"""K5 and K6 of the port against the JAX Pallas kernels they replace, and the
model's kernel gates against the JAX gates.

On the CPU each wrapper runs its plain twin (the CUDA kernels are held
against the twins on the card by ``chip_smoke.py`` and
``tests/test_torch_cuda.py``); the Pallas kernels run in interpret mode
(tests/conftest.py).  All fp32: the two sides differ only in summation
order, so 2e-5 of the output scale is the bound (the twins' bound of
tests/test_torch_kernels.py).  A CPU call leaves the launch counters at
rest.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vda_tpu.models import dinov2 as jdinov2
from vda_tpu.ops import pallas_attention, pallas_stream

import vda_tpu_torch.ops as tops
from vda_tpu_torch.ops import attention_kernel, stream_kernel, tiny_seq_kernel

from tests.torch_port import rel_err

TOL = 2e-5


@pytest.fixture(autouse=True)
def counters_at_rest():
    tops.reset_launch_counts()
    yield
    assert set(tops.launch_counts().values()) == {0}


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


@pytest.mark.parametrize("t", [1, 7, 32, 64])
@pytest.mark.parametrize("dh,heads", [(8, 8), (24, 8), (128, 2)])
def test_k5_tiny_seq_attention(t, dh, heads):
    c = heads * dh
    r = np.random.default_rng(t * 1000 + dh)
    q, k, v = (r.standard_normal((5, t, c)).astype(np.float32)
               for _ in range(3))
    scale = dh ** -0.5
    ref = pallas_attention.tiny_seq_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), heads=heads, seq=t,
        scale=scale)
    got = tiny_seq_kernel.tiny_seq_attention(_t(q), _t(k), _t(v), heads,
                                             scale)
    assert got.shape == ref.shape == (5, t, c)
    assert rel_err(ref, got.numpy()) < TOL


def test_k5_reads_column_slices_of_a_fused_projection():
    """q, k, v as column slices of one (BD, T, 3C) tensor, as the model
    hands them over, give the result of contiguous copies."""
    qkv = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (6, 32, 3 * 192)).astype(np.float32))
    q, k, v = qkv.split(192, dim=-1)
    got = tiny_seq_kernel.tiny_seq_attention(q, k, v, 8, 24 ** -0.5)
    ref = tiny_seq_kernel.tiny_seq_attention(
        q.contiguous(), k.contiguous(), v.contiguous(), 8, 24 ** -0.5)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("c,heads,n_valid", [(256, 8, 31), (64, 8, 20),
                                             (1024, 8, 31), (192, 8, 0)])
def test_k6_stream_kv_attention(c, heads, n_valid):
    r = np.random.default_rng(c + n_valid)
    bhw, rows = 32, 31  # JAX tiles 16 positions a cell
    q, kn, vn = (r.standard_normal((bhw, c)).astype(np.float32)
                 for _ in range(3))
    kb, vb = (r.standard_normal((bhw, rows, c)).astype(np.float32)
              for _ in range(2))
    pk, pv = (r.standard_normal((rows, c)).astype(np.float32)
              for _ in range(2))
    valid = np.zeros(rows, bool)
    valid[r.permutation(rows)[:n_valid]] = True
    scale = (c // heads) ** -0.5
    ref = pallas_stream.stream_kv_attention(
        *(jnp.asarray(x) for x in (q, kn, vn, kb, vb, pk, pv, valid)),
        heads=heads, scale=scale)
    got = stream_kernel.stream_kv_attention(
        *(_t(x) for x in (q, kn, vn, kb, vb, pk, pv, valid)), heads, scale)
    assert got.shape == ref.shape == (bhw, c)
    assert rel_err(ref, got.numpy()) < TOL


def test_k6_skips_rows_that_are_not_valid():
    """A row that is not valid is never read: NaN there changes nothing."""
    r = np.random.default_rng(5)
    q, kn, vn = (_t(r.standard_normal((3, 64)).astype(np.float32))
                 for _ in range(3))
    kb, vb = (_t(r.standard_normal((3, 6, 64)).astype(np.float32))
              for _ in range(2))
    pk, pv = torch.zeros(6, 64), torch.zeros(6, 64)
    valid = torch.tensor([True, False, True, True, False, True])
    ref = stream_kernel.stream_kv_attention(q, kn, vn, kb, vb, pk, pv, valid,
                                            8, 0.3)
    kb[:, 1], vb[:, 4] = float("nan"), float("nan")
    got = stream_kernel.stream_kv_attention(q, kn, vn, kb, vb, pk, pv, valid,
                                            8, 0.3)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("n", [17, 257, 511, 512, 530, 1370, 4097])
def test_k1_gate_is_the_jax_gate(n, monkeypatch):
    """K1 dispatches where JAX runs its Pallas kernel (``_use_pallas`` on a
    TPU), less the head widths above the kernel's 128."""
    monkeypatch.setattr(jdinov2, "_on_tpu", lambda: True)
    for dh in (4, 8, 12, 24, 32, 64, 80, 96, 128, 136, 192, 256):
        assert attention_kernel.use_kernel(n, dh) == \
            (jdinov2._use_pallas(n, dh) and dh <= 128), (n, dh)


def test_k5_and_k6_gates():
    """K5: whole sequences of at most 64 frames, head width % 8 (JAX
    models/temporal.py:187-189).  K6: one new frame, heads tiling a
    512-wide group, head width % 8 (:288-290, less the TPU row padding)."""
    assert tiny_seq_kernel.use_kernel(1, 1, 128)
    assert tiny_seq_kernel.use_kernel(32, 32, 24)
    assert tiny_seq_kernel.use_kernel(64, 64, 192)
    assert not tiny_seq_kernel.use_kernel(65, 65, 8)
    assert not tiny_seq_kernel.use_kernel(1, 32, 8)  # cached queries
    assert not tiny_seq_kernel.use_kernel(32, 32, 4)
    for c, heads, want in [(1024, 8, True), (256, 8, True), (192, 8, True),
                           (64, 8, True), (32, 8, False), (1536, 8, False),
                           (1536, 12, True), (384, 6, True), (640, 8, False),
                           (32, 4, True)]:
        dh, gw = c // heads, min(c, 512)
        jax_gate = c % gw == 0 and gw % dh == 0 and dh % 8 == 0
        assert stream_kernel.use_kernel(1, c, heads, "ape") == jax_gate \
            == want
        assert not stream_kernel.use_kernel(2, c, heads, "ape")


def test_wrappers_refuse_other_devices():
    x = torch.zeros(2, 4, 64, device="meta")
    with pytest.raises(ValueError):
        tiny_seq_kernel.tiny_seq_attention(x, x, x, 8, 0.3)
    row = torch.zeros(2, 64, device="meta")
    with pytest.raises(ValueError):
        stream_kernel.stream_kv_attention(
            row, row, row, x, x, x[0], x[0],
            torch.ones(4, dtype=torch.bool, device="meta"), 8, 0.3)
