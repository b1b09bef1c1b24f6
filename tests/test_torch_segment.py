"""K8 (block-diagonal attention over packed segments) and
``block_apply_nested`` of the port against the JAX package.

On the CPU the K8 wrapper runs its plain twin (the CUDA kernel is held to
the twin in tests/test_torch_cuda.py and chip_smoke.py); the Pallas
``segment_attention`` runs in interpret mode (tests/conftest.py).  All
fp32; tolerance 1e-5 of the output scale (summation order of the softmax
and the products).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from vda_tpu.models import dinov2 as jdino
from vda_tpu.ops import attention as jattention
from vda_tpu.ops import pallas_attention as jpallas

from vda_tpu_torch.models import dinov2 as tdino
from vda_tpu_torch.ops import attention as tattention
from vda_tpu_torch.ops import segment_kernel

from tests.torch_port import rel_err, small_models

TOL = 1e-5
# ragged lengths: single rows, one segment over the 128-row bin (the
# Pallas plan then makes bins of 384), many bins, and a 64-row K8 tile
# edge (64, 65)
LENGTHS = [(1, 50, 257, 3, 130, 1), (100, 100, 100, 100, 100),
           (1, 1, 1, 1, 1, 1, 1), (64, 65, 1, 128, 7), (300, 20, 1, 200)]


def _qkv(total, hd, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((total, hd)).astype(np.float32)
            for _ in range(3)]


@pytest.mark.parametrize("heads,d", [(2, 64), (4, 16)])
@pytest.mark.parametrize("lengths", LENGTHS, ids=str)
def test_segment_twin_matches_pallas(lengths, heads, d):
    total = sum(lengths)
    q, k, v = _qkv(total, heads * d)
    ref = jpallas.segment_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                    heads=heads, scale=d ** -0.5,
                                    segment_lengths=lengths)
    got = segment_kernel.segment_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), heads, d ** -0.5, lengths)
    assert rel_err(np.asarray(ref), got.numpy()) < TOL


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_packed_self_attention_segments_match_jax(impl):
    """``packed_self_attention(segment_lengths=...)``: the port's dispatch
    (K8 with "auto", per-segment plain with "plain") against JAX's pallas
    and xla paths."""
    lengths = (1, 50, 257, 3, 130)
    q, k, v = (a[None] for a in _qkv(sum(lengths), 128, seed=1))
    ref = np.asarray(jattention.packed_self_attention(
        *(jnp.asarray(a) for a in (q, k, v)), 2, None, impl,
        segment_lengths=lengths))
    for t_impl in ("auto", "plain"):
        got = tattention.packed_self_attention(
            *(torch.from_numpy(a) for a in (q, k, v)), 2, None, t_impl,
            segment_lengths=lengths)
        assert got.shape == (1, sum(lengths), 128)
        assert rel_err(ref, got.numpy()) < TOL


@pytest.fixture(scope="module")
def models():
    return small_models(seed=2)


@pytest.mark.parametrize("attn_impl", ["xla", "pallas"])
def test_block_apply_nested_matches_jax(models, attn_impl):
    """The NestedTensorBlock over token batches of different lengths
    (including a single token) against JAX's ``block_apply_nested``."""
    params, jcfg, model, tcfg = models
    rng = np.random.default_rng(3)
    shapes = [(2, 17, 128), (3, 5, 128), (1, 1, 128), (2, 70, 128)]
    xs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    p0 = params["pretrained"]["blocks"][0]
    ref = jdino.block_apply_nested(p0, [jnp.asarray(x) for x in xs],
                                   jcfg.vit, attn_impl)
    blk = model.pretrained.blocks[0]
    with torch.no_grad():
        got = tdino.block_apply_nested(blk, [torch.from_numpy(x) for x in xs],
                                       tcfg.vit)
        per_sample = [tdino.block_apply(blk, torch.from_numpy(x), tcfg.vit,
                                        kernels=False) for x in xs]
    for r, g, p in zip(ref, got, per_sample):
        assert g.shape == r.shape
        assert rel_err(np.asarray(r), g.numpy()) < TOL
        assert rel_err(p.numpy(), g.numpy()) < TOL


def test_block_apply_nested_launches_k8_once(models, monkeypatch):
    """The nested block sends its attention to K8's wrapper once, with one
    segment per sample."""
    _, _, model, tcfg = models
    calls = []
    real = segment_kernel.segment_attention

    def spy(q, k, v, heads, scale, segment_lengths):
        calls.append(tuple(segment_lengths))
        return real(q, k, v, heads, scale, segment_lengths)

    monkeypatch.setattr(segment_kernel, "segment_attention", spy)
    xs = [torch.randn(2, 9, 128), torch.randn(3, 4, 128)]
    with torch.no_grad():
        tdino.block_apply_nested(model.pretrained.blocks[0], xs, tcfg.vit)
        tdino.block_apply_nested(model.pretrained.blocks[0], xs, tcfg.vit,
                                 impl="plain")
    assert calls == [(9, 9, 4, 4, 4)]


@pytest.mark.parametrize("d,kernel", [(64, True), (128, True), (8, True),
                                      (40, True), (12, False), (136, False),
                                      (4, False)])
def test_segment_gate(monkeypatch, d, kernel):
    """K8 takes the segments where JAX's gate does (head width % 8) and the
    kernel takes the width (<= 128); elsewhere the per-segment plain form;
    ``impl="plain"`` never reaches K8."""
    calls = []
    monkeypatch.setattr(segment_kernel, "segment_attention",
                        lambda *a: calls.append(a) or
                        segment_kernel.segment_attention_reference(*a))
    q = torch.randn(1, 12, 2 * d)
    for impl in ("auto", "plain"):
        tattention.packed_self_attention(q, q, q, 2, impl=impl,
                                         segment_lengths=(5, 7))
    assert len(calls) == int(kernel)
    assert segment_kernel.kernel_supported(d) == kernel


def test_segment_errors():
    q = torch.randn(2, 12, 128)
    with pytest.raises(ValueError, match="B=1"):
        tattention.packed_self_attention(q, q, q, 2, segment_lengths=(5, 7))
    for impl in ("auto", "plain"):
        with pytest.raises(ValueError, match="sum"):
            tattention.packed_self_attention(q[:1], q[:1], q[:1], 2,
                                             impl=impl,
                                             segment_lengths=(5, 6))
        with pytest.raises(ValueError, match="positive"):
            tattention.packed_self_attention(q[:1], q[:1], q[:1], 2,
                                             impl=impl,
                                             segment_lengths=(12, 0))
    with pytest.raises(ValueError, match="impl"):
        tattention.packed_self_attention(q[:1], q[:1], q[:1], 2, impl="xla",
                                         segment_lengths=(12,))


@pytest.mark.parametrize("lengths", LENGTHS + [(1370,) * 3, (257, 50, 50)],
                         ids=str)
def test_tile_table_covers_every_row_once(lengths):
    """K8's tile table: each segment's rows in 64-row tiles, in order, each
    row in exactly one tile of its own segment."""
    table = segment_kernel.tile_table(tuple(lengths))
    seen = np.zeros(sum(lengths), int)
    starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    for start, n, q0, pad in table:
        assert pad == 0 and start in starts and 0 <= q0 < n and q0 % 64 == 0
        seen[start + q0:start + min(q0 + 64, n)] += 1
    assert (seen == 1).all()
    assert len(table) == sum(-(-n // 64) for n in lengths)
