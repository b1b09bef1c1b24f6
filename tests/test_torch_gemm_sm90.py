"""The GEMM probe's twins (``probes/bench_gemm_sm90.py``, the design steps
of K11/K13's Hopper mainloop) against the JAX package, and its tables
against ``csrc/gemm_sm90_variants.cu``.

On the CPU ``bench_gemm_sm90.gemm`` runs its plain twin.  The shapes are
ragged against the kernel's 128- and 256-row tiles and its 128-byte stage
of k: M 1, 129 and 200; K 16, 48 and 1040 bytes; N 128, 136, 256 and 640
(N % 128 for K11, as in JAX).  K11's twin is held to JAX's
``_int8_matmul`` (its Pallas kernel in interpret mode, tests/conftest.py)
within one bf16 ulp of each output beyond 1e-6 of the scale (XLA:CPU
contracts the interpreted epilogue into an FMA where the port rounds each
step; tests/test_torch_quant.py says the same); the int8 product exactly
and the bf16 product within 2^-8 of the scale against JAX's product with
fp32 sums.
"""

import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vda_tpu.ops import quant as jquant

import vda_tpu_torch.ops as tops
from vda_tpu_torch.ops import _build, quant
from vda_tpu_torch.probes import bench_gemm_sm90 as bg

from tests.torch_port import rel_err

KERNELS = [f"K{i}" for i in range(1, 15)]
# (M, K bytes, N)
SHAPES = [(1, 16, 128), (129, 48, 640), (200, 1040, 256)]


@pytest.fixture(autouse=True)
def counters_at_rest():
    tops.reset_launch_counts()
    bg.launches = 0
    yield
    assert tops.launch_counts() == dict.fromkeys(KERNELS, 0)
    assert bg.launches == 0


def _int8(rng, *shape):
    return rng.integers(-127, 127, shape).astype(np.int8)


@pytest.mark.parametrize("m,kb,n", SHAPES)
def test_k11_twin_matches_jax(m, kb, n):
    rng = np.random.default_rng(m + kb + n)
    a, w = _int8(rng, m, kb), _int8(rng, kb, n)
    sx = (rng.random((m, 1)) / 127 + 1e-4).astype(np.float32)
    sw = (rng.random(n) / 127 + 1e-4).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    ref = np.asarray(jquant._int8_matmul(
        jnp.asarray(a), jnp.asarray(w), jnp.asarray(sx),
        jnp.asarray(sw)[None], jnp.asarray(b)[None], jnp.bfloat16),
        np.float32)
    t = torch.from_numpy
    got = bg.gemm("k11", t(a), t(np.ascontiguousarray(w.T)), "t128x256",
                  t(sx), t(sw), t(b))
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    got = got.float().numpy()
    ulp = np.spacing(np.abs(ref)) * 2.0 ** 16
    assert (np.abs(got - ref) <= ulp + 1e-6 * np.abs(ref).max()).all()


@pytest.mark.parametrize("m,kb,n", SHAPES + [(129, 48, 136)])
def test_k13_int8_twin_matches_jax(m, kb, n):
    rng = np.random.default_rng(m * kb + n)
    a, w = _int8(rng, m, kb), _int8(rng, kb, n)
    ref = np.asarray(jnp.dot(jnp.asarray(a), jnp.asarray(w),
                             preferred_element_type=jnp.int32))
    got = bg.gemm("k13_int8", torch.from_numpy(a),
                  torch.from_numpy(np.ascontiguousarray(w.T)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("m,kb,n", SHAPES + [(129, 48, 136)])
def test_k13_bf16_twin_matches_jax(m, kb, n):
    rng = np.random.default_rng(m + 3 * kb + n)
    k = kb // 2  # bf16: 8, 24 and 520 values
    a = jnp.asarray(rng.standard_normal((m, k)), jnp.bfloat16)
    w = jnp.asarray(rng.standard_normal((k, n)), jnp.bfloat16)
    ref = np.asarray(jnp.dot(a, w, preferred_element_type=jnp.float32))
    ta = torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
    tbt = torch.from_numpy(np.ascontiguousarray(np.asarray(w, np.float32).T))
    got = bg.gemm("k13_bf16", ta, tbt.to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    assert rel_err(ref, got.float().numpy()) < 2.0 ** -8


@pytest.mark.parametrize("variant", list(bg.WRITE_NOTHING))
@pytest.mark.parametrize("kind", list(bg.KINDS))
def test_steps_that_write_nothing_have_a_zero_twin(kind, variant):
    a = torch.ones(3, 32, dtype=torch.int8)
    if kind == "k13_bf16":
        a = a[:, :16].bfloat16()
    got = bg.gemm(kind, a, a[:2].repeat(4, 1), variant, torch.ones(3, 1),
                  torch.ones(8), torch.zeros(8))
    assert got.shape == (3, 8) and not got.any()
    assert got.dtype == (torch.int32 if kind == "k13_int8"
                         else torch.bfloat16)


def test_variant_table_matches_the_source():
    """The probe's names and indices are the ones the source lists in its
    header, and the entry point has a case for each."""
    with open(os.path.join(_build.CSRC, "gemm_sm90_variants.cu")) as f:
        src = f.read()
    header = src.split("#include")[0]
    kinds, loops = header.split("`variant` the loop:")
    listed = dict((name, int(i)) for i, name in
                  re.findall(r"^//\s+(\d+) (\w+)\s", loops, re.M))
    assert listed == bg.VARIANTS
    cases = sorted(int(i) for i in re.findall(r"case (\d+):\s+return", src))
    assert cases == sorted(bg.VARIANTS.values())
    assert "0 K13 int8" in kinds and "1 K13 bf16" in kinds \
        and "2 K11" in kinds
    assert bg.KINDS == {"k13_int8": 0, "k13_bf16": 1, "k11": 2}


@pytest.mark.parametrize("kind,by", [("k13_int8", "bytes"),
                                     ("k13_bf16", "operations"),
                                     ("k11", "operations")])
def test_bounds_at_the_probe_shapes(kind, by):
    m, k, n = bg.SHAPES[kind]
    ms, bound_by = bg.bound_ms(kind, m, k, n)
    n_bytes, n_ops = bg.cost(kind, m, k, n)
    assert bound_by == by
    assert ms == pytest.approx(1e3 * max(
        n_bytes / 3.35e12,
        n_ops / (989e12 if kind == "k13_bf16" else 1979e12)))


@pytest.mark.parametrize("k,itemsize,want", [(40, 1, 48), (48, 1, 48),
                                             (40, 2, 40), (12, 2, 16),
                                             (8, 2, 8), (1, 4, 4)])
def test_padded_k_rounds_rows_to_sixteen_bytes(k, itemsize, want):
    assert quant.padded_k(k, itemsize) == want


def test_transposed_bf16_weight_pads_to_sixteen_bytes():
    w = torch.randn(12, 8).to(torch.bfloat16)
    wt = quant.transposed(w)
    assert wt.shape == (8, 16)  # 12 values = 24 bytes -> 32 bytes
    assert torch.equal(wt[:, :12], w.t()) and not wt[:, 12:].any()
    w24 = torch.randn(24, 8).to(torch.bfloat16)
    assert quant.transposed(w24).shape == (8, 24)  # 48 bytes: no padding
