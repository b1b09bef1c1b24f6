"""K10 (bf16 bilinear upsample) against the JAX package's
``resize_bilinear_fused`` and its ``VDA_RESIZE_KERNEL=1`` dispatch.

On the CPU K10's wrapper runs its plain twin; the Pallas kernel runs in
interpret mode (tests/conftest.py).  Both compute the fp32 row lerp
r0·(1 − t) + r1·t, round it to bf16, and sum two exact bf16 products with
one rounding.  The twin (and the CUDA kernel, bit for bit) rounds each
product of the lerp; XLA:CPU contracts ``r0 * (1 - t) + r1 * t`` in the
interpreted kernel into a fused multiply-add, which moves a lerped row
value by up to one bf16 ulp of itself where the fp32 sum sits near a bf16
rounding boundary, and the output by up to two such ulps (the row value
enters with a weight of at most 1 and the output rounds again).  The bound
is therefore two bf16 ulps of the largest input the output reads (its 2x2
taps), and at most 2e-3 of the elements may differ; measured at these
shapes: up to 0.0156 at inputs near 4 (2 ulps), at 6e-5..1.2e-3 of the
elements, the rest bit-exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vda_tpu.ops import pallas_resize
from vda_tpu.ops.resize import resize_bilinear as jresize_bilinear

import vda_tpu_torch.ops as tops
from vda_tpu_torch.ops import resize_kernel
from vda_tpu_torch.ops.resize import resize_bilinear

from tests.torch_port import resize_gate_cases

# the three shapes of tests/test_ops.py and one at the 296 -> 518 ratio of
# the vitl island
CASES = [((8, 20, 24, 128), (32, 40)), ((8, 148, 16, 128), (296, 28)),
         ((9, 9, 7, 256), (14, 13)), ((8, 37, 11, 128), (518 * 37 // 296,
                                                          21))]


def _within_two_ulps(x, out_hw, ref, got):
    """|got - ref| <= 2 bf16 ulps of the largest of each output's 2x2 input
    taps (``_lerp_tables``, as both sides use them)."""
    from vda_tpu_torch.ops.resize import _lerp_tables

    i0, i1, _ = _lerp_tables(x.shape[1], out_hw[0], True, None)
    j0, j1, _ = _lerp_tables(x.shape[2], out_hw[1], True, None)
    a = np.abs(x)
    taps = np.maximum.reduce([a[:, i][:, :, j] for i in (i0, i1)
                              for j in (j0, j1)])
    ulp = np.spacing(taps.astype(np.float32)) * 2 ** 16  # bf16 ulp
    return (np.abs(got - ref) <= 2 * ulp).all()


def _bf16(x32):
    """The same bf16 values on both sides."""
    j = jnp.asarray(x32, jnp.bfloat16)
    return j, torch.from_numpy(np.asarray(j, np.float32)).to(torch.bfloat16)


@pytest.mark.parametrize("shape,out_hw", CASES)
def test_k10_twin_matches_pallas(monkeypatch, shape, out_hw):
    monkeypatch.setenv("VDA_RESIZE_KERNEL", "1")
    jx, tx = _bf16(np.random.default_rng(sum(shape)).standard_normal(shape)
                   .astype(np.float32))
    assert pallas_resize.supported(jx, out_hw, True, None)
    assert resize_kernel.supported(tx, out_hw, True, None)
    ref = np.asarray(pallas_resize.resize_bilinear_fused(jx, out_hw),
                     np.float32)
    tops.reset_launch_counts()
    got = resize_kernel.resize_bilinear_fused(tx, out_hw)
    assert tops.launch_counts()["K10"] == 0  # the twin ran
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape
    got = got.float().numpy()
    assert _within_two_ulps(np.asarray(jx, np.float32), out_hw, ref, got)
    assert (got != ref).mean() < 2e-3


@pytest.mark.parametrize("in_hw,out_hw", [
    ((148, 148), (296, 296)), ((296, 296), (518, 518)), ((16, 9), (32, 14)),
    ((32, 8), (56, 16)), ((9, 20), (14, 32)), ((148, 7), (304, 7))])
def test_k10_tables_are_the_separable_form(in_hw, out_hw):
    """The tables K10 and its twin read hold JAX's row taps and lerp weight
    (``_lerp_tables``) and, as two taps a column, exactly the bf16-rounded
    W-pass matrix the Pallas kernel multiplies by (``_linear_matrix``)."""
    from vda_tpu.ops.resize import _lerp_tables, _linear_matrix

    (h, w), (oh, ow) = in_hw, out_hw
    itab, ftab = resize_kernel._tables(h, w, oh, ow)
    i0, i1, j0, j1 = np.split(itab, np.cumsum([oh, oh, ow]))
    w1, m0, m1 = np.split(ftab, np.cumsum([oh, ow]))
    for got, ref in zip((i0, i1, w1), _lerp_tables(h, oh, True, None)):
        np.testing.assert_array_equal(got, ref)
    dense = np.zeros((ow, w), np.float32)
    np.add.at(dense, (np.arange(ow), j0), m0)
    np.add.at(dense, (np.arange(ow), j1), m1)
    ref = np.asarray(jnp.asarray(_linear_matrix(w, ow, True), jnp.bfloat16),
                     np.float32)
    np.testing.assert_array_equal(dense, ref)


def test_gate_follows_jax(monkeypatch):
    """The JAX gate's rejections (tests/test_ops.py) and its one
    admission; the grid is in tests/test_torch_copies.py."""
    monkeypatch.setenv("VDA_RESIZE_KERNEL", "1")
    for i, (shape, out_hw, ac, scale, f32) in enumerate(
            resize_gate_cases()[:8]):
        jx = jnp.zeros(shape, jnp.float32 if f32 else jnp.bfloat16)
        tx = torch.zeros(shape, dtype=torch.float32 if f32
                         else torch.bfloat16)
        want = pallas_resize.supported(jx, out_hw, ac, scale)
        assert want == (i == 0)  # the first case alone is admitted
        assert resize_kernel.supported(tx, out_hw, ac, scale) == want
    # the JAX gate's own switch stays JAX's: off, it admits nothing
    monkeypatch.delenv("VDA_RESIZE_KERNEL")
    ok = jnp.zeros((8, 20, 24, 128), jnp.bfloat16)
    assert not pallas_resize.supported(ok, (32, 40), True, None)


@pytest.fixture
def k10_calls(monkeypatch):
    """Counts the calls of K10's wrapper."""
    n = []
    wrapper = resize_kernel.resize_bilinear_fused
    monkeypatch.setattr(resize_kernel, "resize_bilinear_fused",
                        lambda *a: n.append(1) or wrapper(*a))
    return n


def test_resize_bilinear_dispatch(monkeypatch, k10_calls):
    """``resize_bilinear(kernel=True)`` takes K10 exactly where the gate
    admits, and then returns what JAX's ``resize_bilinear`` returns with
    its switch on; ``kernel=False`` never takes it."""
    monkeypatch.setenv("VDA_RESIZE_KERNEL", "1")
    rng = np.random.default_rng(0)
    for shape, out_hw, ac in [((8, 20, 24, 128), (32, 40), True),
                              ((8, 20, 24, 128), (32, 40), False),
                              ((7, 20, 24, 128), (32, 40), True),
                              ((8, 20, 24, 200), (32, 40), True),
                              ((8, 9, 7, 256), (14, 13), True),
                              ((8, 19, 19, 128), (37, 37), True),
                              ((8, 20, 24, 128), (32, 20), True)]:
        jx, tx = _bf16(rng.standard_normal(shape).astype(np.float32))
        admitted = resize_kernel.supported(tx, out_hw, ac, None)
        k10_calls.clear()
        got = resize_bilinear(tx, out_hw, align_corners=ac, kernel=True)
        assert len(k10_calls) == int(admitted)
        ref = np.asarray(jresize_bilinear(jx, out_hw, align_corners=ac),
                         np.float32)
        assert _within_two_ulps(np.asarray(jx, np.float32), out_hw, ref,
                                got.float().numpy())
        k10_calls.clear()
        resize_bilinear(tx, out_hw, align_corners=ac)
        assert not k10_calls
