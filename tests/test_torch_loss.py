"""The port's training loss (``vda_tpu_torch/loss``) against the JAX
package's (``vda_tpu/loss``): every function's value and its gradient with
respect to the prediction (``jax.grad`` against autograd), on the same
numpy inputs.

The masks have zeros, an all-empty frame and (the "ties" cases) prediction
and target values on a coarse grid, so the robust medians and the trimmed
sorts meet ties, which is where an unstable sort would send the gradient
to another element.  Tolerances: values within 1e-5 relative (fp32
reduction order); gradients within 1e-4 of their largest magnitude.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from vda_tpu.loss import loss as jl
from vda_tpu_torch.loss import loss as tl

B, T, H, W = 2, 4, 16, 20


def _inputs(ties: bool, seed: int = 0):
    rng = np.random.default_rng(seed)
    p = rng.random((B, T, H, W)) * 3
    t = rng.random((B, T, H, W)) * 3 + 0.2
    if ties:  # values on a grid of 0.25: many equal residuals and medians
        p, t = np.round(p * 4) / 4, np.round(t * 4) / 4
    m = rng.random((B, T, H, W)) > 0.3
    m[0, 1] = False  # an all-empty frame
    m[1, 2, :4] = False
    return p.astype(np.float32), t.astype(np.float32), m


def _frames(a):
    return a.reshape(B * T, H, W)


# name -> (JAX scalar of (p, t, m), port scalar of (p, t, m)); p, t, m are
# (B, T, H, W) with m as float; a fixed weight makes non-scalar outputs
# scalar so every output element reaches the gradient
_W = np.random.default_rng(9).random((B * T, H, W)).astype(np.float32)


def _norm_j(p, t, m):
    out, (mm, s) = jl.normalize_prediction_robust(_frames(p), _frames(m))
    return jnp.sum(out * _W) + jnp.sum(mm) + jnp.sum(s)


def _norm_t(p, t, m):
    out, (mm, s) = tl.normalize_prediction_robust(_frames(p), _frames(m))
    return (out * torch.from_numpy(_W)).sum() + mm.sum() + s.sum()


def _sas_j(p, t, m):
    x0, x1 = jl.compute_scale_and_shift(p.reshape(B, T * H, W),
                                        t.reshape(B, T * H, W),
                                        m.reshape(B, T * H, W))
    return jnp.sum(x0 * 1.3 + x1)


def _sas_t(p, t, m):
    x0, x1 = tl.compute_scale_and_shift(p.reshape(B, T * H, W),
                                        t.reshape(B, T * H, W),
                                        m.reshape(B, T * H, W))
    return (x0 * 1.3 + x1).sum()


CASES = {
    "normalize_prediction_robust": (_norm_j, _norm_t),
    "compute_scale_and_shift": (_sas_j, _sas_t),
    "trimmed_mae_loss": (
        lambda p, t, m: jl.trimmed_mae_loss(_frames(p), _frames(t),
                                            _frames(m), trim=0.2),
        lambda p, t, m: tl.trimmed_mae_loss(_frames(p), _frames(t),
                                            _frames(m), trim=0.2)),
    "trimmed_mae_loss_trim0": (
        lambda p, t, m: jl.trimmed_mae_loss(_frames(p), _frames(t),
                                            _frames(m), trim=0.0),
        lambda p, t, m: tl.trimmed_mae_loss(_frames(p), _frames(t),
                                            _frames(m), trim=0.0)),
    "gradient_loss": (
        lambda p, t, m: jl.gradient_loss(_frames(p), _frames(t), _frames(m)),
        lambda p, t, m: tl.gradient_loss(_frames(p), _frames(t),
                                         _frames(m))),
    "gradient_loss_frame_h2": (
        lambda p, t, m: jl.gradient_loss(_frames(p), _frames(t), _frames(m),
                                         scales=3, num_frame_h=2),
        lambda p, t, m: tl.gradient_loss(_frames(p), _frames(t), _frames(m),
                                         scales=3, num_frame_h=2)),
    "trimmed_procrustes_loss": (
        lambda p, t, m: jl.trimmed_procrustes_loss(_frames(p), _frames(t),
                                                   _frames(m)),
        lambda p, t, m: tl.trimmed_procrustes_loss(_frames(p), _frames(t),
                                                   _frames(m))),
    "temporal_gradient_matching_loss": (
        lambda p, t, m: jl.temporal_gradient_matching_loss(p, t, m),
        lambda p, t, m: tl.temporal_gradient_matching_loss(p, t, m)),
    "temporal_gradient_matching_loss_2scales": (
        lambda p, t, m: jl.temporal_gradient_matching_loss(
            p, t, m, trim=0.1, temp_grad_scales=2),
        lambda p, t, m: tl.temporal_gradient_matching_loss(
            p, t, m, trim=0.1, temp_grad_scales=2)),
    "video_depth_loss": (
        lambda p, t, m: jl.video_depth_loss(p, t, m)["total_loss"],
        lambda p, t, m: tl.video_depth_loss(p, t, m)["total_loss"]),
    "video_depth_loss_trim": (
        lambda p, t, m: jl.video_depth_loss(p, t, m, trim=0.2)["total_loss"],
        lambda p, t, m: tl.video_depth_loss(p, t, m,
                                            trim=0.2)["total_loss"]),
}


@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_loss_and_gradient_match_jax(name, ties):
    jfn, tfn = CASES[name]
    p, t, m = _inputs(ties)
    mf = m.astype(np.float32)
    jv, jg = jax.value_and_grad(jfn)(jnp.asarray(p), jnp.asarray(t),
                                     jnp.asarray(mf))
    pt = torch.tensor(p, requires_grad=True)
    tv = tfn(pt, torch.from_numpy(t), torch.from_numpy(mf))
    tv.backward()
    tv = tv.detach()
    jv, jg = float(jv), np.asarray(jg)
    assert np.isfinite(float(tv)) and np.isfinite(pt.grad.numpy()).all()
    assert abs(float(tv) - jv) <= 1e-5 * max(abs(jv), 1e-6), (float(tv), jv)
    scale = max(float(np.abs(jg).max()), 1e-12)
    assert float(np.abs(pt.grad.numpy() - jg).max()) <= 1e-4 * scale


def test_video_depth_loss_parts_and_bool_mask_match_jax():
    """The three outputs of ``video_depth_loss`` with a bool mask."""
    p, t, m = _inputs(False, seed=1)
    ref = jl.video_depth_loss(jnp.asarray(p), jnp.asarray(t), jnp.asarray(m))
    got = tl.video_depth_loss(torch.from_numpy(p), torch.from_numpy(t),
                              torch.from_numpy(m))
    assert set(got) == set(ref)
    for k in ref:
        assert abs(float(got[k]) - float(ref[k])) <= \
            1e-5 * max(abs(float(ref[k])), 1e-6), k


def test_empty_mask_gives_zero_loss_and_finite_gradient():
    """No valid pixel: the +inf sentinels of the trimmed sort and the
    min/max are all selected away; loss 0 and a zero, finite gradient."""
    p, t, _ = _inputs(False)
    m = np.zeros_like(p, dtype=bool)
    pt = torch.tensor(p, requires_grad=True)
    out = tl.video_depth_loss(pt, torch.from_numpy(t), torch.from_numpy(m))
    out["total_loss"].backward()
    assert float(out["total_loss"]) == 0.0
    assert torch.isfinite(pt.grad).all() and float(pt.grad.abs().max()) == 0.0


def test_median_is_lower_middle_and_statistics_are_detached():
    v = torch.tensor([[3.0, 1.0, 2.0, 4.0], [0.0, 0.0, 5.0, 0.0]])
    assert tl._median_lower(v).tolist() == [2.0, 0.0]
    x = torch.rand(2, 3, 4, requires_grad=True)
    _, (m, s) = tl.normalize_prediction_robust(x, torch.ones(2, 3, 4))
    assert not m.requires_grad and not s.requires_grad


def test_median_gradient_sits_on_the_median_pixel():
    """The robust median passes the gradient of the frame's shift to its one
    median pixel (as ``jnp.sort``'s does), so a change of 2e-7 that swaps
    the two pixels around the median moves that whole gradient to the other
    pixel; with more than half the pixels invalid the median is a zeroed
    invalid pixel, which passes nothing, and the same change moves the
    gradient by little.  This is why a train step's gradients are compared
    between two implementations on a sparse mask (chip_smoke.py's
    ``phase_train``): at 518x518 the values around a frame's median lie
    closer together than two implementations' rounding."""
    p = torch.linspace(0.5, 0.7, 101).reshape(1, 1, 101)
    p[0, 0, 50], p[0, 0, 51] = 0.6, 0.6 + 1e-7
    w = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, 1, 101)).astype(np.float32))
    dense = torch.ones(1, 1, 101)
    sparse = (torch.arange(101) % 5 < 2).float().reshape(1, 1, 101)
    sparse[0, 0, 50:52] = 1.0

    def grad(pred, mask):
        x = pred.clone().requires_grad_(True)
        (tl.normalize_prediction_robust(x, mask)[0] * w * mask).sum() \
            .backward()
        return x.grad

    moved = p.clone()
    moved[0, 0, 50] += 2e-7  # now above its neighbour: the median moves
    for mask, bound in ((dense, None), (sparse, 1e-3)):
        g0, g1 = grad(p, mask), grad(moved, mask)
        change = float((g1 - g0).abs().max() / g0.abs().max())
        if bound is None:
            assert change > 0.1
        else:
            assert change < bound
