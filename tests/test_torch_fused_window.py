"""The fused window configuration (K7 and K10 switched on) against the JAX
package's, and the tail's chunk rule.

The small model of tests/torch_port.py with a head of ``features=256``: its
output tail runs the island at 128 channels and refinenet1 at 256, as vitl's
does, so K10's gate admits them on both sides (input 56: refinenet1 16 ->
32 with row blocks of 16, the island 32 -> 56 with blocks of 14; refinenets
2 and 3 upsample 8 -> 16 and 4 -> 8 and are admitted too).  At N=17 neither
side engages K7 (tests/test_torch_attn_proj.py holds K7's path at the
encoder).  The JAX side runs ``attn_impl="auto"`` on the CPU (its XLA
attention) with ``VDA_ATTN_FUSE_PROJ=1`` and ``VDA_RESIZE_KERNEL=1``, K10 in
interpret mode; the port runs the twins.  bf16 throughout, bound 2e-2 of the
output scale (the JAX package's bf16 bound for its fused kernels); measured
6.5e-3 for the tail and 5.5e-3 for the window (the JAX bf16 tail folds
refinenet1's out_conv and runs its island in space-to-depth form, which the
port does not, so the two round at other points).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vda_tpu.infer.windowed import infer_video_depth as jinfer
from vda_tpu.models import dpt as jdpt

import vda_tpu_torch as vt
from vda_tpu_torch.models import dpt as tdpt
from vda_tpu_torch.ops import resize_kernel

from tests.torch_port import rel_err, small_models

TOL = 2e-2


@pytest.fixture(scope="module")
def setup():
    params, jcfg, model, tcfg = small_models(seed=5, features=256)
    model.requires_grad_(False)
    return params, jcfg, model, tcfg


@pytest.fixture
def switches(monkeypatch):
    monkeypatch.setenv("VDA_ATTN_FUSE_PROJ", "1")
    monkeypatch.setenv("VDA_RESIZE_KERNEL", "1")


@pytest.fixture
def k10_calls(monkeypatch):
    n = []
    wrapper = resize_kernel.resize_bilinear_fused
    monkeypatch.setattr(resize_kernel, "resize_bilinear_fused",
                        lambda *a: n.append(tuple(a[0].shape)) or wrapper(*a))
    return n


def _stage_out(b, seed):
    """bf16 (path_3, l2, l1) at input 56, features 256, on both sides."""
    r = np.random.default_rng(seed)
    shapes = ((b, 8, 8, 256), (b, 8, 8, 256), (b, 16, 16, 256))
    arrs = [jnp.asarray(r.standard_normal(s).astype(np.float32),
                        jnp.bfloat16) for s in shapes]
    return arrs, [torch.from_numpy(np.asarray(a, np.float32))
                  .to(torch.bfloat16) for a in arrs]


def test_tail_with_resize_kernel_matches_jax(setup, switches, k10_calls):
    """The tail alone at B=16: K10 takes refinenet2's, refinenet1's and the
    island's upsamples on both sides."""
    params, _, model, _ = setup
    jin, tin = _stage_out(16, 0)
    ref = jdpt.dpt_head_temporal_tail(params["head"], tuple(jin), (4, 4),
                                      micro_batch_size=16)
    with torch.no_grad():
        got = tdpt.dpt_head_temporal_tail(model.head, tuple(tin), (4, 4),
                                          micro_batch_size=16,
                                          resize_kernel=True)
    assert k10_calls == [(16, 8, 8, 256), (16, 16, 16, 256),
                         (16, 32, 32, 128)]
    assert got.shape == ref.shape == (16, 56, 56, 1)
    assert rel_err(np.asarray(ref, np.float32), got.float().numpy()) < TOL


def test_fused_window_matches_jax(setup, switches, k10_calls):
    """``infer_video_depth(fuse_proj=True, resize_kernel=True)`` on one
    window of 20 frames (tails in chunks of 16) against JAX with both
    switches on, bf16."""
    params, jcfg, model, _ = setup
    frames = (np.random.default_rng(6).random((20, 56, 56, 3))
              * 255).astype(np.uint8)
    ref, _ = jinfer(params, frames, 24, jcfg, input_size=56,
                    micro_batch_size=16)
    got, _ = vt.infer_video_depth(model, frames, 24, input_size=56,
                                  micro_batch_size=16, fuse_proj=True,
                                  resize_kernel=True)
    # a window: refinenet3 once on its 32 frames, then per 16-frame chunk
    # refinenet2, refinenet1 and the island
    assert len(k10_calls) == 1 + 2 * 3
    assert got.shape == ref.shape == (20, 56, 56)
    assert np.isfinite(got).all() and got.std() > 0
    assert rel_err(ref, got) < TOL


@pytest.mark.parametrize("mb", [4, 16, 28, 32])
def test_tail_chunks_follow_jax(setup, monkeypatch, mb):
    """The tail runs a batch of 32 in the JAX package's chunks: all at once
    when the batch is not larger than ``micro_batch_size`` or not a multiple
    of it (28, 32), else in chunks of ``micro_batch_size`` (4, 16).  The
    frames each chunk gets are counted on both sides."""
    params, _, model, _ = setup
    jin, tin = _stage_out(32, 1)
    seen = {"jax": [], "port": []}
    for side, mod in (("jax", jdpt), ("port", tdpt)):
        tail = mod._output_tail
        monkeypatch.setattr(mod, "_output_tail",
                            lambda head, p3, *a, _s=side, _t=tail, **k:
                            seen[_s].append(p3.shape[0])
                            or _t(head, p3, *a, **k))
    jdpt.dpt_head_temporal_tail(params["head"],
                                tuple(a.astype(jnp.float32) for a in jin),
                                (4, 4), micro_batch_size=mb)
    with torch.no_grad():
        tdpt.dpt_head_temporal_tail(model.head, tuple(t.float() for t in tin),
                                    (4, 4), micro_batch_size=mb)
    # lax.scan traces its body once for all chunks of equal size
    jax_chunks = seen["jax"] * (32 // seen["jax"][0])
    want = [32] if 32 <= mb or 32 % mb else [mb] * (32 // mb)
    assert jax_chunks == want
    assert seen["port"] == want


def test_switches_need_the_kernels(setup):
    model = setup[2]
    x = torch.zeros(1, 2, 56, 56, 3)
    for kw in ({"fuse_proj": True}, {"resize_kernel": True}):
        with pytest.raises(ValueError):
            vt.forward(model, x, attn_impl="plain", **kw)
    with pytest.raises(ValueError):
        vt.StreamingDepth(model, attn_impl="plain", fuse_proj=True)
