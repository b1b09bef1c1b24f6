"""The port's offline windowed inference against the JAX package's.

40 frames of 70x90 at input 56 give two windows, so the keyframe overlap and
the scale/shift stitching run.  Both sides run fp32 with their kernels (JAX:
Pallas in interpret mode; the port: the kernels' plain twins on the CPU),
with one set of weights.  The bound is 1e-3 of the depth scale, loose on
purpose: the stitch's least-squares scale/shift fit can amplify fp32
summation-order differences of the network (on this input the two sides
agree to ~1e-5).
"""

import numpy as np
import pytest

from vda_tpu.infer.windowed import infer_video_depth as jinfer

import vda_tpu_torch as vt

from tests.torch_port import rel_err, small_models


@pytest.fixture(scope="module")
def setup():
    params, jcfg, model, _ = small_models(seed=3)
    frames = (np.random.default_rng(4).random((40, 70, 90, 3))
              * 255).astype(np.uint8)
    return params, jcfg, model, frames


def test_infer_video_depth_matches_jax(setup):
    params, jcfg, model, frames = setup
    ref, fps_ref = jinfer(params, frames, 24, jcfg, input_size=56, fp32=True,
                          attn_impl="pallas")
    seen = []
    got, fps = vt.infer_video_depth(model, frames, 24, input_size=56,
                                    fp32=True,
                                    progress=lambda d, n: seen.append((d, n)))
    assert got.shape == ref.shape == (40, 70, 90)
    assert got.dtype == np.float32 and fps == fps_ref
    assert np.isfinite(got).all() and got.std() > 0
    assert rel_err(ref, got) <= 1e-3
    assert seen == [(1, 2), (2, 2)]


def test_plain_and_auto_agree(setup):
    """attn_impl="plain" bypasses every kernel dispatch; on the CPU the
    wrappers' twins are the same functions, so both paths agree exactly up
    to the order of summation."""
    _, _, model, frames = setup
    a, _ = vt.infer_video_depth(model, frames[:10], 24, input_size=56,
                                fp32=True, attn_impl="auto")
    b, _ = vt.infer_video_depth(model, frames[:10], 24, input_size=56,
                                fp32=True, attn_impl="plain")
    assert rel_err(a, b) < 1e-5
