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


def test_window_batch_matches_jax_and_single_windows(setup, monkeypatch):
    """``window_batch=2`` over 50 frames (three windows, so the second
    forward carries the last window and its repeat) against JAX's
    ``window_batch=2`` and the port's one window a forward: each window a
    sequence of its own in the motion modules, the pad's depths dropped.
    Within 1e-4 of the depth scale (fp32; the two sides agree to ~1e-5
    before the stitch, see the module docstring)."""
    from vda_tpu_torch.infer import windowed as tw

    params, jcfg, model, _ = setup
    frames = (np.random.default_rng(5).random((50, 70, 90, 3))
              * 255).astype(np.uint8)
    ref, _ = jinfer(params, frames, 24, jcfg, input_size=56, fp32=True,
                    attn_impl="pallas", window_batch=2)
    one, _ = vt.infer_video_depth(model, frames, 24, input_size=56,
                                  fp32=True)
    batches, seen = [], []
    forward = tw.forward

    def counted(model, x, **kw):
        batches.append(x.shape[0])
        return forward(model, x, **kw)

    monkeypatch.setattr(tw, "forward", counted)
    got, _ = vt.infer_video_depth(model, frames, 24, input_size=56,
                                  fp32=True, window_batch=2,
                                  progress=lambda d, n: seen.append((d, n)))
    assert batches == [2, 2] and seen == [(2, 3), (3, 3)]
    assert got.shape == ref.shape == (50, 70, 90)
    assert rel_err(ref, got) < 1e-4
    assert rel_err(one, got) < 1e-4


def test_stitch_reads_its_inputs_and_returns_one_array(setup, monkeypatch):
    """The contract the benchmark's capture of ``windowed.stitch_windows``
    relies on: one call a video with the host's per-frame window depths,
    left as they were, and the video back as one fp32 C-contiguous array,
    every window depth already fp32 C-contiguous (no frame converted)."""
    from vda_tpu_torch.infer import windowed as tw
    from vda_tpu_torch.utils import trace

    _, _, model, frames = setup
    calls = []
    stitch = tw.stitch_windows

    def checked(depth_list, **kw):
        copies = [d.copy() for d in depth_list]
        out = stitch(depth_list, **kw)
        calls.append(all(np.array_equal(d, c, equal_nan=True)
                         for d, c in zip(depth_list, copies)))
        return out

    monkeypatch.setattr(tw, "stitch_windows", checked)
    with trace.recording() as rec:
        got, _ = vt.infer_video_depth(model, frames, 24, input_size=56)
    assert calls == [True]
    assert got.shape == (40, 70, 90) and got.dtype == np.float32
    assert got.flags.c_contiguous
    spans = rec.snapshot()["spans"]
    stitched = [s for s in spans if s["name"] == "video.stitch"]
    assert [s["counters"] for s in stitched] == [
        {"stitch_converted_frames": 0}]

    # frames above torch's grain size, as views of one array a window (the
    # layout of the fetch): the threaded passes write none of them
    rng = np.random.default_rng(6)
    depth_list = list(rng.random((3 * 32, 240, 320), dtype=np.float32))
    copies = [d.copy() for d in depth_list]
    stitch(depth_list)
    for d, c in zip(depth_list, copies):
        np.testing.assert_array_equal(d.view(np.uint32), c.view(np.uint32))


def test_stitch_counts_and_converts_other_frames():
    """A frame that is not fp32 C-contiguous is copied to one and counted;
    the video is the stitch of those copies."""
    from vda_tpu_torch.infer.stitching import stitch_windows
    from vda_tpu_torch.utils import trace

    rng = np.random.default_rng(7)
    base = [rng.random((20, 30), dtype=np.float32) + 0.1 for _ in range(64)]
    mixed = list(base)
    mixed[3] = base[3].astype(np.float64)
    mixed[40] = np.asfortranarray(base[40])
    mixed[45] = base[45].T.copy().T  # a transposed view: not C-contiguous
    with trace.recording() as rec:
        with trace.span("video.stitch"):
            got = stitch_windows(mixed)
    (span,) = rec.snapshot()["spans"]
    assert span["counters"] == {"stitch_converted_frames": 3}
    np.testing.assert_array_equal(got, stitch_windows(base))
