"""The window driver's double-buffered dispatch on the CPU: batch n+1
enqueued before batch n is fetched gives, bit for bit, what one batch at a
time gives.

Each case runs ``infer_video_depth`` on 60x80 frames of the stock tiny
model at input 56, and a serial loop of ``_window_step`` and
``stitch_windows`` written here, over 1 to 4 windows at one and two windows
a batch (three windows at two: a padded last batch).
"""

import numpy as np
import pytest
import torch

import vda_tpu_torch as vt
from vda_tpu_torch.infer import windowed as tw
from vda_tpu_torch.utils import knobs, trace
from vda_tpu_torch.utils.transform import (
    compute_resize_hw,
    effective_input_size,
)

H, W = 60, 80
SIZE = 56
# frames -> windows: 22 a window after the first
FRAMES = {1: 10, 2: 30, 3: 50, 4: 70}


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Two torch threads: the tier-1 run's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def model():
    return vt.init_random(vt.get_config("tiny"),
                          torch.Generator().manual_seed(0),
                          device="cpu").requires_grad_(False)


@pytest.fixture(scope="module")
def frames():
    return (np.random.default_rng(2).random((max(FRAMES.values()), H, W, 3))
            * 255).astype(np.uint8)


def _serial(model, frames, window_batch):
    """One batch at a time: upload, step, fetch, then the next batch.
    Returns (depths, progress calls)."""
    n = frames.shape[0]
    idx = tw.window_source_indices(n)
    n_windows = idx.shape[0]
    wb = max(1, min(window_batch, n_windows))
    net_hw = compute_resize_hw(H, W, effective_input_size(H, W, SIZE))
    fuse_proj = knobs.fuse_proj(None, "auto")
    resize_kernel = knobs.resize_kernel(None, "auto")
    host, seen = [], []
    for start in range(0, n_windows, wb):
        batch = idx[start:start + wb]
        n_valid = batch.shape[0]
        if n_valid < wb:
            batch = np.concatenate([batch, batch[-1:].repeat(wb - n_valid,
                                                             0)])
        d = tw._window_step(model, torch.from_numpy(frames[batch]), net_hw,
                            (H, W), torch.bfloat16, "auto", 16, fuse_proj,
                            resize_kernel)
        host.extend(d[:n_valid].flatten(0, 1).float().numpy())
        seen.append((start + n_valid, n_windows))
    aligned = tw.stitch_windows(host, metric=model.cfg.metric)
    return np.asarray(aligned[:n]), seen


@pytest.mark.parametrize("window_batch", [1, 2])
@pytest.mark.parametrize("n_windows", sorted(FRAMES))
def test_pipelined_equals_serial(model, frames, monkeypatch, n_windows,
                                 window_batch):
    clip = frames[:FRAMES[n_windows]]
    ref, ref_seen = _serial(model, clip, window_batch)
    captured = []
    stitch = tw.stitch_windows

    def capture(depth_list, *args, **kwargs):
        captured.append(depth_list)
        return stitch(depth_list, *args, **kwargs)

    monkeypatch.setattr(tw, "stitch_windows", capture)
    seen = []
    with trace.recording() as rec:
        got, fps = vt.infer_video_depth(
            model, clip, 30.0, input_size=SIZE, window_batch=window_batch,
            progress=lambda done, n: seen.append((done, n)))
    assert fps == 30.0 and got.dtype == np.float32
    assert got.shape == ref.shape == (clip.shape[0], H, W)
    assert np.array_equal(got, ref)
    assert seen == ref_seen
    spans = rec.snapshot()["spans"]
    steps = [s for s in spans if s["name"] == "window.step"]
    assert len(steps) == len(ref_seen)
    assert sum(s["counters"].get("overlapped", 0) for s in steps) == \
        len(ref_seen) - 1
    # the window depths handed to the stitch are the caller's: a second
    # video leaves them as they were
    (first,) = captured
    kept = [np.array(a) for a in first]
    assert len(first) == 32 * n_windows
    assert all(a.dtype == np.float32 and a.flags.c_contiguous
               for a in first)
    vt.infer_video_depth(model, frames[::-1][:FRAMES[n_windows]].copy(),
                         30.0, input_size=SIZE, window_batch=window_batch)
    assert len(captured) == 2
    assert all(np.array_equal(a, b) for a, b in zip(first, kept))


def test_staging_is_kept_for_the_next_video(model, frames, monkeypatch):
    """One ``_Staging`` a device serves video after video; a video that
    raises returns it all the same."""
    monkeypatch.setattr(tw, "_STAGING", {})
    vt.infer_video_depth(model, frames[:10], 30.0, input_size=SIZE)
    (staging,) = tw._STAGING[torch.device("cpu")]
    assert staging.copy_stream is None and staging.host is None
    assert staging.upload.slots == [None, None]

    def fail(*args, **kwargs):
        raise RuntimeError("step")

    monkeypatch.setattr(tw, "_window_step", fail)
    with pytest.raises(RuntimeError, match="step"):
        vt.infer_video_depth(model, frames[:10], 30.0, input_size=SIZE)
    assert tw._STAGING[torch.device("cpu")] == [staging]
