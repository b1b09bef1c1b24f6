"""The plain reference against the program at the tiny configuration in
fp32 on the CPU: windows, stitching and the stream; and its weights'
layout against the program's state dict."""

import numpy as np
import pytest
import torch

from h100_bench import harness
from h100_bench.reference import protocol as P
from h100_bench.reference.model import Reference
from h100_bench.reference.weights import make_state_dict, specs
from h100_bench.tests import tiny_cells


def _tiny():
    cfg = tiny_cells.cell("vits.offline_480p").cfg
    sd = make_state_dict(cfg, 2 ** 40 + 17, "cpu")
    model = harness.build_model(dict(cfg, dtype="float32"), 2 ** 40 + 17,
                                "cpu")
    return cfg, Reference(cfg, sd), model


def _frames(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.random((n, 50, 80, 3)) * 255).astype(np.uint8)


@pytest.mark.parametrize("name", ["vitl", "vits"])
def test_weights_match_the_program_layout(name):
    from vda_tpu_torch.models.vda import VideoDepthAnything

    cfg = harness.read_json(f"{harness.HERE}/configs/{name}.json")
    model = VideoDepthAnything(harness.port_config(cfg), device="meta")
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert {k: s for k, s, _, _ in specs(cfg)} == want


def test_windows_and_stitching_match_the_program():
    from vda_tpu_torch.infer import windowed

    cfg, ref, model = _tiny()
    frames = _frames(50)
    captured = []
    real = windowed.stitch_windows
    windowed.stitch_windows = lambda d, **kw: captured.append(d) or real(
        d, **kw)
    try:
        out, _ = windowed.infer_video_depth(model, frames, 30.0,
                                            input_size=56, fp32=True)
    finally:
        windowed.stitch_windows = real
    raw = captured[0]
    assert len(raw) == 32 * len(P.window_inputs(50))
    for w in range(len(P.window_inputs(50))):
        with torch.no_grad():
            r = P.window_depth(ref, frames, w, 56, "cpu")
        p = torch.from_numpy(np.stack(raw[32 * w:32 * (w + 1)]))
        assert max(harness.frame_errors(p, r)) < 1e-4
    s = P.stitch(raw)[:50]
    assert np.abs(s - out).max() <= 1e-5 * np.abs(out).max()


def test_window_inputs_follow_the_keyframe_recursion():
    win = P.window_inputs(50)
    assert win[0] == list(range(32))
    assert win[1][:10] == [win[0][k] for k in P.KEYFRAMES]
    assert win[1][10:] == list(range(32, 50)) + [49] * 4
    assert win[2][:10] == [win[1][k] for k in P.KEYFRAMES]


def test_stream_replay_matches_the_program():
    from vda_tpu_torch.infer.streaming import StreamingDepth

    cfg, ref, model = _tiny()
    frames = _frames(10, seed=1)
    stream = StreamingDepth(model, input_size=56, fp32=True)
    out = [stream.submit(frames[0]).numpy()]
    for i in range(1, 57, 4):
        out += list(stream.submit_group(
            frames[[(i + j) % 10 for j in range(4)]]).numpy())
    replay = P.StreamReplay(
        ref, lambda i: (torch.from_numpy(frames[i % 10]), i % 10), 56, "cpu")
    with torch.no_grad():
        for i, d in enumerate(out):
            r = replay.step(True)
            assert harness.frame_errors(torch.from_numpy(d)[None],
                                        r[None])[0] < 1e-4, i
    assert len(replay.taps) == 10  # each distinct frame encoded once


def test_fp8_control_departs_from_fp32():
    cfg, ref, _ = _tiny()
    low = Reference(cfg, ref.sd, fp8=True)
    frames = _frames(32)
    with torch.no_grad():
        r = P.window_depth(ref, frames, 0, 56, "cpu")
        c = P.window_depth(low, frames, 0, 56, "cpu")
    assert max(harness.frame_errors(c, r)) > 0.1
