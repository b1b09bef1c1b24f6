"""The plain reference against the program at the tiny configurations
(the GELU MLP and vitg's SwiGLU) in fp32 on the CPU: windows, stitching
and the stream; its weights' layout against the program's state dict; and
its operation count."""

import hashlib
import json

import numpy as np
import pytest
import torch

from h100_bench import harness
from h100_bench.reference import flops
from h100_bench.reference import protocol as P
from h100_bench.reference.model import Reference
from h100_bench.reference.weights import ffn_hidden, make_state_dict, specs
from h100_bench.tests import tiny_cells

BENCH = harness.read_json(f"{harness.ROOT}/BENCHMARK.json")
# vitg at the port's widths (vda_tpu_torch/config.py MODEL_CONFIGS): DINOv2
# vit_giant2 and Depth-Anything-V2 run.py model_configs['vitg']
VITG = dict(harness.read_json(f"{harness.HERE}/configs/vitl.json"),
            name="vitg", features=384, out_channels=[1536] * 4,
            intermediate_layer_idx=[9, 19, 29, 39])
VITG["encoder"] = dict(VITG["encoder"], embed_dim=1536, depth=40,
                       num_heads=24, ffn_layer="swiglufused")
# sha256 of specs() as JSON, as the benchmark drew vitl's and vits' weights
# before the SwiGLU layout: the same seed gives the same weights
SPECS_SHA256 = {
    "vitl": "70e3393212da6fef9817bf8d70d6c838848a1e1b54fd229976208576b204eae7",
    "vits": "01e30d70c6238833e2a641b61746300a2b0886a16aa1135025219c69db8d97ae",
}


def _config(name):
    if name == "vitg":
        return VITG
    entry = {c["name"]: c for c in BENCH["configs"]}[name]
    return harness.read_json(f"{harness.ROOT}/{entry['file']}")


def _tiny(config):
    cfg = tiny_cells.cell("vits.offline_480p", config).cfg
    sd = make_state_dict(cfg, 2 ** 40 + 17, "cpu")
    model = harness.build_model(dict(cfg, dtype="float32"), 2 ** 40 + 17,
                                "cpu")
    return cfg, Reference(cfg, sd), model


def _frames(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.random((n, 50, 80, 3)) * 255).astype(np.uint8)


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]]
                         + ["vitg"])
def test_weights_match_the_program_layout(name):
    from vda_tpu_torch.models.vda import VideoDepthAnything

    cfg = _config(name)
    model = VideoDepthAnything(harness.port_config(cfg), device="meta")
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert {k: s for k, s, _, _ in specs(cfg)} == want


@pytest.mark.parametrize("name", sorted(SPECS_SHA256))
def test_specs_are_pinned(name):
    got = hashlib.sha256(json.dumps(specs(_config(name))).encode())
    assert got.hexdigest() == SPECS_SHA256[name]


def test_ffn_hidden_follows_dinov2():
    assert ffn_hidden(VITG["encoder"]) == 4096
    assert ffn_hidden(_config("vitl")["encoder"]) == 4096
    with pytest.raises(ValueError, match="ffn_layer"):
        specs(dict(VITG, encoder=dict(VITG["encoder"], ffn_layer="swiglu")))


def test_swiglu_counts_its_own_products():
    """The SwiGLU tiny's window exceeds the MLP tiny's by the w12 / w3
    products less the fc1 / fc2 products of every token of every block."""
    mlp, swi = (tiny_cells.cell("vits.offline_480p", c).cfg
                for c in tiny_cells.CONFIGS)
    net_hw, frames = (56, 70), 32
    enc = mlp["encoder"]
    d, tokens = enc["embed_dim"], 4 * 5 + 1
    h_mlp, h_swi = ffn_hidden(enc), ffn_hidden(swi["encoder"])
    per_token = 2 * (d * 2 * h_swi + h_swi * d) - 2 * (d * h_mlp + h_mlp * d)
    assert per_token > 0
    assert flops.window_flops(swi, net_hw, frames) - flops.window_flops(
        mlp, net_hw, frames) == enc["depth"] * frames * tokens * per_token


@pytest.mark.parametrize("config", tiny_cells.CONFIGS)
def test_windows_and_stitching_match_the_program(config):
    from vda_tpu_torch.infer import windowed

    cfg, ref, model = _tiny(config)
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


@pytest.mark.parametrize("config", tiny_cells.CONFIGS)
def test_stream_replay_matches_the_program(config):
    from vda_tpu_torch.infer.streaming import StreamingDepth

    cfg, ref, model = _tiny(config)
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


@pytest.mark.parametrize("config", tiny_cells.CONFIGS)
def test_fp8_control_departs_from_fp32(config):
    cfg, ref, _ = _tiny(config)
    low = Reference(cfg, ref.sd, fp8=True)
    frames = _frames(32)
    with torch.no_grad():
        r = P.window_depth(ref, frames, 0, 56, "cpu")
        c = P.window_depth(low, frames, 0, 56, "cpu")
    assert max(harness.frame_errors(c, r)) > 0.1
