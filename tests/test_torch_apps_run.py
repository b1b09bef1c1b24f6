"""The port's offline CLI (``vda_tpu_torch.apps.run``) and benchmark
inference (``vda_tpu_torch.apps.benchmark_infer``) against the JAX
package's (``apps/run.py``, ``benchmark/infer/infer.py``) on shared tiny
weights: the port's seeded model's reference-format state dict, loaded
strictly into JAX params by ``convert_state_dict`` (JAX's own init of the
tiny model compiles for ~15 s on the CPU), both CLIs given their model
through their module's ``load_model``."""

import json
import os

import numpy as np
import pytest

import torch

from vda_tpu.config import get_config as jget_config
from vda_tpu.utils.convert import convert_state_dict

import vda_tpu_torch as vt
from vda_tpu_torch.apps import benchmark_infer
from vda_tpu_torch.apps import run as trun
from vda_tpu_torch.utils import io as tio

from tests.torch_port import rel_err


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two torch threads: the suite's workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

# tests/test_torch_windowed.py's bound for the fp32 windowed driver
TOL = 1e-5


@pytest.fixture(scope="module")
def test_video(tmp_path_factory):
    """tests/test_cli.py's clip: 40 frames of 70x90, a rolled texture."""
    import cv2

    path = str(tmp_path_factory.mktemp("vid") / "clip.mp4")
    rng = np.random.default_rng(0)
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 12, (90, 70))
    base = (rng.random((70, 90, 3)) * 255).astype(np.uint8)
    for i in range(40):
        w.write(np.roll(base, i * 2, axis=1)[:, :, ::-1].copy())
    w.release()
    return path


@pytest.fixture(scope="module")
def shared():
    """(JAX cfg, JAX params, port model) of the tiny config, one set of
    weights."""
    jcfg = jget_config("tiny")
    model = vt.init_random(vt.get_config("tiny"),
                           torch.Generator().manual_seed(3), device="cpu")
    params = convert_state_dict(
        {k: v.numpy() for k, v in model.state_dict().items()}, jcfg)
    return jcfg, params, model


@pytest.fixture()
def loaders(shared, monkeypatch):
    """Both CLIs' ``load_model`` return the shared weights."""
    import apps.run as jrun

    jcfg, params, model = shared
    monkeypatch.setattr(jrun, "load_model", lambda args: (jcfg, params))
    monkeypatch.setattr(trun, "load_model", lambda args: (model.cfg, model))


def test_run_cli_matches_jax(loaders, test_video, tmp_path):
    """--save_npz --fp32 depths within the windowed driver's bound of JAX's
    CLI, and every output file JAX writes."""
    from apps.run import main as jmain

    flags = ["--input_video", test_video, "--input_size", "56", "--fp32",
             "--save_npz", "--save_exr", "--grayscale"]
    ref = jmain(flags + ["--output_dir", str(tmp_path / "jax")])
    got = trun.main(flags + ["--output_dir", str(tmp_path / "port"),
                             "--device", "cpu"])
    assert got.shape == (40, 70, 90) and np.isfinite(got).all()
    assert rel_err(ref, got) <= TOL
    out = tmp_path / "port"
    assert sorted(os.listdir(out)) == sorted(os.listdir(tmp_path / "jax"))
    npz = np.load(out / "clip_depths.npz")["depths"]
    np.testing.assert_array_equal(npz, got)
    assert rel_err(np.load(tmp_path / "jax" / "clip_depths.npz")["depths"],
                   npz) <= TOL
    assert len(os.listdir(out / "clip_depths_exr")) == 40


def test_run_cli_random_init_metric(test_video, tmp_path):
    """The CLI's own loader (seeded weights on the CPU) and the metric
    outputs: one PLY point cloud a frame."""
    out = tmp_path / "metric"
    depths = trun.main(["--input_video", test_video, "--output_dir",
                        str(out), "--encoder", "tiny", "--random-init",
                        "--device", "cpu", "--input_size", "56", "--metric",
                        "--max_len", "8"])
    assert depths.shape == (8, 70, 90) and np.isfinite(depths).all()
    plys = sorted(f for f in os.listdir(out) if f.endswith(".ply"))
    assert plys == [f"point{i:04d}.ply" for i in range(8)]
    with open(out / plys[0], "rb") as f:
        assert f.read().startswith(b"ply\nformat binary_little_endian 1.0\n"
                                   b"element vertex 6300\n")


@pytest.mark.parametrize("flags", [["--tp", "2"]], ids=["tp"])
def test_run_cli_refuses_unported(flags, tmp_path):
    """``--tp 2`` in a world of one process: the degree does not divide
    the world size (JAX's CLI exits alike on its devices)."""
    with pytest.raises(SystemExit, match="does not divide the world size 1"):
        trun.main(["--input_video", str(tmp_path / "x.mp4"), "--device",
                   "cpu", "--random-init"] + flags)


@pytest.fixture(scope="module", autouse=True)
def tp2_ranks(test_video, tmp_path_factory):
    """The two ranks of ``test_run_cli_tp2_matches_direct_call``, started
    with the module so that they run beside its other tests."""
    from tests import torch_ranks

    tmp = tmp_path_factory.mktemp("tp2")
    flags = ["--input_video", test_video, "--output_dir", str(tmp / "out"),
             "--encoder", "tiny", "--random-init", "--device", "cpu",
             "--input_size", "56", "--fp32", "--tp", "2"]
    yield from torch_ranks.started_with_module(
        "body_cli_run", 2, tmp, torchrun=True, flags=flags)


def test_run_cli_tp2_matches_direct_call(tp2_ranks):
    """``--tp 2`` on two gloo ranks under a torchrun environment: each
    rank's depths bit-identical to ``infer_video_depth(mesh=)`` on the
    model and frames the CLI loads, and rank 0 alone writes."""
    ranks = tp2_ranks.results()
    out = os.path.join(tp2_ranks.tmp, "out")
    for r in ranks:
        assert r["world"] == 2
        assert r["cli"].shape == (40, 70, 90)
        np.testing.assert_array_equal(r["cli"], r["direct"])
    assert sorted(os.listdir(out)) == ["clip_src.mp4", "clip_vis.mp4"]


def test_run_cli_window_batch(loaders, test_video, tmp_path):
    """``--window-batch 2`` on the CPU: the clip's two windows in one
    forward give the depths of one window a forward, within ``TOL``."""
    flags = ["--input_video", test_video, "--input_size", "56", "--fp32",
             "--device", "cpu"]
    one = trun.main(flags + ["--output_dir", str(tmp_path / "wb1")])
    two = trun.main(flags + ["--output_dir", str(tmp_path / "wb2"),
                             "--window-batch", "2"])
    assert two.shape == one.shape == (40, 70, 90)
    assert rel_err(one, two) <= TOL


def test_run_cli_swiglu_rope_model(test_video, tmp_path, monkeypatch):
    """The tiny model with vitg's SwiGLU encoder and RoPE motion modules
    (``load_model`` overridden with the config) through the CLI on the
    CPU: the depths of ``infer_video_depth`` on the model it loaded."""
    from dataclasses import replace

    from vda_tpu_torch.utils.loader import load_model_params

    cfg = vt.get_config("tiny", pe="rope")
    cfg = cfg.replace(vit=replace(cfg.vit, ffn_layer="swiglufused"))
    loaded = []

    def load_model(args):
        loaded.append(load_model_params(
            args.encoder, cfg=cfg, random_init=True, cast_bf16=False,
            device=args.device, generator=torch.Generator().manual_seed(1)))
        return loaded[-1]

    monkeypatch.setattr(trun, "load_model", load_model)
    got = trun.main(["--input_video", test_video, "--output_dir",
                     str(tmp_path), "--encoder", "tiny", "--random-init",
                     "--device", "cpu", "--input_size", "56", "--fp32",
                     "--max_len", "8"])
    _, model = loaded[0]
    assert hasattr(model.pretrained.blocks[0].mlp, "w12")
    frames, fps = tio.read_video_frames(test_video, 8)
    want, _ = vt.infer_video_depth(model, frames, fps, input_size=56,
                                   fp32=True)
    assert got.shape == (8, 70, 90) and np.isfinite(got).all()
    np.testing.assert_array_equal(got, want)


def test_example_video_equals_jax(tmp_path):
    """The default clip the CLI makes when the example is missing is the
    one ``apps/run.py`` makes (examples/make_test_video.py, by file path)."""
    from apps.run import _ensure_example_video as jensure

    a, b = tmp_path / "a" / "clip.mp4", tmp_path / "b" / "clip.mp4"
    jensure(str(a))
    trun._ensure_example_video(str(b))
    assert a.read_bytes() == b.read_bytes()
    frames, _ = tio.read_video_frames(str(b))
    assert frames.shape == (64, 210, 320, 3)


def _scene(tmp_path):
    """A manifest (benchmark/dataset_extract layout) of one 8-frame scene of
    70x90 PNGs."""
    import cv2

    rng = np.random.default_rng(5)
    root = tmp_path / "bench"
    (root / "ds" / "scene").mkdir(parents=True)
    entries = []
    for i in range(8):
        rel = f"ds/scene/{i:04d}.png"
        cv2.imwrite(str(root / rel),
                    (rng.random((70, 90, 3)) * 255).astype(np.uint8))
        entries.append({"image": rel, "gt_depth": rel, "factor": 1.0})
    manifest = root / "ds_video.json"
    manifest.write_text(json.dumps({"ds": [{"scene": entries}]}))
    return manifest


def test_benchmark_infer_matches_jax(loaders, tmp_path):
    """One .npy a frame at the image's path, fp32 depths within the
    windowed driver's bound of ``benchmark/infer/infer.py``'s."""
    from benchmark.infer.infer import main as jmain

    manifest = _scene(tmp_path)
    flags = ["--json_file", str(manifest), "--datasets", "ds",
             "--input_size", "56"]
    jmain(flags + ["--infer_path", str(tmp_path / "jax")])
    benchmark_infer.main(flags + ["--infer_path", str(tmp_path / "port"),
                                  "--device", "cpu"])
    names = sorted(os.listdir(tmp_path / "port" / "ds" / "ds" / "scene"))
    assert names == [f"{i:04d}.npy" for i in range(8)]
    for name in names:
        got = np.load(tmp_path / "port" / "ds" / "ds" / "scene" / name)
        ref = np.load(tmp_path / "jax" / "ds" / "ds" / "scene" / name)
        assert got.shape == (70, 90) and got.dtype == np.float32
        assert rel_err(ref, got) <= TOL
