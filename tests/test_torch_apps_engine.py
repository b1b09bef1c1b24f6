"""The port's engine (``vda_tpu_torch.apps.engine``), Colab processor and
demo: the host-only copies held to ``apps/engine/``'s originals, one job on
a PNG sequence on the CPU, the CUDA-OOM ladder through each tier (an
injected ``_infer_fn``), the strategy tiers, the Colab processor against
JAX's on shared tiny weights, and the demo's exit without gradio."""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from apps import colab_processor as jcolab
from apps.engine import engine as jengine
from apps.engine import exr_to_prores as jexr
from apps.engine import metadata as jmeta
from apps.engine import sequence as jseq
from apps.engine import strategies as jstrat
from vda_tpu.config import get_config as jget_config
from vda_tpu.utils.convert import convert_state_dict

import vda_tpu_torch as vt
from vda_tpu_torch.apps import app as tapp
from vda_tpu_torch.apps import colab_processor as tcolab
from vda_tpu_torch.apps.engine import engine as tengine
from vda_tpu_torch.apps.engine import exr_to_prores as texr
from vda_tpu_torch.apps.engine import metadata as tmeta
from vda_tpu_torch.apps.engine import sequence as tseq
from vda_tpu_torch.apps.engine import strategies as tstrat

from tests.torch_port import rel_err


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two torch threads: the suite's workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _write_sequence(tmp_path, n=6, h=70, w=90, first=1, name="plate"):
    import cv2

    rng = np.random.default_rng(0)
    d = tmp_path / "seq"
    d.mkdir(exist_ok=True)
    for i in range(first, first + n):
        cv2.imwrite(str(d / f"{name}.{i:04d}.png"),
                    (rng.random((h, w, 3)) * 255).astype(np.uint8))
    return str(d / f"{name}.%04d.png")


# --- the copies ----------------------------------------------------------

PATHS = ["a/b_%04d.exr", "a/b.####.jpg", "a/b_%d.png", "a/b.mp4",
         "x.%05d.exr", "x.mov", "p.###.jpg", "shot_%3d.png"]


@pytest.mark.parametrize("path", PATHS)
def test_sequence_patterns_equal(path):
    assert tseq.detect_frame_pattern(path) == jseq.detect_frame_pattern(path)
    assert tseq.is_image_sequence(path) == jseq.is_image_sequence(path)
    for n in (0, 7, 42, 1001, 123456):
        assert tseq.format_frame_path(path, n) == \
            jseq.format_frame_path(path, n)


def test_read_image_sequence_equal(tmp_path):
    template = _write_sequence(tmp_path, n=4)
    for rng_ in ((1, 4), (1, 10), (2, 3)):
        (a, na), (b, nb) = (jseq.read_image_sequence(template, *rng_),
                            tseq.read_image_sequence(template, *rng_))
        np.testing.assert_array_equal(a, b)
        assert na == nb
    os.remove(template.replace("%04d", "0002"))
    for mod in (jseq, tseq):
        with pytest.raises(FileNotFoundError, match="missing frames"):
            mod.read_image_sequence(template, 1, 4)


def test_build_metadata_equal_but_software():
    """The one allowed difference of the copies: ``"software"``."""
    job = {"metric_depth": True, "floating_point": "full",
           "input_video": "/shots/a.%04d.exr", "first_frame": 1001,
           "last_frame": 1010, "exr_first_frame": 1, "exr_last_frame": 10,
           "enable_normalization": True, "normalization_near": 0.1,
           "normalization_far": 9.0, "invert_depth": True}
    args = (job, "vitl", "/c/video_depth_anything_vitl.pth")
    kw = dict(frame_range=(1001, 1010), extra={"k": 1})
    a, b = jmeta.build_metadata(*args, **kw), tmeta.build_metadata(*args, **kw)
    assert (a.pop("software"), b.pop("software")) == ("vda_tpu",
                                                      "vda_tpu_torch")
    a.pop("created"), b.pop("created")
    assert a == b


def test_sidecar_and_exr_helpers_equal(tmp_path):
    meta = {"a": 1, "b": [1, 2], "c": "x"}
    pa = jmeta.write_sidecar(str(tmp_path / "j"), meta)
    pb = tmeta.write_sidecar(str(tmp_path / "t"), meta)
    assert open(pa).read() == open(pb).read()
    assert tmeta.read_sidecar(str(tmp_path / "t")) == \
        jmeta.read_sidecar(str(tmp_path / "j")) == meta
    assert tmeta.read_sidecar(str(tmp_path / "none")) is None
    (tmp_path / "exr").mkdir()
    for i in range(3):
        (tmp_path / "exr" / f"d.{i:04d}.exr").write_bytes(b"")
    for p in (str(tmp_path / "exr"), str(tmp_path / "exr" / "d.####.exr"),
              str(tmp_path / "exr" / "d.0001.exr"), "a.png"):
        assert texr.is_exr_sequence(p) == jexr.is_exr_sequence(p)
    assert texr.list_exr_frames(str(tmp_path / "exr")) == \
        jexr.list_exr_frames(str(tmp_path / "exr"))
    img = np.linspace(-0.5, 1.5, 60, dtype=np.float32).reshape(4, 5, 3)
    np.testing.assert_array_equal(texr.acescg_to_srgb(img),
                                  jexr.acescg_to_srgb(img))


def test_engine_host_helpers_equal():
    depth = np.linspace(2.0, 7.0, 12, dtype=np.float32).reshape(3, 4)
    for near, far, inv in ((0.0, 1.0, False), (0.2, 0.9, True),
                           (5.0, 1.0, False)):
        np.testing.assert_array_equal(
            tengine.normalize_depth(depth, near, far, inv),
            jengine.normalize_depth(depth, near, far, inv))
    np.testing.assert_array_equal(
        tengine.normalize_depth(np.full((2, 2), 3.0), 0.2, 0.9, False),
        jengine.normalize_depth(np.full((2, 2), 3.0), 0.2, 0.9, False))
    for job, ck in (({"encoder": "vitb"}, "x_vitl.pth"),
                    ({}, "c/video_depth_anything_vitl.pth"), ({}, "w.pth")):
        assert tengine.detect_encoder(job, ck) == \
            jengine.detect_encoder(job, ck)
    for p in ("/s/plate.%04d.exr", "a\\b\\shot_####.png", "clip.mp4",
              "%04d.png"):
        assert tengine.derive_shot_name(p) == jengine.derive_shot_name(p)
        assert tengine.normalize_path(p) == jengine.normalize_path(p)
    frames = (np.random.default_rng(2).random((1, 2200, 4200, 3)) * 255) \
        .astype(np.uint8)
    a, b = (jengine.resize_frames_to_uhd_max(frames),
            tengine.resize_frames_to_uhd_max(frames))
    np.testing.assert_array_equal(a[0], b[0])
    assert a[1:] == b[1:]


def test_stabilize_and_upscale_equal():
    rng = np.random.default_rng(0)
    depths = rng.random((5, 32, 48)).astype(np.float32) * 5
    np.testing.assert_array_equal(
        tstrat.stabilize_depth_sequence(depths, temporal_window=3),
        jstrat.stabilize_depth_sequence(depths, temporal_window=3))
    for hw in ((64, 96), (32, 48)):
        np.testing.assert_array_equal(tstrat.upscale_depth(depths, hw),
                                      jstrat.upscale_depth(depths, hw))


# --- strategies ----------------------------------------------------------

def test_select_strategy_tiers():
    card = {"accelerator": "cuda", "accelerator_count": 1,
            "accelerator_memory_gb": 79.1}
    assert tstrat.select_strategy(card).name == "cuda_direct"
    assert tstrat.select_strategy(
        card, source_pixels=4096 * 2160).name == "cuda_conservative"
    assert tstrat.select_strategy(
        dict(card, accelerator_memory_gb=8.0)).name == "cuda_conservative"
    assert tstrat.select_strategy(card, device="cpu").name == "cpu"
    assert tstrat.STRATEGIES["cuda_direct"].input_size == 518
    assert not tstrat.STRATEGIES["cuda_direct"].fp32


def test_select_strategy_never_picks_cpu_unasked():
    """No card and no request for the CPU: an error, not the CPU tier."""
    none = {"accelerator": "cpu", "accelerator_count": 0,
            "accelerator_memory_gb": 0.0}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tstrat.select_strategy(none)
    hw = tstrat.detect_hardware()
    assert hw["accelerator"] == ("cuda" if torch.cuda.is_available()
                                 else "cpu")
    assert hw["cpu_count"] == os.cpu_count()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tstrat.select_strategy()
    assert tstrat.select_strategy(device="cpu").name == "cpu"


# --- jobs and the OOM ladder ---------------------------------------------

def test_job_on_png_sequence_cpu(tmp_path):
    """``main --job --device cpu``: the CLI's own loader (seeded tiny
    weights on the CPU), an auto strategy, normalisation and a
    visualisation, numbered from exr_first_frame."""
    template = _write_sequence(tmp_path, n=5)
    out = tmp_path / "out"
    job = {"input_video": template, "exr_output_dir": str(out),
           "first_frame": 1, "last_frame": 5, "floating_point": "full",
           "encoder": "tiny", "random_init": True, "input_size": 56,
           "exr_first_frame": 1001, "enable_normalization": True,
           "invert_depth": True, "create_depth_vis_mp4": True,
           "auto_strategy": True}
    (tmp_path / "job.json").write_text(json.dumps(job))
    assert tengine.main(["--job", str(tmp_path / "job.json"), "--device",
                         "cpu"]) == 0
    files = sorted(os.listdir(out))
    depth_files = [f for f in files if "_depth.10" in f]
    assert len(depth_files) == 5
    assert depth_files[0].endswith(("1001.exr", "1001.png"))
    assert "plate_vis.mp4" in files
    meta = json.load(open(out / "metadata.json"))
    assert meta["software"] == "vda_tpu_torch" and meta["encoder"] == "tiny"
    assert "processing_degradation" not in meta


@pytest.fixture()
def tiny_engine(monkeypatch):
    """An engine of device "cuda" whose model (seeded tiny) lives on the
    CPU, so that the ladder's card tiers run through an injected
    ``_infer_fn``."""
    model = vt.init_random(vt.get_config("tiny"),
                           torch.Generator().manual_seed(1), device="cpu")
    e = tengine.VideoDepthEngine(device="cuda")

    def fake_load(self, encoder, metric, checkpoint, random_init=False,
                  fp32=False):
        self._cfg, self._model = model.cfg, model
        self._model_key = (encoder, metric, checkpoint, random_init, fp32)

    monkeypatch.setattr(tengine.VideoDepthEngine, "_load_model", fake_load)
    return e


def _oom_until(calls, n_oom):
    """An injected infer that raises CUDA OOM on its first ``n_oom`` calls
    and runs the real driver (at input size 56) after them."""
    from vda_tpu_torch.infer.windowed import infer_video_depth

    def infer(model, frames, fps, input_size=518, fp32=False,
              micro_batch_size=4, attn_impl="auto"):
        calls.append((input_size, attn_impl, id(model)))
        if len(calls) <= n_oom:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried "
                                              "to allocate 2.00 GiB")
        return infer_video_depth(model, frames, fps, input_size=56,
                                 fp32=fp32, micro_batch_size=micro_batch_size,
                                 attn_impl=attn_impl)
    return infer


@pytest.mark.parametrize("n_oom,degraded", [
    (1, ["requested"]),
    (2, ["requested", "conservative_384"]),
], ids=["384", "chunked"])
def test_oom_ladder_reaches_each_tier(tiny_engine, tmp_path, n_oom,
                                      degraded):
    """CUDA OOM on the first n tiers: the job completes on the next one,
    with the engine's own model, degraded and reported so in its status
    and metadata."""
    calls = []
    tiny_engine._infer_fn = _oom_until(calls, n_oom)
    out = tmp_path / "out"
    result = tiny_engine.process_job({
        "input_video": _write_sequence(tmp_path, n=4),
        "exr_output_dir": str(out), "first_frame": 1, "last_frame": 4,
        "encoder": "tiny", "input_size": 518})
    assert result["status"] == "success", result
    assert result["degraded"] == degraded
    assert "degraded after OOM" in result["message"]
    assert json.load(open(out / "metadata.json"))[
        "processing_degradation"] == degraded
    assert [c[0] for c in calls] == [518, 384, 224][:n_oom + 1]
    assert {c[1:] for c in calls} == {("auto", id(tiny_engine._model))}


@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_oom_on_every_tier_fails_the_job(tiny_engine, tmp_path, device):
    """An OOM on the last tier fails the job with the tiers it tried in its
    status; no tier moves the model to another device."""
    calls = []
    tiny_engine.device = device
    tiny_engine._infer_fn = _oom_until(calls, 99)
    result = tiny_engine.process_job({
        "input_video": _write_sequence(tmp_path, n=2),
        "exr_output_dir": str(tmp_path / "o"), "first_frame": 1,
        "last_frame": 2, "encoder": "tiny", "input_size": 518})
    assert result["status"] == "error" and "out of memory" in \
        result["message"]
    assert result["degraded"] == ["requested", "conservative_384",
                                  "chunked_224"]
    assert [c[0] for c in calls] == [518, 384, 224]
    assert {c[1:] for c in calls} == {("auto", id(tiny_engine._model))}


@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_errors_not_retried(tiny_engine, tmp_path, device):
    """A failure other than CUDA OOM surfaces at once, on either device."""
    calls = []

    def broken(model, frames, fps, **kw):
        calls.append(kw["input_size"])
        raise ValueError("bad frames")

    tiny_engine.device = device
    tiny_engine._infer_fn = broken
    result = tiny_engine.process_job({
        "input_video": _write_sequence(tmp_path, n=2),
        "exr_output_dir": str(tmp_path / "o"), "first_frame": 1,
        "last_frame": 2, "encoder": "tiny", "input_size": 518})
    assert result["status"] == "error" and "degraded" not in result
    assert calls == [518]


# --- the Colab processor and the demo ------------------------------------

def test_colab_matches_jax(tmp_path, monkeypatch):
    """One sequence of plates numbered from 1001: the port's depths, read
    back from what it wrote, within the fp32 driver's bound of JAX's."""
    jcfg = jget_config("tiny")
    model = vt.init_random(vt.get_config("tiny"),
                           torch.Generator().manual_seed(4), device="cpu")
    params = convert_state_dict(
        {k: v.numpy() for k, v in model.state_dict().items()}, jcfg)

    def jinit(self, **kw):
        self.cfg, self.params, self.input_size, self.fp32 = (jcfg, params,
                                                             56, True)

    def tinit(self, **kw):
        self.cfg, self.model, self.input_size, self.fp32 = (model.cfg, model,
                                                            56, True)

    monkeypatch.setattr(jcolab.BatchSequenceProcessor, "__init__", jinit)
    monkeypatch.setattr(tcolab.BatchSequenceProcessor, "__init__", tinit)
    template = _write_sequence(tmp_path, n=5, first=1001, name="shot")

    def config(out):
        return {"sh010": {"template": template, "first_frame": 1001,
                          "last_frame": 1005, "output_dir": str(out),
                          "save_vis_mp4": True}}

    ref = jcolab.process_batch_sequences(config(tmp_path / "j"))["sh010"]
    got = tcolab.process_batch_sequences(config(tmp_path / "t"),
                                         device="cpu")["sh010"]
    assert [os.path.basename(p) for p in got] == \
        [os.path.basename(p) for p in ref]
    assert os.path.basename(got[0]).startswith("depth.1001.")
    assert (tmp_path / "t" / "depth_vis.mp4").exists()
    for a, b in zip(ref, got):
        assert rel_err(_read_depth(a), _read_depth(b)) <= 1e-5


def _read_depth(path):
    if path.endswith(".npy"):
        return np.load(path)
    os.environ.setdefault("OPENCV_IO_ENABLE_OPENEXR", "1")
    import cv2

    return cv2.imread(path, cv2.IMREAD_UNCHANGED)


def test_demo_exits_without_gradio():
    if importlib.util.find_spec("gradio") is not None:
        pytest.skip("gradio is installed: the demo builds")
    with pytest.raises(SystemExit, match="gradio"):
        tapp.build_demo(random_init=True, device="cpu")
