"""The port's training CLI (``vda_tpu_torch.apps.train``): its three data
iterators against ``apps/train.py``'s originals, and ``main`` end to end on
the CPU: two synthetic steps, the exported ``.pth`` loaded strictly by both
packages, a resumed fine-tune from it, and the refusals."""

import json
import os

import numpy as np
import pytest
import torch

import apps.train as jtrain
from vda_tpu.config import get_config as jget_config
from vda_tpu.utils.convert import export_state_dict, load_torch_checkpoint

import vda_tpu_torch as vt
from vda_tpu_torch.apps import train as ttrain


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two torch threads: the suite's workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _same_batches(a, b, n):
    for _ in range(n):
        x, y = next(a), next(b)
        assert x.keys() == y.keys()
        for k in x:
            assert x[k].dtype == y[k].dtype, k
            np.testing.assert_array_equal(x[k], y[k])


@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_iter_equal(seed):
    _same_batches(jtrain.synthetic_iter(2, 3, 28, seed),
                  ttrain.synthetic_iter(2, 3, 28, seed), 2)


def _shards(path, videos):
    path.mkdir()
    rng = np.random.default_rng(1)
    for i, video in enumerate(videos):
        shape = video.shape[:4]
        np.savez(path / f"s{i}.npz", video=video,
                 depth=rng.random(shape).astype(np.float32),
                 mask=rng.random(shape) > 0.3)
    return str(path)


def test_npz_data_iter_equal(tmp_path):
    """uint8 and float shards, looped and not."""
    rng = np.random.default_rng(0)
    d = _shards(tmp_path / "ok", [
        (rng.random((1, 2, 28, 28, 3)) * 255).astype(np.uint8),
        rng.random((1, 2, 28, 28, 3)).astype(np.float32)])
    _same_batches(jtrain.npz_data_iter(d, patch=14),
                  ttrain.npz_data_iter(d, patch=14), 3)
    assert len(list(ttrain.npz_data_iter(d, loop=False))) == \
        len(list(jtrain.npz_data_iter(d, loop=False))) == 2


@pytest.mark.parametrize("case", ["normalized", "patch", "empty"])
def test_npz_data_iter_errors_equal(tmp_path, case):
    rng = np.random.default_rng(0)
    if case == "empty":
        d, err = str(tmp_path), FileNotFoundError
    elif case == "patch":
        d, err = _shards(tmp_path / "p", [
            (rng.random((1, 2, 30, 28, 3)) * 255).astype(np.uint8)]), \
            ValueError
    else:
        d, err = _shards(tmp_path / "n", [
            rng.standard_normal((1, 2, 28, 28, 3)).astype(np.float32) * 3]), \
            ValueError
    with pytest.raises(err) as ref:
        next(jtrain.npz_data_iter(d, patch=14))
    with pytest.raises(err) as got:
        next(ttrain.npz_data_iter(d, patch=14))
    assert str(got.value) == str(ref.value)


def _manifest(tmp_path, n=6):
    """A benchmark-extract manifest: one sequence of n 40x50 frames with
    16-bit depth PNGs (factor 1000), one of 2 frames."""
    import cv2

    rng = np.random.default_rng(4)
    root = tmp_path / "m"
    (root / "seq").mkdir(parents=True)
    seqs = {}
    for name, count in (("a", n), ("b", 2)):
        entries = []
        for i in range(count):
            img, dep = f"seq/{name}{i}.png", f"seq/{name}{i}_d.png"
            cv2.imwrite(str(root / img),
                        (rng.random((40, 50, 3)) * 255).astype(np.uint8))
            d = (rng.random((40, 50)) * 4000).astype(np.uint16)
            d[:5] = 0  # invalid pixels
            cv2.imwrite(str(root / dep), d)
            entries.append({"image": img, "gt_depth": dep, "factor": 1000.0})
        seqs[name] = entries
    path = root / "train.json"
    path.write_text(json.dumps({"ds": [{"a": seqs["a"]}, {"b": seqs["b"]}]}))
    return str(path)


@pytest.mark.parametrize("target", ["disparity", "depth"])
def test_manifest_clip_iter_equal(tmp_path, target):
    m = _manifest(tmp_path)
    kw = dict(batch=2, frames=3, size=28, seed=5, target=target)
    _same_batches(jtrain.manifest_clip_iter(m, **kw),
                  ttrain.manifest_clip_iter(m, **kw), 2)


def test_manifest_clip_iter_short_equal(tmp_path):
    m = _manifest(tmp_path, n=2)
    with pytest.raises(ValueError) as ref:
        next(jtrain.manifest_clip_iter(m, 1, 3, 28))
    with pytest.raises(ValueError) as got:
        next(ttrain.manifest_clip_iter(m, 1, 3, 28))
    assert str(got.value) == str(ref.value)


BASE = ["--encoder", "tiny", "--synthetic", "--frames", "4", "--size", "56",
        "--device", "cpu"]


def test_train_cli_exports_pth_both_load(tmp_path):
    """--synthetic --steps 2 --export-pth: the state after two steps, and a
    .pth that ``load_model_params`` and JAX's ``load_torch_checkpoint`` both
    load strictly, to the trained values."""
    pth, metrics = str(tmp_path / "w.pth"), str(tmp_path / "m.jsonl")
    state = ttrain.main(BASE + ["--steps", "2", "--export-pth", pth,
                                "--metrics", metrics])
    assert state.step == 2
    with open(metrics) as f:
        rows = [json.loads(line) for line in f]
    assert [r["step"] for r in rows] == [0, 1]
    assert all(np.isfinite(r["total_loss"]) for r in rows)
    trained = state.model.state_dict()
    init = vt.init_random(vt.get_config("tiny"),
                          torch.Generator().manual_seed(0),
                          device="cpu").state_dict()
    assert any(not torch.equal(init[k], trained[k]) for k in init)

    _, model = vt.load_model_params("tiny", checkpoint=pth, cast_bf16=False,
                                    device="cpu")
    loaded = model.state_dict()
    assert loaded.keys() == trained.keys()
    assert all(torch.equal(loaded[k], trained[k]) for k in trained)

    jcfg = jget_config("tiny")
    params = load_torch_checkpoint(pth, jcfg)  # strict
    back = export_state_dict(params, jcfg)
    assert back.keys() == trained.keys()
    for k, v in back.items():
        np.testing.assert_array_equal(v, trained[k].numpy(), err_msg=k)


def test_train_cli_from_pth_with_options(tmp_path):
    """A fine-tune from a .pth with the schedule, clipping, accumulation,
    augmentation, no prefetch and a checkpoint directory; then a rerun
    resumes at its last step."""
    pth = str(tmp_path / "w.pth")
    torch.save(vt.init_random(vt.get_config("tiny"),
                              torch.Generator().manual_seed(7),
                              device="cpu").state_dict(), pth)
    flags = BASE + ["--checkpoint", pth, "--schedule", "--warmup-steps", "1",
                    "--clip-norm", "1.0", "--accum", "2", "--augment-size",
                    "28", "--prefetch", "0", "--ckpt-dir",
                    str(tmp_path / "ckpt")]
    first = ttrain.main(flags + ["--steps", "2"])
    assert first.step == 2
    resumed = ttrain.main(flags + ["--steps", "3"])
    assert resumed.step == 3


@pytest.fixture(scope="module", autouse=True)
def tp2_ranks(tmp_path_factory):
    """The two ranks of ``test_train_cli_tp2_runs_and_resumes``, started
    with the module so that they run beside its other tests."""
    from tests import torch_ranks

    tmp = tmp_path_factory.mktemp("tp2")
    flags = BASE + ["--tp", "2", "--prefetch", "0", "--ckpt-dir",
                    str(tmp / "ckpt")]
    yield from torch_ranks.started_with_module(
        "body_cli_train", 2, tmp, torchrun=True, flags=flags)


def test_train_cli_tp2_runs_and_resumes(tp2_ranks):
    """``--tp 2`` on two gloo ranks under a torchrun environment: two
    synthetic steps, a checkpoint (written whole by rank 0) and a run
    resumed from it to step 3."""
    ranks = tp2_ranks.results()
    assert [r["steps"] for r in ranks] == [(2, 3), (2, 3)]
    ckpt = os.path.join(tp2_ranks.tmp, "ckpt")
    assert sorted(os.listdir(ckpt)) == [
        "step_00000002.pt", "step_00000003.pt"]


@pytest.mark.parametrize("flags,match", [
    (["--tp", "2"], "does not divide the world size 1"),
    (["--size", "50"], None),
], ids=["tp", "size"])
def test_train_cli_refusals(flags, match):
    with pytest.raises(SystemExit, match=match):
        ttrain.main(BASE + ["--steps", "1"] + flags)
