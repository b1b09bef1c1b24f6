"""Benchmark dress rehearsal of the port: the user-facing chain with the
port's inference, as ``tests/test_benchmark_dress_rehearsal.py`` runs it
for JAX.  As subprocesses, with no monkeypatching:

    benchmark/dataset_extract/extract.py   (4 raw mini-datasets)
    python -m vda_tpu_torch.apps.benchmark_infer
                                 (tiny encoder, random init, --device cpu,
                                  real windowed inference -> per-frame .npy)
    sh benchmark/eval/eval.sh      (sintel scannet kitti bonn)
    sh benchmark/eval/eval_tae.sh  (scannet TAE protocol)

The raw datasets, the rewrite of the GT from the predictions (so that
delta1 ~ 1) and the reading of results.txt are that file's own builders,
imported; the TAE ~ 0 pass overwrites every TAE prediction with the first
(the scene's frames are identical and its poses identity).
"""

from __future__ import annotations

import sys

import numpy as np

from tests.test_benchmark_dress_rehearsal import (
    REPO,
    _make_raw_datasets,
    _parse_results,
    _rewrite_gt_from_preds,
    _run,
)

DATASETS = ("sintel", "scannet", "kitti", "bonn")


def test_torch_benchmark_shell_chain(tmp_path, monkeypatch):
    # two torch threads a subprocess: the suite's workers share the cores
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    raw = tmp_path / "raw"
    raw.mkdir()
    _make_raw_datasets(raw)
    bench_root = tmp_path / "benchmark_root"
    preds = tmp_path / "preds"

    ex = f"{REPO}/benchmark/dataset_extract/extract.py"
    _run([sys.executable, ex, "kitti", "--root", str(raw / "kitti_rgb"),
          "--depth-root", str(raw / "kitti_depth"),
          "--saved-dir", str(bench_root)])
    _run([sys.executable, ex, "bonn", "--root", str(raw / "bonn"),
          "--saved-dir", str(bench_root)])
    _run([sys.executable, ex, "sintel", "--root", str(raw / "sintel_clean"),
          "--depth-root", str(raw / "sintel_depth"),
          "--saved-dir", str(bench_root)])
    _run([sys.executable, ex, "scannet", "--root", str(raw / "scannet"),
          "--saved-dir", str(bench_root)])

    infer = [sys.executable, "-m", "vda_tpu_torch.apps.benchmark_infer",
             "--infer_path", str(preds), "--encoder", "tiny",
             "--random-init", "--input_size", "56", "--device", "cpu"]
    for ds in DATASETS:
        _run(infer + ["--json_file", str(bench_root / ds / f"{ds}_video.json"),
                      "--datasets", ds])
    _run(infer + ["--json_file",
                  str(bench_root / "scannet" / "scannet_video_tae.json"),
                  "--datasets", "scannet"])

    for ds in DATASETS:
        _rewrite_gt_from_preds(str(bench_root), str(preds), ds)
    _run(["sh", "benchmark/eval/eval.sh", str(preds), str(bench_root)])

    _run(["sh", "benchmark/eval/eval_tae.sh", str(preds), str(bench_root)])
    tae_npys = sorted((preds / "scannet" / "scene0000_00"
                       / "color_origin").glob("*.npy"))
    assert len(tae_npys) == 12
    first = np.load(tae_npys[0])
    for p in tae_npys[1:]:
        np.save(p, first)
    _run(["sh", "benchmark/eval/eval_tae.sh", str(preds), str(bench_root)])

    res = _parse_results(preds / "results.txt")
    for ds in DATASETS:
        assert res[ds]["delta1_acc"] > 0.995, (ds, res[ds])
        assert res[ds]["abs_relative_difference"] < 0.03, (ds, res[ds])
    assert len(res["tae_runs"]) == 2
    assert np.isfinite(res["tae_runs"][0])
    assert res["tae_runs"][1] < 0.05, res["tae_runs"]
