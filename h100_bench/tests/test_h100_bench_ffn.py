"""The encoder feed-forward's metrics (``offline.ffn_ms_per_frame``,
``offline.ffn_roofline``) on synthetic records, and the least work they
are read against (``reference/ffn_work.py``) by hand."""

import os

import pytest

from h100_bench import harness
from h100_bench.reference import protocol as P
from h100_bench.reference.ffn_work import ffn_work

CONFIGS = os.path.join(harness.HERE, "configs")
NAMES = ("offline.ffn_ms_per_frame", "offline.ffn_roofline")
TRAFFIC = {"frame_hw": [720, 1280], "input_size": 518}
NET = (518, 924)  # 37 x 66 patches: 2443 tokens a frame with the cls token


def _cfg(name):
    return harness.read_json(os.path.join(CONFIGS, name + ".json"))


def test_net_size_of_the_hd_traffic():
    assert P.net_size(720, 1280, 518, 14) == NET


@pytest.mark.parametrize("name,ops,nbytes", [
    # vitl, GELU MLP: d 1024, hidden 4096; 2·tok·(d·h + h·d) a block
    ("vitl", 2 * 32 * 2443 * (1024 * 4096 + 4096 * 1024),
     2 * (2 * 32 * 2443 * 1024 + 1024 * 4096 + 4096 + 4096 * 1024 + 1024)),
    # vitg, SwiGLU: d 1536, hidden 4096; 2·tok·(d·2h + h·d) a block
    ("vitg", 2 * 32 * 2443 * (1536 * 8192 + 4096 * 1536),
     2 * (2 * 32 * 2443 * 1536 + 1536 * 8192 + 8192 + 4096 * 1536 + 1536)),
])
def test_counts_by_hand(name, ops, nbytes):
    cfg = _cfg(name)
    depth = cfg["encoder"]["depth"]
    assert ffn_work(cfg, NET, 32) == (depth * ops, depth * nbytes)


def test_vitg_feed_forward_is_half_its_encoder():
    # 118 TFLOP a 32-frame window at 518 x 924, 119 ms at the bf16 peak
    ops, nbytes = ffn_work(_cfg("vitg"), NET, 32)
    assert ops == pytest.approx(118.1e12, rel=1e-3)
    assert nbytes / 3.35e12 < ops / 989e12


def _record(cfg, ms, windows=14, **kw):
    spans = [{"id": 0, "parent": None, "name": "video", "request": 0,
              "start_ns": 0, "end_ns": 10, "device_ms": None,
              "counters": {"frames": 300, "windows": windows}}]
    for i, m in enumerate(ms):
        spans.append({"id": i + 1, "parent": 0, "name": "encoder.ffn",
                      "request": 0, "start_ns": 1, "end_ns": 2,
                      "counters": {"tokens": 32 * 2443}, "device_ms": m})
    rec = {"program": {"spans": spans}, "cfg": cfg, "traffic": TRAFFIC,
           "peaks": harness.peaks(), "windows": windows,
           "window_frames": 32}
    rec.update(kw)
    return rec


def _read(rec):
    return {n: harness.load_reader(n)(rec) for n in NAMES}


@pytest.mark.parametrize("name", ["vitl", "vitg"])
def test_readers_on_a_synthetic_run(name):
    cfg = _cfg(name)
    depth = cfg["encoder"]["depth"]
    ms = [2.0 + 0.01 * i for i in range(14 * depth)]
    got = _read(_record(cfg, ms))
    assert got["offline.ffn_ms_per_frame"] == pytest.approx(
        sum(ms) / (14 * 32))
    ops, _ = ffn_work(cfg, NET, 32)
    assert got["offline.ffn_roofline"] == pytest.approx(
        100 * 14 * ops / 989e12 / (sum(ms) / 1e3))


@pytest.mark.parametrize("name", ["vitl", "vitg"])
def test_spans_shorter_than_the_least_time_read_above_100(name):
    cfg = _cfg(name)
    ops, _ = ffn_work(cfg, NET, 32)
    spans = 14 * cfg["encoder"]["depth"]
    # each block's span at 0.9 of its least time (compute-bound)
    least_ms = 1e3 * ops / 989e12 / cfg["encoder"]["depth"]
    got = _read(_record(cfg, [0.9 * least_ms] * spans))
    assert got["offline.ffn_roofline"] == pytest.approx(100 / 0.9)


@pytest.mark.parametrize("rec", [
    {}, {"program": None}, {"program": {"spans": []}},
    # a run without the span (the parent of this metric's program), and
    # one off the card (no device time)
    "no ffn", "no device"])
def test_without_the_spans_there_is_no_reading(rec):
    cfg = _cfg("vitg")
    if rec == "no ffn":
        rec = _record(cfg, [])
    elif rec == "no device":
        rec = _record(cfg, [1.0, None])
    else:
        rec = dict(rec, cfg=cfg, traffic=TRAFFIC, peaks=harness.peaks(),
                   windows=14, window_frames=32)
    assert _read(rec) == {n: None for n in NAMES}


def test_every_ffn_metric_is_in_both_hd_cells():
    bench = harness.read_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
    entries = {m["name"]: m for m in bench["per_layer"]}
    for n in NAMES:
        assert entries[n]["workloads"] == ["vitl.offline_720p",
                                           "vitg.offline_720p"]
        assert entries[n]["source"] == "program_span"
        assert entries[n]["moves"] == "offline_fps"
