"""The metric arithmetic: the busy union, the 95th percentile over all
groups, rates over whole videos, the readers, the seeded sample."""

import numpy as np
import pytest

from h100_bench import harness
from h100_bench.drivers import offline, stream
from types import SimpleNamespace


def test_busy_union_counts_overlaps_once():
    assert harness.merge([(5, 6), (0, 2), (1, 3)]) == [[0, 3], [5, 6]]
    assert harness.merge([(0, 10), (2, 3)]) == [[0, 10]]
    assert harness.merge([]) == []


def test_p95_takes_every_group():
    lat = [0.1] * 95 + [1.0] * 5
    assert harness.p95(lat) == pytest.approx(np.percentile(lat, 95))
    assert harness.p95(list(range(1, 101))) == pytest.approx(95.05)


def test_offline_rate_is_whole_videos_over_the_wall():
    st = SimpleNamespace(runs=[(300, 14), (300, 14)], wall=20.0)
    ctx = SimpleNamespace(traffic={"rate_metric": "offline_fps"})
    assert offline.end_to_end(ctx, st) == {"offline_fps": 30.0}


def test_stream_rates():
    st = SimpleNamespace(frames=400, wall=10.0, latency=[0.2] * 99 + [0.5])
    e2e = stream.end_to_end(None, st)
    assert e2e["stream_fps"] == 40.0
    assert e2e["stream_p95_ms"] == pytest.approx(200.0)


def _record(**kw):
    rec = {"spans": {}, "profile": {}, "peaks": harness.peaks()}
    rec.update(kw)
    return rec


def test_offline_readers():
    rec = _record(
        spans={"stitch_windows": [(0.5, False), (0.5, True)],
               "window_step": [(0.3, False)] * 28,
               "encoder": [(0.1, True)] * 28,
               "head_stage": [(0.02, False)] * 28,
               "output_tail": [(0.1, False)] * 28},
        frames=600, windows=28, wall_s=12.0, window_frames=32,
        window_flops=80e12, attention=(2e12, 1e9),
        profile={"busy_s": 8.0, "window_s": 10.0,
                 "by_name": {"attention_sm90_kernel<64>": 14.0,
                             "gemm": 99.0}})
    read = lambda n: harness.load_reader(n)(rec)  # noqa: E731
    assert read("offline.stitch_ms_per_frame") == pytest.approx(1e3 / 600)
    assert read("offline.driver_gap_ms_per_window") == pytest.approx(
        1e3 * (12.0 - 8.4 - 1.0) / 28)
    assert read("offline.encoder_ms_per_frame") == pytest.approx(
        1e3 * 2.8 / (28 * 32))
    assert read("offline.idle_pct") == pytest.approx(20.0)
    assert read("offline.mfu_pct") == pytest.approx(
        100 * 28 * 80e12 / (12.0 * 989e12))
    assert read("offline.attn_roofline") == pytest.approx(
        100 * 28 * (2e12 / 989e12) / 14.0)


def test_readers_find_nothing_and_say_nothing():
    rec = _record(frames=0, windows=0, wall_s=0.0, host_s=0.0)
    for m in harness.read_json(f"{harness.ROOT}/BENCHMARK.json")["per_layer"]:
        assert harness.load_reader(m["name"])(rec) is None, m["name"]


def test_attention_roofline_needs_its_kernels():
    rec = _record(spans={"encoder": [(0.1, True)]}, attention=(1e12, 1e9),
                  profile={"busy_s": 1.0, "window_s": 1.0,
                           "by_name": {"gemm": 1.0}})
    assert harness.load_reader("offline.attn_roofline")(rec) is None


def test_reservoir_is_seeded_and_uniform():
    picks = []
    for s in range(2000):
        r = harness.Reservoir(1, np.random.default_rng([s, 2]))
        for i in range(4):
            r.offer(i)
        picks.append(r.items[0])
    counts = np.bincount(picks, minlength=4)
    assert counts.min() > 400
    a, b = (harness.Reservoir(2, np.random.default_rng(7)) for _ in range(2))
    for i in range(50):
        a.offer(i)
        b.offer(i)
    assert a.items == b.items


def test_frame_errors_are_per_frame():
    import torch

    r = torch.stack([torch.arange(12.0).view(3, 4), torch.ones(3, 4) * 2])
    r[1, 0, 0] = 3.0
    p = r.clone()
    p[0] += 0.5
    e = harness.frame_errors(p, r)
    assert e[1] == 0.0 and e[0] == pytest.approx(0.5 / float(r[0].std()))


def test_profile_summary_busy_and_gaps():
    import torch

    def ev(name, s, e, cuda, annotation=False):
        return SimpleNamespace(
            name=name, time_range=SimpleNamespace(start=s, end=e),
            device_type=(torch.autograd.DeviceType.CUDA if cuda
                         else torch.autograd.DeviceType.CPU),
            is_user_annotation=annotation)

    events = [ev("gemm_a", 0, 100, True), ev("gemm_b", 50, 150, True),
              ev("encoder", 0, 400, True, annotation=True),
              ev("elementwise_c", 300, 400, True),
              ev("stitch_windows", 120, 320, False),
              ev("aten::copy_", 160, 260, False)]
    out = harness.summarize_profile(SimpleNamespace(events=lambda: events),
                                    0.0005)
    assert out["busy_s"] == pytest.approx(250e-6)
    assert out["breakdown"]["idle_gaps"] == [["aten::copy_",
                                             pytest.approx(150e-6)]]
    kinds = dict(out["breakdown"]["device_ops"])
    assert kinds["gemm (cuBLAS)"] == pytest.approx(200e-6)
    assert "other" not in kinds
    events.append(ev("np.stack", 400, 600, False))
    out = harness.summarize_profile(SimpleNamespace(events=lambda: events),
                                    0.0007)
    assert out["breakdown"]["idle_gaps"][0] == ["np.stack",
                                               pytest.approx(200e-6)]
