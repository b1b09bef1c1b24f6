"""The readers of the program's own spans and counters
(``program_readers.py``) on synthetic records, and a traced run of the tiny
cells on the CPU with the program's recorder open (``program_spans.py``),
in which every metric the CPU can give is reported."""

import time

import pytest

from h100_bench import program_readers, program_spans, session
from h100_bench.tests import tiny_cells

SEED = 2 ** 41 + 7


def _span(i, parent, name, a, b, counters=None, device_ms=None):
    return {"id": i, "parent": parent, "name": name, "request": 0,
            "start_ns": a * 1_000_000, "end_ns": b * 1_000_000,
            "counters": counters or {}, "device_ms": device_ms}


def _read(rec, driver, prefix="x"):
    got = program_readers.metrics(rec, driver, prefix)
    return {k.split(".", 1)[1]: v["value"] for k, v in got.items()}


def test_offline_readers_on_a_synthetic_video():
    spans = [_span(0, None, "video", 0, 100, {"frames": 40, "windows": 2})]
    t = 0
    for w in range(2):  # upload 5, step 10, wait 20, fetch 8 ms a window
        for name, ms, counters in (
                ("window.upload", 5, {"h2d_bytes": 1_000_000}),
                ("window.step", 10, {}), ("window.wait", 20, {}),
                ("window.fetch", 8, {"d2h_bytes": 500_000})):
            spans.append(_span(len(spans), 0, name, t, t + ms, counters,
                               29.0 if name == "window.step" else None))
            t += ms
    spans.append(_span(len(spans), 0, "video.stitch", t, t + 6))
    spans.append(_span(len(spans), 2, "encoder", 6, 9, device_ms=2.0))
    got = _read({"program": {"spans": spans}, "wall_s": 0.13}, "offline")
    assert got == pytest.approx({
        "upload_ms_per_window": 5.0, "wait_ms_per_window": 20.0,
        "fetch_ms_per_window": 8.0,
        # 100 ms less 2 x 43 of windows and 6 of stitching
        "driver_self_ms_per_window": (100 - 86 - 6) / 2,
        "h2d_mb_per_frame": 2.0 / 40, "d2h_mb_per_frame": 1.0 / 40,
        "step_host_ms_per_window": 10.0, "step_device_ms_per_window": 29.0,
        # 130 ms of wall time, 100 of them in the video
        "outside_video_ms_per_window": 30 / 2})
    # without the wall time, nothing outside the video to read
    assert "outside_video_ms_per_window" not in _read(
        {"program": {"spans": spans}}, "offline")


def test_self_time_on_a_synthetic_tree():
    spans = [_span(0, None, "video", 0, 100, {"frames": 1, "windows": 1}),
             _span(1, 0, "window.upload", 10, 30),
             _span(2, 0, "window.fetch", 20, 50),  # overlaps the upload
             _span(3, 2, "encoder", 25, 45),        # a grandchild
             _span(4, 0, "video.stitch", 90, 130),  # past the video's end
             _span(5, None, "video", 200, 210, {"frames": 1, "windows": 1}),
             dict(_span(6, 5, "window.upload", 205, 0), end_ns=None)]
    got = program_readers.driver_self_ms_per_window(
        {"program": {"spans": spans}})
    assert got == pytest.approx((100 - 40 - 10 + 10) / 2)


def test_stream_readers_on_a_synthetic_group():
    spans = [_span(0, None, "stream.group", 0, 20, {"frames": 4}),
             _span(1, 0, "stream.upload", 0, 2, {"h2d_bytes": 10}),
             _span(2, 1, "stream.upload_wait", 1, 2),
             _span(7, 0, "stream.step", 2, 4),  # a group handed to submit
             _span(3, 7, "stream.upload", 2, 3, {"h2d_bytes": 1}),
             _span(4, 0, "stream.context", 4, 5, device_ms=1.5),
             _span(5, 0, "stream.context", 6, 7, device_ms=2.5),
             _span(6, 0, "head.stage", 5, 6, device_ms=9.0)]
    got = _read({"program": {"spans": spans}}, "stream")
    assert got == pytest.approx({
        "upload_ms_per_frame": 3 / 4, "upload_wait_ms_per_frame": 1 / 4,
        "enqueue_ms_per_frame": (20 - 3) / 4,
        "context_ms_per_frame": 4.0 / 4})
    spans[5]["device_ms"] = None  # a span without CUDA events: no reading
    assert "context_ms_per_frame" not in _read({"program": {"spans": spans}},
                                               "stream")


@pytest.mark.parametrize("rec", [{}, {"program": None},
                                 {"program": {"spans": []}}])
def test_readers_without_the_program_say_nothing(rec):
    for driver in program_readers.METRICS:
        assert program_readers.metrics(rec, driver, "x") == {}


# the metrics the CPU cannot give: device time
DEVICE_ONLY = {"stream.context_ms_per_frame",
               "offline.step_device_ms_per_window",
               "clips.step_device_ms_per_window"}


@pytest.mark.parametrize("name", ["vits.offline_480p", "vitl.stream_720p"])
def test_a_recorded_tiny_cell_reports_every_metric(name):
    cell = tiny_cells.cell(name)
    prog = {}
    run_cell = session.run_cell
    with program_spans._recorded(prog):
        result, _ = session.run_cell(cell, SEED, 1.0, True, "cpu",
                                     time.perf_counter())
    assert result["correct"], tiny_cells.dump(result)
    driver = cell.traffic["driver"]
    prefix = cell.per_layer[0]["name"].split(".")[0]
    want = {f"{prefix}.{m}" for m, _, _ in program_readers.METRICS[driver]}
    got = result["metrics"]
    assert want - set(got) == want & DEVICE_ONLY
    assert all(got[k]["value"] >= 0 for k in want - DEVICE_ONLY)
    h, w = cell.traffic["frame_hw"]
    if driver == "offline":
        # every source frame of a window is uploaded once a window, and the
        # float16 depths of its 32 frames fetched
        roots = [s for s in prog["spans"] if s["name"] == "video"]
        frames = sum(r["counters"]["frames"] for r in roots)
        windows = sum(r["counters"]["windows"] for r in roots)
        assert got[f"{prefix}.h2d_mb_per_frame"]["value"] == pytest.approx(
            windows * 32 * h * w * 3 / 1e6 / frames)
        assert got[f"{prefix}.d2h_mb_per_frame"]["value"] == pytest.approx(
            windows * 32 * h * w * 2 / 1e6 / frames)
    assert session.run_cell is run_cell  # the harness as it was
