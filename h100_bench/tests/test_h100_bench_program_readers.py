"""The readers of the program's own spans and counters (``metrics/`` over
``program_readers.py``) on synthetic records, and traced runs of the tiny
cells on the CPU, in which ``session.run_cell`` holds the program's
recording open around the window and every metric the CPU can give is
reported; an untraced run opens no recording."""

import time

import pytest

from h100_bench import harness, session
from h100_bench.tests import tiny_cells

SEED = 2 ** 41 + 7
WINDOW = ("upload_ms_per_window", "wait_ms_per_window",
          "fetch_ms_per_window", "driver_self_ms_per_window",
          "step_host_ms_per_window", "step_device_ms_per_window",
          "outside_video_ms_per_window", "h2d_mb_per_frame",
          "d2h_mb_per_frame")
STREAM = ("upload_ms_per_frame", "upload_wait_ms_per_frame",
          "enqueue_ms_per_frame", "context_ms_per_frame")
# the per-layer metrics that read the program's record, by cell
PROGRAM = {"vitl.offline_720p": [f"offline.{n}" for n in WINDOW],
           "vits.offline_480p": [f"clips.{n}" for n in WINDOW],
           "vitl.stream_720p": [f"stream.{n}" for n in STREAM]}
# the metrics the CPU cannot give: device time
DEVICE_ONLY = {"stream.context_ms_per_frame",
               "offline.step_device_ms_per_window",
               "clips.step_device_ms_per_window"}


def _span(i, parent, name, a, b, counters=None, device_ms=None):
    return {"id": i, "parent": parent, "name": name, "request": 0,
            "start_ns": a * 1_000_000, "end_ns": b * 1_000_000,
            "counters": counters or {}, "device_ms": device_ms}


def _read(rec, cell):
    """Every program metric of ``cell`` the record gives, by its name
    without the cell's prefix."""
    got = {n: harness.load_reader(n)(rec) for n in PROGRAM[cell]}
    return {n.split(".", 1)[1]: v for n, v in got.items() if v is not None}


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
    got = _read({"program": {"spans": spans}, "wall_s": 0.13},
                "vitl.offline_720p")
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
        {"program": {"spans": spans}}, "vits.offline_480p")


def test_self_time_on_a_synthetic_tree():
    spans = [_span(0, None, "video", 0, 100, {"frames": 1, "windows": 1}),
             _span(1, 0, "window.upload", 10, 30),
             _span(2, 0, "window.fetch", 20, 50),  # overlaps the upload
             _span(3, 2, "encoder", 25, 45),        # a grandchild
             _span(4, 0, "video.stitch", 90, 130),  # past the video's end
             _span(5, None, "video", 200, 210, {"frames": 1, "windows": 1}),
             dict(_span(6, 5, "window.upload", 205, 0), end_ns=None)]
    got = harness.load_reader("offline.driver_self_ms_per_window")(
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
    got = _read({"program": {"spans": spans}}, "vitl.stream_720p")
    assert got == pytest.approx({
        "upload_ms_per_frame": 3 / 4, "upload_wait_ms_per_frame": 1 / 4,
        "enqueue_ms_per_frame": (20 - 3) / 4,
        "context_ms_per_frame": 4.0 / 4})
    spans[5]["device_ms"] = None  # a span without CUDA events: no reading
    assert "context_ms_per_frame" not in _read({"program": {"spans": spans}},
                                               "vitl.stream_720p")


@pytest.mark.parametrize("rec", [{}, {"program": None},
                                 {"program": {"spans": []}}])
def test_readers_without_the_program_say_nothing(rec):
    for cell in PROGRAM:
        assert _read(rec, cell) == {}


def test_every_program_metric_is_in_its_cell():
    bench = harness.read_json(f"{harness.ROOT}/BENCHMARK.json")
    for cell, names in PROGRAM.items():
        entries = {m["name"]: m for m in bench["per_layer"]
                   if cell in m["workloads"]}
        assert set(names) <= set(entries), cell
        assert all(entries[n]["source"] == ("program_counter" if "_mb_" in n
                                            else "program_span")
                   for n in names)


@pytest.mark.parametrize("name", ["vits.offline_480p", "vitl.stream_720p"])
def test_a_traced_tiny_cell_reports_every_metric(monkeypatch, name):
    cell = tiny_cells.cell(name)
    records = []
    load = harness.load_reader

    def spying(metric):
        read = load(metric)
        return lambda rec: records.append(rec) or read(rec)

    monkeypatch.setattr(harness, "load_reader", spying)
    result, _ = session.run_cell(cell, SEED, 1.0, True, "cpu",
                                 time.perf_counter())
    assert result["correct"], tiny_cells.dump(result)
    prog = records[0]["program"]
    assert prog["spans"] and all(r["program"] is prog for r in records)
    want = set(PROGRAM[name])
    got = result["metrics"]
    assert want - set(got) == want & DEVICE_ONLY
    assert all(got[k]["value"] >= 0 for k in want - DEVICE_ONLY)
    if cell.traffic["driver"] == "offline":
        h, w = cell.traffic["frame_hw"]
        prefix = PROGRAM[name][0].split(".")[0]
        # every source frame of a window is uploaded once a window, and the
        # float16 depths of its 32 frames fetched
        roots = [s for s in prog["spans"] if s["name"] == "video"]
        frames = sum(r["counters"]["frames"] for r in roots)
        windows = sum(r["counters"]["windows"] for r in roots)
        assert got[f"{prefix}.h2d_mb_per_frame"]["value"] == pytest.approx(
            windows * 32 * h * w * 3 / 1e6 / frames)
        assert got[f"{prefix}.d2h_mb_per_frame"]["value"] == pytest.approx(
            windows * 32 * h * w * 2 / 1e6 / frames)


def test_an_untraced_run_opens_no_recording(monkeypatch):
    from vda_tpu_torch.utils import trace

    opened = []
    recording = trace.recording
    monkeypatch.setattr(trace, "recording",
                        lambda: opened.append(1) or recording())
    records = []
    monkeypatch.setattr(harness, "load_reader",
                        lambda m: lambda rec: records.append(rec))
    cell = tiny_cells.cell("vitl.stream_720p")
    result, _ = session.run_cell(cell, SEED, 1.0, False, "cpu",
                                 time.perf_counter())
    assert result["correct"] and not opened and not records
    assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}
    result, _ = session.run_cell(cell, SEED, 1.0, True, "cpu",
                                 time.perf_counter())
    assert opened == [1] and records[0]["program"]["spans"]
