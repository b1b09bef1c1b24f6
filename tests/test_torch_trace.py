"""The port's span recorder (``vda_tpu_torch/utils/trace.py``) on the CPU:
nothing runs while it is off, the trees of a video and of a stream, the
counters, and the spans on torch.profiler's timeline."""

import numpy as np
import pytest
import torch

import vda_tpu_torch as vt
from vda_tpu_torch.utils import trace

H, W = 60, 80
N_FRAMES = 30  # two windows
# two windows, double-buffered: the second is uploaded and enqueued before
# the first is waited for and fetched (no ``window.upload_wait`` on the
# CPU: nothing is pinned there)
VIDEO = ["window.upload", "window.step", "window.upload", "window.step",
         "window.wait", "window.fetch", "window.wait", "window.fetch",
         "video.stitch"]


@pytest.fixture(scope="module")
def model():
    return vt.init_random(vt.get_config("tiny"),
                          torch.Generator().manual_seed(0),
                          device="cpu").requires_grad_(False)


@pytest.fixture(scope="module")
def frames():
    return (np.random.default_rng(1).random((N_FRAMES, H, W, 3))
            * 255).astype(np.uint8)


@pytest.fixture(scope="module")
def video(model, frames):
    """One recorded ``infer_video_depth``: (depths, snapshot)."""
    with trace.recording() as rec:
        depths, _ = vt.infer_video_depth(model, frames, 30.0, input_size=56)
    return depths, rec.snapshot()


def _children(spans, parent_id):
    return [s for s in spans if s["parent"] == parent_id]


def _raise(*args, **kwargs):
    raise AssertionError("created while recording is off")


def test_off_creates_no_event_range_or_span(monkeypatch, model, frames,
                                            video):
    monkeypatch.setattr(torch.cuda, "Event", _raise)
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    monkeypatch.setattr(trace, "_Span", _raise)
    depths, _ = vt.infer_video_depth(model, frames, 30.0, input_size=56)
    assert np.array_equal(depths, video[0])
    stream = vt.StreamingDepth(model, input_size=56)
    stream.submit(frames[0])
    stream.submit_group(frames[1:4])
    trace.count("h2d_bytes", 1)


def test_video_tree(video):
    spans = video[1]["spans"]
    roots = [s for s in spans if s["parent"] is None]
    assert [r["name"] for r in roots] == ["video"]
    video_id = roots[0]["id"]
    children = _children(spans, video_id)
    assert [s["name"] for s in children] == VIDEO
    # the second step is enqueued while the first batch is unfetched
    assert [s["counters"] for s in children if s["name"] == "window.step"] \
        == [{}, {"overlapped": 1}]
    assert len({s["request"] for s in spans}) == 1
    assert roots[0]["counters"] == {"frames": N_FRAMES, "windows": 2}
    step = _children(spans, video_id)[1]["id"]
    inner = [s["name"] for s in _children(spans, step)]
    assert inner == ["encoder", "head.stage", "head.tail"]
    assert all(s["end_ns"] >= s["start_ns"] for s in spans)
    assert [s["id"] for s in spans] == sorted(s["id"] for s in spans)


def test_video_byte_counters(video):
    spans = video[1]["spans"]
    total = {}
    for s in spans:
        for k, v in s["counters"].items():
            total[k] = total.get(k, 0) + v
    assert total["h2d_bytes"] == 2 * 32 * H * W * 3
    assert total["d2h_bytes"] == 2 * 32 * H * W * 2  # float16 depths
    by_name = {s["name"]: s["counters"] for s in spans}
    assert set(by_name["window.upload"]) == {"h2d_bytes"}
    assert set(by_name["window.fetch"]) == {"d2h_bytes"}


def test_head_spans_nest_by_layer(video):
    spans = video[1]["spans"]
    stage = next(s for s in spans if s["name"] == "head.stage")
    assert [s["name"] for s in _children(spans, stage["id"])] == [
        "head.project_resize", "head.temporal_mm0", "head.temporal_mm1",
        "head.temporal_mm2", "head.temporal_mm3"]
    tail = next(s for s in spans if s["name"] == "head.tail")
    chunks = _children(spans, tail["id"])
    assert [s["name"] for s in chunks] == ["head.output_tail"] * 2
    # CPU tensors: no CUDA events, so no device time
    assert all(s["device_ms"] is None for s in spans)


def test_each_call_is_one_request(model, frames):
    with trace.recording() as rec:
        for n in (5, 24):
            vt.infer_video_depth(model, frames[:n], 30.0, input_size=56)
    spans = rec.snapshot()["spans"]
    roots = [s for s in spans if s["parent"] is None]
    assert [r["counters"] for r in roots] == [
        {"frames": 5, "windows": 1}, {"frames": 24, "windows": 2}]
    assert roots[1]["request"] == roots[0]["request"] + 1
    for r in roots:
        assert sum(s["request"] == r["request"] for s in spans) == \
            sum(1 for _ in _subtree(spans, r["id"]))


def _subtree(spans, root_id):
    ids = {root_id}
    for s in spans:  # parents open before their children
        if s["id"] in ids or s["parent"] in ids:
            ids.add(s["id"])
            yield s


def _stream_roots(spans, name):
    return [s for s in spans if s["parent"] is None and s["name"] == name]


def test_stream_group_tree(model, frames):
    stream = vt.StreamingDepth(model, input_size=56)
    stream.submit(frames[0])
    with trace.recording() as rec:
        stream.submit_group(frames[1:5])
    spans = rec.snapshot()["spans"]
    (group,) = _stream_roots(spans, "stream.group")
    assert group["request"] == 1 and group["counters"] == {"frames": 4}
    assert all(s["request"] == 1 for s in spans)
    names = [s["name"] for s in _children(spans, group["id"])]
    assert names.count("stream.context") == 4
    assert names.count("stream.cache_write") == 4
    assert names.count("head.stage") == 4 and names.count("head.tail") == 1
    uploads = [s for s in spans if s["name"] == "stream.upload"]
    assert uploads[0]["counters"]["h2d_bytes"] == 4 * H * W * 3
    # each frame's context is gathered before its stage runs
    ctx = [i for i, n in enumerate(names) if n == "stream.context"]
    assert all(names[i + 1] == "head.stage" for i in ctx)


def test_stream_step_tree(model, frames):
    stream = vt.StreamingDepth(model, input_size=56)
    with trace.recording() as rec:
        for f in frames[:3]:
            stream.submit(f)
    spans = rec.snapshot()["spans"]
    steps = _stream_roots(spans, "stream.step")
    assert [s["request"] for s in steps] == [0, 1, 2]
    for i, step in enumerate(steps):
        names = [s["name"] for s in _children(spans, step["id"])]
        # the first frame fills the cache: no context to gather
        assert names.count("stream.context") == (1 if i else 0)
        assert names.count("stream.cache_write") == 1
        assert names[0] == "stream.upload"
        assert step["counters"] == {"frames": 1}


def test_upload_counts_only_host_tensors():
    # a tensor that is not in host memory (here on the meta device, as a
    # tensor already on a card would be) is handed on, and its bytes are
    # not counted as a host-to-device copy
    from vda_tpu_torch.infer.staging import Upload

    up = Upload("meta")
    with trace.recording() as rec:
        assert up(torch.zeros(2, 3, dtype=torch.uint8)).device.type == "meta"
        up(torch.zeros(5, device="meta"))
    spans = rec.snapshot()["spans"]
    assert [(s["name"], s["counters"]) for s in spans] == [
        ("stream.upload", {"h2d_bytes": 6}), ("stream.upload", {})]


def test_count_goes_to_the_innermost_span():
    with trace.recording() as rec:
        trace.count("outside", 1)
        with trace.span("a"):
            trace.count("n", 2)
            with trace.span("b"):
                trace.count("n", 3)
                trace.count("n", 4)
            trace.count("n", 5)
        with pytest.raises(RuntimeError):
            with trace.recording():
                pass
    spans = rec.snapshot()["spans"]
    assert [(s["name"], s["counters"]) for s in spans] == [
        ("a", {"n": 7}), ("b", {"n": 7})]
    assert trace.span("c") is trace.span("d")  # off again: the shared no-op


def test_spans_are_profiler_ranges_on_its_clock(model, frames):
    from torch.profiler import ProfilerActivity, profile

    stream = vt.StreamingDepth(model, input_size=56)
    stream.submit(frames[0])
    with trace.recording() as rec:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            stream.submit_group(frames[1:3])
            vt.infer_video_depth(model, frames[:5], 30.0, input_size=56)
    snap = rec.snapshot()
    spans = snap["spans"]
    names = {s["name"] for s in spans}
    events = [e for e in prof.events() if e.name in names]
    assert len(events) == len(spans)
    offset = trace.profiler_offset_ns(snap, prof.events())
    assert offset is not None
    by_start = sorted(events, key=lambda e: (e.time_range.start,
                                             -e.time_range.end))
    ranges = {}
    for s, e in zip(spans, by_start):
        assert s["name"] == e.name
        assert abs(s["start_ns"] + offset - e.time_range.start * 1e3) < 5e5
        assert abs(s["end_ns"] + offset - e.time_range.end * 1e3) < 5e5
        ranges[s["id"]] = (e.time_range.start, e.time_range.end)
    for s in spans:  # each range lies inside its parent's
        if s["parent"] is not None:
            (a, b), (pa, pb) = ranges[s["id"]], ranges[s["parent"]]
            assert pa <= a and b <= pb
