"""The arithmetic of the program's own spans and counters, shared by the
readers of ``metrics/`` that read them: what ``vda_tpu_torch/utils/trace.py``
records inside the window and stream drivers while a traced run holds a
recording open around the cell's window (``session.run_cell``), kept in
the run's record under ``"program"`` (a snapshot: ``{"spans": [...]}``,
each span a dict with ``name``, ``id``, ``parent``, ``start_ns``,
``end_ns``, ``counters`` and ``device_ms``), beside the driver's
``wall_s``.

Each function takes the record and returns its metric, or None where the
record's ``program`` is None (an untraced run, or a program without the
recorder) or has nothing to read.  Self times are computed here, not
taken from the program.
"""

from __future__ import annotations


def _spans(rec):
    prog = rec.get("program")
    spans = prog.get("spans") if prog else None
    return [s for s in spans if s["end_ns"] is not None] if spans else None


def _frames(spans) -> int:
    """Source frames of the recorded requests (the roots' ``frames``)."""
    return sum(s["counters"].get("frames", 0) for s in spans
               if s["parent"] is None)


def _windows(spans) -> int:
    return sum(s["counters"].get("windows", 0) for s in spans
               if s["name"] == "video")


def _host_ms(spans, name) -> float:
    return sum(s["end_ns"] - s["start_ns"] for s in spans
               if s["name"] == name) / 1e6


def _uncovered_ms(spans, name, under=None) -> float:
    """Host ms of the spans ``name`` minus the part of each that its direct
    children cover or, given ``under``, that every span below it with a
    name in ``under`` covers."""
    by_id = {s["id"]: s for s in spans}
    covers = {}
    for s in spans:
        owner = s["parent"]
        if under is not None:
            if s["name"] not in under:
                continue
            while owner in by_id and by_id[owner]["name"] != name:
                owner = by_id[owner]["parent"]
        covers.setdefault(owner, []).append((s["start_ns"], s["end_ns"]))
    total = 0
    for s in spans:
        if s["name"] != name:
            continue
        covered, reach = 0, s["start_ns"]
        for a, b in sorted(covers.get(s["id"], [])):
            a, b = max(a, reach), min(b, s["end_ns"])
            if b > a:
                covered += b - a
                reach = b
        total += s["end_ns"] - s["start_ns"] - covered
    return total / 1e6


def per_window_ms(rec, name):
    """Host ms of the spans ``name`` over the windows of the videos."""
    spans = _spans(rec)
    if not spans or not _windows(spans):
        return None
    return _host_ms(spans, name) / _windows(spans)


def driver_self_ms_per_window(rec):
    """Host ms of the ``video`` spans that none of their children cover
    (the driver's own work: the final stack, the loop) over windows."""
    spans = _spans(rec)
    if not spans or not _windows(spans):
        return None
    return _uncovered_ms(spans, "video") / _windows(spans)


def device_ms_per_window(rec, name):
    """Device ms (CUDA events) of the spans ``name`` over the windows;
    None where a span has no device time (not on a card)."""
    spans = _spans(rec)
    ms = [s["device_ms"] for s in spans or () if s["name"] == name]
    if not ms or None in ms or not _windows(spans):
        return None
    return sum(ms) / _windows(spans)


def outside_video_ms_per_window(rec):
    """The record's wall time of the window (``wall_s``) that no ``video``
    span covers, over the windows: the caller's time between videos."""
    spans = _spans(rec)
    if not spans or not _windows(spans) or rec.get("wall_s") is None:
        return None
    return (1e3 * rec["wall_s"] - _host_ms(spans, "video")) / _windows(spans)


def mb_per_frame(rec, key):
    """The counter ``key`` summed over every span, in MB a source frame."""
    spans = _spans(rec)
    counted = [s["counters"][key] for s in spans or ()
               if key in s["counters"]]
    if not counted or not _frames(spans):
        return None
    return sum(counted) / 1e6 / _frames(spans)


def per_frame_ms(rec, name):
    """Host ms of the spans ``name`` over the frames submitted."""
    spans = _spans(rec)
    if not spans or not _frames(spans):
        return None
    return _host_ms(spans, name) / _frames(spans)


def enqueue_ms_per_frame(rec):
    """Host ms of the ``stream.group`` spans outside the uploads below them
    (a group that hands off to ``submit`` nests them in ``stream.step``),
    over the frames submitted."""
    spans = _spans(rec)
    if not spans or not _frames(spans):
        return None
    return _uncovered_ms(spans, "stream.group",
                         {"stream.upload"}) / _frames(spans)


def device_ms_per_frame(rec, name):
    """Device ms (CUDA events) of the spans ``name`` over the frames
    submitted; None where a span has no device time (not on a card)."""
    spans = _spans(rec)
    ms = [s["device_ms"] for s in spans or () if s["name"] == name]
    if not ms or None in ms or not _frames(spans):
        return None
    return sum(ms) / _frames(spans)
