"""Named spans and byte counters of the port's drivers and model, kept in
memory while a recording is open.

    from vda_tpu_torch.utils import trace

    with trace.recording() as rec:
        depths, fps = vt.infer_video_depth(model, frames, 30.0)
    spans = rec.snapshot()["spans"]

Recording is off unless ``recording()`` is open.  Off, ``span`` is one test
of a module flag returning a shared no-op context, and ``count`` one test
that returns: no CUDA event, no profiler range, no allocation and no
synchronisation.

While recording, each span keeps its name, a unique ``id``, its
``parent``'s id (None for a root), a ``request`` id shared by every span
under one root (the root's own ``request`` where its caller gives one,
else a count of the process's recorded roots), host ``start_ns`` and
``end_ns`` on ``time.perf_counter_ns``, and the ``counters`` that ``count``
adds to it.  A span given a CUDA ``device`` (a tensor or a
``torch.device``) also records a CUDA event before and after it on that
device's current stream; ``snapshot()`` waits for them and gives
``device_ms``, and nothing else the recorder does waits for the device.
While a torch.profiler runs, each span also enters
``torch.profiler.record_function`` of its name, so the spans are host
ranges on the profiler's timeline (without a profiler such a range
would only cost time).  The first span opened under a running profiler
is preceded by a ``trace.clock`` range whose host time the snapshot keeps
(``marker_ns``); ``profiler_offset_ns`` turns it into the offset that lays
the in-memory spans on that profiler's clock.

Spans of the port (host spans unless marked "device"):

  * ``infer_video_depth``: ``video`` (the root; counters ``frames``, the
    source frames, and ``windows``), and for each window batch
    ``window.upload`` (the host gather of the batch's frames into a pinned
    slot and their copy's enqueue; ``h2d_bytes``) with
    ``window.upload_wait`` (the host waiting for the slot's copy of two
    batches ago), ``window.step`` (device; the forward's enqueue; counter
    ``overlapped``, 1 where an earlier batch of the video is still
    unfetched), then, once the next batch's step is enqueued (after the
    last batch, at once), ``window.wait`` (the host blocked until the
    depths' copy to the host has run, behind the step) and
    ``window.fetch`` (the float16 -> float32 cast into new arrays and the
    list extend; ``d2h_bytes``); then ``video.stitch`` (counter ``stitch_converted_frames``, the window
    depths the stitch had to copy to fp32 C-contiguous first; 0 on this
    path).
  * the model: ``encoder`` (in it each block's feed-forward,
    ``encoder.ffn``, with the counter ``tokens``: rows times batch),
    ``head.stage`` (in it ``head.project_resize`` and ``head.temporal_mm0``
    .. ``head.temporal_mm3``) and ``head.tail`` (in it each
    ``head.output_tail`` chunk), all device.  A motion module's span counts
    the route of its attention (``models/temporal.py``): ``k3_blocks`` (a
    transformer block in K3, fused or the chain), ``k4_blocks`` (an
    attention sub-block in K4), ``k5_calls`` (an attention in K5) and
    ``plain_attn_calls`` (one in plain PyTorch).
  * ``StreamingDepth``: ``stream.step`` (the root of ``submit``) and
    ``stream.group`` (of ``submit_group``), both device with the counter
    ``frames`` and the first frame's id as the request; ``stream.upload``
    (a pinned staging and its copy; ``h2d_bytes`` of a host tensor) with
    ``stream.upload_wait`` (the host waiting for the staging buffer's copy
    of two calls ago); ``stream.context`` (device; a frame's context
    gather) and ``stream.cache_write`` (device; its new rows written).

Under a mesh, a rank's counters are that rank's own.  The recorder is the
process's: one recording at a time, spans nested per thread.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import Dict, List, Optional

import torch

CLOCK = "trace.clock"

_recorder: Optional["Recording"] = None
_requests = itertools.count()  # ids of the roots opened without one


_OFF = contextlib.nullcontext()  # every span while nothing records


def _cuda(device) -> Optional[torch.device]:
    """The CUDA device of a tensor or device, else None."""
    if isinstance(device, torch.Tensor):
        device = device.device
    if isinstance(device, torch.device) and device.type == "cuda":
        return device
    return None


def _profiler_running() -> bool:
    return bool(getattr(torch.autograd.profiler, "_is_profiler_enabled",
                        False))


class _Span:
    __slots__ = ("rec", "name", "device", "request", "data", "range",
                 "events")

    def __init__(self, rec: "Recording", name: str, device, request):
        self.rec = rec
        self.name = name
        self.device = device
        self.request = request

    def __enter__(self):
        rec = self.rec
        stack = rec._stack()
        self.range = None
        if _profiler_running():
            if rec.marker_ns is None:
                # the host clock read just before the range takes its own
                marker = torch.profiler.record_function(CLOCK)
                rec.marker_ns = time.perf_counter_ns()
                marker.__enter__()
                marker.__exit__(None, None, None)
            self.range = torch.profiler.record_function(self.name)
        start_ns = time.perf_counter_ns()
        if self.range is not None:
            self.range.__enter__()
        if stack:
            parent, request = stack[-1]["id"], stack[-1]["request"]
        else:
            parent = None
            request = (self.request if self.request is not None
                       else next(_requests))
        self.data = {"id": next(rec._ids), "parent": parent,
                     "name": self.name, "request": request,
                     "start_ns": start_ns, "end_ns": None,
                     "counters": {}, "device_ms": None}
        self.events = None
        dev = _cuda(self.device)
        if dev is not None:
            stream = torch.cuda.current_stream(dev)
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True), stream)
            self.events[0].record(stream)
            rec._events[self.data["id"]] = self.events[:2]
        rec._spans.append(self.data)
        stack.append(self.data)
        return self.data

    def __exit__(self, *exc):
        if self.events is not None:
            self.events[1].record(self.events[2])
        if self.range is not None:
            self.range.__exit__(*exc)
        self.data["end_ns"] = time.perf_counter_ns()
        self.rec._stack().pop()
        return False


class Recording:
    """The spans of one ``recording()``: ``snapshot()`` reads them."""

    def __init__(self):
        self._spans: List[dict] = []
        self._events: Dict[int, tuple] = {}
        self._ids = itertools.count()
        self._local = threading.local()
        self.marker_ns: Optional[int] = None

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def count(self, key: str, n) -> None:
        stack = self._stack()
        if stack:
            counters = stack[-1]["counters"]
            counters[key] = counters.get(key, 0) + n

    def snapshot(self) -> dict:
        """``{"spans": [...], "marker_ns": ...}``: a copy of every span so
        far, in the order they opened, each a dict of the keys the module
        docstring names; a closed device span's ``device_ms`` is resolved
        here (this waits for its end event)."""
        spans = []
        for data in list(self._spans):
            data = dict(data, counters=dict(data["counters"]))
            events = self._events.get(data["id"])
            if events is not None and data["end_ns"] is not None:
                events[1].synchronize()
                data["device_ms"] = events[0].elapsed_time(events[1])
            spans.append(data)
        return {"spans": spans, "marker_ns": self.marker_ns}


@contextlib.contextmanager
def recording():
    """Record the port's spans while open; yields the ``Recording``."""
    global _recorder
    if _recorder is not None:
        raise RuntimeError("a recording is already open")
    rec = _recorder = Recording()
    try:
        yield rec
    finally:
        _recorder = None


def span(name: str, device=None, request=None):
    """A context that records the span ``name`` while a recording is open.
    ``device``: a tensor or device whose CUDA stream the span also times
    (nothing on another device); ``request``: a root's request id."""
    if _recorder is None:
        return _OFF
    return _Span(_recorder, name, device, request)


def count(key: str, n) -> None:
    """Add ``n`` to the counter ``key`` of the innermost open span."""
    if _recorder is None:
        return
    _recorder.count(key, n)


def profiler_offset_ns(snapshot: dict, events) -> Optional[int]:
    """Nanoseconds to add to a span's ``start_ns`` / ``end_ns`` to place it
    on the clock of a finished torch.profiler's ``events()`` (whose
    ``time_range`` is in microseconds), from the ``trace.clock`` range;
    None if the recording saw no profiler or ``events`` lack the range."""
    if snapshot["marker_ns"] is None:
        return None
    for e in events:
        if e.name == CLOCK:
            return round(e.time_range.start * 1e3) - snapshot["marker_ns"]
    return None
