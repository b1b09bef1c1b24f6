"""Host-side input pipeline: a prefetch thread and an early copy to the card.

Counterpart of ``vda_tpu/utils/data.py``.  A daemon thread runs the
(arbitrary, Python) iterator, puts each batch's tensors in pinned host
memory and starts their copy to the device with ``non_blocking=True`` on a
side stream, so decoding and the host-to-device copy of batch N+1 overlap
the device work of batch N.  The consumer's stream waits on that copy's
event before it hands the batch out.  A bounded queue (``buffer_size``)
keeps the producer at most that many batches ahead; an exception in the
producer is raised at the consumer's next ``next()``; closing the returned
generator (or dropping it) stops the thread.  Items are yielded in order.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, Optional

import numpy as np
import torch

_DONE = object()


class _Failure:
    def __init__(self, exc: BaseException):
        self.exc = exc


def _to_device(item, device, stream):
    """item's arrays and tensors (a dict, list or tuple of them, or one) on
    ``device``, copied from pinned memory on ``stream``."""
    if isinstance(item, dict):
        return {k: _to_device(v, device, stream) for k, v in item.items()}
    if isinstance(item, (list, tuple)):
        return type(item)(_to_device(v, device, stream) for v in item)
    if isinstance(item, np.ndarray):
        item = torch.from_numpy(item)
    if not isinstance(item, torch.Tensor):
        return item
    if item.device == device:
        return item
    if device.type == "cuda" and item.device.type == "cpu":
        with torch.cuda.stream(stream):
            return item.pin_memory().to(device, non_blocking=True)
    return item.to(device)


def _record_stream(item, stream):
    """Mark every CUDA tensor of item as used on ``stream``, so the caching
    allocator does not hand its memory to the copy stream while the
    consumer's stream may still read it."""
    if isinstance(item, dict):
        item = list(item.values())
    if isinstance(item, (list, tuple)):
        for v in item:
            _record_stream(v, stream)
    elif isinstance(item, torch.Tensor) and item.is_cuda:
        item.record_stream(stream)


def prefetch_to_device(data_iter: Iterable, device=None,
                       buffer_size: int = 2) -> Iterator:
    """Wrap ``data_iter`` so items are produced (and, when ``device`` is
    given, copied there) in a background thread.  Yields the same items in
    order; the producer stays at most ``buffer_size`` items ahead."""
    if buffer_size < 1:
        raise ValueError("buffer_size must be >= 1")
    device = None if device is None else torch.device(device)
    cuda = device is not None and device.type == "cuda"
    stream = torch.cuda.Stream(device) if cuda else None
    q: queue.Queue = queue.Queue(maxsize=buffer_size)
    stop = threading.Event()

    def put(token) -> bool:
        while not stop.is_set():
            try:
                q.put(token, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def produce():
        try:
            for item in data_iter:
                event = None
                if device is not None:
                    item = _to_device(item, device, stream)
                    if cuda:
                        event = torch.cuda.Event()
                        event.record(stream)
                if not put((item, event)):
                    return
            put(_DONE)
        except BaseException as e:  # noqa: BLE001 — must surface at consumer
            put(_Failure(e))

    thread = threading.Thread(target=produce, daemon=True,
                              name="vda-prefetch")
    thread.start()

    try:
        while True:
            token = q.get()
            if token is _DONE:
                return
            if isinstance(token, _Failure):
                raise token.exc
            item, event = token
            if event is not None:
                current = torch.cuda.current_stream(device)
                current.wait_event(event)
                _record_stream(item, current)
            yield item
    finally:
        stop.set()


def take_slice(item, index: int, count: int):
    """Slice ``index`` of ``count`` equal slices along axis 0 of every
    array in a batch (a dict, list or tuple of them, or one): a data
    rank's share of the global batch."""
    if isinstance(item, dict):
        return {k: take_slice(v, index, count) for k, v in item.items()}
    if isinstance(item, (list, tuple)):
        return type(item)(take_slice(v, index, count) for v in item)
    if not isinstance(item, (np.ndarray, torch.Tensor)):
        return item
    b = item.shape[0]
    if b % count:
        raise ValueError(f"a batch of {b} does not split over {count} "
                         "data ranks")
    k = b // count
    return item[index * k:(index + 1) * k]


def sized_prefetch(data_iter: Iterable, device=None, buffer_size: int = 2,
                   limit: Optional[int] = None,
                   data_slice: Optional[tuple] = None) -> Iterator:
    """``prefetch_to_device`` with an optional item cap: the producer stops
    after ``limit`` items, so an endless sampler ends cleanly instead of
    leaving a blocked thread behind.  ``data_slice`` (index, count): each
    item is cut to ``take_slice(item, index, count)`` before its copy."""
    if data_slice is not None:
        data_iter = (take_slice(item, *data_slice) for item in data_iter)
    if limit is not None:
        def capped(src):
            if limit <= 0:
                return
            for i, item in enumerate(src):
                yield item
                if i + 1 >= limit:
                    return
        data_iter = capped(data_iter)
    return prefetch_to_device(data_iter, device, buffer_size)
