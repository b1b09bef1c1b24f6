"""Pinned host staging of the drivers' host-to-device copies.

``Upload`` is the one upload path of the port: the stream driver
(``streaming.StreamingDepth``) copies each frame and its context rows
through it on the current stream, and the window driver
(``windowed.infer_video_depth``) gathers each window batch's frames
through it onto a copy stream of its own.
"""

from __future__ import annotations

import numpy as np
import torch

from vda_tpu_torch.utils import trace


class Upload:
    """Host-to-device copies that do not make the host wait: each host
    tensor is staged in one of two pinned buffers, used in turn, and copied
    with ``non_blocking=True``.  Before a buffer is refilled the host waits
    on the event recorded after its previous copy (the copy of two calls
    ago), since overwriting a pinned buffer while its copy is in flight
    would corrupt that copy.  On a device other than CUDA (the CPU, whose
    PyTorch may be built without CUDA and cannot pin) the tensor is moved
    as it is.

    ``copy_stream``: the CUDA stream the copies run on; None runs them on
    the current stream.  With a copy stream, the current stream waits for
    each copy before the work queued after it, and the copied tensor is
    recorded as used there.  ``name`` prefixes the spans: ``<name>.upload``
    (counter ``h2d_bytes`` of a host tensor) and its child
    ``<name>.upload_wait`` (the wait before a refill)."""

    def __init__(self, device, name: str = "stream", copy_stream=None):
        self.device = torch.device(device)
        self.copy_stream = copy_stream
        self.span = name + ".upload"
        self.wait_span = name + ".upload_wait"
        self.slots = [None, None]  # (pinned buffer, event after its copy)
        self.turn = 0

    def __call__(self, host: torch.Tensor) -> torch.Tensor:
        with trace.span(self.span):
            if host.device.type == "cpu":  # not a tensor already on a card
                trace.count("h2d_bytes", host.nbytes)
            if self.device.type != "cuda" or host.device.type != "cpu":
                return host.to(self.device)
            buf = self._slot(host.shape, host.dtype)
            buf.copy_(host)
            return self._send(buf)

    def take(self, array: np.ndarray, index: np.ndarray) -> torch.Tensor:
        """``array[index]`` on the device: ``index`` an integer array of
        rows of ``array``, gathered row by row straight into the pinned
        buffer (no pageable copy of the gather is made; ``np.take`` would
        first copy a strided ``array`` whole)."""
        with trace.span(self.span):
            if self.device.type != "cuda":
                host = torch.from_numpy(array[index])
                trace.count("h2d_bytes", host.nbytes)
                return host.to(self.device)
            dtype = torch.from_numpy(np.empty(0, array.dtype)).dtype
            buf = self._slot(index.shape + array.shape[1:], dtype)
            rows = buf.numpy().reshape(-1, *array.shape[1:])
            for row, i in zip(rows, index.ravel()):
                row[...] = array[i]
            trace.count("h2d_bytes", buf.nbytes)
            return self._send(buf)

    def _slot(self, shape, dtype) -> torch.Tensor:
        """This turn's pinned buffer of ``shape`` and ``dtype``, once its
        previous copy has finished."""
        slot, self.turn = self.slots[self.turn], self.turn ^ 1
        buf = None
        if slot is not None:
            buf, event = slot
            with trace.span(self.wait_span):
                event.synchronize()
            if buf.shape != shape or buf.dtype != dtype:
                buf = None
        if buf is None:
            buf = torch.empty(shape, dtype=dtype, pin_memory=True)
        return buf

    def _send(self, buf: torch.Tensor) -> torch.Tensor:
        stream = self.copy_stream or torch.cuda.current_stream(self.device)
        with torch.cuda.stream(stream):
            out = buf.to(self.device, non_blocking=True)
        event = torch.cuda.Event()
        event.record(stream)
        if self.copy_stream is not None:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(event)
            out.record_stream(consumer)
        self.slots[self.turn ^ 1] = (buf, event)
        return out
