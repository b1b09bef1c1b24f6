"""Offline windowed inference, PyTorch.

Counterpart of ``vda_tpu/infer/windowed.py`` ``infer_video_depth`` on one
device: every window's input is a direct gather of source frames
(``window_source_indices``, gathered into pinned memory and copied),
preprocessing and the forward run on the device, the final resize to the
frame size runs in fp32, depths cross to the host in float16 (fp32 with
``fp32=True``) through pinned memory, and the host stitches the windows
(``stitching.stitch_windows``: in place into one fp32 array on torch's
intra-op threads, bit for bit with the JAX package's; its first N frames
are returned without a further copy).  ``window_batch`` runs that many
windows as the batch of one forward on the device, each window its own
sequence of frames.  Dispatch is double-buffered, as JAX's: batch n+1's
upload and step are enqueued before the host waits for batch n's depths,
so at most two batches are in flight; on a card both copies run on a copy
stream of their own (``_Staging``), ordered to the compute stream by
events.  ``mesh`` (``parallel/mesh.make_mesh``) fans that batch out over
the data axis and runs each rank's windows tensor-parallel over the model
axis; every rank returns the whole stitched video.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import numpy as np
import torch

from vda_tpu_torch.config import INFER_LEN, KEYFRAMES, OVERLAP
from vda_tpu_torch.infer.staging import Upload
from vda_tpu_torch.infer.stitching import stitch_windows
from vda_tpu_torch.models.vda import VideoDepthAnything, forward
from vda_tpu_torch.ops.resize import resize_bilinear
from vda_tpu_torch.parallel import mesh as tpm
from vda_tpu_torch.utils import knobs, trace
from vda_tpu_torch.utils.transform import (
    compute_resize_hw,
    effective_input_size,
    preprocess_frames,
)

FRAME_STEP = INFER_LEN - OVERLAP  # 22


def window_source_indices(n_frames: int) -> np.ndarray:
    """(n_windows, INFER_LEN) source-frame index of every window input slot.

    Derivation: the reference recursion input_w[:OVERLAP] =
    input_{w-1}[KEYFRAMES] (video_depth.py:104-105) bottoms out at source
    frames because KEYFRAMES[0] == 0 (a fixed global anchor) and
    KEYFRAMES[1:] >= OVERLAP (fresh frames of the previous window):

        input_w[0]    = source[0]
        input_w[j]    = source[(w-1)*22 + KEYFRAMES[j]]   for 1 <= j < 10
        input_w[10:]  = source[w*22 + 10 : w*22 + 32]

    Indices past the video end clamp to the last frame (the reference pads by
    repeating it, video_depth.py:92-95).
    """
    n_windows = len(range(0, n_frames, FRAME_STEP))
    idx = np.empty((n_windows, INFER_LEN), np.int64)
    kf = np.asarray(KEYFRAMES, np.int64)
    for w in range(n_windows):
        if w == 0:
            idx[w] = np.arange(INFER_LEN)
        else:
            idx[w, 0] = 0
            idx[w, 1:OVERLAP] = (w - 1) * FRAME_STEP + kf[1:]
            idx[w, OVERLAP:] = w * FRAME_STEP + np.arange(OVERLAP, INFER_LEN)
    return np.minimum(idx, n_frames - 1)


class _Staging:
    """The window driver's host side on one device, kept from one video to
    the next (``_staging``).  ``upload`` gathers each batch's frames into
    one of two pinned slots and copies them on ``copy_stream``; ``fetch``
    copies a batch's depths on the same stream, behind its step, into one
    pinned buffer, which the host reads before the next fetch is enqueued.
    On a device other than CUDA: the tensors as they are, nothing pinned,
    no stream."""

    def __init__(self, device: torch.device):
        cuda = device.type == "cuda"
        self.copy_stream = torch.cuda.Stream(device) if cuda else None
        self.upload = Upload(device, "window", self.copy_stream)
        self.host = None  # the pinned buffer of fetched depths

    def fetch(self, depths: torch.Tensor):
        """Enqueue the copy of ``depths`` to the host behind the work queued
        so far on the current stream.  Returns (host tensor, event after
        the copy or None): the host tensor holds the depths once the event
        has passed, until the next fetch."""
        if self.copy_stream is None:
            return depths.cpu(), None
        buf = self.host
        if (buf is None or buf.dtype != depths.dtype
                or buf.shape[1:] != depths.shape[1:]
                or buf.shape[0] < depths.shape[0]):
            buf = self.host = torch.empty(depths.shape, dtype=depths.dtype,
                                          pin_memory=True)
        host = buf[:depths.shape[0]]
        self.copy_stream.wait_stream(
            torch.cuda.current_stream(self.copy_stream.device))
        with torch.cuda.stream(self.copy_stream):
            host.copy_(depths, non_blocking=True)
        depths.record_stream(self.copy_stream)
        copied = torch.cuda.Event()
        copied.record(self.copy_stream)
        return host, copied


_STAGING: Dict[torch.device, List[_Staging]] = {}


@contextlib.contextmanager
def _staging(device: torch.device):
    """A ``_Staging`` of ``device`` for one video: the one the last video
    returned, else a new one (two videos at once on a device take one
    each)."""
    free = _STAGING.setdefault(device, [])
    try:
        staging = free.pop()
    except IndexError:
        staging = _Staging(device)
    try:
        yield staging
    finally:
        free.append(staging)


@torch.no_grad()
def _window_step(model: VideoDepthAnything, frames_u8, net_hw, out_hw,
                 dtype, attn_impl: str, micro_batch_size: int,
                 fuse_proj: bool, resize_kernel: bool):
    """(B, T, H, W, 3) uint8 windows on the device -> contiguous (B, T,
    outH, outW) depths, fp32 if ``dtype`` is fp32 else float16."""
    x = preprocess_frames(frames_u8, net_hw, dtype=dtype)
    depth = forward(model, x, attn_impl=attn_impl,
                    micro_batch_size=micro_batch_size, fuse_proj=fuse_proj,
                    resize_kernel=resize_kernel)
    # final resize in fp32 (the reference casts before F.interpolate,
    # video_depth.py:111-112), then a float16 transfer unless fp32; the
    # resize's einsum leaves each frame column-major, and the cast (or a
    # copy) lays it out row-major on the device, so the host reads rows
    d = resize_bilinear(depth[..., None].float(), out_hw, align_corners=True)
    d = d[..., 0]
    out = torch.float32 if dtype == torch.float32 else torch.float16
    return d.to(out, memory_format=torch.contiguous_format)


def infer_video_depth(
    model: VideoDepthAnything,
    frames: np.ndarray,
    target_fps: float,
    input_size: int = 518,
    fp32: bool = False,
    attn_impl: str = "auto",
    micro_batch_size: int = 16,
    progress: Optional[callable] = None,
    fuse_proj: Optional[bool] = None,
    resize_kernel: Optional[bool] = None,
    window_batch: int = 1,
    mesh=None,
):
    """frames: (N, H, W, 3) uint8 RGB.  Returns (depths (N, H, W) fp32, fps).

    Matches reference infer_video_depth (video_depth.py:70-162): aspect-ratio
    guard, window padding, keyframe overlap and scale/shift stitching.
    ``fp32=False`` runs the network in bfloat16, on the model's device.
    ``fuse_proj`` (K7 for the encoder blocks) and ``resize_kernel`` (K10 for
    the tail's upsamples) are the JAX package's ``VDA_ATTN_FUSE_PROJ`` and
    ``VDA_RESIZE_KERNEL`` switches, off by default as there (None reads
    those knobs, ``utils/knobs.py``); both need ``attn_impl="auto"``.
    ``window_batch``: windows a forward takes, as its batch (JAX's
    ``window_batch`` on one device); the last batch is filled up by
    repeating its last window, whose depths are dropped, so every forward
    has one shape.

    ``mesh`` (a ``parallel/mesh.Mesh``; every rank calls this with the same
    frames): the window batch is rounded up to fill the data axis (JAX's
    ``wb = ceil(wb / dp) * dp``), data rank r runs windows r·wb/dp ..
    (r+1)·wb/dp of each batch, its model sharded over the model axis
    (``shard_model``, done here if not yet) where that axis is above 1,
    and the depths (float16 unless ``fp32``) are gathered over the data
    axis, so every rank stitches the whole video; ``progress`` counts the
    windows fetched.  Without a mesh, the one the model was sharded over
    (``parallel/mesh.use_mesh``); one other than that raises."""
    with trace.span("video"):
        trace.count("frames", frames.shape[0])
        cfg = model.cfg
        mesh = tpm.use_mesh(model, mesh)
        device = next(model.parameters()).device
        fuse_proj = knobs.fuse_proj(fuse_proj, attn_impl)
        resize_kernel = knobs.resize_kernel(resize_kernel, attn_impl)
        n_frames, frame_h, frame_w = frames.shape[:3]
        size = effective_input_size(frame_h, frame_w, input_size)
        net_hw = compute_resize_hw(frame_h, frame_w, size)
        dtype = torch.float32 if fp32 else torch.bfloat16

        idx = window_source_indices(n_frames)
        n_windows = idx.shape[0]
        trace.count("windows", n_windows)
        wb = max(1, min(window_batch, n_windows))
        dp, rank = (1, 0) if mesh is None else (mesh.dp, mesh.data_rank)
        wb = -(-wb // dp) * dp  # the window batch fills the data axis
        per = wb // dp
        host_depths = []

        def receive(host, copied, n_done):
            with trace.span("window.wait"):
                if copied is not None:
                    copied.synchronize()
            with trace.span("window.fetch"):
                trace.count("d2h_bytes", host.nbytes)
                # new fp32 arrays: ``host`` may be a reused pinned buffer
                host_depths.extend(host.to(torch.float32, copy=True).numpy())
            if progress is not None:
                progress(n_done, n_windows)

        with _staging(device) as staging:
            queued = None  # the last batch's depths and windows done
            for start in range(0, n_windows, wb):
                batch_idx = idx[start:start + wb]
                n_valid = batch_idx.shape[0]
                if n_valid < wb:
                    batch_idx = np.concatenate(
                        [batch_idx, batch_idx[-1:].repeat(wb - n_valid, 0)])
                mine = batch_idx[rank * per:(rank + 1) * per]
                u8 = staging.upload.take(frames, mine)
                # the last batch's copy to the host, on the copy stream
                # behind this batch's upload (and before this batch's step
                # is enqueued, so it waits for the last step alone)
                fetched = staging.fetch(queued[0]) if queued else None
                with trace.span("window.step", device=u8):
                    if queued is not None:
                        trace.count("overlapped", 1)
                    d = _window_step(model, u8, net_hw, (frame_h, frame_w),
                                     dtype, attn_impl, micro_batch_size,
                                     fuse_proj, resize_kernel)
                    if dp > 1:
                        d = tpm.all_gather(d, mesh.data_group, 0)
                if fetched is not None:
                    receive(*fetched, queued[1])
                queued = (d[:n_valid].flatten(0, 1), start + n_valid)
            if queued is not None:
                receive(*staging.fetch(queued[0]), queued[1])
        with trace.span("video.stitch"):
            aligned = stitch_windows(host_depths, metric=cfg.metric)
        # a view of the stitched array (a stitch swapped in that returns a
        # list of frames is stacked)
        return np.asarray(aligned[:n_frames]), target_fps
