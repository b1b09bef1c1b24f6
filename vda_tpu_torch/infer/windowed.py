"""Offline windowed inference, PyTorch.

Counterpart of ``vda_tpu/infer/windowed.py`` ``infer_video_depth`` on one
device: every window's input is a direct gather of source frames
(``window_source_indices``, copied), preprocessing and the forward run on
the device, the final resize to the frame size runs in fp32, depths cross to
the host in float16 (fp32 with ``fp32=True``), and the host stitches the
windows (``stitching.stitch_windows``, copied).  ``window_batch`` runs that
many windows as the batch of one forward on the device, each window its own
sequence of frames; the JAX ``mesh``, which shards that batch over chips,
is the multi-GPU work.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from vda_tpu_torch.config import INFER_LEN, KEYFRAMES, OVERLAP
from vda_tpu_torch.infer.stitching import stitch_windows
from vda_tpu_torch.models.vda import VideoDepthAnything, forward
from vda_tpu_torch.ops.resize import resize_bilinear
from vda_tpu_torch.utils import knobs
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


@torch.no_grad()
def _window_step(model: VideoDepthAnything, frames_u8, net_hw, out_hw,
                 dtype, attn_impl: str, micro_batch_size: int,
                 fuse_proj: bool, resize_kernel: bool):
    """(B, T, H, W, 3) uint8 windows on the device -> (B, T, outH, outW)
    depths, fp32 if ``dtype`` is fp32 else float16."""
    x = preprocess_frames(frames_u8, net_hw, dtype=dtype)
    depth = forward(model, x, attn_impl=attn_impl,
                    micro_batch_size=micro_batch_size, fuse_proj=fuse_proj,
                    resize_kernel=resize_kernel)
    # final resize in fp32 (the reference casts before F.interpolate,
    # video_depth.py:111-112), then a float16 transfer unless fp32
    d = resize_bilinear(depth[..., None].float(), out_hw, align_corners=True)
    d = d[..., 0]
    return d if dtype == torch.float32 else d.to(torch.float16)


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
    has one shape."""
    cfg = model.cfg
    device = next(model.parameters()).device
    fuse_proj = knobs.fuse_proj(fuse_proj, attn_impl)
    resize_kernel = knobs.resize_kernel(resize_kernel, attn_impl)
    n_frames, frame_h, frame_w = frames.shape[:3]
    size = effective_input_size(frame_h, frame_w, input_size)
    net_hw = compute_resize_hw(frame_h, frame_w, size)
    dtype = torch.float32 if fp32 else torch.bfloat16

    idx = window_source_indices(n_frames)
    n_windows = idx.shape[0]
    wb = max(1, min(window_batch, n_windows))
    host_depths = []
    for start in range(0, n_windows, wb):
        batch_idx = idx[start:start + wb]
        n_valid = batch_idx.shape[0]
        if n_valid < wb:
            batch_idx = np.concatenate(
                [batch_idx, batch_idx[-1:].repeat(wb - n_valid, 0)])
        u8 = torch.from_numpy(frames[batch_idx]).to(device)
        d = _window_step(model, u8, net_hw, (frame_h, frame_w), dtype,
                         attn_impl, micro_batch_size, fuse_proj,
                         resize_kernel)
        host_depths.extend(d[:n_valid].flatten(0, 1).cpu().float().numpy())
        if progress is not None:
            progress(start + n_valid, n_windows)
    aligned = stitch_windows(host_depths, metric=cfg.metric)
    return np.stack(aligned[:n_frames], axis=0), target_fps
