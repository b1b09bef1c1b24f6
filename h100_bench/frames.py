"""The one frame generator every traffic mix reads.

A video is a seeded canvas that the camera pans across, ``pan_px`` pixels a
frame, so that consecutive frames are coherent as in real footage.  A
canvas is the sum of smooth random fields at three scales (coarse shapes,
mid-scale texture, pixel noise), made on the device from a
``torch.Generator`` in one batched call and handed to the program and to
the reference alike as uint8 host arrays.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from h100_bench.reference.weights import generator_seed


def canvases(seed: int, count: int, height: int, width: int,
             device) -> np.ndarray:
    """(count, height, width, 3) uint8 canvases drawn from ``seed``."""
    g = torch.Generator(device=device).manual_seed(generator_seed(seed, 1))
    size = (height, width)

    def field(cells: int, mode: str):
        low = torch.rand(count, 3, height // cells + 2, width // cells + 2,
                         generator=g, device=device)
        return F.interpolate(low, size=size, mode=mode, align_corners=False)

    x = (0.6 * field(48, "bicubic") + 0.3 * field(6, "bilinear")
         + 0.1 * torch.rand(count, 3, height, width, generator=g,
                            device=device))
    x = (x.clamp(0.0, 1.0) * 255.0).round().to(torch.uint8)
    return np.ascontiguousarray(x.permute(0, 2, 3, 1).cpu().numpy())


def panned(canvas: np.ndarray, frames: int, frame_hw, pan_px: int):
    """A (frames, H, W, 3) read-only view of ``canvas`` whose frame i starts
    ``i * pan_px`` columns in: a camera panning right at constant speed."""
    h, w = frame_hw
    need = w + (frames - 1) * pan_px
    if canvas.shape[0] < h or canvas.shape[1] < need:
        raise ValueError(f"canvas {canvas.shape[:2]} too small for "
                         f"{frames} frames of {h}x{w} at {pan_px} px")
    s = canvas.strides
    return np.lib.stride_tricks.as_strided(
        canvas, shape=(frames, h, w, 3), strides=(pan_px * s[1],) + s,
        writeable=False)


def sweep_position(i: int, positions: int) -> int:
    """Frame i's position in a camera sweep that pans across ``positions``
    steps and back (period 2 * (positions - 1))."""
    period = 2 * (positions - 1)
    k = i % period
    return k if k < positions else period - k
