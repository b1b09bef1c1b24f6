"""Preprocessing: frame -> normalised network input, PyTorch.

Counterpart of ``vda_tpu/utils/transform.py``: the keep-aspect size policy
runs on the host (integer math, copied), the bicubic resize and ImageNet
normalisation on the device, batched over the window.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from vda_tpu_torch.config import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    MAX_ASPECT_RATIO,
    PATCH_SIZE,
)
from vda_tpu_torch.ops.resize import resize_bicubic


def constrain_to_multiple_of(x: float, multiple: int, min_val: int = 0,
                             max_val: int | None = None) -> int:
    """Reference util/transform.py:51-60."""
    y = int(np.round(x / multiple) * multiple)
    if max_val is not None and y > max_val:
        y = int(np.floor(x / multiple) * multiple)
    if y < min_val:
        y = int(np.ceil(x / multiple) * multiple)
    return y


def compute_resize_hw(height: int, width: int, target: int,
                      multiple: int = PATCH_SIZE) -> tuple[int, int]:
    """Keep-aspect "lower_bound" resize policy (reference
    util/transform.py:62-107), the one inference uses."""
    s = max(target / height, target / width)
    return (constrain_to_multiple_of(s * height, multiple, min_val=target),
            constrain_to_multiple_of(s * width, multiple, min_val=target))


def effective_input_size(height: int, width: int, input_size: int) -> int:
    """Aspect-ratio guard (reference video_depth.py:72-75)."""
    ratio = max(height, width) / min(height, width)
    if ratio > MAX_ASPECT_RATIO:
        input_size = int(input_size * 1.777 / ratio)
        input_size = round(input_size / PATCH_SIZE) * PATCH_SIZE
    return input_size


@functools.lru_cache(maxsize=None)
def imagenet_stats(device) -> tuple:
    """ImageNet (mean, std) as fp32 tensors on ``device``, uploaded once (a
    host-to-device copy at every call would make the host wait)."""
    return (torch.tensor(IMAGENET_MEAN, device=device),
            torch.tensor(IMAGENET_STD, device=device))


def preprocess_frames(frames_u8, out_hw, dtype=torch.float32):
    """uint8 (..., H, W, 3) frames -> normalised (..., h, w, 3) in ``dtype``:
    /255, cv2-exact bicubic resize, ImageNet normalisation, all in fp32."""
    x = frames_u8.float() / 255.0
    x = resize_bicubic(x, out_hw)
    mean, std = imagenet_stats(x.device)
    return ((x - mean) / std).to(dtype)
