"""Image-sequence path templating and frame I/O for the VFX engine.

A copy of ``apps/engine/sequence.py`` for the port (which imports nothing
of the JAX side), held to it by ``tests/test_torch_apps_engine.py``.

Rebuild of the reference engine's sequence handling
(reference external_engine/engine.py:275-330): frame-number patterns
%0Nd / #### / %d with underscore or dot separators, EXR input frames via
OpenCV, and sequence detection.
"""

from __future__ import annotations

import os
import re
from typing import List, Optional, Tuple

import numpy as np

_PERCENT_RE = re.compile(r"%0?(\d+)d")
_HASH_RE = re.compile(r"#+")


def detect_frame_pattern(path: str) -> Optional[str]:
    """Return the detected pattern token ('%04d', '####', '%d', ...) or None."""
    m = _PERCENT_RE.search(path)
    if m:
        return f"%0{int(m.group(1))}d"
    m = _HASH_RE.search(path)
    if m:
        return m.group(0)
    if "%d" in path:
        return "%d"
    return None


def format_frame_path(template: str, frame_num: int) -> str:
    """Substitute a frame number into a templated path."""
    out = _PERCENT_RE.sub(lambda m: f"{frame_num:0{int(m.group(1))}d}",
                          template)
    out = _HASH_RE.sub(lambda m: f"{frame_num:0{len(m.group(0))}d}", out)
    return out.replace("%d", str(frame_num))


def is_image_sequence(path: str) -> bool:
    return detect_frame_pattern(path) is not None


def read_frame(path: str) -> np.ndarray:
    """Read one frame (EXR float or 8-bit image) as uint8 RGB
    (reference engine.py:1066-1097)."""
    os.environ.setdefault("OPENCV_IO_ENABLE_OPENEXR", "1")
    import cv2

    if path.lower().endswith(".exr"):
        img = cv2.imread(path, cv2.IMREAD_ANYCOLOR | cv2.IMREAD_ANYDEPTH)
        if img is None:
            raise IOError(f"cannot read EXR frame: {path}")
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, axis=-1)
        # simple linear->display transform for network input
        img = np.clip(img, 0.0, 1.0) ** (1.0 / 2.2)
        img = (img * 255.0).astype(np.uint8)
    else:
        img = cv2.imread(path)
        if img is None:
            raise IOError(f"cannot read frame: {path}")
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def read_image_sequence(template: str, first_frame: int, last_frame: int,
                        allow_gaps: bool = False
                        ) -> Tuple[np.ndarray, List[int]]:
    """Read a templated image sequence -> ((N,H,W,3) uint8, frame numbers).

    Mid-sequence gaps raise by default: silently skipping a missing plate
    frame would misalign every later output's frame number with its source
    (a classic VFX delivery bug).  Missing frames at the range EDGES are
    tolerated (clients often over-specify the range).
    """
    frames, numbers, missing = [], [], []
    for n in range(first_frame, last_frame + 1):
        path = format_frame_path(template, n)
        if not os.path.exists(path):
            missing.append(n)
            continue
        frames.append(read_frame(path))
        numbers.append(n)
    if not frames:
        raise FileNotFoundError(
            f"no frames found for template {template} "
            f"[{first_frame}..{last_frame}]")
    if not allow_gaps:
        interior = [n for n in missing if numbers[0] < n < numbers[-1]]
        if interior:
            raise FileNotFoundError(
                f"image sequence {template} has missing frames "
                f"{interior[:10]}{'...' if len(interior) > 10 else ''} — "
                f"outputs would misalign; pass allow_gaps=True to override")
    return np.stack(frames, axis=0), numbers
