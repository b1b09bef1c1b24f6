#!/usr/bin/env python
"""EXR sequence -> ProRes converter.

A copy of ``apps/engine/exr_to_prores.py`` for the port (which imports nothing
of the JAX side), held to it by ``tests/test_torch_apps_engine.py``.

Rebuild of reference external_engine/exr_to_prores_converter.py: reads an EXR
sequence, applies a simplified ACEScg->sRGB display transform (gamma 2.2),
writes temp PNGs, and encodes ProRes 422 HQ/LT 10-bit (yuv422p10le) via
ffmpeg.  Without an ffmpeg binary the PNG frames are kept and the encode step
reports unavailable.
"""

from __future__ import annotations

import argparse
import glob
import os
import re
import shutil
import subprocess
import sys
import tempfile

import numpy as np

PRORES_PROFILES = {"hq": "3", "lt": "1"}  # ffmpeg -profile:v


def is_exr_sequence(path: str) -> bool:
    """Directory of EXRs or a templated EXR path
    (reference exr_to_prores_converter.py:290-301)."""
    if os.path.isdir(path):
        return bool(glob.glob(os.path.join(path, "*.exr")))
    return path.lower().endswith(".exr") and bool(
        re.search(r"(%0?\d*d|#+|\d+)\.exr$", path))


def list_exr_frames(path: str):
    if os.path.isdir(path):
        frames = sorted(glob.glob(os.path.join(path, "*.exr")))
    else:
        pattern = re.sub(r"(%0?\d*d|#+)", "*", path)
        frames = sorted(glob.glob(pattern))
    if not frames:
        raise FileNotFoundError(f"no EXR frames under {path}")
    return frames


def acescg_to_srgb(img: np.ndarray) -> np.ndarray:
    """Simplified display transform: clamp + gamma 2.2
    (reference exr_to_prores_converter.py:173-191)."""
    return np.clip(img, 0.0, 1.0) ** (1.0 / 2.2)


def convert(input_path: str, output_path: str, fps: float = 24.0,
            profile: str = "hq", keep_pngs: bool = False) -> dict:
    os.environ.setdefault("OPENCV_IO_ENABLE_OPENEXR", "1")
    import cv2

    frames = list_exr_frames(input_path)
    tmp_dir = tempfile.mkdtemp(prefix="exr2prores_")
    for i, exr in enumerate(frames):
        img = cv2.imread(exr, cv2.IMREAD_ANYCOLOR | cv2.IMREAD_ANYDEPTH)
        if img is None:
            raise IOError(f"cannot read {exr}")
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, axis=-1)
        img = acescg_to_srgb(img.astype(np.float32))
        png16 = (img * 65535.0).astype(np.uint16)
        cv2.imwrite(os.path.join(tmp_dir, f"frame_{i:06d}.png"), png16)

    ffmpeg = shutil.which("ffmpeg")
    if ffmpeg is None:
        dest = output_path + "_frames"
        shutil.move(tmp_dir, dest)
        return {"status": "partial", "message": "ffmpeg unavailable; "
                f"display-transformed PNG frames kept at {dest}",
                "frames": len(frames)}

    cmd = [
        ffmpeg, "-y", "-framerate", str(fps),
        "-i", os.path.join(tmp_dir, "frame_%06d.png"),
        "-c:v", "prores_ks", "-profile:v", PRORES_PROFILES[profile],
        "-pix_fmt", "yuv422p10le", output_path,
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
    finally:
        if not keep_pngs:
            shutil.rmtree(tmp_dir, ignore_errors=True)
    return {"status": "success", "output": output_path,
            "frames": len(frames)}


def main(argv=None):
    parser = argparse.ArgumentParser(description="EXR -> ProRes 422")
    parser.add_argument("input", help="EXR directory or templated path")
    parser.add_argument("output", help="output .mov path")
    parser.add_argument("--fps", type=float, default=24.0)
    parser.add_argument("--profile", choices=list(PRORES_PROFILES),
                        default="hq")
    args = parser.parse_args(argv)
    result = convert(args.input, args.output, args.fps, args.profile)
    print(result)
    return 0 if result["status"] in ("success", "partial") else 1


if __name__ == "__main__":
    sys.exit(main())
