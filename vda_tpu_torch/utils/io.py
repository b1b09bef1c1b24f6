"""Host-side video / depth I/O for the port's entry points.

A copy of ``vda_tpu/utils/io.py`` (itself a rebuild of reference
utils/dc_utils.py and run.py's NPZ/EXR/point-cloud writers), kept here so
that the port imports nothing of the JAX package;
``tests/test_torch_copies.py`` holds each function to its original.  Decode and encode stay on the host:
cv2, imageio, matplotlib and OpenEXR are imported where they are used.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np


def ensure_even(v: int) -> int:
    return v if v % 2 == 0 else v + 1


def read_video_frames(video_path: str, process_length: int = -1,
                      target_fps: float = -1, max_res: int = -1
                      ) -> Tuple[np.ndarray, float]:
    """Decode a video to (N, H, W, 3) uint8 RGB + fps
    (reference utils/dc_utils.py:19-69, cv2 path with fps-targeting stride and
    max_res downscale)."""
    import cv2

    cap = cv2.VideoCapture(video_path)
    if not cap.isOpened():
        raise FileNotFoundError(f"cannot open video: {video_path}")
    original_fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
    oh = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
    ow = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))

    scale_needed = max_res > 0 and max(oh, ow) > max_res
    if scale_needed:
        s = max_res / max(oh, ow)
        height, width = ensure_even(round(oh * s)), ensure_even(round(ow * s))
    else:
        height, width = oh, ow

    fps = original_fps if target_fps <= 0 else target_fps
    stride = max(round(original_fps / fps), 1)

    frames = []
    frame_count = 0
    while True:
        ret, frame = cap.read()
        if not ret or (process_length > 0 and len(frames) >= process_length):
            break
        if frame_count % stride == 0:
            frame = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
            if scale_needed:
                frame = cv2.resize(frame, (width, height))
            frames.append(frame)
        frame_count += 1
    cap.release()
    if not frames:
        raise ValueError(f"no frames decoded from {video_path}")
    return np.stack(frames, axis=0), fps


_INFERNO: Optional[np.ndarray] = None


def inferno_colormap() -> np.ndarray:
    """(256, 3) float inferno LUT (reference dc_utils.py:75 uses matplotlib)."""
    global _INFERNO
    if _INFERNO is None:
        import matplotlib
        _INFERNO = np.asarray(
            matplotlib.colormaps["inferno"](np.arange(256))[:, :3])
    return _INFERNO


def _visualize(frames: np.ndarray, is_depths: bool, grayscale: bool):
    """Yield uint8 RGB frames; depth vis = global min-max -> inferno
    (reference utils/dc_utils.py:74-84)."""
    if not is_depths:
        for i in range(frames.shape[0]):
            yield frames[i]
        return
    cmap = inferno_colormap()
    d_min, d_max = float(frames.min()), float(frames.max())
    denom = max(d_max - d_min, 1e-8)
    for i in range(frames.shape[0]):
        dn = ((frames[i] - d_min) / denom * 255).astype(np.uint8)
        if grayscale:
            yield np.repeat(dn[..., None], 3, axis=-1)
        else:
            yield (cmap[dn] * 255).astype(np.uint8)


def save_video(frames: np.ndarray, output_path: str, fps: float = 10,
               is_depths: bool = False, grayscale: bool = False) -> None:
    """MP4 writer (reference utils/dc_utils.py:72-86): H.264 CRF-18 via
    imageio/ffmpeg when available, else cv2 mp4v."""
    # Writer creation is the only step inside the fallback guard: if imageio
    # fails mid-append we would have partially consumed the frame iterator, so
    # on any append failure the partial file is removed and the cv2 fallback
    # restarts from a FRESH iterator (never a silently truncated video).
    writer = None
    try:
        import imageio

        writer = imageio.get_writer(
            output_path, fps=fps, macro_block_size=1, codec="libx264",
            ffmpeg_params=["-crf", "18"])
    except Exception:
        writer = None
    if writer is not None:
        try:
            for frame in _visualize(frames, is_depths, grayscale):
                writer.append_data(frame)
            writer.close()
            return
        except Exception:
            try:
                writer.close()
            except Exception:
                pass
            try:
                if os.path.exists(output_path):
                    os.remove(output_path)
            except OSError:
                pass
    import cv2

    vis = _visualize(frames, is_depths, grayscale)
    first = next(iter(vis))
    h, w = first.shape[:2]
    writer = cv2.VideoWriter(output_path, cv2.VideoWriter_fourcc(*"mp4v"),
                             fps, (w, h))
    if not writer.isOpened():
        raise RuntimeError(f"no video encoder available for {output_path}")
    writer.write(first[:, :, ::-1])
    for frame in vis:
        writer.write(frame[:, :, ::-1])
    writer.release()


def save_depths_npz(path: str, depths: np.ndarray) -> None:
    """reference run.py:67-69."""
    np.savez_compressed(path, depths=depths)


def save_depth_exr(path: str, depth: np.ndarray) -> bool:
    """Single-frame EXR with a float Z channel (reference run.py:70-83).

    Uses OpenEXR if importable, else cv2's EXR encoder; returns False if no
    EXR backend is available (callers fall back to .npy, mirroring the
    engine's EXR->PNG fallback ladder, reference engine.py:911-919).
    """
    depth = np.ascontiguousarray(depth.astype(np.float32))
    try:
        import Imath
        import OpenEXR

        header = OpenEXR.Header(depth.shape[1], depth.shape[0])
        header["channels"] = {
            "Z": Imath.Channel(Imath.PixelType(Imath.PixelType.FLOAT))}
        f = OpenEXR.OutputFile(path, header)
        try:
            f.writePixels({"Z": depth.tobytes()})
        finally:
            f.close()
        return True
    except ImportError:
        pass
    try:
        os.environ.setdefault("OPENCV_IO_ENABLE_OPENEXR", "1")
        import cv2

        return bool(cv2.imwrite(path, depth))
    except Exception:
        return False


def save_depth_exr_sequence(out_dir: str, depths: np.ndarray,
                            name_fmt: str = "frame_{:05d}.exr") -> None:
    os.makedirs(out_dir, exist_ok=True)
    for i in range(depths.shape[0]):
        path = os.path.join(out_dir, name_fmt.format(i))
        if not save_depth_exr(path, depths[i]):
            np.save(path.replace(".exr", ".npy"), depths[i].astype(np.float32))


def save_point_clouds(out_dir: str, frames: np.ndarray, depths: np.ndarray,
                      focal_length_x: float, focal_length_y: float) -> None:
    """Metric-depth point clouds via pinhole back-projection
    (reference run.py:85-101).  Writes ASCII PLY without needing open3d."""
    os.makedirs(out_dir, exist_ok=True)
    height, width = depths[0].shape[-2:]
    x, y = np.meshgrid(np.arange(width), np.arange(height))
    x = (x - width / 2) / focal_length_x
    y = (y - height / 2) / focal_length_y
    for i, (color, z) in enumerate(zip(frames, depths)):
        pts = np.stack((x * z, y * z, z), axis=-1).reshape(-1, 3)
        cols = color.reshape(-1, 3).astype(np.uint8)
        path = os.path.join(out_dir, f"point{i:04d}.ply")
        _write_ply(path, pts, cols)


def _write_ply(path: str, points: np.ndarray, colors: np.ndarray) -> None:
    n = points.shape[0]
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {n}\n"
        "property float x\nproperty float y\nproperty float z\n"
        "property uchar red\nproperty uchar green\nproperty uchar blue\n"
        "end_header\n"
    )
    rec = np.zeros(n, dtype=[("xyz", np.float32, 3), ("rgb", np.uint8, 3)])
    rec["xyz"] = points.astype(np.float32)
    rec["rgb"] = colors
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(rec.tobytes())
