"""Cross-window scale/shift stitching (host-side, float32, in place).

Faithful rebuild of the reference alignment pass
(reference video_depth.py:120-160 and utils/util.py): per window, solve the
closed-form least-squares scale/shift aligning the new window's first
ALIGN_LEN depths against reference keyframe depths, clamp negatives, linearly
cross-fade the INTERP_LEN overlap frames, and refresh the keyframe reference
set.  This runs on the host, on data that must come back to the host anyway
for encoding.

``stitch_windows`` writes the stitched video straight into one fp32 array.
Its elementwise passes run in place on ``torch.from_numpy`` views, a run of
a window's frames at a time, so torch's intra-op threads split them (a run
below torch's grain size stays on one thread); the fit's sums are numpy's
over the same concatenated arrays as ``vda_tpu/infer/stitching.py``.  Every
step keeps that module's fp32 operations, order and roundings (no fused
multiply-add), so the two agree bit for bit; only the sign of a zero that
the clamp returns may differ, where numpy's own ``maximum`` differs between
its CPU loops.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from vda_tpu_torch.config import (
    ALIGN_LEN,
    INFER_LEN,
    INTERP_LEN,
    KF_ALIGN_LIST,
    OVERLAP,
)
from vda_tpu_torch.utils import trace

# float32 counts every whole number below this exactly, so a sum of this
# many ones is the count itself
_EXACT_COUNT = 2 ** 24


def _solve(a_00, a_01, a_11, b_0, b_1):
    """The 2x2 normal equations' scale and shift (float32 sums in)."""
    det = a_00 * a_11 - a_01 * a_01
    if det == 0:
        return 1.0, 0.0
    x_0 = (a_11 * b_0 - a_01 * b_1) / det
    x_1 = (-a_01 * b_0 + a_00 * b_1) / det
    return float(x_0), float(x_1)


def compute_scale_and_shift(prediction: np.ndarray, target: np.ndarray,
                            mask: np.ndarray, scale_only: bool = False):
    """Closed-form 2x2 normal-equation solve (reference utils/util.py:23-62)."""
    prediction = prediction.astype(np.float32)
    target = target.astype(np.float32)
    mask = mask.astype(np.float32)

    a_00 = np.sum(mask * prediction * prediction)
    a_01 = np.sum(mask * prediction)
    a_11 = np.sum(mask)
    b_0 = np.sum(mask * prediction * target)

    if scale_only:
        return b_0 / (a_00 + 1e-6), 0.0

    return _solve(a_00, a_01, a_11, b_0, np.sum(mask * target))


def _fit(cur: np.ndarray, ref: np.ndarray, tmp: np.ndarray):
    """``compute_scale_and_shift(cur, ref, ones)`` without the mask:
    ``1 * x == x`` and a sum of fewer than 2**24 ones is exact, so every sum
    is the same numpy sum over an array of the same values and shape.  The
    products run on torch's threads into ``tmp``."""
    cur_t, tmp_t = torch.from_numpy(cur), torch.from_numpy(tmp)
    torch.mul(cur_t, cur_t, out=tmp_t)
    a_00 = np.sum(tmp)
    a_01 = np.sum(cur)
    if cur.size < _EXACT_COUNT:
        a_11 = np.float32(cur.size)
    else:
        a_11 = np.sum(np.ones_like(cur))
    torch.mul(cur_t, torch.from_numpy(ref), out=tmp_t)
    b_0 = np.sum(tmp)
    return _solve(a_00, a_01, a_11, b_0, np.sum(ref))


def _align(src: torch.Tensor, scale: float, shift: float,
           out: torch.Tensor) -> None:
    """out = max(src * scale + shift, 0), each step rounded to fp32."""
    torch.mul(src, scale, out=out)
    out.add_(shift)
    out.clamp_min_(0.0)


def _float32_frames(depth_list: Sequence[np.ndarray]) -> List[np.ndarray]:
    """Each frame as fp32 C-contiguous: itself where it is one, else a
    copy; the copies are counted as ``stitch_converted_frames``."""
    frames, converted = [], 0
    for d in depth_list:
        f = np.ascontiguousarray(d, dtype=np.float32)
        converted += f is not d
        frames.append(f)
    trace.count("stitch_converted_frames", converted)
    return frames


def _run(frames: List[np.ndarray], start: int, stop: int,
         spare: np.ndarray) -> np.ndarray:
    """Frames ``start:stop`` as one (stop - start, *frame) array: a view
    where they are consecutive frames of one C-contiguous array, as the
    window fetch hands them over, else stacked into ``spare``."""
    run = frames[start:stop]
    base = run[0].base
    if (isinstance(base, np.ndarray) and base.flags.c_contiguous
            and base.dtype == np.float32 and base.shape[1:] == run[0].shape):
        step, at = run[0].nbytes, run[0].ctypes.data
        first, rem = divmod(at - base.ctypes.data, step)
        if rem == 0 and all(f.base is base and f.ctypes.data == at + i * step
                            for i, f in enumerate(run)):
            return base[first:first + len(run)]
    return np.stack(run, out=spare[:len(run)])


def stitch_windows(depth_list: Sequence[np.ndarray],
                   metric: bool = False) -> np.ndarray:
    """Align and blend per-window depths into one sequence
    (reference video_depth.py:120-160).

    depth_list: per-frame depths, concatenated window outputs — the layout the
    window loop produces (len == n_windows * INFER_LEN; each window's first
    OVERLAP frames are re-inferences of the previous window's KEYFRAMES).
    It is only read.  Returns the stitched frames as one C-contiguous fp32
    array, (n_windows * INFER_LEN - (n_windows - 1) * OVERLAP, *frame);
    ``metric``: scale 1 and shift 0, the clamp still applied.
    """
    frames = _float32_frames(depth_list)
    n_in = len(frames)
    n_windows = -(-n_in // INFER_LEN)
    shape = frames[0].shape
    out = np.empty((n_in - (n_windows - 1) * OVERLAP,) + shape, np.float32)
    out_t = torch.from_numpy(out)
    # written only where a run of frames is not one array's (see _run)
    spare = np.empty((INFER_LEN,) + shape, np.float32)

    # the fit's operands, concatenated as np.concatenate joins frames
    n_align = len(KF_ALIGN_LIST)
    cat_shape = (n_align * shape[0],) + shape[1:]
    ref, tmp = np.empty(cat_shape, np.float32), np.empty(cat_shape, np.float32)
    ref_t = torch.from_numpy(ref).view((n_align,) + shape)
    post = torch.empty((INTERP_LEN,) + shape, dtype=torch.float32)
    step = 1.0 / (INTERP_LEN - 1)
    weights = [0.0] + [i * step for i in range(1, INTERP_LEN - 1)] + [1.0]
    bcast = (INTERP_LEN,) + (1,) * len(shape)
    w_post = torch.tensor(weights, dtype=torch.float32).view(bcast)
    w_pre = torch.tensor([1.0 - w for w in weights],
                         dtype=torch.float32).view(bcast)

    end = min(n_in, INFER_LEN)  # frames of ``out`` written so far
    out_t[:end].copy_(torch.from_numpy(_run(frames, 0, end, spare)))
    for j, kf_id in enumerate(KF_ALIGN_LIST):
        ref_t[j].copy_(torch.from_numpy(frames[kf_id]))

    for frame_id in range(INFER_LEN, n_in, INFER_LEN):
        if metric:
            scale, shift = 1.0, 0.0
        else:
            cur = _run(frames, frame_id, frame_id + n_align, spare)
            scale, shift = _fit(cur.reshape(cat_shape), ref, tmp)

        # cross-fade the last INTERP_LEN frames with the aligned overlap
        src = _run(frames, frame_id + ALIGN_LEN, frame_id + OVERLAP, spare)
        _align(torch.from_numpy(src), scale, shift, post)
        pre = out_t[end - INTERP_LEN:end]
        pre.mul_(w_pre)
        post.mul_(w_post)
        pre.add_(post)

        src = _run(frames, frame_id + OVERLAP, frame_id + INFER_LEN, spare)
        _align(torch.from_numpy(src), scale, shift,
               out_t[end:end + INFER_LEN - OVERLAP])
        end += INFER_LEN - OVERLAP

        for j, kf_id in enumerate(KF_ALIGN_LIST[1:], 1):
            _align(torch.from_numpy(frames[frame_id + kf_id]), scale, shift,
                   ref_t[j])

    return out
