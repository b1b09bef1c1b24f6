"""Cross-window scale/shift stitching (host-side numpy, float32).

Faithful rebuild of the reference alignment pass
(reference video_depth.py:120-160 and utils/util.py): per window, solve the
closed-form least-squares scale/shift aligning the new window's first
ALIGN_LEN depths against reference keyframe depths, clamp negatives, linearly
cross-fade the INTERP_LEN overlap frames, and refresh the keyframe reference
set.  This runs on the host: it is O(pixels) numpy on data that must come back
to the host anyway for encoding, and keeping it in fp32 numpy makes it
bit-stable across backends.
"""

from __future__ import annotations

from typing import List

import numpy as np

from vda_tpu_torch.config import (
    ALIGN_LEN,
    INFER_LEN,
    INTERP_LEN,
    KF_ALIGN_LIST,
    OVERLAP,
)


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

    b_1 = np.sum(mask * target)
    det = a_00 * a_11 - a_01 * a_01
    if det == 0:
        return 1.0, 0.0
    x_0 = (a_11 * b_0 - a_01 * b_1) / det
    x_1 = (-a_01 * b_0 + a_00 * b_1) / det
    return float(x_0), float(x_1)


def get_interpolate_frames(pre: List[np.ndarray], post: List[np.ndarray]):
    """Linear cross-fade with endpoint weights 0 and 1
    (reference utils/util.py:65-74)."""
    assert len(pre) == len(post)
    n = len(pre)
    step = 1.0 / (n - 1)
    weights = [0.0] + [i * step for i in range(1, n - 1)] + [1.0]
    return [pre[i] * (1.0 - weights[i]) + post[i] * weights[i]
            for i in range(n)]


def stitch_windows(depth_list: List[np.ndarray], metric: bool = False):
    """Align and blend per-window depths into one sequence
    (reference video_depth.py:120-160).

    depth_list: per-frame depths, concatenated window outputs — the layout the
    window loop produces (len == n_windows * INFER_LEN; each window's first
    OVERLAP frames are re-inferences of the previous window's KEYFRAMES).
    """
    aligned: List[np.ndarray] = []
    ref_align: List[np.ndarray] = []

    for frame_id in range(0, len(depth_list), INFER_LEN):
        if not aligned:
            aligned += depth_list[:INFER_LEN]
            for kf_id in KF_ALIGN_LIST:
                ref_align.append(depth_list[frame_id + kf_id])
            continue

        curr_align = [depth_list[frame_id + i] for i in range(len(KF_ALIGN_LIST))]
        if metric:
            scale, shift = 1.0, 0.0
        else:
            scale, shift = compute_scale_and_shift(
                np.concatenate(curr_align),
                np.concatenate(ref_align),
                np.ones_like(np.concatenate(ref_align)))

        pre = aligned[-INTERP_LEN:]
        post = [depth_list[frame_id + ALIGN_LEN + i] for i in range(INTERP_LEN)]
        post = [np.maximum(d * scale + shift, 0.0) for d in post]
        aligned[-INTERP_LEN:] = get_interpolate_frames(pre, post)

        for i in range(OVERLAP, INFER_LEN):
            aligned.append(np.maximum(depth_list[frame_id + i] * scale + shift,
                                      0.0))

        ref_align = ref_align[:1]
        for kf_id in KF_ALIGN_LIST[1:]:
            ref_align.append(np.maximum(depth_list[frame_id + kf_id] * scale
                                        + shift, 0.0))

    return aligned
