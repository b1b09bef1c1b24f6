"""The published inference protocols, frozen: preprocessing, the 32-frame
windows with their keyframe overlap and scale/shift stitching
(``video_depth.py`` ``infer_video_depth``), and the causal stream's cache
bookkeeping (``video_depth_stream.py`` ``infer_video_depth_one``).

Plain torch and numpy; nothing of the program under test.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from h100_bench.reference.model import Reference

INFER_LEN = 32
OVERLAP = 10
KEYFRAMES = (0, 12, 24, 25, 26, 27, 28, 29, 30, 31)
INTERP_LEN = 8
ALIGN_LEN = OVERLAP - INTERP_LEN
KF_ALIGN_LIST = KEYFRAMES[:ALIGN_LEN]
STREAM_GAP = (INFER_LEN - OVERLAP) * 2 - 1 - ALIGN_LEN  # 41
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


# -- preprocessing (util/transform.py, video_depth.py:72-89) -----------------
def input_size(h: int, w: int, size: int, patch: int = 14) -> int:
    ratio = max(h, w) / min(h, w)
    if ratio > 1.78:
        size = int(size * 1.777 / ratio)
        size = round(size / patch) * patch
    return size


def _multiple(x: float, m: int, min_val: int) -> int:
    y = int(np.round(x / m) * m)
    if y < min_val:
        y = int(np.ceil(x / m) * m)
    return y


def net_size(h: int, w: int, size: int, patch: int = 14):
    """The keep-aspect "lower_bound" resize to multiples of the patch."""
    size = input_size(h, w, size, patch)
    s = max(size / h, size / w)
    return _multiple(s * h, patch, size), _multiple(s * w, patch, size)


def preprocess(frames_u8: torch.Tensor, net_hw) -> torch.Tensor:
    """(T, H, W, 3) uint8 -> (T, 3, h, w) fp32: /255, bicubic (a = -0.75,
    half-pixel, edge pixels repeated: cv2.INTER_CUBIC), ImageNet
    normalisation."""
    x = frames_u8.permute(0, 3, 1, 2).float() / 255.0
    x = F.interpolate(x, size=net_hw, mode="bicubic", align_corners=False)
    mean = torch.tensor(MEAN, device=x.device).view(1, 3, 1, 1)
    std = torch.tensor(STD, device=x.device).view(1, 3, 1, 1)
    return (x - mean) / std


# -- windows --------------------------------------------------------------
def window_inputs(n_frames: int) -> List[List[int]]:
    """Source frame of every input slot of every window: the reference's
    loop with the last frame repeated as padding and each window's first
    OVERLAP slots taken from the previous window's KEYFRAMES."""
    step = INFER_LEN - OVERLAP
    pad = (step - n_frames % step) % step + (INFER_LEN - step)
    src = list(range(n_frames)) + [n_frames - 1] * pad
    out, pre = [], None
    for start in range(0, n_frames, step):
        cur = src[start:start + INFER_LEN]
        if pre is not None:
            cur[:OVERLAP] = [pre[k] for k in KEYFRAMES]
        out.append(cur)
        pre = cur
    return out


def window_depth(ref: Reference, frames: np.ndarray, window: int, size: int,
                 device) -> torch.Tensor:
    """Depths (32, H, W) fp32 of one window of a video (N, H, W, 3) uint8."""
    idx = window_inputs(frames.shape[0])[window]
    h, w = frames.shape[1:3]
    patch = ref.cfg["encoder"]["patch_size"]
    x = preprocess(torch.from_numpy(frames[idx]).to(device),
                   net_size(h, w, size, patch))
    return ref.forward_window(x, (h, w))


def _scale_shift(pred, target):
    """Least-squares scale and shift of pred onto target (utils/util.py
    ``compute_scale_and_shift`` with an all-ones mask)."""
    a_00 = (pred * pred).sum()
    a_01 = pred.sum()
    a_11 = torch.tensor(float(pred.numel()), dtype=pred.dtype)
    b_0 = (pred * target).sum()
    b_1 = target.sum()
    det = a_00 * a_11 - a_01 * a_01
    if float(det) == 0.0:
        return 1.0, 0.0
    return (a_11 * b_0 - a_01 * b_1) / det, (-a_01 * b_0 + a_00 * b_1) / det


def stitch(depths: List[np.ndarray], dtype=torch.float32) -> np.ndarray:
    """The reference's alignment pass over concatenated window depths
    (video_depth.py:120-160), in ``dtype`` on the host.  Returns every
    aligned frame, (n_windows * 22 + 10, H, W) fp32."""
    d = [torch.from_numpy(np.asarray(x, np.float32)).to(dtype)
         for x in depths]
    aligned, ref_align = [], []
    step = INFER_LEN
    for fid in range(0, len(d), step):
        if not aligned:
            aligned += d[:INFER_LEN]
            ref_align = [d[fid + k] for k in KF_ALIGN_LIST]
            continue
        cur = torch.cat([d[fid + i] for i in range(len(KF_ALIGN_LIST))])
        s, t = _scale_shift(cur, torch.cat(ref_align))
        post = [torch.clamp(d[fid + ALIGN_LEN + i] * s + t, min=0)
                for i in range(INTERP_LEN)]
        pre = aligned[-INTERP_LEN:]
        wts = [i / (INTERP_LEN - 1) for i in range(INTERP_LEN)]
        aligned[-INTERP_LEN:] = [pre[i] * (1 - wts[i]) + post[i] * wts[i]
                                 for i in range(INTERP_LEN)]
        for i in range(OVERLAP, INFER_LEN):
            aligned.append(torch.clamp(d[fid + i] * s + t, min=0))
        ref_align = ref_align[:1] + [torch.clamp(d[fid + k] * s + t, min=0)
                                     for k in KF_ALIGN_LIST[1:]]
    return torch.stack(aligned).float().numpy()


# -- the causal stream --------------------------------------------------------
class StreamReplay:
    """The reference stream from frame 0: the frame cache list of
    ``infer_video_depth_one`` (the first frame's rows stand for 32 entries;
    the context is entries [0:2] + [-29:]; entry 1 is dropped once
    id + 32 > gap + 1), one frame a step.  An entry keeps each attention
    block's projected (k, v) rows of the frame (``Reference.
    temporal_attention``).

    ``frame(i)`` gives (uint8 (H, W, 3) tensor, key): frames with equal keys
    are equal, and their encoder taps are computed once.
    """

    def __init__(self, ref: Reference, frame: Callable, size: int, device):
        self.ref = ref
        self.frame = frame
        self.device = device
        self.size = size
        self.taps: Dict[object, list] = {}
        self.cache_list: List[list] = []
        self.id = -1
        self.net_hw = self.out_hw = None

    def _taps(self, i: int):
        f, key = self.frame(i)
        if key not in self.taps:
            if self.net_hw is None:
                self.out_hw = tuple(f.shape[:2])
                patch = self.ref.cfg["encoder"]["patch_size"]
                self.net_hw = net_size(*self.out_hw, self.size, patch)
            x = preprocess(f[None].to(self.device), self.net_hw)
            self.taps[key] = self.ref.encode(x)
        return self.taps[key]

    def step(self, want_depth: bool) -> Optional[torch.Tensor]:
        """Run the next frame; its depth (H, W) fp32 if ``want_depth``."""
        self.id += 1
        taps = self._taps(self.id)
        patch = self.ref.cfg["encoder"]["patch_size"]
        phw = (self.net_hw[0] // patch, self.net_hw[1] // patch)
        if self.id == 0:
            stage, rows = self.ref.head_stage(taps, phw, 1, rows=True)
            self.cache_list = [rows] * INFER_LEN
        else:
            cur = self.cache_list[0:2] + self.cache_list[-(INFER_LEN - 3):]
            ctx = [tuple(torch.cat([c[i][j] for c in cur], dim=1)
                         for j in range(2)) for i in range(len(cur[0]))]
            stage, rows = self.ref.head_stage(taps, phw, 1, ctx)
            self.cache_list.append(rows)
        if self.id + INFER_LEN > STREAM_GAP + 1:
            del self.cache_list[1]
        if not want_depth:
            return None
        return self.ref.depth(stage, self.net_hw, self.out_hw)[0]
