"""Clip augmentation for video-depth training, on the device, PyTorch.

Counterpart of ``vda_tpu/utils/augment.py``: a spatially consistent
random-resized crop and horizontal flip per clip, and photometric jitter on
the video only.  As in JAX the crop is one bilinear lerp matrix per axis
built from the box, ``max(0, 1 - |src_i - j|)``, applied as two matrix
products, so no shape depends on the draw; depth and its mask resample by
the box's nearest (dominant) tap, never blended across a depth edge.

Sampling is split from application: ``sample_augment`` draws every clip's
box, flip and jitter factors from an explicit ``torch.Generator``;
``apply_augment`` is deterministic given those draws, which is what the
tests hold against JAX with JAX's own draws (the two random streams differ
by design).  ``augment_batch`` is the two in turn.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch


def _lerp_matrix(in_size: int, out_size: int, lo, hi):
    """(out, in) bilinear weights mapping the box [lo, hi] (inclusive source
    coordinates, 0-dim tensors) onto ``out_size`` rows, align_corners style:
    ``src_i = lo + i * (hi - lo) / (out - 1)``."""
    i = torch.arange(out_size, dtype=torch.float32, device=lo.device)
    step = (hi - lo) / max(out_size - 1, 1)
    src = torch.clamp(lo + i * step, 0.0, in_size - 1)
    j = torch.arange(in_size, dtype=torch.float32, device=lo.device)
    return torch.clamp(1.0 - (src[:, None] - j[None, :]).abs(), min=0.0)


def _nearest_matrix(w):
    """0/1 matrix taking each output row's dominant tap of ``w`` (the first
    of equal taps, as ``jnp.argmax``)."""
    return torch.nn.functional.one_hot(w.argmax(dim=1), w.shape[1]).to(w.dtype)


def _resample_clip(clip, wy, wx):
    """clip (T, H, W, C) -> (T, out_h, out_w, C) by the two lerp products."""
    y = torch.einsum("oh,thwc->towc", wy, clip)
    return torch.einsum("pw,towc->topc", wx, y)


def _uniform(generator, n: int, lo, hi):
    return lo + (hi - lo) * torch.rand(n, generator=generator,
                                       device=generator.device)


def sample_augment(generator: torch.Generator, batch: int, h: int, w: int,
                   scale_range=(0.6, 1.0),
                   jitter=(0.2, 0.2, 0.2)) -> Dict[str, torch.Tensor]:
    """Every clip's draws, (batch,) tensors on the generator's device: the
    crop box y0, y1, x0, x1 (a span of ``scale_range`` times the side and a
    uniform offset, as JAX's ``_sample_box``), ``flip`` (probability 0.5)
    and the brightness, contrast and saturation factors (uniform in 1 -/+
    each ``jitter``)."""
    lo_s, hi_s = scale_range
    out = {}
    for name, size in (("y", h), ("x", w)):
        span = (size - 1) * _uniform(generator, batch, lo_s, hi_s)
        start = _uniform(generator, batch, 0.0, 1.0) \
            * ((size - 1) - span + 1e-6)
        out[f"{name}0"], out[f"{name}1"] = start, start + span
    out["flip"] = torch.rand(batch, generator=generator,
                             device=generator.device) < 0.5
    for name, amount in zip(("brightness", "contrast", "saturation"), jitter):
        out[name] = _uniform(generator, batch, 1.0 - amount, 1.0 + amount)
    return out


def apply_crop(video, depth, mask, y0, y1, x0, x1, out_hw: Tuple[int, int]):
    """One clip's resized crop: video (T, H, W, 3) bilinear, depth and mask
    (T, H, W) by the nearest tap; mask comes back bool."""
    h, w = video.shape[1], video.shape[2]
    wy = _lerp_matrix(h, out_hw[0], y0, y1)
    wx = _lerp_matrix(w, out_hw[1], x0, x1)
    video_o = _resample_clip(video, wy, wx)
    dm = torch.stack([depth, mask.to(torch.float32)], dim=-1)
    dm_o = _resample_clip(dm, _nearest_matrix(wy), _nearest_matrix(wx))
    return video_o, dm_o[..., 0], dm_o[..., 1] > 0.5


def apply_flip(video, depth, mask, flip):
    """One clip flipped along W where ``flip`` (a bool 0-dim tensor)."""
    return (torch.where(flip, video.flip(-2), video),
            torch.where(flip, depth.flip(-1), depth),
            torch.where(flip, mask.flip(-1), mask))


def color_jitter(video, brightness, contrast, saturation):
    """Per-clip photometric jitter of [0, 1] RGB video (T, H, W, 3); the
    contrast anchors on the clip mean (JAX ``color_jitter``)."""
    v = video * brightness
    mean = v.mean()
    v = mean + (v - mean) * contrast
    gray = v.mean(dim=-1, keepdim=True)
    v = gray + (v - gray) * saturation
    return torch.clamp(v, 0.0, 1.0)


def apply_augment(batch: Dict[str, torch.Tensor], draws, out_hw):
    """The deterministic half: crop, flip and jitter each clip of
    {"video" (B, T, H, W, 3) in [0, 1], "depth" (B, T, H, W), "mask"
    (B, T, H, W)} by its ``draws``.  Returns the batch at ``out_hw``."""
    out = {"video": [], "depth": [], "mask": []}
    for i in range(batch["video"].shape[0]):
        v, d, m = apply_crop(batch["video"][i].to(torch.float32),
                             batch["depth"][i].to(torch.float32),
                             batch["mask"][i], draws["y0"][i],
                             draws["y1"][i], draws["x0"][i], draws["x1"][i],
                             out_hw)
        v, d, m = apply_flip(v, d, m, draws["flip"][i])
        v = color_jitter(v, draws["brightness"][i], draws["contrast"][i],
                         draws["saturation"][i])
        for k, x in zip(("video", "depth", "mask"), (v, d, m)):
            out[k].append(x)
    return {k: torch.stack(x) for k, x in out.items()}


def augment_batch(generator: torch.Generator, batch: Dict[str, torch.Tensor],
                  out_hw: Tuple[int, int], scale_range=(0.6, 1.0),
                  jitter=(0.2, 0.2, 0.2),
                  data_slice: Tuple[int, int] = (0, 1)
                  ) -> Dict[str, torch.Tensor]:
    """Augment a training batch to spatial size ``out_hw`` (JAX
    ``augment_batch``): ``sample_augment`` then ``apply_augment``.
    ``data_slice`` (index, count): the batch is slice ``index`` of
    ``count`` equal slices of a global batch, whose draws are made and
    this slice's kept (data parallelism draws what one device draws)."""
    b, _, h, w = batch["depth"].shape
    index, count = data_slice
    draws = sample_augment(generator, b * count, h, w, scale_range, jitter)
    draws = {k: v[index * b:(index + 1) * b] for k, v in draws.items()}
    return apply_augment(batch, draws, tuple(out_hw))
