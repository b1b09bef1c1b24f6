"""VideoDepthAnything: DINOv2 encoder + temporal DPT head, PyTorch.

Counterpart of ``vda_tpu/models/vda.py``: ``forward_features`` (the
encoder), ``forward_depth`` (the head, with the streaming caches) and
``forward`` (offline windows).
x layout: (B, T, H, W, 3) channels-last normalised frames; depth (B, T, H, W)
non-negative.
"""

from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

from vda_tpu_torch.config import ModelConfig
from vda_tpu_torch.models.dinov2 import DinoVisionTransformer, encode
from vda_tpu_torch.models.dpt import DPTHeadTemporal, dpt_head_temporal_apply
from vda_tpu_torch.ops.resize import resize_bilinear

ATTN_IMPLS = ("auto", "plain")


class VideoDepthAnything(nn.Module):
    """Parameter container; names match the reference state dict."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.pretrained = DinoVisionTransformer(cfg.vit, device=device)
        self.head = DPTHeadTemporal(cfg, device=device)


def use_kernels(attn_impl: str) -> bool:
    """``"auto"``: the hand-written kernels (their wrappers take the plain
    twins for CPU tensors); ``"plain"``: plain PyTorch everywhere."""
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, "
                         f"got {attn_impl!r}")
    return attn_impl == "auto"


def forward_features(model: VideoDepthAnything, x, attn_impl: str = "auto"):
    """Encoder taps (reference video_depth_stream.py:65-67): x (B, T, H, W,
    3) -> four (tokens (B*T, N, D), cls (B*T, D))."""
    b, t, h, w, c = x.shape
    return encode(model.pretrained, x.reshape(b * t, h, w, c),
                  model.cfg.intermediate_layer_idx, use_kernels(attn_impl))


def forward_depth(model: VideoDepthAnything, features, x_shape,
                  cached_hidden_state_list: Optional[List] = None,
                  micro_batch_size: int = 4, cache_kind: str = "h",
                  need_caches: bool = True, attn_impl: str = "auto"):
    """Head + resize + ReLU (reference video_depth_stream.py:69-75).
    Returns (depth (B, T, H, W), new cache rows); see
    ``dpt.dpt_head_temporal_apply`` for the cache kinds."""
    cfg = model.cfg
    b, t, h, w, _ = x_shape
    patch_hw = (h // cfg.vit.patch_size, w // cfg.vit.patch_size)
    depth, caches = dpt_head_temporal_apply(
        model.head, features, patch_hw, t, cfg,
        cached_hidden_state_list=cached_hidden_state_list,
        micro_batch_size=micro_batch_size, cache_kind=cache_kind,
        need_caches=need_caches, kernels=use_kernels(attn_impl))
    depth = torch.relu(resize_bilinear(depth, (h, w), align_corners=True))
    return depth[..., 0].reshape(b, t, h, w), caches


@torch.no_grad()
def forward(model: VideoDepthAnything, x, attn_impl: str = "auto",
            micro_batch_size: int = 4):
    """Full forward (reference video_depth.py:61-68): (B,T,H,W,3) -> (B,T,H,W)."""
    features = forward_features(model, x, attn_impl)
    depth, _ = forward_depth(model, features, x.shape,
                             micro_batch_size=micro_batch_size,
                             need_caches=False, attn_impl=attn_impl)
    return depth
