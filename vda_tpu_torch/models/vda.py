"""VideoDepthAnything: DINOv2 encoder + temporal DPT head, PyTorch.

Counterpart of ``vda_tpu/models/vda.py`` ``forward`` (offline windows).
x layout: (B, T, H, W, 3) channels-last normalised frames; depth (B, T, H, W)
non-negative.
"""

from __future__ import annotations

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


@torch.no_grad()
def forward(model: VideoDepthAnything, x, attn_impl: str = "auto",
            micro_batch_size: int = 4):
    """Full forward (reference video_depth.py:61-68): (B,T,H,W,3) -> (B,T,H,W)."""
    cfg = model.cfg
    kernels = use_kernels(attn_impl)
    b, t, h, w, c = x.shape
    features = encode(model.pretrained, x.reshape(b * t, h, w, c),
                      cfg.intermediate_layer_idx, kernels)
    patch_hw = (h // cfg.vit.patch_size, w // cfg.vit.patch_size)
    depth = dpt_head_temporal_apply(model.head, features, patch_hw, t, cfg,
                                    micro_batch_size, kernels)
    depth = torch.relu(resize_bilinear(depth, (h, w), align_corners=True))
    return depth[..., 0].reshape(b, t, h, w)
