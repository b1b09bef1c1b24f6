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

    def __init__(self, cfg: ModelConfig, device="cuda"):
        """Parameters on ``device``: the card unless the caller asks for
        ``"cpu"``."""
        super().__init__()
        self.cfg = cfg
        self.pretrained = DinoVisionTransformer(cfg.vit, device=device)
        self.head = DPTHeadTemporal(cfg, device=device)


def use_kernels(attn_impl: str, **switches) -> bool:
    """``"auto"``: the hand-written kernels (their wrappers take the plain
    twins for CPU tensors); ``"plain"``: plain PyTorch everywhere.  The
    kernel switches (``fuse_proj``, ``resize_kernel``, ``ctx_kernel``) are
    refused with ``"plain"``."""
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, "
                         f"got {attn_impl!r}")
    on = [k for k, v in switches.items() if v]
    if on and attn_impl == "plain":
        raise ValueError(f"{', '.join(on)} require the kernels "
                         "(attn_impl='auto')")
    return attn_impl == "auto"


def forward_features(model: VideoDepthAnything, x, attn_impl: str = "auto",
                     fuse_proj: bool = False):
    """Encoder taps (reference video_depth_stream.py:65-67): x (B, T, H, W,
    3) -> four (tokens (B*T, N, D), cls (B*T, D)).  ``fuse_proj``: K7 for
    the blocks its gate admits (JAX's ``VDA_ATTN_FUSE_PROJ=1``)."""
    b, t, h, w, c = x.shape
    return encode(model.pretrained, x.reshape(b * t, h, w, c),
                  model.cfg.intermediate_layer_idx,
                  use_kernels(attn_impl, fuse_proj=fuse_proj), fuse_proj)


def forward_depth(model: VideoDepthAnything, features, x_shape,
                  cached_hidden_state_list: Optional[List] = None,
                  micro_batch_size: int = 4, cache_kind: str = "h",
                  need_caches: bool = True, attn_impl: str = "auto",
                  resize_kernel: bool = False):
    """Head + resize + ReLU (reference video_depth_stream.py:69-75).
    Returns (depth (B, T, H, W), new cache rows); see
    ``dpt.dpt_head_temporal_apply`` for the cache kinds.
    ``resize_kernel``: K10 for the upsamples its gate admits (JAX's
    ``VDA_RESIZE_KERNEL=1``)."""
    cfg = model.cfg
    b, t, h, w, _ = x_shape
    patch_hw = (h // cfg.vit.patch_size, w // cfg.vit.patch_size)
    depth, caches = dpt_head_temporal_apply(
        model.head, features, patch_hw, t, cfg,
        cached_hidden_state_list=cached_hidden_state_list,
        micro_batch_size=micro_batch_size, cache_kind=cache_kind,
        need_caches=need_caches,
        kernels=use_kernels(attn_impl, resize_kernel=resize_kernel),
        resize_kernel=resize_kernel)
    depth = torch.relu(resize_bilinear(depth, (h, w), align_corners=True))
    return depth[..., 0].reshape(b, t, h, w), caches


@torch.no_grad()
def forward(model: VideoDepthAnything, x, attn_impl: str = "auto",
            micro_batch_size: int = 4, fuse_proj: bool = False,
            resize_kernel: bool = False):
    """Full forward (reference video_depth.py:61-68): (B,T,H,W,3) -> (B,T,H,W).
    ``fuse_proj`` / ``resize_kernel``: see ``forward_features`` /
    ``forward_depth``."""
    features = forward_features(model, x, attn_impl, fuse_proj)
    depth, _ = forward_depth(model, features, x.shape,
                             micro_batch_size=micro_batch_size,
                             need_caches=False, attn_impl=attn_impl,
                             resize_kernel=resize_kernel)
    return depth
