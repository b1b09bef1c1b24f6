"""VideoDepthAnything: DINOv2 encoder + temporal DPT head, PyTorch.

Counterpart of ``vda_tpu/models/vda.py``: ``forward_features`` (the
encoder), ``forward_depth`` (the head, with the streaming caches) and
``forward`` (offline windows).
x layout: (B, T, H, W, 3) channels-last normalised frames; depth (B, T, H, W)
non-negative.  A model ``parallel/mesh.shard_model`` split over a mesh
runs the encoder and the motion modules' attention tensor-parallel on that
mesh (``model.mesh``, the one place it is kept); the DPT head and the tail
run whole on every rank.
"""

from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

from vda_tpu_torch.config import ModelConfig
from vda_tpu_torch.models.dinov2 import DinoVisionTransformer, encode
from vda_tpu_torch.models.dpt import DPTHeadTemporal, dpt_head_temporal_apply
from vda_tpu_torch.ops.resize import resize_bilinear
from vda_tpu_torch.parallel.mesh import model_mesh
from vda_tpu_torch.utils import trace

ATTN_IMPLS = ("auto", "xla", "plain")


class VideoDepthAnything(nn.Module):
    """Parameter container; names match the reference state dict."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        """Parameters on ``device``: the card unless the caller asks for
        ``"cpu"``."""
        super().__init__()
        self.cfg = cfg
        self.pretrained = DinoVisionTransformer(cfg.vit, device=device)
        self.head = DPTHeadTemporal(cfg, device=device)


def kernel_set(attn_impl: str, **switches) -> tuple[bool, bool]:
    """(kernels, ln_kernel) of an ``attn_impl``.  ``"auto"``: every
    hand-written kernel (their wrappers take the plain twins for CPU
    tensors).  ``"xla"``, JAX's training set (``parallel/train.py``): the
    attention kernels (K1, K7, K9) and the temporal ones (K3-K6) off, K2 on
    (JAX keys it on the device alone) and K10 where ``resize_kernel`` asks
    and its gate admits.  ``"plain"``: plain PyTorch everywhere.
    ``fuse_proj`` and ``ctx_kernel`` need ``"auto"``; ``resize_kernel`` is
    refused with ``"plain"``."""
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, "
                         f"got {attn_impl!r}")
    on = [k for k, v in switches.items()
          if v and (attn_impl == "plain"
                    or (attn_impl == "xla" and k != "resize_kernel"))]
    if on:
        raise ValueError(f"{', '.join(on)} require the kernels "
                         f"(not attn_impl={attn_impl!r})")
    return attn_impl == "auto", attn_impl != "plain"


def forward_features(model: VideoDepthAnything, x, attn_impl: str = "auto",
                     fuse_proj: bool = False, remat: bool = False,
                     drop_path_rate: float = 0.0,
                     generator: torch.Generator | None = None):
    """Encoder taps (reference video_depth_stream.py:65-67): x (B, T, H, W,
    3) -> four (tokens (B*T, N, D), cls (B*T, D)).  ``fuse_proj``: K7 for
    the blocks its gate admits (JAX's ``VDA_ATTN_FUSE_PROJ=1``).
    ``remat`` / ``drop_path_rate`` / ``generator``: training, see
    ``dinov2.encode``."""
    b, t, h, w, c = x.shape
    kernels, ln_kernel = kernel_set(attn_impl, fuse_proj=fuse_proj)
    with trace.span("encoder", device=x):
        return encode(model.pretrained, x.reshape(b * t, h, w, c),
                      model.cfg.intermediate_layer_idx, kernels, fuse_proj,
                      ln_kernel, remat=remat, drop_path_rate=drop_path_rate,
                      generator=generator, mesh=model_mesh(model))


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
    kernels, ln_kernel = kernel_set(attn_impl, resize_kernel=resize_kernel)
    depth, caches = dpt_head_temporal_apply(
        model.head, features, patch_hw, t, cfg,
        cached_hidden_state_list=cached_hidden_state_list,
        micro_batch_size=micro_batch_size, cache_kind=cache_kind,
        need_caches=need_caches, kernels=kernels,
        resize_kernel=resize_kernel, ln_kernel=ln_kernel,
        mesh=model_mesh(model))
    depth = torch.relu(resize_bilinear(depth, (h, w), align_corners=True))
    return depth[..., 0].reshape(b, t, h, w), caches


def forward(model: VideoDepthAnything, x, attn_impl: str = "auto",
            micro_batch_size: int = 4, fuse_proj: bool = False,
            resize_kernel: bool = False, remat: bool = False,
            drop_path_rate: float = 0.0,
            generator: torch.Generator | None = None):
    """Full forward (reference video_depth.py:61-68): (B,T,H,W,3) -> (B,T,H,W).
    ``fuse_proj`` / ``resize_kernel``: see ``forward_features`` /
    ``forward_depth``.  Differentiable (the inference entry points run it
    under ``torch.no_grad``); the train step runs ``attn_impl="xla"`` with
    ``remat`` and stochastic depth (``drop_path_rate`` with a
    ``generator``), as JAX's does."""
    features = forward_features(model, x, attn_impl, fuse_proj, remat=remat,
                                drop_path_rate=drop_path_rate,
                                generator=generator)
    depth, _ = forward_depth(model, features, x.shape,
                             micro_batch_size=micro_batch_size,
                             need_caches=False, attn_impl=attn_impl,
                             resize_kernel=resize_kernel)
    return depth
