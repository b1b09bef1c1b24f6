"""DINOv2 ViT encoder, PyTorch.

Counterpart of ``vda_tpu/models/dinov2.py`` (inference path, ``ffn_layer``
"mlp"): conv patch embed, bicubic pos-embed interpolation with the +0.1
offset, pre-norm blocks with LayerScale, and ``encode`` taps with the final
norm.  Module names follow the reference state-dict keys.  Tokens are
(B, N, D) and are not padded: the attention kernel takes N as it is.

``kernels=True`` routes the attention through K1 where the JAX gate admits
it (``attention_kernel.use_kernel``) and the LayerNorms through K2; with
``fuse_proj=True`` as well, attention, out-projection, LayerScale and
residual go through K7 where its gate admits them; on CPU tensors every
wrapper runs its plain twin.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from vda_tpu_torch.config import EncoderConfig
from vda_tpu_torch.ops import attention_kernel, attn_proj_kernel
from vda_tpu_torch.ops.layers import (
    Conv2d,
    Linear,
    Norm,
    cast_once,
    gelu,
    layer_norm,
    linear,
)
from vda_tpu_torch.ops.resize import resize_bicubic


class PatchEmbed(nn.Module):
    def __init__(self, cfg: EncoderConfig, device=None):
        super().__init__()
        self.proj = Conv2d(3, cfg.embed_dim, cfg.patch_size, device=device)


class Attention(nn.Module):
    def __init__(self, d, device=None):
        super().__init__()
        self.qkv = Linear(d, 3 * d, device=device)
        self.proj = Linear(d, d, device=device)


class LayerScale(nn.Module):
    def __init__(self, d, device=None):
        super().__init__()
        self.gamma = nn.Parameter(torch.empty(d, device=device))


class Mlp(nn.Module):
    def __init__(self, d, hidden, device=None):
        super().__init__()
        self.fc1 = Linear(d, hidden, device=device)
        self.fc2 = Linear(hidden, d, device=device)


class Block(nn.Module):
    def __init__(self, cfg: EncoderConfig, device=None):
        super().__init__()
        d = cfg.embed_dim
        self.norm1 = Norm(d, device=device)
        self.attn = Attention(d, device=device)
        self.ls1 = LayerScale(d, device=device)
        self.norm2 = Norm(d, device=device)
        self.mlp = Mlp(d, int(d * cfg.mlp_ratio), device=device)
        self.ls2 = LayerScale(d, device=device)


class DinoVisionTransformer(nn.Module):
    def __init__(self, cfg: EncoderConfig, device=None):
        super().__init__()
        if cfg.ffn_layer != "mlp":
            raise NotImplementedError(f"ffn_layer {cfg.ffn_layer!r} is not "
                                      "ported yet (vitg's SwiGLU)")
        d = cfg.embed_dim
        self.cfg = cfg
        self.cls_token = nn.Parameter(torch.empty(1, 1, d, device=device))
        self.mask_token = nn.Parameter(torch.empty(1, d, device=device))
        self.pos_embed = nn.Parameter(
            torch.empty(1, cfg.num_patches + 1, d, device=device))
        self.patch_embed = PatchEmbed(cfg, device=device)
        self.blocks = nn.ModuleList(Block(cfg, device=device)
                                    for _ in range(cfg.depth))
        self.norm = Norm(d, device=device)


def _patch_embed(p, x):
    """(B, H, W, 3) -> (B, ph*pw, D): the k == stride conv as one matmul."""
    b, h, w, c = x.shape
    k = p.weight.shape[-1]
    ph, pw = h // k, w // k
    xx = x.reshape(b, ph, k, pw, k, c).permute(0, 1, 3, 2, 4, 5)
    xx = xx.reshape(b, ph * pw, k * k * c)
    wk = p.weight.permute(0, 2, 3, 1).reshape(p.weight.shape[0], -1)
    return torch.matmul(xx, wk.to(x.dtype).t()) + p.bias.to(x.dtype)


def _interp_pos_embed(pos_embed, grid_hw, cfg: EncoderConfig):
    """Bicubic with an explicit scale factor and the +interpolate_offset
    workaround, in fp32 (reference dinov2.py:179-210)."""
    ph, pw = grid_hw
    n = pos_embed.shape[1] - 1
    side = int(math.sqrt(n))
    if ph * pw == n and ph == pw:
        return pos_embed
    cls_pos = pos_embed[:, :1]
    patch_pos = pos_embed[:, 1:].reshape(1, side, side, -1)
    sh = (ph + cfg.interpolate_offset) / side
    sw = (pw + cfg.interpolate_offset) / side
    patch_pos = resize_bicubic(patch_pos.float(), (ph, pw), scale=(sh, sw))
    return torch.cat([cls_pos, patch_pos.reshape(1, ph * pw, -1)
                      .to(pos_embed.dtype)], dim=1)


def prepare_tokens(enc: DinoVisionTransformer, x):
    """Patch embed + cls token + (interpolated) position embedding."""
    b, h, w, _ = x.shape
    cfg = enc.cfg
    grid = (h // cfg.patch_size, w // cfg.patch_size)
    tokens = _patch_embed(enc.patch_embed.proj, x)
    cls = enc.cls_token.to(tokens.dtype).expand(b, 1, -1)
    tokens = torch.cat([cls, tokens], dim=1)
    return tokens + _interp_pos_embed(enc.pos_embed, grid, cfg).to(tokens.dtype)


def _attention(p: Attention, x, heads: int, kernels: bool):
    b, n, d = x.shape
    dh = d // heads
    qkv = linear(p.qkv, x)  # [q | k | v] along the last axis
    if kernels and attention_kernel.use_kernel(n, dh):
        o = attention_kernel.flash_attention_qkv(qkv, heads, dh ** -0.5)
    else:
        o = attention_kernel.flash_attention_qkv_reference(qkv, heads,
                                                           dh ** -0.5)
    return linear(p.proj, o)


def block_apply(blk: Block, x, cfg: EncoderConfig, kernels: bool,
                fuse_proj: bool = False):
    """Pre-norm block: x + ls1*attn(n1(x)); x + ls2*mlp(n2(x)).

    ``fuse_proj`` (with the kernels) runs the first half through K7 where
    its gate admits the shape (JAX's ``VDA_ATTN_FUSE_PROJ=1`` branch): W in
    the working dtype, cast once; LayerScale gamma and the projection bias
    in fp32."""
    if fuse_proj and kernels and attn_proj_kernel.use_fused_proj(
            x.shape[1], cfg.num_heads, cfg.head_dim):
        qkv = linear(blk.attn.qkv, layer_norm(blk.norm1, x, kernel=True))
        proj = blk.attn.proj
        gb = torch.stack([blk.ls1.gamma.float(), proj.bias.float()])
        x = attn_proj_kernel.flash_attention_qkv_proj(
            qkv, cast_once(proj.weight, qkv.dtype), gb, x, cfg.num_heads,
            cfg.head_dim ** -0.5)
    else:
        h = _attention(blk.attn, layer_norm(blk.norm1, x, kernel=kernels),
                       cfg.num_heads, kernels)
        x = x + h * blk.ls1.gamma.to(h.dtype)
    h = layer_norm(blk.norm2, x, kernel=kernels)
    h = linear(blk.mlp.fc2, gelu(linear(blk.mlp.fc1, h)))
    return x + h * blk.ls2.gamma.to(h.dtype)


def encode(enc: DinoVisionTransformer, x, tap_idx: Sequence[int],
           kernels: bool = True, fuse_proj: bool = False):
    """Reference get_intermediate_layers(x, tap_idx, return_class_token=True).

    x: (B, H, W, 3) normalised images.  Returns a list of (patch tokens
    (B, N, D), cls token (B, D)) per tap, the final LayerNorm applied.
    ``fuse_proj``: see ``block_apply``."""
    cfg = enc.cfg
    taps = set(tap_idx)
    h = prepare_tokens(enc, x)
    out = {}
    for i, blk in enumerate(enc.blocks):
        h = block_apply(blk, h, cfg, kernels, fuse_proj)
        if i in taps:
            out[i] = h
    result = []
    for i in tap_idx:
        t = layer_norm(enc.norm, out[i], kernel=kernels)
        result.append((t[:, 1 + cfg.num_register_tokens:], t[:, 0]))
    return result
