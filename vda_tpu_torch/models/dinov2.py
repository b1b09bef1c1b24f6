"""DINOv2 ViT encoder, PyTorch.

Counterpart of ``vda_tpu/models/dinov2.py``: conv patch embed, bicubic
pos-embed interpolation with the +0.1 offset, pre-norm blocks with
LayerScale, and ``encode`` taps with the final norm.  The block's
feed-forward is the GELU MLP (``ffn_layer="mlp"``) or, for vitg, the SwiGLU
of ``ffn_layer="swiglufused"`` (``mlp.w12``, d -> 2 hidden, and ``mlp.w3``:
``w3(silu(x1) * x2)``).  Module names follow the reference state-dict keys.
Tokens are (B, N, D) and are not padded: the attention kernel takes N as it
is.

``kernels=True`` routes the attention through K1 where the JAX gate admits
it (``attention_kernel.use_kernel``); with ``fuse_proj=True`` as well,
attention, out-projection, LayerScale and residual go through K7 where its
gate admits them.  ``ln_kernel`` (default: ``kernels``) routes the
LayerNorms through K2; JAX's training set (``attn_impl="xla"``) is
``kernels=False, ln_kernel=True``.  On CPU tensors every wrapper runs its
plain twin.

Training: ``prepare_tokens(masks=)`` (iBOT mask token), stochastic depth in
``block_apply`` / ``encode`` (``drop_path_rate`` with a ``torch.Generator``,
DINOv2's linear per-block schedule), ``encode(remat=True)`` (each block
recomputed in the backward by ``torch.utils.checkpoint``), and
``block_apply_nested``, the NestedTensorBlock over a list of token batches
of different lengths (K8 through ``packed_self_attention``).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from vda_tpu_torch.config import EncoderConfig
from vda_tpu_torch.ops import attention_kernel, attn_proj_kernel
from vda_tpu_torch.ops.attention import packed_self_attention
from vda_tpu_torch.ops.layers import (
    Conv2d,
    Linear,
    Norm,
    apply_drop_path,
    cast_once,
    drop_path_mask,
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


class SwiGLUFFN(nn.Module):
    """vitg's feed-forward (reference dinov2_layers/swiglu_ffn.py): hidden
    ``(int(int(d * mlp_ratio) * 2 / 3) + 7) // 8 * 8``, 4096 at d 1536."""

    def __init__(self, d, mlp_ratio, device=None):
        super().__init__()
        hidden = (int(int(d * mlp_ratio) * 2 / 3) + 7) // 8 * 8
        self.w12 = Linear(d, 2 * hidden, device=device)
        self.w3 = Linear(hidden, d, device=device)


FFN_LAYERS = ("mlp", "swiglufused")


class Block(nn.Module):
    def __init__(self, cfg: EncoderConfig, device=None):
        super().__init__()
        d = cfg.embed_dim
        self.norm1 = Norm(d, device=device)
        self.attn = Attention(d, device=device)
        self.ls1 = LayerScale(d, device=device)
        self.norm2 = Norm(d, device=device)
        if cfg.ffn_layer == "swiglufused":
            self.mlp = SwiGLUFFN(d, cfg.mlp_ratio, device=device)
        else:
            self.mlp = Mlp(d, int(d * cfg.mlp_ratio), device=device)
        self.ls2 = LayerScale(d, device=device)


class DinoVisionTransformer(nn.Module):
    def __init__(self, cfg: EncoderConfig, device=None):
        super().__init__()
        if cfg.ffn_layer not in FFN_LAYERS:
            raise ValueError(f"ffn_layer must be one of {FFN_LAYERS}, got "
                             f"{cfg.ffn_layer!r}")
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
    return torch.matmul(xx, wk.to(x.dtype).t()) + cast_once(p.bias, x.dtype)


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


def prepare_tokens(enc: DinoVisionTransformer, x, masks=None):
    """Patch embed + optional iBOT masking + cls token + (interpolated)
    position embedding (reference dinov2.py:212-231).  ``masks``: optional
    (B, N_patches) bool; True patches take the learned ``mask_token`` before
    the position embedding is added (training only)."""
    b, h, w, _ = x.shape
    cfg = enc.cfg
    grid = (h // cfg.patch_size, w // cfg.patch_size)
    tokens = _patch_embed(enc.patch_embed.proj, x)
    if masks is not None:
        tokens = torch.where(masks[..., None],
                             cast_once(enc.mask_token, tokens.dtype), tokens)
    cls = cast_once(enc.cls_token, tokens.dtype).expand(b, 1, -1)
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


def _mlp(blk: Block, x):
    """The block's feed-forward: GELU MLP, or SwiGLU ``w3(silu(x1) * x2)``
    with x1, x2 the halves of ``w12(x)`` (JAX ``_mlp``)."""
    if isinstance(blk.mlp, SwiGLUFFN):
        x1, x2 = linear(blk.mlp.w12, x).chunk(2, dim=-1)
        return linear(blk.mlp.w3, torch.nn.functional.silu(x1) * x2)
    return linear(blk.mlp.fc2, gelu(linear(blk.mlp.fc1, x)))


def _draw_masks(x, rate: float, generator):
    """The two drop-path masks of a block (attention and MLP branch), or
    None at rate 0 or without a generator."""
    if rate <= 0.0 or generator is None:
        return None
    return tuple(drop_path_mask(x.shape[0], rate, generator, x.dtype)
                 for _ in range(2))


def _block(blk: Block, x, cfg: EncoderConfig, kernels: bool, fuse_proj: bool,
           ln_kernel: bool, masks):
    """``block_apply`` with its drop-path masks drawn (None: no drop)."""
    if masks is None and fuse_proj and kernels \
            and attn_proj_kernel.use_fused_proj(x.shape[1], cfg.num_heads,
                                                cfg.head_dim):
        qkv = linear(blk.attn.qkv, layer_norm(blk.norm1, x, kernel=ln_kernel))
        proj = blk.attn.proj
        gb = torch.stack([blk.ls1.gamma.float(), proj.bias.float()])
        x = attn_proj_kernel.flash_attention_qkv_proj(
            qkv, cast_once(proj.weight, qkv.dtype), gb, x, cfg.num_heads,
            cfg.head_dim ** -0.5)
    else:
        h = _attention(blk.attn, layer_norm(blk.norm1, x, kernel=ln_kernel),
                       cfg.num_heads, kernels)
        h = h * cast_once(blk.ls1.gamma, h.dtype)
        if masks is not None:
            h = apply_drop_path(h, masks[0])
        x = x + h
    h = _mlp(blk, layer_norm(blk.norm2, x, kernel=ln_kernel))
    h = h * cast_once(blk.ls2.gamma, h.dtype)
    if masks is not None:
        h = apply_drop_path(h, masks[1])
    return x + h


def block_apply(blk: Block, x, cfg: EncoderConfig, kernels: bool,
                fuse_proj: bool = False, drop_path_rate: float = 0.0,
                generator: torch.Generator | None = None):
    """Pre-norm block: x + ls1*attn(n1(x)); x + ls2*mlp(n2(x)).

    ``fuse_proj`` (with the kernels) runs the first half through K7 where
    its gate admits the shape (JAX's ``VDA_ATTN_FUSE_PROJ=1`` branch): W in
    the working dtype, cast once; LayerScale gamma and the projection bias
    in fp32.  ``drop_path_rate`` > 0 with a ``generator`` applies
    stochastic depth to both residual branches (reference block.py:110-201;
    it turns K7 off, as in JAX)."""
    return _block(blk, x, cfg, kernels, fuse_proj, kernels,
                  _draw_masks(x, drop_path_rate, generator))


def block_apply_nested(blk: Block, x_list, cfg: EncoderConfig,
                       impl: str = "auto"):
    """Variable-length batched block, the reference NestedTensorBlock
    (dinov2_layers/block.py:204-252; JAX ``block_apply_nested``).

    x_list: (B_i, N_i, D) token batches of different N_i.  Every sample is
    packed into one (1, sum B_i·N_i, D) row sequence that runs through one
    pre-norm block with attention block-diagonal over the samples
    (``packed_self_attention(segment_lengths=...)``: K8 with ``impl="auto"``,
    per-segment plain attention with ``"plain"``; the LayerNorms take K2
    with ``"auto"``).  Returns the list in the input shapes."""
    ln_kernel = impl == "auto"
    d = x_list[0].shape[-1]
    seglens = []
    for xi in x_list:
        seglens.extend([xi.shape[1]] * xi.shape[0])
    packed = torch.cat([xi.reshape(1, -1, d) for xi in x_list], dim=1)
    dh = d // cfg.num_heads
    qkv = linear(blk.attn.qkv, layer_norm(blk.norm1, packed, kernel=ln_kernel))
    q, k, v = qkv.split(d, dim=-1)
    o = packed_self_attention(q, k, v, cfg.num_heads, dh ** -0.5, impl,
                              segment_lengths=tuple(seglens))
    h = linear(blk.attn.proj, o)
    packed = packed + h * cast_once(blk.ls1.gamma, h.dtype)
    h = _mlp(blk, layer_norm(blk.norm2, packed, kernel=ln_kernel))
    packed = packed + h * cast_once(blk.ls2.gamma, h.dtype)
    outs = []
    off = 0
    for xi in x_list:
        n = xi.shape[0] * xi.shape[1]
        outs.append(packed[0, off:off + n].reshape(xi.shape))
        off += n
    return outs


def encode(enc: DinoVisionTransformer, x, tap_idx: Sequence[int],
           kernels: bool = True, fuse_proj: bool = False,
           ln_kernel: bool | None = None, remat: bool = False,
           drop_path_rate: float = 0.0,
           generator: torch.Generator | None = None, masks=None):
    """Reference get_intermediate_layers(x, tap_idx, return_class_token=True).

    x: (B, H, W, 3) normalised images.  Returns a list of (patch tokens
    (B, N, D), cls token (B, D)) per tap, the final LayerNorm applied.
    ``fuse_proj``: see ``block_apply``; ``ln_kernel``: K2 for the norms
    (default: ``kernels``).

    Training: ``remat=True`` recomputes each block in the backward
    (``torch.utils.checkpoint``, non-reentrant; the block's forward runs
    twice, its kernels launch twice).  ``drop_path_rate`` > 0 with a
    ``generator`` applies stochastic depth with DINOv2's linear schedule,
    block i at rate · i / (depth - 1) (reference dinov2.py:115-120); the
    masks are drawn before the checkpoint, so the recompute replays them.
    ``masks``: see ``prepare_tokens``."""
    from torch.utils.checkpoint import checkpoint

    cfg = enc.cfg
    if ln_kernel is None:
        ln_kernel = kernels
    taps = set(tap_idx)
    h = prepare_tokens(enc, x, masks=masks)
    depth = len(enc.blocks)
    out = {}
    for i, blk in enumerate(enc.blocks):
        rate = drop_path_rate * i / max(depth - 1, 1)
        dp = _draw_masks(h, rate, generator)
        if remat:
            h = checkpoint(_block, blk, h, cfg, kernels, fuse_proj, ln_kernel,
                           dp, use_reentrant=False)
        else:
            h = _block(blk, h, cfg, kernels, fuse_proj, ln_kernel, dp)
        if i in taps:
            out[i] = h
    result = []
    for i in tap_idx:
        t = layer_norm(enc.norm, out[i], kernel=ln_kernel)
        result.append((t[:, 1 + cfg.num_register_tokens:], t[:, 0]))
    return result
