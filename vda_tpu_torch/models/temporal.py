"""Temporal motion module, PyTorch (offline path).

Counterpart of ``vda_tpu/models/temporal.py`` for offline windows
(``need_caches=False``, APE): GroupNorm(32, eps 1e-6) -> proj_in -> one
TemporalTransformerBlock per position over time -> proj_out -> residual.
Module names follow the reference state-dict keys, ``pos_encoder.pe``
buffers included; the sinusoidal table used is that buffer.

Dispatch follows the JAX gates: a block whose width K3 takes runs whole in
K3 (``fused_block_supported``); otherwise each attention sub-block runs in
K4 where it takes the width (``attn_fused_supported``) and the GEGLU
feed-forward stays plain.  The streaming cache and RoPE are not ported yet.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from vda_tpu_torch.config import ModelConfig
from vda_tpu_torch.ops import temporal_kernel as tk
from vda_tpu_torch.ops.layers import Linear, Norm, group_norm, linear


def sinusoidal_pe(max_len: int, d_model: int) -> torch.Tensor:
    """The reference's ``pos_encoder.pe`` buffer (motion_module.py:192-206),
    (1, max_len, d_model) fp32."""
    position = torch.arange(max_len).unsqueeze(1)
    div_term = torch.exp(torch.arange(0, d_model, 2)
                         * (-math.log(10000.0) / d_model))
    pe = torch.zeros(1, max_len, d_model)
    pe[0, :, 0::2] = torch.sin(position * div_term)
    pe[0, :, 1::2] = torch.cos(position * div_term)
    return pe


class PositionalEncoding(nn.Module):
    def __init__(self, c, max_len, device=None):
        super().__init__()
        self.register_buffer("pe", sinusoidal_pe(max_len, c).to(device))


class TemporalAttention(nn.Module):
    def __init__(self, c, cfg: ModelConfig, device=None):
        super().__init__()
        self.to_q = Linear(c, c, bias=False, device=device)
        self.to_k = Linear(c, c, bias=False, device=device)
        self.to_v = Linear(c, c, bias=False, device=device)
        self.to_out = nn.ModuleList([Linear(c, c, device=device)])
        self.pos_encoder = PositionalEncoding(c, cfg.num_frames, device=device)


class GEGLU(nn.Module):
    def __init__(self, c, device=None):
        super().__init__()
        self.proj = Linear(c, 8 * c, device=device)


class FeedForward(nn.Module):
    def __init__(self, c, device=None):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(c, device=device), nn.Identity(),
                                  Linear(4 * c, c, device=device)])


class TemporalTransformerBlock(nn.Module):
    def __init__(self, c, cfg: ModelConfig, device=None):
        super().__init__()
        n = cfg.num_attention_blocks
        self.attention_blocks = nn.ModuleList(
            TemporalAttention(c, cfg, device=device) for _ in range(n))
        self.norms = nn.ModuleList(Norm(c, device=device) for _ in range(n))
        self.ff = FeedForward(c, device=device)
        self.ff_norm = Norm(c, device=device)


class TemporalTransformer3DModel(nn.Module):
    def __init__(self, c, cfg: ModelConfig, device=None):
        super().__init__()
        self.norm = Norm(c, device=device)  # GroupNorm scale/shift
        self.proj_in = Linear(c, c, device=device)
        self.transformer_blocks = nn.ModuleList(
            TemporalTransformerBlock(c, cfg, device=device)
            for _ in range(cfg.num_transformer_block))
        self.proj_out = Linear(c, c, device=device)


class TemporalModule(nn.Module):
    def __init__(self, c, cfg: ModelConfig, device=None):
        super().__init__()
        if cfg.pe != "ape":
            raise NotImplementedError("only the APE motion module is ported")
        self.temporal_transformer = TemporalTransformer3DModel(c, cfg,
                                                               device=device)


def _transformer_block(block: TemporalTransformerBlock, h, cfg: ModelConfig,
                       kernels: bool):
    """h: (BD, T, C).  Reference motion_module.py:172-189."""
    bd, t, c = h.shape
    heads = cfg.num_attention_heads
    pe = block.attention_blocks[0].pos_encoder.pe[0]
    if kernels and tk.fused_block_supported(c, t, cfg.pe, heads,
                                            cfg.num_attention_blocks):
        return tk.temporal_block_fused(block, h, pe, heads)
    use_k4 = kernels and tk.attn_fused_supported(c, t, cfg.pe, heads)
    for attn, norm in zip(block.attention_blocks, block.norms):
        pe = attn.pos_encoder.pe[0]
        if use_k4:
            h = tk.attention_block_fused(attn, norm, h, pe, heads)
        else:
            h = tk.attention_block_reference(attn, norm, h, pe, heads,
                                             ln_kernel=kernels)
    return tk.feed_forward(block, h, ln_kernel=kernels)


def temporal_module_apply(mm: TemporalModule, x, cfg: ModelConfig,
                          kernels: bool = True):
    """x: (B, T, H, W, C) -> (B, T, H, W, C)."""
    b, t, hh, ww, c = x.shape
    tt = mm.temporal_transformer
    h = group_norm(tt.norm, x.reshape(b * t, hh, ww, c),
                   cfg.norm_num_groups, eps=1e-6)
    h = linear(tt.proj_in, h.reshape(b, t, hh * ww, c))
    # (B, T, D, C) -> (B*D, T, C) sequences per spatial position
    h = h.transpose(1, 2).reshape(b * hh * ww, t, c).contiguous()
    for block in tt.transformer_blocks:
        h = _transformer_block(block, h, cfg, kernels)
    h = h.reshape(b, hh * ww, t, c).transpose(1, 2)
    h = linear(tt.proj_out, h).reshape(b, t, hh, ww, c)
    return h + x
