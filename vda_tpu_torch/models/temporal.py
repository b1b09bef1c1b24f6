"""Temporal motion module, PyTorch.

Counterpart of ``vda_tpu/models/temporal.py``: GroupNorm(32, eps 1e-6) ->
proj_in -> one TemporalTransformerBlock per position over time -> proj_out
-> residual, for offline windows and for the streaming caches (the
reference's hidden-state cache, the pre-PE K/V-projection cache, and that
cache handed to K6).  Module names follow the reference state-dict keys.

Positions are encoded by ``cfg.pe``.  "ape" adds the sinusoidal table to
the attention input; it is the ``pos_encoder.pe`` buffer, registered under
APE alone, as the reference exports it.  "rope" rotates q and k after
their projection (reference motion_module/attention.py:403-429): the
interleaved channel pairs (0, 1), (2, 3), ... of the whole width C, not of
one head, turn by angle ``pos * 10000^(-2j / C)``, in fp32, the result in
the input's dtype.  A query and a key take their position in the attended
sequence: in the caches, the new frames' queries positions ``T_cache..``
and the context ``0..``, so a cached frame's position moves as the context
slides.  The caches hold unrotated rows.

Dispatch follows the JAX gates exactly: offline (``need_caches=False``), a
block whose width K3 takes runs whole in K3 (``fused_block_supported``),
else each attention sub-block runs in K4 where it takes the width
(``attn_fused_supported``); every other attention over whole sequences of
at most 64 frames runs in K5 (``tiny_seq_kernel.use_kernel``), the
streaming first step included; the kv cache goes through K6 when the stream
asks for it (``stream_kernel.use_kernel``), over the gathered context or,
once the context's rows are distinct, over the cache buffers in place.
``kernels=False`` turns all four off; the LayerNorms take K2 by
``ln_kernel`` (default: ``kernels``), so JAX's training set
(``attn_impl="xla"``) is ``kernels=False, ln_kernel=True``.  The JAX gates
keep K3, K4 and K6 to APE, so under RoPE K5 takes every attention over
whole sequences and the kv cache runs plain.
"""

from __future__ import annotations

import functools
import math
from typing import List, Optional

import numpy as np
import torch
from torch import nn

from vda_tpu_torch.config import INFER_LEN, ModelConfig
from vda_tpu_torch.ops import stream_kernel as sk
from vda_tpu_torch.ops import temporal_kernel as tk
from vda_tpu_torch.ops import tiny_seq_kernel as ts
from vda_tpu_torch.ops.attention import attention_plain
from vda_tpu_torch.ops.layers import (
    Linear,
    Norm,
    cast_once,
    group_norm,
    layer_norm,
    linear,
)


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


@functools.lru_cache(maxsize=None)
def rope_tables(dim: int, end: int, device) -> tuple:
    """The rotation's (end, dim / 2) cos and sin tables, computed in float64
    (reference precompute_freqs_cis, attention.py:403-408), as fp32 tensors
    on ``device``, made once a key (a steady streaming step copies nothing
    to the device); callers do not modify them."""
    freqs = 1.0 / (10000.0 ** (np.arange(0, dim, 2)[: dim // 2] / dim))
    f = np.outer(np.arange(end, dtype=np.float64), freqs)
    return tuple(torch.from_numpy(a.astype(np.float32)).to(device)
                 for a in (np.cos(f), np.sin(f)))


def apply_rope(x, cos, sin):
    """Rotate the channel pairs (x[..., 0::2], x[..., 1::2]) of x by the
    tables (broadcast against x[..., 0::2]), in fp32; the result in x's
    dtype (reference apply_rotary_emb, attention.py:419-429)."""
    x32 = x.float()
    xr, xi = x32[..., 0::2], x32[..., 1::2]
    out = torch.stack([xr * cos - xi * sin, xr * sin + xi * cos], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


def _rope_at(x, start: int):
    """``apply_rope`` of (BD, T, C) x at positions start .. start + T - 1."""
    t, c = x.shape[1], x.shape[2]
    cos, sin = rope_tables(c, start + t, x.device)
    return apply_rope(x, cos[start:], sin[start:])


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
        if cfg.pe == "ape":
            self.pos_encoder = PositionalEncoding(c, cfg.num_frames,
                                                  device=device)


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


PES = ("ape", "rope")


class TemporalModule(nn.Module):
    def __init__(self, c, cfg: ModelConfig, device=None):
        super().__init__()
        if cfg.pe not in PES:
            raise ValueError(f"pe must be one of {PES}, got {cfg.pe!r}")
        self.temporal_transformer = TemporalTransformer3DModel(c, cfg,
                                                               device=device)


def _pe(attn: TemporalAttention, t: int, dtype):
    """The first ``t`` rows of the module's sinusoidal table in ``dtype``
    (the whole table cast once)."""
    return cast_once(attn.pos_encoder.pe, dtype)[0, :t]


def _attend(q, k, v, heads: int, kernels: bool):
    """Per-head attention of q (BD, Tq, C) over k, v (BD, T, C): K5 where
    the JAX gate admits it, else the plain form."""
    bd, t_q, c = q.shape
    t_full = k.shape[1]
    dh = c // heads
    if kernels and ts.use_kernel(t_q, t_full, dh):
        return ts.tiny_seq_attention(q, k, v, heads, dh ** -0.5)
    return attention_plain(q.reshape(bd, t_q, heads, dh),
                           k.reshape(bd, t_full, heads, dh),
                           v.reshape(bd, t_full, heads, dh),
                           dh ** -0.5).reshape(bd, t_q, c)


def _temporal_attention(attn: TemporalAttention, h, cfg: ModelConfig, cache,
                        want_kv: bool = False, kernels: bool = True):
    """h: (BD, T_new, C) normed sequences.  Reference motion_module.py:
    242-321 (JAX ``_temporal_attention``).

    cache: None; a (BD, T_cache, C) tensor of pre-PE hidden states (the
    "h" cache); a ``(k, v)`` tuple of pre-PE projections (the "kv" cache,
    ``_temporal_attention_kv``); or ``(k, v, "ctx")``, the same handed to
    K6 (``_temporal_attention_kv_ctx``); or ``(k_buf, v_buf, pos_map,
    valid)``, the whole cache buffers read in place by K6
    (``_temporal_attention_kv_direct``).  Returns (out (BD, T_new, C),
    cache_row): the new rows in the cache's kind, (k_new, v_new) when
    ``want_kv``."""
    if isinstance(cache, tuple):
        if len(cache) == 4:
            return _temporal_attention_kv_direct(attn, h, cfg, cache, kernels)
        if len(cache) == 3:
            return _temporal_attention_kv_ctx(attn, h, cfg, cache, kernels)
        return _temporal_attention_kv(attn, h, cfg, cache)
    input_hidden_states = h
    d_in = 0
    if cache is not None:
        d_in = cache.shape[1]
        h = torch.cat([cache.to(h.dtype), h], dim=1)
    bd, t_full, c = h.shape
    rope = cfg.pe == "rope"
    if not rope:
        h = h + _pe(attn, t_full, h.dtype)
    if d_in == 0:
        # one fused (C, 3C) product; q, k, v are column slices of it
        qkv = torch.matmul(h, tk._wqkv(attn, h.dtype).t())
        if rope:  # q and k rotated at the same positions, as one (2, C)
            cos, sin = rope_tables(c, t_full, h.device)
            qk = apply_rope(qkv[..., :2 * c].unflatten(-1, (2, c)),
                            cos[:, None], sin[:, None])
            # v copied beside them: K5 reads q, k, v with one row stride
            qkv = torch.cat([qk.flatten(-2), qkv[..., 2 * c:]], dim=-1)
        q, k, v = qkv.split(c, dim=-1)
    else:
        q = linear(attn.to_q, h[:, d_in:])
        k = linear(attn.to_k, h)
        v = linear(attn.to_v, h)
        if rope:
            q, k = _rope_at(q, d_in), _rope_at(k, 0)
    o = _attend(q, k, v, cfg.num_attention_heads, kernels)
    out = linear(attn.to_out[0], o)
    if want_kv:
        return out, (linear(attn.to_k, input_hidden_states),
                     linear(attn.to_v, input_hidden_states))
    return out, input_hidden_states


def _temporal_attention_kv(attn: TemporalAttention, h, cfg: ModelConfig,
                           cache):
    """The "kv" cache: pre-PE K/V projections of the context.  to_k and to_v
    have no bias, so to_k(h_i + pe_i) == to_k(h_i) + to_k(pe_i): the cache
    holds to_k(h_i) and a (T, C) product adds the projected encoding (JAX
    ``_temporal_attention_kv``).  Under RoPE the rotation follows the
    projection, so the split is exact: q and the assembled k are rotated."""
    kc, vc = cache
    bd, t_new, c = h.shape
    d_in = kc.shape[1]
    t_full = d_in + t_new
    k_new = linear(attn.to_k, h)
    v_new = linear(attn.to_v, h)
    k = torch.cat([kc.to(h.dtype), k_new], dim=1)
    v = torch.cat([vc.to(h.dtype), v_new], dim=1)
    if cfg.pe == "ape":
        pe = _pe(attn, t_full, h.dtype)
        q = linear(attn.to_q, h + pe[None, d_in:t_full])
        k = k + linear(attn.to_k, pe)[None]
        v = v + linear(attn.to_v, pe)[None]
    else:  # the whole context rotated at its positions in it, each step
        q = _rope_at(linear(attn.to_q, h), d_in)
        k = _rope_at(k, 0)
    heads = cfg.num_attention_heads
    dh = c // heads
    o = attention_plain(q.reshape(bd, t_new, heads, dh),
                        k.reshape(bd, t_full, heads, dh),
                        v.reshape(bd, t_full, heads, dh),
                        dh ** -0.5).reshape(bd, t_new, c)
    return linear(attn.to_out[0], o), (k_new, v_new)


def _temporal_attention_kv_ctx(attn: TemporalAttention, h, cfg: ModelConfig,
                               cache, kernels: bool = True):
    """The "kv" cache through K6 (JAX ``_temporal_attention_kv_ctx``): the
    encoding add, scores, softmax and value sum over the (BD, T_ctx, C)
    context in one kernel, instead of the concatenation, encoding adds and
    attention passes of ``_temporal_attention_kv``.  Shapes the JAX gate
    refuses go to ``_temporal_attention_kv``."""
    kc, vc = cache[0], cache[1]
    bd, t_new, c = h.shape
    heads = cfg.num_attention_heads
    if not (kernels and sk.use_kernel(t_new, c, heads, cfg.pe)):
        return _temporal_attention_kv(attn, h, cfg, (kc, vc))
    t_ctx = kc.shape[1]
    t_full = t_ctx + 1
    pe = _pe(attn, t_full, h.dtype)
    k_new = linear(attn.to_k, h)  # pre-PE, what the cache keeps
    v_new = linear(attn.to_v, h)
    pe_k = linear(attn.to_k, pe)
    pe_v = linear(attn.to_v, pe)
    q = linear(attn.to_q, h + pe[None, t_full - 1:t_full])[:, 0]
    kn = k_new[:, 0] + pe_k[t_full - 1]
    vn = v_new[:, 0] + pe_v[t_full - 1]
    o = sk.stream_kv_attention(q, kn, vn, kc.to(h.dtype), vc.to(h.dtype),
                               pe_k[:t_ctx], pe_v[:t_ctx],
                               sk.all_valid(t_ctx, h.device), heads,
                               (c // heads) ** -0.5)
    return linear(attn.to_out[0], o[:, None]), (k_new, v_new)


def _temporal_attention_kv_direct(attn: TemporalAttention, h,
                                  cfg: ModelConfig, cache,
                                  kernels: bool = True):
    """The kv cache's buffers read in place by K6 (JAX
    ``_temporal_attention_kv_direct``), with no context gathered: cache is
    ``(k_buf, v_buf, pos_map, valid)``, the (BD, rows, C) pre-PE K/V
    buffers of the stream, each row's position in the 31-entry context
    (``pos_map``, (rows,) int, arbitrary where not valid) and the rows that
    form the context (``valid``, (rows,) uint8 or bool).  Each row gets the
    projected encoding of its context position (``index_select`` by
    ``pos_map`` clipped to [0, 30]); K6 never reads a row that is not
    valid.  The same function as ``_temporal_attention_kv_ctx`` over the
    gathered context, its rows summed in buffer order.  The stream's gate
    (``infer/streaming.StreamingDepth._direct_ok``) sends only what K6
    takes; anything else raises, since no other path reads the buffers in
    place."""
    k_buf, v_buf, pos_map, valid = cache
    bd, t_new, c = h.shape
    heads = cfg.num_attention_heads
    if not (kernels and sk.use_kernel(t_new, c, heads, cfg.pe)):
        raise ValueError(f"the in-place cache read needs K6: {t_new} new "
                         f"frames of width {c}, {heads} heads, pe "
                         f"{cfg.pe!r}, kernels {kernels}")
    t_full = INFER_LEN  # the 31 context positions and the new frame
    pe = _pe(attn, t_full, h.dtype)
    k_new = linear(attn.to_k, h)  # pre-PE, what the cache keeps
    v_new = linear(attn.to_v, h)
    pe_k = linear(attn.to_k, pe)
    pe_v = linear(attn.to_v, pe)
    q = linear(attn.to_q, h + pe[None, t_full - 1:t_full])[:, 0]
    kn = k_new[:, 0] + pe_k[t_full - 1]
    vn = v_new[:, 0] + pe_v[t_full - 1]
    idx = pos_map.clamp(0, t_full - 2)
    o = sk.stream_kv_attention(q, kn, vn, k_buf, v_buf,
                               pe_k.index_select(0, idx),
                               pe_v.index_select(0, idx), valid, heads,
                               (c // heads) ** -0.5)
    return linear(attn.to_out[0], o[:, None]), (k_new, v_new)


def _transformer_block(block: TemporalTransformerBlock, h, cfg: ModelConfig,
                       caches, want_kv: bool = False, need_caches: bool = True,
                       kernels: bool = True, ln_kernel: bool = True):
    """h: (BD, T_new, C).  Reference motion_module.py:172-189.  Returns (h,
    the new cache rows of its attention sub-blocks)."""
    c = h.shape[-1]
    heads = cfg.num_attention_heads
    use_k4 = (caches is None and not want_kv and not need_caches and kernels
              and tk.attn_fused_supported(c, h.shape[1], cfg.pe, heads))
    out_caches = []
    for i, (attn, norm) in enumerate(zip(block.attention_blocks,
                                         block.norms)):
        if use_k4:
            h = tk.attention_block_fused(attn, norm, h, attn.pos_encoder.pe[0],
                                         heads)
            continue
        hn = layer_norm(norm, h, eps=1e-5, kernel=ln_kernel)
        attn_out, cache_row = _temporal_attention(
            attn, hn, cfg, None if caches is None else caches[i],
            want_kv=want_kv, kernels=kernels)
        h = attn_out + h
        out_caches.append(cache_row)
    return tk.feed_forward(block, h, ln_kernel=ln_kernel), out_caches


def temporal_module_apply(mm: TemporalModule, x, cfg: ModelConfig,
                          cache_list: Optional[List] = None,
                          want_kv: bool = False, need_caches: bool = True,
                          kernels: bool = True, ln_kernel: bool | None = None):
    """x: (B, T, H, W, C) -> ((B, T, H, W, C), new cache rows).

    With ``cache_list`` (streaming) T counts the new frames and each entry
    is one sub-block's context in a ``_temporal_attention`` cache kind.  The
    cache rows come back in the same kind ((k, v) with ``want_kv``), one per
    attention sub-block.  ``need_caches=False`` (offline windows) lets K3
    take whole blocks and K4 the attention sub-blocks where the JAX gates
    admit them; those return no cache rows.  ``kernels=False`` keeps K3-K6
    off; ``ln_kernel`` (default: ``kernels``) decides K2."""
    if ln_kernel is None:
        ln_kernel = kernels
    b, t, hh, ww, c = x.shape
    tt = mm.temporal_transformer
    heads = cfg.num_attention_heads
    h = group_norm(tt.norm, x.reshape(b * t, hh, ww, c),
                   cfg.norm_num_groups, eps=1e-6)
    h = linear(tt.proj_in, h.reshape(b, t, hh * ww, c))
    # (B, T, D, C) -> (B*D, T, C) sequences per spatial position
    h = h.transpose(1, 2).reshape(b * hh * ww, t, c).contiguous()
    use_k3 = (cache_list is None and not want_kv and not need_caches
              and kernels
              and tk.fused_block_supported(c, t, cfg.pe, heads,
                                           cfg.num_attention_blocks))
    n_per = cfg.num_attention_blocks
    all_caches = []
    for i, block in enumerate(tt.transformer_blocks):
        if use_k3:
            pe = block.attention_blocks[0].pos_encoder.pe[0]
            h = tk.temporal_block_fused(block, h, pe, heads)
            continue
        caches = None
        if cache_list is not None:
            caches = cache_list[i * n_per:(i + 1) * n_per]
        h, out_caches = _transformer_block(block, h, cfg, caches, want_kv,
                                           need_caches, kernels, ln_kernel)
        all_caches.extend(out_caches)
    h = h.reshape(b, hh * ww, t, c).transpose(1, 2)
    h = linear(tt.proj_out, h).reshape(b, t, hh, ww, c)
    return h + x, all_caches
