"""K3 and K4: fused temporal-transformer blocks, CUDA C++.

K3 replaces ``vda_tpu/ops/pallas_temporal.py`` ``temporal_block_fused`` (its
``pl.pallas_call`` runs ``_block_kernel``): a whole TemporalTransformerBlock
on (BD, T, C) sequences, vitl mm2/mm3 at (1369, 32, 256) and (5476, 32, 256).
K4 replaces ``attention_block_fused`` (``_attn_only_kernel``): one attention
sub-block, vitl mm0/mm1 at C=1024, whose GEGLU feed-forward stays outside.

What bounds them on the H100: device-memory traffic of the intermediates.
Unfused, one C=256 block writes and re-reads nine row-sized tensors (qkv is
3C wide, the GEGLU input 8C wide) for about 1.3 MFLOP a row.  The kernels
(``csrc/temporal_block.cu``) keep all of them in shared memory: one thread
block owns whole T-frame sequences, reads its rows once and writes them once.
The TPU kernel held every weight in VMEM; here the 2.6 MB (C=256) or 8 MB
(C=1024) of weights stay in device memory (L2-resident: 50 MB L2), each block
streams them through shared memory 64 columns at a time with cp.async into
WMMA bf16 products, and the row tile is as tall as shared memory allows, so
each weight byte read serves as many rows as possible.  Attention runs per
sequence, (T x T) per head, instead of the TPU's block-diagonal masked
(rows x rows) score pass, which only suited the 128x128 MXU.  The GEGLU
input is formed 64 hidden columns at a time and never leaves the block.
Where one sequence's buffers do not fit shared memory (fp32 at C=1024, T
above 32 at C=1024) the largest move to a device-memory workspace; the C
side alone plans that layout (``plan`` in the .cu file), and this wrapper
asks it for the workspace size.  The weights are cast to the working dtype
once per parameter and reused (``layers.cast_once``).

Rounding follows the TPU kernel (``pallas_temporal.py`` module docstring):
LayerNorm stats fp32 (eps 1e-5), the APE added after the norm in the working
dtype, matmuls accumulated in fp32 and rounded to the working dtype, the
softmax exp rounded to bf16 with an fp32 sum and the normalisation deferred
to the output, tanh GELU in bf16 and erf GELU in fp32.
"""

from __future__ import annotations

import ctypes

import torch

from vda_tpu_torch.ops import _build
from vda_tpu_torch.ops.attention import attention_plain
from vda_tpu_torch.ops.layers import cast_once, gelu, layer_norm, linear

launches_block = 0  # K3 launches made by ``temporal_block_fused``
launches_attn = 0   # K4 launches made by ``attention_block_fused``

_MAX_FUSED_WIDTH = 512     # K3 takes C up to this (the JAX gate)


def fused_block_supported(c: int, t: int, pe: str, heads: int,
                          n_attn: int = 2) -> bool:
    """The JAX gate (``pallas_temporal.fused_block_supported``); K3 takes
    every shape it admits, in bf16 and fp32."""
    return (pe == "ape" and n_attn == 2 and c <= _MAX_FUSED_WIDTH and t <= 64
            and c % 128 == 0 and c % heads == 0 and (c // heads) % 8 == 0)


def attn_fused_supported(c: int, t: int, pe: str, heads: int) -> bool:
    """The JAX gate (``pallas_temporal.attn_fused_supported``); K4 takes
    every shape it admits, in bf16 and fp32."""
    return (pe == "ape" and _MAX_FUSED_WIDTH < c <= 1024 and t <= 64
            and c % 128 == 0 and c % heads == 0 and (c // heads) % 8 == 0)


# ---------------------------------------------------------------------------
# plain twins: the unfused offline path (vda_tpu/models/temporal.py
# ``_temporal_attention`` without cache and ``_transformer_block``)
# ---------------------------------------------------------------------------

def _wqkv(attn, dtype):
    return torch.cat([attn.to_q.weight, attn.to_k.weight, attn.to_v.weight],
                     dim=0).to(dtype)


def attention_block_reference(attn, norm, h, pe_table, heads: int,
                              ln_kernel: bool = False):
    """h + out(attn(LN(h) + pe)) on (BD, T, C) sequences."""
    bd, t, c = h.shape
    hn = layer_norm(norm, h, eps=1e-5, kernel=ln_kernel)
    hn = hn + pe_table[:t].to(h.dtype)
    qkv = torch.matmul(hn, _wqkv(attn, h.dtype).t())
    q, k, v = (x.reshape(bd, t, heads, c // heads) for x in qkv.split(c, -1))
    o = attention_plain(q, k, v, (c // heads) ** -0.5).reshape(bd, t, c)
    return h + linear(attn.to_out[0], o)


def feed_forward(block, h, ln_kernel: bool = False):
    """h + GEGLU(LN(h)) (reference motion_module/attention.py:363-384)."""
    hn = layer_norm(block.ff_norm, h, eps=1e-5, kernel=ln_kernel)
    x12 = linear(block.ff.net[0].proj, hn)
    x1, gate = x12.chunk(2, dim=-1)
    return h + linear(block.ff.net[2], x1 * gelu(gate))


def temporal_block_reference(block, h, pe_table, heads: int,
                             ln_kernel: bool = False):
    """Plain twin of K3: both attention sub-blocks, then the feed-forward."""
    for attn, norm in zip(block.attention_blocks, block.norms):
        h = attention_block_reference(attn, norm, h, pe_table, heads,
                                      ln_kernel)
    return feed_forward(block, h, ln_kernel)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _check(name, h, pe_table):
    t, c = h.shape[1:]
    if h.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {h.device}")
    if h.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name}: unsupported dtype {h.dtype}")
    if not h.is_contiguous() or h.data_ptr() % 16:
        raise ValueError(f"{name}: h must be contiguous and 16-byte aligned")
    if pe_table.shape[0] < t or pe_table.shape[1] != c:
        raise ValueError(f"{name}: pe_table {tuple(pe_table.shape)} too small")
    if torch.is_grad_enabled() and h.requires_grad:
        raise NotImplementedError(f"{name} has no backward yet")


def _workspace(name, h, heads, full):
    """(workspace tensor or None, its bytes) for this launch, as the C side
    plans it; raises for a shape the kernel does not take."""
    bd, t, c = h.shape
    n = ctypes.c_ulonglong(0)
    err = _build.library().vda_temporal_workspace(
        bd, t, c, heads, int(h.dtype == torch.bfloat16), int(full),
        ctypes.byref(n))
    if err:
        raise ValueError(f"{name}: unsupported shape {tuple(h.shape)} with "
                         f"{heads} heads")
    if not n.value:
        return None, 0
    return torch.empty(n.value, dtype=torch.uint8, device=h.device), n.value


def _ptrs(name, h, tensors):
    """The device pointers of ``tensors``: on h's device, 16-byte aligned,
    and not needing a gradient (the kernels have no backward)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(f"{name} has no backward yet")
    for t in tensors:
        if t.device != h.device or t.data_ptr() % 16:
            raise ValueError(f"{name}: weights and pe_table must be on "
                             f"{h.device} and 16-byte aligned")
    return [t.data_ptr() for t in tensors]


def _attn_tensors(attn, norm, dtype):
    f32 = torch.float32
    mats = (attn.to_q, attn.to_k, attn.to_v, attn.to_out[0])
    return [cast_once(norm.weight, f32), cast_once(norm.bias, f32),
            *(cast_once(m.weight, dtype) for m in mats),
            cast_once(attn.to_out[0].bias, f32)]


def attention_block_fused(attn, norm, h, pe_table, heads: int):
    """K4: one LN -> +PE -> qkv -> per-sequence attention -> out-proj ->
    residual sub-block on (BD, T, C) sequences."""
    global launches_attn
    if h.device.type == "cpu":
        return attention_block_reference(attn, norm, h, pe_table, heads)
    name = "attention_block_fused"
    _check(name, h, pe_table)
    bd, t, c = h.shape
    ws, ws_bytes = _workspace(name, h, heads, full=False)
    # ``args`` keeps every tensor alive until the launch is queued
    args = [pe_table[:t].detach().float().contiguous(),
            *_attn_tensors(attn, norm, h.dtype)]
    out = torch.empty_like(h)
    err = _build.library().vda_attention_block(
        h.data_ptr(), out.data_ptr(), *_ptrs(name, h, args),
        None if ws is None else ws.data_ptr(), ws_bytes, bd, t, c, heads,
        int(h.dtype == torch.bfloat16), _build.stream_ptr(h))
    _build.check(err, "vda_attention_block")
    launches_attn += 1
    return out


def temporal_block_fused(block, h, pe_table, heads: int):
    """K3: a whole TemporalTransformerBlock (two attention sub-blocks and the
    GEGLU feed-forward) on (BD, T, C) sequences."""
    global launches_block
    if h.device.type == "cpu":
        return temporal_block_reference(block, h, pe_table, heads)
    name = "temporal_block_fused"
    _check(name, h, pe_table)
    if len(block.attention_blocks) != 2:
        raise ValueError(f"{name}: the kernel runs exactly two attention "
                         f"sub-blocks, got {len(block.attention_blocks)}")
    bd, t, c = h.shape
    ws, ws_bytes = _workspace(name, h, heads, full=True)
    f32 = torch.float32
    args = [pe_table[:t].detach().float().contiguous()]
    for attn, norm in zip(block.attention_blocks, block.norms):
        args += _attn_tensors(attn, norm, h.dtype)
    proj, ffo = block.ff.net[0].proj, block.ff.net[2]
    args += [cast_once(block.ff_norm.weight, f32),
             cast_once(block.ff_norm.bias, f32),
             cast_once(proj.weight, h.dtype), cast_once(proj.bias, f32),
             cast_once(ffo.weight, h.dtype), cast_once(ffo.bias, f32)]
    out = torch.empty_like(h)
    err = _build.library().vda_temporal_block(
        h.data_ptr(), out.data_ptr(), *_ptrs(name, h, args),
        None if ws is None else ws.data_ptr(), ws_bytes, bd, t, c, heads,
        int(h.dtype == torch.bfloat16), _build.stream_ptr(h))
    _build.check(err, "vda_temporal_block")
    launches_block += 1
    return out
