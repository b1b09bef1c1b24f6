"""K3 and K4: fused temporal-transformer blocks, CUDA C++.

K3 replaces ``vda_tpu/ops/pallas_temporal.py`` ``temporal_block_fused`` (its
``pl.pallas_call`` runs ``_block_kernel``): a whole TemporalTransformerBlock
on (BD, T, C) sequences, vitl mm2/mm3 at (1369, 32, 256) and (5476, 32, 256).
K4 replaces ``attention_block_fused`` (``_attn_only_kernel``): one attention
sub-block, vitl mm0/mm1 at (1369, 32, 1024) and (361, 32, 1024), whose GEGLU
feed-forward stays outside.

What bounds them on the H100: the products (vitl mm0's K4 0.37 ms, mm3's K3
0.47 ms at the bf16 peak) against a few hundred MB of rows in and out.  The
C entry points pick the device code by (C, heads, T, dtype) alone
(``loop_of``, the C query ``vda_temporal_loop``):

* bf16 at head widths that are multiples of 16 up to 128 and T <= 64 (vitl
  mm0-mm3, vitb and vits: every main-path shape): Hopper code.  K3 at
  vitl's width (C 256, 8 heads, T 32: mm2 and mm3) runs one fused kernel,
  ``csrc/temporal_fused_sm90.cuh``: 64-row tiles whose residual, LN output
  and head outputs stay in shared memory, the weights streamed by TMA
  through a ring that two wgmma consumer warpgroups read, cluster pairs
  sharing each weight box by multicast.  Every other such shape runs the
  Hopper chain of ``csrc/temporal_sm90.cuh``; one entry point call launches
  its stages: a
  LayerNorm (+ APE) row pass, the qkv product on the Hopper GEMM mainloop of
  K11/K13 (``csrc/gemm_sm90.cuh``: TMA, wgmma, cluster pairs sharing each
  weight tile), a per-sequence attention on the tensor cores (``mma.sync``),
  the out-projection on the same mainloop with a bias + residual epilogue;
  K3 twice, then the LN pass, the GEGLU product (x1 and gate of a chunk in
  one tile, combined in the epilogue) and the feed-forward product with the
  residual epilogue.  The intermediates live in a device-memory workspace
  (``vda_temporal_workspace`` gives its size).  Its design steps:
  ``probes/bench_temporal_sm90.py``.
* fp32 and every other shape the JAX gates admit: the kernels of
  ``csrc/temporal_block.cu``.  One thread block owns whole T-frame
  sequences and keeps every intermediate in shared memory (a device-memory
  workspace where even one sequence does not fit: fp32 at C=1024, T above
  32 at C=1024); each block streams the weights from L2 through shared
  memory 64 columns at a time with cp.async into WMMA bf16 products (scalar
  FMAs in fp32).

The two never stand in for each other: a CUDA tensor runs the code its loop
names or the wrapper raises.  Launches are counted (``launches_block``,
``launches_attn``: one a call) and counted by device code
(``launches_by_loop``: "sm90" the Hopper chain, "sm80" the other, one dict
for K3 and one for K4).  The weights are cast to the working dtype once per
parameter and reused (``layers.cast_once``); q, k and v's weights are
concatenated once per module into the (3C, C) operand of the qkv product.

Rounding follows the TPU kernel (``pallas_temporal.py`` module docstring):
LayerNorm stats fp32 (eps 1e-5), the APE added after the norm in the working
dtype, matmuls accumulated in fp32 and rounded to the working dtype, the
softmax exp rounded to bf16 with an fp32 sum and the normalisation deferred
to the output, tanh GELU in bf16 and erf GELU in fp32.  The stage twins
below (``ln_ape_reference`` .. ``geglu_reference``) compute each stage of
the Hopper chain with exactly those rounding points.
"""

from __future__ import annotations

import ctypes
import functools
import weakref

import torch

from vda_tpu_torch.ops import _build
from vda_tpu_torch.ops.attention import attention_plain
from vda_tpu_torch.ops.layers import cast_once, gelu, layer_norm, linear
from vda_tpu_torch.ops.norm_kernel import layer_norm_reference

launches_block = 0  # K3 launches made by ``temporal_block_fused``
launches_attn = 0   # K4 launches made by ``attention_block_fused``
# the same launches by device code: "sm90" the Hopper code (the fused K3 or
# the chain), "sm80" the kernels of temporal_block.cu
launches_by_loop = {"K3": {"sm90": 0, "sm80": 0},
                    "K4": {"sm90": 0, "sm80": 0}}

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


@functools.lru_cache(maxsize=None)
def loop_of(dtype, c: int, heads: int, t: int, full: bool) -> str:
    """The device code the C entry point runs for this shape (``full``: K3,
    else K4), as it reports it (``vda_temporal_loop``): "sm90" (the Hopper
    code: the fused K3 or the chain) or "sm80"."""
    code = _build.library().vda_temporal_loop(
        c, heads, t, int(dtype == torch.bfloat16), int(full))
    return "sm90" if code == 90 else "sm80"


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
# plain twins of the Hopper chain's stages, with the TPU kernel's rounding
# points (pallas_temporal.py ``_ln``, ``_attention``, ``_block_kernel``);
# rows are the last-but-one axis, (BD, T, C) or (M, C)
# ---------------------------------------------------------------------------

def ln_ape_reference(x, w, b, pe=None):
    """LN(x) (eps 1e-5, fp32 statistics) rounded to x's dtype, plus pe (T,
    C) rounded to x's dtype (row t of each (T, C) sequence), the sum rounded
    to x's dtype."""
    y = layer_norm_reference(x, w, b, 1e-5)
    return y if pe is None else y + pe[:x.shape[-2]].to(x.dtype)


def qkv_reference(a, w):
    """a @ w^T with fp32 sums, rounded to a's dtype."""
    return torch.matmul(a.float(), w.float().t()).to(a.dtype)


def seq_attention_reference(qkv, heads: int):
    """Attention within each (T, 3C) sequence of qkv = [q | k | v]: fp32
    scores times dh^-0.5, e = exp(s - max) with the difference and e in
    qkv's dtype, the row sum of e in fp32, (e @ v) / sum in fp32, rounded
    to qkv's dtype.  Returns (BD, T, C)."""
    bd, t, c3 = qkv.shape
    c = c3 // 3
    dh = c // heads
    q, k, v = (x.reshape(bd, t, heads, dh).float()
               for x in qkv.split(c, dim=-1))
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * dh ** -0.5
    e = (s - s.amax(-1, keepdim=True)).to(qkv.dtype).float().exp()
    e = e.to(qkv.dtype).float()
    o = torch.einsum("bhqk,bkhd->bqhd", e, v) / e.sum(-1).transpose(
        1, 2)[..., None]
    return o.to(qkv.dtype).reshape(bd, t, c)


def residual_reference(a, w, b, h):
    """h + (a @ w^T + b) with fp32 sums, rounded to h's dtype, the sum in
    h's dtype."""
    return h + (torch.matmul(a.float(), w.float().t())
                + b.float()).to(h.dtype)


def geglu_reference(a, w, b):
    """x1 * gelu(gate) with [x1 | gate] = a @ w^T + b (fp32 sums, rounded
    to a's dtype) and gelu in a's dtype (tanh in bf16)."""
    x12 = (torch.matmul(a.float(), w.float().t()) + b.float()).to(a.dtype)
    x1, gate = x12.chunk(2, dim=-1)
    return x1 * gelu(gate)


def attention_sub_stages(attn, norm, h, pe_table, heads: int):
    """One attention sub-block as the Hopper chain computes it, from the
    stage twins: h + out-proj(attention(LN(h) + pe)), the weights in h's
    dtype."""
    hn = ln_ape_reference(h, norm.weight, norm.bias, pe_table)
    qkv = qkv_reference(hn, _wqkv(attn, h.dtype))
    o = seq_attention_reference(qkv, heads)
    out = attn.to_out[0]
    return residual_reference(o, out.weight.to(h.dtype), out.bias, h)


def temporal_block_stages(block, h, pe_table, heads: int):
    """K3's block as the Hopper chain computes it, from the stage twins."""
    for attn, norm in zip(block.attention_blocks, block.norms):
        h = attention_sub_stages(attn, norm, h, pe_table, heads)
    hn = ln_ape_reference(h, block.ff_norm.weight, block.ff_norm.bias)
    proj, ffo = block.ff.net[0].proj, block.ff.net[2]
    g = geglu_reference(hn, proj.weight.to(h.dtype), proj.bias)
    return residual_reference(g, ffo.weight.to(h.dtype), ffo.bias, h)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

_wqkv_cache = weakref.WeakKeyDictionary()


def wqkv_once(attn, dtype):
    """to_q, to_k and to_v's weights as one contiguous (3C, C) ``dtype``
    tensor, made once per module and reused until one of them changes;
    made anew where autograd records and a weight requires grad (as
    ``cast_once``)."""
    ws = (attn.to_q.weight, attn.to_k.weight, attn.to_v.weight)
    if torch.is_grad_enabled() and any(w.requires_grad for w in ws):
        return _wqkv(attn, dtype).contiguous()
    state = (dtype, ws[0].device,
             *((w.data_ptr(), w._version) for w in ws))
    hit = _wqkv_cache.get(attn)
    if hit is None or hit[0] != state:
        hit = _wqkv_cache[attn] = (state, _wqkv(attn, dtype).contiguous())
    return hit[1]


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
    return [cast_once(norm.weight, f32), cast_once(norm.bias, f32),
            wqkv_once(attn, dtype), cast_once(attn.to_out[0].weight, dtype),
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
    launches_by_loop["K4"][loop_of(h.dtype, c, heads, t, False)] += 1
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
    launches_by_loop["K3"][loop_of(h.dtype, c, heads, t, True)] += 1
    return out
