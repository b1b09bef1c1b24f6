"""K5: attention within many short sequences, CUDA C++.

Replaces ``vda_tpu/ops/pallas_attention.py`` ``tiny_seq_attention`` (its
``pl.pallas_call`` runs ``_tiny_seq_kernel``): independent softmax attention
for every (sequence, head) of (BD, T, C) q/k/v with T <= 64 frames and head
width ``dh = C / heads`` a multiple of 8.  The model reaches it wherever a
motion module runs per attention sub-block and neither K3 nor K4 takes the
block: the first streaming step (T = 1, every module), the offline
modules of odd widths (vits mm0 at C=192, mm2/mm3 at C=64; vitg mm0/mm1 at
C=1536, 8 heads of 192) and every RoPE module; under tensor parallelism a
rank runs it at its local heads (vitg's mm0/mm1: 4 heads of 192).

What bounds it on the H100: bytes.  At the vits mm3 shape (5476, 32, 64) in
bf16 it reads q, k, v and writes o, 4 * 5476 * 32 * 64 * 2 B = 90 MB, while
its 4 * BD * T^2 * C operations are 1.4 GFLOP.  The TPU kernel masked a
block-diagonal (512 x 512) score tile to fill the MXU.  The C entry point
picks the device code by (T, C, heads, dtype) alone (``loop_of``, the C
query ``vda_tiny_seq_loop``):

* bf16 at the main paths' shapes (``csrc/tiny_seq_sm90.cuh``; head widths
  8-128 and 192): for T >= 2 a persistent grid whose blocks take
  (sequence, head group) items (at head width 192 a warp computes a
  64-column slab of a head's output over the whole head's scores), each
  item's q, k and v brought by TMA (boxes of 64 columns by T rows, read in
  place through the caller's strides, so the fused projection is never
  split into copies) into a ring of two shared-memory stages, the next
  item's bytes in flight under this one's products; both products on the
  tensor cores (mma.sync), the softmax in registers, the output through a
  shared-memory tile in whole rows.  For T = 1 a warp a position, 16-byte
  loads, the one-key softmax computed per head (an infinite or NaN score
  gives NaN, as in JAX).  Its design steps: ``probes/bench_short_attn_sm90``.
* fp32 and the shapes the Hopper code refuses (at T >= 2 head widths off
  its list 8, 16, 24, 32, 48, 64, 96, 128 and 192, or head groups that do
  not fill 64 columns; at T = 1 C over 2048): the kernel of
  ``csrc/tiny_seq_attention.cu``, a block a sequence and a head group, the
  columns staged in shared memory as fp32, a warp a head and a lane a query
  row.

Launches are counted (``launches``) and counted by device code
(``launches_by_loop``: "sm90" the Hopper code, "sm80" the other).

Rounding follows the TPU kernel: scores accumulate in fp32 and are scaled,
``exp`` of the max-shifted score is taken on bf16-rounded input and rounded
to bf16 (bf16 only), the row sum adds those values in fp32, and the
normalisation is deferred to the output.
"""

from __future__ import annotations

import functools

import torch

from vda_tpu_torch.ops import _build

launches = 0  # kernel launches made by ``tiny_seq_attention``
launches_by_loop = {"sm90": 0, "sm80": 0}  # the same launches by loop

MAX_T = 64  # frames a sequence may hold (the JAX gate)


def use_kernel(t_q: int, t_full: int, dh: int) -> bool:
    """The model's dispatch: the JAX gate (``vda_tpu/models/temporal.py``
    ``_temporal_attention``): queries cover the whole sequence, at most 64
    frames, head width a multiple of 8.  The kernel takes every such shape."""
    return t_q == t_full and t_full <= MAX_T and dh % 8 == 0


@functools.lru_cache(maxsize=None)
def loop_of(dtype, t: int, c: int, heads: int) -> str:
    """The device code the C entry point runs at this shape, as it reports
    it (``vda_tiny_seq_loop``): "sm90" (the Hopper code) or "sm80"."""
    code = _build.library().vda_tiny_seq_loop(
        t, c, heads, int(dtype == torch.bfloat16))
    return "sm90" if code == 90 else "sm80"


def tiny_seq_attention_reference(q, k, v, heads: int, scale: float,
                                 out_dtype=None):
    """Plain twin: q, k, v (BD, T, C) -> (BD, T, C) in ``out_dtype``
    (default q's dtype; fp32 keeps the output before its last rounding),
    with the kernel's rounding (fp32 scores, bf16 exp in bf16, fp32 sum,
    deferred normalisation)."""
    bd, t, c = q.shape
    dh = c // heads
    qh, kh, vh = (x.reshape(bd, t, heads, dh).float() for x in (q, k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", qh, kh) * scale
    s = s - s.amax(-1, keepdim=True)
    if v.dtype == torch.bfloat16:
        e = torch.exp(s.to(torch.bfloat16)).float()
    else:
        e = torch.exp(s)
    z = e.sum(-1).transpose(1, 2)[..., None]  # (BD, T, heads, 1)
    o = torch.einsum("bhqk,bkhd->bqhd", e, vh) / z
    return o.reshape(bd, t, c).to(out_dtype or q.dtype)


def _check(q, k, v, heads):
    name = "tiny_seq_attention"
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name}: unsupported dtype {q.dtype}")
    if q.dim() != 3 or any(x.shape != q.shape or x.dtype != q.dtype
                           or x.device != q.device for x in (k, v)):
        raise ValueError(f"{name}: q, k, v must be (BD, T, C) of one dtype "
                         f"and device")
    bd, t, c = q.shape
    if not 0 < t <= MAX_T or bd == 0 or c % heads or (c // heads) % 8:
        raise ValueError(f"{name}: unsupported shape {tuple(q.shape)} with "
                         f"{heads} heads")
    # one row stride for all three, unit column stride, 16-byte aligned rows
    if any(x.stride() != q.stride() for x in (k, v)) or q.stride(2) != 1:
        raise ValueError(f"{name}: q, k, v must share strides with unit "
                         f"column stride")
    align = 16 // q.element_size()
    if (q.stride(0) % align or q.stride(1) % align
            or any(x.data_ptr() % 16 for x in (q, k, v))):
        raise ValueError(f"{name}: rows must be 16-byte aligned")
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        raise NotImplementedError(f"{name} has no backward yet")


def tiny_seq_attention(q, k, v, heads: int, scale: float):
    """Softmax attention within each length-T sequence of (BD, T, C) q, k,
    v, per head.  q, k and v may be column slices of one fused (BD, T, 3C)
    projection (they share its row stride).  Returns (BD, T, C)."""
    global launches
    if q.device.type == "cpu":
        return tiny_seq_attention_reference(q, k, v, heads, scale)
    _check(q, k, v, heads)
    bd, t, c = q.shape
    out = torch.empty(bd, t, c, device=q.device, dtype=q.dtype)
    err = _build.library().vda_tiny_seq_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bd, t, c,
        heads, q.stride(0), q.stride(1), float(scale),
        int(q.dtype == torch.bfloat16), _build.stream_ptr(q))
    _build.check(err, "vda_tiny_seq_attention")
    launches += 1
    launches_by_loop[loop_of(q.dtype, t, c, heads)] += 1
    return out
