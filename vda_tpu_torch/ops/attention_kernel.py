"""K1 and K9: multi-head self-attention over head-packed q, k and v, CUDA C++.

K1 replaces ``vda_tpu/ops/pallas_attention.py`` ``flash_attention_qkv`` (its
``pl.pallas_call`` runs ``_attn_kernel_packed``), the encoder attention of
every DINOv2 block: vitl runs it at (B·T, N, 3·H·D) = (32, 1370, 3072), 16
heads of 64.  K9 replaces ``flash_attention_packed``, the same function over
three separate (B, N, H·D) tensors, which ``ops/attention.py`` and the
generic attention library reach for N >= 512.

What bounds them on the H100: the tensor cores, once the (N, N) scores
stay on chip.  Materialised in fp32 they are 32·16·1370² · 4 B = 3.8 GB a
layer, written and re-read several times by the plain form; kept on chip,
the call moves 0.36 GB against 246 GFLOP (0.107 ms of bytes against 0.249
ms of operations at vitl).  The TPU kernel kept a whole head's K and V
resident in VMEM (~350 KB at N=1370), which does not fit the 227 KB a block
may hold here, so the kernel (``csrc/attention_qkv.cu``) is a flash
attention: one block per (batch, head, query tile) walks K/V tiles with an
online softmax (fp32 running max and sum, fp32 accumulator, normalised once
at the end).  The C entry point picks the device loop by (dtype, head
width) alone (``loop_of``):

* bf16 at head width 64, every encoder config: the Hopper loop
  (``csrc/flash_attention_sm90.cuh``).  A producer warpgroup streams K/V
  tiles of 128 keys by TMA into a 2-stage ring guarded by mbarriers; three
  consumer warpgroups of 64 query rows each (192 rows a block) run Q·Kᵀ and
  P·V by ``wgmma`` (P from registers, its row sums by the tensor core too)
  and the online softmax in registers, one consumer's exponentials running
  under another's products.
* other head widths (multiples of 8 up to 128) and fp32: the loop of
  ``csrc/flash_attention.cuh`` (one block of 4 warps per 64-row query tile,
  ``mma.sync`` m16n8k16 on ``ldmatrix`` operands double-buffered by
  cp.async in bf16; scalar FMAs through shared memory in fp32), which K8
  also runs (and K7 and K12 at those widths).

The one C entry point takes a q, a k and a v pointer and one row stride: K1
passes column offsets 0, H·D and 2·H·D of the fused tensor with a stride of
3·H·D, so nothing is copied or transposed first; K9 passes its three
tensors.  N is taken unpadded and keys at or beyond ``valid_len`` masked.
Launches are counted by kernel (``launches``, ``launches_packed``) and by
loop (``launches_by_loop``: "sm90" the Hopper loop, "sm80" the other).
"""

from __future__ import annotations

import functools

import torch

from vda_tpu_torch.ops import _build
from vda_tpu_torch.ops.attention import attention_plain

launches = 0         # K1 launches made by ``flash_attention_qkv``
launches_packed = 0  # K9 launches made by ``flash_attention_packed``
launches_by_loop = {"sm90": 0, "sm80": 0}  # K1 and K9 launches by loop


def kernel_supported(heads: int, dh: int) -> bool:
    """Head widths the kernel takes: a multiple of 8, at most 128."""
    return dh % 8 == 0 and 0 < dh <= 128


@functools.lru_cache(maxsize=None)
def loop_of(dtype, dh: int) -> str:
    """The device loop the C entry point runs for ``dtype`` at head width
    ``dh``, as it reports it (``vda_attention_loop``): "sm90" or "sm80"."""
    code = _build.library().vda_attention_loop(
        dh, int(dtype == torch.bfloat16))
    return "sm90" if code == 90 else "sm80"


def use_kernel(n: int, dh: int) -> bool:
    """The model's dispatch: the JAX gate (``vda_tpu/models/dinov2.py``
    ``_use_pallas``: at least 512 tokens, head width a multiple of 8) and
    the kernel's own head-width limit."""
    return n >= 512 and dh % 8 == 0 and dh <= 128


def flash_attention_qkv_reference(qkv, heads: int, scale: float,
                                  valid_len: int | None = None):
    """Plain twin of K1: fp32-statistics softmax(Q K^T · scale) V over the
    fused (B, N, 3·H·D) tensor.  Returns (B, N, H·D)."""
    hd = qkv.shape[-1] // 3
    return flash_attention_packed_reference(*qkv.split(hd, dim=-1), heads,
                                            scale, valid_len)


def flash_attention_packed_reference(q, k, v, heads: int, scale: float,
                                     valid_len: int | None = None):
    """Plain twin of K9 over (B, N, H·D) q, k and v.  Returns (B, N, H·D)."""
    b, n, hd = q.shape
    qh, kh, vh = (t.reshape(b, n, heads, hd // heads) for t in (q, k, v))
    return attention_plain(qh, kh, vh, scale, valid_len).reshape(b, n, hd)


def _launch(name, q, k, v, heads, scale, valid_len, row_stride):
    b, n, hd = q.shape
    if valid_len is None:
        valid_len = n
    if hd % heads or not kernel_supported(heads, hd // heads):
        raise ValueError(f"{name}: unsupported shape {tuple(q.shape)} with "
                         f"{heads} heads")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name}: unsupported dtype {q.dtype}")
    if not 0 < valid_len <= n:
        raise ValueError(f"{name}: valid_len {valid_len} outside (0, {n}]")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(f"{name} has no backward yet")
    out = torch.empty(b, n, hd, device=q.device, dtype=q.dtype)
    err = _build.library().vda_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, n,
        heads, hd // heads, row_stride, valid_len, float(scale),
        int(q.dtype == torch.bfloat16), _build.stream_ptr(q))
    _build.check(err, "vda_attention")
    launches_by_loop[loop_of(q.dtype, hd // heads)] += 1
    return out


def flash_attention_qkv(qkv, heads: int, scale: float,
                        valid_len: int | None = None):
    """K1: attention over the fused [q | k | v] tensor (B, N, 3·H·D).  Keys
    at or beyond ``valid_len`` are masked.  Returns (B, N, H·D) in qkv's
    dtype."""
    global launches
    if qkv.device.type == "cpu":
        return flash_attention_qkv_reference(qkv, heads, scale, valid_len)
    if qkv.device.type != "cuda":
        raise ValueError(f"flash_attention_qkv: unsupported device "
                         f"{qkv.device}")
    if qkv.shape[-1] % 3:
        raise ValueError(f"flash_attention_qkv: unsupported shape "
                         f"{tuple(qkv.shape)}")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("flash_attention_qkv: qkv must be contiguous and "
                         "16-byte aligned")
    q, k, v = qkv.split(qkv.shape[-1] // 3, dim=-1)
    out = _launch("flash_attention_qkv", q, k, v, heads, scale, valid_len,
                  qkv.shape[-1])
    launches += 1
    return out


def flash_attention_packed(q, k, v, heads: int, scale: float):
    """K9: self-attention over head-packed (B, N, H·D) q, k and v of one
    shape and one layout: unit column stride, rows ``row_stride`` apart and
    batches N rows apart (contiguous tensors, or column slices of one fused
    projection), 16-byte aligned.  Returns (B, N, H·D) in q's dtype."""
    global launches_packed
    if q.device.type == "cpu":
        return flash_attention_packed_reference(q, k, v, heads, scale)
    name = "flash_attention_packed"
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    b, n, hd = q.shape
    rs = q.stride(1)
    for t in (q, k, v):
        if (t.shape != q.shape or t.dtype != q.dtype or t.device != q.device
                or t.stride() != (n * rs, rs, 1) or t.data_ptr() % 16
                or rs % 8):
            raise ValueError(f"{name}: q, k and v must share one shape, "
                             "dtype and row layout, 16-byte aligned")
    out = _launch(name, q, k, v, heads, scale, None, rs)
    launches_packed += 1
    return out


def flash_attention(q, k, v, scale: float):
    """K9 over (B, N, H, D) tensors: the reshape wrapper of
    ``flash_attention_packed`` (``pallas_attention.flash_attention``)."""
    b, n, h, d = q.shape
    out = flash_attention_packed(*(t.reshape(b, n, h * d) for t in (q, k, v)),
                                 heads=h, scale=scale)
    return out.reshape(b, n, h, d)
