"""K1: self-attention read in place from the fused qkv projection, CUDA C++.

Replaces ``vda_tpu/ops/pallas_attention.py`` ``flash_attention_qkv`` (its
``pl.pallas_call`` runs ``_attn_kernel_packed``), the encoder attention of
every DINOv2 block: vitl runs it at (B·T, N, 3·H·D) = (32, 1370, 3072), 16
heads of 64.

What bounds it on the H100: the (N, N) scores.  Materialised in fp32 they
are 32·16·1370² · 4 B = 3.8 GB a layer, written and re-read several times by
the plain form.  The TPU kernel kept a whole head's K and V resident in VMEM
(~350 KB at N=1370), which does not fit the 227 KB a block may hold here, so
the kernel (``csrc/attention_qkv.cu``) is a flash attention: one block per
(batch, head, 64-row query tile) walks 64-row K/V tiles, double-buffered in
shared memory by cp.async, with an online softmax (fp32 running max and sum,
fp32 accumulator, normalised once at the end).  In bf16 each warp keeps its
16 query rows' scores, probabilities and output accumulator in registers
and runs the products on the tensor cores (``mma.sync`` m16n8k16, fp32
accumulate, operands by ``ldmatrix``): scores never leave registers.  fp32
input takes a scalar-FMA path through shared memory.  q, k and v are read
at column offsets 0, H·D and 2·H·D of the fused tensor, so nothing is copied
or transposed first; N is taken unpadded and the ragged last K tile masked.
"""

from __future__ import annotations

import torch

from vda_tpu_torch.ops import _build
from vda_tpu_torch.ops.attention import attention_plain

launches = 0  # kernel launches made by ``flash_attention_qkv``


def kernel_supported(heads: int, dh: int) -> bool:
    """Head widths the kernel takes: a multiple of 8, at most 128."""
    return dh % 8 == 0 and 0 < dh <= 128


def use_kernel(n: int, dh: int) -> bool:
    """The model's dispatch: the JAX gate (``vda_tpu/models/dinov2.py``
    ``_use_pallas``: at least 512 tokens, head width a multiple of 8) and
    the kernel's own head-width limit."""
    return n >= 512 and dh % 8 == 0 and dh <= 128


def flash_attention_qkv_reference(qkv, heads: int, scale: float,
                                  valid_len: int | None = None):
    """Plain twin: fp32-statistics softmax(Q K^T · scale) V over the fused
    (B, N, 3·H·D) tensor.  Returns (B, N, H·D)."""
    b, n, hd3 = qkv.shape
    hd = hd3 // 3
    q, k, v = (t.reshape(b, n, heads, hd // heads)
               for t in qkv.split(hd, dim=-1))
    return attention_plain(q, k, v, scale, valid_len).reshape(b, n, hd)


def flash_attention_qkv(qkv, heads: int, scale: float,
                        valid_len: int | None = None):
    """Attention over the fused [q | k | v] tensor (B, N, 3·H·D).  Keys at or
    beyond ``valid_len`` are masked.  Returns (B, N, H·D) in qkv's dtype."""
    global launches
    b, n, hd3 = qkv.shape
    if valid_len is None:
        valid_len = n
    if qkv.device.type == "cpu":
        return flash_attention_qkv_reference(qkv, heads, scale, valid_len)
    if qkv.device.type != "cuda":
        raise ValueError(f"flash_attention_qkv: unsupported device {qkv.device}")
    if hd3 % (3 * heads) or not kernel_supported(heads, hd3 // (3 * heads)):
        raise ValueError(f"flash_attention_qkv: unsupported shape "
                         f"{tuple(qkv.shape)} with {heads} heads")
    if qkv.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"flash_attention_qkv: unsupported dtype {qkv.dtype}")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("flash_attention_qkv: qkv must be contiguous and "
                         "16-byte aligned")
    if not 0 < valid_len <= n:
        raise ValueError(f"flash_attention_qkv: valid_len {valid_len} "
                         f"outside (0, {n}]")
    if torch.is_grad_enabled() and qkv.requires_grad:
        raise NotImplementedError("flash_attention_qkv has no backward yet")
    out = torch.empty(b, n, hd3 // 3, device=qkv.device, dtype=qkv.dtype)
    err = _build.library().vda_attention_qkv(
        qkv.data_ptr(), out.data_ptr(), b, n, heads, hd3 // (3 * heads),
        valid_len, float(scale), int(qkv.dtype == torch.bfloat16),
        _build.stream_ptr(qkv))
    _build.check(err, "vda_attention_qkv")
    launches += 1
    return out
