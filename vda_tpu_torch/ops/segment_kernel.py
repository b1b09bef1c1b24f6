"""K8: block-diagonal self-attention over packed variable-length segments,
CUDA C++.

Replaces ``vda_tpu/ops/pallas_attention.py`` ``segment_attention`` (its
``pl.pallas_call`` runs ``_segment_kernel``), which
``packed_self_attention(segment_lengths=...)`` reaches from
``models/dinov2.block_apply_nested``: the reference's NestedTensorBlock for
multi-crop training batches, where DINOv2 packs per image 2 global crops of
224 (257 tokens) and 8 local crops of 98 (50 tokens) into one row sequence.

The function: q, k and v are (total, H·D) rows of ``len(segment_lengths)``
back-to-back sequences; each head attends only within its row's segment,
scores and softmax statistics in fp32, the output in q's dtype.

What bounds it on the H100: bytes at the multi-crop shapes (4·total·H·D
elements read and written, 0.072 ms at vitl's 29,248 rows in bf16), where
the operations of segments of 257 and 50 rows are few; a long segment is
bound by operations, like K1.  The TPU kernel bin-packed segments into
128-aligned bins, gathered them and held a (cap, cap) score tile per head in
VMEM.  Here (``csrc/segment_attention.cu``) the static lengths become a
table of 64-row query tiles ({segment start, length, first row}), made once
per shape on the host and copied to the card once; one block per (tile,
head) runs K1's flash loop (``csrc/flash_attention.cuh``) with the segment's
start as its row base and its length as its row and key count.  Nothing is
gathered, padded or scattered: the K/V tile that straddles a segment's end is
zero-filled and masked, query rows past it are never stored.

Forward only, as in JAX (``pallas_call`` has no VJP rule there): the wrapper
raises if autograd would need a gradient.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from vda_tpu_torch.ops import _build
from vda_tpu_torch.ops.attention import attention_plain

launches = 0  # kernel launches made by ``segment_attention``
TILE = 64     # query rows a block takes (csrc/flash_attention.cuh BQ)


def kernel_supported(dh: int) -> bool:
    """Head widths the kernel takes: a multiple of 8, at most 128."""
    return dh % 8 == 0 and 0 < dh <= 128


def _lengths(segment_lengths, total: int):
    lengths = tuple(int(n) for n in segment_lengths)
    if not lengths or min(lengths) <= 0:
        raise ValueError("segment_lengths must be positive")
    if sum(lengths) != total:
        raise ValueError(f"segment_lengths sum {sum(lengths)} != rows {total}")
    return lengths


@functools.lru_cache(maxsize=64)
def tile_table(lengths: tuple) -> np.ndarray:
    """(n_tiles, 4) int32 {segment start, segment length, first query row,
    0}: one row per 64-row query tile of each segment, in row order."""
    rows = []
    start = 0
    for n in lengths:
        rows.extend((start, n, q0, 0) for q0 in range(0, n, TILE))
        start += n
    return np.asarray(rows, np.int32).reshape(-1, 4)


@functools.lru_cache(maxsize=64)
def _device_table(lengths: tuple, device) -> torch.Tensor:
    return torch.from_numpy(tile_table(lengths)).to(device)


def segment_attention_reference(q, k, v, heads: int, scale: float,
                                segment_lengths):
    """Plain twin: per-segment attention (JAX's ``xla`` path of
    ``packed_self_attention``, ``vda_tpu/ops/attention.py``)."""
    total, hd = q.shape
    d = hd // heads
    outs = []
    off = 0
    for n in _lengths(segment_lengths, total):
        qs, ks, vs = (t[off:off + n].reshape(1, n, heads, d)
                      for t in (q, k, v))
        outs.append(attention_plain(qs, ks, vs, scale).reshape(n, hd))
        off += n
    return torch.cat(outs, dim=0)


def segment_attention(q, k, v, heads: int, scale: float, segment_lengths):
    """K8 over (total, H·D) q, k and v of one shape, dtype and row layout
    (unit column stride, one row stride that is a multiple of 8 elements:
    contiguous tensors or column slices of one fused projection), 16-byte
    aligned.  ``segment_lengths``: static positive ints summing to total.
    Returns (total, H·D) in q's dtype."""
    global launches
    if q.device.type == "cpu":
        return segment_attention_reference(q, k, v, heads, scale,
                                           segment_lengths)
    name = "segment_attention"
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    if q.dim() != 2 or q.shape[1] % heads \
            or not kernel_supported(q.shape[1] // heads):
        raise ValueError(f"{name}: unsupported shape {tuple(q.shape)} with "
                         f"{heads} heads")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name}: unsupported dtype {q.dtype}")
    total, hd = q.shape
    rs = q.stride(0)
    for t in (q, k, v):
        if (t.shape != q.shape or t.dtype != q.dtype or t.device != q.device
                or t.stride() != (rs, 1) or t.data_ptr() % 16 or rs % 8):
            raise ValueError(f"{name}: q, k and v must share one shape, "
                             "dtype and row layout, 16-byte aligned")
    lengths = _lengths(segment_lengths, total)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(f"{name} has no backward (as in JAX)")
    tiles = _device_table(lengths, q.device)
    out = torch.empty(total, hd, device=q.device, dtype=q.dtype)
    err = _build.library().vda_segment_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        tiles.data_ptr(), tiles.shape[0], heads, hd // heads, rs,
        float(scale), int(q.dtype == torch.bfloat16), _build.stream_ptr(q))
    _build.check(err, "vda_segment_attention")
    launches += 1
    return out
