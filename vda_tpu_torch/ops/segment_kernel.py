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
VMEM.  The C entry point picks the device code by head width and dtype
(``loop_of``, the C query ``vda_segment_loop``):

* bf16 at head width 64 (vitl's, every main-path shape): the Hopper code
  of ``csrc/segment_sm90.cuh``, K1's TMA/wgmma loop over a work table
  (``work_table``, made once per length tuple and copied to the card
  once): an item is a pass of up to three 64-row query tiles, one a
  consumer warpgroup, over one key span, either three tiles of one long
  segment or one tile each of up to three consecutive short segments whose
  keys lie side by side (each consumer masks the keys outside its own
  segment); a persistent grid walks (item, head) works with the next
  work's loads in flight; key tiles of 64 rows where the longest span is
  at most 1024 keys, else 128.  Its design steps:
  ``probes/bench_short_attn_sm90``.
* fp32 and other head widths: the mma.sync loop (``csrc/segment_attention
  .cu`` + ``flash_attention.cuh``) over a table of 64-row query tiles
  ({segment start, length, first row}, ``tile_table``), one block per
  (tile, head).

Nothing is gathered, padded or scattered: a K/V tile that straddles a
segment's end is masked, query rows past it are never stored.  Launches are
counted (``launches``) and counted by device code (``launches_by_loop``:
"sm90" the Hopper code, "sm80" the other).

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
launches_by_loop = {"sm90": 0, "sm80": 0}  # the same launches by loop
TILE = 64     # query rows a tile (csrc/flash_attention.cuh BQ, a wgmma's M)
CONSUMERS = 3  # query tiles an item of the work table holds
MIX_SPAN = 640  # longest key span of an item holding several segments


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
def work_table(lengths: tuple, mix_span: int = MIX_SPAN) -> np.ndarray:
    """The Hopper code's items (csrc/segment_sm90.cuh): (n_items, 16) int32
    rows {k0, nk, own, n_own} (the key span: rows k0 .. k0 + nk - 1; own 1
    where every segment of the item fits one 64-row tile, which the kernel
    then loads at each segment's start instead of tiling the span: n_own
    tiles, one a consumer), then
    for each of the three consumers {q0, qn, ks, ke}: its query tile (rows
    q0 .. q0 + qn - 1, qn 0 for none) and its segment's keys (rows ks ..
    ke - 1).
    The 64-row query tiles of all segments, in row order, go three to an
    item; a tile of another segment than the item's last joins it only
    while the item's key span stays within ``mix_span`` rows (so short
    segments share items, and the tiles of a 257-row segment fill the
    consumers its last item would leave idle, but a long segment's keys are
    never streamed past consumers that do not need them)."""
    tiles = []  # (q0, qn, ks, ke) of every query tile, in row order
    start = 0
    for n in lengths:
        tiles.extend((start + q0, min(TILE, n - q0), start, start + n)
                     for q0 in range(0, n, TILE))
        start += n
    rows = []
    i = 0
    while i < len(tiles):
        group = [tiles[i]]
        i += 1
        while len(group) < CONSUMERS and i < len(tiles):
            nxt = tiles[i]
            if nxt[2] != group[-1][2] and nxt[3] - group[0][2] > mix_span:
                break
            group.append(nxt)
            i += 1
        k0 = group[0][2]
        # segments of one tile each: a key tile at each one's start
        own = all(ke - ks <= TILE for _, _, ks, ke in group)
        rows.append((k0, group[-1][3] - k0, int(own), len(group) * own,
                     *sum(group, ()),
                     *(0, 0, 0, 0) * (CONSUMERS - len(group))))
    return np.asarray(rows, np.int32).reshape(-1, 4 + 4 * CONSUMERS)


@functools.lru_cache(maxsize=64)
def _device_table(lengths: tuple, device) -> torch.Tensor:
    return torch.from_numpy(tile_table(lengths)).to(device)


@functools.lru_cache(maxsize=64)
def _device_items(lengths: tuple, device,
                  mix_span: int = MIX_SPAN) -> tuple[torch.Tensor, int]:
    """The work table on ``device`` and its longest key span."""
    table = work_table(lengths, mix_span)
    return torch.from_numpy(table).to(device), int(table[:, 1].max())


@functools.lru_cache(maxsize=None)
def loop_of(dtype, d: int) -> str:
    """The device code the C entry point runs at head width ``d``, as it
    reports it (``vda_segment_loop``): "sm90" (the Hopper code) or
    "sm80"."""
    code = _build.library().vda_segment_loop(d, int(dtype == torch.bfloat16))
    return "sm90" if code == 90 else "sm80"


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
    d = hd // heads
    tiles = _device_table(lengths, q.device)
    items, span = _device_items(lengths, q.device)
    out = torch.empty(total, hd, device=q.device, dtype=q.dtype)
    err = _build.library().vda_segment_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        tiles.data_ptr(), tiles.shape[0], items.data_ptr(), items.shape[0],
        span, total, heads, d, rs, float(scale),
        int(q.dtype == torch.bfloat16), _build.stream_ptr(q))
    _build.check(err, "vda_segment_attention")
    launches += 1
    launches_by_loop[loop_of(q.dtype, d)] += 1
    return out
