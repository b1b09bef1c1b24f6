"""K6: one new frame's attention over a cached context, CUDA C++.

Replaces ``vda_tpu/ops/pallas_stream.py`` ``stream_kv_attention`` (its
``pl.pallas_call`` runs ``_stream_kv_kernel``), the cached temporal attention
of a streaming step with ``StreamingDepth(ctx_kernel=True)``: for each
spatial position one query attends over the cached K/V rows, each with its
projected position encoding added in the working dtype and masked by
``valid``, plus the new frame's own K/V row (its encoding already added).

What bounds it on the H100: bytes.  Each position reads its context once, 2
x 31 rows x C, for one length-dh dot product and one weighted sum per row
and head: about one operation a byte, far below the ~295 a byte at which the
tensor cores would matter.  So it is CUDA C++ with plain fp32 FMAs, not a
tensor-core kernel (Triton would serve as well; CUDA keeps the one build
route of the other kernels).  The TPU kernel tiled 16 positions and masked a
block-diagonal (16, 16 * rows) score tile for the MXU.  The C entry point
picks the device code by (C, heads, dtype) alone (``loop_of``, the C query
``vda_stream_kv_loop``):

* bf16 at head widths a multiple of 8 up to 128 (vitl's 128 and 32, every
  main-path shape): the Hopper loop, ``csrc/stream_kv_sm90.cuh``.  Blocks
  are persistent and each owns a range of heads, whose encodings (the same
  for every position) it stages in shared memory once; a warp owns one
  (position, head) at a time and loads a 32-row chunk of its K into
  registers, 16 bytes a lane, before the first product, and the chunk of
  V beside it (head widths up to 64) or after the scores (wider heads,
  where both would spill); scores, softmax and the weighted sum run on
  shuffles.  Its design steps: ``probes/bench_stream_sm90.py``.
* fp32 and wider heads: the kernel of ``csrc/stream_kv_attention.cu``, a
  block a position and a group of heads with the rows staged in shared
  memory by 16-byte cp.async loads.

Rows that are not valid are never read by either.  Launches are counted
(``launches``) and counted by device code (``launches_by_loop``: "sm90"
the Hopper loop, "sm80" the other).

Rounding follows the TPU kernel: the encoding add rounds to the working
dtype, scores accumulate in fp32, ``exp`` of the bf16-rounded shifted score
is rounded to bf16 (bf16 only), the sum is fp32 and the normalisation is
deferred to the output.
"""

from __future__ import annotations

import functools

import torch

from vda_tpu_torch.ops import _build

launches = 0  # kernel launches made by ``stream_kv_attention``
launches_by_loop = {"sm90": 0, "sm80": 0}  # the same launches by loop


def use_kernel(t_new: int, c: int, heads: int) -> bool:
    """The model's dispatch: the JAX gate (``vda_tpu/models/temporal.py``
    ``_temporal_attention_kv_ctx``, less its TPU row-padding term): one new
    frame, heads that tile a 512-wide column group, head width a multiple
    of 8.  The kernel takes every such shape at the 31-row context."""
    dh = c // heads
    gw = min(c, 512)
    return t_new == 1 and c % gw == 0 and gw % dh == 0 and dh % 8 == 0


@functools.lru_cache(maxsize=None)
def loop_of(dtype, c: int, heads: int) -> str:
    """The device code the C entry point runs at this shape, as it reports
    it (``vda_stream_kv_loop``): "sm90" (the Hopper loop) or "sm80"."""
    code = _build.library().vda_stream_kv_loop(
        c, heads, int(dtype == torch.bfloat16))
    return "sm90" if code == 90 else "sm80"


@functools.lru_cache(maxsize=None)
def all_valid(rows: int, device) -> torch.Tensor:
    """(rows,) uint8 ones on ``device``, made once: the flags of a context
    whose every row takes part, as the ``ctx_kernel`` path's does.  The same
    tensor for the same key; callers do not modify it."""
    return torch.ones(rows, dtype=torch.uint8, device=device)


def stream_kv_attention_reference(q, k_new, v_new, k_buf, v_buf, pe_k, pe_v,
                                  valid, heads: int, scale: float):
    """Plain twin: q, k_new, v_new (BHW, C); k_buf, v_buf (BHW, rows, C);
    pe_k, pe_v (rows, C); valid (rows,) bool or uint8.  Returns (BHW, C) in
    q's dtype, with the kernel's rounding."""
    bhw, rows, c = k_buf.shape
    dh = c // heads
    dt = q.dtype
    keep = valid.to(torch.bool)[None, :, None, None]
    k = (k_buf + pe_k.to(dt)).float().reshape(bhw, rows, heads, dh)
    v = (v_buf + pe_v.to(dt)).float().reshape(bhw, rows, heads, dh)
    v = v.masked_fill(~keep, 0.0)  # rows that are not valid are never read
    qh = q.float().reshape(bhw, heads, dh)
    s = torch.einsum("bhd,brhd->bhr", qh, k) * scale
    s = s.masked_fill(~keep[..., 0].permute(0, 2, 1), float("-inf"))
    sn = torch.einsum("bhd,bhd->bh", qh,
                      k_new.float().reshape(bhw, heads, dh)) * scale
    m = torch.maximum(s.amax(-1), sn)
    e, en = s - m[..., None], sn - m
    if dt == torch.bfloat16:
        e, en = (torch.exp(x.to(torch.bfloat16)).float() for x in (e, en))
    else:
        e, en = torch.exp(e), torch.exp(en)
    z = e.sum(-1) + en
    o = torch.einsum("bhr,brhd->bhd", e, v)
    o = o + en[..., None] * v_new.float().reshape(bhw, heads, dh)
    return (o / z[..., None]).reshape(bhw, c).to(dt)


def _check(q, k_new, v_new, k_buf, v_buf, pe_k, pe_v, valid, heads):
    name = "stream_kv_attention"
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name}: unsupported dtype {q.dtype}")
    if k_buf.dim() != 3 or q.dim() != 2:
        raise ValueError(f"{name}: q (BHW, C) and k_buf (BHW, rows, C) "
                         f"expected")
    bhw, rows, c = k_buf.shape
    shapes = ((q, (bhw, c)), (k_new, (bhw, c)), (v_new, (bhw, c)),
              (k_buf, (bhw, rows, c)), (v_buf, (bhw, rows, c)),
              (pe_k, (rows, c)), (pe_v, (rows, c)))
    for x, shape in shapes:
        if (tuple(x.shape) != shape or x.dtype != q.dtype
                or x.device != q.device):
            raise ValueError(f"{name}: expected {shape} {q.dtype} on "
                             f"{q.device}, got {tuple(x.shape)} {x.dtype}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name}: operands must be contiguous and "
                             f"16-byte aligned")
    if tuple(valid.shape) != (rows,) or valid.device != q.device:
        raise ValueError(f"{name}: valid must be ({rows},) on {q.device}")
    if bhw == 0 or c % heads or (c // heads) % 8 or c // heads > 512:
        raise ValueError(f"{name}: unsupported shape {tuple(k_buf.shape)} "
                         f"with {heads} heads")
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in (q, k_new, v_new, k_buf, v_buf)):
        raise NotImplementedError(f"{name} has no backward yet")


def stream_kv_attention(q, k_new, v_new, k_buf, v_buf, pe_k, pe_v, valid,
                        heads: int, scale: float):
    """Attention of one new frame against cached rows and itself, per
    position and head (the JAX signature; BHW need not be a multiple of 16).

    q, k_new, v_new: (BHW, C), the new frame's projections with its
    encoding added.  k_buf, v_buf: (BHW, rows, C) cached projections
    without encoding.  pe_k, pe_v: (rows, C) projected encoding of each
    cached row.  valid: (rows,) bool or uint8, the rows that take part (a
    contiguous uint8 tensor goes to the kernel as it is).  Returns (BHW,
    C)."""
    global launches
    if q.device.type == "cpu":
        return stream_kv_attention_reference(q, k_new, v_new, k_buf, v_buf,
                                             pe_k, pe_v, valid, heads, scale)
    _check(q, k_new, v_new, k_buf, v_buf, pe_k, pe_v, valid, heads)
    bhw, rows, c = k_buf.shape
    flags = valid.to(torch.uint8).contiguous()
    out = torch.empty_like(q)
    err = _build.library().vda_stream_kv_attention(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), k_buf.data_ptr(),
        v_buf.data_ptr(), pe_k.data_ptr(), pe_v.data_ptr(), flags.data_ptr(),
        out.data_ptr(), bhw, rows, c, heads, float(scale),
        int(q.dtype == torch.bfloat16), _build.stream_ptr(q))
    if err == _build.INVALID_VALUE:  # more rows than shared memory holds
        raise ValueError(f"stream_kv_attention: unsupported shape "
                         f"{tuple(k_buf.shape)} with {heads} heads")
    _build.check(err, "vda_stream_kv_attention")
    launches += 1
    launches_by_loop[loop_of(q.dtype, c, heads)] += 1
    return out
