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
block-diagonal (16, 16 * rows) score tile for the MXU; here a block owns one
position and a group of heads (``csrc/stream_kv_attention.cu``), copies the
group's columns of its valid context rows and the new row into shared memory
with 16-byte cp.async loads (every byte read once; rows that are not valid
are not read at all), and gives each head a warp: one lane a row for the
scores, one lane a column for the weighted sum.  The encodings, the same for
every position, are read through the cache.

Rounding follows the TPU kernel: the encoding add rounds to the working
dtype, scores accumulate in fp32, ``exp`` of the bf16-rounded shifted score
is rounded to bf16 (bf16 only), the sum is fp32 and the normalisation is
deferred to the output.
"""

from __future__ import annotations

import torch

from vda_tpu_torch.ops import _build

launches = 0  # kernel launches made by ``stream_kv_attention``


def use_kernel(t_new: int, c: int, heads: int) -> bool:
    """The model's dispatch: the JAX gate (``vda_tpu/models/temporal.py``
    ``_temporal_attention_kv_ctx``, less its TPU row-padding term): one new
    frame, heads that tile a 512-wide column group, head width a multiple
    of 8.  The kernel takes every such shape at the 31-row context."""
    dh = c // heads
    gw = min(c, 512)
    return t_new == 1 and c % gw == 0 and gw % dh == 0 and dh % 8 == 0


def stream_kv_attention_reference(q, k_new, v_new, k_buf, v_buf, pe_k, pe_v,
                                  valid, heads: int, scale: float):
    """Plain twin: q, k_new, v_new (BHW, C); k_buf, v_buf (BHW, rows, C);
    pe_k, pe_v (rows, C); valid (rows,) bool.  Returns (BHW, C) in q's
    dtype, with the kernel's rounding."""
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
    cached row.  valid: (rows,) bool, the rows that take part.  Returns
    (BHW, C)."""
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
    return out
