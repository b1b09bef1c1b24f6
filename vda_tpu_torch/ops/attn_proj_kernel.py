"""K7: attention + out-projection + LayerScale + residual, CUDA C++.

Replaces ``vda_tpu/ops/pallas_attention.py`` ``flash_attention_qkv_proj``
(its ``pl.pallas_call`` runs ``_attn_proj_kernel``), the fused first half of
an encoder block that the JAX package runs with ``VDA_ATTN_FUSE_PROJ=1`` and
the port with ``fuse_proj=True``:

    out = x + gamma * (attn(q, k, v) @ W^T + bias)

over the fused qkv projection (B, N, 3C); vitl runs it at (32, 1370, 3072)
with W (1024, 1024), 24 times a window, and at (1, 1370, 3072) 24 times a
stream step.

What bounds it on the H100: operations (vitl: 3.4e11, 0.34 ms at the bf16
peak).  The split path writes the (B, N, C) attention output and reads it
back for the projection, then makes two more elementwise passes for the
LayerScale and the residual; the kernel keeps the attention output of a
64-row query tile, all heads of it, in shared memory and projects it
there.  One block owns one batch row and one query tile across all heads,
because the projection contracts over every head.  The C entry point picks
the device code by (dtype, head width) alone (``loop_of``):

* bf16 at head width 64 (vits, vitb and vitl: every shape the model's gate
  admits in bf16): the Hopper kernel (``csrc/attention_heads_sm90.cuh``).
  A cluster pair of blocks owns each 64-row tile, each block half of the
  heads.  In a block, a producer warpgroup streams, by TMA, each
  consumer's Q and K/V tiles of 128 keys into rings guarded by mbarriers;
  three consumer warpgroups run three heads at a time on K1's Hopper
  softmax loop (``wgmma``, the row sums by the tensor core) and write each
  head's output, rounded to bf16, into the block's half of a head-output
  tile in shared memory (64 KB at C = 1024) in the swizzled layout
  ``wgmma`` reads.  The two blocks then swap their halves (a bulk copy into
  the other block's freed rings), each consumer projects chunks of 64
  output columns of its block's half from the whole tile against W tiles
  streamed by TMA, and the epilogue adds bias, LayerScale and residual in
  fp32 with one rounding (16-byte accesses after a transpose of the sums
  within quads of threads).  Its design steps:
  ``probes/bench_attn_proj_sm90.py``.
* other head widths and fp32 (``csrc/attention_proj.cu``): K1's
  ``mma.sync`` loop (``csrc/flash_attention.cuh``) head by head into a
  shared-memory tile, W in 64 x 64 chunks (cp.async, double-buffered) into
  ``mma.sync``; in fp32 the 64 x C output tile does not fit shared memory
  at C=1024 (256 KB), so it goes to a device-memory workspace that the
  same block reads back.

W is the port's ``Linear`` weight as stored, (out, in); the JAX function
takes it (in, out).  Launches are counted (``launches``) and counted by
device code (``launches_by_loop``: "sm90" the Hopper kernel, "sm80" the
other).

The function differs from the split block on purpose: the split block
rounds the projection to the working dtype and multiplies by gamma in that
dtype; here projection, bias, gamma and residual are fp32 until the one
rounding (``pallas_attention.py`` ``_attn_proj_kernel``).
"""

from __future__ import annotations

import functools

import torch

from vda_tpu_torch.ops import _build
from vda_tpu_torch.ops.attention_kernel import (
    flash_attention_qkv_reference,
    kernel_supported,
    use_kernel,
)

launches = 0  # kernel launches made by ``flash_attention_qkv_proj``
launches_by_loop = {"sm90": 0, "sm80": 0}  # the same launches by device code


@functools.lru_cache(maxsize=None)
def loop_of(dtype, dh: int) -> str:
    """The device code the C entry point runs for ``dtype`` at head width
    ``dh``, as it reports it (``vda_attention_proj_loop``): "sm90" (the
    Hopper kernel) or "sm80"."""
    code = _build.library().vda_attention_proj_loop(
        dh, int(dtype == torch.bfloat16))
    return "sm90" if code == 90 else "sm80"


def attn_proj_fits(n: int, heads: int, dh: int, itemsize: int = 2) -> bool:
    """Copy of ``pallas_attention.attn_proj_fits``: the JAX static guard of
    the fused kernel (its K/V and W resident set in 8 MB of VMEM; vitl's
    C=1024 fits, vitg's C=1536 does not)."""
    hd = heads * dh
    np_len = n if n % 16 == 0 else -(-n // 128) * 128
    resident = 2 * np_len * hd * itemsize + hd * hd * itemsize
    return hd <= 1024 and dh % 8 == 0 and resident <= 8_000_000


def use_fused_proj(n: int, heads: int, dh: int) -> bool:
    """The model's gate: JAX's ``_fuse_proj_usable`` (``dinov2.py``) as the
    JAX encoder evaluates it, on N rounded up to 128 (``encode`` lane-pads
    the tokens when its attention kernel engages, so the gate sees the padded
    length), with K1's gate (at least 512 tokens, head width a multiple of 8)
    and its head-width limit (at most 128).  A shape the JAX gate admits with
    a head wider than 128 takes the split path."""
    return (use_kernel(n, dh)
            and attn_proj_fits(-(-n // 128) * 128, heads, dh))


def flash_attention_qkv_proj_reference(qkv, w, gamma_bias, x_res, heads: int,
                                       scale: float,
                                       valid_len: int | None = None):
    """Plain twin: the attention output rounded to qkv's dtype, projected by
    w (out, in) with fp32 products and sums, then x + gamma * (proj + bias)
    in fp32 and one rounding to x's dtype."""
    o = flash_attention_qkv_reference(qkv, heads, scale, valid_len)
    proj = torch.matmul(o.float(), w.float().t())
    gb = gamma_bias.float()
    return (x_res.float() + gb[0] * (proj + gb[1])).to(x_res.dtype)


def flash_attention_qkv_proj(qkv, w, gamma_bias, x_res, heads: int,
                             scale: float, valid_len: int | None = None):
    """K7 over qkv (B, N, 3C), w (C, C) (out, in) in qkv's dtype,
    gamma_bias (2, C) fp32 [LayerScale gamma; projection bias] and the
    residual x_res (B, N, C).  Keys at or beyond ``valid_len`` are masked.
    Returns (B, N, C) in x's dtype."""
    global launches
    if qkv.device.type == "cpu":
        return flash_attention_qkv_proj_reference(qkv, w, gamma_bias, x_res,
                                                  heads, scale, valid_len)
    name = "flash_attention_qkv_proj"
    if qkv.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {qkv.device}")
    b, n, c3 = qkv.shape
    c = c3 // 3
    if valid_len is None:
        valid_len = n
    if (c3 % (3 * heads) or not kernel_supported(heads, c // heads)
            or c > 1024):
        raise ValueError(f"{name}: unsupported shape {tuple(qkv.shape)} with "
                         f"{heads} heads")
    if qkv.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name}: unsupported dtype {qkv.dtype}")
    if (tuple(w.shape) != (c, c) or tuple(x_res.shape) != (b, n, c)
            or tuple(gamma_bias.shape) != (2, c)):
        raise ValueError(f"{name}: w {tuple(w.shape)}, gamma_bias "
                         f"{tuple(gamma_bias.shape)} or x_res "
                         f"{tuple(x_res.shape)} do not fit qkv "
                         f"{tuple(qkv.shape)}")
    if w.dtype != qkv.dtype or x_res.dtype != qkv.dtype \
            or gamma_bias.dtype != torch.float32:
        raise ValueError(f"{name}: w and x_res must be in qkv's dtype, "
                         "gamma_bias fp32")
    for t in (qkv, w, gamma_bias, x_res):
        if t.device != qkv.device or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError(f"{name}: every operand must be contiguous, "
                             "16-byte aligned and on qkv's device")
    if not 0 < valid_len <= n:
        raise ValueError(f"{name}: valid_len {valid_len} outside (0, {n}]")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (qkv, w, gamma_bias, x_res)):
        raise NotImplementedError(f"{name} has no backward yet")
    bf = qkv.dtype == torch.bfloat16
    ws = None if bf else torch.empty(b, n, c, device=qkv.device)
    out = torch.empty_like(x_res)
    err = _build.library().vda_attention_proj(
        qkv.data_ptr(), w.data_ptr(), gamma_bias.data_ptr(),
        x_res.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(),
        b, n, heads, c // heads, valid_len, float(scale), int(bf),
        _build.stream_ptr(qkv))
    _build.check(err, "vda_attention_proj")
    launches += 1
    launches_by_loop[loop_of(qkv.dtype, c // heads)] += 1
    return out
