"""K2: one-pass LayerNorm, a Triton kernel.

Replaces ``vda_tpu/ops/pallas_norm.py`` ``fused_layer_norm`` (``_ln_2d``,
whose ``pl.pallas_call`` runs ``_ln_kernel``).

What bounds it on the H100: bytes.  A LayerNorm reads C values a row and
writes C back with ~8 operations each, far under the ~295 operations a byte
the card needs before arithmetic matters.  The plain form materialises the
fp32 upcast and the centred copy in device memory (several passes over a
(32*1370, 1024) tensor); this kernel reads each row once into registers,
takes fp32 mean and centred variance there, and writes the output once, in
the input dtype.  One program handles ``ROWS`` whole rows; the row width is
padded to the next power of two and masked.

Forward only: the backward comes with the training slice, so the wrapper
raises if autograd would need a gradient.
"""

from __future__ import annotations

import functools

import torch

launches = 0  # kernel launches made by ``fused_layer_norm``


def ln_supported(x) -> bool:
    """Widths the kernel takes (the JAX gate, ``pallas_norm.ln_supported``)."""
    return x.dim() >= 2 and x.shape[-1] % 128 == 0 and x.shape[-1] <= 8192


def layer_norm_reference(x, weight, bias, eps: float):
    """Plain twin: LayerNorm over the last axis with fp32 mean and centred
    variance, output in x's dtype."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    xc = x32 - mean
    var = (xc * xc).mean(-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(x.dtype)


def _ln_fwd(x_ptr, w_ptr, b_ptr, y_ptr, n_rows, n_cols, eps,
            BLOCK_C: tl.constexpr, ROWS: tl.constexpr):
    """Triton kernel body (jitted by ``_kernel``): ROWS rows per program."""
    rows = tl.program_id(0) * ROWS + tl.arange(0, ROWS)
    cols = tl.arange(0, BLOCK_C)
    cmask = cols < n_cols
    mask = (rows[:, None] < n_rows) & cmask[None, :]
    offs = rows[:, None].to(tl.int64) * n_cols + cols[None, :]
    x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
    mean = tl.sum(x, axis=1) / n_cols
    xc = tl.where(mask, x - mean[:, None], 0.0)
    var = tl.sum(xc * xc, axis=1) / n_cols
    rstd = tl.rsqrt(var + eps)
    w = tl.load(w_ptr + cols, mask=cmask, other=0.0).to(tl.float32)
    b = tl.load(b_ptr + cols, mask=cmask, other=0.0).to(tl.float32)
    y = xc * rstd[:, None] * w[None, :] + b[None, :]
    tl.store(y_ptr + offs, y.to(y_ptr.dtype.element_ty), mask=mask)


@functools.lru_cache(maxsize=None)
def _kernel():
    """Import Triton and jit the kernel at first launch (this module must
    import without Triton).  The body resolves ``tl`` from this module's
    globals, so it is bound here before jitting."""
    import triton
    import triton.language

    globals()["tl"] = triton.language
    return triton, triton.jit(_ln_fwd)


@torch.no_grad()
def _launch(x2d, weight, bias, eps: float):
    global launches
    triton, kernel = _kernel()
    r, c = x2d.shape
    y = torch.empty_like(x2d)
    block_c = triton.next_power_of_2(c)
    rows = max(1, 4096 // block_c)
    kernel[(triton.cdiv(r, rows),)](
        x2d, weight, bias, y, r, c, eps, BLOCK_C=block_c, ROWS=rows,
        num_warps=4 if block_c <= 1024 else 8)
    launches += 1
    return y


def fused_layer_norm(x, weight, bias, eps: float = 1e-6):
    """LayerNorm over the last axis of x (any rank >= 2, width C % 128 == 0,
    C <= 8192) with (C,) scale and shift.  Output dtype == x.dtype."""
    if x.device.type == "cpu":
        return layer_norm_reference(x, weight, bias, eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_layer_norm: unsupported device {x.device}")
    if not ln_supported(x):
        raise ValueError(f"fused_layer_norm: unsupported shape {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise ValueError(f"fused_layer_norm: unsupported dtype {x.dtype}")
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or bias.requires_grad):
        raise NotImplementedError("fused_layer_norm has no backward yet")
    c = x.shape[-1]
    w = weight.detach().float().contiguous()
    b = bias.detach().float().contiguous()
    if w.shape != (c,) or b.shape != (c,) or w.device != x.device:
        raise ValueError("fused_layer_norm: scale/bias must be (C,) on x's device")
    y = _launch(x.contiguous().view(-1, c), w, b, float(eps))
    return y.view(x.shape)
