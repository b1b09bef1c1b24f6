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

Differentiable as JAX's custom VJP (``_fln_fwd`` / ``_fln_bwd``): the
forward is the kernel, the backward recomputes autograd through the plain
twin on the saved (x, weight, bias); no backward kernel, as in JAX.
``launches`` counts forward launches.
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


def _forward(x, weight, bias, eps: float):
    c = x.shape[-1]
    y = _launch(x.contiguous().view(-1, c), weight.detach().float().contiguous(),
                bias.detach().float().contiguous(), eps)
    return y.view(x.shape)


class _FusedLayerNorm(torch.autograd.Function):
    """Forward: the kernel.  Backward: autograd through
    ``layer_norm_reference`` on the saved inputs (JAX ``_fln_bwd``)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        ctx.save_for_backward(x, weight, bias)
        ctx.eps = eps
        return _forward(x, weight, bias, eps)

    @staticmethod
    def backward(ctx, g):
        x, weight, bias = ctx.saved_tensors
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(need)
                   for t, need in zip((x, weight, bias),
                                      ctx.needs_input_grad[:3])]
            y = layer_norm_reference(*ins, ctx.eps)
            wanted = [t for t in ins if t.requires_grad]
            grads = iter(torch.autograd.grad(y, wanted, g))
        return (*(next(grads) if t.requires_grad else None for t in ins),
                None)


def fused_layer_norm(x, weight, bias, eps: float = 1e-6):
    """LayerNorm over the last axis of x (any rank >= 2, width C % 128 == 0,
    C <= 8192) with (C,) scale and shift.  Output dtype == x.dtype.
    Differentiable in x, weight and bias (plain recompute backward)."""
    if x.device.type == "cpu":
        return layer_norm_reference(x, weight, bias, eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_layer_norm: unsupported device {x.device}")
    if not ln_supported(x):
        raise ValueError(f"fused_layer_norm: unsupported shape {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise ValueError(f"fused_layer_norm: unsupported dtype {x.dtype}")
    c = x.shape[-1]
    if weight.shape != (c,) or bias.shape != (c,) \
            or weight.device != x.device or bias.device != x.device:
        raise ValueError("fused_layer_norm: scale/bias must be (C,) on x's device")
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or bias.requires_grad):
        return _FusedLayerNorm.apply(x, weight, bias, float(eps))
    # nothing to differentiate: the launch without the Function's host cost
    return _forward(x, weight, bias, float(eps))
