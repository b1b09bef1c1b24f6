"""K10: bf16 NHWC bilinear upsample with align_corners=True, CUDA C++.

Replaces ``vda_tpu/ops/pallas_resize.py`` ``resize_bilinear_fused`` (its
``pl.pallas_call`` runs ``_resize_kernel``), the decoder tail's two largest
resizes, which the JAX package sends to it with ``VDA_RESIZE_KERNEL=1`` and
the port with ``resize_kernel=True``: vitl (16, 148, 148, 256) -> (296,
296) and (16, 296, 296, 128) -> (518, 518), twice a window each (two tail
chunks of 16 frames).

The function: output row i is the lerp r0·(1 − t) + r1·t of input rows i0
and i1 in fp32, with t the fp32 ``w1`` of ``_lerp_tables`` (not rounded),
rounded to bf16; output column j sums that row at its two taps with the
bf16-rounded weights of ``_linear_matrix`` (one tap of weight 1 at the
clipped edge) in fp32 and rounds once.  The TPU ran the column pass as an
MXU matmul with that (W_out, W_in) matrix; its two nonzeros a row are read
directly here, and the sum of two exact bf16·bf16 products has one rounding
in any order, so kernel, twin and the TPU kernel agree bit for bit.

What bounds it on the H100: bytes (vitl 0.27 and 0.44 ms at 3.35 TB/s),
most of them the output's.  The kernel (``csrc/resize_sm90.cuh``, entry
``csrc/resize_bilinear.cu``) follows the TPU kernel's two passes: a block
lerps an output row's two input rows (a channel slice of them) once into a
bf16 row in shared memory, then makes each output pixel of the slice from
two taps of that row and writes it with 16-byte streaming stores, so the
(B, H_out, W_in, C) intermediate of the separable form never reaches
device memory.  Blocks are persistent, at most 3 an SM, and walk (batch,
output row, slice) in order, so the blocks in flight share their input
rows through L2 and one block's loads overlap another's stores.  The
TPU kernel's row blocks (``_pick_block``) remain in the gate alone.  The
input is read through its strides; the tables live on the device, made
once per shape.  Its design steps: ``probes/bench_resize_sm90.py``.

Differentiable as JAX's custom VJP (``_rbf_fwd`` / ``_rbf_bwd``): the
forward is the kernel, the backward runs autograd through the plain
separable form (``ops/resize._apply_separable`` with the
``_linear_matrix`` pair), no backward kernel, as in JAX.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from vda_tpu_torch.ops import _build
from vda_tpu_torch.ops.resize import (_apply_separable, _lerp_tables,
                                      _linear_matrix)

launches = 0  # kernel launches made by ``resize_bilinear_fused``


def _pick_block(out_h: int):
    """Copy of ``pallas_resize._pick_block``: output rows a block makes."""
    for br in (16, 14, 8, 7):
        if out_h % br == 0:
            return br
    return None


def supported(x, out_hw, align_corners: bool, scale) -> bool:
    """The JAX gate (``pallas_resize.supported`` without its environment
    switch): bf16 NHWC, align_corners, no explicit scale, a batch of at
    least 8, channels % 128, upsampling on both axes, and a row block that
    divides H_out.  The kernel takes every shape it admits."""
    if scale is not None or not align_corners:
        return False
    if x.dim() != 4 or x.dtype != torch.bfloat16 or x.shape[0] < 8:
        return False
    h, w, c = x.shape[1], x.shape[2], x.shape[3]
    oh, ow = out_hw
    if c % 128 != 0 or oh < h or ow < w:
        return False
    return _pick_block(oh) is not None


@functools.lru_cache(maxsize=64)
def _tables(h: int, w: int, oh: int, ow: int):
    """Host tables: (int32 [i0 | i1 | j0 | j1], fp32 [w1 | m0 | m1]) with
    i0/i1/w1 the row taps and lerp weight of ``_lerp_tables``, j0/j1 the
    column taps and m0/m1 their bf16-rounded matrix weights (m1 = 0 where
    the two taps merge)."""
    i0, i1, w1 = _lerp_tables(h, oh, True, None)
    j0, j1, _ = _lerp_tables(w, ow, True, None)
    m = torch.from_numpy(_linear_matrix(w, ow, True)).to(torch.bfloat16)
    m = m.float().numpy()
    cols = np.arange(ow)
    m0 = m[cols, j0]
    m1 = np.where(j1 != j0, m[cols, j1], 0.0)
    itab = np.concatenate([i0, i1, j0, j1]).astype(np.int32)
    ftab = np.concatenate([w1, m0, m1]).astype(np.float32)
    return itab, ftab


@functools.lru_cache(maxsize=64)
def _device_tables(h: int, w: int, oh: int, ow: int, device):
    itab, ftab = _tables(h, w, oh, ow)
    return (torch.from_numpy(itab).to(device),
            torch.from_numpy(ftab).to(device))


def resize_bilinear_fused_reference(x, out_hw):
    """Plain twin over (B, H, W, C): the same taps and roundings by tensor
    ops (each op rounds to fp32, as the kernel's __fmul_rn/__fadd_rn do)."""
    h, w = x.shape[1], x.shape[2]
    oh, ow = out_hw
    itab, ftab = (torch.from_numpy(a).to(x.device)
                  for a in _tables(h, w, oh, ow))
    i0, i1, j0, j1 = itab.long().split([oh, oh, ow, ow])
    w1, m0, m1 = ftab.split([oh, ow, ow])
    t = w1[:, None, None]
    rows = (x[:, i0].float() * (1.0 - t) + x[:, i1].float() * t)
    rows = rows.to(torch.bfloat16).float()
    return (m0[:, None] * rows[:, :, j0]
            + m1[:, None] * rows[:, :, j1]).to(x.dtype)


class _ResizeBilinearFused(torch.autograd.Function):
    """Forward: the kernel.  Backward: autograd through the separable
    matmul form on the saved input (JAX ``_rbf_bwd``)."""

    @staticmethod
    def forward(ctx, x, out_hw):
        ctx.save_for_backward(x)
        ctx.out_hw = out_hw
        return _launch(x, out_hw)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        h, w = x.shape[1], x.shape[2]
        with torch.enable_grad():
            xi = x.detach().requires_grad_(True)
            y = _apply_separable(xi, ("linear", h, ctx.out_hw[0], True, None),
                                 ("linear", w, ctx.out_hw[1], True, None))
            (gx,) = torch.autograd.grad(y, xi, g)
        return gx, None


def prepare(x, out_hw):
    """(x as the kernel reads it, the row/column tables on its device): x
    keeps its strides where they suit the kernel (unit channel stride, the
    others multiples of 8, 16-byte aligned), else is made contiguous."""
    b, h, w, c = x.shape
    if x.stride(3) != 1 or any(s % 8 for s in x.stride()[:3]) \
            or x.data_ptr() % 16:
        x = x.contiguous()
    return (x, *_device_tables(h, w, *out_hw, x.device))


def c_args(x, itab, ftab, out) -> tuple:
    """The arguments of ``vda_resize_bilinear`` before its stream (those of
    ``vda_resize_variant`` before its keep flag), for ``prepare``'s
    operands and out (B, OH, OW, C)."""
    b, _, w, c = x.shape
    return (x.data_ptr(), out.data_ptr(), itab.data_ptr(), ftab.data_ptr(),
            b, w, out.shape[1], out.shape[2], c, *x.stride()[:3])


def _launch(x, out_hw):
    global launches
    x, itab, ftab = prepare(x, out_hw)
    out = torch.empty(x.shape[0], *out_hw, x.shape[3], device=x.device,
                      dtype=x.dtype)
    err = _build.library().vda_resize_bilinear(
        *c_args(x, itab, ftab, out), _build.stream_ptr(x))
    _build.check(err, "vda_resize_bilinear")
    launches += 1
    return out


def resize_bilinear_fused(x, out_hw):
    """K10: (B, H, W, C) bf16 -> (B, H_out, W_out, C) bf16, align_corners.
    The caller checks ``supported`` first (on the card the wrapper raises
    for a shape it refuses).  Differentiable in x (plain backward)."""
    if x.device.type == "cpu":
        return resize_bilinear_fused_reference(x, out_hw)
    name = "resize_bilinear_fused"
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if not supported(x, out_hw, True, None):
        raise ValueError(f"{name}: unsupported input {tuple(x.shape)} "
                         f"{x.dtype} -> {tuple(out_hw)}")
    return _ResizeBilinearFused.apply(x, tuple(out_hw))
