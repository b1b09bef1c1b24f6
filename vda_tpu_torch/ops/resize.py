"""Separable matmul resizing with exact torch / cv2 semantics, PyTorch.

Counterpart of ``vda_tpu/ops/resize.py``.  The per-axis (out, in)
interpolation matrices are built on the host in numpy (``_linear_matrix`` and
``_cubic_matrix`` are copies of the JAX package's, held equal by a test) and
applied as two einsums, H then W, exactly as ``_apply_separable`` does:

  * bilinear with align_corners=True (the decoder's ``F.interpolate``)
  * cv2-exact bicubic, a=-0.75, half-pixel (preprocessing)
  * bicubic with an explicit scale factor (pos-embed interpolation)

fp32 input contracts in fp32; bf16 input contracts with bf16 matrices and
fp32 accumulation, rounding between the two passes, as on the JAX side.
The matrices live on the device in a cache keyed by (kind, sizes,
align_corners, scale, device, dtype) (``device_matrix``): the first call at
a size uploads them, and every later one issues no host-to-device copy,
which would make the host wait for the device.
The two-tap tables ``_lerp_tables`` (a copy too) feed K10
(``resize_kernel.py``), which ``resize_bilinear(kernel=True)`` reaches.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _src_coords(in_size: int, out_size: int, align_corners: bool,
                scale: float | None) -> np.ndarray:
    d = np.arange(out_size, dtype=np.float64)
    if align_corners:
        if out_size == 1:
            return np.zeros(1)
        return d * (in_size - 1) / (out_size - 1)
    s = scale if scale is not None else out_size / in_size
    return (d + 0.5) / s - 0.5


@functools.lru_cache(maxsize=256)
def _linear_matrix(in_size: int, out_size: int, align_corners: bool,
                   scale: float | None = None) -> np.ndarray:
    """(out, in) float32 bilinear interpolation matrix for one axis."""
    src = _src_coords(in_size, out_size, align_corners, scale)
    src = np.clip(src, 0.0, in_size - 1)
    i0 = np.floor(src).astype(np.int64)
    i0 = np.clip(i0, 0, in_size - 1)
    i1 = np.clip(i0 + 1, 0, in_size - 1)
    w1 = src - i0
    w0 = 1.0 - w1
    m = np.zeros((out_size, in_size), dtype=np.float64)
    rows = np.arange(out_size)
    np.add.at(m, (rows, i0), w0)
    np.add.at(m, (rows, i1), w1)
    return m.astype(np.float32)


def _cubic_kernel(x: np.ndarray, a: float = -0.75) -> np.ndarray:
    """Cubic convolution kernel (Keys); a=-0.75 matches torch & cv2."""
    ax = np.abs(x)
    ax2 = ax * ax
    ax3 = ax2 * ax
    w = np.where(
        ax <= 1.0,
        (a + 2.0) * ax3 - (a + 3.0) * ax2 + 1.0,
        np.where(ax < 2.0, a * ax3 - 5.0 * a * ax2 + 8.0 * a * ax - 4.0 * a, 0.0),
    )
    return w


@functools.lru_cache(maxsize=256)
def _cubic_matrix(in_size: int, out_size: int, align_corners: bool,
                  scale: float | None = None) -> np.ndarray:
    """(out, in) float32 bicubic interpolation matrix for one axis."""
    src = _src_coords(in_size, out_size, align_corners, scale)
    i0 = np.floor(src).astype(np.int64)
    frac = src - i0
    m = np.zeros((out_size, in_size), dtype=np.float64)
    rows = np.arange(out_size)
    for t in range(-1, 3):
        idx = np.clip(i0 + t, 0, in_size - 1)
        w = _cubic_kernel(t - frac)
        np.add.at(m, (rows, idx), w)
    return m.astype(np.float32)


_MATRICES = {"linear": _linear_matrix, "cubic": _cubic_matrix}


@functools.lru_cache(maxsize=256)
def device_matrix(kind: str, in_size: int, out_size: int,
                  align_corners: bool, scale: float | None, device,
                  dtype) -> torch.Tensor:
    """The (out, in) matrix of ``kind`` ("linear" or "cubic") in ``dtype``
    on ``device``, uploaded once; the same tensor for the same key.  Callers
    do not modify it."""
    m = _MATRICES[kind](in_size, out_size, align_corners, scale)
    return torch.from_numpy(m).to(device, dtype)


def _apply_separable(x, h_key: tuple, w_key: tuple):
    """Apply per-axis (out, in) matrices to (..., H, W, C) input; each key
    is (kind, in, out, align_corners, scale) of ``device_matrix``."""
    dtype = x.dtype if x.dtype == torch.bfloat16 else torch.float32
    a_h = device_matrix(*h_key, x.device, dtype)
    a_w = device_matrix(*w_key, x.device, dtype)
    y = torch.einsum("oh,...hwc->...owc", a_h, x.to(dtype))
    y = torch.einsum("pw,...owc->...opc", a_w, y)
    return y.to(x.dtype)


@functools.lru_cache(maxsize=256)
def _lerp_tables(in_size: int, out_size: int, align_corners: bool,
                 scale: float | None = None):
    """(i0, i1, w1) gather/lerp tables for one axis (same math as
    _linear_matrix, two-tap form)."""
    src = _src_coords(in_size, out_size, align_corners, scale)
    src = np.clip(src, 0.0, in_size - 1)
    i0 = np.clip(np.floor(src).astype(np.int32), 0, in_size - 1)
    i1 = np.clip(i0 + 1, 0, in_size - 1)
    w1 = (src - i0).astype(np.float32)
    return i0, i1, w1


def resize_bilinear(x, out_hw, align_corners: bool = True,
                    kernel: bool = False):
    """Bilinear resize of (..., H, W, C) input (torch F.interpolate
    semantics with align_corners=True).  ``kernel=True`` sends the resizes
    that ``resize_kernel.supported`` admits to K10, as JAX's
    ``VDA_RESIZE_KERNEL=1`` does."""
    from vda_tpu_torch.ops import resize_kernel

    h, w = x.shape[-3], x.shape[-2]
    oh, ow = out_hw
    if (oh, ow) == (h, w) and align_corners:
        return x
    if kernel and resize_kernel.supported(x, out_hw, align_corners, None):
        return resize_kernel.resize_bilinear_fused(x, out_hw)
    return _apply_separable(x, ("linear", h, oh, align_corners, None),
                            ("linear", w, ow, align_corners, None))


def resize_bicubic(x, out_hw, align_corners: bool = False, scale=None):
    """Bicubic (a=-0.75) resize of (..., H, W, C) input: cv2.INTER_CUBIC with
    ``scale=None``; torch interpolate with an explicit ``scale=(sh, sw)``."""
    h, w = x.shape[-3], x.shape[-2]
    oh, ow = out_hw
    if (oh, ow) == (h, w) and scale is None:
        return x  # the interpolation matrix is the identity
    sh, sw = (scale if scale is not None else (None, None))
    return _apply_separable(x, ("cubic", h, oh, align_corners, sh),
                            ("cubic", w, ow, align_corners, sw))
