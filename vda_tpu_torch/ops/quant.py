"""K11: the W8A8 int8 linear, CUDA C++.

Replaces ``vda_tpu/ops/quant.py`` ``_int8_matmul`` (its ``pl.pallas_call``
runs ``_kernel``), reached through ``int8_linear``: activations get dynamic
symmetric per-row int8 scales, weights per-column ones (``quantize_weight``),
the int8 x int8 product sums in int32, and the epilogue
``((acc * sx) * sw) + b`` casts to the activation's dtype.  As in JAX, the
activation quantisation runs outside the kernel as plain tensor ops, and
nothing in the model calls this path (``ops/layers.linear`` stays
quantisation-free): it is the op, for deployments whose encoder matmuls
dominate.

What bounds it on the H100: at the encoder's qkv shape (43840, 1024) x
(1024, 3072) the operations, 2.8e11 at 1979 TOP/s int8 (0.14 ms), against
~0.32 GB of bytes.  The kernel (``csrc/int8_matmul.cu`` on the Hopper
mainloop of ``csrc/gemm_sm90.cuh``: TMA loads into a ring of stages, wgmma
m64n256k32 with int32 sums, a producer and two consumer warpgroups, a
persistent grid of two-block clusters that share each weight tile by
multicast, the epilogue through shared memory and TMA stores) takes the
weight as (N, K): 8-bit wgmma operands must be K-major, so the wrapper
keeps one transposed copy of each weight tensor, made at its first use and
kept until the tensor changes, as ``cast_once`` keeps casts.  Ragged M and N come in as zeros and are not
stored; K is zero-padded to 16 bytes (exact; TMA's row strides are 16-byte
multiples).  The epilogue rounds each step as the twin does, so the two
agree bit for bit.  ``gemm_launches_by_loop`` counts K11's and K13's
launches by the loop the library reports running (``vda_gemm_loop``):
"sm90" the Hopper loop, "sm80" the ``mma.sync`` loop it replaced, which no
wrapper reaches any more (``probes/bench_gemm_sm90.py`` times it).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.weak import WeakIdKeyDictionary

from vda_tpu_torch.ops import _build

launches = 0  # K11 launches made by ``int8_linear``
gemm_launches_by_loop = {"sm90": 0, "sm80": 0}  # K11 and K13, by loop

_transposed = WeakIdKeyDictionary()  # weight -> (its state, its (N, K) copy)


def quantize_weight(w):
    """(K, N) float -> (w_q int8 (K, N), w_s fp32 (N,)): symmetric
    per-output-channel scales (JAX ``quantize_weight``)."""
    w32 = w.float()
    s = (w32.abs().amax(dim=0) / 127.0).clamp_min(1e-12)
    q = torch.clamp(torch.round(w32 / s[None, :]), -127, 127)
    return q.to(torch.int8), s


def quantize_rows(x2):
    """(M, K) float -> (xq int8 (M, K), sx fp32 (M, 1)): the dynamic
    symmetric per-row quantisation of ``int8_linear`` (JAX runs it in XLA,
    outside the kernel).  ``torch.round`` rounds half to even, as
    ``jnp.round``."""
    x32 = x2.float()
    sx = (x32.abs().amax(dim=1, keepdim=True) / 127.0).clamp_min(1e-12)
    xq = torch.clamp(torch.round(x32 / sx), -127, 127).to(torch.int8)
    return xq, sx


def int8_matmul_reference(xq, wq, sx, sw, b, out_dtype):
    """Plain twin of the kernel: xq (M, K) and wq (K, N) int8, sx (M, 1),
    sw and b (N,) fp32.  The product in float64 is exact (every partial sum
    is an integer below 2^53 for K <= 2^53 / 127^2), so it equals the int32
    sum; the epilogue rounds in the kernel's order."""
    acc = xq.double() @ wq.double()
    return (((acc.float() * sx) * sw) + b).to(out_dtype)


def _bias(p, n, device):
    b = p.get("b")
    return (torch.zeros(n, device=device) if b is None
            else b.float().reshape(n))


def _check_width(n):
    # JAX's _int8_matmul picks a 128-multiple divisor of n as its block
    # width and raises when there is none
    if n % 128:
        raise ValueError(f"int8_linear needs a 128-aligned output width, "
                         f"got n={n}")


def padded_k(k: int, itemsize: int = 1) -> int:
    """K rounded up to the kernel's 16-byte chunk (for int8, 16 values; for
    bf16, 8)."""
    per = 16 // itemsize
    return -(-k // per) * per


def gemm_loop() -> str:
    """The device loop the GEMM entry points run, as the library reports
    it (``vda_gemm_loop``): "sm90" or "sm80"."""
    return "sm90" if _build.library().vda_gemm_loop() == 90 else "sm80"


def transposed(w):
    """The (N, K) copy of a (K, N) weight, K zero-padded to ``padded_k``
    (16 bytes): made once and reused until ``w`` changes, in place or by
    reallocation."""
    state = (w.device, w.data_ptr(), w._version)
    hit = _transposed.get(w)
    if hit is None or hit[0] != state:
        k = w.shape[0]
        wt = F.pad(w.t(), (0, padded_k(k, w.element_size()) - k)).contiguous()
        hit = _transposed[w] = (state, wt)
    return hit[1]


def _pad_k(t):
    k = t.shape[-1]
    return t if k == padded_k(k) else F.pad(t, (0, padded_k(k) - k))


def _aligned(*ts):
    return all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in ts)


def int8_matmul(xq, wq, sx, sw, b, out_dtype):
    """K11 (JAX ``_int8_matmul``): ``((xq @ wq) * sx * sw) + b`` in
    ``out_dtype`` (bf16 or fp32), xq (M, K) and wq (K, N) int8 with int32
    sums, sx (M, 1), sw and b (N,) fp32.  N must be a multiple of 128, as in
    JAX; M is any row count."""
    global launches
    if xq.device.type == "cpu":
        _check_width(wq.shape[1])
        return int8_matmul_reference(xq, wq, sx, sw, b, out_dtype)
    name = "int8_matmul"
    if xq.device.type != "cuda" or any(t.device != xq.device
                                       for t in (wq, sx, sw, b)):
        raise ValueError(f"{name}: operands must share one CUDA device")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name}: unsupported output dtype {out_dtype}")
    if (xq.dtype != torch.int8 or wq.dtype != torch.int8 or xq.dim() != 2
            or wq.dim() != 2 or wq.shape[0] != xq.shape[1]):
        raise ValueError(f"{name}: xq (M, K) and wq (K, N) int8 expected, "
                         f"got {tuple(xq.shape)} {xq.dtype}, "
                         f"{tuple(wq.shape)} {wq.dtype}")
    m, k = xq.shape
    n = wq.shape[1]
    _check_width(n)
    if m == 0:
        raise ValueError(f"{name}: unsupported row count {m}")
    if sx.numel() != m or sw.numel() != n or b.numel() != n:
        raise ValueError(f"{name}: sx ({m}, 1), sw and b ({n},) expected")
    xq = _pad_k(xq).contiguous()
    wt = transposed(wq)
    sx, sw, b = (t.float().contiguous() for t in (sx, sw, b))
    out = torch.empty(m, n, device=xq.device, dtype=out_dtype)
    if not _aligned(xq, wt, sx, sw, b, out):
        raise ValueError(f"{name}: operands must be 16-byte aligned")
    err = _build.library().vda_int8_linear(
        xq.data_ptr(), wt.data_ptr(), sx.data_ptr(), sw.data_ptr(),
        b.data_ptr(), out.data_ptr(), m, n, padded_k(k),
        int(out_dtype == torch.bfloat16), _build.stream_ptr(xq))
    _build.check(err, "vda_int8_linear")
    launches += 1
    gemm_launches_by_loop[gemm_loop()] += 1
    return out


def int8_linear_reference(p, x):
    """Plain twin of ``int8_linear`` (the same quantisation, the twin's
    product and epilogue)."""
    shape = x.shape
    n = p["w_q"].shape[1]
    _check_width(n)
    xq, sx = quantize_rows(x.reshape(-1, shape[-1]))
    y = int8_matmul_reference(xq, p["w_q"], sx, p["w_s"].float().reshape(n),
                              _bias(p, n, x.device), x.dtype)
    return y.reshape(*shape[:-1], n)


def int8_linear(p, x):
    """Drop-in ``linear`` for int8-quantised params (JAX ``int8_linear``).

    p: {"w_q" (K, N) int8, "w_s" (N,) fp32, optional "b" (N,)}; x: (..., K)
    bf16 or fp32.  Dynamic symmetric per-row activation quantisation (plain
    tensor ops), then K11: int32 sums and the dequantising epilogue.
    Returns x's dtype.  N must be a multiple of 128, as in JAX."""
    shape = x.shape
    n = p["w_q"].shape[1]
    xq, sx = quantize_rows(x.reshape(-1, shape[-1]))
    y = int8_matmul(xq, p["w_q"], sx, p["w_s"].reshape(n),
                    _bias(p, n, x.device), x.dtype)
    return y.reshape(*shape[:-1], n)
