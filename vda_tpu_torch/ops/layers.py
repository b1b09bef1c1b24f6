"""Functional NN primitives and parameter holders, PyTorch.

Counterpart of ``vda_tpu/ops/layers.py``.  Public functions keep the JAX
package's layouts: images and features are NHWC; convolutions run NCHW inside
(``permute`` of an NHWC tensor is a channels-last NCHW view, which cuDNN takes
as it is).  Parameters keep the reference's torch layouts: linear weights
(out, in), conv weights OIHW, conv-transpose weights (Cin, Cout, k, k).  They
are stored in fp32 and cast to the compute dtype where they are used, as the
JAX side does.

Numerics policy (as in JAX): LayerNorm and GroupNorm statistics are fp32;
GELU is exact erf in fp32 and the tanh form in bf16 (``vda_tpu/ops/layers.py``
``gelu``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.weak import WeakIdKeyDictionary

from vda_tpu_torch.ops import norm_kernel


# ---------------------------------------------------------------------------
# parameter holders (names follow the reference state-dict keys; values come
# from utils/convert.init_random or load_state_dict_numpy)
# ---------------------------------------------------------------------------

def _empty(*shape, device=None):
    return nn.Parameter(torch.empty(*shape, device=device))


class Linear(nn.Module):
    def __init__(self, d_in, d_out, bias=True, device=None):
        super().__init__()
        self.weight = _empty(d_out, d_in, device=device)
        self.bias = _empty(d_out, device=device) if bias else None


class Conv2d(nn.Module):
    def __init__(self, cin, cout, k, bias=True, device=None):
        super().__init__()
        self.weight = _empty(cout, cin, k, k, device=device)
        self.bias = _empty(cout, device=device) if bias else None


class ConvTranspose2d(nn.Module):
    """kernel_size == stride, no padding (the only deconv the model uses)."""

    def __init__(self, cin, cout, k, device=None):
        super().__init__()
        self.weight = _empty(cin, cout, k, k, device=device)
        self.bias = _empty(cout, device=device)


class Norm(nn.Module):
    """Scale and shift of a LayerNorm or GroupNorm."""

    def __init__(self, dim, device=None):
        super().__init__()
        self.weight = _empty(dim, device=device)
        self.bias = _empty(dim, device=device)


_casts = WeakIdKeyDictionary()  # parameter -> (its state, its cast copy)


def cast_once(p, dtype):
    """Parameter ``p`` as a contiguous ``dtype`` tensor, for a kernel that
    takes its weights in the working dtype.  A cast copy is made once and
    reused until ``p`` changes, in place or by reallocation.  Where autograd
    records and ``p`` requires grad, the cast is made anew and keeps the
    graph: a cached copy is detached and would cut ``p``'s gradient."""
    if torch.is_grad_enabled() and p.requires_grad:
        return p.to(dtype).contiguous()
    if p.dtype == dtype and p.is_contiguous():
        return p.detach()
    state = (dtype, p.device, p.data_ptr(), p._version)
    hit = _casts.get(p)
    if hit is None or hit[0] != state:
        hit = _casts[p] = (state, p.detach().to(dtype).contiguous())
    return hit[1]


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------

def gelu(x):
    """Exact erf GELU in fp32, tanh form in bf16 (JAX ``layers.gelu``)."""
    if x.dtype == torch.bfloat16:
        return F.gelu(x, approximate="tanh")
    return F.gelu(x)


def linear(p, x):
    """x @ W^T + b with the weight cast to x's dtype."""
    b = None if p.bias is None else p.bias.to(x.dtype)
    return F.linear(x, p.weight.to(x.dtype), b)


def layer_norm(p, x, eps: float = 1e-6, kernel: bool = True):
    """LayerNorm over the last axis, fp32 statistics: the one-pass kernel
    (K2) where it takes the width, its plain twin otherwise or with
    ``kernel=False``."""
    if kernel and norm_kernel.ln_supported(x):
        return norm_kernel.fused_layer_norm(x, p.weight, p.bias, eps)
    return norm_kernel.layer_norm_reference(x, p.weight, p.bias, eps)


def group_norm(p, x, num_groups: int, eps: float = 1e-6):
    """GroupNorm over NHWC input (stats over (H, W, C/g) per group), fp32."""
    n, h, w, c = x.shape
    x32 = x.float().reshape(n, h * w, num_groups, c // num_groups)
    mean = x32.mean(dim=(1, 3), keepdim=True)
    xc = x32 - mean
    var = (xc * xc).mean(dim=(1, 3), keepdim=True)
    y = (xc * torch.rsqrt(var + eps)).reshape(n, h, w, c)
    y = y * p.weight.float() + p.bias.float()
    return y.to(x.dtype)


def drop_path_mask(batch: int, rate: float, generator: torch.Generator,
                   dtype=torch.float32):
    """The per-sample mask of stochastic depth (JAX ``layers.drop_path``):
    a Bernoulli draw of keep = 1 - rate for each of ``batch`` samples, the
    survivors scaled by 1/keep, in ``dtype`` on the generator's device."""
    keep = 1.0 - rate
    mask = (torch.rand(batch, generator=generator, device=generator.device)
            < keep).to(dtype)
    if keep > 0.0:
        mask = mask / torch.tensor(keep, dtype=dtype)
    return mask


def apply_drop_path(x, mask):
    """x scaled per sample (along axis 0) by a ``drop_path_mask``."""
    return x * mask.to(x.dtype).view(-1, *(1,) * (x.dim() - 1))


def drop_path(x, rate: float, generator: torch.Generator):
    """Stochastic depth on a residual branch (reference
    dinov2_layers/drop_path.py:18-35): per-sample zeroing, survivors scaled
    by 1/keep.  Training only; identity at rate 0."""
    if rate <= 0.0:
        return x
    return apply_drop_path(x, drop_path_mask(x.shape[0], rate, generator,
                                             x.dtype))


def conv2d(p, x, stride: int = 1, padding: int = 0):
    """2D conv on NHWC input with symmetric integer padding."""
    b = None if p.bias is None else p.bias.to(x.dtype)
    y = F.conv2d(x.permute(0, 3, 1, 2), p.weight.to(x.dtype), b,
                 stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1)


def conv_transpose_same_stride(p, x, k: int):
    """ConvTranspose2d with kernel_size == stride: each input pixel makes an
    independent k x k block, so it is one matmul and a reshape."""
    n, h, w, _ = x.shape
    wk = p.weight.to(x.dtype)                      # (Cin, Cout, k, k)
    cout = wk.shape[1]
    y = torch.einsum("nhwc,cokl->nhkwlo", x, wk).reshape(n, h * k, w * k, cout)
    return y + p.bias.to(x.dtype)
