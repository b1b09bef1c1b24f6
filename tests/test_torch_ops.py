"""The port's ops against the JAX package's, on numpy-seeded inputs.

Everything runs in fp32 on the CPU, where the two packages compute the same
formulas and differ only in summation order: 1e-5 of the output scale is
the bound (a module off by more than 1e-4 would be a bug, not rounding).
GELU in bf16 is held to one bf16 ulp of its output (the tanh form in both).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vda_tpu.ops import attention as jattn
from vda_tpu.ops import layers as jl
from vda_tpu.ops import resize as jr

from vda_tpu_torch.ops import attention as tattn
from vda_tpu_torch.ops import layers as tl
from vda_tpu_torch.ops import resize as tr

from tests.torch_port import rel_err

TOL = 1e-5


def _rng(seed=0):
    return np.random.default_rng(seed)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _set(p, **arrays):
    for k, v in arrays.items():
        getattr(p, k).data = _t(v)
    return p.requires_grad_(False)


@pytest.mark.parametrize("bias", [True, False])
def test_linear(bias):
    r = _rng(1)
    w = r.standard_normal((48, 32)).astype(np.float32)
    b = r.standard_normal(32).astype(np.float32)
    x = r.standard_normal((3, 5, 48)).astype(np.float32)
    jp = {"w": w, "b": b} if bias else {"w": w}
    p = tl.Linear(48, 32, bias=bias)
    _set(p, weight=w.T, **({"bias": b} if bias else {}))
    ref = jl.linear(jp, jnp.asarray(x))
    assert rel_err(ref, tl.linear(p, _t(x)).numpy()) < TOL


@pytest.mark.parametrize("c,eps", [(256, 1e-6), (1024, 1e-5), (40, 1e-6)])
def test_layer_norm(c, eps):
    r = _rng(2)
    x = (r.standard_normal((4, 9, c)) * 3 + 1).astype(np.float32)
    s = r.standard_normal(c).astype(np.float32)
    b = r.standard_normal(c).astype(np.float32)
    ref = jl.layer_norm({"scale": s, "bias": b}, jnp.asarray(x), eps=eps)
    p = _set(tl.Norm(c), weight=s, bias=b)
    for kernel in (True, False):  # CPU: the kernel dispatch takes the twin
        got = tl.layer_norm(p, _t(x), eps=eps, kernel=kernel)
        assert rel_err(ref, got.numpy()) < TOL


def test_group_norm():
    r = _rng(3)
    x = (r.standard_normal((2, 5, 6, 64)) * 2 - 1).astype(np.float32)
    s = r.standard_normal(64).astype(np.float32)
    b = r.standard_normal(64).astype(np.float32)
    ref = jl.group_norm({"scale": s, "bias": b}, jnp.asarray(x), 32, eps=1e-6)
    got = tl.group_norm(_set(tl.Norm(64), weight=s, bias=b), _t(x), 32, 1e-6)
    assert rel_err(ref, got.numpy()) < TOL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu(dtype):
    x = (_rng(4).standard_normal(4096) * 3).astype(np.float32)
    ref = np.asarray(jl.gelu(jnp.asarray(x).astype(dtype)), np.float32)
    got = tl.gelu(_t(x).to(getattr(torch, dtype))).float().numpy()
    tol = TOL if dtype == "float32" else 2 ** -7  # one bf16 ulp
    assert rel_err(ref, got) < tol


@pytest.mark.parametrize("k,stride,pad", [(3, 1, 1), (3, 2, 1), (1, 1, 0)])
def test_conv2d(k, stride, pad):
    r = _rng(5)
    w = r.standard_normal((k, k, 16, 24)).astype(np.float32)
    b = r.standard_normal(24).astype(np.float32)
    x = r.standard_normal((2, 11, 9, 16)).astype(np.float32)
    ref = jl.conv2d({"w": w, "b": b}, jnp.asarray(x), stride=stride,
                    padding=pad)
    p = _set(tl.Conv2d(16, 24, k), weight=w.transpose(3, 2, 0, 1), bias=b)
    got = tl.conv2d(p, _t(x), stride=stride, padding=pad)
    assert got.shape == ref.shape
    assert rel_err(ref, got.numpy()) < TOL


@pytest.mark.parametrize("k", [2, 4])
def test_conv_transpose_same_stride(k):
    r = _rng(6)
    w = r.standard_normal((16, k, k, 8)).astype(np.float32)
    b = r.standard_normal(8).astype(np.float32)
    x = r.standard_normal((2, 5, 7, 16)).astype(np.float32)
    ref = jl.conv_transpose_same_stride({"w": w, "b": b}, jnp.asarray(x), k)
    p = _set(tl.ConvTranspose2d(16, 8, k), weight=w.transpose(0, 3, 1, 2),
             bias=b)
    got = tl.conv_transpose_same_stride(p, _t(x), k)
    assert got.shape == ref.shape
    assert rel_err(ref, got.numpy()) < TOL


@pytest.mark.parametrize("in_hw,out_hw", [((37, 37), (74, 74)),
                                          ((9, 13), (20, 17)),
                                          ((8, 8), (8, 8))])
def test_resize_bilinear(in_hw, out_hw):
    x = _rng(7).standard_normal((2, *in_hw, 5)).astype(np.float32)
    ref = jr.resize_bilinear(jnp.asarray(x), out_hw, align_corners=True)
    got = tr.resize_bilinear(_t(x), out_hw, align_corners=True)
    assert rel_err(ref, got.numpy()) < TOL


@pytest.mark.parametrize("in_hw,out_hw,scale", [((70, 90), (56, 70), None),
                                                ((30, 20), (64, 42), None),
                                                ((4, 4), (4, 5), (1.025, 1.275))])
def test_resize_bicubic(in_hw, out_hw, scale):
    x = _rng(8).standard_normal((1, *in_hw, 3)).astype(np.float32)
    ref = jr.resize_bicubic(jnp.asarray(x), out_hw, scale=scale)
    got = tr.resize_bicubic(_t(x), out_hw, scale=scale)
    assert rel_err(ref, got.numpy()) < TOL


@pytest.mark.parametrize("nq,nk,valid", [(17, 17, None), (5, 40, 33)])
def test_attention_plain(nq, nk, valid):
    r = _rng(9)
    q = r.standard_normal((2, nq, 3, 16)).astype(np.float32)
    k = r.standard_normal((2, nk, 3, 16)).astype(np.float32)
    v = r.standard_normal((2, nk, 3, 16)).astype(np.float32)
    n = nk if valid is None else valid
    ref = jattn._xla_attention(jnp.asarray(q), jnp.asarray(k[:, :n]),
                               jnp.asarray(v[:, :n]), 0.25)
    got = tattn.attention_plain(_t(q), _t(k), _t(v), 0.25, valid)
    assert rel_err(ref, got.numpy()) < TOL
