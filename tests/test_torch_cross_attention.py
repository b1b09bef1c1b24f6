"""K9 and the generic attention library against the JAX package.

K9's twin is held against the Pallas ``flash_attention_packed`` (interpret
mode, tests/conftest.py); ``ops/attention.py``'s dispatch and
``models/cross_attention.py`` against ``vda_tpu/ops/attention.py`` and
``vda_tpu/models/cross_attention.py`` on shared weights
(``load_cross_attention_numpy``).  fp32 differs in summation order only:
2e-5 of the output scale.  bf16 K9: 1e-2 (the Pallas kernel rounds its exp
to bf16, the twin its normalised probabilities).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vda_tpu.models import cross_attention as jca
from vda_tpu.ops import attention as jattention
from vda_tpu.ops import pallas_attention

import vda_tpu_torch.ops as tops
from vda_tpu_torch.models import cross_attention as tca
from vda_tpu_torch.ops import attention as tattention
from vda_tpu_torch.ops import attention_kernel
from vda_tpu_torch.utils.convert import load_cross_attention_numpy

from tests.torch_port import rel_err

TOL = 2e-5


def _t(a):
    return torch.from_numpy(np.array(a, np.float32, copy=True))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("n", [530, 600])
def test_k9_twin_matches_pallas(n, dtype):
    """N=530 and 600 (ragged: the Pallas kernel pads to 640), 2 heads of
    64."""
    q, k, v = np.random.default_rng(n).standard_normal((3, 1, n, 128)) \
        .astype(np.float32)
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    ref = pallas_attention.flash_attention_packed(
        *(jnp.asarray(a, jdt) for a in (q, k, v)), heads=2, scale=0.125)
    tops.reset_launch_counts()
    got = attention_kernel.flash_attention_packed(
        *(_t(a).to(tdt) for a in (q, k, v)), 2, 0.125)
    assert tops.launch_counts()["K9"] == 0  # the twin ran
    assert got.dtype == tdt and got.shape == (1, n, 128)
    assert rel_err(np.asarray(ref, np.float32), got.float().numpy()) < \
        (TOL if dtype == "f32" else 1e-2)


@pytest.fixture
def k9_calls(monkeypatch):
    """Counts the calls of K9's wrapper."""
    n = []
    wrapper = attention_kernel.flash_attention_packed
    monkeypatch.setattr(attention_kernel, "flash_attention_packed",
                        lambda *a, **k: n.append(1) or wrapper(*a, **k))
    return n


@pytest.mark.parametrize("nq,nk,heads,d,impl,kernel", [
    (530, 530, 2, 64, "auto", True), (530, 530, 2, 64, "plain", False),
    (100, 100, 2, 64, "auto", False), (530, 77, 2, 64, "auto", False),
    (512, 512, 4, 12, "auto", False), (512, 512, 2, 136, "auto", False),
    (600, 600, 8, 16, "auto", True)])
def test_dot_product_attention_matches_jax(k9_calls, nq, nk, heads, d, impl,
                                           kernel):
    """Over (B, N, H, D): K9 exactly where the JAX gate (N >= 512, equal
    lengths, D % 8) and the kernel (D <= 128) admit the shape."""
    r = np.random.default_rng(nq + nk + d)
    q = r.standard_normal((2, nq, heads, d)).astype(np.float32)
    k, v = r.standard_normal((2, 2, nk, heads, d)).astype(np.float32)
    ref = jattention.dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        impl="xla" if impl == "plain" else "auto")
    got = tattention.dot_product_attention(_t(q), _t(k), _t(v), impl=impl)
    assert len(k9_calls) == int(kernel)
    assert rel_err(ref, got.numpy()) < TOL


@pytest.mark.parametrize("n,impl,kernel", [(530, "auto", True),
                                           (300, "auto", False),
                                           (530, "plain", False)])
def test_packed_self_attention_matches_jax(k9_calls, n, impl, kernel):
    r = np.random.default_rng(n)
    q, k, v = r.standard_normal((3, 2, n, 192)).astype(np.float32)
    ref = jattention.packed_self_attention(
        *(jnp.asarray(a) for a in (q, k, v)), 3,
        impl="xla" if impl == "plain" else "auto")
    got = tattention.packed_self_attention(*(_t(a) for a in (q, k, v)), 3,
                                           impl=impl)
    assert len(k9_calls) == int(kernel)
    assert rel_err(ref, got.numpy()) < TOL


def test_dispatch_refusals():
    x = torch.zeros(1, 8, 64)
    with pytest.raises(ValueError, match="B=1"):  # segments need a packed batch
        x2 = torch.zeros(2, 8, 64)
        tattention.packed_self_attention(x2, x2, x2, 2,
                                         segment_lengths=(3, 5))
    with pytest.raises(ValueError, match="sum"):
        tattention.packed_self_attention(x, x, x, 2, segment_lengths=(3, 4))
    with pytest.raises(ValueError):
        tattention.packed_self_attention(x, x, x, 2, impl="pallas")
    with pytest.raises(ValueError):
        tattention.dot_product_attention(x.view(1, 8, 2, 32),
                                          x.view(1, 8, 2, 32),
                                          x.view(1, 8, 2, 32), impl="xla")


def _attention_pair(seed, query_dim=128, heads=2, dim_head=64, **kw):
    """JAX ``init_cross_attention`` params and the port's module holding
    them."""
    p = jca.init_cross_attention(jax.random.PRNGKey(seed), query_dim,
                                 heads=heads, dim_head=dim_head, **kw)
    if "norm_num_groups" in kw:  # non-trivial GroupNorm scale and shift
        r = np.random.default_rng(seed)
        p["group_norm"] = {"scale": jnp.asarray(1 + r.standard_normal(
            heads * dim_head).astype(np.float32) * 0.5), "bias": jnp.asarray(
            r.standard_normal(heads * dim_head).astype(np.float32) * 0.5)}
    m = tca.CrossAttention(query_dim, heads=heads, dim_head=dim_head,
                           device="cpu", **kw).requires_grad_(False)
    return p, load_cross_attention_numpy(m, p)


# (name, init kwargs, sequence length, context length or None, call kwargs)
CASES = [
    ("self_kernel", {}, 530, None, {"impl": "auto"}),
    ("self_plain", {}, 40, None, {}),
    ("self_bias", {"bias": True}, 40, None, {}),
    ("cross", {"cross_attention_dim": 96}, 40, 17, {"impl": "auto"}),
    ("added_kv", {"added_kv_proj_dim": 80}, 40, 17, {}),
    ("group_norm", {"norm_num_groups": 4}, 40, None,
     {"group_norm_groups": 4}),
    ("mask", {}, 40, None, {"mask": True, "impl": "auto"}),
]


@pytest.mark.parametrize("name,init,n,m,call", CASES,
                         ids=[c[0] for c in CASES])
def test_cross_attention_matches_jax(k9_calls, name, init, n, m, call):
    p, mod = _attention_pair(len(name), **init)
    r = np.random.default_rng(n)
    h = r.standard_normal((2, n, 128)).astype(np.float32)
    ctx = None
    if m is not None:
        ctx = r.standard_normal((2, m, init.get("cross_attention_dim") or
                                 init.get("added_kv_proj_dim"))) \
            .astype(np.float32)
    mask = None
    if call.get("mask"):
        mask = np.where(r.random((2, 1, n, n)) < 0.2, -1e4, 0.0) \
            .astype(np.float32)
    impl = call.get("impl", "plain")
    ref = jca.cross_attention(
        p, jnp.asarray(h), 2,
        encoder_hidden_states=None if ctx is None else jnp.asarray(ctx),
        attention_mask=None if mask is None else jnp.asarray(mask),
        group_norm_groups=call.get("group_norm_groups"),
        impl="xla" if impl == "plain" else "auto")
    with torch.no_grad():
        got = mod(_t(h), None if ctx is None else _t(ctx),
                  None if mask is None else _t(mask),
                  call.get("group_norm_groups"), impl)
    assert got.shape == ref.shape
    assert rel_err(ref, got.numpy()) < TOL
    assert len(k9_calls) == int(name == "self_kernel")


def test_added_kv_needs_a_context():
    p, mod = _attention_pair(0, added_kv_proj_dim=80)
    x = np.zeros((1, 4, 128), np.float32)
    with pytest.raises(ValueError):
        jca.cross_attention(p, jnp.asarray(x), 2)
    with pytest.raises(ValueError):
        tca.cross_attention(mod, _t(x))


@pytest.mark.parametrize("act", ["geglu", "gelu", "geglu-approximate"])
def test_feed_forward_matches_jax(act):
    p = jca.init_feed_forward(jax.random.PRNGKey(3), 96, dim_out=80, mult=2,
                              activation_fn=act)
    mod = tca.FeedForward(96, dim_out=80, mult=2, activation_fn=act,
                          device="cpu").requires_grad_(False)
    load_cross_attention_numpy(mod, p)
    x = np.random.default_rng(4).standard_normal((2, 13, 96))
    x = x.astype(np.float32)
    ref = jca.feed_forward(p, jnp.asarray(x), act)
    with torch.no_grad():
        got = mod(_t(x))
    assert rel_err(ref, got.numpy()) < TOL


@pytest.mark.parametrize("module", [tca.CrossAttention, tca.FeedForward])
def test_modules_are_built_on_the_card_unless_asked(module):
    """Both library modules build their parameters on the card by default,
    as ``VideoDepthAnything`` does; a CPU caller passes ``device="cpu"``."""
    import inspect

    assert inspect.signature(module).parameters["device"].default == "cuda"
    mod = module(16, device="cpu")
    assert {p.device.type for p in mod.parameters()} == {"cpu"}


def test_feed_forward_refuses_unknown_activation():
    p = jca.init_feed_forward(jax.random.PRNGKey(3), 16, activation_fn="gelu")
    mod = tca.FeedForward(16, activation_fn="gelu", device="cpu")
    load_cross_attention_numpy(mod, p)
    with pytest.raises(NotImplementedError):
        jca.feed_forward(p, jnp.zeros((1, 2, 16)), "relu")
    with pytest.raises(NotImplementedError):
        tca.feed_forward(mod, torch.zeros(1, 2, 16), "relu")
