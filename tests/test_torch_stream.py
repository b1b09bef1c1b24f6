"""The port's causal streaming against the JAX package's, with shared weights.

The JAX side runs its Pallas kernels in interpret mode (tests/conftest.py);
the port runs its kernels' plain twins on the CPU.  Every comparison is fp32
and holds to 1e-4 of the output scale (1e-4 is the bound the port's model
tests use; the two sides differ in summation order only), except the int8
cache, whose bound is explained at its test.  Dispatch is checked by
counting calls of the K5 and K6 wrappers.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vda_tpu.config import EncoderConfig, ModelConfig
from vda_tpu.infer import streaming as jstream
from vda_tpu.models import init_video_depth_anything
from vda_tpu.models import temporal as jtemporal
from vda_tpu.models import vda as jvda
from vda_tpu.utils.convert import export_state_dict

import vda_tpu_torch as vt
from vda_tpu_torch import config as tconfig
from vda_tpu_torch.infer import streaming as tstream
from vda_tpu_torch.models import temporal as ttemporal
from vda_tpu_torch.models import vda as tvda
from vda_tpu_torch.ops import stream_kernel, tiny_seq_kernel

from tests.torch_port import nonzero_proj_out, rel_err

TOL = 1e-4


def _shared(head, vit, seed, **kw):
    """(JAX params, JAX cfg, port model) of one config and one set of
    weights, every motion module's proj_out non-zero."""
    jcfg = ModelConfig(*head, EncoderConfig(**vit), **kw)
    tcfg = tconfig.ModelConfig(*head, tconfig.EncoderConfig(**vit), **kw)
    params = init_video_depth_anything(jax.random.PRNGKey(seed), jcfg)
    params = nonzero_proj_out(params, np.random.default_rng(seed))
    model = vt.VideoDepthAnything(tcfg, device="cpu").requires_grad_(False)
    vt.load_state_dict_numpy(model, export_state_dict(params, jcfg))
    return params, jcfg, model


@pytest.fixture(scope="module")
def vits_like():
    """A vits-shaped head (features 64, out_channels (48, 96, 192, 384)): its
    motion modules at C=192 (8 heads of 24) and C=64 (8 of 8) take neither
    K3 nor K4, so offline they run K5; C=384 takes K3."""
    return _shared(("vits_like", 64, (48, 96, 192, 384), (0, 0, 1, 1)),
                   dict(embed_dim=64, depth=2, num_heads=2, img_size=56), 7)


@pytest.fixture
def calls(monkeypatch):
    """Count the model's calls of the K5 and K6 wrappers."""
    n = {"K5": 0, "K6": 0}
    for key, mod, name in (("K5", tiny_seq_kernel, "tiny_seq_attention"),
                           ("K6", stream_kernel, "stream_kv_attention")):
        def counted(*a, _f=getattr(mod, name), _k=key, **kw):
            n[_k] += 1
            return _f(*a, **kw)
        monkeypatch.setattr(mod, name, counted)
    return n


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_rows_match(ref_rows, got_rows):
    assert len(ref_rows) == len(got_rows) == 2
    for r, g in zip(ref_rows, got_rows):
        if isinstance(r, tuple):
            assert isinstance(g, tuple) and len(g) == len(r) == 2
            for a, b in zip(r, g):
                assert rel_err(a, _np(b)) < TOL
        else:
            assert rel_err(r, _np(g)) < TOL


# mode -> (T of x, hw, context kind)
MODES = {"offline": (8, (4, 5), None), "first_step": (1, (4, 5), None),
         "kv": (1, (4, 5), "kv"), "ctx": (1, (4, 4), "ctx"),
         "h": (1, (4, 5), "h")}


@pytest.mark.parametrize("mm,c", [(0, 192), (2, 64)])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_temporal_module_cache_modes(vits_like, calls, mode, mm, c):
    params, jcfg, model = vits_like
    t, hw, kind = MODES[mode]
    bd = hw[0] * hw[1]  # 16 positions for ctx: JAX's K6 tiles 16 a cell
    r = np.random.default_rng(mm * 10 + t)
    x = r.standard_normal((1, t, *hw, c)).astype(np.float32)
    ctx = None
    if kind is not None:
        ctx = [r.standard_normal((bd, 31, c)).astype(np.float32)
               for _ in range(4 if kind != "h" else 2)]
        if kind == "h":
            ctx = [jnp.asarray(a) for a in ctx]
        else:
            marker = ("ctx",) if kind == "ctx" else ()
            ctx = [(jnp.asarray(ctx[2 * i]), jnp.asarray(ctx[2 * i + 1]))
                   + marker for i in range(2)]
    want_kv = mode == "first_step" or kind in ("kv", "ctx")
    need = mode != "offline"
    ref, ref_rows = jtemporal.temporal_module_apply(
        params["head"]["motion_modules"][mm], jnp.asarray(x), jcfg, ctx,
        want_kv=want_kv, need_caches=need)
    tctx = None
    if ctx is not None:
        tctx = [tuple(torch.from_numpy(np.array(a)) if not isinstance(a, str)
                      else a for a in e) if isinstance(e, tuple)
                else torch.from_numpy(np.array(e)) for e in ctx]
    with torch.no_grad():
        got, got_rows = ttemporal.temporal_module_apply(
            model.head.motion_modules[mm], torch.from_numpy(x), model.cfg,
            tctx, want_kv=want_kv, need_caches=need)
    assert got.shape == ref.shape
    assert rel_err(ref, got.numpy()) < TOL
    assert rel_err(x, ref) > 1e-2  # the module is not the identity
    _assert_rows_match(ref_rows, got_rows)
    # K5 takes every attention over whole sequences, K6 the ctx cache
    assert calls == {"K5": 2 if kind is None else 0,
                     "K6": 2 if kind == "ctx" else 0}


def test_bookkeeping_equals_jax():
    assert all(tstream._row(i) == jstream._row(i) for i in range(400))
    j_order, t_order, free = [0] * 32, [0] * 32, []
    jstream._evict(0, j_order, free)
    tstream._evict(0, t_order)
    assert t_order == j_order
    for step in range(1, 121):
        j_ctx, j_new = jstream._advance_bookkeeping(step, j_order, free)
        t_ctx, t_new = tstream._advance_bookkeeping(step, t_order)
        assert (t_ctx, t_new, t_order) == (j_ctx, j_new, j_order), step
    assert tstream._BUF_ROWS == jstream._BUF_ROWS


@pytest.fixture(scope="module")
def stream_setup():
    """The ``ctx_cfg`` of tests/test_streaming_ctx_kernel.py (4 temporal
    heads of width 8, so the JAX side engages K5 and K6) and 48 frames, past
    eviction onset (step 11) and ring-row reuse (step 45)."""
    params, jcfg, model = _shared(("tiny", 32, (32, 32, 32, 32), (0, 0, 1, 1)),
                                  dict(embed_dim=64, depth=2, num_heads=2,
                                       img_size=56), 11,
                                  num_attention_heads=4)
    frames = (np.random.default_rng(11).random((48, 70, 90, 3))
              * 255).astype(np.uint8)
    return params, jcfg, model, frames


@pytest.mark.parametrize("cache_kind,ctx_kernel",
                         [("kv", False), ("kv", True), ("h", False)])
def test_streaming_matches_jax(stream_setup, calls, cache_kind, ctx_kernel):
    params, jcfg, model, frames = stream_setup
    ref = jstream.StreamingDepth(params, jcfg, input_size=56, fp32=True,
                                 cache_kind=cache_kind, cache_dtype="bf16",
                                 ctx_kernel=ctx_kernel)
    got = vt.StreamingDepth(model, input_size=56, fp32=True,
                            cache_kind=cache_kind, ctx_kernel=ctx_kernel)
    for i, f in enumerate(frames):
        d_ref = np.asarray(ref(f))
        d = got(f)
        assert d.shape == (70, 90) and d.dtype == np.float32
        assert rel_err(d_ref, d) < TOL, i
        assert got.order == ref.order, i
        if i == 0:  # the first step runs K5 in every attention sub-block
            assert calls == {"K5": 8, "K6": 0}
    assert calls["K6"] == (8 * 47 if ctx_kernel else 0)
    assert float(np.abs(d_ref).max()) > 1e-2
    # the cache matters: the last frame alone gives another depth
    alone = vt.StreamingDepth(model, input_size=56, fp32=True)(frames[-1])
    assert rel_err(d, alone) > 1e-3


def test_streaming_int8_cache_matches_jax(stream_setup):
    """int8 rows over 12 frames.  Each cache row is quantised with one scale
    (its largest magnitude over 127), so an element whose value sits at a
    rounding midpoint may round one way here and the other in JAX after a
    1e-7 difference upstream: one quantum, amax/127 of one cached value.
    Such a flip moves a depth by far less than 1e-3 of its scale (1.4e-5
    measured on this input)."""
    params, jcfg, model, frames = stream_setup
    ref = jstream.StreamingDepth(params, jcfg, input_size=56, fp32=True,
                                 cache_dtype="int8")
    got = vt.StreamingDepth(model, input_size=56, fp32=True,
                            cache_dtype="int8")
    for i, f in enumerate(frames[:12]):
        assert rel_err(np.asarray(ref(f)), got(f)) < 1e-3, i
    assert all(b.dtype == torch.int8 for b in got.buffers)
    for (jk, jv), (tk, tv) in zip(ref.scales, zip(got.scales[::2],
                                                  got.scales[1::2])):
        assert rel_err(jk, tk.numpy()) < TOL and rel_err(jv, tv.numpy()) < TOL


def test_streaming_refusals(stream_setup):
    _, _, model, frames = stream_setup
    with pytest.raises(ValueError):
        vt.StreamingDepth(model, input_size=56, ctx_kernel=True,
                          cache_kind="h")
    with pytest.raises(ValueError):
        vt.StreamingDepth(model, input_size=56, ctx_kernel=True,
                          attn_impl="plain")
    with pytest.raises(ValueError):
        vt.StreamingDepth(model, input_size=56, cache_dtype="fp8")
    s = vt.StreamingDepth(model, input_size=56, fp32=True)
    s(frames[0])
    with pytest.raises(ValueError):
        s(frames[1][:60])
    assert s.id == 0  # the refused frame left the stream as it was
    s.reset()
    assert s(frames[1][:60]).shape == (60, 90)


def test_vits_like_forward_matches_jax(vits_like, calls):
    """A whole forward of the vits-shaped model (K5 in mm0, mm2 and mm3, K3
    in mm1), and ``forward`` equal to forward_features + forward_depth bit
    for bit."""
    params, jcfg, model = vits_like
    x = np.random.default_rng(2).standard_normal(
        (1, 8, 56, 70, 3)).astype(np.float32)
    ref = jvda.forward(params, jnp.asarray(x), jcfg, attn_impl="pallas")
    got = tvda.forward(model, torch.from_numpy(x))
    assert rel_err(ref, got.numpy()) < TOL
    assert calls["K5"] == 6
    with torch.no_grad():
        feats = tvda.forward_features(model, torch.from_numpy(x))
        depth, caches = tvda.forward_depth(model, feats, x.shape,
                                           need_caches=False)
    assert torch.equal(depth, got)
    assert len(caches) == 6  # the input states of the K5 sub-blocks
