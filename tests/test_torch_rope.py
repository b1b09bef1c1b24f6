"""The port's RoPE motion modules (``cfg.pe="rope"``) against the JAX
package's, with shared weights.

The rotation turns the interleaved channel pairs of the whole width C, so a
per-head or half-split rotation would still be the identity at position 0:
every comparison here includes positions above 0 (whole windows, and cached
steps whose queries sit at position 31).  The JAX side runs its Pallas
kernels in interpret mode (tests/conftest.py); the port runs its kernels'
plain twins on the CPU.  Comparisons are fp32 and hold to 1e-4 of the
output scale (the bound of tests/test_torch_models.py; the two sides differ
in summation order only), the tables and the rotation to 1e-6; the int8
cache takes tests/test_torch_stream.py's bound, explained there.  Dispatch
is checked by counting calls of the K3-K6 wrappers: under RoPE the JAX
gates leave K5 alone.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vda_tpu.config import STREAM_MAX_CACHE, EncoderConfig, ModelConfig
from vda_tpu.infer import streaming as jstream
from vda_tpu.models import temporal as jtemporal
from vda_tpu.models import vda as jvda

import vda_tpu_torch as vt
from vda_tpu_torch import config as tconfig
from vda_tpu_torch.models import temporal as ttemporal
from vda_tpu_torch.models import vda as tvda
from vda_tpu_torch.ops import stream_kernel, temporal_kernel, tiny_seq_kernel

from tests.test_torch_stream import _assert_rows_match, _shared
from tests.torch_port import rel_err, small_models

TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two torch threads: the suite's workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    return small_models(seed=5, pe="rope")


@pytest.fixture
def calls(monkeypatch):
    """Count the model's calls of the K3-K6 wrappers."""
    n = {"K3": 0, "K4": 0, "K5": 0, "K6": 0}
    for key, mod, name in (
            ("K3", temporal_kernel, "temporal_block_fused"),
            ("K4", temporal_kernel, "attention_block_fused"),
            ("K5", tiny_seq_kernel, "tiny_seq_attention"),
            ("K6", stream_kernel, "stream_kv_attention")):
        def counted(*a, _f=getattr(mod, name), _k=key, **kw):
            n[_k] += 1
            return _f(*a, **kw)
        monkeypatch.setattr(mod, name, counted)
    return n


@pytest.mark.parametrize("dim,end,start", [(8, 5, 0), (256, 32, 3),
                                           (1024, 32, 31)])
def test_rope_tables_and_rotation_match_jax(dim, end, start):
    jcos, jsin = jtemporal._rope_tables(dim, end)
    cos, sin = ttemporal.rope_tables(dim, end, torch.device("cpu"))
    assert cos.shape == sin.shape == (end, dim // 2)
    assert rel_err(jcos, cos.numpy()) < 1e-6
    assert rel_err(jsin, sin.numpy()) < 1e-6
    x = np.random.default_rng(dim).standard_normal(
        (3, end - start, dim)).astype(np.float32)
    ref = jtemporal._apply_rope(jnp.asarray(x),
                                jnp.asarray(jcos)[None, start:],
                                jnp.asarray(jsin)[None, start:])
    got = ttemporal._rope_at(torch.from_numpy(x), start)
    assert rel_err(ref, got.numpy()) < 1e-6
    if start > 0:  # a rotation: not the identity above position 0
        assert rel_err(x, got.numpy()) > 1e-2


def test_rope_state_dict_has_no_pe(models):
    """JAX exports ``pos_encoder.pe`` under APE alone, and the strict load of
    ``small_models`` took the RoPE export whole."""
    _, _, model, _ = models
    assert not any("pos_encoder" in k for k in model.state_dict())


# mode -> (T of x, context kind)
MODES = {"offline": (8, None), "first_step": (1, None), "kv": (1, "kv"),
         "ctx": (1, "ctx"), "h": (1, "h"), "kv_t3": (3, "kv"),
         "h_t3": (3, "h")}


@pytest.mark.parametrize("mm,c", [(0, 640), (2, 128)])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_rope_temporal_module_matches_jax(models, calls, mode, mm, c):
    """Offline, the first streaming step, and cached steps whose new frames
    sit at positions 31.. of the context (``kv_t3``/``h_t3``: three new
    frames).  mm 0 (C 640, 8 heads of 80) and mm 2 (C 128, 8 of 16) would
    take K4 and K3 under APE; under RoPE K5 takes every attention over
    whole sequences and K6 nothing, ``ctx`` running the plain kv path as in
    JAX."""
    params, jcfg, model, _ = models
    t, kind = MODES[mode]
    hw = (4, 4)
    bd = hw[0] * hw[1]
    r = np.random.default_rng(mm * 10 + t)
    x = r.standard_normal((1, t, *hw, c)).astype(np.float32)
    ctx = tctx = None
    if kind is not None:
        raw = [r.standard_normal((bd, 31, c)).astype(np.float32)
               for _ in range(4 if kind != "h" else 2)]
        if kind == "h":
            ctx = [jnp.asarray(a) for a in raw]
            tctx = [torch.from_numpy(a) for a in raw]
        else:
            marker = ("ctx",) if kind == "ctx" else ()
            ctx = [(jnp.asarray(raw[2 * i]), jnp.asarray(raw[2 * i + 1]))
                   + marker for i in range(2)]
            tctx = [(torch.from_numpy(raw[2 * i]),
                     torch.from_numpy(raw[2 * i + 1])) + marker
                    for i in range(2)]
    want_kv = mode == "first_step" or kind in ("kv", "ctx")
    need = mode != "offline"
    ref, ref_rows = jtemporal.temporal_module_apply(
        params["head"]["motion_modules"][mm], jnp.asarray(x), jcfg, ctx,
        want_kv=want_kv, need_caches=need)
    with torch.no_grad():
        got, got_rows = ttemporal.temporal_module_apply(
            model.head.motion_modules[mm], torch.from_numpy(x), model.cfg,
            tctx, want_kv=want_kv, need_caches=need)
    assert got.shape == ref.shape
    assert rel_err(ref, got.numpy()) < TOL
    assert rel_err(x, ref) > 1e-2  # the module is not the identity
    _assert_rows_match(ref_rows, got_rows)
    assert calls == {"K3": 0, "K4": 0, "K5": 2 if kind is None else 0,
                     "K6": 0}


def test_rope_differs_from_ape(models):
    """The same weights under APE give another output: the positions are
    encoded, and by the rotation (no ``pos_encoder`` is read)."""
    params, jcfg, model, tcfg = models
    x = np.random.default_rng(9).standard_normal(
        (1, 8, 4, 4, 128)).astype(np.float32)
    mm = model.head.motion_modules[2]
    with torch.no_grad():
        rope, _ = ttemporal.temporal_module_apply(
            mm, torch.from_numpy(x), tcfg, need_caches=False)
    ape_cfg = jcfg.replace(pe="ape")
    ape, _ = jtemporal.temporal_module_apply(
        params["head"]["motion_modules"][2], jnp.asarray(x), ape_cfg,
        need_caches=False, attn_impl="xla")
    assert rel_err(ape, rope.numpy()) > 1e-3


def test_rope_forward_matches_jax(models, calls):
    """A whole window of the RoPE model: K5 in both attention sub-blocks of
    all four motion modules, K3/K4 in none."""
    params, jcfg, model, _ = models
    x = np.random.default_rng(2).standard_normal(
        (1, 8, 56, 70, 3)).astype(np.float32)
    ref = jvda.forward(params, jnp.asarray(x), jcfg, attn_impl="pallas")
    with torch.no_grad():
        got = tvda.forward(model, torch.from_numpy(x))
    assert rel_err(ref, got.numpy()) < TOL
    assert calls == {"K3": 0, "K4": 0, "K5": 8, "K6": 0}


@pytest.mark.parametrize("pe", ["ape", "rope"])
def test_stream_kernel_gate_matches_jax(monkeypatch, pe):
    """``stream_kernel.use_kernel`` against JAX's K6 gate, read off
    ``_temporal_attention_kv_ctx``: whether it calls its kernel or hands
    the step to the plain kv path (16 rows, JAX's row tile, so its padding
    term holds)."""
    import jax

    from vda_tpu.ops import pallas_stream

    class Called(Exception):
        pass

    class Refused(Exception):
        pass

    def kernel(*a, **kw):
        raise Called

    def plain(*a, **kw):
        raise Refused

    monkeypatch.setattr(pallas_stream, "stream_kv_attention", kernel)
    monkeypatch.setattr(jtemporal, "_temporal_attention_kv", plain)
    for c, heads in [(1024, 8), (256, 8), (192, 8), (64, 8), (32, 8),
                     (1536, 8), (1536, 12), (384, 6), (640, 8), (32, 4)]:
        cfg = ModelConfig("g", 32, (32,) * 4, (0, 0, 1, 1),
                          EncoderConfig(embed_dim=64, depth=1, num_heads=1),
                          num_attention_heads=heads, pe=pe)
        keys = jax.random.split(jax.random.PRNGKey(c), 4)
        p = {name: {"w": jax.random.normal(k, (c, c)) * 0.02}
             for name, k in zip(("to_q", "to_k", "to_v", "to_out"), keys)}
        p["to_out"]["b"] = jnp.zeros((c,))
        h = jnp.ones((16, 1, c))
        ctx = (jnp.ones((16, 31, c)), jnp.ones((16, 31, c)), "ctx")
        try:
            jtemporal._temporal_attention_kv_ctx(p, h, cfg, ctx)
        except Called:
            jax_gate = True
        except Refused:
            jax_gate = False
        assert stream_kernel.use_kernel(1, c, heads, pe) == jax_gate, (c,
                                                                      heads)
        assert jax_gate == (pe == "ape" and (c, heads) not in
                            [(32, 8), (1536, 8), (640, 8)])


@pytest.fixture(scope="module")
def stream_setup():
    """tests/test_torch_stream.py's stream config under RoPE (4 temporal
    heads of width 8, so K5 takes the first step) and STREAM_MAX_CACHE + 4
    frames: past eviction onset (step 11), so cached frames' positions move
    from step to step."""
    params, jcfg, model = _shared(("tiny", 32, (32, 32, 32, 32), (0, 0, 1, 1)),
                                  dict(embed_dim=64, depth=2, num_heads=2,
                                       img_size=56), 13,
                                  num_attention_heads=4, pe="rope")
    frames = (np.random.default_rng(13).random(
        (STREAM_MAX_CACHE + 4, 70, 90, 3)) * 255).astype(np.uint8)
    return params, jcfg, model, frames


@pytest.mark.parametrize("cache_kind,ctx_kernel",
                         [("kv", False), ("kv", True), ("h", False)])
def test_rope_streaming_matches_jax(stream_setup, calls, cache_kind,
                                    ctx_kernel):
    params, jcfg, model, frames = stream_setup
    ref = jstream.StreamingDepth(params, jcfg, input_size=56, fp32=True,
                                 cache_kind=cache_kind, ctx_kernel=ctx_kernel)
    got = vt.StreamingDepth(model, input_size=56, fp32=True,
                            cache_kind=cache_kind, ctx_kernel=ctx_kernel)
    for i, f in enumerate(frames):
        d_ref = np.asarray(ref(f))
        d = got(f)
        assert rel_err(d_ref, d) < TOL, i
        assert got.order == ref.order, i
        if i == 0:
            assert calls["K5"] == 8
    assert calls == {"K3": 0, "K4": 0, "K5": 8, "K6": 0}
    assert float(np.abs(d_ref).max()) > 1e-2
    alone = vt.StreamingDepth(model, input_size=56, fp32=True)(frames[-1])
    assert rel_err(d, alone) > 1e-3  # the cache matters


def test_rope_streaming_int8_cache_matches_jax(stream_setup):
    params, jcfg, model, frames = stream_setup
    ref = jstream.StreamingDepth(params, jcfg, input_size=56, fp32=True,
                                 cache_dtype="int8")
    got = vt.StreamingDepth(model, input_size=56, fp32=True,
                            cache_dtype="int8")
    for i, f in enumerate(frames[:12]):
        assert rel_err(np.asarray(ref(f)), got(f)) < 1e-3, i


def test_rope_submit_group_matches_jax(stream_setup):
    """One ``submit_group`` of 4 after 6 single steps, against JAX's
    ``submit_group``, and the cache against 4 ``submit`` calls."""
    params, jcfg, model, frames = stream_setup
    ref = jstream.StreamingDepth(params, jcfg, input_size=56, fp32=True)
    got = vt.StreamingDepth(model, input_size=56, fp32=True)
    seq = vt.StreamingDepth(model, input_size=56, fp32=True)
    for f in frames[:6]:
        ref(f), got(f), seq(f)
    d_ref = np.asarray(ref.submit_group(frames[6:10]))
    d = got.submit_group(frames[6:10]).numpy()
    assert d.shape == (4, 70, 90)
    assert rel_err(d_ref, d) < TOL
    d_seq = np.stack([seq(f) for f in frames[6:10]])
    assert rel_err(d_seq, d) < TOL
    assert got.order == seq.order == ref.order
    for a, b in zip(got.buffers, seq.buffers):
        assert torch.equal(a, b)
    assert rel_err(np.asarray(ref(frames[10])), got(frames[10])) < TOL


def test_unknown_pe_refused():
    with pytest.raises(ValueError, match="pe"):
        vt.VideoDepthAnything(tconfig.get_config("tiny", pe="alibi"),
                              device="cpu")
