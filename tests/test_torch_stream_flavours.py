"""The port's streaming flavours against the JAX package's, with shared
weights: the ``ctx_kernel`` stream, whose K6 reads the cache buffers in
place once the context's rows are distinct (JAX's direct flavour), and the
``VDA_*`` knobs that pick behaviour, with JAX's ring and sliding layouts
refused.

One small kv config (tests/test_torch_stream.py's ``stream_setup``: four
temporal heads of width 8, so both sides engage K5 and K6), fp32, 56
frames: past the step from which the in-place read engages (42: the first
whose 31 context entries sit in distinct rows).  The JAX streams run once
for the module, its Pallas kernels in interpret mode (tests/conftest.py);
the port runs its kernels' plain twins on the CPU.  Bound: 1e-4 of the
output scale (tests/test_torch_stream.py's, summation order only), against
JAX's direct flavour too (tests/test_streaming_direct.py's fp32 bound).
"""

import numpy as np
import pytest
import torch

from vda_tpu.infer import streaming as jstream
from vda_tpu.infer import streaming_experimental as jexp

import vda_tpu_torch as vt
from vda_tpu_torch.apps import run as trun
from vda_tpu_torch.apps import run_streaming as trun_streaming
from vda_tpu_torch.infer import streaming as tstream
from vda_tpu_torch.infer import windowed as twindowed
from vda_tpu_torch.models import temporal as ttemporal
from vda_tpu_torch.models import vda as tvda
from vda_tpu_torch.ops import stream_kernel
from vda_tpu_torch.utils import knobs

from tests.test_torch_stream import _shared
from tests.torch_port import rel_err

TOL = 1e-4
GROUP_TOL = 1e-5  # tests/test_torch_apps_stream.py's: batched encoder/tail
N_FRAMES = 56
DIRECT_FROM = 42  # first step with 31 distinct context rows
KNOBS = ("VDA_STREAM_RING", "VDA_STREAM_DIRECT", "VDA_STREAM_SLIDE",
         "VDA_STREAM_SLIDE_ROWS", "VDA_STREAM_CACHE_DTYPE", "VDA_STREAM_KV8",
         "VDA_STREAM_CTX_KERNEL", "VDA_ATTN_FUSE_PROJ", "VDA_RESIZE_KERNEL")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two torch threads: the suite's workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_knobs(monkeypatch):
    """Every test starts with no knob set; each sets its own."""
    for name in KNOBS:
        monkeypatch.delenv(name, raising=False)


@pytest.fixture(scope="module")
def setup():
    params, jcfg, model = _shared(("tiny", 32, (32, 32, 32, 32),
                                   (0, 0, 1, 1)),
                                  dict(embed_dim=64, depth=2, num_heads=2,
                                       img_size=56), 11,
                                  num_attention_heads=4)
    frames = (np.random.default_rng(11).random((N_FRAMES, 70, 90, 3))
              * 255).astype(np.uint8)
    return params, jcfg, model, frames


def _jax_run(stream, frames):
    out, orders = [], []
    for f in frames:
        out.append(np.asarray(stream.submit(f)))
        orders.append(list(stream.order))
    return out, orders


@pytest.fixture(scope="module")
def jax_streams(setup):
    """JAX's default kv stream and its direct flavour, each run once:
    {name: (depths, order after each step)}, and the steps on which JAX's
    direct gate held."""
    params, jcfg, _, frames = setup
    out = {"kv": _jax_run(jstream.StreamingDepth(
        params, jcfg, input_size=56, fp32=True, cache_dtype="bf16"), frames)}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VDA_STREAM_DIRECT", "1")
        s = jstream.StreamingDepth(params, jcfg, input_size=56, fp32=True)
        assert type(s) is jexp.ExperimentalStreamingDepth
        engaged = []
        depths, orders = [np.asarray(s.submit(frames[0]))], [list(s.order)]
        for f in frames[1:]:
            order, free = list(s.order), list(s.free)
            ctx, _ = jstream._advance_bookkeeping(s.id + 1, order, free)
            engaged.append(s._direct_ok([jstream._row(i) for i in ctx]))
            depths.append(np.asarray(s.submit(f)))
            orders.append(list(s.order))
    out["direct"] = (depths, orders)
    return out, engaged


@pytest.fixture
def spies(monkeypatch):
    """Count the in-place steps and K6's launches (of its wrapper)."""
    n = {"direct": 0, "K6": 0}
    for key, mod, name in (("direct", tstream, "_stream_step_direct"),
                           ("K6", stream_kernel, "stream_kv_attention")):
        def counted(*a, _f=getattr(mod, name), _k=key, **kw):
            n[_k] += 1
            return _f(*a, **kw)
        monkeypatch.setattr(mod, name, counted)
    return n


@pytest.mark.parametrize("env,kw", [({}, {"ctx_kernel": True}),
                                    ({"VDA_STREAM_DIRECT": "1"}, {})],
                         ids=["ctx_kernel", "direct_knob"])
def test_direct_matches_jax_direct(setup, jax_streams, monkeypatch, spies,
                                   env, kw):
    """The ``ctx_kernel`` stream (built by the argument or by JAX's
    ``VDA_STREAM_DIRECT`` knob) against JAX's direct flavour within 1e-4 at
    every step, both reading the buffers in place from step 42 (K6 8 a step
    after the first: over the gathered rows, then over the 45-row buffers)
    and within 1e-4 of JAX's default kv stream."""
    _, _, model, frames = setup
    streams, jax_engaged = jax_streams
    _set(monkeypatch, env)
    s = vt.StreamingDepth(model, input_size=56, fp32=True, **kw)
    assert s.ctx_kernel and s._direct
    engaged = []
    ref, ref_orders = streams["direct"]
    for i, f in enumerate(frames):
        if i:
            order = list(s.order)
            ctx, _ = tstream._advance_bookkeeping(s.id + 1, order)
            engaged.append(s._direct_ok([tstream._row(c) for c in ctx]))
        d = s.submit(f).numpy()
        assert rel_err(ref[i], d) < TOL, i
        assert rel_err(streams["kv"][0][i], d) < TOL, i
        assert s.order == ref_orders[i], i
    assert engaged == jax_engaged
    assert engaged.index(True) == DIRECT_FROM - 1 and all(
        engaged[DIRECT_FROM - 1:])
    assert spies["direct"] == N_FRAMES - DIRECT_FROM
    assert spies["K6"] == 8 * (N_FRAMES - 1)
    assert float(np.abs(ref[-1]).max()) > 1e-2


def _stepped(model, frames, n, **kw):
    s = vt.StreamingDepth(model, input_size=56, fp32=True, **kw)
    for f in frames[:n]:
        s.submit(f)
    return s


def _fork(stream):
    """A second stream in ``stream``'s state, its own copy of the cache."""
    twin = vt.StreamingDepth(stream.model, input_size=56, fp32=True,
                             ctx_kernel=stream.ctx_kernel)
    twin.__dict__.update({k: v for k, v in stream.__dict__.items()
                          if not k.startswith("_upload")})
    twin.buffers = [b.clone() for b in stream.buffers]
    twin.order = list(stream.order)
    return twin


@pytest.fixture(scope="module")
def at_44(setup):
    """A ``ctx_kernel`` stream after 44 frames (two in-place steps done)."""
    _, _, model, frames = setup
    return _stepped(model, frames, 44, ctx_kernel=True)


def test_direct_group_matches_submits(setup, at_44, spies):
    """A ``ctx_kernel`` ``submit_group`` of 4 past step 42 runs as one
    in-place group (the rows written into the buffers frame by frame): it
    leaves the cache 4 in-place submits leave, bit for bit, with K6 8 a
    frame; the depths within GROUP_TOL."""
    _, _, _, frames = setup
    seq, grp = _fork(at_44), _fork(at_44)
    ref = [seq.submit(f) for f in frames[44:48]]
    assert spies["direct"] == 4
    got = grp.submit_group(frames[44:48])
    assert spies["direct"] == 4  # the group's own path
    assert spies["K6"] == 2 * 8 * 4
    assert got.shape == (4, 70, 90)
    assert seq.order == grp.order and seq.id == grp.id
    assert all(torch.equal(x, y) for x, y in zip(seq.buffers, grp.buffers))
    for a, b in zip(ref, got):
        assert rel_err(a.numpy(), b.numpy()) < GROUP_TOL


@pytest.mark.parametrize("env", [{}, {"VDA_STREAM_DIRECT": "1"}],
                         ids=["ctx_kernel", "with_direct_knob"])
@pytest.mark.parametrize("start", [1, 40], ids=["warmup", "across_42"])
def test_ctx_kernel_group_keeps_k6(setup, monkeypatch, spies, env, start):
    """A ``ctx_kernel`` group in which some frame's context cannot be read
    in place (the warmup, or a group across step 42) runs as submits, so
    K6 runs every step (8 a frame) and nothing takes the plain kv
    attention; depths and cache bit-identical to the submits."""
    _, _, model, frames = setup
    _set(monkeypatch, env)
    base = _stepped(model, frames, start, ctx_kernel=True)
    seq, grp = _fork(base), _fork(base)
    plain = []
    kv = ttemporal._temporal_attention_kv
    monkeypatch.setattr(ttemporal, "_temporal_attention_kv",
                        lambda *a, **k: plain.append(1) or kv(*a, **k))
    spies["K6"] = spies["direct"] = 0
    ref = [seq.submit(f) for f in frames[start:start + 4]]
    n_k6, n_direct = spies["K6"], spies["direct"]
    got = grp.submit_group(frames[start:start + 4])
    assert spies["K6"] == 2 * n_k6 == 2 * 8 * 4
    assert n_direct == (2 if start == 40 else 0)
    assert spies["direct"] == 2 * n_direct and not plain
    assert all(torch.equal(a, b) for a, b in zip(ref, got))
    assert seq.order == grp.order
    assert all(torch.equal(x, y) for x, y in zip(seq.buffers, grp.buffers))


def _set(mp, env):
    for k, v in env.items():
        mp.setenv(k, v)


# env, constructor keywords: resolved alike by both packages
RESOLUTION = [
    ({}, {}),
    ({"VDA_STREAM_CACHE_DTYPE": "int8"}, {}),
    ({"VDA_STREAM_CACHE_DTYPE": "int8"}, {"cache_dtype": "bf16"}),
    ({"VDA_STREAM_KV8": "1"}, {}),
    ({"VDA_STREAM_KV8": "1"}, {"ctx_kernel": True}),
    ({"VDA_STREAM_CTX_KERNEL": "1"}, {}),
    ({"VDA_STREAM_CTX_KERNEL": "1"}, {"cache_kind": "h"}),
    ({"VDA_STREAM_CTX_KERNEL": "1"}, {"ctx_kernel": False}),
    ({}, {"ctx_kernel": True}),
]


@pytest.mark.parametrize("env,kw", RESOLUTION, ids=str)
def test_knob_resolution_equals_jax(setup, monkeypatch, env, kw):
    """The cache dtype and ``ctx_kernel``, as JAX resolves them from the
    same knobs and keywords."""
    params, jcfg, model, _ = setup
    _set(monkeypatch, env)
    j = jstream.StreamingDepth(params, jcfg, input_size=56, fp32=True, **kw)
    t = vt.StreamingDepth(model, input_size=56, fp32=True, **kw)
    assert type(j) is jstream.StreamingDepth
    assert (t.cache_dtype, t.ctx_kernel) == (j.cache_dtype, j.ctx_kernel)
    assert t._direct == (t.ctx_kernel and t.cache_dtype == "bf16")


# JAX's direct knob: env, keywords, the port's (cache dtype, ctx_kernel,
# in-place read); JAX builds its direct flavour for each
DIRECT_KNOB = [
    ({"VDA_STREAM_DIRECT": "1"}, {}, ("bf16", True, True)),
    ({"VDA_STREAM_DIRECT": "1"}, {"ctx_kernel": False},
     ("bf16", False, False)),
    ({"VDA_STREAM_DIRECT": "1"}, {"cache_kind": "h"},
     ("bf16", False, False)),
    ({"VDA_STREAM_DIRECT": "1"}, {"attn_impl": "xla"},
     ("bf16", False, False)),
    ({"VDA_STREAM_DIRECT": "1", "VDA_STREAM_KV8": "1"}, {},
     ("int8", True, False)),
]


@pytest.mark.parametrize("env,kw,want", DIRECT_KNOB, ids=str)
def test_direct_knob_resolution(setup, monkeypatch, env, kw, want):
    """``VDA_STREAM_DIRECT=1`` turns on ``ctx_kernel`` where it applies (its
    stream reads in place where JAX's direct flavour does) and yields
    elsewhere, as JAX's knob does; an int8 cache gathers (K6 reads only
    rows in the working dtype in place)."""
    params, jcfg, model, _ = setup
    _set(monkeypatch, env)
    j = jstream.StreamingDepth(params, jcfg, input_size=56, fp32=True, **kw)
    assert type(j) is jexp.ExperimentalStreamingDepth
    t = vt.StreamingDepth(model, input_size=56, fp32=True, **kw)
    assert (t.cache_dtype, t.ctx_kernel, t._direct) == want


# refused by both packages: env, keywords
REFUSALS = [
    ({}, {"ctx_kernel": True, "cache_kind": "h"}),
    ({"VDA_STREAM_CTX_KERNEL": "1"}, {"ctx_kernel": True,
                                      "cache_kind": "h"}),
    ({"VDA_STREAM_CACHE_DTYPE": "fp8"}, {}),
]


@pytest.mark.parametrize("env,kw", REFUSALS, ids=str)
def test_refusals_equal_jax(setup, monkeypatch, env, kw):
    params, jcfg, model, _ = setup
    _set(monkeypatch, env)
    with pytest.raises(ValueError):
        jstream.StreamingDepth(params, jcfg, input_size=56, fp32=True, **kw)
    with pytest.raises(ValueError):
        vt.StreamingDepth(model, input_size=56, fp32=True, **kw)


@pytest.mark.parametrize("env", [
    {"VDA_STREAM_RING": "1"}, {"VDA_STREAM_SLIDE": "1"},
    {"VDA_STREAM_SLIDE": "1", "VDA_STREAM_SLIDE_ROWS": "56"},
    {"VDA_STREAM_RING": "1", "VDA_STREAM_DIRECT": "1"}], ids=str)
def test_layout_knobs_refused(setup, monkeypatch, env):
    """JAX's ring and sliding layouts are refused by name, with where their
    measurement is written; JAX builds them."""
    params, jcfg, model, _ = setup
    _set(monkeypatch, env)
    j = jstream.StreamingDepth(params, jcfg, input_size=56, fp32=True)
    assert type(j) is not jstream.StreamingDepth
    with pytest.raises(ValueError, match="PERF.md"):
        vt.StreamingDepth(model, input_size=56, fp32=True)


def test_in_place_read_needs_k6(setup):
    """``_temporal_attention_kv_direct`` raises where K6 is off or its gate
    refuses: no other path reads the buffers in place."""
    _, _, model, _ = setup
    attn = model.head.motion_modules[0].temporal_transformer \
        .transformer_blocks[0].attention_blocks[0]
    h = torch.zeros(6, 1, 32)
    cache = (torch.zeros(6, 45, 32), torch.zeros(6, 45, 32),
             torch.zeros(45, dtype=torch.int32),
             torch.ones(45, dtype=torch.uint8))
    with pytest.raises(ValueError, match="K6"):
        ttemporal._temporal_attention_kv_direct(attn, h, model.cfg, cache,
                                                kernels=False)
    with pytest.raises(ValueError, match="K6"):
        ttemporal._temporal_attention_kv_direct(
            attn, torch.zeros(6, 2, 32), model.cfg, cache)


def test_layout_helpers_equal_jax():
    """``_pos_map`` against JAX's over 300 steps of the bookkeeping, at every
    step whose context rows are distinct."""
    order = [0] * 32
    tstream._evict(0, order)
    n = 0
    for step in range(1, 300):
        ctx, _ = tstream._advance_bookkeeping(step, order)
        rows = [tstream._row(i) for i in ctx]
        if len(set(rows)) == len(rows):
            n += 1
            for a, b in zip(tstream._pos_map(rows),
                            jexp._pos_map(rows, tstream._BUF_ROWS)):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
    assert n == 300 - DIRECT_FROM


def test_fuse_proj_and_resize_knobs(setup, monkeypatch):
    """``VDA_ATTN_FUSE_PROJ`` / ``VDA_RESIZE_KERNEL`` are the defaults of
    ``fuse_proj`` / ``resize_kernel`` left at None where a call begins:
    ``infer_video_depth`` and ``StreamingDepth``; an explicit value wins,
    the knobs yield where the kernels are off, and the model functions
    take plain values, so ``forward`` does not read them."""
    _, _, model, frames = setup
    seen = []
    monkeypatch.setattr(twindowed, "_window_step",
                        lambda *a: seen.append(a[-2:]) or torch.zeros(
                            1, 32, 70, 90))
    enc, head = tvda.encode, tvda.dpt_head_temporal_apply
    monkeypatch.setattr(tvda, "encode", lambda *a, **k: seen.append(
        ("encode", a[4])) or enc(*a, **k))
    monkeypatch.setattr(tvda, "dpt_head_temporal_apply",
                        lambda *a, **k: seen.append(
                            ("head", k["resize_kernel"])) or head(*a, **k))
    x = torch.zeros(1, 2, 56, 56, 3)
    for env in ({}, {"VDA_ATTN_FUSE_PROJ": "1", "VDA_RESIZE_KERNEL": "1"}):
        with monkeypatch.context() as mp:
            _set(mp, env)
            on = bool(env)
            seen.clear()
            vt.infer_video_depth(model, frames[:4], 24, input_size=56)
            assert seen == [(on, on)]
            seen.clear()
            vt.infer_video_depth(model, frames[:4], 24, input_size=56,
                                 fuse_proj=False, resize_kernel=False)
            assert seen == [(False, False)]
            seen.clear()
            vt.infer_video_depth(model, frames[:4], 24, input_size=56,
                                 attn_impl="plain")
            assert seen == [(False, False)]
            seen.clear()
            tvda.forward(model, x)
            assert seen == [("encode", False), ("head", False)]
            assert vt.StreamingDepth(model).fuse_proj == on
            assert vt.StreamingDepth(model, fuse_proj=False).fuse_proj \
                is False
            assert knobs.fuse_proj(None, "xla") is False
            assert knobs.resize_kernel(None, "xla") == on


@pytest.fixture(scope="module")
def test_video(tmp_path_factory):
    """tests/test_torch_apps_stream.py's clip: 40 frames of 70x90."""
    import cv2

    path = str(tmp_path_factory.mktemp("vid") / "clip.mp4")
    rng = np.random.default_rng(0)
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 12, (90, 70))
    base = (rng.random((70, 90, 3)) * 255).astype(np.uint8)
    for i in range(40):
        w.write(np.roll(base, i * 2, axis=1)[:, :, ::-1].copy())
    w.release()
    return path


def _run_cli(model, test_video, tmp_path, monkeypatch, flags):
    built = []
    cls = trun_streaming.StreamingDepth

    def spy(*a, **k):
        s = cls(*a, **k)
        built.append((s.cache_dtype, s.ctx_kernel))
        return s

    monkeypatch.setattr(trun_streaming, "StreamingDepth", spy)
    monkeypatch.setattr(trun, "load_model", lambda args: (model.cfg, model))
    got = trun_streaming.main(["--input_video", test_video, "--output_dir",
                               str(tmp_path), "--input_size", "56",
                               "--fp32", "--max_len", "5", "--device",
                               "cpu"] + flags)
    return built, got


@pytest.mark.parametrize("env,flags,want", [
    ({"VDA_STREAM_DIRECT": "1"}, [], ("bf16", True)),
    ({"VDA_STREAM_CACHE_DTYPE": "int8"}, [], ("int8", False)),
    ({"VDA_STREAM_KV8": "1"}, ["--cache-dtype", "bf16"], ("bf16", False)),
    ({"VDA_STREAM_CTX_KERNEL": "1"}, ["--lookahead", "2"], ("bf16", True)),
], ids=["direct", "int8", "explicit", "ctx_kernel"])
def test_streaming_cli_reads_the_knobs(setup, test_video, tmp_path,
                                       monkeypatch, env, flags, want):
    """``--cache-dtype auto`` passes None, so the CLI's stream resolves its
    cache and K6 from the knobs as JAX's CLI does."""
    _, _, model, _ = setup
    _set(monkeypatch, env)
    built, got = _run_cli(model, test_video, tmp_path, monkeypatch, flags)
    assert built == [want]
    assert len(got) == 5 and all(np.isfinite(d).all() for d in got)


def test_streaming_cli_refuses_layout_knobs(setup, test_video, tmp_path,
                                            monkeypatch):
    _, _, model, _ = setup
    monkeypatch.setenv("VDA_STREAM_SLIDE", "1")
    with pytest.raises(ValueError, match="VDA_STREAM_SLIDE"):
        _run_cli(model, test_video, tmp_path, monkeypatch, [])
