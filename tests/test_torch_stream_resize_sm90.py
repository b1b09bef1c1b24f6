"""K6's Hopper loop and K10's Hopper kernel on the CPU: K6's loop rule and
both design-step tables against their C sources, every step's twin, the
bounds the probes print, K6's bf16 twin against the JAX package's Pallas
kernel, and the ``ctx_kernel`` path's one flag tensor per context length.

``stream_kernel.loop_of`` asks the library; here the library is replaced
by one whose loop query evaluates the C condition parsed from
``csrc/stream_kv_attention.cu`` and the Hopper loop's ``takes`` in
``csrc/stream_kv_sm90.cuh`` (the rule its launcher checks too), so the
Python rule, the arguments it passes and the C condition are checked
together (as
``test_torch_temporal_sm90.py`` does for K3/K4), and the entry point is held
to dispatching on the query.

K6's bf16 twin is held to ``pallas_stream.stream_kv_attention`` in
interpret mode (tests/conftest.py) at vitl's two stream widths, C 1024 and
256, 8 heads, 31 rows and 32 positions (a multiple of its ``ROW_TILE``),
within 2e-2 of the output's scale: the repo's bound for the stream flavours
(tests/test_streaming_ctx_kernel.py), which bf16 rounding of the encoding
adds and of exp, in another summation order, stays well inside.  On the CPU
the wrappers and the probes' steps run their twins and launch nothing.
"""

import inspect
import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vda_tpu.ops import pallas_stream

import vda_tpu_torch.ops as tops
from vda_tpu_torch.ops import _build, resize_kernel, stream_kernel
from vda_tpu_torch.probes import bench_resize_sm90 as br
from vda_tpu_torch.probes import bench_stream_sm90 as bs

from tests.torch_port import rel_err

KERNELS = [f"K{i}" for i in range(1, 15)]
BF = torch.bfloat16
CPU = torch.device("cpu")


def _source(name: str) -> str:
    with open(os.path.join(_build.CSRC, name)) as f:
        return f.read()


@pytest.fixture(autouse=True)
def counters_at_rest():
    tops.reset_launch_counts()
    bs.launches = br.launches = 0
    yield
    assert tops.launch_counts() == dict.fromkeys(KERNELS, 0)
    assert stream_kernel.launches_by_loop == {"sm90": 0, "sm80": 0}
    assert bs.launches == br.launches == 0


# ---- K6's loop rule against the C condition ----

def _python(cond: str) -> str:
    cond = " ".join(cond.split())
    return cond.replace("&&", " and ").replace("||", " or ").replace(
        "/", "//")


def _c_condition() -> str:
    """The body of ``vda_stream_kv_loop`` as a Python expression: bf16 and
    the body of ``stream90::takes``, the launcher's own rule."""
    body = re.search(r'extern "C" int vda_stream_kv_loop\(([^)]*)\) \{\s*'
                     r'return (.*?)\s*\? 90\s*: 80;\s*\}',
                     _source("stream_kv_attention.cu"), re.S)
    assert body and " ".join(body.group(1).split()) == \
        "int c, int heads, int is_bf16"
    assert " ".join(body.group(2).split()) == \
        "is_bf16 && vda::stream90::takes(c, heads)"
    header = _source("stream_kv_sm90.cuh")
    takes = re.search(r"inline bool takes\(int c, int heads\) \{\s*"
                      r"return (.*?);\s*\}", header, re.S)
    assert takes
    # the launcher refuses what the rule does not take
    assert "if (bhw <= 0 || rows < 0 || !takes(c, heads))" in header
    return f"is_bf16 and ({_python(takes.group(1))})"


class _FakeLibrary:
    """The kernel library's loop query, evaluating the C condition."""

    def __init__(self):
        self.cond = _c_condition()

    def vda_stream_kv_loop(self, c, heads, is_bf16):
        env = dict(c=c, heads=heads, is_bf16=is_bf16)
        return 90 if eval(self.cond, {}, env) else 80


@pytest.fixture
def fake_library(monkeypatch):
    monkeypatch.setattr(_build, "library", _FakeLibrary)
    stream_kernel.loop_of.cache_clear()
    yield
    stream_kernel.loop_of.cache_clear()


# (C, heads, loop in bf16): vitl mm0/mm1 and mm2/mm3, vitb, vits, vitg,
# the card tests' other shapes, the widths past the Hopper loop's 128
LOOP_CASES = [
    (1024, 8, "sm90"), (256, 8, "sm90"), (768, 8, "sm90"), (128, 8, "sm90"),
    (384, 8, "sm90"), (192, 8, "sm90"), (64, 8, "sm90"), (1536, 12, "sm90"),
    (384, 6, "sm90"), (96, 12, "sm90"), (32, 4, "sm90"), (1024, 1, "sm80"),
    (512, 1, "sm80"), (1536, 8, "sm80"), (1024, 4, "sm80"),
]


@pytest.mark.parametrize("dtype", [BF, torch.float32])
@pytest.mark.parametrize("c,heads,loop", LOOP_CASES)
def test_loop_of_is_the_c_condition(fake_library, dtype, c, heads, loop):
    """bf16 at head widths a multiple of 8 up to 128: the Hopper loop; fp32
    and wider heads: the old kernel."""
    want = loop if dtype == BF else "sm80"
    assert stream_kernel.loop_of(dtype, c, heads) == want


def test_entry_point_dispatches_on_the_loop_query():
    """vda_stream_kv_attention runs the Hopper loop exactly when
    vda_stream_kv_loop says 90 and the old kernel otherwise, nothing gives
    way to the other, and the wrapper counts the loop the query names."""
    src = _source("stream_kv_attention.cu")
    body = re.search(r'extern "C" int vda_stream_kv_attention\(.*?\n\}', src,
                     re.S).group(0)
    assert ("if (vda_stream_kv_loop(c, heads, is_bf16) == 90)\n"
            "    return vda::stream90::launch<vda::stream90::kFull>(" in body)
    assert "return vda::stream_kv_sm80(" in body
    assert body.count("return") == 2
    for name in ("stream_kv_attention.cu", "stream_kv_sm90.cuh",
                 "resize_bilinear.cu", "resize_sm90.cuh"):
        assert "try" not in re.sub(r"//[^\n]*", "", _source(name))
    wrapper = inspect.getsource(stream_kernel.stream_kv_attention)
    assert "launches_by_loop[loop_of(q.dtype, c, heads)] += 1" in wrapper
    resize = re.search(r'extern "C" int vda_resize_bilinear\(.*?\n\}',
                       _source("resize_bilinear.cu"), re.S).group(0)
    assert "return launch<kFull>(" in resize


# ---- the design-step tables against their sources ----

def _listed(src: str) -> dict:
    return {name: int(i) for i, name in re.findall(
        r"^//\s+(\d+) (\w+)\s", src.split("#include")[0], re.M)}


def _cases(src: str) -> dict:
    """index -> the function a case returns."""
    return {int(i): fn for i, fn in re.findall(
        r"case (\d+): return ([\w:<>, ]+?)\(", src)}


def test_k6_step_table_matches_the_source():
    src = _source("stream_kv_sm90_variants.cu")
    v = bs.VARIANTS
    assert _listed(src) == v
    assert _cases(src) == {
        v["sm80"]: "vda::stream_kv_sm80",
        v["sm90"]: "launch<kFull>",
        v["loads"]: "launch<kLoads>",
        v["no_pe"]: "launch<kNoPe>",
        v["no_value_sum"]: "launch<kNoValueSum>",
        v["read_linear"]: "read_linear",
        v["k_ahead"]: "ahead::launch"}
    # the steps that write nothing are the parts whose kernel skips the store
    header = _source("stream_kv_sm90.cuh")
    assert "kLoads and kNoValueSum write no output" in header
    assert set(bs.PARTS) == {"loads", "no_value_sum", "read_linear"}


def test_k10_step_table_matches_the_source():
    src = _source("resize_sm90_variants.cu")
    v = br.VARIANTS
    assert _listed(src) == v
    assert _cases(src) == {
        v["sm90"]: "launch<kFull>",
        v["loads"]: "launch<kLoads>",
        v["stores"]: "launch<kStores>"}
    assert re.search(rf"case {v['old']}: \{{.*?"
                     r"resize_sm80_kernel<<<", src, re.S)
    # the kernel it replaced lives in the probe's source alone
    assert "resize_sm80_kernel" not in _source("resize_bilinear.cu")
    assert "resize_sm80_kernel" not in _source("resize_sm90.cuh")


def _k6_inputs(bhw=16, rows=31, c=256):
    return bs.inputs(torch.Generator().manual_seed(bhw + rows + c), bhw,
                     rows, c)


@pytest.mark.parametrize("step", list(bs.VARIANTS))
def test_k6_steps_run_their_twins_on_the_cpu(step):
    ins = _k6_inputs()
    got = bs.variant(step, ins)
    assert torch.equal(got, bs.twin(step, ins))
    ref = stream_kernel.stream_kv_attention_reference(
        ins["q"], ins["kn"], ins["vn"], ins["kb"], ins["vb"], ins["pk"],
        ins["pv"], ins["valid"], bs.HEADS, ins["scale"])
    if step in bs.PARTS:
        assert not got.any()
    elif step == "no_pe":
        assert not torch.equal(got, ref)  # the encodings left out
    else:
        assert torch.equal(got, ref)


@pytest.mark.parametrize("step", list(br.VARIANTS))
def test_k10_steps_run_their_twins_on_the_cpu(step):
    x = torch.randn(8, 9, 7, 128, generator=torch.Generator().manual_seed(3))
    x = x.to(BF)
    got = br.variant(step, x, (14, 13))
    assert torch.equal(got, br.twin(step, x, (14, 13)))
    if step in br.PARTS:
        assert not got.any()
    else:
        assert torch.equal(
            got, resize_kernel.resize_bilinear_fused_reference(x, (14, 13)))


def test_k6_split_path_computes_the_function():
    """The split path the probe times beside K6 computes K6's function (in
    fp32 here: exp not rounded to bf16)."""
    ins = {k: (v.float() if torch.is_tensor(v) and v.is_floating_point()
               else v) for k, v in _k6_inputs(8, 31, 1024).items()}
    got = bs.split_path(ins)
    ref = stream_kernel.stream_kv_attention_reference(
        ins["q"], ins["kn"], ins["vn"], ins["kb"], ins["vb"], ins["pk"],
        ins["pv"], ins["valid"], bs.HEADS, ins["scale"])
    assert rel_err(ref.numpy(), got.numpy()) < 1e-5


# ---- the bounds the probes print ----

@pytest.mark.parametrize("module,want", [("mm0", 0.0553), ("mm1", 0.0146),
                                         ("mm2", 0.0138), ("mm3", 0.0553)])
def test_k6_bounds(module, want):
    """The bounds at the four stream shapes to four decimals, within one in
    the last (mm3's 0.05525 ms is written 0.0553 beside mm0's)."""
    ms, by = bs.bound_ms(*bs.SHAPES[module])
    assert by == "bytes" and ms == pytest.approx(want, abs=1e-4)


@pytest.mark.parametrize("i,want", [(0, 0.268), (1, 0.435)])
def test_k10_bounds(i, want):
    ms, by = br.bound_ms(*br.SHAPES[i])
    assert by == "bytes" and ms == pytest.approx(want, abs=5e-4)


# ---- K6's bf16 twin against the Pallas kernel ----

@pytest.mark.parametrize("c,n_valid", [(1024, 31), (256, 31), (256, 19)])
def test_k6_bf16_twin_matches_pallas(c, n_valid):
    r = np.random.default_rng(c + n_valid)
    bhw, rows, heads = 32, 31, 8
    assert bhw % pallas_stream.ROW_TILE == 0
    arrs = [r.standard_normal(s).astype(np.float32) for s in
            [(bhw, c)] * 3 + [(bhw, rows, c)] * 2 + [(rows, c)] * 2]
    valid = np.zeros(rows, bool)
    valid[r.permutation(rows)[:n_valid]] = True
    scale = (c // heads) ** -0.5
    jx = [jnp.asarray(a, jnp.bfloat16) for a in arrs]
    ref = pallas_stream.stream_kv_attention(*jx, jnp.asarray(valid),
                                            heads=heads, scale=scale)
    tx = [torch.from_numpy(np.asarray(a, np.float32)).to(BF) for a in jx]
    got = stream_kernel.stream_kv_attention(*tx, torch.from_numpy(valid),
                                            heads, scale)
    assert got.dtype == BF and got.shape == (bhw, c)
    assert rel_err(np.asarray(ref, np.float32), got.float().numpy()) < 2e-2


# ---- the ctx_kernel path's flags ----

def test_all_valid_is_one_tensor_per_key():
    a = stream_kernel.all_valid(31, CPU)
    assert stream_kernel.all_valid(31, CPU) is a
    assert a.dtype == torch.uint8 and a.shape == (31,) and bool(a.all())
    assert stream_kernel.all_valid(30, CPU) is not a
    ins = _k6_inputs(8, 31, 256)
    args = [ins[k] for k in ("q", "kn", "vn", "kb", "vb", "pk", "pv")]
    ones = torch.ones(31, dtype=torch.bool)
    assert torch.equal(
        stream_kernel.stream_kv_attention(*args, a, bs.HEADS, ins["scale"]),
        stream_kernel.stream_kv_attention(*args, ones, bs.HEADS,
                                          ins["scale"]))


def test_ctx_path_passes_the_cached_flags(monkeypatch):
    """Every K6 call of a ctx_kernel stream gets the one cached flag tensor
    of its context length: no flags are made per call."""
    import vda_tpu_torch as vt

    from tests.torch_port import small_configs

    seen = []
    real = stream_kernel.stream_kv_attention

    def spy(*args):
        seen.append(args[7])
        return real(*args)

    monkeypatch.setattr(stream_kernel, "stream_kv_attention", spy)
    model = vt.init_random(small_configs()[1], torch.Generator(), "cpu")
    frames = (np.random.default_rng(0).random((3, 56, 56, 3)) * 255).astype(
        np.uint8)
    stream = vt.StreamingDepth(model, input_size=56, fp32=True,
                               ctx_kernel=True)
    for f in frames:
        stream.submit(f)
    assert seen, "the ctx path never reached K6"
    assert all(v is stream_kernel.all_valid(v.shape[0], CPU) for v in seen)
