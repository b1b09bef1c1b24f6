"""K5's and K8's Hopper code on the CPU: their loop rules and design-step
tables against their C sources, K8's work table, the bounds the probe
prints, every step's twin, and K5's bf16 twin against the JAX package's
Pallas kernel.

``tiny_seq_kernel.loop_of`` and ``segment_kernel.loop_of`` ask the library;
here the library is replaced by one whose loop queries evaluate the C
conditions parsed from ``csrc/tiny_seq_attention.cu`` /
``csrc/segment_attention.cu`` and the Hopper code's ``takes`` in
``csrc/tiny_seq_sm90.cuh`` (translated, with the helpers it calls, from C
to Python), so the Python rule, the arguments it passes and the C condition
are checked together (as ``test_torch_stream_resize_sm90.py`` does for K6),
and the entry points are held to dispatching on the queries.

K8's work table is held to what the kernel assumes of it: every query row
in exactly one consumer's tile, each consumer's keys its own segment, and
the key tiles the kernel walks (64 or 128 rows over the span, or one at
each short segment's start) covering each segment's keys exactly once.

K5's bf16 twin is held to ``pallas_attention.tiny_seq_attention`` in
interpret mode (tests/conftest.py) at T 1 and 32 and head widths 8, 24, 128
and 192 (C 64, 192, 1024, 1536; 8 heads), within one bf16 ulp at the
output's scale
(``_ulp_of_scale``: 2^-7 of the binade of max |ref|): the two round at the
same points, but both round their output to bf16 after sums taken in
another order, so one rounding may flip by an ulp; an infinite value
planted in q gives NaN in the same places in both.  On the CPU the wrappers and the probe's steps run
their twins and launch nothing.
"""

import inspect
import math
import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vda_tpu.ops import pallas_attention

import vda_tpu_torch.ops as tops
from vda_tpu_torch.ops import _build, segment_kernel, tiny_seq_kernel
from vda_tpu_torch.probes import bench_short_attn_sm90 as bsa

KERNELS = [f"K{i}" for i in range(1, 15)]
BF = torch.bfloat16


def _ulp_of_scale(ref) -> float:
    """One bf16 ulp (8 significant bits) at max |ref|."""
    return 2.0 ** (math.floor(math.log2(float(np.abs(ref).max()))) - 7)


def _source(name: str) -> str:
    with open(os.path.join(_build.CSRC, name)) as f:
        return f.read()


@pytest.fixture(autouse=True)
def counters_at_rest():
    tops.reset_launch_counts()
    bsa.launches = 0
    yield
    assert tops.launch_counts() == dict.fromkeys(KERNELS, 0)
    assert tiny_seq_kernel.launches_by_loop == {"sm90": 0, "sm80": 0}
    assert segment_kernel.launches_by_loop == {"sm90": 0, "sm80": 0}
    assert bsa.launches == 0


# ---- the loop rules against the C conditions ----

def _python(expr: str) -> str:
    """A C expression of ints, comparisons, &&, ||, !, /, % and calls as
    Python (integer division; the operands are never negative)."""
    expr = " ".join(expr.split())
    expr = re.sub(r"static_cast<\w+>", "", expr)
    expr = re.sub(r"\bvda::\w+::", "", expr)
    expr = expr.replace("&&", " and ").replace("||", " or ")
    expr = re.sub(r"!(?!=)", " not ", expr)
    return expr.replace("/", "//").replace("true", "True").replace(
        "false", "False")


def _functions(src: str, names) -> dict:
    """name -> a Python function translated from the C function of that
    name in src: a body of ``if (cond) return expr;`` lines and a last
    ``return expr;``."""
    env = {"gcd": math.gcd}
    for const in re.findall(r"constexpr (?:int|size_t) (k\w+) = ([^;]+);",
                            src):
        env[const[0]] = eval(_python(const[1]), {}, env)
    for name in names:
        m = re.search(rf"\b{name}\(([^)]*)\) \{{(.*?)\n\}}", src, re.S)
        assert m, name
        params = [p.split()[-1] for p in m.group(1).split(",")]
        body = []
        for stmt in re.findall(r"(if \(.*?\) return [^;]+|return [^;]+);",
                               " ".join(m.group(2).split())):
            cond = re.match(r"if \((.*)\) return (.*)", stmt)
            if cond:
                body.append(f"    if {_python(cond.group(1))}: "
                            f"return {_python(cond.group(2))}")
            else:
                body.append(f"    return {_python(stmt[len('return '):])}")
        code = f"def {name}({', '.join(params)}):\n" + "\n".join(body)
        exec(code, env)
    return env


def _k5_takes():
    header = _source("tiny_seq_sm90.cuh")
    env = _functions(header, ["padded_rows", "group_heads", "smem_bytes",
                              "mma_width", "takes"])
    return env["takes"]


class _FakeLibrary:
    """The kernel library's loop queries, evaluating the C conditions."""

    def __init__(self):
        body = re.search(r'extern "C" int vda_tiny_seq_loop\(([^)]*)\) \{\s*'
                         r'return (.*?)\s*\? 90\s*: 80;\s*\}',
                         _source("tiny_seq_attention.cu"), re.S)
        assert " ".join(body.group(1).split()) == \
            "int t, int c, int heads, int is_bf16"
        assert " ".join(body.group(2).split()) == \
            "is_bf16 && vda::tiny90::takes(t, c, heads)"
        self.takes = _k5_takes()
        seg = re.search(r'extern "C" int vda_segment_loop\(([^)]*)\) \{\s*'
                        r'return (.*?)\s*\? 90\s*: 80;\s*\}',
                        _source("segment_attention.cu"), re.S)
        assert " ".join(seg.group(1).split()) == "int d, int is_bf16"
        assert " ".join(seg.group(2).split()) == \
            "is_bf16 && d == vda::seg90::D"
        self.d = int(re.search(r"constexpr int D = (\d+);",
                               _source("flash_attention_sm90.cuh")).group(1))

    def vda_tiny_seq_loop(self, t, c, heads, is_bf16):
        return 90 if is_bf16 and self.takes(t, c, heads) else 80

    def vda_segment_loop(self, d, is_bf16):
        return 90 if is_bf16 and d == self.d else 80


@pytest.fixture
def fake_library(monkeypatch):
    monkeypatch.setattr(_build, "library", _FakeLibrary)
    tiny_seq_kernel.loop_of.cache_clear()
    segment_kernel.loop_of.cache_clear()
    yield
    tiny_seq_kernel.loop_of.cache_clear()
    segment_kernel.loop_of.cache_clear()


# (T, C, heads, loop in bf16): the vits window's three shapes and the vitl
# stream's first step's four, vitb's widths, T 2 .. 64, vitg's mm0/mm1
# (head width 192) at T 32 and 64 and a tp=2 rank's (4 heads of 192), and
# what the Hopper code refuses (head widths off its instantiations at T >=
# 2: 1024, 256, 160, 112, 10; 16 heads of 4, C over 2048 at T = 1)
K5_LOOP_CASES = [
    (32, 64, 8, "sm90"), (32, 192, 8, "sm90"), (1, 1024, 8, "sm90"),
    (1, 256, 8, "sm90"), (32, 128, 8, "sm90"), (32, 384, 8, "sm90"),
    (2, 64, 8, "sm90"), (33, 256, 8, "sm90"), (64, 1024, 8, "sm90"),
    (64, 192, 8, "sm90"), (1, 192, 8, "sm90"), (1, 1536, 8, "sm90"),
    (32, 1536, 8, "sm90"), (64, 1536, 8, "sm90"), (32, 768, 4, "sm90"),
    (32, 1024, 1, "sm80"), (7, 80, 2, "sm80"), (32, 2048, 8, "sm80"),
    (32, 1280, 8, "sm80"), (1, 4096, 8, "sm80"), (32, 64, 16, "sm80"),
    (32, 24, 3, "sm80"), (64, 896, 8, "sm80"),
]


@pytest.mark.parametrize("dtype", [BF, torch.float32])
@pytest.mark.parametrize("t,c,heads,loop", K5_LOOP_CASES)
def test_k5_loop_of_is_the_c_condition(fake_library, dtype, t, c, heads,
                                       loop):
    """bf16 at the shapes the Hopper code takes: "sm90"; fp32 and the
    rest: the old kernel."""
    want = loop if dtype == BF else "sm80"
    assert tiny_seq_kernel.loop_of(dtype, t, c, heads) == want


def test_k5_takes_is_the_layout_that_fits():
    """The translated rule refuses exactly the mma path's items whose
    stages and output tiles outgrow a block's shared memory (dh 112: 7
    boxes an item at T 64) and takes vits's, vitl's and vitg's (head width
    192: 3 boxes an item, 197,648 bytes at T 64)."""
    takes = _k5_takes()
    assert takes(64, 896, 8) is False and takes(32, 896, 8) is False
    assert takes(64, 1024, 8) and takes(32, 192, 8) and takes(1, 24, 1)
    assert takes(32, 1536, 8) and takes(64, 1536, 8)


@pytest.mark.parametrize("dtype", [BF, torch.float32])
@pytest.mark.parametrize("d,loop", [(64, "sm90"), (16, "sm80"),
                                    (128, "sm80"), (8, "sm80")])
def test_k8_loop_of_is_the_c_condition(fake_library, dtype, d, loop):
    want = loop if dtype == BF else "sm80"
    assert segment_kernel.loop_of(dtype, d) == want


def test_entry_points_dispatch_on_the_loop_queries():
    """vda_tiny_seq_attention and vda_segment_attention run the Hopper code
    exactly when their loop query says 90 and the old kernels otherwise,
    nothing gives way to the other, and the wrappers count the loop the
    query names."""
    src = _source("tiny_seq_attention.cu")
    body = re.search(r'extern "C" int vda_tiny_seq_attention\(.*?\n\}', src,
                     re.S).group(0)
    assert ("if (vda_tiny_seq_loop(t, c, heads, is_bf16) == 90)\n"
            "    return vda::tiny90::launch<vda::tiny90::Mode::kFull>("
            in body)
    assert "return vda::tiny_seq_sm80(" in body and body.count("return") == 3
    src = _source("segment_attention.cu")
    body = re.search(r'extern "C" int vda_segment_attention\(.*?\n\}', src,
                     re.S).group(0)
    assert ("if (vda_segment_loop(d, is_bf16) == 90)\n"
            "    return vda::seg90::launch_for_span(" in body)
    assert "return vda::segment_sm80(" in body and body.count("return") == 2
    for name in ("tiny_seq_sm90.cuh", "segment_sm90.cuh",
                 "tiny_seq_attention.cu", "segment_attention.cu"):
        assert "try" not in re.sub(r"//[^\n]*", "", _source(name))
    assert ("launches_by_loop[loop_of(q.dtype, t, c, heads)] += 1"
            in inspect.getsource(tiny_seq_kernel.tiny_seq_attention))
    assert ("launches_by_loop[loop_of(q.dtype, d)] += 1"
            in inspect.getsource(segment_kernel.segment_attention))


# ---- the design-step tables against their sources ----

def _listed(src: str) -> dict:
    return {name: int(i) for i, name in re.findall(
        r"^//\s+(\d+) (\w+)\s", src.split("#include")[0], re.M)}


def _cases(src: str) -> dict:
    """index -> the function a case returns."""
    return {int(i): " ".join(fn.split()) for i, fn in re.findall(
        r"case (\d+): return ([\w:<>, ]+?)\(", src)}


def test_k5_step_table_matches_the_source():
    src = _source("tiny_seq_sm90_variants.cu")
    v = bsa.K5_VARIANTS
    assert _listed(src) == v
    assert _cases(src) == {
        v["old"]: "vda::tiny_seq_sm80",
        v["sm90"]: "launch<Mode::kFull>",
        v["loads"]: "launch<Mode::kLoads>",
        v["products"]: "launch<Mode::kProducts>",
        v["floor"]: "launch<Mode::kEmpty>"}
    header = _source("tiny_seq_sm90.cuh")
    assert "kLoads, kProducts and kEmpty\n// write no output" in header
    assert set(bsa.PARTS) == {"loads", "products", "floor"}
    assert bsa.K5_MMA_ONLY == ("products",)


def test_k8_step_table_matches_the_source():
    src = _source("segment_sm90_variants.cu")
    v = bsa.K8_VARIANTS
    assert _listed(src) == v
    assert _cases(src) == {
        v["old"]: "vda::segment_sm80",
        v["sm90"]: "launch_for_span",
        v["bk128"]: "launch<Config<128, 2>>",
        v["bk64"]: "launch<Config<64, 6>>",
        v["loads"]: "launch_for_span<Mode::kLoads>",
        v["products"]: "launch_for_span<Mode::kProducts>"}
    header = _source("segment_sm90.cuh")
    # the entry point's configurations are the steps' two
    assert "launch<Config<64, 6, M>>" in header
    assert "launch<Config<128, 2, M>>" in header
    assert re.search(r"constexpr int kShortSpan = 1024;", header)
    assert bsa.K8_TABLES == {"unmixed": ("sm90", 192)}


def _k5_inputs(shape):
    return bsa.inputs(torch.Generator().manual_seed(sum(shape)), "K5", shape)


@pytest.mark.parametrize("shape", [(9, 32, 64), (5, 1, 256), (4, 7, 192)])
def test_k5_steps_run_their_twins_on_the_cpu(shape):
    ins = _k5_inputs(shape)
    ref = tiny_seq_kernel.tiny_seq_attention_reference(
        ins["q"], ins["k"], ins["v"], bsa.HEADS5, ins["scale"])
    for step in bsa.k5_steps(shape[1]):
        got = bsa.variant(step, ins)
        assert torch.equal(got, bsa.twin(step, ins))
        if step in bsa.PARTS:
            assert not got.any()
        else:
            assert torch.equal(got, ref)
    assert "products" not in bsa.k5_steps(1)


def test_k8_steps_run_their_twins_on_the_cpu():
    lengths = (70, 50, 50, 3)
    ins = bsa.inputs(torch.Generator().manual_seed(1), "K8", lengths)
    ref = segment_kernel.segment_attention_reference(
        ins["q"].float(), ins["k"].float(), ins["v"].float(), bsa.HEADS8,
        ins["scale"], lengths)
    for step in [*bsa.K8_VARIANTS, *bsa.K8_TABLES]:
        got = bsa.variant(step, ins)
        if step in bsa.PARTS:
            assert not got.any()
        else:
            assert torch.equal(got, ref)


# ---- K8's work table ----

def _ragged(seed=0, n=200):
    r = np.random.default_rng(seed)
    return tuple(int(x) for x in r.integers(1, 400, n))


TABLE_LENGTHS = [(1,), (63, 64, 65), (257,) * 3 + (50,) * 9, (1370,) * 2,
                 _ragged(), (257,) * 64 + (50,) * 256, (64,) * 7,
                 (65, 1, 1, 1, 300)]


@pytest.mark.parametrize("lengths", TABLE_LENGTHS,
                         ids=lambda x: f"{len(x)}segs")
def test_k8_work_table_covers_every_row_once(lengths):
    """Every query row lies in exactly one consumer's tile (so every (row,
    head) once: every item runs for every head), each consumer's keys are
    its own segment, its tile inside it, and the key tiles the kernel walks
    for it cover its segment's keys exactly once, at either tile size."""
    table = segment_kernel.work_table(lengths)
    starts = np.concatenate([[0], np.cumsum(lengths)])
    seg_of = np.repeat(np.arange(len(lengths)), lengths)
    total = int(starts[-1])
    seen = np.zeros(total, int)
    assert table.shape[1] == 4 + 4 * segment_kernel.CONSUMERS
    for row in table:
        k0, nk, own, n_own = (int(x) for x in row[:4])
        cons = [tuple(int(x) for x in row[4 + 4 * c:8 + 4 * c])
                for c in range(segment_kernel.CONSUMERS)]
        active = [c for c in cons if c[1] > 0]
        # the active consumers come first; the idle ones are all zero
        assert cons[:len(active)] == active
        assert all(c == (0, 0, 0, 0) for c in cons[len(active):])
        assert n_own == (len(active) if own else 0)
        for q0, qn, ks, ke in active:
            assert 0 < qn <= segment_kernel.TILE
            s = seg_of[q0]
            assert (ks, ke) == (starts[s], starts[s + 1])
            assert ks <= q0 and q0 + qn <= ke
            assert k0 <= ks and ke <= k0 + nk <= total
            seen[q0:q0 + qn] += 1
            for bk in (64, 128):
                covered = np.zeros(total, int)
                if own:
                    assert ke - ks <= segment_kernel.TILE
                    tiles = [ks]
                else:
                    tiles = range(k0, k0 + nk, bk)
                for tile0 in tiles:
                    lo, hi = max(ks, tile0), min(ke, tile0 + bk)
                    covered[lo:max(lo, hi)] += 1
                assert (covered[ks:ke] == 1).all()
                assert covered.sum() == ke - ks
        if len({c[2] for c in active}) > 1:  # several segments: a short span
            assert nk <= segment_kernel.MIX_SPAN or own
    assert (seen == 1).all()


def test_k8_work_table_packs_the_multi_crop_batch():
    """The multi-crop batch: three 50-row segments an item with a key tile
    each, and the tiles of 257-row segments three to an item with none
    idle but the last."""
    lengths = (257,) * 64 + (50,) * 256
    table = segment_kernel.work_table(lengths)
    active = (table[:, 5::4] > 0).sum(1)
    assert len(table) == 192 and (active[:-1] == 3).all()
    assert table[:, 2].sum() == 85  # items of three 50-row segments
    assert segment_kernel._device_items(lengths, torch.device("cpu"))[1] \
        == 514
    # without mixing (the probe's "unmixed"): a 257-row segment's last item
    # holds two tiles
    unmixed = segment_kernel.work_table(lengths, 192)
    assert len(unmixed) == 214 and ((unmixed[:, 5::4] > 0).sum(1) == 2).sum() \
        == 64


# ---- the bounds the probe prints ----

@pytest.mark.parametrize("case,want", [
    ("vits_mm3", 0.0268), ("vits_mm2", 0.0067), ("vits_mm0", 0.0201),
    ("step0_mm0", 0.0033), ("step0_mm1", 0.0009), ("step0_mm2", 0.0008),
    ("step0_mm3", 0.0033), ("vitg_mm0", 0.1607), ("vitg_mm1", 0.0424)])
def test_k5_bounds(case, want):
    ms, by = bsa.bound_ms("K5", bsa.K5_SHAPES[case])
    assert by == "bytes" and ms == pytest.approx(want, abs=5e-5)


def test_k8_bounds():
    ms, by = bsa.bound_ms("K8", bsa.K8_SHAPES["multi_crop"])
    assert by == "bytes" and ms == pytest.approx(0.0715, abs=5e-5)
    ms, by = bsa.bound_ms("K8", bsa.K8_SHAPES["32x1370"])
    assert by == "operations" and ms == pytest.approx(0.2487, abs=5e-5)


# ---- K5's bf16 twin against the Pallas kernel ----

def _pallas_vs_twin(bd, t, dh, plant=False):
    heads = 8
    c = heads * dh
    r = np.random.default_rng(bd + t + dh)
    qkv = r.standard_normal((bd, t, 3 * c)).astype(np.float32)
    if plant:
        qkv[3, 0, 5] = np.inf
        qkv[9, t - 1, c - 1] = -np.inf
    jx = jnp.asarray(qkv, jnp.bfloat16)
    scale = dh ** -0.5
    ref = pallas_attention.tiny_seq_attention(
        jx[..., :c], jx[..., c:2 * c], jx[..., 2 * c:], heads, t, scale)
    tq = torch.from_numpy(np.asarray(jx, np.float32)).to(BF)
    got = tiny_seq_kernel.tiny_seq_attention(
        *tq.split(c, dim=-1), heads, scale)
    assert got.dtype == BF and got.shape == (bd, t, c)
    return np.asarray(ref, np.float32), got.float().numpy()


@pytest.mark.parametrize("t", [1, 32])
@pytest.mark.parametrize("dh", [8, 24, 128, 192])
def test_k5_bf16_twin_matches_pallas(t, dh):
    ref, got = _pallas_vs_twin(16, t, dh)
    assert np.isfinite(got).all()
    assert np.abs(ref - got).max() <= _ulp_of_scale(ref)


@pytest.mark.parametrize("dh", [8, 128])
def test_k5_nan_rows_match_pallas_at_t1(dh):
    """At T = 1 an infinite q value makes its head's output NaN in both
    (the one-key softmax is computed, not skipped), and only there."""
    ref, got = _pallas_vs_twin(16, 1, dh, plant=True)
    nan = np.isnan(ref)
    assert nan.any() and (np.isnan(got) == nan).all()
    heads_hit = nan.reshape(16, 1, 8, dh).any(-1)
    assert heads_hit.sum() == 2  # the two planted heads, whole
    assert nan.reshape(16, 1, 8, dh)[heads_hit].all()
    assert np.abs(ref[~nan] - got[~nan]).max() <= _ulp_of_scale(ref[~nan])
