"""K3 and K4 on the Hopper chain: the loop rule and the design-step table
against their C sources, each stage's plain twin against the JAX package,
and the chain's twins against the Pallas kernels at vitl widths.

``temporal_kernel.loop_of`` asks the library; here the library is replaced
by one whose loop query evaluates the C condition parsed from
``csrc/temporal_block.cu``, so the Python rule, the arguments it passes and
the C condition are checked together (as ``test_torch_attn_sm90.py`` does
for K7), and the entry points are held to dispatching on the query.

The stage twins (``ln_ape_reference``, ``qkv_reference``,
``seq_attention_reference``, ``residual_reference``, ``geglu_reference``)
are held to the JAX package's own pieces of ``pallas_temporal`` (``_ln``,
``_mm`` and the lines of ``_attention`` / ``_block_kernel``), in bf16 with
the rounding points checked: the twin agrees with JAX bit for bit on all
but a few elements (summation order), where a twin without the rounding
point differs on far more.  The chain's twins (``attention_sub_stages``,
``temporal_block_stages``) and the wrappers' CPU paths are held to the
Pallas kernels in interpret mode (tests/conftest.py) at vitl widths: C=256
and C=1024, 8 heads, T=32, BD 5 (not a multiple of the GEMM's 128-row
tile): fp32 within 2e-5 (summation order), bf16 within 2e-2 (the JAX
package's bound for its fused temporal kernels, tests/test_pallas_temporal.py).
On the CPU the wrappers and the probe's steps run their twins and launch
nothing.
"""

import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vda_tpu.config import get_config
from vda_tpu.models import temporal as jtemporal
from vda_tpu.ops import pallas_temporal

import vda_tpu_torch.ops as tops
from vda_tpu_torch.ops import _build, temporal_kernel
from vda_tpu_torch.ops.layers import gelu
from vda_tpu_torch.probes import bench_temporal_sm90 as bt

from tests.test_torch_kernels import _port_block
from tests.torch_port import rel_err

KERNELS = [f"K{i}" for i in range(1, 15)]
BF = torch.bfloat16


def _source(name: str) -> str:
    with open(os.path.join(_build.CSRC, name)) as f:
        return f.read()


@pytest.fixture(autouse=True)
def counters_at_rest():
    tops.reset_launch_counts()
    bt.launches = bt.stage_launches = 0
    yield
    assert tops.launch_counts() == dict.fromkeys(KERNELS, 0)
    assert temporal_kernel.launches_by_loop == {
        "K3": {"sm90": 0, "sm80": 0}, "K4": {"sm90": 0, "sm80": 0}}
    assert bt.launches == bt.stage_launches == 0


# ---- the loop rule against the C condition ----

def _c_condition() -> str:
    """The body of ``vda_temporal_loop`` as a Python expression."""
    body = re.search(r'extern "C" int vda_temporal_loop\(([^)]*)\) \{\s*'
                     r'return (.*?)\s*\? 90\s*: 80;\s*\}',
                     _source("temporal_block.cu"), re.S)
    assert body
    cond = " ".join(body.group(2).split())
    return cond.replace("&&", " and ").replace("||", " or ").replace(
        "/", "//")


class _FakeLibrary:
    """The kernel library's loop query, evaluating the C condition."""

    def __init__(self):
        self.cond = _c_condition()

    def vda_temporal_loop(self, c, heads, t, is_bf16, full):
        env = dict(c=c, heads=heads, t=t, is_bf16=is_bf16, full=full)
        return 90 if eval(self.cond, {}, env) else 80


@pytest.fixture
def fake_library(monkeypatch):
    monkeypatch.setattr(_build, "library", _FakeLibrary)
    temporal_kernel.loop_of.cache_clear()
    yield
    temporal_kernel.loop_of.cache_clear()


# (C, heads, T, full, loop in bf16): vitl mm0-mm3, vitb (C 768 and 128),
# vits (C 384), the card tests' other shapes
LOOP_CASES = [
    (1024, 8, 32, False, "sm90"), (256, 8, 32, True, "sm90"),
    (768, 8, 32, False, "sm90"), (128, 8, 32, True, "sm90"),
    (384, 8, 32, True, "sm90"), (512, 8, 64, True, "sm90"),
    (1024, 8, 64, False, "sm90"), (640, 8, 32, False, "sm90"),
    (896, 56, 7, False, "sm90"), (128, 8, 20, True, "sm90"),
    (256, 32, 32, True, "sm80"), (384, 48, 40, True, "sm80"),
    (1024, 1, 32, False, "sm80"), (1024, 4, 32, False, "sm80"),
    (1024, 8, 65, False, "sm80"), (640, 8, 32, True, "sm80"),
]


@pytest.mark.parametrize("dtype", [BF, torch.float32])
@pytest.mark.parametrize("c,heads,t,full,loop", LOOP_CASES)
def test_loop_of_is_the_c_condition(fake_library, dtype, c, heads, t, full,
                                    loop):
    """bf16 at head widths a multiple of 16 up to 128, T <= 64 (K3 to C
    512, K4 to 1024): the Hopper chain; fp32 and the rest: the old
    kernels."""
    want = loop if dtype == BF else "sm80"
    assert temporal_kernel.loop_of(dtype, c, heads, t, full) == want


def test_entry_points_dispatch_on_the_loop_query():
    """K3's and K4's entry points and the workspace query take the Hopper
    chain exactly when vda_temporal_loop says 90, and nothing gives way to
    the old kernels."""
    src = _source("temporal_block.cu")
    run = re.search(r"cudaError_t run_block\(.*?\n\}", src, re.S).group(0)
    assert ("if (vda_temporal_loop(a.c, a.heads, a.seq, is_bf16, full) == 90)"
            in run)
    assert ("if (full && vda::temporal_fused::takes(a.c, a.heads, a.seq))\n"
            "      return vda::temporal_fused::launch<vda::TF90>(a, st);"
            in run)
    assert "temporal_block<vda::TB90>(a, st)" in run
    assert "attention_block<vda::TB90>(a, st)" in run
    assert "return vda::temporal_sm80(a, full, is_bf16, st);" in run
    for entry in ("vda_attention_block", "vda_temporal_block"):
        body = re.search(rf'extern "C" int {entry}\(.*?\n\}}', src,
                         re.S).group(0)
        assert "return run_block(a, " in body
    ws = re.search(r'extern "C" int vda_temporal_workspace\(.*?\n\}', src,
                   re.S).group(0)
    assert "if (vda_temporal_loop(c, heads, seq, is_bf16, full) == 90)" in ws
    assert "full && vda::temporal_fused::takes(c, heads, seq)" in ws
    for name in ("temporal_block.cu", "temporal_sm90.cuh",
                 "temporal_fused_sm90.cuh"):
        assert "try" not in re.sub(r"//[^\n]*", "", _source(name))


# ---- the design-step table against its source ----

def test_design_step_table_matches_the_source():
    """The probe's step names and indices are the ones
    temporal_sm90_variants.cu lists, its entry point has a case for each,
    the default step is the entry points' own configuration (TB90, K13's),
    the fused steps are K3's alone, and the stage indices are those of
    vda_temporal_stage, which lives beside the steps and not in the
    model's library source."""
    src = _source("temporal_sm90_variants.cu")
    listed = {name: int(i) for i, name in re.findall(
        r"^//\s+(\d+) (\w+)\s", src.split("#include")[0], re.M)}
    assert listed == bt.VARIANTS
    cases = dict(re.findall(r"case (\d+): return (\S+)\(", src))
    assert sorted(int(i) for i in cases) == sorted(bt.VARIANTS.values())
    assert cases[str(bt.VARIANTS["sm80"])] == "vda::temporal_sm80"
    assert re.search(rf"case {bt.VARIANTS['chain']}: return "
                     r"chain<vda::TB90>\(", src)
    header = _source("temporal_sm90.cuh")
    tb90 = re.search(r"using TB90 = (gemm90::Config<[^>]*>);", header)
    k13 = re.search(r"using GEMM90 =\s*(gemm90::Config<[^>]*>);",
                    _source("int8_matmul.cu"))
    assert tb90 and k13 and tb90.group(1) == k13.group(1)
    assert re.search(rf"case {bt.VARIANTS['fused']}: return "
                     r"fused<vda::TF90>\(", src)
    assert re.search(rf"case {bt.VARIANTS['fused_cl1']}: return "
                     r"fused<vda::TF90_CL1>\(", src)
    for name, cfg in (("fused_products", "TF90_SKIP<skip::kProducts>"),
                      ("fused_loads", "TF90_SKIP<skip::kLoads>"),
                      ("fused_split", "TF90_SPLIT"),
                      ("fused_lag", "TF90_LAG"),
                      ("fused_no_norm", "TF90_SKIP<skip::kNorm>"),
                      ("fused_no_attn", "TF90_SKIP<skip::kAttention>"),
                      ("fused_no_geglu", "TF90_SKIP<skip::kGeglu>"),
                      ("fused_no_resid", "TF90_SKIP<skip::kResidual>")):
        assert re.search(rf"case {bt.VARIANTS[name]}: return "
                         rf"fused<vda::{re.escape(cfg)}>\(", src), name
    assert set(bt.K3_ONLY) == {"fused", "fused_cl1", "fused_split",
                               "fused_lag", *bt.PARTS}
    assert set(bt.PARTS) == {n for n in bt.VARIANTS
                             if n.startswith("fused_") and n not in
                             ("fused_cl1", "fused_split", "fused_lag")}
    assert "vda_temporal_stage" not in _source("temporal_block.cu")
    stage = src.split(
        'extern "C" int vda_temporal_stage')[0].rsplit("// One stage", 1)[1]
    listed = {name: int(i) for i, name in re.findall(
        r"^//\s+(\d+) (\w+)\s", stage, re.M)}
    assert listed == {k: v for k, v in bt.STAGES.items() if k != "ffo"}
    assert bt.STAGES["ffo"] == bt.STAGES["residual"]


# ---- the stage twins against the JAX package, rounding points checked ----

def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32, copy=True)).to(dtype)


def _j(a, dtype):
    return jnp.asarray(np.asarray(a, np.float32)).astype(dtype)


def _same(ref, got) -> float:
    """Share of elements equal bit for bit."""
    return float((np.asarray(jnp.asarray(ref).astype(jnp.float32))
                  == got.float().numpy()).mean())


def _case(seed, *shapes):
    r = np.random.default_rng(seed)
    return [r.standard_normal(s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("c", [256, 1024])
def test_ln_ape_twin_matches_jax(c):
    """LN (eps 1e-5, fp32 statistics) rounded to bf16, the APE rounded to
    bf16 and added in bf16 (``_ln(h) + pe`` of ``_attention``)."""
    x, w, b, pe = _case(c, (5, 32, c), (c,), (c,), (32, c))
    x = 2 * x + 0.5
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, BF)):
        ref = pallas_temporal._ln(_j(x, jdt), jnp.asarray(w),
                                  jnp.asarray(b)) + _j(pe, jdt)
        got = temporal_kernel.ln_ape_reference(_t(x, tdt), _t(w), _t(b),
                                               _t(pe))
        assert got.dtype == tdt
        assert rel_err(np.asarray(ref, np.float32), got.float().numpy()) < (
            2e-5 if tdt == torch.float32 else 2e-2)
    assert _same(ref, got) > 0.999
    unrounded = (temporal_kernel.layer_norm_reference(
        _t(x, BF).float(), _t(w), _t(b), 1e-5) + _t(pe)).to(BF)
    assert _same(ref, unrounded) < 0.9


def _attention_jax(qkv, heads, seq):
    """The attention lines of ``pallas_temporal._attention`` over a (rows,
    3C) tile of whole sequences: block-diagonal masked scores, bf16 exp of
    the bf16 difference, fp32 row sums, the division after P v."""
    rows, c3 = qkv.shape
    c = c3 // 3
    d = c // heads
    same = (jnp.arange(rows)[:, None] // seq) == (jnp.arange(rows)[None]
                                                  // seq)
    outs = []
    for hh in range(heads):
        s = jax.lax.dot_general(
            qkv[:, hh * d:(hh + 1) * d], qkv[:, c + hh * d:c + (hh + 1) * d],
            (((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32) * d ** -0.5
        s = jnp.where(same, s, -jnp.inf)
        m = jnp.max(s, axis=-1, keepdims=True)
        e = (jnp.exp((s - m).astype(jnp.bfloat16))
             if qkv.dtype == jnp.bfloat16 else jnp.exp(s - m))
        z = jnp.sum(e.astype(jnp.float32), axis=-1, keepdims=True)
        vh = qkv[:, 2 * c + hh * d:2 * c + (hh + 1) * d]
        outs.append((pallas_temporal._mm(e.astype(vh.dtype), vh)
                     / z).astype(qkv.dtype))
    return jnp.concatenate(outs, axis=-1)


@pytest.mark.parametrize("c", [256, 1024])
def test_seq_attention_twin_matches_jax(c):
    (qkv,) = _case(c + 1, (5, 32, 3 * c))
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, BF)):
        ref = _attention_jax(_j(qkv.reshape(160, 3 * c), jdt), 8, 32)
        got = temporal_kernel.seq_attention_reference(_t(qkv, tdt), 8)
        assert got.shape == (5, 32, c) and got.dtype == tdt
        got = got.reshape(160, c)
        assert rel_err(np.asarray(ref, np.float32), got.float().numpy()) < (
            2e-5 if tdt == torch.float32 else 2e-2)
    assert _same(ref, got) > 0.999
    # normalised before P v, as the unfused path does: another function
    from vda_tpu_torch.ops.attention import attention_plain

    q, k, v = (x.reshape(5, 32, 8, c // 8) for x in _t(qkv, BF).split(c, -1))
    early = attention_plain(q, k, v, (c // 8) ** -0.5).reshape(160, c)
    assert _same(ref, early) < 0.9


@pytest.mark.parametrize("c", [256, 1024])
def test_residual_twin_matches_jax(c):
    """h + bf16(o W^T + b): the out-projection's and the feed-forward's
    epilogue (``_attention``'s last line, ``_block_kernel``'s)."""
    o, w, b, h = _case(c + 2, (160, c), (c, c), (c,), (160, c))
    w *= c ** -0.5
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, BF)):
        hj = _j(h, jdt)
        ref = hj + (pallas_temporal._mm(_j(o, jdt), _j(w.T, jdt))
                    + jnp.asarray(b)).astype(jdt)
        got = temporal_kernel.residual_reference(_t(o, tdt), _t(w, tdt),
                                                 _t(b), _t(h, tdt))
        assert got.dtype == tdt
        assert rel_err(np.asarray(ref, np.float32), got.float().numpy()) < (
            2e-5 if tdt == torch.float32 else 2e-2)
    assert _same(ref, got) > 0.999
    unrounded = (_t(h, BF).float() + _t(o, BF).float() @ _t(w, BF).float().t()
                 + _t(b)).to(BF)
    assert _same(ref, unrounded) < 0.9


@pytest.mark.parametrize("c", [256, 384])
def test_geglu_twin_matches_jax(c):
    """x1 * gelu(gate) of bf16(hn W^T + b) (``_block_kernel``), the GELU's
    tanh form in bf16 computed in fp32 and rounded once (JAX rounds each of
    its steps: the two agree within 2e-2 and on most elements)."""
    hn, w, b = _case(c + 3, (160, c), (8 * c, c), (8 * c,))
    w *= c ** -0.5
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, BF)):
        x12 = (pallas_temporal._mm(_j(hn, jdt), _j(w.T, jdt))
               + jnp.asarray(b)).astype(jdt)
        ref = x12[:, :4 * c] * jax.nn.gelu(x12[:, 4 * c:],
                                           approximate=jdt == jnp.bfloat16)
        got = temporal_kernel.geglu_reference(_t(hn, tdt), _t(w, tdt),
                                              _t(b))
        assert got.shape == (160, 4 * c) and got.dtype == tdt
        assert rel_err(np.asarray(ref, np.float32), got.float().numpy()) < (
            2e-5 if tdt == torch.float32 else 2e-2)
    x12 = (_t(hn, BF).float() @ _t(w, BF).float().t() + _t(b))
    x1, gate = x12.chunk(2, -1)
    unrounded = (x1 * torch.nn.functional.gelu(gate, approximate="tanh")
                 ).to(BF)
    assert _same(ref, got) > _same(ref, unrounded) + 0.1
    assert torch.equal(got, x12.to(BF).chunk(2, -1)[0]
                       * gelu(x12.to(BF).chunk(2, -1)[1]))


# ---- the chain's twins against the Pallas kernels at vitl widths ----

def _setup(c, bd, seed):
    cfg = get_config("vitl")
    bp = jtemporal.init_temporal_module(jax.random.PRNGKey(seed), c,
                                        cfg)["blocks"][0]
    h = np.random.default_rng(seed).standard_normal((bd, 32, c))
    return bp, h.astype(np.float32), jtemporal._sinusoidal_pe(32, c)


@pytest.mark.parametrize("dtype,tol", [("fp32", 2e-5), ("bf16", 2e-2)])
def test_k3_chain_twin_matches_pallas(dtype, tol):
    """K3 at vitl's mm2/mm3 width (C=256, 8 heads, T=32), BD 5."""
    bp, h, pe = _setup(256, 5, seed=31)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "fp32"
                else (jnp.bfloat16, BF))
    ref = pallas_temporal.temporal_block_fused(
        bp, jnp.asarray(h).astype(jdt), jnp.asarray(pe), heads=8, seq=32)
    block = _port_block(bp, 256)
    pe_t = _t(pe)
    for got in (temporal_kernel.temporal_block_stages(block, _t(h, tdt),
                                                      pe_t, 8),
                temporal_kernel.temporal_block_fused(block, _t(h, tdt),
                                                     pe_t, 8),
                bt.variant("chain", block, _t(h, tdt), pe_t, True)):
        assert got.dtype == tdt and got.shape == (5, 32, 256)
        assert rel_err(np.asarray(ref, np.float32), got.float().numpy()) < tol


@pytest.mark.parametrize("dtype,tol", [("fp32", 2e-5), ("bf16", 2e-2)])
def test_k4_chain_twin_matches_pallas(dtype, tol):
    """K4 at vitl's mm0/mm1 width (C=1024, 8 heads, T=32), BD 5."""
    bp, h, pe = _setup(1024, 5, seed=41)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "fp32"
                else (jnp.bfloat16, BF))
    ref = pallas_temporal.attention_block_fused(
        bp["attn"][0], bp["norms"][0], jnp.asarray(h).astype(jdt),
        jnp.asarray(pe), heads=8, seq=32)
    block = _port_block(bp, 1024)
    attn, norm, pe_t = block.attention_blocks[0], block.norms[0], _t(pe)
    for got in (temporal_kernel.attention_sub_stages(attn, norm, _t(h, tdt),
                                                     pe_t, 8),
                temporal_kernel.attention_block_fused(attn, norm, _t(h, tdt),
                                                      pe_t, 8),
                bt.variant("sm80", block, _t(h, tdt), pe_t, False)):
        assert got.dtype == tdt and got.shape == (5, 32, 1024)
        assert rel_err(np.asarray(ref, np.float32), got.float().numpy()) < tol


def test_probe_stages_run_their_twins_on_the_cpu():
    """Each stage the probe times, on its inputs in a small block: the
    stage twin, and the chain's stages compose to the chain's twin."""
    g = torch.Generator().manual_seed(0)
    blk = bt.block(g, 256)
    from vda_tpu_torch.models.temporal import sinusoidal_pe

    pe = sinusoidal_pe(32, 256)[0]
    h = torch.randn(3, 32, 256, generator=g).to(BF)
    cases = bt.stage_inputs(blk, h, pe, True)
    assert sorted(cases) == sorted(bt.COUNT["K3"])
    for name, (args, want) in cases.items():
        assert torch.equal(bt.stage(name, True, *args, 32), want)
    x, lw, lb = cases["ln"][0][:3]
    o = cases["residual"][0][0]
    wo, bo = cases["residual"][0][1:3]
    one = bt.stage("residual", True, o, wo, bo, x, None, 32)
    assert torch.equal(
        one.reshape(3, 32, 256),
        temporal_kernel.attention_sub_stages(blk.attention_blocks[0],
                                             blk.norms[0], h, pe, 8))


# ---- the bounds at the probe shapes ----

@pytest.mark.parametrize("kernel,bd,c,ms", [
    ("K3", 5476, 256, 0.47608), ("K3", 1369, 256, 0.11902),
    ("K4", 1369, 1024, 0.37738), ("K4", 361, 1024, 0.09951)])
def test_bounds_at_the_probe_shapes(kernel, bd, c, ms):
    """Operations bind all four: K3 40 C^2 + 8 T C a row, K4 8 C^2 + 4 T C
    (the products and the attention), at 989 TFLOP/s."""
    got, by = bt.bound_ms(kernel, bd, 32, c)
    assert by == "operations"
    assert got == pytest.approx(ms, rel=1e-4)
    per_row = 40 * c * c + 8 * 32 * c if kernel == "K3" else \
        8 * c * c + 4 * 32 * c
    assert bt.cost(kernel, bd, 32, c)[1] == bd * 32 * per_row
    assert (kernel, bd, 32, c) in bt.SHAPES
