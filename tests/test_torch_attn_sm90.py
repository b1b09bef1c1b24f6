"""K7 and K12 on the Hopper attention loop: their tables and loop rules
against their C sources, and K7's twin against the JAX package at vitl
widths.

K12's variant table (``probes/bench_attn_variants.py``, with ``mma_sync``)
and K7's design-step table (``probes/bench_attn_proj_sm90.py``) are held to
the lists their ``.cu`` sources give in their headers and to the cases
their entry points dispatch, by regex, as ``test_torch_gemm_sm90.py``
holds the GEMM table.  ``loop_of`` of K7 (``ops/attn_proj_kernel.py``) and
K12 ask the library; here the library is replaced by one whose loop
queries evaluate the C conditions parsed from the sources, so the Python
rule, the arguments it passes and the C condition are checked together,
and each entry point is held to dispatching on its query.

K7's twin is held to ``vda_tpu.ops.pallas_attention.flash_attention_qkv_proj``
(its Pallas kernel in interpret mode, tests/conftest.py) at vitl's widths,
16 heads of 64, over 130 tokens with keys masked past 100, batch 1 and 2:
fp32 within 2e-5 of the scale (summation order only), bf16 within 2e-2
(the JAX package's bound for its fused kernel, tests/test_attn_fuse_proj.py),
and the bf16 twin rounds the attention output to bf16 before the
projection, as the JAX kernel does: the rounding point the Hopper kernel
follows.  On the CPU the wrappers of K7, K12 and K7's design steps run
their twins and launch nothing.
"""

import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vda_tpu.ops import pallas_attention

import vda_tpu_torch.ops as tops
from vda_tpu_torch.ops import _build, attention_kernel, attn_proj_kernel
from vda_tpu_torch.probes import bench_attn_proj_sm90 as bp
from vda_tpu_torch.probes import bench_attn_variants as k12

from tests.torch_port import rel_err

KERNELS = [f"K{i}" for i in range(1, 15)]
BF = torch.bfloat16


def _source(name: str) -> str:
    with open(os.path.join(_build.CSRC, name)) as f:
        return f.read()


@pytest.fixture(autouse=True)
def counters_at_rest():
    tops.reset_launch_counts()
    bp.launches = 0
    yield
    assert tops.launch_counts() == dict.fromkeys(KERNELS, 0)
    assert bp.launches == 0
    assert k12.launches_by_loop == {"sm90": 0, "sm80": 0}
    assert attn_proj_kernel.launches_by_loop == {"sm90": 0, "sm80": 0}


# ---- tables against the sources ----

def _listed(header: str) -> dict:
    """name -> index of the ``//   i name  ...`` lines of a header."""
    return {name: int(i) for i, name in
            re.findall(r"^//\s+(\d+) (\w+)\s", header, re.M)}


def test_k12_variant_table_matches_the_source():
    """The probe's names and indices (``mma_sync`` too) are the ones
    attention_variants.cu lists, and its Hopper dispatch has a case for
    every variant but mma_sync, its old-loop dispatch one for each of 0-9
    and mma_sync maps onto the old loop's full."""
    src = _source("attention_variants.cu")
    header = src.split("#include")[0]
    listed = _listed(header.split("`variant`:")[1].split("The device loop")[0])
    assert listed == {name: idx for name, (idx, _) in k12.VARIANTS.items()}
    sm90 = sorted(int(i) for i in re.findall(r"VDA_SM90\((\d+),", src))
    sm90 += [int(i) for i in re.findall(
        r"case (\d+):\s+return sm90::launch_heads", src)]
    want90 = sorted(i for name, (i, _) in k12.VARIANTS.items()
                    if name != "mma_sync")
    assert sorted(sm90) == want90
    old = sorted(int(i) for i in re.findall(r"VDA_VARIANT\((\d+),", src))
    assert old == list(range(10))
    assert re.search(r"constexpr int kMmaSync = (\d+);", src).group(1) == \
        str(k12.VARIANTS["mma_sync"][0])
    assert "if (variant == kMmaSync) variant = 0;" in src
    # the geometry variants are 6-9 on both loops
    assert sorted(k12.VARIANTS[v][0] for v in k12.GEOMETRY) == [6, 7, 8, 9]


def test_k12_full_exp2_and_bk128_are_k1s_configuration():
    """full, exp2 and bk128 launch K1's own configuration (vda::SM90) on
    the Hopper loop: the same kernel, bit-identical with K1."""
    src = _source("attention_variants.cu")
    assert re.search(r"using Full90 = Local<SM90>;", src)
    for name in ("full", "exp2", "bk128"):
        idx = k12.VARIANTS[name][0]
        assert re.search(rf"VDA_SM90\({idx}, Full90\);", src), name
    sm90 = _source("flash_attention_sm90.cuh")
    assert re.search(r"using SM90 = sm90::Config<128, 3, 2, false, false, "
                     r"sm90::Mode::kFull, 0, true>;", sm90)
    assert "vda::sm90::launch<vda::SM90>" in _source("attention_qkv.cu")


def test_k7_design_step_table_matches_the_source():
    """The probe's names and indices are the ones
    attention_proj_sm90_variants.cu lists, its entry point has a case for
    each, and the default step launches K7's own configuration."""
    src = _source("attention_proj_sm90_variants.cu")
    listed = _listed(src.split("#include")[0])
    assert listed == bp.VARIANTS
    cases = sorted(int(i) for i in re.findall(r"case (\d+):", src))
    assert cases == sorted(bp.VARIANTS.values())
    default = re.search(r"case (\d+): return VDA_RUN\(vda::K7SM90\);", src)
    assert default and \
        int(default.group(1)) == bp.VARIANTS["split2_c3_pn64_v16"]
    assert "(vda::K7SM90)" in src.split("#include")[0]
    # the steps that run one phase alone are the Phases::kAttention and
    # kProjection configurations
    one_phase = sorted(int(i) for i in re.findall(
        r"case (\d+): return VDA_RUN\(HeadsConfig<[^>]*Phases::"
        r"k(?:Attention|Projection)", src))
    assert one_phase == sorted(bp.VARIANTS[v] for v in bp.EPILOGUE_ONLY)


# ---- loop rules against the C conditions ----

def _c_condition(src: str, fn: str) -> str:
    """The body ``return <cond> ? 90 : 80;`` of the C loop query ``fn``, as
    a Python expression."""
    body = re.search(rf'extern "C" int {fn}\(([^)]*)\) \{{\s*return (.*?) '
                     r'\? 90 : 80;\s*\}', src, re.S)
    assert body, fn
    cond = " ".join(body.group(2).split())
    cond = cond.replace("&&", " and ").replace("||", " or ")
    cond = cond.replace("vda::sm90::D", "64").replace("kMmaSync",
                                                      "MMA_SYNC")
    return cond


class _FakeLibrary:
    """The loop queries of the kernel library, evaluating the C conditions
    of the sources."""

    def __init__(self):
        self.conds = {
            "vda_attention_proj_loop": (
                ("d", "is_bf16"),
                _c_condition(_source("attention_proj.cu"),
                             "vda_attention_proj_loop")),
            "vda_attention_variant_loop": (
                ("d", "variant"),
                _c_condition(_source("attention_variants.cu"),
                             "vda_attention_variant_loop")),
            "vda_attention_loop": (
                ("d", "is_bf16"),
                _c_condition(_source("attention_qkv.cu"),
                             "vda_attention_loop")),
        }

    def __getattr__(self, name):
        args, cond = self.conds[name]
        env = {"MMA_SYNC": k12.VARIANTS["mma_sync"][0]}
        return lambda *vals: 90 if eval(cond, env, dict(zip(args, vals))) \
            else 80


@pytest.fixture
def fake_library(monkeypatch):
    monkeypatch.setattr(_build, "library", _FakeLibrary)
    for f in (attn_proj_kernel.loop_of, k12.loop_of,
              attention_kernel.loop_of):
        f.cache_clear()
    yield
    for f in (attn_proj_kernel.loop_of, k12.loop_of,
              attention_kernel.loop_of):
        f.cache_clear()


@pytest.mark.parametrize("dtype", [BF, torch.float32])
@pytest.mark.parametrize("dh", [8, 32, 40, 64, 80, 128])
def test_k7_loop_rule_is_the_c_condition(fake_library, dtype, dh):
    """K7: the Hopper kernel for bf16 at head width 64, the mma.sync / fp32
    kernels otherwise (K1's rule)."""
    want = "sm90" if dtype == BF and dh == 64 else "sm80"
    assert attn_proj_kernel.loop_of(dtype, dh) == want
    assert attention_kernel.loop_of(dtype, dh) == want


@pytest.mark.parametrize("variant", list(k12.VARIANTS))
@pytest.mark.parametrize("dh", [8, 40, 64, 80, 128])
def test_k12_loop_rule_is_the_c_condition(fake_library, variant, dh):
    """K12: every variant but mma_sync on the Hopper loop at head width 64,
    the mma.sync loop otherwise."""
    want = "sm90" if dh == 64 and variant != "mma_sync" else "sm80"
    assert k12.loop_of(dh, variant) == want


def test_entry_points_dispatch_on_their_loop_queries():
    """vda_attention_proj and vda_attention_variant take the Hopper path
    exactly when their loop query says 90, as vda_attention does."""
    proj = _source("attention_proj.cu")
    assert "if (vda_attention_proj_loop(d, is_bf16) == 90) {" in proj
    assert "vda::sm90::launch_heads<vda::K7SM90>(" in proj
    var = _source("attention_variants.cu")
    assert "if (vda_attention_variant_loop(d, variant) == 90)\n" \
           "    return vda::launch_sm90(" in var
    qkv = _source("attention_qkv.cu")
    assert "if (vda_attention_loop(d, is_bf16) == 90)" in qkv


# ---- K7's twin against the JAX package at vitl widths ----

def _inputs(b, n, c, seed):
    r = np.random.default_rng(seed)
    qkv = r.standard_normal((b, n, 3 * c)).astype(np.float32)
    w = (r.standard_normal((c, c)) * c ** -0.5).astype(np.float32)  # (in, out)
    gb = np.stack([1 + 0.5 * r.standard_normal(c),
                   0.1 * r.standard_normal(c)]).astype(np.float32)
    x = (0.1 * r.standard_normal((b, n, c))).astype(np.float32)
    return qkv, w, gb, x


def _t(a):
    return torch.from_numpy(np.array(a, np.float32, copy=True))


@pytest.mark.parametrize("dtype,tol", [("fp32", 2e-5), ("bf16", 2e-2)])
@pytest.mark.parametrize("b", [1, 2])
def test_k7_twin_matches_jax_at_vitl_widths(b, dtype, tol):
    """16 heads of 64 (C 1024) over 130 tokens, keys masked past 100."""
    heads, c, n, valid = 16, 1024, 130, 100
    qkv, w, gb, x = _inputs(b, n, c, seed=b)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "fp32"
                else (jnp.bfloat16, BF))
    ref = pallas_attention.flash_attention_qkv_proj(
        jnp.asarray(qkv, jdt), jnp.asarray(w, jdt), jnp.asarray(gb),
        jnp.asarray(x, jdt), heads, 64 ** -0.5, valid_len=valid)
    args = (_t(qkv).to(tdt), _t(w).t().contiguous().to(tdt), _t(gb),
            _t(x).to(tdt), heads, 0.125, valid)
    got = attn_proj_kernel.flash_attention_qkv_proj(*args)
    assert got.dtype == tdt and got.shape == (b, n, c)
    assert rel_err(np.asarray(ref, np.float32), got.float().numpy()) < tol
    # every design step but the one-phase ones computes the same function
    for variant in ("split2", "c2_bk64", "mma_sync"):
        assert torch.equal(bp.attn_proj(variant, *args), got)


def test_k7_bf16_twin_rounds_the_attention_output():
    """The bf16 twin projects the attention output rounded to bf16 (as the
    JAX kernel and the Hopper kernel's head-output tile do), not the fp32
    one: planting the fp32 output moves the result."""
    heads, c, n = 16, 1024, 130
    qkv, w, gb, x = _inputs(1, n, c, seed=3)
    qkv_t, w_t = _t(qkv).to(BF), _t(w).t().contiguous().to(BF)
    x_t, gb_t = _t(x).to(BF), _t(gb)
    got = attn_proj_kernel.flash_attention_qkv_proj_reference(
        qkv_t, w_t, gb_t, x_t, heads, 0.125)
    o = attention_kernel.flash_attention_qkv_reference(qkv_t, heads, 0.125)
    assert o.dtype == BF
    o32 = attention_kernel.flash_attention_qkv_reference(qkv_t.float(),
                                                         heads, 0.125)
    unrounded = (x_t.float() + gb_t[0] * (o32 @ w_t.float().t()
                                          + gb_t[1])).to(BF)
    rounded = (x_t.float() + gb_t[0] * (o.float() @ w_t.float().t()
                                        + gb_t[1])).to(BF)
    assert torch.equal(got, rounded)
    assert not torch.equal(got, unrounded)


@pytest.mark.parametrize("variant", list(bp.VARIANTS))
def test_k7_design_step_twins(variant):
    """On the CPU each step runs its twin: x + gamma * bias for the steps
    that run one phase alone, K7's twin for the others."""
    g = torch.Generator().manual_seed(0)
    qkv, w, gb, x = bp.inputs(g, 2, 70, 6)
    got = bp.attn_proj(variant, qkv, w, gb, x, 6, 0.125, 50)
    if variant in bp.EPILOGUE_ONLY:
        want = (x.float() + gb[0] * gb[1]).to(BF)
    else:
        want = attn_proj_kernel.flash_attention_qkv_proj_reference(
            qkv, w, gb, x, 6, 0.125, 50)
    assert torch.equal(got, want)
    ok, r = bp.agrees(variant, got, want)
    assert ok and r == 0.0


@pytest.mark.parametrize("b,n,c,by", [(32, 1370, 1024, "operations"),
                                      (1, 1370, 1024, "operations"),
                                      (1, 16, 384, "bytes")])
def test_k7_bound_at_the_probe_shapes(b, n, c, by):
    ms, bound_by = bp.bound_ms(b, n, c)
    n_bytes, n_ops = bp.cost(b, n, c)
    assert bound_by == by
    assert ms == pytest.approx(1e3 * max(n_bytes / 3.35e12, n_ops / 989e12))
    assert n_ops == 4 * b * n * n * c + 2 * b * n * c * c


def test_k12_mma_sync_twin_is_full():
    qkv = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (1, 100, 3 * 2 * 64)).astype(np.float32))
    assert torch.equal(k12.attn(qkv, 2, 0.125, "mma_sync"),
                       k12.attn(qkv, 2, 0.125, "full"))
