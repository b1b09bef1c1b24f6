"""The measurement kernels' twins (K12, K13, K14) against the JAX package's
measurement scripts.

``scripts/bench_attn_variants.py``, ``scripts/bench_int8_pallas.py`` and
``scripts/probe_stream_kernel.py`` pass no ``interpret=`` to
``pl.pallas_call``, so each is loaded here as a module of its own whose
``pl`` is swapped for a namespace that runs ``pallas_call`` in interpret
mode; nothing in ``scripts/`` changes.  Loading the first two enables JAX's
persistent compilation cache, so ``VDA_COMPILE_CACHE`` points at a
temporary directory first and the JAX configuration is restored after.

On the CPU each port wrapper runs its twin.  Tolerances, as max |twin -
script| over max |script|: 2e-5 where no bf16 rounding enters (K12's
``matmul`` and ``fp32exp`` on fp32 input: summation order only); 3.9e-3
where exp or an output is rounded to bf16 (docs/PARITY.md:107); K13 int8
exactly, bf16 within 2^-8 of the scale.
"""

import functools
import importlib.util
import os
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

import vda_tpu_torch.ops as tops
from vda_tpu_torch.probes import bench_attn_variants as k12
from vda_tpu_torch.probes import bench_int8 as k13
from vda_tpu_torch.probes import probe_stream_kernel as k14

from tests.torch_port import rel_err

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNELS = [f"K{i}" for i in range(1, 15)]
CACHE_KEYS = ("jax_compilation_cache_dir",
              "jax_persistent_cache_min_compile_time_secs",
              "jax_persistent_cache_min_entry_size_bytes")


def _reset_cache():
    try:
        from jax._src import compilation_cache
        compilation_cache.reset_cache()
    except (ImportError, AttributeError):
        pass


@pytest.fixture(scope="module")
def scripts(tmp_path_factory):
    """The three scripts, loaded with an interpreting ``pl``."""
    saved = {k: getattr(jax.config, k) for k in CACHE_KEYS}
    env = os.environ.get("VDA_COMPILE_CACHE")
    os.environ["VDA_COMPILE_CACHE"] = str(tmp_path_factory.mktemp("jax_cache"))
    interp = types.SimpleNamespace(
        pallas_call=functools.partial(pl.pallas_call, interpret=True),
        BlockSpec=pl.BlockSpec, CostEstimate=pl.CostEstimate)
    mods = {}
    try:
        for name in ("bench_attn_variants", "bench_int8_pallas",
                     "probe_stream_kernel"):
            spec = importlib.util.spec_from_file_location(
                f"_script_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            mod.pl = interp
            mods[name] = mod
        yield mods
    finally:
        if env is None:
            os.environ.pop("VDA_COMPILE_CACHE", None)
        else:
            os.environ["VDA_COMPILE_CACHE"] = env
        for k, v in saved.items():
            jax.config.update(k, v)
        _reset_cache()


@pytest.fixture(autouse=True)
def counters_at_rest():
    tops.reset_launch_counts()
    yield
    assert tops.launch_counts() == dict.fromkeys(KERNELS, 0)


# (JAX attn keywords, the port's variant, tolerance)
K12_CASES = {
    "full": (dict(), "full", 3.9e-3),
    "mma_sync": (dict(), "mma_sync", 3.9e-3),  # the old loop's full
    "matmul": (dict(mode="matmul"), "matmul", 2e-5),
    "nomask": (dict(mode="nomask"), "nomask", 3.9e-3),
    "fp32exp": (dict(exp_dtype="fp32"), "fp32exp", 2e-5),
    "bf16sm": (dict(mode="bf16sm"), "bf16sm", 3.9e-3),
    "exp2": (dict(mode="exp2"), "exp2", 3.9e-3),
    # JAX's geometry against the port's: the same function as full
    "g8": (dict(g_heads=8), "heads2", 3.9e-3),
    "g2": (dict(g_heads=2), "heads2", 3.9e-3),
    "bq128": (dict(block_q=128), "bq128", 3.9e-3),
    "bq32_np256": (dict(block_q=32, np_len=256), "bk128", 3.9e-3),
}


@pytest.mark.parametrize("case", list(K12_CASES))
def test_k12_attention_variants_match_the_script(scripts, case):
    """Every mode at qkv (1, 100, 3 x 16 x 8) (the script's 16 heads), keys
    padded to np_len=128, block_q=64 unless the case sets another."""
    kw, variant, tol = K12_CASES[case]
    kw = dict(dict(block_q=64, np_len=128), **kw)
    qkv = np.random.default_rng(7).standard_normal(
        (1, 100, 3 * 16 * 8)).astype(np.float32)
    ref = np.asarray(scripts["bench_attn_variants"].attn(jnp.asarray(qkv),
                                                         **kw))
    assert ref.shape == (1, kw["np_len"], 16 * 8)
    got = k12.attn(torch.from_numpy(qkv), 16, 8 ** -0.5, variant,
                   np_len=kw["np_len"] if variant == "nomask" else None)
    assert got.shape == (1, 100, 16 * 8)
    assert rel_err(ref[:, :100], got.numpy()) < tol


def test_k12_nomask_counts_the_padded_keys(scripts):
    """nomask's function depends on the padded key count (zero keys take
    part), and differs from full."""
    qkv = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (1, 100, 3 * 16 * 8)).astype(np.float32))
    a = k12.attn(qkv, 16, 8 ** -0.5, "nomask", np_len=128)
    b = k12.attn(qkv, 16, 8 ** -0.5, "nomask", np_len=192)
    full = k12.attn(qkv, 16, 8 ** -0.5, "full")
    assert rel_err(a.numpy(), b.numpy()) > 1e-3
    assert rel_err(full.numpy(), a.numpy()) > 1e-3


@pytest.fixture
def small_k13(scripts, monkeypatch):
    mod = scripts["bench_int8_pallas"]
    for name, value in dict(M=64, K=64, N=128, BM=32, BN=64).items():
        monkeypatch.setattr(mod, name, value)
    return mod


def test_k13_int8_matches_the_script_exactly(small_k13):
    rng = np.random.default_rng(9)
    x = rng.integers(-127, 127, (64, 64)).astype(np.int8)
    w = rng.integers(-127, 127, (64, 128)).astype(np.int8)
    ref = np.asarray(small_k13.matmul(jnp.asarray(x), jnp.asarray(w),
                                      jnp.int32, jnp.int32))
    got = k13.matmul(torch.from_numpy(x), torch.from_numpy(w))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(ref, x.astype(np.int64) @ w.astype(np.int64))


def test_k13_bf16_matches_the_script(small_k13):
    rng = np.random.default_rng(10)
    x, w = (jnp.asarray(rng.standard_normal(s), jnp.bfloat16)
            for s in ((64, 64), (64, 128)))
    ref = np.asarray(small_k13.matmul(x, w, jnp.bfloat16, jnp.float32))
    got = k13.matmul(*(torch.from_numpy(np.asarray(t, np.float32))
                       .to(torch.bfloat16) for t in (x, w)))
    assert got.dtype == torch.bfloat16
    assert rel_err(ref.astype(np.float32), got.float().numpy()) < 2.0 ** -8


@pytest.fixture(scope="module")
def k14_inputs(scripts):
    """The script's make_inputs(), as the port's tensors."""
    q, kn, vn, kb, vb, pe, valid = scripts["probe_stream_kernel"].make_inputs()
    return tuple(torch.from_numpy(np.asarray(t, np.float32)).to(
        torch.bfloat16) for t in (q, kn, vn, kb, vb, pe)) + (
        torch.from_numpy(np.asarray(valid)),)


def test_k14_inputs_equal_the_script(k14_inputs):
    for ref, got in zip(k14_inputs, k14.make_inputs(device="cpu")):
        assert ref.dtype == got.dtype and torch.equal(ref, got)


@pytest.mark.parametrize("stage", list(k14.STAGES))
def test_k14_stages_match_the_script(scripts, k14_inputs, stage):
    feats = k14.STAGES[stage]
    ref = np.asarray(scripts["probe_stream_kernel"].simple_kernel(set(feats)))
    got = k14.simple_kernel(feats, k14_inputs)
    assert got.shape == ref.shape == (k14.BHW, k14.C)
    assert torch.isfinite(got.float()).all()
    assert rel_err(ref.astype(np.float32), got.float().numpy()) < 3.9e-3


def test_k14_refuses_feature_sets_it_has_no_stage_for():
    meta = [torch.empty(s, device="meta", dtype=torch.bfloat16)
            for s in ((32, 256),) * 3 + ((32, 43, 256),) * 2 + ((43, 256),)]
    with pytest.raises(ValueError):
        k14.simple_kernel(("pe",), (*meta, torch.ones(43, dtype=torch.bool)))
