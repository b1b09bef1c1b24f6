"""The port's host-side copies equal their JAX-package originals, and the port
imports neither JAX nor ``vda_tpu``."""

import ast
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

import vda_tpu.config as jconfig
from vda_tpu.infer import stitching as jstitch
from vda_tpu.infer.windowed import window_source_indices as jwindows
from vda_tpu.ops import pallas_attention as jpallas_attention
from vda_tpu.ops import pallas_resize as jpallas_resize
from vda_tpu.ops import resize as jresize

import vda_tpu_torch.config as tconfig
from vda_tpu_torch.infer import stitching as tstitch
from vda_tpu_torch.infer.windowed import window_source_indices as twindows
from vda_tpu_torch.ops import attn_proj_kernel as tattn_proj
from vda_tpu_torch.ops import resize as tresize
from vda_tpu_torch.ops import resize_kernel as tresize_kernel
from vda_tpu_torch.probes import bench_attn_variants as tk12
from vda_tpu_torch.probes import bench_int8 as tk13
from vda_tpu_torch.probes import probe_stream_kernel as tk14
from vda_tpu_torch.utils import transform as ttransform
from vda_tpu.utils import transform as jtransform

from tests.torch_port import resize_gate_cases

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONSTANTS = ["INFER_LEN", "OVERLAP", "KEYFRAMES", "INTERP_LEN", "ALIGN_LEN",
             "KF_ALIGN_LIST", "STREAM_GAP", "STREAM_MAX_CACHE",
             "NUM_CACHE_TENSORS", "PATCH_SIZE", "IMAGENET_MEAN",
             "IMAGENET_STD", "MAX_ASPECT_RATIO"]


@pytest.mark.parametrize("name", CONSTANTS)
def test_config_constants_equal(name):
    assert getattr(tconfig, name) == getattr(jconfig, name)


@pytest.mark.parametrize("name", sorted(jconfig.MODEL_CONFIGS))
def test_model_configs_equal(name):
    j, t = jconfig.MODEL_CONFIGS[name], tconfig.MODEL_CONFIGS[name]
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert [f.name for f in dataclasses.fields(t)] == \
        [f.name for f in dataclasses.fields(j)]
    assert sorted(tconfig.MODEL_CONFIGS) == sorted(jconfig.MODEL_CONFIGS)
    assert tconfig.checkpoint_name(name) == jconfig.checkpoint_name(name)


@pytest.mark.parametrize("n_frames", [1, 5, 22, 32, 40, 54, 100, 111])
def test_window_source_indices_equal(n_frames):
    np.testing.assert_array_equal(twindows(n_frames), jwindows(n_frames))


@pytest.mark.parametrize("metric", [False, True])
def test_stitch_windows_equal(metric):
    rng = np.random.default_rng(3)
    depths = [rng.random((6, 7)).astype(np.float32) + 0.1
              for _ in range(3 * tconfig.INFER_LEN)]
    got = tstitch.stitch_windows(depths, metric=metric)
    ref = jstitch.stitch_windows(depths, metric=metric)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("builder", ["_linear_matrix", "_cubic_matrix"])
@pytest.mark.parametrize("args", [(37, 74, True, None), (296, 518, True, None),
                                  (70, 56, False, None), (4, 5, False, 1.3),
                                  (1, 3, True, None), (9, 1, True, None)])
def test_resize_matrices_equal(builder, args):
    np.testing.assert_array_equal(getattr(tresize, builder)(*args),
                                  getattr(jresize, builder)(*args))


@pytest.mark.parametrize("hw", [(70, 90), (1080, 1920), (480, 270), (50, 200)])
def test_resize_policy_equal(hw):
    for size in (56, 518):
        assert ttransform.effective_input_size(*hw, size) == \
            jtransform.effective_input_size(*hw, size)
        assert ttransform.compute_resize_hw(*hw, size) == \
            jtransform.compute_resize_hw(*hw, size)


@pytest.mark.parametrize("args", [(37, 74, True, None), (296, 518, True, None),
                                  (148, 296, True, None),
                                  (70, 56, False, None),
                                  (4, 5, False, 1.3), (1, 3, True, None),
                                  (9, 1, True, None), (8, 16, True, None)])
def test_lerp_tables_equal(args):
    for got, ref in zip(tresize._lerp_tables(*args),
                        jresize._lerp_tables(*args)):
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("out_h", [14, 16, 28, 32, 37, 56, 74, 148, 296, 518,
                                   7, 9, 1])
def test_pick_block_equal(out_h):
    assert tresize_kernel._pick_block(out_h) == \
        jpallas_resize._pick_block(out_h)


@pytest.mark.parametrize("n", [17, 530, 1370, 1376, 1408, 2000, 4097])
@pytest.mark.parametrize("heads,dh", [(16, 64), (24, 64), (6, 64), (12, 64),
                                      (4, 256), (8, 12), (3, 20)])
def test_attn_proj_fits_equal(n, heads, dh):
    assert tattn_proj.attn_proj_fits(n, heads, dh) == \
        jpallas_attention.attn_proj_fits(n, heads, dh)
    assert tattn_proj.attn_proj_fits(n, heads, dh, 4) == \
        jpallas_attention.attn_proj_fits(n, heads, dh, 4)


@pytest.mark.parametrize("case", resize_gate_cases(), ids=str)
def test_resize_gate_logic_equal(monkeypatch, case):
    """K10's gate is JAX's ``supported`` without its environment switch:
    with the switch on, the two agree on every case of the grid."""
    import jax
    import jax.numpy as jnp
    import torch

    monkeypatch.setenv("VDA_RESIZE_KERNEL", "1")
    shape, out_hw, ac, scale, f32 = case
    jx = jax.ShapeDtypeStruct(shape, jnp.float32 if f32 else jnp.bfloat16)
    tx = torch.empty(shape, dtype=torch.float32 if f32 else torch.bfloat16,
                     device="meta")
    assert tresize_kernel.supported(tx, out_hw, ac, scale) == \
        jpallas_resize.supported(jx, out_hw, ac, scale)


def _script_constants(name):
    """Top-level literal assignments of ``scripts/<name>.py``, read from its
    source (importing it would enable JAX's compilation cache)."""
    with open(os.path.join(REPO, "scripts", name)) as f:
        tree = ast.parse(f.read())
    out = {}
    for node in tree.body:
        if not isinstance(node, ast.Assign):
            continue
        try:
            value = ast.literal_eval(node.value)
        except ValueError:
            continue
        target = node.targets[0]
        if isinstance(target, ast.Tuple):
            out.update(zip((t.id for t in target.elts), value))
        elif isinstance(target, ast.Name):
            out[target.id] = value
    return out


@pytest.mark.parametrize("script,module,names", [
    ("bench_attn_variants.py", tk12, ["B", "N", "H", "D", "NP"]),
    ("bench_int8_pallas.py", tk13, ["M", "K", "N"]),
    ("probe_stream_kernel.py", tk14, ["BHW", "ROWS", "C", "HEADS", "G"]),
], ids=["K12", "K13", "K14"])
def test_probe_shapes_equal(script, module, names):
    consts = _script_constants(script)
    for name in names:
        assert getattr(module, name) == consts[name], name


def test_probe_stream_literals_equal():
    """K14's inline literals: the valid rows (``valid[31:] = False``), the
    mask stage's scale and K6's scale at C 1024."""
    with open(os.path.join(REPO, "scripts", "probe_stream_kernel.py")) as f:
        src = f.read()
    assert f"valid[{tk14.N_VALID}:] = False" in src
    assert f"s * {tk14.SCALE} + m_ref" in src
    assert src.count(f"scale={tk14.SCALE_1024})") == 2
    assert f"scale={tk14.SCALE}))" in src


def test_port_imports_no_jax():
    code = ("import sys; import vda_tpu_torch, vda_tpu_torch.ops, "
            "vda_tpu_torch.infer.windowed, vda_tpu_torch.infer.streaming, "
            "vda_tpu_torch.ops.tiny_seq_kernel, "
            "vda_tpu_torch.ops.stream_kernel, vda_tpu_torch.utils.convert, "
            "vda_tpu_torch.ops.attn_proj_kernel, "
            "vda_tpu_torch.ops.resize_kernel, "
            "vda_tpu_torch.models.cross_attention, "
            "vda_tpu_torch.utils.profiling, vda_tpu_torch.ops.segment_kernel, "
            "vda_tpu_torch.loss.loss, vda_tpu_torch.parallel.train, "
            "vda_tpu_torch.parallel.trainer, vda_tpu_torch.utils.augment, "
            "vda_tpu_torch.utils.data, vda_tpu_torch.utils.checkpoint, "
            "vda_tpu_torch.ops.quant, vda_tpu_torch.probes.bench_int8, "
            "vda_tpu_torch.probes.bench_attn_variants, "
            "vda_tpu_torch.probes.probe_stream_kernel, "
            "vda_tpu_torch.probes.bench_attn_sm90, "
            "vda_tpu_torch.probes.bench_attn_proj_sm90, "
            "vda_tpu_torch.probes.bench_gemm_sm90, "
            "vda_tpu_torch.probes.bench_temporal_sm90, chip_smoke; "
            "bad = [m for m in sys.modules if m in ('jax', 'vda_tpu', "
            "'optax', 'orbax') or m.startswith(('jax.', 'vda_tpu.', "
            "'optax.', 'orbax.'))]; print(bad); "
            "sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
