"""The port's host-side copies equal their JAX-package originals, and the port
imports neither JAX, ``vda_tpu``, the JAX apps (``apps``) nor the JAX
benchmark front-end (``benchmark.infer``)."""

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
from vda_tpu.utils import io as jio

import vda_tpu_torch.config as tconfig
from vda_tpu_torch.infer import stitching as tstitch
from vda_tpu_torch.infer.windowed import window_source_indices as twindows
from vda_tpu_torch.ops import attn_proj_kernel as tattn_proj
from vda_tpu_torch.ops import resize as tresize
from vda_tpu_torch.ops import resize_kernel as tresize_kernel
from vda_tpu_torch.probes import bench_attn_variants as tk12
from vda_tpu_torch.probes import bench_int8 as tk13
from vda_tpu_torch.probes import probe_stream_kernel as tk14
from vda_tpu_torch.utils import io as tio
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


@pytest.mark.parametrize("pe,ffn,tp", [("ape", "mlp", False),
                                       ("rope", "swiglufused", False),
                                       ("ape", "mlp", True)],
                         ids=["ape_mlp", "rope_swiglu", "tp_layout"])
def test_convert_and_export_state_dict_equal(pe, ffn, tp):
    """``utils/convert.py``'s ``convert_state_dict`` / ``export_state_dict``
    give JAX's leaves and state dict, array for array (with the
    tensor-parallel layout's qkv leaves on export)."""
    import torch

    import vda_tpu_torch as vt
    from vda_tpu.parallel.mesh import to_tp_layout
    from vda_tpu.utils import convert as jconvert
    from vda_tpu_torch.utils import convert as tconvert

    from tests.torch_port import small_configs

    jcfg, tcfg = small_configs(pe=pe, ffn_layer=ffn)
    sd = {k: v.numpy() for k, v in vt.init_random(
        tcfg, torch.Generator().manual_seed(1), device="cpu")
        .state_dict().items()}
    got = tconvert.convert_state_dict(sd, tcfg)
    ref = jconvert.convert_state_dict(sd, jcfg)
    flat = dict(tconvert._flatten(got))
    ref_flat = dict(tconvert._flatten(ref))
    assert flat.keys() == ref_flat.keys()
    for name, leaf in flat.items():
        assert leaf.dtype == ref_flat[name].dtype, name
        np.testing.assert_array_equal(leaf, ref_flat[name])
    if tp:
        got, ref = to_tp_layout(got), to_tp_layout(ref)
        assert got["pretrained"]["blocks"][0]["attn"]["qkv"]["w"].ndim == 3
    out = tconvert.export_state_dict(got, tcfg)
    ref_out = jconvert.export_state_dict(ref, jcfg)
    assert out.keys() == ref_out.keys() == sd.keys()
    for k, v in out.items():
        assert v.dtype == ref_out[k].dtype, k
        np.testing.assert_array_equal(v, ref_out[k])


def test_port_imports_no_jax():
    code = ("import sys; import vda_tpu_torch, vda_tpu_torch.ops, "
            "vda_tpu_torch.infer.windowed, vda_tpu_torch.infer.streaming, "
            "vda_tpu_torch.utils.knobs, "
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
            "vda_tpu_torch.probes.bench_temporal_sm90, "
            "vda_tpu_torch.utils.io, vda_tpu_torch.apps.run, "
            "vda_tpu_torch.apps.run_streaming, "
            "vda_tpu_torch.apps.benchmark_infer, vda_tpu_torch.apps.train, "
            "vda_tpu_torch.apps.engine, vda_tpu_torch.apps.engine.engine, "
            "vda_tpu_torch.apps.engine.strategies, "
            "vda_tpu_torch.apps.engine.exr_to_prores, "
            "vda_tpu_torch.apps.colab_processor, vda_tpu_torch.apps.app, "
            "chip_smoke; "
            "bad = [m for m in sys.modules if m in ('jax', 'vda_tpu', "
            "'optax', 'orbax', 'apps', 'benchmark.infer') or "
            "m.startswith(('jax.', 'vda_tpu.', 'optax.', 'orbax.', "
            "'apps.', 'benchmark.infer.'))]; print(bad); "
            "sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


FORBIDDEN = ("jax", "vda_tpu", "optax", "orbax", "apps", "benchmark.infer")


def _imports(path):
    """Every module a source file imports, at any depth of its AST."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0, f"{path}: relative import"
            yield node.module
            yield from (f"{node.module}.{a.name}" for a in node.names)


def _port_sources():
    yield os.path.join(REPO, "chip_smoke.py")
    for d, _, files in os.walk(os.path.join(REPO, "vda_tpu_torch")):
        yield from (os.path.join(d, f) for f in sorted(files)
                    if f.endswith(".py"))


@pytest.mark.parametrize("path", sorted(_port_sources()),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_port_source_imports_nothing_of_jax(path):
    """No import in the port's source or ``chip_smoke.py``, also inside a
    function, names JAX, the JAX package, its apps or its benchmark
    front-end."""
    bad = [m for m in _imports(path)
           if any(m == f or m.startswith(f + ".") for f in FORBIDDEN)]
    assert not bad, bad


# --- utils/io.py -----------------------------------------------------------

@pytest.mark.parametrize("v", [-3, 0, 1, 2, 517, 518, 1279])
def test_ensure_even_equal(v):
    assert tio.ensure_even(v) == jio.ensure_even(v)


@pytest.mark.parametrize("is_depths,grayscale", [(False, False),
                                                 (True, False),
                                                 (True, True)])
def test_visualize_equal(is_depths, grayscale):
    rng = np.random.default_rng(1)
    frames = (rng.random((3, 6, 7, 3)) * 255).astype(np.uint8) if \
        not is_depths else rng.random((3, 6, 7)).astype(np.float32) * 4
    got = list(tio._visualize(frames, is_depths, grayscale))
    ref = list(jio._visualize(frames, is_depths, grayscale))
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(g, r)


def test_npz_ply_and_exr_writers_equal(tmp_path):
    """save_depths_npz, _write_ply, save_point_clouds and
    save_depth_exr_sequence write the same bytes."""
    rng = np.random.default_rng(2)
    depths = rng.random((2, 5, 6)).astype(np.float32) * 3 + 0.5
    frames = (rng.random((2, 5, 6, 3)) * 255).astype(np.uint8)
    for mod, name in ((jio, "j"), (tio, "t")):
        d = tmp_path / name
        d.mkdir()
        mod.save_depths_npz(str(d / "d.npz"), depths)
        mod._write_ply(str(d / "p.ply"), depths.reshape(-1, 3),
                       frames.reshape(-1, 3)[:20])
        mod.save_point_clouds(str(d / "pc"), frames, depths, 470.4, 400.0)
        mod.save_depth_exr_sequence(str(d / "exr"), depths)
    np.testing.assert_array_equal(np.load(tmp_path / "t" / "d.npz")["depths"],
                                  np.load(tmp_path / "j" / "d.npz")["depths"])
    for rel in ["p.ply", "pc/point0000.ply", "pc/point0001.ply"] + [
            f"exr/{f}" for f in sorted(os.listdir(tmp_path / "j" / "exr"))]:
        assert (tmp_path / "t" / rel).read_bytes() == \
            (tmp_path / "j" / rel).read_bytes(), rel


@pytest.mark.parametrize("args", [(-1, -1, -1), (5, -1, -1), (-1, 4, -1),
                                  (-1, -1, 60), (7, 6, 51)])
def test_read_video_frames_equal(tmp_path, args):
    """(process_length, target_fps, max_res) on a synthesised 12 fps clip."""
    import cv2

    path = str(tmp_path / "clip.mp4")
    rng = np.random.default_rng(0)
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 12, (90, 70))
    base = (rng.random((70, 90, 3)) * 255).astype(np.uint8)
    for i in range(20):
        w.write(np.roll(base, i * 2, axis=1)[:, :, ::-1].copy())
    w.release()
    got, got_fps = tio.read_video_frames(path, *args)
    ref, ref_fps = jio.read_video_frames(path, *args)
    assert got_fps == ref_fps
    np.testing.assert_array_equal(got, ref)


def test_save_video_equal(tmp_path):
    rng = np.random.default_rng(3)
    depths = rng.random((4, 16, 16)).astype(np.float32)
    for mod, name in ((jio, "j.mp4"), (tio, "t.mp4")):
        mod.save_video(depths, str(tmp_path / name), fps=8, is_depths=True)
    a, _ = tio.read_video_frames(str(tmp_path / "t.mp4"))
    b, _ = jio.read_video_frames(str(tmp_path / "j.mp4"))
    np.testing.assert_array_equal(a, b)
    assert a.shape == (4, 16, 16, 3)
