"""The JAX package's ``.npz`` params in the port (``utils/convert.py``
``save_params_npz`` / ``load_params_npz`` / ``load_npz_checkpoint``,
``utils/loader.load_model_params(checkpoint="x.npz")``): files JAX writes
(fp32 params, its inference-cast bf16 params, whose bf16 leaves numpy reads
as ``|V2``, and tensor-parallel params) load into the port bit for bit as
the ``export_state_dict`` route loads the same params; files the port
writes load in JAX, leaf for leaf; the offline and train CLIs take
``--checkpoint x.npz`` on the CPU.  Forwards compare within 1e-4 of the
output scale (tests/test_torch_stream.py's fp32 bound)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vda_tpu.config import get_config as jget_config
from vda_tpu.models import vda as jvda
from vda_tpu.parallel.mesh import to_tp_layout
from vda_tpu.utils import convert as jconvert

import vda_tpu_torch as vt
from vda_tpu_torch.apps import run as trun
from vda_tpu_torch.apps import train as ttrain
from vda_tpu_torch.models import vda as tvda
from vda_tpu_torch.utils import convert as tconvert

from tests.torch_port import rel_err, small_models

TOL = 1e-4
V2 = np.dtype("V2")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two torch threads: the suite's workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def shared():
    """(JAX params, JAX cfg, port model, port cfg) of the small kernel-shaped
    config, one set of weights (``export_state_dict`` -> the port)."""
    params, jcfg, model, tcfg = small_models(seed=3)
    model.requires_grad_(False)
    return params, jcfg, model, tcfg


def _same_state(a, b) -> bool:
    sa, sb = a.state_dict(), b.state_dict()
    return sa.keys() == sb.keys() and all(
        sa[k].dtype == sb[k].dtype and torch.equal(sa[k], sb[k]) for k in sa)


def _load(path, tcfg, cast):
    return vt.load_model_params("small", checkpoint=str(path), cfg=tcfg,
                                cast_bf16=cast, device="cpu")[1]


@pytest.mark.parametrize("kind", ["fp32", "bf16", "tp"])
def test_jax_file_loads_bit_identically(shared, tmp_path, kind):
    """JAX's ``save_params_npz`` of fp32, inference-cast and TP-layout
    params, through ``load_model_params``: the model the export route
    gives, cast once as JAX's loader casts (bf16 file: cast at load too)."""
    params, jcfg, model, tcfg = shared
    saved = {"fp32": params, "tp": to_tp_layout(params),
             "bf16": jconvert.cast_params_for_inference(params)}[kind]
    path = tmp_path / f"{kind}.npz"
    jconvert.save_params_npz(str(path), saved)
    with np.load(path) as data:
        dtypes = {data[n].dtype for n in data.files}
        qkv = data["pretrained/blocks/0/attn/qkv/w"]
    if kind == "bf16":
        assert V2 in dtypes  # what numpy makes of a bf16 leaf
    else:
        assert dtypes == {np.dtype(np.float32)}
    assert qkv.ndim == (3 if kind == "tp" else 2)
    for cast in (False, True):
        got = _load(path, tcfg, cast)
        want = vt.VideoDepthAnything(tcfg, device="cpu")
        vt.load_state_dict_numpy(want, jconvert.export_state_dict(
            jconvert.cast_params_for_inference(params) if kind == "bf16"
            else params, jcfg))
        if cast:
            vt.cast_params_for_inference(want)
        assert _same_state(want, got), (kind, cast)


def test_bf16_leaf_bits(tmp_path):
    """A bf16 1.5 reads back from JAX's file as ``|V2`` with bits 0x3FC0,
    and the port widens it exactly."""
    path = tmp_path / "x.npz"
    np.savez(path, x=np.asarray(jnp.asarray([1.5, -2.25, 3e38],
                                            jnp.bfloat16)))
    with np.load(path) as data:
        raw = data["x"]
    assert raw.dtype == V2 and raw.view(np.uint16)[0] == 0x3FC0
    got = tconvert._from_file(raw)
    want = np.asarray(jnp.asarray([1.5, -2.25, 3e38], jnp.bfloat16),
                      np.float32)
    assert got.dtype == np.float32 and np.array_equal(got, want)
    assert np.array_equal(tconvert._bf16_bytes(want).view(np.uint16),
                          raw.view(np.uint16))
    with pytest.raises(ValueError, match="bf16"):
        tconvert._bf16_bytes(np.float32([1.0 + 2 ** -20]))


@pytest.mark.parametrize("cast", [False, True], ids=["fp32", "bf16"])
def test_port_file_loads_in_jax(shared, tmp_path, cast):
    """The port's ``save_params_npz``: JAX's ``load_params_npz`` reads
    every leaf of its template, the values JAX's ``convert_state_dict`` (and,
    cast, its inference cast) gives the port's weights, bit for bit; an
    fp32 file's forward in JAX within TOL of the port's."""
    params, jcfg, model, tcfg = shared
    m = vt.VideoDepthAnything(tcfg, device="cpu").requires_grad_(False)
    m.load_state_dict(model.state_dict())
    if cast:
        vt.cast_params_for_inference(m)
    path = tmp_path / "port.npz"
    tconvert.save_params_npz(str(path), m)
    got = jconvert.load_params_npz(str(path), params)
    want = jconvert.convert_state_dict(
        {k: v.numpy() for k, v in model.state_dict().items()}, jcfg)
    if cast:
        want = jconvert.cast_params_for_inference(want)
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want))
    assert len(flat_got) == len(flat_want)
    for kp, leaf in flat_got:
        ref = np.asarray(flat_want[kp])
        if ref.dtype == np.float32:
            assert leaf.dtype == np.float32 and np.array_equal(leaf, ref), kp
        else:  # bf16: the same two bytes a value
            assert leaf.dtype == V2, kp
            assert np.array_equal(leaf.view(np.uint16),
                                  ref.view(np.uint16)), kp
    if not cast:
        x = np.random.default_rng(1).standard_normal(
            (1, 4, 56, 56, 3)).astype(np.float32)
        ref = jvda.forward(got, jnp.asarray(x), jcfg, attn_impl="pallas")
        with torch.no_grad():
            out = tvda.forward(model, torch.from_numpy(x))
        assert rel_err(ref, out.numpy()) < TOL


@pytest.mark.parametrize("cast", [False, True], ids=["fp32", "bf16"])
def test_port_round_trip(shared, tmp_path, cast):
    """save_params_npz -> load_model_params gives the same model bit for
    bit (a cast model: loaded with the cast)."""
    _, _, model, tcfg = shared
    m = vt.VideoDepthAnything(tcfg, device="cpu").requires_grad_(False)
    m.load_state_dict(model.state_dict())
    if cast:
        vt.cast_params_for_inference(m)
    path = tmp_path / "rt.npz"
    tconvert.save_params_npz(str(path), m)
    assert _same_state(m, _load(path, tcfg, cast))


@pytest.mark.parametrize("encoder,kw", [("vitg", {}), ("vits", {"pe": "rope"}),
                                        ("vitl", {"metric": True})])
def test_layouts_of_the_configs(tmp_path, encoder, kw):
    """The names and shapes the port writes for a full config (vitg's
    SwiGLU, RoPE without ``pos_encoder``, metric) are JAX's, on the meta
    device: ``jax.eval_shape`` of JAX's init against the port's
    ``convert_state_dict`` of a model's state dict."""
    from vda_tpu.models import init_video_depth_anything

    jcfg = jget_config(encoder, **kw)
    tcfg = vt.get_config(encoder, **kw)
    shapes = jax.eval_shape(lambda: init_video_depth_anything(
        jax.random.PRNGKey(0), jcfg))
    want = {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in kp): tuple(v.shape)
            for kp, v in jax.tree_util.tree_leaves_with_path(shapes)}
    model = vt.VideoDepthAnything(tcfg, device="meta")
    sd = {k: np.lib.stride_tricks.as_strided(
        np.zeros(1, np.float32), tuple(v.shape), (0,) * v.dim())
        for k, v in model.state_dict().items()}
    got = {n: tuple(a.shape) for n, a in tconvert._flatten(
        tconvert.convert_state_dict(sd, tcfg))}
    assert got == want


@pytest.fixture(scope="module")
def test_video(tmp_path_factory):
    """tests/test_cli.py's clip: 40 frames of 70x90, a rolled texture."""
    import cv2

    path = str(tmp_path_factory.mktemp("vid") / "clip.mp4")
    rng = np.random.default_rng(0)
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 12, (90, 70))
    base = (rng.random((70, 90, 3)) * 255).astype(np.uint8)
    for i in range(20):
        w.write(np.roll(base, i * 2, axis=1)[:, :, ::-1].copy())
    w.release()
    return path


@pytest.fixture(scope="module")
def tiny_files(tmp_path_factory):
    """A seeded tiny model as a ``.pth`` and as a JAX-format ``.npz``."""
    d = tmp_path_factory.mktemp("tiny")
    model = vt.init_random(vt.get_config("tiny"),
                           torch.Generator().manual_seed(4), device="cpu")
    torch.save(model.state_dict(), d / "w.pth")
    jconvert.save_params_npz(str(d / "w.npz"), jconvert.convert_state_dict(
        {k: v.numpy() for k, v in model.state_dict().items()},
        jget_config("tiny")))
    return str(d / "w.pth"), str(d / "w.npz")


def test_run_cli_takes_npz(test_video, tiny_files, tmp_path):
    """``apps.run --checkpoint x.npz`` on the CPU: the depths of the same
    weights from the ``.pth``, bit for bit."""
    flags = ["--input_video", test_video, "--encoder", "tiny", "--device",
             "cpu", "--fp32", "--input_size", "56", "--max_len", "8"]
    depths = [trun.main(flags + ["--checkpoint", ckpt, "--output_dir",
                                 str(tmp_path / str(i))])
              for i, ckpt in enumerate(tiny_files)]
    assert depths[0].shape == (8, 70, 90)
    assert np.array_equal(depths[0], depths[1])


def test_train_cli_takes_npz(tiny_files):
    """``apps.train --checkpoint x.npz``: one synthetic step from the
    ``.npz`` gives the state one step from the ``.pth`` gives."""
    base = ["--encoder", "tiny", "--synthetic", "--frames", "4", "--size",
            "56", "--device", "cpu", "--steps", "1", "--prefetch", "0"]
    states = [ttrain.main(base + ["--checkpoint", ckpt])
              for ckpt in tiny_files]
    assert all(int(s.step) == 1 for s in states)
    assert _same_state(states[0].model, states[1].model)


def test_file_without_the_model_raises(shared, tmp_path):
    _, _, _, tcfg = shared
    path = tmp_path / "other.npz"
    np.savez(path, **{"pretrained/cls_token": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="other.npz"):
        _load(path, tcfg, False)
