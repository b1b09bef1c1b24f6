"""vitg in the port: the SwiGLU feed-forward of its encoder
(``ffn_layer="swiglufused"``) against the JAX package, and vitg's full
parameter layout and inference cast without building its 1.3B parameters.

Numerics run on the small kernel-shaped model of tests/torch_port.py with
the SwiGLU encoder (hidden (int(512 * 2 / 3) + 7) // 8 * 8 = 344 at embed
128), shared through ``export_state_dict`` -> strict load.  The JAX side
runs its Pallas kernels in interpret mode; the port runs its plain twins.
All fp32: 1e-4 of the output scale, the bound of tests/test_torch_models.py.
vitg's layout comes from ``jax.eval_shape`` of JAX's init, exported with
shape-only leaves (zero-strided numpy views, so nothing of vitg's size is
allocated), against the port built on the ``meta`` device.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vda_tpu.config import get_config as jget_config
from vda_tpu.models import dinov2 as jdinov2
from vda_tpu.models import init_video_depth_anything
from vda_tpu.models import vda as jvda
from vda_tpu.utils import convert as jconvert
from vda_tpu.utils.convert import cast_params_for_inference as jcast
from vda_tpu.utils.convert import export_state_dict

import vda_tpu_torch as vt
from vda_tpu_torch.models import dinov2 as tdinov2
from vda_tpu_torch.models import vda as tvda
from vda_tpu_torch.utils.convert import (
    cast_params_for_inference,
    load_torch_checkpoint,
)

from tests.torch_port import rel_err, small_models

TOL = 1e-4
T = 4


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two torch threads: the suite's workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    return small_models(seed=6, ffn_layer="swiglufused")


@pytest.fixture(scope="module")
def frames():
    return np.random.default_rng(7).standard_normal(
        (1, T, 56, 70, 3)).astype(np.float32)


def test_swiglu_hidden_width():
    """The reference's hidden width: 4096 at vitg's 1536, 344 at 128."""
    for d, hidden in ((1536, 4096), (128, 344)):
        ffn = tdinov2.SwiGLUFFN(d, 4.0, device="meta")
        assert tuple(ffn.w12.weight.shape) == (2 * hidden, d)
        assert tuple(ffn.w3.weight.shape) == (d, hidden)


def test_swiglu_block_matches_jax(models):
    """One block (``block_apply``, the ``_block`` path) and the nested
    block, whose feed-forward is the same ``_mlp``."""
    params, jcfg, model, tcfg = models
    x = np.random.default_rng(1).standard_normal(
        (2, 17, 128)).astype(np.float32)
    p0 = params["pretrained"]["blocks"][0]
    blk = model.pretrained.blocks[0]
    ref = jdinov2.block_apply(p0, jnp.asarray(x), jcfg.vit, attn_impl="xla")
    ref_nested = jdinov2.block_apply_nested(p0, [jnp.asarray(x)], jcfg.vit,
                                            "xla")
    with torch.no_grad():
        got = tdinov2.block_apply(blk, torch.from_numpy(x), tcfg.vit,
                                  kernels=True)
        nested = tdinov2.block_apply_nested(blk, [torch.from_numpy(x)],
                                            tcfg.vit)
    assert rel_err(ref, got.numpy()) < TOL
    assert rel_err(ref_nested[0], nested[0].numpy()) < TOL
    assert rel_err(x, got.numpy()) > 1e-2


def test_swiglu_encode_matches_jax(models, frames):
    params, jcfg, model, _ = models
    x = frames.reshape(T, 56, 70, 3)
    ref = jdinov2.encode(params["pretrained"], jnp.asarray(x), jcfg.vit,
                         jcfg.intermediate_layer_idx, attn_impl="pallas")
    with torch.no_grad():
        got = tdinov2.encode(model.pretrained, torch.from_numpy(x),
                             jcfg.intermediate_layer_idx)
    for (jt, jc), (tt, tc) in zip(ref, got):
        assert rel_err(jt, tt.numpy()) < TOL
        assert rel_err(jc, tc.numpy()) < TOL


@pytest.mark.parametrize("pe", ["ape", "rope"])
def test_swiglu_model_forward_matches_jax(frames, pe):
    """The whole model with the SwiGLU encoder, under either encoding."""
    params, jcfg, model, _ = small_models(seed=8, ffn_layer="swiglufused",
                                          pe=pe)
    ref = jvda.forward(params, jnp.asarray(frames), jcfg, attn_impl="pallas")
    with torch.no_grad():
        got = tvda.forward(model, torch.from_numpy(frames))
    assert got.shape == ref.shape
    assert rel_err(ref, got.numpy()) < TOL


def test_swiglu_checkpoint_loads_strictly(models, tmp_path):
    """A reference-format ``.pth`` of a SwiGLU model through
    ``load_torch_checkpoint``: bit-identical parameters; a dict that lacks
    ``mlp.w3`` is refused."""
    _, _, model, tcfg = models
    path = str(tmp_path / "swiglu.pth")
    torch.save(model.state_dict(), path)
    back = load_torch_checkpoint(path, vt.VideoDepthAnything(tcfg,
                                                             device="cpu"))
    for (k, a), (_, b) in zip(model.state_dict().items(),
                              back.state_dict().items()):
        assert torch.equal(a, b), k
    sd = {k: v for k, v in model.state_dict().items()
          if not k.endswith("mlp.w3.weight")}
    torch.save(sd, path)
    with pytest.raises(RuntimeError, match="w3"):
        load_torch_checkpoint(path, vt.VideoDepthAnything(tcfg,
                                                          device="cpu"))


def _shape_only(monkeypatch):
    """Make ``export_state_dict`` copy nothing: each exporter returns a
    zero-strided view of the transposed shape in the leaf's dtype (the
    exporters' own cast to fp32 dropped, so the dtypes of a cast tree
    survive)."""
    def view(a, perm=None):
        shape = tuple(a.shape) if perm is None \
            else tuple(a.shape[i] for i in perm)
        return np.broadcast_to(np.zeros((), a.dtype), shape)

    monkeypatch.setattr(jconvert, "_it", lambda a: view(a, (1, 0)))
    monkeypatch.setattr(jconvert, "_iconv", lambda a: view(a, (3, 2, 0, 1)))
    monkeypatch.setattr(jconvert, "_ideconv", lambda a: view(a, (0, 3, 1, 2)))
    monkeypatch.setattr(jconvert, "_iarr", view)


@pytest.fixture(scope="module")
def vitg_shapes():
    """vitg's JAX params as shapes, uncast and cast by JAX's rule."""
    cfg = jget_config("vitg")
    init = functools.partial(init_video_depth_anything, cfg=cfg)
    key = jax.random.PRNGKey(0)

    def views(tree):  # numpy leaves of the shapes, no memory behind them
        return jax.tree_util.tree_map(
            lambda s: np.broadcast_to(np.zeros((), s.dtype), s.shape), tree)

    return (cfg, views(jax.eval_shape(init, key)),
            views(jax.eval_shape(lambda k: jcast(init(k)), key)))


def test_vitg_key_shape_map_matches_jax(vitg_shapes, monkeypatch):
    cfg, shapes, _ = vitg_shapes
    _shape_only(monkeypatch)
    ref = {k: tuple(v.shape) for k, v in export_state_dict(shapes,
                                                           cfg).items()}
    model = vt.VideoDepthAnything(vt.get_config("vitg"), device="meta")
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert got == ref
    assert got["pretrained.blocks.39.mlp.w12.weight"] == (8192, 1536)
    assert got["pretrained.blocks.39.mlp.w3.weight"] == (1536, 4096)
    n = sum(v.numel() for v in model.parameters())
    assert 1.3e9 < n < 1.4e9


def test_vitg_inference_cast_matches_jax(vitg_shapes, monkeypatch):
    """JAX's cast of vitg's leaves against the port's fp32/bf16 split, name
    by name (the SwiGLU weights among the bf16 ones)."""
    cfg, _, cast = vitg_shapes
    _shape_only(monkeypatch)
    ref = {k: str(v.dtype) for k, v in export_state_dict(cast, cfg).items()}
    model = vt.VideoDepthAnything(vt.get_config("vitg"), device="meta")
    cast_params_for_inference(model)
    names = {torch.float32: "float32", torch.bfloat16: "bfloat16"}
    got = {k: names[v.dtype] for k, v in model.state_dict().items()}
    assert got == ref
    assert got["pretrained.blocks.0.mlp.w12.weight"] == "bfloat16"
    assert got["pretrained.blocks.0.mlp.w3.bias"] == "float32"


def test_unknown_ffn_layer_refused():
    cfg = vt.get_config("tiny")
    cfg = cfg.replace(vit=cfg.vit.__class__(**{**cfg.vit.__dict__,
                                               "ffn_layer": "moe"}))
    with pytest.raises(ValueError, match="ffn_layer"):
        vt.VideoDepthAnything(cfg, device="cpu")
