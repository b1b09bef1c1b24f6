"""The port's weight loading against the JAX package's: the cast to bf16
once (``cast_params_for_inference``), the reference ``.pth`` loader and
``load_model_params``.

The cast must leave in fp32 exactly what JAX's leaves in fp32: the 1-D
parameters, the fp32 output island (``head.scratch.output_conv2``) and the
``pos_encoder.pe`` buffers; ``pretrained.pos_embed`` is cast, as JAX casts
it.  On 56x70 frames the cast ``pos_embed`` is interpolated, so a port
model cast by another rule would compute other values: both sides run in
fp32 on the small kernel-shaped model of tests/torch_port.py, held to 1e-4
of the output scale as in tests/test_torch_models.py.
"""

import inspect

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vda_tpu.infer.windowed import infer_video_depth as jinfer
from vda_tpu.models import vda as jvda
from vda_tpu.utils.convert import cast_params_for_inference as jcast
from vda_tpu.utils.convert import export_state_dict

import vda_tpu_torch as vt
from vda_tpu_torch.models import vda as tvda
from vda_tpu_torch.probes.param_casts import ParamCasts
from vda_tpu_torch.utils.convert import (cast_params_for_inference,
                                         load_torch_checkpoint)
from vda_tpu_torch.utils.loader import load_model_params

from tests.torch_port import rel_err, small_models

TOL = 1e-4
T = 4


@pytest.fixture(scope="module")
def small():
    """(JAX params, JAX cfg, port cfg, their exported state dict)."""
    params, jcfg, _, tcfg = small_models(seed=1)
    return params, jcfg, tcfg, export_state_dict(params, jcfg)


@pytest.fixture(scope="module")
def cast_models(small):
    """(JAX params cast by JAX's rule, JAX cfg, the port model cast by the
    port's), from one set of weights."""
    params, jcfg, tcfg, sd = small
    model = vt.load_state_dict_numpy(vt.VideoDepthAnything(tcfg,
                                                           device="cpu"), sd)
    return jcast(params), jcfg, cast_params_for_inference(model)


@pytest.fixture(scope="module")
def frames():
    return np.random.default_rng(2).standard_normal(
        (1, T, 56, 70, 3)).astype(np.float32)


def test_cast_leaves_fp32_exactly_what_jax_leaves_fp32(small):
    """Every JAX leaf filled with values no bf16 holds, cast by JAX's rule
    and exported: the keys whose values did not change are the names the
    port's cast leaves fp32."""
    params, jcfg, tcfg, _ = small
    rng = np.random.default_rng(0)

    def unroundable(leaf):  # the float32 mantissa's last bit set
        a = rng.standard_normal(leaf.shape).astype(np.float32)
        return jnp.asarray((a.view(np.uint32) | 1).view(np.float32))

    filled = jax.tree_util.tree_map(unroundable, params)
    before = export_state_dict(filled, jcfg)
    after = export_state_dict(jcast(filled), jcfg)
    jax_fp32 = {k for k in before if np.array_equal(before[k], after[k])}

    model = vt.VideoDepthAnything(tcfg, device="cpu")
    vt.load_state_dict_numpy(model, before)
    assert cast_params_for_inference(model) is model
    sd = model.state_dict()
    port_fp32 = {k for k, v in sd.items() if v.dtype == torch.float32}
    assert port_fp32 == jax_fp32
    assert {v.dtype for k, v in sd.items() if k not in port_fp32} \
        == {torch.bfloat16}
    # the fp32 island, the buffers and 1-D leaves stay; pos_embed is cast
    assert "head.scratch.output_conv2.0.weight" in port_fp32
    assert "head.scratch.output_conv2.2.weight" in port_fp32
    assert "pretrained.pos_embed" not in port_fp32
    assert all(k in port_fp32 for k in sd if k.endswith("pos_encoder.pe"))
    # the cast is the round to nearest of the loaded fp32 values
    for k in ("pretrained.pos_embed", "pretrained.blocks.0.attn.qkv.weight"):
        want = torch.from_numpy(before[k]).to(torch.bfloat16)
        assert torch.equal(sd[k], want)


def test_cast_forward_matches_jax_cast_params(cast_models, frames):
    params, jcfg, model = cast_models
    ref = jvda.forward(params, jnp.asarray(frames), jcfg, attn_impl="xla")
    with torch.no_grad():
        got = tvda.forward(model, torch.from_numpy(frames))
    assert got.dtype == torch.float32
    assert got.shape == ref.shape == (1, T, 56, 70)
    assert np.isfinite(got.numpy()).all()
    assert rel_err(ref, got.numpy()) < TOL


def test_cast_infer_video_depth_matches_jax_cast_params(cast_models):
    """One window (10 frames of 56x70 at input 56): the window path and the
    final resize on the cast weights, no stitching fit."""
    params, jcfg, model = cast_models
    video = (np.random.default_rng(3).random((10, 56, 70, 3))
             * 255).astype(np.uint8)
    ref, _ = jinfer(params, video, 24, jcfg, input_size=56, fp32=True,
                    attn_impl="xla")
    got, _ = vt.infer_video_depth(model, video, 24, input_size=56, fp32=True)
    assert got.shape == ref.shape == (10, 56, 70)
    assert np.isfinite(got).all() and got.std() > 0
    assert rel_err(ref, got) < TOL


def _same_state(model, sd):
    got = model.state_dict()
    assert set(got) == set(sd)
    for k, v in sd.items():
        assert torch.equal(got[k], torch.as_tensor(v)), k


@pytest.mark.parametrize("wrapped", [False, True])
def test_pth_loads_bare_and_wrapped(tmp_path, small, wrapped):
    """A ``.pth`` of ``export_state_dict``'s tensors, bare or wrapped in
    ``{"state_dict": ...}``."""
    _, _, cfg, sd = small
    tensors = {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}
    path = tmp_path / "ckpt.pth"
    torch.save({"state_dict": tensors} if wrapped else tensors, path)
    model = vt.VideoDepthAnything(cfg, device="cpu")
    assert load_torch_checkpoint(str(path), model) is model
    _same_state(model, tensors)
    # the loader: fp32 as loaded with cast_bf16=False, cast by default
    got_cfg, m32 = load_model_params("vits", checkpoint=str(path), cfg=cfg,
                                     cast_bf16=False, device="cpu")
    assert got_cfg is cfg
    _same_state(m32, tensors)
    _, m16 = load_model_params("vits", checkpoint=str(path), cfg=cfg,
                               device="cpu")
    assert m16.pretrained.blocks[0].attn.qkv.weight.dtype == torch.bfloat16
    assert m16.pretrained.blocks[0].attn.qkv.bias.dtype == torch.float32
    assert m16.head.scratch.output_conv2[0].weight.dtype == torch.float32


@pytest.mark.parametrize("fault", ["missing", "unexpected"])
def test_pth_loads_strictly(tmp_path, small, fault):
    _, _, cfg, sd = small
    tensors = {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}
    if fault == "missing":
        del tensors["pretrained.blocks.0.attn.qkv.weight"]
    else:
        tensors["pretrained.extra.weight"] = torch.zeros(3)
    path = tmp_path / "ckpt.pth"
    torch.save(tensors, path)
    with pytest.raises(RuntimeError, match="state_dict"):
        load_torch_checkpoint(str(path), vt.VideoDepthAnything(cfg,
                                                               device="cpu"))


def test_missing_checkpoint_and_npz_raise(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # no ./checkpoints here
    with pytest.raises(FileNotFoundError,
                       match="video_depth_anything_tiny.pth"):
        load_model_params("tiny", device="cpu")
    with pytest.raises(FileNotFoundError, match="random init"):
        load_model_params("tiny", checkpoint=str(tmp_path / "no.pth"),
                          device="cpu")
    npz = tmp_path / "params.npz"
    np.savez(npz, a=np.zeros(1))
    with pytest.raises(ValueError, match="npz"):
        load_model_params("tiny", checkpoint=str(npz), device="cpu")


def test_default_device_is_the_card():
    sig = inspect.signature(load_model_params)
    assert sig.parameters["device"].default == "cuda"
    assert sig.parameters["cast_bf16"].default is True
    assert vt.load_model_params is load_model_params


def test_random_init_is_seeded_from_generator_zero():
    """``random_init`` without a generator is ``init_random`` from a
    ``torch.Generator`` seeded 0 on the device, then the cast."""
    cfg, model = load_model_params("tiny", random_init=True, device="cpu")
    want = cast_params_for_inference(vt.init_random(
        cfg, torch.Generator().manual_seed(0), device="cpu"))
    _same_state(model, want.state_dict())
    _, other = load_model_params(
        "tiny", random_init=True, device="cpu", cast_bf16=False,
        generator=torch.Generator().manual_seed(1))
    assert not torch.equal(other.pretrained.pos_embed,
                           want.pretrained.pos_embed.float())


def _stream_casts(model, frames):
    """The parameter casts of one steady bf16 stream step (after three)."""
    stream = vt.StreamingDepth(model, input_size=56)
    for f in frames[:3]:
        stream.submit(f)
    with ParamCasts(model) as casts:
        depth = stream.submit(frames[3])
    assert torch.isfinite(depth).all()
    return casts


def test_steady_step_casts_no_parameter():
    """A cast model's steady bf16 stream step casts no parameter or buffer
    (the 1-D casts and the encoding tables are cast once,
    ``ops.layers.cast_once``); the uncast model's step casts its weights at
    use, which the counter sees.  Square frames, as vitl's 518: on another
    grid ``pos_embed`` is interpolated from an fp32 upcast at every call,
    as in JAX."""
    _, _, model, _ = small_models(seed=2)
    model.requires_grad_(False)
    frames = (np.random.default_rng(4).random((4, 56, 56, 3))
              * 255).astype(np.uint8)
    uncast = _stream_casts(model, frames)
    assert uncast.count > 0
    assert any(n.endswith("qkv.weight") for n in uncast.names)
    cast_params_for_inference(model)
    casts = _stream_casts(model, frames)
    assert casts.count == 0, casts.names
