"""The port's models against the JAX package's, with shared weights.

The small kernel-shaped model of tests/torch_port.py (non-zero ``proj_out``)
carries one set of weights to both sides.  The JAX side runs its Pallas
kernels in interpret mode (``attn_impl="pallas"``; the temporal kernels
engage through ``need_caches=False``); the port runs ``attn_impl="auto"``,
whose wrappers take the plain twins on the CPU.  Frames are 56x70, so the
bicubic pos-embed interpolation runs.  All fp32: 1e-4 of the output scale
is the bound.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vda_tpu.models import dinov2 as jdinov2
from vda_tpu.models import dpt as jdpt
from vda_tpu.models import temporal as jtemporal
from vda_tpu.models import vda as jvda

from vda_tpu_torch.models import dinov2 as tdinov2
from vda_tpu_torch.models import dpt as tdpt
from vda_tpu_torch.models import temporal as ttemporal
from vda_tpu_torch.models import vda as tvda

from tests.torch_port import rel_err, small_models

TOL = 1e-4
T = 8


@pytest.fixture(scope="module")
def models():
    return small_models(seed=0)


@pytest.fixture(scope="module")
def frames():
    return np.random.default_rng(1).standard_normal(
        (1, T, 56, 70, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_features(models, frames):
    params, jcfg, _, _ = models
    x = jnp.asarray(frames.reshape(T, 56, 70, 3))
    return jdinov2.encode(params["pretrained"], x, jcfg.vit,
                          jcfg.intermediate_layer_idx, attn_impl="pallas")


def test_load_state_dict_strict(models):
    _, _, model, _ = models
    names = dict(model.named_parameters())
    assert all(not torch.all(p == 0) for n, p in names.items()
               if n.endswith("proj_out.weight"))
    assert "head.motion_modules.0.temporal_transformer.transformer_blocks.0." \
        "attention_blocks.0.pos_encoder.pe" in model.state_dict()


def test_encode(models, frames, jax_features):
    _, jcfg, model, _ = models
    with torch.no_grad():
        got = tdinov2.encode(model.pretrained,
                             torch.from_numpy(frames.reshape(T, 56, 70, 3)),
                             jcfg.intermediate_layer_idx)
    assert len(got) == len(jax_features) == 4
    for (jt, jc), (tt, tc) in zip(jax_features, got):
        assert tt.shape == jt.shape and tc.shape == jc.shape
        assert rel_err(jt, tt.numpy()) < TOL
        assert rel_err(jc, tc.numpy()) < TOL


@pytest.mark.parametrize("mm,hw", [(0, (4, 5)), (2, (8, 10))])
def test_temporal_module(models, mm, hw):
    """mm 0 (C=640) runs its attention sub-blocks in K4, mm 2 (C=128) its
    whole block in K3 (their twins here)."""
    params, jcfg, model, tcfg = models
    c = (640, 640, 128, 128)[mm]
    x = np.random.default_rng(mm).standard_normal(
        (1, T, *hw, c)).astype(np.float32)
    ref, caches = jtemporal.temporal_module_apply(
        params["head"]["motion_modules"][mm], jnp.asarray(x), jcfg, None,
        need_caches=False)
    assert caches == []
    with torch.no_grad():
        got, got_caches = ttemporal.temporal_module_apply(
            model.head.motion_modules[mm], torch.from_numpy(x), tcfg,
            need_caches=False)
    assert got_caches == []
    assert rel_err(ref, got.numpy()) < TOL
    assert rel_err(x, ref) > 1e-2  # the module is not the identity


def test_dpt_head(models, jax_features):
    params, jcfg, model, tcfg = models
    patch_hw = (4, 5)
    ref, _ = jdpt.dpt_head_temporal_apply(params["head"], jax_features,
                                          patch_hw, T, jcfg,
                                          need_caches=False,
                                          attn_impl="pallas")
    feats = [(torch.from_numpy(np.array(t)), torch.from_numpy(np.array(c)))
             for t, c in jax_features]
    with torch.no_grad():
        got, caches = tdpt.dpt_head_temporal_apply(model.head, feats,
                                                   patch_hw, T, tcfg,
                                                   micro_batch_size=3,
                                                   need_caches=False)
    assert caches == []
    assert got.shape == ref.shape == (T, 56, 70, 1)
    assert rel_err(ref, got.numpy()) < TOL


@pytest.fixture(scope="module")
def jax_depth(models, frames):
    params, jcfg, _, _ = models
    return jvda.forward(params, jnp.asarray(frames), jcfg, attn_impl="pallas")


@pytest.mark.parametrize("attn_impl", ["auto", "plain"])
def test_forward(models, frames, jax_depth, attn_impl):
    model, ref = models[2], jax_depth
    with torch.no_grad():  # forward is differentiable; inference runs it so
        got = tvda.forward(model, torch.from_numpy(frames),
                           attn_impl=attn_impl)
    assert got.shape == ref.shape == (1, T, 56, 70)
    assert np.isfinite(got.numpy()).all()
    assert rel_err(ref, got.numpy()) < TOL


def test_forward_rejects_unknown_attn_impl(models, frames):
    with pytest.raises(ValueError):
        tvda.forward(models[2], torch.from_numpy(frames), attn_impl="pallas")


def test_model_is_built_on_the_card_unless_asked():
    """``VideoDepthAnything`` builds its parameters on the card by default,
    as ``init_random`` does; a CPU caller passes ``device="cpu"``."""
    import inspect

    import vda_tpu_torch as vt

    sig = inspect.signature(vt.VideoDepthAnything)
    assert sig.parameters["device"].default == "cuda"
    model = vt.VideoDepthAnything(vt.get_config("tiny"), device="cpu")
    assert {p.device.type for p in model.parameters()} == {"cpu"}


def test_init_random_runs_on_the_card_unless_asked():
    """The port's entry points run on the card unless the caller asks for
    the CPU: ``init_random`` defaults to ``"cuda"``, and a CPU caller
    passes ``"cpu"`` with a CPU generator."""
    import inspect

    import vda_tpu_torch as vt

    assert inspect.signature(vt.init_random).parameters["device"].default \
        == "cuda"
    model = vt.init_random(vt.get_config("tiny"),
                           torch.Generator().manual_seed(0), "cpu")
    assert {p.device.type for p in model.parameters()} == {"cpu"}
