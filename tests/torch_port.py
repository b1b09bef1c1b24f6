"""Shared setup of the port's parity tests (tests/test_torch_*.py).

One small model whose widths pass every kernel gate of both packages: an
encoder of embed 128, depth 2, 2 heads (head dim 64), img 56; a head with
features 128 and out_channels (128, 128, 640, 640), so motion modules 0/1
(C=640, 8 heads of 80) take K4 and modules 2/3 (C=128, 8 heads of 16) take
K3.  (The stock ``tiny`` config has temporal heads of width 4 and engages no
kernel.)  JAX params come from a seed, with every ``proj_out`` filled from
numpy: zero-initialised, the motion modules would be identities and a broken
temporal kernel would pass.  They reach the port through
``export_state_dict`` -> ``load_state_dict_numpy``.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from vda_tpu.config import EncoderConfig, ModelConfig
from vda_tpu.models import init_video_depth_anything
from vda_tpu.utils.convert import export_state_dict

import vda_tpu_torch as vt
from vda_tpu_torch import config as tconfig


def small_configs(features: int = 128):
    """(JAX ModelConfig, port ModelConfig) of the small kernel-shaped model.
    ``features=256`` gives the head vitl's widths where K10 engages: the
    output tail's island at 128 channels and refinenet1 at 256."""
    kw = dict(embed_dim=128, depth=2, num_heads=2, img_size=56)
    head = ("small", features, (128, 128, 640, 640), (0, 0, 1, 1))
    return (ModelConfig(*head, EncoderConfig(**kw)),
            tconfig.ModelConfig(*head, tconfig.EncoderConfig(**kw)))


def nonzero_proj_out(params, rng):
    for mm in params["head"]["motion_modules"]:
        c = mm["proj_out"]["w"].shape[0]
        bound = 1.0 / np.sqrt(c)
        mm["proj_out"]["w"] = jnp.asarray(
            rng.uniform(-bound, bound, (c, c)).astype(np.float32))
        mm["proj_out"]["b"] = jnp.asarray(
            rng.uniform(-bound, bound, (c,)).astype(np.float32))
    return params


def small_models(seed: int = 0, features: int = 128):
    """(JAX params, JAX cfg, port model, port cfg) sharing one set of
    weights."""
    jcfg, tcfg = small_configs(features)
    params = init_video_depth_anything(jax.random.PRNGKey(seed), jcfg)
    params = nonzero_proj_out(params, np.random.default_rng(seed))
    model = vt.VideoDepthAnything(tcfg, device="cpu")
    vt.load_state_dict_numpy(model, export_state_dict(params, jcfg))
    return params, jcfg, model, tcfg


def rel_err(ref, got) -> float:
    """max |ref - got| over max |ref| (the output scale)."""
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    return float(np.abs(ref - got).max() / max(np.abs(ref).max(), 1e-12))


def resize_gate_cases():
    """Inputs of K10's gate (``supported``): tests/test_ops.py's rejections
    (fp32, 64 channels, batch 1, a downsample, align_corners=False, an
    explicit scale, an H_out no row block divides) and a grid over batch,
    channels and sizes.  Each is (shape, out_hw, align_corners, scale,
    fp32)."""
    ok = ((8, 20, 24, 128), (32, 40), True, None, False)
    cases = [ok,
             ((8, 20, 24, 128), (32, 40), True, None, True),
             ((8, 20, 24, 64), (32, 40), True, None, False),
             ((1, 20, 24, 128), (32, 40), True, None, False),
             ((8, 20, 24, 128), (10, 40), True, None, False),
             ((8, 20, 24, 128), (32, 40), False, None, False),
             ((8, 20, 24, 128), (32, 40), True, (2.0, 2.0), False),
             ((8, 20, 24, 128), (37, 40), True, None, False)]
    for b in (1, 7, 8, 16):
        for c in (64, 128, 200, 256):
            for (h, w), (oh, ow) in (((148, 148), (296, 296)),
                                     ((296, 296), (518, 518)),
                                     ((74, 74), (148, 148)),
                                     ((37, 37), (74, 74)),
                                     ((19, 19), (37, 37)),
                                     ((20, 24), (20, 24)),
                                     ((20, 24), (32, 20)),
                                     ((9, 7), (14, 13))):
                cases.append(((b, h, w, c), (oh, ow), True, None, False))
    return cases
