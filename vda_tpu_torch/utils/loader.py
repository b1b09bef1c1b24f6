"""The one way the port's entry points load a model: a reference ``.pth``,
the JAX package's ``.npz`` params, or a seeded random initialisation, then
the cast inference runs with.

The counterpart of ``vda_tpu/utils/loader.py`` ``load_model_params``, which
every JAX app loads through.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch

from vda_tpu_torch.config import ModelConfig, checkpoint_name, get_config
from vda_tpu_torch.models.vda import VideoDepthAnything
from vda_tpu_torch.utils.convert import (
    cast_params_for_inference,
    init_random,
    load_npz_checkpoint,
    load_torch_checkpoint,
)


def load_model_params(
    encoder: str,
    metric: bool = False,
    checkpoint: Optional[str] = None,
    random_init: bool = False,
    cast_bf16: bool = True,
    cfg: Optional[ModelConfig] = None,
    device="cuda",
    generator: Optional[torch.Generator] = None,
) -> Tuple[ModelConfig, VideoDepthAnything]:
    """(cfg, model) from a reference ``.pth`` (``checkpoint``, by default
    ``./checkpoints/<checkpoint_name>.pth``), a JAX-package ``.npz`` params
    file (``checkpoint`` ending in ``.npz``: ``load_npz_checkpoint``, bf16
    and tensor-parallel files included) or, with ``random_init``, from
    ``init_random`` seeded by ``generator`` (by default a ``torch.Generator``
    on ``device`` seeded 0; JAX's ``PRNGKey(0)`` gives other values).
    ``cast_bf16`` stores the weights in bf16 once, as JAX's loader does
    (``cast_params_for_inference``); pass False for fp32 runs.  The model
    lives on ``device``: the card unless the caller asks for ``"cpu"``."""
    if cfg is None:
        cfg = get_config(encoder, metric=metric)
    if random_init:
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        model = init_random(cfg, generator, device=device)
    else:
        ckpt = checkpoint or os.path.join(
            "./checkpoints", checkpoint_name(encoder, metric) + ".pth")
        if not os.path.exists(ckpt):
            raise FileNotFoundError(
                f"checkpoint not found: {ckpt} — pass an explicit checkpoint "
                f"path, run scripts/get_weights.sh, or use random init "
                f"(testing only)")
        load = load_npz_checkpoint if ckpt.endswith(".npz") \
            else load_torch_checkpoint
        model = load(ckpt, VideoDepthAnything(cfg, device=device))
    if cast_bf16:
        cast_params_for_inference(model)
    return cfg, model
