"""Weights for the port: the JAX package's exported state dict, or a seeded
random initialisation.

``load_state_dict_numpy`` takes the flat reference-format numpy dict that
``vda_tpu.utils.convert.export_state_dict`` emits (reference key names and
torch layouts, ``pos_encoder.pe`` buffers included) and loads it strictly:
every key must be used and every parameter given.

``init_random`` fills a model from a ``torch.Generator`` with the JAX init's
distributions (``vda_tpu/models``): truncated-normal encoder projections,
fan-in uniform convs and linears, unit LayerNorms and LayerScale, and the
final conv's bias made positive so random depth is not all-zero after the
ReLU.  Unlike the JAX init, ``proj_out`` of every motion module gets
non-zero weights: zero-initialised, each motion module would be the identity
and a broken temporal kernel could not change the output.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from vda_tpu_torch.config import ModelConfig
from vda_tpu_torch.models.vda import VideoDepthAnything
from vda_tpu_torch.ops.layers import Conv2d, ConvTranspose2d, Linear, Norm


def load_state_dict_numpy(model: VideoDepthAnything,
                          sd: Dict[str, np.ndarray]) -> VideoDepthAnything:
    """Load a reference-format numpy state dict (strict)."""
    device = next(model.parameters()).device
    model.load_state_dict(
        {k: torch.from_numpy(np.array(v, np.float32)).to(device)
         for k, v in sd.items()}, strict=True)
    return model


def load_cross_attention_numpy(module: torch.nn.Module,
                               params: Dict) -> torch.nn.Module:
    """Load the JAX package's ``init_cross_attention`` or
    ``init_feed_forward`` params (numpy or JAX arrays; linears {"w" (in,
    out), "b"}, group_norm {"scale", "bias"}) into a
    ``models.cross_attention`` module (linear weights (out, in)), strictly:
    every parameter of the module is given and every param is used."""
    device = next(module.parameters()).device
    sd = {}
    for name, p in params.items():
        if name == "group_norm":
            sd["group_norm.weight"] = p["scale"]
            sd["group_norm.bias"] = p["bias"]
            continue
        sd[f"{name}.weight"] = np.asarray(p["w"]).T
        if "b" in p:
            sd[f"{name}.bias"] = p["b"]
    module.load_state_dict(
        {k: torch.from_numpy(np.array(v, np.float32)).to(device)
         for k, v in sd.items()}, strict=True)
    return module


def load_int8_params_numpy(params: Dict, device="cuda") -> Dict:
    """The JAX package's int8 linear params (``quantize_weight``'s ``w_q``
    (K, N) int8 and ``w_s`` (N,), an optional bias "b"; numpy or JAX
    arrays) as the tensors ``ops.quant.int8_linear`` takes, dtypes kept,
    on ``device``."""
    return {k: torch.from_numpy(np.array(v)).to(device)
            for k, v in params.items()}


@torch.no_grad()
def init_random(cfg: ModelConfig, generator: torch.Generator,
                device="cuda") -> VideoDepthAnything:
    """A model with seeded random weights (fp32, on ``device``: the card
    unless the caller asks for ``"cpu"``).  The generator must live on
    ``device`` (a CPU generator for CPU)."""
    model = VideoDepthAnything(cfg, device=device)

    def uniform_(t, fan_in):
        bound = fan_in ** -0.5
        t.uniform_(-bound, bound, generator=generator)

    def trunc_normal_(t, std=0.02):
        t.normal_(0.0, std, generator=generator).clamp_(-2 * std, 2 * std)

    for name, m in model.named_modules():
        if isinstance(m, Norm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, (Linear, Conv2d)):
            fan_in = m.weight[0].numel()
            uniform_(m.weight, fan_in)
            if m.bias is not None:
                uniform_(m.bias, fan_in)
        elif isinstance(m, ConvTranspose2d):
            fan_in = m.weight[0].numel()  # torch counts Cout * k * k
            uniform_(m.weight, fan_in)
            uniform_(m.bias, fan_in)

    enc = model.pretrained
    enc.cls_token.normal_(0.0, 1e-6, generator=generator)
    enc.mask_token.zero_()
    trunc_normal_(enc.pos_embed)
    trunc_normal_(enc.patch_embed.proj.weight)
    enc.patch_embed.proj.bias.zero_()
    for blk in enc.blocks:
        for lin in (blk.attn.qkv, blk.attn.proj):
            trunc_normal_(lin.weight)
            lin.bias.zero_()
        blk.ls1.gamma.fill_(cfg.vit.init_values)
        blk.ls2.gamma.fill_(cfg.vit.init_values)
    final = model.head.scratch.output_conv2[2]
    final.bias.copy_(final.bias.abs() + 0.1)
    return model
