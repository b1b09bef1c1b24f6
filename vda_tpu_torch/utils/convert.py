"""Weights for the port: a reference ``.pth``, the JAX package's exported
state dict, or a seeded random initialisation, and the cast to the compute
dtype that inference loads them with.

``load_torch_checkpoint`` loads a reference-format ``.pth`` (a bare state
dict or one wrapped in ``{"state_dict": ...}``) strictly, the counterpart of
``vda_tpu/utils/convert.py`` ``load_torch_checkpoint``.
``cast_params_for_inference`` is JAX's ``cast_params_for_inference``: every
parameter of 2 or more dims is stored once in bf16, except the fp32 output
island's (``head.scratch.output_conv2``); 1-D parameters and buffers stay
fp32.

``load_state_dict_numpy`` takes the flat reference-format numpy dict that
``vda_tpu.utils.convert.export_state_dict`` emits (reference key names and
torch layouts, ``pos_encoder.pe`` buffers included under APE; vitg's
SwiGLU as ``mlp.w12`` / ``mlp.w3``) and loads it strictly: every key must
be used and every parameter given.

``init_random`` fills a model from a ``torch.Generator`` with the JAX init's
distributions (``vda_tpu/models``): truncated-normal encoder projections,
fan-in uniform convs and linears (the MLP's or SwiGLU's among them), unit LayerNorms and LayerScale, and the
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


def load_torch_checkpoint(path: str,
                          model: VideoDepthAnything) -> VideoDepthAnything:
    """Load a reference ``.pth`` (reference run.py:50-54) into ``model``,
    strictly: every key used, every parameter and buffer given.  A state
    dict wrapped as ``{"state_dict": ...}`` is unwrapped."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    model.load_state_dict(sd, strict=True)
    return model


ISLAND = "head.scratch.output_conv2."  # the fp32 output convs' parameters
# parameters the reference shapes (1, 1, C) and (1, C) whose JAX leaves are
# (C,) vectors: 1-D to JAX's rule, so they stay fp32
TOKENS = ("pretrained.cls_token", "pretrained.mask_token")


@torch.no_grad()
def cast_params_for_inference(model: torch.nn.Module,
                              dtype=torch.bfloat16) -> torch.nn.Module:
    """Stores every parameter of 2 or more dims in ``dtype``, in place, once
    (JAX ``cast_params_for_inference``: the weights carry the memory
    traffic), except those of the fp32 output island; 1-D parameters (norm
    scales, biases, LayerScale gammas; the cls and mask tokens, vectors in
    JAX) and buffers (``pos_encoder.pe``) stay fp32.
    ``pretrained.pos_embed`` (1, N, C) is cast, as JAX casts it.  Returns
    ``model``."""
    for name, p in model.named_parameters():
        if p.dim() >= 2 and not name.startswith(ISLAND) \
                and name not in TOKENS:
            p.data = p.data.to(dtype)
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
