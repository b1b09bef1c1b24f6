"""Seeded Video Depth Anything weights in the reference state-dict layout.

The keys and shapes are those of the published checkpoints
(``video_depth_anything_<encoder>.pth``): ``pretrained.*`` for the DINOv2
encoder and ``head.*`` for the temporal DPT head, the motion modules'
sinusoidal ``pos_encoder.pe`` buffers included.  An encoder whose
``ffn_layer`` is "swiglufused" (vitg, of which VDA publishes no checkpoint)
takes DINOv2's ``mlp.w12`` and ``mlp.w3`` where the GELU MLP takes
``mlp.fc1`` and ``mlp.fc2``.  Every value is drawn from
one ``torch.Generator`` on the given device in a single ``randn`` call, then
scaled per tensor:

* linear and conv weights: std ``fan_in ** -0.5`` (a conv-transpose whose
  stride equals its kernel sees one input pixel an output: fan-in ``Cin``);
* biases, tokens and the mask token: std 0.02; the position embedding: 0.1;
* norm scales ``1 + 0.1 n``, norm shifts ``0.1 n``; LayerScale ``0.5 + 0.1 n``;
* the last output conv (32 -> 1, after a ReLU) takes weights ``|n| / sqrt(32)``
  and a bias ``1 + 0.1 |n|``, so that every depth is positive whatever the
  seed (with signed weights some seeds zero nearly every pixel);
* every motion module's ``proj_out`` has non-zero weights (the published
  init zeroes it, which would make each module the identity).

The same seed gives the same values on the same device type; seeds of any
size are mixed into the generator's seed (``generator_seed``).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

Spec = Tuple[str, Tuple[int, ...], str, float]  # key, shape, kind, fan-in


def generator_seed(seed: int, stream: int = 0) -> int:
    """A 63-bit generator seed mixed from a seed of any size and a stream
    number, so that seeds differing in any bit give different draws (the
    CPU generator keeps only 32 bits of what it is given)."""
    a, b = np.random.SeedSequence([seed, stream]).generate_state(2, np.uint32)
    return (int(a) << 31) ^ int(b)


def sinusoidal_pe(max_len: int, d_model: int) -> torch.Tensor:
    """The motion modules' (1, max_len, d_model) position table
    (reference motion_module.py ``PositionalEncoding``)."""
    position = torch.arange(max_len).unsqueeze(1)
    div_term = torch.exp(torch.arange(0, d_model, 2)
                         * (-math.log(10000.0) / d_model))
    pe = torch.zeros(1, max_len, d_model)
    pe[0, :, 0::2] = torch.sin(position * div_term)
    pe[0, :, 1::2] = torch.cos(position * div_term)
    return pe


def _linear(out: List[Spec], key: str, d_in: int, d_out: int,
            bias: bool = True) -> None:
    out.append((f"{key}.weight", (d_out, d_in), "weight", d_in))
    if bias:
        out.append((f"{key}.bias", (d_out,), "bias", 0))


def _conv(out: List[Spec], key: str, cin: int, cout: int, k: int,
          bias: bool = True) -> None:
    out.append((f"{key}.weight", (cout, cin, k, k), "weight", cin * k * k))
    if bias:
        out.append((f"{key}.bias", (cout,), "bias", 0))


def _norm(out: List[Spec], key: str, c: int) -> None:
    out.append((f"{key}.weight", (c,), "scale", 0))
    out.append((f"{key}.bias", (c,), "shift", 0))


def ffn_hidden(enc: dict) -> int:
    """The hidden width of the encoder's feed-forward: ``d * mlp_ratio`` for
    the GELU MLP (``ffn_layer`` "mlp"); for the SwiGLU of "swiglufused"
    (DINOv2 ``SwiGLUFFNFused``: ``w3(silu(x1) * x2)`` with x1, x2 the
    halves of ``w12(x)``) two thirds of it rounded up to a multiple of 8,
    4096 at d 1536."""
    hidden = int(enc["embed_dim"] * enc["mlp_ratio"])
    if enc["ffn_layer"] == "mlp":
        return hidden
    if enc["ffn_layer"] == "swiglufused":
        return (int(hidden * 2 / 3) + 7) // 8 * 8
    raise ValueError(f"unknown ffn_layer {enc['ffn_layer']!r}")


def specs(cfg: dict) -> List[Spec]:
    """Every tensor of the state dict: (key, shape, kind, fan-in), in a fixed
    order."""
    enc = cfg["encoder"]
    d, p = enc["embed_dim"], enc["patch_size"]
    side = enc["img_size"] // p
    f, oc = cfg["features"], cfg["out_channels"]
    out: List[Spec] = [
        ("pretrained.cls_token", (1, 1, d), "token", 0),
        ("pretrained.mask_token", (1, d), "token", 0),
        ("pretrained.pos_embed", (1, side * side + 1, d), "pos", 0),
    ]
    _conv(out, "pretrained.patch_embed.proj", 3, d, p)
    hidden = ffn_hidden(enc)
    for i in range(enc["depth"]):
        b = f"pretrained.blocks.{i}"
        _norm(out, f"{b}.norm1", d)
        _linear(out, f"{b}.attn.qkv", d, 3 * d)
        _linear(out, f"{b}.attn.proj", d, d)
        out.append((f"{b}.ls1.gamma", (d,), "gamma", 0))
        _norm(out, f"{b}.norm2", d)
        if enc["ffn_layer"] == "mlp":
            _linear(out, f"{b}.mlp.fc1", d, hidden)
            _linear(out, f"{b}.mlp.fc2", hidden, d)
        else:
            _linear(out, f"{b}.mlp.w12", d, 2 * hidden)
            _linear(out, f"{b}.mlp.w3", hidden, d)
        out.append((f"{b}.ls2.gamma", (d,), "gamma", 0))
    _norm(out, "pretrained.norm", d)
    for i in range(4):
        _conv(out, f"head.projects.{i}", d, oc[i], 1)
    out.append(("head.resize_layers.0.weight", (oc[0], oc[0], 4, 4),
                "weight", oc[0]))
    out.append(("head.resize_layers.0.bias", (oc[0],), "bias", 0))
    out.append(("head.resize_layers.1.weight", (oc[1], oc[1], 2, 2),
                "weight", oc[1]))
    out.append(("head.resize_layers.1.bias", (oc[1],), "bias", 0))
    _conv(out, "head.resize_layers.3", oc[3], oc[3], 3)
    for i in range(4):
        _conv(out, f"head.scratch.layer{i + 1}_rn", oc[i], f, 3, bias=False)
    for i in range(1, 5):
        r = f"head.scratch.refinenet{i}"
        for u in (1, 2):
            _conv(out, f"{r}.resConfUnit{u}.conv1", f, f, 3)
            _conv(out, f"{r}.resConfUnit{u}.conv2", f, f, 3)
        _conv(out, f"{r}.out_conv", f, f, 1)
    _conv(out, "head.scratch.output_conv1", f, f // 2, 3)
    _conv(out, "head.scratch.output_conv2.0", f // 2, 32, 3)
    out.append(("head.scratch.output_conv2.2.weight", (1, 32, 1, 1),
                "depth_weight", 32))
    out.append(("head.scratch.output_conv2.2.bias", (1,), "depth_bias", 0))
    mm = cfg["motion"]
    for m, c in enumerate((oc[2], oc[3], f, f)):
        t = f"head.motion_modules.{m}.temporal_transformer"
        _norm(out, f"{t}.norm", c)
        _linear(out, f"{t}.proj_in", c, c)
        for j in range(mm["num_transformer_block"]):
            blk = f"{t}.transformer_blocks.{j}"
            for a in range(mm["num_attention_blocks"]):
                ab = f"{blk}.attention_blocks.{a}"
                for name in ("to_q", "to_k", "to_v"):
                    _linear(out, f"{ab}.{name}", c, c, bias=False)
                _linear(out, f"{ab}.to_out.0", c, c)
                out.append((f"{ab}.pos_encoder.pe", (1, cfg["num_frames"], c),
                            "pe", 0))
                _norm(out, f"{blk}.norms.{a}", c)
            _linear(out, f"{blk}.ff.net.0.proj", c, 8 * c)
            _linear(out, f"{blk}.ff.net.2", 4 * c, c)
            _norm(out, f"{blk}.ff_norm", c)
        _linear(out, f"{t}.proj_out", c, c)
    return out


def make_state_dict(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The fp32 state dict of ``cfg`` drawn from ``seed`` on ``device``."""
    table = specs(cfg)
    sizes = [math.prod(shape) for _, shape, _, _ in table]
    gen = torch.Generator(device=device).manual_seed(generator_seed(seed))
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    sd, off = {}, 0
    for (key, shape, kind, fan_in), n in zip(table, sizes):
        x = flat[off:off + n].view(shape)
        off += n
        if kind == "weight":
            x = x * fan_in ** -0.5
        elif kind in ("bias", "token"):
            x = x * 0.02
        elif kind == "pos":
            x = x * 0.1
        elif kind == "scale":
            x = 1.0 + 0.1 * x
        elif kind == "shift":
            x = 0.1 * x
        elif kind == "gamma":
            x = 0.5 + 0.1 * x
        elif kind == "depth_weight":
            x = x.abs() * fan_in ** -0.5
        elif kind == "depth_bias":
            x = 1.0 + 0.1 * x.abs()
        elif kind == "pe":
            x = sinusoidal_pe(shape[1], shape[2]).to(device)
        else:
            raise ValueError(f"unknown tensor kind {kind!r} of {key}")
        sd[key] = x
    return sd
