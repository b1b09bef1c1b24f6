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

``save_params_npz`` / ``load_params_npz`` write and read the JAX package's
own ``.npz`` params format (``vda_tpu/utils/convert.py:429-451``): one
array a pytree leaf, named by its ``"/"``-joined dict keys and list
indices, so a file written by either package loads in the other.  They go
through copies of JAX's numpy-only ``convert_state_dict`` (reference state
dict -> params pytree) and ``export_state_dict`` (the inverse, which also
takes the tensor-parallel layout's (d, 3, d) qkv leaves, reshaped to (d,
3d) as ``vda_tpu/parallel/mesh.from_tp_layout`` does).  bf16 leaves (a file
of JAX's inference-cast params) are stored as JAX's file stores them, two
raw bytes a value (numpy reads them back as ``|V2``), and read back exactly.
``load_npz_checkpoint`` loads such a file into a model.

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
from vda_tpu_torch.models.temporal import sinusoidal_pe
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


# --- the JAX package's params pytree and its .npz file ----------------------
# convert_state_dict and export_state_dict below, with their helpers, are
# copies of vda_tpu/utils/convert.py's (numpy only), held to them by
# tests/test_torch_copies.py.


def _t(a):  # linear weight
    return np.ascontiguousarray(np.asarray(a).T)


def _conv(a):  # OIHW -> HWIO
    return np.ascontiguousarray(np.transpose(np.asarray(a), (2, 3, 1, 0)))


def _deconv(a):  # (Cin, Cout, kH, kW) -> (Cin, kH, kW, Cout)
    return np.ascontiguousarray(np.transpose(np.asarray(a), (0, 2, 3, 1)))


def _arr(a):
    return np.ascontiguousarray(np.asarray(a))


class _Reader:
    def __init__(self, sd: Dict[str, np.ndarray]):
        self.sd = dict(sd)
        self.used = set()

    def __call__(self, key: str, fn=_arr):
        if key not in self.sd:
            raise KeyError(f"checkpoint missing key: {key}")
        self.used.add(key)
        return fn(self.sd[key])

    def has(self, key: str) -> bool:
        return key in self.sd

    def leftover(self):
        return [k for k in self.sd if k not in self.used]


def _convert_linear(r, prefix, bias=True):
    p = {"w": r(f"{prefix}.weight", _t)}
    if bias and r.has(f"{prefix}.bias"):
        p["b"] = r(f"{prefix}.bias")
    return p


def _convert_conv(r, prefix, bias=True):
    p = {"w": r(f"{prefix}.weight", _conv)}
    if bias and r.has(f"{prefix}.bias"):
        p["b"] = r(f"{prefix}.bias")
    return p


def _convert_ln(r, prefix):
    return {"scale": r(f"{prefix}.weight"), "bias": r(f"{prefix}.bias")}


def _convert_block(r, prefix, ffn_layer):
    p = {
        "norm1": _convert_ln(r, f"{prefix}.norm1"),
        "attn": {
            "qkv": _convert_linear(r, f"{prefix}.attn.qkv"),
            "proj": _convert_linear(r, f"{prefix}.attn.proj"),
        },
        "ls1": r(f"{prefix}.ls1.gamma"),
        "norm2": _convert_ln(r, f"{prefix}.norm2"),
        "ls2": r(f"{prefix}.ls2.gamma"),
    }
    if ffn_layer == "swiglufused":
        p["mlp"] = {
            "w12": _convert_linear(r, f"{prefix}.mlp.w12"),
            "w3": _convert_linear(r, f"{prefix}.mlp.w3"),
        }
    else:
        p["mlp"] = {
            "fc1": _convert_linear(r, f"{prefix}.mlp.fc1"),
            "fc2": _convert_linear(r, f"{prefix}.mlp.fc2"),
        }
    return p


def _convert_encoder(r, cfg: ModelConfig):
    vit = cfg.vit
    return {
        "cls_token": r("pretrained.cls_token").reshape(-1),
        "pos_embed": r("pretrained.pos_embed"),
        "mask_token": r("pretrained.mask_token").reshape(-1),
        "patch_embed": _convert_conv(r, "pretrained.patch_embed.proj"),
        "blocks": [
            _convert_block(r, f"pretrained.blocks.{i}", vit.ffn_layer)
            for i in range(vit.depth)
        ],
        "norm": _convert_ln(r, "pretrained.norm"),
    }


def _convert_rcu(r, prefix):
    return {
        "conv1": _convert_conv(r, f"{prefix}.conv1"),
        "conv2": _convert_conv(r, f"{prefix}.conv2"),
    }


def _convert_fusion(r, prefix):
    return {
        "rcu1": _convert_rcu(r, f"{prefix}.resConfUnit1"),
        "rcu2": _convert_rcu(r, f"{prefix}.resConfUnit2"),
        "out_conv": _convert_conv(r, f"{prefix}.out_conv"),
    }


def _convert_motion_module(r, prefix, cfg: ModelConfig):
    tt = f"{prefix}.temporal_transformer"
    blocks = []
    for b in range(cfg.num_transformer_block):
        bp = f"{tt}.transformer_blocks.{b}"
        attn, norms = [], []
        for a in range(cfg.num_attention_blocks):
            ap = f"{bp}.attention_blocks.{a}"
            # pos_encoder.pe is a deterministic sinusoidal buffer
            # (reference motion_module.py:201-206): consumed, not kept
            if r.has(f"{ap}.pos_encoder.pe"):
                r(f"{ap}.pos_encoder.pe")
            attn.append({
                "to_q": _convert_linear(r, f"{ap}.to_q"),
                "to_k": _convert_linear(r, f"{ap}.to_k"),
                "to_v": _convert_linear(r, f"{ap}.to_v"),
                "to_out": _convert_linear(r, f"{ap}.to_out.0"),
            })
            norms.append(_convert_ln(r, f"{bp}.norms.{a}"))
        blocks.append({
            "attn": attn,
            "norms": norms,
            "ff": {
                "proj": _convert_linear(r, f"{bp}.ff.net.0.proj"),
                "out": _convert_linear(r, f"{bp}.ff.net.2"),
            },
            "ff_norm": _convert_ln(r, f"{bp}.ff_norm"),
        })
    return {
        "norm": _convert_ln(r, f"{tt}.norm"),
        "proj_in": _convert_linear(r, f"{tt}.proj_in"),
        "blocks": blocks,
        "proj_out": _convert_linear(r, f"{tt}.proj_out"),
    }


def _convert_head(r, cfg: ModelConfig):
    p = {
        "projects": [_convert_conv(r, f"head.projects.{i}") for i in range(4)],
        "resize0": {
            "w": r("head.resize_layers.0.weight", _deconv),
            "b": r("head.resize_layers.0.bias"),
        },
        "resize1": {
            "w": r("head.resize_layers.1.weight", _deconv),
            "b": r("head.resize_layers.1.bias"),
        },
        "resize3": _convert_conv(r, "head.resize_layers.3"),
        "scratch": {
            f"layer{i}_rn": _convert_conv(r, f"head.scratch.layer{i}_rn")
            for i in range(1, 5)
        },
        "output_conv1": _convert_conv(r, "head.scratch.output_conv1"),
        "output_conv2": {
            "conv0": _convert_conv(r, "head.scratch.output_conv2.0"),
            "conv1": _convert_conv(r, "head.scratch.output_conv2.2"),
        },
    }
    for j in range(1, 5):
        p[f"refinenet{j}"] = _convert_fusion(r, f"head.scratch.refinenet{j}")
    p["motion_modules"] = [
        _convert_motion_module(r, f"head.motion_modules.{i}", cfg)
        for i in range(4)
    ]
    return p


def convert_state_dict(state_dict: Dict[str, "np.ndarray"], cfg: ModelConfig,
                       strict: bool = True):
    """A reference-format state dict (name -> array; numpy arrays or torch
    tensors) as the JAX package's params pytree (nested dicts and lists of
    fp32 numpy arrays: linear weights (in, out), convs HWIO, transposed
    convs (Cin, kH, kW, Cout), the tokens as vectors, no ``pos_encoder``
    buffers).  Strict: every key consumed, every leaf produced."""
    sd = {}
    for k, v in state_dict.items():
        if hasattr(v, "detach"):
            v = v.detach().cpu().numpy()
        sd[k] = np.asarray(v, dtype=np.float32)
    r = _Reader(sd)
    params = {
        "pretrained": _convert_encoder(r, cfg),
        "head": _convert_head(r, cfg),
    }
    if strict:
        left = r.leftover()
        if left:
            raise ValueError(f"unconsumed checkpoint keys: {left[:10]}"
                             f" (+{max(0, len(left) - 10)} more)")
    return params


def _it(a):  # linear weight inverse: (in, out) -> (out, in)
    return np.ascontiguousarray(np.asarray(a, np.float32).T)


def _iconv(a):  # HWIO -> OIHW
    return np.ascontiguousarray(
        np.transpose(np.asarray(a, np.float32), (3, 2, 0, 1)))


def _ideconv(a):  # (Cin, kH, kW, Cout) -> (Cin, Cout, kH, kW)
    return np.ascontiguousarray(
        np.transpose(np.asarray(a, np.float32), (0, 3, 1, 2)))


def _iarr(a):
    return np.ascontiguousarray(np.asarray(a, np.float32))


def _export_linear(out, p, prefix):
    out[f"{prefix}.weight"] = _it(p["w"])
    if "b" in p:
        out[f"{prefix}.bias"] = _iarr(p["b"])


def _export_conv(out, p, prefix):
    out[f"{prefix}.weight"] = _iconv(p["w"])
    if "b" in p:
        out[f"{prefix}.bias"] = _iarr(p["b"])


def _export_ln(out, p, prefix):
    out[f"{prefix}.weight"] = _iarr(p["scale"])
    out[f"{prefix}.bias"] = _iarr(p["bias"])


def _from_tp_layout(params):
    """``vda_tpu/parallel/mesh.from_tp_layout`` in numpy: each encoder
    block's (d, 3, d) qkv weight and (3, d) bias back to (d, 3d) and (3d,),
    in a copy of the params' containers."""
    enc = dict(params["pretrained"])
    blocks = []
    for bp in enc["blocks"]:
        qkv = bp["attn"]["qkv"]
        if np.ndim(qkv["w"]) == 3:
            d = qkv["w"].shape[0]
            qkv = {**qkv, "w": np.reshape(qkv["w"], (d, 3 * d))}
            if "b" in qkv:
                qkv["b"] = np.reshape(qkv["b"], (3 * d,))
            bp = {**bp, "attn": {**bp["attn"], "qkv": qkv}}
        blocks.append(bp)
    enc["blocks"] = blocks
    return {**params, "pretrained": enc}


def export_state_dict(params, cfg: ModelConfig) -> Dict[str, np.ndarray]:
    """Inverse of ``convert_state_dict``: the params pytree as a
    reference-format state dict (fp32 numpy arrays, the reference's key
    names and layouts), with the ``pos_encoder.pe`` buffers the reference
    registers under APE.  Tensor-parallel params (3-dim qkv leaves) are
    taken back to the plain layout first."""
    if np.ndim(params["pretrained"]["blocks"][0]["attn"]["qkv"]["w"]) == 3:
        params = _from_tp_layout(params)

    out: Dict[str, np.ndarray] = {}
    enc = params["pretrained"]
    vit = cfg.vit
    out["pretrained.cls_token"] = _iarr(enc["cls_token"]).reshape(1, 1, -1)
    out["pretrained.mask_token"] = _iarr(enc["mask_token"]).reshape(1, -1)
    out["pretrained.pos_embed"] = _iarr(enc["pos_embed"])
    _export_conv(out, enc["patch_embed"], "pretrained.patch_embed.proj")
    for i, bp in enumerate(enc["blocks"]):
        pre = f"pretrained.blocks.{i}"
        _export_ln(out, bp["norm1"], f"{pre}.norm1")
        _export_linear(out, bp["attn"]["qkv"], f"{pre}.attn.qkv")
        _export_linear(out, bp["attn"]["proj"], f"{pre}.attn.proj")
        out[f"{pre}.ls1.gamma"] = _iarr(bp["ls1"])
        _export_ln(out, bp["norm2"], f"{pre}.norm2")
        out[f"{pre}.ls2.gamma"] = _iarr(bp["ls2"])
        if vit.ffn_layer == "swiglufused":
            _export_linear(out, bp["mlp"]["w12"], f"{pre}.mlp.w12")
            _export_linear(out, bp["mlp"]["w3"], f"{pre}.mlp.w3")
        else:
            _export_linear(out, bp["mlp"]["fc1"], f"{pre}.mlp.fc1")
            _export_linear(out, bp["mlp"]["fc2"], f"{pre}.mlp.fc2")
    _export_ln(out, enc["norm"], "pretrained.norm")

    head = params["head"]
    for i in range(4):
        _export_conv(out, head["projects"][i], f"head.projects.{i}")
    out["head.resize_layers.0.weight"] = _ideconv(head["resize0"]["w"])
    out["head.resize_layers.0.bias"] = _iarr(head["resize0"]["b"])
    out["head.resize_layers.1.weight"] = _ideconv(head["resize1"]["w"])
    out["head.resize_layers.1.bias"] = _iarr(head["resize1"]["b"])
    _export_conv(out, head["resize3"], "head.resize_layers.3")
    for i in range(1, 5):
        _export_conv(out, head["scratch"][f"layer{i}_rn"],
                     f"head.scratch.layer{i}_rn")
    for j in range(1, 5):
        fp = head[f"refinenet{j}"]
        pre = f"head.scratch.refinenet{j}"
        for rcu, rp in (("rcu1", "resConfUnit1"), ("rcu2", "resConfUnit2")):
            _export_conv(out, fp[rcu]["conv1"], f"{pre}.{rp}.conv1")
            _export_conv(out, fp[rcu]["conv2"], f"{pre}.{rp}.conv2")
        _export_conv(out, fp["out_conv"], f"{pre}.out_conv")
    _export_conv(out, head["output_conv1"], "head.scratch.output_conv1")
    _export_conv(out, head["output_conv2"]["conv0"],
                 "head.scratch.output_conv2.0")
    _export_conv(out, head["output_conv2"]["conv1"],
                 "head.scratch.output_conv2.2")

    for i, mm in enumerate(head["motion_modules"]):
        tt = f"head.motion_modules.{i}.temporal_transformer"
        _export_ln(out, mm["norm"], f"{tt}.norm")
        _export_linear(out, mm["proj_in"], f"{tt}.proj_in")
        for b, bp in enumerate(mm["blocks"]):
            bpre = f"{tt}.transformer_blocks.{b}"
            for a, ap in enumerate(bp["attn"]):
                apre = f"{bpre}.attention_blocks.{a}"
                _export_linear(out, ap["to_q"], f"{apre}.to_q")
                _export_linear(out, ap["to_k"], f"{apre}.to_k")
                _export_linear(out, ap["to_v"], f"{apre}.to_v")
                _export_linear(out, ap["to_out"], f"{apre}.to_out.0")
                if cfg.pe == "ape":
                    # the buffer the reference registers (max_len =
                    # num_frames, dpt_temporal.py:38)
                    c = np.asarray(ap["to_q"]["w"]).shape[0]
                    out[f"{apre}.pos_encoder.pe"] = sinusoidal_pe(
                        cfg.num_frames, c).numpy()
                _export_ln(out, bp["norms"][a], f"{bpre}.norms.{a}")
            _export_linear(out, bp["ff"]["proj"], f"{bpre}.ff.net.0.proj")
            _export_linear(out, bp["ff"]["out"], f"{bpre}.ff.net.2")
            _export_ln(out, bp["ff_norm"], f"{bpre}.ff_norm")
        _export_linear(out, mm["proj_out"], f"{tt}.proj_out")
    return out


def _flatten(tree, prefix=""):
    """(name, leaf) of a params pytree, named as JAX's ``save_params_npz``
    names them: dict keys and list indices joined by "/", in JAX's leaf
    order (dict keys sorted)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def _unflatten(flat: Dict[str, np.ndarray]):
    """The params pytree of "/"-joined names: a level whose keys are all
    indices is a list."""
    root: dict = {}
    for name, leaf in flat.items():
        *path, last = name.split("/")
        node = root
        for k in path:
            node = node.setdefault(k, {})
        node[last] = leaf

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    return lists(root)


BF16_BYTES = np.dtype("V2")  # a bf16 leaf as numpy reads it without ml_dtypes


def _bf16_bytes(a: np.ndarray) -> np.ndarray:
    """fp32 values that are bf16 values, as the two bytes a value of a bf16
    leaf (the upper half of each fp32).  Raises where a value is not a bf16
    value: the file would not hold the model's bits."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
    if (bits & 0xFFFF).any():
        raise ValueError("a leaf the inference cast stores in bf16 holds "
                         "values that are not bf16")
    return (bits >> 16).astype(np.uint16).view(BF16_BYTES)


def _from_file(a: np.ndarray) -> np.ndarray:
    """A leaf read from an .npz, fp32: a bf16 leaf (``|V2``) widened
    exactly."""
    if a.dtype == BF16_BYTES:
        return (a.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
    return np.asarray(a, np.float32)


def _cast_by_jax(name: str, leaf: np.ndarray) -> bool:
    """JAX's ``cast_params_for_inference`` rule on a params leaf: matrices
    and conv kernels, except the fp32 output island's."""
    return "output_conv2" not in name and np.ndim(leaf) >= 2


def save_params_npz(path: str, model: VideoDepthAnything) -> None:
    """Write ``model`` as the JAX package's ``.npz`` params file: one array
    a pytree leaf, on JAX's names (``vda_tpu/utils/convert.py:429``).  A
    model whose weights were cast to bf16 (``cast_params_for_inference``)
    is written as a file of JAX's cast params: the leaves JAX's cast stores
    in bf16 as bf16, the others fp32; an uncast model all fp32."""
    sd = model.state_dict()
    cast = any(v.dtype == torch.bfloat16 for v in sd.values())
    params = convert_state_dict(
        {k: v.detach().float().cpu().numpy() for k, v in sd.items()},
        model.cfg)
    np.savez(path, **{name: _bf16_bytes(leaf) if cast and _cast_by_jax(
        name, leaf) else leaf for name, leaf in _flatten(params)})


def load_params_npz(path: str):
    """The params pytree of a JAX-package ``.npz`` file (nested dicts and
    lists of fp32 numpy arrays; bf16 leaves widened exactly), as
    ``vda_tpu/utils/convert.py:load_params_npz`` reads it into its
    template."""
    with np.load(path) as data:
        return _unflatten({name: _from_file(data[name])
                           for name in data.files})


def load_npz_checkpoint(path: str,
                        model: VideoDepthAnything) -> VideoDepthAnything:
    """Load a JAX-package ``.npz`` params file into ``model``, strictly
    (``load_params_npz`` -> ``export_state_dict`` ->
    ``load_state_dict_numpy``); tensor-parallel files included.  A file
    that lacks a leaf of the model raises ``ValueError``."""
    params = load_params_npz(path)
    try:
        sd = export_state_dict(params, model.cfg)
    except (KeyError, IndexError, TypeError) as e:
        raise ValueError(f"{path}: not the JAX package's params of a "
                         f"{model.cfg.encoder!r} model (no {e})") from e
    return load_state_dict_numpy(model, sd)
