"""Temporal DPT head, PyTorch.

Counterpart of ``vda_tpu/models/dpt.py``: tap projections and resize
layers, the four motion modules (on layer_3, layer_4, after refinenet4 and
after refinenet3) with their streaming caches, the refinenet fusions, and
the output tail whose conv2 stack is an fp32 island (reference
dpt_temporal.py:105-108).  The head splits as in JAX into the cache-coupled
``dpt_head_temporal_stage`` and the per-frame ``dpt_head_temporal_tail``.
The TPU-only forms (the out_conv fold, the space-to-depth island, the
lax.scan micro-batching) are not ported: the same values are computed
directly and a Python loop over frame chunks takes the scan's place.  NHWC
throughout; tokens arrive (B*T, N, D).
"""

from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

from vda_tpu_torch.config import ModelConfig
from vda_tpu_torch.models.temporal import TemporalModule, temporal_module_apply
from vda_tpu_torch.ops.layers import Conv2d, ConvTranspose2d, cast_once, conv2d
from vda_tpu_torch.ops.layers import conv_transpose_same_stride
from vda_tpu_torch.ops.resize import resize_bilinear


class ResidualConvUnit(nn.Module):
    def __init__(self, f, device=None):
        super().__init__()
        self.conv1 = Conv2d(f, f, 3, device=device)
        self.conv2 = Conv2d(f, f, 3, device=device)


class FeatureFusionBlock(nn.Module):
    def __init__(self, f, device=None):
        super().__init__()
        self.resConfUnit1 = ResidualConvUnit(f, device=device)
        self.resConfUnit2 = ResidualConvUnit(f, device=device)
        self.out_conv = Conv2d(f, f, 1, device=device)


class Scratch(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        f, oc = cfg.features, cfg.out_channels
        for i in range(4):
            setattr(self, f"layer{i + 1}_rn",
                    Conv2d(oc[i], f, 3, bias=False, device=device))
        for i in range(4):
            setattr(self, f"refinenet{i + 1}", FeatureFusionBlock(f, device))
        self.output_conv1 = Conv2d(f, f // 2, 3, device=device)
        self.output_conv2 = nn.ModuleList([
            Conv2d(f // 2, 32, 3, device=device), nn.ReLU(),
            Conv2d(32, 1, 1, device=device)])


class DPTHeadTemporal(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d, f, oc = cfg.vit.embed_dim, cfg.features, cfg.out_channels
        self.projects = nn.ModuleList(Conv2d(d, oc[i], 1, device=device)
                                      for i in range(4))
        self.resize_layers = nn.ModuleList([
            ConvTranspose2d(oc[0], oc[0], 4, device=device),
            ConvTranspose2d(oc[1], oc[1], 2, device=device),
            nn.Identity(),
            Conv2d(oc[3], oc[3], 3, device=device)])
        self.scratch = Scratch(cfg, device=device)
        self.motion_modules = nn.ModuleList(
            TemporalModule(c, cfg, device=device)
            for c in (oc[2], oc[3], f, f))


def _rcu(p: ResidualConvUnit, x):
    """ResidualConvUnit (reference util/blocks.py:68-91)."""
    out = conv2d(p.conv1, torch.relu(x), padding=1)
    out = conv2d(p.conv2, torch.relu(out), padding=1)
    return out + x


def _fusion(p: FeatureFusionBlock, x, res=None, size=None,
            resize_kernel: bool = False):
    """FeatureFusionBlock (reference util/blocks.py:135-162); its upsample
    goes to K10 where ``resize_kernel`` is set and the gate admits it."""
    out = x
    if res is not None:
        out = out + _rcu(p.resConfUnit1, res)
    out = _rcu(p.resConfUnit2, out)
    if size is None:
        size = (out.shape[1] * 2, out.shape[2] * 2)
    out = resize_bilinear(out, size, align_corners=True, kernel=resize_kernel)
    return conv2d(p.out_conv, out)


def _project_and_resize(head: DPTHeadTemporal, features, patch_hw):
    """Token taps -> four feature maps (reference dpt.py:126-141)."""
    ph, pw = patch_hw
    out = []
    for i, (tokens, _cls) in enumerate(features):
        x = tokens.reshape(tokens.shape[0], ph, pw, tokens.shape[-1])
        x = conv2d(head.projects[i], x)
        rl = head.resize_layers[i]
        if i < 2:
            x = conv_transpose_same_stride(rl, x, 4 if i == 0 else 2)
        elif i == 3:
            x = conv2d(rl, x, stride=2, padding=1)
        out.append(x)
    return out


def _output_tail(head: DPTHeadTemporal, path_3, layer_2_rn, layer_1_rn,
                 out_hw, resize_kernel: bool = False):
    """refinenet2/1 and the output convs; the conv2 stack runs in fp32 with
    the conv0 weight rounded to the working dtype, as the JAX island does
    (reference dpt_temporal.py:98-108).  ``resize_kernel``: the upsamples
    the gate admits (vitl: refinenet1's and the one before the island) run
    in K10."""
    sc = head.scratch
    path_2 = _fusion(sc.refinenet2, path_3, layer_2_rn,
                     size=tuple(layer_1_rn.shape[1:3]),
                     resize_kernel=resize_kernel)
    path_1 = _fusion(sc.refinenet1, path_2, layer_1_rn,
                     resize_kernel=resize_kernel)
    out = conv2d(sc.output_conv1, path_1, padding=1)
    out = resize_bilinear(out, out_hw, align_corners=True,
                          kernel=resize_kernel)
    dtype = out.dtype
    c0, c1 = sc.output_conv2[0], sc.output_conv2[2]
    y = torch.nn.functional.conv2d(
        out.float().permute(0, 3, 1, 2), cast_once(c0.weight, dtype).float(),
        c0.bias.float(), padding=1)
    y = torch.relu(torch.nn.functional.conv2d(torch.relu(y), c1.weight.float(),
                                              c1.bias.float()))
    return y.permute(0, 2, 3, 1).to(dtype)


def dpt_head_temporal_stage(head: DPTHeadTemporal, features, patch_hw,
                            frame_length: int, cfg: ModelConfig,
                            cached_hidden_state_list: Optional[List] = None,
                            cache_kind: str = "h", need_caches: bool = True,
                            kernels: bool = True, resize_kernel: bool = False,
                            ln_kernel: bool | None = None):
    """The cache-coupled front of the head (reference dpt_temporal.py:53-123
    up to refinenet3): tap projections, the four motion modules, the rn
    convs and refinenets 4/3.  ``cached_hidden_state_list`` holds each
    module's contexts in order (two a module); ``cache_kind="kv"`` asks for
    (k, v) cache rows; ``resize_kernel`` lets the refinenets' upsamples take
    K10 where its gate admits them; ``kernels`` / ``ln_kernel``: see
    ``temporal_module_apply``.  Returns ((path_3, l2, l1), new cache
    rows)."""
    sc = head.scratch
    mms = head.motion_modules
    n_cache = 0
    if cached_hidden_state_list is not None:
        n_cache = len(cached_hidden_state_list) // len(mms)

    def temporal(i, x):
        bt, hh, ww, c = x.shape
        xt = x.reshape(bt // frame_length, frame_length, hh, ww, c)
        cache = None
        if n_cache:
            cache = cached_hidden_state_list[i * n_cache:(i + 1) * n_cache]
        y, rows = temporal_module_apply(mms[i], xt, cfg, cache,
                                        want_kv=cache_kind == "kv",
                                        need_caches=need_caches,
                                        kernels=kernels, ln_kernel=ln_kernel)
        return y.reshape(x.shape), rows

    layer_1, layer_2, layer_3, layer_4 = _project_and_resize(head, features,
                                                             patch_hw)
    layer_3, h0 = temporal(0, layer_3)
    layer_4, h1 = temporal(1, layer_4)
    l1 = conv2d(sc.layer1_rn, layer_1, padding=1)
    l2 = conv2d(sc.layer2_rn, layer_2, padding=1)
    l3 = conv2d(sc.layer3_rn, layer_3, padding=1)
    l4 = conv2d(sc.layer4_rn, layer_4, padding=1)
    path_4, h2 = temporal(2, _fusion(sc.refinenet4, l4,
                                     size=tuple(l3.shape[1:3]),
                                     resize_kernel=resize_kernel))
    path_3, h3 = temporal(3, _fusion(sc.refinenet3, path_4, l3,
                                     size=tuple(l2.shape[1:3]),
                                     resize_kernel=resize_kernel))
    return (path_3, l2, l1), h0 + h1 + h2 + h3


def tail_chunks(batch: int, micro_batch_size: int) -> List[int]:
    """Frames in each chunk of the tail, by the JAX rule
    (``vda_tpu/models/dpt.py`` ``dpt_head_temporal_tail``): the whole batch
    at once when it is no larger than ``micro_batch_size`` or not a multiple
    of it, else chunks of ``micro_batch_size``."""
    mb = micro_batch_size
    if batch <= mb or batch % mb:
        return [batch]
    return [mb] * (batch // mb)


def dpt_head_temporal_tail(head: DPTHeadTemporal, stage_out, patch_hw,
                           micro_batch_size: int = 4,
                           resize_kernel: bool = False):
    """The per-frame back of the head (reference dpt_temporal.py:96-123):
    refinenets 2/1 and the output convs over the chunks of ``tail_chunks``.
    Returns depth (B*T, 14*ph, 14*pw, 1)."""
    path_3, l2, l1 = stage_out
    ph, pw = patch_hw
    out_hw = (ph * 14, pw * 14)
    out, i = [], 0
    for n in tail_chunks(l1.shape[0], micro_batch_size):
        out.append(_output_tail(head, path_3[i:i + n], l2[i:i + n],
                                l1[i:i + n], out_hw, resize_kernel))
        i += n
    return torch.cat(out)


def dpt_head_temporal_apply(head: DPTHeadTemporal, features, patch_hw,
                            frame_length: int, cfg: ModelConfig,
                            cached_hidden_state_list: Optional[List] = None,
                            micro_batch_size: int = 4, cache_kind: str = "h",
                            need_caches: bool = True, kernels: bool = True,
                            resize_kernel: bool = False,
                            ln_kernel: bool | None = None):
    """features: four (tokens (B*T, N, D), cls) taps, T == frame_length new
    frames.  Returns (depth (B*T, 14*ph, 14*pw, 1), new cache rows, two a
    motion module).  ``need_caches=False`` (offline windows) lets K3/K4
    take the blocks they admit, which return no cache rows;
    ``resize_kernel`` sends the upsamples K10's gate admits to K10;
    ``ln_kernel`` (default: ``kernels``) the motion modules' LayerNorms to
    K2."""
    stage_out, caches = dpt_head_temporal_stage(
        head, features, patch_hw, frame_length, cfg,
        cached_hidden_state_list=cached_hidden_state_list,
        cache_kind=cache_kind, need_caches=need_caches, kernels=kernels,
        resize_kernel=resize_kernel, ln_kernel=ln_kernel)
    return dpt_head_temporal_tail(head, stage_out, patch_hw,
                                  micro_batch_size, resize_kernel), caches
