"""Plain PyTorch Video Depth Anything: the benchmark's yardstick.

A straightforward float32 implementation of the published model
(DepthAnything/Video-Depth-Anything: ``video_depth_anything/dinov2.py``,
``dpt.py``, ``dpt_temporal.py``, ``motion_module/``), NCHW as the original,
over a state dict in the published key layout; the encoder's feed-forward
is the GELU MLP or, where ``ffn_layer`` is "swiglufused" (vitg), DINOv2's
SwiGLU (``dinov2_layers/swiglu_ffn.py``).  It imports torch and numpy
and nothing of the program under test.  No hand-written kernel, no fused
path, no cache layout of the program: linears are ``x @ W.T + b``,
attention is ``softmax(q k^T / sqrt(d)) v`` computed in blocks of the batch
so that 32 frames of 2443 tokens fit, norms take fp32 statistics.

``fp8=True`` is the control: the same computation with both operands of
every product (linears, convolutions, the attention's q k^T and p v)
rounded to float8 e4m3 with one scale a tensor, accumulated in fp32.  It
stands for the step below the bf16 the configurations are served in.

TF32 is switched off for the process when this module is imported: a fp32
product in TF32 would not be the fp32 reference.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

E4M3_MAX = 448.0
SCORE_BYTES = 1 << 30  # attention scores held at once, per block


def round_fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under one scale (its largest magnitude
    maps to 448), returned in fp32."""
    amax = t.abs().amax().float().clamp_min(1e-12)
    s = amax / E4M3_MAX
    return (t / s).to(torch.float8_e4m3fn).float() * s


class Reference:
    """The model of ``cfg`` (a configuration file's dict) over ``sd``."""

    def __init__(self, cfg: dict, sd: Dict[str, torch.Tensor],
                 fp8: bool = False):
        self.cfg = cfg
        self.sd = sd
        self.fp8 = fp8

    # -- products ----------------------------------------------------------
    def _q(self, t):
        return round_fp8(t) if self.fp8 else t

    def linear(self, x, key: str, bias: bool = True):
        b = self.sd[f"{key}.bias"] if bias else None
        return F.linear(self._q(x), self._q(self.sd[f"{key}.weight"]), b)

    def conv(self, x, key: str, stride: int = 1, padding: int = 0,
             bias: bool = True):
        b = self.sd[f"{key}.bias"] if bias else None
        return F.conv2d(self._q(x), self._q(self.sd[f"{key}.weight"]), b,
                        stride=stride, padding=padding)

    def conv_transpose(self, x, key: str, k: int):
        return F.conv_transpose2d(self._q(x),
                                  self._q(self.sd[f"{key}.weight"]),
                                  self.sd[f"{key}.bias"], stride=k)

    def attention(self, q, k, v, heads: int):
        """q (B, Tq, C), k / v (B, T, C) -> (B, Tq, C), per head, in blocks
        of the batch.  One query a sequence (a stream step) takes the
        products as sums over broadcast rows, which read k and v in place."""
        b, tq, c = q.shape
        t = k.shape[1]
        dh = c // heads
        q, k, v = self._q(q), self._q(k), self._q(v)
        if tq == 1:
            s = (q.view(b, 1, heads, dh) * k.view(b, t, heads, dh)).sum(-1)
            p = self._q(torch.softmax(s * dh ** -0.5, dim=1))
            return (p.unsqueeze(-1) * v.view(b, t, heads, dh)).sum(1) \
                .view(b, 1, c)
        q = q.view(b, tq, heads, dh).transpose(1, 2)
        k = k.view(b, t, heads, dh).transpose(1, 2)
        v = v.view(b, t, heads, dh).transpose(1, 2)
        step = max(1, SCORE_BYTES // (heads * tq * t * 4))
        out = []
        for i in range(0, b, step):
            s = torch.matmul(q[i:i + step], k[i:i + step].transpose(-1, -2))
            p = torch.softmax(s * dh ** -0.5, dim=-1)
            out.append(torch.matmul(self._q(p), v[i:i + step]))
        return torch.cat(out).transpose(1, 2).reshape(b, tq, c)

    # -- norms ---------------------------------------------------------------
    def layer_norm(self, x, key: str, eps: float):
        return F.layer_norm(x, x.shape[-1:], self.sd[f"{key}.weight"],
                            self.sd[f"{key}.bias"], eps)

    def group_norm(self, x, key: str, groups: int, eps: float):
        return F.group_norm(x, groups, self.sd[f"{key}.weight"],
                            self.sd[f"{key}.bias"], eps)

    # -- encoder (dinov2.py) -------------------------------------------------
    def pos_embed(self, gh: int, gw: int):
        enc = self.cfg["encoder"]
        pe = self.sd["pretrained.pos_embed"]
        n = pe.shape[1] - 1
        if gh * gw == n and gh == gw:
            return pe
        m = int(math.sqrt(n))
        off = enc["interpolate_offset"]
        patch = pe[:, 1:].reshape(1, m, m, -1).permute(0, 3, 1, 2)
        patch = F.interpolate(patch, scale_factor=((gh + off) / m,
                                                   (gw + off) / m),
                              mode="bicubic", antialias=False)
        if tuple(patch.shape[-2:]) != (gh, gw):
            raise ValueError(f"position grid {tuple(patch.shape[-2:])}, "
                             f"expected {(gh, gw)}")
        return torch.cat([pe[:, :1], patch.permute(0, 2, 3, 1)
                          .reshape(1, gh * gw, -1)], dim=1)

    def block(self, i: int, x):
        enc = self.cfg["encoder"]
        b = f"pretrained.blocks.{i}"
        heads = enc["num_heads"]
        n, d = x.shape[1], x.shape[2]
        h = self.layer_norm(x, f"{b}.norm1", 1e-6)
        qkv = self.linear(h, f"{b}.attn.qkv")
        q, k, v = qkv.split(d, dim=-1)
        o = self.attention(q, k, v, heads)
        x = x + self.linear(o, f"{b}.attn.proj") * self.sd[f"{b}.ls1.gamma"]
        h = self.layer_norm(x, f"{b}.norm2", 1e-6)
        if enc["ffn_layer"] == "mlp":
            h = self.linear(F.gelu(self.linear(h, f"{b}.mlp.fc1")),
                            f"{b}.mlp.fc2")
        else:  # DINOv2 SwiGLUFFNFused
            x1, x2 = self.linear(h, f"{b}.mlp.w12").chunk(2, dim=-1)
            h = self.linear(F.silu(x1) * x2, f"{b}.mlp.w3")
        return x + h * self.sd[f"{b}.ls2.gamma"]

    def encode(self, x) -> List[torch.Tensor]:
        """x (B, 3, H, W) normalised -> the four taps' patch tokens
        (B, N, D), final norm applied (``get_intermediate_layers``)."""
        enc = self.cfg["encoder"]
        p = enc["patch_size"]
        bsz, _, hh, ww = x.shape
        t = self.conv(x, "pretrained.patch_embed.proj", stride=p)
        t = t.flatten(2).transpose(1, 2)
        cls = self.sd["pretrained.cls_token"].expand(bsz, -1, -1)
        t = torch.cat([cls, t], dim=1) + self.pos_embed(hh // p, ww // p)
        taps = set(self.cfg["intermediate_layer_idx"])
        outs = {}
        for i in range(enc["depth"]):
            t = self.block(i, t)
            if i in taps:
                outs[i] = t
        return [self.layer_norm(outs[i], "pretrained.norm", 1e-6)[:, 1:]
                for i in self.cfg["intermediate_layer_idx"]]

    # -- motion modules (motion_module.py) -----------------------------------
    def temporal_attention(self, key: str, h, cache, rows: bool = False):
        """h (BD, Tn, C) normed rows.  ``cache``: None, or the context's
        (k, v), the bias-free ``to_k`` / ``to_v`` projections of its earlier
        normed rows: a row's projection with its position code added is
        the sum of the two projections, so a stream projects each row once.
        Returns (out, this call's (k, v) rows where ``cache`` or ``rows``
        asks for them)."""
        pe = self.sd[f"{key}.pos_encoder.pe"][0]
        t_ctx = 0 if cache is None else cache[0].shape[1]
        t = t_ctx + h.shape[1]
        new = None
        if cache is not None or rows:
            new = (self.linear(h, f"{key}.to_k", bias=False),
                   self.linear(h, f"{key}.to_v", bias=False))
        if cache is None:
            x = h + pe[:t]
            q = self.linear(x, f"{key}.to_q", bias=False)
            k = self.linear(x, f"{key}.to_k", bias=False)
            v = self.linear(x, f"{key}.to_v", bias=False)
        else:
            q = self.linear(h + pe[t_ctx:t], f"{key}.to_q", bias=False)
            k = torch.cat([cache[0], new[0]], dim=1) \
                + self.linear(pe[:t], f"{key}.to_k", bias=False)
            v = torch.cat([cache[1], new[1]], dim=1) \
                + self.linear(pe[:t], f"{key}.to_v", bias=False)
        o = self.attention(q, k, v, self.cfg["motion"]["num_attention_heads"])
        return self.linear(o, f"{key}.to_out.0"), new

    def motion_module(self, m: int, x, frames: int, cache=None,
                      rows: bool = False):
        """x (B*T, C, h, w) -> (same, the (k, v) cache rows of its attention
        blocks, None unless ``cache`` or ``rows``).  ``cache``: one (k, v)
        context an attention block."""
        mm = self.cfg["motion"]
        t = f"head.motion_modules.{m}.temporal_transformer"
        bt, c, hh, ww = x.shape
        b = bt // frames
        h = self.group_norm(x, f"{t}.norm", mm["norm_num_groups"], 1e-6)
        h = h.permute(0, 2, 3, 1).reshape(bt, hh * ww, c)
        h = self.linear(h, f"{t}.proj_in")
        h = h.reshape(b, frames, hh * ww, c).transpose(1, 2) \
            .reshape(b * hh * ww, frames, c)
        new_rows, n = [], mm["num_attention_blocks"]
        for j in range(mm["num_transformer_block"]):
            blk = f"{t}.transformer_blocks.{j}"
            for a in range(n):
                hn = self.layer_norm(h, f"{blk}.norms.{a}", 1e-5)
                ctx = None if cache is None else cache[j * n + a]
                o, r = self.temporal_attention(
                    f"{blk}.attention_blocks.{a}", hn, ctx, rows)
                h = o + h
                new_rows.append(r)
            hn = self.layer_norm(h, f"{blk}.ff_norm", 1e-5)
            y, gate = self.linear(hn, f"{blk}.ff.net.0.proj").chunk(2, -1)
            h = self.linear(y * F.gelu(gate), f"{blk}.ff.net.2") + h
        h = h.reshape(b, hh * ww, frames, c).transpose(1, 2) \
            .reshape(bt, hh * ww, c)
        h = self.linear(h, f"{t}.proj_out")
        return h.reshape(bt, hh, ww, c).permute(0, 3, 1, 2) + x, new_rows

    # -- DPT head (dpt.py, dpt_temporal.py, util/blocks.py) ------------------
    def rcu(self, key: str, x):
        out = self.conv(F.relu(x), f"{key}.conv1", padding=1)
        out = self.conv(F.relu(out), f"{key}.conv2", padding=1)
        return out + x

    def fusion(self, i: int, x, res=None, size=None):
        key = f"head.scratch.refinenet{i}"
        if res is not None:
            x = x + self.rcu(f"{key}.resConfUnit1", res)
        x = self.rcu(f"{key}.resConfUnit2", x)
        if size is None:
            size = (x.shape[2] * 2, x.shape[3] * 2)
        x = F.interpolate(x, size=size, mode="bilinear", align_corners=True)
        return self.conv(x, f"{key}.out_conv")

    def head_stage(self, taps: Sequence[torch.Tensor], patch_hw, frames: int,
                   cache: Optional[list] = None, rows: bool = False):
        """The taps of B*T frames -> ((path_3, layer_2_rn, layer_1_rn), the
        new (k, v) cache rows, two a motion module, where ``cache`` or
        ``rows`` asks for them).  ``cache``: the (k, v) contexts, two a
        motion module, in order."""
        ph, pw = patch_hw
        per = len(cache) // 4 if cache is not None else 0
        outs = []
        for i, tok in enumerate(taps):
            x = tok.transpose(1, 2).reshape(tok.shape[0], tok.shape[2], ph, pw)
            x = self.conv(x, f"head.projects.{i}")
            if i == 0:
                x = self.conv_transpose(x, "head.resize_layers.0", 4)
            elif i == 1:
                x = self.conv_transpose(x, "head.resize_layers.1", 2)
            elif i == 3:
                x = self.conv(x, "head.resize_layers.3", stride=2, padding=1)
            outs.append(x)
        l1, l2, l3, l4 = outs

        def mm(i, x):
            ctx = None if cache is None else cache[i * per:(i + 1) * per]
            return self.motion_module(i, x, frames, ctx, rows)

        l3, r0 = mm(0, l3)
        l4, r1 = mm(1, l4)
        sc = "head.scratch"
        rn1 = self.conv(l1, f"{sc}.layer1_rn", padding=1, bias=False)
        rn2 = self.conv(l2, f"{sc}.layer2_rn", padding=1, bias=False)
        rn3 = self.conv(l3, f"{sc}.layer3_rn", padding=1, bias=False)
        rn4 = self.conv(l4, f"{sc}.layer4_rn", padding=1, bias=False)
        p4, r2 = mm(2, self.fusion(4, rn4, size=rn3.shape[2:]))
        p3, r3 = mm(3, self.fusion(3, p4, rn3, size=rn2.shape[2:]))
        return (p3, rn2, rn1), r0 + r1 + r2 + r3

    def head_tail(self, stage, patch_hw, chunk: int = 4):
        """(path_3, layer_2_rn, layer_1_rn) -> depth (B*T, 1, 14 ph, 14 pw),
        ``chunk`` frames at a time (the reference's micro-batches)."""
        p3, rn2, rn1 = stage
        sc = "head.scratch"
        out = []
        for i in range(0, rn1.shape[0], chunk):
            s = slice(i, i + chunk)
            p2 = self.fusion(2, p3[s], rn2[s], size=rn1.shape[2:])
            p1 = self.fusion(1, p2, rn1[s])
            y = self.conv(p1, f"{sc}.output_conv1", padding=1)
            y = F.interpolate(y, size=(patch_hw[0] * 14, patch_hw[1] * 14),
                              mode="bilinear", align_corners=True)
            y = F.relu(self.conv(y, f"{sc}.output_conv2.0", padding=1))
            out.append(F.relu(self.conv(y, f"{sc}.output_conv2.2")))
        return torch.cat(out)

    def depth(self, stage, net_hw, out_hw, chunk: int = 4):
        """Tail, resize to the network size and ReLU (vda.forward), then the
        resize to the frame size: (B*T, H, W) fp32."""
        p = self.cfg["encoder"]["patch_size"]
        d = self.head_tail(stage, (net_hw[0] // p, net_hw[1] // p), chunk)
        d = F.relu(F.interpolate(d, size=net_hw, mode="bilinear",
                                 align_corners=True))
        d = F.interpolate(d, size=out_hw, mode="bilinear", align_corners=True)
        return d[:, 0]

    def forward_window(self, x, out_hw):
        """x (T, 3, h, w) normalised frames of one window -> their depths
        (T, H, W) at the frame size."""
        p = self.cfg["encoder"]["patch_size"]
        net_hw = tuple(x.shape[2:])
        taps = self.encode(x)
        stage, _ = self.head_stage(taps, (net_hw[0] // p, net_hw[1] // p),
                                   x.shape[0])
        del taps
        return self.depth(stage, net_hw, out_hw)
