"""Generic cross-attention and feed-forward library, PyTorch.

Counterpart of ``vda_tpu/models/cross_attention.py``, itself a rebuild of
the reference's diffusers-derived CrossAttention / FeedForward
(video_depth_anything/motion_module/attention.py):

  * ``cross_attention``: self- or cross-attention (``encoder_hidden_states``),
    to_q/k/v without bias by default, an optional token GroupNorm, optional
    added-kv projections, and an additive attention mask (reference
    attention.py:125-211);
  * ``feed_forward``: GEGLU, GELU and the sigmoid-approximated GELU
    (reference attention.py:296-400).

Module names follow the JAX parameter keys (``to_q``, ``to_k``, ``to_v``,
``to_out``, ``add_k_proj``, ``add_v_proj``, ``group_norm``; ``proj``,
``out``); ``utils.convert.load_cross_attention_numpy`` loads JAX params.
Both modules are built on the card unless the caller passes
``device="cpu"``.
Without a mask the attention goes through ``ops.attention``
``dot_product_attention``: ``impl="auto"`` takes K9 where its gate admits
the shape (self-attention of at least 512 tokens), ``impl="plain"`` (the
default, as JAX's ``"xla"``) never does.  A mask takes the plain einsum
form, as in JAX.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from vda_tpu_torch.ops.attention import dot_product_attention
from vda_tpu_torch.ops.layers import Linear, Norm, gelu, linear


class CrossAttention(nn.Module):
    """Parameters of reference CrossAttention.__init__ (attention.py:45-91);
    ``norm_num_groups`` adds the GroupNorm over the inner width that
    ``cross_attention(group_norm_groups=...)`` applies."""

    def __init__(self, query_dim: int,
                 cross_attention_dim: Optional[int] = None, heads: int = 8,
                 dim_head: int = 64, bias: bool = False,
                 added_kv_proj_dim: Optional[int] = None,
                 norm_num_groups: Optional[int] = None, device="cuda"):
        super().__init__()
        inner = heads * dim_head
        cross = cross_attention_dim or query_dim
        self.heads = heads
        self.to_q = Linear(query_dim, inner, bias=bias, device=device)
        self.to_k = Linear(cross, inner, bias=bias, device=device)
        self.to_v = Linear(cross, inner, bias=bias, device=device)
        self.to_out = Linear(inner, query_dim, device=device)
        self.add_k_proj = self.add_v_proj = self.group_norm = None
        if added_kv_proj_dim is not None:
            self.add_k_proj = Linear(added_kv_proj_dim, cross, device=device)
            self.add_v_proj = Linear(added_kv_proj_dim, cross, device=device)
        if norm_num_groups is not None:
            self.group_norm = Norm(inner, device=device)

    def forward(self, hidden_states, encoder_hidden_states=None,
                attention_mask=None, group_norm_groups=None, impl="plain"):
        return cross_attention(self, hidden_states, encoder_hidden_states,
                               attention_mask, group_norm_groups, impl)


class FeedForward(nn.Module):
    """Parameters of the reference FeedForward: ``proj`` (to twice the
    inner width for GEGLU) and ``out``."""

    def __init__(self, dim: int, dim_out: Optional[int] = None, mult: int = 4,
                 activation_fn: str = "geglu", device="cuda"):
        super().__init__()
        inner = int(dim * mult)
        self.activation_fn = activation_fn
        self.proj = Linear(dim, 2 * inner if activation_fn == "geglu"
                           else inner, device=device)
        self.out = Linear(inner, dim_out or dim, device=device)

    def forward(self, x):
        return feed_forward(self, x, self.activation_fn)


def cross_attention(p: CrossAttention, hidden_states,
                    encoder_hidden_states=None, attention_mask=None,
                    group_norm_groups: Optional[int] = None,
                    impl: str = "plain"):
    """Reference CrossAttention.forward (attention.py:125-180).

    hidden_states: (B, N, C).  encoder_hidden_states: optional (B, M, C').
    attention_mask: an ADDITIVE mask broadcastable to (B, heads, N, M); the
    caller owns the reference's pad/repeat_interleave preprocessing
    (attention.py:157-162)."""
    b, n, _ = hidden_states.shape
    h = hidden_states
    heads = p.heads
    if group_norm_groups is not None:
        # token-wise GroupNorm over channels, eps 1e-5 (reference
        # attention.py:130-131 normalises the transposed (B, C, N) layout)
        c, g = h.shape[-1], group_norm_groups
        x32 = h.float().reshape(b, n, g, c // g)
        mean = x32.mean(dim=(1, 3), keepdim=True)
        var = (x32 - mean).square().mean(dim=(1, 3), keepdim=True)
        x32 = (x32 - mean) * torch.rsqrt(var + 1e-5)
        h = (x32.reshape(b, n, c) * p.group_norm.weight.float()
             + p.group_norm.bias.float()).to(h.dtype)

    q = linear(p.to_q, h)
    inner = q.shape[-1]
    dh = inner // heads
    if p.add_k_proj is not None:
        # added-kv path (reference attention.py:137-149): the context's keys
        # and values come first, then the sequence's own
        if encoder_hidden_states is None:
            raise ValueError(
                "add_k_proj/add_v_proj params present but "
                "encoder_hidden_states is None (added-kv attention requires "
                "a context, reference attention.py:137-149)")
        k = torch.cat([linear(p.add_k_proj, encoder_hidden_states),
                       linear(p.to_k, h)], dim=1)
        v = torch.cat([linear(p.add_v_proj, encoder_hidden_states),
                       linear(p.to_v, h)], dim=1)
    else:
        context = (encoder_hidden_states
                   if encoder_hidden_states is not None else h)
        k = linear(p.to_k, context)
        v = linear(p.to_v, context)

    qh, kh, vh = (t.reshape(b, -1, heads, dh) for t in (q, k, v))
    if attention_mask is not None:
        logits = torch.einsum("bqhd,bkhd->bhqk", qh.float(), kh.float())
        logits = logits * dh ** -0.5 + attention_mask.float()
        probs = torch.softmax(logits, dim=-1).to(vh.dtype)
        o = torch.einsum("bhqk,bkhd->bqhd", probs, vh)
    else:
        o = dot_product_attention(qh, kh, vh, scale=dh ** -0.5, impl=impl)
    return linear(p.to_out, o.reshape(b, -1, inner))


def feed_forward(p: FeedForward, x, activation_fn: str = "geglu"):
    """Reference FeedForward (attention.py:296-400): GEGLU x1·gelu(gate),
    GELU, or x·sigmoid(1.702x); GELU is exact erf in fp32 and the tanh form
    in bf16, as everywhere in the port."""
    h = linear(p.proj, x)
    if activation_fn == "geglu":
        h1, gate = h.chunk(2, dim=-1)
        h = h1 * gelu(gate)
    elif activation_fn == "gelu":
        h = gelu(h)
    elif activation_fn == "geglu-approximate":
        h = h * torch.sigmoid(1.702 * h)
    else:
        raise NotImplementedError(activation_fn)
    return linear(p.out, h)
