"""Plain multi-head attention, PyTorch.

Counterpart of ``vda_tpu/ops/attention.py`` ``_xla_attention``: the scores
are fp32 (the products of the input values, summed in fp32), the softmax is
fp32, and the probabilities are cast back to the input dtype before the
value product.  Every kernel's plain twin that needs attention uses this.
"""

from __future__ import annotations

import torch


def attention_plain(q, k, v, scale: float, valid_len: int | None = None):
    """q: (B, Nq, H, D); k, v: (B, Nk, H, D).  Keys at or beyond
    ``valid_len`` are masked out."""
    dtype = q.dtype
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if valid_len is not None and valid_len < k.shape[1]:
        logits[..., valid_len:] = float("-inf")
    probs = torch.softmax(logits, dim=-1).to(dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)
