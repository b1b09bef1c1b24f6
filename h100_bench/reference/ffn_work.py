"""The least work of the encoder's feed-forwards, from the configuration and
the network size alone, for the feed-forward's share of its roofline: the
same count whatever kernels compute it.

A block's feed-forward over ``tok`` tokens of width ``d`` with hidden width
``h`` (``weights.ffn_hidden``) does 2·tok·(d·h + h·d) operations as the GELU
MLP (``fc1``, ``fc2``) and 2·tok·(d·2h + h·d) as the SwiGLU (``w12``,
``w3``).  Its least bytes, in bf16: the input read, the output written and
the weights (biases included) read once.
"""

from __future__ import annotations

from h100_bench.reference.weights import ffn_hidden


def ffn_work(cfg: dict, net_hw, frames: int):
    """(operations, bytes) of the feed-forwards of every encoder block over
    one ``encode`` of ``frames`` frames at the network size ``net_hw``."""
    enc = cfg["encoder"]
    p, d = enc["patch_size"], enc["embed_dim"]
    h = ffn_hidden(enc)
    tok = frames * ((net_hw[0] // p) * (net_hw[1] // p) + 1)
    wide = 2 * h if enc["ffn_layer"] == "swiglufused" else h
    params = d * wide + wide + h * d + d
    ops = 2 * tok * (d * wide + h * d)
    nbytes = 2 * (2 * tok * d + params)
    return enc["depth"] * ops, enc["depth"] * nbytes
