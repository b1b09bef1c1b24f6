"""Operation counts of the work a cell asks for, taken from the plain
reference on the ``meta`` device (no memory, no device), so that a
whole-step share of the peak reads the same work whatever computes it.

``torch.utils.flop_counter.FlopCounterMode`` counts the products (matmuls,
convolutions); norms, softmax, resizes and elementwise work are not
counted, as MFU conventionally leaves them out.  The encoder attention's
count and bytes are worked out from its shapes for its roofline.
"""

from __future__ import annotations

import functools
import json

import torch
from torch.utils.flop_counter import FlopCounterMode

from h100_bench.reference.model import Reference
from h100_bench.reference.weights import specs


def _meta_reference(cfg: dict) -> Reference:
    sd = {k: torch.empty(shape, device="meta")
          for k, shape, _, _ in specs(cfg)}
    return Reference(cfg, sd)


@functools.lru_cache(maxsize=None)
def _window_flops(cfg_json: str, net_hw: tuple, frames: int) -> int:
    cfg = json.loads(cfg_json)
    ref = _meta_reference(cfg)
    p = cfg["encoder"]["patch_size"]
    phw = (net_hw[0] // p, net_hw[1] // p)
    x = torch.empty(frames, 3, *net_hw, device="meta")
    with FlopCounterMode(display=False) as fc:
        stage, _ = ref.head_stage(ref.encode(x), phw, frames)
        ref.head_tail(stage, phw)
    return int(fc.get_total_flops())


@functools.lru_cache(maxsize=None)
def _stream_flops(cfg_json: str, net_hw: tuple, context: int) -> int:
    cfg = json.loads(cfg_json)
    ref = _meta_reference(cfg)
    p = cfg["encoder"]["patch_size"]
    phw = (net_hw[0] // p, net_hw[1] // p)
    x = torch.empty(1, 3, *net_hw, device="meta")
    taps = ref.encode(x)
    _, rows = ref.head_stage(taps, phw, 1, rows=True)
    ctx = [tuple(t.expand(-1, context, -1) for t in r) for r in rows]
    with FlopCounterMode(display=False) as fc:
        stage, _ = ref.head_stage(ref.encode(x), phw, 1, ctx)
        ref.head_tail(stage, phw)
    return int(fc.get_total_flops())


def window_flops(cfg: dict, net_hw, frames: int = 32) -> int:
    """Products' operations of one offline window of ``frames`` frames at
    the network size ``net_hw``: encoder, head stage and output tail."""
    return _window_flops(json.dumps(cfg, sort_keys=True), tuple(net_hw),
                         frames)


def stream_step_flops(cfg: dict, net_hw, context: int = 31) -> int:
    """Products' operations of one steady stream step: the encoder on one
    frame, the head stage against ``context`` cached entries, the tail."""
    return _stream_flops(json.dumps(cfg, sort_keys=True), tuple(net_hw),
                         context)


def encoder_attention(cfg: dict, net_hw, frames: int):
    """(operations, bytes) of one ``encode`` call's attention over
    ``frames`` frames in bf16: q k^T and p v (4 B H N^2 dh), reading q, k
    and v once and writing the output once."""
    enc = cfg["encoder"]
    p = enc["patch_size"]
    n = (net_hw[0] // p) * (net_hw[1] // p) + 1
    d, heads = enc["embed_dim"], enc["num_heads"]
    flops = 4 * frames * heads * n * n * (d // heads) * enc["depth"]
    nbytes = 2 * frames * n * 4 * d * enc["depth"]
    return flops, nbytes
