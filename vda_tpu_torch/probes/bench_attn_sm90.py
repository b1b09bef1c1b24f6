"""The design steps of K1's Hopper loop, timed at the encoder shapes on the
card.

    python -m vda_tpu_torch.probes.bench_attn_sm90 [variant ...]

Each step (``csrc/attention_sm90_variants.cu``: compile-time configurations
of ``csrc/flash_attention_sm90.cuh``) runs over seeded bf16 qkv in K1's
fused layout at vitl's window (32, 1370, 3 x 16 x 64) and stream step (1,
1370, 3 x 16 x 64), timed by CUDA events beside K1 as the library runs it,
the old ``mma.sync`` loop (K12 ``full``) and SDPA on the same values, and
held against its plain twin: the function's steps within 3.9e-3 of the
output's scale (K1's bound), ``products`` (P = bf16(S), no softmax: the
products alone) within 3.9e-3, ``loads`` (the TMA ring alone) exactly zero.
Prints one JSON line a step and shape; exits non-zero on a disagreement.
``--k9 N`` instead times K9 on three separate (32, 1370, 1024) tensors and
K1 on the same values fused, in turns (K9, K1, K1, K9) N times, beside
SDPA, and checks the two bit-identical.

Steps (``csrc/attention_sm90_variants.cu`` says what each is): ``loads``
(the TMA ring alone), ``products`` (no softmax), ``serial`` (each product
waited for before the softmax), ``serial_pp`` / ``serial_p2`` (with turns /
with half of the exponentials by a polynomial on the FMA pipe),
``overlap2`` / ``overlap3`` / ``overlap4`` (the next tile's Q K^T issued
with this tile's P V before this tile's softmax, 2 / 3 / 4 stages),
``pingpong``, ``bk64``, ``bk176``, ``rows192`` / ``rows192s`` (three
consumers, overlapped / serial), ``poly1`` / ``poly2`` / ``rows192p2``, and
the ``sum_*`` steps, with the row sums of P by the tensor core.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from vda_tpu_torch.ops import _build
from vda_tpu_torch.probes import budget, require_cuda, time_ms

SHAPES = ((32, 1370, 16, 64), (1, 1370, 16, 64))  # vitl window, stream step
TOL = 3.9e-3
# name -> index of the configuration in csrc/attention_sm90_variants.cu
VARIANTS = {"loads": 0, "products": 1, "serial": 2, "serial_pp": 3,
            "serial_p2": 4, "overlap2": 5, "overlap3": 6, "overlap4": 7,
            "pingpong": 8, "bk64": 9, "bk176": 10, "rows192": 11,
            "rows192s": 12, "poly1": 13, "poly2": 14, "rows192p2": 15,
            "sum_serial": 16, "sum_overlap": 17, "sum_pp": 18,
            "sum_bk176": 19, "sum_rows192": 20, "sum_rows192s": 21,
            "sum_r192s_2": 22, "sum_r192s_4": 23, "sum_r192s_bk64": 24,
            "sum_r192s_p1": 25, "sum_r192_bk64": 26, "sum_r192_bk96": 27,
            "sum_r192s_bk96": 28, "r192_bk64": 29, "bk96": 30}

launches = 0  # launches made by ``attn``


def attn_reference(qkv, heads: int, scale: float, variant: str):
    """Plain twin of a step over the fused (B, N, 3 H D) qkv, in fp32:
    ``loads`` zeros; ``products`` (Q K^T rounded to bf16) V; the others
    K1's function (``attention_kernel.flash_attention_qkv_reference``)."""
    from vda_tpu_torch.ops import attention_kernel

    b, n, hd3 = qkv.shape
    hd = hd3 // 3
    if variant == "loads":
        return torch.zeros(b, n, hd, device=qkv.device)
    if variant == "products":
        d = hd // heads
        q, k, v = (t.float().reshape(b, n, heads, d).transpose(1, 2)
                   for t in qkv.split(hd, dim=-1))
        p = (q @ k.transpose(-1, -2)).to(torch.bfloat16).float()
        return (p @ v).transpose(1, 2).reshape(b, n, hd)
    return attention_kernel.flash_attention_qkv_reference(qkv.float(), heads,
                                                          scale)


def attn(qkv, heads: int, scale: float, variant: str = "sum_r192s_2"):
    """The step ``variant`` of K1's Hopper loop over the fused bf16 (B, N, 3
    H D) qkv with head width 64.  Returns (B, N, H D) bf16."""
    global launches
    if qkv.device.type == "cpu":
        return attn_reference(qkv, heads, scale, variant).to(qkv.dtype)
    b, n, hd3 = qkv.shape
    hd = hd3 // 3
    if (qkv.device.type != "cuda" or qkv.dtype != torch.bfloat16
            or hd3 % 3 or hd != 64 * heads or not qkv.is_contiguous()
            or qkv.data_ptr() % 16):
        raise ValueError(f"attention_sm90_variant: contiguous bf16 (B, N, 3 "
                         f"H 64) on a CUDA device, got {tuple(qkv.shape)} "
                         f"{qkv.dtype} with {heads} heads on {qkv.device}")
    out = torch.empty(b, n, hd, device=qkv.device, dtype=qkv.dtype)
    p = qkv.data_ptr()
    err = _build.library().vda_attention_sm90_variant(
        p, p + 2 * hd, p + 4 * hd, out.data_ptr(), b, n, heads, hd3, n,
        float(scale), VARIANTS[variant], _build.stream_ptr(qkv))
    _build.check(err, "vda_attention_sm90_variant")
    launches += 1
    return out


def run(variants=tuple(VARIANTS), shapes=SHAPES, reps: int = 10,
        seed: int = 0):
    """Each step at each shape on the card, with K1, the old loop (K12
    ``full``) and SDPA timed on the same values: a list of dicts with ms,
    TF/s and max_rel against the twin (``ok``)."""
    import torch.nn.functional as F

    from vda_tpu_torch.ops import attention_kernel as k1
    from vda_tpu_torch.probes import bench_attn_variants as k12

    g = torch.Generator(device="cuda").manual_seed(seed)
    rows = []
    for b, n, h, d in shapes:
        qkv = torch.randn(b, n, 3 * h * d, device="cuda", generator=g)
        qkv = qkv.to(torch.bfloat16)
        scale = d ** -0.5
        flops = 4 * b * n * n * h * d
        heads_view = qkv.view(b, n, 3, h, d).permute(2, 0, 3, 1, 4)
        beside = {
            "k1": time_ms(lambda: k1.flash_attention_qkv(qkv, h, scale),
                          reps),
            "mma_sync": time_ms(lambda: k12.attn(qkv, h, scale, "full"),
                                reps),
            "sdpa": time_ms(lambda: F.scaled_dot_product_attention(
                *heads_view, scale=scale), reps)}
        for name in variants:
            with budget(300):
                ms = time_ms(lambda: attn(qkv, h, scale, name), reps)
                got = attn(qkv, h, scale, name)
                ref = attn_reference(qkv, h, scale, name)
                err = float((got.float() - ref).abs().max())
                r = err / max(float(ref.abs().max()), 1e-12)
                ok = bool(torch.isfinite(got).all()) and (
                    err == 0.0 if name == "loads" else r < TOL)
                del ref
            rows.append(dict(variant=name, shape=[b, n, 3 * h * d], ms=ms,
                             tflops=flops / ms / 1e9, max_rel=r, ok=ok,
                             **{f"{k}_ms": v for k, v in beside.items()}))
        del qkv, heads_view
    return rows


def k9_in_turns(rounds: int, reps: int = 20, seed: int = 0):
    """K9 (three contiguous (32, 1370, 1024) tensors) and K1 (the same
    values as one fused tensor) timed in turns, with SDPA on the separate
    tensors: a dict of the lists of ms and whether K1 and K9 agree bit for
    bit."""
    import torch.nn.functional as F

    from vda_tpu_torch.ops import attention_kernel as k1

    b, n, h, d = 32, 1370, 16, 64
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(b, n, h * d, device="cuda", generator=g)
               .to(torch.bfloat16) for _ in range(3))
    qkv = torch.cat([q, k, v], dim=-1)
    calls = {"k9": lambda: k1.flash_attention_packed(q, k, v, h, d ** -0.5),
             "k1": lambda: k1.flash_attention_qkv(qkv, h, d ** -0.5),
             "sdpa": lambda: F.scaled_dot_product_attention(
                 *(t.view(b, n, h, d).transpose(1, 2) for t in (q, k, v)),
                 scale=d ** -0.5)}
    out = {name: [] for name in calls}
    for _ in range(rounds):
        for name in ("k9", "k1", "sdpa", "sdpa", "k1", "k9"):
            out[name].append(time_ms(calls[name], reps))
    out["bit_identical"] = bool(torch.equal(calls["k9"](), calls["k1"]()))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", nargs="*", metavar="variant",
                    help=f"any of {', '.join(VARIANTS)} (default: all)")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--k9", type=int, metavar="N", default=0,
                    help="time K9 against K1 and SDPA in turns, N rounds")
    args = ap.parse_args(argv)
    unknown = set(args.variants) - set(VARIANTS)
    if unknown:
        ap.error(f"unknown variants {sorted(unknown)}")
    require_cuda()
    if args.k9:
        res = k9_in_turns(args.k9, args.reps)
        print(json.dumps(res), flush=True)
        return 0 if res["bit_identical"] else 1
    rows = run(args.variants or tuple(VARIANTS), reps=args.reps)
    for r in rows:
        print(json.dumps(r), flush=True)
    return 0 if all(r["ok"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
