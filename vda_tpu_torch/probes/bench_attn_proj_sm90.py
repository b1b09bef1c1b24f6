"""The design steps of K7's Hopper kernel, timed at vitl's fused shapes on
the card.

    python -m vda_tpu_torch.probes.bench_attn_proj_sm90 [variant ...]

Each step (``csrc/attention_proj_sm90_variants.cu``: compile-time
configurations of ``csrc/attention_heads_sm90.cuh``) runs over seeded bf16
qkv (B, 1370, 3 x 16 x 64), W (1024, 1024), gamma/bias and a residual x at
vitl's window (B 32) and stream step (B 1), timed by CUDA events beside K7
as the library runs it and the split path it replaces (K1, the projection
by ``F.linear``, LayerScale and residual, as ``block_apply`` runs them),
with the least time the card could take (``bound_ms``: the larger of the
bytes at 3.35 TB/s and the operations at 989 TFLOP/s), and held against
its plain twin: the function's steps within 2e-2 of the output's scale
(K7's bound, the JAX package's for its fused kernel), the steps that run
one phase alone (x + gamma * bias: the epilogue without the other phase's
sum) exactly.  Prints one JSON line a step and shape; exits non-zero on a
disagreement.

Steps (``csrc/attention_proj_sm90_variants.cu`` says what each is):
``c2_bk64`` (one block a tile, two consumers on two heads at a time, K/V
tiles of 64 keys) and its phases alone (``attn_only`` / ``proj_only``),
``sums_add`` (row sums by adds),
``bk128_s1`` / ``bk32_s4`` (other K/V tiles and rings), ``c3_bk32`` /
``c3_bk64_s1`` (three consumers), ``pn256`` / ``pn64_w4`` (other
projection chunks and W rings), ``mma_sync`` (the kernel K7 ran before,
on the ``mma.sync`` loop), and ``split2`` (a cluster pair on each tile,
each block on half of the heads with K/V tiles of 128 keys, the halves of
the head-output tile swapped between the two blocks' shared memory, each
block projecting half of the output columns) with its phases alone
(``split2_attn``, ``split2_proj``), three consumers
(``split2_c3``, ``split2_c3_s1``, ``split2_c3_s1_q2``, and with
64-column chunks ``split2_c3_pn64``, ``split2_c3_pn64_q2``,
``split2_c3_pn64_w3``, ``split2_c3_pn64_w4``), 64-column chunks with two
consumers (``split2_pn64``), 16-byte epilogue accesses
(``split2_c3_pn64_v16``, K7's configuration; with 32-column chunks
``split2_c3_pn32_v16``, with 64-key tiles ``split2_c3_bk64_v16``), rings
of three 64-key stages
(``split2_bk64_s3``), two Q buffers a consumer (``split2_q2``), K1's
overlapped schedule (``split2_ov``) and both (``split2_q2_ov``).
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from vda_tpu_torch.ops import _build
from vda_tpu_torch.probes import budget, require_cuda, time_ms

SHAPES = ((32, 1370, 16, 64), (1, 1370, 16, 64))  # vitl window, stream step
TOL = 2e-2
# name -> index of the step in csrc/attention_proj_sm90_variants.cu
VARIANTS = {"attn_only": 0, "proj_only": 1, "c2_bk64": 2, "sums_add": 3,
            "bk128_s1": 4, "bk32_s4": 5, "c3_bk32": 6, "c3_bk64_s1": 7,
            "pn256": 8, "pn64_w4": 9, "mma_sync": 10, "split2": 11,
            "split2_attn": 12, "split2_proj": 13, "split2_c3": 14,
            "split2_c3_s1": 15, "split2_bk64_s3": 16, "split2_q2": 17,
            "split2_ov": 18, "split2_q2_ov": 19, "split2_c3_s1_q2": 20,
            "split2_c3_pn64": 21, "split2_c3_pn64_q2": 22,
            "split2_c3_pn64_w3": 23, "split2_c3_pn64_w4": 24,
            "split2_pn64": 25, "split2_c3_pn64_v16": 26,
            "split2_c3_pn32_v16": 27, "split2_c3_bk64_v16": 28}
# out = x + gamma * bias
EPILOGUE_ONLY = ("attn_only", "proj_only", "split2_attn", "split2_proj")
HBM_BYTES_S, BF16_OPS_S = 3.35e12, 989e12

launches = 0  # launches made by ``attn_proj``


def inputs(gen, b: int, n: int, heads: int, d: int = 64):
    """Seeded qkv (B, N, 3C), w (C, C) (out, in), gamma_bias (2, C) fp32
    and x (B, N, C), scaled as ``chip_smoke.py`` scales K7's: the attention
    branch and the residual of one size."""
    c = heads * d
    dev = gen.device

    def mk(*shape, s=1.0):
        return torch.randn(*shape, device=dev, generator=gen) * s
    qkv = mk(b, n, 3 * c, s=2.0).to(torch.bfloat16)
    w = mk(c, c, s=c ** -0.5).to(torch.bfloat16)
    gb = torch.stack([1 + 0.5 * mk(c), mk(c, s=0.1)])
    x = mk(b, n, c, s=0.1).to(torch.bfloat16)
    return qkv, w, gb, x


def attn_proj_reference(variant: str, qkv, w, gb, x, heads: int,
                        scale: float, valid_len: int | None = None):
    """Plain twin of a step: x + gamma * bias for the steps that run one
    phase alone (``EPILOGUE_ONLY``), K7's function (``attn_proj_kernel``'s
    twin) for the others.  Returns (B, N, C) in x's dtype."""
    from vda_tpu_torch.ops import attn_proj_kernel

    if variant in EPILOGUE_ONLY:
        return (x.float() + gb[0] * gb[1]).to(x.dtype)
    return attn_proj_kernel.flash_attention_qkv_proj_reference(
        qkv, w, gb, x, heads, scale, valid_len)


def attn_proj(variant: str, qkv, w, gb, x, heads: int, scale: float,
              valid_len: int | None = None):
    """The step ``variant`` of K7's Hopper kernel over bf16 qkv (B, N, 3C),
    w (C, C) (out, in), fp32 gamma_bias (2, C) and x (B, N, C), C = heads x
    64 <= 1024, keys at or beyond ``valid_len`` masked.  Returns (B, N, C)
    bf16."""
    global launches
    if qkv.device.type == "cpu":
        return attn_proj_reference(variant, qkv, w, gb, x, heads, scale,
                                   valid_len)
    b, n, c3 = qkv.shape
    c = c3 // 3
    valid_len = n if valid_len is None else valid_len
    ok = (qkv.device.type == "cuda" and c3 == 3 * 64 * heads and c <= 1024
          and all(t.dtype == torch.bfloat16 for t in (qkv, w, x))
          and gb.dtype == torch.float32 and tuple(w.shape) == (c, c)
          and tuple(x.shape) == (b, n, c) and tuple(gb.shape) == (2, c)
          and 0 < valid_len <= n and scale > 0
          and all(t.device == qkv.device and t.is_contiguous()
                  and t.data_ptr() % 16 == 0 for t in (qkv, w, gb, x)))
    if not ok:
        raise ValueError(f"attention_proj_sm90_variant: contiguous bf16 qkv "
                         f"(B, N, 3 H 64), w, x and fp32 gamma_bias on one "
                         f"CUDA device, got qkv {tuple(qkv.shape)} "
                         f"{qkv.dtype} with {heads} heads on {qkv.device}")
    out = torch.empty_like(x)
    err = _build.library().vda_attention_proj_sm90_variant(
        qkv.data_ptr(), w.data_ptr(), gb.data_ptr(), x.data_ptr(),
        out.data_ptr(), b, n, heads, valid_len, float(scale),
        VARIANTS[variant], _build.stream_ptr(qkv))
    _build.check(err, "vda_attention_proj_sm90_variant")
    launches += 1
    return out


def cost(b: int, n: int, c: int) -> tuple[float, float]:
    """(bytes, operations) of K7 at (B, N, C): qkv, x and out in bf16, W and
    gamma_bias read once; the two attention products and the projection."""
    return ((5 * b * n * c + c * c) * 2 + 2 * c * 4,
            4 * b * n * n * c + 2 * b * n * c * c)


def bound_ms(b: int, n: int, c: int) -> tuple[float, str]:
    """(least ms at the data-sheet rates, "bytes" or "operations")."""
    n_bytes, n_ops = cost(b, n, c)
    t_b, t_o = n_bytes / HBM_BYTES_S, n_ops / BF16_OPS_S
    return 1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


def agrees(variant: str, got, ref) -> tuple[bool, float]:
    """(within the step's bound, max |got - ref| / max |ref|)."""
    err = float((got.float() - ref.float()).abs().max())
    r = err / max(float(ref.float().abs().max()), 1e-12)
    ok = bool(torch.isfinite(got).all())
    return ok and (err == 0.0 if variant in EPILOGUE_ONLY else r < TOL), r


def run(variants=tuple(VARIANTS), shapes=SHAPES, reps: int = 10,
        seed: int = 0):
    """Each step at each shape on the card, with K7 and the split path
    timed on the same values: a list of dicts with ms, TF/s, the bound and
    max_rel against the twin (``ok``)."""
    import torch.nn.functional as F

    from vda_tpu_torch.ops import attention_kernel as k1
    from vda_tpu_torch.ops import attn_proj_kernel as k7

    g = torch.Generator(device="cuda").manual_seed(seed)
    rows = []
    for b, n, h, d in shapes:
        qkv, w, gb, x = inputs(g, b, n, h, d)
        c, scale = h * d, d ** -0.5
        gamma, bias = gb[0].to(torch.bfloat16), gb[1].to(torch.bfloat16)
        flops = cost(b, n, c)[1]
        bound, bound_by = bound_ms(b, n, c)
        beside = {
            "k7": time_ms(lambda: k7.flash_attention_qkv_proj(
                qkv, w, gb, x, h, scale), reps),
            "split": time_ms(lambda: x + F.linear(k1.flash_attention_qkv(
                qkv, h, scale), w, bias) * gamma, reps)}
        for name in variants:
            with budget(300):
                ms = time_ms(lambda: attn_proj(name, qkv, w, gb, x, h, scale),
                             reps)
                got = attn_proj(name, qkv, w, gb, x, h, scale)
                ref = attn_proj_reference(name, qkv, w, gb, x, h, scale)
                ok, r = agrees(name, got, ref)
                del ref
            rows.append(dict(variant=name, shape=[b, n, 3 * c], ms=ms,
                             tflops=flops / ms / 1e9, max_rel=r, ok=ok,
                             bound_ms=bound, bound_by=bound_by,
                             **{f"{k}_ms": v for k, v in beside.items()}))
        del qkv, w, gb, x
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", nargs="*", metavar="variant",
                    help=f"any of {', '.join(VARIANTS)} (default: all)")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    unknown = set(args.variants) - set(VARIANTS)
    if unknown:
        ap.error(f"unknown variants {sorted(unknown)}")
    require_cuda()
    rows = run(args.variants or tuple(VARIANTS), reps=args.reps)
    for r in rows:
        print(json.dumps(r), flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0)}), flush=True)
    return 0 if all(r["ok"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
