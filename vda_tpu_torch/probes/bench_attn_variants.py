"""K12: K1's attention with one piece ablated or its tiling changed, timed
at the vitl encoder shape on the card.

    python -m vda_tpu_torch.probes.bench_attn_variants [variant ...]
    python -m vda_tpu_torch.probes.bench_attn_variants --against DIR

The counterpart of ``scripts/bench_attn_variants.py``.  Over seeded bf16
qkv of (32, 1370, 3 x 16 x 64), each variant (``csrc/attention_variants.cu``)
is timed by CUDA events, printed with its rate in TF/s (4 B N^2 H D
operations, as the script counts them) and held against its plain twin
within 3.9e-3 of the output's scale (the repo's bf16-softmax bound,
docs/PARITY.md; ``bf16sm`` 2e-2, see ``TOL_BF16SM``).

At head width 64 every variant but ``mma_sync`` is a configuration of K1's
Hopper loop (``csrc/flash_attention_sm90.cuh``; ``heads2`` of
``csrc/attention_heads_sm90.cuh``), so the shares it measures are those of
the loop K1 and K9 run; other head widths run the old ``mma.sync`` loop
(``csrc/flash_attention.cuh``), as K1 does there.  ``loop_of`` says which
and ``launches_by_loop`` counts.

Function variants (JAX's ``mode`` / ``exp_dtype``): ``full`` (K1's own
configuration, bit-identical with K1), ``matmul`` (no softmax, no row
sums), ``nomask`` (the key compare gone, the 38 padded keys of the
1408-key buffer taking part as TMA's zero rows), ``fp32exp`` (its row sums
in registers: the tensor core's sums read the bf16 P, not the fp32 values
this variant sums), ``bf16sm``, ``exp2`` (on the Hopper loop the same
configuration as ``full``, which already takes the max over unscaled
scores and one FMA and ``ex2.approx`` a score: nothing differs, so its
time is a second reading of ``full``).  Geometry variants, the loop's
tiling in place of JAX's block sizes: ``bq128`` (two consumers, 128 query
rows a block, for JAX's ``bq*``), ``bk32`` / ``bk128`` (K/V tiles of 32 /
128 keys, for ``np_len``; 128 is ``full``'s own tile, so ``bk128`` is
``full``'s configuration), ``heads2`` (two consumers on two heads of the
same 64 rows, for ``g*``).  ``mma_sync``: the old loop's ``full``, the
loop K1 ran before the Hopper loop.

``--against DIR`` runs K1, K7, K8 and K9 at their ``chip_smoke.py`` shapes
in a child process of this tree and of the checkout at DIR, in turns (DIR,
this, this, DIR), and prints each time and whether each output is
bit-identical across the two.  K1, K8 and K9 must be; K7 moved to a new
kernel whose sums run in another order, so it is held to the parent within
its bound against its twin, 2e-2 of the output's scale, and the largest
difference is printed.  It exits non-zero when K1, K8 or K9 differ or K7
is out of its bound.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import sys

import torch

from vda_tpu_torch.ops import _build
from vda_tpu_torch.probes import budget, require_cuda, time_ms

B, N, H, D = 32, 1370, 16, 64  # scripts/bench_attn_variants.py
NP = 1408  # its padded key buffer: the keys ``nomask`` runs over
TOL = 3.9e-3
# bf16sm rounds each shifted score to bf16 (twice: the difference, then its
# product with log2 e) against the running max in the kernel and against
# the row max in the twin, and the two roundings differ by more than
# 3.9e-3 of the scale: the repo's bound for bf16 kernels that round at
# other points than their twin (tests/test_pallas_temporal.py)
TOL_BF16SM = 2e-2
# name -> (entry index in csrc/attention_variants.cu, the function computed)
VARIANTS = {"full": (0, "full"), "matmul": (1, "matmul"),
            "nomask": (2, "nomask"), "fp32exp": (3, "fp32exp"),
            "bf16sm": (4, "bf16sm"), "exp2": (5, "exp2"),
            "bq128": (6, "full"), "bk32": (7, "full"), "bk128": (8, "full"),
            "heads2": (9, "full"), "mma_sync": (10, "full")}
GEOMETRY = ("bq128", "bk32", "bk128", "heads2")  # head widths up to 64
LOG2E = 1.4426950408889634
TOL_K7 = 2e-2  # K7 against the parent's K7: its bound against its twin

launches = 0  # K12 launches made by ``attn``
launches_by_loop = {"sm90": 0, "sm80": 0}  # the same launches by loop


@functools.lru_cache(maxsize=None)
def loop_of(dh: int, variant: str) -> str:
    """The loop the C entry point runs ``variant`` on at head width
    ``dh``, as it reports it (``vda_attention_variant_loop``): "sm90" (the
    Hopper loop) or "sm80" (the mma.sync loop)."""
    code = _build.library().vda_attention_variant_loop(dh,
                                                       VARIANTS[variant][0])
    return "sm90" if code == 90 else "sm80"


def tolerance(variant: str) -> float:
    """The bound of a variant against its twin's unrounded output."""
    return TOL_BF16SM if variant == "bf16sm" else TOL


def attn_reference(qkv, heads: int, scale: float, mode: str = "full",
                   np_len: int | None = None, out_dtype=None):
    """Plain twin: the function of ``mode`` over the fused (B, N, 3 H D)
    qkv, in fp32 with the kernel's roundings.  Returns (B, N, H D) in
    ``out_dtype`` (default qkv's).

    full     softmax, exp of the fp32 shifted score rounded to bf16, the
             sum of the rounded values (K1)
    matmul   (S * scale) V, S * scale in qkv's dtype: no max, no exp, no
             normalisation
    nomask   full over np_len keys, those at or beyond N zero rows
    fp32exp  fp32 exp, the sum of unrounded values, the product's operand
             in qkv's dtype
    bf16sm   scores and their max in bf16, the shifted score rounded to
             bf16, 2^(bf16(d * log2 e)) rounded to bf16
    exp2     2^((s - m) * log2 e) in fp32 (the scale folded in), rounded
             to bf16"""
    b, n, hd3 = qkv.shape
    hd = hd3 // 3
    d = hd // heads
    q, k, v = (t.float().reshape(b, n, heads, d).transpose(1, 2)
               for t in qkv.split(hd, dim=-1))
    if mode == "nomask":
        pad = (np_len or n) - n
        k, v = (torch.nn.functional.pad(t, (0, 0, 0, pad)) for t in (k, v))
    s = (q @ k.transpose(-1, -2)) * scale
    bf, wd = torch.bfloat16, qkv.dtype
    if mode == "matmul":
        p = s.to(wd).float()
        z = 1.0
    elif mode == "bf16sm":
        sb = s.to(bf)
        dd = (sb - sb.amax(-1, keepdim=True)).float()
        p = torch.exp2((dd * LOG2E).to(bf).float()).to(bf).float()
        z = p.sum(-1, keepdim=True)
    else:
        e = s - s.amax(-1, keepdim=True)
        e = torch.exp2(e * LOG2E) if mode == "exp2" else torch.exp(e)
        p = e.to(wd if mode == "fp32exp" else bf).float()
        z = (e if mode == "fp32exp" else p).sum(-1, keepdim=True)
    o = (p @ v) / z
    return o.transpose(1, 2).reshape(b, n, hd).to(out_dtype or wd)


def attn(qkv, heads: int, scale: float, variant: str = "full",
         np_len: int | None = None):
    """K12: ``variant`` of K1 over the fused bf16 (B, N, 3 H D) qkv (K1's
    layout, read in place), on the loop ``loop_of`` names.  ``nomask`` runs
    over ``np_len`` keys (a multiple of 64, at least N; default N rounded up
    to 64).  Returns (B, N, H D)."""
    global launches
    idx, mode = VARIANTS[variant]
    b, n, hd3 = qkv.shape
    if mode == "nomask":
        np_len = np_len or -(-n // 64) * 64
    if qkv.device.type == "cpu":
        return attn_reference(qkv, heads, scale, mode, np_len)
    name = "attention_variant"
    hd = hd3 // 3
    d = hd // heads if heads > 0 and hd3 % 3 == 0 else 0
    if qkv.device.type != "cuda" or qkv.dtype != torch.bfloat16:
        raise ValueError(f"{name}: bf16 on a CUDA device, got {qkv.dtype} "
                         f"on {qkv.device}")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError(f"{name}: qkv must be contiguous, 16-byte aligned")
    if d == 0 or hd % heads or d % 8 or d > (64 if variant in GEOMETRY
                                              else 128):
        raise ValueError(f"{name}: unsupported shape {tuple(qkv.shape)} "
                         f"with {heads} heads for {variant}")
    if mode == "nomask" and (np_len % 64 or np_len < n):
        raise ValueError(f"{name}: np_len {np_len} must be a multiple of 64 "
                         f"and at least {n}")
    out = torch.empty(b, n, hd, device=qkv.device, dtype=qkv.dtype)
    err = _build.library().vda_attention_variant(
        qkv.data_ptr(), qkv.data_ptr() + hd * 2, qkv.data_ptr() + 2 * hd * 2,
        out.data_ptr(), b, n, heads, d, hd3, np_len if mode == "nomask" else n,
        float(scale), idx, _build.stream_ptr(qkv))
    _build.check(err, "vda_attention_variant")
    launches += 1
    launches_by_loop[loop_of(d, variant)] += 1
    return out


def run(variants=tuple(VARIANTS), reps: int = 10, seed: int = 0,
        shape=(B, N, H, D)):
    """Each variant at ``shape`` (B, N, heads, head width) on the card: a
    list of dicts with ms, TF/s and max_rel against its twin (``ok``)."""
    b, n, h, d = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn(b, n, 3 * h * d, device="cuda", generator=g)
    qkv = qkv.to(torch.bfloat16)
    flops = 4 * b * n * n * h * d
    rows = []
    for name in variants:
        kw = dict(variant=name, np_len=NP if n == N else None)
        with budget(300):
            ms = time_ms(lambda: attn(qkv, h, d ** -0.5, **kw), reps)
            got = attn(qkv, h, d ** -0.5, **kw)
            # the twin's output unrounded: the kernel's own output
            # rounding is then at most half a bf16 ulp of the scale
            ref = attn_reference(qkv, h, d ** -0.5, VARIANTS[name][1],
                                 kw["np_len"] or -(-n // 64) * 64,
                                 torch.float32)
            err = float((got.float() - ref.float()).abs().max()
                        / ref.float().abs().max())
            finite = bool(torch.isfinite(got).all())
            del ref
        tol = tolerance(name)
        rows.append(dict(variant=name, loop=loop_of(d, name), ms=ms,
                         tflops=flops / ms / 1e9, max_rel=err, tol=tol,
                         ok=finite and err < tol))
    return rows


# K1, K7, K8 and K9 at chip_smoke.py's shapes: run as a child process with
# the tree to import first on sys.path; prints one JSON line of each
# output's digest and its time.  It uses only entry points every tree of the
# port has had since K8 came.
_DIGEST = r"""
import hashlib, json, sys
sys.path.insert(0, sys.argv[1])
import numpy as np, torch
from vda_tpu_torch.ops import attention_kernel as k1
from vda_tpu_torch.ops import attn_proj_kernel as k7
from vda_tpu_torch.ops import segment_kernel as k8
def time_ms(fn, reps):
    fn()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps
g = torch.Generator(device="cuda").manual_seed(0)
bf = torch.bfloat16
k7_path = sys.argv[2]  # K7's output is saved here for the comparison
b, n, h, d = 32, 1370, 16, 64
c = h * d
def rnd(*s, scale=1.0):
    return torch.randn(*s, device="cuda", generator=g) * scale
qkv = rnd(b, n, 3 * c).to(bf)
w = rnd(c, c, scale=c ** -0.5).to(bf)
gb = torch.stack([1 + 0.5 * rnd(c), rnd(c, scale=0.1)])
x = rnd(b, n, c, scale=0.1).to(bf)
q, k, v = (rnd(b, n, c).to(bf) for _ in range(3))
lengths = [257] * 64 + [50] * 256
qkv8 = rnd(sum(lengths), 3 * c).to(bf)
calls = {
    "K1": lambda: k1.flash_attention_qkv(qkv, h, d ** -0.5),
    "K7": lambda: k7.flash_attention_qkv_proj(qkv, w, gb, x, h, d ** -0.5),
    "K8": lambda: k8.segment_attention(*qkv8.split(c, dim=-1), h, d ** -0.5,
                                       lengths),
    "K9": lambda: k1.flash_attention_packed(q, k, v, h, d ** -0.5),
}
out = {}
for name, f in calls.items():
    y = f()
    torch.cuda.synchronize()
    if name == "K7":
        torch.save(y.cpu(), k7_path)
    out[name] = {"sha256": hashlib.sha256(
        y.view(torch.int16).cpu().numpy().tobytes()).hexdigest(),
        "ms": time_ms(f, 20)}
print(json.dumps(out))
"""


def against(other: str) -> int:
    """K1, K7, K8, K9 of this tree against the checkout at ``other``, in
    turns; 0 when K1, K8 and K9 are bit-identical and K7 is within
    ``TOL_K7`` of the other tree's K7."""
    other = os.path.abspath(other)
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    runs = []
    for i, tree in enumerate((other, here, here, other)):
        k7_path = os.path.join(_build.BUILD_DIR, f"against_k7_{i}.pt")
        r = subprocess.run([sys.executable, "-c", _DIGEST, tree, k7_path],
                           cwd=tree, capture_output=True, text=True,
                           timeout=900)
        if r.returncode:
            print(r.stdout + r.stderr, file=sys.stderr)
            return 1
        runs.append((tree, json.loads(r.stdout.strip().splitlines()[-1]),
                     k7_path))
    ok = True
    for name in runs[0][1]:
        digests = {res[name]["sha256"] for _, res, _ in runs}
        same = len(digests) == 1
        line = {"kernel": name, "bit_identical": same,
                "ms_in_turns": [[os.path.basename(t) or t, res[name]["ms"]]
                                for t, res, _ in runs]}
        if name == "K7":
            theirs = torch.load(runs[0][2]).float()
            mine = torch.load(runs[1][2]).float()
            diff = float((mine - theirs).abs().max())
            line.update(max_abs_vs_other=diff,
                        max_rel_vs_other=diff / float(theirs.abs().max()),
                        tol=TOL_K7)
            ok &= line["max_rel_vs_other"] < TOL_K7
        else:
            ok &= same
        print(json.dumps(line), flush=True)
    for _, _, path in runs:
        os.remove(path)
    return 0 if ok else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", nargs="*", metavar="variant",
                    help=f"any of {', '.join(VARIANTS)} (default: all)")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--against", metavar="DIR",
                    help="compare K1/K7/K8/K9 with the checkout at DIR")
    args = ap.parse_args(argv)
    unknown = set(args.variants) - set(VARIANTS)
    if unknown:
        ap.error(f"unknown variants {sorted(unknown)}")
    require_cuda()
    if args.against:
        return against(args.against)
    rows = run(args.variants or list(VARIANTS), args.reps)
    for r in rows:
        print(f"{r['variant']:>8} ({r['loop']}): {r['ms']:7.3f} ms  "
              f"{r['tflops']:6.1f} TF/s"
              f"  max_rel {r['max_rel']:.2e}"
              f"  {'agrees' if r['ok'] else 'DISAGREES'}", flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "rows": rows}))
    return 0 if all(r["ok"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
