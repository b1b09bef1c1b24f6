"""The design steps of K11/K13's Hopper GEMM mainloop, timed at the probe
shapes on the card.

    python -m vda_tpu_torch.probes.bench_gemm_sm90 [variant ...] [--kinds ...]

Each step (``csrc/gemm_sm90_variants.cu``: compile-time configurations of
``csrc/gemm_sm90.cuh``, and ``mma_sync``, the loop of ``csrc/gemm_sm80.cuh``
that the library ran before) runs on seeded operands at three shapes:
K13's rate probe (45056, 1024) @ (1024, 3072) int8 -> int32 (``k13_int8``)
and bf16 -> bf16 (``k13_bf16``), and K11's qkv product, (43840, 1024) @
(1024, 3072) int8 dequantised to bf16 (``k11``).  Each is timed by CUDA
events beside the library's kernel (K13 ``bench_int8.matmul``, K11
``quant.int8_matmul``) and one PyTorch call (``torch._int_mm``, the product
alone, or ``torch.matmul``) on the same values, with the least time the card
could take (bytes at 3.35 TB/s or operations at the data-sheet peak,
whichever is larger), and held against its plain twin: int8 and K11
exactly, bf16 within 2^-8 of the output's scale against the unrounded fp32
product, ``loads`` and ``products`` (which write nothing) by an output left
at zero.  Prints one JSON line a step and shape; exits non-zero on a
disagreement.  ``--power S`` instead loops each step (and the library
calls) S seconds while ``nvidia-smi`` samples the SM clock and the power.

Steps: ``mma_sync`` (the old loop), ``loads`` (the TMA ring alone),
``products`` (the wgmma products alone), tiles ``t128x128`` /
``t128x256_s3`` / ``t128x256`` / ``t256x128`` (stages 4 unless named,
stores from registers), ``grid`` (one block a tile instead of a persistent
grid), and the epilogue through shared memory and TMA stores in groups of
2, 4 or 8 boxes a consumer: ``ts2_s3`` / ``ts2`` / ``ts4_s3`` / ``ts8_s2`` /
``t256x128_ts4`` / ``t128x128_ts4``; and in clusters of two blocks sharing
each B^T tile by multicast: ``c2_loads``, ``c2_products``, ``c2_ts2`` (the
library's default), ``c2_ts2_s3``, ``c2_ts4_s3``, ``c2_grid`` (one cluster
a pair of tiles); and the two halves of ``c2_ts2``'s epilogue,
``c2_stage`` (up to the TMA stores) and ``c2_storeonly`` (the stores alone)
(``csrc/gemm_sm90_variants.cu`` says what each is).
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from vda_tpu_torch.ops import _build, quant
from vda_tpu_torch.probes import budget, require_cuda, time_ms

# name -> (M, K, N) and the kind index of csrc/gemm_sm90_variants.cu
SHAPES = {"k13_int8": (45056, 1024, 3072), "k13_bf16": (45056, 1024, 3072),
          "k11": (43840, 1024, 3072)}
KINDS = {"k13_int8": 0, "k13_bf16": 1, "k11": 2}
# name -> index of the loop in csrc/gemm_sm90_variants.cu
VARIANTS = {"mma_sync": 0, "loads": 1, "products": 2, "t128x128": 3,
            "t128x256_s3": 4, "t128x256": 5, "t256x128": 6, "grid": 7,
            "ts2_s3": 8, "ts2": 9, "ts4_s3": 10, "ts8_s2": 11,
            "t256x128_ts4": 12, "t128x128_ts4": 13, "c2_loads": 14,
            "c2_products": 15, "c2_ts2": 16, "c2_ts2_s3": 17,
            "c2_ts4_s3": 18, "c2_stage": 19, "c2_storeonly": 20,
            "c2_grid": 21}
# steps whose output is zero: they write nothing, or (c2_storeonly) store
# staging that was zeroed once
WRITE_NOTHING = ("loads", "products", "c2_loads", "c2_products", "c2_stage",
                 "c2_storeonly")
TOL_BF16 = 2.0 ** -8
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"int8": 1979e12, "bf16": 989e12}

launches = 0  # launches made by ``gemm``


def _out_dtype(kind: str):
    return torch.int32 if kind == "k13_int8" else torch.bfloat16


def gemm_reference(kind: str, a, bt, sx=None, sw=None, b=None,
                   variant: str = "t128x256"):
    """Plain twin of a step: a (M, K) times bt (N, K) transposed.
    ``k13_int8`` the exact int32 product (float64 is exact for K <= 2^53 /
    127^2); ``k13_bf16`` the fp32 product rounded to bf16; ``k11`` K11's
    twin (``quant.int8_matmul_reference``); ``loads`` and ``products``
    zeros."""
    m, n = a.shape[0], bt.shape[0]
    if variant in WRITE_NOTHING:
        return torch.zeros(m, n, dtype=_out_dtype(kind), device=a.device)
    if kind == "k13_int8":
        return (a.double() @ bt.double().t()).to(torch.int32)
    if kind == "k13_bf16":
        return (a.float() @ bt.float().t()).to(torch.bfloat16)
    return quant.int8_matmul_reference(a, bt.t(), sx, sw, b, torch.bfloat16)


def gemm(kind: str, a, bt, variant: str = "t128x256", sx=None, sw=None,
         b=None, out=None):
    """The step ``variant`` on a (M, K) and bt (N, K), both int8 (``k13_int8``,
    ``k11``) or bf16 (``k13_bf16``), rows a multiple of 16 bytes, N a
    multiple of 8 (of 128 for ``k11``, whose sx (M, 1), sw and b (N,) are
    fp32).  Writes into ``out`` (M, N) when given (int32 for ``k13_int8``,
    else bf16) and returns it."""
    global launches
    if a.device.type == "cpu":
        return gemm_reference(kind, a, bt, sx, sw, b, variant)
    dtype = torch.bfloat16 if kind == "k13_bf16" else torch.int8
    m, k = a.shape
    n = bt.shape[0]
    ops = [a, bt] + ([sx, sw, b] if kind == "k11" else [])
    if (a.device.type != "cuda" or any(t.device != a.device for t in ops)
            or a.dtype != dtype or bt.dtype != dtype or bt.shape[1] != k
            or m == 0 or k * a.element_size() % 16 or n % 8
            or (kind == "k11" and (n % 128 or sx.numel() != m
                                   or sw.numel() != n or b.numel() != n
                                   or any(t.dtype != torch.float32
                                          for t in (sx, sw, b))))
            or any(not t.is_contiguous() or t.data_ptr() % 16 for t in ops)):
        raise ValueError(f"gemm_sm90_variant {kind}: unsupported operands "
                         f"{tuple(a.shape)} {a.dtype}, {tuple(bt.shape)} "
                         f"{bt.dtype} on {a.device}")
    if out is None:
        out = torch.empty(m, n, device=a.device, dtype=_out_dtype(kind))
    ptr = (lambda t: t.data_ptr()) if kind == "k11" else (lambda t: None)
    err = _build.library().vda_gemm_sm90_variant(
        a.data_ptr(), bt.data_ptr(), ptr(sx), ptr(sw), ptr(b), out.data_ptr(),
        m, n, k, KINDS[kind], VARIANTS[variant], _build.stream_ptr(a))
    _build.check(err, "vda_gemm_sm90_variant")
    launches += 1
    return out


def operands(kind: str, generator, m: int, k: int, n: int):
    """Seeded operands of ``kind`` on the card: (a, bt, sx, sw, b) with bt
    the (N, K) layout; bf16 normal, int8 uniform in [-127, 127) as the
    scripts draw them; K11's scales positive and its bias normal."""
    dev = generator.device
    if kind == "k13_bf16":
        a = torch.randn(m, k, device=dev, generator=generator)
        bt = torch.randn(n, k, device=dev, generator=generator)
        return a.to(torch.bfloat16), bt.to(torch.bfloat16), None, None, None
    a = torch.randint(-127, 127, (m, k), device=dev, generator=generator,
                      dtype=torch.int8)
    bt = torch.randint(-127, 127, (n, k), device=dev, generator=generator,
                       dtype=torch.int8)
    if kind == "k13_int8":
        return a, bt, None, None, None
    sx = torch.rand(m, 1, device=dev, generator=generator) / 127 + 1e-4
    sw = torch.rand(n, device=dev, generator=generator) / 127 + 1e-4
    b = torch.randn(n, device=dev, generator=generator)
    return a, bt, sx, sw, b


def cost(kind: str, m: int, k: int, n: int) -> tuple[float, float]:
    """(bytes, operations) of one call: each input read once, the output
    written once."""
    if kind == "k13_int8":
        return m * k + k * n + 4 * m * n, 2 * m * k * n
    if kind == "k13_bf16":
        return 2 * (m * k + k * n + m * n), 2 * m * k * n
    return m * k + k * n + 4 * m + 8 * n + 2 * m * n, 2 * m * k * n


def bound_ms(kind: str, m: int, k: int, n: int) -> tuple[float, str]:
    """(least ms of the call on the H100, "bytes" or "operations")."""
    n_bytes, n_ops = cost(kind, m, k, n)
    t_bytes = n_bytes / HBM_BYTES_S
    t_ops = n_ops / PEAK_OPS_S["bf16" if kind == "k13_bf16" else "int8"]
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def agrees(kind: str, variant: str, got, ref) -> tuple[bool, float]:
    """(whether ``got`` meets the step's bound, its largest error over the
    twin's scale)."""
    err = float((got.float() - ref.float()).abs().max())
    r = err / max(float(ref.float().abs().max()), 1e-12)
    if kind == "k13_bf16" and variant not in WRITE_NOTHING:
        return bool(torch.isfinite(got).all()) and r < TOL_BF16, r
    return bool(torch.equal(got, ref)), r


def _library_calls(kind, a, bt, sx, sw, b):
    """The library's kernel for ``kind`` and the PyTorch call computing the
    same product, by name, on operands ``operands`` made (the wrappers'
    transposed copy of the weight made here, outside any timing)."""
    from vda_tpu_torch.probes import bench_int8

    w = bt.t()  # the (K, N) view the wrappers take
    quant.transposed(w)
    if kind == "k11":
        calls = {"library_kernel": lambda: quant.int8_matmul(
            a, w, sx, sw, b, torch.bfloat16)}
    else:
        calls = {"library_kernel": lambda: bench_int8.matmul(a, w)}
    if kind == "k13_bf16":
        calls["torch_matmul"] = lambda: a @ w
    elif bench_int8.int_mm(a, bt) is not None:
        calls["torch_int_mm"] = lambda: bench_int8.int_mm(a, bt)
    return calls


def run(variants=tuple(VARIANTS), kinds=tuple(SHAPES), reps: int = 10,
        seed: int = 0, shapes=None):
    """Each step at each kind's shape (``shapes``: kind -> (M, K, N), by
    default ``SHAPES``) on the card, with the library's kernel and the
    PyTorch call timed on the same values: a list of dicts with ms, TOP/s,
    the share of peak, the bound, and the agreement with the twin
    (``ok``)."""
    shapes = shapes or SHAPES
    g = torch.Generator(device="cuda").manual_seed(seed)
    rows = []
    for kind in kinds:
        m, k, n = shapes[kind]
        a, bt, sx, sw, b = operands(kind, g, m, k, n)
        ref = (a.float() @ bt.float().t() if kind == "k13_bf16"
               else gemm_reference(kind, a, bt, sx, sw, b))
        beside = _library_calls(kind, a, bt, sx, sw, b)
        with budget(300):
            beside_ms = {name: time_ms(f, reps) for name, f in beside.items()}
        ops = 2.0 * m * k * n
        peak = PEAK_OPS_S["bf16" if kind == "k13_bf16" else "int8"]
        bms, bby = bound_ms(kind, m, k, n)
        for name in variants:
            with budget(300):
                out = (torch.zeros if name in WRITE_NOTHING else torch.empty)(
                    m, n, device="cuda", dtype=_out_dtype(kind))
                ms = time_ms(lambda: gemm(kind, a, bt, name, sx, sw, b, out),
                             reps)
                if name not in WRITE_NOTHING:
                    out.zero_()  # the checked call writes all of it again
                got = gemm(kind, a, bt, name, sx, sw, b, out)
                want = (torch.zeros_like(out) if name in WRITE_NOTHING
                        else ref)
                ok, r = agrees(kind, name, got, want)
                torch.cuda.synchronize()
            rows.append(dict(variant=name, kind=kind, shape=[m, k, n], ms=ms,
                             tops=ops / ms / 1e9,
                             peak_share=ops / ms / 1e-3 / peak,
                             bound_ms=bms, bound_by=bby, max_rel=r, ok=ok,
                             **{f"{key}_ms": v
                                for key, v in beside_ms.items()}))
            del out, got, want
        del a, bt, ref
    return rows


def power_run(variants, kinds=tuple(SHAPES), seconds: float = 3.0,
              seed: int = 0):
    """Each step, the library's kernel and the PyTorch call looped for
    ``seconds`` at each kind's shape while ``nvidia-smi`` samples the SM
    clock and the board's power every 100 ms (the first 300 ms dropped): a
    list of dicts with the ms of one call over the loop (CUDA events), the
    mean SM clock (MHz) and the mean power (W).  Under a sustained GEMM the
    card meets its power limit and lowers its clock, which a 20-call timing
    does not show."""
    import subprocess
    import time

    g = torch.Generator(device="cuda").manual_seed(seed)
    rows = []
    for kind in kinds:
        m, k, n = SHAPES[kind]
        a, bt, sx, sw, b = operands(kind, g, m, k, n)
        out = torch.zeros(m, n, device="cuda", dtype=_out_dtype(kind))
        calls = {v: (lambda v=v: gemm(kind, a, bt, v, sx, sw, b, out))
                 for v in variants}
        calls.update(_library_calls(kind, a, bt, sx, sw, b))
        for name, fn in calls.items():
            with budget(int(seconds) + 120):
                time_ms(fn, 20)  # warm
                smi = subprocess.Popen(
                    ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                     "--format=csv,noheader,nounits", "-lms", "100"],
                    stdout=subprocess.PIPE, text=True)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                t0, n_calls = time.perf_counter(), 0
                start.record()
                while time.perf_counter() - t0 < seconds:
                    for _ in range(100):
                        fn()
                    n_calls += 100
                    torch.cuda.synchronize()
                end.record()
                torch.cuda.synchronize()
                smi.terminate()
                samples = [[float(x) for x in line.split(",")]
                           for line in smi.communicate()[0].splitlines()
                           if line.strip()][3:]
            rows.append(dict(
                step=name, kind=kind, ms=start.elapsed_time(end) / n_calls,
                sm_mhz=sum(r[0] for r in samples) / max(len(samples), 1),
                power_w=sum(r[1] for r in samples) / max(len(samples), 1),
                samples=len(samples)))
        del a, bt, out
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", nargs="*", metavar="variant",
                    help=f"any of {', '.join(VARIANTS)} (default: all)")
    ap.add_argument("--kinds", nargs="+", choices=tuple(SHAPES),
                    default=list(SHAPES))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--power", type=float, default=0.0, metavar="S",
                    help="loop each step (default: products, c2_products, "
                    "c2_ts2) and the library calls S seconds, sampling the "
                    "SM clock and the power, instead of timing")
    args = ap.parse_args(argv)
    unknown = set(args.variants) - set(VARIANTS)
    if unknown:
        ap.error(f"unknown variants {sorted(unknown)}")
    require_cuda()
    if args.power:
        rows = power_run(args.variants or ("products", "c2_products",
                                           "c2_ts2"), args.kinds, args.power)
        for r in rows:
            print(json.dumps(r), flush=True)
        print(json.dumps({"device": torch.cuda.get_device_name(0)}),
              flush=True)
        return 0
    rows = run(args.variants or tuple(VARIANTS), args.kinds, reps=args.reps)
    for r in rows:
        print(json.dumps(r), flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0)}), flush=True)
    return 0 if all(r["ok"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
