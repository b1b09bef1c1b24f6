"""The design steps of K5's and K8's Hopper code, timed at their main-path
shapes on the card.

    python -m vda_tpu_torch.probes.bench_short_attn_sm90 [step ...]
        [--kernels K5 K8] [--reps 20] [--rounds N]

K5 (``tiny_seq_attention``) runs at the vits window's three shapes (BD, T,
C) = (5476, 32, 64), (1369, 32, 64), (1369, 32, 192), the vitl stream's
first step's four, (1369, 1, 1024), (361, 1, 1024), (1369, 1, 256), (5476,
1, 256), and vitg's mm0 and mm1, (1369, 32, 1536), (361, 32, 1536) (head
width 192), 8 heads; K8 (``segment_attention``) at DINOv2's multi-crop batch
(64 segments of 257 rows and 256 of 50, 16 heads of 64) and at 32 segments
of 1370 (K1's shape).  q, k and v are seeded bf16 column slices of one
fused projection, as the model hands them over.  Each step runs through
``vda_tiny_seq_variant`` / ``vda_segment_variant``
(``csrc/tiny_seq_sm90_variants.cu``, ``csrc/segment_sm90_variants.cu`` say
what each is): ``old`` (the kernel the Hopper code replaced), ``sm90`` (the
entry point's own), K8's two configurations at every span (``bk128``: key
tiles of 128 rows, ``bk64``: of 64; ``sm90`` picks by the longest span)
and ``unmixed`` (``sm90`` over a table whose items hold several segments
only within 192 keys), and the parts: ``loads`` (the loads alone),
``products`` (the products and softmax alone, on whatever the tiles hold;
K5 at T >= 2) and K5's ``floor`` (an empty kernel on ``sm90``'s grid: a
launch's own time).  The parts write nothing and are held to an output
left at zero; the others to the plain twin
(``ops.tiny_seq_kernel.tiny_seq_attention_reference`` on the same bf16
values, ``ops.segment_kernel.segment_attention_reference`` on them in
fp32) within 3.9e-3 of its scale, chip_smoke.py's bound for K5 and K8 in
bf16.

Each step is timed with the device held while the host enqueues the calls
(``probes.time_held_ms``: a call's host work would otherwise set the pace
of a 5-50 us kernel); ``--rounds N`` times the steps of a shape in turns N
times and reports medians.  Beside the steps of a shape, its ``beside``
line times the plain twin (``plain_ms``), one PyTorch call computing the
same function (``library_ms``: ``scaled_dot_product_attention`` over
(BD, heads, T, dh) views for K5, over jagged nested tensors for K8; a
yardstick the port never calls), K8 at 32 x 1370 K1 on the same values
(``k1_ms``), and the least time the card could take (``bound_ms``: q, k,
v and the output moved once at 3.35 TB/s, or the products at 989
TFLOP/s).  Prints one JSON line a step and shape; exits non-zero on a
disagreement.
"""

from __future__ import annotations

import argparse
import json
import sys
from statistics import median

import numpy as np
import torch

from vda_tpu_torch.ops import _build
from vda_tpu_torch.probes import budget, require_cuda, time_held_ms

HEADS5, HEADS8, D8 = 8, 16, 64
# name -> (BD, T, C) of K5's calls: the vits window, the stream's first
# step, vitg's window
K5_SHAPES = {"vits_mm3": (5476, 32, 64), "vits_mm2": (1369, 32, 64),
             "vits_mm0": (1369, 32, 192), "step0_mm0": (1369, 1, 1024),
             "step0_mm1": (361, 1, 1024), "step0_mm2": (1369, 1, 256),
             "step0_mm3": (5476, 1, 256), "vitg_mm0": (1369, 32, 1536),
             "vitg_mm1": (361, 32, 1536)}
# name -> segment lengths of K8's calls: DINOv2's multi-crop batch (32
# images of 2 global crops of 257 tokens and 8 local crops of 50), and one
# long segment a sample (K1's window shape)
K8_SHAPES = {"multi_crop": (257,) * 64 + (50,) * 256, "32x1370": (1370,) * 32}
TOL = 3.9e-3
# name -> index of the step in csrc/tiny_seq_sm90_variants.cu
K5_VARIANTS = {"old": 0, "sm90": 1, "loads": 2, "products": 3, "floor": 4}
K5_MMA_ONLY = ("products",)  # steps of the mma path alone (T >= 2)
# name -> index of the step in csrc/segment_sm90_variants.cu
K8_VARIANTS = {"old": 0, "sm90": 1, "bk128": 2, "bk64": 3, "loads": 4,
               "products": 5}
# K8 steps of the table, not the kernel (name -> (variant, work_table's
# mix_span)): sm90 over items that hold several segments only within 192
# keys (three short ones; the first build's table: a 257-row segment's
# last item leaves a consumer idle)
K8_TABLES = {"unmixed": ("sm90", 192)}
PARTS = ("loads", "products", "floor")  # steps that write nothing
HBM_BYTES_S, BF16_OPS_S = 3.35e12, 989e12
BF = torch.bfloat16

launches = 0  # launches made by ``variant``


def k5_steps(t: int) -> list:
    """K5's steps at sequence length t: the mma path's at T >= 2."""
    return [n for n in K5_VARIANTS if t > 1 or n not in K5_MMA_ONLY]


def inputs(gen, kernel: str, shape) -> dict:
    """Seeded bf16 q, k, v on the generator's device: column slices of one
    fused projection.  K5: shape (BD, T, C); K8: segment lengths."""
    if kernel == "K5":
        bd, t, c = shape
        qkv = torch.randn(bd, t, 3 * c, device=gen.device, generator=gen)
        heads = HEADS5
    else:
        c = HEADS8 * D8
        qkv = torch.randn(sum(shape), 3 * c, device=gen.device,
                          generator=gen)
        heads = HEADS8
    qkv = qkv.to(BF)
    q, k, v = qkv.split(c, dim=-1)
    return dict(kernel=kernel, shape=shape, qkv=qkv, q=q, k=k, v=v,
                heads=heads, scale=(c // heads) ** -0.5)


def twin(name: str, ins: dict):
    """What step ``name`` writes: the plain twin, or zeros for the parts."""
    from vda_tpu_torch.ops import segment_kernel, tiny_seq_kernel

    q, k, v = ins["q"], ins["k"], ins["v"]
    if name in PARTS:
        return torch.zeros(q.shape, dtype=q.dtype, device=q.device)
    if ins["kernel"] == "K5":  # the kernel's rounding points, bf16 inputs
        return tiny_seq_kernel.tiny_seq_attention_reference(
            q, k, v, ins["heads"], ins["scale"])
    # K8 against the twin on the same values in fp32, as chip_smoke.py
    return segment_kernel.segment_attention_reference(
        q.float(), k.float(), v.float(), ins["heads"], ins["scale"],
        ins["shape"])


def variant(name: str, ins: dict, out=None):
    """Step ``name`` over the operands of ``inputs``, bf16, into ``out``
    (default: a new zero tensor).  On the CPU, the step's twin."""
    global launches
    from vda_tpu_torch.ops import segment_kernel

    q, k, v = ins["q"], ins["k"], ins["v"]
    if q.device.type == "cpu":
        return twin(name, ins)
    if q.device.type != "cuda" or q.dtype != BF:
        raise ValueError(f"short_attn variant: bf16 CUDA operands, got "
                         f"{q.dtype} on {q.device}")
    if out is None:
        out = torch.zeros(q.shape, dtype=BF, device=q.device)
    lib = _build.library()
    if ins["kernel"] == "K5":
        bd, t, c = q.shape
        err = lib.vda_tiny_seq_variant(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bd, t,
            c, ins["heads"], q.stride(0), q.stride(1), float(ins["scale"]),
            0, K5_VARIANTS[name], _build.stream_ptr(q))
        _build.check(err, "vda_tiny_seq_variant")
    else:
        lengths = tuple(ins["shape"])
        step, mix = K8_TABLES.get(name, (name, segment_kernel.MIX_SPAN))
        tiles = segment_kernel._device_table(lengths, q.device)
        items, span = segment_kernel._device_items(lengths, q.device, mix)
        total, hd = q.shape
        err = lib.vda_segment_variant(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            tiles.data_ptr(), tiles.shape[0], items.data_ptr(),
            items.shape[0], span, total, ins["heads"], hd // ins["heads"],
            q.stride(0), float(ins["scale"]), 0, K8_VARIANTS[step],
            _build.stream_ptr(q))
        _build.check(err, "vda_segment_variant")
    launches += 1
    return out


def cost(kernel: str, shape) -> tuple[float, float]:
    """(bytes, operations) of one bf16 call: q, k, v and the output moved
    once; the two products, 4 T^2 C a sequence (K8: 4 n^2 H D a
    segment)."""
    if kernel == "K5":
        bd, t, c = shape
        return 4 * bd * t * c * 2, 4 * bd * t * t * c
    c = HEADS8 * D8
    return 4 * sum(shape) * c * 2, 4 * sum(n * n for n in shape) * c


def bound_ms(kernel: str, shape) -> tuple[float, str]:
    """(least ms at the data-sheet rates, "bytes" or "operations")."""
    n_bytes, n_ops = cost(kernel, shape)
    t_b, t_o = n_bytes / HBM_BYTES_S, n_ops / BF16_OPS_S
    return 1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


def library(ins: dict):
    """One PyTorch call computing the function (a yardstick): SDPA over
    (BD, heads, T, dh) views (K5), over jagged nested tensors (K8)."""
    import torch.nn.functional as F

    q, k, v, h = ins["q"], ins["k"], ins["v"], ins["heads"]
    if ins["kernel"] == "K5":
        bd, t, c = q.shape
        return F.scaled_dot_product_attention(
            *(x.reshape(bd, t, h, c // h).transpose(1, 2)
              for x in (q, k, v)), scale=ins["scale"])
    if "nested" not in ins:  # built once, outside the timed call
        offs = torch.tensor([0, *np.cumsum(ins["shape"])], device=q.device)
        ins["nested"] = [
            torch.nested.nested_tensor_from_jagged(x.contiguous(), offs)
            .unflatten(-1, (h, D8)).transpose(1, 2) for x in (q, k, v)]
    return F.scaled_dot_product_attention(*ins["nested"], scale=ins["scale"])


def _rel(got, ref) -> tuple[bool, float]:
    err = float((got.float() - ref.float()).abs().max())
    r = err / max(float(ref.float().abs().max()), 1e-12)
    return bool(torch.isfinite(got).all()) and r < TOL, r


def run(steps=None, kernels=("K5", "K8"), reps: int = 10, seed: int = 0,
        rounds: int = 1):
    """Each step at each shape on the card: a list of dicts, one a step and
    shape (ms, max_rel against its twin, ``ok``) and one a shape
    (``beside``: the twin, the library call, K1 at 32 x 1370, the bound).
    With ``rounds`` > 1 the steps of a shape are timed in turns that many
    times, and ms is the median (the rounds' values beside it)."""
    from vda_tpu_torch.ops import attention_kernel, segment_kernel
    from vda_tpu_torch.ops import tiny_seq_kernel

    g = torch.Generator(device="cuda").manual_seed(seed)
    rows = []
    for kernel in kernels:
        shapes = K5_SHAPES if kernel == "K5" else K8_SHAPES
        for name, shape in shapes.items():
            ins = inputs(g, kernel, shape)
            avail = (k5_steps(shape[1]) if kernel == "K5"
                     else [*K8_VARIANTS, *K8_TABLES])
            names = [n for n in avail if steps is None or n in steps]
            times = {n: [] for n in names}
            # each step's output made once, outside the timed calls
            outs = {n: torch.zeros(ins["q"].shape, dtype=BF, device="cuda")
                    for n in names}
            for _ in range(rounds):
                for n in names:
                    with budget(120):
                        times[n].append(time_held_ms(
                            lambda: variant(n, ins, outs[n]), reps))
            del outs
            for n in names:
                with budget(120):
                    got = variant(n, ins)
                    if n in PARTS:
                        ok, r = bool((got == 0).all()), 0.0
                    else:
                        ok, r = _rel(got, twin(n, ins))
                row = dict(kernel=kernel, case=name, step=n,
                           shape=list(shape) if kernel == "K5"
                           else [len(shape), sum(shape)],
                           ms=median(times[n]), max_rel=r, ok=ok)
                if rounds > 1:
                    row["ms_rounds"] = times[n]
                rows.append(row)
            q, k, v, h, s = (ins[x] for x in ("q", "k", "v", "heads",
                                               "scale"))
            if kernel == "K5":
                plain = lambda: tiny_seq_kernel.tiny_seq_attention_reference(
                    q, k, v, h, s)
            else:
                plain = lambda: segment_kernel.segment_attention_reference(
                    q, k, v, h, s, shape)
            bound, bound_by = bound_ms(kernel, shape)
            beside = dict(kernel=kernel, case=name, step="beside",
                          plain_ms=time_held_ms(plain, min(reps, 3)),
                          library_ms=time_held_ms(lambda: library(ins),
                                                  reps),
                          bound_ms=bound, bound_by=bound_by)
            if kernel == "K8" and len(set(shape)) == 1:
                # the fused rows as K1's (B, N, 3C)
                qkv = ins["qkv"].view(len(shape), shape[0], -1)
                beside["k1_ms"] = time_held_ms(
                    lambda: attention_kernel.flash_attention_qkv(qkv, h, s),
                    reps)
            rows.append(beside)
            del ins
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("steps", nargs="*", metavar="step",
                    help=f"any of {', '.join({**K5_VARIANTS, **K8_VARIANTS, **K8_TABLES})}"
                         " (default: all)")
    ap.add_argument("--kernels", nargs="+", default=["K5", "K8"],
                    choices=["K5", "K8"])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=1,
                    help="time the steps in turns this many times")
    args = ap.parse_args(argv)
    unknown = (set(args.steps) - set(K5_VARIANTS) - set(K8_VARIANTS)
               - set(K8_TABLES))
    if unknown:
        ap.error(f"unknown steps {sorted(unknown)}")
    require_cuda()
    rows = run(args.steps or None, args.kernels, reps=args.reps,
               rounds=args.rounds)
    for r in rows:
        print(json.dumps(r), flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0)}), flush=True)
    return 0 if all(r.get("ok", True) for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
