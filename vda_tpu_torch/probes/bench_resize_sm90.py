"""The design steps of K10's Hopper kernel, timed at the vitl tail's two
upsamples on the card.

    python -m vda_tpu_torch.probes.bench_resize_sm90 [step ...] [--reps 20]
        [--rounds N]

K10 runs twice a fused window at each of (16, 148, 148, 256) -> (296, 296)
and (16, 296, 296, 128) -> (518, 518) (two tail chunks of 16 frames), on
seeded bf16 inputs.  Each step runs through ``vda_resize_variant``
(``csrc/resize_sm90_variants.cu`` says what each is): ``old`` (the kernel
the Hopper one replaced), ``sm90`` (``csrc/resize_sm90.cuh``: the entry
point's own), and its parts ``loads`` (the input reads alone: nothing
written, held to an output left at zero) and ``stores`` (the output writes
alone: zeros, held to an output first filled with NaN and then all zero);
``old`` and ``sm90`` bit for bit with the plain twin
(``ops.resize_kernel.resize_bilinear_fused_reference``).

Times are CUDA events over back-to-back calls with the device held while
the host enqueues them (``probes.time_held_ms``).  Beside the steps of a
shape, its ``beside`` line times the plain twin
(``plain_ms``), ``F.interpolate`` on the channels-last view of the same
input (``library_ms``: one PyTorch call that computes the function; a
yardstick the port never calls) and the least time the card could take
(``bound_ms``: the input read and the output written once at 3.35 TB/s,
against ~9 fp32 operations an output element at 67 TFLOP/s).  Prints one
JSON line a step and shape (``--rounds N``: the steps of a shape timed in
turns N times, medians reported); exits non-zero on a disagreement.
"""

from __future__ import annotations

import argparse
import json
import sys
from statistics import median

import torch

from vda_tpu_torch.ops import _build
from vda_tpu_torch.probes import budget, require_cuda, time_held_ms

# (input shape, output size): the vitl tail's two upsamples
SHAPES = (((16, 148, 148, 256), (296, 296)),
          ((16, 296, 296, 128), (518, 518)))
# name -> index of the step in csrc/resize_sm90_variants.cu
VARIANTS = {"old": 0, "sm90": 1, "loads": 2, "stores": 3}
PARTS = ("loads", "stores")  # steps that write no lerped output
HBM_BYTES_S, FP32_OPS_S = 3.35e12, 67e12
BF = torch.bfloat16

launches = 0  # launches made by ``variant``


def twin(name: str, x, out_hw):
    """What step ``name`` leaves in its output: the plain twin, or zeros
    for the parts."""
    from vda_tpu_torch.ops.resize_kernel import resize_bilinear_fused_reference

    if name in PARTS:
        return x.new_zeros(x.shape[0], *out_hw, x.shape[3])
    return resize_bilinear_fused_reference(x, out_hw)


def variant(name: str, x, out_hw, out=None):
    """Step ``name`` over bf16 x (B, H, W, C) into ``out`` (B, OH, OW, C),
    allocated when None.  On the CPU, the step's twin."""
    global launches
    from vda_tpu_torch.ops import resize_kernel as rk

    if x.device.type == "cpu":
        return twin(name, x, out_hw)
    if x.device.type != "cuda" or x.dtype != BF:
        raise ValueError(f"resize_variant: bf16 CUDA input, got {x.dtype} "
                         f"on {x.device}")
    x, itab, ftab = rk.prepare(x, out_hw)
    if out is None:
        out = torch.empty(x.shape[0], *out_hw, x.shape[3], device=x.device,
                          dtype=BF)
    err = _build.library().vda_resize_variant(
        *rk.c_args(x, itab, ftab, out), 0, VARIANTS[name],
        _build.stream_ptr(x))
    _build.check(err, "vda_resize_variant")
    launches += 1
    return out


def cost(shape, out_hw) -> tuple[float, float]:
    """(bytes, fp32 operations) of one call: the input read and the output
    written once, bf16; ~9 operations an output element (two row lerps of
    three, two weighted taps and their sum)."""
    n_out = shape[0] * out_hw[0] * out_hw[1] * shape[3]
    n_in = shape[0] * shape[1] * shape[2] * shape[3]
    return (n_in + n_out) * 2, 9 * n_out


def bound_ms(shape, out_hw) -> tuple[float, str]:
    """(least ms at the data-sheet rates, "bytes" or "operations")."""
    n_bytes, n_ops = cost(shape, out_hw)
    t_b, t_o = n_bytes / HBM_BYTES_S, n_ops / FP32_OPS_S
    return 1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


def library(x, out_hw):
    """``F.interpolate`` on the channels-last view of x: one PyTorch call
    computing the function (in its own rounding)."""
    import torch.nn.functional as F

    return F.interpolate(x.permute(0, 3, 1, 2), size=out_hw, mode="bilinear",
                         align_corners=True)


def run(steps=None, shapes=SHAPES, reps: int = 10, seed: int = 0,
        rounds: int = 1):
    """Each step at each shape on the card: a list of dicts, one a step and
    shape (ms, ``exact`` against its twin, ``ok``) and one a shape
    (``beside``: the twin, the library call, the bound).  With ``rounds``
    > 1 the steps of a shape are timed in turns that many times and ms is
    the median (the rounds' values beside it)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    rows = []
    for shape, out_hw in shapes:
        x = torch.randn(*shape, device="cuda", generator=g).to(BF)
        ref = twin("sm90", x, out_hw)
        names = [n for n in VARIANTS if steps is None or n in steps]
        times = {n: [] for n in names}
        for _ in range(rounds):
            for name in names:
                with budget(120):
                    times[name].append(time_held_ms(
                        lambda: variant(name, x, out_hw), reps))
        for name in names:
            with budget(120):
                out = None
                if name == "stores":  # every element written
                    out = torch.full((shape[0], *out_hw, shape[3]),
                                     float("nan"), device="cuda", dtype=BF)
                elif name == "loads":
                    out = torch.zeros(shape[0], *out_hw, shape[3],
                                      device="cuda", dtype=BF)
                got = variant(name, x, out_hw, out)
                want = twin(name, x, out_hw) if name in PARTS else ref
                ok = bool(torch.equal(got, want))
                del got, out
            row = dict(kernel="K10", step=name, shape=[*shape, *out_hw],
                       ms=median(times[name]), exact=ok, ok=ok)
            if rounds > 1:
                row["ms_rounds"] = times[name]
            rows.append(row)
        del ref
        bound, bound_by = bound_ms(shape, out_hw)
        rows.append(dict(
            kernel="K10", step="beside", shape=[*shape, *out_hw],
            plain_ms=time_held_ms(lambda: twin("sm90", x, out_hw), reps),
            library_ms=time_held_ms(lambda: library(x, out_hw), reps),
            bound_ms=bound, bound_by=bound_by))
        del x
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("steps", nargs="*", metavar="step",
                    help=f"any of {', '.join(VARIANTS)} (default: all)")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=1,
                    help="time the steps in turns this many times")
    args = ap.parse_args(argv)
    unknown = set(args.steps) - set(VARIANTS)
    if unknown:
        ap.error(f"unknown steps {sorted(unknown)}")
    require_cuda()
    rows = run(args.steps or None, reps=args.reps, rounds=args.rounds)
    for r in rows:
        print(json.dumps(r), flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0)}), flush=True)
    return 0 if all(r.get("ok", True) for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
