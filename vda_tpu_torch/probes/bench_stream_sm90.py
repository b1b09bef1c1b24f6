"""The design steps of K6's Hopper loop, timed at vitl's four stream shapes
on the card.

    python -m vda_tpu_torch.probes.bench_stream_sm90 [step ...] [--reps 20]
        [--rounds N]

K6 runs twice in each motion module of a ``ctx_kernel`` stream step, at
(BHW, rows, C) = mm0's (1369, 31, 1024), mm1's (361, 31, 1024), mm2's
(1369, 31, 256) and mm3's (5476, 31, 256), 8 heads, every row valid, on
seeded bf16 operands.  Each step runs through ``vda_stream_kv_variant``
(``csrc/stream_kv_sm90_variants.cu`` says what each is): ``sm80`` (the
kernel the loop replaced), ``sm90`` (the Hopper loop,
``csrc/stream_kv_sm90.cuh``: the entry point's own), and parts of it:
``loads`` (its loads alone), ``no_pe`` (without the encoding adds: held
to the twin with zero encodings) and ``no_value_sum`` (loads, scores and
softmax without the weighted sum); ``read_linear`` (a plain read of the
same K and V bytes: the card's read rate, not K6's function) and
``k_ahead`` (the loop with the next item's K rows copied into shared
memory by cp.async under the current item's work; 31 rows at most).  The
parts that write nothing are held to an output left at zero; the others
to the plain twin (``ops.stream_kernel.stream_kv_attention_reference``)
within 3.9e-3 of its scale, chip_smoke.py's bound for K6 in bf16.

Each step is timed twice: ``ms``, back to back over the same operands
(mm1's and mm2's ~47-49 MB nearly fit the 50 MB L2, so that time can beat
the device-memory bound), the device held while the host enqueues the
calls (``probes.time_held_ms``: at 30-50 us a kernel, a call's host work
would set the pace), and ``cold_ms``, with the L2 flushed before each
call by writing a 256 MB buffer; ``--rounds N`` times the steps of a
shape in turns N times and reports medians (a card's times drift by 5-10%
between and within calls).  Beside the steps of a shape, its
``beside`` line times the plain twin (``plain_ms``), the split path that
the kernel replaces (``split_ms``, ``split_cold_ms``: the concatenation
and encoding adds of ``models/temporal._temporal_attention_kv`` and
``scaled_dot_product_attention`` over (BHW, 8, 1, 32, dh); a yardstick the
port never calls), the host time of one call of the entry point's wrapper
(``host_us``: ``ops.stream_kernel.stream_kv_attention``, its Python
checks and C launcher, with the device held) and the least time the card
could take (``bound_ms``: q, the new K/V rows and the output, the valid
K/V rows and their encodings, each moved once at 3.35 TB/s).  Prints one
JSON line a step and shape; exits non-zero on a disagreement.
"""

from __future__ import annotations

import argparse
import json
import sys
from statistics import median

import torch

from vda_tpu_torch.ops import _build
from vda_tpu_torch.probes import budget, host_us, require_cuda, time_held_ms

# motion module -> (BHW, rows, C) of its K6 calls at vitl 518x518
SHAPES = {"mm0": (1369, 31, 1024), "mm1": (361, 31, 1024),
          "mm2": (1369, 31, 256), "mm3": (5476, 31, 256)}
HEADS = 8
TOL = 3.9e-3
# name -> index of the step in csrc/stream_kv_sm90_variants.cu
VARIANTS = {"sm80": 0, "sm90": 1, "loads": 2, "no_pe": 3, "no_value_sum": 4,
            "read_linear": 5, "k_ahead": 6}
# steps that write nothing
PARTS = ("loads", "no_value_sum", "read_linear")
HOST_REPS = 50  # calls of the entry point timed on the host a shape
HBM_BYTES_S, BF16_OPS_S = 3.35e12, 989e12
FLUSH_BYTES = 256 << 20
BF = torch.bfloat16

launches = 0  # launches made by ``variant``


def inputs(gen, bhw: int, rows: int, c: int) -> dict:
    """Seeded bf16 operands of one call on the generator's device: q, the
    new row's k/v, the cached k/v rows and their encodings; every row
    valid, as the ``ctx_kernel`` path passes them."""
    def mk(*shape):
        return torch.randn(*shape, device=gen.device, generator=gen).to(BF)
    return dict(q=mk(bhw, c), kn=mk(bhw, c), vn=mk(bhw, c),
                kb=mk(bhw, rows, c), vb=mk(bhw, rows, c), pk=mk(rows, c),
                pv=mk(rows, c),
                valid=torch.ones(rows, dtype=torch.uint8, device=gen.device),
                scale=(c // HEADS) ** -0.5)


def _args(ins: dict, pe_zero: bool = False) -> tuple:
    pk, pv = ins["pk"], ins["pv"]
    if pe_zero:
        pk, pv = torch.zeros_like(pk), torch.zeros_like(pv)
    return (ins["q"], ins["kn"], ins["vn"], ins["kb"], ins["vb"], pk, pv,
            ins["valid"], HEADS, ins["scale"])


def twin(name: str, ins: dict):
    """What step ``name`` writes: the plain twin (``no_pe``: with zero
    encodings), or zeros for the steps that write nothing."""
    from vda_tpu_torch.ops.stream_kernel import stream_kv_attention_reference

    if name in PARTS:
        return torch.zeros_like(ins["q"])
    return stream_kv_attention_reference(*_args(ins, name == "no_pe"))


def variant(name: str, ins: dict):
    """Step ``name`` over the operands of ``inputs``: (BHW, C) bf16.  On
    the CPU, the step's twin."""
    global launches
    q = ins["q"]
    if q.device.type == "cpu":
        return twin(name, ins)
    if q.device.type != "cuda" or q.dtype != BF:
        raise ValueError(f"stream_kv_variant: bf16 CUDA operands, got "
                         f"{q.dtype} on {q.device}")
    bhw, rows, c = ins["kb"].shape
    out = torch.zeros_like(q) if name in PARTS else torch.empty_like(q)
    err = _build.library().vda_stream_kv_variant(
        *(ins[k].data_ptr() for k in ("q", "kn", "vn", "kb", "vb", "pk",
                                      "pv", "valid")),
        out.data_ptr(), bhw, rows, c, HEADS, float(ins["scale"]), 0,
        VARIANTS[name], _build.stream_ptr(q))
    _build.check(err, "vda_stream_kv_variant")
    launches += 1
    return out


def split_path(ins: dict):
    """The function by the split path's library calls: the context and the
    new row concatenated with their encodings added, then
    ``scaled_dot_product_attention`` over (BHW, 8, 1, 32, dh)."""
    import torch.nn.functional as F

    bhw, rows, c = ins["kb"].shape
    dh = c // HEADS
    k = torch.cat([ins["kb"] + ins["pk"], ins["kn"][:, None]], dim=1)
    v = torch.cat([ins["vb"] + ins["pv"], ins["vn"][:, None]], dim=1)
    o = F.scaled_dot_product_attention(
        ins["q"].view(bhw, 1, HEADS, dh).transpose(1, 2),
        k.view(bhw, rows + 1, HEADS, dh).transpose(1, 2),
        v.view(bhw, rows + 1, HEADS, dh).transpose(1, 2), scale=ins["scale"])
    return o.transpose(1, 2).reshape(bhw, c)


def cost(bhw: int, rows: int, c: int, n_valid: int | None = None,
         elem: int = 2) -> tuple[float, float]:
    """(bytes, operations) of one call: q, the new k/v and the output, the
    valid cached k/v rows and their encodings moved once, the valid flags;
    the score and value products (4 an element of the valid rows and the
    new row) and the encoding adds."""
    n_valid = rows if n_valid is None else n_valid
    n_bytes = (4 * bhw * c + 2 * bhw * n_valid * c + 2 * n_valid * c) * elem
    return (n_bytes + rows,
            bhw * (n_valid + 1) * c * 4 + 2 * bhw * n_valid * c)


def bound_ms(bhw: int, rows: int, c: int) -> tuple[float, str]:
    """(least ms at the data-sheet rates, "bytes" or "operations")."""
    n_bytes, n_ops = cost(bhw, rows, c)
    t_b, t_o = n_bytes / HBM_BYTES_S, n_ops / BF16_OPS_S
    return 1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


def time_cold_ms(fn, reps: int, flush) -> float:
    """Mean device time of ``fn`` with the L2 flushed before each call (a
    write of ``flush``), by CUDA events around the call alone."""
    fn()
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def _rel(got, ref) -> tuple[bool, float]:
    err = float((got.float() - ref.float()).abs().max())
    r = err / max(float(ref.float().abs().max()), 1e-12)
    return bool(torch.isfinite(got).all()) and r < TOL, r


def run(steps=None, shapes=SHAPES, reps: int = 10, seed: int = 0,
        rounds: int = 1):
    """Each step at each shape on the card: a list of dicts, one a step and
    shape (ms, cold_ms, max_rel against its twin, ``ok``) and one a shape
    (``beside``: the twin, the split path, the wrapper's host time, the
    bound: ``HOST_REPS`` + 1 calls of the entry point, counted as K6
    launches).  With ``rounds`` >
    1 the steps of a shape are timed in turns that many times, and ms and
    cold_ms are the medians (the rounds' values beside them)."""
    from vda_tpu_torch.ops import stream_kernel

    g = torch.Generator(device="cuda").manual_seed(seed)
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    rows_out = []
    for module, (bhw, rows, c) in shapes.items():
        ins = inputs(g, bhw, rows, c)
        shape = [bhw, rows, c]
        names = [n for n in VARIANTS if steps is None or n in steps]
        warm = {n: [] for n in names}
        cold = {n: [] for n in names}
        for _ in range(rounds):
            for name in names:
                with budget(120):
                    warm[name].append(time_held_ms(
                        lambda: variant(name, ins), reps))
                    cold[name].append(time_cold_ms(
                        lambda: variant(name, ins), reps, flush))
        for name in names:
            with budget(120):
                if name in PARTS:  # nothing written
                    got = variant(name, ins)
                    ok, r = bool((got == 0).all()), 0.0
                else:
                    ok, r = _rel(variant(name, ins), twin(name, ins))
            row = dict(kernel="K6", module=module, step=name, shape=shape,
                       ms=median(warm[name]), cold_ms=median(cold[name]),
                       max_rel=r, ok=ok)
            if rounds > 1:
                row.update(ms_rounds=warm[name], cold_ms_rounds=cold[name])
            rows_out.append(row)
        bound, bound_by = bound_ms(bhw, rows, c)
        rows_out.append(dict(
            kernel="K6", module=module, step="beside", shape=shape,
            plain_ms=time_held_ms(
                lambda: stream_kernel.stream_kv_attention_reference(
                    *_args(ins)), reps),
            split_ms=time_held_ms(lambda: split_path(ins), reps),
            split_cold_ms=time_cold_ms(lambda: split_path(ins), reps, flush),
            host_us=host_us(lambda: stream_kernel.stream_kv_attention(
                *_args(ins)), HOST_REPS),
            bound_ms=bound, bound_by=bound_by))
        del ins
    return rows_out


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
