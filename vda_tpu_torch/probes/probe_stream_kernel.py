"""K14: the streaming-attention probe, K6's features one at a time, on the
card.

    python -m vda_tpu_torch.probes.probe_stream_kernel [stage ...]
    stages: trivial dot2 mask pe new full full1024 big

The counterpart of ``scripts/probe_stream_kernel.py``.  That script compiled
reduced Pallas kernels one feature at a time, each under a time budget,
because its first stream kernel hung the TPU compiler.  Here ``dot2``,
``mask``, ``pe`` and ``new`` run K14 (``simple_kernel``,
``csrc/stream_probe.cu``) at the script's shape (32 positions, 43 cached
rows of which 31 valid, C 256, 8 heads, groups of 16 positions):
dot-only, dot+mask, dot+mask+pe+softmax and all features; ``full``,
``full1024`` and ``big`` run K6 (``ops.stream_kernel``) at (32, 43, 256),
(32, 43, 1024) and (1376, 43, 1024); ``trivial`` is one small matmul.
Each stage runs under its time budget, is held against its plain twin
within 3.9e-3 of the output's scale (exp rounded to bf16, docs/PARITY.md)
and prints its time.  The probe exits non-zero if a stage disagrees, and
ends with exit code 1 if one outlives its budget.

K14 runs the Hopper kernel of ``csrc/stream_probe_sm90.cuh`` (a cluster of
up to 8 blocks a (group, head), both products on mma.sync, the row maxima
exchanged over distributed shared memory) wherever it takes the shape
(groups of up to 16 positions, head widths a multiple of 8 up to 128), and
the first build of ``csrc/stream_probe.cu`` elsewhere; ``loop_of`` says
which and ``launches_by_loop`` counts the launches by loop.  Its K14 stages
also print ``held_ms`` (``probes.time_held_ms``: the device held while the
host enqueues the calls) beside the design's steps timed the same way
(``variant``): ``old`` the first build, ``loads`` the Hopper kernel's loads
alone, ``floor`` an empty kernel on its grid, cluster shape and shared
memory.
"""

from __future__ import annotations

import argparse
import functools
import json
import sys

import numpy as np
import torch

from vda_tpu_torch.ops import _build, stream_kernel
from vda_tpu_torch.probes import budget, require_cuda, time_held_ms, time_ms

BHW, ROWS, C, HEADS, G = 32, 43, 256, 8, 16  # scripts/probe_stream_kernel.py
N_VALID = 31  # its valid cached rows
SCALE = 0.17678  # its mask stage's score scale
SCALE_1024 = 0.0883883  # K6's scale at C 1024 in its full1024 / big stages
TOL = 3.9e-3
FEATURES = ("mask", "pe", "softmax", "new")
# stage -> the features of the reduced kernel (the script's order)
STAGES = {"dot2": (), "mask": ("mask",), "pe": ("mask", "pe", "softmax"),
          "new": ("mask", "pe", "softmax", "new")}
# stage -> (positions, width, scale) of the K6 stages
K6_STAGES = {"full": (BHW, C, SCALE), "full1024": (32, 1024, SCALE_1024),
             "big": (1376, 1024, SCALE_1024)}

launches = 0  # K14 launches made by ``simple_kernel``
launches_by_loop = {"sm90": 0, "sm80": 0}  # the same launches by loop
# the steps of K14's design (``variant``): the first build, the Hopper
# kernel, its loads alone, an empty kernel on its grid
VARIANTS = {"old": 0, "sm90": 1, "loads": 2, "floor": 3}
STEPS = ("old", "loads", "floor")  # the steps ``run`` times beside a stage
variant_launches = 0  # launches made by ``variant``


def make_inputs(bhw=BHW, c=C, device="cuda"):
    """The script's inputs from numpy's seed 0: q, k_new, v_new (bhw, c);
    k_buf, v_buf (bhw, ROWS, c); pe (ROWS, c) x 0.1, all bf16; valid
    (ROWS,), the first N_VALID rows."""
    rng = np.random.default_rng(0)

    def bf(a):
        return torch.from_numpy(a.astype(np.float32)).to(device,
                                                         torch.bfloat16)
    q, kn, vn = (bf(rng.standard_normal((bhw, c))) for _ in range(3))
    kb, vb = (bf(rng.standard_normal((bhw, ROWS, c))) for _ in range(2))
    pe = bf(rng.standard_normal((ROWS, c)) * 0.1)
    valid = torch.zeros(ROWS, dtype=torch.bool, device=device)
    valid[:N_VALID] = True
    return q, kn, vn, kb, vb, pe, valid


def simple_kernel_reference(feats, inputs, heads=HEADS, group=G,
                            scale=SCALE, out_dtype=torch.bfloat16):
    """Plain twin of the reduced kernel with features ``feats`` (a subset
    of FEATURES): every query of a ``group`` of positions against all the
    group's cached rows, per head, in fp32 with the kernel's roundings.
    Returns (BHW, C) in ``out_dtype``."""
    q, kn, vn, kb, vb, pe, valid = inputs
    bhw, rows, c = kb.shape
    dh, ng, nr = c // heads, bhw // group, group * rows
    bf = torch.bfloat16
    k = (kb + pe) if "pe" in feats else kb  # the add rounded to bf16

    def heads_of(t, n):  # (ng * n, c) -> (ng, heads, n, dh)
        return t.float().reshape(ng, n, heads, dh).transpose(1, 2)
    qh = heads_of(q, group)
    s = qh @ heads_of(k.reshape(-1, c), nr).transpose(-1, -2)
    if "mask" in feats:
        own = ((torch.arange(nr, device=q.device) // rows)[None]
               == torch.arange(group, device=q.device)[:, None]) \
            & valid.to(torch.bool).repeat(group)[None]
        s = s * scale + torch.where(own, 0.0, -1e30)
    v = heads_of(vb.reshape(-1, c), nr)
    if "softmax" in feats:
        mx = s.amax(-1, keepdim=True)
        if "new" in feats:
            sn = qh @ heads_of(kn, group).transpose(-1, -2)
            sn = sn + torch.where(torch.eye(group, dtype=torch.bool,
                                            device=q.device), 0.0, -1e30)
            mx = torch.maximum(mx, sn.amax(-1, keepdim=True))
        e = torch.exp((s - mx).to(bf)).float()
        z = e.sum(-1, keepdim=True)
        o = e @ v
        if "new" in feats:
            en = torch.exp((sn - mx).to(bf)).float()
            z = z + en.sum(-1, keepdim=True)
            o = o + en @ heads_of(vn, group)
        o = o / z
    else:
        o = s.to(bf).float() @ v
    return o.transpose(1, 2).reshape(bhw, c).to(out_dtype)


@functools.lru_cache(maxsize=None)
def loop_of(rows: int, c: int, heads: int, group: int) -> str:
    """The device code ``simple_kernel`` runs at this shape, as the C entry
    point reports it (``vda_stream_probe_loop``): "sm90" (the Hopper kernel)
    or "sm80" (the first build)."""
    code = _build.library().vda_stream_probe_loop(rows, c, heads, group)
    return "sm90" if code == 90 else "sm80"


def _bits(feats) -> int:
    bits = sum(1 << FEATURES.index(f) for f in set(feats))
    if bits not in (0, 1, 7, 15):
        raise ValueError(f"stream_probe: unsupported feature set "
                         f"{sorted(feats)}")
    return bits


def _check(inputs, heads, group):
    """The operands' shapes, or ValueError: (bhw, rows, c)."""
    name = "stream_probe"
    q, kn, vn, kb, vb, pe, valid = inputs
    bhw, rows, c = kb.shape
    for t, shape in ((q, (bhw, c)), (kn, (bhw, c)), (vn, (bhw, c)),
                     (kb, (bhw, rows, c)), (vb, (bhw, rows, c)),
                     (pe, (rows, c))):
        if (tuple(t.shape) != shape or t.dtype != torch.bfloat16
                or t.device != q.device or not t.is_contiguous()
                or t.data_ptr() % 16):
            raise ValueError(f"{name}: expected contiguous, 16-byte aligned "
                             f"bf16 {shape} on {q.device}")
    # valid is read as it is: one byte an element (bool or uint8)
    if (tuple(valid.shape) != (rows,) or valid.device != q.device
            or valid.dtype not in (torch.bool, torch.uint8)
            or not valid.is_contiguous()):
        raise ValueError(f"{name}: valid must be a contiguous bool or uint8 "
                         f"({rows},) tensor on {q.device}")
    if bhw % group or c % heads or (c // heads) % 8:
        raise ValueError(f"{name}: unsupported shape {tuple(kb.shape)}, "
                         f"{heads} heads, groups of {group}")
    return bhw, rows, c


def _operands(inputs, out):
    return [t.data_ptr() for t in (*inputs, out)]


def simple_kernel(feats, inputs, heads=HEADS, group=G, scale=SCALE):
    """K14: the reduced kernel with features ``feats``: (), ("mask",),
    ("mask", "pe", "softmax") or all four.  ``inputs`` as ``make_inputs``
    gives them (bf16; BHW a multiple of ``group``; ``valid`` a bool or uint8
    tensor, passed as it is)."""
    global launches
    q = inputs[0]
    if q.device.type == "cpu":
        return simple_kernel_reference(feats, inputs, heads, group, scale)
    bits = _bits(feats)
    bhw, rows, c = _check(inputs, heads, group)
    out = torch.empty_like(q)
    err = _build.library().vda_stream_probe(
        *_operands(inputs, out), bhw, rows, c, heads, group, float(scale),
        bits, _build.stream_ptr(q))
    if err == _build.INVALID_VALUE:
        raise ValueError(f"stream_probe: unsupported shape {(bhw, rows, c)}")
    _build.check(err, "vda_stream_probe")
    launches += 1
    launches_by_loop[loop_of(rows, c, heads, group)] += 1
    return out


def variant(name, feats, inputs, out, heads=HEADS, group=G, scale=SCALE):
    """One step of K14's design (``VARIANTS``) into ``out`` (on the card):
    "old" the first build, "sm90" the Hopper kernel, "loads" its loads
    alone and "floor" an empty kernel on its grid (these two write
    nothing).  Counted in ``variant_launches``, not in ``launches``."""
    global variant_launches
    bhw, rows, c = _check(inputs, heads, group)
    err = _build.library().vda_stream_probe_variant(
        *_operands(inputs, out), bhw, rows, c, heads, group, float(scale),
        _bits(feats), VARIANTS[name], _build.stream_ptr(out))
    if err == _build.INVALID_VALUE:
        raise ValueError(f"stream_probe {name}: unsupported shape "
                         f"{(bhw, rows, c)}")
    _build.check(err, "vda_stream_probe_variant")
    variant_launches += 1
    return out


def _rel(ref, got):
    ref, got = ref.float(), got.float()
    return float((ref - got).abs().max() / ref.abs().max().clamp_min(1e-12))


def run(stages=("dot2", "mask", "pe", "new", "full", "full1024"),
        reps: int = 20, budget_s: int = 240):
    """Each stage on the card under its time budget: a list of dicts with
    ms, max_rel against the twin and ``ok``; K14's stages also the loop it
    ran, ``held_ms`` and the held times of the design's other steps
    (``old_ms``, ``loads_ms``, ``floor_ms``; each a warm-up and ``reps``
    calls of ``variant``)."""
    rows = []
    for stage in stages:
        with budget(budget_s):
            if stage == "trivial":
                a = torch.ones(128, 128, device="cuda", dtype=torch.bfloat16)
                fn, ref = (lambda: (a @ a) * 1.000451), None
            elif stage in STAGES:
                inputs = make_inputs()
                feats = STAGES[stage]
                fn = lambda: simple_kernel(feats, inputs)  # noqa: E731
                # the twin's output unrounded: the kernel's own output
                # rounding is then at most half a bf16 ulp of the scale
                ref = simple_kernel_reference(feats, inputs,
                                              out_dtype=torch.float32)
            else:
                bhw, c, scale = K6_STAGES[stage]
                q, kn, vn, kb, vb, pe, valid = make_inputs(bhw, c)
                args = (q, kn, vn, kb, vb, pe, pe, valid, HEADS, scale)
                fn = lambda: stream_kernel.stream_kv_attention(  # noqa: E731
                    *args)
                # in fp32 with the encodings added in bf16, as chip_smoke.py
                # holds K6
                zero = torch.zeros_like(pe, dtype=torch.float32)
                ref = stream_kernel.stream_kv_attention_reference(
                    q.float(), kn.float(), vn.float(), (kb + pe).float(),
                    (vb + pe).float(), zero, zero, valid, HEADS, scale)
            got = fn()
            torch.cuda.synchronize()
            finite = bool(torch.isfinite(got).all())
            err = 0.0 if ref is None else _rel(ref, got)
            row = dict(stage=stage, ms=time_ms(fn, reps), max_rel=err,
                       tol=TOL, ok=finite and err < TOL)
            if stage in STAGES:
                out = torch.empty_like(got)
                row.update(loop=loop_of(ROWS, C, HEADS, G),
                           held_ms=time_held_ms(fn, reps),
                           **{f"{v}_ms": time_held_ms(
                               lambda v=v: variant(v, feats, inputs, out),
                               reps) for v in STEPS})
            rows.append(row)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("stages", nargs="*", metavar="stage",
                    help="trivial, dot2, mask, pe, new, full, full1024, big "
                         "(default: all but big)")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--budget", type=int, default=240,
                    help="seconds a stage may take before the probe exits 1")
    args = ap.parse_args(argv)
    known = {"trivial", *STAGES, *K6_STAGES}
    unknown = set(args.stages) - known
    if unknown:
        ap.error(f"unknown stages {sorted(unknown)}")
    require_cuda()
    stages = args.stages or ["trivial", "dot2", "mask", "pe", "new", "full",
                             "full1024"]
    rows = run(stages, args.reps, args.budget)
    for r in rows:
        held = "".join(f"  {k} {r[k]:.4f}" for k in r
                       if k.endswith("_ms") and k != "ms")
        print(f"[{r['stage']}] {r['ms']:.4f} ms{held}  max_rel "
              f"{r['max_rel']:.2e}  {'agrees' if r['ok'] else 'DISAGREES'}",
              flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "rows": rows}))
    return 0 if all(r["ok"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
