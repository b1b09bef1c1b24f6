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
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from vda_tpu_torch.ops import _build, stream_kernel
from vda_tpu_torch.probes import budget, require_cuda, time_ms

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


def simple_kernel(feats, inputs, heads=HEADS, group=G, scale=SCALE):
    """K14: the reduced kernel with features ``feats``: (), ("mask",),
    ("mask", "pe", "softmax") or all four.  ``inputs`` as ``make_inputs``
    gives them (bf16; BHW a multiple of ``group``)."""
    global launches
    q, kn, vn, kb, vb, pe, valid = inputs
    if q.device.type == "cpu":
        return simple_kernel_reference(feats, inputs, heads, group, scale)
    name = "stream_probe"
    bits = sum(1 << FEATURES.index(f) for f in set(feats))
    if bits not in (0, 1, 7, 15):
        raise ValueError(f"{name}: unsupported feature set {sorted(feats)}")
    bhw, rows, c = kb.shape
    for t, shape in ((q, (bhw, c)), (kn, (bhw, c)), (vn, (bhw, c)),
                     (kb, (bhw, rows, c)), (vb, (bhw, rows, c)),
                     (pe, (rows, c))):
        if (tuple(t.shape) != shape or t.dtype != torch.bfloat16
                or t.device != q.device or not t.is_contiguous()
                or t.data_ptr() % 16):
            raise ValueError(f"{name}: expected contiguous, 16-byte aligned "
                             f"bf16 {shape} on {q.device}")
    if bhw % group or c % heads or (c // heads) % 8 \
            or tuple(valid.shape) != (rows,):
        raise ValueError(f"{name}: unsupported shape {tuple(kb.shape)}, "
                         f"{heads} heads, groups of {group}")
    flags = valid.to(device=q.device, dtype=torch.uint8).contiguous()
    out = torch.empty_like(q)
    err = _build.library().vda_stream_probe(
        q.data_ptr(), kn.data_ptr(), vn.data_ptr(), kb.data_ptr(),
        vb.data_ptr(), pe.data_ptr(), flags.data_ptr(), out.data_ptr(), bhw,
        rows, c, heads, group, float(scale), bits, _build.stream_ptr(q))
    if err == _build.INVALID_VALUE:
        raise ValueError(f"{name}: unsupported shape {tuple(kb.shape)}")
    _build.check(err, "vda_stream_probe")
    launches += 1
    return out


def _rel(ref, got):
    ref, got = ref.float(), got.float()
    return float((ref - got).abs().max() / ref.abs().max().clamp_min(1e-12))


def run(stages=("dot2", "mask", "pe", "new", "full", "full1024"),
        reps: int = 20, budget_s: int = 240):
    """Each stage on the card under its time budget: a list of dicts with
    ms, max_rel against the twin and ``ok``."""
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
            rows.append(dict(stage=stage, ms=time_ms(fn, reps), max_rel=err,
                             tol=TOL, ok=finite and err < TOL))
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
        print(f"[{r['stage']}] {r['ms']:.4f} ms  max_rel {r['max_rel']:.2e}  "
              f"{'agrees' if r['ok'] else 'DISAGREES'}", flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "rows": rows}))
    return 0 if all(r["ok"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
