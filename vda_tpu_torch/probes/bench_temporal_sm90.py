"""The design steps of K3's and K4's Hopper chain, timed at vitl's four
temporal shapes on the card.

    python -m vda_tpu_torch.probes.bench_temporal_sm90 [step ...] [--reps 20]

K3 runs at mm3's (5476, 32, 256) and mm2's (1369, 32, 256), K4 at mm0's
(1369, 32, 1024) and mm1's (361, 32, 1024), 8 heads, over a seeded block
(``block``) and seeded bf16 rows.  Each step is one of

* the whole block through ``vda_temporal_variant``
  (``csrc/temporal_sm90_variants.cu`` says what each is): ``sm80`` (the
  kernels the chain replaced), ``chain`` (the default: the chain's products
  on ``vda::TB90``, cluster pairs of 128 x 256 tiles), ``chain_cl1``
  (blocks alone), ``chain_bm256`` (256 x 128 tiles), and for K3 alone
  ``fused`` (the whole block in one kernel, cluster pairs sharing the
  weights by multicast: the default at C = 256, 8 heads, T = 32),
  ``fused_cl1`` (blocks alone), ``fused_split`` (a ring of 16 KB weight
  slots for each consumer), ``fused_lag`` (the second consumer's qkv
  products half a product behind the first's), and parts of ``fused`` that
  write no
  output, held to an output left at zero: ``fused_products`` (its weight
  stream and products alone, with their waits and barriers),
  ``fused_loads`` (the weight stream alone) and ``fused`` without its
  norms, attentions, GEGLU or residual epilogues (``fused_no_norm``,
  ``fused_no_attn``, ``fused_no_geglu``, ``fused_no_resid``); the others
  held to the chain's
  plain twin (``temporal_kernel.temporal_block_stages`` /
  ``attention_sub_stages``) within 2e-2 of its scale, the bound the JAX
  package holds its fused temporal kernels to;
* one stage of the chain alone through ``vda_temporal_stage``: ``ln`` (LN +
  APE), ``qkv`` (the qkv product), ``attn`` (the per-sequence attention),
  ``residual`` (the out-projection with bias and residual), and for K3
  ``geglu`` (the GEGLU product) and ``ffo`` (the feed-forward product with
  bias and residual, the ``residual`` stage at (M, 4C) x (4C, C)); each on
  inputs of its shape in the block, held to its stage twin within 2e-2.
  ``count`` is how often the block runs the stage; the block's line gives
  ``stages_ms``, the sum of each stage's ms times its count.

Beside the steps of a shape, its line of ``beside`` times the plain twin
(``plain_ms``, the wrapper's CPU-side function run on the card), the split
path of library calls that computes the same function (``split_ms``:
``F.layer_norm``, ``F.linear``, ``scaled_dot_product_attention``,
``F.gelu``; a yardstick the port never calls) and the least time the card
could take (``bound_ms``: the larger of h in and out plus the weights at
3.35 TB/s and the products at 989 TFLOP/s).  Prints one JSON line a step
and shape; exits non-zero on a disagreement.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys

import torch

from vda_tpu_torch.ops import _build
from vda_tpu_torch.probes import budget, require_cuda, time_ms

# (kernel, BD, T, C): vitl mm3, mm2 (K3), mm0, mm1 (K4)
SHAPES = (("K3", 5476, 32, 256), ("K3", 1369, 32, 256),
          ("K4", 1369, 32, 1024), ("K4", 361, 32, 1024))
HEADS = 8
TOL = 2e-2
# name -> index of the step in csrc/temporal_sm90_variants.cu
VARIANTS = {"sm80": 0, "chain": 1, "chain_cl1": 2, "chain_bm256": 3,
            "fused": 4, "fused_cl1": 5, "fused_products": 6,
            "fused_loads": 7, "fused_split": 8, "fused_no_norm": 9,
            "fused_no_attn": 10, "fused_no_geglu": 11, "fused_no_resid": 12,
            "fused_lag": 13}
# steps that time a part of the fused kernel and write no output
PARTS = ("fused_products", "fused_loads", "fused_no_norm", "fused_no_attn",
         "fused_no_geglu", "fused_no_resid")
# steps of K3's whole block alone
K3_ONLY = ("fused", "fused_cl1", "fused_split", "fused_lag", *PARTS)
# name -> index of the stage in temporal_sm90_variants.cu vda_temporal_stage
STAGES = {"ln": 0, "qkv": 1, "attn": 2, "residual": 3, "geglu": 4, "ffo": 3}
# how often a block runs each stage
COUNT = {"K3": {"ln": 3, "qkv": 2, "attn": 2, "residual": 2, "geglu": 1,
                "ffo": 1},
         "K4": {"ln": 1, "qkv": 1, "attn": 1, "residual": 1}}
HBM_BYTES_S, BF16_OPS_S = 3.35e12, 989e12
BF = torch.bfloat16

launches = 0  # launches made by ``variant``
stage_launches = 0  # launches made by ``stage``


def block(gen, c: int):
    """A TemporalTransformerBlock of width c on the generator's device,
    weights uniform in +-c^-0.5 and the norms' scales about 1, as the card
    tests seed theirs."""
    from vda_tpu_torch.config import get_config
    from vda_tpu_torch.models.temporal import TemporalTransformerBlock

    blk = TemporalTransformerBlock(c, get_config("vitl"),
                                   device=gen.device)
    blk.requires_grad_(False)
    for p in blk.parameters():
        p.uniform_(-c ** -0.5, c ** -0.5, generator=gen)
    for nrm in [*blk.norms, blk.ff_norm]:
        nrm.weight.add_(1.0)
    return blk


def _operands(blk, h, pe):
    """The tensors whose pointers vda_temporal_variant takes between out
    and the workspace (K4 reads the first sub-block's alone)."""
    from vda_tpu_torch.ops import temporal_kernel as tk
    from vda_tpu_torch.ops.layers import cast_once

    f32 = torch.float32
    ts = [pe[:h.shape[1]].float().contiguous()]
    for attn, norm in zip(blk.attention_blocks, blk.norms):
        ts += tk._attn_tensors(attn, norm, h.dtype)
    proj, ffo = blk.ff.net[0].proj, blk.ff.net[2]
    ts += [cast_once(blk.ff_norm.weight, f32),
           cast_once(blk.ff_norm.bias, f32), cast_once(proj.weight, h.dtype),
           cast_once(proj.bias, f32), cast_once(ffo.weight, h.dtype),
           cast_once(ffo.bias, f32)]
    return ts


def twin(blk, h, pe, full: bool):
    """The chain's plain twin: K3's block (``full``) or K4's first
    attention sub-block, from the stage twins."""
    from vda_tpu_torch.ops import temporal_kernel as tk

    if full:
        return tk.temporal_block_stages(blk, h, pe, HEADS)
    return tk.attention_sub_stages(blk.attention_blocks[0], blk.norms[0], h,
                                   pe, HEADS)


def variant(name: str, blk, h, pe, full: bool):
    """Step ``name`` of the chain over bf16 h (BD, T, C): K3's block
    (``full``) or K4's first attention sub-block.  Returns (BD, T, C) bf16;
    on the CPU the chain's twin (every step computes the same function)."""
    global launches
    if h.device.type == "cpu":
        return twin(blk, h, pe, full)
    bd, t, c = h.shape
    if h.device.type != "cuda" or h.dtype != BF or not h.is_contiguous():
        raise ValueError(f"temporal_variant: contiguous bf16 CUDA rows, got "
                         f"{h.dtype} on {h.device}")
    lib = _build.library()
    n = ctypes.c_ulonglong(0)
    err = lib.vda_temporal_variant_workspace(bd, t, c, HEADS, int(full),
                                             VARIANTS[name], n)
    _build.check(err, "vda_temporal_variant_workspace")
    ws = torch.empty(max(n.value, 16), dtype=torch.uint8, device=h.device)
    ts = _operands(blk, h, pe)
    out = torch.zeros_like(h) if name in PARTS else torch.empty_like(h)
    err = lib.vda_temporal_variant(
        h.data_ptr(), out.data_ptr(), *(x.data_ptr() for x in ts),
        ws.data_ptr(), n.value, bd, t, c, HEADS, int(full), VARIANTS[name],
        _build.stream_ptr(h))
    _build.check(err, "vda_temporal_variant")
    launches += 1
    return out


def stage_inputs(blk, h, pe, full: bool) -> dict:
    """name -> (arguments of ``stage`` after the name, the stage twin's
    output): each stage of the block on inputs of its shape, the rows of
    h (BD, T, C) as (M, C)."""
    from vda_tpu_torch.ops import temporal_kernel as tk
    from vda_tpu_torch.ops.layers import cast_once

    bd, t, c = h.shape
    f32 = torch.float32
    attn, norm = blk.attention_blocks[0], blk.norms[0]
    x = h.reshape(bd * t, c)
    lw, lb = cast_once(norm.weight, f32), cast_once(norm.bias, f32)
    wqkv = tk.wqkv_once(attn, h.dtype)
    hn = tk.ln_ape_reference(h, lw, lb, pe).reshape(bd * t, c)
    qkv = tk.qkv_reference(hn, wqkv)
    wo = cast_once(attn.to_out[0].weight, h.dtype)
    bo = cast_once(attn.to_out[0].bias, f32)
    o = tk.seq_attention_reference(qkv.reshape(bd, t, 3 * c),
                                   HEADS).reshape(bd * t, c)
    args = {"ln": (x, lw, lb, None, pe[:t].float().contiguous()),
            "qkv": (hn, wqkv, None, None, None),
            "attn": (qkv, None, None, None, None),
            "residual": (o, wo, bo, x, None)}
    if full:
        proj, ffo = blk.ff.net[0].proj, blk.ff.net[2]
        wp, bp = cast_once(proj.weight, h.dtype), cast_once(proj.bias, f32)
        wf, bf = cast_once(ffo.weight, h.dtype), cast_once(ffo.bias, f32)
        g = tk.geglu_reference(hn, wp, bp)
        args["geglu"] = (hn, wp, bp, None, None)
        args["ffo"] = (g, wf, bf, x, None)
    return {name: (a, stage_reference(name, *a, t))
            for name, a in args.items()}


def stage_reference(name: str, a, w, b, h, pe, t: int):
    """The plain twin of stage ``name`` on ``stage``'s arguments."""
    from vda_tpu_torch.ops import temporal_kernel as tk

    m, k = a.shape
    if name == "ln":
        return tk.ln_ape_reference(a.reshape(m // t, t, k), w, b,
                                   pe).reshape(m, k)
    if name == "qkv":
        return tk.qkv_reference(a, w)
    if name == "attn":
        return tk.seq_attention_reference(a.reshape(m // t, t, k),
                                          HEADS).reshape(m, k // 3)
    if name == "geglu":
        return tk.geglu_reference(a, w, b)
    return tk.residual_reference(a, w, b, h)  # residual, ffo


def stage(name: str, full: bool, a, w, b, h, pe, t: int):
    """Stage ``name`` of the chain alone on the card (``vda_temporal_stage``,
    tagged K3's where ``full``): a (M, K) bf16, w (N, K) bf16 or the norm's
    fp32 weight, b fp32 or None, h (M, N) or None, pe (T, C) fp32 or None.
    Returns its (M, N) output (``attn``: (M, C) of a (M, 3C); ``geglu``:
    (M, N / 2))."""
    global stage_launches
    if a.device.type == "cpu":
        return stage_reference(name, a, w, b, h, pe, t)
    m, k = a.shape
    if name == "ln":
        n = k
    elif name == "attn":
        n = k // 3
    else:
        n = w.shape[0]
    out = torch.empty(m, n // 2 if name == "geglu" else n, dtype=BF,
                      device=a.device)

    def ptr(x):
        return None if x is None else x.data_ptr()

    err = _build.library().vda_temporal_stage(
        STAGES[name], int(full), a.data_ptr(), ptr(w), ptr(b), ptr(h),
        ptr(pe), out.data_ptr(), m, n, k, t, HEADS, _build.stream_ptr(a))
    _build.check(err, "vda_temporal_stage")
    stage_launches += 1
    return out


def split_weights(blk, t: int, pe) -> dict:
    """The split path's operands in bf16, cast and concatenated once (as
    the kernels' ``cast_once`` and ``wqkv_once`` do), outside its timing."""
    subs = []
    for attn, norm in zip(blk.attention_blocks, blk.norms):
        out = attn.to_out[0]
        subs.append(tuple(x.to(BF).contiguous() for x in (
            norm.weight, norm.bias,
            torch.cat([attn.to_q.weight, attn.to_k.weight, attn.to_v.weight]),
            out.weight, out.bias)))
    proj, ffo = blk.ff.net[0].proj, blk.ff.net[2]
    ffn = tuple(x.to(BF).contiguous() for x in (
        blk.ff_norm.weight, blk.ff_norm.bias, proj.weight, proj.bias,
        ffo.weight, ffo.bias))
    return {"pe": pe[:t].to(BF).contiguous(), "subs": subs, "ffn": ffn}


def split_path(ws: dict, h, full: bool):
    """The same function by library calls, as a yardstick: ``F.layer_norm``,
    ``F.linear``, ``scaled_dot_product_attention`` and ``F.gelu``, on the
    bf16 operands of ``split_weights``."""
    import torch.nn.functional as F

    bd, t, c = h.shape
    dh = c // HEADS

    def sub(w, x):
        lw, lb, wqkv, wo, bo = w
        hn = F.layer_norm(x, (c,), lw, lb, 1e-5) + ws["pe"]
        q, k, v = (y.reshape(bd, t, HEADS, dh).transpose(1, 2)
                   for y in F.linear(hn, wqkv).split(c, -1))
        o = F.scaled_dot_product_attention(q, k, v).transpose(1, 2)
        return x + F.linear(o.reshape(bd, t, c), wo, bo)

    for w in ws["subs"][:2 if full else 1]:
        h = sub(w, h)
    if not full:
        return h
    lw, lb, wp, bp, wf, bf = ws["ffn"]
    hn = F.layer_norm(h, (c,), lw, lb, 1e-5)
    x1, gate = F.linear(hn, wp, bp).chunk(2, -1)
    return h + F.linear(x1 * F.gelu(gate, approximate="tanh"), wf, bf)


def cost(kernel: str, bd: int, t: int, c: int) -> tuple[float, float]:
    """(bytes, operations) of one call: h in and out in bf16 and the bf16
    weights read once; the products (K3: two sub-blocks of 8 C^2 + 4 T C a
    row and the feed-forward's 24 C^2; K4: one sub-block)."""
    rows = bd * t
    if kernel == "K3":
        return 2 * rows * c * 2 + 20 * c * c * 2, rows * (40 * c * c
                                                          + 8 * t * c)
    return 2 * rows * c * 2 + 4 * c * c * 2, rows * (8 * c * c + 4 * t * c)


def bound_ms(kernel: str, bd: int, t: int, c: int) -> tuple[float, str]:
    """(least ms at the data-sheet rates, "bytes" or "operations")."""
    n_bytes, n_ops = cost(kernel, bd, t, c)
    t_b, t_o = n_bytes / HBM_BYTES_S, n_ops / BF16_OPS_S
    return 1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


def _rel(got, ref) -> tuple[bool, float]:
    err = float((got.float() - ref.float()).abs().max())
    r = err / max(float(ref.float().abs().max()), 1e-12)
    return bool(torch.isfinite(got).all()) and r < TOL, r


def run(steps=None, shapes=SHAPES, reps: int = 10, seed: int = 0):
    """Each step at each shape on the card: a list of dicts, one a step and
    shape (ms, max_rel against its twin, ``ok``) and one a shape
    (``beside``: the twin, the split path, the bound, ``stages_ms``)."""
    from vda_tpu_torch.models.temporal import sinusoidal_pe
    from vda_tpu_torch.ops import temporal_kernel as tk

    g = torch.Generator(device="cuda").manual_seed(seed)
    rows = []
    for kernel, bd, t, c in shapes:
        full = kernel == "K3"
        blk = block(g, c)
        pe = sinusoidal_pe(t, c)[0].cuda()
        h = torch.randn(bd, t, c, device="cuda", generator=g).to(BF)
        shape = [bd, t, c]
        ref = twin(blk, h, pe, full)
        if full:
            plain = lambda: tk.temporal_block_reference(blk, h, pe, HEADS)
        else:
            attn, norm = blk.attention_blocks[0], blk.norms[0]
            plain = lambda: tk.attention_block_reference(attn, norm, h, pe,
                                                         HEADS)
        stages_ms = 0.0
        names = [v for v in VARIANTS if (steps is None or v in steps)
                 and (full or v not in K3_ONLY)]
        for name in names:
            with budget(300):
                ms = time_ms(lambda: variant(name, blk, h, pe, full), reps)
                got = variant(name, blk, h, pe, full)
                if name in PARTS:  # nothing written
                    ok, r = bool((got == 0).all()), 0.0
                else:
                    ok, r = _rel(got, ref)
                del got
            rows.append(dict(kernel=kernel, step=name, shape=shape, ms=ms,
                             max_rel=r, ok=ok))
        cases = stage_inputs(blk, h, pe, full)
        for name, (args, want) in cases.items():
            if steps is not None and name not in steps:
                continue
            with budget(300):
                ms = time_ms(lambda: stage(name, full, *args, t), reps)
                ok, r = _rel(stage(name, full, *args, t), want)
            n = COUNT[kernel][name]
            stages_ms += n * ms
            rows.append(dict(kernel=kernel, step=name, shape=shape, ms=ms,
                             count=n, max_rel=r, ok=ok))
        del cases, ref
        bound, bound_by = bound_ms(kernel, bd, t, c)
        sw = split_weights(blk, t, pe)
        rows.append(dict(kernel=kernel, step="beside", shape=shape,
                         plain_ms=time_ms(plain, reps),
                         split_ms=time_ms(lambda: split_path(sw, h, full),
                                          reps),
                         stages_ms=stages_ms, bound_ms=bound,
                         bound_by=bound_by))
        del h, blk
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    every = list(VARIANTS) + list(STAGES)
    ap.add_argument("steps", nargs="*", metavar="step",
                    help=f"any of {', '.join(every)} (default: all)")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    unknown = set(args.steps) - set(every)
    if unknown:
        ap.error(f"unknown steps {sorted(unknown)}")
    require_cuda()
    rows = run(args.steps or None, reps=args.reps)
    for r in rows:
        print(json.dumps(r), flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0)}), flush=True)
    return 0 if all(r.get("ok", True) for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
