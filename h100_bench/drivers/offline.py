"""Offline video: whole videos, one after another, through the program's
``infer_video_depth`` (a queue of jobs), each video a camera panning over a
seeded canvas.

Traffic parameters (``traffic/<name>.json``): ``rate_metric`` (the name of
its end-to-end rate), ``frame_hw``, ``clip_lengths``
(a block of as many videos takes them in this order; a new block starts
only while the window is under ``--seconds``, so every run does whole
blocks: the same work, whatever the seed), ``pan_px``,
``pool`` (distinct canvases, used in turn), ``fps``, ``input_size``,
``warmup_frames``, ``check`` (``videos``: the first longest video and a
seeded sample of the others; ``windows``: the last window of each and a
seeded sample of the others) and ``profile`` (``skip`` videos, then
``units`` videos under the profiler in a traced run).
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch

from h100_bench import frames as fr
from h100_bench import harness
from h100_bench.reference import flops
from h100_bench.reference import protocol as P
from h100_bench.reference.model import Reference
from h100_bench.reference.weights import make_state_dict

SPANS = (
    ("vda_tpu_torch.infer.windowed", "stitch_windows", "stitch_windows",
     "host"),
    ("vda_tpu_torch.infer.windowed", "_window_step", "window_step", "cuda"),
    ("vda_tpu_torch.models.vda", "encode", "encoder", "cuda"),
    ("vda_tpu_torch.models.dpt", "dpt_head_temporal_stage", "head_stage",
     "cuda"),
    ("vda_tpu_torch.models.dpt", "dpt_head_temporal_tail", "output_tail",
     "cuda"),
)


def windows_of(n_frames: int) -> int:
    return len(range(0, n_frames, P.INFER_LEN - P.OVERLAP))


def setup(ctx):
    from vda_tpu_torch.infer import windowed

    tr, dev = ctx.traffic, ctx.dev
    h, w = tr["frame_hw"]
    lengths = tr["clip_lengths"]
    st = SimpleNamespace(model=harness.build_model(ctx.cfg, ctx.seed,
                                                   dev.device))
    st.canvases = fr.canvases(ctx.seed, tr["pool"], h,
                              w + (max(lengths) - 1) * tr["pan_px"],
                              dev.device)

    def video(v: int) -> np.ndarray:
        return fr.panned(st.canvases[v % tr["pool"]],
                         lengths[v % len(lengths)], (h, w), tr["pan_px"])

    st.video = video
    st.infer = windowed.infer_video_depth
    st.net_hw = P.net_size(h, w, tr["input_size"],
                           ctx.cfg["encoder"]["patch_size"])
    st.infer(st.model, video(0)[:tr["warmup_frames"]], tr["fps"],
             input_size=tr["input_size"])
    st.runs = []  # (frames, windows) of each video
    st.longest = None
    st.sample = harness.Reservoir(tr["check"]["videos"] - 1,
                                  np.random.default_rng([ctx.seed, 2]))
    st.wall = 0.0
    st.nonzero_share = None
    return st


def window(ctx, st) -> None:
    from vda_tpu_torch.infer import windowed

    tr, tracer = ctx.traffic, ctx.tracer
    first = tr["profile"]["skip"]
    last = first + tr["profile"]["units"] - 1
    captured = []
    stitch = windowed.stitch_windows

    def capture(depth_list, *args, **kwargs):
        captured.append(depth_list)
        return stitch(depth_list, *args, **kwargs)

    windowed.stitch_windows = capture
    try:
        v = 0
        block = len(tr["clip_lengths"])
        t_start = time.perf_counter()
        t_end = t_start
        while v % block or t_end - t_start < ctx.seconds:
            frames = st.video(v)
            if v == first:
                tracer.slice_begin()
            captured.clear()
            depths, _ = st.infer(st.model, frames, tr["fps"],
                                 input_size=tr["input_size"])
            t_end = time.perf_counter()
            if v == last:
                tracer.slice_end()
            n = frames.shape[0]
            st.runs.append((n, windows_of(n)))
            kept = (v, frames, captured[0], depths)
            if st.longest is None or n > st.longest[1].shape[0]:
                kept, st.longest = st.longest, kept
            if kept is not None:
                st.sample.offer(kept)
            v += 1
        st.wall = t_end - t_start
    finally:
        windowed.stitch_windows = stitch


def record(ctx, st) -> dict:
    rec = {"attempted": len(st.runs),
           "frames": sum(r[0] for r in st.runs),
           "windows": sum(r[1] for r in st.runs),
           "wall_s": st.wall,
           "window_frames": P.INFER_LEN}
    if ctx.trace:
        rec["window_flops"] = flops.window_flops(ctx.cfg, st.net_hw)
        rec["attention"] = flops.encoder_attention(ctx.cfg, st.net_hw,
                                                   P.INFER_LEN)
    return rec


def end_to_end(ctx, st) -> dict:
    return {ctx.traffic["rate_metric"]: sum(r[0] for r in st.runs) / st.wall}


def release(st) -> None:
    st.model = None
    st.infer = None


def check(ctx, st, control: bool = False) -> dict:
    """``window_err``: each compared window's frames, the program's depths
    before stitching against the reference's window; ``stitch_err``: each
    compared video, the program's stitched depths against the reference's
    stitching of the program's window depths (largest gap over the
    reference's standard deviation).  ``control``: the same numbers of the
    control in the program's place (the reference in fp8, the stitching in
    bf16), for setting the limits; a run never computes them."""
    tr, device = ctx.traffic, ctx.dev.device
    sd = make_state_dict(ctx.cfg, ctx.seed, device)
    ref = Reference(ctx.cfg, sd)
    low = Reference(ctx.cfg, sd, fp8=True)
    rng = np.random.default_rng([ctx.seed, 3])
    kept = {k[0]: k for k in [st.longest] + st.sample.items if k}
    window_err, stitch_err, nonzero = [], [], []
    for v, frames, raw, depths in (kept[v] for v in sorted(kept)):
        nw = len(raw) // P.INFER_LEN
        more = min(tr["check"]["windows"], nw) - 1
        picks = {nw - 1}
        if more > 0:
            picks |= set(rng.choice(nw - 1, size=more, replace=False).tolist())
        for w in sorted(picks):
            with torch.no_grad():
                r = P.window_depth(ref, frames, w, tr["input_size"], device)
                if control:
                    p = P.window_depth(low, frames, w, tr["input_size"],
                                       device)
                else:
                    p = torch.from_numpy(np.stack(
                        raw[w * P.INFER_LEN:(w + 1) * P.INFER_LEN]))
            window_err += harness.frame_errors(p, r)
            nonzero.append(float((r > 0).float().mean()))
            del r, p
        s = torch.from_numpy(P.stitch(raw)[:frames.shape[0]])
        out = torch.from_numpy(P.stitch(raw, torch.bfloat16)[:frames.shape[0]]
                               if control else depths)
        stitch_err.append(float((out - s).abs().max() / s.std()))
    st.nonzero_share = min(nonzero) if nonzero else None
    return {"window_err": window_err, "stitch_err": stitch_err}
