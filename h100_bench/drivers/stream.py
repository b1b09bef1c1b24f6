"""A live stream: one camera through the program's ``StreamingDepth`` at
its defaults, fed in groups by ``submit_group`` with one group in flight
(the next group is submitted before the previous one's depths are
fetched), the first frame by ``submit``.  Set-up runs the stream past the
cache's eviction onset, so the window is steady state.

The camera sweeps across a seeded canvas and back, ``pan_px`` pixels a
frame over ``sweep_positions`` positions, so consecutive frames are
coherent and the reference, which replays every step from frame 0, encodes
each position once.

Traffic parameters: ``frame_hw``, ``group``, ``fill_frames``, ``pan_px``,
``sweep_positions``, ``input_size``, ``check`` (``groups``: the window's
last group and a seeded sample of the others) and ``profile`` (``skip``
groups, then ``units`` groups under the profiler in a traced run).
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
    ("vda_tpu_torch.infer.streaming", "forward_features", "encoder", "cuda"),
    ("vda_tpu_torch.infer.streaming", "dpt_head_temporal_stage", "head",
     "cuda"),
    ("vda_tpu_torch.infer.streaming", "dpt_head_temporal_tail", "head",
     "cuda"),
)


def setup(ctx):
    from vda_tpu_torch.infer.streaming import StreamingDepth

    tr, dev = ctx.traffic, ctx.dev
    h, w = tr["frame_hw"]
    positions = tr["sweep_positions"]
    st = SimpleNamespace(model=harness.build_model(ctx.cfg, ctx.seed,
                                                   dev.device))
    canvas = fr.canvases(ctx.seed, 1, h,
                         w + (positions - 1) * tr["pan_px"], dev.device)[0]
    st.views = fr.panned(canvas, positions, (h, w), tr["pan_px"])
    st.position = lambda i: fr.sweep_position(i, positions)
    st.stream = StreamingDepth(st.model, input_size=tr["input_size"])
    st.net_hw = P.net_size(h, w, tr["input_size"],
                           ctx.cfg["encoder"]["patch_size"])
    st.stream.submit(np.ascontiguousarray(st.views[st.position(0)])).cpu()
    st.next = 1
    pending = None
    while st.next + tr["group"] <= tr["fill_frames"]:
        handle = st.stream.submit_group(group_frames(st, tr["group"]))
        if pending is not None:
            pending.cpu()
        pending = handle
    pending.cpu()
    st.latency, st.host = [], []
    st.frames = 0
    st.wall = 0.0
    st.sample = harness.Reservoir(tr["check"]["groups"] - 1,
                                  np.random.default_rng([ctx.seed, 2]))
    st.last = None
    st.nonzero_share = None
    return st


def group_frames(st, k: int) -> np.ndarray:
    """The next k frames as one (k, H, W, 3) uint8 array."""
    idx = [st.position(st.next + j) for j in range(k)]
    st.next += k
    return st.views[idx]


def window(ctx, st) -> None:
    tr, tracer = ctx.traffic, ctx.tracer
    k = tr["group"]
    first = tr["profile"]["skip"]
    last = first + tr["profile"]["units"] - 1
    pending = None  # (first frame, submit time, depths on the device)
    g = 0
    t_start = time.perf_counter()

    def fetch(item):
        d = item[2].cpu().numpy()
        st.latency.append(time.perf_counter() - item[1])
        return (item[0], d)

    while time.perf_counter() - t_start < ctx.seconds:
        batch = group_frames(st, k)
        if g == first:
            tracer.slice_begin()
        t = time.perf_counter()
        handle = st.stream.submit_group(batch)
        st.host.append(time.perf_counter() - t)
        if pending is not None:
            st.sample.offer(fetch(pending))
        pending = (st.next - k, t, handle)
        if g == last:
            tracer.slice_end()
        g += 1
    st.last = fetch(pending)
    st.wall = time.perf_counter() - t_start
    st.frames = g * k


def record(ctx, st) -> dict:
    rec = {"attempted": len(st.latency), "frames": st.frames,
           "wall_s": st.wall, "host_s": sum(st.host)}
    if ctx.trace:
        rec["step_flops"] = flops.stream_step_flops(ctx.cfg, st.net_hw)
    return rec


def end_to_end(ctx, st) -> dict:
    return {"stream_fps": st.frames / st.wall,
            "stream_p95_ms": 1e3 * harness.p95(st.latency)}


def release(st) -> None:
    st.stream = None
    st.model = None


def check(ctx, st, control: bool = False) -> dict:
    """``stream_err``: each frame of the compared groups, the program's
    depth against the reference stream replayed from frame 0.
    ``control``: the reference stream in fp8 in the program's place, for
    setting the limit; a run never computes it."""
    device = ctx.dev.device
    sd = make_state_dict(ctx.cfg, ctx.seed, device)
    groups = dict(st.sample.items + [st.last])
    k = ctx.traffic["group"]
    want = {f0 + j: (f0, j) for f0 in groups for j in range(k)}

    def frame(i):
        p = st.position(i)
        return torch.from_numpy(np.ascontiguousarray(st.views[p])), p

    def replay(fp8):
        return P.StreamReplay(Reference(ctx.cfg, sd, fp8=fp8), frame,
                              ctx.traffic["input_size"], device)

    ref = replay(False)
    low = replay(True) if control else None
    errs, nonzero = [], []
    with torch.no_grad():
        for i in range(max(want) + 1):
            r = ref.step(i in want)
            p = low.step(i in want) if control else None
            if r is None:
                continue
            if not control:
                f0, j = want[i]
                p = torch.from_numpy(groups[f0][j])
            errs += harness.frame_errors(p[None], r[None])
            nonzero.append(float((r > 0).float().mean()))
    st.nonzero_share = min(nonzero)
    return {"stream_err": errs}
