"""Where the device time of the vitl main path goes, on one CUDA device.

    python -m vda_tpu_torch.utils.profiling [--reps 5] [--frames 54]
    python -m vda_tpu_torch.utils.profiling --stream [--frames 48]

Counterpart of ``vda_tpu/utils/profiling.py`` for the port.  Builds vitl
from ``init_random`` (seed 0), prints the card's ``nvidia-smi`` name and
power limit, then three JSON lines:

- ``layers``: milliseconds of each layer function of ``models/`` within one
  bf16 1x32x518x518 window ``forward``, by CUDA events recorded around every
  call, mean over ``reps`` forwards after a warm-up: the encoder, the tap
  projections and resize layers, each motion module, the output tail, and
  by difference the rest of the head and of the forward (``head`` is the
  head's stage and tail, as it always was here);
- ``profile_window``: one window ``forward`` under ``torch.profiler``:
  device time and launches by kernel kind, the largest kernels, and the
  device's idle share (1 - union of kernel intervals / host wall time);
- ``profile_end_to_end``: the same for ``infer_video_depth`` on a
  ``frames``-frame 518x518 video.

With ``--fused`` the windows run ``fuse_proj=True, resize_kernel=True``
(K7 and K10) and the streams ``fuse_proj=True``; compare it with a run
without, in one call.

With ``--stream`` it measures causal streaming instead (bf16, 518x518
frames), once without and once with ``ctx_kernel``:

- ``stream_layers``: milliseconds of each layer of a steady step (the mean
  over the steps after the twelfth, past eviction onset), by CUDA events:
  the encoder, the tap projections, each motion module, the output tail,
  the cache write, and by difference the rest of the head and the rest of
  the step (upload, preprocessing, context gather, the resize and ReLU
  after the head, the resize to the frame).  ``head`` is the head's stage
  and tail, as in ``layers``: before the recorder it was all of
  ``forward_depth`` here, its resize and ReLU included, which
  ``step.rest`` now holds;
- ``profile_stream``: those steady steps under ``torch.profiler``.

The layers are the device spans the port records while
``utils/trace.recording()`` is open (the window's ``forward`` a span of
this tool's own); nothing is timed outside this tool's recordings.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from collections import defaultdict

import numpy as np
import torch

from vda_tpu_torch.utils import trace

# kind -> substrings of the kernel name; the first kind that matches wins
KINDS = (
    # K3/K4: the kernels of temporal_block.cu, K3's fused Hopper kernel and
    # the Hopper chain's stages, whose types carry the kernel's tag (its
    # products are GEMM kernels: they must not count as cuBLAS's, nor its
    # attention as K1's)
    ("K3 temporal_block", ("temporal_block_kernel", "temporal_fused_kernel",
                           "TemporalK3")),
    ("K4 attention_block", ("attention_block_kernel", "TemporalK4")),
    # K7: the Hopper kernel (bf16, head width 64) and the mma.sync ones
    ("K7 attention_proj", ("attention_heads_sm90_kernel", "attention_proj_")),
    # K10: the Hopper kernel and the one it replaced
    ("K10 resize_bilinear", ("resize90_kernel", "resize_bilinear_kernel")),
    # K8: the Hopper code (bf16, head width 64) and the mma.sync / fp32 ones
    ("K8 segment_attention", ("segment90_kernel", "segment_bf16_kernel",
                              "segment_f32_kernel")),
    # K1 (K9 launches it too): the Hopper loop and the mma.sync / fp32 ones
    ("K1 attention_qkv", ("attention_sm90_kernel", "attention_qkv_")),
    ("K2 layer_norm", ("_ln_fwd",)),
    # K5: the Hopper code (T >= 2 and T = 1) and the kernel it replaced
    ("K5 tiny_seq", ("tiny90_kernel", "tiny1_kernel", "tiny_seq_kernel")),
    # K6: the Hopper loop (bf16, head widths up to 128) and the other
    ("K6 stream_kv", ("kv_loop_kernel", "stream_kv_kernel")),
    ("copy", ("Memcpy", "Memset", "copy_kernel")),
    ("conv (cuDNN)", ("fprop", "conv", "cudnn")),
    ("gemm (cuBLAS)", ("gemm", "nvjet", "cutlass")),
    ("reduction", ("reduce",)),
    ("elementwise", ("elementwise",)),
)


def kernel_kind(name: str) -> str:
    for kind, keys in KINDS:
        if any(k in name for k in keys):
            return kind
    return "other"


def busy_ms(intervals) -> float:
    """Length of the union of (start, end) intervals, in their unit / 1e3
    (the profiler's microseconds give milliseconds)."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total / 1e3


# the head's layers in the JSON phases, each a span of utils/trace.py
_HEAD_LAYERS = ("head.project_resize", "head.temporal_mm0",
                "head.temporal_mm1", "head.temporal_mm2", "head.temporal_mm3",
                "head.output_tail")


def _device_ms(spans, n: int) -> dict:
    """Device milliseconds of each span name, summed over ``spans`` and
    divided by ``n``."""
    ms = defaultdict(float)
    for s in spans:
        if s["device_ms"] is not None:
            ms[s["name"]] += s["device_ms"] / n
    return ms


def _layers(ms: dict, outer: str, outer_key: str) -> dict:
    """From ``_device_ms``: the encoder, the head and its layers, the
    ``outer`` span (as ``outer_key``) and, by difference, the head's
    rest."""
    out = {"encoder": ms["encoder"],
           "head": ms["head.stage"] + ms["head.tail"],
           outer_key: ms[outer]}
    out.update((k, ms[k]) for k in _HEAD_LAYERS)
    out["head.rest"] = out["head"] - sum(ms[k] for k in _HEAD_LAYERS)
    return out


def layer_times(model, x, reps: int = 5, **kw) -> dict:
    """Mean milliseconds a window ``forward(**kw)`` spends in each layer,
    from the spans of ``utils/trace.py``."""
    from vda_tpu_torch.models import vda

    vda.forward(model, x, **kw)  # warm-up
    torch.cuda.synchronize()
    with trace.recording() as rec:
        for _ in range(reps):
            with trace.span("forward", device=x):
                vda.forward(model, x, **kw)
    ms = _layers(_device_ms(rec.snapshot()["spans"], reps), "forward",
                 "forward")
    ms["forward.rest"] = ms["forward"] - ms["encoder"] - ms["head"]
    return ms


def stream_layer_times(model, frames, ctx_kernel: bool,
                       warm: int = 12, fuse_proj: bool = False) -> dict:
    """Mean milliseconds a steady ``StreamingDepth`` step (steps ``warm``
    and later) spends in each layer, from the spans of ``utils/trace.py``;
    ``step.rest`` is the rest of ``submit`` (the frame's upload,
    preprocessing, context gather, the resize and ReLU after the head and
    the resize to the frame)."""
    import vda_tpu_torch as vt

    stream = vt.StreamingDepth(model, ctx_kernel=ctx_kernel,
                               fuse_proj=fuse_proj)
    for f in frames[:warm]:
        stream.submit(f)
    torch.cuda.synchronize()
    with trace.recording() as rec:
        for f in frames[warm:]:
            stream.submit(f)
    spans = _device_ms(rec.snapshot()["spans"], len(frames) - warm)
    ms = _layers(spans, "stream.step", "step")
    ms["cache_write"] = spans["stream.cache_write"]
    ms["step.rest"] = (ms["step"] - ms["encoder"] - ms["head"]
                       - ms["cache_write"])
    return ms


def device_profile(fn) -> dict:
    """Run ``fn`` once under torch.profiler: device time and launches by
    kernel kind, the largest kernels, and the device's idle share."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise RuntimeError("torch.profiler recorded no device kernels")
    by_kind, launches, by_name = (defaultdict(float), defaultdict(int),
                                  defaultdict(float))
    for e in kernels:
        d = (e.time_range.end - e.time_range.start) / 1e3
        by_kind[kernel_kind(e.name)] += d
        launches[kernel_kind(e.name)] += 1
        by_name[e.name[:90]] += d
    busy = busy_ms((e.time_range.start, e.time_range.end) for e in kernels)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    return dict(wall_ms=wall_ms, device_busy_ms=busy,
                idle_share=1 - busy / wall_ms,
                kernel_ms_by_kind=dict(sorted(by_kind.items(),
                                              key=lambda kv: -kv[1])),
                launches_by_kind=dict(launches), top_kernels_ms=dict(top))


def main(argv=None) -> int:
    import vda_tpu_torch as vt
    from vda_tpu_torch.utils.transform import preprocess_frames

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--frames", type=int, default=None,
                    help="video length (default 54; 48 with --stream)")
    ap.add_argument("--stream", action="store_true",
                    help="measure causal streaming instead of windows")
    ap.add_argument("--fused", action="store_true",
                    help="switch on K7 (and K10 for windows)")
    args = ap.parse_args(argv)
    win_kw = dict(fuse_proj=True, resize_kernel=True) if args.fused else {}
    fuse = dict(fuse_proj=args.fused)
    n_frames = args.frames or (48 if args.stream else 54)
    if not torch.cuda.is_available():
        raise SystemExit("profiling needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    model = vt.init_random(vt.get_config("vitl"),
                           torch.Generator(device="cuda").manual_seed(0),
                           device="cuda").requires_grad_(False)
    frames = (np.random.default_rng(0).random((n_frames, 518, 518, 3))
              * 255).astype(np.uint8)
    if args.stream:
        for ctx_kernel in (False, True):
            print(json.dumps({"phase": "stream_layers",
                              "ctx_kernel": ctx_kernel, **fuse,
                              "steps": n_frames - 12,
                              "ms": stream_layer_times(model, frames,
                                                       ctx_kernel, **fuse)}),
                  flush=True)
            stream = vt.StreamingDepth(model, ctx_kernel=ctx_kernel, **fuse)
            for f in frames[:12]:
                stream.submit(f)
            print(json.dumps({"phase": "profile_stream",
                              "ctx_kernel": ctx_kernel, **fuse,
                              "steps": n_frames - 12,
                              **device_profile(lambda: [
                                  stream.submit(f) for f in frames[12:]])}),
                  flush=True)
        return 0
    x = preprocess_frames(torch.from_numpy(frames[:32][None]).cuda(),
                          (518, 518), dtype=torch.bfloat16)
    # the tail in 16-frame chunks, as infer_video_depth runs it
    win_kw["micro_batch_size"] = 16
    print(json.dumps({"phase": "layers", "reps": args.reps, **win_kw,
                      "ms": layer_times(model, x, args.reps, **win_kw)}),
          flush=True)
    vt.forward(model, x, **win_kw)  # warm-up outside the profiler
    print(json.dumps({"phase": "profile_window", **win_kw,
                      **device_profile(lambda: vt.forward(model, x,
                                                          **win_kw))}),
          flush=True)
    kw = {k: v for k, v in win_kw.items() if k != "micro_batch_size"}
    vt.infer_video_depth(model, frames[:32], 30.0, **kw)
    print(json.dumps({"phase": "profile_end_to_end", "frames": n_frames,
                      **kw, **device_profile(lambda: vt.infer_video_depth(
                          model, frames, 30.0, **kw))}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
