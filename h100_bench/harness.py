"""What every cell shares: the cell's files found by name, the program's
model built from seeded weights, host and CUDA-event spans around the
program's functions, the profiled slice of a traced window, the per-layer
metric readers, and the result line.

Nothing here names a cell.  A cell is an entry of ``BENCHMARK.json``; its
configuration is ``configs/<config>.json``, its traffic
``traffic/<traffic>.json`` (whose ``driver`` names the module of
``drivers/`` that runs it), the limits of its correctness check
``limits/<cell>.json``, and each per-layer metric ``metrics/<name>.py``.
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import os
import time
from collections import defaultdict
from typing import Callable, Dict, List

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

# kernel kind -> substrings of the kernel name, the first match wins (the
# table of vda_tpu_torch/utils/profiling.py, copied)
KINDS = (
    ("K3 temporal_block", ("temporal_block_kernel", "temporal_fused_kernel",
                           "TemporalK3")),
    ("K4 attention_block", ("attention_block_kernel", "TemporalK4")),
    ("K7 attention_proj", ("attention_heads_sm90_kernel", "attention_proj_")),
    ("K10 resize_bilinear", ("resize90_kernel", "resize_bilinear_kernel")),
    ("K8 segment_attention", ("segment90_kernel", "segment_bf16_kernel",
                              "segment_f32_kernel")),
    ("K1 attention_qkv", ("attention_sm90_kernel", "attention_qkv_")),
    ("K2 layer_norm", ("_ln_fwd",)),
    ("K5 tiny_seq", ("tiny90_kernel", "tiny1_kernel", "tiny_seq_kernel")),
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


def merge(intervals) -> list:
    """The union of (start, end) intervals as disjoint [start, end] pairs,
    in order."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def p95(values: List[float]) -> float:
    """The 95th percentile (linear between order statistics) of all
    values."""
    return float(np.percentile(np.asarray(values, np.float64), 95))


def read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


# -- the cell -------------------------------------------------------------
class Cell:
    """A workload of ``BENCHMARK.json`` with its configuration, traffic and
    limits (``load`` reads them from the files named after it)."""

    def __init__(self, name: str, cfg: dict, traffic: dict, limits: dict,
                 chips: int = 1, end_to_end=(), per_layer=()):
        self.name = name
        self.cfg = cfg
        self.traffic = traffic
        self.limits = limits
        self.chips = chips
        self.end_to_end = list(end_to_end)
        self.per_layer = list(per_layer)

    @classmethod
    def load(cls, name: str, root: str = ROOT) -> "Cell":
        bench = read_json(os.path.join(root, "BENCHMARK.json"))
        entry = {w["name"]: w for w in bench["workloads"]}.get(name)
        if entry is None:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
        cfg_entry = {c["name"]: c for c in bench["configs"]}[entry["config"]]
        return cls(name, read_json(os.path.join(root, cfg_entry["file"])),
                   read_json(os.path.join(HERE, "traffic",
                                          entry["traffic"] + ".json")),
                   read_json(os.path.join(HERE, "limits", name + ".json")),
                   entry["chips"],
                   [m for m in bench["end_to_end"]
                    if name in m.get("workloads", [name])],
                   [m for m in bench["per_layer"]
                    if name in m.get("workloads", [name])])


def port_config(cfg: dict):
    """The program's ``ModelConfig`` with the configuration file's sizes."""
    from vda_tpu_torch.config import EncoderConfig, ModelConfig

    e, m = cfg["encoder"], cfg["motion"]
    vit = EncoderConfig(embed_dim=e["embed_dim"], depth=e["depth"],
                        num_heads=e["num_heads"], mlp_ratio=e["mlp_ratio"],
                        ffn_layer=e["ffn_layer"], img_size=e["img_size"],
                        patch_size=e["patch_size"],
                        interpolate_offset=e["interpolate_offset"])
    return ModelConfig(cfg["name"], cfg["features"],
                       tuple(cfg["out_channels"]),
                       tuple(cfg["intermediate_layer_idx"]), vit,
                       num_frames=cfg["num_frames"], pe=m["pe"],
                       num_attention_heads=m["num_attention_heads"],
                       num_transformer_block=m["num_transformer_block"],
                       num_attention_blocks=m["num_attention_blocks"],
                       norm_num_groups=m["norm_num_groups"])


def build_model(cfg: dict, seed: int, device):
    """The program's model with the seeded weights, loaded strictly and
    stored as inference serves them (bf16 once, ``cast_params_for_inference``,
    for a bf16 configuration)."""
    from vda_tpu_torch import cast_params_for_inference
    from vda_tpu_torch.models.vda import VideoDepthAnything

    from h100_bench.reference.weights import make_state_dict

    sd = make_state_dict(cfg, seed, device)
    model = VideoDepthAnything(port_config(cfg), device=device)
    model.load_state_dict(sd, strict=True)
    del sd
    model.requires_grad_(False)
    if cfg["dtype"] == "bfloat16":
        cast_params_for_inference(model)
    return model


# -- clocks and spans ------------------------------------------------------
class Device:
    def __init__(self, device):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)


class Tracer:
    """Spans around the program's module functions while ``installed``:
    host-clock spans (seconds) or CUDA-event spans (resolved to seconds by
    ``resolve`` once the device has finished).  Off, it wraps nothing.
    ``slice_begin`` / ``slice_end`` run torch.profiler over a part of the
    window; spans record whether they began inside it."""

    def __init__(self, enabled: bool, dev: Device):
        self.enabled = enabled
        self.dev = dev
        self.host = defaultdict(list)
        self.events = []  # (name, start event, end event, in slice)
        self.in_slice = False
        self.prof = None
        self.slice_wall = None
        self._t_slice = None

    def _wrap(self, fn: Callable, name: str, clock: str) -> Callable:
        def host_timed(*args, **kwargs):
            with torch.profiler.record_function(name):
                t = time.perf_counter()
                out = fn(*args, **kwargs)
                self.host[name].append((time.perf_counter() - t,
                                        self.in_slice))
            return out

        def cuda_timed(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            with torch.profiler.record_function(name):
                start.record()
                out = fn(*args, **kwargs)
                end.record()
            self.events.append((name, start, end, self.in_slice))
            return out

        return cuda_timed if clock == "cuda" and self.dev.cuda else host_timed

    @contextlib.contextmanager
    def installed(self, spans):
        """spans: (module name, attribute, span name, "host" | "cuda")."""
        saved = []
        try:
            if self.enabled:
                for mod_name, attr, name, clock in spans:
                    mod = importlib.import_module(mod_name)
                    fn = getattr(mod, attr)
                    saved.append((mod, attr, fn))
                    setattr(mod, attr, self._wrap(fn, name, clock))
            yield self
        finally:
            for mod, attr, fn in reversed(saved):
                setattr(mod, attr, fn)

    def warm_profiler(self) -> None:
        """Start and stop the profiler once, so that its first start is not
        paid inside the window."""
        if self.enabled and self.dev.cuda:
            with _profile():
                torch.zeros(1, device=self.dev.device).add_(1)
                self.dev.sync()

    def slice_begin(self) -> None:
        if not self.enabled or self.prof is not None or not self.dev.cuda:
            return
        self.dev.sync()
        self.prof = _profile()
        self.prof.__enter__()
        self.in_slice = True
        self._t_slice = time.perf_counter()

    def slice_end(self) -> None:
        if not self.in_slice:
            return
        self.dev.sync()
        self.slice_wall = time.perf_counter() - self._t_slice
        self.in_slice = False
        self.prof.__exit__(None, None, None)

    def resolve(self) -> Dict[str, list]:
        """Every span: name -> [(seconds, in slice)]."""
        self.dev.sync()
        out = defaultdict(list, {k: list(v) for k, v in self.host.items()})
        for name, start, end, in_slice in self.events:
            out[name].append((start.elapsed_time(end) / 1e3, in_slice))
        return out


def _profile():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def summarize_profile(prof, slice_wall: float, annotations=()) -> dict:
    """Busy seconds (union of device operations), device seconds by kernel
    kind and by kernel name, and the longest idle gaps named by the
    innermost host activity in them.  The device-side ranges of
    ``record_function`` annotations (``annotations``) are no operations."""
    dev, cpu = [], []
    for e in prof.events():
        rng = (e.time_range.start, e.time_range.end)
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if getattr(e, "is_user_annotation", False) \
                    or e.name in annotations:
                continue
            dev.append((rng, e.name))
        else:
            cpu.append((rng, e.name))
    if not dev:
        return {}
    by_kind, by_name = defaultdict(float), defaultdict(float)
    for (s, e), name in dev:
        by_kind[kernel_kind(name)] += (e - s) / 1e6
        by_name[name] += (e - s) / 1e6
    merged = merge(r for r, _ in dev)
    busy = sum(e - s for s, e in merged) / 1e6
    # idle stretches: between device operations, and before the first and
    # after the last within the host's recorded activity
    edges = [min(r[0] for r, _ in cpu + dev)] + \
        [x for pair in merged for x in pair] + \
        [max(r[1] for r, _ in cpu + dev)]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i], edges[i + 1])
                   for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), reverse=True)[:200]
    gap_by = defaultdict(float)
    if cpu and gaps:
        starts = np.array([r[0] for r, _ in cpu], np.float64)
        ends = np.array([r[1] for r, _ in cpu], np.float64)
        names = [n for _, n in cpu]
        for length, s, e in gaps:
            mid = 0.5 * (s + e)
            hit = np.nonzero((starts <= mid) & (ends >= mid))[0]
            if hit.size:
                name = names[hit[np.argmin(ends[hit] - starts[hit])]]
            else:
                name = "no host activity"
            gap_by[name] += length / 1e6
    top = lambda d: [[k, v] for k, v in  # noqa: E731
                     sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"busy_s": busy, "window_s": slice_wall,
            "by_kind": dict(by_kind), "by_name": dict(by_name),
            "breakdown": {"device_ops": top(by_kind),
                          "idle_gaps": top(gap_by)}}


# -- per-layer metric readers ----------------------------------------------
def load_reader(name: str) -> Callable:
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "h100_bench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def peaks() -> dict:
    return read_json(os.path.join(HERE, "peaks.json"))


class Reservoir:
    """A uniform sample of ``k`` items of a stream of unknown length, drawn
    by ``rng`` (Algorithm R)."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k = k
        self.rng = rng
        self.items = []
        self.seen = 0

    def offer(self, item) -> None:
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                self.items[j] = item
        self.seen += 1


def frame_errors(program: torch.Tensor, reference: torch.Tensor) -> list:
    """Per frame of (T, H, W) depths: the RMS of the program's difference
    from the reference over the reference's standard deviation."""
    p = program.to(reference.device, torch.float32)
    rms = (p - reference).square().mean(dim=(1, 2)).sqrt()
    return (rms / reference.std(dim=(1, 2))).tolist()
