"""One run of one cell: set-up, the measured window, the check against the
reference, the metrics, and the result object.

``run_cell`` takes no notice of how many cards there are; ``run.py`` checks
that before it calls.  Tests call it with a small configuration on the CPU
and the program broken underneath, to see ``correct`` come out false.
"""

from __future__ import annotations

import contextlib
import importlib
import math
import time
from types import SimpleNamespace

import torch

from h100_bench import harness


def _recording(trace: bool):
    """In a traced run, the program's recording of its own spans and
    counters (``vda_tpu_torch/utils/trace.py``), whose snapshot the run's
    record keeps under ``"program"`` for the readers of
    ``program_readers.py``; a program without the recorder, and every
    untraced run, records nothing (yields None)."""
    if trace:
        try:
            from vda_tpu_torch.utils import trace as program_trace
        except ImportError:
            pass
        else:
            return program_trace.recording()
    return contextlib.nullcontext()


def run_cell(cell: harness.Cell, seed: int, seconds: float, trace: bool,
             device, t0: float, control: bool = False):
    """Returns (result object, the lines that give each number compared
    beside its limit).  ``control`` (``calibrate.py`` only) adds the
    control's readings of the same numbers under the result's
    ``"control"``."""
    dev = harness.Device(device)
    tracer = harness.Tracer(trace, dev)
    driver = importlib.import_module("h100_bench.drivers."
                                     + cell.traffic["driver"])
    ctx = SimpleNamespace(cell=cell, cfg=cell.cfg, traffic=cell.traffic,
                          seed=seed, seconds=seconds, trace=trace, dev=dev,
                          tracer=tracer)
    state = driver.setup(ctx)
    tracer.warm_profiler()
    dev.sync()
    setup_s = time.perf_counter() - t0
    with tracer.installed(driver.SPANS), _recording(trace) as rec:
        driver.window(ctx, state)
    tracer.slice_end()
    record = {"spans": tracer.resolve(), "cfg": cell.cfg,
              "traffic": cell.traffic, "peaks": harness.peaks(),
              "profile": {},
              "program": rec.snapshot() if rec is not None else None}
    if tracer.prof is not None:
        annotations = {s[2] for s in driver.SPANS}
        if record["program"]:
            annotations |= {s["name"] for s in record["program"]["spans"]}
        record["profile"] = harness.summarize_profile(
            tracer.prof, tracer.slice_wall, annotations)
    peak = torch.cuda.max_memory_allocated(dev.device) if dev.cuda else 0
    record.update(driver.record(ctx, state))
    driver.release(state)
    if dev.cuda:
        torch.cuda.empty_cache()

    checks = driver.check(ctx, state)
    if control:
        low = driver.check(ctx, state, control=True)
    compared, failed, lines = {}, 0, []
    for name, values in checks.items():
        limit = cell.limits[name]
        worst = max(values) if values else math.inf
        failed += sum(1 for v in values if not v <= limit)
        if not values:
            failed += 1
        compared[name] = {"value": worst, "limit": limit}
        lines.append(f"{name} {worst!r} limit {limit!r}")

    metrics = {}
    if trace:
        for m in cell.per_layer:
            value = harness.load_reader(m["name"])(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        produced = dict(driver.end_to_end(ctx, state), setup_s=setup_s)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": produced[m["name"]],
                                  "unit": m["unit"]}
    dev_info = {"platform": "gpu" if dev.cuda else "cpu",
                "kind": (torch.cuda.get_device_name(dev.device) if dev.cuda
                         else "cpu"),
                "count": 1, "memory_peak_bytes": peak}
    result = {"correct": failed == 0, "attempted": record["attempted"],
              "failed": failed, "metrics": metrics, "device": dev_info}
    prof = record["profile"]
    if trace and prof:
        dev_info["busy_s"] = prof["busy_s"]
        dev_info["window_s"] = prof["window_s"]
        result["breakdown"] = prof["breakdown"]
    result["depth_nonzero_share"] = state.nonzero_share
    if control:
        result["control"] = {k: max(v) for k, v in low.items()}
    result["checks"] = compared
    return result, lines
