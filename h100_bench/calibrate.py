"""Readings that the limits of ``correct`` are set from, in one process.

    python3 -m h100_bench.calibrate --workload vitl.offline_720p \\
        --seeds 11,12,13 --control-seeds 11,12,13 --seconds 12

For every seed it runs the cell as ``run.py`` does (set-up, a window of
``--seconds``, the check) and prints one JSON line with the numbers
compared; for the control seeds it also computes the control's readings of
the same numbers: the reference in fp8 in the program's place (the
stitching in bf16).  The benchmark's own runs never compute the control.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from h100_bench import run as bench_run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\\n\\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    bench_run._environment()

    import torch

    from h100_bench import harness, session

    cell = harness.Cell.load(args.workload)
    if not torch.cuda.is_available():
        print("calibration needs a CUDA card", file=sys.stderr)
        return 2
    control = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        result, _ = session.run_cell(cell, seed, args.seconds, False,
                                     "cuda:0", t, control=seed in control)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "seconds": time.perf_counter() - t,
                          "correct": result["correct"],
                          "checks": {k: v["value"] for k, v in
                                     result["checks"].items()},
                          "control": result.get("control"),
                          "metrics": {k: v["value"] for k, v in
                                      result["metrics"].items()},
                          "nonzero": result["depth_nonzero_share"],
                          "peak": result["device"]["memory_peak_bytes"]}),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
