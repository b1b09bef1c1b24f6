"""The benchmark's cells at the program's tiny configuration and small
frames, with limits for that size, for tests on the CPU."""

import json
import os

from h100_bench import harness

HERE = os.path.dirname(os.path.abspath(__file__))
# the tiny bf16 program reads 0.02-0.05 on these numbers, the fp8 control
# 0.24-0.61 and the bf16 stitching 0.15-0.45
LIMITS = {"offline": {"window_err": 0.1, "stitch_err": 1e-3},
          "stream": {"stream_err": 0.1}}
SMALL = {"frame_hw": [60, 80], "input_size": 56}
CONFIGS = ("tiny", "tiny_swiglu")


def cell(name: str, config: str = "tiny") -> harness.Cell:
    """The cell ``name`` of BENCHMARK.json with a tiny configuration of
    this folder (``tiny``: the GELU MLP; ``tiny_swiglu``: vitg's SwiGLU)."""
    bench = harness.read_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
    entry = {w["name"]: w for w in bench["workloads"]}[name]
    traffic = harness.read_json(os.path.join(
        harness.HERE, "traffic", entry["traffic"] + ".json"))
    traffic.update(SMALL)
    if traffic["driver"] == "offline":
        traffic.update(pool=4, clip_lengths=[24, 56])
    cfg = harness.read_json(os.path.join(HERE, config + ".json"))
    pick = lambda ms: [m for m in ms  # noqa: E731
                       if name in m.get("workloads", [name])]
    return harness.Cell(name, cfg, traffic, LIMITS[traffic["driver"]], 1,
                        pick(bench["end_to_end"]), pick(bench["per_layer"]))


def dump(result) -> str:
    return json.dumps(result["checks"])
