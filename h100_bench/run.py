"""Run one cell of the benchmark once and print its result line.

    python3 -m h100_bench.run --workload vitl.offline_720p --seed 7 \\
        --seconds 30 --trace 0

From the root of a checkout on a machine with the cards the cell asks for.
It makes the weights and the frames from ``--seed``, warms up every shape
the cell uses (``setup_s``), measures for ``--seconds``, then checks what
the timed path produced against the plain reference (``correct``).  With
``--trace 0`` the result's metrics are the cell's end-to-end metrics; with
``--trace 1`` its per-layer metrics, read from spans around the program's
functions, from the program's own recording of its spans and counters
(open around the window in a traced run only) and from torch.profiler
over a slice of the window.  The last
line of standard output is the result as one JSON object; the numbers
compared, each beside its limit, are the last lines of standard error and
the result's last key.

Without a CUDA card, with fewer cards than the cell asks for, or with
JAX or the JAX package loaded in this process at the end, it exits with 2
and prints no result.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "vda_tpu")


def _environment() -> None:
    """The program's defaults (no ``VDA_*`` knob), and every build and
    kernel cache at a fixed path inside the checkout."""
    for k in [k for k in os.environ if k.startswith("VDA_")]:
        del os.environ[k]
    cache = os.path.join(HERE, ".cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                      "torch_extensions")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (compared whole: ``vda_tpu_torch`` is not ``vda_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()

    import torch

    from h100_bench import harness, session

    cell = harness.Cell.load(args.workload)
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); this "
              f"process sees {cards}", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(f"card: {smi.stdout.strip() or smi.stderr.strip()}", flush=True)
    result, lines = session.run_cell(cell, args.seed, args.seconds,
                                     bool(args.trace), "cuda:0", T0)
    bad = forbidden_modules()
    if bad:
        print(f"loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 2
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
