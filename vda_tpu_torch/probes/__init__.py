"""On-card measurement entry points of the port, the counterparts of the JAX
package's ``scripts/bench_int8.py`` + ``scripts/bench_int8_pallas.py``
(``bench_int8``: K13 and K11), ``scripts/bench_attn_variants.py``
(``bench_attn_variants``: K12) and ``scripts/probe_stream_kernel.py``
(``probe_stream_kernel``: K14), and the design steps of K1/K9's Hopper loop
(``bench_attn_sm90``), K7's Hopper kernel (``bench_attn_proj_sm90``) and
K11/K13's Hopper GEMM loop (``bench_gemm_sm90``), which have no JAX
counterpart::

    python -m vda_tpu_torch.probes.bench_int8
    python -m vda_tpu_torch.probes.bench_attn_variants [variant ...]
    python -m vda_tpu_torch.probes.probe_stream_kernel [stage ...]
    python -m vda_tpu_torch.probes.bench_attn_sm90 [variant ...]
    python -m vda_tpu_torch.probes.bench_attn_proj_sm90 [step ...]
    python -m vda_tpu_torch.probes.bench_gemm_sm90 [variant ...]

Each holds every kernel arm against its plain twin and exits non-zero on a
disagreement, or when an arm outlives its time budget.  Times are CUDA
events; a probe without a card fails.
"""

from __future__ import annotations

import contextlib
import faulthandler
import sys


def time_ms(fn, reps: int = 10) -> float:
    """Mean device time of ``fn`` over ``reps`` runs after a warm-up, by
    CUDA events."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


@contextlib.contextmanager
def budget(seconds: int):
    """Ends the process with exit code 1 (and every thread's traceback on
    stderr) if the body runs longer than ``seconds``: a hung kernel blocks
    the host inside a synchronize, where no Python signal handler runs."""
    faulthandler.dump_traceback_later(seconds, exit=True)
    try:
        yield
    finally:
        faulthandler.cancel_dump_traceback_later()


def require_cuda() -> None:
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        sys.exit(1)
