"""On-card measurement entry points of the port, the counterparts of the JAX
package's ``scripts/bench_int8.py`` + ``scripts/bench_int8_pallas.py``
(``bench_int8``: K13 and K11), ``scripts/bench_attn_variants.py``
(``bench_attn_variants``: K12) and ``scripts/probe_stream_kernel.py``
(``probe_stream_kernel``: K14), and the design steps of K1/K9's Hopper loop
(``bench_attn_sm90``), K7's Hopper kernel (``bench_attn_proj_sm90``),
K11/K13's Hopper GEMM loop (``bench_gemm_sm90``), K3/K4's Hopper code
(``bench_temporal_sm90``), K6's Hopper loop (``bench_stream_sm90``),
K10's Hopper kernel (``bench_resize_sm90``) and K5's and K8's Hopper code
(``bench_short_attn_sm90``; ``time_short_attn_paths`` times the paths that
launch them against another checkout), which have no JAX counterpart;
``param_casts.ParamCasts`` counts a model's parameter casts at use::

    python -m vda_tpu_torch.probes.bench_int8
    python -m vda_tpu_torch.probes.bench_attn_variants [variant ...]
    python -m vda_tpu_torch.probes.probe_stream_kernel [stage ...]
    python -m vda_tpu_torch.probes.bench_attn_sm90 [variant ...]
    python -m vda_tpu_torch.probes.bench_attn_proj_sm90 [step ...]
    python -m vda_tpu_torch.probes.bench_gemm_sm90 [variant ...]
    python -m vda_tpu_torch.probes.bench_temporal_sm90 [step ...]
    python -m vda_tpu_torch.probes.bench_stream_sm90 [step ...]
    python -m vda_tpu_torch.probes.bench_resize_sm90 [step ...]
    python -m vda_tpu_torch.probes.bench_short_attn_sm90 [step ...]
    python vda_tpu_torch/probes/time_short_attn_paths.py --against DIR

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


_cycles_per_ms = None  # torch.cuda._sleep cycles a millisecond, once measured


def _hold(ms: float) -> None:
    """Keeps the current stream busy for about ``ms`` with
    ``torch.cuda._sleep``, so that what the host enqueues next waits."""
    import torch

    global _cycles_per_ms
    if _cycles_per_ms is None:
        n = 10_000_000
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        torch.cuda._sleep(n)
        end.record()
        torch.cuda.synchronize()
        _cycles_per_ms = n / start.elapsed_time(end)
    torch.cuda._sleep(int(ms * _cycles_per_ms))


def _warm_host_ms(fn) -> float:
    """Host ms of one call of ``fn`` (the warm-up), the device idle."""
    import time

    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_ms = 1e3 * (time.perf_counter() - t0)
    torch.cuda.synchronize()
    return host_ms


def time_held_ms(fn, reps: int = 10) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back runs after a
    warm-up, by CUDA events, the device held by ``torch.cuda._sleep`` while
    the host enqueues them: a call whose host work (wrapper checks, ctypes)
    outlasts its kernel is timed by its kernels, not by the host's pace."""
    import torch

    host_ms = _warm_host_ms(fn)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    _hold(min(2 * reps * host_ms + 1.0, 2000.0))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_us(fn, reps: int = 50) -> float:
    """Mean host microseconds of a call of ``fn`` after a warm-up (its
    Python and C launch work), the device held by ``torch.cuda._sleep`` so
    that no call waits for the device."""
    import time

    import torch

    host_ms = _warm_host_ms(fn)
    _hold(min(2 * reps * host_ms + 1.0, 2000.0))
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e6 * (t1 - t0) / reps


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
