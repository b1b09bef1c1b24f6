"""The arithmetic of the per-layer metrics, shared by the readers of
``metrics/`` (one file a metric, found by its name): each takes the run's
record (spans, counters, the profiled slice, the peaks) and returns the
metric, or None where the run has nothing to read."""

from __future__ import annotations

ATTENTION_KERNELS = ("attention_sm90_kernel", "attention_qkv_", "flash_fwd",
                     "fmha", "efficient_attention", "sdpa")


def _total(rec, span, in_slice=None):
    spans = rec["spans"].get(span)
    if not spans:
        return None
    return sum(s for s, inside in spans
               if in_slice is None or inside == in_slice)


def per_frame_ms(rec, span):
    """Milliseconds of a span over the frames run in the window."""
    total = _total(rec, span)
    if total is None or not rec.get("frames"):
        return None
    return 1e3 * total / rec["frames"]


def per_window_frame_ms(rec, span):
    """Milliseconds of a span over the frames the network computed: 32 a
    window, padding and overlap included."""
    total = _total(rec, span)
    if total is None or not rec.get("windows"):
        return None
    return 1e3 * total / (rec["windows"] * rec["window_frames"])


def driver_gap_ms(rec):
    """Milliseconds a window that are neither the window's device work
    (CUDA events around ``_window_step``) nor host stitching."""
    steps = _total(rec, "window_step")
    if steps is None or not rec.get("windows"):
        return None
    busy = steps + (_total(rec, "stitch_windows") or 0.0)
    return 1e3 * (rec["wall_s"] - busy) / rec["windows"]


def attention_roofline(rec):
    """The encoder attention's least time in the profiled slice (every
    ``encode`` call's operations at the bf16 peak or bytes at the memory
    peak, whichever is longer, from the shapes) over the device time of
    the kernels that compute it, by name: K1 and PyTorch's SDPA kernels."""
    prof = rec["profile"]
    calls = sum(1 for _, inside in rec["spans"].get("encoder", [])
                if inside)
    if not prof or not calls or "attention" not in rec:
        return None
    spent = sum(t for name, t in prof["by_name"].items()
                if any(k in name for k in ATTENTION_KERNELS))
    if spent <= 0:
        return None
    ops, nbytes = rec["attention"]
    pk = rec["peaks"]
    least = calls * max(ops / pk["bf16_flops_per_s"],
                        nbytes / pk["hbm_bytes_per_s"])
    return 100.0 * least / spent


def mfu_pct(rec, flops_key, units_key):
    """The reference's operations of every unit run in the window over the
    window's wall time at the bf16 peak, in %."""
    if not rec.get(flops_key) or not rec.get("wall_s"):
        return None
    return 100.0 * rec[units_key] * rec[flops_key] / (
        rec["wall_s"] * rec["peaks"]["bf16_flops_per_s"])


def idle_pct(rec):
    """1 - the union of the device operations' intervals over the profiled
    slice's wall time, in %."""
    prof = rec["profile"]
    if not prof or not prof["window_s"]:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])


def host_ms_per_frame(rec):
    """Host milliseconds of the stream's ``submit_group`` calls a frame."""
    if not rec.get("frames"):
        return None
    return 1e3 * rec["host_s"] / rec["frames"]
