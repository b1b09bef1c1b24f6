"""Whole windows' operations over wall time at the bf16 peak, in %."""

from h100_bench import readers


def read(rec):
    return readers.mfu_pct(rec, "window_flops", "windows")
