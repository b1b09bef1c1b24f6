"""The device's idle share of the profiled slice, in %."""

from h100_bench import readers


def read(rec):
    return readers.idle_pct(rec)
