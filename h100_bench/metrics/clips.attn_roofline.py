"""The encoder attention's share of its roofline (K1 / SDPA kernels)."""

from h100_bench import readers


def read(rec):
    return readers.attention_roofline(rec)
