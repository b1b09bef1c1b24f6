"""The encoder feed-forward's share of its roofline: its least time from
the configuration and the network size over the device ms of the
program's ``encoder.ffn`` spans."""

from h100_bench import ffn_readers


def read(rec):
    return ffn_readers.roofline(rec)
