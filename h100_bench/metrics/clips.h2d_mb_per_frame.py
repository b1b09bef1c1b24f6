"""The program's ``h2d_bytes`` counters, in MB a source frame."""

from h100_bench import program_readers


def read(rec):
    return program_readers.mb_per_frame(rec, "h2d_bytes")
