"""Host ms in the program's stitch_windows over the source frames run."""

from h100_bench import readers


def read(rec):
    return readers.per_frame_ms(rec, "stitch_windows")
