"""Device ms in the stream's head stage and tail over the frames run."""

from h100_bench import readers


def read(rec):
    return readers.per_frame_ms(rec, "head")
