"""Device ms in the stream's forward_features over the frames run."""

from h100_bench import readers


def read(rec):
    return readers.per_frame_ms(rec, "encoder")
