"""Device ms in vda.encode (CUDA events) over the frames computed."""

from h100_bench import readers


def read(rec):
    return readers.per_window_frame_ms(rec, "encoder")
