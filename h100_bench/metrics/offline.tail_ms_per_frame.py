"""Device ms in dpt_head_temporal_tail over the frames computed."""

from h100_bench import readers


def read(rec):
    return readers.per_window_frame_ms(rec, "output_tail")
