"""Device ms in dpt_head_temporal_stage over the frames computed."""

from h100_bench import readers


def read(rec):
    return readers.per_window_frame_ms(rec, "head_stage")
