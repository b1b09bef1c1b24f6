"""Device ms of the program's ``encoder.ffn`` spans (each block's
feed-forward) over the frames computed."""

from h100_bench import ffn_readers


def read(rec):
    return ffn_readers.ms_per_frame(rec)
