"""Host ms of the submit_group calls over the frames submitted."""

from h100_bench import readers


def read(rec):
    return readers.host_ms_per_frame(rec)
