"""Host ms of the program's ``stream.group`` spans outside the uploads
below them over the frames submitted."""

from h100_bench import program_readers


def read(rec):
    return program_readers.enqueue_ms_per_frame(rec)
