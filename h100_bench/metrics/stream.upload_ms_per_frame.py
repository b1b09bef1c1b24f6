"""Host ms of the program's ``stream.upload`` spans over the frames
submitted."""

from h100_bench import program_readers


def read(rec):
    return program_readers.per_frame_ms(rec, "stream.upload")
