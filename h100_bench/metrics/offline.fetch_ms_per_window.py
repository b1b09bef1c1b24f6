"""Host ms of the program's ``window.fetch`` spans (the depths' copy to
the host and their cast to fp32) over the windows."""

from h100_bench import program_readers


def read(rec):
    return program_readers.per_window_ms(rec, "window.fetch")
