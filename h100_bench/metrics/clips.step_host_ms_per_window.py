"""Host ms of the program's ``window.step`` spans (the forward's enqueue)
over the windows."""

from h100_bench import program_readers


def read(rec):
    return program_readers.per_window_ms(rec, "window.step")
