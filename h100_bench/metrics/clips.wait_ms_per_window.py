"""Host ms of the program's ``window.wait`` spans (the host blocked until
the card has run the window's step) over the windows."""

from h100_bench import program_readers


def read(rec):
    return program_readers.per_window_ms(rec, "window.wait")
