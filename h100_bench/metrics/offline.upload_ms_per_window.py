"""Host ms of the program's ``window.upload`` spans (the gather of a
window's frames and their copy to the card) over the windows."""

from h100_bench import program_readers


def read(rec):
    return program_readers.per_window_ms(rec, "window.upload")
