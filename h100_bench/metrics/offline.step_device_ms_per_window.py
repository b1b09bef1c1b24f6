"""Device ms (the program's CUDA events) of its ``window.step`` spans over
the windows."""

from h100_bench import program_readers


def read(rec):
    return program_readers.device_ms_per_window(rec, "window.step")
