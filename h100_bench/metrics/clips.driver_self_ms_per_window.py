"""Host ms of the program's ``video`` spans that none of their children
cover (the driver's own work) over the windows."""

from h100_bench import program_readers


def read(rec):
    return program_readers.driver_self_ms_per_window(rec)
