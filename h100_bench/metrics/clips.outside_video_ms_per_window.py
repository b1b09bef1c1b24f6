"""The window's wall time that no ``video`` span of the program covers
(the caller's time between videos) over the windows."""

from h100_bench import program_readers


def read(rec):
    return program_readers.outside_video_ms_per_window(rec)
