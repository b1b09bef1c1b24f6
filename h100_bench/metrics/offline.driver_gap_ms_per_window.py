"""Window driver ms a window: wall - window device spans - stitching."""

from h100_bench import readers


def read(rec):
    return readers.driver_gap_ms(rec)
