"""Device ms (the program's CUDA events) of its ``stream.context`` spans
(the context gathers) over the frames submitted."""

from h100_bench import program_readers


def read(rec):
    return program_readers.device_ms_per_frame(rec, "stream.context")
