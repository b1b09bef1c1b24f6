"""The arithmetic of the encoder feed-forward's metrics, over the program's
``encoder.ffn`` spans (``vda_tpu_torch/utils/trace.py``: one device span a
block's feed-forward) in the run's record (``program_readers.py``): their
device ms over the frames the network computed, and the feed-forward's
least time (``reference/ffn_work.py``) over those ms.

Each returns None where the record has no ``encoder.ffn`` span with device
time: an untraced run, a program without the span, a run off the card.
"""

from __future__ import annotations

from h100_bench import program_readers
from h100_bench.reference import protocol as P
from h100_bench.reference.ffn_work import ffn_work


def _device_ms(rec):
    """Summed device ms of the ``encoder.ffn`` spans, or None."""
    ms = [s["device_ms"] for s in program_readers._spans(rec) or ()
          if s["name"] == "encoder.ffn"]
    if not ms or None in ms or not rec.get("windows"):
        return None
    return sum(ms)


def ms_per_frame(rec):
    """Device ms of the feed-forwards over the frames computed: 32 a
    window, padding and overlap included."""
    ms = _device_ms(rec)
    if ms is None:
        return None
    return ms / (rec["windows"] * rec["window_frames"])


def roofline(rec):
    """The feed-forwards' least time over every window (the larger of
    operations at the bf16 peak and bytes at the memory peak) over their
    device time, in %."""
    ms = _device_ms(rec)
    if not ms:
        return None
    cfg, tr, pk = rec["cfg"], rec["traffic"], rec["peaks"]
    net_hw = P.net_size(*tr["frame_hw"], tr["input_size"],
                        cfg["encoder"]["patch_size"])
    ops, nbytes = ffn_work(cfg, net_hw, rec["window_frames"])
    least = rec["windows"] * max(ops / pk["bf16_flops_per_s"],
                                 nbytes / pk["hbm_bytes_per_s"])
    return 100.0 * least / (ms / 1e3)
