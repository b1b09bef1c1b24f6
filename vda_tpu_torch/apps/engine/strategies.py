"""Hardware-tiered processing strategies and depth post-processing, for the
port's engine.

The counterpart of ``apps/engine/strategies.py`` (a rebuild of the
reference's hardened engine iteration, external_engine/engine_backup.py):
hardware detection (:187-410) reads the CUDA card in place of
``jax.devices()``, and the tiers (:484-586) are the card's: full 518 input
in bf16, or 384 with a small card or a 4K source; the memory-driven knob
is the network input size plus the decoder micro-batch size.  The CPU tier
is given only to a caller that asks for the CPU: with no card and no such
request ``select_strategy`` raises, so a job never moves to the CPU
unasked.  ``stabilize_depth_sequence`` and ``upscale_depth`` are copies,
held to their originals by ``tests/test_torch_apps_engine.py``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional

import numpy as np


def detect_hardware() -> Dict:
    """Detect the CUDA card and the host's capabilities."""
    import torch

    info: Dict = {"accelerator": "cpu", "accelerator_count": 0,
                  "accelerator_memory_gb": 0.0}
    if torch.cuda.is_available():
        info["accelerator"] = "cuda"
        info["accelerator_count"] = torch.cuda.device_count()
        info["accelerator_name"] = torch.cuda.get_device_name(0)
        info["accelerator_memory_gb"] = round(
            torch.cuda.get_device_properties(0).total_memory / 2 ** 30, 1)
    info["cpu_count"] = os.cpu_count()
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal"):
                    info["host_memory_gb"] = round(
                        int(line.split()[1]) / 2 ** 20, 1)
                    break
    except OSError:
        pass
    return info


@dataclasses.dataclass(frozen=True)
class ProcessingStrategy:
    name: str
    input_size: int          # network input (518 / 384 / 224)
    micro_batch_size: int    # decoder-tail chunk (frames)
    fp32: bool
    description: str


STRATEGIES = {
    # the card's analogs of the reference tiers gpu_direct /
    # gpu_conservative_4k, and cpu_direct (engine_backup.py:484-586)
    "cuda_direct": ProcessingStrategy(
        "cuda_direct", 518, 8, False,
        "CUDA card with ample memory: full 518 input, bf16, wide decoder "
        "chunks"),
    "cuda_conservative": ProcessingStrategy(
        "cuda_conservative", 384, 4, False,
        "CUDA card under 12 GB or 4K+ sources: reduced input size"),
    "cpu": ProcessingStrategy(
        "cpu", 224, 2, True,
        "the CPU, when the caller asks for it: smallest input, fp32"),
}


def select_strategy(hardware: Optional[Dict] = None, source_pixels: int = 0,
                    device: str = "cuda") -> ProcessingStrategy:
    """Pick a tier from the capabilities and the source size (reference
    engine_backup.py:484-586).  ``device="cpu"`` gives the CPU tier; with
    no CUDA card any other request raises."""
    if device == "cpu":
        return STRATEGIES["cpu"]
    hw = hardware or detect_hardware()
    if hw["accelerator"] == "cpu" or hw["accelerator_count"] == 0:
        raise RuntimeError("no CUDA card is visible; pass device='cpu' to "
                           "run the job on the CPU")
    mem = hw.get("accelerator_memory_gb", 16.0)
    is_4k = source_pixels > 3840 * 2160 * 0.9
    if mem < 12.0 or is_4k:
        return STRATEGIES["cuda_conservative"]
    return STRATEGIES["cuda_direct"]


# ---------------------------------------------------------------------------
# depth post-processing (reference engine_backup.py:1414-1488, 1556-1608)
# ---------------------------------------------------------------------------

def stabilize_depth_sequence(depths: np.ndarray, temporal_window: int = 3,
                             bilateral_d: int = 5,
                             bilateral_sigma: float = 25.0) -> np.ndarray:
    """Optional temporal median + per-frame bilateral smoothing."""
    import cv2

    n = depths.shape[0]
    half = temporal_window // 2
    out = np.empty_like(depths, dtype=np.float32)
    for i in range(n):
        lo, hi = max(0, i - half), min(n, i + half + 1)
        med = np.median(depths[lo:hi], axis=0).astype(np.float32)
        out[i] = cv2.bilateralFilter(med, bilateral_d, bilateral_sigma,
                                     bilateral_sigma)
    return out


def upscale_depth(depths: np.ndarray, target_hw) -> np.ndarray:
    """Bicubic upscale of a depth sequence to the original resolution."""
    import cv2

    th, tw = target_hw
    if depths.shape[1:3] == (th, tw):
        return depths
    return np.stack([
        cv2.resize(d, (tw, th), interpolation=cv2.INTER_CUBIC)
        for d in depths
    ])
