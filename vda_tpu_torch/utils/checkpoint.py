"""Training checkpoint and resume, PyTorch.

Counterpart of ``vda_tpu/utils/checkpoint.py`` with ``torch.save`` in place
of orbax: a ``TrainState`` (the model's state dict, the optimizer state with
AdamW's moments, the accumulator and the schedule's count, and the step) is
saved as ``<ckpt_dir>/step_<N>.pt``.  The model part keeps the reference
state-dict keys and layouts, so it loads into an inference model as it is
(``VideoDepthAnything.load_state_dict(ckpt["model"])``).  Files are written
under a temporary name and renamed, so a crash never leaves a truncated
latest checkpoint.
"""

from __future__ import annotations

import os
from typing import Optional

import torch


def save_train_state(ckpt_dir: str, state, step: Optional[int] = None) -> str:
    """Save a TrainState as ckpt_dir/step_<N>.pt; returns the path."""
    if step is None:
        step = state.step
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(os.path.abspath(ckpt_dir), f"step_{step:08d}.pt")
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save({"model": state.model.state_dict(),
                "opt_state": state.opt_state.state_dict(),
                "step": state.step}, tmp)
    os.replace(tmp, path)
    return path


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [d for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and d.endswith(".pt")]
    if not steps:
        return None
    return os.path.join(os.path.abspath(ckpt_dir), sorted(steps)[-1])


def restore_train_state(path: str, like_state):
    """Load a checkpoint written by ``save_train_state`` into
    ``like_state`` (its model and optimizer state, in place, on their
    devices) and return it."""
    device = next(like_state.model.parameters()).device
    ckpt = torch.load(path, map_location=device, weights_only=True)
    like_state.model.load_state_dict(ckpt["model"], strict=True)
    like_state.opt_state.load_state_dict(ckpt["opt_state"])
    like_state.step = int(ckpt["step"])
    return like_state


def resume_or_init(ckpt_dir: str, init_state):
    """(state, start step): the latest checkpoint in ckpt_dir loaded into
    ``init_state``, or ``init_state`` and 0 where there is none."""
    path = latest_checkpoint(ckpt_dir)
    if path is None:
        return init_state, 0
    state = restore_train_state(path, init_state)
    return state, state.step
