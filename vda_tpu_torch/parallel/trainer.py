"""Training loop: steps, metrics, checkpoints and resume, on one device.

Counterpart of ``vda_tpu/parallel/trainer.py``: it wires the train step
(``parallel/train.py``) to the checkpoints (``utils/checkpoint.py``) and
the prefetching input pipeline (``utils/data.py``), so a fine-tune can be
run and resumed.
"""

from __future__ import annotations

import itertools
import json
import time
from typing import Callable, Iterable, Optional

from vda_tpu_torch.models.vda import VideoDepthAnything
from vda_tpu_torch.parallel.train import (
    init_train_state,
    make_optimizer,
    make_train_step,
)
from vda_tpu_torch.utils.checkpoint import resume_or_init, save_train_state


def train(
    model: VideoDepthAnything,
    data_iter: Iterable[dict],
    num_steps: int,
    ckpt_dir: Optional[str] = None,
    ckpt_every: int = 500,
    learning_rate: float = 1e-5,
    tp: int = 1,
    sp: bool = False,
    log_fn: Optional[Callable[[int, dict], None]] = None,
    warmup_steps: int = 0,
    schedule: bool = False,
    clip_norm: float = 0.0,
    augment_hw: Optional[tuple] = None,
    augment_seed: int = 0,
    prefetch: int = 2,
    accum: int = 1,
    metrics_path: Optional[str] = None,
):
    """Run ``num_steps`` train steps of VideoDepthLoss fine-tuning on the
    model's device, updating ``model`` in place; returns the TrainState.

    data_iter yields dicts of video (B, T, H, W, 3) raw RGB in [0, 1],
    depth (B, T, H, W) and mask (B, T, H, W), numpy or tensors.
    ``schedule=True``: linear warmup over ``warmup_steps`` then cosine to
    lr/10 over ``num_steps``, both converted to optimizer updates by
    ``// accum``; ``clip_norm`` > 0: global-norm clipping; ``accum`` > 1:
    one AdamW update per ``accum`` steps from their mean gradient.
    ``augment_hw``: the clip augmentation inside each step, its randomness
    from (``augment_seed``, step), so a resumed run replays it.
    ``prefetch`` > 0: the iterator runs in a thread that copies each batch
    to the device ahead (depth ``prefetch``); 0 keeps the loop synchronous.
    ``metrics_path``: one JSON line a step ({step, losses, grad_norm,
    wall_s}); each write reads the metrics on the host, a device sync a
    step.  ``ckpt_dir``: resume from its latest checkpoint (the batches the
    earlier run consumed are skipped) and save every ``ckpt_every`` steps
    and at the end.  ``tp`` > 1 and ``sp`` (tensor and sequence
    parallelism) are multi-GPU work, not ported."""
    if tp > 1 or sp:
        raise NotImplementedError("tensor / sequence parallel training is "
                                  "multi-GPU work, not ported (tp=1 only)")
    device = next(model.parameters()).device
    optimizer = make_optimizer(learning_rate,
                               warmup_steps=warmup_steps // accum,
                               total_steps=(max(num_steps // accum, 1)
                                            if schedule else 0),
                               clip_norm=clip_norm, accum_steps=accum)
    state = init_train_state(model, optimizer)
    start_step = 0
    if ckpt_dir:
        state, start_step = resume_or_init(ckpt_dir, state)
    step_fn = make_train_step(optimizer, augment_hw=augment_hw,
                              augment_seed=augment_seed)

    if start_step:
        # a resumed run sees the same data stream as an unbroken one
        data_iter = itertools.islice(data_iter, start_step, None)
    take = max(num_steps - start_step, 0)
    if prefetch > 0:
        from vda_tpu_torch.utils.data import sized_prefetch

        data_iter = sized_prefetch(data_iter, device, buffer_size=prefetch,
                                   limit=take)
    else:
        data_iter = itertools.islice(data_iter, take)
    t0 = time.time()
    for step, batch in enumerate(data_iter, start=start_step):
        if step >= num_steps:
            break
        state, metrics = step_fn(state, batch)
        if metrics_path:
            with open(metrics_path, "a") as f:
                f.write(json.dumps(
                    {"step": step,
                     **{k: float(v) for k, v in metrics.items()},
                     "wall_s": round(time.time() - t0, 3)}) + "\n")
        if log_fn is not None:
            log_fn(step, metrics)
        elif step % 10 == 0:
            m = {k: float(v) for k, v in metrics.items()}
            print(f"step {step}: total={m['total_loss']:.4f} "
                  f"spatial={m['spatial_loss']:.4f} "
                  f"stable={m['stable_loss']:.4f} "
                  f"({time.time() - t0:.1f}s)")
        if ckpt_dir and (step + 1) % ckpt_every == 0:
            save_train_state(ckpt_dir, state)
    if ckpt_dir:
        save_train_state(ckpt_dir, state)
    return state
