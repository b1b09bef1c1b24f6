"""Training loop: steps, metrics, checkpoints and resume.

Counterpart of ``vda_tpu/parallel/trainer.py``: it wires the train step
(``parallel/train.py``) to the checkpoints (``utils/checkpoint.py``) and
the prefetching input pipeline (``utils/data.py``), so a fine-tune can be
run and resumed, on one device or on every rank of a torch.distributed
world (``tp`` / ``sp``: ``parallel/mesh.py``).
"""

from __future__ import annotations

import itertools
import json
import time
from typing import Callable, Iterable, Optional

from vda_tpu_torch.models.vda import VideoDepthAnything
from vda_tpu_torch.parallel import mesh as tpm
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
    and at the end.

    In a torch.distributed world (every rank calls this with the same
    data) the ranks form ``make_mesh(tp=tp)``: the model is sharded over
    the model axis, every rank pulls the same global batch and keeps its
    data slice (B must divide by world / tp), the loss and metrics are the
    global batch's, checkpoints are saved whole (rank 0 writes) and
    restored in pieces, and rank 0 alone writes ``metrics_path``.
    ``sp=True`` (needs tp > 1) adds sequence parallelism: the encoder's
    norm regions are token-sharded (its token count must divide by tp);
    it sets ``seq_shard`` on the model's config."""
    if sp and tp <= 1:
        raise ValueError("sp=True requires tp > 1")
    device = next(model.parameters()).device
    mesh = tpm.make_mesh(tp=tp, device=device)
    if mesh.world == 1:
        mesh = None
    else:
        if sp:
            import dataclasses

            vit = dataclasses.replace(model.cfg.vit, seq_shard=True)
            model.cfg = model.cfg.replace(vit=vit)
            model.pretrained.cfg = vit
        tpm.shard_model(model, mesh)
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
                              augment_seed=augment_seed, mesh=mesh)

    if start_step:
        # a resumed run sees the same data stream as an unbroken one
        data_iter = itertools.islice(data_iter, start_step, None)
    take = max(num_steps - start_step, 0)
    data_slice = None if mesh is None else (mesh.data_rank, mesh.dp)
    if prefetch > 0:
        from vda_tpu_torch.utils.data import sized_prefetch

        data_iter = sized_prefetch(data_iter, device, buffer_size=prefetch,
                                   limit=take, data_slice=data_slice)
    else:
        from vda_tpu_torch.utils.data import take_slice

        data_iter = itertools.islice(data_iter, take)
        if data_slice is not None:
            data_iter = (take_slice(b, *data_slice) for b in data_iter)
    writer = mesh is None or mesh.rank == 0
    t0 = time.time()
    for step, batch in enumerate(data_iter, start=start_step):
        if step >= num_steps:
            break
        state, metrics = step_fn(state, batch)
        if metrics_path and writer:
            with open(metrics_path, "a") as f:
                f.write(json.dumps(
                    {"step": step,
                     **{k: float(v) for k, v in metrics.items()},
                     "wall_s": round(time.time() - t0, 3)}) + "\n")
        if log_fn is not None:
            log_fn(step, metrics)
        elif step % 10 == 0 and writer:
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
