"""Training checkpoint and resume, PyTorch.

Counterpart of ``vda_tpu/utils/checkpoint.py`` with ``torch.save`` in place
of orbax: a ``TrainState`` (the model's state dict, the optimizer state with
AdamW's moments, the accumulator and the schedule's count, and the step) is
saved as ``<ckpt_dir>/step_<N>.pt``.  The model part keeps the reference
state-dict keys and layouts, so it loads into an inference model as it is
(``VideoDepthAnything.load_state_dict(ckpt["model"])``).  Files are written
under a temporary name and renamed, so a crash never leaves a truncated
latest checkpoint.

A model sharded over a mesh (``parallel/mesh.shard_model``) saves whole:
every rank takes part in gathering the sharded parameters, their AdamW
moments and accumulators over its model group, rank 0 writes the file, and
all ranks wait for it at a barrier.  Restoring reads the whole checkpoint
and cuts each rank's pieces, so a checkpoint loads at any tp, and into an
unsharded model.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from vda_tpu_torch.parallel import mesh as tpm


def _map_opt_state(state, fn) -> dict:
    """The optimizer state dict with ``fn(tensor, spec)`` applied to each
    per-parameter tensor (AdamW's moments, the accumulator); spec is the
    parameter's ``tp_specs`` entry or None."""
    specs = getattr(state.model, "tp_specs", {})
    names = state.param_names()
    sd = state.opt_state.state_dict()
    adam = dict(sd["adam"])
    adam["state"] = {i: {k: (fn(v, specs.get(names[i])) if v.dim() else v)
                         for k, v in st.items()}
                     for i, st in sd["adam"]["state"].items()}
    acc = sd["acc"]
    if acc is not None:
        acc = [fn(a, specs.get(n)) for a, n in zip(acc, names, strict=True)]
    return {**sd, "adam": adam, "acc": acc}


def save_train_state(ckpt_dir: str, state, step: Optional[int] = None) -> str:
    """Save a TrainState as ckpt_dir/step_<N>.pt; returns the path.  Under
    a mesh every rank calls it (see the module docstring)."""
    if step is None:
        step = state.step
    path = os.path.join(os.path.abspath(ckpt_dir), f"step_{step:08d}.pt")
    mesh = tpm.model_mesh(state.model)
    if mesh is None or mesh.world == 1:
        model, opt = state.model.state_dict(), state.opt_state.state_dict()
    else:
        model = tpm.full_state_dict(state.model)
        opt = _map_opt_state(state,
                             lambda t, spec: tpm.gather_full(t, spec, mesh))
    if mesh is None or mesh.rank == 0:
        os.makedirs(ckpt_dir, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save({"model": model, "opt_state": opt, "step": state.step},
                   tmp)
        os.replace(tmp, path)
    if mesh is not None and mesh.world > 1:
        dist.barrier()
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
    devices; a sharded model takes its pieces) and return it."""
    model = like_state.model
    device = next(model.parameters()).device
    ckpt = torch.load(path, map_location=device, weights_only=True)
    model.load_state_dict(tpm.local_state_dict(model, ckpt["model"]),
                          strict=True)
    mesh = tpm.model_mesh(model)
    opt = ckpt["opt_state"]
    if mesh is not None and getattr(model, "tp_specs", None):
        names = like_state.param_names()

        def cut(t, name):
            spec = model.tp_specs.get(name)
            return t if spec is None else tpm.shard_tensor(
                t, spec, mesh.model_rank, mesh.tp)

        adam = {**opt["adam"], "state": {
            i: {k: (cut(v, names[i]) if v.dim() else v)
                for k, v in st.items()}
            for i, st in opt["adam"]["state"].items()}}
        acc = opt["acc"]
        if acc is not None:
            acc = [cut(a, n) for a, n in zip(acc, names, strict=True)]
        opt = {**opt, "adam": adam, "acc": acc}
    like_state.opt_state.load_state_dict(opt)
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
