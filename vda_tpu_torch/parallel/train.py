"""Training step, PyTorch.

Counterpart of ``vda_tpu/parallel/train.py``: AdamW with
optax's semantics, an optional warmup-cosine schedule, global-norm clipping
and gradient accumulation, around ``video_depth_loss`` on the model's
``attn_impl="xla"`` forward (JAX's training kernel set: K2, no attention or
temporal kernel).

Unlike JAX's pure step, the port updates in place: ``train_step`` changes
the model's parameters, the optimizer state and ``state.step`` of the
``TrainState`` it is given, and returns that same state (no second copy of
the parameters and moments is held).

The optimizer is ``optax.adamw`` (b1 0.9, b2 0.999, eps 1e-8, decoupled
weight decay 1e-2 on every parameter, no mask) as ``torch.optim.AdamW``,
whose update is the same function; the learning rate is set before each
update from ``warmup_cosine``, a plain function of the number of updates
made, as ``optax.warmup_cosine_decay_schedule``.  Clipping is
``optax.clip_by_global_norm``: gradients are scaled by max_norm / norm only
where norm >= max_norm, with no epsilon in the divisor (``clip_grad_norm_``
adds 1e-6 and scales by min(1, max_norm / (norm + 1e-6)): a relative
difference under 1e-6 / max_norm).  Accumulation is ``optax.MultiSteps``:
k micro-steps update a running mean of their gradients (``acc + (g - acc) /
(n + 1)``) and leave the parameters untouched; the k-th clips that mean and
applies one AdamW update.

Under a mesh (``make_train_step(mesh=)``, the model sharded by
``parallel/mesh.shard_model``) each data rank takes its slice of the batch
and the loss is the whole batch's (``video_depth_loss(group=)``): a rank's
backward carries that loss's gradient to its own samples, so the
gradients are summed over the data group.  A replicated parameter gets
the same gradient on every model rank through the collectives' backward,
up to the card's nondeterministic sums (cuDNN's weight gradients), so its
gradient is averaged over the model group, which keeps its copies equal;
with sequence parallelism the ones of the token-sharded regions (the
encoder's norms, LayerScales and row-parallel biases, and its final norm)
hold the gradient of this rank's tokens and are summed instead.  The
global norm (the metric and the clipping) sums the sharded gradients'
squares over the model group and counts the replicated ones once, so it is
``optax.global_norm`` of the whole gradient; AdamW and the accumulation act
on each rank's pieces as they are.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from vda_tpu_torch.config import IMAGENET_MEAN, IMAGENET_STD
from vda_tpu_torch.loss import video_depth_loss
from vda_tpu_torch.models.vda import VideoDepthAnything, forward
from vda_tpu_torch.parallel import mesh as tpm


def warmup_cosine(count: int, peak: float, warmup_steps: int,
                  decay_steps: int, end_value: float) -> float:
    """``optax.warmup_cosine_decay_schedule(0, peak, warmup_steps,
    decay_steps, end_value)`` at update ``count``: linear from 0 to the
    peak over ``warmup_steps``, then cosine to ``end_value`` at
    ``decay_steps`` (which counts the warmup), constant after."""
    if count < warmup_steps:
        return -peak * (1.0 - count / warmup_steps) + peak
    span = decay_steps - warmup_steps
    t = min(count - warmup_steps, span)
    alpha = 0.0 if peak == 0.0 else end_value / peak
    cosine = 0.5 * (1.0 + math.cos(math.pi * t / span))
    return peak * ((1.0 - alpha) * cosine + alpha)


def global_norm(tensors, sharded=None, mesh=None) -> torch.Tensor:
    """sqrt of the sum of squares of every element (``optax.global_norm``),
    fp32, on the tensors' device.  ``sharded`` (one bool a tensor) and
    ``mesh``: the sharded tensors' squares are summed over the model group,
    the replicated ones counted once."""
    tensors = list(tensors)
    if sharded is None or mesh is None or mesh.model_group is None:
        return torch.sqrt(sum((t.float() * t.float()).sum()
                              for t in tensors))
    sq = [torch.zeros((), device=tensors[0].device) for _ in range(2)]
    for t, s in zip(tensors, sharded, strict=True):
        sq[int(s)] = sq[int(s)] + (t.float() * t.float()).sum()
    return torch.sqrt(sq[0] + tpm.all_reduce_(sq[1].reshape(1),
                                              mesh.model_group)[0])


def _sum_grads(grads, group, bucket: int = 1 << 24) -> None:
    """Sum tensors over a group in place, flattened into buckets of at
    most ``bucket`` elements of one dtype (one collective a bucket)."""
    if group is None:
        return
    pending, n = [], 0

    def flush():
        nonlocal pending, n
        if pending:
            flat = torch.cat([g.reshape(-1) for g in pending])
            tpm.all_reduce_(flat, group)
            off = 0
            for g in pending:
                g.copy_(flat[off:off + g.numel()].view_as(g))
                off += g.numel()
        pending, n = [], 0

    for g in grads:
        if pending and (n + g.numel() > bucket or g.dtype != pending[0].dtype):
            flush()
        pending.append(g)
        n += g.numel()
    flush()


@dataclasses.dataclass
class OptState:
    """AdamW's moments and step, the accumulator of ``MultiSteps`` (None
    without accumulation), the micro-step within the current group, and
    the number of updates made (the schedule's count)."""
    adam: torch.optim.AdamW
    acc: Optional[List[torch.Tensor]]
    mini_step: int = 0
    count: int = 0

    def state_dict(self) -> dict:
        return {"adam": self.adam.state_dict(), "acc": self.acc,
                "mini_step": self.mini_step, "count": self.count}

    def load_state_dict(self, sd: dict) -> None:
        self.adam.load_state_dict(sd["adam"])
        if (sd["acc"] is None) != (self.acc is None):
            raise ValueError("checkpoint and optimizer differ in accumulation")
        if self.acc is not None:
            for a, b in zip(self.acc, sd["acc"], strict=True):
                a.copy_(b)
        self.mini_step, self.count = int(sd["mini_step"]), int(sd["count"])


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """The optax chain of ``make_optimizer``: [MultiSteps(k)] of
    ([clip_by_global_norm] then adamw(schedule))."""
    learning_rate: float = 1e-5
    weight_decay: float = 1e-2
    warmup_steps: int = 0
    total_steps: int = 0
    clip_norm: float = 0.0
    accum_steps: int = 1

    def lr(self, count: int) -> float:
        """Learning rate of update ``count`` (0-based)."""
        if self.total_steps <= 0:
            return self.learning_rate
        warmup = max(self.warmup_steps, 1)
        return warmup_cosine(count, self.learning_rate, warmup,
                             max(self.total_steps, warmup + 1),
                             self.learning_rate / 10.0)

    def init(self, params: List[torch.Tensor]) -> OptState:
        adam = torch.optim.AdamW(params, lr=self.lr(0), betas=(0.9, 0.999),
                                 eps=1e-8, weight_decay=self.weight_decay)
        acc = None
        if self.accum_steps > 1:
            acc = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        return OptState(adam, acc)

    def update(self, st: OptState, params: List[torch.Tensor],
               norm: Callable = global_norm) -> bool:
        """One micro-step from the parameters' ``.grad``: accumulate, and
        at the end of a group (every call without accumulation) clip by
        ``norm`` of the gradients and apply AdamW in place.  Returns
        whether the parameters changed."""
        grads = [p.grad for p in params]
        if st.acc is not None:
            n = st.mini_step
            for a, g in zip(st.acc, grads):
                a.add_((g - a) / (n + 1))
            if n + 1 < self.accum_steps:
                st.mini_step = n + 1
                return False
            st.mini_step = 0
            grads = st.acc
        if self.clip_norm > 0.0:
            n = norm(grads)
            grads = [torch.where(n < self.clip_norm, g,
                                 g / n * self.clip_norm) for g in grads]
        for p, g in zip(params, grads):
            p.grad = g
        for group in st.adam.param_groups:
            group["lr"] = self.lr(st.count)
        st.adam.step()
        st.count += 1
        if st.acc is not None:
            for a in st.acc:
                a.zero_()
        return True


def make_optimizer(learning_rate: float = 1e-5, weight_decay: float = 1e-2,
                   warmup_steps: int = 0, total_steps: int = 0,
                   clip_norm: float = 0.0, accum_steps: int = 1) -> Optimizer:
    """AdamW, optionally with linear warmup -> cosine decay (total_steps >
    0: peak ``learning_rate``, floor lr/10, both counts in optimizer
    updates), global-norm clipping (clip_norm > 0) and accumulation of
    ``accum_steps`` micro-steps into one update (JAX ``make_optimizer``)."""
    return Optimizer(learning_rate, weight_decay, warmup_steps, total_steps,
                     clip_norm, accum_steps)


@dataclasses.dataclass
class TrainState:
    """The model (its parameters), the optimizer state and the number of
    train steps (micro-steps) taken."""
    model: VideoDepthAnything
    opt_state: OptState
    step: int = 0

    def params(self) -> List[torch.Tensor]:
        return [p for p in self.model.parameters() if p.requires_grad]

    def param_names(self) -> List[str]:
        return [n for n, p in self.model.named_parameters()
                if p.requires_grad]


def init_train_state(model: VideoDepthAnything,
                     optimizer: Optional[Optimizer] = None) -> TrainState:
    if optimizer is None:
        optimizer = make_optimizer()
    state = TrainState(model, None, 0)
    state.opt_state = optimizer.init(state.params())
    return state


def step_generators(augment_seed: int, step: int, device):
    """The randomness of train step ``step``: one ``np.random.SeedSequence``
    of (augment_seed, step) spawns two disjoint streams, a
    ``torch.Generator`` on ``device`` for the augmentation and one for
    drop-path, so a resumed run replays the same draws."""
    seeds = np.random.SeedSequence([augment_seed, step]).generate_state(
        2, np.uint64)
    return tuple(torch.Generator(device=device).manual_seed(int(s))
                 for s in seeds)


def make_train_step(optimizer: Optional[Optimizer] = None,
                    micro_batch_size: Optional[int] = None,
                    remat: bool = True, drop_path_rate: float = 0.0,
                    augment_hw: Optional[tuple] = None,
                    augment_seed: int = 0,
                    attn_impl: str = "xla", mesh=None) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics) (JAX
    ``make_train_step``, whose ``cfg`` the port's model carries; ``state``
    is updated in place and returned).

    batch: video (B, T, H, W, 3) raw RGB in [0, 1], depth (B, T, H, W),
    mask (B, T, H, W), moved to the model's device if elsewhere.  ImageNet
    normalisation runs inside the step, as inference preprocessing does.
    ``micro_batch_size`` defaults to B·T (the tail in one chunk), as in
    JAX.  ``remat`` recomputes each encoder block in the backward.
    ``drop_path_rate`` > 0: encoder stochastic depth.  ``augment_hw``:
    ``utils.augment.augment_batch`` to that size inside the step.
    ``attn_impl``: ``"xla"`` (JAX's training set, the default) or
    ``"plain"`` (no kernel, the reference the kernels are held to).
    metrics: spatial_loss, stable_loss, total_loss and grad_norm (of this
    micro-step's gradients, before accumulation and clipping), 0-dim device
    tensors.

    ``mesh`` (a ``parallel/mesh.Mesh``; the model is sharded over it here
    if it is not yet; without one, the mesh the model was sharded over,
    ``parallel/mesh.use_mesh``): ``batch`` is this data rank's slice of
    the global batch (in data-rank order), and the metrics are the global
    batch's on every rank."""
    if optimizer is None:
        optimizer = make_optimizer()
    given = mesh

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        model = state.model
        mesh = tpm.use_mesh(model, given)
        data = (0, 1) if mesh is None else (mesh.data_rank, mesh.dp)
        group = None if mesh is None else mesh.data_group
        device = next(model.parameters()).device
        batch = {k: torch.as_tensor(v).to(device, non_blocking=True)
                 for k, v in batch.items()}
        aug_gen, dp_gen = step_generators(augment_seed, state.step, device)
        if augment_hw is not None:
            from vda_tpu_torch.utils.augment import augment_batch

            batch = augment_batch(aug_gen, batch, out_hw=tuple(augment_hw),
                                  data_slice=data)
        mean = torch.tensor(IMAGENET_MEAN, device=device)
        std = torch.tensor(IMAGENET_STD, device=device)
        video = (batch["video"].to(torch.float32) - mean) / std
        b, t = video.shape[:2]
        pred = forward(model, video, attn_impl=attn_impl,
                       micro_batch_size=micro_batch_size or b * t,
                       remat=remat, drop_path_rate=drop_path_rate,
                       generator=dp_gen if drop_path_rate > 0.0 else None)
        losses = video_depth_loss(pred.to(torch.float32),
                                  batch["depth"].to(torch.float32),
                                  batch["mask"], group=group)
        params = state.params()
        for p in params:
            p.grad = None
        losses["total_loss"].backward()
        for p in params:  # unused parameters (mask_token): zero, as in JAX
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        metrics = {k: v.detach() for k, v in losses.items()}
        norm = global_norm
        if mesh is not None:
            names = state.param_names()
            specs = getattr(model, "tp_specs", {})
            if tpm.tp_on(mesh):
                sp = model.cfg.vit.seq_shard
                partial = [sp and tpm.sp_partial(n, specs) for n in names]
                _sum_grads([p.grad for p, pa in zip(params, partial) if pa],
                           mesh.model_group)
                # the rest of the replicated: their mean keeps the copies
                # equal (see the module docstring)
                rep = [p.grad for n, p, pa in zip(names, params, partial)
                       if n not in specs and not pa]
                if rep:
                    _sum_grads(rep, mesh.model_group)
                    torch._foreach_div_(rep, float(mesh.tp))
            _sum_grads([p.grad for p in params], group)
            sharded = [n in specs for n in names]

            def norm(grads):
                return global_norm(grads, sharded, mesh)
        metrics["grad_norm"] = norm(p.grad for p in params)
        optimizer.update(state.opt_state, params, norm)
        for p in params:
            p.grad = None
        state.step += 1
        return state, metrics

    return train_step
