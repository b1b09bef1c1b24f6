"""The process grid, partition rules and collectives of the multi-GPU paths.

Counterpart of ``vda_tpu/parallel/mesh.py`` on ``torch.distributed``.  The
ranks form a ('data', 'model') grid of shape (world / tp, tp), rank r at
(r // tp, r % tp), as JAX reshapes its device list.  Windows and training
batches are split over 'data'; within 'model' the encoder and the temporal
attention follow Megatron's head-aligned scheme:

  * the encoder's qkv is column-parallel by whole heads and its ``proj``
    row-parallel; ``fc1`` (vitg: ``w12``, by halves) column-parallel and
    ``fc2`` (``w3``) row-parallel;
  * the temporal ``to_q`` / ``to_k`` / ``to_v`` are column-parallel and
    ``to_out`` row-parallel;
  * everything else (convs, norms, positional embeddings, the temporal
    feed-forward, the DPT head) is replicated.

Each row-parallel projection ends in exactly one collective: an all-reduce
(``reduce_from_model``), or with sequence parallelism (``cfg.vit.seq_shard``)
a reduce-scatter of the tokens (``scatter_tokens``), whose partner is the
all-gather entering attention and the MLP (``gather_tokens``).  The weights
keep the reference layout: ``shard_model`` slices each rank's rows of
``[q | k | v]`` by heads, so the local fused product keeps the order K1
reads in place, and JAX's ``to_tp_layout`` has no counterpart here.

The process group comes from the caller or from torchrun's environment
(``make_mesh``).  NCCL serves ranks that each have a card; ranks sharing a
card (NCCL refuses two ranks on one device) and CPU ranks use gloo, whose
collectives take the tensors where they are; both backends run the same
calls.  Every collective is counted by kind with the bytes of its whole
buffer: the summed tensor of an all-reduce, the gathered one of an
all-gather, the one scattered by a reduce-scatter (``collective_counts``).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
KINDS = ("all_reduce", "all_gather", "reduce_scatter", "all_reduce_max")

_counts = {k: 0 for k in KINDS}
_bytes = {k: 0 for k in KINDS}


def collective_counts() -> dict:
    """{kind: calls} of every collective since the last reset, with
    ``"bytes"``: {kind: bytes of the buffers they reduced or gathered}."""
    return {**_counts, "bytes": dict(_bytes)}


def reset_collective_counts() -> None:
    for k in KINDS:
        _counts[k] = 0
        _bytes[k] = 0


def _count(kind: str, t: torch.Tensor) -> None:
    _counts[kind] += 1
    _bytes[kind] += t.numel() * t.element_size()


@dataclasses.dataclass(eq=False)
class Mesh:
    """One rank's view of the ('data', 'model') grid: its coordinates, the
    groups of its row and column (None where that axis has one rank), its
    device and the process group's backend."""
    world: int
    tp: int
    rank: int
    device: torch.device
    backend: Optional[str]
    data_group: Optional[object] = None
    model_group: Optional[object] = None

    @property
    def dp(self) -> int:
        return self.world // self.tp

    @property
    def data_rank(self) -> int:
        return self.rank // self.tp

    @property
    def model_rank(self) -> int:
        return self.rank % self.tp

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.dp, MODEL_AXIS: self.tp}


def backend_for(device_type: str, ranks_on_host: int) -> str:
    """NCCL where each rank of the host has a card of its own, gloo where
    ranks share a card (NCCL refuses two ranks on one device) or run on
    the CPU."""
    if device_type == "cpu":
        return "gloo"
    return "nccl" if torch.cuda.device_count() >= ranks_on_host else "gloo"


def rank_device(device=None) -> torch.device:
    """The rank's device: ``cuda:{LOCAL_RANK % device_count()}`` unless the
    caller names one (``"cpu"`` for the CPU)."""
    if device is not None:
        return torch.device(device)
    local = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device(f"cuda:{local % max(torch.cuda.device_count(), 1)}")


def _init_from_env(device: torch.device) -> None:
    """Initialise the default process group from torchrun's environment
    (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT, LOCAL_WORLD_SIZE)."""
    ranks_on_host = int(os.environ.get("LOCAL_WORLD_SIZE",
                                       os.environ["WORLD_SIZE"]))
    dist.init_process_group(backend_for(device.type, ranks_on_host),
                            init_method="env://")


def world_size() -> int:
    """The ranks of the default process group, or of torchrun's
    environment before one exists (1 without either)."""
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def make_mesh(n_devices: Optional[int] = None, tp: int = 1,
              device=None) -> Optional[Mesh]:
    """The ('data', 'model') grid of the default process group's first
    ``n_devices`` ranks (default: all), with its data and model subgroups;
    tp = the model-parallel degree, which must divide n_devices (JAX's
    rule).  Without a process group one is initialised from torchrun's
    environment, and without either the mesh is this process alone.
    Every rank of the world must call it (the subgroups are made
    collectively); a rank outside the first n_devices gets None."""
    device = rank_device(device)
    if not dist.is_initialized() and world_size() > 1:
        _init_from_env(device)
    if dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
        backend = dist.get_backend()
    else:
        world, rank, backend = 1, 0, None
    n = world if n_devices is None else n_devices
    if not 1 <= n <= world:
        raise ValueError(f"a mesh of {n} devices in a world of {world} "
                         "ranks")
    if tp < 1 or n % tp != 0:
        raise ValueError(f"{n} devices not divisible by tp={tp}")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    mesh = Mesh(n, tp, rank, device, backend) if rank < n else None
    dp = n // tp

    def group(ranks):
        return dist.group.WORLD if len(ranks) == world \
            else dist.new_group(ranks)

    # every rank of the world makes every group, in the same order
    if tp > 1:
        for d in range(dp):
            g = group([d * tp + m for m in range(tp)])
            if mesh is not None and d == mesh.data_rank:
                mesh.model_group = g
    if dp > 1:
        for m in range(tp):
            g = group([d * tp + m for d in range(dp)])
            if mesh is not None and m == mesh.model_rank:
                mesh.data_group = g
    return mesh


# ---------------------------------------------------------------------------
# collectives (counted); a group of None is one rank and moves nothing
# ---------------------------------------------------------------------------

def _size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def all_reduce_(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """Sum (or max) of x over the group, in place; returns x."""
    if group is None:
        return x
    _count("all_reduce_max" if op == "max" else "all_reduce", x)
    dist.all_reduce(x, dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM,
                    group=group)
    return x


def all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The group's x concatenated along ``dim`` in rank order."""
    n = _size(group)
    if n == 1:
        return x
    x = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * x.shape[0], *x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    _count("all_gather", out)
    dist.all_gather_into_tensor(out, x, group=group)
    return out.movedim(0, dim)


def reduce_scatter(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's slice along ``dim`` of the group's sum of x."""
    n = _size(group)
    if n == 1:
        return x
    x = x.movedim(dim, 0).contiguous()
    if x.shape[0] % n:
        raise ValueError(f"{x.shape[0]} rows do not split over {n} ranks")
    out = torch.empty((x.shape[0] // n, *x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    _count("reduce_scatter", x)
    dist.reduce_scatter_tensor(out, x, group=group)
    return out.movedim(0, dim).contiguous()


def _slice(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = _size(group)
    if n == 1:
        return x
    r = dist.get_rank(group)
    k = x.shape[dim] // n
    return x.narrow(dim, r * k, k).contiguous()


class _CopyToModel(torch.autograd.Function):
    """Entering a column-parallel product: identity; the backward sums the
    ranks' partial input gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    """Leaving a row-parallel product: the sum of the ranks' partial sums;
    the backward passes the gradient on."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    """All-gather along ``dim``.  ``partial``: the ranks' gradients of the
    gathered tensor are partial (it feeds a column-parallel product), so
    the backward is a reduce-scatter; else they are equal (replicated
    compute follows) and the backward takes this rank's slice."""

    @staticmethod
    def forward(ctx, x, group, dim, partial):
        ctx.group, ctx.dim, ctx.partial = group, dim, partial
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.partial:
            return reduce_scatter(g, ctx.group, ctx.dim), None, None, None
        return _slice(g, ctx.group, ctx.dim), None, None, None


class _Scatter(torch.autograd.Function):
    """Reduce-scatter along ``dim`` (leaving a row-parallel product under
    sequence parallelism); the backward all-gathers."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return reduce_scatter(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.group, ctx.dim), None, None


class _Split(torch.autograd.Function):
    """This rank's slice along ``dim`` of a replicated tensor (entering a
    token-sharded region); the backward all-gathers."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _slice(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.group, ctx.dim), None, None


def _tracked(x) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def copy_to_model(x, mesh: Mesh):
    if mesh.model_group is None or not _tracked(x):
        return x
    return _CopyToModel.apply(x, mesh.model_group)


def reduce_from_model(x, mesh: Mesh):
    if mesh.model_group is None:
        return x
    if not _tracked(x):  # x is a fresh product: reduce it in place
        return all_reduce_(x.contiguous(), mesh.model_group)
    return _ReduceFromModel.apply(x, mesh.model_group)


def gather_tokens(x, mesh: Mesh):
    """(B, N/tp, D) -> (B, N, D) entering attention or the MLP."""
    return _Gather.apply(x, mesh.model_group, 1, True)


def scatter_tokens(x, mesh: Mesh):
    """(B, N, D) partial sums -> this rank's (B, N/tp, D) of their sum."""
    return _Scatter.apply(x, mesh.model_group, 1)


def split_tokens(x, mesh: Mesh):
    """(B, N, D) replicated -> this rank's (B, N/tp, D)."""
    return _Split.apply(x, mesh.model_group, 1)


def gather_replicated(x, group, dim: int):
    """All-gather along ``dim`` into replicated compute: every rank's
    gradient of the result is the same, and it keeps its own slice."""
    return _Gather.apply(x, group, dim, False)


def row_parallel(p, x, mesh: Mesh, seq_shard: bool = False):
    """A row-parallel linear: this rank's partial product, one collective
    (all-reduce, or with sequence parallelism a reduce-scatter of the
    tokens), then the bias once."""
    y = torch.nn.functional.linear(x, p.weight.to(x.dtype))
    y = scatter_tokens(y, mesh) if seq_shard else reduce_from_model(y, mesh)
    if p.bias is None:
        return y
    from vda_tpu_torch.ops.layers import cast_once

    return y + cast_once(p.bias, y.dtype)


def tp_on(mesh: Optional[Mesh]) -> bool:
    return mesh is not None and mesh.tp > 1


def sharded(module) -> bool:
    """Whether ``shard_model`` split this module's projections."""
    return getattr(module, "tp_sharded", False)


# ---------------------------------------------------------------------------
# partition rules (JAX's _spec_for_path, on the reference state-dict names)
# ---------------------------------------------------------------------------

# name suffix -> (the dim split over 'model', the groups that dim holds,
# each split alike): column-parallel weights split their output rows,
# row-parallel ones their input columns; the fused qkv splits each of q, k
# and v by heads, vitg's w12 each of its halves
RULES = {
    "attn.qkv.weight": (0, 3), "attn.qkv.bias": (0, 3),
    "attn.proj.weight": (1, 1),
    "mlp.fc1.weight": (0, 1), "mlp.fc1.bias": (0, 1),
    "mlp.w12.weight": (0, 2), "mlp.w12.bias": (0, 2),
    "mlp.fc2.weight": (1, 1), "mlp.w3.weight": (1, 1),
    "to_q.weight": (0, 1), "to_k.weight": (0, 1), "to_v.weight": (0, 1),
    "to_out.0.weight": (1, 1),
}
Spec = Tuple[int, int]


def rule_for(name: str) -> Optional[Spec]:
    for suffix, spec in RULES.items():
        if name.endswith(suffix):
            return spec
    return None


def _heads_of(name: str, cfg) -> int:
    if name.startswith("pretrained."):
        return cfg.vit.num_heads
    return cfg.num_attention_heads


def partition_specs(model, tp: int) -> Dict[str, Spec]:
    """{parameter name: spec} of the parameters split over tp model ranks.
    A parameter whose split dim (a group of it) tp does not divide stays
    replicated, as JAX's guard keeps it; so does an attention whose heads
    tp does not divide, since a rank computes only whole heads.  Both
    members of a column/row pair fall under the same guard."""
    specs = {}
    if tp <= 1:
        return specs
    cfg = model.cfg
    for name, p in model.named_parameters():
        spec = rule_for(name)
        if spec is None:
            continue
        dim, groups = spec
        if (p.shape[dim] // groups) % tp:
            continue
        if (".attn." in name or ".attention_blocks." in name) \
                and _heads_of(name, cfg) % tp:
            continue
        specs[name] = spec
    return specs


def sp_partial(name: str, specs: Dict[str, Spec]) -> bool:
    """Whether a parameter acts on the token-sharded regions of sequence
    parallelism while replicated (the encoder blocks' norms, LayerScales
    and row-parallel biases, and its final norm): each rank's gradient of
    it is then its tokens' share."""
    return (name.startswith("pretrained.blocks.") and name not in specs) \
        or name.startswith("pretrained.norm.")


def shard_tensor(full: torch.Tensor, spec: Spec, index: int,
                 n: int) -> torch.Tensor:
    """Rank ``index``'s of n pieces of ``full`` under ``spec``."""
    dim, groups = spec
    t = full.movedim(dim, 0)
    t = t.reshape(groups, t.shape[0] // groups, *t.shape[1:])
    k = t.shape[1] // n
    t = t[:, index * k:(index + 1) * k]
    return t.reshape(groups * k, *t.shape[2:]).movedim(0, dim).contiguous()


def unshard_tensor(pieces, spec: Spec) -> torch.Tensor:
    """The inverse of ``shard_tensor`` over the n pieces in rank order."""
    dim, groups = spec
    parts = []
    for p in pieces:
        t = p.movedim(dim, 0)
        parts.append(t.reshape(groups, t.shape[0] // groups, *t.shape[1:]))
    t = torch.cat(parts, dim=1)
    return t.reshape(-1, *t.shape[2:]).movedim(0, dim).contiguous()


def shard_model(model, mesh: Mesh):
    """Slice each rank's weights in place (``partition_specs``), mark the
    modules whose projections were split (``sharded``) and keep the mesh
    and specs on the model (``model.mesh``, ``model.tp_specs``).  Returns
    the model.  A model already sharded over this mesh is returned as it
    is, one sharded over another raises; ``mesh.tp`` 1 shards nothing (and
    still ties the model to the mesh)."""
    if model_mesh(model) is mesh:
        return model
    if model_mesh(model) is not None:
        raise ValueError("the model is sharded over another mesh")
    specs = partition_specs(model, mesh.tp)
    modules = dict(model.named_modules())
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name in specs:
                p.data = shard_tensor(p.data, specs[name], mesh.model_rank,
                                      mesh.tp)
                owner = name.rsplit(".", 2)[0]
                if owner.endswith(".to_out"):
                    owner = owner[:-len(".to_out")]
                modules[owner].tp_sharded = True
    model.mesh = mesh
    model.tp_specs = specs
    return model


def model_mesh(model) -> Optional[Mesh]:
    """The mesh a model was sharded over, or None."""
    return getattr(model, "mesh", None)


def use_mesh(model, mesh: Optional[Mesh]) -> Optional[Mesh]:
    """The one mesh a model runs under: ``mesh``, the model sharded over it
    here if it is not yet, or without one the mesh the model was sharded
    over (None if it was not).  A mesh other than the model's raises."""
    if mesh is None:
        return model_mesh(model)
    shard_model(model, mesh)
    return mesh


def gather_full(t: torch.Tensor, spec: Optional[Spec], mesh: Mesh):
    """The whole tensor of a sharded parameter (or of its optimizer moment)
    from the model group's pieces; a replicated one as it is."""
    if spec is None or mesh.model_group is None:
        return t
    pieces = all_gather(t.contiguous().unsqueeze(0), mesh.model_group, 0)
    return unshard_tensor(list(pieces), spec)


def full_state_dict(model) -> dict:
    """The model's state dict with every sharded tensor whole (collective
    over the model group)."""
    mesh, specs = model_mesh(model), getattr(model, "tp_specs", {})
    sd = model.state_dict()
    if mesh is None:
        return sd
    return {k: gather_full(v, specs.get(k), mesh) for k, v in sd.items()}


def local_state_dict(model, full: dict) -> dict:
    """A whole state dict cut to this rank's pieces."""
    mesh, specs = model_mesh(model), getattr(model, "tp_specs", {})
    if mesh is None:
        return full
    return {k: (shard_tensor(v, specs[k], mesh.model_rank, mesh.tp)
                if k in specs else v) for k, v in full.items()}
