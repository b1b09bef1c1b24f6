"""Rank bodies of the port's multi-process CPU tests, and their launcher.

``spawn(body, world, tmp_path, **kw)`` starts ``world`` processes by the
spawn start method, joined by a gloo process group over a ``file://``
store under ``tmp_path``, each on one torch thread, and runs
``body(rank, world, tmp_path, **kw)`` (a function of this module, named by
its name) in each; it returns each rank's result (a ``torch.save``-able
object), in rank order.  A rank that raises fails the call with its
traceback; ranks still running after ``timeout`` seconds are killed and the
call fails, so nothing hangs.  ``start`` returns at once, so that the
caller computes its references while the ranks run.  This module imports
torch and the port only: a spawned rank never imports JAX.
"""

from __future__ import annotations

import contextlib
import os
import socket
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _entry(rank, world, tmp, body, kw, env):
    torch.set_num_threads(1)
    os.environ.update({k: v.replace("{rank}", str(rank))
                       for k, v in (env or {}).items()})
    if env is None:
        dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                                rank=rank, world_size=world)
    try:
        out = globals()[body](rank, world, tmp, **kw)
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def free_port() -> int:
    with contextlib.closing(socket.socket()) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def torchrun_env(world: int) -> dict:
    """The environment torchrun gives rank ``{rank}`` of a one-host world
    (the rank is filled in by the launcher)."""
    return {"WORLD_SIZE": str(world), "LOCAL_WORLD_SIZE": str(world),
            "RANK": "{rank}", "LOCAL_RANK": "{rank}",
            "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port())}


class Ranks:
    """Ranks started by ``start``; ``results()`` waits for them."""

    def __init__(self, ctx, body: str, world: int, tmp: str, timeout: float):
        self.ctx, self.body, self.world, self.tmp = ctx, body, world, tmp
        self.deadline = time.monotonic() + timeout
        self.timeout = timeout

    def results(self):
        """Each rank's result, in rank order; a rank's exception is raised
        here, and ranks past the timeout are killed."""
        while not self.ctx.join(
                timeout=max(self.deadline - time.monotonic(), 0.1)):
            if time.monotonic() > self.deadline:
                for p in self.ctx.processes:
                    if p.is_alive():
                        p.kill()
                raise TimeoutError(f"{self.body}: ranks still running after "
                                   f"{self.timeout} s")
        return [torch.load(os.path.join(self.tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(self.world)]


def start(body: str, world: int, tmp_path, timeout: float = 240.0,
          torchrun: bool = False, **kw) -> Ranks:
    """Start ``body`` on ``world`` gloo ranks (``torchrun``: no process
    group made here; the ranks get torchrun's environment and the code
    under test makes it) and return at once, so that the caller computes
    the references while the ranks run."""
    tmp = str(tmp_path)
    os.makedirs(tmp, exist_ok=True)
    env = torchrun_env(world) if torchrun else None
    ctx = mp.start_processes(_entry, args=(world, tmp, body, kw, env),
                             nprocs=world, join=False, start_method="spawn")
    return Ranks(ctx, body, world, tmp, timeout)


def started_with_module(body: str, world: int, tmp_path, **kw):
    """A module fixture's body: ``start`` the ranks, yield them, and reap
    them at the module's end (their errors are the test's to report)."""
    started = start(body, world, tmp_path, **kw)
    yield started
    try:
        started.results()
    except Exception:  # noqa: BLE001 — reported by the test that waited
        pass


def spawn(body: str, world: int, tmp_path, timeout: float = 240.0,
          torchrun: bool = False, **kw):
    """``start`` and wait: the ranks' results."""
    return start(body, world, tmp_path, timeout, torchrun, **kw).results()


# ---------------------------------------------------------------------------
# helpers of the bodies
# ---------------------------------------------------------------------------

def load_model(tmp, name="weights.pt", cfg=None):
    """The port model of the state dict the test saved (fp32, CPU)."""
    import vda_tpu_torch as vt

    saved = torch.load(os.path.join(tmp, name), weights_only=False)
    model = vt.VideoDepthAnything(cfg or saved["cfg"], device="cpu")
    model.load_state_dict(saved["sd"], strict=True)
    return model.requires_grad_(False)


def save_model(tmp, model, name="weights.pt"):
    torch.save({"cfg": model.cfg, "sd": model.state_dict()},
               os.path.join(str(tmp), name))


def _counted(fn):
    from vda_tpu_torch.parallel import mesh as tpm

    tpm.reset_collective_counts()
    out = fn()
    return out, tpm.collective_counts()


# ---------------------------------------------------------------------------
# bodies
# ---------------------------------------------------------------------------

def body_window(rank, world, tmp, tp, frames, x, sp_x=None):
    """dp x tp: the sharded model's one-forward collectives, the shard /
    gather round trip, ``infer_video_depth(mesh=)`` on ``frames`` (fp32) and
    the sequence-parallel forward of ``sp_x`` over the dp slices (the
    second saved model, ``seq_shard`` on)."""
    import dataclasses

    import vda_tpu_torch as vt
    from vda_tpu_torch.parallel import mesh as tpm

    mesh = tpm.make_mesh(tp=tp, device="cpu")
    model = load_model(tmp)
    full = {k: v.clone() for k, v in model.state_dict().items()}
    tpm.shard_model(model, mesh)
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    back = tpm.full_state_dict(model)
    round_trip = all(torch.equal(full[k], back[k]) for k in full)
    with torch.no_grad():
        _, counts = _counted(lambda: vt.forward(model, torch.from_numpy(x)))
    depths, _ = vt.infer_video_depth(model, frames, 24, input_size=56,
                                     fp32=True, window_batch=2, mesh=mesh)
    out = {"shapes": shapes, "round_trip": round_trip, "counts": counts,
           "depths": depths}
    if sp_x is not None:
        m2 = load_model(tmp, "weights_sp.pt")
        vit = dataclasses.replace(m2.cfg.vit, seq_shard=True)
        m2.cfg = m2.cfg.replace(vit=vit)
        m2.pretrained.cfg = vit
        tpm.shard_model(m2, mesh)
        b = sp_x.shape[0] // mesh.dp
        mine = torch.from_numpy(sp_x[mesh.data_rank * b:
                                     (mesh.data_rank + 1) * b])
        with torch.no_grad():
            got, counts = _counted(lambda: vt.forward(m2, mine,
                                                      micro_batch_size=4))
        out["sp"] = tpm.all_gather(got, mesh.data_group, 0).numpy()
        out["sp_counts"] = counts
    return out


def _stream_refusals(model, mesh):
    """The messages of what a tensor-parallel stream refuses."""
    import vda_tpu_torch as vt

    msgs = {}
    for name, env, kw in (("ctx_kernel", {}, {"ctx_kernel": True}),
                          ("direct", {"VDA_STREAM_DIRECT": "1"}, {})):
        old = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            vt.StreamingDepth(model, input_size=56, fp32=True, mesh=mesh,
                              **kw)
            msgs[name] = None
        except ValueError as e:
            msgs[name] = str(e)
        finally:
            for k, v in old.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
    os.environ["VDA_STREAM_CTX_KERNEL"] = "1"
    try:
        msgs["knob_yields"] = not vt.StreamingDepth(
            model, input_size=56, fp32=True, mesh=mesh).ctx_kernel
    finally:
        os.environ.pop("VDA_STREAM_CTX_KERNEL")
    return msgs


def body_stream(rank, world, tmp, frames, group_at, cache_dtypes):
    """A tp=world stream over ``frames`` for each cache dtype, a
    ``submit_group`` of 4 at step ``group_at``: each step's depths, the
    order after each step, the cache bytes; and the refusals."""
    import vda_tpu_torch as vt
    from vda_tpu_torch.parallel import mesh as tpm

    mesh = tpm.make_mesh(tp=world, device="cpu")
    model = load_model(tmp)
    out = {"refusals": _stream_refusals(model, mesh)}
    # the model now carries the mesh: a stream given none takes it
    out["inherits_mesh"] = vt.StreamingDepth(
        model, input_size=56, fp32=True).mesh is mesh
    for cd in cache_dtypes:
        s = vt.StreamingDepth(model, input_size=56, fp32=True, mesh=mesh,
                              cache_dtype=cd)
        depths, orders = [], []
        i = 0
        while i < len(frames):
            if i == group_at:
                depths.extend(s.submit_group(frames[i:i + 4]).numpy())
                i += 4
            else:
                depths.append(s.submit(frames[i]).numpy())
                i += 1
            orders.append(list(s.order))
        out[cd] = {"depths": np.stack(depths), "orders": orders,
                   "cache_bytes": s.cache_bytes()}
    return out


def body_train(rank, world, tmp, tp, sp, batches, steps, resume_from=None,
               **kw):
    """``parallel.trainer.train`` over ``batches`` (each rank keeps its
    data slice) on the saved model: the metrics of every step, and on each
    rank the whole trained state dict (gathered) and ``resume_from``'s
    resumed run (its checkpoint directory a copy of step 1's)."""
    import shutil

    import vda_tpu_torch as vt
    from vda_tpu_torch.parallel import mesh as tpm

    def run(ckpt, n):
        model = load_model(tmp).requires_grad_(True)
        logs = []
        state = vt.train(model, iter(batches), n, ckpt_dir=ckpt,
                         ckpt_every=1, tp=tp, sp=sp, prefetch=0,
                         log_fn=lambda s, m: logs.append(
                             {k: float(v) for k, v in m.items()}), **kw)
        return state, logs

    ckpt = os.path.join(tmp, "ckpt")
    state, logs = run(ckpt, steps)
    out = {"logs": logs, "sd": tpm.full_state_dict(state.model),
           "counts": None}
    if resume_from is not None:
        again = os.path.join(tmp, "ckpt_resume")
        if rank == 0:
            os.makedirs(again, exist_ok=True)
            name = f"step_{resume_from:08d}.pt"
            shutil.copy(os.path.join(ckpt, name), os.path.join(again, name))
        dist.barrier()
        state2, logs2 = run(again, steps)
        out["resumed_logs"] = logs2
        out["resumed_sd"] = tpm.full_state_dict(state2.model)
    return out


def _cli_model(device="cpu"):
    from vda_tpu_torch.utils.loader import load_model_params

    return load_model_params("tiny", random_init=True, cast_bf16=False,
                             device=device)[1]


def body_cli_run(rank, world, tmp, flags):
    """``apps.run`` with ``flags`` under torchrun's environment, then
    ``infer_video_depth(mesh=)`` on the model and frames it loads."""
    import vda_tpu_torch as vt
    from vda_tpu_torch.apps import run
    from vda_tpu_torch.parallel import mesh as tpm
    from vda_tpu_torch.utils import io

    args = run.build_arg_parser().parse_args(flags)
    got = run.main(flags)
    mesh = tpm.make_mesh(tp=args.tp, device="cpu")
    frames, fps = io.read_video_frames(args.input_video, args.max_len,
                                       args.target_fps, args.max_res)
    want, _ = vt.infer_video_depth(_cli_model(), frames, fps,
                                   input_size=args.input_size, fp32=True,
                                   mesh=mesh)
    return {"cli": got, "direct": want, "world": mesh.world,
            "outputs": sorted(os.listdir(args.output_dir))}


def body_cli_stream(rank, world, tmp, flags):
    """``apps.run_streaming`` with ``flags`` under torchrun's environment,
    then a ``StreamingDepth(mesh=)`` loop over the frames it decodes."""
    import vda_tpu_torch as vt
    from vda_tpu_torch.apps import run_streaming
    from vda_tpu_torch.parallel import mesh as tpm

    args = run_streaming.build_arg_parser().parse_args(flags)
    got = run_streaming.main(flags)
    mesh = tpm.make_mesh(tp=args.tp, device="cpu")
    s = vt.StreamingDepth(_cli_model(), input_size=args.input_size,
                          fp32=True, mesh=mesh)
    _, video = run_streaming.open_video(args.input_video, args.target_fps,
                                        args.max_res)
    want = [s(f) for _, f in zip(range(args.max_len), video)]
    return {"cli": np.stack(got), "direct": np.stack(want)}


def body_cli_train(rank, world, tmp, flags):
    """``apps.train`` with ``flags`` for 2 steps under torchrun's
    environment, then resumed from its checkpoint to step 3."""
    from vda_tpu_torch.apps import train

    first = train.main(flags + ["--steps", "2"])
    resumed = train.main(flags + ["--steps", "3"])
    return {"steps": (first.step, resumed.step)}
