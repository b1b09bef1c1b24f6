"""Offline video depth CLI of the port: the counterpart of ``apps/run.py``
(a rebuild of reference run.py:23-101), with its flags and outputs.

    python -m vda_tpu_torch.apps.run --input_video clip.mp4 --encoder vitl

Outputs: <name>_src.mp4, <name>_vis.mp4, optional NPZ (``depths`` key),
optional per-frame EXR Z channel, and metric-mode point clouds (PLY).

Weights: a reference ``.pth`` (default ./checkpoints/{metric_}video_depth_
anything_{enc}.pth, reference run.py:50-54) or the JAX package's ``.npz``
params (``--checkpoint x.npz``) through ``utils/loader.load_model_params``,
or ``--random-init`` (seeded weights, for pipeline testing).  The model
runs on the card unless ``--device cpu`` asks for the CPU.
``--window-batch N`` runs N windows as the batch of one forward on that
device.

Under ``torchrun --standalone --nproc-per-node N`` the ranks form a
('data', 'model') mesh (``parallel/mesh.make_mesh``): ``--tp`` ranks hold
one model, sharded head-aligned, and the window batch fans out over the
rest (JAX's rule: with ``--tp 1`` the data axis takes at most
``--window-batch`` ranks, so the batch keeps its size; ``--tp`` must
divide the world size).  Each rank runs on ``cuda:{LOCAL_RANK}`` (ranks
sharing a card join by gloo, others by NCCL); rank 0 alone writes the
outputs.  With one process and ``--tp 1`` nothing of this runs.
"""

import argparse
import importlib.util
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_VIDEO = "./assets/example_videos/davis_rollercoaster.mp4"


def build_arg_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Video Depth Anything (GPU)")
    parser.add_argument("--input_video", type=str, default=DEFAULT_VIDEO)
    parser.add_argument("--output_dir", type=str, default="./outputs")
    parser.add_argument("--input_size", type=int, default=518)
    parser.add_argument("--max_res", type=int, default=1280)
    parser.add_argument("--encoder", type=str, default="vitl",
                        choices=["vits", "vitb", "vitl", "vitg", "tiny"])
    parser.add_argument("--max_len", type=int, default=-1,
                        help="maximum length of the input video, -1 no limit")
    parser.add_argument("--target_fps", type=int, default=-1,
                        help="target fps, -1 keeps the original fps")
    parser.add_argument("--metric", action="store_true",
                        help="use metric depth model")
    parser.add_argument("--fp32", action="store_true",
                        help="run in float32 (default bfloat16)")
    parser.add_argument("--grayscale", action="store_true",
                        help="do not apply colorful palette")
    parser.add_argument("--save_npz", action="store_true")
    parser.add_argument("--save_exr", action="store_true")
    parser.add_argument("--focal-length-x", default=470.4, type=float)
    parser.add_argument("--focal-length-y", default=470.4, type=float)
    # extensions over the reference CLI
    parser.add_argument("--checkpoint", type=str, default=None,
                        help="explicit checkpoint path: a reference .pth "
                             "or the JAX package's .npz params")
    parser.add_argument("--random-init", action="store_true",
                        help="random weights (pipeline testing only)")
    parser.add_argument("--attn-impl", type=str, default="auto",
                        choices=["auto", "xla", "plain"],
                        help="auto: the hand-written kernels; xla: the "
                             "LayerNorm kernel only; plain: plain PyTorch")
    parser.add_argument("--window-batch", type=int, default=1,
                        help="independent windows batched into one forward")
    parser.add_argument("--tp", type=int, default=1,
                        help="tensor-parallel degree under torchrun: ranks "
                             "sharing one model (must divide the world "
                             "size)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="device the model runs on (cuda, or cpu)")
    return parser


def check_tp(args) -> int:
    """The world size; SystemExit where ``--tp`` does not divide it."""
    from vda_tpu_torch.parallel.mesh import world_size

    world = world_size()
    tp = getattr(args, "tp", 1)
    if tp < 1 or world % tp:
        raise SystemExit(f"--tp {tp} does not divide the world size "
                         f"{world} (launch with torchrun --nproc-per-node "
                         f"a multiple of {tp})")
    return world


def rank_device(args) -> str:
    """The rank's device: ``--device cuda`` is ``cuda:{LOCAL_RANK}`` (of
    the cards there are), any other ``--device`` as given."""
    from vda_tpu_torch.parallel.mesh import rank_device as rd

    device = getattr(args, "device", "cuda")
    return str(rd(None if device == "cuda" else device))


def cli_mesh(args, n_devices=None):
    """The mesh of a CLI run (``make_mesh(n_devices, tp=--tp)`` on the
    rank's device), or None for one process at ``--tp 1``.  Ranks outside
    the first ``n_devices`` get None as well."""
    from vda_tpu_torch.parallel.mesh import make_mesh

    world = check_tp(args)
    if world == 1:
        return None
    return make_mesh(n_devices, tp=args.tp, device=rank_device(args))


def is_writer() -> bool:
    """Whether this rank writes outputs: rank 0, or the one process."""
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


def _ensure_example_video(path: str) -> None:
    """The repo ships no binary assets (reference run.py:24 assumes a
    checked-in example clip).  When the user runs the literal default
    command on a fresh clone, synthesize the example video instead of
    failing, with examples/make_test_video.py, as ``apps/run.py`` does."""
    if os.path.exists(path):
        return
    os.makedirs(os.path.dirname(path), exist_ok=True)
    sys.argv, argv_prev = [sys.argv[0], path, "--frames", "64"], sys.argv
    try:
        spec = importlib.util.spec_from_file_location(
            "make_test_video",
            os.path.join(REPO, "examples", "make_test_video.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        mod.main()
        print(f"default example video was missing — generated a synthetic "
              f"clip at {path}")
    finally:
        sys.argv = argv_prev


def load_model(args):
    """(cfg, model) the CLI runs: weights by ``load_model_params``, cast to
    bf16 once unless ``--fp32``, on ``--device``."""
    from vda_tpu_torch.utils.loader import load_model_params

    return load_model_params(
        args.encoder,
        metric=getattr(args, "metric", False),
        checkpoint=args.checkpoint,
        random_init=args.random_init,
        cast_bf16=not getattr(args, "fp32", False),
        device=rank_device(args))


def main(argv=None):
    args = build_arg_parser().parse_args(argv)
    world = check_tp(args)
    # JAX's rule: --tp fills the data axis with the whole world; plain
    # --window-batch N fans out over at most N ranks, so the batch keeps
    # its size (the other ranks have nothing to do)
    n = world if args.tp > 1 else min(world, args.window_batch)
    mesh = cli_mesh(args, n)

    from vda_tpu_torch.infer.windowed import infer_video_depth
    from vda_tpu_torch.utils import io

    if args.input_video == DEFAULT_VIDEO and is_writer():
        _ensure_example_video(args.input_video)
    if world > 1:
        import torch.distributed as dist

        dist.barrier()
        if mesh is None:
            return None  # a rank outside the mesh
    cfg, model = load_model(args)
    frames, target_fps = io.read_video_frames(
        args.input_video, args.max_len, args.target_fps, args.max_res)

    def progress(i, n):
        if is_writer():
            print(f"\rwindow {i}/{n}", end="", flush=True)

    depths, fps = infer_video_depth(
        model, frames, target_fps, input_size=args.input_size,
        fp32=args.fp32, attn_impl=args.attn_impl, progress=progress,
        window_batch=args.window_batch, mesh=mesh)
    if not is_writer():
        return depths
    print()

    stem = os.path.splitext(os.path.basename(args.input_video))[0]
    os.makedirs(args.output_dir, exist_ok=True)

    io.save_video(frames, os.path.join(args.output_dir, stem + "_src.mp4"),
                  fps=fps)
    io.save_video(depths, os.path.join(args.output_dir, stem + "_vis.mp4"),
                  fps=fps, is_depths=True, grayscale=args.grayscale)

    if args.save_npz:
        io.save_depths_npz(os.path.join(args.output_dir, stem + "_depths.npz"),
                           depths)
    if args.save_exr:
        io.save_depth_exr_sequence(
            os.path.join(args.output_dir, stem + "_depths_exr"), depths)
    if args.metric:
        io.save_point_clouds(args.output_dir, frames, depths,
                             args.focal_length_x, args.focal_length_y)
    print(f"done: {depths.shape[0]} frames -> {args.output_dir}")
    return depths


if __name__ == "__main__":
    main()
