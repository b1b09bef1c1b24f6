"""Fine-tuning CLI of the port: the counterpart of ``apps/train.py``, with its
flags, over ``parallel/trainer.train`` on one device.

    python -m vda_tpu_torch.apps.train --encoder vitl --synthetic \
        --steps 100 --export-pth finetuned.pth

Data comes from a directory of .npz shards (keys: video (B,T,H,W,3) uint8
or float RAW RGB in [0,1], depth (B,T,H,W), mask), a benchmark-extract
--manifest, or --synthetic for a smoke run; the three iterators are copies
of ``apps/train.py``'s, held to them by ``tests/test_torch_apps_train.py``.
ImageNet normalization happens INSIDE the train step: shards must NOT be
pre-normalized (guarded in npz_data_iter).  The model starts from seeded
random weights (``init_random``, a ``torch.Generator`` seeded 0), a
reference ``.pth`` or the JAX package's ``.npz`` params (in fp32, as JAX's
CLI loads them); ``--export-pth`` saves the trained state dict, which has
the reference's key layout.  Runs on the card unless ``--device cpu``;
``--tp`` above 1 is multi-GPU work (ROADMAP.md Queue 1, item 9) and is
refused.
"""

import argparse
import glob
import os

import numpy as np


def npz_data_iter(data_dir: str, loop: bool = True, patch: int = 0):
    """patch > 0 validates shard spatial dims against the ViT patch size up
    front (the friendly error; otherwise the jitted step fails obscurely)."""
    shards = sorted(glob.glob(os.path.join(data_dir, "*.npz")))
    if not shards:
        raise FileNotFoundError(f"no .npz shards under {data_dir}")
    checked = set()
    while True:
        for path in shards:
            with np.load(path) as z:
                video = z["video"]
                if path not in checked:
                    checked.add(path)
                    h, w = video.shape[2], video.shape[3]
                    if patch and (h % patch or w % patch):
                        raise ValueError(
                            f"{path}: shard frames are {h}x{w}, not a "
                            f"multiple of the ViT patch size ({patch})")
                    if video.dtype != np.uint8 and (
                            float(video.min()) < -0.05
                            or float(video.max()) > 1.5):
                        raise ValueError(
                            f"{path}: float video outside [0, 1] — shards "
                            "must hold RAW RGB (ImageNet normalization "
                            "happens inside the train step; pre-normalized "
                            "data would be normalized twice)")
                if video.dtype == np.uint8:
                    video = video.astype(np.float32) / 255.0
                yield {
                    "video": video.astype(np.float32),
                    "depth": z["depth"].astype(np.float32),
                    "mask": z["mask"].astype(bool),
                }
        if not loop:
            return


def manifest_clip_iter(manifest_path: str, batch: int, frames: int,
                       size: int, seed: int = 0, target: str = "disparity",
                       decode_workers: int = 8):
    """Sample training clips from a benchmark-extract manifest
    (benchmark/dataset_extract/extract_utils.gen_json layout:
    ``{dataset: [{seq_name: [{image, gt_depth, factor}, ...]}, ...]}``,
    paths relative to the manifest's directory).

    Each batch item is ``frames`` CONSECUTIVE frames from a random sequence,
    resized to (size, size): video raw RGB in [0,1] (normalization happens
    inside the train step), target depth/factor (or its masked reciprocal
    when target="disparity" — the affine-invariant supervision the
    depth-anything family trains on), mask = depth > 0.
    """
    import json

    import cv2

    root = os.path.dirname(os.path.abspath(manifest_path))
    with open(manifest_path) as f:
        data = json.load(f)
    seqs = [entries for ds in data.values() for seq in ds
            for entries in seq.values() if len(entries) >= frames]
    if not seqs:
        raise ValueError(f"no sequence with >= {frames} frames in "
                         f"{manifest_path}")
    rng = np.random.default_rng(seed)

    def load_clip(entries, start):
        vid, dep = [], []
        for e in entries[start:start + frames]:
            # cv2.imread returns None instead of raising — name the file
            img = cv2.imread(os.path.join(root, e["image"]))
            if img is None:
                raise FileNotFoundError(
                    f"unreadable image: {os.path.join(root, e['image'])}")
            img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
            d = cv2.imread(os.path.join(root, e["gt_depth"]),
                           cv2.IMREAD_UNCHANGED)
            if d is None:
                raise FileNotFoundError(
                    f"unreadable depth: {os.path.join(root, e['gt_depth'])}")
            d = d.astype(np.float32) / float(e.get("factor", 1.0))
            vid.append(cv2.resize(img, (size, size),
                                  interpolation=cv2.INTER_AREA))
            dep.append(cv2.resize(d, (size, size),
                                  interpolation=cv2.INTER_NEAREST))
        return np.stack(vid), np.stack(dep)

    # cv2 decode/resize release the GIL, so a thread pool over the batch's
    # clips gives near-linear decode speedup (this iterator usually runs
    # inside utils/data.prefetch_to_device, overlapping with device compute)
    from concurrent.futures import ThreadPoolExecutor
    pool = ThreadPoolExecutor(max_workers=max(1, min(decode_workers, batch)))

    while True:
        picks = []
        for _ in range(batch):
            entries = seqs[rng.integers(len(seqs))]
            start = int(rng.integers(len(entries) - frames + 1))
            picks.append((entries, start))
        clips = list(pool.map(lambda p: load_clip(*p), picks))
        vids = [v for v, _ in clips]
        deps = [d for _, d in clips]
        video = np.stack(vids).astype(np.float32) / 255.0
        depth = np.stack(deps)
        mask = depth > 0
        if target == "disparity":
            depth = np.where(mask, 1.0 / np.maximum(depth, 1e-6), 0.0)
        yield {"video": video, "depth": depth.astype(np.float32),
               "mask": mask}


def synthetic_iter(batch: int, frames: int, size: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    while True:
        yield {
            "video": rng.random((batch, frames, size, size, 3),
                                dtype=np.float32),
            "depth": (rng.random((batch, frames, size, size),
                                 dtype=np.float32) * 5 + 0.1),
            "mask": np.ones((batch, frames, size, size), bool),
        }


def main(argv=None):
    parser = argparse.ArgumentParser(description="VDA fine-tuning (GPU)")
    parser.add_argument("--encoder", default="vits",
                        choices=["vits", "vitb", "vitl", "vitg", "tiny"])
    parser.add_argument("--checkpoint", default=None,
                        help=".pth/.npz initial weights (default random)")
    parser.add_argument("--data-dir", default=None)
    parser.add_argument("--synthetic", action="store_true")
    parser.add_argument("--steps", type=int, default=100)
    parser.add_argument("--batch", type=int, default=1)
    parser.add_argument("--frames", type=int, default=8)
    parser.add_argument("--size", type=int, default=266)
    parser.add_argument("--lr", type=float, default=1e-5)
    parser.add_argument("--tp", type=int, default=1,
                        help="tensor-parallel degree: multi-GPU work, only "
                             "1 is served")
    parser.add_argument("--ckpt-dir", default=None)
    parser.add_argument("--ckpt-every", type=int, default=500)
    parser.add_argument("--manifest", default=None,
                        help="benchmark-extract manifest JSON: sample "
                             "consecutive-frame clips from its sequences")
    parser.add_argument("--target", default="disparity",
                        choices=["disparity", "depth"])
    parser.add_argument("--schedule", action="store_true",
                        help="linear warmup -> cosine decay to lr/10")
    parser.add_argument("--warmup-steps", type=int, default=0)
    parser.add_argument("--clip-norm", type=float, default=0.0)
    parser.add_argument("--augment-size", type=int, default=0,
                        help="enable on-device clip augmentation "
                             "(random-resized-crop to this size + hflip + "
                             "photometric jitter); 0 = off")
    parser.add_argument("--prefetch", type=int, default=2,
                        help="host-side prefetch depth (decode + H2D in a "
                             "background thread); 0 = synchronous")
    parser.add_argument("--accum", type=int, default=1,
                        help="gradient-accumulation steps (effective batch "
                             "= batch x accum)")
    parser.add_argument("--metrics", default=None,
                        help="append per-step loss JSONL to this path")
    parser.add_argument("--export-pth", default=None,
                        help="after training, save the final weights as a "
                             "reference-format .pth (loadable by the torch "
                             "reference with strict=True)")
    parser.add_argument("--device", default="cuda",
                        help="device the model trains on (cuda, or cpu)")
    args = parser.parse_args(argv)

    import torch

    from vda_tpu_torch.apps.run import refuse_unported
    from vda_tpu_torch.config import get_config
    from vda_tpu_torch.models.vda import VideoDepthAnything
    from vda_tpu_torch.parallel.trainer import train
    from vda_tpu_torch.utils.convert import (
        init_random,
        load_npz_checkpoint,
        load_torch_checkpoint,
    )

    refuse_unported(args)
    cfg = get_config(args.encoder)
    patch = cfg.vit.patch_size
    # --size only reaches the model in manifest/synthetic modes (npz shards
    # carry their own dims, validated in npz_data_iter); with augmentation
    # on, --augment-size is what reaches the model in every mode
    eff_size = args.augment_size or (
        None if args.data_dir and not args.manifest else args.size)
    if eff_size and eff_size % patch:
        parser.error(
            f"the size reaching the model ({eff_size}, from "
            f"{'--augment-size' if args.augment_size else '--size'}) must "
            f"be a multiple of the ViT patch size ({patch})")
    if args.augment_size and args.augment_size > args.size and args.manifest:
        # the crop would UPSAMPLE low-res decodes while looking like
        # augment-size training; decode at least as large as the crop
        parser.error(
            f"--augment-size {args.augment_size} > --size {args.size}: "
            "decode at least as large as the crop (raise --size)")
    if args.checkpoint is None:
        model = init_random(cfg, torch.Generator(device=args.device)
                            .manual_seed(0), device=args.device)
    else:
        load = load_npz_checkpoint if args.checkpoint.endswith(".npz") \
            else load_torch_checkpoint
        model = load(args.checkpoint,
                     VideoDepthAnything(cfg, device=args.device))

    if args.manifest:
        data = manifest_clip_iter(args.manifest, args.batch, args.frames,
                                  args.size, target=args.target)
    elif args.synthetic or args.data_dir is None:
        data = synthetic_iter(args.batch, args.frames, args.size)
    else:
        data = npz_data_iter(args.data_dir, patch=0 if args.augment_size
                             else patch)

    state = train(model, data, num_steps=args.steps,
                  ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                  learning_rate=args.lr,
                  schedule=args.schedule, warmup_steps=args.warmup_steps,
                  clip_norm=args.clip_norm,
                  augment_hw=((args.augment_size, args.augment_size)
                              if args.augment_size else None),
                  prefetch=args.prefetch, accum=args.accum,
                  metrics_path=args.metrics)
    if args.export_pth:
        torch.save(state.model.state_dict(), args.export_pth)
        print(f"exported reference-format weights to {args.export_pth}")
    print(f"done at step {int(state.step)}")
    return state


if __name__ == "__main__":
    main()
