"""Benchmark inference of the port: a dataset manifest to per-frame ``.npy``
predictions, the counterpart of ``benchmark/infer/infer.py`` (a rebuild of
reference benchmark/infer/infer.py).

    python -m vda_tpu_torch.apps.benchmark_infer --infer_path preds \\
        --json_file root/scannet/scannet_video.json --datasets scannet

For each manifest entry it loads the frame images, runs the whole windowed
inference in fp32 with target_fps=1, and saves one ``.npy`` a frame under
``--infer_path``, mirroring the image paths.  ``benchmark/eval/`` reads them
unchanged.  Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def read_rgb(path: str) -> np.ndarray:
    """(H, W, 3) uint8 RGB of an image file (cv2)."""
    import cv2

    img = cv2.imread(path)
    if img is None:
        raise FileNotFoundError(f"unreadable image: {path}")
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--infer_path", type=str, default="")
    parser.add_argument("--json_file", type=str, default="")
    parser.add_argument("--datasets", type=str, nargs="+",
                        default=["scannet", "nyuv2"])
    parser.add_argument("--input_size", type=int, default=518)
    parser.add_argument("--encoder", type=str, default="vitl",
                        choices=["vits", "vitb", "vitl", "vitg", "tiny"])
    parser.add_argument("--checkpoint", type=str, default=None)
    parser.add_argument("--random-init", action="store_true")
    parser.add_argument("--device", type=str, default="cuda",
                        help="device the model runs on (cuda, or cpu)")
    args = parser.parse_args(argv)

    from vda_tpu_torch.apps import run
    from vda_tpu_torch.infer.windowed import infer_video_depth

    args.metric = False
    args.fp32 = True
    run.refuse_unported(args)
    cfg, model = run.load_model(args)

    for dataset in args.datasets:
        with open(args.json_file) as f:
            manifest = json.load(f)
        root_path = os.path.dirname(args.json_file)
        for scene in manifest[dataset]:
            for _name, entries in scene.items():
                frames, pred_paths = [], []
                for e in entries:
                    frames.append(read_rgb(os.path.join(root_path,
                                                        e["image"])))
                    pred_paths.append(
                        os.path.join(args.infer_path, dataset, e["image"])
                        .replace(".jpg", ".npy").replace(".png", ".npy"))
                frames = np.stack(frames, axis=0)
                depths, _fps = infer_video_depth(
                    model, frames, target_fps=1, input_size=args.input_size,
                    fp32=True)
                for path, depth in zip(pred_paths, depths):
                    os.makedirs(os.path.dirname(path), exist_ok=True)
                    np.save(path, depth)
                print(f"{_name}: {len(pred_paths)} frames")


if __name__ == "__main__":
    main()
