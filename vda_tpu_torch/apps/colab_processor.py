"""Batch image-sequence processor (Colab-style workflow) of the port: the
counterpart of ``apps/colab_processor.py`` (a rebuild of reference
colab_processor.py).

    python -m vda_tpu_torch.apps.colab_processor batch.json --encoder vitl

Loads image-sequence frames by template, runs windowed inference and writes
an EXR Z-channel sequence numbered from ``first_frame`` (VFX convention,
typically 1001), plus an optional depth visualization MP4.  Runs on the
card unless ``--device cpu``.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from vda_tpu_torch.apps.engine.sequence import read_image_sequence


class BatchSequenceProcessor:
    """reference colab_processor.py:53-149 (ColabVDAProcessor)."""

    def __init__(self, encoder: str = "vits", metric: bool = False,
                 checkpoint: Optional[str] = None, fp32: bool = False,
                 random_init: bool = False, input_size: int = 518,
                 device: str = "cuda"):
        from vda_tpu_torch.utils.loader import load_model_params

        self.input_size = input_size
        self.fp32 = fp32
        self.cfg, self.model = load_model_params(
            encoder, metric=metric, checkpoint=checkpoint,
            random_init=random_init, cast_bf16=not fp32, device=device)

    def process_sequence(self, frame_template: str, first_frame: int,
                         last_frame: int, output_dir: str,
                         exr_first_frame: Optional[int] = None,
                         save_vis_mp4: bool = False,
                         fps: float = 24.0) -> List[str]:
        """One sequence -> EXR Z sequence (reference colab_processor.py:152-212).

        frame_template: e.g. /shots/sh010/plate.%04d.jpg
        """
        from vda_tpu_torch.infer.windowed import infer_video_depth
        from vda_tpu_torch.utils.io import save_depth_exr, save_video

        frames, numbers = read_image_sequence(frame_template, first_frame,
                                              last_frame)
        depths, _ = infer_video_depth(self.model, frames, fps,
                                      input_size=self.input_size,
                                      fp32=self.fp32)
        os.makedirs(output_dir, exist_ok=True)
        base = exr_first_frame if exr_first_frame is not None else numbers[0]
        written = []
        for i, depth in enumerate(depths):
            path = os.path.join(output_dir, f"depth.{base + i:04d}.exr")
            if not save_depth_exr(path, depth):
                path = path.replace(".exr", ".npy")
                np.save(path, depth.astype(np.float32))
            written.append(path)
        if save_vis_mp4:
            save_video(depths, os.path.join(output_dir, "depth_vis.mp4"),
                       fps=fps, is_depths=True)
        return written


def process_batch_sequences(config: Dict, encoder: str = "vits",
                            metric: bool = False,
                            checkpoint: Optional[str] = None,
                            fp32: bool = False,
                            random_init: bool = False,
                            device: str = "cuda") -> Dict[str, List[str]]:
    """Batch driver (reference colab_processor.py:152-212).

    config: {sequence_name: {"template": ..., "first_frame": int,
    "last_frame": int, "output_dir": ..., ["exr_first_frame": int,
    "save_vis_mp4": bool]}}
    """
    proc = BatchSequenceProcessor(encoder=encoder, metric=metric,
                                  checkpoint=checkpoint, fp32=fp32,
                                  random_init=random_init, device=device)
    results = {}
    for name, seq in config.items():
        results[name] = proc.process_sequence(
            seq["template"], int(seq["first_frame"]), int(seq["last_frame"]),
            seq["output_dir"],
            exr_first_frame=seq.get("exr_first_frame"),
            save_vis_mp4=bool(seq.get("save_vis_mp4", False)))
        print(f"{name}: {len(results[name])} frames -> {seq['output_dir']}")
    return results


def main(argv=None):
    import argparse
    import json

    parser = argparse.ArgumentParser()
    parser.add_argument("config", help="JSON batch config")
    parser.add_argument("--encoder", default="vits")
    parser.add_argument("--metric", action="store_true")
    parser.add_argument("--checkpoint", default=None)
    parser.add_argument("--fp32", action="store_true")
    parser.add_argument("--random-init", action="store_true")
    parser.add_argument("--device", default="cuda",
                        help="device the model runs on (cuda, or cpu)")
    args = parser.parse_args(argv)
    with open(args.config) as f:
        config = json.load(f)
    return process_batch_sequences(
        config, encoder=args.encoder, metric=args.metric,
        checkpoint=args.checkpoint, fp32=args.fp32,
        random_init=args.random_init, device=args.device)


if __name__ == "__main__":
    main()
