"""Gradio web demo (vitl) of the port: the counterpart of ``apps/app.py`` (a
rebuild of reference app.py:39-152).

    python -m vda_tpu_torch.apps.app --random-init

Sliders for max_len / target_fps / max_res; returns the processed source and
depth-visualization MP4s.  Requires the optional ``gradio`` dependency.
Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import os
import tempfile


def build_demo(encoder: str = "vitl", checkpoint: str = None,
               random_init: bool = False, input_size: int = 518,
               device: str = "cuda"):
    try:
        import gradio as gr
    except ImportError as e:
        raise SystemExit(
            "gradio is not installed in this environment; the demo UI is "
            "unavailable. Use python -m vda_tpu_torch.apps.run for CLI "
            "inference.") from e

    from vda_tpu_torch.infer.windowed import infer_video_depth
    from vda_tpu_torch.utils.io import read_video_frames, save_video
    from vda_tpu_torch.utils.loader import load_model_params

    cfg, model = load_model_params(encoder, checkpoint=checkpoint,
                                   random_init=random_init, device=device)

    def infer(video_path, max_len, target_fps, max_res):
        frames, fps = read_video_frames(video_path, int(max_len),
                                        int(target_fps), int(max_res))
        depths, out_fps = infer_video_depth(model, frames, fps,
                                            input_size=input_size)
        out_dir = tempfile.mkdtemp(prefix="vda_demo_")
        src = os.path.join(out_dir, "src.mp4")
        vis = os.path.join(out_dir, "vis.mp4")
        save_video(frames, src, fps=out_fps)
        save_video(depths, vis, fps=out_fps, is_depths=True)
        return src, vis

    with gr.Blocks(title="Video Depth Anything (GPU)") as demo:
        gr.Markdown("# Video Depth Anything — PyTorch/CUDA port")
        with gr.Row():
            inp = gr.Video(label="input video")
            with gr.Column():
                max_len = gr.Slider(-1, 1000, value=500, step=1,
                                    label="max length (frames)")
                target_fps = gr.Slider(-1, 30, value=15, step=1,
                                       label="target fps")
                max_res = gr.Slider(480, 1920, value=1280, step=2,
                                    label="max resolution")
                btn = gr.Button("Generate depth")
        with gr.Row():
            out_src = gr.Video(label="processed source")
            out_vis = gr.Video(label="depth visualization")
        btn.click(infer, [inp, max_len, target_fps, max_res],
                  [out_src, out_vis])
    return demo


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("--encoder", default="vitl")
    parser.add_argument("--checkpoint", default=None)
    parser.add_argument("--random-init", action="store_true")
    parser.add_argument("--port", type=int, default=7860)
    parser.add_argument("--device", default="cuda",
                        help="device the model runs on (cuda, or cpu)")
    args = parser.parse_args(argv)
    build_demo(args.encoder, args.checkpoint, args.random_init,
               device=args.device).launch(server_port=args.port)


if __name__ == "__main__":
    main()
