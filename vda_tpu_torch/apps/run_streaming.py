"""Streaming (causal, frame-by-frame) video depth CLI of the port: the
counterpart of ``apps/run_streaming.py`` (a rebuild of reference
run_streaming.py:25-96), with its flags and outputs.

    python -m vda_tpu_torch.apps.run_streaming --input_video clip.mp4

Decodes frames with cv2 (``open_video``), calls ``StreamingDepth`` per frame
(``--lookahead`` k > 1: ``submit_group`` on k frames at a time), writes the
depth visualization video and prints the wall time.  Whether the stream
runs K6 (``VDA_STREAM_CTX_KERNEL`` / ``VDA_STREAM_DIRECT``) and, with
``--cache-dtype auto``, its cache dtype come from the ``VDA_STREAM_*``
knobs, as JAX's CLI resolves them (``utils/knobs.py``).
Runs on the card unless ``--device cpu``; ``--tp`` above 1 is multi-GPU
work (ROADMAP.md Queue 1, item 9) and is refused.
"""

import argparse
import os
import time

import numpy as np

from vda_tpu_torch.infer.streaming import StreamingDepth


def build_arg_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Video Depth Anything streaming (GPU)")
    parser.add_argument("--input_video", type=str,
                        default="./assets/example_videos/davis_rollercoaster.mp4")
    parser.add_argument("--output_dir", type=str, default="./outputs")
    parser.add_argument("--input_size", type=int, default=518)
    parser.add_argument("--max_res", type=int, default=1280)
    parser.add_argument("--encoder", type=str, default="vitl",
                        choices=["vits", "vitb", "vitl", "vitg", "tiny"])
    parser.add_argument("--max_len", type=int, default=-1)
    parser.add_argument("--target_fps", type=int, default=-1)
    parser.add_argument("--fp32", action="store_true")
    parser.add_argument("--grayscale", action="store_true")
    parser.add_argument("--checkpoint", type=str, default=None)
    parser.add_argument("--random-init", action="store_true")
    parser.add_argument("--attn-impl", type=str, default="auto",
                        choices=["auto", "xla", "plain"])
    parser.add_argument("--lookahead", type=int, default=1,
                        help="frames per call (>1 = throughput mode: "
                             "batched encoder and output tail, the same "
                             "cache, up to <lookahead> frames of added "
                             "latency)")
    parser.add_argument("--cache-dtype", type=str, default="auto",
                        choices=["auto", "bf16", "int8"],
                        help="hidden-state cache dtype: bf16 or int8, "
                             "which halves the cache and its per-step read; "
                             "auto reads VDA_STREAM_CACHE_DTYPE / "
                             "VDA_STREAM_KV8 (bf16 when unset)")
    parser.add_argument("--tp", type=int, default=1,
                        help="tensor-parallel degree: multi-GPU work, only "
                             "1 is served")
    parser.add_argument("--device", type=str, default="cuda",
                        help="device the model runs on (cuda, or cpu)")
    return parser


def open_video(path: str, target_fps: float, max_res: int):
    """(fps, generator of (H, W, 3) uint8 RGB frames) of a video, decoded by
    cv2 with ``apps/run_streaming.py``'s stride for ``target_fps`` and its
    even-sized downscale to ``max_res``."""
    import cv2

    from vda_tpu_torch.utils.io import ensure_even

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise FileNotFoundError(path)
    original_fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
    fps = original_fps if target_fps <= 0 else target_fps
    stride = max(round(original_fps / fps), 1)
    oh = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
    ow = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
    scale_needed = max_res > 0 and max(oh, ow) > max_res
    if scale_needed:
        s = max_res / max(oh, ow)
        height, width = ensure_even(round(oh * s)), ensure_even(round(ow * s))

    def frames():
        count = 0
        try:
            while True:
                ret, frame = cap.read()
                if not ret:
                    return
                if count % stride == 0:
                    frame = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
                    if scale_needed:
                        frame = cv2.resize(frame, (width, height))
                    yield frame
                count += 1
        finally:
            cap.release()

    return fps, frames()


def main(argv=None):
    args = build_arg_parser().parse_args(argv)

    from vda_tpu_torch.apps import run
    from vda_tpu_torch.utils import io

    run.refuse_unported(args)
    cfg, model = run.load_model(args)
    stream = StreamingDepth(model, input_size=args.input_size,
                            fp32=args.fp32, attn_impl=args.attn_impl,
                            cache_dtype=(None if args.cache_dtype == "auto"
                                         else args.cache_dtype))
    fps, video = open_video(args.input_video, args.target_fps, args.max_res)

    # Pipelined loop: submit frame n+1 (asynchronous) BEFORE fetching frame
    # n's depth, overlapping host decode and the device-to-host copy with
    # device compute; one frame (or one lookahead group) in flight bounds
    # memory.
    depths = []
    pending = None
    batch = []
    n_submitted = 0
    t0 = time.time()

    def flush(handle):
        nonlocal pending
        if pending is not None:
            d = pending.cpu().numpy()
            depths.extend(d if d.ndim == 3 else [d])
        pending = handle

    for frame in video:
        if args.max_len > 0 and n_submitted >= args.max_len:
            break
        n_submitted += 1
        if args.lookahead <= 1 or n_submitted == 1:
            flush(stream.submit(frame))  # frame 1 initializes the stream
        else:
            batch.append(frame)
            if len(batch) == args.lookahead:
                flush(stream.submit_group(np.stack(batch)))
                batch = []
    video.close()
    for f in batch:  # leftover partial group: frame by frame
        flush(stream.submit(f))
    flush(None)
    wall = time.time() - t0
    print(f"{len(depths)} frames in {wall:.2f}s "
          f"({len(depths) / max(wall, 1e-9):.2f} fps)")

    stem = os.path.splitext(os.path.basename(args.input_video))[0]
    os.makedirs(args.output_dir, exist_ok=True)
    io.save_video(np.stack(depths),
                  os.path.join(args.output_dir, stem + "_vis.mp4"),
                  fps=fps, is_depths=True, grayscale=args.grayscale)
    return depths


if __name__ == "__main__":
    main()
