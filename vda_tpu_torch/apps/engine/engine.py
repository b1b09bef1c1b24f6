"""VFX production batch engine of the port: the counterpart of
``apps/engine/engine.py`` (a rebuild of reference external_engine/engine.py),
a daemon that processes depth jobs described by JSON, in two modes:

  * CLI mode: ``python -m vda_tpu_torch.apps.engine.engine --job job.json``
    (reference engine.py:1284-1348)
  * queue mode: poll ``communication/job_queue.json`` every 0.5 s, write
    ``communication/status.json`` ({running|processing|success|error}), delete
    the job file when done (reference engine.py:1349-1464)

Job schema (reference engine.py:190-196, 587-610):
    input_video, exr_output_dir, first_frame, last_frame, metric_depth,
    floating_point ("half"|"full"), encoder, {metric_}video_depth_anything_
    checkpoint, exr_first_frame, exr_last_frame, enable_normalization,
    normalization_near, normalization_far, invert_depth, create_source_mp4,
    create_depth_vis_mp4, depth_mp4_dir

Features reproduced: encoder autodetect from the checkpoint filename
(engine.py:224-236), image-sequence templating (%0Nd/####/%d,
engine.py:275-330), EXR input reading, UHD 4096x2160 cap resize
(engine.py:69-133), near/far normalization + inversion for Nuke
(engine.py:1099-1141), EXR output with PNG fallback (engine.py:891-935),
MP4 visualization with metadata embedding (engine.py:1143-1274).

The model runs on the card unless ``--device cpu``.  A CUDA out-of-memory
error walks the degradation ladder (``_infer_with_degradation``) down the
card's tiers, logged as DEGRADED and reported in the job's status and
metadata; an OOM on the last tier fails the job, with the tiers it tried in
its status.  The job never moves to the CPU: only an engine built with
``device="cpu"`` runs there.  DELIBERATELY NOT rebuilt, as in the JAX
engine: engine_backup's
last-ditch "simple gradient-based depth" fallback (reference
external_engine/engine_backup.py:1310-1352), which emits a Sobel-edge
pseudo-depth under real-result filenames; beyond the ladder a job fails
visibly.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time
import traceback
from typing import Dict, Optional

import numpy as np

from vda_tpu_torch.apps.engine import metadata as meta_mod
from vda_tpu_torch.apps.engine.sequence import (
    is_image_sequence,
    read_image_sequence,
)

logger = logging.getLogger("vda_engine")

UHD_MAX_WIDTH = 4096
UHD_MAX_HEIGHT = 2160
POLL_INTERVAL_S = 0.5


def normalize_path(path: str) -> str:
    """Windows/UNC -> posix-friendly path (reference engine.py:597-605)."""
    if not path:
        return path
    path = path.replace("\\", "/")
    return path


def detect_encoder(job_data: Dict, checkpoint_path: str) -> str:
    """reference engine.py:224-236."""
    if "encoder" in job_data:
        return job_data["encoder"]
    for enc in ("vits", "vitb", "vitl", "vitg"):
        if enc in os.path.basename(checkpoint_path or ""):
            return enc
    return "vits"


def resize_frames_to_uhd_max(frames: np.ndarray):
    """Cap inputs to 4096x2160 keeping aspect, even dims
    (reference engine.py:69-133)."""
    import cv2

    h, w = frames[0].shape[:2]
    if w <= UHD_MAX_WIDTH and h <= UHD_MAX_HEIGHT:
        return frames, False, (w, h), (w, h)
    scale = min(UHD_MAX_WIDTH / w, UHD_MAX_HEIGHT / h)
    nw = min(int(round(w * scale)) + int(round(w * scale)) % 2, UHD_MAX_WIDTH)
    nh = min(int(round(h * scale)) + int(round(h * scale)) % 2, UHD_MAX_HEIGHT)
    out = np.stack([
        cv2.resize(f, (nw, nh), interpolation=cv2.INTER_CUBIC)
        for f in frames
    ])
    return out, True, (w, h), (nw, nh)


def normalize_depth(depth: np.ndarray, near_value: float, far_value: float,
                    invert_depth: bool) -> np.ndarray:
    """Near/far normalization + inversion for Nuke
    (reference engine.py:1099-1141)."""
    d_min, d_max = float(depth.min()), float(depth.max())
    if d_max > d_min:
        norm = (depth - d_min) / (d_max - d_min)
        if far_value > near_value:
            norm = near_value + (far_value - near_value) * norm
        else:
            norm = far_value + (near_value - far_value) * norm
    else:
        norm = np.full_like(depth, near_value)
    if invert_depth:
        norm = far_value - (norm - near_value)
    return norm


def derive_shot_name(input_video: str) -> str:
    stem = os.path.splitext(os.path.basename(input_video))[0]
    # strip frame-pattern remnants
    for tok in ("%04d", "####", "%d"):
        stem = stem.replace(tok, "").rstrip("._")
    return stem or "shot"


class VideoDepthEngine:
    """Stateful engine: caches the loaded model between jobs with the same
    (encoder, metric, checkpoint).  ``device``: where the model runs, the
    card unless the caller asks for ``"cpu"``."""

    def __init__(self, fp32: Optional[bool] = None, device: str = "cuda"):
        self._model_key = None
        self._cfg = None
        self._model = None
        self.fp32 = fp32
        self.device = device
        # injectable for tests (OOM injection); None = infer_video_depth
        self._infer_fn = None

    # ------------------------------------------------------------------
    @staticmethod
    def _is_oom(e: Exception) -> bool:
        import torch

        return isinstance(e, torch.cuda.OutOfMemoryError)

    def _infer_with_degradation(self, frames, fps, input_size: int,
                                fp32: bool, micro_batch: int):
        """CUDA-OOM degradation ladder (reference
        engine_backup.py:1010-1352): retry the job at the next-smaller tier
        on the engine's device, then window-chunked at the smallest size.
        An OOM on the last tier is re-raised with the tiers that ran out of
        memory as its ``degraded`` attribute.  Returns (depths, fps,
        degraded_steps)."""
        from vda_tpu_torch.config import INFER_LEN
        from vda_tpu_torch.infer.stitching import compute_scale_and_shift

        infer = self._infer_fn
        if infer is None:
            from vda_tpu_torch.infer.windowed import infer_video_depth as infer

        ladder = [
            dict(name="requested", input_size=input_size,
                 micro_batch=micro_batch, fp32=fp32, chunked=False),
            dict(name="conservative_384", input_size=min(input_size, 384),
                 micro_batch=4, fp32=fp32, chunked=False),
            dict(name="chunked_224", input_size=224, micro_batch=2,
                 fp32=fp32, chunked=True),
        ]
        # drop no-op repeats (e.g. requested already <= 384)
        seen = set()
        steps = []
        for s in ladder:
            key = (s["input_size"], s["micro_batch"], s["chunked"])
            if key not in seen:
                seen.add(key)
                steps.append(s)

        degraded = []
        for i, s in enumerate(steps):
            def run(s=s):
                def call(fr):
                    return infer(self._model, fr, fps,
                                 input_size=s["input_size"], fp32=s["fp32"],
                                 micro_batch_size=s["micro_batch"])
                if s["chunked"]:
                    # One window at a time bounds live device memory to a
                    # single 32-frame window (reference
                    # engine_backup.py:1010-1352 chunked analog).  Each
                    # chunk's depth is affine-ambiguous, so chunks overlap
                    # by 4 frames and each new chunk is scale/shift-aligned
                    # to the previous one on the shared frames (the
                    # least-squares alignment of infer/stitching.py).
                    ov = 4
                    step = INFER_LEN - ov
                    out = None
                    for j in range(0, len(frames), step):
                        part = call(frames[j:j + INFER_LEN])[0]
                        if out is None:
                            out = part
                        else:
                            shared = min(ov, len(out) - j, len(part))
                            pred = part[:shared].reshape(-1)
                            targ = out[j:j + shared].reshape(-1)
                            scale, shift = compute_scale_and_shift(
                                pred, targ, np.ones_like(pred))
                            part = np.maximum(scale * part + shift, 0.0)
                            out = np.concatenate([out[:j + shared],
                                                  part[shared:]], axis=0)
                        if len(out) >= len(frames):
                            break
                    return out[:len(frames)], fps
                return call(frames)

            try:
                depths, out_fps = run()
                if degraded:
                    logger.warning("job completed DEGRADED via %s "
                                   "(after: %s)", s["name"],
                                   " -> ".join(degraded))
                return depths, out_fps, degraded
            except Exception as e:  # noqa: BLE001 — the ladder filters below
                if not self._is_oom(e):
                    raise
                degraded.append(s["name"])
                if i == len(steps) - 1:
                    logger.error("CUDA OOM on every tier (%s); job fails",
                                 " -> ".join(degraded))
                    e.degraded = degraded
                    raise
                logger.warning("tier %s hit CUDA OOM (%s); degrading to %s",
                               s["name"], type(e).__name__,
                               steps[i + 1]["name"])

    # ------------------------------------------------------------------
    def _load_model(self, encoder: str, metric: bool, checkpoint: str,
                    random_init: bool = False, fp32: bool = False):
        key = (encoder, metric, checkpoint, random_init, fp32)
        if key == self._model_key:
            return
        from vda_tpu_torch.utils.loader import load_model_params

        cfg, model = load_model_params(encoder, metric=metric,
                                       checkpoint=checkpoint,
                                       random_init=random_init,
                                       cast_bf16=not fp32,
                                       device=self.device)
        self._model_key, self._cfg, self._model = key, cfg, model

    # ------------------------------------------------------------------
    def _read_input(self, input_video: str, first_frame: int,
                    last_frame: int):
        from vda_tpu_torch.utils.io import read_video_frames

        if is_image_sequence(input_video):
            frames, numbers = read_image_sequence(input_video, first_frame,
                                                  last_frame)
            fps = 24.0
        else:
            frames, fps = read_video_frames(input_video, process_length=-1)
            n = len(frames)
            lo = max(first_frame - 1, 0)
            hi = min(last_frame, n)
            frames = frames[lo:hi]
            numbers = list(range(first_frame, first_frame + len(frames)))
        return frames, numbers, fps

    # ------------------------------------------------------------------
    def _write_exr_sequence(self, depths: np.ndarray, out_dir: str,
                            shot_name: str, exr_first_frame: int,
                            metadata: Dict, output_format: str = "exr"):
        """Depth sequence writer: EXR Z-channel with PNG fallback
        (reference engine.py:851-959), or explicit 16-bit PNG output
        (reference engine_old.py:169-280 output_format switch)."""
        from vda_tpu_torch.utils.io import save_depth_exr

        os.makedirs(out_dir, exist_ok=True)
        written = []
        d_min, d_max = float(depths.min()), float(depths.max())
        for i, depth in enumerate(depths):
            frame_no = exr_first_frame + i
            d = depth.astype(np.float32)
            if output_format == "png":
                import cv2
                path = os.path.join(out_dir,
                                    f"{shot_name}_depth.{frame_no:04d}.png")
                dn = (d - d_min) / max(d_max - d_min, 1e-8)
                cv2.imwrite(path, (dn * 65535).astype(np.uint16))
            else:
                path = os.path.join(out_dir,
                                    f"{shot_name}_depth.{frame_no:04d}.exr")
                if not save_depth_exr(path, d):
                    import cv2
                    png = path.replace(".exr", ".png")
                    dn = (d - d.min()) / max(d.max() - d.min(), 1e-8)
                    cv2.imwrite(png, (dn * 65535).astype(np.uint16))
                    path = png
                else:
                    meta_mod.embed_exr_metadata(path, metadata)
            written.append(path)
        return written

    # ------------------------------------------------------------------
    def process_job(self, job_data: Dict) -> Dict:
        """Run one job end-to-end; returns a status dict for status.json
        (reference engine.py:577-1041)."""
        try:
            input_video = normalize_path(job_data["input_video"])
            exr_output_dir = normalize_path(job_data["exr_output_dir"])
            first_frame = int(job_data.get("first_frame", 1))
            last_frame = int(job_data.get("last_frame", first_frame))
            metric_depth = bool(job_data.get("metric_depth", False))
            floating_point = job_data.get("floating_point", "half")
            # reference jobs say "float32"/"float16" (engine.py:383,766);
            # "full"/"half" accepted as synonyms
            fp32 = (floating_point in ("full", "float32")) \
                if self.fp32 is None else self.fp32
            ckpt_key = ("metric_video_depth_anything_checkpoint"
                        if metric_depth
                        else "video_depth_anything_checkpoint")
            checkpoint = normalize_path(job_data.get(ckpt_key, ""))
            encoder = detect_encoder(job_data, checkpoint)
            exr_first_frame = int(job_data.get("exr_first_frame",
                                               first_frame))

            self._load_model(encoder, metric_depth, checkpoint,
                             random_init=bool(job_data.get("random_init",
                                                           False)),
                             fp32=fp32)

            frames, numbers, fps = self._read_input(input_video, first_frame,
                                                    last_frame)
            frames, was_resized, orig_size, new_size = \
                resize_frames_to_uhd_max(frames)
            logger.info("read %d frames %s (resized=%s)", len(frames),
                        new_size, was_resized)

            input_size = int(job_data.get("input_size", 518))
            micro_batch = 16
            if bool(job_data.get("auto_strategy", False)):
                from vda_tpu_torch.apps.engine.strategies import (
                    select_strategy)

                strat = select_strategy(
                    source_pixels=frames.shape[1] * frames.shape[2],
                    device=self.device)
                logger.info("auto strategy: %s", strat.name)
                input_size = min(input_size, strat.input_size)
                micro_batch = strat.micro_batch_size
                fp32 = fp32 or strat.fp32
            depths, _fps, degraded_steps = self._infer_with_degradation(
                frames, fps, input_size=input_size, fp32=fp32,
                micro_batch=micro_batch)

            if bool(job_data.get("enable_stabilization", False)):
                from vda_tpu_torch.apps.engine.strategies import (
                    stabilize_depth_sequence)

                depths = stabilize_depth_sequence(
                    depths,
                    temporal_window=int(job_data.get("stabilization_window",
                                                     3)))

            if was_resized and bool(job_data.get("upscale_to_original",
                                                 True)):
                import cv2
                ow, oh = orig_size
                depths = np.stack([
                    cv2.resize(d, (ow, oh), interpolation=cv2.INTER_CUBIC)
                    for d in depths
                ])

            if bool(job_data.get("enable_normalization", False)):
                # the reference normalizes EACH FRAME by its own min/max
                # (engine.py:784-785 loops frames before normalize_depth)
                near = float(job_data.get("normalization_near", 0.0))
                far = float(job_data.get("normalization_far", 1.0))
                invert = bool(job_data.get("invert_depth", False))
                depths = np.stack([
                    normalize_depth(d, near, far, invert) for d in depths
                ])

            shot_name = derive_shot_name(input_video)
            metadata = meta_mod.build_metadata(
                job_data, encoder, checkpoint,
                frame_range=(numbers[0], numbers[-1]))
            if degraded_steps:
                # provenance of the OOM downgrade (reference records its
                # fallback chain in the engine log; we persist it)
                metadata["processing_degradation"] = degraded_steps
            # honor the requested output range (the reference truncates via
            # zip(range(exr_first, exr_last+1), depths))
            if "exr_last_frame" in job_data:
                max_out = int(job_data["exr_last_frame"]) - exr_first_frame + 1
                depths = depths[:max(max_out, 0)]
            written = self._write_exr_sequence(
                depths, exr_output_dir, shot_name, exr_first_frame,
                metadata, output_format=job_data.get("output_format", "exr"))
            meta_mod.write_sidecar(exr_output_dir, metadata)

            from vda_tpu_torch.utils.io import save_video

            if bool(job_data.get("create_source_mp4", False)):
                src_path = os.path.join(exr_output_dir,
                                        f"{shot_name}_src.mp4")
                save_video(frames, src_path, fps=fps)
                meta_mod.embed_mp4_metadata(src_path, metadata)
            if bool(job_data.get("create_depth_vis_mp4", False)):
                vis_dir = normalize_path(
                    job_data.get("depth_mp4_dir", exr_output_dir))
                os.makedirs(vis_dir, exist_ok=True)
                vis_path = os.path.join(vis_dir, f"{shot_name}_vis.mp4")
                save_video(depths, vis_path, fps=fps, is_depths=True)
                meta_mod.embed_mp4_metadata(vis_path, metadata)

            result = {
                "status": "success",
                "message": f"wrote {len(written)} depth frames",
                "output_dir": exr_output_dir,
                "frames": len(written),
                "encoder": encoder,
            }
            if degraded_steps:
                result["degraded"] = degraded_steps
                result["message"] += (
                    f" (degraded after OOM: {' -> '.join(degraded_steps)})")
            return result
        except Exception as e:  # noqa: BLE001 — engine must never crash the queue
            logger.error("job failed: %s", e)
            result = {
                "status": "error",
                "message": str(e),
                "traceback": traceback.format_exc(),
            }
            if hasattr(e, "degraded"):
                result["degraded"] = e.degraded
            return result


def run_queue(comm_dir: str, device: str = "cuda"):
    """File-based job queue (reference engine.py:1349-1464)."""
    os.makedirs(comm_dir, exist_ok=True)
    job_file = os.path.join(comm_dir, "job_queue.json")
    status_file = os.path.join(comm_dir, "status.json")

    def put_status(status: Dict):
        # atomic write: a polling client must never read half-written JSON
        tmp = status_file + ".tmp"
        with open(tmp, "w") as f:
            json.dump(status, f)
        os.replace(tmp, status_file)

    engine = VideoDepthEngine(device=device)
    put_status({"status": "running", "message": "engine ready"})
    logger.info("engine started; polling %s", job_file)
    parse_failures = 0
    while True:
        try:
            if os.path.exists(job_file):
                try:
                    with open(job_file) as f:
                        job_data = json.load(f)
                except json.JSONDecodeError:
                    # likely caught a non-atomic writer mid-write: wait and
                    # retry instead of destroying the half-written job
                    parse_failures += 1
                    if parse_failures >= 10:
                        os.replace(job_file, job_file + ".invalid")
                        put_status({"status": "error",
                                    "message": "job_queue.json never became "
                                    "valid JSON; moved to .invalid"})
                        parse_failures = 0
                    time.sleep(POLL_INTERVAL_S)
                    continue
                parse_failures = 0
                put_status({"status": "processing",
                            "message": "processing video..."})
                result = engine.process_job(job_data)
                put_status(result)
                os.remove(job_file)
            time.sleep(POLL_INTERVAL_S)
        except KeyboardInterrupt:
            put_status({"status": "stopped", "message": "engine stopped"})
            break
        except Exception as e:  # noqa: BLE001
            # keep the job (as a .failed sidecar) instead of destroying it on
            # an unexpected error, and record the traceback for debugging
            import traceback

            put_status({"status": "error", "message": str(e),
                        "traceback": traceback.format_exc()})
            try:
                if os.path.exists(job_file):
                    os.replace(job_file, job_file + ".failed")
            except OSError:
                pass
            time.sleep(POLL_INTERVAL_S)


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser(description="VDA VFX engine (GPU)")
    parser.add_argument("--job", type=str, default=None,
                        help="JSON job file (CLI mode); omit for queue mode")
    parser.add_argument("--communication-dir", type=str,
                        default="./communication")
    parser.add_argument("--device", type=str, default="cuda",
                        help="device the model runs on (cuda, or cpu)")
    args = parser.parse_args(argv)

    if args.job:
        with open(args.job) as f:
            job_data = json.load(f)
        result = VideoDepthEngine(device=args.device).process_job(job_data)
        print(json.dumps(result, indent=2))
        return 0 if result["status"] == "success" else 1
    run_queue(args.communication_dir, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
