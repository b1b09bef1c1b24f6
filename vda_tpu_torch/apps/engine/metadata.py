"""Provenance metadata embedding / reading for engine outputs.

A copy of ``apps/engine/metadata.py`` for the port (which imports nothing
of the JAX side), held to it by ``tests/test_torch_apps_engine.py``;
the provenance's ``"software"`` names the port.

Rebuild of reference external_engine/metadata_embedder.py and
metadata_reader.py: builds a provenance dict (model, checkpoint, frame ranges,
normalization settings, workflow), embeds it into EXR headers (OpenEXR) and
MOV/MP4 containers (ffmpeg -metadata -c copy), and always writes a sidecar
``metadata.json``.  Backends degrade gracefully: without OpenEXR or an ffmpeg
binary the sidecar remains the source of truth.
"""

from __future__ import annotations

import datetime
import json
import os
import shutil
import subprocess
from typing import Dict, Optional

METADATA_PREFIX = "vda"


def build_metadata(job_data: Dict, encoder: str, checkpoint_path: str,
                   frame_range=None, extra: Optional[Dict] = None) -> Dict:
    """Provenance dict (reference metadata_embedder.py:23-90)."""
    meta = {
        "software": "vda_tpu_torch",
        "workflow": "video_depth_generation",
        "model": f"video_depth_anything_{encoder}",
        "encoder": encoder,
        "checkpoint": os.path.basename(checkpoint_path or ""),
        "metric_depth": bool(job_data.get("metric_depth", False)),
        "floating_point": job_data.get("floating_point", "half"),
        "input_video": job_data.get("input_video", ""),
        "first_frame": job_data.get("first_frame"),
        "last_frame": job_data.get("last_frame"),
        "exr_first_frame": job_data.get("exr_first_frame"),
        "exr_last_frame": job_data.get("exr_last_frame"),
        "enable_normalization": bool(job_data.get("enable_normalization",
                                                  False)),
        "normalization_near": job_data.get("normalization_near"),
        "normalization_far": job_data.get("normalization_far"),
        "invert_depth": bool(job_data.get("invert_depth", False)),
        "created": datetime.datetime.now().isoformat(),
    }
    if frame_range is not None:
        meta["processed_frames"] = list(frame_range)
    if extra:
        meta.update(extra)
    return meta


def write_sidecar(output_dir: str, metadata: Dict,
                  name: str = "metadata.json") -> str:
    """Sidecar JSON (reference metadata_embedder.py:229-248)."""
    os.makedirs(output_dir, exist_ok=True)
    path = os.path.join(output_dir, name)
    with open(path, "w") as f:
        json.dump(metadata, f, indent=2, default=str)
    return path


def embed_exr_metadata(exr_path: str, metadata: Dict) -> bool:
    """Rewrite an EXR with metadata in its header
    (reference metadata_embedder.py:91-133).  Needs OpenEXR."""
    try:
        import Imath  # noqa: F401
        import OpenEXR
    except ImportError:
        return False
    try:
        src = OpenEXR.InputFile(exr_path)
        header = src.header()
        channels = {name: src.channel(name) for name in header["channels"]}
        for k, v in metadata.items():
            header[f"{METADATA_PREFIX}/{k}"] = str(v).encode()
        tmp = exr_path + ".tmp"
        out = OpenEXR.OutputFile(tmp, header)
        out.writePixels(channels)
        out.close()
        src.close()
        os.replace(tmp, exr_path)
        return True
    except Exception:
        return False


def embed_mp4_metadata(mp4_path: str, metadata: Dict) -> bool:
    """Container-level metadata via ffmpeg stream copy
    (reference metadata_embedder.py:135-228)."""
    ffmpeg = shutil.which("ffmpeg")
    if ffmpeg is None:
        return False
    tmp = mp4_path + ".tmp.mp4"
    cmd = [ffmpeg, "-y", "-i", mp4_path, "-c", "copy", "-movflags",
           "use_metadata_tags"]
    for k, v in metadata.items():
        cmd += ["-metadata", f"{METADATA_PREFIX}_{k}={v}"]
    cmd.append(tmp)
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
        os.replace(tmp, mp4_path)
        return True
    except Exception:
        if os.path.exists(tmp):
            os.remove(tmp)
        return False


# ---------------------------------------------------------------------------
# readers (reference metadata_reader.py:12-129)
# ---------------------------------------------------------------------------

def read_sidecar(output_dir: str, name: str = "metadata.json") -> Optional[Dict]:
    path = os.path.join(output_dir, name)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def read_exr_metadata(exr_path: str) -> Optional[Dict]:
    try:
        import OpenEXR
    except ImportError:
        return None
    try:
        src = OpenEXR.InputFile(exr_path)
        header = src.header()
        prefix = f"{METADATA_PREFIX}/"
        out = {}
        for k, v in header.items():
            if k.startswith(prefix):
                out[k[len(prefix):]] = (v.decode()
                                        if isinstance(v, bytes) else str(v))
        src.close()
        return out or None
    except Exception:
        return None


def read_mp4_metadata(mp4_path: str) -> Optional[Dict]:
    ffprobe = shutil.which("ffprobe")
    if ffprobe is None:
        return None
    try:
        out = subprocess.run(
            [ffprobe, "-v", "quiet", "-print_format", "json",
             "-show_format", mp4_path],
            check=True, capture_output=True, timeout=60)
        tags = json.loads(out.stdout).get("format", {}).get("tags", {})
        prefix = f"{METADATA_PREFIX}_"
        found = {k[len(prefix):]: v for k, v in tags.items()
                 if k.startswith(prefix)}
        return found or None
    except Exception:
        return None
