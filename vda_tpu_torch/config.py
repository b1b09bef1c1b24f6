"""Central typed config registry.

The reference duplicates dict-literal model configs in every entry point
(reference run.py:45-49, run_streaming.py, app.py, benchmark/infer/infer.py) and
keeps "do not change" inference constants at module scope
(reference video_depth_anything/video_depth.py:29-33).  Here there is exactly one
registry and one set of constants.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

# ---------------------------------------------------------------------------
# Inference protocol constants (reference video_depth.py:30-33).
# These define the overlapping-window algorithm and MUST stay in sync with any
# trained checkpoints: temporal positional encodings are learned for 32 frames.
# ---------------------------------------------------------------------------
INFER_LEN = 32          # frames per window
OVERLAP = 10            # frames shared between consecutive windows
KEYFRAMES = (0, 12, 24, 25, 26, 27, 28, 29, 30, 31)  # prev-window frames reused
INTERP_LEN = 8          # cross-faded frames inside the overlap
ALIGN_LEN = OVERLAP - INTERP_LEN          # = 2, frames used for scale/shift fit
KF_ALIGN_LIST = KEYFRAMES[:ALIGN_LEN]     # = (0, 12)

# Streaming constants (reference video_depth_stream.py:56-60).
STREAM_GAP = (INFER_LEN - OVERLAP) * 2 - 1 - ALIGN_LEN  # = 41
STREAM_MAX_CACHE = STREAM_GAP + 1                        # max cache entries = 42
NUM_CACHE_TENSORS = 8   # 4 temporal modules x 1 block x 2 attention blocks

# Preprocessing constants (reference video_depth.py:77-89).
PATCH_SIZE = 14
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
MAX_ASPECT_RATIO = 1.78  # reference video_depth.py:73-75


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """DINOv2 ViT encoder hyperparameters (reference dinov2.py:339-415)."""

    embed_dim: int
    depth: int
    num_heads: int
    mlp_ratio: float = 4.0
    ffn_layer: str = "mlp"            # "mlp" | "swiglufused"
    img_size: int = 518
    patch_size: int = PATCH_SIZE
    init_values: float = 1.0          # LayerScale on (reference dinov2.py:409)
    interpolate_offset: float = 0.1   # reference dinov2.py:414
    num_register_tokens: int = 0
    # Megatron-style sequence parallelism (training-only, used with
    # tp_layout on a ('data','model') mesh): the residual stream is
    # sharded over tokens in the LayerNorm regions — norm-region activation
    # memory / tp, and the TP collectives become reduce-scatter +
    # all-gather pairs where the backend partitioner supports the rewrite
    # (XLA:CPU keeps all-reduce + slice).  parallel/mesh.py.
    seq_shard: bool = False

    @property
    def num_patches(self) -> int:
        side = self.img_size // self.patch_size
        return side * side

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Full VideoDepthAnything model config (reference run.py:45-49,
    video_depth.py:35-59)."""

    encoder: str
    features: int
    out_channels: Tuple[int, int, int, int]
    intermediate_layer_idx: Tuple[int, int, int, int]
    vit: EncoderConfig
    num_frames: int = INFER_LEN
    pe: str = "ape"
    metric: bool = False
    # tensor-parallel execution (parallel/mesh.py): keeps attention
    # projections as separate per-weight matmuls so GSPMD shards them
    # head-aligned (the single-chip paths fuse q/k/v into one matmul, which
    # is the right MXU shape but the wrong sharding granularity)
    tp_layout: bool = False
    # Temporal motion-module hyperparameters (reference dpt_temporal.py:35-40).
    num_attention_heads: int = 8
    num_transformer_block: int = 1
    num_attention_blocks: int = 2
    norm_num_groups: int = 32

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


_VIT = {
    # reference dinov2.py:339-395
    "vits": EncoderConfig(embed_dim=384, depth=12, num_heads=6),
    "vitb": EncoderConfig(embed_dim=768, depth=12, num_heads=12),
    "vitl": EncoderConfig(embed_dim=1024, depth=24, num_heads=16),
    "vitg": EncoderConfig(embed_dim=1536, depth=40, num_heads=24,
                          ffn_layer="swiglufused"),
}

# reference run.py:45-49 and video_depth.py:49-53
MODEL_CONFIGS = {
    "vits": ModelConfig("vits", 64, (48, 96, 192, 384), (2, 5, 8, 11), _VIT["vits"]),
    "vitb": ModelConfig("vitb", 128, (96, 192, 384, 768), (2, 5, 8, 11), _VIT["vitb"]),
    "vitl": ModelConfig("vitl", 256, (256, 512, 1024, 1024), (4, 11, 17, 23), _VIT["vitl"]),
    # vitg: the reference factory builds the encoder (dinov2.py:381-414,
    # swiglufused FFN) but ships NO head config or checkpoint for it; the
    # head constants here follow the Depth-Anything-family giant convention
    # (features 384, four 1536-channel taps at layers 9/19/29/39) so a vitg
    # checkpoint converts and runs the day one exists
    "vitg": ModelConfig("vitg", 384, (1536, 1536, 1536, 1536), (9, 19, 29, 39),
                        _VIT["vitg"]),
    # development/demo size (no reference counterpart): seconds-fast CPU
    # compiles for tests, the stubbed demo, and docs examples
    "tiny": ModelConfig(
        "tiny", 32, (32, 32, 32, 32), (0, 0, 1, 1),
        EncoderConfig(embed_dim=64, depth=2, num_heads=2, img_size=56)),
}


def get_config(encoder: str, metric: bool = False, **overrides) -> ModelConfig:
    cfg = MODEL_CONFIGS[encoder].replace(metric=metric)
    if overrides:
        cfg = cfg.replace(**overrides)
    return cfg


def checkpoint_name(encoder: str, metric: bool = False) -> str:
    """Canonical checkpoint filename stem (reference run.py:50-54)."""
    stem = "metric_video_depth_anything" if metric else "video_depth_anything"
    return f"{stem}_{encoder}"
