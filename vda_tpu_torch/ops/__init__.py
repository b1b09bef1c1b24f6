"""Ops of the port and the launch counters of its ten kernels."""

from vda_tpu_torch.ops import (
    attention_kernel,
    attn_proj_kernel,
    norm_kernel,
    resize_kernel,
    segment_kernel,
    stream_kernel,
    temporal_kernel,
    tiny_seq_kernel,
)


def launch_counts() -> dict:
    """Kernel launches made so far in this process, by kernel."""
    return {"K1": attention_kernel.launches, "K2": norm_kernel.launches,
            "K3": temporal_kernel.launches_block,
            "K4": temporal_kernel.launches_attn,
            "K5": tiny_seq_kernel.launches, "K6": stream_kernel.launches,
            "K7": attn_proj_kernel.launches, "K8": segment_kernel.launches,
            "K9": attention_kernel.launches_packed,
            "K10": resize_kernel.launches}


def reset_launch_counts() -> None:
    attention_kernel.launches = 0
    attention_kernel.launches_packed = 0
    attn_proj_kernel.launches = 0
    norm_kernel.launches = 0
    resize_kernel.launches = 0
    segment_kernel.launches = 0
    temporal_kernel.launches_block = 0
    temporal_kernel.launches_attn = 0
    tiny_seq_kernel.launches = 0
    stream_kernel.launches = 0
