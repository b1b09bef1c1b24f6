"""Ops of the port and the launch counters of its fourteen kernels."""

from vda_tpu_torch.ops import (
    attention_kernel,
    attn_proj_kernel,
    norm_kernel,
    quant,
    resize_kernel,
    segment_kernel,
    stream_kernel,
    temporal_kernel,
    tiny_seq_kernel,
)


def _probes():
    # the measurement kernels' wrappers live beside their probes, which
    # import this package: imported here, at call time
    from vda_tpu_torch.probes import (bench_attn_variants, bench_int8,
                                      probe_stream_kernel)

    return bench_attn_variants, bench_int8, probe_stream_kernel


def launch_counts() -> dict:
    """Kernel launches made so far in this process, by kernel."""
    k12, k13, k14 = _probes()
    return {"K1": attention_kernel.launches, "K2": norm_kernel.launches,
            "K3": temporal_kernel.launches_block,
            "K4": temporal_kernel.launches_attn,
            "K5": tiny_seq_kernel.launches, "K6": stream_kernel.launches,
            "K7": attn_proj_kernel.launches, "K8": segment_kernel.launches,
            "K9": attention_kernel.launches_packed,
            "K10": resize_kernel.launches, "K11": quant.launches,
            "K12": k12.launches, "K13": k13.launches, "K14": k14.launches}


def reset_launch_counts() -> None:
    attention_kernel.launches = 0
    attention_kernel.launches_packed = 0
    attention_kernel.launches_by_loop = dict.fromkeys(
        attention_kernel.launches_by_loop, 0)
    attn_proj_kernel.launches = 0
    attn_proj_kernel.launches_by_loop = dict.fromkeys(
        attn_proj_kernel.launches_by_loop, 0)
    norm_kernel.launches = 0
    quant.launches = 0
    quant.gemm_launches_by_loop = dict.fromkeys(quant.gemm_launches_by_loop,
                                                0)
    resize_kernel.launches = 0
    segment_kernel.launches = 0
    segment_kernel.launches_by_loop = dict.fromkeys(
        segment_kernel.launches_by_loop, 0)
    temporal_kernel.launches_block = 0
    temporal_kernel.launches_attn = 0
    temporal_kernel.launches_by_loop = {
        k: dict.fromkeys(v, 0)
        for k, v in temporal_kernel.launches_by_loop.items()}
    tiny_seq_kernel.launches = 0
    tiny_seq_kernel.launches_by_loop = dict.fromkeys(
        tiny_seq_kernel.launches_by_loop, 0)
    stream_kernel.launches = 0
    stream_kernel.launches_by_loop = dict.fromkeys(
        stream_kernel.launches_by_loop, 0)
    for probe in _probes():
        probe.launches = 0
    k12 = _probes()[0]
    k12.launches_by_loop = dict.fromkeys(k12.launches_by_loop, 0)
