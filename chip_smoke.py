"""Smoke run of the PyTorch/CUDA port (vda_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's four hand-written kernels from vda_tpu_torch/csrc and
vda_tpu_torch/ops (nvcc for sm_90a, Triton JIT), checks each against its
plain PyTorch twin at the vitl main-path shapes, drives the offline windowed
main path (``infer_video_depth``) on a vitl model with seeded random weights
over a 54-frame 518x518 video (three windows), counts the kernel launches of
that run, and cross-checks one window's forward against the all-plain path.
Each phase prints one JSON line; any failure raises and exits non-zero.
Without a CUDA device it fails at once and prints no result.  The last
line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

N_FRAMES = 54  # three 32-frame windows: keyframe overlap and stitching run
SIZE = 518
PER_WINDOW = {"K1": 24, "K2": 54, "K3": 2, "K4": 4}  # vitl launches a window
KERNELS = {  # name -> (route, source in the repo, the TPU kernel it replaces)
    "K1": ("cuda", "vda_tpu_torch/csrc/attention_qkv.cu",
           "vda_tpu/ops/pallas_attention.py:361"),
    "K2": ("triton", "vda_tpu_torch/ops/norm_kernel.py",
           "vda_tpu/ops/pallas_norm.py:71"),
    "K3": ("cuda", "vda_tpu_torch/csrc/temporal_block.cu",
           "vda_tpu/ops/pallas_temporal.py:234"),
    "K4": ("cuda", "vda_tpu_torch/csrc/temporal_block.cu",
           "vda_tpu/ops/pallas_temporal.py:162"),
}
# Tolerances, as max |kernel - reference| over max |reference|:
# bf16 K1/K2 against the twin run in fp32 on the same (bf16) inputs: the
# kernel's own output rounding is up to half a bf16 ulp, 2^-9..2^-8 of the
# scale; K1's bound is the repo's bf16-softmax bound (docs/PARITY.md:107).
# bf16 K3/K4 against the bf16 twin, which rounds at the same points: the
# bound the JAX package holds its fused temporal kernels to
# (tests/test_pallas_temporal.py).  fp32 cases: summation order only.
TOL = {"K1": 3.9e-3, "K2": 3.9e-3, "K3": 2e-2, "K4": 2e-2, "fp32": 1e-4}


def emit(**kw):
    print(json.dumps(kw), flush=True)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def time_ms(fn, reps: int = 5) -> float:
    """Mean device time of ``fn`` over ``reps`` runs after a warm-up, by
    CUDA events."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def rel(ref, got) -> tuple[float, float]:
    """(max abs error, max abs error over max |ref|)."""
    ref, got = ref.float(), got.float()
    err = float((ref - got).abs().max())
    return err, err / max(float(ref.abs().max()), 1e-12)


def phase_env():
    nvcc = subprocess.run(
        [shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc", "--version"],
        capture_output=True, text=True, check=True)
    line = smi()
    print(line, flush=True)
    emit(phase="env", nvidia_smi=line, torch=torch.__version__,
         cuda=torch.version.cuda, nvcc=nvcc.stdout.strip().splitlines()[-1],
         device=torch.cuda.get_device_name(0),
         device_count=torch.cuda.device_count(), python=sys.version.split()[0])


def phase_build():
    from vda_tpu_torch.ops import _build, norm_kernel

    t0 = time.perf_counter()
    _build.library()
    nvcc_s = time.perf_counter() - t0
    x = torch.randn(64, 1024, device="cuda", dtype=torch.bfloat16)
    w = torch.ones(1024, device="cuda")
    t0 = time.perf_counter()
    norm_kernel.fused_layer_norm(x, w, torch.zeros_like(w))
    torch.cuda.synchronize()
    emit(phase="build", nvcc_s=round(nvcc_s, 3),
         nvcc_own_s=_build.build_seconds,
         triton_jit_s=round(time.perf_counter() - t0, 3))


def phase_kernels(model):
    """Each kernel against its plain twin at the vitl main-path shapes in
    bf16, and at a small shape in fp32.  Returns per-kernel results."""
    from vda_tpu_torch.ops import attention_kernel as k1
    from vda_tpu_torch.ops import norm_kernel as k2
    from vda_tpu_torch.ops import temporal_kernel as k34

    g = torch.Generator(device="cuda").manual_seed(1)
    bf = torch.bfloat16
    results = {}

    def check(name, shape, kern, twin, twin_inputs_fp32, tol, reps=5):
        got = kern()
        ref = twin(fp32=twin_inputs_fp32)
        torch.cuda.synchronize()
        err, r = rel(ref, got)
        if not torch.isfinite(got).all():
            raise AssertionError(f"{name}: non-finite kernel output")
        ms = time_ms(kern, reps)
        plain_ms = time_ms(lambda: twin(fp32=False), reps)
        res = dict(kernel=name, shape=list(shape), dtype=str(got.dtype),
                   max_abs=err, max_rel=r, tol=tol, ms=ms, plain_ms=plain_ms)
        emit(phase="kernel_vs_plain", **res)
        if not r < tol:
            raise AssertionError(f"{name} {shape}: max_rel {r} >= {tol}")
        return res

    # K1: encoder attention, (B*T, N, 3*H*D) = (32, 1370, 3072), 16 heads
    qkv = torch.randn(32, 1370, 3072, device="cuda", generator=g).to(bf)
    results["K1"] = check(
        "K1", qkv.shape, lambda: k1.flash_attention_qkv(qkv, 16, 0.125),
        lambda fp32: k1.flash_attention_qkv_reference(
            qkv.float() if fp32 else qkv, 16, 0.125), True, TOL["K1"])
    del qkv
    # K2: the encoder LayerNorm (eps 1e-6) and the mm0 ff_norm (eps 1e-5)
    for shape, eps in (((32, 1370, 1024), 1e-6), ((1369, 32, 1024), 1e-5)):
        x = (torch.randn(*shape, device="cuda", generator=g) * 2 + 0.5).to(bf)
        w = torch.randn(1024, device="cuda", generator=g)
        b = torch.randn(1024, device="cuda", generator=g)
        res = check("K2", shape,
                    lambda: k2.fused_layer_norm(x, w, b, eps),
                    lambda fp32: k2.layer_norm_reference(
                        x.float() if fp32 else x, w, b, eps),
                    True, TOL["K2"], reps=20)
        results.setdefault("K2", res)
        results["K2"]["max_abs"] = max(results["K2"]["max_abs"], res["max_abs"])
    # K3: mm3, (5476, 32, 256); K4: mm0's attention sub-block, (1369, 32, 1024)
    mms = model.head.motion_modules
    blk3 = mms[3].temporal_transformer.transformer_blocks[0]
    blk0 = mms[0].temporal_transformer.transformer_blocks[0]
    pe3 = blk3.attention_blocks[0].pos_encoder.pe[0]
    pe0 = blk0.attention_blocks[0].pos_encoder.pe[0]
    h3 = torch.randn(5476, 32, 256, device="cuda", generator=g).to(bf)
    results["K3"] = check(
        "K3", h3.shape, lambda: k34.temporal_block_fused(blk3, h3, pe3, 8),
        lambda fp32: k34.temporal_block_reference(blk3, h3, pe3, 8), False,
        TOL["K3"])
    del h3
    h0 = torch.randn(1369, 32, 1024, device="cuda", generator=g).to(bf)
    a0, n0 = blk0.attention_blocks[0], blk0.norms[0]
    results["K4"] = check(
        "K4", h0.shape, lambda: k34.attention_block_fused(a0, n0, h0, pe0, 8),
        lambda fp32: k34.attention_block_reference(a0, n0, h0, pe0, 8), False,
        TOL["K4"])
    del h0
    # fp32 at small shapes
    qkv = torch.randn(2, 200, 3 * 2 * 64, device="cuda", generator=g)
    check("K1", qkv.shape, lambda: k1.flash_attention_qkv(qkv, 2, 0.125,
                                                          valid_len=150),
          lambda fp32: k1.flash_attention_qkv_reference(qkv, 2, 0.125, 150),
          True, TOL["fp32"])
    x = torch.randn(300, 256, device="cuda", generator=g)
    w = torch.randn(256, device="cuda", generator=g)
    b = torch.randn(256, device="cuda", generator=g)
    check("K2", x.shape, lambda: k2.fused_layer_norm(x, w, b, 1e-5),
          lambda fp32: k2.layer_norm_reference(x, w, b, 1e-5), True,
          TOL["fp32"])
    h = torch.randn(7, 32, 256, device="cuda", generator=g)
    check("K3", h.shape, lambda: k34.temporal_block_fused(blk3, h, pe3, 8),
          lambda fp32: k34.temporal_block_reference(blk3, h, pe3, 8), True,
          TOL["fp32"])
    # K4 in fp32 at mm0's width: part of its working set lives in the
    # device-memory workspace
    h = torch.randn(5, 32, 1024, device="cuda", generator=g)
    check("K4", h.shape, lambda: k34.attention_block_fused(a0, n0, h, pe0, 8),
          lambda fp32: k34.attention_block_reference(a0, n0, h, pe0, 8), True,
          TOL["fp32"])
    return results


def phase_main_path(model):
    """vitl offline windowed inference, bf16, 54 frames of 518x518."""
    import vda_tpu_torch as vt
    from vda_tpu_torch import ops

    frames = (np.random.default_rng(0).random((N_FRAMES, SIZE, SIZE, 3))
              * 255).astype(np.uint8)
    vt.infer_video_depth(model, frames[:32], 30.0)  # warm-up, one window
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    depths, _ = vt.infer_video_depth(model, frames, 30.0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    n_windows = len(range(0, N_FRAMES, 22))
    emit(phase="main_path", frames=N_FRAMES, windows=n_windows,
         wall_s=wall, ms_per_frame=1e3 * wall / N_FRAMES,
         ms_per_window_frame=1e3 * wall / (n_windows * 32),
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         launches=counts, depth_min=float(depths.min()),
         depth_max=float(depths.max()), depth_std=float(depths.std()))
    want = {k: v * n_windows for k, v in PER_WINDOW.items()}
    if counts != want:
        raise AssertionError(f"launch counts {counts} != expected {want}")
    if depths.shape != (N_FRAMES, SIZE, SIZE):
        raise AssertionError(f"depth shape {depths.shape}")
    if not np.isfinite(depths).all() or not depths.std() > 0:
        raise AssertionError("depths not finite or constant")
    return counts, frames


def phase_cross_check(model, frames):
    """One window's forward with the kernels and all-plain, same params and
    input: bench.py's test (max_rel < 1e-2, agree_125 > 0.999)."""
    import vda_tpu_torch as vt
    from vda_tpu_torch.utils.transform import preprocess_frames

    u8 = torch.from_numpy(frames[:32][None]).cuda()
    x = preprocess_frames(u8, (SIZE, SIZE), dtype=torch.bfloat16)
    window_ms = time_ms(lambda: vt.forward(model, x), reps=3)
    ref = vt.forward(model, x).float().cpu().numpy()
    plain_window_ms = time_ms(lambda: vt.forward(model, x, attn_impl="plain"),
                              reps=2)
    got = vt.forward(model, x, attn_impl="plain").float().cpu().numpy()
    floor = max(1e-3, 1e-3 * float(np.abs(ref).max()))
    a, b = np.maximum(ref, floor), np.maximum(got, floor)
    agree = float((np.maximum(a / b, b / a) < 1.25).mean())
    max_rel = float(np.abs(ref - got).max() / max(float(np.abs(ref).max()),
                                                  1e-6))
    emit(phase="cross_check", max_rel=max_rel, agree_125=agree,
         window_ms=window_ms, window_ms_per_frame=window_ms / 32,
         plain_window_ms=plain_window_ms,
         plain_window_ms_per_frame=plain_window_ms / 32)
    if not (max_rel < 1e-2 and agree > 0.999):
        raise AssertionError(f"kernel vs plain forward: max_rel {max_rel}, "
                             f"agree_125 {agree}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 1
    import vda_tpu_torch as vt

    torch.cuda.set_device(0)
    phase_env()
    phase_build()
    model = vt.init_random(vt.get_config("vitl"),
                           torch.Generator(device="cuda").manual_seed(0),
                           device="cuda").requires_grad_(False)
    results = phase_kernels(model)
    counts, frames = phase_main_path(model)
    phase_cross_check(model, frames)
    print(json.dumps({"kernels": [
        {"name": k, "route": KERNELS[k][0], "source": KERNELS[k][1],
         "replaces": KERNELS[k][2], "launches": counts[k],
         "max_abs_err": results[k]["max_abs"], "ms": results[k]["ms"],
         "plain_ms": results[k]["plain_ms"]} for k in KERNELS]}), flush=True)
    print(smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
