"""Smoke run of the PyTorch/CUDA port (vda_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's fourteen hand-written kernels from vda_tpu_torch/csrc
and vda_tpu_torch/ops (nvcc for sm_90a, one process a source, and the
Triton JIT), checks each against its plain PyTorch twin at the shapes its
main paths give it, with its time beside the least time the card could
take and beside one PyTorch library call where one computes the same
function (and the gradients of the two differentiable kernels, K2 and K10,
against autograd through their plain forms), then drives each main path
with every launch counter set to 0 just before it and read just after:

  * ``weights``: vitl through ``load_model_params(random_init=True)``
    (the smoke run's seeded weights, cast to bf16 once by JAX's rule)
    against the same weights uncast: a window and the first 4 stream steps
    bit-identical; the cast model written as the JAX package's ``.npz``
    params (``save_params_npz``) and loaded back by
    ``load_model_params(checkpoint="x.npz")``, every tensor and the window
    bit-identical; then each model's parameter casts, kernels and host ms
    of a steady stream step and its window's peak memory; the window,
    stream and fused paths below run the cast model;
  * ``main_path``: offline windowed ``infer_video_depth`` on a vitl model
    with seeded random weights over a 54-frame 518x518 video (three
    windows), then one window's forward against the all-plain path;
  * ``stream``: vitl ``StreamingDepth.submit`` over 48 frames of 518x518
    (past eviction onset at step 11 and ring-row reuse at step 45), without
    and with ``ctx_kernel`` (which reads its cache in place from step 42),
    launch counts asserted step by step, the two held to each other and
    the first frames to an all-plain stream;
  * ``stream_direct``: vitl ``StreamingDepth`` over 72 steps of 518x518
    (the 54 frames, then their first 18 again), three streams stepped in
    turns: the default kv stream, ``ctx_kernel`` (K6 over the 31 gathered
    rows, then from step 42 over the 45-row cache buffers in place with 31
    rows valid) and the same ``ctx_kernel`` stream with its in-place read
    switched off (K6 over the gathered rows at every step): launches and
    K6's rows asserted step by step, the in-place read bit-identical to
    the gathering stream before step 42 and within 2e-2 of it after (the
    largest gap printed over all steps and over the in-place steps alone),
    ``order`` equal; the cache bytes, three steps of each under
    torch.profiler, and an in-place ``submit_group`` of 4 against 4
    submits (the cache bit for bit);
  * ``vits_window``: one 1x32x518x518 vits forward against the all-plain
    path;
  * ``vitg_window``: one 1x32x518x518 forward of a seeded vitg
    (``load_model_params("vitg", random_init=True)``: the SwiGLU encoder,
    24 heads, motion modules at C 1536 on K5 and C 384 on K3) against the
    all-plain path, launches and their loops asserted, peak memory; the
    model freed after;
  * ``rope``: vitl with RoPE motion modules (``pe="rope"``): a window
    against the all-plain path (K5 in every attention sub-block, K3/K4
    off), then 48 ``submit`` steps without and with ``ctx_kernel`` (K6
    off: its gate is APE's), the flavours held to each other and the first
    frames to an all-plain stream;
  * ``window_batch``: the vitl video through ``infer_video_depth(
    window_batch=2)`` against ``window_batch=1`` in turns, each forward's
    launches those of one window;
  * ``fused_window``: the same vitl video through ``infer_video_depth(
    fuse_proj=True, resize_kernel=True)`` (K7 and K10), then one window
    against the default-kernel and the all-plain forwards, the two timed
    in turns;
  * ``fused_stream``: 8 vitl ``StreamingDepth(fuse_proj=True)`` steps
    against the default stream, counts asserted step by step;
  * ``cross_attention``: ``models.cross_attention`` at vitl encoder widths,
    self-attention through K9 against ``impl="plain"``, and a cross call
    (M != N) that K9's gate refuses;
  * ``nested_block``: ``block_apply_nested`` on a vitl block over DINOv2's
    multi-crop batch (32 images: 64 global crops of 257 tokens, 256 local
    crops of 50), bf16, through K8, against per-sample ``block_apply`` and
    ``impl="plain"``;
  * ``train``: the training slice's main path, ``parallel.trainer.train``
    on vitl, fp32, 6 steps of 1x8x518x518 synthetic clips (remat,
    warmup-cosine schedule, clipping, accumulation 2, augmentation,
    prefetch, a metrics JSONL), K2 launches asserted per step and no
    attention or temporal kernel; then a checkpoint resumed bit for bit,
    and one step from the seeded initial state with the kernels against
    the all-plain step;
  * ``apps``: the entry points (``vda_tpu_torch.apps``), each ``main(argv)``
    in this process at vitl width with seeded weights (``--random-init``):
    the offline CLI on 40 frames of 518x518 (two windows) with
    ``--save_npz``, bit-identical to ``infer_video_depth`` on the model it
    loaded (K1 24, K2 54, K3 2, K4 4 a window, on the Hopper code), then
    with ``--encoder vitg`` and with ``--window-batch 2``, each
    bit-identical to its direct call; the
    streaming CLI on 12 frames at ``--lookahead`` 1 (depths and cache
    bit-identical to a ``submit`` loop) and 4 (``submit_group``: the cache
    bit-identical, depths within 1e-2), then 4 ``submit`` calls against one
    group of 4 in turns, ms a frame, and on 48 frames with
    ``VDA_STREAM_DIRECT=1`` (depths and cache bit-identical to the
    ``ctx_kernel`` stream the knob builds); ``benchmark_infer`` on one 8-frame
    480x640 scene (fp32, bit-identical to the direct call); the train CLI
    (2 synthetic steps at 266, ``--export-pth`` reloaded by
    ``load_model_params`` bit for bit); the engine's degradation ladder at
    its strategy (``cuda_direct``, not degraded, bit-identical).  Decode and
    encode functions whose library the card lacks are replaced by numpy
    stand-ins on seeded frames, named on the line;
  * ``int8``: the W8A8 linear, ``ops.quant.int8_linear`` (K11) at the
    encoder's qkv shape on vitl's first qkv weight, bf16 and fp32
    activations, bit-identical with its twin and within 2e-2 of the bf16
    linear of the float weights;
  * ``probes``: the measurement entry points' runs
    (``vda_tpu_torch.probes``): every K12 variant of K1 at (32, 1370,
    3072) (all but ``mma_sync`` on the Hopper loop), K13 and K11's
    dynamic-quant arm at (45056, 1024) @ (1024, 3072), K14's four stages
    and K6's two, the design steps and stages of K3/K4's Hopper chain at
    vitl's four temporal shapes, and the design steps of K6's Hopper loop
    (the four stream shapes), K10's Hopper kernel (the two tail shapes)
    and K5's and K8's Hopper code (the vits window's and the first stream
    step's K5 shapes, K8's multi-crop and 32 x 1370), each arm against its
    twin;
  * ``host_sync``: a steady ``StreamingDepth.submit`` with the device held
    by ``torch.cuda._sleep`` (~50 ms, or three times an idle submit's host
    time if longer) returns in less host time than the sleep (vits; vitl's
    numbers printed beside), and a steady vitl submit, a vitl window
    ``forward`` and a steady vitl ``ctx_kernel`` submit that reads its
    cache in place make no synchronising call under
    ``torch.cuda.set_sync_debug_mode("error")``.

K1 and K9 (bf16, head width 64) run the Hopper loop
(csrc/flash_attention_sm90.cuh: TMA, wgmma, warp specialisation): their
``kernel_vs_plain`` lines carry the old mma.sync loop's time on the same
values (``mma_sync_ms``, K12 ``mma_sync``) and the largest |new - old|,
and every K1 launch of the vitl window, the vitl stream and the vits
window is asserted to have gone through it
(``attention_kernel.launches_by_loop``).  K12's ``full`` runs K1's own
configuration of that loop: its line carries the old loop's time, and it
is asserted bit-identical with K1.  K7 in bf16 runs the Hopper kernel of
csrc/attention_heads_sm90.cuh: its lines, at the fused window's (32, 1370,
3072) and the fused stream step's (1, 1370, 3072), carry the split path's
time (``split_ms``), and every K7 launch of phases ``kernels``,
``fused_window`` and ``fused_stream`` is asserted to have run it
(``attn_proj_kernel.launches_by_loop``).
K3 and K4 in bf16 run Hopper code: K3 at vitl's width (C 256, 8 heads, T
32) the fused kernel of csrc/temporal_fused_sm90.cuh (the whole block on
64-row tiles in shared memory, the weights streamed by TMA to cluster
pairs), every other shape the chain of csrc/temporal_sm90.cuh (an LN pass,
the products on the GEMM mainloop of csrc/gemm_sm90.cuh with bias, residual
and GEGLU epilogues, a per-sequence tensor-core attention): their lines, at
vitl's mm3 and mm2 (K3) and mm0 and mm1 (K4) shapes, carry the time of the
kernels they replaced on the same values (``old_ms``, the largest |new -
old| beside it) and of the split path of library calls (``split_ms``);
every K3/K4 launch of phases ``main_path``, ``vits_window`` and
``fused_window`` is asserted to have run the Hopper code
(``temporal_kernel.launches_by_loop``), the fp32 cases to stay on the old
kernels, and phase ``probes`` runs the design steps and the chain's stages
(``probes.bench_temporal_sm90``) against their twins.
K6 in bf16 runs the Hopper loop of csrc/stream_kv_sm90.cuh: its lines, at
the four stream shapes (mm0-mm3), carry the old kernel's time on the same
values (``old_ms``, the largest |new - old| beside it) and the split path
of library calls (``split_ms``); the fp32 case stays on the old kernel;
every K6 launch of phases ``kernels``, ``stream``, ``stream_direct``
and ``probes`` is asserted on the loop it should run
(``stream_kernel.launches_by_loop``), and the loop repeats bit for bit;
K6 is also checked at the whole 45-row buffers with the 31 scattered rows
of the first in-place step valid, as the stream reads them.
K10 runs csrc/resize_sm90.cuh: its
lines carry the old kernel's time (``old_ms``), bit-exact with the twin
and with itself over 30 repeats.
K5 in bf16 runs the Hopper code of csrc/tiny_seq_sm90.cuh (T >= 2: TMA
boxes of a (sequence, head group) item into a ring of two stages, both
products on mma.sync; T = 1: a warp per 256 columns of a position), K8 in
bf16 at head width 64 that of csrc/segment_sm90.cuh (K1's TMA/wgmma loop
over a host work table of query-tile passes): their lines carry the old
kernel's time on the same values (``old_ms``, the largest |new - old|
beside it; K8 at 32 x 1370 with K1's time too), K5's T = 1 lines an empty
kernel's held time on the same grid (``floor_ms``); each repeats bit for
bit over 30 calls, the fp32 cases stay on the old kernels, every bf16 K5
launch of phases ``kernels``, ``stream`` (step 0), ``vits_window`` and
``fused_stream`` and every bf16 K8 launch of ``kernels`` and
``nested_block`` is asserted on "sm90" (``tiny_seq_kernel`` /
``segment_kernel.launches_by_loop``), and phase ``probes`` runs their
design steps (``probes.bench_short_attn_sm90``) against their twins.
K14 runs the Hopper kernel of csrc/stream_probe_sm90.cuh (a cluster of up
to 8 blocks a (group, head), both products on mma.sync, the row maxima
exchanged over distributed shared memory): its lines, one a stage, carry
the held time (``held_ms``) beside, held the same way, the first build on
the same values (``old_ms``), the kernel's loads alone (``loads_ms``) and
an empty kernel on its grid and cluster shape (``floor_ms``), and the
stage's own bound (only the operands its features read); each stage
repeats bit for bit over 30 calls, and every
K14 launch of phases ``kernels`` and ``probes`` is asserted on "sm90"
(``probe_stream_kernel.launches_by_loop``).
K11 and K13 run the Hopper GEMM mainloop (csrc/gemm_sm90.cuh): their lines
carry the old mma.sync loop's time on the same values (``mma_sync_ms``,
``probes.bench_gemm_sm90``'s ``mma_sync`` step) and the largest |new -
old|, K11 is checked at a ragged shape too, and every K11/K13 launch of
phases ``kernels``, ``int8`` and ``probes`` is asserted to have run it
(``quant.gemm_launches_by_loop``).

Each phase prints one JSON line; any failure raises and exits non-zero.
Without a CUDA device it fails at once and prints no result.  The last
lines are the kernels line, the card's nvidia-smi name and power limit, and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import copy
import gc
import json
import os
import shutil
import subprocess
import sys
import time
import weakref

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

N_FRAMES = 54  # three 32-frame windows: keyframe overlap and stitching run
SIZE = 518
N_STREAM = 48  # STREAM_MAX_CACHE + 6 streaming steps
ZERO = {f"K{i}": 0 for i in range(1, 15)}
# vitl launches a window: K2 is two norms a block, four tap norms, and the
# ff_norm of mm0/mm1 (K4 takes their attention sub-blocks, K3 whole blocks
# of mm2/mm3)
PER_WINDOW = {**ZERO, "K1": 24, "K2": 54, "K3": 2, "K4": 4}
# vitl launches a streaming step: K2 is 48 block norms + 4 tap norms + 3
# per motion module (two attention sub-blocks and the feed-forward, all at
# widths % 128; the caches keep K3/K4 off); K5 takes all 8 attention
# sub-blocks of the first step, K6 those of every later step with ctx_kernel
PER_STEP = {**ZERO, "K1": 24, "K2": 64}
# vits launches a window: K2 24 block norms + 4 tap norms (its temporal
# widths 192 and 64 are not multiples of 128, mm1's norms are inside K3);
# K5 the attention sub-blocks of mm0, mm2, mm3
PER_VITS_WINDOW = {**ZERO, "K1": 12, "K2": 28, "K3": 1, "K5": 6}
# with fuse_proj and resize_kernel: K7 takes every block's attention half
# (both norms stay K2), K10 the two upsamples of each 16-frame tail chunk
PER_FUSED_WINDOW = {**PER_WINDOW, "K1": 0, "K7": 24, "K10": 4}
# vitg launches a window: K1 its 40 blocks (24 heads of 64); K2 80 block
# norms + 4 tap norms + 3 a motion module at C 1536 (mm0/mm1: K4's gate
# stops at 1024, so K5 takes their attention sub-blocks, head width 192);
# K3 the whole blocks of mm2/mm3 (C 384, 8 heads of 48)
PER_VITG_WINDOW = {**ZERO, "K1": 40, "K2": 90, "K3": 2, "K5": 4}
# vitl with RoPE: the JAX gates keep K3, K4 and K6 to APE, so K5 takes all
# 8 attention sub-blocks of a window and K2 the 3 norms of every module
PER_ROPE_WINDOW = {**ZERO, "K1": 24, "K2": 64, "K5": 8}
WINDOW_BATCH = 2  # windows a forward of phase window_batch
# phase stream_direct: 72 steps (the 54 frames, then their first 18
# again), past the first step whose 31 context entries sit in 31 distinct
# rows (42), from which the ctx_kernel stream reads its cache in place
N_DIRECT_STEPS = 72
DIRECT_FROM = 42
# positions x width summed over vitl's four motion modules at 518x518
# (37^2, 19^2, 37^2 and 74^2 positions at 1024, 1024, 256 and 256): a
# cache row of the 16 bf16 buffers (k and v of two attention sub-blocks a
# module) is 8 bytes x this, 28,190,720
STREAM_POS_WIDTH = (37 * 37 * 1024 + 19 * 19 * 1024 + 37 * 37 * 256
                    + 74 * 74 * 256)
N_FUSED_STREAM = 8
KERNELS = {  # name -> (route, source in the repo, the TPU kernel it replaces)
    "K1": ("cuda", "vda_tpu_torch/csrc/attention_qkv.cu",
           "vda_tpu/ops/pallas_attention.py:361"),
    "K2": ("triton", "vda_tpu_torch/ops/norm_kernel.py",
           "vda_tpu/ops/pallas_norm.py:71"),
    "K3": ("cuda", "vda_tpu_torch/csrc/temporal_fused_sm90.cuh",
           "vda_tpu/ops/pallas_temporal.py:234"),
    "K4": ("cuda", "vda_tpu_torch/csrc/temporal_block.cu",
           "vda_tpu/ops/pallas_temporal.py:162"),
    "K5": ("cuda", "vda_tpu_torch/csrc/tiny_seq_sm90.cuh",
           "vda_tpu/ops/pallas_attention.py:517"),
    "K6": ("cuda", "vda_tpu_torch/csrc/stream_kv_sm90.cuh",
           "vda_tpu/ops/pallas_stream.py:119"),
    "K7": ("cuda", "vda_tpu_torch/csrc/attention_proj.cu",
           "vda_tpu/ops/pallas_attention.py:274"),
    "K8": ("cuda", "vda_tpu_torch/csrc/segment_sm90.cuh",
           "vda_tpu/ops/pallas_attention.py:641"),
    "K9": ("cuda", "vda_tpu_torch/csrc/attention_qkv.cu",
           "vda_tpu/ops/pallas_attention.py:112"),
    "K10": ("cuda", "vda_tpu_torch/csrc/resize_sm90.cuh",
            "vda_tpu/ops/pallas_resize.py:134"),
    "K11": ("cuda", "vda_tpu_torch/csrc/int8_matmul.cu",
            "vda_tpu/ops/quant.py:66"),
    "K12": ("cuda", "vda_tpu_torch/csrc/attention_variants.cu",
            "scripts/bench_attn_variants.py:85"),
    "K13": ("cuda", "vda_tpu_torch/csrc/int8_matmul.cu",
            "scripts/bench_int8_pallas.py:34"),
    "K14": ("cuda", "vda_tpu_torch/csrc/stream_probe.cu",
            "scripts/probe_stream_kernel.py:61"),
}
# Tolerances, as max |kernel - reference| over max |reference|:
# bf16 K1/K2/K5/K6 against the twin run in fp32 on the same (bf16) inputs:
# the kernel's own output rounding is up to half a bf16 ulp, 2^-9..2^-8 of
# the scale, and the softmax kernels round exp to bf16 as well; their bound
# is the repo's bf16-softmax bound (docs/PARITY.md:107).  (K6's function
# adds the encodings in the working dtype, so its fp32 run takes the rows
# with the encodings added in bf16.)  bf16 K3/K4 against the bf16 twin,
# which rounds at the same points: the bound the JAX package holds its fused
# temporal kernels to (tests/test_pallas_temporal.py).  bf16 K9 as K1.
# bf16 K7 against the bf16 twin: the bound the JAX package holds its fused
# kernel to (tests/test_attn_fuse_proj.py).  K10 is bit-exact with its twin
# (two exact products, one rounding).  bf16 K8 as K1; fp32 K8 within 1e-5
# (summation order of the softmax only).  fp32 cases: summation order only.
# Gradients of K2 and K10: their backward is autograd through the plain
# form on the same saved inputs, so the same gradient up to reduction
# order: 1e-5 of the gradient's scale.  K11 is bit-exact with its twin
# (exact int32 sums, the epilogue's steps rounded alike), K13 int8 exact;
# K13 bf16 against the unrounded fp32 product, 2^-8 (one output rounding);
# K12 and K14 against their twins' unrounded outputs as K1.  The W8A8 error
# of int8_linear against the bf16 linear of the float weights: 2e-2
# (tests/test_quant.py's bound).
TOL = {"K1": 3.9e-3, "K2": 3.9e-3, "K3": 2e-2, "K4": 2e-2, "K5": 3.9e-3,
       "K6": 3.9e-3, "K7": 2e-2, "K8": 3.9e-3, "K9": 3.9e-3, "K10": 1e-12,
       "K11": 1e-12, "K12": 3.9e-3, "K13": 1e-12, "K13_bf16": 2.0 ** -8,
       "K14": 3.9e-3, "w8a8": 2e-2, "fp32": 1e-4, "K8_fp32": 1e-5,
       "grad": 1e-5}
# DINOv2's multi-crop batch (its NestedTensorBlock's input): per image 2
# global crops of 224 (257 tokens) and 8 local crops of 98 (50 tokens)
MULTI_CROP = (32, (2, 257), (8, 50))
N_TRAIN_STEPS = 6
TRAIN_CLIP = (1, 8, SIZE)  # B, T, side: scripts/train_throughput.py's shape
N_APPS = 40  # the offline CLI's and the engine's video: two windows
N_APP_STREAM = 12  # a first frame, two groups of 4 and 3 frames left over
N_APP_DIRECT = 48  # the streaming CLI with VDA_STREAM_DIRECT=1: 6 in place
APP_SCENE = (8, 480, 640)  # benchmark_infer's scene: ScanNet's frame size
APP_TRAIN_SIZE = 266  # the train CLI's default --size
# the host libraries of the entry points' decode, encode and demo
HOST_LIBS = ("cv2", "imageio", "matplotlib", "OpenEXR", "gradio")
# vitl K2 launches of a stream step: the encoder's 48 block and 4 tap norms
# (once a group with submit_group), and the motion modules' 12
ENC_K2, MM_K2 = 52, 12
# The least time of a call: the larger of its bytes (each input read once,
# each output written once) over the memory rate and its operations over
# the peak rate for their type (NVIDIA H100 SXM data sheet, dense).
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {torch.bfloat16: 989e12, torch.float32: 67e12,
              torch.int8: 1979e12}


def emit(**kw):
    print(json.dumps(kw), flush=True)


def cache_bytes_want(rows: int) -> int:
    """Bytes of a vitl 518x518 bf16 kv cache of ``rows`` rows a buffer."""
    return 8 * rows * STREAM_POS_WIDTH


def direct_rows() -> list:
    """The buffer rows of the 31 context entries of the first direct step
    (DIRECT_FROM), by the stream's own bookkeeping."""
    from vda_tpu_torch.infer import streaming

    order = [0] * streaming.INFER_LEN
    streaming._evict(0, order)
    for step in range(1, DIRECT_FROM + 1):
        ctx, _ = streaming._advance_bookkeeping(step, order)
    rows = [streaming._row(i) for i in ctx]
    if len(set(rows)) != len(rows):
        raise AssertionError(f"step {DIRECT_FROM}: context rows {rows} "
                             "not distinct")
    return rows


@contextlib.contextmanager
def knob_scope(env: dict):
    """Sets the knobs ``env`` for the block and restores the environment
    after it."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


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


def bound(n_bytes: float, n_ops: float, dtype) -> tuple[float, str]:
    """(least ms of the call, "bytes" or "operations": which binds)."""
    t_bytes = n_bytes / HBM_BYTES_S
    t_ops = n_ops / PEAK_OPS_S[dtype]
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def agreement(ref, got) -> tuple[float, float]:
    """bench.py's test: (max_rel, share of pixels within a factor 1.25)."""
    ref, got = ref.float().cpu().numpy(), got.float().cpu().numpy()
    floor = max(1e-3, 1e-3 * float(np.abs(ref).max()))
    a, b = np.maximum(ref, floor), np.maximum(got, floor)
    agree = float((np.maximum(a / b, b / a) < 1.25).mean())
    return (float(np.abs(ref - got).max() / max(float(np.abs(ref).max()),
                                                1e-6)), agree)


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


def by_loop_ok(counts) -> bool:
    """Every K1/K9 launch since the counters were reset went through the
    Hopper loop."""
    from vda_tpu_torch.ops import attention_kernel

    return attention_kernel.launches_by_loop == {
        "sm90": counts["K1"] + counts["K9"], "sm80": 0}


def k7_by_loop_ok(counts) -> bool:
    """Every K7 launch since the counters were reset ran the Hopper
    kernel."""
    from vda_tpu_torch.ops import attn_proj_kernel

    return attn_proj_kernel.launches_by_loop == {"sm90": counts["K7"],
                                                 "sm80": 0}


def temporal_by_loop_ok(counts) -> bool:
    """Every K3/K4 launch since the counters were reset (all bf16 at
    head widths 32, 48 and 128 on the model paths) ran the Hopper chain."""
    from vda_tpu_torch.ops import temporal_kernel

    return temporal_kernel.launches_by_loop == {
        "K3": {"sm90": counts["K3"], "sm80": 0},
        "K4": {"sm90": counts["K4"], "sm80": 0}}


def k5_k8_by_loop_ok(counts, k5_loops=None) -> bool:
    """Every K5 and K8 launch since the counters were reset (bf16 on every
    path) ran the Hopper code; ``k5_loops``: K5's launches by loop where
    ``tiny_seq_kernel.loop_of`` sends a shape elsewhere (vitg's head width
    192)."""
    from vda_tpu_torch.ops import segment_kernel, tiny_seq_kernel

    want = {"sm90": counts["K5"], "sm80": 0} if k5_loops is None \
        else {"sm90": 0, "sm80": 0, **k5_loops}
    return (tiny_seq_kernel.launches_by_loop == want
            and segment_kernel.launches_by_loop == {"sm90": counts["K8"],
                                                    "sm80": 0})


def vitg_k5_loops(n_windows: int = 1) -> dict:
    """K5's launches by loop in ``n_windows`` vitg windows: its 4 a window
    at (1369 | 361, 32, 1536), all on the code the C entry point reports
    for head width 192."""
    from vda_tpu_torch.ops import tiny_seq_kernel as k5

    return {k5.loop_of(torch.bfloat16, 32, 1536, 8):
            PER_VITG_WINDOW["K5"] * n_windows}


def random_temporal_block(c: int, g):
    """A motion module's transformer block at width ``c`` (8 heads of
    c / 8, APE) on the card, its weights drawn from ``g`` as ``init_random``
    draws a model's: fan-in uniform linears, unit LayerNorms."""
    import vda_tpu_torch as vt
    from vda_tpu_torch.models.temporal import TemporalTransformerBlock
    from vda_tpu_torch.ops.layers import Linear, Norm

    blk = TemporalTransformerBlock(c, vt.get_config("vitg"), device="cuda")
    blk.requires_grad_(False)
    for m in blk.modules():
        if isinstance(m, Norm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, Linear):
            bound = m.weight.shape[1] ** -0.5
            m.weight.uniform_(-bound, bound, generator=g)
            if m.bias is not None:
                m.bias.uniform_(-bound, bound, generator=g)
    return blk


def freed(ref, what: str) -> None:
    """Raises if the model behind the weak reference ``ref`` outlived the
    caller's last reference to it, then returns its memory to the card."""
    gc.collect()
    if ref() is not None:
        raise AssertionError(f"{what} outlived its phase")
    torch.cuda.empty_cache()


def gemm_by_loop_ok(counts, loops, since=None) -> bool:
    """Every K11/K13 launch counted in ``counts`` ran the Hopper GEMM loop:
    ``loops`` is ``quant.gemm_launches_by_loop`` read with ``counts``, and
    ``since`` (default: zeros, the counters reset) its value when ``counts``
    began."""
    base = since or dict.fromkeys(loops, 0)
    got = {k: v - base[k] for k, v in loops.items()}
    return got == {"sm90": counts["K11"] + counts["K13"], "sm80": 0}


def phase_kernels(model):
    """Each kernel against its plain twin at the main-path shapes in bf16,
    and at a small shape in fp32.  Returns per-kernel results: the first
    bf16 case of each kernel gives its times and bound, every case its
    error."""
    import torch.nn.functional as F

    from vda_tpu_torch.infer.streaming import _BUF_ROWS
    from vda_tpu_torch.ops import attention_kernel as k1
    from vda_tpu_torch.ops import attn_proj_kernel as k7
    from vda_tpu_torch.ops import norm_kernel as k2
    from vda_tpu_torch.ops import resize_kernel as k10
    from vda_tpu_torch.ops import segment_kernel as k8
    from vda_tpu_torch.ops import stream_kernel as k6
    from vda_tpu_torch.ops import temporal_kernel as k34
    from vda_tpu_torch.ops import tiny_seq_kernel as k5

    g = torch.Generator(device="cuda").manual_seed(1)
    bf = torch.bfloat16
    results = {}

    def check(name, shape, kern, twin, twin_inputs_fp32, tol, reps=5,
              cost=None, library=None, ops_dtype=None, held=False,
              held_timed=None, **timed):
        """cost: (bytes, operations) of the call, the operations at the peak
        rate of ``ops_dtype`` (default: the output's); library: one PyTorch
        call computing the same function, timed as a yardstick only; held:
        also time the kernel with the device held while the host enqueues
        the calls (``held_ms``, ``probes.time_held_ms``: for kernels short
        enough that their wrapper's host work sets the pace of ``ms``);
        held_timed: other calls timed that way, by name (``floor``: an
        empty kernel on the kernel's grid); timed: other calls to time
        beside it, by name.  In either, ``mma_sync`` or ``old`` is the code
        the kernel replaced on the same values, whose largest difference
        from the kernel is printed too."""
        got = kern()
        ref = twin(fp32=twin_inputs_fp32)
        extra = {}
        others = {**timed, **(held_timed or {})}
        for key in ("mma_sync", "old"):  # the code the kernel replaced
            if key in others:
                extra[f"max_abs_vs_{key}"] = float(
                    (got.float() - others[key]().float()).abs().max())
        torch.cuda.synchronize()
        err, r = rel(ref, got)
        if not torch.isfinite(got).all():
            raise AssertionError(f"{name}: non-finite kernel output")
        res = dict(kernel=name, shape=list(shape), dtype=str(got.dtype),
                   max_abs=err, max_rel=r, tol=tol, ms=time_ms(kern, reps),
                   plain_ms=time_ms(lambda: twin(fp32=False), reps),
                   library_ms=None if library is None
                   else time_ms(library, reps),
                   **{f"{k}_ms": time_ms(f, reps) for k, f in timed.items()},
                   **extra)
        if held:
            from vda_tpu_torch.probes import time_held_ms

            res["held_ms"] = time_held_ms(kern, reps)
        for key, f in (held_timed or {}).items():
            from vda_tpu_torch.probes import time_held_ms

            res[f"{key}_ms"] = time_held_ms(f, reps)
        if cost is not None:
            res["bound_ms"], res["bound_by"] = bound(*cost,
                                                     ops_dtype or got.dtype)
        emit(phase="kernel_vs_plain", **res)
        if not r < tol:
            raise AssertionError(f"{name} {shape}: max_rel {r} >= {tol}")
        if name in results:
            results[name]["max_abs"] = max(results[name]["max_abs"], err)
        else:
            results[name] = res
        return res

    from vda_tpu_torch.probes import bench_attn_variants as k12

    # K1: encoder attention on the Hopper loop, (B*T, N, 3*H*D) = (32, 1370,
    # 3072), 16 heads (the vitl window), then the vitl stream step (1, 1370,
    # 3072: 8 x 16 = 128 blocks of 192 query rows for 132 SMs) and the vits
    # window (32, 1370, 1152: 6 heads); the old mma.sync loop (K12
    # "mma_sync") timed beside it on the same values
    def k1_case(b, n, h, d=64):
        qkv = torch.randn(b, n, 3 * h * d, device="cuda", generator=g).to(bf)
        heads_view = qkv.view(b, n, 3, h, d).permute(2, 0, 3, 1, 4)
        check("K1", qkv.shape,
              lambda: k1.flash_attention_qkv(qkv, h, d ** -0.5),
              lambda fp32: k1.flash_attention_qkv_reference(
                  qkv.float() if fp32 else qkv, h, d ** -0.5), True,
              TOL["K1"], cost=(4 * b * n * h * d * 2, 4 * b * h * n * n * d),
              library=lambda: F.scaled_dot_product_attention(
                  *heads_view, scale=d ** -0.5),
              mma_sync=lambda: k12.attn(qkv, h, d ** -0.5, "mma_sync"))

    b, n, h, d = 32, 1370, 16, 64
    # then the vitg window (24 heads) and the vitl window batch of 2
    for shape in ((32, 1370, 16), (1, 1370, 16), (32, 1370, 6),
                  (32, 1370, 24), (64, 1370, 16)):
        k1_case(*shape)
    # K2: the encoder LayerNorm (eps 1e-6) and the mm0 ff_norm (eps 1e-5),
    # at vitl's width 1024, then at vitg's 1536
    for shape, eps in (((32, 1370, 1024), 1e-6), ((1369, 32, 1024), 1e-5),
                       ((32, 1370, 1536), 1e-6), ((1369, 32, 1536), 1e-5)):
        x = (torch.randn(*shape, device="cuda", generator=g) * 2 + 0.5).to(bf)
        c = shape[-1]
        w = torch.randn(c, device="cuda", generator=g)
        b_ = torch.randn(c, device="cuda", generator=g)
        check("K2", shape, lambda: k2.fused_layer_norm(x, w, b_, eps),
              lambda fp32: k2.layer_norm_reference(
                  x.float() if fp32 else x, w, b_, eps), True, TOL["K2"],
              reps=20, cost=(2 * x.numel() * 2 + 2 * c * 4, 8 * x.numel()),
              library=lambda: F.layer_norm(x, (c,), w.to(bf), b_.to(bf),
                                           eps))
        del x
    # K3 at mm3 and mm2, (5476, 32, 256) and (1369, 32, 256); K4 at mm0's
    # and mm1's attention sub-blocks, (1369, 32, 1024) and (361, 32, 1024),
    # all on the Hopper chain, each beside the kernels it replaced on the
    # same values (the probe's "sm80" step: old_ms, max_abs_vs_old) and the
    # split path of library calls (split_ms).  Operations a row: K3 40 C^2
    # of products + 8 T C of attention, K4 8 C^2 + 4 T C; bytes: h in and
    # out and the bf16 weights (probes/bench_temporal_sm90.py cost)
    from vda_tpu_torch.probes import bench_temporal_sm90 as bt

    mms = model.head.motion_modules
    blks = [mm.temporal_transformer.transformer_blocks[0] for mm in mms]
    blk3, blk0 = blks[3], blks[0]
    pe3 = blk3.attention_blocks[0].pos_encoder.pe[0]
    pe0 = blk0.attention_blocks[0].pos_encoder.pe[0]
    # vitg's mm3 and mm2 (C 384, 8 heads of 48) on a seeded block of that
    # width: the chain
    wide = random_temporal_block(384, g)
    for blk, bd, c in ((blks[3], 5476, 256), (blks[2], 1369, 256),
                       (wide, 5476, 384), (wide, 1369, 384)):
        t = 32
        pe = blk.attention_blocks[0].pos_encoder.pe[0]
        h3 = torch.randn(bd, t, c, device="cuda", generator=g).to(bf)
        sw = bt.split_weights(blk, t, pe)
        if k34.loop_of(bf, c, 8, t, True) != "sm90":
            raise AssertionError(f"K3 at {(bd, t, c)} is not on the Hopper "
                                 "chain")
        check("K3", h3.shape,
              lambda: k34.temporal_block_fused(blk, h3, pe, 8),
              lambda fp32: k34.temporal_block_reference(blk, h3, pe, 8),
              False, TOL["K3"], cost=bt.cost("K3", bd, t, c),
              old=lambda: bt.variant("sm80", blk, h3, pe, True),
              split=lambda: bt.split_path(sw, h3, True))
        del h3, sw
    del wide
    for i, bd in ((0, 1369), (1, 361)):
        blk, t, c = blks[i], 32, 1024
        pe = blk.attention_blocks[0].pos_encoder.pe[0]
        a, nrm = blk.attention_blocks[0], blk.norms[0]
        h0 = torch.randn(bd, t, c, device="cuda", generator=g).to(bf)
        sw = bt.split_weights(blk, t, pe)
        if k34.loop_of(bf, c, 8, t, False) != "sm90":
            raise AssertionError(f"K4 at {(bd, t, c)} is not on the Hopper "
                                 "chain")
        check("K4", h0.shape,
              lambda: k34.attention_block_fused(a, nrm, h0, pe, 8),
              lambda fp32: k34.attention_block_reference(a, nrm, h0, pe, 8),
              False, TOL["K4"], cost=bt.cost("K4", bd, t, c),
              old=lambda: bt.variant("sm80", blk, h0, pe, False),
              split=lambda: bt.split_path(sw, h0, False))
        del h0, sw
    a0, n0 = blk0.attention_blocks[0], blk0.norms[0]

    # K5 at the shapes of the streaming first step (vitl, T = 1) and of the
    # vits window (T = 32), 8 heads; q, k, v are column slices of one fused
    # projection, as the model hands them over.  bf16 on the Hopper code,
    # beside the kernel it replaced on the same values (the probe's "old"
    # step: old_ms, max_abs_vs_old) and, at T = 1, an empty kernel on the
    # same grid (floor_ms); repeated bit for bit; fp32 on the old kernel
    from vda_tpu_torch.probes import bench_short_attn_sm90 as bsa

    def k5_case(bd, t, c, dtype, heads=8, loop=None):
        """``loop``: the code the shape must run (default: "sm90" in bf16,
        else "sm80")."""
        qkv = torch.randn(bd, t, 3 * c, device="cuda", generator=g).to(dtype)
        q, k, v = qkv.split(c, dim=-1)
        dh = c // heads
        qh, kh, vh = (x.reshape(bd, t, heads, dh).transpose(1, 2)
                      for x in (q, k, v))
        loop = loop or ("sm90" if dtype == bf else "sm80")
        if k5.loop_of(dtype, t, c, heads) != loop:
            raise AssertionError(f"K5 at {(bd, t, c)} {dtype} is not on the "
                                 f"{loop} code")
        ins = dict(kernel="K5", shape=(bd, t, c), q=q, k=k, v=v, heads=heads,
                   scale=dh ** -0.5)
        out = torch.zeros(bd, t, c, device="cuda", dtype=dtype)
        timed = {} if dtype != bf else dict(
            old=lambda: bsa.variant("old", ins, out))
        held = {} if dtype != bf or t != 1 else dict(
            floor=lambda: bsa.variant("floor", ins, out))

        def kern():
            return k5.tiny_seq_attention(q, k, v, heads, dh ** -0.5)

        loops0 = dict(k5.launches_by_loop)
        check("K5", (bd, t, c), kern,
              lambda fp32: k5.tiny_seq_attention_reference(
                  *((x.float() for x in (q, k, v)) if fp32 else (q, k, v)),
                  heads, dh ** -0.5), True,
              TOL["K5" if dtype == bf else "fp32"],
              cost=(4 * bd * t * c * qkv.element_size(), 4 * bd * t * t * c),
              library=lambda: F.scaled_dot_product_attention(
                  qh, kh, vh, scale=dh ** -0.5), held=True, held_timed=held,
              **timed)
        if dtype == bf:  # no atomics, one order of the sums: the same bits
            first = kern()
            if not all(torch.equal(kern(), first) for _ in range(30)):
                raise AssertionError(f"K5 at {(bd, t, c)} differs between "
                                     "repeats")
        torch.cuda.synchronize()
        moved = {key: v - loops0[key] for key, v in k5.launches_by_loop.items()}
        if moved[loop] == 0 or any(moved[key] for key in moved if key != loop):
            raise AssertionError(f"K5 launches by loop {moved}, all expected "
                                 f"on {loop}")

    for shape in ((5476, 32, 64), (1369, 32, 64), (1369, 32, 192),
                  (1369, 1, 1024), (361, 1, 1024), (1369, 1, 256),
                  (5476, 1, 256),
                  # the RoPE vitl window's four modules (K3/K4 refuse RoPE)
                  (1369, 32, 1024), (361, 32, 1024), (1369, 32, 256),
                  (5476, 32, 256)):
        k5_case(*shape, bf)
    # vitg's mm0 and mm1 (head width 192) on the code the C entry point
    # reports for them
    for shape in ((1369, 32, 1536), (361, 32, 1536)):
        k5_case(*shape, bf, loop=k5.loop_of(bf, 32, 1536, 8))
    k5_case(37, 7, 256, torch.float32)  # ragged T, fp32

    # K6 at the shapes of a streaming step with ctx_kernel (vitl, 31 rows:
    # mm0, mm1, mm2, mm3), bf16 on the Hopper loop, beside the kernel it
    # replaced on the same values (the probe's "sm80" step: old_ms,
    # max_abs_vs_old) and the split path of library calls (split_ms); the
    # fp32 case, with rows that are not valid, on the old kernel
    from vda_tpu_torch.probes import bench_stream_sm90 as bs

    def k6_case(bhw, rows, c, dtype, n_valid, heads=8, valid_rows=None):
        def mk(*shape):
            return torch.randn(*shape, device="cuda", generator=g).to(dtype)
        q, kn, vn = mk(bhw, c), mk(bhw, c), mk(bhw, c)
        kb, vb, pk, pv = mk(bhw, rows, c), mk(bhw, rows, c), mk(rows, c), \
            mk(rows, c)
        valid = torch.zeros(rows, dtype=torch.bool, device="cuda")
        if valid_rows is None:
            valid[:n_valid] = True
        else:
            valid[valid_rows] = True
        zero = torch.zeros(rows, c, device="cuda")
        scale = (c // heads) ** -0.5
        loop = "sm90" if dtype == bf else "sm80"
        if k6.loop_of(dtype, c, heads) != loop:
            raise AssertionError(f"K6 at {(bhw, rows, c)} {dtype} is not on "
                                 f"the {loop} loop")
        ins = dict(q=q, kn=kn, vn=vn, kb=kb, vb=vb, pk=pk, pv=pv,
                   valid=valid.to(torch.uint8), scale=scale)
        # the split path of library calls computes the function only where
        # every row takes part
        timed = {} if dtype != bf else dict(
            old=lambda: bs.variant("sm80", ins),
            **({} if valid_rows is not None else
               dict(split=lambda: bs.split_path(ins))))

        def twin(fp32):
            if fp32:  # the encodings added in the working dtype
                return k6.stream_kv_attention_reference(
                    q.float(), kn.float(), vn.float(), (kb + pk).float(),
                    (vb + pv).float(), zero, zero, valid, heads, scale)
            return k6.stream_kv_attention_reference(
                q, kn, vn, kb, vb, pk, pv, valid, heads, scale)

        def kern():
            return k6.stream_kv_attention(q, kn, vn, kb, vb, pk, pv, valid,
                                          heads, scale)

        loops0 = dict(k6.launches_by_loop)
        check("K6", (bhw, rows, c), kern, twin, True,
              TOL["K6" if dtype == bf else "fp32"],
              cost=bs.cost(bhw, rows, c, n_valid, q.element_size()),
              held=True, **timed)
        if dtype == bf:  # the loop's sums have one order: the same bits
            first = kern()
            if not all(torch.equal(kern(), first) for _ in range(30)):
                raise AssertionError(f"K6 at {(bhw, rows, c)} differs "
                                     "between repeats")
        torch.cuda.synchronize()
        moved = {k: v - loops0[k] for k, v in k6.launches_by_loop.items()}
        if moved[loop] == 0 or any(moved[k] for k in moved if k != loop):
            raise AssertionError(f"K6 launches by loop {moved}, all "
                                 f"expected on {loop}")

    for shape in bs.SHAPES.values():
        k6_case(*shape, bf, n_valid=31)
    # the in-place read's shapes: the whole 45-row buffers, the 31 context
    # rows of its first step (42) valid, scattered as that step's rows are;
    # fp32 on the old kernel
    for bhw, _, c in bs.SHAPES.values():
        k6_case(bhw, _BUF_ROWS, c, bf, n_valid=31, valid_rows=direct_rows())
    k6_case(37, _BUF_ROWS, 256, torch.float32, n_valid=31,
            valid_rows=direct_rows())
    k6_case(37, 31, 256, torch.float32, n_valid=19)

    # K7: vitl's fused attention half, qkv (32, 1370, 3072), W (1024, 1024),
    # then the fused stream step's (1, 1370, 3072); against the bf16 twin;
    # the split path it replaces (K1, the projection, LayerScale and
    # residual as block_apply runs them) timed beside it; in bf16 every
    # launch on the Hopper kernel
    def k7_case(b, n, heads, d, dtype, valid=None):
        c = heads * d

        def mk(*shape, s=1.0):
            return torch.randn(*shape, device="cuda", generator=g) * s
        qkv = mk(b, n, 3 * c, s=2.0).to(dtype)
        w = mk(c, c, s=c ** -0.5).to(dtype)
        gb = torch.stack([1 + 0.5 * mk(c), mk(c, s=0.1)])
        x = mk(b, n, c, s=0.1).to(dtype)
        gamma, bias = gb[0].to(dtype), gb[1].to(dtype)
        scale = d ** -0.5
        es = qkv.element_size()
        check("K7", (b, n, 3 * c),
              lambda: k7.flash_attention_qkv_proj(qkv, w, gb, x, heads, scale,
                                                  valid),
              lambda fp32: k7.flash_attention_qkv_proj_reference(
                  qkv, w, gb, x, heads, scale, valid), False,
              TOL["K7" if dtype == bf else "fp32"],
              cost=((5 * b * n * c + c * c) * es + 2 * c * 4,
                    4 * b * n * n * c + 2 * b * n * c * c),
              split=lambda: x + F.linear(k1.flash_attention_qkv(
                  qkv, heads, scale, valid), w, bias) * gamma)

    k7_loops0, k7_n0 = dict(k7.launches_by_loop), k7.launches
    k7_case(32, 1370, 16, 64, bf)
    k7_case(1, 1370, 16, 64, bf)
    k7_loops = {key: v - k7_loops0[key]
                for key, v in k7.launches_by_loop.items()}
    if k7_loops != {"sm90": k7.launches - k7_n0, "sm80": 0}:
        raise AssertionError(f"a bf16 K7 launch missed the Hopper kernel: "
                             f"{k7_loops}")
    # K9: the generic attention entry at vitl encoder widths, three separate
    # (32, 1370, 1024) tensors, 16 heads
    q, k, v = (torch.randn(b, n, h * d, device="cuda", generator=g).to(bf)
               for _ in range(3))
    qkv9 = torch.cat([q, k, v], dim=-1)  # the old loop reads fused rows
    check("K9", (b, n, h * d),
          lambda: k1.flash_attention_packed(q, k, v, h, d ** -0.5),
          lambda fp32: k1.flash_attention_packed_reference(
              *((t.float() for t in (q, k, v)) if fp32 else (q, k, v)), h,
              d ** -0.5), True, TOL["K9"],
          cost=(4 * b * n * h * d * 2, 4 * b * h * n * n * d),
          library=lambda: F.scaled_dot_product_attention(
              *(t.view(b, n, h, d).transpose(1, 2) for t in (q, k, v)),
              scale=d ** -0.5),
          mma_sync=lambda: k12.attn(qkv9, h, d ** -0.5, "mma_sync"))
    k9 = k1.flash_attention_packed(q, k, v, h, d ** -0.5)
    if not torch.equal(k9, k1.flash_attention_qkv(qkv9, h, d ** -0.5)):
        raise AssertionError("K9 and K1 differ on the same values")
    del q, k, v, qkv9, k9

    # K8: block-diagonal attention at vitl widths (16 heads of 64) over the
    # segments of DINOv2's multi-crop batch, q, k and v column slices of one
    # fused projection as block_apply_nested hands them over; bf16 and fp32.
    # Then one long segment a sample (32 x 1370), the K1 shape, with K1's
    # time on the same values beside it.  Library call: SDPA over jagged
    # nested tensors (built outside the timed call).
    def k8_case(lengths, dtype, tol, **timed):
        c = h * d
        total = sum(lengths)
        qkv = torch.randn(total, 3 * c, device="cuda", generator=g).to(dtype)
        q8, k8_, v8 = qkv.split(c, dim=-1)
        offs = torch.tensor([0, *np.cumsum(lengths)], device="cuda")
        nested = [torch.nested.nested_tensor_from_jagged(t.contiguous(), offs)
                  .unflatten(-1, (h, d)).transpose(1, 2)
                  for t in (q8, k8_, v8)]
        sq = sum(n * n for n in lengths)
        loop = "sm90" if dtype == bf else "sm80"
        if k8.loop_of(dtype, d) != loop:
            raise AssertionError(f"K8 {dtype} is not on the {loop} code")
        ins = dict(kernel="K8", shape=tuple(lengths), q=q8, k=k8_, v=v8,
                   heads=h, scale=d ** -0.5)
        out = torch.zeros(total, c, device="cuda", dtype=dtype)
        if dtype == bf:  # the mma.sync loop it replaced, on the same values
            timed["old"] = lambda qkv: bsa.variant("old", ins, out)

        def kern():
            return k8.segment_attention(q8, k8_, v8, h, d ** -0.5, lengths)

        loops0 = dict(k8.launches_by_loop)
        check("K8", (len(lengths), total, c), kern,
              lambda fp32: k8.segment_attention_reference(
                  *((t.float() for t in (q8, k8_, v8)) if fp32
                    else (q8, k8_, v8)), h, d ** -0.5, lengths), True, tol,
              cost=(4 * total * c * qkv.element_size(), 4 * sq * c),
              library=lambda: F.scaled_dot_product_attention(
                  *nested, scale=d ** -0.5),
              **{k: (lambda f=f: f(qkv)) for k, f in timed.items()})
        if dtype == bf:  # no atomics, one order of the sums: the same bits
            first = kern()
            if not all(torch.equal(kern(), first) for _ in range(30)):
                raise AssertionError(f"K8 over {len(lengths)} segments "
                                     "differs between repeats")
        torch.cuda.synchronize()
        moved = {key: v - loops0[key] for key, v in k8.launches_by_loop.items()}
        if moved[loop] == 0 or any(moved[key] for key in moved if key != loop):
            raise AssertionError(f"K8 launches by loop {moved}, all expected "
                                 f"on {loop}")

    n_img, (n_g, len_g), (n_l, len_l) = MULTI_CROP
    multi_crop = [len_g] * (n_img * n_g) + [len_l] * (n_img * n_l)
    k8_case(multi_crop, bf, TOL["K8"])
    k8_case(multi_crop, torch.float32, TOL["K8_fp32"])
    k8_case([n] * b, bf, TOL["K8"], k1=lambda qkv: k1.flash_attention_qkv(
        qkv.view(b, n, 3 * h * d), h, d ** -0.5))
    # K10: the vitl tail's two upsamples (16-frame chunks) on the Hopper
    # kernel, bit-exact with the twin and with itself over 30 repeats, beside
    # the kernel it replaced (the probe's "old" step: old_ms,
    # max_abs_vs_old); ~9 fp32 operations an output element, at the fp32
    # rate
    from vda_tpu_torch.probes import bench_resize_sm90 as br

    for shape, out_hw in br.SHAPES:
        x = torch.randn(*shape, device="cuda", generator=g).to(bf)
        check("K10", (*shape, *out_hw),
              lambda: k10.resize_bilinear_fused(x, out_hw),
              lambda fp32: k10.resize_bilinear_fused_reference(x, out_hw),
              False, TOL["K10"], reps=20, cost=br.cost(shape, out_hw),
              ops_dtype=torch.float32,
              library=lambda: br.library(x, out_hw),
              old=lambda: br.variant("old", x, out_hw))
        first = k10.resize_bilinear_fused(x, out_hw)
        if not all(torch.equal(k10.resize_bilinear_fused(x, out_hw), first)
                   for _ in range(30)):
            raise AssertionError(f"K10 at {shape} differs between repeats")
        del x, first

    # K11: the kernel at the encoder's qkv product, 32 x 1370 rows of 1024
    # -> 3072, on vitl's first qkv weight quantised and per-row quantised
    # activations, bf16 out; bit-exact with the twin.  No PyTorch call
    # computes the dequantised product (library_ms null); timed beside it:
    # torch._int_mm on the same int8 operands (the product alone), the
    # whole int8_linear (the quantisation's plain ops and the kernel) and
    # the old mma.sync loop on the same values (the GEMM probe's step)
    from vda_tpu_torch import ops
    from vda_tpu_torch.ops import quant as k11
    from vda_tpu_torch.probes import bench_gemm_sm90 as gemm90
    from vda_tpu_torch.probes import bench_int8 as k13
    from vda_tpu_torch.probes import probe_stream_kernel as k14

    gemm_counts0 = ops.launch_counts()
    gemm_loops0 = dict(k11.gemm_launches_by_loop)

    lin = model.pretrained.blocks[0].attn.qkv
    w_q, w_s = k11.quantize_weight(lin.weight.detach().t())
    b11 = lin.bias.detach().float()
    x = torch.randn(b, n, h * d, device="cuda", generator=g).to(bf)
    xq, sx = k11.quantize_rows(x.reshape(-1, h * d))
    m, kk, nn = xq.shape[0], h * d, 3 * h * d
    int_mm = {}
    if k13.int_mm(xq, k11.transposed(w_q)) is not None:
        int_mm["int_mm"] = lambda: k13.int_mm(xq, k11.transposed(w_q))
    check("K11", (m, kk, nn),
          lambda: k11.int8_matmul(xq, w_q, sx, w_s, b11, bf),
          lambda fp32: k11.int8_matmul_reference(xq, w_q, sx, w_s, b11, bf),
          False, TOL["K11"], cost=(m * kk + kk * nn + 4 * m + 8 * nn
                                   + 2 * m * nn, 2 * m * kk * nn),
          ops_dtype=torch.int8, int8_linear=lambda: k11.int8_linear(
              {"w_q": w_q, "w_s": w_s, "b": b11}, x), **int_mm,
          mma_sync=lambda: gemm90.gemm("k11", xq, k11.transposed(w_q),
                                       "mma_sync", sx, w_s, b11))
    del x, xq
    # K11 ragged: M = 3 x 1370 + 1 rows (not a multiple of the 128-row
    # tile), N = 640 (not a multiple of the 256-column tile)
    mr, nr = 3 * 1370 + 1, 640
    xr = torch.randint(-127, 127, (mr, kk), device="cuda", generator=g,
                       dtype=torch.int8)
    wr = torch.randint(-127, 127, (kk, nr), device="cuda", generator=g,
                       dtype=torch.int8)
    sxr = torch.rand(mr, 1, device="cuda", generator=g) / 127
    swr = torch.rand(nr, device="cuda", generator=g) / 127
    br = torch.randn(nr, device="cuda", generator=g)
    check("K11", (mr, kk, nr),
          lambda: k11.int8_matmul(xr, wr, sxr, swr, br, bf),
          lambda fp32: k11.int8_matmul_reference(xr, wr, sxr, swr, br, bf),
          False, TOL["K11"], cost=(mr * kk + kk * nr + 4 * mr + 8 * nr
                                   + 2 * mr * nr, 2 * mr * kk * nr),
          ops_dtype=torch.int8,
          mma_sync=lambda: gemm90.gemm("k11", xr, k11.transposed(wr),
                                       "mma_sync", sxr, swr, br))
    del xr, wr
    # K12: K1's function as the variant kernel runs it on the Hopper loop
    # (K1's own configuration), at K1's shape and bound, bit-identical with
    # K1; the old loop's full (mma_sync) timed beside it (the other
    # variants: phase probes)
    qkv = torch.randn(b, n, 3 * h * d, device="cuda", generator=g).to(bf)
    k12_loops0 = dict(k12.launches_by_loop)
    check("K12", qkv.shape, lambda: k12.attn(qkv, h, d ** -0.5, "full"),
          lambda fp32: k12.attn_reference(
              qkv, h, d ** -0.5, "full",
              out_dtype=torch.float32 if fp32 else None), True, TOL["K12"],
          cost=(4 * b * n * h * d * 2, 4 * b * h * n * n * d),
          library=lambda: F.scaled_dot_product_attention(
              *qkv.view(b, n, 3, h, d).permute(2, 0, 3, 1, 4),
              scale=d ** -0.5),
          mma_sync=lambda: k12.attn(qkv, h, d ** -0.5, "mma_sync"))
    if not torch.equal(k12.attn(qkv, h, d ** -0.5, "full"),
                       k1.flash_attention_qkv(qkv, h, d ** -0.5)):
        raise AssertionError("K12 full and K1 differ on the same values")
    torch.cuda.synchronize()
    k12_sm90 = k12.launches_by_loop["sm90"] - k12_loops0["sm90"]
    k12_sm80 = k12.launches_by_loop["sm80"] - k12_loops0["sm80"]
    if k12_sm90 != 1 + 5 + 1 + 1 or k12_sm80 != 1 + 5 + 1:
        raise AssertionError(f"K12 launches by loop: full {k12_sm90} on "
                             f"the Hopper loop, mma_sync {k12_sm80} on the "
                             "old one")
    del qkv
    # K13 at the rate probe's shape: int8 -> int32 exact (its int32 output
    # dominates the bytes), library torch._int_mm; bf16 against the
    # unrounded fp32 product, library torch.matmul
    xb, wb, xi, wi = k13.inputs(g)
    M, K, N = k13.M, k13.K, k13.N
    wti = k11.transposed(wi)
    wtb = k11.transposed(wb)
    check("K13", (M, K, N), lambda: k13.matmul(xi, wi),
          lambda fp32: k13.matmul_reference(xi, wi), False, TOL["K13"],
          cost=(M * K + K * N + 4 * M * N, 2 * M * K * N),
          ops_dtype=torch.int8,
          library=(None if k13.int_mm(xi, wti) is None
                   else lambda: k13.int_mm(xi, wti)),
          mma_sync=lambda: gemm90.gemm("k13_int8", xi, wti, "mma_sync"))
    check("K13", (M, K, N), lambda: k13.matmul(xb, wb),
          lambda fp32: (xb.float() @ wb.float()) if fp32
          else k13.matmul_reference(xb, wb), True, TOL["K13_bf16"],
          cost=(2 * (M * K + K * N + M * N), 2 * M * K * N),
          library=lambda: xb @ wb,
          mma_sync=lambda: gemm90.gemm("k13_bf16", xb, wtb, "mma_sync"))
    del xb, wb, xi, wi, wti, wtb
    torch.cuda.synchronize()
    gemm_counts = {k: v - gemm_counts0[k]
                   for k, v in ops.launch_counts().items()}
    if not gemm_by_loop_ok(gemm_counts, k11.gemm_launches_by_loop,
                           since=gemm_loops0):
        raise AssertionError(f"K11/K13 launches off the Hopper GEMM loop: "
                             f"{k11.gemm_launches_by_loop} since "
                             f"{gemm_loops0}, counts {gemm_counts}")
    # K14 at the probe script's shape (32 positions, 43 rows, C 256, 8
    # heads, groups of 16), each stage (all features first: the kernels
    # line's numbers) on the Hopper kernel; held, the kernel (held_ms)
    # beside the first build on the same values (old_ms, max_abs_vs_old),
    # its loads alone (loads_ms) and an empty kernel on its grid and
    # cluster shape (floor_ms); each stage repeated bit for bit.  A stage's
    # bound counts the operands its features read, every cached row once
    # (all of them are read in every stage): q, kb, vb and out; kn and vn
    # with NEW, pe with PE, valid with MASK
    inputs = k14.make_inputs()
    bhw, rows, c, grp = k14.BHW, k14.ROWS, k14.C, k14.G
    if k14.loop_of(rows, c, k14.HEADS, grp) != "sm90":
        raise AssertionError("K14 at the probe's shape is not on the Hopper "
                             "kernel")
    k14_out = torch.empty_like(inputs[0])
    for stage in ("new", "dot2", "mask", "pe"):
        feats = k14.STAGES[stage]

        def k14_kern(feats=feats):
            return k14.simple_kernel(feats, inputs)

        def k14_step(step, feats=feats):
            return k14.variant(step, feats, inputs, k14_out)

        new, pe_on = "new" in feats, "pe" in feats
        loops0 = dict(k14.launches_by_loop)
        res = check("K14", (bhw, rows, c), k14_kern,
                    lambda fp32, feats=feats: k14.simple_kernel_reference(
                        feats, inputs, out_dtype=torch.float32 if fp32
                        else torch.bfloat16), True, TOL["K14"], reps=20,
                    cost=(2 * (2 * bhw * c + 2 * bhw * rows * c
                               + new * 2 * bhw * c + pe_on * rows * c)
                          + ("mask" in feats) * rows,
                          bhw * 4 * grp * c * (rows + new)),
                    held=True, held_timed={
                        "floor": lambda: k14_step("floor"),
                        "loads": lambda: k14_step("loads"),
                        "old": lambda: k14_step("old")})
        first = k14_kern()
        if not all(torch.equal(k14_kern(), first) for _ in range(30)):
            raise AssertionError(f"K14 stage {stage} differs between repeats")
        torch.cuda.synchronize()
        moved = {k: v - loops0[k] for k, v in k14.launches_by_loop.items()}
        if moved["sm80"]:
            raise AssertionError(f"K14 stage {stage} left the Hopper kernel: "
                                 f"{moved}")
        emit(phase="k14_stage", stage=stage, features=list(feats),
             held_ms=res["held_ms"], floor_ms=res["floor_ms"],
             held_minus_floor_us=1e3 * (res["held_ms"] - res["floor_ms"]),
             old_ms=res["old_ms"], loads_ms=res["loads_ms"],
             bound_ms=res["bound_ms"], ms=res["ms"], max_rel=res["max_rel"],
             launches_by_loop=moved, repeats_bit_for_bit=30)

    # fp32 at small shapes
    qkv = torch.randn(2, 200, 3 * 2 * 64, device="cuda", generator=g)
    check("K1", qkv.shape, lambda: k1.flash_attention_qkv(qkv, 2, 0.125,
                                                          valid_len=150),
          lambda fp32: k1.flash_attention_qkv_reference(qkv, 2, 0.125, 150),
          True, TOL["fp32"])
    x = torch.randn(300, 256, device="cuda", generator=g)
    w = torch.randn(256, device="cuda", generator=g)
    b_ = torch.randn(256, device="cuda", generator=g)
    check("K2", x.shape, lambda: k2.fused_layer_norm(x, w, b_, 1e-5),
          lambda fp32: k2.layer_norm_reference(x, w, b_, 1e-5), True,
          TOL["fp32"])
    if k34.loop_of(torch.float32, 256, 8, 32, True) != "sm80" or \
            k34.loop_of(torch.float32, 1024, 8, 32, False) != "sm80":
        raise AssertionError("fp32 K3/K4 left the kernels of "
                             "temporal_block.cu")
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
    # K7 in fp32 at vitl's width (its head outputs in the device-memory
    # workspace), ragged with keys masked; K9 in fp32
    k7_case(2, 300, 16, 64, torch.float32, valid=257)
    q = torch.randn(2, 530, 3 * 128, device="cuda", generator=g)
    check("K9", (2, 530, 128), lambda: k1.flash_attention_packed(
        *q.split(128, dim=-1), 2, 0.125),
          lambda fp32: k1.flash_attention_packed_reference(
              *q.split(128, dim=-1), 2, 0.125), True, TOL["fp32"])
    grad_cases()
    return results


def grad_cases():
    """The gradients of the two differentiable kernels: x.grad (and
    weight.grad, bias.grad of K2) through the kernel's autograd Function
    against autograd through the plain form, on the same inputs and output
    gradient.  K2 at vitl's (8 x 1370, 1024) in fp32 (the train step) and
    bf16; K10 at the vitl tail's (16, 148, 148, 256) -> 296 in bf16."""
    from vda_tpu_torch.ops import norm_kernel as k2
    from vda_tpu_torch.ops import resize_kernel as k10
    from vda_tpu_torch.ops.resize import resize_bilinear

    g = torch.Generator(device="cuda").manual_seed(3)

    def case(name, shape, fn, twin, inputs, tol=TOL["grad"]):
        gy = torch.randn(*fn(*inputs).shape, device="cuda", generator=g)
        gy = gy.to(inputs[0].dtype)

        def grads(f):
            ins = [t.detach().clone().requires_grad_(True) for t in inputs]
            f(*ins).backward(gy)
            return [t.grad for t in ins]

        got, ref = grads(fn), grads(twin)
        torch.cuda.synchronize()
        errs = {f"d{i}": rel(r, x)[1] for i, (r, x) in enumerate(zip(ref,
                                                                      got))}
        emit(phase="kernel_grad", kernel=name, shape=list(shape),
             dtype=str(inputs[0].dtype), max_rel=errs, tol=tol,
             fwd_bwd_ms=time_ms(lambda: grads(fn), 3),
             plain_fwd_bwd_ms=time_ms(lambda: grads(twin), 3))
        bad = {k: v for k, v in errs.items() if not v < tol}
        if bad or not all(torch.isfinite(x).all() for x in got):
            raise AssertionError(f"{name} {shape} gradients: {errs}")

    for dtype in (torch.float32, torch.bfloat16):
        x = (torch.randn(8 * 1370, 1024, device="cuda", generator=g) * 2
             + 0.5).to(dtype)
        w = torch.randn(1024, device="cuda", generator=g)
        b_ = torch.randn(1024, device="cuda", generator=g)
        case("K2", x.shape, lambda *a: k2.fused_layer_norm(*a, 1e-6),
             lambda *a: k2.layer_norm_reference(*a, 1e-6), (x, w, b_))
    x = torch.randn(16, 148, 148, 256, device="cuda", generator=g)
    x = x.to(torch.bfloat16)
    case("K10", (*x.shape, 296, 296),
         lambda t: k10.resize_bilinear_fused(t, (296, 296)),
         lambda t: resize_bilinear(t, (296, 296), kernel=False), (x,))


def copies_bytes(model) -> int:
    """Bytes of the working-dtype copies the kernels' wrappers keep of the
    model's tensors (``ops.layers.cast_once``, the temporal kernels' fused
    q/k/v weights)."""
    from vda_tpu_torch.ops import layers, temporal_kernel

    n = sum(layers._casts[t][1].nbytes for t in
            [*model.parameters(), *model.buffers()] if t in layers._casts)
    return n + sum(temporal_kernel._wqkv_cache[m][1].nbytes
                   for m in model.modules() if m in temporal_kernel._wqkv_cache)


def npz_round_trip(cast, x, window) -> dict:
    """The cast vitl through the JAX package's ``.npz`` params
    (``save_params_npz``) and back (``load_model_params(checkpoint=
    "x.npz")``, cast once): every tensor and the window ``x``'s depths
    (``window``) bit-identical.  Returns the file's bytes and the ms of the
    write and the load."""
    import tempfile

    import vda_tpu_torch as vt
    from vda_tpu_torch.utils.convert import save_params_npz

    work = tempfile.mkdtemp(prefix="vda_npz_")
    try:
        path = os.path.join(work, "vitl.npz")
        t0 = time.perf_counter()
        save_params_npz(path, cast)
        save_ms = 1e3 * (time.perf_counter() - t0)
        with np.load(path) as data:
            bf16_leaves = sum(data[n].dtype == np.dtype("V2")
                              for n in data.files)
            leaves = len(data.files)
        t0 = time.perf_counter()
        _, back = vt.load_model_params("vitl", checkpoint=path)
        torch.cuda.synchronize()
        load_ms = 1e3 * (time.perf_counter() - t0)
        back.requires_grad_(False)
        sa, sb = cast.state_dict(), back.state_dict()
        same = sa.keys() == sb.keys() and all(
            sa[k].dtype == sb[k].dtype and torch.equal(sa[k], sb[k])
            for k in sa)
        out = dict(file_bytes=os.path.getsize(path), leaves=leaves,
                   bf16_leaves=bf16_leaves, save_ms=save_ms, load_ms=load_ms,
                   state_bit_identical=same,
                   window_bit_identical=bool(torch.equal(
                       vt.forward(back, x), window)))
    finally:
        shutil.rmtree(work)
    if not (out["state_bit_identical"] and out["window_bit_identical"]
            and 0 < bf16_leaves < leaves):
        raise AssertionError(f"the cast vitl through .npz: {out}")
    return out


def phase_weights(model):
    """The inference weights' path: vitl through ``load_model_params(
    random_init=True)`` (``init_random`` from a generator seeded 0, as
    ``model``, then every weight cast to bf16 once by JAX's rule) against
    ``model`` (the same weights in fp32, cast at use).  A 1x32x518x518
    window and the first 4 stream steps are the same bits; one steady
    stream step of each: its parameter casts (``ParamCasts``: a launch
    each), its kernels and ``aten::_to_copy`` ops (torch.profiler) and its
    host ms (median of 6 steps in turns); each model's window peak memory
    (weights + kept copies + the forward's peak over what was resident).
    Returns the cast model."""
    from torch.profiler import ProfilerActivity, profile

    import vda_tpu_torch as vt
    from vda_tpu_torch.probes.param_casts import ParamCasts
    from vda_tpu_torch.utils.transform import preprocess_frames

    _, cast = vt.load_model_params("vitl", random_init=True)
    cast.requires_grad_(False)
    models = {"uncast": model, "cast": cast}
    w = "pretrained.blocks.0.attn.qkv.weight"
    if cast.state_dict()[w].dtype != torch.bfloat16 or not torch.equal(
            cast.state_dict()[w], model.state_dict()[w].to(torch.bfloat16)):
        raise AssertionError("the loader's vitl is not the smoke run's "
                             "weights cast to bf16")
    frames = (np.random.default_rng(0).random((32, SIZE, SIZE, 3))
              * 255).astype(np.uint8)
    x = preprocess_frames(torch.from_numpy(frames[None]).cuda(),
                          (SIZE, SIZE), dtype=torch.bfloat16)
    res = {name: {} for name in models}
    outs = {}
    for name, m in models.items():
        vt.forward(m, x)  # warm-up: the kept copies made
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        outs[name] = vt.forward(m, x)
        torch.cuda.synchronize()
        over = torch.cuda.max_memory_allocated() - resident
        weights = sum(t.nbytes for t in [*m.parameters(), *m.buffers()])
        copies = copies_bytes(m)
        res[name].update(weights_bytes=weights, copies_bytes=copies,
                         window_peak_over_resident=over,
                         window_peak_bytes=weights + copies + over)
    for name in ("uncast", "cast", "cast", "uncast"):
        res[name].setdefault("window_ms_in_turns", []).append(
            time_ms(lambda: vt.forward(models[name], x), reps=3))
    if not torch.equal(outs["uncast"], outs["cast"]):
        raise AssertionError("the cast model's window differs from the "
                             "uncast model's")
    npz = npz_round_trip(cast, x, outs["cast"])
    streams = {name: vt.StreamingDepth(m) for name, m in models.items()}
    for i, f in enumerate(frames[:4]):
        d = {name: st.submit(f) for name, st in streams.items()}
        if not torch.equal(d["uncast"], d["cast"]):
            raise AssertionError(f"stream step {i}: the cast model differs "
                                 "from the uncast model")
    host, step = ({name: [] for name in streams} for _ in range(2))
    for f in frames[4:10]:  # steady steps, in turns
        for name, st in streams.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st.submit(f)
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            host[name].append(1e3 * (t1 - t0))
            step[name].append(1e3 * (time.perf_counter() - t0))
    for name, st in streams.items():
        with ParamCasts(models[name]) as casts:
            st.submit(frames[10])
            torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            st.submit(frames[11])
            torch.cuda.synchronize()
        ka = prof.key_averages()
        res[name].update(
            step_param_casts=casts.count,
            step_kernels=sum(e.count for e in ka
                             if e.device_type.name == "CUDA"),
            step_to_copy_ops=sum(e.count for e in ka
                                 if e.key == "aten::_to_copy"),
            step_host_ms=float(np.median(host[name])),
            step_ms=float(np.median(step[name])),
            step_host_ms_all=host[name])
    emit(phase="weights", window_bit_identical=True,
         stream_steps_bit_identical=4, npz=npz, **res)
    if res["cast"]["step_param_casts"] or not res["uncast"][
            "step_param_casts"]:
        raise AssertionError(f"parameter casts of a steady step: cast "
                             f"{res['cast']['step_param_casts']}, uncast "
                             f"{res['uncast']['step_param_casts']}")
    del streams
    return cast


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
    if not by_loop_ok(counts) or not temporal_by_loop_ok(counts):
        raise AssertionError("a K1 launch of the window missed the Hopper "
                             "loop, or a K3/K4 launch the Hopper chain")
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
    max_rel, agree = agreement(torch.from_numpy(ref), torch.from_numpy(got))
    emit(phase="cross_check", max_rel=max_rel, agree_125=agree,
         window_ms=window_ms, window_ms_per_frame=window_ms / 32,
         plain_window_ms=plain_window_ms,
         plain_window_ms_per_frame=plain_window_ms / 32)
    if not (max_rel < 1e-2 and agree > 0.999):
        raise AssertionError(f"kernel vs plain forward: max_rel {max_rel}, "
                             f"agree_125 {agree}")


def phase_stream(model, frames):
    """vitl causal streaming, bf16, 48 frames of 518x518, through
    ``StreamingDepth.submit``: one stream without and one with ctx_kernel,
    stepped in turns; the launch counts of every step are read alone.
    Returns the launches of the whole phase."""
    import vda_tpu_torch as vt
    from vda_tpu_torch import ops
    from vda_tpu_torch.infer.streaming import _BUF_ROWS
    from vda_tpu_torch.ops import stream_kernel

    streams = {"kv": vt.StreamingDepth(model),
               "ctx": vt.StreamingDepth(model, ctx_kernel=True)}
    total = dict(ZERO)
    step_ms = {name: [] for name in streams}
    first = {name: [] for name in streams}
    worst = 0.0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for i, f in enumerate(frames):
        depth = {}
        for name, stream in streams.items():
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            depth[name] = stream.submit(f)
            torch.cuda.synchronize()
            step_ms[name].append(1e3 * (time.perf_counter() - t0))
            counts = ops.launch_counts()
            want = {**PER_STEP, "K5": 8 if i == 0 else 0,
                    "K6": 8 if i and name == "ctx" else 0}
            k6_loops = dict(stream_kernel.launches_by_loop)
            if counts != want or not by_loop_ok(counts) or \
                    k6_loops != {"sm90": want["K6"], "sm80": 0} or \
                    not k5_k8_by_loop_ok(counts):
                raise AssertionError(f"stream {name} step {i}: launches "
                                     f"{counts} != {want}, or a K1 launch "
                                     "missed the Hopper loop, or a K6 "
                                     f"launch its own ({k6_loops}), or a K5 "
                                     "launch the Hopper code")
            total = {k: total[k] + counts[k] for k in total}
            d = depth[name]
            if d.shape != (SIZE, SIZE) or not torch.isfinite(d).all():
                raise AssertionError(f"stream {name} step {i}: depth "
                                     f"{tuple(d.shape)} not finite")
            if i < 4:
                first[name].append(d.cpu())
        r = rel(depth["kv"], depth["ctx"])[1]
        worst = max(worst, r)
        if not r < 2e-2:
            raise AssertionError(f"step {i}: ctx_kernel vs kv max_rel {r}")
        if streams["kv"].order != streams["ctx"].order:
            raise AssertionError(f"step {i}: cache order differs")
    peak = torch.cuda.max_memory_allocated()
    want_cache = cache_bytes_want(_BUF_ROWS)
    cache = streams["kv"].cache_bytes()
    if cache != want_cache or streams["ctx"].cache_bytes() != want_cache:
        raise AssertionError(f"cache bytes {cache} != {want_cache}")
    # the first frames against an all-plain stream
    plain = vt.StreamingDepth(model, attn_impl="plain")
    vs_plain = []
    for i, f in enumerate(frames[:4]):
        ref = plain.submit(f).cpu()
        for name in streams:
            max_rel, agree = agreement(ref, first[name][i])
            vs_plain.append(dict(step=i, stream=name, max_rel=max_rel,
                                 agree_125=agree))
            if not (max_rel < 1e-2 and agree > 0.999):
                raise AssertionError(f"stream {name} step {i} vs plain: "
                                     f"max_rel {max_rel}, agree {agree}")
    steady = {name: float(np.median(ms[12:])) for name, ms in step_ms.items()}
    emit(phase="stream", frames=len(frames), first_frame_ms={
        name: ms[0] for name, ms in step_ms.items()},
         steady_ms_per_frame=steady, steady_steps="12-47 (median)",
         step_ms=step_ms, max_memory_allocated=peak,
         cache_bytes_per_stream=cache, max_rel_ctx_vs_kv=worst,
         vs_plain=vs_plain, launches=total)
    return total


def fork(stream):
    """A second stream in ``stream``'s state: the same model, bookkeeping
    and options, its own copy of the cache buffers."""
    twin = copy.copy(stream)
    twin.buffers = [b.clone() for b in stream.buffers]
    twin.order = list(stream.order)
    return twin


def phase_stream_direct(model, frames):
    """vitl causal streaming, bf16, N_DIRECT_STEPS steps of 518x518 (the 54
    frames, then their first 18 again), three streams stepped in turns:
    the default kv stream, ``ctx_kernel`` (K6 over the 31 gathered rows up
    to step 41, over the 45-row buffers in place from DIRECT_FROM) and,
    for comparison, the same ``ctx_kernel`` stream with its in-place read
    switched off (``gather``: K6 over the gathered rows at every step, the
    path the in-place read replaces).  At every step: the launches (K1 24,
    K2 64, K5 8 on step 0; K6 8 on each ``ctx`` and ``gather`` step after
    the first, on the Hopper loop: at 45 rows with 31 valid for ``ctx``
    from DIRECT_FROM, else at 31 rows), ``ctx`` bit-identical to
    ``gather`` before DIRECT_FROM and within 2e-2 of it from then on, both
    within 2e-2 of kv, ``order`` equal.  The largest gaps are kept over all
    steps and over the in-place steps alone.  Then the cache bytes, three
    more steps of each stream under torch.profiler (device busy ms, kernel
    ms by kind), and a ``ctx_kernel`` ``submit_group`` of 4 (one in-place
    group) against 4 submits on a fork of the stream (the cache bit for
    bit, the depths within 1e-2).  Returns the launches of the stepped
    run."""
    import vda_tpu_torch as vt
    from vda_tpu_torch import ops
    from vda_tpu_torch.infer.streaming import _BUF_ROWS
    from vda_tpu_torch.ops import stream_kernel
    from vda_tpu_torch.utils.profiling import device_profile

    frames = np.concatenate([frames, frames[:N_DIRECT_STEPS - len(frames)]])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    streams = {"kv": vt.StreamingDepth(model),
               "ctx": vt.StreamingDepth(model, ctx_kernel=True),
               "gather": vt.StreamingDepth(model, ctx_kernel=True)}
    if not streams["ctx"]._direct:
        raise AssertionError("the vitl ctx_kernel stream does not read its "
                             "cache in place")
    streams["gather"]._direct = False
    # K6's launches, their rows and valid flags, seen through its wrapper
    k6_calls = []
    wrapper = stream_kernel.stream_kv_attention

    def recording(q, k_new, v_new, k_buf, v_buf, pe_k, pe_v, valid, heads,
                  scale):
        k6_calls.append((k_buf.shape[1], valid))
        return wrapper(q, k_new, v_new, k_buf, v_buf, pe_k, pe_v, valid,
                       heads, scale)

    total = dict(ZERO)
    step_ms = {name: [] for name in streams}
    worst = {"ctx_vs_gather": 0.0, "ctx_vs_kv": 0.0, "gather_vs_kv": 0.0}
    worst_direct = dict(worst)  # over the in-place steps alone
    stream_kernel.stream_kv_attention = recording
    try:
        for i, f in enumerate(frames):
            depth = {}
            for name, stream in streams.items():
                torch.cuda.synchronize()
                ops.reset_launch_counts()
                k6_calls.clear()
                t0 = time.perf_counter()
                depth[name] = stream.submit(f)
                torch.cuda.synchronize()
                step_ms[name].append(1e3 * (time.perf_counter() - t0))
                counts = ops.launch_counts()
                k6 = 8 if i and name != "kv" else 0
                want = {**PER_STEP, "K5": 8 if i == 0 else 0, "K6": k6}
                k6_loops = dict(stream_kernel.launches_by_loop)
                rows = sorted({r for r, _ in k6_calls})
                n_valid = sorted({int(v.sum()) for _, v in k6_calls})
                in_place = name == "ctx" and i >= DIRECT_FROM
                want_rows = ([_BUF_ROWS if in_place else 31] if k6 else [])
                if counts != want or not by_loop_ok(counts) or \
                        k6_loops != {"sm90": k6, "sm80": 0} or \
                        not k5_k8_by_loop_ok(counts) or \
                        rows != want_rows or n_valid != ([31] if k6 else []):
                    raise AssertionError(
                        f"stream {name} step {i}: launches {counts} != "
                        f"{want}, K6 by loop {k6_loops}, K6 rows {rows} "
                        f"(want {want_rows}) with {n_valid} valid, or a K1 "
                        "or K5 launch off the Hopper code")
                total = {k: total[k] + counts[k] for k in total}
                d = depth[name]
                if d.shape != (SIZE, SIZE) or not torch.isfinite(d).all():
                    raise AssertionError(f"stream {name} step {i}: depth "
                                         f"{tuple(d.shape)} not finite")
            if i < DIRECT_FROM and not torch.equal(depth["ctx"],
                                                   depth["gather"]):
                raise AssertionError(f"step {i}: ctx_kernel before its "
                                     "first in-place step differs from the "
                                     "gathering stream")
            for key in worst:
                a, b = key.split("_vs_")
                r = rel(depth[b], depth[a])[1]
                worst[key] = max(worst[key], r)
                if i >= DIRECT_FROM:
                    worst_direct[key] = max(worst_direct[key], r)
                if not r < 2e-2:
                    raise AssertionError(f"step {i}: {a} vs {b} max_rel {r}")
            orders = {tuple(st.order) for st in streams.values()}
            if len(orders) != 1:
                raise AssertionError(f"step {i}: cache order differs "
                                     "between the streams")
    finally:
        stream_kernel.stream_kv_attention = wrapper
    peak = torch.cuda.max_memory_allocated()
    cache = {name: st.cache_bytes() for name, st in streams.items()}
    want_cache = cache_bytes_want(_BUF_ROWS)
    if set(cache.values()) != {want_cache} or want_cache != 1_268_582_400:
        raise AssertionError(f"cache bytes {cache} != {want_cache}")
    # three more steps of each stream under torch.profiler
    profiled = {}
    for name, stream in streams.items():
        runs = [device_profile(lambda: stream.submit(f))
                for f in frames[18:21]]
        by_kind = [r["kernel_ms_by_kind"] for r in runs]
        kinds_seen = sorted({k for kinds in by_kind for k in kinds})
        profiled[name] = dict(
            kernel_ms_by_kind_median={
                k: float(np.median([kinds.get(k, 0.0) for kinds in by_kind]))
                for k in kinds_seen},
            device_busy_ms=[r["device_busy_ms"] for r in runs],
            device_busy_median_ms=float(np.median(
                [r["device_busy_ms"] for r in runs])),
            wall_ms=[r["wall_ms"] for r in runs],
            idle_share=[r["idle_share"] for r in runs],
            kernels=[sum(r["launches_by_kind"].values()) for r in runs],
            top_kernels_ms=runs[-1]["top_kernels_ms"])
    # an in-place group of 4 against 4 submits, from one state
    seq = streams["ctx"]
    grp = fork(seq)
    batch = frames[21:25]
    ref = [seq.submit(f) for f in batch]
    ops.reset_launch_counts()
    got = grp.submit_group(batch)
    torch.cuda.synchronize()
    group_counts = ops.launch_counts()
    group_rel = max(rel(r, g)[1] for r, g in zip(ref, got))
    group = dict(frames=len(batch), launches=group_counts,
                 cache_identical=same_cache(seq, grp), max_rel=group_rel)
    want_group = {**ZERO, "K1": 24, "K2": ENC_K2 + MM_K2 * len(batch),
                  "K6": 8 * len(batch)}
    if not group["cache_identical"] or not group_rel < 1e-2 or \
            group_counts != want_group:
        raise AssertionError(f"ctx_kernel submit_group of 4 against 4 "
                             f"submits: {group}, want launches {want_group}")
    steady = {name: float(np.median(ms[DIRECT_FROM:]))
              for name, ms in step_ms.items()}
    emit(phase="stream_direct", nvidia_smi=smi(), frames=len(frames),
         first_step_ms={name: ms[0] for name, ms in step_ms.items()},
         steady_ms_per_frame=steady,
         steady_steps=f"{DIRECT_FROM}-{len(frames) - 1} (median)",
         step_ms=step_ms, max_memory_allocated=peak, cache_bytes=cache,
         max_rel_all_steps=worst,
         max_rel_in_place_steps=worst_direct,
         profiled_steps=profiled, group=group, launches=total)
    return total


def phase_vits_window(frames):
    """One vits 1x32x518x518 bf16 forward with the kernels against the
    all-plain forward; K5 carries three of its four motion modules.
    Returns the launches of the forward."""
    import vda_tpu_torch as vt
    from vda_tpu_torch import ops
    from vda_tpu_torch.utils.transform import preprocess_frames

    _, model = vt.load_model_params("vits", random_init=True)
    model.requires_grad_(False)
    x = preprocess_frames(torch.from_numpy(frames[:32][None]).cuda(),
                          (SIZE, SIZE), dtype=torch.bfloat16)
    vt.forward(model, x)  # warm-up
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    got = vt.forward(model, x)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    if counts != PER_VITS_WINDOW or not by_loop_ok(counts) \
            or not temporal_by_loop_ok(counts) or not k5_k8_by_loop_ok(counts):
        raise AssertionError(f"vits launches {counts} != {PER_VITS_WINDOW}, "
                             "or a K1 launch missed the Hopper loop, or a K3 "
                             "launch the Hopper chain, or a K5 launch the "
                             "Hopper code")
    window_ms = time_ms(lambda: vt.forward(model, x), reps=3)
    plain_ms = time_ms(lambda: vt.forward(model, x, attn_impl="plain"),
                       reps=2)
    max_rel, agree = agreement(vt.forward(model, x, attn_impl="plain"), got)
    emit(phase="vits_window", max_rel=max_rel, agree_125=agree,
         window_ms=window_ms, window_ms_per_frame=window_ms / 32,
         plain_window_ms=plain_ms, plain_window_ms_per_frame=plain_ms / 32,
         launches=counts, depth_std=float(got.float().std()))
    if not (max_rel < 1e-2 and agree > 0.999):
        raise AssertionError(f"vits kernel vs plain forward: max_rel "
                             f"{max_rel}, agree_125 {agree}")
    return counts


def phase_vitg_window(frames):
    """One seeded vitg 1x32x518x518 bf16 window (``load_model_params("vitg",
    random_init=True)``, cast once) with the kernels against the all-plain
    forward (bench.py's test): launches and the loop of each asserted, K5
    on the loop ``loop_of`` reports at head width 192; window and plain ms,
    peak memory of each.  The model is freed at the end: the plain K1 twin
    at 24 heads alone holds ~5.8 GB of fp32 scores a call.  Returns the
    launches of the forward."""
    import vda_tpu_torch as vt
    from vda_tpu_torch import ops
    from vda_tpu_torch.utils.transform import preprocess_frames

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, model = vt.load_model_params("vitg", random_init=True)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    model.requires_grad_(False)
    n_params = sum(p.numel() for p in model.parameters())
    x = preprocess_frames(torch.from_numpy(frames[:32][None]).cuda(),
                          (SIZE, SIZE), dtype=torch.bfloat16)
    vt.forward(model, x)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    got = vt.forward(model, x)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    k5_loops = vitg_k5_loops()
    if counts != PER_VITG_WINDOW or not by_loop_ok(counts) \
            or not temporal_by_loop_ok(counts) \
            or not k5_k8_by_loop_ok(counts, k5_loops):
        raise AssertionError(f"vitg launches {counts} != {PER_VITG_WINDOW}, "
                             "or a K1 launch missed the Hopper loop, or a K3 "
                             "launch the Hopper chain, or K5's launches "
                             f"their loop {k5_loops}")
    window_ms = time_ms(lambda: vt.forward(model, x), reps=3)
    plain_ms = time_ms(lambda: vt.forward(model, x, attn_impl="plain"),
                       reps=1)
    torch.cuda.reset_peak_memory_stats()
    ref = vt.forward(model, x, attn_impl="plain")
    torch.cuda.synchronize()
    plain_peak = torch.cuda.max_memory_allocated()
    max_rel, agree = agreement(ref, got)
    emit(phase="vitg_window", nvidia_smi=smi(), params=n_params,
         load_s=load_s, max_rel=max_rel, agree_125=agree,
         window_ms=window_ms, window_ms_per_frame=window_ms / 32,
         plain_window_ms=plain_ms, plain_window_ms_per_frame=plain_ms / 32,
         max_memory_allocated=peak, plain_max_memory_allocated=plain_peak,
         launches=counts, k5_by_loop=k5_loops,
         depth_std=float(got.float().std()))
    if not (max_rel < 1e-2 and agree > 0.999):
        raise AssertionError(f"vitg kernel vs plain forward: max_rel "
                             f"{max_rel}, agree_125 {agree}")
    gone = weakref.ref(model)
    del model, got, ref, x
    freed(gone, "the vitg model")
    return counts


def phase_rope(frames):
    """vitl with RoPE motion modules (``cfg.pe="rope"``, seeded weights
    cast once): one 1x32x518x518 window against the all-plain forward,
    then N_STREAM ``StreamingDepth.submit`` steps without and with
    ``ctx_kernel``, stepped in turns, launch counts asserted step by step
    (K6's gate refuses RoPE, so the ``ctx_kernel`` stream runs the plain kv
    path), the flavours within 2e-2 of each other at every step, the first
    4 steps against an all-plain stream.  Returns the launches of the
    phase."""
    import vda_tpu_torch as vt
    from vda_tpu_torch import ops
    from vda_tpu_torch.ops import tiny_seq_kernel as k5
    from vda_tpu_torch.utils.transform import preprocess_frames

    cfg = vt.get_config("vitl", pe="rope")
    _, model = vt.load_model_params("vitl", cfg=cfg, random_init=True)
    model.requires_grad_(False)
    x = preprocess_frames(torch.from_numpy(frames[:32][None]).cuda(),
                          (SIZE, SIZE), dtype=torch.bfloat16)
    vt.forward(model, x)  # warm-up
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    got = vt.forward(model, x)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    # K5 at mm0/mm1 (C 1024, 8 heads of 128) and mm2/mm3 (C 256, of 32)
    k5_loops = {"sm90": 0, "sm80": 0}
    for c in (1024, 1024, 256, 256):
        k5_loops[k5.loop_of(torch.bfloat16, 32, c, 8)] += 2
    if counts != PER_ROPE_WINDOW or not by_loop_ok(counts) \
            or not temporal_by_loop_ok(counts) \
            or not k5_k8_by_loop_ok(counts, k5_loops):
        raise AssertionError(f"RoPE window launches {counts} != "
                             f"{PER_ROPE_WINDOW}, or a K1 launch missed the "
                             "Hopper loop, or K5's launches their loops "
                             f"{k5_loops}")
    total = dict(counts)
    window_ms = time_ms(lambda: vt.forward(model, x), reps=3)
    plain_ms = time_ms(lambda: vt.forward(model, x, attn_impl="plain"),
                       reps=2)
    max_rel, agree = agreement(vt.forward(model, x, attn_impl="plain"), got)
    window = dict(max_rel=max_rel, agree_125=agree, window_ms=window_ms,
                  window_ms_per_frame=window_ms / 32, plain_window_ms=plain_ms,
                  plain_window_ms_per_frame=plain_ms / 32, launches=counts,
                  k5_by_loop=k5_loops)
    if not (max_rel < 1e-2 and agree > 0.999):
        raise AssertionError(f"RoPE window kernel vs plain forward: max_rel "
                             f"{max_rel}, agree_125 {agree}")
    del got, x

    streams = {"kv": vt.StreamingDepth(model),
               "ctx": vt.StreamingDepth(model, ctx_kernel=True)}
    step_ms = {name: [] for name in streams}
    first = {name: [] for name in streams}
    worst = 0.0
    for i, f in enumerate(frames[:N_STREAM]):
        depth = {}
        for name, stream in streams.items():
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            depth[name] = stream.submit(f)
            torch.cuda.synchronize()
            step_ms[name].append(1e3 * (time.perf_counter() - t0))
            counts = ops.launch_counts()
            want = {**PER_STEP, "K5": 8 if i == 0 else 0}
            if counts != want or not by_loop_ok(counts) or \
                    not k5_k8_by_loop_ok(counts):
                raise AssertionError(f"RoPE stream {name} step {i}: "
                                     f"launches {counts} != {want}, or a "
                                     "K1 launch missed the Hopper loop, or "
                                     "a K5 launch the Hopper code")
            total = {k: total[k] + counts[k] for k in total}
            d = depth[name]
            if d.shape != (SIZE, SIZE) or not torch.isfinite(d).all():
                raise AssertionError(f"RoPE stream {name} step {i}: depth "
                                     f"{tuple(d.shape)} not finite")
            if i < 4:
                first[name].append(d.cpu())
        r = rel(depth["kv"], depth["ctx"])[1]
        worst = max(worst, r)
        if not r < 2e-2:
            raise AssertionError(f"RoPE step {i}: ctx_kernel vs kv max_rel "
                                 f"{r}")
        if streams["kv"].order != streams["ctx"].order:
            raise AssertionError(f"RoPE step {i}: cache order differs")
    plain = vt.StreamingDepth(model, attn_impl="plain")
    vs_plain = []
    for i, f in enumerate(frames[:4]):
        ref = plain.submit(f).cpu()
        for name in streams:
            max_rel, agree = agreement(ref, first[name][i])
            vs_plain.append(dict(step=i, stream=name, max_rel=max_rel,
                                 agree_125=agree))
            if not (max_rel < 1e-2 and agree > 0.999):
                raise AssertionError(f"RoPE stream {name} step {i} vs "
                                     f"plain: max_rel {max_rel}, agree "
                                     f"{agree}")
    steady = {name: float(np.median(ms[12:])) for name, ms in step_ms.items()}
    emit(phase="rope", nvidia_smi=smi(), window=window,
         stream=dict(frames=N_STREAM,
                     first_frame_ms={n: ms[0] for n, ms in step_ms.items()},
                     steady_ms_per_frame=steady,
                     steady_steps=f"12-{N_STREAM - 1} (median)",
                     step_ms=step_ms, max_rel_ctx_vs_kv=worst,
                     vs_plain=vs_plain),
         launches=total)
    gone = weakref.ref(model)
    del model, streams, stream, plain
    freed(gone, "the RoPE vitl model")
    return total


def phase_window_batch(model, frames):
    """The vitl video (N_FRAMES frames: three windows) through
    ``infer_video_depth(window_batch=WINDOW_BATCH)`` against
    ``window_batch=1``: depths by bench.py's test, each forward's launches
    those of one window (at batch 2; the second forward's pad window
    repeats the last), end-to-end ms a frame of both, timed in turns (1, 2,
    2, 1).  Returns the launches of the counted batched run."""
    import vda_tpu_torch as vt
    from vda_tpu_torch import ops
    from vda_tpu_torch.infer import windowed

    real = windowed.forward
    forwards = []

    def counted(model_, x, **kw):
        before = ops.launch_counts()
        out = real(model_, x, **kw)
        after = ops.launch_counts()
        forwards.append((x.shape[0], {k: after[k] - before[k] for k in after}))
        return out

    def run(wb):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        d, _ = vt.infer_video_depth(model, frames, 30.0, window_batch=wb)
        torch.cuda.synchronize()
        return d, 1e3 * (time.perf_counter() - t0) / len(frames)

    run(WINDOW_BATCH)  # warm-up at the batched shapes
    windowed.forward = counted
    try:
        ops.reset_launch_counts()
        batched, _ = run(WINDOW_BATCH)
        counts = ops.launch_counts()
    finally:
        windowed.forward = real
    n_windows = len(range(0, len(frames), 22))
    n_forwards = -(-n_windows // WINDOW_BATCH)
    ok = (len(forwards) == n_forwards and by_loop_ok(counts)
          and temporal_by_loop_ok(counts)
          and all(b == WINDOW_BATCH and c == PER_WINDOW
                  for b, c in forwards))
    ms = {1: [], WINDOW_BATCH: []}
    single = None
    for wb in (1, WINDOW_BATCH, WINDOW_BATCH, 1):
        d, t = run(wb)
        ms[wb].append(t)
        if wb == 1:
            single = d
    max_rel, agree = agreement(torch.from_numpy(single),
                               torch.from_numpy(batched))
    emit(phase="window_batch", nvidia_smi=smi(), frames=len(frames),
         windows=n_windows, window_batch=WINDOW_BATCH, forwards=len(forwards),
         per_forward=[c for _, c in forwards], launches=counts,
         ms_per_frame={str(k): v for k, v in ms.items()},
         max_rel=max_rel, agree_125=agree)
    if not ok:
        raise AssertionError(f"window_batch forwards {forwards}: each must "
                             f"take {WINDOW_BATCH} windows and launch "
                             f"{PER_WINDOW} on the Hopper loops")
    if batched.shape != single.shape or not (max_rel < 1e-2
                                             and agree > 0.999):
        raise AssertionError(f"window_batch {WINDOW_BATCH} vs 1: max_rel "
                             f"{max_rel}, agree_125 {agree}")
    return counts


def phase_fused_window(model, frames):
    """The vitl video again through ``infer_video_depth(fuse_proj=True,
    resize_kernel=True)``, launch counts asserted per window; then one
    window's forward with both switches against the default-kernel forward
    and the all-plain forward (bench.py's test), the two kernel
    configurations timed in turns (default, fused, fused, default).
    Returns the launches of the video."""
    import vda_tpu_torch as vt
    from vda_tpu_torch import ops
    from vda_tpu_torch.utils.transform import preprocess_frames

    fused = dict(fuse_proj=True, resize_kernel=True)
    vt.infer_video_depth(model, frames[:32], 30.0, **fused)  # warm-up
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    depths, _ = vt.infer_video_depth(model, frames, 30.0, **fused)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    n_windows = len(range(0, len(frames), 22))
    want = {k: v * n_windows for k, v in PER_FUSED_WINDOW.items()}
    if counts != want or not k7_by_loop_ok(counts) \
            or not temporal_by_loop_ok(counts):
        raise AssertionError(f"fused launch counts {counts} != {want}, or a "
                             "K7 launch missed the Hopper kernel, or a K3/K4 "
                             "launch the Hopper chain")
    if depths.shape != frames.shape[:3] or not np.isfinite(depths).all() \
            or not depths.std() > 0:
        raise AssertionError("fused depths not finite, constant or of the "
                             "wrong shape")
    x = preprocess_frames(torch.from_numpy(frames[:32][None]).cuda(),
                          (SIZE, SIZE), dtype=torch.bfloat16)
    mb = dict(micro_batch_size=16)  # infer_video_depth's tail chunks
    ms = {}
    for name in ("default", "fused", "fused", "default"):
        kw = dict(mb, **(fused if name == "fused" else {}))
        ms.setdefault(name, []).append(
            time_ms(lambda: vt.forward(model, x, **kw), reps=3))
    got = vt.forward(model, x, **mb, **fused)
    vs = {"default": vt.forward(model, x, **mb),
          "plain": vt.forward(model, x, attn_impl="plain", **mb)}
    agree = {k: agreement(r, got) for k, r in vs.items()}
    emit(phase="fused_window", frames=len(frames), windows=n_windows,
         wall_s=wall, ms_per_frame=1e3 * wall / len(frames),
         launches=counts, depth_std=float(depths.std()),
         window_ms_in_turns=ms,
         **{f"max_rel_vs_{k}": a[0] for k, a in agree.items()},
         **{f"agree_125_vs_{k}": a[1] for k, a in agree.items()})
    for k, (max_rel, share) in agree.items():
        if not (max_rel < 1e-2 and share > 0.999):
            raise AssertionError(f"fused window vs {k}: max_rel {max_rel}, "
                                 f"agree_125 {share}")
    return counts


def phase_fused_stream(model, frames):
    """vitl ``StreamingDepth(fuse_proj=True)`` against the default stream
    over the first frames, stepped in turns: K7 24 a step and no K1, each
    step within 2e-2 of the default stream's (the bound the repo holds two
    kernel flavours of one stream to).  Returns the launches of the fused
    stream."""
    import vda_tpu_torch as vt
    from vda_tpu_torch import ops

    streams = {"kv": vt.StreamingDepth(model),
               "fused": vt.StreamingDepth(model, fuse_proj=True)}
    total = dict(ZERO)
    step_ms = {name: [] for name in streams}
    worst = 0.0
    for i, f in enumerate(frames):
        depth = {}
        for name, stream in streams.items():
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            depth[name] = stream.submit(f)
            torch.cuda.synchronize()
            step_ms[name].append(1e3 * (time.perf_counter() - t0))
            if name == "fused":
                counts = ops.launch_counts()
                want = {**PER_STEP, "K1": 0, "K7": 24,
                        "K5": 8 if i == 0 else 0}
                if counts != want or not k7_by_loop_ok(counts) \
                        or not k5_k8_by_loop_ok(counts):
                    raise AssertionError(f"fused stream step {i}: launches "
                                         f"{counts} != {want}, or a K7 "
                                         "launch missed the Hopper kernel, "
                                         "or a K5 launch the Hopper code")
                total = {k: total[k] + counts[k] for k in total}
        r = rel(depth["kv"], depth["fused"])[1]
        worst = max(worst, r)
        if not torch.isfinite(depth["fused"]).all() or not r < 2e-2:
            raise AssertionError(f"fused stream step {i}: max_rel {r}")
    emit(phase="fused_stream", frames=len(frames), step_ms=step_ms,
         median_ms_steps_2_on={k: float(np.median(v[2:]))
                               for k, v in step_ms.items()},
         max_rel_fused_vs_kv=worst, launches=total)
    return total


def phase_cross_attention():
    """``models.cross_attention`` at vitl encoder widths (B 32, N 1370, C
    1024, 16 heads of 64), seeded weights: self-attention with
    ``impl="auto"`` launches K9 once and agrees with ``impl="plain"``
    (bench.py's max_rel < 1e-2); a cross call with a 77-token context (M !=
    N) launches nothing.  Returns the launches of the two calls."""
    from vda_tpu_torch import ops
    from vda_tpu_torch.models.cross_attention import (CrossAttention,
                                                      cross_attention)

    g = torch.Generator(device="cuda").manual_seed(2)
    attn = CrossAttention(1024, heads=16, dim_head=64, device="cuda")
    attn.requires_grad_(False)
    for p in attn.parameters():
        p.uniform_(-1024 ** -0.5, 1024 ** -0.5, generator=g)
    x = torch.randn(32, 1370, 1024, device="cuda", generator=g)
    x = x.to(torch.bfloat16)
    ctx = torch.randn(32, 77, 1024, device="cuda", generator=g)
    ctx = ctx.to(torch.bfloat16)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    got = cross_attention(attn, x, impl="auto")
    torch.cuda.synchronize()
    self_counts = ops.launch_counts()
    cross = cross_attention(attn, x, encoder_hidden_states=ctx, impl="auto")
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    ref = cross_attention(attn, x, impl="plain")
    ref_cross = cross_attention(attn, x, encoder_hidden_states=ctx,
                                impl="plain")
    max_rel = rel(ref, got)[1]
    emit(phase="cross_attention", shape=list(x.shape), launches_self=
         self_counts, launches=counts, max_rel_vs_plain=max_rel,
         cross_equal_to_plain=bool(torch.equal(cross, ref_cross)))
    if self_counts != {**ZERO, "K9": 1} or counts != self_counts:
        raise AssertionError(f"cross_attention launches {self_counts}, "
                             f"then {counts}")
    if not torch.isfinite(got).all() or not max_rel < 1e-2 \
            or not torch.equal(cross, ref_cross):
        raise AssertionError(f"cross_attention vs plain: max_rel {max_rel}")
    return counts


def phase_nested_block(model):
    """``block_apply_nested`` on vitl's first encoder block over the
    multi-crop list [(64, 257, 1024), (256, 50, 1024)] (29,248 rows), bf16:
    one K8 launch (and the two K2 norms) a call, held to per-sample
    ``block_apply`` without kernels and to ``impl="plain"`` (bench.py's
    max_rel < 1e-2).  Returns the launches of one call."""
    from vda_tpu_torch import ops
    from vda_tpu_torch.models.dinov2 import block_apply, block_apply_nested

    cfg = model.cfg.vit
    blk = model.pretrained.blocks[0]
    g = torch.Generator(device="cuda").manual_seed(4)
    n_img, (n_g, len_g), (n_l, len_l) = MULTI_CROP
    x_list = [torch.randn(n_img * k, n, cfg.embed_dim, device="cuda",
                          generator=g).to(torch.bfloat16)
              for k, n in ((n_g, len_g), (n_l, len_l))]
    with torch.no_grad():
        block_apply_nested(blk, x_list, cfg)  # warm-up
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        got = block_apply_nested(blk, x_list, cfg)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        loops_ok = k5_k8_by_loop_ok(counts)
        per_sample = [block_apply(blk, xi, cfg, kernels=False) for xi in x_list]
        plain = block_apply_nested(blk, x_list, cfg, impl="plain")
        ms = time_ms(lambda: block_apply_nested(blk, x_list, cfg), 5)
        plain_ms = time_ms(lambda: block_apply_nested(blk, x_list, cfg,
                                                      impl="plain"), 2)
        per_sample_ms = time_ms(lambda: [block_apply(blk, xi, cfg, False)
                                         for xi in x_list], 2)
    rel_ps = max(rel(r, o)[1] for r, o in zip(per_sample, got))
    rel_plain = max(rel(r, o)[1] for r, o in zip(plain, got))
    emit(phase="nested_block", shapes=[list(x.shape) for x in x_list],
         rows=sum(x.shape[0] * x.shape[1] for x in x_list), launches=counts,
         max_rel_vs_per_sample=rel_ps, max_rel_vs_plain=rel_plain, ms=ms,
         plain_ms=plain_ms, per_sample_ms=per_sample_ms)
    if counts != {**ZERO, "K8": 1, "K2": 2} or not loops_ok:
        raise AssertionError(f"nested_block launches {counts}, or the K8 "
                             "launch missed the Hopper code")
    if not all(torch.isfinite(o).all() for o in got) \
            or not (rel_ps < 1e-2 and rel_plain < 1e-2):
        raise AssertionError(f"nested_block vs per-sample {rel_ps}, vs "
                             f"plain {rel_plain}")
    return counts


def synthetic_clips(seed: int = 0):
    """Seeded synthetic training batches (``apps/train.py``'s
    ``synthetic_iter``): video uniform in [0, 1), depth in [0.1, 5.1), all
    pixels valid."""
    b, t, side = TRAIN_CLIP
    rng = np.random.default_rng(seed)
    while True:
        yield {"video": rng.random((b, t, side, side, 3), dtype=np.float32),
               "depth": rng.random((b, t, side, side), dtype=np.float32) * 5
               + 0.1,
               "mask": np.ones((b, t, side, side), bool)}


def train_model(cfg, seed: int):
    import vda_tpu_torch as vt

    model = vt.init_random(cfg, torch.Generator(device="cuda").manual_seed(
        seed))
    final = model.head.scratch.output_conv2[2]
    with torch.no_grad():
        # a live final ReLU (tests/test_train.py), and a depth that varies:
        # random weights give a near-constant one, on which the loss's
        # scale-and-shift fit cancels and its gradient follows the rounding
        final.bias.add_(0.5)
        final.weight.mul_(20.0)
    return model


def same_state(a, b) -> bool:
    """Bit-identical TrainStates: model state dicts, AdamW moments and
    steps, accumulator, micro-step, update count and step."""
    sa, sb = a.model.state_dict(), b.model.state_dict()
    if sa.keys() != sb.keys() or not all(torch.equal(sa[k], sb[k])
                                         for k in sa):
        return False
    oa, ob = a.opt_state.state_dict(), b.opt_state.state_dict()
    for pa, pb in zip(oa["adam"]["state"].values(),
                      ob["adam"]["state"].values(), strict=True):
        # AdamW keeps its step count on the host; a restore may place it
        # on the card
        if pa.keys() != pb.keys() or not all(
                torch.equal(pa[k], pb[k].to(pa[k].device)) for k in pa):
            return False
    return (all(torch.equal(x, y) for x, y in zip(oa["acc"], ob["acc"],
                                                  strict=True))
            and (oa["mini_step"], oa["count"], a.step)
            == (ob["mini_step"], ob["count"], b.step))


def phase_train():
    """The training slice's main path on vitl (seeded random weights, fp32
    as the JAX step runs): ``parallel.trainer.train`` over 1x8x518x518
    synthetic clips for 6 steps with remat, the warmup-cosine schedule
    (warmup 2), clip_norm 1, accum 2, augmentation to 518x518, prefetch 2
    and a metrics JSONL.  Asserts finite losses and gradient norms, changed
    parameters, K2 launches per step as the code makes them and no other
    kernel (K10's gate refuses fp32, as in JAX); resumes the last checkpoint
    into a fresh state bit for bit; then one step from the seeded initial
    state on one batch with the kernels (attn_impl "xla") and all-plain.
    Returns the launches of the train run.  (The comparison is held on a
    batch whose mask leaves 40% of the pixels valid; see below.)"""
    import tempfile

    import vda_tpu_torch as vt
    from vda_tpu_torch import ops
    from vda_tpu_torch.parallel.train import (init_train_state,
                                              make_optimizer, make_train_step)
    from vda_tpu_torch.utils.checkpoint import (latest_checkpoint,
                                                restore_train_state)

    cfg = vt.get_config("vitl")
    model = train_model(cfg, 5)
    before = [p.detach().clone() for p in model.parameters()]
    work = tempfile.mkdtemp(prefix="vda_train_")
    metrics_path = os.path.join(work, "metrics.jsonl")
    kw = dict(learning_rate=1e-5, schedule=True, warmup_steps=2,
              clip_norm=1.0, accum=2, augment_hw=(SIZE, SIZE), prefetch=2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    state = vt.train(model, synthetic_clips(), N_TRAIN_STEPS, ckpt_dir=work,
                     metrics_path=metrics_path, log_fn=lambda *_: None, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    with open(metrics_path) as f:
        rows = [json.loads(line) for line in f]
    walls = [0.0] + [r["wall_s"] for r in rows]
    step_ms = [1e3 * (b - a) for a, b in zip(walls, walls[1:])]
    steady = float(np.median(step_ms[1:]))
    # K2 a step: norm1 and norm2 of each block and the four tap norms in
    # the forward, three norms of each motion module (widths 1024, 1024,
    # 256, 256: all % 128), and each block's two again in its remat
    # recompute; the backward of K2 is plain (no launch)
    depth = cfg.vit.depth
    per_step = 2 * depth + 4 + 3 * 4 + 2 * depth
    want = {**ZERO, "K2": per_step * N_TRAIN_STEPS}
    changed = sum(int(not torch.equal(p0, p)) for p0, p in
                  zip(before, model.parameters()))
    finite = all(np.isfinite([r[k] for k in ("total_loss", "spatial_loss",
                                            "stable_loss", "grad_norm")]).all()
                 for r in rows)
    del before
    # resume: the last checkpoint into a fresh state, bit for bit
    opt = make_optimizer(1e-5, warmup_steps=2 // 2,
                         total_steps=N_TRAIN_STEPS // 2, clip_norm=1.0,
                         accum_steps=2)
    fresh = init_train_state(train_model(cfg, 6), opt)
    restore_train_state(latest_checkpoint(work), fresh)
    resumed_equal = same_state(state, fresh)
    del fresh
    # one step on one batch, kernels vs plain, from the seeded initial
    # state: the trained state is not the same in every run (the metrics of
    # steps 0-3 agree between runs to the last bit, those of steps 4-5 do
    # not), and the loss's rank selections amplify such a difference past
    # the bound.  The loss normalises each frame by its median pixel, whose
    # gradient lands on that one pixel; with every pixel valid, the rounding
    # by which K2 and the plain LayerNorm differ moves the median to another
    # pixel and the gradient with it (tests/test_torch_loss.py,
    # test_median_gradient_sits_on_the_median_pixel), so the held
    # comparison uses a LiDAR-like mask (40% valid), where the median is a
    # zeroed invalid pixel that passes no gradient; the dense batch's gap
    # is reported only
    batch = next(synthetic_clips(7))
    sparse = dict(batch, mask=np.random.default_rng(8).random(
        batch["mask"].shape) < 0.4)
    step_out = {}
    for mask_kind, bt in (("sparse", sparse), ("dense", batch)):
        for impl in ("xla", "plain"):
            st = init_train_state(train_model(cfg, 5), opt)
            step = make_train_step(opt, augment_hw=(SIZE, SIZE),
                                   attn_impl=impl)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            _, m = step(st, bt)
            torch.cuda.synchronize()
            step_out[mask_kind, impl] = (
                {k: float(v) for k, v in m.items()},
                1e3 * (time.perf_counter() - t1))
            del st

    def rel_gap(mask_kind, key):
        a, b = (step_out[mask_kind, impl][0][key] for impl in ("xla", "plain"))
        return abs(a - b) / abs(b)

    loss_rel, gn_rel = rel_gap("sparse", "total_loss"), rel_gap("sparse",
                                                               "grad_norm")
    b, t, side = TRAIN_CLIP
    emit(phase="train", steps=N_TRAIN_STEPS, clip=[b, t, side, side, 3],
         dtype="float32", tf32_matmul=torch.backends.cuda.matmul.allow_tf32,
         tf32_cudnn=torch.backends.cudnn.allow_tf32, wall_s=wall,
         step_ms=step_ms, steady_ms_per_step=steady,
         steady_steps="1-5 (median)", frames_per_s=1e3 * b * t / steady,
         max_memory_allocated=peak, launches=counts,
         k2_per_step=per_step, params_changed=changed,
         params=len(list(model.parameters())), metrics=rows,
         resumed_bit_identical=resumed_equal,
         one_step={f"{k[0]}_{k[1]}": v[0] for k, v in step_out.items()},
         one_step_ms={f"{k[0]}_{k[1]}": v[1] for k, v in step_out.items()},
         loss_rel_xla_vs_plain=loss_rel, grad_norm_rel_xla_vs_plain=gn_rel,
         dense_mask_loss_rel=rel_gap("dense", "total_loss"),
         dense_mask_grad_norm_rel=rel_gap("dense", "grad_norm"))
    shutil.rmtree(work)
    if len(rows) != N_TRAIN_STEPS or not finite:
        raise AssertionError(f"train metrics not finite: {rows}")
    if counts != want:
        raise AssertionError(f"train launches {counts} != {want}")
    if not changed:
        raise AssertionError("train: no parameter changed")
    if not resumed_equal:
        raise AssertionError("train: resumed state differs from the saved")
    if not (loss_rel < 1e-4 and gn_rel < 1e-3):
        raise AssertionError(f"train step xla vs plain: loss {loss_rel}, "
                             f"grad_norm {gn_rel}")
    return counts


def stream_launches(n: int, k: int) -> dict:
    """vitl launches of a streaming CLI run of n frames at ``--lookahead``
    k: the first frame and the leftover frames a ``submit`` each, the rest
    in groups of k (the encoder batched: its K1s and K2s once a group; the
    motion modules' K2s a frame)."""
    groups, left = ((n - 1) // k, (n - 1) % k) if k > 1 else (0, n - 1)
    singles = 1 + left
    return {**ZERO, "K1": 24 * (singles + groups),
            "K2": PER_STEP["K2"] * singles + groups * (ENC_K2 + MM_K2 * k),
            "K5": 8}


def same_cache(a, b) -> bool:
    """Two streams' bookkeeping and cache buffers, bit for bit."""
    return a.order == b.order and a.id == b.id and all(
        torch.equal(x, y) for x, y in zip(a.buffers, b.buffers, strict=True))


def phase_apps():
    """The port's entry points (``vda_tpu_torch.apps``), each ``main(argv)``
    in this process on the card at vitl width with ``--random-init``
    (``load_model_params``' weights, seeded 0): the offline CLI on N_APPS frames with
    ``--save_npz``, its depths against ``infer_video_depth`` on the model
    it loaded; the streaming CLI on N_APP_STREAM frames at ``--lookahead``
    1 (depths and cache against a ``submit`` loop, bit for bit) and 4
    (``submit_group``: the cache bit for bit, the depths within 1e-2); then
    4 ``submit`` calls against one ``submit_group`` of 4, in turns, ms a
    frame; ``benchmark_infer`` on one APP_SCENE scene against
    ``infer_video_depth(fp32=True)``; the train CLI (2 synthetic steps,
    ``--export-pth``) and its ``.pth`` reloaded by ``load_model_params``,
    bit for bit; the engine's ``_infer_with_degradation`` at its strategy
    on the N_APPS frames.  The clips are written and decoded with cv2;
    where the host lacks the libraries ``io.save_video`` encodes with
    (HOST_LIBS), it is replaced by a numpy stand-in (named on the line), so
    everything from the frames to the written files is the entry points'
    own code.  Returns the launches of the phase."""
    import importlib.util
    import tempfile

    import cv2

    import vda_tpu_torch as vt
    from vda_tpu_torch import ops
    from vda_tpu_torch.apps import benchmark_infer, run, run_streaming, train
    from vda_tpu_torch.apps.engine import engine, strategies
    from vda_tpu_torch.utils import io

    encoder, size, device = "vitl", SIZE, "cuda"
    missing = [m for m in HOST_LIBS if importlib.util.find_spec(m) is None]
    rng = np.random.default_rng(13)
    frames = (rng.random((N_APPS, size, size, 3)) * 255).astype(np.uint8)
    n_scene, sh, sw = APP_SCENE
    scene = (rng.random((n_scene, sh, sw, 3)) * 255).astype(np.uint8)
    work = tempfile.mkdtemp(prefix="vda_apps_")
    video = os.path.join(work, "clip.mp4")
    names = [f"scannet/scene0000_00/color/{i:06d}.png" for i in range(n_scene)]
    manifest = os.path.join(work, "scannet_video.json")
    with open(manifest, "w") as f:
        json.dump({"scannet": [{"scene0000_00": [
            {"image": n, "gt_depth": n, "factor": 1000.0} for n in names]}]},
            f)
    restore, stood_in, loaded, load_s, streams = [], [], [], [], []

    def replace(owner, name, fn):
        restore.append((owner, name, getattr(owner, name)))
        setattr(owner, name, fn)

    def stand_in(owner, name, fn):
        replace(owner, name, fn)
        stood_in.append(f"{owner.__name__}.{name}")

    out = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"mp4v"), 30,
                          (size, size))
    for f in frames:
        out.write(f[:, :, ::-1].copy())
    out.release()
    for n, f in zip(names, scene):
        os.makedirs(os.path.dirname(os.path.join(work, n)), exist_ok=True)
        cv2.imwrite(os.path.join(work, n), f[:, :, ::-1].copy())
    if "matplotlib" in missing:
        def save_video(frames_, output_path, fps=10, is_depths=False,
                       grayscale=False):
            with open(output_path, "wb") as f:
                np.save(f, np.asarray(frames_))

        stand_in(io, "save_video", save_video)

    def keep(args, load=run.load_model):
        """The CLI's own loader; keeps the model and its load time."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cfg, model = load(args)
        torch.cuda.synchronize()
        load_s.append(time.perf_counter() - t0)
        loaded.append(model)
        return cfg, model

    def recording(*args, _build=run_streaming.StreamingDepth, **kw):
        """The CLI's stream, flavour by its knobs as the CLI builds it;
        kept."""
        stream = _build(*args, **kw)
        streams.append(stream)
        return stream

    replace(run, "load_model", keep)
    replace(run_streaming, "StreamingDepth", recording)

    def call(fn, argv):
        """(fn's result, wall s, launches, whether every K1, K3, K4 and K5
        launch ran the Hopper code) of one entry point."""
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        out = fn(argv)
        torch.cuda.synchronize()
        wall, c = time.perf_counter() - t0, ops.launch_counts()
        return out, wall, c, (by_loop_ok(c) and temporal_by_loop_ok(c)
                              and k5_k8_by_loop_ok(c))

    common = ["--encoder", encoder, "--random-init", "--device", device]
    total = dict(ZERO)
    fails = []
    try:
        seen, fps = io.read_video_frames(video)
        out1 = os.path.join(work, "offline")
        depths, wall, counts, hopper = call(run.main, [
            "--input_video", video, "--output_dir", out1, "--save_npz",
            "--input_size", str(size)] + common)
        model = loaded.pop()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        direct, _ = vt.infer_video_depth(model, seen, fps, input_size=size)
        torch.cuda.synchronize()
        npz = np.load(os.path.join(out1, "clip_depths.npz"))["depths"]
        n_windows = len(range(0, N_APPS, 22))
        offline = dict(frames=N_APPS, windows=n_windows, wall_s=wall,
                       load_s=load_s[-1],
                       direct_wall_s=time.perf_counter() - t0,
                       launches=counts, files=sorted(os.listdir(out1)),
                       bit_identical=bool(np.array_equal(npz, direct)
                                          and np.array_equal(depths, direct)))
        total = {k: total[k] + counts[k] for k in total}
        if not offline["bit_identical"]:
            fails.append("offline CLI depths differ from the direct call")
        want = {k: v * n_windows for k, v in PER_WINDOW.items()}
        if counts != want or not hopper:
            fails.append(f"offline CLI launches {counts} != {want}, or off "
                         "the Hopper loops")
        del model, depths, direct, npz

        # the same clip through a seeded vitg, then through vitl with its
        # two windows in one forward (--window-batch 2), each against its
        # direct call
        extra_cli = {}
        for name, argv, kw, per, n_fwd in (
                ("vitg", ["--encoder", "vitg", "--random-init", "--device",
                          device], {}, PER_VITG_WINDOW, n_windows),
                ("window_batch_2", ["--window-batch", "2"] + common,
                 dict(window_batch=2), PER_WINDOW, -(-n_windows // 2))):
            depths, wall, counts, _ = call(run.main, [
                "--input_video", video, "--output_dir",
                os.path.join(work, name), "--input_size", str(size)] + argv)
            k5_loops = vitg_k5_loops(n_windows) if name == "vitg" else None
            loops_ok = (by_loop_ok(counts) and temporal_by_loop_ok(counts)
                        and k5_k8_by_loop_ok(counts, k5_loops))
            model = loaded.pop()
            direct, _ = vt.infer_video_depth(model, seen, fps,
                                             input_size=size, **kw)
            want = {k: v * n_fwd for k, v in per.items()}
            extra_cli[name] = dict(wall_s=wall, load_s=load_s[-1],
                                   launches=counts,
                                   bit_identical=bool(
                                       np.array_equal(depths, direct)))
            total = {k: total[k] + counts[k] for k in total}
            if not extra_cli[name]["bit_identical"]:
                fails.append(f"offline CLI {name}: depths differ from the "
                             "direct call")
            if counts != want or not loops_ok:
                fails.append(f"offline CLI {name}: launches {counts} != "
                             f"{want}, or off their loops")
            del model, depths, direct

        stream = {}
        out2 = os.path.join(work, "stream")
        runs = {}
        for k in (1, 4):
            got, wall, counts, hopper = call(run_streaming.main, [
                "--input_video", video, "--output_dir", out2,
                "--max_len", str(N_APP_STREAM), "--lookahead", str(k),
                "--input_size", str(size)] + common)
            runs[k] = (np.stack(got), streams.pop(), loaded.pop())
            total = {key: total[key] + counts[key] for key in total}
            stream[f"lookahead_{k}"] = dict(wall_s=wall, launches=counts)
            if counts != stream_launches(N_APP_STREAM, k) or not hopper:
                fails.append(f"streaming CLI --lookahead {k}: launches "
                             f"{counts} != {stream_launches(N_APP_STREAM, k)}"
                             ", or off the Hopper loops")
        direct = vt.StreamingDepth(runs[1][2], input_size=size)
        ref = np.stack([direct.submit(f).cpu().numpy()
                        for f in seen[:N_APP_STREAM]])
        la4 = float(np.abs(runs[4][0] - ref).max() / np.abs(ref).max())
        stream.update(
            lookahead_1_bit_identical=bool(np.array_equal(runs[1][0], ref)),
            lookahead_1_cache_identical=same_cache(runs[1][1], direct),
            lookahead_4_cache_identical=same_cache(runs[4][1], direct),
            lookahead_4_max_rel=la4)
        if not (stream["lookahead_1_bit_identical"]
                and stream["lookahead_1_cache_identical"]
                and stream["lookahead_4_cache_identical"] and la4 < 1e-2):
            fails.append(f"streaming CLI against a submit loop: {stream}")
        # 4 submits (the direct stream) against one group of 4 (the
        # --lookahead 4 run's stream, whose cache is the same), in turns
        grouped = runs[4][1]
        ms = {"submit": [], "group": []}
        for r in range(5):
            batch = seen[N_APP_STREAM + 4 * r:N_APP_STREAM + 4 * r + 4]
            turns = (("submit", lambda: [direct.submit(f) for f in batch]),
                     ("group", lambda: grouped.submit_group(batch)))
            for name, fn in turns[::1 if r % 2 else -1]:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                ms[name].append(1e3 * (time.perf_counter() - t0) / 4)
        stream.update(
            submit_ms_per_frame=ms["submit"], group_ms_per_frame=ms["group"],
            submit_median=float(np.median(ms["submit"])),
            group_median=float(np.median(ms["group"])),
            cache_identical_after=same_cache(direct, grouped))
        if not stream["cache_identical_after"]:
            fails.append("submit_group's cache left the submits' after "
                         "the timed rounds")
        del runs, direct, grouped, ref

        # the streaming CLI with VDA_STREAM_DIRECT=1 on a clip of
        # N_APP_DIRECT frames (the N_APPS frames, then their first ones
        # again: in place from step 42), against the ctx_kernel stream the
        # knob should build on the model it loaded
        video_d = os.path.join(work, "clip_direct.mp4")
        out = cv2.VideoWriter(video_d, cv2.VideoWriter_fourcc(*"mp4v"), 30,
                              (size, size))
        for f in np.concatenate([frames, frames])[:N_APP_DIRECT]:
            out.write(f[:, :, ::-1].copy())
        out.release()
        seen_d, _ = io.read_video_frames(video_d)
        with knob_scope({"VDA_STREAM_DIRECT": "1"}):
            got, wall, counts, hopper = call(run_streaming.main, [
                "--input_video", video_d, "--output_dir",
                os.path.join(work, "stream_direct"), "--input_size",
                str(size)] + common)
        cli_stream, model = streams.pop(), loaded.pop()
        direct = vt.StreamingDepth(model, input_size=size, ctx_kernel=True)
        ref = [direct.submit(f).cpu().numpy() for f in seen_d]
        want = {**stream_launches(N_APP_DIRECT, 1),
                "K6": 8 * (N_APP_DIRECT - 1)}
        stream["direct_knob"] = dict(
            frames=N_APP_DIRECT, wall_s=wall, launches=counts,
            ctx_kernel=cli_stream.ctx_kernel, in_place=cli_stream._direct,
            bit_identical=bool(np.array_equal(np.stack(got), np.stack(ref))),
            cache_identical=same_cache(cli_stream, direct))
        total = {key: total[key] + counts[key] for key in total}
        if not (stream["direct_knob"]["bit_identical"]
                and stream["direct_knob"]["cache_identical"]
                and cli_stream.ctx_kernel and cli_stream._direct
                and counts == want and hopper):
            fails.append(f"streaming CLI with VDA_STREAM_DIRECT=1: "
                         f"{stream['direct_knob']}, want launches {want}")
        del cli_stream, model, direct, got, ref

        preds = os.path.join(work, "preds")
        _, wall, counts, _ = call(benchmark_infer.main, [
            "--infer_path", preds, "--json_file", manifest, "--datasets",
            "scannet", "--input_size", str(size)] + common)
        model = loaded.pop()
        direct, _ = vt.infer_video_depth(model, scene, 1, input_size=size,
                                         fp32=True)
        outs = [np.load(os.path.join(preds, "scannet",
                                     n.replace(".png", ".npy")))
                for n in names]
        bench = dict(frames=n_scene, hw=[sh, sw], wall_s=wall,
                     launches=counts, bit_identical=all(
                         np.array_equal(o, d) for o, d in zip(outs, direct)))
        total = {k: total[k] + counts[k] for k in total}
        if not bench["bit_identical"]:
            fails.append("benchmark_infer's .npy differ from the direct call")
        # one fp32 window (K1 fp32 runs the mma.sync loop)
        if counts != PER_WINDOW:
            fails.append(f"benchmark_infer launches {counts} != "
                         f"{PER_WINDOW}")
        del model, direct, outs

        pth = os.path.join(work, "trained.pth")
        state, wall, counts, _ = call(train.main, [
            "--synthetic", "--frames", "8", "--size", str(APP_TRAIN_SIZE),
            "--steps", "2", "--export-pth", pth, "--encoder", encoder,
            "--device", device])
        _, back = vt.load_model_params(encoder, checkpoint=pth,
                                       cast_bf16=False, device=device)
        sa, sb = state.model.state_dict(), back.state_dict()
        depth = state.model.cfg.vit.depth
        want = {**ZERO, "K2": 2 * (2 * depth + 4 + 3 * 4 + 2 * depth)}
        trained = dict(steps=state.step, size=APP_TRAIN_SIZE, wall_s=wall,
                       launches=counts, pth_bytes=os.path.getsize(pth),
                       reloaded_bit_identical=sa.keys() == sb.keys() and all(
                           torch.equal(sa[k], sb[k]) for k in sa))
        total = {k: total[k] + counts[k] for k in total}
        if not trained["reloaded_bit_identical"] or state.step != 2:
            fails.append("train CLI: the exported .pth reloads other weights")
        if counts != want:
            fails.append(f"train CLI launches {counts} != {want}")
        del state, back, sa, sb

        eng = engine.VideoDepthEngine(device=device)
        eng._load_model(encoder, False, "", random_init=True)
        strat = strategies.select_strategy(
            source_pixels=seen.shape[1] * seen.shape[2], device=device)
        kw = dict(input_size=min(size, strat.input_size), fp32=strat.fp32)
        (depths, _, degraded), wall, counts, hopper = call(
            lambda _: eng._infer_with_degradation(
                seen, fps, micro_batch=strat.micro_batch_size, **kw), None)
        direct, _ = vt.infer_video_depth(
            eng._model, seen, fps, micro_batch_size=strat.micro_batch_size,
            **kw)
        eng_line = dict(strategy=strat.name, degraded=degraded, wall_s=wall,
                        launches=counts,
                        bit_identical=bool(np.array_equal(depths, direct)))
        total = {k: total[k] + counts[k] for k in total}
        want = {k: v * n_windows for k, v in PER_WINDOW.items()}
        if (degraded or not eng_line["bit_identical"]
                or strat.name != "cuda_direct" or counts != want or not hopper):
            fails.append(f"engine: {eng_line}")
        del eng, depths, direct
    finally:
        for owner, name, original in reversed(restore):
            setattr(owner, name, original)
        shutil.rmtree(work)
    emit(phase="apps", nvidia_smi=smi(),
         encoder=encoder, size=size, host_libs_missing=missing,
         stood_in=stood_in, offline_cli=offline,
         offline_cli_vitg=extra_cli["vitg"],
         offline_cli_window_batch_2=extra_cli["window_batch_2"],
         streaming_cli=stream,
         benchmark_infer=bench, train_cli=trained, engine=eng_line,
         launches=total)
    if fails:
        raise AssertionError("; ".join(fails))
    return total


def phase_int8(model):
    """K11's path: ``ops.quant.int8_linear`` at the encoder's qkv shape (32
    x 1370 tokens, 1024 -> 3072) on vitl's first qkv weight and bias, with
    bf16 and fp32 activations: one K11 launch each, bit-identical with the
    twin, and the W8A8 error against the bf16 linear of the float weights
    within tests/test_quant.py's 2e-2.  Returns the launches of the two
    calls."""
    import torch.nn.functional as F

    from vda_tpu_torch import ops
    from vda_tpu_torch.ops import quant

    lin = model.pretrained.blocks[0].attn.qkv
    w_q, w_s = quant.quantize_weight(lin.weight.detach().t())
    p = {"w_q": w_q, "w_s": w_s, "b": lin.bias.detach().float()}
    g = torch.Generator(device="cuda").manual_seed(6)
    xs = {str(dt): torch.randn(32, 1370, 1024, device="cuda",
                               generator=g).to(dt)
          for dt in (torch.bfloat16, torch.float32)}
    quant.int8_linear(p, xs["torch.bfloat16"])  # the weight's transposed copy
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    ys = {k: quant.int8_linear(p, x) for k, x in xs.items()}
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    loops = dict(quant.gemm_launches_by_loop)
    res = {}
    w_bf, b_bf = lin.weight.detach().to(torch.bfloat16), \
        lin.bias.detach().to(torch.bfloat16)
    for k, x in xs.items():
        y = ys[k]
        dense = F.linear(x.to(torch.bfloat16), w_bf, b_bf)
        res[k] = dict(
            shape=list(y.shape), dtype=str(y.dtype),
            bit_identical=bool(torch.equal(y, quant.int8_linear_reference(
                p, x))),
            finite=bool(torch.isfinite(y).all()),
            w8a8_max_rel_vs_bf16_linear=rel(dense, y)[1],
            int8_linear_ms=time_ms(lambda: quant.int8_linear(p, x), 10),
            bf16_linear_ms=time_ms(lambda: F.linear(x.to(torch.bfloat16),
                                                    w_bf, b_bf), 10))
    emit(phase="int8", launches=counts, gemm_launches_by_loop=loops, **res)
    if counts != {**ZERO, "K11": 2} or not gemm_by_loop_ok(counts, loops):
        raise AssertionError(f"int8 launches {counts}, by loop {loops}")
    for k, r in res.items():
        if not (r["bit_identical"] and r["finite"]
                and r["shape"] == [32, 1370, 3072]
                and r["w8a8_max_rel_vs_bf16_linear"] < TOL["w8a8"]):
            raise AssertionError(f"int8_linear {k}: {r}")
    return counts


def phase_probes():
    """The measurement kernels' path: the probes' ``run`` as their entry
    points run them, each arm held against its twin by the probe: every K12
    variant at (32, 1370, 3072), K13 (and K11's dynamic-quant arm) at
    (45056, 1024) @ (1024, 3072), K14's four stages with K6's stages, the
    design steps and stages of K3/K4's Hopper chain, and the design steps
    of K6's Hopper loop and K10's Hopper kernel at their main-path shapes,
    and those of K5's and K8's Hopper code (with K1 timed beside K8 at 32 x
    1370).  Returns the launches of the runs."""
    from vda_tpu_torch import ops
    from vda_tpu_torch.ops import quant, stream_kernel
    from vda_tpu_torch.probes import (bench_attn_variants, bench_int8,
                                      bench_resize_sm90,
                                      bench_short_attn_sm90,
                                      bench_stream_sm90, bench_temporal_sm90,
                                      probe_stream_kernel)

    reps, stream_reps = 5, 20
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    bt, bs, br = bench_temporal_sm90, bench_stream_sm90, bench_resize_sm90
    bsa = bench_short_attn_sm90
    bt.launches = bt.stage_launches = bs.launches = br.launches = 0
    bsa.launches = 0
    rows = {"attn_variants": bench_attn_variants.run(reps=reps),
            "int8": bench_int8.run(reps=reps),
            "stream": probe_stream_kernel.run(reps=stream_reps),
            "temporal_sm90": bt.run(reps=reps),
            "stream_sm90": bs.run(reps=reps),
            "resize_sm90": br.run(reps=reps),
            "short_attn_sm90": bsa.run(reps=reps)}
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    # K3/K4's design steps: each step and stage a warm-up, ``reps`` timed
    # calls and one checked call at each of the four shapes (the fused
    # steps at K3's alone)
    n_steps = sum(len(bt.VARIANTS) - (0 if k == "K3" else len(bt.K3_ONLY))
                  for k, *_ in bt.SHAPES)
    want_bt = (n_steps * (reps + 2),
               sum(len(bt.COUNT[k]) for k, *_ in bt.SHAPES) * (reps + 2))
    # K6's steps: warm and L2-flushed timings (a warm-up and ``reps`` each)
    # and one checked call; K10's: one timing and one checked call
    want_bs = len(bs.VARIANTS) * len(bs.SHAPES) * (2 * reps + 3)
    want_br = len(br.VARIANTS) * len(br.SHAPES) * (reps + 2)
    # K5's and K8's: one held timing (a warm-up and ``reps``) and one
    # checked call a step and shape
    want_bsa = (sum(len(bsa.k5_steps(t)) for _, t, _ in bsa.K5_SHAPES.values())
                + len(bsa.K8_SHAPES) * (len(bsa.K8_VARIANTS)
                                        + len(bsa.K8_TABLES))) * (reps + 2)
    got = (bt.launches, bt.stage_launches, bs.launches, br.launches,
           bsa.launches)
    if got != (*want_bt, want_bs, want_br, want_bsa):
        raise AssertionError(f"design-step probe launches {got} != "
                             f"{(*want_bt, want_bs, want_br, want_bsa)}")
    loops = dict(quant.gemm_launches_by_loop)
    k12_loops = dict(bench_attn_variants.launches_by_loop)
    k6_loops = dict(stream_kernel.launches_by_loop)
    k14_loops = dict(probe_stream_kernel.launches_by_loop)
    emit(phase="probes", launches=counts, gemm_launches_by_loop=loops,
         k12_launches_by_loop=k12_loops, k6_launches_by_loop=k6_loops,
         k14_launches_by_loop=k14_loops, **rows)
    # each arm: a warm-up and ``reps`` timed calls, and one checked call
    # (K14's stages a held timing more); at head width 64 every K12 variant
    # but mma_sync on the Hopper loop; every K14 launch on the Hopper kernel;
    # K14's K6 stages (bf16, 43 rows) and the wrapper's host timing on K6's
    # Hopper loop
    n_variants = len(bench_attn_variants.VARIANTS)
    # K6: K14's two stages, and the wrapper's host timing (a warm-up and
    # ``HOST_REPS`` calls a shape) in K6's design-step probe
    # K1: timed beside K8 at 32 x 1370 (a warm-up and ``reps``)
    want = {**ZERO, "K1": reps + 1,
            "K12": n_variants * (reps + 2), "K13": 2 * (reps + 2),
            "K11": reps + 2, "K14": len(probe_stream_kernel.STAGES)
            * (2 * stream_reps + 3),
            "K6": 2 * (stream_reps + 2) + len(bs.SHAPES) * (bs.HOST_REPS + 1)}
    want_k12 = {"sm90": (n_variants - 1) * (reps + 2), "sm80": reps + 2}
    if counts != want or not gemm_by_loop_ok(counts, loops) \
            or k12_loops != want_k12 \
            or k6_loops != {"sm90": want["K6"], "sm80": 0} \
            or k14_loops != {"sm90": want["K14"], "sm80": 0}:
        raise AssertionError(f"probes launches {counts} != {want}, GEMM by "
                             f"loop {loops}, K12 by loop {k12_loops} != "
                             f"{want_k12}, K6 by loop {k6_loops}, K14 by "
                             f"loop {k14_loops}")
    bad = [r for rs in rows.values() for r in rs if not r.get("ok", True)]
    if bad:
        raise AssertionError(f"probe arms disagree with their twins: {bad}")
    return counts


def sleep_cycles(ms: float) -> int:
    """GPU clock cycles of ``torch.cuda._sleep`` that last about ``ms``,
    measured on this card."""
    n = 10_000_000
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    torch.cuda._sleep(n)
    end.record()
    torch.cuda.synchronize()
    return int(n * ms / start.elapsed_time(end))


def held_submit(stream, frame) -> dict:
    """One ``submit`` of a numpy frame (staged through the pinned buffers)
    with the device held by ``torch.cuda._sleep`` enqueued first, for ~50
    ms or three times the host time of a submit with the device idle,
    whichever is longer (a wait for the device inside ``submit`` makes its
    host time exceed the hold, however long; the longer hold keeps a slow
    host's own work from looking like one): the host ms of the call beside
    the sleep's device ms, the host ms until the step is done, the idle
    submit's host ms, and the kernels the step enqueued."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stream.submit(frame)
    idle_ms = 1e3 * (time.perf_counter() - t0)
    torch.cuda.synchronize()
    cycles = sleep_cycles(max(50.0, 3 * idle_ms))
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    t0 = time.perf_counter()
    stream.submit(frame)
    host_ms = 1e3 * (time.perf_counter() - t0)
    torch.cuda.synchronize()
    done_ms = 1e3 * (time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        stream.submit(frame)
        torch.cuda.synchronize()
    kernels = sum(e.count for e in prof.key_averages()
                  if e.device_type.name == "CUDA")
    return dict(sleep_ms=start.elapsed_time(end), submit_host_ms=host_ms,
                step_done_ms=done_ms, idle_submit_host_ms=idle_ms,
                kernels_a_step=kernels)


def phase_host_sync(model, frames):
    """The host never waits for the device inside a steady ``submit`` or a
    window ``forward``.  (1) With the device held by ``torch.cuda._sleep``
    (~50 ms, longer on a slow host: ``held_submit``), a steady vits
    ``submit`` returns in less host time than the sleep.  The same is
    printed for vitl; its step enqueues more kernels than CUDA's launch queue holds (~1000), so there the host
    waits for queue room, not for a synchronising call.  (2) A steady vitl
    ``submit``, a vitl window ``forward`` and a steady vitl ``ctx_kernel``
    ``submit`` that reads the cache in place (past DIRECT_FROM: its
    position map and valid flags go up every step) run under
    ``torch.cuda.set_sync_debug_mode("error")``, which raises at any call
    that makes the host wait for the device."""
    import vda_tpu_torch as vt
    from vda_tpu_torch.utils.transform import preprocess_frames

    _, vits = vt.load_model_params("vits", random_init=True)
    vits.requires_grad_(False)
    held = {}
    streams = {}
    for name, m in (("vits", vits), ("vitl", model)):
        streams[name] = vt.StreamingDepth(m)
        for f in frames[:3]:  # steps 0-2: buffers and caches made
            streams[name].submit(f)
        torch.cuda.synchronize()
        held[name] = held_submit(streams[name], frames[3])
    x = preprocess_frames(torch.from_numpy(frames[:32][None]).cuda(),
                          (SIZE, SIZE), dtype=torch.bfloat16)
    vt.forward(model, x)
    # a ctx_kernel stream past its first in-place step, one steady step
    # before the check
    direct = vt.StreamingDepth(model, ctx_kernel=True)
    for f in frames[:DIRECT_FROM + 2]:
        direct.submit(f)
    torch.cuda.synchronize()
    checked = []
    torch.cuda.set_sync_debug_mode("error")
    try:
        streams["vitl"].submit(frames[5])
        checked.append("vitl steady submit")
        vt.forward(model, x)
        checked.append("vitl window forward")
        direct.submit(frames[DIRECT_FROM + 2])
        checked.append("vitl steady in-place ctx_kernel submit")
    finally:
        torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        emit(phase="host_sync", held=held, sync_debug_error_clean=checked)
    h = held["vits"]
    if not h["submit_host_ms"] < h["sleep_ms"]:
        raise AssertionError(f"a steady vits submit waited for the device: "
                             f"{h}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 1
    import vda_tpu_torch as vt

    torch.cuda.set_device(0)
    phase_env()
    phase_build()

    def fp32_vitl():  # the smoke run's vitl weights, seed 0, in fp32
        return vt.init_random(vt.get_config("vitl"),
                              torch.Generator(device="cuda").manual_seed(0),
                              device="cuda").requires_grad_(False)

    model = fp32_vitl()
    results = phase_kernels(model)
    # the window, stream and fused phases run the weights cast once, as the
    # JAX benchmark runs them; the fp32 model is freed first, so that the
    # main path's peak memory counts the cast weights alone, and made again
    # for the nested block and W8A8; the train phase builds its own
    cast = phase_weights(model)
    gone = weakref.ref(model)
    del model
    freed(gone, "the fp32 vitl")
    window, frames = phase_main_path(cast)
    phase_cross_check(cast, frames)
    stream = phase_stream(cast, frames[:N_STREAM])
    direct = phase_stream_direct(cast, frames)
    vits = phase_vits_window(frames)
    vitg = phase_vitg_window(frames)
    rope = phase_rope(frames)
    batched = phase_window_batch(cast, frames)
    fused = phase_fused_window(cast, frames)
    fused_stream = phase_fused_stream(cast, frames[:N_FUSED_STREAM])
    cross = phase_cross_attention()
    model = fp32_vitl()
    nested = phase_nested_block(model)
    train = phase_train()
    apps = phase_apps()
    int8 = phase_int8(model)
    probes = phase_probes()
    phase_host_sync(cast, frames)
    paths = (window, stream, direct, vits, vitg, rope, batched, fused,
             fused_stream, cross, nested, train, apps, int8, probes)
    launches = {k: sum(p[k] for p in paths) for k in KERNELS}
    idle = [k for k, n in launches.items() if not n]
    if idle:
        raise AssertionError(f"kernels never launched on a main path: {idle}")
    print(json.dumps({"kernels": [
        {"name": k, "route": KERNELS[k][0], "source": KERNELS[k][1],
         "replaces": KERNELS[k][2], "launches": launches[k],
         "max_abs_err": results[k]["max_abs"], "ms": results[k]["ms"],
         "plain_ms": results[k]["plain_ms"],
         "bound_ms": results[k]["bound_ms"],
         "bound_by": results[k]["bound_by"],
         "library_ms": results[k]["library_ms"],
         "shape": results[k]["shape"],
         **{key: v for key, v in results[k].items()  # split_ms, int_mm_ms..
            if key.endswith("_ms") and key not in
            ("ms", "plain_ms", "bound_ms", "library_ms")}}
        for k in KERNELS]}), flush=True)
    print(smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
