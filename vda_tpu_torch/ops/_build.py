"""Build the CUDA kernels in ``vda_tpu_torch/csrc`` and bind them with ctypes.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` for Hopper
(``sm_90a``), all of them at once, and the objects are linked into one shared
library with a plain C interface.  Nothing here includes PyTorch's headers,
so a build takes seconds.  The library is built at first use into
``csrc/build/`` (listed in ``.gitignore``), named after a hash of the sources
and flags, so an edited source never loads a stale build.

Each C entry point takes raw device pointers and the CUDA stream as
``c_void_p``, launches on that stream, and returns ``cudaGetLastError()``;
``check`` raises when it is not 0 (a refused launch never runs, and a later
``synchronize`` would not report it).
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import time

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "csrc")
BUILD_DIR = os.path.join(CSRC, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_U64 = ctypes.c_ulonglong
_I64 = ctypes.c_longlong
# C signatures of the entry points (csrc/*.cu, ``extern "C"``)
_SIGNATURES = {
    # q, k, v, out, B, N, H, D, row_stride, valid_len, scale, is_bf16, stream
    "vda_attention": [_P] * 4 + [_I] * 4 + [_I64, _I, _F, _I, _P],
    # D, is_bf16 -> 90 (the Hopper loop) or 80
    "vda_attention_loop": [_I, _I],
    # q, k, v, out, B, N, H, row_stride, valid_len, scale, variant, stream
    "vda_attention_sm90_variant": [_P] * 4 + [_I] * 3
    + [_I64, _I, _F, _I, _P],
    # qkv, w, gamma_bias, x, out, ws, B, N, H, D, valid_len, scale, is_bf16,
    # stream
    "vda_attention_proj": [_P] * 6 + [_I] * 5 + [_F, _I, _P],
    # D, is_bf16 -> 90 (K7's Hopper kernel) or 80
    "vda_attention_proj_loop": [_I, _I],
    # qkv, w, gamma_bias, x, out, B, N, H, valid_len, scale, variant, stream
    "vda_attention_proj_sm90_variant": [_P] * 5 + [_I] * 4 + [_F, _I, _P],
    # x, out, itab, ftab, B, W, OH, OW, C, stride_b, stride_h, stride_w,
    # stream
    "vda_resize_bilinear": [_P] * 4 + [_I] * 5 + [_I64] * 3 + [_P],
    # the operands of vda_resize_bilinear, keep, variant, stream
    "vda_resize_variant": [_P] * 4 + [_I] * 5 + [_I64] * 3 + [_I] * 2
    + [_P],
    # C, heads, T, is_bf16, full -> 90 (the Hopper chain) or 80
    "vda_temporal_loop": [_I] * 5,
    # BD, T, C, heads, is_bf16, full, *workspace_bytes (out)
    "vda_temporal_workspace": [_I] * 6 + [ctypes.POINTER(_U64)],
    # h, out, pe, ln_w, ln_b, wqkv, wout, bout, ws, ws_bytes, BD, T, C,
    # heads, is_bf16, stream
    "vda_attention_block": [_P] * 9 + [_U64] + [_I] * 5 + [_P],
    # h, out, pe, (ln_w, ln_b, wqkv, wout, bout) x2, ffn_w, ffn_b, wproj,
    # bproj, wffo, bffo, ws, ws_bytes, BD, T, C, heads, is_bf16, stream
    "vda_temporal_block": [_P] * 20 + [_U64] + [_I] * 5 + [_P],
    # stage, full, a, w, b, h, pe, out, M, N, K, T, heads, stream
    "vda_temporal_stage": [_I] * 2 + [_P] * 6 + [_I] * 5 + [_P],
    # BD, T, C, heads, full, variant, *workspace_bytes (out)
    "vda_temporal_variant_workspace": [_I] * 6 + [ctypes.POINTER(_U64)],
    # the operands of vda_temporal_block, ws, ws_bytes, BD, T, C, heads,
    # full, variant, stream
    "vda_temporal_variant": [_P] * 20 + [_U64] + [_I] * 6 + [_P],
    # q, k, v, out, BD, T, C, heads, seq_stride, row_stride, scale, is_bf16,
    # stream
    "vda_tiny_seq_attention": [_P] * 4 + [_I] * 4 + [_I64] * 2
    + [_F, _I, _P],
    # T, C, heads, is_bf16 -> 90 (the Hopper code) or 80
    "vda_tiny_seq_loop": [_I] * 4,
    # the operands of vda_tiny_seq_attention, scale, keep, variant, stream
    "vda_tiny_seq_variant": [_P] * 4 + [_I] * 4 + [_I64] * 2
    + [_F, _I, _I, _P],
    # q, k_new, v_new, k_buf, v_buf, pe_k, pe_v, valid, out, BHW, rows, C,
    # heads, scale, is_bf16, stream
    "vda_stream_kv_attention": [_P] * 9 + [_I] * 4 + [_F, _I, _P],
    # C, heads, is_bf16 -> 90 (the Hopper loop) or 80
    "vda_stream_kv_loop": [_I] * 3,
    # the operands of vda_stream_kv_attention, scale, keep, variant, stream
    "vda_stream_kv_variant": [_P] * 9 + [_I] * 4 + [_F, _I, _I, _P],
    # q, k, v, out, tiles, n_tiles, items, n_items, max_span, total, heads,
    # D, row_stride, scale, is_bf16, stream
    "vda_segment_attention": [_P] * 5 + [_I, _P] + [_I] * 5
    + [_I64, _F, _I, _P],
    # D, is_bf16 -> 90 (the Hopper code) or 80
    "vda_segment_loop": [_I, _I],
    # the operands of vda_segment_attention up to row_stride, scale, keep,
    # variant, stream
    "vda_segment_variant": [_P] * 5 + [_I, _P] + [_I] * 5
    + [_I64, _F, _I, _I, _P],
    # xq, wt, sx, sw, b, out, M, N, K, out_bf16, stream
    "vda_int8_linear": [_P] * 6 + [_I] * 4 + [_P],
    # -> 90: the loop vda_int8_linear and vda_matmul_probe run (Hopper)
    "vda_gemm_loop": [],
    # a, bt, sx, sw, b, out, M, N, K, kind, variant, stream
    "vda_gemm_sm90_variant": [_P] * 6 + [_I] * 5 + [_P],
    # a, bt, out, M, N, K, is_bf16, stream
    "vda_matmul_probe": [_P] * 3 + [_I] * 4 + [_P],
    # q, k, v, out, B, N, H, D, row_stride, valid_len, scale, variant, stream
    "vda_attention_variant": [_P] * 4 + [_I] * 4 + [_I64, _I, _F, _I, _P],
    # D, variant -> 90 (the Hopper loop) or 80
    "vda_attention_variant_loop": [_I, _I],
    # q, k_new, v_new, k_buf, v_buf, pe, valid, out, BHW, rows, C, heads,
    # group, scale, features, stream
    "vda_stream_probe": [_P] * 8 + [_I] * 5 + [_F, _I, _P],
    # rows, C, heads, group -> 90 (the Hopper kernel) or 80
    "vda_stream_probe_loop": [_I] * 4,
    # the operands of vda_stream_probe, features, variant, stream
    "vda_stream_probe_variant": [_P] * 8 + [_I] * 5 + [_F, _I, _I, _P],
}

build_seconds = None  # wall time of the nvcc run in this process, if any
INVALID_VALUE = 1  # cudaErrorInvalidValue: an entry point refused its shape


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu"))
                  + glob.glob(os.path.join(CSRC, "*.cuh")))


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library.  nvcc's
    ``-Xptxas -v`` report (registers, spills, shared memory of every kernel)
    is kept beside the library as ``<library>.ptxas.log``."""
    global build_seconds
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + f.read())
    so = os.path.join(BUILD_DIR, f"libvda_kernels_{h.hexdigest()[:12]}.so")
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        cus = [s for s in _sources() if s.endswith(".cu")]
        objs = [f"{tmp}.{os.path.basename(s)}.o" for s in cus]
        t0 = time.perf_counter()
        jobs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", "-o", o, s],
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
                for s, o in zip(cus, objs)]
        logs = [(s, *j.communicate(), j.returncode)
                for s, j in zip(cus, jobs)]
        log = "".join(f"== {os.path.basename(s)}\n{out}" for s, out, _, _
                      in logs)
        bad = [os.path.basename(s) for s, _, _, rc in logs if rc]
        if not bad:
            r = subprocess.run([_nvcc(), "-shared", "-o", tmp, *objs],
                               capture_output=True, text=True)
            log += r.stdout + r.stderr
            bad = ["link"] if r.returncode else []
        build_seconds = time.perf_counter() - t0
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
        if bad:
            raise RuntimeError(f"nvcc failed ({', '.join(bad)}):\n{log}")
        with open(f"{so}.ptxas.log", "w") as f:
            f.write(log)
        os.replace(tmp, so)
    lib = ctypes.CDLL(so)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def stream_ptr(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
