"""vda_tpu_torch: the PyTorch and CUDA port of ``vda_tpu``.

It runs Video Depth Anything on an NVIDIA Hopper GPU, every configuration
of ``config.MODEL_CONFIGS`` (vitg's SwiGLU encoder among them) with APE or
RoPE motion modules (``pe``): offline windowed inference
(``infer_video_depth``, optionally with ``fuse_proj``, ``resize_kernel``
and ``window_batch``), causal streaming (``StreamingDepth``; with
``ctx_kernel`` K6 reads the cache in place once the warmup is over), the
JAX package's ``VDA_*`` knobs that pick behaviour (``utils/knobs.py``), the
generic attention library (``models/cross_attention.py``), and training on
one device: ``video_depth_loss`` (``loss/``), ``make_optimizer`` /
``init_train_state`` / ``make_train_step`` (``parallel/train.py``), the
``train`` loop with metrics, prefetch and checkpoint resume
(``parallel/trainer.py``, ``utils/data.py``, ``utils/checkpoint.py``,
``utils/augment.py``), and ``models/dinov2.block_apply_nested`` for
multi-crop batches; ``load_model_params`` (``utils/loader.py``), the one
loader of a reference ``.pth``, the JAX package's ``.npz`` params or a
seeded model, with JAX's cast of the weights to bf16 once
(``cast_params_for_inference``); the kernel-level
W8A8 int8 linear (``ops/quant.py``, which the model does not call, as in
JAX) and the on-card measurement probes (``probes/``).  Plain tensor code is PyTorch; the fourteen TPU
kernels of the JAX package are hand-written Hopper kernels, each beside a
plain PyTorch twin:

  * K1 / K9 ``ops/attention_kernel.py`` + ``csrc/attention_qkv.cu``:
    attention read in place from the fused qkv projection / over separate
    q, k and v (``ops/attention.py``'s dispatch), one device loop
    (``csrc/flash_attention.cuh``)
  * K2 ``ops/norm_kernel.py`` (Triton): one-pass LayerNorm; differentiable,
    its backward a recompute through the plain twin, as in JAX
  * K3 / K4 ``ops/temporal_kernel.py`` + ``csrc/temporal_block.cu``: a whole
    temporal transformer block / one attention sub-block
  * K5 ``ops/tiny_seq_kernel.py`` + ``csrc/tiny_seq_attention.cu``:
    attention inside each short temporal sequence
  * K6 ``ops/stream_kernel.py`` + ``csrc/stream_kv_attention.cu``: a new
    frame's attention over the streaming cache
  * K7 ``ops/attn_proj_kernel.py`` + ``csrc/attention_proj.cu``: attention,
    out-projection, LayerScale and residual of an encoder block
    (``fuse_proj=True``)
  * K8 ``ops/segment_kernel.py`` + ``csrc/segment_attention.cu``:
    block-diagonal attention over packed variable-length segments
    (``block_apply_nested``; forward only, as in JAX)
  * K10 ``ops/resize_kernel.py`` + ``csrc/resize_bilinear.cu``: the output
    tail's bf16 bilinear upsamples (``resize_kernel=True``); differentiable,
    its backward the plain separable form, as in JAX
  * K11 ``ops/quant.py`` + ``csrc/int8_matmul.cu``: the W8A8 linear's int8
    product with its dequantising epilogue (``int8_linear``)
  * K12 ``probes/bench_attn_variants.py`` + ``csrc/attention_variants.cu``:
    K1's loop with one piece ablated or its tiling changed
  * K13 ``probes/bench_int8.py`` + ``csrc/int8_matmul.cu``: the int8 and
    bf16 rate probe's tiled product
  * K14 ``probes/probe_stream_kernel.py`` + ``csrc/stream_probe.cu``
    (``stream_probe_sm90.cuh``): K6's features one at a time

The package never imports JAX or ``vda_tpu``; the JAX package is the
reference its tests hold it to.
"""

import torch

# cuDNN runs fp32 convolutions in TF32 by default (about three decimal
# digits), which would hide real errors of the fp32 path and break the fp32
# output island; fp32 matmuls must stay full fp32 for the same reason.
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

from vda_tpu_torch.config import MODEL_CONFIGS, ModelConfig, get_config  # noqa: E402,F401
from vda_tpu_torch.infer.streaming import StreamingDepth  # noqa: E402,F401
from vda_tpu_torch.infer.windowed import infer_video_depth  # noqa: E402,F401
from vda_tpu_torch.loss import video_depth_loss  # noqa: E402,F401
from vda_tpu_torch.models.vda import VideoDepthAnything, forward  # noqa: E402,F401
from vda_tpu_torch.parallel.train import (  # noqa: E402,F401
    TrainState,
    init_train_state,
    make_optimizer,
    make_train_step,
)
from vda_tpu_torch.parallel.trainer import train  # noqa: E402,F401
from vda_tpu_torch.utils.convert import (  # noqa: E402,F401
    cast_params_for_inference,
    init_random,
    load_state_dict_numpy,
)
from vda_tpu_torch.utils.loader import load_model_params  # noqa: E402,F401
