"""The JAX package's ``VDA_*`` environment knobs that pick behaviour, read by
the port where an argument is left at ``None``.

An explicit argument always wins; a knob only fills in a default.  The
knobs the port reads (each ``"1"`` to switch it on unless said otherwise):

* ``VDA_ATTN_FUSE_PROJ``: K7 for the encoder blocks (``fuse_proj``), read
  by JAX at ``vda_tpu/models/dinov2.py:237``.  It yields where the kernels
  are off (``attn_impl`` other than ``"auto"``), as JAX's gate does.
* ``VDA_RESIZE_KERNEL``: K10 for the output tail's upsamples
  (``resize_kernel``), read by JAX at ``vda_tpu/ops/pallas_resize.py:60-62``.
  It yields under ``attn_impl="plain"``.
* ``VDA_STREAM_CACHE_DTYPE`` (``bf16`` or ``int8``), ``VDA_STREAM_KV8``,
  ``VDA_STREAM_CTX_KERNEL`` and ``VDA_STREAM_DIRECT``: the streaming cache
  and K6, resolved by ``infer/streaming.py`` as
  ``vda_tpu/infer/streaming.py`` resolves them, except that
  ``VDA_STREAM_DIRECT`` turns on ``ctx_kernel``, whose stream reads the
  cache in place where JAX's direct flavour does.
* ``VDA_STREAM_RING`` and ``VDA_STREAM_SLIDE`` are refused by
  ``StreamingDepth``: the port has no ring or sliding cache layout.

These knobs are read where a call begins (``infer_video_depth``,
``StreamingDepth``); the model functions take plain values.

The knobs without a counterpart are listed in README.md with what the port
does instead.
"""

from __future__ import annotations

import os
from typing import Optional


def flag(name: str) -> bool:
    """True when the knob is set to ``"1"``."""
    return os.environ.get(name, "0") == "1"


def value(name: str) -> Optional[str]:
    """The knob's value, None when it is unset or empty."""
    return os.environ.get(name) or None


def fuse_proj(fuse: Optional[bool], attn_impl: str) -> bool:
    """``fuse_proj`` with None resolved from ``VDA_ATTN_FUSE_PROJ`` (off
    unless the kernels are on)."""
    if fuse is None:
        return flag("VDA_ATTN_FUSE_PROJ") and attn_impl == "auto"
    return bool(fuse)


def resize_kernel(kernel: Optional[bool], attn_impl: str) -> bool:
    """``resize_kernel`` with None resolved from ``VDA_RESIZE_KERNEL`` (off
    under ``attn_impl="plain"``)."""
    if kernel is None:
        return flag("VDA_RESIZE_KERNEL") and attn_impl != "plain"
    return bool(kernel)
