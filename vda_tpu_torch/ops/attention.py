"""Multi-head attention, PyTorch: the plain form and its dispatch.

Counterpart of ``vda_tpu/ops/attention.py``.  ``attention_plain`` is
``_xla_attention``: the scores are fp32 (the products of the input values,
summed in fp32), the softmax is fp32, and the probabilities are cast back to
the input dtype before the value product.  Every kernel's plain twin that
needs attention uses it.

``dot_product_attention`` (over (B, N, H, D)) and ``packed_self_attention``
(over head-packed (B, N, H·D)) pick the implementation as the JAX functions
do: ``impl="plain"`` (JAX's ``"xla"``) always runs ``attention_plain``;
``impl="auto"`` runs K9 (``attention_kernel.flash_attention_packed``) where
the JAX gate admits the shape (at least 512 tokens, query and key lengths
equal, head width a multiple of 8) and the kernel takes its head width (at
most 128), and ``attention_plain`` elsewhere.  With ``segment_lengths``,
``packed_self_attention`` is block-diagonal over packed segments: K8
(``segment_kernel.segment_attention``) where the head width is a multiple
of 8 and at most 128, per-segment ``attention_plain`` elsewhere.  On CPU
tensors the kernel wrappers run their plain twins.
"""

from __future__ import annotations

import torch

IMPLS = ("auto", "plain")


def attention_plain(q, k, v, scale: float, valid_len: int | None = None):
    """q: (B, Nq, H, D); k, v: (B, Nk, H, D).  Keys at or beyond
    ``valid_len`` are masked out."""
    dtype = q.dtype
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if valid_len is not None and valid_len < k.shape[1]:
        logits[..., valid_len:] = float("-inf")
    probs = torch.softmax(logits, dim=-1).to(dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _use_kernel(impl: str, nq: int, nk: int, d: int) -> bool:
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    return impl == "auto" and nq >= 512 and nq == nk and d % 8 == 0 \
        and d <= 128


def dot_product_attention(q, k, v, scale: float | None = None,
                          impl: str = "auto"):
    """Scaled dot-product attention over (B, N, H, D) tensors."""
    from vda_tpu_torch.ops import attention_kernel

    d = q.shape[-1]
    if scale is None:
        scale = d ** -0.5
    if _use_kernel(impl, q.shape[1], k.shape[1], d):
        return attention_kernel.flash_attention(q, k, v, scale)
    return attention_plain(q, k, v, scale)


def packed_self_attention(q, k, v, heads: int, scale: float | None = None,
                          impl: str = "auto", segment_lengths=None):
    """Self-attention over head-packed (B, N, H·D) tensors.

    ``segment_lengths``: static per-sequence lengths of a packed batch (B
    must be 1 and N their sum); attention is block-diagonal over the
    segments (the JAX package's NestedTensorBlock path)."""
    from vda_tpu_torch.ops import attention_kernel, segment_kernel

    b, n, hd = q.shape
    d = hd // heads
    if scale is None:
        scale = d ** -0.5
    if segment_lengths is not None:
        if b != 1:
            raise ValueError("segment_lengths requires a packed batch (B=1)")
        if impl not in IMPLS:
            raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
        fn = segment_kernel.segment_attention_reference
        if impl == "auto" and d % 8 == 0 and d <= 128:
            fn = segment_kernel.segment_attention
        return fn(q[0], k[0], v[0], heads, scale, segment_lengths)[None]
    if _use_kernel(impl, n, k.shape[1], d):
        return attention_kernel.flash_attention_packed(q, k, v, heads, scale)
    qh, kh, vh = (t.reshape(b, -1, heads, d) for t in (q, k, v))
    return attention_plain(qh, kh, vh, scale).reshape(b, n, hd)
