"""Causal streaming inference with a fixed-size cache, PyTorch.

Counterpart of ``vda_tpu/infer/streaming.py``, itself a rebuild of
reference video_depth_stream.py:77-161:

  * first frame: a T=1 forward whose 8 cache rows stand in for a whole
    32-frame window (the replication trick, reference :104-121);
  * later frames: the encoder on the new frame only, and temporal attention
    of the new frame over a 31-entry context of cache entries [0:2] +
    [-(INFER_LEN-3):] (reference :134-140), then the new rows are kept;
  * sliding-window eviction keeps entry 0 (the anchor) and drops entry 1
    once the window has slid past STREAM_GAP (reference :155-160).

Each of the 8 cache slots is one device tensor (BHW, 45, C) per cached
quantity (k and v for the default "kv" cache, the hidden states for "h"):
a ring in which entry ids map to rows deterministically (``_row``).  The
value is the JAX package's, not its TPU layout: buffers are not padded to a
row tile, the context is gathered with ``index_select`` on the 31 rows
instead of a one-hot product, and the new rows are written into the
buffers in place.  ``submit_group`` runs k frames in one call, as JAX's
does.

With ``ctx_kernel`` the kv cache's attention runs in K6: over the 31
gathered context rows while the warmup lasts, then, from the first step
whose 31 context entries sit in 31 distinct rows (step 42), over the whole
45-row buffers in place (JAX's direct flavour, from
``vda_tpu/infer/streaming_experimental.py``): a (45,) position map and
valid mask (``_pos_map``) reach the card by the stream's pinned copies,
and K6 reads only the valid rows, so the context is neither gathered nor
written.  ``cache_dtype`` and ``ctx_kernel`` left at None resolve from
``VDA_STREAM_CACHE_DTYPE`` / ``VDA_STREAM_KV8`` and
``VDA_STREAM_CTX_KERNEL`` / ``VDA_STREAM_DIRECT`` (``utils/knobs.py``).
JAX's ring and sliding cache layouts (``VDA_STREAM_RING``,
``VDA_STREAM_SLIDE``) are refused: on the H100 they gave the default
stream's depths in more device time a step (PERF.md, Findings).

``mesh`` with a model axis above 1 runs the stream tensor-parallel (JAX's
``StreamingDepth(mesh=)``): the model is sharded (``parallel/mesh``), the
kv cache's buffers hold this rank's channels (whole temporal heads; an h
cache stays whole), the bookkeeping is the same on every rank, and an int8
cache takes each row's scale from the largest magnitude over all ranks'
channels (an all-reduce MAX), as one device takes it over the whole row.
K6 is JAX's experimental flavour and single-chip: under a mesh the knobs
yield and an explicit ``ctx_kernel=True`` or ``VDA_STREAM_DIRECT=1``
raise.

``submit`` returns without waiting for the device, as JAX's does: the frame
and the context row ids reach the card by non-blocking copies from pinned
host buffers (``staging.Upload``), and the resize matrices and normalisation
constants come from device caches, so a steady step makes no synchronising
call.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from vda_tpu_torch.config import INFER_LEN, STREAM_GAP, STREAM_MAX_CACHE
from vda_tpu_torch.infer.staging import Upload
from vda_tpu_torch.models.dpt import (
    dpt_head_temporal_stage,
    dpt_head_temporal_tail,
)
from vda_tpu_torch.models.vda import (
    VideoDepthAnything,
    forward_depth,
    forward_features,
    kernel_set,
)
from vda_tpu_torch.ops import stream_kernel as sk
from vda_tpu_torch.ops.resize import resize_bilinear
from vda_tpu_torch.parallel import mesh as tpm
from vda_tpu_torch.utils import knobs, trace
from vda_tpu_torch.utils.transform import (
    compute_resize_hw,
    effective_input_size,
    preprocess_frames,
)

_CTX = INFER_LEN - 1  # 31 context entries
# Entry ids map to rows as row(0) = 0 (the anchor) and row(id) = 1 + (id-1) %
# _RING.  The cache holds at most STREAM_MAX_CACHE (42) live entries plus the
# new one, written before the eviction, so a ring of 44 leaves one row of
# margin (checked by _advance_bookkeeping).
_RING = STREAM_MAX_CACHE + 2
_BUF_ROWS = _RING + 1
# the cache dtype of cache_dtype=None with no knob set (JAX's
# _DEFAULT_CACHE_DTYPE)
_DEFAULT_CACHE_DTYPE = "bf16"


def _resolve_cache_dtype(cache_dtype: Optional[str]) -> str:
    """JAX's ``_resolve_cache_dtype``: an explicit ``cache_dtype`` wins;
    None is bf16 under ``VDA_STREAM_DIRECT=1`` (JAX's experimental
    flavours take only bf16), else reads ``VDA_STREAM_CACHE_DTYPE``, else
    int8 for ``VDA_STREAM_KV8=1``, else ``_DEFAULT_CACHE_DTYPE``."""
    if cache_dtype is not None:
        return cache_dtype
    if knobs.flag("VDA_STREAM_DIRECT"):
        return "bf16"
    env = knobs.value("VDA_STREAM_CACHE_DTYPE")
    if env:
        return env
    if knobs.flag("VDA_STREAM_KV8"):
        return "int8"
    return _DEFAULT_CACHE_DTYPE


def _pos_map(ctx_rows: List[int]):
    """The in-place read's row -> context position table (JAX
    ``streaming_experimental._pos_map``).  ctx_rows: 31 distinct buffer rows
    in context order.  Returns (pos_map (45,) int32, valid (45,) bool):
    pos_map[r] is the context position of row r (0 where valid[r] is
    False)."""
    pos_map = np.zeros((_BUF_ROWS,), np.int32)
    valid = np.zeros((_BUF_ROWS,), np.bool_)
    for i, r in enumerate(ctx_rows):
        pos_map[r] = i
        valid[r] = True
    return pos_map, valid


def _row(entry_id: int) -> int:
    """Buffer row of a logical cache entry (0-based frame id)."""
    return 0 if entry_id == 0 else 1 + (entry_id - 1) % _RING


def _evict(step_id: int, order: List[int]) -> None:
    """Eviction rule (reference video_depth_stream.py:155-160)."""
    if step_id + INFER_LEN > STREAM_GAP + 1:
        order.pop(1)


def _advance_bookkeeping(step_id: int, order: List[int]):
    """One step of the reference's frame_cache_list protocol
    (video_depth_stream.py:134-160), mutating ``order`` (the logical frame
    ids of the live entries, oldest first).  Returns (context ids, new id):
    the context is entries [0:2] + the newest INFER_LEN-3, the new entry is
    appended, then the eviction rule runs."""
    ctx = order[0:2] + order[-(INFER_LEN - 3):]
    if len(ctx) != _CTX:
        raise RuntimeError(f"cache context of {len(ctx)} entries, not {_CTX}")
    order.append(step_id)
    _evict(step_id, order)
    # distinct live ids must occupy distinct rows: the row just (re)used
    # belonged to an entry already evicted
    live = set(order)
    if len({_row(i) for i in live}) != len(live):
        raise RuntimeError("ring placement collision: a live cache entry "
                           "was overwritten")
    return ctx, step_id


def _to_out_depth(depth, out_hw):
    """forward_depth's (1, 1, h, w) -> (H, W) fp32 depth at out_hw."""
    d = resize_bilinear(depth[0][..., None].float(), out_hw,
                        align_corners=True)
    return d[0, ..., 0]


def _leaves(rows, cache_kind: str) -> list:
    """The cache rows of a step as one flat list of tensors."""
    if cache_kind == "kv":
        return [x for kv in rows for x in kv]
    return list(rows)


@torch.no_grad()
def _first_step(model, frame_u8, net_hw, out_hw, dtype, attn_impl,
                cache_kind, fuse_proj):
    """First frame: a T=1 forward; returns (depth, the flat cache rows,
    each (BHW, C))."""
    x = preprocess_frames(frame_u8[None], net_hw, dtype=dtype)[None]
    feats = forward_features(model, x, attn_impl, fuse_proj)
    depth, rows = forward_depth(model, feats, x.shape, cache_kind=cache_kind,
                                attn_impl=attn_impl)
    return (_to_out_depth(depth, out_hw),
            [r[:, 0] for r in _leaves(rows, cache_kind)])


@torch.no_grad()
def _stream_step(model, frame_u8, buffers, scales, ctx_rows, net_hw, out_hw,
                 dtype, attn_impl, cache_kind, ctx_kernel, fuse_proj):
    """One causal step: gathers the 31-row context of every buffer
    (dequantising an int8 cache by its per-row scales), runs the frame
    against it and returns (depth, the flat new rows, each (BHW, 1, C)).
    Reads the buffers and does not write them."""
    x = preprocess_frames(frame_u8[None], net_hw, dtype=dtype)[None]
    feats = forward_features(model, x, attn_impl, fuse_proj)
    ctx = []
    with trace.span("stream.context", device=x):
        for i, buf in enumerate(buffers):
            c = buf.index_select(1, ctx_rows).to(dtype)
            if scales is not None:
                c = c * scales[i].index_select(0, ctx_rows).to(dtype)[
                    None, :, None]
            ctx.append(c)
    if cache_kind == "kv":
        marker = ("ctx",) if ctx_kernel else ()
        ctx = [(ctx[2 * i], ctx[2 * i + 1]) + marker
               for i in range(len(ctx) // 2)]
    depth, rows = forward_depth(model, feats, x.shape,
                                cached_hidden_state_list=ctx,
                                cache_kind=cache_kind, attn_impl=attn_impl)
    return _to_out_depth(depth, out_hw), _leaves(rows, cache_kind)


@torch.no_grad()
def _stream_step_group(model, frames_u8, buffers, ctx_rows, held_at, net_hw,
                       out_hw, dtype, attn_impl, cache_kind, fuse_proj):
    """k causal steps in one call (JAX ``_stream_step_group``): the encoder
    over the k frames in one batch, the cache-coupled head stage frame by
    frame in order, and one output tail over the k frames.  Frame j's
    context is gathered from the buffers at ``ctx_rows[j]``; then each
    ``(position, i)`` of ``held_at[j]`` takes the new rows of the group's
    frame i < j, which are held here and not written (the buffers are only
    read).  Returns (depths (k, H, W) fp32, each frame's flat new rows,
    each (BHW, 1, C))."""
    cfg = model.cfg
    x = preprocess_frames(frames_u8, net_hw, dtype=dtype)[None]
    feats = forward_features(model, x, attn_impl, fuse_proj)
    kernels, ln_kernel = kernel_set(attn_impl)
    h, w = x.shape[2:4]
    patch_hw = (h // cfg.vit.patch_size, w // cfg.vit.patch_size)
    stage_outs, held = [], []
    for j in range(frames_u8.shape[0]):
        feats_j = [(t[j:j + 1], None if c is None else c[j:j + 1])
                   for t, c in feats]
        ctx = []
        with trace.span("stream.context", device=x):
            for i, buf in enumerate(buffers):
                c = buf.index_select(1, ctx_rows[j]).to(dtype)
                for pos, src in held_at[j]:
                    c[:, pos] = held[src][i][:, 0]
                ctx.append(c)
        if cache_kind == "kv":
            ctx = [(ctx[2 * i], ctx[2 * i + 1]) for i in range(len(ctx) // 2)]
        stage_out, rows = dpt_head_temporal_stage(
            model.head, feats_j, patch_hw, 1, cfg,
            cached_hidden_state_list=ctx, cache_kind=cache_kind,
            kernels=kernels, ln_kernel=ln_kernel, mesh=tpm.model_mesh(model))
        stage_outs.append(stage_out)
        held.append(_leaves(rows, cache_kind))
    batched = tuple(torch.cat([s[i] for s in stage_outs]) for i in range(3))
    depth = dpt_head_temporal_tail(model.head, batched, patch_hw,
                                   micro_batch_size=len(stage_outs))
    depth = torch.relu(resize_bilinear(depth, (h, w), align_corners=True))
    depths = resize_bilinear(depth.float(), out_hw, align_corners=True)
    return depths[..., 0], held


@torch.no_grad()
def _stream_step_direct(model, frame_u8, buffers, pos_map, valid, net_hw,
                        out_hw, dtype, attn_impl, fuse_proj):
    """One causal step whose temporal attention reads the kv buffers in
    place (K6 with ``pos_map`` and ``valid``, (45,) device tensors; JAX
    ``_stream_step_direct``).  Reads the buffers and does not write them.
    Returns (depth, the flat new rows)."""
    x = preprocess_frames(frame_u8[None], net_hw, dtype=dtype)[None]
    feats = forward_features(model, x, attn_impl, fuse_proj)
    cache = [(buffers[2 * i], buffers[2 * i + 1], pos_map, valid)
             for i in range(len(buffers) // 2)]
    depth, rows = forward_depth(model, feats, x.shape,
                                cached_hidden_state_list=cache,
                                cache_kind="kv", attn_impl=attn_impl)
    return _to_out_depth(depth, out_hw), _leaves(rows, "kv")


@torch.no_grad()
def _stream_step_group_direct(model, frames_u8, buffers, pos_maps, valids,
                              write_pos, net_hw, out_hw, dtype, attn_impl,
                              fuse_proj):
    """k in-place steps in one call (JAX ``_stream_step_group_direct``): the
    encoder over the k frames in one batch, the cache-coupled head stage
    frame by frame with K6 reading the buffers in place at ``pos_maps[j]``
    / ``valids[j]`` ((k, 45) device tensors), each frame's new rows written
    into the buffers at ``write_pos[j]`` before the next frame's stage reads
    them, and one output tail over the k frames.  Returns depths (k, H, W)
    fp32."""
    cfg = model.cfg
    x = preprocess_frames(frames_u8, net_hw, dtype=dtype)[None]
    feats = forward_features(model, x, attn_impl, fuse_proj)
    kernels, ln_kernel = kernel_set(attn_impl)
    h, w = x.shape[2:4]
    patch_hw = (h // cfg.vit.patch_size, w // cfg.vit.patch_size)
    stage_outs = []
    for j in range(frames_u8.shape[0]):
        feats_j = [(t[j:j + 1], None if c is None else c[j:j + 1])
                   for t, c in feats]
        cache = [(buffers[2 * i], buffers[2 * i + 1], pos_maps[j], valids[j])
                 for i in range(len(buffers) // 2)]
        stage_out, rows = dpt_head_temporal_stage(
            model.head, feats_j, patch_hw, 1, cfg,
            cached_hidden_state_list=cache, cache_kind="kv",
            kernels=kernels, ln_kernel=ln_kernel)
        stage_outs.append(stage_out)
        with trace.span("stream.cache_write", device=x):
            _write_step(buffers, _leaves(rows, "kv"), write_pos[j])
    batched = tuple(torch.cat([s[i] for s in stage_outs]) for i in range(3))
    depth = dpt_head_temporal_tail(model.head, batched, patch_hw,
                                   micro_batch_size=len(stage_outs))
    depth = torch.relu(resize_bilinear(depth, (h, w), align_corners=True))
    depths = resize_bilinear(depth.float(), out_hw, align_corners=True)
    return depths[..., 0]


@torch.no_grad()
def _write_step(buffers, new_rows, write_pos: int) -> None:
    """Write each new (BHW, 1, C) row into its buffer at ``write_pos``, in
    place."""
    for buf, row in zip(buffers, new_rows):
        buf[:, write_pos] = row[:, 0].to(buf.dtype)


@torch.no_grad()
def _write_step_q8(buffers, scales, new_rows, write_pos: int,
                   mesh=None) -> None:
    """int8 ``_write_step``: each new (BHW, 1, C) row is quantised with one
    fp32 scale (its largest magnitude over 127, at least 1e-8 / 127),
    rounded half to even and clipped to [-127, 127]; the scale goes to
    ``scales[i][write_pos]``.  In place.  ``mesh``: the rows are this
    rank's channels, and the largest magnitude is taken over every rank's
    (one all-reduce MAX for all the rows)."""
    rows = [row[:, 0].float() for row in new_rows]
    amax = torch.stack([r.abs().max() for r in rows])
    if mesh is not None:
        tpm.all_reduce_(amax, mesh.model_group, op="max")
    for buf, sc, r, m in zip(buffers, scales, rows, amax):
        s = m.clamp_min(1e-8) / 127.0
        buf[:, write_pos] = torch.round(r / s).clamp_(-127, 127).to(torch.int8)
        sc[write_pos] = s


class StreamingDepth:
    """Stateful frame-by-frame depth (reference video_depth_stream.py:32-161
    ``infer_video_depth_one``), on the model's device.

    cache_kind: "kv" (default) caches the pre-PE K/V projections of every
    frame, so a step projects only the new frame; "h" caches the pre-PE
    hidden states as the reference does.  cache_dtype: "bf16" keeps rows in
    the working dtype, "int8" quantises each row with one scale
    (``_write_step_q8``); None resolves as JAX does
    (``_resolve_cache_dtype``).  ctx_kernel: run the kv cache's attention in
    K6, reading the buffers in place once the context's rows are distinct
    (``_direct_ok``); it needs cache_kind="kv" and the kernels (attn_impl
    "auto").  None reads ``VDA_STREAM_CTX_KERNEL`` and
    ``VDA_STREAM_DIRECT``, which yield where the kernel does not apply; an
    explicit True there raises.  fuse_proj: run the encoder blocks through
    K7 (JAX's ``VDA_ATTN_FUSE_PROJ=1``, which None reads); it needs the
    kernels.  (K10's gate refuses every batch-1 resize, so the stream
    offers no ``resize_kernel``.)  fp32: run the network in fp32 instead of
    bf16.  attn_impl: "auto" (the kernels), "xla" (JAX's training set: K2
    only) or "plain" (plain PyTorch everywhere).  mesh: a
    ``parallel/mesh.Mesh`` whose model axis is above 1 runs the stream
    tensor-parallel (every rank of the model group submits the same
    frames and gets the same depths); a mesh with one model rank changes
    nothing, as in JAX (a stream has no batch to fan out).  Without one,
    the mesh the model was sharded over (``parallel/mesh.use_mesh``); one
    other than that raises."""

    def __init__(self, model: VideoDepthAnything, input_size: int = 518,
                 fp32: bool = False, attn_impl: str = "auto",
                 cache_kind: str = "kv", cache_dtype: Optional[str] = None,
                 ctx_kernel: Optional[bool] = None,
                 fuse_proj: Optional[bool] = None, mesh=None):
        if mesh is None:
            mesh = tpm.model_mesh(model)
        self.mesh = mesh if tpm.tp_on(mesh) else None
        if self.mesh is not None and knobs.flag("VDA_STREAM_DIRECT"):
            raise ValueError("experimental streaming flavors do not support "
                             "tensor parallelism")
        for name in ("VDA_STREAM_RING", "VDA_STREAM_SLIDE"):
            if knobs.flag(name):
                raise ValueError(
                    f"{name}=1 picks a cache layout this package does not "
                    "have: on the H100 it gave the default stream's depths "
                    "in more device time a step (PERF.md, Findings); unset "
                    "it, or use ctx_kernel for K6's in-place read")
        fuse_proj = knobs.fuse_proj(fuse_proj, attn_impl)
        kernel_set(attn_impl, fuse_proj=fuse_proj)  # validates them
        if cache_kind not in ("kv", "h"):
            raise ValueError(f"cache_kind must be kv or h, got {cache_kind!r}")
        cache_dtype = _resolve_cache_dtype(cache_dtype)
        if cache_dtype not in ("bf16", "int8"):
            raise ValueError(f"cache_dtype must be bf16 or int8, "
                             f"got {cache_dtype!r}")
        unsupported = (cache_kind != "kv" or attn_impl != "auto"
                       or self.mesh is not None)
        if ctx_kernel is None:
            # the knobs yield where the kernel does not apply; only an
            # explicit True raises (JAX's rule)
            ctx_kernel = (knobs.flag("VDA_STREAM_CTX_KERNEL")
                          or knobs.flag("VDA_STREAM_DIRECT")) \
                and not unsupported
        if ctx_kernel and unsupported:
            raise ValueError("ctx_kernel requires cache_kind='kv', the "
                             "kernels (attn_impl='auto') and no tensor-"
                             "parallel mesh")
        tpm.use_mesh(model, mesh)  # shards it, or refuses another mesh
        self.model = model
        self.device = next(model.parameters()).device
        self.input_size = input_size
        self.dtype = torch.float32 if fp32 else torch.bfloat16
        self.attn_impl = attn_impl
        self.cache_kind = cache_kind
        self.cache_dtype = cache_dtype
        self.ctx_kernel = bool(ctx_kernel)
        self.fuse_proj = fuse_proj
        cfg = model.cfg
        widths = [mm.temporal_transformer.proj_in.weight.shape[0]
                  for mm in model.head.motion_modules]
        # K6 may read the buffers in place (JAX's direct gate): rows kept
        # in the working dtype, APE, and every motion module's width one
        # that K6 takes
        self._direct = self.ctx_kernel and cache_dtype == "bf16" and all(
            sk.use_kernel(1, c, cfg.num_attention_heads, cfg.pe)
            for c in widths)
        self._upload_frame = Upload(self.device)
        self._upload_rows = Upload(self.device)
        self._upload_pos = Upload(self.device)
        self._upload_valid = Upload(self.device)
        self.reset()

    def reset(self) -> None:
        self.id = -1
        self.net_hw: Optional[tuple] = None
        self.out_hw: Optional[tuple] = None
        self.buffers: Optional[List[torch.Tensor]] = None
        self.scales: Optional[List[torch.Tensor]] = None  # int8 cache only
        # logical frame id of each live cache entry, oldest first (the
        # reference's frame_cache_list); rows derive from ids via _row
        self.order: List[int] = []

    def __call__(self, frame) -> np.ndarray:
        """frame: (H, W, 3) uint8 RGB -> depth (H, W) fp32 on the host."""
        return self.submit(frame).cpu().numpy()

    def submit(self, frame) -> torch.Tensor:
        """Run one frame ((H, W, 3) uint8, numpy or tensor) and return its
        depth as an (H, W) fp32 tensor on the model's device.  The host does
        not wait for this frame's work to finish; reading the tensor
        does."""
        with trace.span("stream.step", device=self.device,
                        request=self.id + 1):
            trace.count("frames", 1)
            return self._submit(frame)

    def _submit(self, frame) -> torch.Tensor:
        frame_u8 = self._upload_frame(torch.as_tensor(frame))
        step_id = self.id + 1
        if self.net_hw is None:
            h, w = frame_u8.shape[:2]
            size = effective_input_size(h, w, self.input_size)
            net_hw = compute_resize_hw(h, w, size)
            depth, rows = _first_step(self.model, frame_u8, net_hw, (h, w),
                                      self.dtype, self.attn_impl,
                                      self.cache_kind, self.fuse_proj)
            self._init_buffers(rows)
            self.net_hw, self.out_hw = net_hw, (h, w)
            self.id = step_id
            # the replication trick (reference :118): the first INFER_LEN
            # logical entries all map to row 0
            self.order = [0] * INFER_LEN
            _evict(self.id, self.order)
            return depth
        if tuple(frame_u8.shape[:2]) != self.out_hw:
            raise ValueError(f"frame size changed mid-stream: "
                             f"{tuple(frame_u8.shape[:2])} after "
                             f"{self.out_hw}")
        # bookkeeping on a copy, committed once the step has run
        order = list(self.order)
        ctx, new_id = _advance_bookkeeping(step_id, order)
        ctx_rows = [_row(i) for i in ctx]
        if self._direct_ok(ctx_rows):
            pos_map, valid = self._maps(ctx_rows)
            depth, rows = _stream_step_direct(
                self.model, frame_u8, self.buffers, pos_map, valid,
                self.net_hw, self.out_hw, self.dtype, self.attn_impl,
                self.fuse_proj)
        else:
            depth, rows = _stream_step(
                self.model, frame_u8, self.buffers, self.scales,
                self._upload_rows(torch.tensor(ctx_rows)), self.net_hw,
                self.out_hw, self.dtype, self.attn_impl, self.cache_kind,
                self.ctx_kernel, self.fuse_proj)
        self._commit(rows, _row(new_id))
        self.id, self.order = step_id, order
        return depth

    def _direct_ok(self, *ctx_rows) -> bool:
        """K6 reads the buffers in place for these contexts' rows: the
        stream's gate (``_direct``) holds and every context entry sits in a
        distinct row (in the warmup the anchor row fills several positions,
        which only the gather expresses; from step 42 on, never)."""
        return self._direct and all(len(set(r)) == len(r) for r in ctx_rows)

    def _maps(self, *ctx_rows):
        """The position maps and valid flags of contexts, on the device by
        the pinned non-blocking copies (stacked when there are several)."""
        maps = [_pos_map(r) for r in ctx_rows]
        pos = np.stack([m for m, _ in maps])
        valid = np.stack([v for _, v in maps]).view(np.uint8)
        if len(ctx_rows) == 1:
            pos, valid = pos[0], valid[0]
        return (self._upload_pos(torch.from_numpy(pos)),
                self._upload_valid(torch.from_numpy(valid)))

    def submit_group(self, frames) -> torch.Tensor:
        """Run k frames ((k, H, W, 3) uint8, numpy or tensor) in one call
        and return their depths as a (k, H, W) fp32 device tensor (JAX
        ``submit_group``).  The context and eviction bookkeeping of the k
        steps is replayed exactly and the cache-coupled head stage runs
        frame by frame, so the cache afterwards is bit-identical to k
        ``submit`` calls; the encoder and the output tail run batched over
        the k frames, so the depths agree with ``submit``'s to the order of
        summation.  The new rows are written once the group has run.  With
        ``ctx_kernel``, a group whose every frame K6 reads in place
        (``_direct_ok``) runs as one call that writes each frame's rows
        before the next frame's stage (JAX's direct group); any other
        ``ctx_kernel`` group, and an int8 cache, runs k ``submit`` calls, as
        JAX does, so K6 runs every step.  The stream must have had its
        first frame (``submit``)."""
        with trace.span("stream.group", device=self.device,
                        request=self.id + 1):
            trace.count("frames", len(frames))
            return self._submit_group(frames)

    def _submit_group(self, frames) -> torch.Tensor:
        if self.net_hw is None:
            raise RuntimeError("initialize the stream with "
                               "submit(first_frame) before submit_group")
        frames = torch.as_tensor(frames)
        if tuple(frames.shape[1:3]) != self.out_hw:
            raise ValueError(f"frame size changed mid-stream: "
                             f"{tuple(frames.shape[1:3])} after {self.out_hw}")
        # bookkeeping of the k steps on a copy, committed once they have run
        order = list(self.order)
        ids, ctx_rows, held_at = [], [], []
        for j in range(len(frames)):
            ctx, new_id = _advance_bookkeeping(self.id + 1 + j, order)
            earlier = {gid: i for i, gid in enumerate(ids)}
            held_at.append([(pos, earlier[c]) for pos, c in enumerate(ctx)
                            if c in earlier])
            ctx_rows.append([_row(c) for c in ctx])
            ids.append(new_id)
        if self._direct_ok(*ctx_rows):
            pos_maps, valids = self._maps(*ctx_rows)
            depths = _stream_step_group_direct(
                self.model, self._upload_frame(frames), self.buffers,
                pos_maps, valids, [_row(i) for i in ids], self.net_hw,
                self.out_hw, self.dtype, self.attn_impl, self.fuse_proj)
        elif self.cache_dtype == "int8" or self.ctx_kernel:
            return torch.stack([self.submit(f) for f in frames])
        else:
            depths, held = _stream_step_group(
                self.model, self._upload_frame(frames), self.buffers,
                self._upload_rows(torch.tensor(ctx_rows)), held_at,
                self.net_hw, self.out_hw, self.dtype, self.attn_impl,
                self.cache_kind, self.fuse_proj)
            for new_id, rows in zip(ids, held):
                self._commit(rows, _row(new_id))
        self.id, self.order = self.id + len(frames), order
        return depths

    def _init_buffers(self, rows) -> None:
        """Zeroed (BHW, 45, C) buffers holding the first frame's rows at
        row 0."""
        int8 = self.cache_dtype == "int8"
        self.buffers = [torch.zeros(r.shape[0], _BUF_ROWS, r.shape[1],
                                    dtype=torch.int8 if int8 else r.dtype,
                                    device=r.device) for r in rows]
        self.scales = None
        if int8:
            self.scales = [torch.zeros(_BUF_ROWS, device=r.device)
                           for r in rows]
        self._commit([r[:, None] for r in rows], 0)

    def _commit(self, rows, write_pos: int) -> None:
        with trace.span("stream.cache_write", device=self.device):
            if self.scales is None:
                _write_step(self.buffers, rows, write_pos)
            else:
                _write_step_q8(self.buffers, self.scales, rows, write_pos,
                               self.mesh)

    def cache_bytes(self) -> int:
        """Device bytes the cache buffers (and scales) hold (this rank's
        under a mesh)."""
        bufs = (self.buffers or []) + (self.scales or [])
        return sum(b.numel() * b.element_size() for b in bufs)
