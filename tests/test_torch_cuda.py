"""The port's fourteen kernels against their plain twins on the card, over
the widths the model configs give them, the gradients of K2 and K10, and
one small forward, one small stream and two small train steps with and
without the kernels (and with K7/K10 switched on).

Needs an NVIDIA GPU with nvcc and Triton; elsewhere every test skips.  Run
on the GPU host from the repo root, without the JAX test configuration:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances, as max |kernel - twin| over max |twin|: bf16 K1/K2 against the
twin run in fp32 on the same bf16 inputs, 3.9e-3 (the repo's bf16-softmax
bound, docs/PARITY.md); bf16 K3/K4 against the bf16 twin, which rounds at
the same points, 2e-2 (the bound tests/test_pallas_temporal.py holds the
fused temporal kernels to); bf16 K5/K6 against the bf16 twin, which rounds
at the same points, 3.9e-3 (a summation order that flips one rounding moves
an output by at most one bf16 ulp), K5's Hopper code over the widths and
1369 sequences of ``test_k5_hopper_code`` against that twin's output
before its last rounding (one flipped output of the top binade is up to
2^-7 of the scale against the rounded twin; the kernel's own rounding at
most half an ulp); bf16 K9 as K1; bf16 K7 against the
bf16 twin, 2e-2 (the bound tests/test_attn_fuse_proj.py holds the JAX fused
kernel to); K10 bit-exact with its twin; bf16 K8 as K1; fp32, summation
order only, 1e-4.  K11 bit-exact with its twin (exact int32 sums, the same
rounding steps); K13 int8 exact, bf16 within 2^-8 of the scale against the
unrounded fp32 product (one output rounding); bf16 K12 and K14 against
their twins' unrounded outputs, 3.9e-3 (the output rounding is at most
half a bf16 ulp of the scale; the softmax variants round exp to bf16), K12
bf16sm 2e-2 (``bench_attn_variants.TOL_BF16SM`` says why).  K7 and K12
launches are asserted on the device loop their C entry points report
(``attn_proj_kernel.loop_of``, ``bench_attn_variants.loop_of``): "sm90"
for bf16 at head width 64 (K12: every variant but ``mma_sync``), "sm80"
otherwise; K7's design steps (``probes/bench_attn_proj_sm90.py``) against
their twins at small shapes.  K3 and K4 launches are asserted on the loop
``temporal_kernel.loop_of`` reports: "sm90" (the Hopper code: K3's fused
kernel at C 256, 8 heads, T 32, the chain elsewhere) for bf16 at head
widths a multiple of 16 up to 128, "sm80" otherwise; the Hopper code at the
main-path head widths within 2e-2 of the twin and of the kernels it
replaced, the design steps and the chain's stages
(``probes/bench_temporal_sm90.py``) against their twins.
"""

import numpy as np
import pytest
import torch

import vda_tpu_torch as vt
import vda_tpu_torch.ops as tops
from vda_tpu_torch.config import EncoderConfig, ModelConfig, get_config
from vda_tpu_torch.models.temporal import (TemporalTransformerBlock,
                                           sinusoidal_pe)
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
from vda_tpu_torch.ops.resize import resize_bilinear
from vda_tpu_torch.probes.bench_attn_proj_sm90 import VARIANTS as K7_VARIANTS
from vda_tpu_torch.probes.bench_attn_variants import VARIANTS as K12_VARIANTS
from vda_tpu_torch.probes.bench_gemm_sm90 import VARIANTS as GEMM_VARIANTS
from vda_tpu_torch.probes.bench_resize_sm90 import VARIANTS as K10_VARIANTS
from vda_tpu_torch.probes.bench_stream_sm90 import VARIANTS as K6_VARIANTS

pytestmark = pytest.mark.cuda

BF, F32 = torch.bfloat16, torch.float32
TOL = {BF: 3.9e-3, F32: 1e-4}
TOL_TEMPORAL = {BF: 2e-2, F32: 1e-4}


@pytest.fixture
def gen():
    """A seeded CUDA generator; skips where there is no card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


def _rel(ref, got):
    ref, got = ref.float(), got.float()
    assert torch.isfinite(got).all()
    return float((ref - got).abs().max() / ref.abs().max().clamp_min(1e-12))


def _launched(name, fn):
    """fn()'s result, checking that it made exactly one launch of ``name``."""
    before = tops.launch_counts()
    out = fn()
    torch.cuda.synchronize()
    after = tops.launch_counts()
    assert after[name] == before[name] + 1
    assert all(after[k] == before[k] for k in after if k != name)
    return out


def _on_gemm_loop(name, fn):
    """fn()'s result, checking that it made one launch of ``name`` (K11 or
    K13) and that the launch ran the Hopper GEMM loop."""
    from vda_tpu_torch.ops import quant

    before = dict(quant.gemm_launches_by_loop)
    out = _launched(name, fn)
    assert quant.gemm_launches_by_loop == {"sm90": before["sm90"] + 1,
                                           "sm80": before["sm80"]}
    return out


def _on_loop(counts, loop, fn):
    """fn()'s result, checking that it moved the by-loop counter dict
    ``counts()`` by one launch on ``loop``."""
    before = dict(counts())
    out = fn()
    torch.cuda.synchronize()
    after = counts()
    assert {k: after[k] - before[k] for k in after} == {
        "sm90": int(loop == "sm90"), "sm80": int(loop == "sm80")}
    return out


@pytest.mark.parametrize("dtype", [BF, F32])
@pytest.mark.parametrize("b,n,heads,dh,valid", [
    (2, 17, 2, 64, None), (2, 200, 3, 32, 150), (1, 1370, 16, 64, None),
    (3, 257, 6, 64, None), (2, 130, 2, 80, 129), (2, 64, 4, 128, None),
    (2, 65, 8, 8, 33), (1, 70, 24, 64, 1)])
def test_k1_attention_qkv(gen, dtype, b, n, heads, dh, valid):
    qkv = torch.randn(b, n, 3 * heads * dh, device="cuda", generator=gen)
    qkv = qkv.to(dtype)
    got = _launched("K1", lambda: attention_kernel.flash_attention_qkv(
        qkv, heads, dh ** -0.5, valid_len=valid))
    ref = attention_kernel.flash_attention_qkv_reference(
        qkv.float(), heads, dh ** -0.5, valid)
    assert got.dtype == dtype and got.shape == (b, n, heads * dh)
    assert _rel(ref, got) < TOL[dtype]


# The Hopper loop (bf16, head width 64): batch 1 (the stream step), vitl's
# window, vits-like 530 tokens, one full 64-row tile plus one row, keys
# masked past valid_len, and 2000 tokens (16 key tiles)
@pytest.mark.parametrize("b,n,heads,valid", [
    (1, 1370, 16, None), (32, 1370, 16, None), (2, 530, 2, None),
    (2, 65, 8, None), (3, 129, 4, 100), (2, 2000, 4, None)])
def test_k1_hopper_loop(gen, b, n, heads, valid):
    """K1 on the Hopper loop against its twin in fp32 on the same bf16
    inputs (TOL[bf16]); each launch counted on that loop; K9 bit-identical
    with it on column slices of the fused tensor and on contiguous copies
    (one entry point, one loop)."""
    qkv = torch.randn(b, n, 3 * heads * 64, device="cuda", generator=gen)
    qkv = qkv.to(BF)
    before = dict(attention_kernel.launches_by_loop)
    got = _launched("K1", lambda: attention_kernel.flash_attention_qkv(
        qkv, heads, 0.125, valid_len=valid))
    assert attention_kernel.launches_by_loop == {
        "sm90": before["sm90"] + 1, "sm80": before["sm80"]}
    ref = attention_kernel.flash_attention_qkv_reference(qkv.float(), heads,
                                                         0.125, valid)
    assert got.dtype == BF and got.shape == (b, n, heads * 64)
    assert _rel(ref, got) < TOL[BF]
    del ref
    if valid is None:
        sliced = qkv.split(heads * 64, dim=-1)
        for q, k, v in (sliced, [t.contiguous() for t in sliced]):
            assert torch.equal(attention_kernel.flash_attention_packed(
                q, k, v, heads, 0.125), got)


@pytest.mark.parametrize("dtype,dh,loop", [
    (BF, 64, "sm90"), (BF, 80, "sm80"), (BF, 32, "sm80"), (F32, 64, "sm80")])
def test_k1_loop_is_chosen_by_dtype_and_head_width(gen, dtype, dh, loop):
    """bf16 at head width 64 runs the Hopper loop; other widths and fp32 the
    mma.sync / fp32 loop, each counted once in ``launches_by_loop``."""
    qkv = torch.randn(2, 130, 3 * 2 * dh, device="cuda", generator=gen)
    qkv = qkv.to(dtype)
    assert attention_kernel.loop_of(dtype, dh) == loop
    before = dict(attention_kernel.launches_by_loop)
    got = attention_kernel.flash_attention_qkv(qkv, 2, dh ** -0.5)
    torch.cuda.synchronize()
    after = attention_kernel.launches_by_loop
    assert {k: after[k] - before[k] for k in after} == {
        "sm90": int(loop == "sm90"), "sm80": int(loop == "sm80")}
    ref = attention_kernel.flash_attention_qkv_reference(qkv.float(), 2,
                                                         dh ** -0.5)
    assert _rel(ref, got) < TOL[dtype]


@pytest.mark.parametrize("dtype", [BF, F32, torch.float16])
@pytest.mark.parametrize("c", [128, 384, 768, 1024, 1536, 8192])
def test_k2_layer_norm(gen, dtype, c):
    x = (torch.randn(3, 37, c, device="cuda", generator=gen) * 2 + 0.5)
    x = x.to(dtype)
    w = torch.randn(c, device="cuda", generator=gen)
    b = torch.randn(c, device="cuda", generator=gen)
    got = _launched("K2", lambda: norm_kernel.fused_layer_norm(x, w, b, 1e-5))
    ref = norm_kernel.layer_norm_reference(x.float(), w, b, 1e-5)
    assert got.dtype == dtype
    assert _rel(ref, got) < TOL.get(dtype, TOL[BF])


def _block(c, gen):
    """A TemporalTransformerBlock of width c (8 heads) with seeded weights."""
    blk = TemporalTransformerBlock(c, get_config("vitl"), device="cuda")
    blk.requires_grad_(False)
    for p in blk.parameters():
        p.uniform_(-c ** -0.5, c ** -0.5, generator=gen)
    for nrm in [*blk.norms, blk.ff_norm]:
        nrm.weight.add_(1.0)
    return blk


# Every shape the JAX gate admits launches: at C=512 and T=64, and with
# heads 8 wide, part of the working set lives in the device-memory workspace.
@pytest.mark.parametrize("dtype", [BF, F32])
@pytest.mark.parametrize("c,t,bd,heads", [
    (128, 32, 9, 8), (128, 20, 7, 8), (256, 32, 5, 8), (256, 16, 11, 8),
    (384, 32, 3, 8), (512, 32, 2, 8), (512, 64, 3, 8), (256, 32, 3, 32),
    (384, 40, 2, 48)])
def test_k3_temporal_block(gen, dtype, c, t, bd, heads):
    assert temporal_kernel.fused_block_supported(c, t, "ape", heads)
    blk = _block(c, gen)
    pe = sinusoidal_pe(t, c)[0].cuda()  # the model's table holds 32 frames
    h = torch.randn(bd, t, c, device="cuda", generator=gen).to(dtype)
    loop = temporal_kernel.loop_of(dtype, c, heads, t, True)
    assert loop == ("sm90" if dtype == BF and (c // heads) % 16 == 0
                    else "sm80")
    got = _on_loop(lambda: temporal_kernel.launches_by_loop["K3"], loop,
                   lambda: _launched("K3", lambda: (
                       temporal_kernel.temporal_block_fused(blk, h, pe,
                                                            heads))))
    ref = temporal_kernel.temporal_block_reference(blk, h, pe, heads)
    assert _rel(ref, got) < TOL_TEMPORAL[dtype]


# fp32 at C=1024, bf16 at C=1024 with T > 32, and one 1024-wide head place
# buffers in the workspace; they launch like the rest.
@pytest.mark.parametrize("dtype", [BF, F32])
@pytest.mark.parametrize("c,t,bd,heads", [
    (640, 32, 5, 8), (768, 20, 4, 8), (1024, 32, 3, 8), (1024, 64, 3, 8),
    (1024, 48, 2, 8), (1024, 32, 2, 1), (896, 7, 5, 56)])
def test_k4_attention_block(gen, dtype, c, t, bd, heads):
    assert temporal_kernel.attn_fused_supported(c, t, "ape", heads)
    blk = _block(c, gen)
    attn, norm = blk.attention_blocks[1], blk.norms[1]
    pe = sinusoidal_pe(t, c)[0].cuda()
    h = torch.randn(bd, t, c, device="cuda", generator=gen).to(dtype)
    loop = temporal_kernel.loop_of(dtype, c, heads, t, False)
    dh = c // heads
    assert loop == ("sm90" if dtype == BF and dh % 16 == 0 and dh <= 128
                    else "sm80")
    got = _on_loop(lambda: temporal_kernel.launches_by_loop["K4"], loop,
                   lambda: _launched("K4", lambda: (
                       temporal_kernel.attention_block_fused(attn, norm, h,
                                                             pe, heads))))
    ref = temporal_kernel.attention_block_reference(attn, norm, h, pe, heads)
    assert _rel(ref, got) < TOL_TEMPORAL[dtype]


# K3 and K4 on the Hopper code at the main-path head widths (vitl K3 32,
# K4 128; vitb K3 16, K4 96; vits K3 48), ragged BD: within 2e-2 of the bf16
# twin and of the kernels they replaced (the probe's "sm80" step) on the
# same values, every launch on "sm90".  vitl's K3 (C = 256) runs the fused
# kernel and is also held to the chain (the probe's "chain" step); BD 1 and
# 37 leave a cluster pair's second tile past the last row.
@pytest.mark.parametrize("bd", [1, 5, 37, 361])
@pytest.mark.parametrize("c", [256, 128, 384])
def test_k3_hopper_kernel(gen, c, bd):
    from vda_tpu_torch.probes import bench_temporal_sm90 as bt

    blk = _block(c, gen)
    pe = sinusoidal_pe(32, c)[0].cuda()
    h = torch.randn(bd, 32, c, device="cuda", generator=gen).to(BF)
    assert temporal_kernel.loop_of(BF, c, 8, 32, True) == "sm90"
    got = _on_loop(lambda: temporal_kernel.launches_by_loop["K3"], "sm90",
                   lambda: _launched("K3", lambda: (
                       temporal_kernel.temporal_block_fused(blk, h, pe, 8))))
    assert _rel(temporal_kernel.temporal_block_reference(blk, h, pe, 8),
                got) < TOL_TEMPORAL[BF]
    assert _rel(temporal_kernel.temporal_block_stages(blk, h, pe, 8),
                got) < TOL_TEMPORAL[BF]
    assert _rel(bt.variant("sm80", blk, h, pe, True), got) < TOL_TEMPORAL[BF]
    if c == 256:
        assert _rel(bt.variant("chain", blk, h, pe, True), got) < \
            TOL_TEMPORAL[BF]


# The fused K3 launched back to back gives the same bits every time: a race
# between its producer and its consumers (a slot read before its weights
# land, a tile stored before its last epilogue) would show as a difference.
# 1369 sequences leave a cluster pair's last tile past the end.
@pytest.mark.parametrize("step", ["fused", "fused_cl1", "fused_split",
                                  "fused_lag"])
def test_k3_fused_kernel_repeats_bit_for_bit(gen, step):
    from vda_tpu_torch.probes import bench_temporal_sm90 as bt

    blk = _block(256, gen)
    pe = sinusoidal_pe(32, 256)[0].cuda()
    h = torch.randn(1369, 32, 256, device="cuda", generator=gen).to(BF)
    first = bt.variant(step, blk, h, pe, True)
    for _ in range(30):
        assert torch.equal(bt.variant(step, blk, h, pe, True), first)
    assert _rel(bt.twin(blk, h, pe, True), first) < TOL_TEMPORAL[BF]


@pytest.mark.parametrize("bd", [1, 5, 37, 361])
@pytest.mark.parametrize("c", [1024, 768])
def test_k4_hopper_kernel(gen, c, bd):
    from vda_tpu_torch.probes import bench_temporal_sm90 as bt

    blk = _block(c, gen)
    attn, norm = blk.attention_blocks[0], blk.norms[0]
    pe = sinusoidal_pe(32, c)[0].cuda()
    h = torch.randn(bd, 32, c, device="cuda", generator=gen).to(BF)
    assert temporal_kernel.loop_of(BF, c, 8, 32, False) == "sm90"
    got = _on_loop(lambda: temporal_kernel.launches_by_loop["K4"], "sm90",
                   lambda: _launched("K4", lambda: (
                       temporal_kernel.attention_block_fused(attn, norm, h,
                                                             pe, 8))))
    assert _rel(temporal_kernel.attention_block_reference(attn, norm, h, pe,
                                                          8),
                got) < TOL_TEMPORAL[BF]
    assert _rel(temporal_kernel.attention_sub_stages(attn, norm, h, pe, 8),
                got) < TOL_TEMPORAL[BF]
    assert _rel(bt.variant("sm80", blk, h, pe, False), got) < TOL_TEMPORAL[BF]


# The design steps (the fused ones K3's alone) and each of the chain's
# stages alone (probes/bench_temporal_sm90.py) against their twins at small
# shapes.
@pytest.mark.parametrize("c,bd", [(256, 37), (1024, 5)])
def test_temporal_design_steps_and_stages(gen, c, bd):
    from vda_tpu_torch.probes import bench_temporal_sm90 as bt

    full = c <= 512
    blk = _block(c, gen)
    pe = sinusoidal_pe(32, c)[0].cuda()
    h = torch.randn(bd, 32, c, device="cuda", generator=gen).to(BF)
    want = bt.twin(blk, h, pe, full)
    for name in bt.VARIANTS:
        if name in bt.K3_ONLY and not full:
            continue
        got = bt.variant(name, blk, h, pe, full)
        if name in bt.PARTS:  # parts of the fused kernel write nothing
            assert (got == 0).all(), name
        else:
            assert _rel(want, got) < TOL_TEMPORAL[BF], name
    for name, (args, ref) in bt.stage_inputs(blk, h, pe, full).items():
        assert _rel(ref, bt.stage(name, full, *args, 32)) < \
            TOL_TEMPORAL[BF], name


def test_wrappers_refuse_what_the_kernels_do_not_take(gen):
    qkv = torch.randn(2, 40, 3 * 128, device="cuda", generator=gen).to(BF)
    with pytest.raises(ValueError):  # a strided view
        attention_kernel.flash_attention_qkv(qkv[:, ::2], 2, 0.125)
    with pytest.raises(ValueError):  # fp16
        attention_kernel.flash_attention_qkv(qkv.half(), 2, 0.125)
    with pytest.raises(ValueError):  # head width 4
        attention_kernel.flash_attention_qkv(qkv[..., :96].contiguous(), 8,
                                             0.5)
    x = qkv[..., :128].float().requires_grad_()  # K2 is differentiable
    norm_kernel.fused_layer_norm(x, torch.ones(128, device="cuda"),
                                 torch.zeros(128, device="cuda")).sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()
    blk = _block(256, gen)
    h = torch.randn(4, 32, 256, device="cuda", generator=gen).to(BF)
    pe = blk.attention_blocks[0].pos_encoder.pe[0]
    with pytest.raises(ValueError):  # a transposed view
        temporal_kernel.temporal_block_fused(blk, h.transpose(0, 1), pe, 8)
    with pytest.raises(ValueError):  # 6 heads of width 42.67
        temporal_kernel.temporal_block_fused(blk, h, pe, 6)
    with pytest.raises(ValueError):  # C=192 is not a multiple of 128
        temporal_kernel.temporal_block_fused(
            _block(192, gen), torch.zeros(2, 32, 192, device="cuda"),
            sinusoidal_pe(32, 192)[0].cuda(), 8)
    with pytest.raises(ValueError):  # T=65 sequences
        temporal_kernel.attention_block_fused(
            blk.attention_blocks[0], blk.norms[0],
            torch.zeros(2, 65, 256, device="cuda"),
            sinusoidal_pe(65, 256)[0].cuda(), 8)
    with pytest.raises(ValueError):  # fp16
        temporal_kernel.temporal_block_fused(blk, h.half(), pe, 8)


# (C, heads): vits mm0/mm2 (192, 64), vitl mm0/mm2 (1024, 256), vitg
# mm0 and its head (1536, 384), a 16-head C=128, one 1024-wide head
K5_WIDTHS = [(192, 8), (64, 8), (1024, 8), (256, 8), (1536, 8), (384, 8),
             (128, 16), (1024, 1)]


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("dtype", [BF, F32])
@pytest.mark.parametrize("c,heads", K5_WIDTHS)
@pytest.mark.parametrize("t", [1, 7, 32, 64])
def test_k5_tiny_seq_attention(gen, t, c, heads, dtype, fused):
    bd = 37 if c <= 256 else 5
    if fused:  # column slices of one (BD, T, 3C) projection
        q, k, v = torch.randn(bd, t, 3 * c, device="cuda",
                              generator=gen).to(dtype).split(c, dim=-1)
    else:
        q, k, v = (torch.randn(bd, t, c, device="cuda", generator=gen)
                   .to(dtype) for _ in range(3))
    scale = (c // heads) ** -0.5
    assert tiny_seq_kernel.use_kernel(t, t, c // heads)
    got = _launched("K5", lambda: tiny_seq_kernel.tiny_seq_attention(
        q, k, v, heads, scale))
    ref = tiny_seq_kernel.tiny_seq_attention_reference(q, k, v, heads, scale)
    assert got.dtype == dtype and got.shape == (bd, t, c)
    assert _rel(ref, got) < TOL[dtype]


@pytest.mark.parametrize("dtype", [BF, F32])
@pytest.mark.parametrize("bhw,rows,c,heads,n_valid", [
    (1, 31, 1024, 8, 31), (37, 31, 256, 8, 31), (37, 31, 256, 8, 17),
    (5, 31, 64, 8, 0), (19, 31, 192, 8, 30), (3, 31, 384, 6, 31),
    (2, 31, 512, 1, 31), (7, 5, 1024, 8, 2), (1369, 31, 1024, 8, 31),
    (32, 43, 1024, 8, 31), (33, 43, 256, 8, 40), (5476, 31, 256, 8, 31),
    (4, 31, 384, 8, 31), (3, 70, 96, 12, 65)])
def test_k6_stream_kv_attention(gen, dtype, bhw, rows, c, heads, n_valid):
    """K6 against its twin, on the loop ``loop_of`` names: the Hopper loop
    in bf16 at head widths a multiple of 8 up to 128 (more than one 32-row
    chunk at 43 and 70 rows), the old kernel in fp32 and at 512."""
    def mk(*shape):
        return torch.randn(*shape, device="cuda", generator=gen).to(dtype)
    q, kn, vn = mk(bhw, c), mk(bhw, c), mk(bhw, c)
    kb, vb = mk(bhw, rows, c), mk(bhw, rows, c)
    pk, pv = mk(rows, c), mk(rows, c)
    valid = torch.zeros(rows, dtype=torch.bool, device="cuda")
    valid[torch.randperm(rows, device="cuda", generator=gen)[:n_valid]] = 1
    kb[:, ~valid] = float("nan")  # rows that are not valid are never read
    vb[:, ~valid] = float("nan")
    scale = (c // heads) ** -0.5
    assert stream_kernel.use_kernel(1, c, heads, "ape")
    loop = "sm90" if dtype == BF and c // heads <= 128 else "sm80"
    assert stream_kernel.loop_of(dtype, c, heads) == loop
    got = _on_loop(lambda: stream_kernel.launches_by_loop, loop,
                   lambda: _launched("K6", lambda: (
                       stream_kernel.stream_kv_attention(
                           q, kn, vn, kb, vb, pk, pv, valid, heads, scale))))
    ref = stream_kernel.stream_kv_attention_reference(
        q, kn, vn, kb, vb, pk, pv, valid, heads, scale)
    assert got.dtype == dtype and got.shape == (bhw, c)
    assert _rel(ref, got) < TOL[dtype]


# K6's Hopper loop launched back to back gives the same bits every time (its
# sums have one order), at the stream shapes of mm0 and mm3
@pytest.mark.parametrize("bhw,c", [(1369, 1024), (5476, 256)])
def test_k6_repeats_bit_for_bit(gen, bhw, c):
    from vda_tpu_torch.probes import bench_stream_sm90 as bs

    ins = bs.inputs(gen, bhw, 31, c)
    args = (ins["q"], ins["kn"], ins["vn"], ins["kb"], ins["vb"], ins["pk"],
            ins["pv"], stream_kernel.all_valid(31, ins["q"].device), 8,
            ins["scale"])
    first = stream_kernel.stream_kv_attention(*args)
    for _ in range(30):
        assert torch.equal(stream_kernel.stream_kv_attention(*args), first)
    assert _rel(bs.twin("sm90", ins), first) < TOL[BF]


@pytest.mark.parametrize("step", list(K6_VARIANTS))
def test_k6_design_steps(gen, step):
    """Each step of probes/bench_stream_sm90.py against what it writes: the
    twin (no_pe: with zero encodings) within K6's bound, or an output left
    at zero.  k_ahead takes one 32-row chunk an item and refuses more
    rows."""
    from vda_tpu_torch.probes import bench_stream_sm90 as bs

    for bhw, rows, c in ((37, 31, 1024), (40, 31, 256), (9, 43, 1024)):
        ins = bs.inputs(gen, bhw, rows, c)
        if step == "k_ahead" and rows > 31:
            with pytest.raises(RuntimeError, match="vda_stream_kv_variant"):
                bs.variant(step, ins)
            continue
        got = bs.variant(step, ins)
        torch.cuda.synchronize()
        want = bs.twin(step, ins)
        if step in bs.PARTS:
            assert torch.equal(got, want)
        else:
            assert _rel(want, got) < TOL[BF], (bhw, rows, c)


def test_k5_k6_wrappers_refuse_what_the_kernels_do_not_take(gen):
    x = torch.randn(4, 8, 3 * 64, device="cuda", generator=gen).to(BF)
    q, k, v = x.split(64, dim=-1)
    with pytest.raises(ValueError):  # k and v laid out unlike q
        tiny_seq_kernel.tiny_seq_attention(q, k.contiguous(), v, 8, 0.3)
    with pytest.raises(ValueError):  # head width 4
        tiny_seq_kernel.tiny_seq_attention(q, k, v, 16, 0.3)
    with pytest.raises(ValueError):  # 65 frames
        y = torch.zeros(2, 65, 64, device="cuda")
        tiny_seq_kernel.tiny_seq_attention(y, y, y, 8, 0.3)
    with pytest.raises(ValueError):  # fp16
        tiny_seq_kernel.tiny_seq_attention(q.half(), k.half(), v.half(), 8,
                                           0.3)
    with pytest.raises(ValueError):  # rows not 16-byte aligned
        y = torch.zeros(4, 8, 65, device="cuda", dtype=BF)[..., 1:]
        tiny_seq_kernel.tiny_seq_attention(y, y, y, 8, 0.3)
    row = torch.zeros(3, 256, device="cuda", dtype=BF)
    buf = torch.zeros(3, 31, 256, device="cuda", dtype=BF)
    pe = torch.zeros(31, 256, device="cuda", dtype=BF)
    ok = torch.ones(31, dtype=torch.bool, device="cuda")
    with pytest.raises(ValueError):  # a strided context
        stream_kernel.stream_kv_attention(row, row, row, buf.transpose(0, 1)
                                          .contiguous().transpose(0, 1),
                                          buf, pe, pe, ok, 8, 0.1)
    with pytest.raises(ValueError):  # pe of the wrong length
        stream_kernel.stream_kv_attention(row, row, row, buf, buf, pe[:30],
                                          pe, ok, 8, 0.1)
    with pytest.raises(ValueError):  # head width 4
        stream_kernel.stream_kv_attention(row, row, row, buf, buf, pe, pe,
                                          ok, 64, 0.1)
    with pytest.raises(ValueError):  # fp16
        stream_kernel.stream_kv_attention(
            row.half(), row.half(), row.half(), buf.half(), buf.half(),
            pe.half(), pe.half(), ok, 8, 0.1)
    with pytest.raises(ValueError):  # more rows than shared memory holds
        big = torch.zeros(1, 200, 512, device="cuda")
        r1 = torch.zeros(1, 512, device="cuda")
        stream_kernel.stream_kv_attention(
            r1, r1, r1, big, big, big[0], big[0],
            torch.ones(200, dtype=torch.bool, device="cuda"), 1, 0.1)


@pytest.mark.parametrize("dtype", [BF, F32])
@pytest.mark.parametrize("b,n,heads,dh", [
    (2, 530, 2, 64), (1, 1370, 16, 64), (2, 257, 6, 64), (2, 130, 2, 80),
    (2, 64, 4, 128), (2, 65, 8, 8)])
def test_k9_attention_packed(gen, dtype, b, n, heads, dh):
    """K9 on three separate tensors, and on column slices of one fused
    projection: both bit-identical with K1 on the fused tensor, which runs
    the same device code."""
    qkv = torch.randn(b, n, 3 * heads * dh, device="cuda", generator=gen)
    qkv = qkv.to(dtype)
    q, k, v = (t.contiguous() for t in qkv.split(heads * dh, dim=-1))
    scale = dh ** -0.5
    got = _launched("K9", lambda: attention_kernel.flash_attention_packed(
        q, k, v, heads, scale))
    ref = attention_kernel.flash_attention_packed_reference(
        q.float(), k.float(), v.float(), heads, scale)
    assert got.dtype == dtype and got.shape == (b, n, heads * dh)
    assert _rel(ref, got) < TOL[dtype]
    fused = attention_kernel.flash_attention_qkv(qkv, heads, scale)
    sliced = attention_kernel.flash_attention_packed(
        *qkv.split(heads * dh, dim=-1), heads, scale)
    assert torch.equal(fused, got) and torch.equal(sliced, got)
    got4 = attention_kernel.flash_attention(
        *(t.view(b, n, heads, dh) for t in (q, k, v)), scale)
    assert torch.equal(got4.reshape(b, n, heads * dh), got)


def _k7_inputs(gen, b, n, heads, dh, dtype):
    """qkv, w (out, in), gamma_bias and x, scaled so that the attention
    branch and the residual are of one size."""
    c = heads * dh
    def mk(*shape, s=1.0):
        return torch.randn(*shape, device="cuda", generator=gen) * s
    qkv = mk(b, n, 3 * c, s=2.0).to(dtype)
    w = mk(c, c, s=c ** -0.5).to(dtype)
    gb = torch.stack([1 + 0.5 * mk(c), mk(c, s=0.1)])
    x = mk(b, n, c, s=0.1).to(dtype)
    return qkv, w, gb, x


# (B, N, heads, dh): vits/vitb/vitl widths at their window lengths, ragged
# N, a width that is not a multiple of 64, heads of 128 and of 8
@pytest.mark.parametrize("dtype", [BF, F32])
@pytest.mark.parametrize("b,n,heads,dh,valid", [
    (2, 530, 6, 64, None), (1, 1370, 12, 64, None), (2, 1370, 16, 64, None),
    (2, 300, 16, 64, 257), (2, 77, 5, 24, None), (2, 65, 8, 128, None),
    (3, 130, 2, 8, 129), (1, 17, 2, 64, 1)])
def test_k7_attention_proj(gen, dtype, b, n, heads, dh, valid):
    """K7 against its twin on the same inputs (bf16: the bound the JAX
    package holds its fused kernel to, tests/test_attn_fuse_proj.py)."""
    qkv, w, gb, x = _k7_inputs(gen, b, n, heads, dh, dtype)
    scale = dh ** -0.5
    loop = attn_proj_kernel.loop_of(dtype, dh)
    assert loop == ("sm90" if dtype == BF and dh == 64 else "sm80")
    got = _on_loop(lambda: attn_proj_kernel.launches_by_loop, loop,
                   lambda: _launched(
                       "K7", lambda: attn_proj_kernel.flash_attention_qkv_proj(
                           qkv, w, gb, x, heads, scale, valid)))
    ref = attn_proj_kernel.flash_attention_qkv_proj_reference(
        qkv, w, gb, x, heads, scale, valid)
    assert got.dtype == dtype and got.shape == x.shape
    assert _rel(ref, got) < TOL_TEMPORAL[dtype]


# K7 on the Hopper kernel at vits, vitb and vitl widths (6, 12, 16 heads of
# 64): N of one token, one row short of a 64-row tile, one tile, one tile
# and a row, and vitl's 1370; batch 1 (the stream step) and 3; all keys, or
# keys masked from about two thirds of N on
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("n", [1, 63, 64, 65, 1370])
@pytest.mark.parametrize("heads", [6, 12, 16])
def test_k7_hopper_kernel(gen, heads, n, b, masked):
    """bf16 K7 at head width 64 against its twin (TOL_TEMPORAL[bf16]),
    each launch counted on the Hopper kernel."""
    valid = max(1, 2 * n // 3) if masked else None
    if masked and valid == n:
        valid = n - 1 if n > 1 else None
    qkv, w, gb, x = _k7_inputs(gen, b, n, heads, 64, BF)
    got = _on_loop(lambda: attn_proj_kernel.launches_by_loop, "sm90",
                   lambda: _launched(
                       "K7", lambda: attn_proj_kernel.flash_attention_qkv_proj(
                           qkv, w, gb, x, heads, 0.125, valid)))
    ref = attn_proj_kernel.flash_attention_qkv_proj_reference(
        qkv, w, gb, x, heads, 0.125, valid)
    assert got.dtype == BF and got.shape == x.shape
    assert _rel(ref, got) < TOL_TEMPORAL[BF]


@pytest.mark.parametrize("heads", [1, 3, 5, 7])
def test_k7_hopper_kernel_odd_heads(gen, heads):
    """An odd head count splits unevenly across the cluster pair (one head:
    the second block attends to none and only projects)."""
    qkv, w, gb, x = _k7_inputs(gen, 2, 130, heads, 64, BF)
    got = _on_loop(lambda: attn_proj_kernel.launches_by_loop, "sm90",
                   lambda: attn_proj_kernel.flash_attention_qkv_proj(
                       qkv, w, gb, x, heads, 0.125, 100))
    ref = attn_proj_kernel.flash_attention_qkv_proj_reference(
        qkv, w, gb, x, heads, 0.125, 100)
    assert _rel(ref, got) < TOL_TEMPORAL[BF]


@pytest.mark.parametrize("dtype,dh,loop", [
    (BF, 64, "sm90"), (BF, 32, "sm80"), (F32, 64, "sm80")])
def test_k7_loop_is_chosen_by_dtype_and_head_width(gen, dtype, dh, loop):
    """bf16 at head width 64 runs the Hopper kernel; fp32 and a head width
    of 32 the mma.sync / fp32 kernels, each counted once."""
    heads = 512 // dh
    qkv, w, gb, x = _k7_inputs(gen, 2, 130, heads, dh, dtype)
    assert attn_proj_kernel.loop_of(dtype, dh) == loop
    got = _on_loop(lambda: attn_proj_kernel.launches_by_loop, loop,
                   lambda: attn_proj_kernel.flash_attention_qkv_proj(
                       qkv, w, gb, x, heads, dh ** -0.5, 100))
    ref = attn_proj_kernel.flash_attention_qkv_proj_reference(
        qkv, w, gb, x, heads, dh ** -0.5, 100)
    assert _rel(ref, got) < TOL_TEMPORAL[dtype]


@pytest.mark.parametrize("variant", list(K7_VARIANTS))
def test_k7_design_steps_agree_with_their_twins(gen, variant):
    """Every step of probes/bench_attn_proj_sm90.py at vitl's width (16
    heads) over 130 tokens with keys masked past 100, and at vits's (6
    heads) over 65: the function's steps within K7's bound, the two that
    run one phase alone (x + gamma * bias) exactly."""
    from vda_tpu_torch.probes import bench_attn_proj_sm90 as bp

    for b, n, heads, valid in ((2, 130, 16, 100), (1, 65, 6, None)):
        qkv, w, gb, x = bp.inputs(gen, b, n, heads)
        got = bp.attn_proj(variant, qkv, w, gb, x, heads, 0.125, valid)
        torch.cuda.synchronize()
        ref = bp.attn_proj_reference(variant, qkv, w, gb, x, heads, 0.125,
                                     valid)
        ok, r = bp.agrees(variant, got, ref)
        assert ok, (b, n, heads, r)


# the two vitl window shapes (at batch 8), the gate's cases of
# tests/test_ops.py, an odd ratio and a 16-row block
K10_CASES = [((8, 148, 148, 256), (296, 296)),
             ((8, 296, 296, 128), (518, 518)),
             ((8, 20, 24, 128), (32, 40)), ((8, 148, 16, 128), (296, 28)),
             ((9, 9, 7, 256), (14, 13)), ((8, 5, 3, 384), (32, 7)),
             ((16, 148, 148, 256), (296, 296)),
             ((16, 296, 296, 128), (518, 518)),
             ((8, 300, 330, 128), (518, 518)), ((8, 3, 1000, 256), (7, 2000))]


@pytest.mark.parametrize("shape,out_hw", K10_CASES)
def test_k10_resize_bilinear(gen, shape, out_hw):
    """K10 is bit-exact with its twin, on a contiguous input and on
    strided ones: channels sliced from a wider tensor and H/W transposed
    (read through their strides), channels-first memory (made contiguous by
    the wrapper)."""
    x = torch.randn(*shape, device="cuda", generator=gen).to(BF)
    assert resize_kernel.supported(x, out_hw, True, None)
    got = _launched("K10", lambda: resize_kernel.resize_bilinear_fused(
        x, out_hw))
    ref = resize_kernel.resize_bilinear_fused_reference(x, out_hw)
    assert got.shape == (shape[0], *out_hw, shape[3]) and got.dtype == BF
    assert torch.equal(got, ref)
    wide = torch.cat([x, x], dim=-1)[..., :shape[3]]
    assert torch.equal(resize_kernel.resize_bilinear_fused(wide, out_hw), ref)
    for odd in (x.transpose(1, 2).contiguous().transpose(1, 2),
                x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)):
        assert torch.equal(resize_kernel.resize_bilinear_fused(odd, out_hw),
                           ref)
    plain = _rel(resize_bilinear(x.float(), out_hw), got)
    assert plain < 2e-2  # tests/test_ops.py's bound against fp32


# K10 launched back to back gives the same bits every time: a row read
# from shared memory before its lerp lands, or rewritten while another warp
# still reads it, would show as a difference
@pytest.mark.parametrize("shape,out_hw", K10_CASES[6:8])
def test_k10_repeats_bit_for_bit(gen, shape, out_hw):
    x = torch.randn(*shape, device="cuda", generator=gen).to(BF)
    first = resize_kernel.resize_bilinear_fused(x, out_hw)
    for _ in range(30):
        assert torch.equal(resize_kernel.resize_bilinear_fused(x, out_hw),
                           first)
    assert torch.equal(first,
                       resize_kernel.resize_bilinear_fused_reference(x,
                                                                     out_hw))


@pytest.mark.parametrize("step", list(K10_VARIANTS))
def test_k10_design_steps(gen, step):
    """Each step of probes/bench_resize_sm90.py: old and sm90 bit for bit
    with the twin; loads leave an output of zeros as it was, stores write
    zeros over every element of one filled with NaN."""
    from vda_tpu_torch.probes import bench_resize_sm90 as br

    for shape, out_hw in (((8, 20, 24, 128), (32, 40)),
                          ((9, 37, 37, 256), (70, 74))):
        x = torch.randn(*shape, device="cuda", generator=gen).to(BF)
        assert resize_kernel.supported(x, out_hw, True, None)
        fill = float("nan") if step == "stores" else 0.0
        out = torch.full((shape[0], *out_hw, shape[3]), fill, device="cuda",
                         dtype=BF)
        got = br.variant(step, x, out_hw, out)
        torch.cuda.synchronize()
        assert torch.equal(got, br.twin(step, x, out_hw)), (shape, out_hw)


def test_k7_k9_k10_refuse_what_the_kernels_do_not_take(gen):
    qkv, w, gb, x = _k7_inputs(gen, 2, 64, 24, 64, BF)  # vitg C=1536
    with pytest.raises(ValueError):
        attn_proj_kernel.flash_attention_qkv_proj(qkv, w, gb, x, 24, 0.125)
    qkv, w, gb, x = _k7_inputs(gen, 2, 64, 4, 64, BF)
    with pytest.raises(ValueError):  # w not in the working dtype
        attn_proj_kernel.flash_attention_qkv_proj(qkv, w.float(), gb, x, 4,
                                                  0.125)
    with pytest.raises(ValueError):  # gamma_bias not fp32
        attn_proj_kernel.flash_attention_qkv_proj(qkv, w, gb.to(BF), x, 4,
                                                  0.125)
    with pytest.raises(ValueError):  # a strided residual
        attn_proj_kernel.flash_attention_qkv_proj(
            qkv, w, gb, torch.cat([x, x], -1)[..., :256], 4, 0.125)
    with pytest.raises(NotImplementedError):  # no backward yet
        attn_proj_kernel.flash_attention_qkv_proj(
            qkv, w, gb, x.float().requires_grad_().to(BF), 4, 0.125)
    q = torch.randn(2, 64, 256, device="cuda", generator=gen).to(BF)
    with pytest.raises(ValueError):  # k laid out unlike q
        attention_kernel.flash_attention_packed(
            q, torch.cat([q, q], -1)[..., :256], q, 4, 0.125)
    with pytest.raises(ValueError):  # fp16
        attention_kernel.flash_attention_packed(q.half(), q.half(), q.half(),
                                                4, 0.125)
    with pytest.raises(NotImplementedError):  # no backward yet
        r = q.float().requires_grad_()
        attention_kernel.flash_attention_packed(r, r, r, 4, 0.125)
    x = torch.zeros(8, 20, 24, 128, device="cuda", dtype=BF)
    for bad, hw in [(x.float(), (32, 40)), (x[:4], (32, 40)),
                    (x[..., :64], (32, 40)), (x, (10, 40)), (x, (37, 40))]:
        assert not resize_kernel.supported(bad, hw, True, None)
        with pytest.raises(ValueError):
            resize_kernel.resize_bilinear_fused(bad, hw)


def _small_model(gen, depth=2):
    """Widths that pass every kernel gate: encoder heads of 64 (K1 at 530
    tokens, 322x322 input), temporal modules at C=640 (K4; 8 heads of 80)
    and C=128 (K3 offline; K6 in a stream)."""
    cfg = ModelConfig("small", 128, (128, 128, 640, 640), (0, 0, 1, 1),
                      EncoderConfig(embed_dim=128, depth=depth, num_heads=2,
                                    img_size=322))
    return vt.init_random(cfg, gen, device="cuda").requires_grad_(False)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("dtype", [BF, F32])
def test_forward_kernels_match_plain(gen, dtype, fused):
    """A small model whose widths pass every kernel gate: each kernel runs
    its expected number of times, and the output matches attn_impl="plain"
    (bf16: bench.py's max_rel < 1e-2; fp32: 1e-4).  ``fused``: K7 takes
    every block, and K10 refinenet1's upsample (features 128; the island's
    64 channels are refused) of the 8-frame tail in bf16."""
    depth = 2
    model = _small_model(gen, depth)
    x = torch.randn(1, 8, 322, 322, 3, device="cuda", generator=gen)
    x = x.to(dtype)
    tops.reset_launch_counts()
    got = vt.forward(model, x, micro_batch_size=8, fuse_proj=fused,
                     resize_kernel=fused)
    torch.cuda.synchronize()
    # K2: two block norms a layer, four tap norms, mm0/mm1's ff_norm
    assert tops.launch_counts() == {
        "K1": 0 if fused else depth, "K2": 2 * depth + 4 + 2, "K3": 2,
        "K4": 4, "K5": 0, "K6": 0, "K7": depth if fused else 0, "K8": 0,
        "K9": 0, "K10": int(fused and dtype == BF), "K11": 0, "K12": 0,
        "K13": 0, "K14": 0}
    ref = vt.forward(model, x, attn_impl="plain")
    assert got.shape == ref.shape == (1, 8, 322, 322)
    assert float(ref.float().std()) > 0
    assert _rel(ref, got) < (1e-2 if dtype == BF else 1e-4)


def test_streaming_kernels_match_plain(gen):
    """12 bf16 frames through the small model: K5 in the first step's 8
    attention sub-blocks, K6 in the 4 of the C=128 modules each later step
    (C=640 is not a K6 width), and the depths within bench.py's bound of
    the all-plain stream (kernel flavours of one stream: 2e-2, the bound of
    tests/test_streaming_ctx_kernel.py)."""
    depth = 2
    model = _small_model(gen, depth)
    frames = (torch.rand(12, 322, 322, 3, device="cuda", generator=gen)
              * 255).to(torch.uint8)
    plain = vt.StreamingDepth(model, input_size=322, attn_impl="plain")
    kv = vt.StreamingDepth(model, input_size=322)
    ctx = vt.StreamingDepth(model, input_size=322, ctx_kernel=True)
    fused = vt.StreamingDepth(model, input_size=322, fuse_proj=True)
    for i, f in enumerate(frames):
        ref = plain.submit(f)
        a = kv.submit(f)
        tops.reset_launch_counts()
        b = ctx.submit(f)
        torch.cuda.synchronize()
        n = tops.launch_counts()
        assert n["K1"] == depth and n["K3"] == n["K4"] == 0
        assert (n["K5"], n["K6"]) == ((8, 0) if i == 0 else (0, 4))
        assert _rel(ref, a) < 1e-2 and _rel(ref, b) < 1e-2
        assert _rel(a, b) < 2e-2
        tops.reset_launch_counts()
        c = fused.submit(f)
        torch.cuda.synchronize()
        n = tops.launch_counts()
        assert (n["K1"], n["K7"]) == (0, depth)
        assert _rel(a, c) < 2e-2
        assert ctx.order == kv.order == plain.order == fused.order


def test_streaming_cache_kinds_agree(gen):
    """The "h" cache and the int8 rows (through K6) on the card against the
    bf16 kv stream, 12 bf16 frames: within 5e-2 of the depth scale, the
    bound tests/test_streaming_kv.py holds JAX's kv-vs-h streams to (the
    int8 test there allows a 5e-2 median); the int8 buffers hold int8."""
    model = _small_model(gen)
    frames = (torch.rand(12, 322, 322, 3, device="cuda", generator=gen)
              * 255).to(torch.uint8)
    kv = vt.StreamingDepth(model, input_size=322)
    others = [vt.StreamingDepth(model, input_size=322, cache_kind="h"),
              vt.StreamingDepth(model, input_size=322, cache_dtype="int8",
                                ctx_kernel=True)]
    for f in frames:
        ref = kv.submit(f)
        for s in others:
            assert _rel(ref, s.submit(f)) < 5e-2
            assert s.order == kv.order
    assert all(b.dtype == torch.int8 for b in others[1].buffers)
    assert others[1].cache_bytes() < kv.cache_bytes() // 2 + 4096


def test_streaming_direct_read_on_card(gen, monkeypatch):
    """K6's in-place read of the cache on the card, 50 bf16 frames through
    a tiny model whose temporal widths K6 takes (4 heads of 8), stepped in
    turns beside the default kv stream and the same ``ctx_kernel`` stream
    with its in-place read switched off: K6 8 a step after the first, over
    the 31 gathered rows up to step 41 (bit-identical to the gathering
    stream) and over the 45-row buffers from step 42, on the Hopper loop;
    within 2e-2 of the gathering stream and of kv (the bound of
    tests/test_streaming_ctx_kernel.py); then a group of 4 that reads in
    place leaves the cache 4 submits leave.  The small model's C=640
    modules are not a K6 width, so its in-place read stays off."""
    from vda_tpu_torch.ops import stream_kernel

    cfg = ModelConfig("tiny", 32, (32, 32, 32, 32), (0, 0, 1, 1),
                      EncoderConfig(embed_dim=64, depth=2, num_heads=2,
                                    img_size=56), num_attention_heads=4)
    model = vt.init_random(cfg, gen, device="cuda").requires_grad_(False)
    frames = (torch.rand(54, 70, 90, 3, device="cuda", generator=gen)
              * 255).to(torch.uint8)
    streams = {"kv": vt.StreamingDepth(model, input_size=56),
               "ctx": vt.StreamingDepth(model, input_size=56,
                                        ctx_kernel=True),
               "gather": vt.StreamingDepth(model, input_size=56,
                                           ctx_kernel=True)}
    assert streams["ctx"]._direct
    streams["gather"]._direct = False
    rows = []
    wrapper = stream_kernel.stream_kv_attention
    monkeypatch.setattr(stream_kernel, "stream_kv_attention",
                        lambda *a: rows.append(a[3].shape[1]) or wrapper(*a))
    for i, f in enumerate(frames[:50]):
        out = {}
        for name, stream in streams.items():
            rows.clear()
            tops.reset_launch_counts()
            out[name] = stream.submit(f)
            torch.cuda.synchronize()
            want = [] if name == "kv" or i == 0 else \
                [45 if name == "ctx" and i >= 42 else 31] * 8
            assert rows == want, (name, i)
            assert stream_kernel.launches_by_loop == {"sm90": len(want),
                                                      "sm80": 0}
        if i < 42:
            assert torch.equal(out["ctx"], out["gather"]), i
        assert _rel(out["gather"], out["ctx"]) < 2e-2, i
        assert _rel(out["kv"], out["ctx"]) < 2e-2, i
        assert len({tuple(s.order) for s in streams.values()}) == 1
    seq, grp = streams["ctx"], streams["gather"]
    grp._direct = True
    grp.buffers = [b.clone() for b in seq.buffers]
    ref = [seq.submit(f) for f in frames[50:]]
    rows.clear()
    got = grp.submit_group(frames[50:])
    assert rows == [45] * 32
    assert all(torch.equal(a, b) for a, b in zip(seq.buffers, grp.buffers))
    assert seq.order == grp.order
    assert max(_rel(a, b) for a, b in zip(ref, got)) < 1e-2
    small = vt.StreamingDepth(_small_model(gen), input_size=322,
                              ctx_kernel=True)
    assert not small._direct


# ---------------------------------------------------------------------------
# K5 and K8 on their Hopper code
# ---------------------------------------------------------------------------

def _k5_operands(gen, bd, t, c, fused, dtype=BF):
    if fused:  # column slices of one (BD, T, 3C) projection
        return torch.randn(bd, t, 3 * c, device="cuda",
                           generator=gen).to(dtype).split(c, dim=-1)
    return tuple(torch.randn(bd, t, c, device="cuda", generator=gen)
                 .to(dtype) for _ in range(3))


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("bd", [1, 7, 1369])
@pytest.mark.parametrize("dh", [8, 16, 24, 32, 64, 128, 192])
@pytest.mark.parametrize("t", [1, 2, 8, 31, 32, 33, 64])
def test_k5_hopper_code(gen, t, dh, bd, fused):
    """K5 in bf16 on the Hopper code (T >= 2 the mma path, T = 1 the row
    path), 8 heads, every launch asserted on "sm90", against the bf16
    twin's output before its last rounding (the same rounding points
    before it): the kernel's one output rounding is at most half a bf16
    ulp of the scale, where against the rounded twin a summation order
    that flips one output of the top binade by one ulp moves it by up to
    2^-7 of the scale."""
    heads = 8
    c = heads * dh
    q, k, v = _k5_operands(gen, bd, t, c, fused)
    scale = dh ** -0.5
    assert tiny_seq_kernel.loop_of(BF, t, c, heads) == "sm90"
    got = _on_loop(lambda: tiny_seq_kernel.launches_by_loop, "sm90",
                   lambda: _launched("K5", lambda: (
                       tiny_seq_kernel.tiny_seq_attention(q, k, v, heads,
                                                          scale))))
    ref = tiny_seq_kernel.tiny_seq_attention_reference(q, k, v, heads, scale,
                                                       out_dtype=F32)
    assert got.dtype == BF and got.shape == (bd, t, c)
    assert _rel(ref, got) < TOL[BF]


@pytest.mark.parametrize("t,c,heads,loop", [
    (32, 64, 8, "sm90"), (1, 1024, 8, "sm90"), (1, 192, 8, "sm90"),
    (32, 1536, 8, "sm90"), (32, 768, 4, "sm90"), (32, 1024, 1, "sm80"),
    (7, 80, 2, "sm80"), (32, 2048, 8, "sm80"), (32, 1280, 8, "sm80"),
    (1, 4096, 8, "sm80")])
def test_k5_routes(gen, t, c, heads, loop):
    """The shapes the Hopper code refuses (head widths outside its
    instantiations at T >= 2: 1024, 10, 256, 160; C over 2048 at T = 1) and
    fp32 run the old kernel, counted as such; vitg's head width 192 runs
    the Hopper code."""
    q, k, v = _k5_operands(gen, 5, t, c, True)
    for dtype in (BF, F32):
        want = loop if dtype == BF else "sm80"
        x = [y.to(dtype) for y in (q, k, v)] if dtype != BF else (q, k, v)
        if dtype != BF:  # one fused layout again
            x = torch.cat(x, -1).split(c, dim=-1)
        assert tiny_seq_kernel.loop_of(dtype, t, c, heads) == want
        got = _on_loop(lambda: tiny_seq_kernel.launches_by_loop, want,
                       lambda: tiny_seq_kernel.tiny_seq_attention(
                           *x, heads, (c // heads) ** -0.5))
        ref = tiny_seq_kernel.tiny_seq_attention_reference(
            *(y.float() for y in x), heads, (c // heads) ** -0.5)
        assert _rel(ref, got) < TOL[dtype]


@pytest.mark.parametrize("t,dh", [(1, 128), (1, 32), (1, 24), (32, 8),
                                  (32, 24)])
def test_k5_nan_where_the_twin_has_it(gen, t, dh):
    """An infinite value planted in q makes its head's rows NaN in the
    kernel exactly where the twin has NaN (at T = 1 the one-key softmax is
    computed, not skipped), and every other value agrees."""
    heads, bd = 8, 37
    c = heads * dh
    q, k, v = _k5_operands(gen, bd, t, c, True)
    q[3, 0, 5] = float("inf")
    q[9, t - 1, c - 1] = float("-inf")
    got = tiny_seq_kernel.tiny_seq_attention(q, k, v, heads, dh ** -0.5)
    ref = tiny_seq_kernel.tiny_seq_attention_reference(q, k, v, heads,
                                                       dh ** -0.5)
    torch.cuda.synchronize()
    assert torch.isnan(ref).any()
    assert torch.equal(torch.isnan(got), torch.isnan(ref))
    ok = ~torch.isnan(ref)
    err = (got.float() - ref.float())[ok].abs().max()
    assert float(err / ref.float()[ok].abs().max()) < TOL[BF]


@pytest.mark.parametrize("bd,t,c", [(5476, 32, 64), (1369, 32, 192),
                                    (1369, 1, 1024), (5476, 1, 256),
                                    (1369, 32, 1536)])
def test_k5_repeats_bit_for_bit(gen, bd, t, c):
    q, k, v = _k5_operands(gen, bd, t, c, True)
    scale = (c // 8) ** -0.5
    first = tiny_seq_kernel.tiny_seq_attention(q, k, v, 8, scale)
    for _ in range(30):
        assert torch.equal(tiny_seq_kernel.tiny_seq_attention(q, k, v, 8,
                                                              scale), first)


K8_TABLE_LENGTHS = [(1,), (63, 64, 65), (257,) * 3 + (50,) * 9,
                    (1370,) * 2,
                    (5, 300, 1, 64, 64, 2, 129, 33, 33, 33, 70, 1, 1, 200)]


@pytest.mark.parametrize("heads,dh,loop", [(4, 64, "sm90"), (16, 64, "sm90"),
                                           (4, 16, "sm80"),
                                           (2, 128, "sm80")])
@pytest.mark.parametrize("lengths", K8_TABLE_LENGTHS, ids=str)
def test_k8_hopper_code(gen, lengths, heads, dh, loop):
    """K8 in bf16 against the per-segment twin in fp32, each launch on the
    loop its head width takes: the Hopper code at 64, the mma.sync loop at
    16 and 128."""
    total, c = sum(lengths), heads * dh
    qkv = torch.randn(total, 3 * c, device="cuda", generator=gen).to(BF)
    q, k, v = qkv.split(c, dim=-1)
    assert segment_kernel.loop_of(BF, dh) == loop
    got = _on_loop(lambda: segment_kernel.launches_by_loop, loop,
                   lambda: _launched("K8", lambda: (
                       segment_kernel.segment_attention(
                           q, k, v, heads, dh ** -0.5, lengths))))
    ref = segment_kernel.segment_attention_reference(
        q.float(), k.float(), v.float(), heads, dh ** -0.5, lengths)
    assert got.dtype == BF and got.shape == (total, c)
    assert _rel(ref, got) < TOL[BF]


def test_k8_repeats_bit_for_bit(gen):
    lengths = (257,) * 64 + (50,) * 256
    qkv = torch.randn(sum(lengths), 3 * 1024, device="cuda",
                      generator=gen).to(BF)
    q, k, v = qkv.split(1024, dim=-1)
    first = segment_kernel.segment_attention(q, k, v, 16, 0.125, lengths)
    for _ in range(30):
        assert torch.equal(segment_kernel.segment_attention(
            q, k, v, 16, 0.125, lengths), first)


@pytest.mark.parametrize("kernel", ["K5", "K8"])
def test_k5_k8_design_steps(gen, kernel):
    """Each step of probes/bench_short_attn_sm90.py against what it
    writes: the twin within 3.9e-3 of its scale, or an output left at zero;
    the steps that do not take a shape refuse it."""
    from vda_tpu_torch.probes import bench_short_attn_sm90 as bsa

    shapes = ([(37, 32, 64), (20, 32, 192), (40, 1, 1024), (33, 1, 256),
               (9, 7, 64), (20, 32, 1536)] if kernel == "K5"
              else [(257, 257, 50, 50, 50), (1370, 3, 64)])
    steps = (bsa.K5_VARIANTS if kernel == "K5"
             else [*bsa.K8_VARIANTS, *bsa.K8_TABLES])
    for shape in shapes:
        ins = bsa.inputs(gen, kernel, shape)
        for step in steps:
            # K5's steps other than old and sm90 run at the main paths' T
            # (32 and 1), some on the mma path alone
            refused = kernel == "K5" and (
                (step in bsa.K5_MMA_ONLY and shape[1] == 1)
                or (step not in ("old", "sm90") and shape[1] not in (1, 32)))
            if refused:
                with pytest.raises(RuntimeError, match="variant"):
                    bsa.variant(step, ins)
                continue
            got = bsa.variant(step, ins)
            torch.cuda.synchronize()
            want = bsa.twin(step, ins)
            if step in bsa.PARTS:
                assert torch.equal(got, want), (step, shape)
            else:
                assert _rel(want, got) < TOL[BF], (step, shape)


def test_k5_k8_hopper_launchers_refuse(gen):
    """The C launchers refuse what the Hopper code does not take (the
    entry points route such shapes to the old kernels; the variant entry
    points reach the launchers directly) and raise through the wrappers."""
    from vda_tpu_torch.ops import _build

    lib = _build.library()
    x = torch.zeros(4, 2, 3 * 1536, device="cuda", dtype=BF)
    st = _build.stream_ptr(x)
    # K5 sm90 at head width 160 (T 2)
    assert lib.vda_tiny_seq_variant(
        x.data_ptr(), x.data_ptr(), x.data_ptr(), x.data_ptr(), 4, 2, 1280,
        8, x.stride(0), x.stride(1), 0.1, 0, 1, st) == _build.INVALID_VALUE
    # K8 sm90 at head width 128
    q = torch.zeros(10, 256, device="cuda", dtype=BF)
    items, span = segment_kernel._device_items((10,), q.device)
    tiles = segment_kernel._device_table((10,), q.device)
    assert lib.vda_segment_variant(
        q.data_ptr(), q.data_ptr(), q.data_ptr(), q.data_ptr(),
        tiles.data_ptr(), tiles.shape[0], items.data_ptr(), items.shape[0],
        span, 10, 2, 128, 256, 0.1, 0, 1, st) == _build.INVALID_VALUE
    with pytest.raises(ValueError):  # 65 frames, bf16
        y = torch.zeros(2, 65, 64, device="cuda", dtype=BF)
        tiny_seq_kernel.tiny_seq_attention(y, y, y, 8, 0.3)
    with pytest.raises(ValueError):  # K8 head width 136
        w = torch.zeros(12, 272, device="cuda", dtype=BF)
        segment_kernel.segment_attention(w, w, w, 2, 0.1, (5, 7))
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# the training slice: K8, the K2/K10 gradients, a train step
# ---------------------------------------------------------------------------

SEGMENTS = [(257, 257, 50, 50, 50), (1, 64, 65, 1, 128, 7, 130),
            (1370, 1370), (1,) * 9, (300, 20, 1, 200)]


@pytest.mark.parametrize("dtype", [BF, F32])
@pytest.mark.parametrize("heads,dh", [(4, 8), (4, 16), (4, 40), (2, 64),
                                      (4, 80), (2, 128), (6, 64), (16, 64),
                                      (24, 64)])
@pytest.mark.parametrize("lengths", SEGMENTS, ids=str)
def test_k8_segment_attention(gen, dtype, heads, dh, lengths):
    """K8 against the per-segment twin in fp32 on the same inputs, over
    head widths 8..128, the vits/vitl/vitg head counts (6, 16, 24 of 64) and
    ragged segments (single rows, tile edges, one past 1370); q, k and v
    column slices of one fused projection.  Tolerance as K1's."""
    total, c = sum(lengths), heads * dh
    qkv = torch.randn(total, 3 * c, device="cuda", generator=gen).to(dtype)
    q, k, v = qkv.split(c, dim=-1)
    got = _launched("K8", lambda: segment_kernel.segment_attention(
        q, k, v, heads, dh ** -0.5, lengths))
    ref = segment_kernel.segment_attention_reference(
        q.float(), k.float(), v.float(), heads, dh ** -0.5, lengths)
    assert got.dtype == dtype and got.shape == (total, c)
    assert _rel(ref, got) < TOL[dtype]


def test_k8_refuses_what_the_kernel_does_not_take(gen):
    q = torch.randn(12, 128, device="cuda", generator=gen)
    with pytest.raises(ValueError):  # head width 12
        segment_kernel.segment_attention(q[:, :24], q[:, :24], q[:, :24], 2,
                                         0.1, (5, 7))
    with pytest.raises(ValueError):  # head width 136
        w = torch.randn(12, 272, device="cuda", generator=gen)
        segment_kernel.segment_attention(w, w, w, 2, 0.1, (5, 7))
    with pytest.raises(ValueError):  # fp16
        segment_kernel.segment_attention(q.half(), q.half(), q.half(), 2,
                                         0.1, (5, 7))
    with pytest.raises(ValueError):  # lengths do not sum to the rows
        segment_kernel.segment_attention(q, q, q, 2, 0.1, (5, 6))
    with pytest.raises(ValueError):  # k laid out unlike q
        segment_kernel.segment_attention(q, torch.cat([q, q], -1)[:, :128],
                                         q, 2, 0.1, (5, 7))
    with pytest.raises(NotImplementedError):  # forward only, as in JAX
        r = q.clone().requires_grad_()
        segment_kernel.segment_attention(r, r, r, 2, 0.1, (5, 7))


@pytest.mark.parametrize("dtype", [BF, F32])
def test_k2_k10_gradients_match_plain(gen, dtype):
    """x.grad (K2: and weight.grad, bias.grad) through the kernels'
    autograd Functions against autograd through the plain forms: the same
    backward on the same saved inputs, 1e-5 of the gradient's scale."""
    from vda_tpu_torch.ops.resize import resize_bilinear

    def grads(fn, inputs, gy):
        ins = [t.detach().clone().requires_grad_(True) for t in inputs]
        fn(*ins).backward(gy)
        return [t.grad for t in ins]

    x = (torch.randn(3, 70, 256, device="cuda", generator=gen) * 2).to(dtype)
    w, b = (torch.randn(256, device="cuda", generator=gen) for _ in range(2))
    gy = torch.randn(3, 70, 256, device="cuda", generator=gen).to(dtype)
    got = grads(lambda *a: _launched("K2", lambda: norm_kernel.
                                     fused_layer_norm(*a, 1e-5)),
                (x, w, b), gy)
    ref = grads(lambda *a: norm_kernel.layer_norm_reference(*a, 1e-5),
                (x, w, b), gy)
    for r, g in zip(ref, got):
        assert _rel(r, g) < 1e-5
    if dtype == BF:
        x = torch.randn(8, 20, 24, 128, device="cuda", generator=gen).to(BF)
        gy = torch.randn(8, 32, 40, 128, device="cuda", generator=gen).to(BF)
        (g,) = grads(lambda t: _launched("K10", lambda: resize_kernel.
                                         resize_bilinear_fused(t, (32, 40))),
                     (x,), gy)
        (r,) = grads(lambda t: resize_bilinear(t, (32, 40), kernel=False),
                     (x,), gy)
        assert _rel(r, g) < 1e-5


def test_train_step_kernels_match_plain(gen):
    """Two fp32 train steps of the small model (remat, accumulation over 2,
    clipping, augmentation) with JAX's training set (K2 only; K2 launches
    in the forward and the remat recompute) and all-plain, from one state
    and batch: losses within 1e-5 and gradient norms within 1e-4
    relative."""
    from vda_tpu_torch.parallel.train import (init_train_state,
                                              make_optimizer,
                                              make_train_step)

    sd = _small_model(gen).state_dict()
    batch = {"video": torch.rand(1, 2, 330, 340, 3, device="cuda",
                                 generator=gen),
             "depth": torch.rand(1, 2, 330, 340, device="cuda",
                                 generator=gen) * 3 + 0.2,
             # 40% valid: the frames' medians are invalid (zeroed) pixels,
             # which pass no gradient (chip_smoke.py phase_train says why)
             "mask": torch.rand(1, 2, 330, 340, device="cuda",
                                generator=gen) < 0.4}
    out = {}
    final = "head.scratch.output_conv2.2."
    sd[final + "bias"] += 0.5  # a live ReLU and a depth that varies
    sd[final + "weight"] *= 20.0  # (chip_smoke.py's train_model)
    for impl in ("xla", "plain"):
        model = _small_model(gen)
        model.load_state_dict(sd)
        model.requires_grad_(True)
        opt = make_optimizer(1e-4, clip_norm=1.0, accum_steps=2)
        st = init_train_state(model, opt)
        step = make_train_step(opt, augment_hw=(322, 322), attn_impl=impl)
        out[impl] = []
        for _ in range(2):
            tops.reset_launch_counts()
            st, m = step(st, batch)
            torch.cuda.synchronize()
            n = tops.launch_counts()
            # xla: 2 norms a block and 4 tap norms, 3 a motion module (640
            # and 128 wide), and the blocks' norms again in the recompute
            assert n == {**{k: 0 for k in n},
                         "K2": (2 * 2 + 4 + 12 + 2 * 2) if impl == "xla"
                         else 0}
            out[impl].append({k: float(v) for k, v in m.items()})
    for a, b in zip(out["xla"], out["plain"]):
        assert all(np.isfinite(list(a.values())))
        assert abs(a["total_loss"] - b["total_loss"]) <= \
            1e-5 * abs(b["total_loss"])
        assert abs(a["grad_norm"] - b["grad_norm"]) <= 1e-4 * b["grad_norm"]


# K11: ragged M (against the 128-row tile), K off the 16-value chunk, N = 640
@pytest.mark.parametrize("dtype", [BF, F32])
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("shape,k,n", [
    ((3, 100), 256, 384), ((1, 512), 256, 640), ((2, 77), 200, 256),
    ((1370,), 1024, 3072), ((5,), 40, 128)])
def test_k11_int8_linear_bit_exact(gen, dtype, bias, shape, k, n):
    """The kernel's int32 sums are exact and its epilogue rounds each step
    as the twin does: bit-identical outputs."""
    from vda_tpu_torch.ops import quant

    x = torch.randn(*shape, k, device="cuda", generator=gen).to(dtype)
    w = torch.randn(k, n, device="cuda", generator=gen) * 0.05
    w_q, w_s = quant.quantize_weight(w)
    p = {"w_q": w_q, "w_s": w_s}
    if bias:
        p["b"] = torch.randn(n, device="cuda", generator=gen)
    got = _on_gemm_loop("K11", lambda: quant.int8_linear(p, x))
    ref = quant.int8_linear_reference(p, x)
    assert got.dtype == dtype and got.shape == (*shape, n)
    assert torch.equal(got, ref)
    dense = x.float() @ w + (p["b"] if bias else 0)
    assert _rel(dense, got) < 2e-2  # tests/test_quant.py's W8A8 bound


def test_k11_k13_refuse_what_the_kernels_do_not_take(gen):
    from vda_tpu_torch.ops import quant
    from vda_tpu_torch.probes import bench_int8

    x = torch.randn(10, 64, device="cuda", generator=gen)
    w_q, w_s = quant.quantize_weight(torch.randn(64, 256, device="cuda",
                                                 generator=gen))
    with pytest.raises(ValueError):  # N % 128, as in JAX
        quant.int8_linear({"w_q": w_q[:, :200], "w_s": w_s[:200]}, x)
    with pytest.raises(ValueError):  # fp16 activations
        quant.int8_linear({"w_q": w_q, "w_s": w_s}, x.half())
    with pytest.raises(ValueError):  # weights not int8
        quant.int8_linear({"w_q": w_q.float(), "w_s": w_s}, x)
    with pytest.raises(ValueError):  # weights on the CPU
        quant.int8_linear({"w_q": w_q.cpu(), "w_s": w_s.cpu()}, x)
    xi = torch.randint(-127, 127, (64, 40), device="cuda", generator=gen,
                       dtype=torch.int8)
    wi = torch.randint(-127, 127, (40, 128), device="cuda", generator=gen,
                       dtype=torch.int8)
    with pytest.raises(ValueError):  # K % 16
        bench_int8.matmul(xi, wi)
    with pytest.raises(ValueError):  # mixed dtypes
        bench_int8.matmul(xi[:, :32].contiguous(), wi[:32].bfloat16())


@pytest.mark.parametrize("m,k,n", [(45056 // 8, 1024, 3072), (100, 64, 136),
                                   (257, 512, 1024)])
def test_k13_matmul(gen, m, k, n):
    from vda_tpu_torch.probes import bench_int8

    xi = torch.randint(-127, 127, (m, k), device="cuda", generator=gen,
                       dtype=torch.int8)
    wi = torch.randint(-127, 127, (k, n), device="cuda", generator=gen,
                       dtype=torch.int8)
    got = _on_gemm_loop("K13", lambda: bench_int8.matmul(xi, wi))
    assert got.dtype == torch.int32
    assert torch.equal(got, bench_int8.matmul_reference(xi, wi))
    xb = torch.randn(m, k, device="cuda", generator=gen).to(BF)
    wb = torch.randn(k, n, device="cuda", generator=gen).to(BF)
    got = _on_gemm_loop("K13", lambda: bench_int8.matmul(xb, wb))
    ref = xb.float() @ wb.float()  # unrounded: the kernel rounds once
    assert got.dtype == BF and _rel(ref, got) < 2.0 ** -8


# The Hopper GEMM loop at edges of its 128 x 256 tiles and 128-byte stages
# of k: M 1, 129 and K11's 43840 rows; N 136 (K13 only: K11 takes N % 128),
# 640 and 3072; rows of 16, 48 and 1040 bytes (int8 16, 48, 1040 values;
# bf16 8, 24, 520)
GEMM_M, GEMM_N, GEMM_KB = (1, 129, 43840), (136, 640, 3072), (16, 48, 1040)


@pytest.mark.parametrize("kb", GEMM_KB)
@pytest.mark.parametrize("n", GEMM_N)
@pytest.mark.parametrize("m", GEMM_M)
@pytest.mark.parametrize("dtype", [torch.int8, BF])
def test_k13_ragged_on_the_hopper_loop(gen, dtype, m, n, kb):
    from vda_tpu_torch.probes import bench_int8

    k = kb // (2 if dtype == BF else 1)
    if dtype == BF:
        x = torch.randn(m, k, device="cuda", generator=gen).to(BF)
        w = torch.randn(k, n, device="cuda", generator=gen).to(BF)
    else:
        x = torch.randint(-127, 127, (m, k), device="cuda", generator=gen,
                          dtype=torch.int8)
        w = torch.randint(-127, 127, (k, n), device="cuda", generator=gen,
                          dtype=torch.int8)
    got = _on_gemm_loop("K13", lambda: bench_int8.matmul(x, w))
    assert got.shape == (m, n)
    if dtype == BF:
        assert _rel(x.float() @ w.float(), got) < 2.0 ** -8
    else:
        assert torch.equal(got, bench_int8.matmul_reference(x, w))


@pytest.mark.parametrize("out_dtype", [BF, F32])
@pytest.mark.parametrize("kb", GEMM_KB)
@pytest.mark.parametrize("n", [n for n in GEMM_N if n % 128 == 0])
@pytest.mark.parametrize("m", GEMM_M)
def test_k11_ragged_on_the_hopper_loop(gen, m, n, kb, out_dtype):
    """K11 on int8 operands as they come: bit-identical with the twin."""
    from vda_tpu_torch.ops import quant

    xq = torch.randint(-127, 127, (m, kb), device="cuda", generator=gen,
                       dtype=torch.int8)
    wq = torch.randint(-127, 127, (kb, n), device="cuda", generator=gen,
                       dtype=torch.int8)
    sx = torch.rand(m, 1, device="cuda", generator=gen) / 127
    sw = torch.rand(n, device="cuda", generator=gen) / 127
    b = torch.randn(n, device="cuda", generator=gen)
    got = _on_gemm_loop("K11", lambda: quant.int8_matmul(
        xq, wq, sx, sw, b, out_dtype))
    assert got.dtype == out_dtype and got.shape == (m, n)
    assert torch.equal(got, quant.int8_matmul_reference(xq, wq, sx, sw, b,
                                                        out_dtype))


@pytest.mark.parametrize("variant", list(GEMM_VARIANTS))
@pytest.mark.parametrize("kind", ["k13_int8", "k13_bf16", "k11"])
def test_gemm_design_steps_agree_with_their_twins(gen, kind, variant):
    """Every step of probes/bench_gemm_sm90.py at a shape ragged in M, N
    and K (129 rows, 640 columns, 1040 bytes of k); the steps that write
    nothing (or store zeroed staging) leave a zeroed output at zero."""
    from vda_tpu_torch.probes import bench_gemm_sm90 as bg

    m, n = 129, 640
    a, bt, sx, sw, b = bg.operands(kind, gen, m, 1040 // (
        2 if kind == "k13_bf16" else 1), n)
    out = torch.zeros(m, n, device="cuda", dtype=torch.int32
                      if kind == "k13_int8" else BF)
    got = bg.gemm(kind, a, bt, variant, sx, sw, b, out)
    torch.cuda.synchronize()
    if variant in bg.WRITE_NOTHING:
        ref = torch.zeros_like(out)
    elif kind == "k13_bf16":
        ref = a.float() @ bt.float().t()
    else:
        ref = bg.gemm_reference(kind, a, bt, sx, sw, b)
    ok, _ = bg.agrees(kind, variant, got, ref)
    assert ok


# K12: the function variants over head widths 8-128, the geometry variants
# (the vitl tiling's alternatives) over 8-64; ragged N; 3 heads, so two
# heads a block leaves a group without a head.  Head width 64 runs every
# variant but mma_sync on the Hopper loop
@pytest.mark.parametrize("variant", list(K12_VARIANTS))
@pytest.mark.parametrize("n", [100, 257, 1370])
@pytest.mark.parametrize("dh", [8, 40, 64, 80, 128])
def test_k12_attention_variants(gen, variant, n, dh):
    from vda_tpu_torch.probes import bench_attn_variants as k12

    heads = 3
    qkv = torch.randn(2, n, 3 * heads * dh, device="cuda", generator=gen)
    qkv = qkv.to(BF)
    if dh > 64 and variant in k12.GEOMETRY:
        with pytest.raises(ValueError):
            k12.attn(qkv, heads, dh ** -0.5, variant)
        return
    loop = k12.loop_of(dh, variant)
    assert loop == ("sm90" if dh == 64 and variant != "mma_sync" else "sm80")
    got = _on_loop(lambda: k12.launches_by_loop, loop, lambda: _launched(
        "K12", lambda: k12.attn(qkv, heads, dh ** -0.5, variant)))
    np_len = -(-n // 64) * 64
    ref = k12.attn_reference(qkv, heads, dh ** -0.5, k12.VARIANTS[variant][1],
                             np_len, torch.float32)
    assert got.shape == (2, n, heads * dh)
    assert _rel(ref, got) < k12.tolerance(variant)


def test_k12_full_is_k1_and_refusals(gen):
    """The full variant is K1's own configuration of the Hopper loop, so
    bit-identical with K1 (and so are exp2 and bk128, the same
    configuration); mma_sync is the old loop's full, which K1 ran before:
    within TOL[bf16] of the twin and of K1."""
    from vda_tpu_torch.probes import bench_attn_variants as k12

    qkv = torch.randn(4, 1370, 3 * 16 * 64, device="cuda", generator=gen)
    qkv = qkv.to(BF)
    a = _on_loop(lambda: k12.launches_by_loop, "sm90", lambda: _launched(
        "K12", lambda: k12.attn(qkv, 16, 0.125, "full")))
    b = _launched("K1", lambda: attention_kernel.flash_attention_qkv(
        qkv, 16, 0.125))
    assert torch.equal(a, b)
    for same in ("exp2", "bk128"):
        assert torch.equal(k12.attn(qkv, 16, 0.125, same), b)
    old = _on_loop(lambda: k12.launches_by_loop, "sm80", lambda: _launched(
        "K12", lambda: k12.attn(qkv, 16, 0.125, "mma_sync")))
    ref = attention_kernel.flash_attention_qkv_reference(qkv.float(), 16,
                                                         0.125)
    assert _rel(ref, a) < TOL[BF] and _rel(ref, old) < TOL[BF]
    assert _rel(old, b) < TOL[BF]
    with pytest.raises(ValueError):  # fp32
        k12.attn(qkv.float(), 16, 0.125, "full")
    with pytest.raises(ValueError):  # a key count that is not 64-aligned
        k12.attn(qkv, 16, 0.125, "nomask", np_len=1400)
    with pytest.raises(ValueError):  # fewer keys than tokens
        k12.attn(qkv, 16, 0.125, "nomask", np_len=1344)


@pytest.mark.parametrize("stage", ["dot2", "mask", "pe", "new"])
def test_k14_stream_probe_stages(gen, stage):
    """Each stage at the script's shape and at a wider one (C 1024, 16
    heads of 64, groups of 8), against the twin's unrounded output, on the
    Hopper kernel; also the first build (``variant("old")``) at the same
    values."""
    from vda_tpu_torch.probes import probe_stream_kernel as k14

    feats = k14.STAGES[stage]
    for bhw, c, heads, group in ((32, 256, 8, 16), (40, 1024, 16, 8)):
        inputs = k14.make_inputs(bhw, c)
        assert k14.loop_of(k14.ROWS, c, heads, group) == "sm90"
        got = _on_loop(lambda: k14.launches_by_loop, "sm90", lambda: _launched(
            "K14", lambda: k14.simple_kernel(feats, inputs, heads=heads,
                                             group=group)))
        ref = k14.simple_kernel_reference(feats, inputs, heads=heads,
                                          group=group, out_dtype=F32)
        assert _rel(ref, got) < TOL[BF]
        old = k14.variant("old", feats, inputs, torch.empty_like(got),
                          heads=heads, group=group)
        assert _rel(ref, old) < TOL[BF]
    with pytest.raises(ValueError):  # positions not a multiple of the group
        k14.simple_kernel(feats, k14.make_inputs(24, 256))


@pytest.mark.parametrize("stage", ["dot2", "mask", "pe", "new"])
@pytest.mark.parametrize("case", ["group4", "none_valid", "dh8", "dh128",
                                  "rows1", "rows200"])
def test_k14_hopper_kernel_shapes(gen, stage, case):
    """The Hopper kernel beyond the probe's shapes: a group of 4, ``valid``
    all false (every cached score -1e30: the twin's uniform average), head
    widths 8 and 128, one cached row, 200 cached rows (a cluster of 8
    blocks of many chunks each)."""
    from vda_tpu_torch.probes import probe_stream_kernel as k14

    feats = k14.STAGES[stage]
    bhw, c, heads, group = {"group4": (32, 256, 8, 4),
                            "none_valid": (32, 256, 8, 16),
                            "dh8": (32, 64, 8, 16),
                            "dh128": (16, 256, 2, 8),
                            "rows1": (32, 256, 8, 16),
                            "rows200": (16, 256, 8, 16)}[case]
    q, kn, vn, kb, vb, pe, valid = k14.make_inputs(bhw, c)
    if case == "none_valid":
        valid = torch.zeros_like(valid)
    if case in ("rows1", "rows200"):
        rows = 1 if case == "rows1" else 200
        g2 = torch.Generator(device="cuda").manual_seed(1)
        kb, vb = (torch.randn(bhw, rows, c, device="cuda", generator=g2)
                  .to(BF) for _ in range(2))
        pe = (torch.randn(rows, c, device="cuda", generator=g2) * 0.1).to(BF)
        valid = torch.rand(rows, device="cuda", generator=g2) < 0.7
    inputs = (q, kn, vn, kb, vb, pe, valid)
    assert k14.loop_of(kb.shape[1], c, heads, group) == "sm90"
    got = _on_loop(lambda: k14.launches_by_loop, "sm90",
                   lambda: k14.simple_kernel(feats, inputs, heads=heads,
                                             group=group))
    ref = k14.simple_kernel_reference(feats, inputs, heads=heads,
                                      group=group, out_dtype=F32)
    assert torch.isfinite(got).all()
    assert _rel(ref, got) < TOL[BF]


@pytest.mark.parametrize("stage", ["dot2", "mask", "pe", "new"])
def test_k14_repeats_bit_for_bit(gen, stage):
    """No atomics: the cluster's sums are read in rank order, so 30 calls
    give the same bits."""
    from vda_tpu_torch.probes import probe_stream_kernel as k14

    feats = k14.STAGES[stage]
    inputs = k14.make_inputs()
    first = k14.simple_kernel(feats, inputs)
    assert all(torch.equal(k14.simple_kernel(feats, inputs), first)
               for _ in range(30))


def test_k14_routes_what_the_hopper_kernel_refuses(gen):
    """Groups over 16 and heads over 128 wide run the first build (counted
    "sm80"); the design's steps refuse them; a uint8 ``valid`` is taken as
    a bool one; the steps run at the probe's shape."""
    from vda_tpu_torch.probes import probe_stream_kernel as k14

    feats = k14.STAGES["new"]
    for bhw, c, heads, group in ((32, 256, 8, 32), (16, 272, 1, 8)):
        inputs = k14.make_inputs(bhw, c)
        assert k14.loop_of(k14.ROWS, c, heads, group) == "sm80"
        got = _on_loop(lambda: k14.launches_by_loop, "sm80",
                       lambda: k14.simple_kernel(feats, inputs, heads=heads,
                                                 group=group))
        ref = k14.simple_kernel_reference(feats, inputs, heads=heads,
                                          group=group, out_dtype=F32)
        assert _rel(ref, got) < TOL[BF]
        for step in ("sm90", "loads", "floor"):
            with pytest.raises(ValueError):
                k14.variant(step, feats, inputs, torch.empty_like(got),
                            heads=heads, group=group)
    inputs = k14.make_inputs()
    as_u8 = (*inputs[:6], inputs[6].to(torch.uint8))
    assert torch.equal(k14.simple_kernel(feats, as_u8),
                       k14.simple_kernel(feats, inputs))
    with pytest.raises(ValueError):  # valid of another length
        k14.simple_kernel(feats, (*inputs[:6], inputs[6][:-1]))
    out = torch.empty_like(inputs[0])
    for step in ("sm90", "loads", "floor"):  # the design's steps
        k14.variant(step, feats, inputs, out)
    torch.cuda.synchronize()
    assert torch.equal(k14.variant("sm90", feats, inputs, out),
                       k14.simple_kernel(feats, inputs))


def _vits_models(gen):
    """The vits model from ``load_model_params`` (seeded init, one
    generator seed) cast to bf16 once, and the same weights uncast."""
    from vda_tpu_torch.utils.loader import load_model_params

    models = [load_model_params(
        "vits", random_init=True, cast_bf16=cast,
        generator=torch.Generator(device="cuda").manual_seed(3))[1]
        .requires_grad_(False) for cast in (True, False)]
    assert models[0].pretrained.blocks[0].attn.qkv.weight.dtype == BF
    assert models[1].pretrained.blocks[0].attn.qkv.weight.dtype == F32
    return models


def test_loader_cast_window_is_bit_identical_at_518(gen):
    """At 518 (a 37 x 37 grid: ``pos_embed`` not interpolated) a weight
    cast once equals a weight cast at use, so the window is the same bits."""
    cast, uncast = _vits_models(gen)
    frames = (np.random.default_rng(6).random((1, 8, 518, 518, 3))
              .astype(np.float32))
    x = torch.from_numpy(frames).cuda().to(BF)
    assert torch.equal(vt.forward(cast, x), vt.forward(uncast, x))


def test_loader_cast_stream_is_bit_identical_and_casts_nothing(gen):
    """The first 4 stream steps of the cast and uncast models at 518 are the
    same bits; the cast model's steady step casts no parameter (each would
    be a launch), the uncast model's casts its weights."""
    from vda_tpu_torch.probes.param_casts import ParamCasts

    cast, uncast = _vits_models(gen)
    frames = (np.random.default_rng(7).random((5, 518, 518, 3))
              * 255).astype(np.uint8)
    streams = [vt.StreamingDepth(m) for m in (cast, uncast)]
    for f in frames[:4]:
        a, b = (s.submit(f) for s in streams)
        assert torch.equal(a, b)
    counts = []
    for m, s in zip((cast, uncast), streams):
        with ParamCasts(m) as casts:
            s.submit(frames[4])
        counts.append(casts.count)
    assert counts[0] == 0 and counts[1] > 0


def _sleep_cycles(ms: float) -> int:
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


def _steady_stream(gen):
    """A small-model stream (numpy frames, so uploads go through the pinned
    buffers) past its first two steps, and a next frame."""
    model = _small_model(gen)
    frames = (np.random.default_rng(5).random((4, 322, 322, 3))
              * 255).astype(np.uint8)
    stream = vt.StreamingDepth(model, input_size=322)
    for f in frames[:3]:
        stream.submit(f)
    torch.cuda.synchronize()
    return model, stream, frames[3]


def test_steady_submit_returns_before_the_device_finishes(gen):
    """With the device held by ``torch.cuda._sleep`` (~50 ms, or three
    times an idle submit's host time if longer), a steady ``submit``
    returns in less host time than the sleep: nothing in it waits for the
    device."""
    import time

    _, stream, frame = _steady_stream(gen)
    t0 = time.perf_counter()
    stream.submit(frame)
    idle_ms = 1e3 * (time.perf_counter() - t0)
    torch.cuda.synchronize()
    cycles = _sleep_cycles(max(50.0, 3 * idle_ms))
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    t0 = time.perf_counter()
    depth = stream.submit(frame)
    host_ms = 1e3 * (time.perf_counter() - t0)
    torch.cuda.synchronize()
    sleep_ms = start.elapsed_time(end)
    assert host_ms < sleep_ms, (host_ms, sleep_ms)
    assert torch.isfinite(depth).all()


def test_no_synchronising_call_in_a_steady_submit_or_a_forward(gen):
    """``set_sync_debug_mode("error")`` raises at any call that makes the
    host wait for the device; a steady ``submit`` and a window ``forward``
    make none."""
    model, stream, frame = _steady_stream(gen)
    x = torch.randn(1, 8, 322, 322, 3, device="cuda", generator=gen).to(BF)
    vt.forward(model, x, micro_batch_size=8)  # the caches filled
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        stream.submit(frame)
        vt.forward(model, x, micro_batch_size=8)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def _tiny_card_model(gen):
    cfg = ModelConfig("tiny", 32, (32, 32, 32, 32), (0, 0, 1, 1),
                      EncoderConfig(embed_dim=64, depth=2, num_heads=2,
                                    img_size=56), num_attention_heads=4)
    return vt.init_random(cfg, gen, device="cuda").requires_grad_(False)


@pytest.mark.parametrize("fp32", [False, True])
def test_window_staging_pinned_and_reused(gen, monkeypatch, fp32):
    """Two videos of 60x80 frames (4 windows, then 2; views into wider
    frames) through the window driver: its upload slots and fetch buffer
    are pinned, made once and kept for the second video (the same host
    memory); the refills wait
    where a slot had a copy (``window.upload_wait`` under the third and
    fourth uploads, then every upload of the kept slots); every step but a
    video's first counts ``overlapped``; the first video's depths handed
    to the stitch are its own, unchanged by the second; and the depths
    equal, bit for bit, a serial loop of ``_window_step`` on the card.
    ``fp32``: the depths cross in fp32, so the fetch buffer has the dtype
    of the arrays handed to the stitch, which must still be new ones."""
    from vda_tpu_torch.infer import windowed as tw
    from vda_tpu_torch.utils import trace

    monkeypatch.setattr(tw, "_STAGING", {})
    model = _tiny_card_model(gen)
    # a strided view, as a camera panning over a wider canvas gives
    frames = (np.random.default_rng(6).random((70, 60, 96, 3))
              * 255).astype(np.uint8)[:, :, 8:88]
    captured = []
    stitch = tw.stitch_windows

    def capture(depth_list, *args, **kwargs):
        captured.append(depth_list)
        return stitch(depth_list, *args, **kwargs)

    monkeypatch.setattr(tw, "stitch_windows", capture)
    with trace.recording() as rec:
        got, _ = vt.infer_video_depth(model, frames, 30.0, input_size=56,
                                      fp32=fp32)
    (staging,) = tw._STAGING[torch.device("cuda", 0)]
    bufs = [slot[0] for slot in staging.upload.slots] + [staging.host]
    assert all(b.is_pinned() for b in bufs)
    ptrs = [b.data_ptr() for b in bufs]
    kept = [np.array(a) for a in captured[0]]
    with trace.recording() as rec2:
        vt.infer_video_depth(model, frames[::-1][:30].copy(), 30.0,
                             input_size=56, fp32=fp32)
    assert tw._STAGING[torch.device("cuda", 0)] == [staging]
    bufs = [slot[0] for slot in staging.upload.slots] + [staging.host]
    assert [b.data_ptr() for b in bufs] == ptrs
    assert all(np.array_equal(a, b) for a, b in zip(captured[0], kept))
    for r, waits in ((rec, [False, False, True, True]), (rec2, [True] * 2)):
        spans = r.snapshot()["spans"]
        uploads = [s for s in spans if s["name"] == "window.upload"]
        assert [any(c["parent"] == u["id"] and
                    c["name"] == "window.upload_wait" for c in spans)
                for u in uploads] == waits
        steps = [s for s in spans if s["name"] == "window.step"]
        assert [s["counters"].get("overlapped", 0) for s in steps] == \
            [0] + [1] * (len(steps) - 1)
        assert all(s["device_ms"] is not None for s in steps)
    # the serial loop
    from vda_tpu_torch.utils.transform import (compute_resize_hw,
                                               effective_input_size)

    net_hw = compute_resize_hw(60, 80, effective_input_size(60, 80, 56))
    idx = tw.window_source_indices(frames.shape[0])
    host = []
    for w in range(idx.shape[0]):
        u8 = torch.from_numpy(frames[idx[w:w + 1]]).cuda()
        d = tw._window_step(model, u8, net_hw, (60, 80), F32 if fp32 else BF,
                            "auto", 16, False, False)
        host.extend(d[0].float().cpu().numpy())
    assert all(np.array_equal(a, b) for a, b in zip(captured[0], host))
    ref = np.asarray(stitch(host, metric=model.cfg.metric)[:70])
    assert np.array_equal(got, ref)


def test_stream_uploads_through_the_shared_helper(gen):
    """The stream's uploads go through ``staging.Upload`` on the current
    stream: spans ``stream.upload`` with the frame's ``h2d_bytes`` and, from
    a helper's third copy on, ``stream.upload_wait`` below it; the frame's
    two slots pinned."""
    from vda_tpu_torch.infer.staging import Upload
    from vda_tpu_torch.utils import trace

    model = _tiny_card_model(gen)
    stream = vt.StreamingDepth(model, input_size=56)
    assert isinstance(stream._upload_frame, Upload)
    assert stream._upload_frame.copy_stream is None
    frames = (np.random.default_rng(7).random((4, 60, 80, 3))
              * 255).astype(np.uint8)
    with trace.recording() as rec:
        for f in frames:
            stream.submit(f)
    torch.cuda.synchronize()
    spans = rec.snapshot()["spans"]
    steps = [s for s in spans if s["name"] == "stream.step"]
    firsts = [next(c for c in spans if c["parent"] == s["id"])
              for s in steps]
    assert [c["name"] for c in firsts] == ["stream.upload"] * 4
    assert [c["counters"] for c in firsts] == [{"h2d_bytes": 60 * 80 * 3}] * 4
    waits = [any(c["parent"] == u["id"] and c["name"] == "stream.upload_wait"
                 for c in spans) for u in firsts]
    assert waits == [False, False, True, True]
    assert all(slot[0].is_pinned() for slot in stream._upload_frame.slots)
