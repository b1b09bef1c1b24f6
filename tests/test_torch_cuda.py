"""The port's four kernels against their plain twins on the card, over the
widths the model configs give them, and one small forward with and without
the kernels.

Needs an NVIDIA GPU with nvcc and Triton; elsewhere every test skips.  Run
on the GPU host from the repo root, without the JAX test configuration:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances, as max |kernel - twin| over max |twin|: bf16 K1/K2 against the
twin run in fp32 on the same bf16 inputs, 3.9e-3 (the repo's bf16-softmax
bound, docs/PARITY.md); bf16 K3/K4 against the bf16 twin, which rounds at
the same points, 2e-2 (the bound tests/test_pallas_temporal.py holds the
fused temporal kernels to); fp32, summation order only, 1e-4.
"""

import pytest
import torch

import vda_tpu_torch as vt
import vda_tpu_torch.ops as tops
from vda_tpu_torch.config import EncoderConfig, ModelConfig, get_config
from vda_tpu_torch.models.temporal import (TemporalTransformerBlock,
                                           sinusoidal_pe)
from vda_tpu_torch.ops import attention_kernel, norm_kernel, temporal_kernel

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
    got = _launched("K3", lambda: temporal_kernel.temporal_block_fused(
        blk, h, pe, heads))
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
    got = _launched("K4", lambda: temporal_kernel.attention_block_fused(
        attn, norm, h, pe, heads))
    ref = temporal_kernel.attention_block_reference(attn, norm, h, pe, heads)
    assert _rel(ref, got) < TOL_TEMPORAL[dtype]


def test_wrappers_refuse_what_the_kernels_do_not_take(gen):
    qkv = torch.randn(2, 40, 3 * 128, device="cuda", generator=gen).to(BF)
    with pytest.raises(ValueError):  # a strided view
        attention_kernel.flash_attention_qkv(qkv[:, ::2], 2, 0.125)
    with pytest.raises(ValueError):  # fp16
        attention_kernel.flash_attention_qkv(qkv.half(), 2, 0.125)
    with pytest.raises(ValueError):  # head width 4
        attention_kernel.flash_attention_qkv(qkv[..., :96].contiguous(), 8,
                                             0.5)
    with pytest.raises(NotImplementedError):  # no backward yet
        norm_kernel.fused_layer_norm(qkv[..., :128].float().requires_grad_(),
                                     torch.ones(128, device="cuda"),
                                     torch.zeros(128, device="cuda"))
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


@pytest.mark.parametrize("dtype", [BF, F32])
def test_forward_kernels_match_plain(gen, dtype):
    """A small model whose widths pass every kernel gate: each kernel runs
    its expected number of times, and the output matches attn_impl="plain"
    (bf16: bench.py's max_rel < 1e-2; fp32: 1e-4)."""
    depth = 2
    cfg = ModelConfig("small", 128, (128, 128, 640, 640), (0, 0, 1, 1),
                      EncoderConfig(embed_dim=128, depth=depth, num_heads=2,
                                    img_size=56))
    model = vt.init_random(cfg, gen, device="cuda").requires_grad_(False)
    x = torch.randn(1, 8, 56, 70, 3, device="cuda", generator=gen).to(dtype)
    tops.reset_launch_counts()
    got = vt.forward(model, x)
    torch.cuda.synchronize()
    # K2: two block norms a layer, four tap norms, mm0/mm1's ff_norm
    assert tops.launch_counts() == {"K1": depth, "K2": 2 * depth + 4 + 2,
                                    "K3": 2, "K4": 4}
    ref = vt.forward(model, x, attn_impl="plain")
    assert got.shape == ref.shape == (1, 8, 56, 70)
    assert float(ref.float().std()) > 0
    assert _rel(ref, got) < (1e-2 if dtype == BF else 1e-4)
