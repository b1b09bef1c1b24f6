"""Each kernel module of the port against the JAX Pallas kernel it replaces.

On the CPU every wrapper runs its plain twin (the CUDA and Triton kernels
themselves are held against the twins on the card by ``chip_smoke.py``);
the Pallas kernels run in interpret mode (tests/conftest.py).  All fp32:
the two sides differ only in summation order, so 2e-5 of the output scale
is the bound.  A CPU call must leave the launch counters at rest.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vda_tpu.config import get_config
from vda_tpu.models import temporal as jtemporal
from vda_tpu.ops import pallas_attention, pallas_norm, pallas_temporal

import vda_tpu_torch.ops as tops
from vda_tpu_torch import config as tconfig
from vda_tpu_torch.models.temporal import TemporalTransformerBlock
from vda_tpu_torch.ops import attention_kernel, norm_kernel, temporal_kernel
from vda_tpu_torch.ops.layers import cast_once

from tests.torch_port import rel_err

TOL = 2e-5


@pytest.fixture(autouse=True)
def counters_at_rest():
    tops.reset_launch_counts()
    yield
    assert tops.launch_counts() == {"K1": 0, "K2": 0, "K3": 0, "K4": 0,
                                    "K5": 0, "K6": 0, "K7": 0, "K8": 0,
                                    "K9": 0, "K10": 0, "K11": 0, "K12": 0,
                                    "K13": 0, "K14": 0}


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


@pytest.mark.parametrize("n,heads,dh,valid", [(17, 2, 64, None),
                                              (200, 2, 64, None),
                                              (200, 3, 32, 150),
                                              (40, 16, 8, 33)])
def test_k1_attention_qkv(n, heads, dh, valid):
    qkv = np.random.default_rng(n).standard_normal(
        (2, n, 3 * heads * dh)).astype(np.float32)
    scale = dh ** -0.5
    ref = pallas_attention.flash_attention_qkv(jnp.asarray(qkv), heads, scale,
                                               valid_len=valid)
    got = attention_kernel.flash_attention_qkv(_t(qkv), heads, scale,
                                               valid_len=valid)
    assert got.shape == ref.shape
    assert rel_err(ref, got.numpy()) < TOL


@pytest.mark.parametrize("c,eps", [(256, 1e-6), (1024, 1e-5), (256, 1e-5),
                                   (1024, 1e-6)])
def test_k2_layer_norm(c, eps):
    r = np.random.default_rng(c)
    x = (r.standard_normal((3, 37, c)) * 2 + 0.5).astype(np.float32)
    s = r.standard_normal(c).astype(np.float32)
    b = r.standard_normal(c).astype(np.float32)
    ref = pallas_norm.fused_layer_norm(jnp.asarray(x), jnp.asarray(s),
                                       jnp.asarray(b), eps)
    got = norm_kernel.fused_layer_norm(_t(x), _t(s), _t(b), eps)
    assert rel_err(ref, got.numpy()) < TOL


def _port_block(bp, c):
    """The port's TemporalTransformerBlock holding JAX block params ``bp``
    (linear weights transposed to torch's (out, in))."""
    cfg = tconfig.get_config("vitl")
    block = TemporalTransformerBlock(c, cfg).requires_grad_(False)
    for a, (ap, npp) in enumerate(zip(bp["attn"], bp["norms"])):
        attn = block.attention_blocks[a]
        for name in ("to_q", "to_k", "to_v"):
            getattr(attn, name).weight.copy_(_t(np.asarray(ap[name]["w"]).T))
        attn.to_out[0].weight.copy_(_t(np.asarray(ap["to_out"]["w"]).T))
        attn.to_out[0].bias.copy_(_t(np.asarray(ap["to_out"]["b"])))
        block.norms[a].weight.copy_(_t(np.asarray(npp["scale"])))
        block.norms[a].bias.copy_(_t(np.asarray(npp["bias"])))
    for lin, jp in ((block.ff.net[0].proj, bp["ff"]["proj"]),
                    (block.ff.net[2], bp["ff"]["out"])):
        lin.weight.copy_(_t(np.asarray(jp["w"]).T))
        lin.bias.copy_(_t(np.asarray(jp["b"])))
    block.ff_norm.weight.copy_(_t(np.asarray(bp["ff_norm"]["scale"])))
    block.ff_norm.bias.copy_(_t(np.asarray(bp["ff_norm"]["bias"])))
    return block


def _block_setup(c, bd, t, seed):
    import jax

    cfg = get_config("vitl")
    bp = jtemporal.init_temporal_module(jax.random.PRNGKey(seed), c,
                                        cfg)["blocks"][0]
    h = np.random.default_rng(seed).standard_normal((bd, t, c))
    h = h.astype(np.float32)
    pe = jtemporal._sinusoidal_pe(t, c)
    return bp, cfg, h, pe


@pytest.mark.parametrize("c,bd", [(128, 9), (256, 5)])
def test_k3_temporal_block(c, bd):
    bp, cfg, h, pe = _block_setup(c, bd, 32, seed=c)
    heads = cfg.num_attention_heads
    assert pallas_temporal.fused_block_supported(c, 32, "ape", heads)
    assert temporal_kernel.fused_block_supported(c, 32, "ape", heads)
    ref = pallas_temporal.temporal_block_fused(bp, jnp.asarray(h),
                                               jnp.asarray(pe), heads=heads,
                                               seq=32)
    got = temporal_kernel.temporal_block_fused(_port_block(bp, c), _t(h),
                                               _t(pe), heads)
    assert rel_err(ref, got.numpy()) < TOL


@pytest.mark.parametrize("c,bd", [(640, 5), (1024, 3)])
def test_k4_attention_block(c, bd):
    bp, cfg, h, pe = _block_setup(c, bd, 32, seed=c + 1)
    heads = cfg.num_attention_heads
    assert pallas_temporal.attn_fused_supported(c, 32, "ape", heads)
    ref = pallas_temporal.attention_block_fused(
        bp["attn"][1], bp["norms"][1], jnp.asarray(h), jnp.asarray(pe),
        heads=heads, seq=32)
    block = _port_block(bp, c)
    got = temporal_kernel.attention_block_fused(
        block.attention_blocks[1], block.norms[1], _t(h), _t(pe), heads)
    assert rel_err(ref, got.numpy()) < TOL


def test_gates_follow_jax():
    """The model dispatches through exactly the JAX gates, with no dtype or
    shared-memory condition: K3/K4 take every shape they admit."""
    for c, t, pe, heads in [(256, 32, "ape", 8), (1024, 32, "ape", 8),
                            (192, 32, "ape", 8), (256, 128, "ape", 8),
                            (256, 32, "rope", 8), (640, 32, "ape", 8),
                            (512, 32, "ape", 8), (1536, 32, "ape", 8),
                            (1024, 64, "ape", 8), (1024, 65, "ape", 8),
                            (1024, 32, "ape", 1), (512, 64, "ape", 64),
                            (384, 32, "ape", 48), (256, 32, "ape", 3)]:
        assert temporal_kernel.fused_block_supported(c, t, pe, heads) == \
            pallas_temporal.fused_block_supported(c, t, pe, heads)
        assert temporal_kernel.fused_block_supported(c, t, pe, heads, 1) == \
            pallas_temporal.fused_block_supported(c, t, pe, heads, 1)
        assert temporal_kernel.attn_fused_supported(c, t, pe, heads) == \
            pallas_temporal.attn_fused_supported(c, t, pe, heads)


def test_weight_casts_are_made_once(monkeypatch):
    """K3/K4 cast their weights to the working dtype once per parameter and
    make a new copy only after the parameter changes; so does the encoder
    block for K7's projection weight."""
    lin = torch.nn.Linear(128, 128).requires_grad_(False)
    w = cast_once(lin.weight, torch.bfloat16)
    assert w.dtype == torch.bfloat16 and w.is_contiguous()
    assert cast_once(lin.weight, torch.bfloat16) is w
    assert cast_once(lin.weight, torch.float32).data_ptr() == \
        lin.weight.data_ptr()  # already in the working dtype: no copy
    lin.weight.mul_(2.0)
    w2 = cast_once(lin.weight, torch.bfloat16)
    assert w2 is not w
    assert torch.equal(w2, lin.weight.to(torch.bfloat16))

    from vda_tpu_torch.models import dinov2
    from vda_tpu_torch.ops import attn_proj_kernel

    cfg = tconfig.EncoderConfig(embed_dim=128, depth=1, num_heads=2)
    blk = dinov2.Block(cfg).requires_grad_(False)
    for p in blk.parameters():
        p.uniform_(-0.1, 0.1)
    seen = []
    wrapper = attn_proj_kernel.flash_attention_qkv_proj
    monkeypatch.setattr(attn_proj_kernel, "flash_attention_qkv_proj",
                        lambda qkv, w, *a: seen.append(w) or wrapper(qkv, w,
                                                                     *a))
    x = torch.randn(1, 530, 128).to(torch.bfloat16)
    for _ in range(2):
        dinov2.block_apply(blk, x, cfg, kernels=True, fuse_proj=True)
    assert len(seen) == 2 and seen[0] is seen[1]
    assert seen[0].dtype == torch.bfloat16
    assert torch.equal(seen[0], blk.attn.proj.weight.to(torch.bfloat16))


def test_wrappers_refuse_other_devices():
    x = torch.zeros(2, 4, 384, device="meta")
    with pytest.raises(ValueError):
        attention_kernel.flash_attention_qkv(x, 2, 0.1)
    with pytest.raises(ValueError):
        norm_kernel.fused_layer_norm(x[..., :128], torch.ones(128),
                                     torch.zeros(128))
    from vda_tpu_torch.ops import attn_proj_kernel, resize_kernel
    q = x[..., :128]
    with pytest.raises(ValueError):
        attention_kernel.flash_attention_packed(q, q, q, 2, 0.1)
    with pytest.raises(ValueError):
        attn_proj_kernel.flash_attention_qkv_proj(
            x, torch.zeros(128, 128, device="meta"),
            torch.zeros(2, 128, device="meta"), q, 2, 0.1)
    with pytest.raises(ValueError):
        resize_kernel.resize_bilinear_fused(
            torch.zeros(8, 4, 4, 128, dtype=torch.bfloat16, device="meta"),
            (8, 8))
