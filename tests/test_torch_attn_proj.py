"""K7 (attention + out-projection + LayerScale + residual) against the JAX
package's ``flash_attention_qkv_proj`` and its ``VDA_ATTN_FUSE_PROJ=1``
encoder branch.

On the CPU K7's wrapper runs its plain twin; the Pallas kernel runs in
interpret mode (tests/conftest.py).  fp32 differs in summation order only:
2e-5 of the output scale for the kernel and for the encoder (measured: 1e-6
for the block, 8e-6 for the encoder's taps).  bf16 is held to the JAX
package's own bound for the fused kernel, 2e-2
(tests/test_attn_fuse_proj.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vda_tpu.config import EncoderConfig, ModelConfig
from vda_tpu.models import dinov2 as jdinov2
from vda_tpu.models import init_video_depth_anything
from vda_tpu.ops import pallas_attention
from vda_tpu.utils.convert import export_state_dict

import vda_tpu_torch as vt
import vda_tpu_torch.ops as tops
from vda_tpu_torch import config as tconfig
from vda_tpu_torch.models import dinov2 as tdinov2
from vda_tpu_torch.ops import attn_proj_kernel

from tests.torch_port import rel_err

TOL = {np.float32: 2e-5, "bf16": 2e-2}


def _t(a):
    return torch.from_numpy(np.array(a, np.float32, copy=True))


def _inputs(n, c, seed):
    r = np.random.default_rng(seed)
    qkv = r.standard_normal((2, n, 3 * c)).astype(np.float32)
    w = (r.standard_normal((c, c)) * c ** -0.5).astype(np.float32)  # (in, out)
    gb = np.stack([1 + 0.5 * r.standard_normal(c),
                   0.1 * r.standard_normal(c)]).astype(np.float32)
    x = r.standard_normal((2, n, c)).astype(np.float32)
    return qkv, w, gb, x


@pytest.mark.parametrize("dtype", [np.float32, "bf16"])
@pytest.mark.parametrize("n,valid", [(96, None), (176, None), (256, None),
                                     (200, 150)])
def test_k7_twin_matches_pallas(n, valid, dtype):
    """C=128 with 4 heads; (200, 150) is ragged and masks keys past 150."""
    heads, c = 4, 128
    qkv, w, gb, x = _inputs(n, c, seed=n)
    jdt = jnp.float32 if dtype is np.float32 else jnp.bfloat16
    tdt = torch.float32 if dtype is np.float32 else torch.bfloat16
    ref = pallas_attention.flash_attention_qkv_proj(
        jnp.asarray(qkv, jdt), jnp.asarray(w, jdt), jnp.asarray(gb),
        jnp.asarray(x, jdt), heads, (c // heads) ** -0.5, valid_len=valid)
    tops.reset_launch_counts()
    got = attn_proj_kernel.flash_attention_qkv_proj(
        _t(qkv).to(tdt), _t(w).t().contiguous().to(tdt), _t(gb),
        _t(x).to(tdt), heads, (c // heads) ** -0.5, valid)
    assert tops.launch_counts()["K7"] == 0  # the twin ran
    assert got.dtype == tdt and got.shape == (2, n, c)
    assert rel_err(np.asarray(ref, np.float32), got.float().numpy()) \
        < TOL[dtype]


def _encoders(seed, **kw):
    """(JAX encoder params, JAX EncoderConfig, port encoder, port
    EncoderConfig) sharing one set of weights: C=128 with 4 heads of 32.
    The attention weights, biases and LayerScales are refilled from numpy
    (the init's small qkv weights give near-uniform attention, its biases
    are zero and its LayerScales equal), so that the attention half is a
    large part of each block's output and a fault in any argument of K7
    shows."""
    vit = dict(embed_dim=128, depth=2, num_heads=4, **kw)
    head = ("enc", 64, (64, 64, 64, 64), (0, 1, 1, 1))
    jcfg = ModelConfig(*head, EncoderConfig(**vit))
    tcfg = tconfig.ModelConfig(*head, tconfig.EncoderConfig(**vit))
    params = init_video_depth_anything(jax.random.PRNGKey(seed), jcfg)
    r = np.random.default_rng(seed)
    for blk in params["pretrained"]["blocks"]:
        for name, std in (("qkv", 2.0), ("proj", 1.0)):
            w = blk["attn"][name]["w"]
            blk["attn"][name] = {
                "w": jnp.asarray(std * 128 ** -0.5
                                 * r.standard_normal(w.shape), jnp.float32),
                "b": jnp.asarray(0.1 * r.standard_normal(w.shape[1]),
                                 jnp.float32)}
        for ls in ("ls1", "ls2"):
            blk[ls] = jnp.asarray(1 + 0.5 * r.standard_normal(128),
                                  jnp.float32)
    model = vt.VideoDepthAnything(tcfg, device="cpu").requires_grad_(False)
    vt.load_state_dict_numpy(model, export_state_dict(params, jcfg))
    return params["pretrained"], jcfg.vit, model.pretrained, tcfg.vit


@pytest.fixture
def k7_calls(monkeypatch):
    """Counts the model's calls of the K7 wrapper."""
    n = []
    wrapper = attn_proj_kernel.flash_attention_qkv_proj
    monkeypatch.setattr(attn_proj_kernel, "flash_attention_qkv_proj",
                        lambda *a, **k: n.append(1) or wrapper(*a, **k))
    return n


def _block_case(monkeypatch):
    """One block at N=530 (a count the port's gate admits) in fp32: the JAX
    block with its switch on, and a function running the port's block with
    ``fuse_proj``."""
    params, cfg, enc, tcfg = _encoders(0)
    x = np.random.default_rng(2).standard_normal((1, 530, 128))
    x = x.astype(np.float32)
    monkeypatch.setenv("VDA_ATTN_FUSE_PROJ", "1")
    ref = jdinov2.block_apply(params["blocks"][0], jnp.asarray(x), cfg,
                              attn_impl="pallas")
    assert attn_proj_kernel.use_fused_proj(530, 4, 32)

    def port():
        with torch.no_grad():
            return tdinov2.block_apply(enc.blocks[0], _t(x), tcfg,
                                       kernels=True, fuse_proj=True).numpy()
    return ref, port


def test_block_apply_fused_matches_jax(monkeypatch, k7_calls):
    """Both sides on their fused branch."""
    ref, port = _block_case(monkeypatch)
    got = port()
    assert len(k7_calls) == 1
    assert rel_err(ref, got) < 2e-5


# Faults of the fused branch's arguments, each planted in the call of K7.
_FAULTS = {
    "w_untransposed": lambda q, w, gb, x, h, s: (q, w.t(), gb, x, h, s),
    "gamma_bias_swapped": lambda q, w, gb, x, h, s: (q, w, gb.flip(0), x, h,
                                                     s),
    "scale": lambda q, w, gb, x, h, s: (q, w, gb, x, h, 2 * s),
    "no_residual": lambda q, w, gb, x, h, s: (q, w, gb, torch.zeros_like(x),
                                              h, s),
}


@pytest.mark.parametrize("fault", sorted(_FAULTS))
def test_block_apply_planted_fault_fails(monkeypatch, fault):
    """The comparison above sees each planted fault of the fused branch
    (measured: 0.44 of the output scale or more)."""
    ref, port = _block_case(monkeypatch)
    wrapper = attn_proj_kernel.flash_attention_qkv_proj
    monkeypatch.setattr(attn_proj_kernel, "flash_attention_qkv_proj",
                        lambda *a: wrapper(*_FAULTS[fault](*a)))
    assert rel_err(ref, port()) > 0.1


def test_encode_fused_matches_jax(monkeypatch, k7_calls):
    """encode at 322x322 (N=530) in fp32 with the switch on both sides."""
    params, cfg, enc, _ = _encoders(4, img_size=322)
    img = np.random.default_rng(5).standard_normal((1, 322, 322, 3))
    img = img.astype(np.float32)
    monkeypatch.setenv("VDA_ATTN_FUSE_PROJ", "1")
    ref = jdinov2.encode(params, jnp.asarray(img), cfg, tap_idx=(0, 1),
                         attn_impl="pallas")
    n = 23 * 23 + 1
    assert attn_proj_kernel.use_fused_proj(n, 4, 32)
    assert jdinov2._fuse_proj_usable(-(-n // 128) * 128, cfg, "pallas")
    with torch.no_grad():
        got = tdinov2.encode(enc, _t(img), (0, 1), fuse_proj=True)
    assert len(k7_calls) == 2
    for (rt, rc), (gt, gc) in zip(ref, got):
        assert rel_err(rt, gt.numpy()) < 2e-5
        assert rel_err(rc, gc.numpy()) < 2e-5


def test_gate_follows_jax(monkeypatch):
    """``attn_proj_fits`` equals the JAX copy; ``use_fused_proj`` equals
    JAX's ``_fuse_proj_usable`` as the JAX encoder evaluates it on a TPU
    (N lane-padded to 128 when its attention kernel engages), with the
    kernel's head-width limit on top."""
    monkeypatch.setattr(jdinov2, "_on_tpu", lambda: True)
    grid = [(n, heads, dh) for n in (17, 100, 511, 512, 530, 1370, 1376,
                                     2000, 4000)
            for heads, dh in ((16, 64), (24, 64), (6, 64), (12, 64), (2, 64),
                              (4, 32), (8, 12), (5, 24), (8, 136), (4, 256),
                              (2, 200))]
    admitted = set()
    for n, heads, dh in grid:
        assert attn_proj_kernel.attn_proj_fits(n, heads, dh) == \
            pallas_attention.attn_proj_fits(n, heads, dh)
        cfg = EncoderConfig(embed_dim=heads * dh, depth=1, num_heads=heads)
        n_jax = -(-n // 128) * 128 if jdinov2._use_pallas(n, dh) else n
        jax_gate = jdinov2._fuse_proj_usable(n_jax, cfg, "auto")
        got = attn_proj_kernel.use_fused_proj(n, heads, dh)
        assert got == (jax_gate and dh <= 128), (n, heads, dh)
        if got:
            admitted.add((heads, dh))
    assert (16, 64) in admitted                              # vitl
    assert not attn_proj_kernel.use_fused_proj(1370, 24, 64)  # vitg
    # admitted by JAX, refused by the kernel (dh > 128): the split path
    cfg = EncoderConfig(embed_dim=4 * 256, depth=1, num_heads=4)
    assert jdinov2._fuse_proj_usable(512, cfg, "auto")
    assert not attn_proj_kernel.use_fused_proj(512, 4, 256)
