"""The port's training slice against the JAX package: the train step with
the optimizer chain, stochastic depth, remat, the differentiable kernel
wrappers (K2, K10), ``cast_once``, checkpoints, resume and the trainer.

Both sides run fp32 on the small kernel-shaped model of tests/torch_port.py
(JAX's step with ``attn_impl="xla"``, jitted without remat where whole
steps are compared, the same function at a third of the compile time; the
port's with its default remat, its wrappers running their plain twins on
CPU tensors), the output conv's bias raised by 0.5 so the final
ReLU passes gradients (tests/test_train.py).  Tolerances: losses within
1e-5 of the total loss (the stable part alone amplifies the forward's
rounding through the cancellation in its scale-and-shift fit, 1.6e-5 of
itself here) and the gradient norm within 1e-4 relative (fp32 summation
order through a forward and a backward); every gradient within 1e-4 of
the largest gradient magnitude (a scale- and shift-invariant loss leaves
some, such as the last bias's, near zero and all rounding); parameters after AdamW updates within 3 lr (an
update is about lr times the sign of the gradient where that gradient is
near zero, so an entry may move by 2 lr in the other direction).
"""

import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from vda_tpu.loss import video_depth_loss as j_video_depth_loss
from vda_tpu.models.vda import forward as jforward
from vda_tpu.ops.layers import drop_path as j_drop_path
from vda_tpu.ops.pallas_norm import fused_layer_norm as j_fused_layer_norm
from vda_tpu.ops.pallas_resize import resize_bilinear_fused as j_resize_fused
from vda_tpu.parallel import train as jt
from vda_tpu.utils.convert import export_state_dict

import vda_tpu_torch as vt
from vda_tpu_torch.config import IMAGENET_MEAN, IMAGENET_STD
from vda_tpu_torch.models.vda import forward as tforward
from vda_tpu_torch.ops import layers, norm_kernel, resize_kernel
from vda_tpu_torch.ops.resize import resize_bilinear
from vda_tpu_torch.parallel import train as tt
from vda_tpu_torch.utils import checkpoint as tckpt

from tests.torch_port import small_models

S = 56  # the small model's input side


def _live_relu(params, model):
    b = params["head"]["output_conv2"]["conv1"]["b"]
    params["head"]["output_conv2"]["conv1"]["b"] = b + 0.5
    with torch.no_grad():
        model.head.scratch.output_conv2[2].bias.add_(0.5)
    return params, model


@pytest.fixture(scope="module")
def setup():
    params, jcfg, model, tcfg = small_models(seed=4)
    params, model = _live_relu(params, model)
    return params, jcfg, model.state_dict(), tcfg


def _port_model(setup):
    _, _, sd, tcfg = setup
    model = vt.VideoDepthAnything(tcfg, device="cpu")
    model.load_state_dict(sd)
    return model


def _batch(seed, b=1, t=2, static_depth=False):
    rng = np.random.default_rng(seed)
    depth = rng.random((b, t, S, S)) * 3 + 0.2
    if static_depth:  # the same depth in every frame: every pixel in the
        depth[:] = depth[:, :1]  # temporal loss's mask
    return {"video": rng.random((b, t, S, S, 3)).astype(np.float32),
            "depth": depth.astype(np.float32),
            "mask": rng.random((b, t, S, S)) > 0.2 if not static_depth
            else np.ones((b, t, S, S), bool)}


def _close(a, b, rtol):
    return abs(float(a) - float(b)) <= rtol * max(abs(float(b)), 1e-12)


OPTIMIZERS = {
    # one AdamW update with clipping
    "one_step": (1, dict(learning_rate=1e-3, clip_norm=0.5)),
    # three updates along the warmup-cosine schedule (lr 0, peak, 0.55
    # peak: the schedule's first update has lr 0, as optax's)
    "three_steps": (3, dict(learning_rate=1e-3, warmup_steps=1,
                            total_steps=3, clip_norm=0.5)),
    # schedule, clip and accumulation over 2: four micro-steps, two updates
    "accum2": (4, dict(learning_rate=1e-3, warmup_steps=1, total_steps=2,
                       clip_norm=0.5, accum_steps=2)),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_train_steps_match_jax(setup, name):
    params, jcfg, _, _ = setup
    n, kw = OPTIMIZERS[name]
    jopt, topt = jt.make_optimizer(**kw), tt.make_optimizer(**kw)
    jstep = jax.jit(jt.make_train_step(jcfg, jopt, remat=False))
    tstep = tt.make_train_step(topt)
    model = _port_model(setup)
    js, ts = jt.init_train_state(params, jopt), tt.init_train_state(model,
                                                                    topt)
    for i in range(n):
        b = _batch(i)
        js, jm = jstep(js, {k: jnp.asarray(v) for k, v in b.items()})
        ts, tm = tstep(ts, b)
        total = abs(float(jm["total_loss"]))
        for k in ("total_loss", "spatial_loss", "stable_loss"):
            assert abs(float(tm[k]) - float(jm[k])) <= 1e-5 * total, \
                (i, k, float(tm[k]), float(jm[k]))
        assert _close(tm["grad_norm"], jm["grad_norm"], 1e-4), i
    assert ts.step == int(js.step) == n
    jsd = export_state_dict(js.params, jcfg)
    lr = kw["learning_rate"]
    moved = 0.0
    for k, p in model.named_parameters():
        p0 = setup[2][k].numpy()
        assert float(np.abs(jsd[k] - p.detach().numpy()).max()) <= 3 * lr, k
        moved = max(moved, float(np.abs(p.detach().numpy() - p0).max()))
    assert moved > 0.5 * lr  # the parameters did take real updates


def test_rope_swiglu_train_step_matches_jax():
    """One step of a RoPE + SwiGLU model (both slices' new code under
    autograd, through the plain ops) against JAX's, on a 40%-valid mask:
    the loss within 1e-4 of itself, the gradient norm within 1e-3
    relative (the dense mask's median pixel amplifies rounding, see
    ``test_median_gradient_sits_on_the_median_pixel``)."""
    params, jcfg, model, _ = small_models(seed=9, pe="rope",
                                          ffn_layer="swiglufused")
    params, model = _live_relu(params, model)
    kw = dict(learning_rate=1e-3, clip_norm=0.5)
    jopt, topt = jt.make_optimizer(**kw), tt.make_optimizer(**kw)
    jstep = jax.jit(jt.make_train_step(jcfg, jopt, remat=False))
    tstep = tt.make_train_step(topt)
    b = _batch(12)
    b["mask"] = np.random.default_rng(13).random(b["mask"].shape) > 0.6
    _, jm = jstep(jt.init_train_state(params, jopt),
                  {k: jnp.asarray(v) for k, v in b.items()})
    _, tm = tstep(tt.init_train_state(model, topt), b)
    assert _close(tm["total_loss"], jm["total_loss"], 1e-4)
    assert _close(tm["grad_norm"], jm["grad_norm"], 1e-3)
    assert float(jm["grad_norm"]) > 0


def test_gradients_match_jax(setup):
    """The gradient of the step's loss for every parameter: ``jax.grad``
    of JAX's loss function (``attn_impl="xla"``, remat) against autograd of
    the port's, through the numpy carry of ``export_state_dict``."""
    params, jcfg, _, _ = setup
    b = _batch(11)
    mean, std = np.asarray(IMAGENET_MEAN), np.asarray(IMAGENET_STD)

    def jloss(p):
        video = (jnp.asarray(b["video"]) - mean) / std
        pred = jforward(p, video.astype(jnp.float32), jcfg, attn_impl="xla",
                        micro_batch_size=2, remat=True)
        return j_video_depth_loss(pred, jnp.asarray(b["depth"]),
                                  jnp.asarray(b["mask"]))["total_loss"]

    jv, jg = jax.jit(jax.value_and_grad(jloss))(params)
    jg = export_state_dict(jg, jcfg)
    model = _port_model(setup)
    video = (torch.from_numpy(b["video"]) - torch.tensor(IMAGENET_MEAN)) \
        / torch.tensor(IMAGENET_STD)
    pred = tforward(model, video.float(), attn_impl="xla",
                    micro_batch_size=2, remat=True)
    loss = vt.video_depth_loss(pred, torch.from_numpy(b["depth"]),
                               torch.from_numpy(b["mask"]))["total_loss"]
    loss.backward()
    assert _close(loss.detach(), jv, 1e-5)
    names = [k for k, _ in model.named_parameters()]
    scale = max(float(np.abs(np.asarray(jg[k])).max()) for k in names)
    for k, p in model.named_parameters():
        ref = np.asarray(jg[k])
        got = np.zeros_like(ref) if p.grad is None else p.grad.numpy()
        assert float(np.abs(got - ref).max()) <= 1e-4 * scale, k


def test_drop_path_with_a_supplied_mask_matches_jax():
    x = np.random.default_rng(0).standard_normal((64, 3, 5)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    for rate in (0.0, 0.25, 0.9):
        ref = np.asarray(j_drop_path(jnp.asarray(x), rate, key))
        # JAX's mask: its drop_path of ones (0 or 1/keep per sample)
        mask = np.asarray(j_drop_path(jnp.ones((64, 1)), rate, key))[:, 0]
        got = layers.apply_drop_path(torch.from_numpy(x),
                                     torch.from_numpy(mask.copy()))
        np.testing.assert_array_equal(got.numpy(), ref)
    gen = torch.Generator().manual_seed(0)
    m = layers.drop_path_mask(4096, 0.4, gen)
    assert set(np.unique(m.numpy()).tolist()) <= {0.0, np.float32(1 / 0.6)}
    assert 0.55 < float((m > 0).float().mean()) < 0.65
    xt = torch.from_numpy(x)
    assert layers.drop_path(xt, 0.0, gen) is xt


def test_remat_equals_no_remat_with_drop_path(setup):
    """``remat`` recomputes each block with the drop-path masks drawn before
    the checkpoint: loss and every gradient are those of the plain
    forward with the same generator."""
    b = _batch(5)
    video = torch.from_numpy(b["video"]).float()
    out = []
    for remat in (False, True):
        model = _port_model(setup)
        gen = torch.Generator().manual_seed(7)
        pred = tforward(model, video, attn_impl="xla", micro_batch_size=2,
                        remat=remat, drop_path_rate=0.5, generator=gen)
        loss = vt.video_depth_loss(pred, torch.from_numpy(b["depth"]),
                                   torch.from_numpy(b["mask"]))["total_loss"]
        loss.backward()
        out.append((loss.detach(), {k: p.grad.clone() for k, p in
                                    model.named_parameters()
                                    if p.grad is not None}))
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1)
    assert g0.keys() == g1.keys()
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], rtol=1e-6, atol=1e-9)
    # the drop is real: without it the loss differs
    model = _port_model(setup)
    plain = tforward(model, video, attn_impl="xla", micro_batch_size=2)
    assert not torch.equal(vt.video_depth_loss(
        plain, torch.from_numpy(b["depth"]),
        torch.from_numpy(b["mask"]))["total_loss"].detach(), l0)


def test_k2_function_gradient(monkeypatch):
    """K2's autograd Function (its forward swapped for the plain twin here:
    the kernel itself runs on the card, tests/test_torch_cuda.py): the
    gradients of x, weight and bias equal autograd through the twin, and
    match JAX's custom VJP of ``fused_layer_norm`` (Pallas in interpret
    mode) within 1e-5 of their scale."""
    monkeypatch.setattr(norm_kernel, "_launch",
                        lambda x, w, b, eps: norm_kernel.layer_norm_reference(
                            x, w, b, eps))
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((6, 10, 256)) * 2 + 0.5).astype(np.float32)
    w, b = (rng.standard_normal(256).astype(np.float32) for _ in range(2))
    gy = rng.standard_normal(x.shape).astype(np.float32)

    def grads(fn):
        ins = [torch.tensor(a, requires_grad=True) for a in (x, w, b)]
        fn(*ins).backward(torch.from_numpy(gy))
        return [t.grad.numpy() for t in ins]

    got = grads(lambda *a: norm_kernel._FusedLayerNorm.apply(*a, 1e-6))
    twin = grads(lambda *a: norm_kernel.layer_norm_reference(*a, 1e-6))
    _, vjp = jax.vjp(lambda *a: j_fused_layer_norm(*a, 1e-6),
                     *(jnp.asarray(a) for a in (x, w, b)))
    ref = vjp(jnp.asarray(gy))
    for g, t, r in zip(got, twin, ref):
        np.testing.assert_array_equal(g, t)
        r = np.asarray(r)
        assert float(np.abs(g - r).max()) <= 1e-5 * float(np.abs(r).max())
    # only the inputs that need it get a gradient
    xt = torch.tensor(x, requires_grad=True)
    norm_kernel._FusedLayerNorm.apply(xt, torch.from_numpy(w),
                                      torch.from_numpy(b), 1e-6).sum().backward()
    assert xt.grad is not None


def test_k10_function_gradient(monkeypatch):
    """K10's autograd Function (forward swapped for the twin): the input
    gradient equals autograd through the plain separable form and matches
    JAX's custom VJP of ``resize_bilinear_fused`` (interpret mode), both bf16
    separable products, within two bf16 ulps of the scale (3.9e-3)."""
    monkeypatch.setattr(resize_kernel, "_launch",
                        resize_kernel.resize_bilinear_fused_reference)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((8, 9, 7, 128)).astype(np.float32)
    gy = rng.standard_normal((8, 16, 14, 128)).astype(np.float32)
    xb, gb = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, gy))

    def grad(fn):
        xi = xb.clone().requires_grad_(True)
        fn(xi).backward(gb)
        return xi.grad.float().numpy()

    got = grad(lambda t: resize_kernel._ResizeBilinearFused.apply(t,
                                                                  (16, 14)))
    twin = grad(lambda t: resize_bilinear(t, (16, 14), kernel=False))
    np.testing.assert_array_equal(got, twin)
    _, vjp = jax.vjp(lambda a: j_resize_fused(a, (16, 14)),
                     jnp.asarray(x, jnp.bfloat16))
    ref = np.asarray(vjp(jnp.asarray(gy, jnp.bfloat16))[0], np.float32)
    assert float(np.abs(got - ref).max()) <= 3.9e-3 * float(np.abs(ref).max())


def test_cast_once_keeps_the_graph():
    p = torch.nn.Parameter(torch.randn(4, 3))
    c = layers.cast_once(p, torch.bfloat16)
    assert c.requires_grad and c.grad_fn is not None
    (c.float() * 2).sum().backward()
    assert p.grad is not None and float(p.grad.abs().min()) == 2.0
    assert layers.cast_once(p, torch.float32) is p  # no cast: p itself
    with torch.no_grad():  # no gradient wanted: the cached detached copy
        a = layers.cast_once(p, torch.bfloat16)
        assert not a.requires_grad and a is layers.cast_once(p,
                                                             torch.bfloat16)
    q = torch.nn.Parameter(torch.randn(4, 3), requires_grad=False)
    assert layers.cast_once(q, torch.bfloat16) is \
        layers.cast_once(q, torch.bfloat16)


def _same_state(a, b):
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert sa.keys() == sb.keys()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    oa, ob = a.opt_state.state_dict(), b.opt_state.state_dict()
    for pa, pb in zip(oa["adam"]["state"].values(),
                      ob["adam"]["state"].values(), strict=True):
        assert all(torch.equal(pa[k], pb[k]) for k in pa)
    assert all(torch.equal(x, y) for x, y in zip(oa["acc"], ob["acc"]))
    assert (oa["mini_step"], oa["count"], a.step) == \
        (ob["mini_step"], ob["count"], b.step)


def test_checkpoint_round_trip(setup, tmp_path):
    """Three steps with accumulation over 2 (mid-group: the accumulator
    holds a gradient), saved and restored into a freshly initialised state
    bit for bit; the model part loads into an inference model as it is."""
    opt = tt.make_optimizer(1e-3, warmup_steps=1, total_steps=3,
                            clip_norm=0.5, accum_steps=2)
    step = tt.make_train_step(opt)
    st = tt.init_train_state(_port_model(setup), opt)
    for i in range(3):
        st, _ = step(st, _batch(i))
    path = tckpt.save_train_state(str(tmp_path), st)
    assert tckpt.latest_checkpoint(str(tmp_path)) == path
    assert st.opt_state.mini_step == 1
    assert float(st.opt_state.acc[0].abs().max()) > 0
    fresh = tt.init_train_state(
        vt.init_random(setup[3], torch.Generator().manual_seed(9), "cpu"), opt)
    restored, start = tckpt.resume_or_init(str(tmp_path), fresh)
    assert start == 3 and restored is fresh
    _same_state(st, restored)
    ckpt = torch.load(path, weights_only=True)
    infer = vt.VideoDepthAnything(setup[3], device="cpu")
    infer.load_state_dict(ckpt["model"])
    x = torch.rand(1, 2, S, S, 3)
    with torch.no_grad():
        assert torch.equal(vt.forward(infer, x), vt.forward(st.model, x))
    none, start = tckpt.resume_or_init(str(tmp_path / "none"), fresh)
    assert none is fresh and start == 0


def _clips(seed=0):
    rng = np.random.default_rng(seed)
    while True:
        yield {"video": rng.random((1, 2, 60, 64, 3), dtype=np.float32),
               "depth": rng.random((1, 2, 60, 64), dtype=np.float32) * 3
               + 0.2, "mask": rng.random((1, 2, 60, 64)) > 0.1}


TRAIN_KW = dict(learning_rate=1e-3, schedule=True, warmup_steps=2,
                clip_norm=0.5, accum=2, augment_hw=(S, S), augment_seed=3)


def test_resumed_run_equals_an_unbroken_one(setup, tmp_path):
    """train() for 6 steps in one go, and for 4 then (a fresh model)
    resumed to 6 from the checkpoint: the same parameters, optimizer state
    and metrics (the consumed batches are skipped, the augmentation
    replays from (augment_seed, step))."""
    one, two = tmp_path / "one", tmp_path / "two"
    log_a, log_b = [], []
    a = vt.train(_port_model(setup), _clips(), 6, ckpt_dir=str(one),
                 ckpt_every=2, log_fn=lambda s, m: log_a.append(s),
                 metrics_path=str(one) + ".jsonl", prefetch=2, **TRAIN_KW)
    vt.train(_port_model(setup), _clips(), 4, ckpt_dir=str(two),
             log_fn=lambda s, m: log_b.append(s),
             metrics_path=str(two) + ".jsonl", prefetch=0, **TRAIN_KW)
    fresh = vt.init_random(setup[3], torch.Generator().manual_seed(9), "cpu")
    b = vt.train(fresh, _clips(), 6, ckpt_dir=str(two),
                 log_fn=lambda s, m: log_b.append(s),
                 metrics_path=str(two) + ".jsonl", prefetch=2, **TRAIN_KW)
    assert log_a == log_b == list(range(6))
    _same_state(a, b)
    rows = [[json.loads(line) for line in open(str(d) + ".jsonl")]
            for d in (one, two)]
    for ra, rb in zip(*rows, strict=True):
        assert {k: v for k, v in ra.items() if k != "wall_s"} == \
            {k: v for k, v in rb.items() if k != "wall_s"}
    assert sorted(os.listdir(one)) == [f"step_{i:08d}.pt" for i in (2, 4, 6)]


def test_trainer_metrics_jsonl_and_refusals(setup, tmp_path):
    path = tmp_path / "m.jsonl"
    model = _port_model(setup)
    before = [p.detach().clone() for p in model.parameters()]
    st = vt.train(model, _clips(1), 3, learning_rate=1e-3,
                  augment_hw=(S, S), metrics_path=str(path),
                  log_fn=lambda s, m: None)
    rows = [json.loads(line) for line in open(path)]
    assert [r["step"] for r in rows] == [0, 1, 2] and st.step == 3
    for r in rows:
        assert set(r) == {"step", "total_loss", "spatial_loss",
                          "stable_loss", "grad_norm", "wall_s"}
        assert all(np.isfinite(v) for v in r.values())
    assert any(not torch.equal(a, p) for a, p in zip(before,
                                                     model.parameters()))
    with pytest.raises(NotImplementedError):
        vt.train(model, _clips(), 1, tp=2)
    with pytest.raises(NotImplementedError):
        vt.train(model, _clips(), 1, sp=True)


def test_accumulation_equals_the_large_batch(setup):
    """Two micro-steps with accumulation over 2 hand AdamW the mean of
    their gradients, which for two equal halves of a batch is the large
    batch's gradient (per-clip losses of equal pixel counts: all pixels
    valid, the same depth in every frame); the first micro-step leaves the
    parameters untouched.  Within 1e-3 of the largest gradient: the
    stable loss's scale-and-shift fit, ill-conditioned on the near-constant
    predictions of random weights, turns the 2e-7 by which a batch of two
    and two batches of one differ in their predictions into 3e-4 of the
    stable loss (tests/test_train.py allows 1e-3 in absolute terms)."""
    b1, b2 = _batch(1, static_depth=True), _batch(2, static_depth=True)
    big = {k: np.concatenate([b1[k], b2[k]]) for k in b1}

    def handed_to_adam(batches, accum):
        opt = tt.make_optimizer(1e-3, accum_steps=accum)
        st = tt.init_train_state(_port_model(setup), opt)
        seen = {}
        real = st.opt_state.adam.step

        def spy():
            seen.update({id(p): p.grad.clone() for p in st.params()})
            real()

        st.opt_state.adam.step = spy
        step = tt.make_train_step(opt)
        for i, b in enumerate(batches):
            before = [p.detach().clone() for p in st.params()]
            st, _ = step(st, b)
            if i < len(batches) - 1:
                assert all(torch.equal(a, p) for a, p in zip(before,
                                                             st.params()))
        return [seen[id(p)] for p in st.params()]

    acc = handed_to_adam([b1, b2], 2)
    ref = handed_to_adam([big], 1)
    scale = max(float(r.abs().max()) for r in ref)
    for a, r in zip(acc, ref, strict=True):
        assert float((a - r).abs().max()) <= 1e-3 * scale


def test_schedule_and_clip_match_optax():
    import optax

    sched = optax.warmup_cosine_decay_schedule(0.0, 1e-3, 3, 10, 1e-4)
    opt = tt.make_optimizer(1e-3, warmup_steps=3, total_steps=10)
    for c in range(14):
        assert abs(opt.lr(c) - float(sched(c))) <= 1e-6 * 1e-3
    assert tt.make_optimizer(2e-4).lr(5) == 2e-4
    # clipping: optax's clip_by_global_norm (no epsilon) against ours
    rng = np.random.default_rng(0)
    g = [rng.standard_normal(s).astype(np.float32) for s in ((3, 4), (5,))]
    for max_norm in (0.5, 100.0):
        ref, _ = optax.clip_by_global_norm(max_norm).update(
            [jnp.asarray(a) for a in g], None)
        params = [torch.nn.Parameter(torch.zeros(a.shape)) for a in g]
        for p, a in zip(params, g):
            p.grad = torch.from_numpy(a.copy())
        o = tt.make_optimizer(1.0, weight_decay=0.0, clip_norm=max_norm)
        st = o.init(params)
        st.adam.step = lambda: None  # read the clipped gradients only
        o.update(st, params)
        for p, r in zip(params, ref):
            np.testing.assert_allclose(p.grad.numpy(), np.asarray(r),
                                       rtol=1e-6, atol=1e-7)
        # clip_grad_norm_ (with its 1e-6) differs by under 1e-6 relative
        q = [torch.nn.Parameter(torch.zeros(a.shape)) for a in g]
        for x, a in zip(q, g):
            x.grad = torch.from_numpy(a.copy())
        torch.nn.utils.clip_grad_norm_(q, max_norm)
        for p, x in zip(params, q):
            assert float((p.grad - x.grad).abs().max()) <= \
                1e-6 / max_norm * float(x.grad.abs().max()) + 1e-7
