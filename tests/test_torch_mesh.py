"""The port's multi-GPU inference paths (``vda_tpu_torch/parallel/mesh.py``)
against the JAX package's mesh runs, on gloo ranks on the CPU.

The partition rules against JAX's ``_spec_for_path`` (with its guard) over
every key of the tiny and vitg models; shard / unshard round trips bit for
bit; a 4-rank dp2 x tp2 world (``tests/torch_ranks.body_window``): its
collectives a forward (2 x depth + 8 all-reduces, no all-gather), the whole
state dict gathered back bit for bit, ``infer_video_depth(mesh=)`` against
JAX's ``infer_video_depth(mesh=make_mesh(4, tp=2))`` and the
sequence-parallel forward against JAX's ``seq_shard`` forward
(``tests/test_parallel_integration.py``'s cases); a 2-rank tp stream
(``body_stream``) over STREAM_MAX_CACHE + 6 steps with a ``submit_group``
of 4, kv cache bf16 and int8, against JAX's tp streams, and what a tp
stream refuses.  Shared weights go port -> JAX (``init_random`` then
``convert_state_dict``).  fp32, JAX's own bound: rtol 1e-4, atol 1e-5.
Each world's JAX references are computed while its ranks run.
"""

import dataclasses

import numpy as np
import pytest

import jax
import torch

from vda_tpu.config import get_config as jget_config
from vda_tpu.parallel.mesh import _spec_for_path
from vda_tpu.parallel.mesh import make_mesh as jmake_mesh
from vda_tpu.parallel.mesh import param_shardings
from vda_tpu.utils.convert import convert_state_dict

import vda_tpu_torch as vt
from vda_tpu_torch.config import STREAM_MAX_CACHE
from vda_tpu_torch.parallel import mesh as tpm

from tests import torch_ranks

RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two torch threads: the suite's workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cpu_mesh(n, tp):
    devs = jax.devices("cpu")
    if len(devs) < n:
        pytest.skip("needs virtual CPU devices")
    return jmake_mesh(n_devices=n, tp=tp, devices=devs)


def _shared(cfg, seed):
    """(JAX params, port model) of one set of seeded weights."""
    model = vt.init_random(cfg, torch.Generator().manual_seed(seed),
                           device="cpu").requires_grad_(False)
    jcfg = jget_config("tiny")
    if cfg.vit.img_size != jcfg.vit.img_size or cfg.num_frames != 32:
        jcfg = jcfg.replace(
            num_frames=cfg.num_frames,
            vit=dataclasses.replace(jcfg.vit, img_size=cfg.vit.img_size))
    params = convert_state_dict(
        {k: v.numpy() for k, v in model.state_dict().items()}, jcfg)
    return params, jcfg, model


def _jax_path(name: str) -> str:
    """The JAX pytree path's suffix that ``_spec_for_path`` keys on."""
    return (name.replace("to_out.0.", "to_out.").replace(".weight", ".w")
            .replace(".bias", ".b").replace(".", "/"))


def _jax_split(name, shape, tp):
    """(split dim in the port's layout, groups) of JAX's rule and guard for
    a port parameter, or None where JAX replicates it.  JAX's linear
    weights are (in, out), the port's (out, in); its qkv rule is the one of
    ``to_tp_layout``'s (d, 3, d) form."""
    path = _jax_path(name)
    if path.endswith("attn/qkv/w") or path.endswith("attn/qkv/b"):
        d = shape[0] // 3
        jshape = (shape[1], 3, d) if len(shape) == 2 else (3, d)
        jdim_of = {2: 0} if len(shape) == 2 else {1: 0}
        groups = 3
    elif len(shape) == 2:
        jshape = (shape[1], shape[0])
        jdim_of = {0: 1, 1: 0}
        groups = 1
    else:
        jshape, jdim_of, groups = tuple(shape), {0: 0}, 1
    spec = _spec_for_path(path, len(jshape))
    split = [i for i, a in enumerate(spec) if a == "model"]
    if not split or len(spec) > len(jshape):
        return None
    if any(jshape[i] % tp for i in split):  # JAX's guard
        return None
    (jdim,) = split
    if path.endswith("w12/w") or path.endswith("w12/b"):
        groups = 2  # the port splits each half (JAX: GSPMD reshards)
    return jdim_of[jdim], groups


@pytest.mark.parametrize("encoder", ["tiny", "vitg"])
@pytest.mark.parametrize("tp", [2, 3, 4])
def test_partition_rules_match_jax(encoder, tp):
    """Every parameter is split on the dim JAX's rule splits, or kept
    whole where JAX's guard keeps it whole; beyond JAX, the port keeps an
    attention whole where tp does not divide its heads (a rank computes
    whole heads), and splits vitg's w12 by halves."""
    model = vt.VideoDepthAnything(vt.get_config(encoder), device="meta")
    cfg = model.cfg
    specs = tpm.partition_specs(model, tp)
    n_split = 0
    for name, p in model.named_parameters():
        want = _jax_split(name, tuple(p.shape), tp)
        heads = (cfg.vit.num_heads if name.startswith("pretrained.")
                 else cfg.num_attention_heads)
        if want is not None and (".attn." in name
                                 or ".attention_blocks." in name) \
                and heads % tp:
            want = None
        if want is not None and want[1] > 1 and \
                (p.shape[want[0]] // want[1]) % tp:
            want = None  # a group tp does not divide
        assert specs.get(name) == want, name
        n_split += want is not None
    if encoder == "vitg" and tp == 2:
        assert specs["pretrained.blocks.0.mlp.w12.weight"] == (0, 2)
        assert n_split == 40 * 6 + 4 * 2 * 4
    if encoder == "vitg" and tp == 3:  # 4096 hidden units: the MLP whole
        assert "pretrained.blocks.0.mlp.w12.weight" not in specs
        assert "pretrained.blocks.0.attn.qkv.weight" in specs
        assert not any(".attention_blocks." in k for k in specs)  # 8 heads
    if encoder == "tiny" and tp == 4:  # 2 heads: the attention whole
        assert "pretrained.blocks.0.attn.qkv.weight" not in specs
        assert "pretrained.blocks.0.mlp.fc1.weight" in specs


def test_shard_unshard_round_trip():
    """Each spec's pieces reassemble bit for bit, and rank m's qkv rows
    are ``[q | k | v]`` of heads m; w12's, its share of each half."""
    g = torch.Generator().manual_seed(0)
    full = torch.randn(3 * 64, 64, generator=g)
    pieces = [tpm.shard_tensor(full, (0, 3), m, 2) for m in range(2)]
    assert torch.equal(pieces[1][:32], full[32:64])
    assert torch.equal(pieces[1][32:64], full[96:128])
    assert torch.equal(pieces[1][64:], full[160:])
    assert torch.equal(tpm.unshard_tensor(pieces, (0, 3)), full)
    for spec, shape in (((0, 1), (64, 8)), ((1, 1), (8, 64)),
                        ((0, 2), (128, 8)), ((0, 3), (96,))):
        t = torch.randn(*shape, generator=g)
        for n in (2, 4):
            ps = [tpm.shard_tensor(t, spec, m, n) for m in range(n)]
            assert torch.equal(tpm.unshard_tensor(ps, spec), t)
    w12 = torch.arange(16.0)[:, None]
    assert tpm.shard_tensor(w12, (0, 2), 1, 2)[:, 0].tolist() == \
        [4.0, 5.0, 6.0, 7.0, 12.0, 13.0, 14.0, 15.0]


@pytest.fixture(scope="module")
def window_world(tmp_path_factory):
    """The 4-rank dp2 x tp2 run and its JAX counterparts."""
    tmp = tmp_path_factory.mktemp("window")
    params, jcfg, model = _shared(vt.get_config("tiny"), 2)
    torch_ranks.save_model(tmp, model)
    cfg70 = vt.get_config("tiny", num_frames=2)
    cfg70 = cfg70.replace(vit=dataclasses.replace(cfg70.vit, img_size=70))
    params70, jcfg70, model70 = _shared(cfg70, 4)
    torch_ranks.save_model(tmp, model70, "weights_sp.pt")
    rng = np.random.default_rng(0)
    frames = (rng.random((50, 70, 90, 3)) * 255).astype(np.uint8)
    x = rng.random((1, 2, 56, 56, 3)).astype(np.float32)
    sp_x = rng.random((2, 2, 70, 70, 3)).astype(np.float32)
    started = torch_ranks.start("body_window", 4, tmp, tp=2, frames=frames,
                                x=x, sp_x=sp_x)
    try:
        refs = {"window": _jax_window(params, jcfg, frames),
                "sp": _jax_sp_forward(params70, jcfg70, sp_x)}
    finally:  # the ranks are waited for even if a reference failed
        ranks = started.results()
    return model, jcfg70, refs, ranks


def _jax_window(params, jcfg, frames):
    """JAX's dp2 x tp2 ``infer_video_depth`` (``test_hybrid_dp_tp_inference``)."""
    from vda_tpu.infer import infer_video_depth as jinfer

    mesh = _cpu_mesh(4, 2)
    with jax.set_mesh(mesh):
        ref, _ = jinfer(jax.device_put(params, param_shardings(params, mesh)),
                        frames, 24, jcfg, input_size=56, fp32=True,
                        window_batch=2, mesh=mesh)
    return ref


def _jax_sp_forward(params70, jcfg70, sp_x):
    """JAX's ``seq_shard`` forward on its dp2 x tp2 mesh
    (``test_sequence_parallel_equivalence_and_collectives``'s config)."""
    from vda_tpu.models.vda import forward as jforward
    from vda_tpu.parallel.mesh import to_tp_layout

    cfg_sp = jcfg70.replace(tp_layout=True, vit=dataclasses.replace(
        jcfg70.vit, seq_shard=True))
    mesh = _cpu_mesh(4, 2)
    p_tp = to_tp_layout(params70)
    p_tp = jax.device_put(p_tp, param_shardings(p_tp, mesh))
    with jax.set_mesh(mesh):
        return np.asarray(jax.jit(lambda p, xx: jforward(
            p, xx, cfg_sp, attn_impl="xla", micro_batch_size=4))(p_tp, sp_x))


def test_dp_tp_window_matches_jax(window_world):
    """``infer_video_depth(mesh=)`` on dp2 x tp2 ranks: every rank's
    stitched video within JAX's bound of JAX's dp2 x tp2 run
    (``test_hybrid_dp_tp_inference``), the same on every rank."""
    _, _, refs, ranks = window_world
    ref = refs["window"]
    for r in ranks:
        np.testing.assert_allclose(r["depths"], ref, rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(r["depths"], ranks[0]["depths"])


def test_tp_forward_collectives_and_shards(window_world):
    """A tp2 forward: one all-reduce after each row-parallel projection
    (2 an encoder block, 1 a temporal attention block: 2 x depth + 8), no
    all-gather or reduce-scatter; whole heads on each rank; the state dict
    gathered back bit for bit."""
    model, _, _, ranks = window_world
    cfg = model.cfg
    want = 2 * cfg.vit.depth + 4 * cfg.num_transformer_block \
        * cfg.num_attention_blocks
    d = cfg.vit.embed_dim
    for r in ranks:
        c = r["counts"]
        assert (c["all_reduce"], c["all_gather"], c["reduce_scatter"]) == \
            (want, 0, 0)
        assert r["round_trip"]
        assert r["shapes"]["pretrained.blocks.0.attn.qkv.weight"] == \
            (3 * d // 2, d)
        assert r["shapes"]["pretrained.blocks.0.attn.proj.weight"] == \
            (d, d // 2)
        assert r["shapes"]["pretrained.blocks.0.attn.proj.bias"] == (d,)
        tq = ("head.motion_modules.0.temporal_transformer.transformer_blocks"
              ".0.attention_blocks.1.")
        assert r["shapes"][tq + "to_q.weight"] == (16, 32)
        assert r["shapes"][tq + "to_out.0.weight"] == (32, 16)
        assert r["shapes"]["head.scratch.output_conv1.weight"] == \
            tuple(model.head.scratch.output_conv1.weight.shape)


def test_sequence_parallel_forward_matches_jax(window_world):
    """``seq_shard`` on dp2 x tp2 (26 tokens at 70x70) against JAX's
    ``seq_shard`` forward on its mesh
    (``test_sequence_parallel_equivalence_and_collectives``): the values,
    and the collectives: an all-gather entering attention and the MLP and
    a reduce-scatter leaving them in each block, each tap gathered, the
    temporal all-reduces unchanged."""
    _, jcfg70, refs, ranks = window_world
    ref = refs["sp"]
    depth = jcfg70.vit.depth
    for r in ranks:
        np.testing.assert_allclose(r["sp"], ref, rtol=RTOL, atol=ATOL)
        c = r["sp_counts"]
        assert c["all_gather"] == 2 * depth + 4
        assert c["reduce_scatter"] == 2 * depth
        assert c["all_reduce"] == 8


@pytest.fixture(scope="module")
def stream_world(tmp_path_factory):
    """The 2-rank tp stream and JAX's tp streams."""
    tmp = tmp_path_factory.mktemp("stream")
    params, jcfg, model = _shared(vt.get_config("tiny"), 5)
    torch_ranks.save_model(tmp, model)
    rng = np.random.default_rng(7)
    frames = (rng.random((STREAM_MAX_CACHE + 6, 70, 90, 3)) * 255) \
        .astype(np.uint8)
    started = torch_ranks.start("body_stream", 2, tmp, frames=frames,
                                group_at=20, cache_dtypes=("bf16", "int8"))
    try:
        refs = {cd: _jax_stream(params, jcfg, frames, _cpu_mesh(2, 2), cd,
                                20) for cd in ("bf16", "int8")}
    finally:
        ranks = started.results()
    return params, jcfg, model, frames, refs, ranks


def _jax_stream(params, jcfg, frames, mesh, cache_dtype, group_at):
    from vda_tpu.infer import StreamingDepth as JStream

    s = JStream(params, jcfg, input_size=56, fp32=True, mesh=mesh,
                cache_dtype=cache_dtype)
    depths, orders = [], []
    i = 0
    while i < len(frames):
        if i == group_at:
            depths.extend(np.asarray(s.submit_group(frames[i:i + 4])))
            i += 4
        else:
            depths.append(np.asarray(s.submit(frames[i])))
            i += 1
        orders.append(list(s.order))
    return np.stack(depths), orders


@pytest.mark.parametrize("cache_dtype", ["bf16", "int8"])
def test_tp_stream_matches_jax(stream_world, cache_dtype):
    """A tp2 kv stream past eviction with a group of 4 (int8 groups run as
    submits in both packages): each step within JAX's bound of JAX's tp2
    stream, ``order`` equal after every call, the ranks' depths equal, and
    each rank's cache half the channels of a one-device stream's (the
    int8 scales, one a row, whole)."""
    _, _, model, frames, refs, ranks = stream_world
    ref, orders = refs[cache_dtype]
    one = vt.StreamingDepth(model, input_size=56, fp32=True,
                            cache_dtype=cache_dtype)
    one.submit(frames[0])
    scales = 0 if one.scales is None else sum(
        s.numel() * s.element_size() for s in one.scales)
    for r in ranks:
        got = r[cache_dtype]
        np.testing.assert_allclose(got["depths"], ref, rtol=RTOL, atol=ATOL)
        assert got["orders"] == orders
        np.testing.assert_array_equal(got["depths"],
                                      ranks[0][cache_dtype]["depths"])
        assert got["cache_bytes"] == (one.cache_bytes() - scales) // 2 \
            + scales
    assert len(orders[-1]) == STREAM_MAX_CACHE


def test_tp_stream_refusals(stream_world):
    """Under a tp mesh an explicit ``ctx_kernel=True`` and
    ``VDA_STREAM_DIRECT=1`` raise (JAX: "experimental streaming flavors do
    not support tensor parallelism"), and ``VDA_STREAM_CTX_KERNEL=1``
    yields."""
    from vda_tpu.infer import StreamingDepth as JStream

    params, jcfg, _, _, _, ranks = stream_world
    for r in ranks:
        msgs = r["refusals"]
        assert "tensor-parallel" in msgs["ctx_kernel"]
        assert "experimental streaming flavors" in msgs["direct"]
        assert msgs["knob_yields"]
        assert r["inherits_mesh"]
    with pytest.raises(ValueError, match="experimental"):
        JStream(params, jcfg, input_size=56, ring=True, mesh=_cpu_mesh(2, 2))


def test_make_mesh_alone_and_refusals():
    """Without a process group the mesh is this process; tp must divide
    the devices, and n_devices may not exceed the world."""
    mesh = tpm.make_mesh(device="cpu")
    assert (mesh.world, mesh.tp, mesh.dp, mesh.rank) == (1, 1, 1, 0)
    assert mesh.shape == {"data": 1, "model": 1}
    assert mesh.data_group is None and mesh.model_group is None
    with pytest.raises(ValueError, match="not divisible by tp=2"):
        tpm.make_mesh(tp=2, device="cpu")
    with pytest.raises(ValueError, match="world of 1"):
        tpm.make_mesh(n_devices=2, device="cpu")
    assert tpm.backend_for("cpu", 2) == "gloo"


def test_a_model_runs_under_one_mesh():
    """The mesh a model was sharded over is the one its entry points use
    when given none (``use_mesh``); another one raises."""
    model = vt.init_random(vt.get_config("tiny"),
                           torch.Generator().manual_seed(0),
                           device="cpu").requires_grad_(False)
    assert tpm.use_mesh(model, None) is None
    mesh = tpm.make_mesh(device="cpu")
    assert tpm.use_mesh(model, mesh) is mesh
    assert tpm.model_mesh(model) is mesh and tpm.use_mesh(model, None) is mesh
    other = tpm.make_mesh(device="cpu")
    frames = np.zeros((4, 56, 56, 3), np.uint8)
    with pytest.raises(ValueError, match="another mesh"):
        vt.StreamingDepth(model, input_size=56, fp32=True, mesh=other)
    with pytest.raises(ValueError, match="another mesh"):
        vt.infer_video_depth(model, frames, 24, input_size=56, fp32=True,
                             mesh=other)
    step = vt.make_train_step(vt.make_optimizer(), mesh=other)
    with pytest.raises(ValueError, match="another mesh"):
        step(vt.init_train_state(model.requires_grad_(True),
                                 vt.make_optimizer()), {})
