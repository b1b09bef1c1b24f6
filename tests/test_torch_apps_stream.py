"""The port's streaming CLI (``vda_tpu_torch.apps.run_streaming``) against
JAX's ``apps/run_streaming.py``, and ``StreamingDepth.submit_group`` against
the port's ``submit`` and JAX's ``submit_group``, on shared tiny weights
(the port's seeded model's state dict loaded strictly into JAX params by
``convert_state_dict``)."""

import numpy as np
import pytest
import torch

from vda_tpu.config import get_config as jget_config
from vda_tpu.infer import streaming as jstream
from vda_tpu.utils.convert import convert_state_dict

import vda_tpu_torch as vt
from vda_tpu_torch.apps import run as trun
from vda_tpu_torch.apps import run_streaming as tstream

from tests.torch_port import rel_err


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two torch threads: the suite's workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

# tests/test_torch_stream.py's bound for the fp32 stream against JAX's
TOL = 1e-3
# submit_group against submit: the batched encoder and tail sum in another
# order (tests/test_streaming_group.py's bound)
GROUP_TOL = 1e-5


@pytest.fixture(scope="module")
def shared():
    jcfg = jget_config("tiny")
    model = vt.init_random(vt.get_config("tiny"),
                           torch.Generator().manual_seed(2), device="cpu")
    params = convert_state_dict(
        {k: v.numpy() for k, v in model.state_dict().items()}, jcfg)
    return jcfg, params, model


@pytest.fixture(scope="module")
def frames():
    return (np.random.default_rng(0).random((9, 70, 90, 3))
            * 255).astype(np.uint8)


@pytest.fixture(scope="module")
def test_video(tmp_path_factory):
    """tests/test_cli.py's clip: 40 frames of 70x90, a rolled texture."""
    import cv2

    path = str(tmp_path_factory.mktemp("vid") / "clip.mp4")
    rng = np.random.default_rng(0)
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 12, (90, 70))
    base = (rng.random((70, 90, 3)) * 255).astype(np.uint8)
    for i in range(40):
        w.write(np.roll(base, i * 2, axis=1)[:, :, ::-1].copy())
    w.release()
    return path


@pytest.mark.parametrize("lookahead", [1, 4])
def test_streaming_cli_matches_jax(shared, test_video, tmp_path, monkeypatch,
                                   lookahead):
    """10 frames, fp32: each depth within the stream's bound of JAX's CLI
    (at --lookahead 4: a first frame, two groups of 4 and one leftover
    frame), and the visualization written."""
    import apps.run as jrun
    from apps.run_streaming import main as jmain

    jcfg, params, model = shared
    monkeypatch.setattr(jrun, "load_model", lambda args: (jcfg, params))
    monkeypatch.setattr(trun, "load_model", lambda args: (model.cfg, model))
    flags = ["--input_video", test_video, "--input_size", "56", "--fp32",
             "--max_len", "10", "--lookahead", str(lookahead)]
    ref = jmain(flags + ["--output_dir", str(tmp_path / "jax")])
    got = tstream.main(flags + ["--output_dir", str(tmp_path / "port"),
                                "--device", "cpu"])
    assert len(got) == len(ref) == 10
    for i, (a, b) in enumerate(zip(ref, got)):
        assert b.shape == (70, 90) and b.dtype == np.float32
        assert rel_err(np.asarray(a), b) < TOL, i
    assert (tmp_path / "port" / "clip_vis.mp4").exists()


def test_streaming_cli_random_init_cpu(test_video, tmp_path):
    """The CLI's own loader on the CPU, an int8 cache and --lookahead 2
    (int8 groups run frame by frame)."""
    got = tstream.main(["--input_video", test_video, "--output_dir",
                        str(tmp_path), "--encoder", "tiny", "--random-init",
                        "--device", "cpu", "--input_size", "56",
                        "--max_len", "5", "--lookahead", "2",
                        "--cache-dtype", "int8"])
    assert len(got) == 5 and all(np.isfinite(d).all() for d in got)


def test_streaming_cli_refuses_tp(tmp_path):
    with pytest.raises(SystemExit, match="ROADMAP.md"):
        tstream.main(["--input_video", str(tmp_path / "x.mp4"), "--tp", "2",
                      "--device", "cpu", "--random-init"])


def _same_cache(a, b) -> bool:
    return a.order == b.order and a.id == b.id and all(
        torch.equal(x, y) for x, y in zip(a.buffers, b.buffers, strict=True))


@pytest.mark.parametrize("kw", [dict(cache_kind="kv"),
                                dict(cache_kind="h")], ids=["kv", "h"])
def test_group_matches_submit(shared, frames, kw):
    """Two groups of 4 after the first frame: after each group the cache
    buffers are bit-identical to 4 submits', the depths within
    GROUP_TOL."""
    _, _, model = shared
    seq = vt.StreamingDepth(model, input_size=56, fp32=True, **kw)
    grp = vt.StreamingDepth(model, input_size=56, fp32=True, **kw)
    ref, got = [seq.submit(frames[0])], [grp.submit(frames[0])]
    for start in (1, 5):
        ref += [seq.submit(f) for f in frames[start:start + 4]]
        out = grp.submit_group(frames[start:start + 4])
        assert out.shape == (4, 70, 90) and out.dtype == torch.float32
        got += list(out)
        assert _same_cache(seq, grp), start
    for i, (a, b) in enumerate(zip(ref, got)):
        assert rel_err(a.numpy(), b.numpy()) < GROUP_TOL, i
    assert float(ref[-1].abs().max()) > 1e-2


@pytest.mark.parametrize("kw", [dict(cache_dtype="int8"),
                                dict(ctx_kernel=True)],
                         ids=["int8", "ctx_kernel"])
def test_group_loops_submit(shared, frames, kw):
    """An int8 cache or ctx_kernel runs the group as submits (JAX's rule):
    the same depths and cache bit for bit."""
    _, _, model = shared
    seq = vt.StreamingDepth(model, input_size=56, fp32=True, **kw)
    grp = vt.StreamingDepth(model, input_size=56, fp32=True, **kw)
    ref = [seq.submit(f) for f in frames[:3]]
    got = [grp.submit(frames[0])] + list(grp.submit_group(frames[1:3]))
    assert all(torch.equal(a, b) for a, b in zip(ref, got))
    assert _same_cache(seq, grp)
    assert all(torch.equal(x, y) for x, y in zip(seq.scales or [],
                                                 grp.scales or []))


def test_group_matches_jax_group(shared, frames):
    """The port's submit_group against JAX's on the same frames, fp32."""
    jcfg, params, model = shared
    ref_stream = jstream.StreamingDepth(params, jcfg, input_size=56,
                                        fp32=True)
    got_stream = vt.StreamingDepth(model, input_size=56, fp32=True)
    ref = [np.asarray(ref_stream.submit(frames[0]))]
    got = [got_stream.submit(frames[0]).numpy()]
    for start in (1, 5):
        ref += list(np.asarray(ref_stream.submit_group(
            frames[start:start + 4])))
        got += list(got_stream.submit_group(frames[start:start + 4]).numpy())
    assert ref_stream.order == got_stream.order
    for i, (a, b) in enumerate(zip(ref, got)):
        assert rel_err(a, b) < TOL, i


def test_group_refusals(shared, frames):
    _, _, model = shared
    s = vt.StreamingDepth(model, input_size=56, fp32=True)
    with pytest.raises(RuntimeError, match="submit"):
        s.submit_group(frames[:2])
    s.submit(frames[0])
    with pytest.raises(ValueError, match="frame size"):
        s.submit_group(frames[1:3, :60])
    assert s.id == 0


def test_group_encoder_takes_fuse_proj(shared, monkeypatch, frames):
    """A ``fuse_proj`` stream's group runs its batched encoder with
    ``fuse_proj``, as its submits do (K7 where the gate admits it)."""
    from vda_tpu_torch.infer import streaming

    calls = []
    encode = streaming.forward_features

    def spy(model, x, attn_impl="auto", fuse_proj=False, **kw):
        calls.append((x.shape[1], fuse_proj))
        return encode(model, x, attn_impl, fuse_proj, **kw)

    monkeypatch.setattr(streaming, "forward_features", spy)
    stream = vt.StreamingDepth(shared[2], input_size=56, fp32=True,
                               fuse_proj=True)
    stream.submit(frames[0])
    stream.submit_group(frames[1:3])
    assert calls == [(1, True), (2, True)]
