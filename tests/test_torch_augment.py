"""The port's clip augmentation and input pipeline.

Augmentation: the deterministic half (``apply_augment``) against JAX's
``augment_batch`` with JAX's own draws (the boxes, flips and jitter factors
its key gives, recovered by the same ``jax.random`` calls), fp32, video
within 1e-5 absolute of [0, 1] values (two matrix products in another
summation order), depth and mask exact (nearest-tap selection).  The port's
random stream differs from JAX's by design; its draws are checked for their
ranges and for determinism under one seed.

Prefetch (``utils/data.py``): order, end, exceptions raised at the
consumer, back-pressure, the item cap and close, as tests/test_data.py
holds the JAX pipeline to.
"""

import threading
import time

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from vda_tpu.utils import augment as jaug
from vda_tpu_torch.utils import augment as taug
from vda_tpu_torch.utils.data import prefetch_to_device, sized_prefetch


def _batch(b=2, t=3, h=20, w=24, seed=0):
    rng = np.random.default_rng(seed)
    return {"video": rng.random((b, t, h, w, 3)).astype(np.float32),
            "depth": (rng.random((b, t, h, w)) * 5 + 0.1).astype(np.float32),
            "mask": rng.random((b, t, h, w)) > 0.2}


def _jax_draws(key, b, h, w, scale_range=(0.6, 1.0), jitter=(0.2, 0.2, 0.2)):
    """The draws JAX's ``augment_batch`` makes from ``key``, by its own
    sequence of splits."""
    out = {k: [] for k in ("y0", "y1", "x0", "x1", "flip", "brightness",
                           "contrast", "saturation")}
    for ks in jax.random.split(key, b):
        k0, k1, k2 = jax.random.split(ks, 3)
        ky, kx = jax.random.split(k0)
        for name, key_, size in (("y", ky, h), ("x", kx, w)):
            lo, hi = jaug._sample_box(key_, size, scale_range)
            out[f"{name}0"].append(float(lo))
            out[f"{name}1"].append(float(hi))
        out["flip"].append(bool(jax.random.bernoulli(k1, 0.5)))
        for name, kk, amount in zip(("brightness", "contrast", "saturation"),
                                    jax.random.split(k2, 3), jitter):
            out[name].append(float(jax.random.uniform(
                kk, (), jnp.float32, 1.0 - amount, 1.0 + amount)))
    return {k: torch.tensor(v) for k, v in out.items()}


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("out_hw", [(14, 16), (28, 28)])
def test_apply_augment_matches_jax(seed, out_hw):
    batch = _batch(seed=seed)
    key = jax.random.PRNGKey(seed)
    ref = jaug.augment_batch(key, {k: jnp.asarray(v) for k, v in batch.items()},
                             out_hw=out_hw)
    draws = _jax_draws(key, 2, 20, 24)
    got = taug.apply_augment({k: torch.from_numpy(v) for k, v in batch.items()},
                             draws, out_hw)
    assert got["video"].shape == (2, 3, *out_hw, 3)
    assert float(np.abs(np.asarray(ref["video"])
                        - got["video"].numpy()).max()) < 1e-5
    np.testing.assert_array_equal(np.asarray(ref["depth"]),
                                  got["depth"].numpy())
    np.testing.assert_array_equal(np.asarray(ref["mask"]), got["mask"].numpy())
    assert got["mask"].dtype == torch.bool


def test_flip_is_taken_and_every_modality_follows_it():
    """A forced flip mirrors video, depth and mask alike (a full-frame box
    resamples exactly)."""
    batch = {k: torch.from_numpy(v) for k, v in _batch(b=1).items()}
    draws = {"y0": torch.tensor([0.0]), "y1": torch.tensor([19.0]),
             "x0": torch.tensor([0.0]), "x1": torch.tensor([23.0]),
             "brightness": torch.ones(1), "contrast": torch.ones(1),
             "saturation": torch.ones(1)}
    for flip in (False, True):
        got = taug.apply_augment(batch, {**draws,
                                         "flip": torch.tensor([flip])},
                                 (20, 24))
        want = {k: v.flip(-2 if k == "video" else -1) if flip else v
                for k, v in batch.items()}
        torch.testing.assert_close(got["video"], want["video"], atol=1e-6,
                                   rtol=0)
        assert torch.equal(got["depth"], want["depth"])
        assert torch.equal(got["mask"], want["mask"])


def test_sample_augment_ranges_and_determinism():
    gen = torch.Generator().manual_seed(5)
    d = taug.sample_augment(gen, 256, 20, 24)
    for a, size in (("y", 20), ("x", 24)):
        lo, hi = d[f"{a}0"], d[f"{a}1"]
        span = hi - lo
        assert (lo >= 0).all() and (hi <= size - 1 + 1e-5).all()
        assert (span >= 0.6 * (size - 1) - 1e-5).all()
        assert (span <= (size - 1) + 1e-5).all()
    assert d["flip"].dtype == torch.bool and 0.3 < d["flip"].float().mean() < 0.7
    for k in ("brightness", "contrast", "saturation"):
        assert (d[k] >= 0.8).all() and (d[k] <= 1.2).all()
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    a = taug.augment_batch(torch.Generator().manual_seed(1), batch, (14, 16))
    b = taug.augment_batch(torch.Generator().manual_seed(1), batch, (14, 16))
    c = taug.augment_batch(torch.Generator().manual_seed(2), batch, (14, 16))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["video"], c["video"])
    assert float(a["video"].min()) >= 0.0 and float(a["video"].max()) <= 1.0


def test_prefetch_order_and_termination():
    items = [{"x": np.full((2, 2), i, np.float32)} for i in range(7)]
    out = list(prefetch_to_device(iter(items), "cpu"))
    assert len(out) == 7
    for i, item in enumerate(out):
        assert isinstance(item["x"], torch.Tensor)
        assert float(item["x"][0, 0]) == i


def test_prefetch_exception_propagates():
    def bad():
        yield {"x": np.zeros(2)}
        raise RuntimeError("decode failed")

    it = prefetch_to_device(bad())
    next(it)
    with pytest.raises(RuntimeError, match="decode failed"):
        next(it)


def test_prefetch_backpressure_and_close():
    produced = []

    def gen():
        for i in range(100):
            produced.append(i)
            yield i

    it = prefetch_to_device(gen(), buffer_size=2)
    next(it)
    time.sleep(0.3)
    # 1 consumed + 2 queued + at most 1 in flight in the producer
    assert len(produced) <= 4
    it.close()
    deadline = time.time() + 5
    while time.time() < deadline and any(
            t.name == "vda-prefetch" and t.is_alive()
            for t in threading.enumerate()):
        time.sleep(0.05)
    assert not any(t.name == "vda-prefetch" and t.is_alive()
                   for t in threading.enumerate())
    assert len(produced) <= 5


def test_sized_prefetch_caps_an_endless_iterator():
    def infinite():
        i = 0
        while True:
            yield i
            i += 1

    assert list(sized_prefetch(infinite(), limit=5)) == [0, 1, 2, 3, 4]
    assert list(sized_prefetch(infinite(), limit=0)) == []
    with pytest.raises(ValueError):
        next(prefetch_to_device(iter([1]), buffer_size=0))
