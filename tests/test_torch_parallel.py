"""The port's multi-GPU training (``parallel/trainer.train`` with ``tp`` and
``sp`` on a torch.distributed world) against the port at one rank, on gloo
ranks on the CPU (``tests/torch_ranks.body_train``).

Four ranks, dp2 x tp2 with sequence parallelism, run 2 steps of the tiny
model at 70x70 (26 tokens, which split over tp 2) on a global batch of 2
clips with a sparse (40%) mask, the clip augmentation (each data rank
keeps its slice of the whole batch's draws) and global-norm clipping that
engages: the
loss within 1e-4 and grad_norm within 1e-3 relative of one rank's
(``tests/test_torch_train.py``'s train bounds, loosened for the sums over
ranks), every rank's metrics equal, each parameter's change over the two
steps within 5e-2 of one rank's change by relative norm (a parameter left
where it was is 1 off, half its update 0.5), and a run resumed from the
step-1 checkpoint (saved whole by rank 0, restored in pieces) equal to the
unbroken run bit for bit.  The one-rank run is computed while the ranks
run.

Why 5e-2 and not tighter: AdamW divides each gradient entry by its own
root mean square, so an entry whose gradient is near zero moves by up to
about lr whatever its size, and the sums over ranks change such an entry's
sign or size in its last bits.  Under 1% of a leaf's entries are such;
they leave a change's relative norm up to 1.0e-2 off on this model, at any
learning rate (measured at 3e-6, 1e-4).  LR 1e-4 keeps every update far
above fp32's rounding of the parameters (1.2e-7 at 1.0).  The loss's data-parallel
form (``video_depth_loss(group=)``) and the trainer's refusals run here
too.
"""

import dataclasses

import numpy as np
import pytest

import torch

import vda_tpu_torch as vt
from vda_tpu_torch.loss import video_depth_loss

from tests import torch_ranks

LR = 1e-4
DELTA_RTOL = 5e-2
CLIP = 0.05  # below the step's gradient norms: clipping engages


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _model():
    cfg = vt.get_config("tiny")
    cfg = cfg.replace(vit=dataclasses.replace(cfg.vit, img_size=70))
    m = vt.init_random(cfg, torch.Generator().manual_seed(3), device="cpu")
    with torch.no_grad():  # the final ReLU passes gradients
        m.head.scratch.output_conv2[2].bias.add_(0.5)
    return m


def _batches(n=2, b=2):
    rng = np.random.default_rng(0)
    return [{"video": rng.random((b, 2, 70, 70, 3), dtype=np.float32),
             "depth": rng.random((b, 2, 70, 70), dtype=np.float32) * 3 + 0.2,
             "mask": rng.random((b, 2, 70, 70)) < 0.4} for _ in range(n)]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train")
    model = _model()
    torch_ranks.save_model(tmp, model)
    batches = _batches()
    kw = dict(clip_norm=CLIP, learning_rate=LR, augment_hw=(70, 70))
    started = torch_ranks.start("body_train", 4, tmp, tp=2, sp=True,
                                batches=batches, steps=2, resume_from=1,
                                **kw)
    logs = []
    try:
        before = torch_ranks.load_model(tmp).state_dict()
        one = torch_ranks.load_model(tmp).requires_grad_(True)
        vt.train(one, iter(batches), 2, prefetch=0, log_fn=lambda s, m:
                 logs.append({k: float(v) for k, v in m.items()}), **kw)
    finally:  # the ranks are waited for even if the one-rank run failed
        ranks = started.results()
    return before, one, logs, ranks


def change_gap(before, after, ref) -> float:
    """||(after - before) - (ref - before)|| / ||ref - before||, in fp64;
    for a parameter ``ref`` left where it was, ||after - before||."""
    want = ref.double() - before.double()
    got = after.double() - before.double()
    n = want.norm().item()
    return ((got - want).norm().item() / n) if n else got.norm().item()


def test_dp_tp_sp_steps_match_one_rank(trained):
    before, one, logs, ranks = trained
    assert logs[0]["grad_norm"] > CLIP
    ref = one.state_dict()
    moved = [k for k, v in ref.items() if not torch.equal(v, before[k])]
    assert len(moved) > 0.9 * len(ref)  # the one-rank steps trained
    for r in ranks:
        assert r["logs"] == ranks[0]["logs"]
        for a, b in zip(logs, r["logs"], strict=True):
            for k in ("spatial_loss", "stable_loss", "total_loss"):
                assert abs(a[k] - b[k]) <= 1e-4 * abs(a["total_loss"]), k
            assert abs(a["grad_norm"] - b["grad_norm"]) \
                <= 1e-3 * a["grad_norm"]
        gaps = {k: change_gap(before[k], r["sd"][k], v)
                for k, v in ref.items()}
        worst = max(gaps, key=gaps.get)
        assert gaps[worst] < DELTA_RTOL, (worst, gaps[worst])


def test_dp_tp_sp_resume_equals_unbroken_run(trained):
    *_, ranks = trained
    for r in ranks:
        assert r["resumed_logs"] == r["logs"][1:]
        assert all(torch.equal(r["resumed_sd"][k], v)
                   for k, v in r["sd"].items())


def test_loss_over_a_group_of_one_is_the_loss():
    """``group=None`` is the plain loss; the data-parallel form's gather
    keeps the gradient on this rank's entries (checked over ranks by the
    train steps above)."""
    b = _batches(1)[0]
    pred = torch.from_numpy(b["depth"][::-1].copy()).requires_grad_(True)
    a = video_depth_loss(pred, torch.from_numpy(b["depth"]),
                         torch.from_numpy(b["mask"]))
    c = video_depth_loss(pred, torch.from_numpy(b["depth"]),
                         torch.from_numpy(b["mask"]), group=None)
    assert all(torch.equal(a[k], c[k]) for k in a)


def test_trainer_refusals():
    """sp without tp > 1 (JAX's ValueError), and a tp the world does not
    divide."""
    m = _model()
    with pytest.raises(ValueError, match="sp=True requires tp > 1"):
        vt.train(m, iter(_batches()), 1, sp=True, prefetch=0)
    with pytest.raises(ValueError, match="not divisible by tp=2"):
        vt.train(m, iter(_batches()), 1, tp=2, prefetch=0)
