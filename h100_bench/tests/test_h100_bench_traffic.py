"""The traffic is made from the seed alone."""

import numpy as np

from h100_bench import frames as fr
from h100_bench.reference.weights import generator_seed, make_state_dict
from h100_bench.tests import tiny_cells


def test_canvases_repeat_by_seed():
    a = fr.canvases(2 ** 40 + 1, 2, 30, 50, "cpu")
    b = fr.canvases(2 ** 40 + 1, 2, 30, 50, "cpu")
    c = fr.canvases(1, 2, 30, 50, "cpu")  # 2**40 + 1 in the low 32 bits
    assert a.dtype == np.uint8 and a.shape == (2, 30, 50, 3)
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert not np.array_equal(a[0], a[1])
    assert a.std() > 20  # not a flat image


def test_generator_seed_uses_every_bit():
    seeds = [1, 2 ** 32 + 1, 2 ** 40 + 1, 2 ** 31, 3 * 2 ** 33]
    assert len({generator_seed(s) for s in seeds}) == len(seeds)
    assert all(0 <= generator_seed(s) < 2 ** 63 for s in seeds)


def test_weights_repeat_by_seed():
    cfg = tiny_cells.cell("vits.offline_480p").cfg
    a = make_state_dict(cfg, 5, "cpu")
    b = make_state_dict(cfg, 5, "cpu")
    c = make_state_dict(cfg, 6, "cpu")
    k = "pretrained.blocks.0.attn.qkv.weight"
    assert all((a[n] == b[n]).all() for n in a)
    assert not (a[k] == c[k]).all()


def test_panned_frames_move_with_the_camera():
    canvas = fr.canvases(3, 1, 20, 40, "cpu")[0]
    v = fr.panned(canvas, 5, (20, 30), 2)
    assert v.shape == (5, 20, 30, 3)
    assert np.array_equal(v[3][:, :-6], v[0][:, 6:])
    assert np.array_equal(v[[1, 4]], np.stack([v[1], v[4]]))


def test_sweep_goes_there_and_back():
    pos = [fr.sweep_position(i, 4) for i in range(8)]
    assert pos == [0, 1, 2, 3, 2, 1, 0, 1]


def test_every_seed_runs_the_same_clips():
    import torch

    from h100_bench.drivers import offline
    from types import SimpleNamespace

    cell = tiny_cells.cell("vits.offline_480p")
    cell.traffic.update(clip_lengths=[24, 48, 56], warmup_frames=24)
    runs = []
    for seed in (9, 9, 10):
        ctx = SimpleNamespace(cfg=cell.cfg, traffic=cell.traffic, seed=seed,
                              dev=SimpleNamespace(device=torch.device("cpu")))
        st = offline.setup(ctx)
        runs.append([st.video(v) for v in range(6)])
    assert [v.shape[0] for v in runs[0]] == [24, 48, 56] * 2
    assert [v.shape for v in runs[0]] == [v.shape for v in runs[2]]
    assert all(np.array_equal(a, b) for a, b in zip(runs[0], runs[1]))
    assert not np.array_equal(runs[0][0], runs[2][0])
