"""A run with the timed path broken underneath comes out not correct, and
the control does not pass the limits, at the tiny configuration on the
CPU; the control at the cells' own sizes runs on a card.

Each fault is planted in the program's own function, so the run drives
the whole of the harness past its look for a card: set-up, window, check.
"""

import time

import numpy as np
import pytest
import torch

from h100_bench import harness, session
from h100_bench.tests import tiny_cells

SEED = 2 ** 41 + 99


def _run(name, config="tiny", **kw):
    result, lines = session.run_cell(tiny_cells.cell(name, config), SEED,
                                     1.0, False, "cpu", time.perf_counter(),
                                     **kw)
    assert len(lines) == len(result["checks"])
    return result


def _altered(d):
    """One frame's depths doubled where the window produces them."""
    d = d.clone()
    d[:, 3] *= 2.0
    return d


def _half_mean(d):
    """The second half of the batch left out, filled with the mean of the
    first half."""
    d = d.clone()
    half = d.shape[1] // 2
    d[:, half:] = d[:, :half].mean(dim=1, keepdim=True)
    return d


def _unaligned(depth_list, metric=False):
    """Stitching whose state never moves: no scale or shift, no blend."""
    out = list(depth_list[:32])
    for fid in range(32, len(depth_list), 32):
        out += depth_list[fid + 10:fid + 32]
    return out


@pytest.mark.parametrize("fault", ["none", "altered", "half_mean",
                                   "unaligned"])
def test_offline_faults(monkeypatch, fault):
    from vda_tpu_torch.infer import windowed

    step = windowed._window_step
    if fault == "unaligned":
        monkeypatch.setattr(windowed, "stitch_windows", _unaligned)
    elif fault != "none":
        change = {"altered": _altered, "half_mean": _half_mean}[fault]
        monkeypatch.setattr(windowed, "_window_step",
                            lambda *a, **k: change(step(*a, **k)))
    result = _run("vits.offline_480p")
    assert result["correct"] == (fault == "none"), tiny_cells.dump(result)
    assert result["failed"] == 0 or fault != "none"


@pytest.mark.parametrize("fault", ["none", "state_unchanged", "altered",
                                   "half_mean"])
def test_stream_faults(monkeypatch, fault):
    from vda_tpu_torch.infer import streaming

    group = streaming._stream_step_group
    if fault == "state_unchanged":
        monkeypatch.setattr(streaming.StreamingDepth, "_commit",
                            lambda self, rows, pos: None)
    elif fault != "none":
        change = {"altered": _altered, "half_mean": _half_mean}[fault]

        def broken(*a, **k):
            depths, held = group(*a, **k)
            return change(depths[None])[0], held

        monkeypatch.setattr(streaming, "_stream_step_group", broken)
    result = _run("vitl.stream_720p")
    assert result["correct"] == (fault == "none"), tiny_cells.dump(result)


def _swapped_swiglu(blk, x, mesh=None, seq_shard=False):
    """The program's SwiGLU with its halves swapped: ``w3(silu(x2) * x1)``."""
    from vda_tpu_torch.models import dinov2

    x1, x2 = dinov2.linear(blk.mlp.w12, x).chunk(2, dim=-1)
    return dinov2._out(blk.mlp.w3, torch.nn.functional.silu(x2) * x1, mesh,
                       seq_shard)


@pytest.mark.parametrize("fault", ["none", "swiglu_swapped"])
@pytest.mark.parametrize("name", ["vits.offline_480p", "vitl.stream_720p"])
def test_swiglu_faults(monkeypatch, name, fault):
    from vda_tpu_torch.models import dinov2

    if fault == "swiglu_swapped":
        monkeypatch.setattr(dinov2, "_mlp", _swapped_swiglu)
    result = _run(name, "tiny_swiglu")
    assert result["correct"] == (fault == "none"), tiny_cells.dump(result)


@pytest.mark.parametrize("config", tiny_cells.CONFIGS)
@pytest.mark.parametrize("name", ["vits.offline_480p", "vitl.stream_720p"])
def test_control_fails_the_limits(name, config):
    result = _run(name, config, control=True)
    cell = tiny_cells.cell(name, config)
    assert any(v > cell.limits[k] for k, v in result["control"].items())


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["vitl.offline_720p", "vits.offline_480p",
                                  "vitl.stream_720p"])
def test_control_fails_the_cell_limits_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("the control at the cell's size runs on a CUDA card")
    cell = harness.Cell.load(name)
    result, _ = session.run_cell(cell, SEED, 5.0, False, "cuda:0",
                                 time.perf_counter(), control=True)
    assert result["correct"], result["checks"]
    assert any(v > cell.limits[k] for k, v in result["control"].items())
    assert np.isfinite(list(result["control"].values())).all()
