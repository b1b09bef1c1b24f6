"""BENCHMARK.json keeps to the contract's names and units, every name it
gives has its file, and the reference imports nothing of the program or
of JAX."""

import ast
import os
import re

import pytest

from h100_bench import harness, run

BENCH = harness.read_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_names_and_units():
    names = [c["name"] for c in BENCH["configs"]]
    names += [w["name"] for w in BENCH["workloads"]]
    names += [w["traffic"] for w in BENCH["workloads"]]
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names += [m["name"] for m in metrics]
    assert all(NAME.match(n) for n in names), names
    assert all(UNIT.match(m["unit"]) for m in metrics)
    assert all(m["better"] in ("lower", "higher") for m in metrics)
    assert len({m["name"] for m in metrics}) == len(metrics)
    for text in ([w["why"] for w in BENCH["workloads"]]
                 + [c["source"] for c in BENCH["configs"]]
                 + [m["layer"] for m in BENCH["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_every_name_has_its_files():
    for c in BENCH["configs"]:
        cfg = harness.read_json(os.path.join(harness.ROOT, c["file"]))
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    for w in BENCH["workloads"]:
        cell = harness.Cell.load(w["name"])
        assert cell.chips == 1
        drv = __import__("h100_bench.drivers." + cell.traffic["driver"],
                         fromlist=["check"])
        assert callable(drv.check)
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
        assert len(cell.end_to_end) >= 2 and cell.per_layer
    for m in BENCH["per_layer"]:
        assert callable(harness.load_reader(m["name"]))
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}


def test_bounds():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    assert {m["name"]: m for m in BENCH["end_to_end"]}["setup_s"][
        "bound"] == 0.25


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("sub", ["reference", ""])
def test_no_jax_and_a_reference_free_of_the_program(sub):
    top = os.path.join(harness.HERE, sub)
    for dirpath, _, files in os.walk(top):
        for f in files:
            if not f.endswith(".py"):
                continue
            mods = {m.split(".")[0] for m in _imports(os.path.join(dirpath,
                                                                    f))}
            assert not mods & {"jax", "jaxlib", "flax", "vda_tpu"}, f
            if sub == "reference":
                assert "vda_tpu_torch" not in mods, f


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "vda_tpu_torch_fake", types.ModuleType(
        "vda_tpu_torch_fake"))
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "vda_tpu.infer",
                        types.ModuleType("vda_tpu.infer"))
    assert run.forbidden_modules() == ["vda_tpu"]


def test_without_a_card_there_is_no_result(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this process sees a CUDA card")
    assert run.main(["--workload", "vitl.offline_720p", "--seed", "1",
                     "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""
