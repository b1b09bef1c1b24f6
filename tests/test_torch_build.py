"""The ctypes signatures of the kernel library against its C sources.

``vda_tpu_torch/ops/_build.py`` binds every ``extern "C"`` entry point of
``vda_tpu_torch/csrc/*.cu`` with argument types written by hand
(``_SIGNATURES``).  A signature that drifts from its source passes a pointer
as a 32-bit int or an argument to the wrong slot, and only a card would
show it.  These tests parse the sources (a regex, no compiler) and hold
each entry point to its signature: same name, same number of arguments,
and the ctypes type each C type needs.
"""

import ctypes
import glob
import os
import re

import pytest

from vda_tpu_torch.ops import _build

_ENTRY = re.compile(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)', re.S)


def _entry_points() -> dict:
    """name -> the C types of its parameters, from every csrc/*.cu."""
    found = {}
    for path in sorted(glob.glob(os.path.join(_build.CSRC, "*.cu"))):
        with open(path) as f:
            src = re.sub(r"//[^\n]*", "", f.read())
        for name, params in _ENTRY.findall(src):
            params = " ".join(params.split())
            types = [] if params in ("", "void") else [
                p.rsplit("*", 1)[0] + "*" if "*" in p
                else p.rsplit(" ", 1)[0] for p in
                (q.strip() for q in params.split(","))]
            assert name not in found, f"{name} defined twice"
            found[name] = types
    return found


ENTRY_POINTS = _entry_points()


def _ctype_of(c_type: str):
    """The ctypes type that carries the C type ``c_type``."""
    t = c_type.replace("const ", "").strip()
    if t == "unsigned long long*":
        return ctypes.POINTER(ctypes.c_ulonglong)
    if t.endswith("*"):
        return ctypes.c_void_p
    return {"int": ctypes.c_int, "float": ctypes.c_float,
            "long long": ctypes.c_longlong,
            "unsigned long long": ctypes.c_ulonglong}[t]


def test_the_sources_have_entry_points():
    # the regex finds them: the library's kernels and its two loop queries
    assert {"vda_attention", "vda_int8_linear", "vda_matmul_probe",
            "vda_gemm_loop", "vda_gemm_sm90_variant",
            "vda_attention_loop"} <= set(ENTRY_POINTS)
    assert ENTRY_POINTS["vda_gemm_loop"] == []


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_has_its_signature(name):
    assert name in _build._SIGNATURES, f"{name} has no ctypes signature"
    want = [_ctype_of(t) for t in ENTRY_POINTS[name]]
    got = _build._SIGNATURES[name]
    assert len(got) == len(want), (name, len(got), len(want))
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"{name} argument {i}: {g} for {ENTRY_POINTS[name][i]}"


def test_every_signature_has_an_entry_point():
    assert set(_build._SIGNATURES) == set(ENTRY_POINTS)


def test_pointers_and_streams_are_never_bound_as_ints():
    # a pointer passed as c_int is cut to 32 bits: every pointer parameter
    # and every stream is c_void_p (or a typed pointer)
    for name, types in ENTRY_POINTS.items():
        for t, g in zip(types, _build._SIGNATURES[name]):
            if t.endswith("*"):
                assert g not in (ctypes.c_int, ctypes.c_longlong), (name, t)
