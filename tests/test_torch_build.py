"""The ctypes bindings of the port's CUDA libraries against their sources.

Each library's C entry points are typed by ``_build.SIGNATURES``; a
parameter missing there, or typed as an int where the C code takes a
pointer, shows only on the card (a cut pointer or a shifted argument).
These tests read the ``extern "C"`` declarations of every source in
``repro_torch/kernels/csrc`` on the CPU and hold the bindings to them.
"""

import ctypes
import re

import pytest

from repro_torch.kernels import _build

_DEF = re.compile(r"^(?:int|const char\*)\s+(\w+)\(([^)]*)\)\s*\{", re.MULTILINE)


def _c_type(param: str):
    """The ctypes type a C parameter declaration binds to."""
    if "*" in param:
        return ctypes.c_void_p
    if param.split()[:2] == ["long", "long"]:
        return ctypes.c_longlong
    assert param.split()[0] == "int", param
    return ctypes.c_int


def _entry_points(source: str) -> dict:
    """name -> ctypes types of the parameters of every function defined in
    the ``extern "C"`` block of ``source``."""
    text = (_build.CSRC / source).read_text()
    start = text.index('extern "C" {')
    block = text[start:text.index('}  // extern "C"', start)]
    return {name: [_c_type(p.strip()) for p in params.split(",")]
            for name, params in _DEF.findall(block)}


def test_every_source_is_a_library():
    assert sorted(_build.SOURCES.values()) == sorted(
        p.name for p in _build.CSRC.glob("*.cu"))
    assert set(_build.SIGNATURES) == set(_build.SOURCES)


@pytest.mark.parametrize("lib", sorted(_build.SOURCES))
def test_signatures_match_the_c_declarations(lib):
    """Every ``extern "C"`` entry point of the library's source is bound,
    with as many parameters as its C declaration and a pointer, int or
    64-bit int where the declaration has one; ``gust_error_string`` is
    bound apart, by ``_build.bind``."""
    found = _entry_points(_build.SOURCES[lib])
    assert found.pop("gust_error_string") == [ctypes.c_int]
    assert sorted(found) == sorted(_build.SIGNATURES[lib])
    for name, types in found.items():
        bound = _build.SIGNATURES[lib][name]
        assert len(bound) == len(types), name
        assert bound == types, name
