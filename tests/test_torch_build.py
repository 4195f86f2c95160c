"""PyTorch port: the ctypes bindings of the CUDA kernels match their C
prototypes.

``ops/_build.py`` declares, for every ``extern "C"`` function of every
``csrc/*.cu`` source, its return type and argument types. A wrong count or
kind there does not fail on the CPU, and on the card it silently cuts a
64-bit pointer passed as ``c_int`` to 32 bits. Each case parses the
prototype from the source and holds the declaration to it.
"""

import ctypes
import re

import pytest

from llm_in_practise_tpu_torch.ops import _build

_PROTO = re.compile(r'extern\s+"C"\s+([^(]*?)\s*\b(\w+)\s*\(([^)]*)\)',
                    re.S)


def _prototypes(name: str) -> dict[str, tuple[str, list[str]]]:
    """symbol -> (return type, parameter declarations) of one source."""
    src = _build.source_path(name).read_text()
    out = {}
    for ret, sym, params in _PROTO.findall(src):
        parts = [" ".join(p.split()) for p in params.split(",")]
        out[sym] = (ret, [p for p in parts if p and p != "void"])
    return out


def _c_kind(decl: str) -> str:
    """pointer / int / float of a C declaration (type plus optional name)."""
    if "*" in decl:
        return "pointer"
    words = decl.replace("const ", "").split()
    return words[0] if len(words) <= 2 else " ".join(words[:-1])


def _ctypes_kind(t) -> str:
    if t in (ctypes.c_void_p, ctypes.c_char_p) or issubclass(
            t, ctypes._Pointer):
        return "pointer"
    return {ctypes.c_int: "int", ctypes.c_float: "float"}.get(t, repr(t))


_CASES = [(name, sym) for name, syms in _build.KERNELS.items()
          for sym in syms]


@pytest.mark.parametrize("name,sym", _CASES,
                         ids=[f"{n}:{s}" for n, s in _CASES])
def test_argtypes_match_the_c_prototype(name, sym):
    protos = _prototypes(name)
    assert sym in protos, f"{sym} is not an extern \"C\" function of " \
                          f"{_build.source_path(name).name}"
    ret, params = protos[sym]
    restype, argtypes = _build.KERNELS[name][sym]
    assert [_ctypes_kind(t) for t in argtypes] == \
        [_c_kind(p) for p in params], (sym, params)
    assert _ctypes_kind(restype) == _c_kind(ret), (sym, ret)


@pytest.mark.parametrize("name", sorted(_build.KERNELS))
def test_every_exported_function_is_declared(name):
    assert set(_prototypes(name)) == set(_build.KERNELS[name])


def test_c_kind_parsing():
    assert _c_kind("const void* x") == "pointer"
    assert _c_kind("const long long* q_strides") == "pointer"
    assert _c_kind("int out_dtype") == "int"
    assert _c_kind("float scale") == "float"
    assert _c_kind("int") == "int"
    assert _c_kind("const char*") == "pointer"
    assert _c_kind("long long n") == "long long"
