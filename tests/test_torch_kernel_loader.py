"""The one loader of the port's CUDA kernels (``ops/_build.py``), checked
on the CPU: its table of C entry points against the ``extern "C"``
functions of ``ops/csrc/*.cu``, read as text (no nvcc), and the device
rule every kernel wrapper shares."""

import ctypes
import re

import pytest
import torch

from ginfinity_tpu_torch.ops import _build

# C parameter and return types as ctypes declares them
_C_TYPES = {"int": ctypes.c_int, "float": ctypes.c_float, "double": ctypes.c_double,
            "size_t": ctypes.c_size_t}


def _ctype(decl: str):
    """The ctypes type of a C declaration (a parameter, or a return type
    with no name): a ``char`` pointer is text, any other pointer
    ``c_void_p``."""
    words = decl.replace("*", " * ").split()
    if "*" in words:
        return ctypes.c_char_p if "char" in words else ctypes.c_void_p
    return _C_TYPES[next(w for w in words if w in _C_TYPES)]


def _extern_c_functions() -> list[tuple[str, str, object, list]]:
    """``(source, name, restype, argtypes)`` of every function defined in
    an ``extern "C"`` block of ``csrc/*.cu``, leaving out what a
    preprocessor condition guards (such as ``K1_PROFILE``'s timing hook,
    compiled only by ``k1_phases.py``, which binds it itself)."""
    found = []
    for src in sorted(_build.CSRC.glob("*.cu")):
        text = src.read_text()
        for block in re.findall(r'^extern "C" \{\n(.*?)^\}  // extern "C"', text, re.M | re.S):
            block = re.sub(r"^#if.*?^#endif", "", block, flags=re.M | re.S)
            block = re.sub(r"//[^\n]*", "", block)
            for ret, name, params in re.findall(r"^([A-Za-z_][\w \*]*?)\s*\b(\w+)\(([^)]*)\)\s*\{",
                                                block, re.M):
                args = [_ctype(p) for p in params.split(",") if p.strip()]
                found.append((src.name, name, _ctype(ret), args))
    return found


def test_every_extern_c_function_has_one_table_entry():
    """Every ``extern "C"`` function of the sources has exactly one entry
    in the loader's table, and every entry names such a function."""
    names = [name for _, name, _, _ in _extern_c_functions()]
    assert len(names) == len(set(names)), names
    assert sorted(names) == sorted(_build.ENTRY_POINTS)


@pytest.mark.parametrize("src, name, restype, argtypes", _extern_c_functions(),
                         ids=[f[1] for f in _extern_c_functions()])
def test_table_declares_the_c_signature(src, name, restype, argtypes):
    """The table's ``restype`` and ``argtypes`` are the C definition's, one
    for one: a pointer ``c_void_p``, a ``char`` pointer ``c_char_p``, each
    number its own width."""
    assert _build.ENTRY_POINTS[name] == (restype, argtypes), src


def test_on_card_takes_cpu_and_cuda_and_refuses_others():
    assert _build.on_card(torch.zeros(1), "w") is False
    with pytest.raises(ValueError, match="w: unsupported device meta"):
        _build.on_card(torch.zeros(1, device="meta"), "w")


def test_check_binds_nothing_on_success(monkeypatch):
    """A zero error code is success and reads no message: the library is
    neither built nor bound for it."""
    monkeypatch.setattr(_build, "library", lambda: pytest.fail("library() was called"))
    _build.check(0, "a launch")
