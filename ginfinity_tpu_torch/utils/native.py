"""The native host parsers (``csrc/ginfast.cpp``), built at first use.

Port of ``ginfinity_tpu/utils/native.py``: the same two functions with
the same results.  The JAX package loads a prebuilt ``native/libginfast.so``
and falls back to Python when it is missing; the port compiles its own
copy of the source with the host C++ compiler (``$CXX``, else ``g++``,
else ``c++``) into ``ginfinity_tpu_torch/_build/<hash>/``, where the hash
covers the source, the flags and the compiler.  Concurrent first uses
(test workers) each compile to a name of their own and rename it into
place.  A failed build raises with the compiler's output: there is no
silent fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "csrc" / "ginfast.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[1] / "_build"
LIB_NAME = "libginfast.so"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared")

_lib = None


def compiler() -> str:
    """``$CXX``, else ``g++`` or ``c++`` on ``PATH``."""
    for cand in (os.environ.get("CXX"), "g++", "c++"):
        path = shutil.which(cand) if cand else None
        if path:
            return path
    raise RuntimeError("no C++ compiler found: set CXX or put g++ on PATH")


def library_path(cxx: str) -> Path:
    h = hashlib.sha256(" ".join((cxx,) + CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / LIB_NAME


def build_library() -> Path:
    """Path of the built library, compiling it first if needed.  Raises
    ``RuntimeError`` with the compiler's output when the build fails."""
    cxx = compiler()
    out = library_path(cxx)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.parent / f"tmp-{os.getpid()}-{threading.get_ident()}-{LIB_NAME}"
    res = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {SOURCE.name} with {cxx} failed:\n{res.stdout}")
    os.replace(tmp, out)
    return out


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_library()))
        lib.gf_pair_table.restype = ctypes.c_int
        lib.gf_pair_table.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                      ctypes.POINTER(ctypes.c_int32)]
        lib.gf_parse_floats.restype = ctypes.c_long
        lib.gf_parse_floats.argtypes = [ctypes.c_char_p, ctypes.c_long,
                                        ctypes.POINTER(ctypes.c_float), ctypes.c_long,
                                        ctypes.POINTER(ctypes.c_long)]
        _lib = lib
    return _lib


def native_pair_table(structure: str) -> np.ndarray | None:
    """The pair table of an extended dot-bracket string (``pt[i]`` the
    partner of ``i`` or -1), or ``None`` for an invalid structure,
    including any character outside latin-1."""
    try:
        raw = structure.encode("latin-1")
    except UnicodeEncodeError:
        return None
    out = np.empty(len(structure), dtype=np.int32)
    rc = _library().gf_pair_table(raw, len(structure),
                                  out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out if rc == 0 else None


def parse_float_matrix(cell) -> np.ndarray | None:
    """A JSON 2-D float matrix cell (``"[[...],...]"``) as float32
    ``[rows, cols]``, each number read by ``strtod`` and rounded to
    float32 (bit-equal to ``json.loads`` then ``float32``).  ``None`` when
    the cell is not a string holding a plain rectangular numeric matrix:
    the callers then take the ``json`` path."""
    if not isinstance(cell, str):
        return None
    s = cell.strip()
    if len(s) < 4 or s[0] != "[" or s[-1] != "]":
        return None
    try:
        raw = s.encode("ascii")
    except UnicodeEncodeError:
        return None
    cap = len(raw) // 2 + 2  # every number takes at least 2 bytes ("0,")
    out = np.empty(cap, dtype=np.float32)
    ncols = ctypes.c_long(0)
    n = _library().gf_parse_floats(raw, len(raw),
                                   out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                                   cap, ctypes.byref(ncols))
    if n <= 0 or ncols.value <= 0 or n % ncols.value != 0:
        return None
    return out[:n].reshape(-1, ncols.value).copy()
