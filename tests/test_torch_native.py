"""The port's native host parsers (``ginfinity_tpu_torch/utils/native.py``,
``utils/csrc/ginfast.cpp``, built at first use) against ``json`` and the
JAX package's scanner (``ginfinity_tpu/utils/native.py``), on the CPU.

Tolerances: none.  The matrix scanner is bit-equal to ``json.loads``
then float32, and to the JAX package's scanner; it returns ``None``
exactly where JAX's does (then the callers take the ``json`` path).  The
pair table equals JAX's (native and Python) and the port's Python scan
on every string, ``None`` for the same invalid ones."""

import json
import subprocess
import sys

import numpy as np
import pytest

from ginfinity_tpu.graphs import dotbracket as jdb
from ginfinity_tpu.utils import native as jnative
from ginfinity_tpu_torch.graphs import dotbracket as tdb
from ginfinity_tpu_torch.pipelines.msa import _parse_matrix_cell
from ginfinity_tpu_torch.pipelines.node_embed import parse_matrix, serialize_matrix
from ginfinity_tpu_torch.utils import native

MALFORMED = [
    "[[1,2],[3]]", "[[1,2],[3,4,5],[6]]", "not json", "", "[]", "[[]]", '[["a","b"]]',
    "[[1,2],[3,4]", "[1,2,3]", "[[[1]]]", "[[1,null]]", "[[1,2]] trailing",
    "[[0x1A,2]]", "[[-inf,1.0]]", "[[nan]]", "[[Infinity]]", "[[1.,2]]", "[[+1,2]]",
    "[[.5,2]]", "[[01,2]]", "[[1e,2]]", "[[1.5,é]]",
]


def _json32(s):
    return np.array(json.loads(s), dtype=np.float32)


def test_scanner_bit_equal_to_json_and_jax():
    rng = np.random.default_rng(0)
    for seed in range(4):
        mags = rng.choice([1e-8, 1e-3, 1.0, 1e4, 1e-30], (57, 128))
        m = (rng.standard_normal((57, 128)) * mags).astype(np.float32)
        for s in (json.dumps([[round(float(v), 6) for v in row] for row in m],
                             separators=(",", ":")),
                  json.dumps(m.tolist()), serialize_matrix(m)):
            got = native.parse_float_matrix(s)
            want = _json32(s)
            assert got.dtype == np.float32 and got.shape == want.shape
            assert got.tobytes() == want.tobytes()
            assert got.tobytes() == jnative.parse_float_matrix(s).tobytes()


def test_scientific_notation_and_spacing():
    s = "  [[1e-5, -2.5],\n [3, 4.0E+2],\r\n\t[-0, 0.25e-3]] "
    got = native.parse_float_matrix(s)
    np.testing.assert_array_equal(got, _json32(s))
    assert got.tobytes() == jnative.parse_float_matrix(s).tobytes()
    assert np.signbit(got[2, 0])


@pytest.mark.parametrize("bad", MALFORMED)
def test_rejects_what_jax_rejects(bad):
    assert native.parse_float_matrix(bad) is None
    assert jnative.parse_float_matrix(bad) is None


def test_non_string_cells():
    for cell in (None, float("nan"), 3, [[1.0]], b"[[1,2]]"):
        assert native.parse_float_matrix(cell) is None
        assert jnative.parse_float_matrix(cell) is None


def test_pipeline_parsers_take_the_scanner_then_json():
    rng = np.random.default_rng(1)
    s = serialize_matrix(rng.standard_normal((33, 16)).astype(np.float32))
    for got in (parse_matrix(s), _parse_matrix_cell(s)):
        assert got.tobytes() == _json32(s).tobytes()
    # the json path: a cell the scanner rejects but json reads, as in JAX
    s2 = "[[true, false], [1, 2e0]]"
    assert native.parse_float_matrix(s2) is None
    for got in (parse_matrix(s2), _parse_matrix_cell(s2)):
        np.testing.assert_array_equal(got, [[1, 0], [1, 2]])
    from ginfinity_tpu.pipelines.msa import _parse_matrix_cell as j_cell
    np.testing.assert_array_equal(j_cell(s2), _parse_matrix_cell(s2))
    assert _parse_matrix_cell("[[1,2],[3]]") is None
    with pytest.raises(ValueError, match="2D"):
        parse_matrix("[1, 2, 3]")


def _structures(rng, n):
    alphabet = list("..((()))[]{}<>AaBbZz") + ["é", "…", "x", " "]
    out = []
    for _ in range(n):
        L = int(rng.integers(0, 40))
        if rng.random() < 0.5:  # balanced: nested pairs of mixed families
            s, stack = [], []
            for _ in range(L):
                r = rng.random()
                if r < 0.3 or (r < 0.6 and not stack):
                    o, c = [("(", ")"), ("[", "]"), ("{", "}"), ("<", ">"), ("A", "a")][
                        int(rng.integers(0, 5))]
                    s.append(o)
                    stack.append(c)
                elif r < 0.6:
                    s.append(stack.pop())
                else:
                    s.append(".")
            s += stack[::-1]
            out.append("".join(s))
        else:
            out.append("".join(rng.choice(alphabet, L)))
    return out


def test_pair_table_matches_jax():
    """A few thousand seeded strings, half balanced, half random over an
    alphabet with latin-1 and non-latin-1 characters."""
    rng = np.random.default_rng(7)
    n_valid = 0
    for s in _structures(rng, 3000):
        got = tdb.pair_table(s, strict=False)
        for want in (jdb.pair_table(s, strict=False), jnative.native_pair_table(s),
                     tdb._py_pair_table(s, strict=False), native.native_pair_table(s)):
            assert (got is None) == (want is None), s
            if got is not None:
                assert got.dtype == np.int32 and np.array_equal(got, want), s
        n_valid += got is not None
        assert tdb.is_valid_dot_bracket(s) == (got is not None)
    assert 1000 < n_valid < 3000
    with pytest.raises(ValueError, match="Invalid dot-bracket"):
        tdb.pair_table("((…))")


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "b")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "SOURCE", tmp_path / "broken.cpp")
    (tmp_path / "broken.cpp").write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="broken.cpp.*failed"):
        native.parse_float_matrix("[[1.0]]")
    assert native._lib is None
    monkeypatch.setenv("CXX", "no-such-compiler-here")
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        native.build_library()


def test_concurrent_first_builds_share_one_library(tmp_path):
    """Three processes build into one fresh directory at once (the test
    workers' race): all load a working library, and one file remains."""
    code = ("import sys; from pathlib import Path; from ginfinity_tpu_torch.utils import native;"
            f"native.BUILD_ROOT = Path({str(tmp_path)!r});"
            "print(native.build_library()); assert native.native_pair_table('(.)') is not None")
    procs = [subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(3)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), [e for _, e in outs]
    assert len({o.strip() for o, _ in outs}) == 1
    assert [p.name for p in tmp_path.rglob("*") if p.is_file()] == [native.LIB_NAME]
