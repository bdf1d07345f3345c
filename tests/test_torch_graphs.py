"""The port's host graph layer against ``ginfinity_tpu.graphs``: pair
tables, loop features, window node features and edge rows must be
array-equal (tolerance 0) on seeded random structures, pseudoknots and
edge cases."""

import numpy as np
import pytest

from ginfinity_tpu.graphs import batching as jbatching
from ginfinity_tpu.graphs import build as jbuild
from ginfinity_tpu.graphs import dotbracket as jdb
from ginfinity_tpu.pipelines import windows as jwindows
from ginfinity_tpu.pipelines.msa_eval import random_structure
from ginfinity_tpu_torch.graphs import batching, build, dotbracket
from ginfinity_tpu_torch.pipelines import windows

EDGE_CASES = [
    "....",
    "()",
    "(.(...))",
    "((..[[..))..]]..",
    "((......))",
    "(((...))).",
    "((..AA..))..aa..",
    "<<..{{..>>..}}..((..))",
    ".",
    "",
]
INVALID = ["(((", "())", "(]", "a", "((..x..))", "[[..))", "Ab..ab"]


def _random_structures():
    rng = np.random.default_rng(20)
    out = [random_structure(rng, int(n)) for n in rng.integers(30, 260, size=6)]
    # pseudoknotted: overlay a bracket-family helix on unpaired runs
    for k, s in enumerate(out[:3]):
        chars = list(s)
        free = [i for i, c in enumerate(chars) if c == "."]
        if len(free) >= 4:
            a, b = free[0], free[-1]
            chars[a], chars[b] = "[{<A"[k % 4], "]}>a"[k % 4]
        out.append("".join(chars))
    return out


STRUCTURES = EDGE_CASES + _random_structures()


@pytest.mark.parametrize("s", STRUCTURES + INVALID)
def test_pair_table_and_validity(s):
    got = dotbracket.pair_table(s, strict=False)
    ref = jdb.pair_table(s, strict=False)
    assert (got is None) == (ref is None)
    if ref is not None:
        np.testing.assert_array_equal(got, ref)
        assert got.dtype == ref.dtype
    assert dotbracket.is_valid_dot_bracket(s) == jdb.is_valid_dot_bracket(s)


@pytest.mark.parametrize("s", INVALID)
def test_strict_pair_table_raises(s):
    with pytest.raises(ValueError):
        jdb.pair_table(s)
    with pytest.raises(ValueError):
        dotbracket.pair_table(s)


@pytest.mark.parametrize("s", STRUCTURES)
def test_loop_and_node_features(s):
    pt = jdb.pair_table(s)
    for a, b in zip(dotbracket.loop_features(pt), jdb.loop_features(pt)):
        np.testing.assert_array_equal(a, b)
    seq = "".join("ACGUacgunN"[i % 10] for i in range(len(s)))
    for seq_weight in (0.0, 0.3):
        for fdim in (None, 3, 4, 6, 8):
            np.testing.assert_array_equal(
                build.standard_node_features(pt, seq, seq_weight, fdim),
                jbuild.standard_node_features(pt, seq, seq_weight, fdim),
            )
        for enc, fdim in (("standard", 4), ("forgi", None), ("forgi", 16), ("forgi", 9)):
            np.testing.assert_array_equal(
                build.window_node_features(pt, seq, seq_weight, enc, fdim),
                jbuild.window_node_features(pt, seq, seq_weight, enc, fdim),
            )


@pytest.mark.parametrize("seq", [None, "", "ACGU", "acgun", "AXGUUUUUUU"])
def test_one_hot_sequence(seq):
    for n in (0, 4, 7):
        np.testing.assert_array_equal(
            dotbracket.one_hot_sequence(seq, n), jdb.one_hot_sequence(seq, n)
        )


def test_forgi_layout_and_edge_rows():
    assert build.FORGI_NODE_TYPES == jbuild.FORGI_NODE_TYPES
    for dim in (4, 7):
        np.testing.assert_array_equal(
            build.window_edge_const_rows(dim), jbuild.window_edge_const_rows(dim)
        )


def test_round_capacity():
    for n in list(range(0, 2100, 7)) + [16384, 16385, 20000, 40961]:
        assert batching._round_capacity(n) == jbatching._round_capacity(n)


@pytest.mark.parametrize("s", STRUCTURES)
def test_window_starts_mask(s):
    for L in (2, 5, 40):
        for thr in (0.0, 0.1, 0.5):
            np.testing.assert_array_equal(
                windows.window_starts_mask(s, L, thr),
                jwindows.window_starts_mask(s, L, thr),
            )
