"""The operation and byte counts behind the rooflines and MFUs equal
hand counts at tiny shapes."""

import pytest

from portbench.counts import gine, k1, k2, similarity
from portbench.reference import graphs as rg

CFG = {"hidden_dims": [2, 3], "output_dim": 5, "node_feature_dim": 4}


def test_gine_forward_and_train_flops():
    # layer 0: 2x2 + 2x2 = 8 MACs a row; layer 1: 2x3 + 3x3 = 15; encoder 4x2 = 8
    assert gine.mlp_flops(CFG, 10) == 2 * 10 * (8 + 15)
    assert gine.forward_flops(CFG, 10, 2) == 2 * 10 * 8 + 2 * 10 * 23 + 2 * 2 * 3 * 5
    fwd = 2 * 10 * 8 + 2 * 10 * 23 + 2 * 4 * 4 * 3
    bwd = 2 * 10 * 8 + 2 * (2 * 10 * 23 + 2 * 4 * 4 * 3)
    assert gine.train_step_flops(CFG, 10, 4) == fwd + bwd


def test_k1_flops_and_bytes():
    assert k1.flops(CFG, 10, 2) == 2 * 10 * 23 + 2 * 2 * 3 * 5
    # weights: (4+4+4+8+6) + (6+9+6+8+9) + 15 + 5 = 84 floats
    assert k1.param_bytes(CFG) == 4 * 84
    assert k1.nbytes(CFG, 10, 2, L=3, launches=2) == 4 * (10 * 2 + 2 * (15 + 5)) + 2 * 4 * 84


@pytest.mark.parametrize("structure, L", [("((....))...((..))", 5), ("(((...)))..((((....)).))", 7),
                                          ("()((..))", 3)])
def test_window_rows_equal_the_window_graphs_nodes(structure, L):
    pt = rg.pair_table(structure)
    feat = rg.node_features(pt, 4)
    want = [rg.window_graph(pt, feat, s, L).n_nodes for s in range(len(structure) - L + 1)]
    assert k1.window_rows(pt, L).tolist() == want


def test_window_rows_by_hand():
    # "((....))": windows of 3 at starts 0..5; the pairs (0,7), (1,6)
    pt = rg.pair_table("((....))")
    assert k1.window_rows(pt, 3).tolist() == [5, 4, 3, 3, 4, 5]


def test_k2_counts():
    assert k2.nbytes(2, 3) == 4 * 6 + 3 * 4
    assert k2.ops(2, 3) == 10 * 12


def test_similarity_flops():
    # a 2 x 4 by 4 x 3 product: 6 dot products of 4 multiply-adds
    assert similarity.flops(2, 3, 4) == 2 * 6 * 4
