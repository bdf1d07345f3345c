"""The port's train-to-a-measured-model harness against the JAX package
on the CPU: the generated training files byte for byte, the held-out
families, both probes on a JAX-exported checkpoint, and the whole
``compare_trained_vs_packaged`` loop at a tiny size (a seeded stand-in
for the packaged weights under ``GINFINITY_REFERENCE_ROOT``)."""

import contextlib
import io
import os

import jax
import numpy as np
import pytest

from ginfinity_tpu.models.checkpoint import export_torch_checkpoint as jexport
from ginfinity_tpu.models.checkpoint import import_torch_checkpoint as jimport
from ginfinity_tpu.pipelines import train_eval as jte
from ginfinity_tpu_torch.pipelines import train_eval as te

from torch_train_data import jax_init

PACKAGED_KW = dict(hidden_dim=128, output_dim=128, gin_layers=6, norm_type="graph",
                   node_embed_norm="zscore_l2", normalize_nodes_before_pool=True,
                   pooling_type="global_add_pool")


def test_generated_files_are_the_jax_package_s(tmp_path):
    want = jte.generate_alignment_training_data(str(tmp_path / "jax"), 5, 3, 4, 40, seed=3)
    got = te.generate_alignment_training_data(str(tmp_path / "port"), 5, 3, 4, 40, seed=3)
    for w, g in zip(want[:2], got[:2]):
        with open(w, "rb") as fw, open(g, "rb") as fg:
            assert fw.read() == fg.read()
    assert len(got[2]) == 3
    for wf, gf in zip(want[2], got[2]):
        for wm, gm in zip(wf, gf):
            assert (wm.name, wm.structure, wm.sequence) == (gm.name, gm.structure, gm.sequence)
            assert np.array_equal(wm.posmap, gm.posmap)


@pytest.fixture(scope="module")
def packaged(tmp_path_factory):
    """A JAX-initialised checkpoint of the packaged architecture, with
    ``node_mu``/``node_sigma`` away from 0 and 1."""
    jc, jp, js, _ = jax_init(PACKAGED_KW, seed=8)
    rng = np.random.default_rng(8)
    js = dict(js, node_mu=(0.1 * rng.normal(size=128)).astype(np.float32),
              node_sigma=(1.0 + rng.random(128)).astype(np.float32))
    root = tmp_path_factory.mktemp("reference")
    path = root.joinpath(*te.PACKAGED)
    path.parent.mkdir(parents=True)
    jexport(str(path), jc, jax.tree_util.tree_map(np.asarray, jp), js)
    return str(root), str(path)


def test_probes_match_jax(packaged):
    _, ckpt = packaged
    fams = [te.make_family(s, n_seqs=4, anc_len=50, sub_rate=0.05, del_rate=0.03,
                           ins_rate=0.03) for s in (1, 2, 3)]
    recall = te.retrieval_recall_at_10(ckpt, fams, device="cpu")
    assert recall == jte.retrieval_recall_at_10(ckpt, fams) and 0.0 <= recall <= 1.0
    f1 = te.alignment_sp_f1(ckpt, fams, device="cpu")
    assert f1 == jte.alignment_sp_f1(ckpt, fams) and 0.0 < f1 <= 1.0


def test_compare_trained_vs_packaged(packaged, tmp_path, monkeypatch):
    """The whole loop on the CPU: data, a one-round schedule on the
    packaged architecture (dropout 0.05 from the port's generator), the
    probes of both checkpoints.  The trained ``.pth`` loads in the JAX
    package with the packaged architecture."""
    root, ckpt = packaged
    monkeypatch.setenv("GINFINITY_REFERENCE_ROOT", root)
    tiny = [{"lr": 5e-4, "decay_rate": 0.98, "patience": 3, "num_epochs": 2}]
    with contextlib.redirect_stdout(io.StringIO()):
        out = te.compare_trained_vs_packaged(str(tmp_path), rounds=tiny, n_train_families=4,
                                             n_eval_families=3, device="cpu")
    assert out["arch"] == "packaged" and out["train_wall_sec"] > 0
    fams = te.generate_alignment_training_data(str(tmp_path / "again"), 4, 3)[2]
    assert out["packaged_recall_at_10"] == round(jte.retrieval_recall_at_10(ckpt, fams), 4)
    trained = os.path.join(tmp_path, "output", "trained_eval", "round_01",
                           "trained_eval_round_01.pth")
    cfg, _, _, extra = jimport(trained)
    assert cfg.hidden_dims == (128,) * 6 and cfg.dropout == 0.05 and extra["epoch"] >= 0
    for key in ("trained_recall_at_10", "trained_alignment_sp_f1"):
        assert 0.0 <= out[key] <= 1.0


def test_packaged_weights_need_the_reference_checkout(monkeypatch, tmp_path):
    monkeypatch.delenv("GINFINITY_REFERENCE_ROOT", raising=False)
    with pytest.raises(FileNotFoundError, match="GINFINITY_REFERENCE_ROOT"):
        te.reference_path(te.PACKAGED)
