"""The port's ``ginfinity-generate-base-embeddings`` against the JAX
package's, on the CPU (mirrors ``tests/test_base_embed_hf.py`` and
``tests/test_aux_pipelines.py::TestBaseEmbed``): ``--backend hf`` on a
small random BERT saved to disk and read back by path, and the RiNALMo
path on a stub model.  Both packages run the same torch model on the
CPU, so every cell but the embeddings is identical text and each
embedding row is within 1e-6 (the JSON's 6 decimals) of JAX's; the
RiNALMo refusal and the port's device refusal are checked too."""

import csv
import json
import sys
import types

import numpy as np
import pandas as pd
import pytest
import torch

from ginfinity_tpu.pipelines import base_embed as jbase
from ginfinity_tpu_torch.pipelines import base_embed as tbase

HIDDEN = 16
TOL = 1e-6


@pytest.fixture(scope="module")
def hf_model_dir(tmp_path_factory):
    """tests/test_base_embed_hf.py's model: a random BertModel and a
    character vocab (specials + nucleotides) saved to disk."""
    pytest.importorskip("transformers")
    from transformers import BertConfig, BertModel, BertTokenizer

    d = tmp_path_factory.mktemp("tiny_hf_model")
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "A", "C", "G", "U", "N"]
    vf = d / "vocab.txt"
    vf.write_text("\n".join(vocab) + "\n")
    tok = BertTokenizer(str(vf), do_lower_case=False)
    torch.manual_seed(0)
    model = BertModel(BertConfig(vocab_size=len(vocab), hidden_size=HIDDEN,
                                 num_hidden_layers=1, num_attention_heads=2,
                                 intermediate_size=32, max_position_embeddings=64))
    model.save_pretrained(d)
    tok.save_pretrained(d)
    return str(d)


def _read(path):
    with open(path, newline="") as f:
        return list(csv.reader(f, delimiter="\t"))


def _run_both(tmp_path, frame, argv, sep=","):
    src = tmp_path / ("in.tsv" if sep == "\t" else "in.csv")
    frame.to_csv(src, sep=sep, index=False)
    base = ["--input", str(src), "--id-column", "id", "--quiet", *argv]
    jbase.main(base + ["--output", str(tmp_path / "jax.tsv")])
    tbase.main(base + ["--output", str(tmp_path / "port.tsv"), "--device", "cpu"])
    return _read(tmp_path / "jax.tsv"), _read(tmp_path / "port.tsv")


def _assert_rows(want, got):
    """Identical header and cells; base_embeddings within TOL."""
    assert got[0] == want[0] and len(got) == len(want)
    col = want[0].index("base_embeddings")
    mats = []
    for g, w in zip(got[1:], want[1:]):
        assert g[:col] + g[col + 1:] == w[:col] + w[col + 1:]
        gm, wm = np.asarray(json.loads(g[col])), np.asarray(json.loads(w[col]))
        assert gm.shape == wm.shape
        if gm.size:
            assert np.abs(gm - wm).max() <= TOL
        mats.append(gm)
    return mats


SEQS = ["ACGUACGU", "GGG", "acgt", "ACGUACGUACGUA", "ACGU", "ACGU"]


@pytest.mark.parametrize("argv", [
    [], ["--batch-size", "2"], ["--no-trim-special"], ["--keep-cols", "family,score"],
    ["--keep-cols", "score", "--batch-size", "4", "--no-trim-special"],
], ids=["default", "batch2", "no_trim", "keep", "keep_batch4_no_trim"])
def test_hf_backend_matches_jax(tmp_path, hf_model_dir, argv):
    """A ragged batch with a DNA-alphabet row and duplicates: one row per
    residue (or + 2 untrimmed), the kept columns as JAX writes them (a
    float column, a missing cell), every embedding within 1e-6."""
    frame = pd.DataFrame({"id": [f"s{i}" for i in range(len(SEQS))], "sequence": SEQS,
                          "family": ["RF1", "RF2", None, "RF1", "x", "y"],
                          "score": [0.5, 1.0, 2.25, None, 7.0, 3.0]})
    want, got = _run_both(tmp_path, frame,
                          ["--backend", "hf", "--model-name", hf_model_dir, *argv])
    mats = _assert_rows(want, got)
    extra = 2 if "--no-trim-special" in argv else 0
    assert [m.shape for m in mats] == [(len(s) + extra, HIDDEN) for s in SEQS]
    np.testing.assert_array_equal(mats[4], mats[5])   # the same sequence, the same rows
    np.testing.assert_array_equal(mats[2], mats[4])   # acgt -> ACGU
    if "--keep-cols" in argv:
        assert got[0][3:] == sorted(argv[argv.index("--keep-cols") + 1].split(","))


def test_hf_single_row_and_int_ids(tmp_path, hf_model_dir):
    """Integer ids stay integers; a lone short row embeds as in a batch."""
    frame = pd.DataFrame({"id": [7, 12], "sequence": ["ACG", "ACGUGGC"]})
    want, got = _run_both(tmp_path, frame,
                          ["--backend", "hf", "--model-name", hf_model_dir], sep="\t")
    _assert_rows(want, got)
    assert [r[0] for r in got[1:]] == ["7", "12"]


@pytest.fixture()
def stub_rinalmo(monkeypatch):
    """tests/test_aux_pipelines.py's stub RiNALMo: BOS + seq + EOS tokens,
    right-padded; the representation counts up, so rows show positions."""
    D = 6

    class FakeAlphabet:
        def batch_tokenize(self, seqs):
            L = max(len(s) for s in seqs)
            return [[1] + [2] * len(s) + [3] + [0] * (L - len(s)) for s in seqs]

    class FakeModel:
        def eval(self):
            return self

        def to(self, dev):
            return self

        def __call__(self, tokens):
            B, T = tokens.shape
            return {"representation": torch.arange(B * T * D, dtype=torch.float32)
                    .reshape(B, T, D)}

    pre = types.ModuleType("rinalmo.pretrained")
    pre.get_pretrained_model = lambda model_name: (FakeModel(), FakeAlphabet())
    root = types.ModuleType("rinalmo")
    root.pretrained = pre
    monkeypatch.setitem(sys.modules, "rinalmo", root)
    monkeypatch.setitem(sys.modules, "rinalmo.pretrained", pre)
    return D


def test_rinalmo_stub_matches_jax(tmp_path, stub_rinalmo):
    """The padded-batch trim: a row two or more shorter than its batch's
    longest keeps residue positions 1..L, not a center crop of the pad."""
    frame = pd.DataFrame({"id": ["s", "t", "u"], "sequence": ["AC", "ACGUUU", "AcgUU"]})
    want, got = _run_both(tmp_path, frame, [], sep="\t")
    mats = _assert_rows(want, got)
    D = stub_rinalmo
    assert mats[0].shape == (2, D) and mats[0][0, 0] == D and mats[0][1, 0] == 2 * D


def test_refusals(tmp_path, monkeypatch):
    """Without the rinalmo package both CLIs exit with the same message;
    without a card the port refuses to run unasked (JAX falls back to the
    CPU); a missing column raises on both."""
    monkeypatch.setitem(sys.modules, "rinalmo", None)
    src = tmp_path / "seqs.csv"
    pd.DataFrame({"id": ["x"], "sequence": ["ACGU"]}).to_csv(src, index=False)
    base = ["--input", str(src), "--output", str(tmp_path / "o.tsv"), "--id-column", "id"]
    msgs = []
    for main, extra in ((jbase.main, []), (tbase.main, ["--device", "cpu"])):
        with pytest.raises(SystemExit, match="rinalmo") as exc:
            main(base + extra)
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbase.main(base)
    for main in (jbase.main, tbase.main):
        with pytest.raises(ValueError, match="Column 'seq' not found"):
            main(base + ["--sequence-column", "seq"])


def test_parser_is_flag_superset():
    opts = lambda p: {o: a for a in p._actions for o in a.option_strings}  # noqa: E731
    want, got = opts(jbase.build_parser()), opts(tbase.build_parser())
    assert set(want) == set(got)
    for o, a in want.items():
        b = got[o]
        assert (b.default, b.required, b.choices, b.type, b.dest) == \
            (a.default, a.required, a.choices, a.type, a.dest), o
