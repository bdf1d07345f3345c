"""The port's ``ginfinity-prewarm`` against the JAX package's, on the CPU
(mirrors ``tests/test_aux_pipelines.py::TestPrewarmMsa``): ``--msa`` runs
the MSA on the JAX CLI's seeded dummy family (the same TSV bytes) in
each requested mode; window mode checks the same flags and reports the
corpus's groups as the JAX package forms them.  Building the CUDA
library needs ``nvcc``, which the CPU test machine lacks: that test
skips there with its reason."""

import csv

import numpy as np
import pytest
import torch

from ginfinity_tpu.graphs.batching import _round_capacity
from ginfinity_tpu.models.checkpoint import export_torch_checkpoint
from ginfinity_tpu.models.gine import GINConfig as JConfig
from ginfinity_tpu.models.gine import init_params as jinit
from ginfinity_tpu.pipelines import fast_windows as jfw
from ginfinity_tpu.pipelines import msa as jmsa
from ginfinity_tpu.pipelines import prewarm as jprewarm
from ginfinity_tpu.pipelines.msa_eval import random_structure
from ginfinity_tpu_torch.ops import _build
from ginfinity_tpu_torch.pipelines import msa as tmsa
from ginfinity_tpu_torch.pipelines import prewarm as tprewarm

MSA_ARGS = ["--msa", "5", "36", "--msa-dim", "6", "--msa-max-pairs", "10", "--msa-topk", "4"]


def _capture_inputs(monkeypatch, mod, store):
    real = mod.main

    def spy(argv):
        with open(argv[argv.index("--input") + 1], "rb") as f:
            store.append((f.read(), argv))
        return real(argv)

    monkeypatch.setattr(mod, "main", spy)


@pytest.mark.parametrize("extra", [[], ["--msa-dp-score", "library", "--msa-refine-iters", "2"]],
                         ids=["both", "library_refine"])
def test_msa_bucket_matches_jax(extra, capsys, monkeypatch):
    """The port runs its MSA once per mode on the dummy family the JAX CLI
    writes (byte-identical TSV, the same flags plus ``--device cpu``)."""
    seen = {"jax": [], "port": []}
    _capture_inputs(monkeypatch, jmsa, seen["jax"])
    _capture_inputs(monkeypatch, tmsa, seen["port"])
    jprewarm.main(MSA_ARGS + extra)
    capsys.readouterr()
    tprewarm.main(MSA_ARGS + extra + ["--device", "cpu"])
    out = capsys.readouterr().out
    modes = ["library"] if extra else ["profile", "library"]
    for m in modes:
        assert f"dp-score={m}" in out
    assert "Prewarmed the MSA path" in out
    assert len(seen["port"]) == len(seen["jax"]) == len(modes)
    for (tb, targv), (jb, jargv) in zip(seen["port"], seen["jax"]):
        assert tb == jb
        strip = lambda a: [x for i, x in enumerate(a) if i < 2 or a[i - 1] not in  # noqa: E731
                           ("--input", "--out-prefix")][2:]
        assert strip(targv) == strip(jargv) + ["--device", "cpu"]


def test_msa_bucket_quiet_and_device_refusal(capsys, monkeypatch):
    tprewarm.main(MSA_ARGS + ["--msa-dp-score", "profile", "--quiet", "--device", "cpu"])
    assert capsys.readouterr().out == ""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tprewarm.main(MSA_ARGS)


def test_window_mode_still_validates_required_flags():
    for main in (jprewarm.main, tprewarm.main):
        with pytest.raises(SystemExit, match="Window mode needs"):
            main(["--window-size", "80"])


@pytest.fixture(scope="module")
def window_inputs(tmp_path_factory):
    """A flagship-width checkpoint exported from JAX ``init_params`` and a
    seeded corpus of 40-150 nt (some shorter than the window)."""
    import jax

    d = tmp_path_factory.mktemp("prewarm")
    cfg = JConfig.create(hidden_dim=128, output_dim=128, gin_layers=2,
                         norm_type="graph", node_embed_norm="zscore_l2")
    params, state = jinit(jax.random.PRNGKey(0), cfg)
    ckpt = str(d / "m.pth")
    export_torch_checkpoint(ckpt, cfg, params, state)
    rng = np.random.default_rng(4)
    structs = [random_structure(rng, int(n)) for n in rng.integers(40, 150, size=12)]
    src = d / "in.tsv"
    with open(src, "w", newline="") as f:
        w = csv.writer(f, delimiter="\t", lineterminator="\n")
        w.writerow(["id", "secondary_structure"])
        w.writerows([f"r{i}", s] for i, s in enumerate(structs))
    return str(src), ckpt, cfg, structs


@pytest.mark.parametrize("extra", [[], ["--keep-paired-neighbors", "--max-programs", "1"],
                                   ["--mask-threshold", "0.3"]])
def test_window_mode_groups_match_jax(window_inputs, extra, monkeypatch, capsys, tmp_path):
    """With the build stood in for (it needs nvcc), the groups the port
    reports are the JAX package's ``_prep_corpus_groups`` groups:
    capacity, structures and windows."""
    src, ckpt, cfg, structs = window_inputs
    lib = tmp_path / "lib.so"
    monkeypatch.setattr(_build, "library_path", lambda: lib)
    monkeypatch.setattr(_build, "build_library", lambda: lib)
    res = tprewarm.main(["--input", src, "--model-path", ckpt, "--window-size", "60", *extra])
    L = 60
    kpn = "--keep-paired-neighbors" in extra
    mt = float(extra[extra.index("--mask-threshold") + 1]) if "--mask-threshold" in extra else 0.0
    mp = int(extra[extra.index("--max-programs") + 1]) if "--max-programs" in extra else None
    per, groups = jfw._prep_corpus_groups(cfg, structs, L, kpn, mt, mp)
    want = [(n_cap, len(idxs), int(sum(per[i][4].size for i in idxs)))
            for n_cap, idxs in sorted(groups.items())]
    assert [tuple(r) for r in res["groups"]] == want and res["library"] == str(lib)
    assert all(n_cap == _round_capacity(n_cap) for n_cap, _, _ in want)
    assert f"{len(want)} window group(s)" in capsys.readouterr().out


def test_window_mode_builds_the_library(window_inputs):
    """The real build: nvcc compiles both CUDA sources into the library."""
    try:
        _build.nvcc_path()
    except RuntimeError:
        pytest.skip("no nvcc on this machine: the CUDA library cannot be built here")
    src, ckpt, _, _ = window_inputs
    res = tprewarm.main(["--input", src, "--model-path", ckpt, "--window-size", "60"])
    assert res["library"] == str(_build.library_path()) and _build.library_path().exists()
    assert res["groups"]
