"""The port's ``ginfinity-train`` twin against the JAX CLI on the CPU.

- ``prepare_dataset`` without pandas: the rows the JAX CLI's pandas calls
  choose (comment lines, invalid structures, groups of one, a missing
  alignment id, sampling, the split), row for row.
- Whole runs from shared initial weights: triplet and regression with
  the port's ``init_params`` swapped for the JAX package's initial
  weights, alignment through a two-round schedule whose ``checkpoint`` is
  a JAX-exported init.  Per-epoch losses within 1e-4 relative, the same
  logged learning rates and early-stopping counters, the same epochs and
  early stop, the same ``.pth`` keys, shapes and metadata.  The weights
  themselves are held to ``2 * lr * steps``: Adam moves a weight by about
  ``lr`` a step whatever its gradient's size, so where a gradient is
  near zero the two float32 sides may step opposite ways.  That is also
  why these runs take ``lr`` 1e-4 (the alignment schedule, whose logits
  are cos / 0.1, 5e-5 and 2e-5): a bias before GraphNorm (mean_scale 1)
  or batch norm has a true gradient of exactly 0, float32 noise of ~1e-7
  on either side, and so a step of +-lr in a random direction; at lr
  5e-3 the two runs' losses part by 1-10% within ten steps (at 1e-4 by
  at most 1.5e-5 over 16 steps), whatever the framework.  Batch norm
  takes no part here: its running mean lags such a bias step, so its
  validation losses (inference mode) carry the noise while its train
  losses do not (4e-4 apart at lr 1e-4 in one run, 1e-7 in the train
  losses).  One step's gradients and batch norm's running statistics
  are held to JAX in ``test_torch_training.py``.
- The port's own behaviour, as the JAX package's ``TestTrainCLI`` checks
  it: exact resume (bit-equal here), the Ctrl-C save and its decline,
  ``--save_best_weights ''``, ``--fit-node-stats``,
  ``--diagnostic-alignment`` PNGs, forgi, and the ``.pth`` read back by
  the JAX package and by the port's embed CLI."""

import builtins
import json
import os

import numpy as np
import pytest
import torch

from ginfinity_tpu.models.checkpoint import export_torch_checkpoint as jexport
from ginfinity_tpu.models.checkpoint import import_torch_checkpoint as jimport
from ginfinity_tpu.training import train_cli as jcli
from ginfinity_tpu_torch.pipelines import embed
from ginfinity_tpu_torch.training import train as T
from ginfinity_tpu_torch.training import train_cli as cli

from torch_train_data import jax_init, write_alignment, write_pairs

LOSS_REL = 1e-4


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli_data")
    data_p, map_p = write_alignment(d / "align", n_families=6)
    # a group of one, a row without an alignment id, an invalid structure
    with open(data_p, "a") as f:
        f.write("solo\t0\t((..))\tACGUAC\n\t1\t((...))\tACGUACG\n")
        f.write("fam2\t9\t((..\tACGU\n# trailing comment\n")
    return {
        "triplet": write_pairs(d / "triplets.tsv", "triplet"),
        "regression": write_pairs(d / "pairs.tsv", "regression", n=30),
        "alignment": (data_p, map_p),
    }


# -- prepare_dataset ----------------------------------------------------------


def _float32_cells(rows):
    """Rows with float cells as float32.  pandas' own float parser may
    read the last bit of a float64 otherwise than Python's ``float``
    (``0.25771204151195837`` as ``0.2577120415119583``); the trainer
    takes such values (regression targets) as float32."""
    return [{k: np.float32(v) if isinstance(v, float) else v for k, v in r.items()}
            for r in rows]


def _records(df):
    return _float32_cells(df.astype(object).where(df.notna(), None).to_dict("records"))


@pytest.mark.parametrize("mode,fraction,val", [
    ("triplet", 1.0, 0.25), ("triplet", 0.6, 0.2), ("regression", 1.0, 0.3),
    ("regression", 0.45, 0.1), ("alignment", 1.0, 0.25), ("alignment", 0.5, 0.4),
])
def test_prepare_dataset_matches_pandas(files, mode, fraction, val):
    data = files[mode]
    path, amap = data if mode == "alignment" else (data, None)
    argv = ["--training_mode", mode, "--f_sample_dataset", str(fraction),
            "--val_fraction", str(val), "--seed", "5"]
    want = jcli.prepare_dataset(jcli.build_parser().parse_args(argv), path, amap)
    got = cli.prepare_dataset(cli.build_parser().parse_args(argv), path, amap)
    for w, g in zip(want[:3], got[:3]):
        assert list(w.columns) == g.columns
        assert _records(w) == _float32_cells(g.rows)
    assert want[3] == got[3] and want[4] == got[4]
    assert 0 < len(got[2].rows) < len(got[0].rows)


# -- whole runs against the JAX CLI --------------------------------------------


def _log_values(log_path, keys=("Training Loss", "Validation Loss")):
    with open(log_path) as f:
        lines = f.read().splitlines()
    return [[ln.split(":", 1)[1].strip() for ln in lines if ln.startswith(key + ":")]
            for key in keys]


def _log_losses(log_path):
    return [[float(v) for v in vals] for vals in _log_values(log_path)]


def _compare_runs(jdir, pdir, ckpt_name, lr, steps):
    for sub in sorted({os.path.dirname(p) for p in _pths(jdir)}):
        rel = os.path.relpath(sub, jdir)
        want = _log_losses(os.path.join(sub, "train.log"))
        got = _log_losses(os.path.join(pdir, rel, "train.log"))
        assert [len(x) for x in got] == [len(x) for x in want] and len(got[0]) >= 3
        for w, g in zip(want, got):
            np.testing.assert_allclose(g, w, rtol=LOSS_REL, atol=0)
        # the runs moved the loss by more than the bar
        assert abs(got[0][-1] - got[0][0]) > 10 * LOSS_REL * abs(got[0][0])
        keys = ("Learning Rate", "Early Stopping Counter", "Epoch")
        assert _log_values(os.path.join(pdir, rel, "train.log"), keys) == \
            _log_values(os.path.join(sub, "train.log"), keys)
    jck = torch.load(os.path.join(jdir, ckpt_name), weights_only=False)
    pck = torch.load(os.path.join(pdir, ckpt_name), weights_only=False)
    assert jck["metadata"] == pck["metadata"] and jck["epoch"] == pck["epoch"]
    assert jck["state_dict"].keys() == pck["state_dict"].keys()
    for k, v in jck["state_dict"].items():
        assert pck["state_dict"][k].shape == v.shape and pck["state_dict"][k].dtype == v.dtype
        np.testing.assert_allclose(pck["state_dict"][k].numpy(), v.numpy(),
                                   atol=2 * lr * steps, rtol=0, err_msg=k)
    return pck


def _run_both(tmp_path, monkeypatch, args):
    """The JAX CLI in ``tmp_path/jax``, the port's on the CPU in
    ``tmp_path/port``."""
    for side, run in (("jax", jcli.main), ("port", lambda a: cli.main(a + ["--device", "cpu"]))):
        (tmp_path / side).mkdir()
        monkeypatch.chdir(tmp_path / side)
        run(args)


def _pths(root):
    return [os.path.join(d, f) for d, _, fs in os.walk(root) for f in fs if f.endswith(".pth")]


def _model_kw(args):
    """``GINConfig.create`` keywords of a run's flags, by the JAX CLI's
    ``make_config``."""
    cfg = jcli.make_config(jcli.build_parser().parse_args(args), int(
        args[args.index("--hidden_dim") + 1]))
    return dict(hidden_dim=list(cfg.hidden_dims), output_dim=cfg.output_dim,
                gin_layers=cfg.gin_layers, **{k: getattr(cfg, k) for k in (
                    "graph_encoding", "pooling_type", "dropout", "node_feature_dim",
                    "edge_feature_dim", "norm_type", "use_residual", "node_embed_norm",
                    "normalize_nodes_before_pool", "gin_eps", "train_eps", "seq_weight")})


@pytest.mark.parametrize("mode,extra", [
    # min_delta 10: no epoch counts as better, so patience stops the run
    ("triplet", ["--node_embed_norm", "zscore_l2", "--fit-node-stats", "--patience", "2",
                 "--min_delta", "10", "--num_epochs", "6"]),
    ("regression", ["--num_epochs", "3", "--pooling_type", "global_mean_pool",
                    "--train_eps"]),
])
def test_cli_matches_jax(files, tmp_path, monkeypatch, mode, extra):
    lr = 1e-4
    args = ["--input_path", files[mode], "--training_mode", mode, "--hidden_dim", "32",
            "--gin_layers", "2", "--output_dim", "16", "--batch_size", "8", "--lr", str(lr),
            "--decay_rate", "0.5", "--val_fraction", "0.25", "--model_id", "m", *extra]
    _, jp, js, (pp, ps) = jax_init(_model_kw(args), seed=42)
    monkeypatch.setattr(cli, "init_params", lambda gen, cfg: (pp, ps))
    _run_both(tmp_path, monkeypatch, args)
    n_epochs = len(_log_losses(tmp_path / "port" / "output" / "m" / "train.log")[0]) - 1
    n_train = len(cli.prepare_dataset(cli.build_parser().parse_args(args), files[mode],
                                      None)[1].rows)
    steps = n_epochs * -(-n_train // 8)
    pck = _compare_runs(str(tmp_path / "jax" / "output" / "m"),
                        str(tmp_path / "port" / "output" / "m"), "m.pth", lr, steps)
    if mode == "triplet":
        assert n_epochs == 2  # stopped by patience, as the JAX run
        sd = pck["state_dict"]
        assert not torch.equal(sd["node_mu"], torch.zeros_like(sd["node_mu"]))


def test_alignment_schedule_matches_jax(files, tmp_path, monkeypatch):
    """Two rounds from a JAX-exported initial checkpoint, the second
    starting from the first's ``.pth``."""
    data_p, map_p = files["alignment"]
    kw = dict(hidden_dim=32, output_dim=16, gin_layers=2, node_embed_norm="zscore_l2",
              dropout=0.0)
    jc, jp, js, _ = jax_init(kw, seed=3)
    init = str(tmp_path / "init.pth")
    jexport(init, jc, jp, js)
    lrs = (5e-5, 2e-5)
    sched = {"checkpoint": init, "rounds": [
        {"round": i + 1, "input": data_p, "alignment_map": map_p, "patience": 5, "epochs": 3,
         "learning_rate": lr, "decay_rate": 0.7, "keep_weights": True}
        for i, lr in enumerate(lrs)]}
    sp = tmp_path / "sched.json"
    sp.write_text(json.dumps(sched))
    args = ["--schedule", str(sp), "--model_id", "s", "--training_mode", "alignment",
            "--batch_size", "2", "--val_fraction", "0.25", "--alignment_max_negatives", "40",
            "--alignment_unaligned_per_graph", "3"]
    _run_both(tmp_path, monkeypatch, args)
    for r in (1, 2):
        name = f"round_{r:02d}/s_round_{r:02d}.pth"
        _compare_runs(str(tmp_path / "jax" / "output" / "s"), str(tmp_path / "port" / "output"
                                                                   / "s"), name,
                      max(lrs), 3 * 3 * r)


# -- the port's own behaviour ---------------------------------------------------

SMALL = ["--training_mode", "triplet", "--hidden_dim", "8", "--gin_layers", "1",
         "--output_dim", "4", "--batch_size", "8", "--lr", "0.01", "--decay_rate", "0.9",
         "--val_fraction", "0.25", "--device", "cpu"]


def _interrupt_at(monkeypatch, call):
    calls = {"n": 0}
    orig = T.EarlyStopping.__call__

    def interrupting(self, val, ts):
        calls["n"] += 1
        if calls["n"] >= call:
            raise KeyboardInterrupt
        return orig(self, val, ts)

    monkeypatch.setattr(T.EarlyStopping, "__call__", interrupting)
    return orig


def test_save_every_and_exact_resume(files, tmp_path, monkeypatch):
    """A run interrupted in epoch 2 and resumed from its latest checkpoint
    writes the uninterrupted run's ``.pth`` bit for bit (dropout on: the
    generator's state is restored too); the last 3 checkpoints are kept."""
    monkeypatch.chdir(tmp_path)
    args = ["--input_path", files["triplet"], *SMALL, "--num_epochs", "5", "--patience", "10",
            "--save-every", "1", "--dropout", "0.2", "--norm_type", "batch"]
    cli.main(args + ["--model_id", "full"])
    orig = _interrupt_at(monkeypatch, 2)
    monkeypatch.setattr(builtins, "input", lambda *a: "n")
    cli.main(args + ["--model_id", "part"])
    monkeypatch.setattr(T.EarlyStopping, "__call__", orig)
    ckpts = tmp_path / "output" / "part" / "checkpoints"
    assert sorted(os.listdir(ckpts)) == ["epoch_0.pt"]
    cli.main(args + ["--model_id", "part", "--resume-from", str(ckpts)])
    full = torch.load(tmp_path / "output" / "full" / "full.pth", weights_only=False)
    part = torch.load(tmp_path / "output" / "part" / "part.pth", weights_only=False)
    assert full["epoch"] == part["epoch"] == 4
    assert full["state_dict"].keys() == part["state_dict"].keys()
    assert all(torch.equal(v, part["state_dict"][k]) for k, v in full["state_dict"].items())
    # the resumed run logs its initial evaluation, then epochs 2-5
    full_losses = _log_losses(tmp_path / "output" / "full" / "train.log")[0]
    part_losses = _log_losses(tmp_path / "output" / "part" / "train.log")[0]
    assert part_losses == full_losses[:1] + full_losses[2:]
    assert sorted(os.listdir(tmp_path / "output" / "full" / "checkpoints")) == [
        "epoch_2.pt", "epoch_3.pt", "epoch_4.pt"]


@pytest.mark.parametrize("answer", ["y", "n"])
def test_interrupt_saves_or_declines_best_weights(files, tmp_path, monkeypatch, answer):
    monkeypatch.chdir(tmp_path)
    _interrupt_at(monkeypatch, 2)
    monkeypatch.setattr(builtins, "input", lambda *a: answer)
    cli.main(["--input_path", files["triplet"], *SMALL, "--num_epochs", "50",
              "--model_id", "intr"])
    log = (tmp_path / "output" / "intr" / "train.log").read_text()
    assert "Interrupted by user" in log
    ckpt = tmp_path / "output" / "intr" / "intr.pth"
    if answer == "y":
        assert "Best weights saved after interrupt: True" in log
        cfg, _, _, extra = jimport(str(ckpt))
        assert cfg.hidden_dims == (8,) and "epoch" in extra
    else:
        assert not ckpt.exists() and "Best weights saved after interrupt: False" in log


def test_disabled_best_weights_skips_the_prompt(files, tmp_path, monkeypatch):
    """``--save_best_weights ''`` (the reference's type=bool quirk: False)
    neither prompts nor saves on an interrupt."""
    monkeypatch.chdir(tmp_path)
    _interrupt_at(monkeypatch, 1)
    prompted = []
    monkeypatch.setattr(builtins, "input", lambda *a: prompted.append(1) or "y")
    cli.main(["--input_path", files["triplet"], *SMALL, "--num_epochs", "3",
              "--model_id", "nb", "--save_best_weights", ""])
    assert not prompted and not (tmp_path / "output" / "nb" / "nb.pth").exists()
    assert "Interrupted by user" in (tmp_path / "output" / "nb" / "train.log").read_text()


def test_forgi_diagnostics_and_reload(files, tmp_path, monkeypatch):
    """A forgi run with ``--diagnostic-aligment`` writes the epoch PNGs and
    a ``.pth`` that the JAX package and the port's embed CLI read."""
    monkeypatch.chdir(tmp_path)
    diag = tmp_path / "diag.csv"
    diag.write_text("Name,DotBracket\na,((((....))))\nb,((....))(...)\n")
    monkeypatch.setenv("GINFINITY_DIAGNOSTIC_ALIGNMENT_PATH", str(diag))
    cli.main(["--input_path", files["triplet"], *SMALL, "--num_epochs", "2",
              "--model_id", "fg", "--graph_encoding", "forgi", "--diagnostic-aligment",
              "--data-parallel"])
    out = tmp_path / "output" / "fg"
    assert "epoch_000.png" in os.listdir(out / "similarity_matrices")
    cfg, _, _, _ = jimport(str(out / "fg.pth"))
    assert (cfg.graph_encoding, cfg.node_feature_dim, cfg.edge_feature_dim) == ("forgi", 16, 7)
    src = tmp_path / "s.csv"
    src.write_text("id,secondary_structure\nx,((((....))))\ny,((..((...))..))\n")
    embed.main(["--input", str(src), "--id-column", "id", "--output", str(tmp_path / "e.tsv"),
                "--model-path", str(out / "fg.pth"), "--device", "cpu", "--quiet"])
    assert len((tmp_path / "e.tsv").read_text().splitlines()) == 3


def test_flag_set_is_the_jax_cli_s():
    def flags(parser):
        return sorted(s for a in parser._actions for s in a.option_strings)

    assert flags(cli.build_parser()) == flags(jcli.build_parser())
