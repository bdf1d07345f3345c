"""Import and device hygiene of the port: its package,
``chip_smoke.py`` and ``k1_phases.py`` import nothing the card's machine lacks (no jax,
flax, optax, orbax, pandas, psutil, nor the JAX package), its entry points never run
on the CPU unasked, and ``chip_smoke.py`` fails without a card."""

import json
import os
import pkgutil
import shutil
import subprocess
import sys

import pytest
import torch

import ginfinity_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "pandas", "psutil", "ginfinity_tpu")

_IMPORT_ALL = """
import importlib, importlib.abc, pkgutil, sys
FORBIDDEN = {forbidden!r}

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if any(name == f or name.startswith(f + ".") for f in FORBIDDEN):
            raise ImportError("refused import of " + name)
        return None

sys.meta_path.insert(0, Refuse())
import ginfinity_tpu_torch
names = [m.name for m in pkgutil.walk_packages(ginfinity_tpu_torch.__path__,
                                                "ginfinity_tpu_torch.")]
for n in names:
    importlib.import_module(n)
import chip_smoke
import k1_phases
bad = [m for m in sys.modules if any(m == f or m.startswith(f + ".") for f in FORBIDDEN)]
assert not bad, bad
print(len(names))
"""


def _port_modules():
    return [m.name for m in pkgutil.walk_packages(ginfinity_tpu_torch.__path__,
                                                  "ginfinity_tpu_torch.")]


def test_port_and_smoke_import_without_forbidden_packages():
    code = _IMPORT_ALL.format(forbidden=FORBIDDEN)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip().splitlines()[-1]) == len(_port_modules()) >= 15


def test_entry_points_refuse_the_cpu_unasked(monkeypatch, tmp_path):
    import numpy as np

    from ginfinity_tpu_torch.models.gine import GINConfig, GINModel, init_params
    from ginfinity_tpu_torch.parallel.search import TopKSearcher
    from ginfinity_tpu_torch.pipelines import (
        base_embed,
        distances,
        embed,
        msa_eval,
        optimize_msa,
        prewarm,
    )
    from ginfinity_tpu_torch.models.checkpoint import export_torch_checkpoint
    from ginfinity_tpu_torch.pipelines import train_eval
    from ginfinity_tpu_torch.pipelines.fast_windows import embed_corpus_windows
    from ginfinity_tpu_torch.training import train_cli
    from ginfinity_tpu_torch.utils.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    seqs = tmp_path / "seqs.csv"
    seqs.write_text("id,sequence\nx,ACGU\n")
    cfg = GINConfig.create(hidden_dim=128, output_dim=128, gin_layers=1)
    model = GINModel(cfg, *init_params(torch.Generator().manual_seed(0), cfg))
    ckpt = str(tmp_path / "m.pth")
    export_torch_checkpoint(ckpt, cfg, model.params, model.state)
    fams = [msa_eval.make_family(0, 2, 20)]
    for call in (
        lambda: resolve_device(),
        lambda: resolve_device("cuda"),
        lambda: embed_corpus_windows(model, ["((....))" * 6], 20),
        lambda: embed.main(["--input", "x.csv", "--id-column", "id", "--window-size",
                            "20", "--model-path", "m.pth",
                            "--output", str(tmp_path / "o.tsv")]),
        lambda: embed.main(["--input", "x.csv", "--id-column", "id", "--model-path", "m.pth",
                            "--output", str(tmp_path / "o.tsv")]),
        lambda: distances.main(["--input", "x.tsv", "--output", str(tmp_path / "d.tsv")]),
        lambda: distances.pair_distances(np.zeros((2, 4), np.float32), np.array([0]),
                                         np.array([1])),
        lambda: TopKSearcher(np.zeros((4, 8), np.float32)),
        lambda: msa_eval.main(["--model-path", "m.pth", "--workdir", str(tmp_path / "w")]),
        lambda: msa_eval.family_to_tsv(msa_eval.make_family(0, 2, 20), "m.pth",
                                       str(tmp_path / "f.tsv")),
        lambda: optimize_msa.main(["--input", "x.tsv", "--regions-tsv", "r.tsv", "--name-a",
                                   "a", "--name-b", "b", "--outdir", str(tmp_path / "o")]),
        lambda: base_embed.main(["--input", str(seqs), "--output", str(tmp_path / "b.tsv"),
                                 "--id-column", "id"]),
        lambda: prewarm.main(["--msa", "3", "10"]),
        lambda: train_cli.main(["--input_path", "x.tsv"]),
        lambda: train_cli.main(["--input_path", "x.tsv", "--device", "cuda"]),
        lambda: train_eval.retrieval_recall_at_10(ckpt, fams),
        lambda: train_eval.alignment_sp_f1(ckpt, fams),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert model.device.type == "cpu"
    assert resolve_device("cpu").type == "cpu"
    with pytest.raises(ValueError):
        resolve_device("mps")


def _run_smoke(cwd):
    env = {k: v for k, v in os.environ.items() if k != "CUDA_VISIBLE_DEVICES"}
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True,
                          text=True, timeout=300, env=env)


def _printed_ok(stdout):
    for line in stdout.splitlines():
        try:
            if json.loads(line).get("ok") is True:
                return True
        except (ValueError, AttributeError):
            continue
    return False


def test_chip_smoke_fails_without_a_card():
    res = _run_smoke(REPO)
    assert res.returncode != 0
    assert not _printed_ok(res.stdout) and "no CUDA device" in res.stderr


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    res = _run_smoke(tmp_path)
    assert res.returncode != 0 and not _printed_ok(res.stdout)


_BUILD_ON_IMPORT = """
import subprocess
def refuse(*a, **k):
    raise AssertionError("a build was started while importing: " + repr(a[:1]))
subprocess.Popen.__init__ = refuse
subprocess.run = refuse
from ginfinity_tpu_torch.utils import native
from ginfinity_tpu_torch.ops import library_pool, profile_pool, value_traceback, pairhmm
from ginfinity_tpu_torch.ops import contrastive_loss, dp, dp_traceback, dp_wavefront
from ginfinity_tpu_torch.ops import windows_encoder, _build
from ginfinity_tpu_torch.pipelines import msa, node_embed, fast_windows
from ginfinity_tpu_torch.graphs import dotbracket
assert native._lib is None and _build._lib is None
assert not profile_pool.check_no_sync and profile_pool.guarded_loops == 0
print("ok")
"""


def test_pool_and_native_modules_build_nothing_on_import():
    """The native parser, the kernel library and the pools build at first
    use, never on import: every process creation is refused while the
    modules are imported, and the one loader of the kernels is unbound."""
    res = subprocess.run([sys.executable, "-c", _BUILD_ON_IMPORT], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def test_pools_refuse_the_cpu_unasked(monkeypatch):
    """The progressive stage's pools run on the card unless asked for the
    CPU; the traceback wrapper takes its plain version only for a CPU
    tensor and refuses other devices."""
    import numpy as np

    from ginfinity_tpu_torch.ops.value_traceback import value_traceback
    from ginfinity_tpu_torch.pipelines import msa

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("GINFINITY_MSA_POOL", raising=False)
    rng = np.random.default_rng(0)
    profiles = msa.initial_profiles([msa.SequenceRecord(f"s{k}", msa._l2_normalize_rows(
        rng.normal(size=(6, 4)).astype(np.float32))) for k in range(3)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        msa.msa_from_tree(((0, 1), 2), profiles, -1.0, -0.1)
    assert msa.msa_from_tree(((0, 1), 2), profiles, -1.0, -0.1, device="cpu").stem.size >= 6
    ST = torch.zeros((3, 3, 1, 3))
    with pytest.raises(ValueError, match="unsupported device"):
        value_traceback(ST.to("meta"), torch.ones(1, dtype=torch.int64, device="meta"),
                        torch.ones(1, dtype=torch.int64, device="meta"))
