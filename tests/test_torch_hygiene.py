"""Import and device hygiene of the port: its package,
``chip_smoke.py`` and ``k1_phases.py`` import nothing the card's machine lacks (no jax,
flax, pandas, psutil, nor the JAX package), its entry points never run
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
FORBIDDEN = ("jax", "jaxlib", "flax", "pandas", "psutil", "ginfinity_tpu")

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
    from ginfinity_tpu_torch.pipelines import distances, embed
    from ginfinity_tpu_torch.pipelines.fast_windows import embed_corpus_windows
    from ginfinity_tpu_torch.utils.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = GINConfig.create(hidden_dim=128, output_dim=128, gin_layers=1)
    model = GINModel(cfg, *init_params(torch.Generator().manual_seed(0), cfg))
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
