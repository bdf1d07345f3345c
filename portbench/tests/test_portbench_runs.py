"""The benchmark's command: it measures nothing without a card, nothing
in a directory that holds only the benchmark, and loads neither JAX nor
the JAX package; the reference imports nothing of the program."""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
ARGS = ["--workload", BENCH["workloads"][0]["name"], "--seed", str(2**31 + 5),
        "--seconds", "1", "--trace", "0"]


def _run(cwd, env_extra=None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env_extra or {}))
    return subprocess.run([sys.executable, "portbench/run.py", *ARGS], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    res = _run(ROOT)
    assert res.returncode == 3, res.stderr
    assert not any(line.startswith("{") for line in res.stdout.splitlines())
    assert "CUDA card" in res.stderr


def test_benchmark_alone_is_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = _run(tmp_path)
    assert res.returncode != 0
    assert not any(line.startswith("{") for line in res.stdout.splitlines())


_GUARD = """
import sys
sys.path.insert(0, {root!r})
import portbench.run as run
from portbench import harness, calibrate, faults
for name in {cells!r}:
    harness.load_cell(name)
top = {{m.split(".")[0] for m in sys.modules}}
bad = sorted(top & {{"jax", "jaxlib", "flax", "ginfinity_tpu"}})
assert "ginfinity_tpu_torch" in top
assert run.forbidden_modules() == bad
print(bad)
"""


def test_nothing_loads_jax_or_the_jax_package():
    code = _GUARD.format(root=str(ROOT), cells=[w["name"] for w in BENCH["workloads"]])
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "[]"


def test_the_reference_imports_nothing_of_the_program():
    for path in (ROOT / "portbench" / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] not in ("ginfinity_tpu_torch", "ginfinity_tpu", "jax"), \
                    (path.name, n)
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r})\n"
            "import portbench.reference.graphs, portbench.reference.gine, "
            "portbench.reference.train, portbench.reference.dp, portbench.reference.precision\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'ginfinity_tpu_torch', 'ginfinity_tpu', 'jax'}))")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0 and res.stdout.strip() == "[]", res.stderr
