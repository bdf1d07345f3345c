"""Build of the port's CUDA kernels at first use.

Every ``*.cu`` file under ``ops/csrc`` is compiled by ``nvcc`` for
Hopper (``sm_90a``), one process per source and all started together,
then linked into one shared library with a plain C interface that
``ctypes`` loads.  The library lands in ``ginfinity_tpu_torch/_build/<key>/``,
where the key hashes the sources and the flags, so an edit to either
builds anew and an unchanged tree reuses the library.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[1] / "_build"
LIB_NAME = "libginfinity_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills go to build.log
)


def _sources() -> list[Path]:
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on ``PATH``, else the
    toolkit's default install location."""
    home = os.environ.get("CUDA_HOME")
    for cand in (
        os.path.join(home, "bin", "nvcc") if home else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / LIB_NAME


def build_library() -> Path:
    """Path of the built library, compiling it first if needed.  Raises
    ``RuntimeError`` with nvcc's output when a step fails."""
    out = library_path()
    if out.exists():
        return out
    nvcc = nvcc_path()
    tmp = out.parent / f"tmp-{os.getpid()}"
    tmp.mkdir(parents=True, exist_ok=True)
    units = [s for s in _sources() if s.suffix == ".cu"]
    objs = [tmp / (s.stem + ".o") for s in units]
    procs = [
        subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(o)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for s, o in zip(units, objs)
    ]
    logs = []
    for s, p in zip(units, procs):
        text, _ = p.communicate()
        logs.append(f"== {s.name}\n{text}")
        if p.returncode != 0:
            for q in procs:
                q.wait()
            raise RuntimeError(f"nvcc failed on {s.name}:\n{text}")
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp / LIB_NAME), *map(str, objs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    (out.parent / "build.log").write_text("\n".join(logs))
    os.replace(tmp / LIB_NAME, out)
    shutil.rmtree(tmp, ignore_errors=True)
    return out
