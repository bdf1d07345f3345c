"""Build and binding of the port's CUDA kernels at first use.

Every ``*.cu`` file under ``ops/csrc`` is compiled by ``nvcc`` for
Hopper (``sm_90a``), one process per source and all started together,
then linked into one shared library with a plain C interface that
``ctypes`` loads.  The library lands in ``ginfinity_tpu_torch/_build/<key>/``,
where the key hashes the sources and the flags, so an edit to either
builds anew and an unchanged tree reuses the library.

:func:`library` binds it once per process, with every C entry point
declared in :data:`ENTRY_POINTS`; the kernel wrappers launch through
:func:`call` and turn an error code into an exception with :func:`check`.
Nothing is built or bound on import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[1] / "_build"
LIB_NAME = "libginfinity_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills go to build.log
)
HOPPER_SMEM_OPTIN = 232448  # bytes of shared memory one CTA may opt in to on Hopper

_P, _I, _F, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_double
# every extern "C" function of csrc/*.cu: (restype, argtypes); a launch
# returns a cudaError_t and takes its stream last
ENTRY_POINTS = {
    "cuda_error_string": (ctypes.c_char_p, [_I]),
    "windows_encoder_launch": (_I, [_P] * 10 + [_I] * 9 + [_F, _P]),
    "windows_encoder_smem_bytes": (ctypes.c_size_t, [_I, _I, _I]),
    "windows_encoder_smem_rows": (_I, [_I, _I]),
    "windows_encoder_staged": (_I, [_I, _I, _I]),
    "dp_wavefront_launch": (_I, [_P, _P, _P, _I, _I, _I, _F, _F, _I, _P, _P, _P, _P, _P]),
    "dp_wavefront_warp_launch": (_I, [_P, _P, _P, _I, _I, _I, _F, _F, _I, _I,
                                      _P, _P, _P, _P, _P]),
    "dp_wavefront_smem_bytes": (ctypes.c_size_t, [_I]),
    "dp_wavefront_smem_optin": (_I, [_I]),
    "dp_traceback_launch": (_I, [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P]),
    "value_traceback_launch": (_I, [_P, _P, _P, _I, _I, _I, _P, _P]),
    "contrastive_loss_scratch_bytes": (ctypes.c_size_t, [_I, _I, _I, _I]),
    "contrastive_loss_forward": (_I, [_I, _P, _I, _I, _P, _P, _P, _D, _D, _I,
                                      _P, _P, _P, _P, _P, _P, _P, _P]),
    "contrastive_loss_backward": (_I, [_I, _P, _I, _I, _P, _P, _P, _D, _D, _I,
                                       _P, _P, _P, _P, _P, _P, _P]),
}


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


def bind(path, names=tuple(ENTRY_POINTS)) -> ctypes.CDLL:
    """The shared library at ``path``, its entry points ``names`` declared
    as :data:`ENTRY_POINTS` gives them."""
    lib = ctypes.CDLL(str(path))
    for name in names:
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = ENTRY_POINTS[name]
    return lib


_lib = None


def library() -> ctypes.CDLL:
    """The kernels' library, built and bound at the first call.  Binding
    checks that the library and ``ops/dp_wavefront.py`` size the DP's
    shared memory alike."""
    global _lib
    if _lib is None:
        from ginfinity_tpu_torch.ops.dp_wavefront import smem_bytes

        lib = bind(build_library())
        if lib.dp_wavefront_smem_bytes(1) != smem_bytes(1):
            raise RuntimeError("dp_wavefront: shared-memory sizes of the library and "
                               "the wrapper disagree")
        _lib = lib
    return _lib


def on_card(t: torch.Tensor, what: str) -> bool:
    """Whether ``t`` lies on a CUDA device, the kernel's side, rather than
    on the CPU, the plain version's; any other device is refused, since no
    wrapper falls back from one version to the other."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {t.device}")
    return t.device.type == "cuda"


def check(err: int, what: str) -> None:
    """Raises ``RuntimeError`` with CUDA's message when the error code
    ``err`` of ``what`` is not 0 (success)."""
    if err != 0:
        raise RuntimeError(f"{what} failed: " + library().cuda_error_string(err).decode())


def call(entry: str, device: torch.device, *args) -> None:
    """Launches the C entry point ``entry`` with ``args`` on the current
    stream of the CUDA ``device``, which is made current for the call;
    raises on a CUDA error."""
    with torch.cuda.device(device):
        err = getattr(library(), entry)(*args, torch.cuda.current_stream(device).cuda_stream)
    check(err, entry)
