#!/usr/bin/env python3
"""Where K1's time goes, on one GPU.

    python3 k1_phases.py

Builds the window encoder (``ginfinity_tpu_torch/ops/csrc/windows_encoder.cu``)
with its timing hook (``-DK1_PROFILE``: thread 0 of each CTA stamps the
global nanosecond clock after setup, after each layer's products and
GraphNorm, and at the end), and beside it variants with one piece taken
out: no wgmma, no weight loads, or neither.  The variants compute wrong
outputs and exist only to show what each piece costs.  Each runs on one
128-window flagship chunk (6 x GINE-128, L = 120) of the seeded corpus of
``chip_smoke.py``; each prints one JSON line: the chunk's time (CUDA
events), its max abs error against the plain version, and the mean per
window of each phase in microseconds.  Imports only the port, torch,
numpy and the standard library.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

sys.dont_write_bytecode = True

import chip_smoke as cs
from ginfinity_tpu_torch.models.gine import GINConfig, GINModel
from ginfinity_tpu_torch.ops import _build
from ginfinity_tpu_torch.ops import windows_encoder as we

SOURCE = _build.CSRC / "windows_encoder.cu"
STAMPS = 16  # per window: setup, 6 x (products, GraphNorm), end
NO_WGMMA = [(f"      wgmma_tf32(acc, ab[kk][{i}], {d});  // {c}\n", "")
            for i, d, c in ((1, "dh", "lo * hi'"), (0, "dl", "hi * lo'"), (0, "dh", "hi * hi'"))]
NO_LOADS = [("    mbar_expect_tx(&full[slot], kStageBytes);\n"
             "    bulk_load(buf + slot * kStageFloats, feed.src(), kStageBytes, &full[slot]);",
             "    mbar_expect_tx(&full[slot], 0);")]
VARIANTS = {
    "kernel": [],
    "no_wgmma": NO_WGMMA,
    "no_weight_loads": NO_LOADS,
    "no_weight_loads_no_wgmma": NO_LOADS + NO_WGMMA,
}
PHASES = ["setup"] + [f"{k}{i}" for i in range(6) for k in ("products", "graphnorm")] + ["tail"]


def build(tmp: str) -> dict:
    """Every variant's library, compiled in parallel; its ptxas summary."""
    src = SOURCE.read_text()
    procs = {}
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"variant {name}: the source no longer has {old!r}")
            text = text.replace(old, new)
        cu = os.path.join(tmp, f"{name}.cu")
        with open(cu, "w") as f:
            f.write("#define K1_PROFILE\n" + text)
        procs[name] = subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-shared", "-o",
             os.path.join(tmp, f"lib{name}.so"), cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        out, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{out}")
        lib = ctypes.CDLL(os.path.join(tmp, f"lib{name}.so"))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.windows_encoder_launch.argtypes = [ptr] * 10 + [i32] * 9 + [ctypes.c_float, ptr]
        lib.windows_encoder_launch.restype = i32
        lib.windows_encoder_smem_bytes.argtypes = [i32, i32]
        lib.windows_encoder_smem_bytes.restype = ctypes.c_size_t
        lib.cuda_error_string.argtypes = [i32]
        lib.cuda_error_string.restype = ctypes.c_char_p
        lib.windows_encoder_stamps.argtypes = [ptr, i32]
        lib.windows_encoder_stamps.restype = i32
        libs[name] = (lib, [ln.strip() for ln in out.splitlines()
                            if "registers" in ln or "spill" in ln or "C75" in ln])
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("k1_phases: no CUDA device is available", file=sys.stderr)
        return 2
    dev = cs.DEVICE
    torch.cuda.set_device(dev)
    cs.disable_tf32()
    print(cs.card_name_and_limit(), flush=True)
    rng = np.random.default_rng(cs.SEED)
    cs.corpus(rng, 2000, 120)  # the draws of chip_smoke's kernel_vs_plain phase
    cfg = GINConfig.create(**cs.FLAGSHIP)
    model = GINModel(cfg, *cs.seeded_model(cfg, cs.SEED + 2)).to(dev)
    p, s = model.params, model.state
    x0, flags = cs.chunk_inputs(cfg, p, cs.corpus(rng, cs.N_WINDOWS, cs.WINDOW), cs.WINDOW, dev)
    packed = we.pack_params(cfg, p, s)
    ref = we.forward_windows_reference(cfg, p, s, x0, *flags, cs.WINDOW)
    C = x0.shape[0]
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(tmp)
        for name, (lib, ptxas) in libs.items():
            we._lib = lib
            run = lambda: we.forward_windows(cfg, p, s, x0, *flags, cs.WINDOW, packed=packed)
            run()  # the library's first launch loads its module: stamp a later one
            got = run()
            torch.cuda.synchronize()
            stamps = (ctypes.c_ulonglong * (C * STAMPS))()
            err = lib.windows_encoder_stamps(ctypes.cast(stamps, ctypes.c_void_p), C * STAMPS)
            if err:
                raise RuntimeError(lib.cuda_error_string(err).decode())
            a = np.array(stamps, dtype=np.float64).reshape(C, STAMPS)
            d = np.diff(a[:, [0, 1] + list(range(2, 14)) + [15]], axis=1) / 1e3
            print(json.dumps({
                "variant": name, "windows": C, "ms": cs.cuda_ms(run, 30),
                "max_abs_err": (got - ref).abs().max().item(),
                "phase_us_mean": dict(zip(PHASES, d.mean(0).round(3).tolist())),
                "window_us_max": float((a[:, 15] - a[:, 0]).max() / 1e3),
                "ptxas": ptxas}), flush=True)
        we._lib = None
    return 0


if __name__ == "__main__":
    sys.exit(main())
