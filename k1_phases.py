#!/usr/bin/env python3
"""Where K1's time goes, on one GPU.

    python3 k1_phases.py [--config portbench/configs/forgi-4x512.json]
                         [--source path/to/windows_encoder.cu]

Builds the window encoder (``ginfinity_tpu_torch/ops/csrc/windows_encoder.cu``,
or ``--source``) with its timing hook (``-DK1_PROFILE``: thread 0 of each
CTA stamps the global nanosecond clock after setup, after each layer's
messages and products and after its GraphNorm, and at the end), and
beside it variants with one piece taken out: no wgmma, no weight loads,
neither, A read as zeros, or (on the route that stages A through shared
memory) no copies of A.  The variants compute wrong outputs and
exist only to show what each piece costs; a variant whose text the
source lacks is reported as skipped.  Without ``--config`` each runs on
one 128-window flagship chunk (6 x GINE-128, L = 120) of the seeded
corpus of ``chip_smoke.py``; with a benchmark configuration
(``portbench/configs/*.json``) on one 128-window chunk of the
``windows-long`` traffic's transcripts (500-8,000 nt, L 120) under that
configuration's widths and weights, as the cell's own set-up draws them
(``chip_smoke.windows_cell``).  A first JSON line gives the
chunk (active rows), its least time at the 3xTF32 rate and the plain
version's time; then each variant prints one: the chunk's time (CUDA
events), its max abs error against the plain version, and the mean per
window of each phase in microseconds.
Imports only the port, ``portbench``, torch, numpy and the standard
library.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

sys.dont_write_bytecode = True

import chip_smoke as cs
from ginfinity_tpu_torch.models.gine import GINConfig, GINModel
from ginfinity_tpu_torch.ops import _build
from ginfinity_tpu_torch.ops import windows_encoder as we

SOURCE = _build.CSRC / "windows_encoder.cu"
STAMPS = 16  # per window: setup, per layer (messages and products, GraphNorm), end
CHUNK = 128  # windows of a chunk of the main path's long groups
NO_WGMMA = [(f"      wgmma_tf32(acc, ab[kk][{i}], {d});  // {c}\n", "")
            for i, d, c in ((1, "dh", "lo * hi'"), (0, "dl", "hi * lo'"), (0, "dh", "hi * hi'"))]
NO_LOADS = [("    mbar_expect_tx(&full[slot], kStageBytes);\n"
             "    bulk_load(buf + slot * kStageFloats, feed.src(), kStageBytes, &full[slot]);",
             "    mbar_expect_tx(&full[slot], 0);")]
# the A fragments built from zeros (no loads of A, on either route); the
# staged route without its copies of A into shared memory
NO_A_LOADS = [("        const float v = load(f & 1, k0 + 8 * kk + t + 4 * (f >> 1));\n",
               "        const float v = 0.f;\n")]
NO_A_COPIES = [("        cp_async16(dst + row * kDepth + 4 * (ch ^ swizzle(row)), src, "
                "live ? 16 : 0);\n", "")]
VARIANTS = {
    "kernel": [],
    "no_wgmma": NO_WGMMA,
    "no_weight_loads": NO_LOADS,
    "no_weight_loads_no_wgmma": NO_LOADS + NO_WGMMA,
    "no_a_loads": NO_A_LOADS,
    "no_a_copies": NO_A_COPIES,
}


def bind_windows_library(path, text: str) -> ctypes.CDLL:
    """A library built from the windows_encoder.cu source ``text`` alone,
    bound with the loader's entry points that the source defines (an
    older source may lack some; one from before the staged route stages
    no launch)."""
    names = [n for n in _build.ENTRY_POINTS
             if (n.startswith("windows_encoder_") or n == "cuda_error_string")
             and re.search(rf"\b{n}\(", text)]
    lib = _build.bind(path, names)
    if "windows_encoder_staged" not in names:
        lib.windows_encoder_staged = lambda L, mw, route: 0
    return lib


def build(tmp: str, source) -> tuple[dict, dict]:
    """Every variant's library, compiled in parallel, and its ptxas
    summary; and the variants the source has no text for."""
    src = Path(source).read_text()
    procs, skipped = {}, {}
    for name, subs in VARIANTS.items():
        text = src
        missing = [old for old, _ in subs if old not in text]
        if missing:
            skipped[name] = f"the source lacks {missing[0]!r}"
            continue
        for old, new in subs:
            text = text.replace(old, new)
        cu = os.path.join(tmp, f"{name}.cu")
        with open(cu, "w") as f:
            f.write("#define K1_PROFILE\n" + text)
        procs[name] = subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-shared",
             "-o", os.path.join(tmp, f"lib{name}.so"), cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        out, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{out}")
        lib = bind_windows_library(os.path.join(tmp, f"lib{name}.so"), src)
        lib.windows_encoder_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.windows_encoder_stamps.restype = ctypes.c_int
        libs[name] = (lib, [ln.strip() for ln in out.splitlines()
                            if "registers" in ln or "spill" in ln or "C75" in ln])
    return libs, skipped


def flagship_chunk(dev):
    """The flagship model and one chunk of chip_smoke's seeded corpus."""
    rng = np.random.default_rng(cs.SEED)
    cs.corpus(rng, 2000, 120)  # the draws of chip_smoke's kernel_vs_plain phase
    cfg = GINConfig.create(**cs.FLAGSHIP)
    model = GINModel(cfg, *cs.seeded_model(cfg, cs.SEED + 2)).to(dev)
    structures = cs.corpus(rng, cs.N_WINDOWS, cs.WINDOW)
    return cfg, model, cs.chunk_inputs(cfg, model.params, structures, cs.WINDOW, dev), cs.WINDOW


def traffic_chunk(config_path: str, dev):
    """A benchmark configuration's model and one chunk of the
    ``windows-long`` cell's first request (one transcript of each length
    stratum), a chunk of the main path's size spread over its largest
    length group."""
    model, structures, L = cs.windows_cell(config_path, dev)
    cfg = model.config
    return cfg, model, cs.chunk_inputs(cfg, model.params, structures, L, dev, C=CHUNK), L


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", help="a benchmark configuration (portbench/configs/*.json); "
                                     "default: the flagship 6 x 128")
    ap.add_argument("--source", default=str(SOURCE), help="the kernel source to build")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k1_phases: no CUDA device is available", file=sys.stderr)
        return 2
    dev = cs.DEVICE
    torch.cuda.set_device(dev)
    cs.disable_tf32()
    print(cs.card_name_and_limit(), flush=True)
    cfg, model, (x0, flags), L = (traffic_chunk(args.config, dev) if args.config
                                  else flagship_chunk(dev))
    p, s = model.params, model.state
    packed = we.pack_params(cfg, p, s)
    ref = we.forward_windows_reference(cfg, p, s, x0, *flags, L)
    C, n_layers = x0.shape[0], cfg.gin_layers
    rows = (L + flags[2].sum(dim=1)).cpu().numpy()
    phases = ["setup"] + [f"{k}{i}" for i in range(n_layers)
                          for k in ("products", "graphnorm")] + ["tail"]
    bound_ms, bound_by, fma_bound_ms = cs.encoder_bound_ms(cfg, x0, flags, packed, L)
    plain_ms = cs.cuda_ms(lambda: we.forward_windows_reference(cfg, p, s, x0, *flags, L), 10)
    print(json.dumps({"source": args.source, "config": args.config or "flagship",
                      "widths": list(cfg.hidden_dims), "L": L, "windows": C,
                      "active_rows_mean": float(rows.mean()), "active_rows_max": int(rows.max()),
                      "windows_over_128_rows": int((rows > 128).sum()), "bound_ms": bound_ms,
                      "bound_by": bound_by, "fma_bound_ms": fma_bound_ms,
                      "plain_ms": plain_ms}), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        libs, skipped = build(tmp, args.source)
        for name, why in skipped.items():
            print(json.dumps({"variant": name, "skipped": why}), flush=True)
        for name, (lib, ptxas) in libs.items():
            _build._lib = lib  # forward_windows launches through the loader's handle
            run = lambda: we.forward_windows(cfg, p, s, x0, *flags, L, packed=packed)
            run()  # the library's first launch loads its module: stamp a later one
            got = run()
            torch.cuda.synchronize()
            stamps = (ctypes.c_ulonglong * (C * STAMPS))()
            err = lib.windows_encoder_stamps(ctypes.cast(stamps, ctypes.c_void_p), C * STAMPS)
            _build.check(err, "windows_encoder_stamps")
            a = np.array(stamps, dtype=np.float64).reshape(C, STAMPS)
            cols = [0, 1] + list(range(2, 2 + 2 * n_layers)) + [STAMPS - 1]
            d = np.diff(a[:, cols], axis=1) / 1e3
            print(json.dumps({
                "variant": name, "windows": C, "ms": cs.cuda_ms(run, 30),
                "max_abs_err": (got - ref).abs().max().item(),
                "phase_us_mean": dict(zip(phases, d.mean(0).round(3).tolist())),
                "window_us_max": float((a[:, -1] - a[:, 0]).max() / 1e3),
                "ptxas": ptxas}), flush=True)
        _build._lib = None
    return 0


if __name__ == "__main__":
    sys.exit(main())
