#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, holds
each kernel against its plain PyTorch version on the card, then drives
the main path — ``ginfinity-embed --window-size 120
--keep-paired-neighbors`` of the port — on a seeded corpus of about
23,000 windows with a seeded flagship checkpoint (6 x GINE-128,
GraphNorm, mean pool, zscore_l2 before pooling).

Each phase prints one JSON line with its name and seconds.  Before the
last line it prints the card's name and power limit (as nvidia-smi
gives them) and one JSON line of per-kernel numbers; the last line is
``{"ok": true, "device": {...}}``.  Any failure exits non-zero without
that line, and so does a machine without a CUDA device.  Imports only
the port, torch, numpy and the standard library.
"""

from __future__ import annotations

import contextlib
import csv
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# the checkout stays as git has it: the only files a run leaves are the
# built kernels under ginfinity_tpu_torch/_build/
sys.dont_write_bytecode = True

from ginfinity_tpu_torch.models.checkpoint import export_torch_checkpoint
from ginfinity_tpu_torch.models.gine import GINConfig, GINModel, init_params
from ginfinity_tpu_torch.ops import _build
from ginfinity_tpu_torch.ops.windows_encoder import (
    forward_windows,
    forward_windows_reference,
    pack_params,
)
from ginfinity_tpu_torch.pipelines import embed
from ginfinity_tpu_torch.pipelines.fast_windows import (
    _chunk_for,
    _embed_group,
    _pack_group,
    _prep_corpus_groups,
    _window_chunk,
    embed_corpus_windows,
)
from ginfinity_tpu_torch.utils.device import disable_tf32

WINDOW = 120
N_WINDOWS = 23_000         # the size of the bench corpus at L = 120
SAMPLE_WINDOWS = 512       # windows re-embedded through the plain path
TOL = 1e-4                 # max abs, kernel vs plain version, float32
F32_FLOPS = 67e12          # H100 SXM float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12  # H100 SXM memory rate
SEED = 0
DEVICE = torch.device("cuda", 0)

FLAGSHIP = dict(hidden_dim=128, output_dim=128, gin_layers=6,
                pooling_type="global_mean_pool", node_embed_norm="zscore_l2",
                norm_type="graph", use_residual=True,
                normalize_nodes_before_pool=True)

# the kernel against its plain version: (name, config, window length)
KERNEL_CASES = (
    ("flagship_L120", GINConfig.create(**FLAGSHIP), 120),
    ("flagship_L40", GINConfig.create(**FLAGSHIP), 40),
    ("widths_256_512x3_to_512",
     GINConfig.create(**{**FLAGSHIP, "hidden_dim": [256, 512, 512, 512],
                         "gin_layers": 4, "output_dim": 512}), 120),
    ("eps_1e-2_gin_eps_0.1",
     GINConfig.create(**{**FLAGSHIP, "eps": 1e-2, "gin_eps": 0.1}), 120),
    ("forgi_edges_7",
     GINConfig.create(**{**FLAGSHIP, "graph_encoding": "forgi"}), 120),
)


def random_structure(rng: np.random.Generator, n: int, p_stem: float = 0.75,
                     min_paired_frac: float = 0.3) -> str:
    """Valid dot-bracket of length ``n``: nested stems with hairpin
    loops of at least 3 nt and occasional multiloop branches, at least
    ``min_paired_frac`` paired (the generator of
    ``ginfinity_tpu/pipelines/msa_eval.py::random_structure``)."""

    def draw() -> str:
        out: list[str] = []

        def gen(m: int, depth: int) -> None:
            if m < 11 or rng.random() > p_stem * (0.9 ** depth):
                out.append("." * m)
                return
            if m >= 26 and rng.random() < 0.35:
                cut = int(rng.integers(11, m - 10))
                gen(cut, depth)
                gen(m - cut, depth)
                return
            h = int(rng.integers(2, min(6, (m - 5) // 2) + 1))
            lead = int(rng.integers(0, min(4, m - 2 * h - 3) + 1))
            tail = int(rng.integers(0, min(4, m - 2 * h - 3 - lead) + 1))
            out.append("." * lead + "(" * h)
            gen(m - 2 * h - lead - tail, depth + 1)
            out.append(")" * h + "." * tail)

        gen(n, 0)
        return "".join(out)

    for _ in range(100):
        s = draw()
        if (s.count("(") + s.count(")")) >= min_paired_frac * n:
            return s
    return s


def corpus(rng: np.random.Generator, n_windows: int, L: int) -> list[str]:
    """Structures of 150-350 nt until they hold ``n_windows`` windows."""
    out, total = [], 0
    while total < n_windows:
        s = random_structure(rng, int(rng.integers(150, 351)))
        out.append(s)
        total += len(s) - L + 1
    return out


def seeded_model(cfg: GINConfig, seed: int):
    """Random parameters with non-trivial node_mu / node_sigma."""
    g = torch.Generator().manual_seed(seed)
    params, state = init_params(g, cfg)
    h = cfg.hidden_dims[-1]
    # with a large eps, sigmas near 1e-3 make eps change the zscore
    scale = 1e-3 if cfg.eps >= 1e-3 else 1.0
    state["node_mu"] = 0.1 * torch.randn(h, generator=g)
    state["node_sigma"] = scale * (1.0 + 0.5 * torch.rand(h, generator=g))
    return params, state


def chunk_inputs(cfg, params, structures, L, dev, C=None):
    """The encoder's inputs for ``C`` windows spread over the largest
    length group of ``structures``, built by the main path's own code;
    ``C=None`` takes the chunk size the main path gives that group."""
    per, groups = _prep_corpus_groups(cfg, structures, L, True, 0.0)
    n_cap, idxs = max(groups.items(), key=lambda kv: sum(per[i][4].size for i in kv[1]))
    feats, pts, sidx, starts, w_cap = _pack_group(cfg, per, n_cap, idxs)
    n_real = sum(per[i][4].size for i in idxs)
    C = C or _chunk_for(w_cap)
    sel = np.linspace(0, n_real - 1, C).astype(np.int64)
    feats_d = torch.from_numpy(feats).to(dev)
    pts_d = torch.from_numpy(pts).to(dev, torch.int64)
    si = torch.from_numpy(sidx[sel]).to(dev, torch.int64)
    st = torch.from_numpy(starts[sel]).to(dev, torch.int64)
    return _window_chunk(cfg, params, feats_d, pts_d, si, st, L, True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, after one warm call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def encoder_bound_ms(cfg, x0, flags, packed, L: int) -> tuple[float, str]:
    """Least time for the encoder's work on these inputs: the products'
    float32 operations on the active rows (window rows + pulled slots)
    over the FMA rate, against the bytes of every input read once and
    the output written once over the memory rate."""
    rows = float(x0.shape[0] * L + flags[2].sum().item())
    ops = 0.0
    for i, dout in enumerate(cfg.hidden_dims):
        din = cfg.hidden_dims[i - 1] if i else cfg.hidden_dims[0]
        ops += 2.0 * rows * (din * dout + dout * dout)
    ops += 2.0 * x0.shape[0] * cfg.hidden_dims[-1] * cfg.output_dim
    nbytes = sum(t.numel() * t.element_size() for t in (x0, *flags, packed.flat, packed.meta))
    nbytes += x0.shape[0] * cfg.output_dim * 4
    t_ops, t_bytes = ops / F32_FLOPS, nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


@contextlib.contextmanager
def phase(name: str, record: dict):
    t0 = time.perf_counter()
    yield record
    print(json.dumps({"phase": name, "seconds": time.perf_counter() - t0, **record}),
          flush=True)


def card_name_and_limit() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    dev = DEVICE
    torch.cuda.set_device(dev)
    disable_tf32()
    card = card_name_and_limit()
    rng = np.random.default_rng(SEED)

    with phase("env", {}) as rec:
        rec.update(torch=torch.__version__, cuda=torch.version.cuda,
                   device=torch.cuda.get_device_name(0), card=card,
                   tf32_matmul=torch.backends.cuda.matmul.allow_tf32,
                   tf32_cudnn=torch.backends.cudnn.allow_tf32)

    with phase("build", {}) as rec:
        lib = _build.build_library()
        log = (lib.parent / "build.log").read_text()
        rec.update(library=os.path.relpath(lib, os.path.dirname(os.path.abspath(__file__))),
                   ptxas=[ln.strip() for ln in log.splitlines()
                          if "registers" in ln or "spill" in ln])

    errs = []
    with phase("kernel_vs_plain", {"tolerance": TOL}) as rec:
        structs = corpus(rng, 2000, 120)
        for name, cfg, L in KERNEL_CASES:
            m = GINModel(cfg, *seeded_model(cfg, SEED + 1)).to(dev)
            p, s = m.params, m.state
            x0, flags = chunk_inputs(cfg, p, structs, L, dev, C=64)
            got = forward_windows(cfg, p, s, x0, *flags, L)
            ref = forward_windows_reference(cfg, p, s, x0, *flags, L)
            torch.cuda.synchronize()
            err = (got - ref).abs().max().item()
            rec[name] = {"max_abs_err": err, "windows": x0.shape[0], "L": L}
            errs.append(err)
            if not (err <= TOL and torch.isfinite(got).all()):
                raise AssertionError(f"kernel vs plain {name}: max abs {err} > {TOL}")

    with tempfile.TemporaryDirectory() as tmp, phase("main_path", {"card": card}) as rec:
        cfg = GINConfig.create(**FLAGSHIP)
        params, state = seeded_model(cfg, SEED + 2)
        ckpt = os.path.join(tmp, "flagship.pth")
        export_torch_checkpoint(ckpt, cfg, params, state)
        structures = corpus(rng, N_WINDOWS, WINDOW)
        n_windows = sum(len(s) - WINDOW + 1 for s in structures)
        src = os.path.join(tmp, "corpus.csv")
        with open(src, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["rna_id", "secondary_structure"])
            w.writerows((f"rna{i}", s) for i, s in enumerate(structures))
        out = os.path.join(tmp, "windows.tsv")

        forward_windows.launches = 0
        t0 = time.perf_counter()
        embed.main(["--input", src, "--id-column", "rna_id", "--output", out,
                    "--model-path", ckpt, "--window-size", str(WINDOW),
                    "--keep-paired-neighbors", "--quiet"])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        launches = forward_windows.launches
        if launches <= 0:
            raise AssertionError("the main path launched no window-encoder kernel")

        with open(out, newline="") as f:
            rows = list(csv.DictReader(f, delimiter="\t"))
        if len(rows) != n_windows:
            raise AssertionError(f"TSV has {len(rows)} rows, expected {n_windows}")
        emb = {r["window_id"]: np.array(r["embedding_vector"].split(","), np.float32)
               for r in rows}
        if any(v.shape != (cfg.output_dim,) or not np.isfinite(v).all() for v in emb.values()):
            raise AssertionError("an embedding is not finite or not 128 wide")

        # a sample re-embedded through the plain torch encoder on the card
        model = GINModel(cfg, params, state).to(dev)
        order = np.random.default_rng(SEED + 3).permutation(len(structures))
        take, n = [], 0
        while n < SAMPLE_WINDOWS:
            take.append(int(order[len(take)]))
            n += len(structures[take[-1]]) - WINDOW + 1
        sub = [structures[i] for i in take]
        per, groups = _prep_corpus_groups(cfg, sub, WINDOW, True, 0.0)
        sample_err = 0.0
        for n_cap, idxs in groups.items():
            plain = _embed_group(model, per, n_cap, idxs, WINDOW, True, use_kernel=False)
            plain = plain.cpu().numpy()
            off = 0
            for i in idxs:
                for st in per[i][4]:
                    got = emb[f"rna{take[i]}_{int(st)}"]
                    sample_err = max(sample_err, float(np.abs(got - plain[off]).max()))
                    off += 1
        if sample_err > TOL:
            raise AssertionError(f"main path vs plain encoder: max abs {sample_err} > {TOL}")

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = embed_corpus_windows(model, structures, WINDOW, True)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        if sum(len(st) for st, _ in res) != n_windows:
            raise AssertionError("warm pass returned another window count")
        rec.update(structures=len(structures), windows=n_windows,
                   kernel_launches=launches, sample_windows=n,
                   sample_max_abs_err=sample_err, cli_seconds=cli_s,
                   cli_windows_per_s=n_windows / cli_s,
                   warm_embed_seconds=warm_s,
                   warm_embed_windows_per_s=n_windows / warm_s)

    with phase("kernel_timing", {"card": card}) as rec:
        p, s = model.params, model.state
        x0, flags = chunk_inputs(cfg, p, structures, WINDOW, dev)
        packed = pack_params(cfg, p, s)
        got = forward_windows(cfg, p, s, x0, *flags, WINDOW, packed=packed)
        ref = forward_windows_reference(cfg, p, s, x0, *flags, WINDOW)
        errs.append((got - ref).abs().max().item())
        ms = cuda_ms(lambda: forward_windows(cfg, p, s, x0, *flags, WINDOW, packed=packed), 50)
        plain_ms = cuda_ms(lambda: forward_windows_reference(cfg, p, s, x0, *flags, WINDOW), 20)
        bound_ms, bound_by = encoder_bound_ms(cfg, x0, flags, packed, WINDOW)
        rec.update(windows=x0.shape[0], L=WINDOW, ms=ms, plain_ms=plain_ms,
                   bound_ms=bound_ms, bound_by=bound_by,
                   max_abs_err=errs[-1])

    print(card)
    print(json.dumps({"kernels": [{
        "name": "windows_encoder",
        "route": "cuda",
        "source": "ginfinity_tpu_torch/ops/csrc/windows_encoder.cu",
        "replaces": "ginfinity_tpu/ops/pallas_windows.py:84",
        "launches": launches,
        "max_abs_err": max(errs),
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
