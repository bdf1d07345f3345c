#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, holds
each kernel against its plain PyTorch version on the card, then drives
the port's two paths with a seeded flagship checkpoint (6 x GINE-128,
GraphNorm, mean pool, zscore_l2):

* the window path, ``ginfinity-embed --window-size 120
  --keep-paired-neighbors``, on a seeded corpus of about 23,000 windows
  (kernel K1, the window encoder);
* the alignment path, ``ginfinity-generate-node-embeddings`` on 64
  seeded structures of 150-350 nt, then
  ``ginfinity-align-node-embeddings-batch`` over all 2,016 pairs and
  ``ginfinity-align-node-embeddings`` on one pair (kernel K2, the
  affine-gap DP wavefront);
* the graph path, ``ginfinity-embed`` without ``--window-size`` on 2,000
  seeded structures, ``ginfinity-compute-distances`` over all pairs of
  500 of them and with ``--top-k 10`` over all 2,000, and a warm
  ``TopKSearcher`` on a 200,000 x 128 corpus in four storage modes
  (torch products, no kernel of the port's own: it launches neither K1
  nor K2, and the phase fails if either counter moves);
* the model variants, at the flagship's width: a forgi flagship and the
  flagship with layer, instance or batch norm or with Set2Set pooling,
  each through ``ginfinity-embed`` on 500 seeded structures and with
  ``--window-size 120 --keep-paired-neighbors`` on about 2,000 windows
  (the forgi flagship's windows go through K1, the others' through the
  compact path, which launches no kernel of the port's own); the forgi
  flagship also through ``ginfinity-generate-node-embeddings`` on 32
  structures and through the two-step flow (the windows CLI, then
  ``embed --graph-pt`` on its ``.npz`` and its ``.pt``);
* the bf16 speed mode, ``--precision bf16``: the window path on the same
  corpus (K1's bf16 route), once alone and once with ``--bf16-check 512``,
  and once under ``--profile-dir`` (a ``torch.profiler`` trace, from which
  the card's busy share of the run is read); the graph path's 2,000
  structures at f32 and bf16 in turns; the layer-norm variant's windows
  (the compact path) at bf16.

Each phase prints one JSON line with its name and seconds.  The
``main_path`` line also splits the warm window pass (upload, window
build, K1, download, from CUDA events) and the CLI's host stages (CSV
read, checkpoint load, prep, TSV write); ``kernel_timing`` gives K1's
bound at the float32-accurate tensor-core rate (3xTF32) and, beside it,
at the FMA units' float32 rate, and times K2 on the route its wrapper
takes (``ms``, one warp per pair) beside its CTA route (``cta_ms``, one
CTA per pair) on the same inputs, in turns.  K2 is held to its plain
version on both routes (``dp_kernel_vs_plain``), and the align path
must take the warp route on every launch.  ``graph_path`` prints
structures/s, pairs/s, queries/s and recall@10 per storage mode, with the
embed CLI's host stages and each search's Gram, tile top-k and re-score
from CUDA events.  ``variants_path`` prints, per variant, structures/s
and windows/s with the CLIs' host stages, K1's launches, and the largest
difference of the card's embeddings from the port's CPU run on the same
inputs (and, for the two-step flow, from the fused window TSV).
``kernel_vs_plain`` also holds K1's bf16 route to the plain version at
bf16 (the same four rounding points) for each case, and ``bf16_path``
prints windows/s and structures/s at bf16 with each window's and each
structure's cosine against the f32 run, the CLI's own ``[bf16-check]``
numbers and the trace's busy share.  Before the last line it prints the card's name and power limit (as nvidia-smi
gives them) and one JSON line of per-kernel numbers; the last line is
``{"ok": true, "device": {...}}``.  Any failure exits non-zero without
that line, and so does a machine without a CUDA device.  Imports only
the port, torch, numpy and the standard library.
"""

from __future__ import annotations

import contextlib
import csv
import dataclasses
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# the checkout stays as git has it: the only files a run leaves are the
# built kernels under ginfinity_tpu_torch/_build/
sys.dont_write_bytecode = True

from ginfinity_tpu_torch.models.checkpoint import export_torch_checkpoint, load_checkpoint
from ginfinity_tpu_torch.models.gine import (
    GINConfig,
    GINModel,
    bf16_matmul_route,
    get_node_embeddings,
    init_params,
)
from ginfinity_tpu_torch.ops import _build
from ginfinity_tpu_torch.ops.dp import (
    dp_kernel_ok,
    pad_batch,
    paths_from_codes,
    wavefront_plain,
)
from ginfinity_tpu_torch.ops.dp_wavefront import (
    barrier_probe,
    dp_wavefront,
    launch,
    rectangle_mask,
    route,
    smem_limit,
)
from ginfinity_tpu_torch.ops.windows_encoder import (
    _library,
    forward_windows,
    forward_windows_reference,
    pack_params,
)
from ginfinity_tpu_torch.parallel.search import (
    TopKSearcher,
    _topk,
    brute_force_topk,
    recall_at_k,
)
from ginfinity_tpu_torch.pipelines import (
    align,
    align_batch,
    distances,
    embed,
    node_embed,
    windows,
)
from ginfinity_tpu_torch.pipelines.align import cosine_similarity_matrix
from ginfinity_tpu_torch.pipelines.engine import InferenceEngine, preprocess_structures
from ginfinity_tpu_torch.pipelines.fast_windows import (
    _chunk_for,
    _dense_forward_ok,
    _embed_group,
    _pack_group,
    _prep_corpus_groups,
    _window_chunk,
    embed_corpus_windows,
)
from ginfinity_tpu_torch.graphs.batching import _round_capacity, batch_graphs, bucket_sizes
from ginfinity_tpu_torch.utils.device import disable_tf32
from ginfinity_tpu_torch.utils.io import read_table, write_tsv

WINDOW = 120
N_WINDOWS = 23_000         # the size of the bench corpus at L = 120
SAMPLE_WINDOWS = 512       # windows re-embedded through the plain path
TOL = 1e-4                 # max abs, kernel vs plain version, float32
F32_FLOPS = 67e12          # H100 SXM float32 outside the tensor cores
# float32-accurate products on the tensor cores: 3xTF32, three TF32 passes
# at 495 TFLOP/s (the rate of K1's products, and the counterpart of the TPU
# kernel's Precision.HIGHEST)
TF32X3_FLOPS = 495e12 / 3
BF16_FLOPS = 989e12        # H100 SXM dense bf16 tensor-core rate (K1's bf16 route)
# K1's bf16 route against its plain version at bf16: a pooled row averages
# 120-162 rows, and a bf16 rounding flipped by float32 order moves one
# operand by at most 2^-9 relative; summing the same bf16 operands in
# float64 instead of float32 moved a CPU run by 2.2e-4 max abs (worst
# window cosine 0.9999982), so these bars leave about 10x and 5x of room
BF16_TOL = 2e-3
BF16_COS = 0.99999
# bf16 against f32, per window or structure: a mean cosine of 0.99995 was
# measured on the CPU (min 0.99972); the gate is on the mean
BF16_MEAN_COS = 0.99
BF16_CHECK = 512           # --bf16-check sample of the bf16 window run
HBM_BYTES_PER_S = 3.35e12  # H100 SXM memory rate
SEED = 0
DEVICE = torch.device("cuda", 0)
DP_GAPS = ((-1.0, -1.0), (-2.0, -0.5), (-10.0, -0.5), (-1.5, -0.3))
DP_TOL = 1e-4              # |score| kernel vs plain version (0 expected)
DP_OPS_PER_CELL = 10       # float32 adds and compares per DP cell
ALIGN_RNAS = 64            # structures of the alignment path: 2,016 pairs
ALIGN_BATCH = 64           # pairs per DP launch (the CLI's default)
GRAPH_RNAS = 2_000         # structures of the graph path (~500k nodes)
GRAPH_SAMPLE = 32          # of them re-embedded on the CPU
PAIRS_RNAS = 500           # rows of the all-pairs run: 124,750 pairs
TOP_K = 10
# the warm search, at the size of bench.py's measure_search_quick
SEARCH_ROWS, SEARCH_DIM, SEARCH_QUERIES = 200_000, 128, 1_024
# recall@10 bars of tests/test_search.py: exact f32 modes 1.0, int8 with the
# device re-score 1.0, bf16 storage with the device re-score 0.99
SEARCH_MODES = (("f32", {}, 1.0), ("f32_host_merge", {"rescore": "host"}, 1.0),
                ("bf16_storage", {"storage": "bf16"}, 0.99),
                ("int8_storage", {"storage": "int8"}, 1.0))
DIST_REL = 1e-5            # all-pairs distances against float64 numpy
VARIANT_RNAS = 500         # structures of each variant's graph mode
VARIANT_WINDOWS = 2_000    # windows of each variant's window mode
VARIANT_SAMPLE = 16        # structures of a variant re-embedded on the CPU
NODE_RNAS = 32             # structures of the forgi node-embedding run

FLAGSHIP = dict(hidden_dim=128, output_dim=128, gin_layers=6,
                pooling_type="global_mean_pool", node_embed_norm="zscore_l2",
                norm_type="graph", use_residual=True,
                normalize_nodes_before_pool=True)

# the variants of the flagship: (name, the change to FLAGSHIP)
VARIANTS = (
    ("forgi", {"graph_encoding": "forgi"}),
    ("layer_norm", {"norm_type": "layer"}),
    ("instance_norm", {"norm_type": "instance"}),
    ("batch_norm", {"norm_type": "batch"}),
    ("set2set", {"pooling_type": "set2set"}),
)

# one long stem: the windows over its opening strand have every slot
# pulled (2L = 240 active rows), more than shared memory holds
ALL_PULLED = ("(" * 130 + "." * 8 + ")" * 130,)

# the kernel against its plain version: (name, config, window length,
# structures or None for the seeded corpus)
KERNEL_CASES = (
    ("flagship_L120", GINConfig.create(**FLAGSHIP), 120, None),
    ("flagship_L40", GINConfig.create(**FLAGSHIP), 40, None),
    ("widths_256_512x3_to_512",
     GINConfig.create(**{**FLAGSHIP, "hidden_dim": [256, 512, 512, 512],
                         "gin_layers": 4, "output_dim": 512}), 120, None),
    ("eps_1e-2_gin_eps_0.1",
     GINConfig.create(**{**FLAGSHIP, "eps": 1e-2, "gin_eps": 0.1}), 120, None),
    ("forgi_edges_7",
     GINConfig.create(**{**FLAGSHIP, "graph_encoding": "forgi"}), 120, None),
    ("flagship_L120_all_pulled", GINConfig.create(**FLAGSHIP), 120, ALL_PULLED),
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


def encoder_bound_ms(cfg, x0, flags, packed, L: int,
                     rate: float = TF32X3_FLOPS) -> tuple[float, str, float]:
    """Least time for the encoder's work on these inputs: the products'
    operations on the active rows (window rows + pulled slots) at the
    route's tensor-core rate (``rate``: 3xTF32 for the float32-accurate
    route, BF16_FLOPS for the bf16 route), against the bytes of every
    input read once and the output written once over the memory rate.
    Also the same operations at the FMA units' float32 rate (a second
    figure, not the bound)."""
    rows = float(x0.shape[0] * L + flags[2].sum().item())
    ops = 0.0
    for i, dout in enumerate(cfg.hidden_dims):
        din = cfg.hidden_dims[i - 1] if i else cfg.hidden_dims[0]
        ops += 2.0 * rows * (din * dout + dout * dout)
    ops += 2.0 * x0.shape[0] * cfg.hidden_dims[-1] * cfg.output_dim
    nbytes = sum(t.numel() * t.element_size() for t in (x0, *flags, packed.flat, packed.meta))
    nbytes += x0.shape[0] * cfg.output_dim * 4
    t_ops, t_bytes = ops / rate, nbytes / HBM_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"),
            1e3 * max(ops / F32_FLOPS, t_bytes))


def warm_split(model, structures, L: int) -> dict:
    """The warm window pass again, stage by stage: host prep and packing on
    the host clock; per group the upload, per chunk the window build
    (``_window_chunk``) and K1, per group the download, each summed from
    CUDA events.  An event span includes the device's wait for the host
    to enqueue the stage, so the host's enqueue time of the window build
    and of K1 is given beside it (``*_host_s``)."""
    cfg, dev = model.config, model.device
    t0 = time.perf_counter()
    per, groups = _prep_corpus_groups(cfg, structures, L, True, 0.0)
    prep_s = time.perf_counter() - t0
    packed = model.packed_windows()
    spans = {"upload": [], "window_build": [], "k1": [], "download": []}
    pack_s, build_host_s, k1_host_s, n_chunks = 0.0, 0.0, 0.0, 0

    def mark():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    for n_cap, idxs in groups.items():
        t0 = time.perf_counter()
        feats, pts, sidx, starts, w_cap = _pack_group(cfg, per, n_cap, idxs)
        n_real = sum(per[i][4].size for i in idxs)
        pack_s += time.perf_counter() - t0
        e0 = mark()
        feats_d = torch.from_numpy(feats).to(dev)
        pts_d = torch.from_numpy(pts).to(dev, torch.int64)
        si = torch.from_numpy(sidx[:n_real]).to(dev, torch.int64)
        st = torch.from_numpy(starts[:n_real]).to(dev, torch.int64)
        spans["upload"].append((e0, mark()))
        views = (feats_d.unfold(1, L, 1), pts_d.unfold(1, L, 1))
        chunk = _chunk_for(w_cap)
        out = torch.empty((n_real, cfg.output_dim), dtype=torch.float32, device=dev)
        for c0 in range(0, n_real, chunk):
            t0 = time.perf_counter()
            e0 = mark()
            x0, flags = _window_chunk(cfg, model.params, feats_d, pts_d, si[c0:c0 + chunk],
                                      st[c0:c0 + chunk], L, True, views)
            e1 = mark()
            t1 = time.perf_counter()
            out[c0:c0 + chunk] = forward_windows(cfg, model.params, model.state, x0, *flags, L,
                                                 packed=packed)
            spans["window_build"].append((e0, e1))
            spans["k1"].append((e1, mark()))
            build_host_s += t1 - t0
            k1_host_s += time.perf_counter() - t1
            n_chunks += 1
        e0 = mark()
        out.cpu()
        spans["download"].append((e0, mark()))
    torch.cuda.synchronize()
    res = {f"{k}_ms": sum(a.elapsed_time(b) for a, b in v) for k, v in spans.items()}
    res.update(host_prep_s=prep_s, host_pack_s=pack_s, window_build_host_s=build_host_s,
               k1_host_s=k1_host_s, chunks=n_chunks, groups=len(groups))
    return res


def cli_host_split(src: str, ckpt: str, out_tsv: str, structures, L: int, dev) -> dict:
    """The window CLI's host stages again, each on the host clock: CSV read,
    checkpoint load (and the model's upload), prep (pair tables, window
    features, grouping) and the TSV write of the embeddings (text
    formatting included)."""
    t0 = time.perf_counter()
    table = read_table(src)
    t1 = time.perf_counter()
    cfg, params, state, _ = load_checkpoint(ckpt)
    model = GINModel(cfg, params, state).to(dev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    _prep_corpus_groups(cfg, structures, L, True, 0.0)
    t3 = time.perf_counter()
    res = embed_corpus_windows(model, structures, L, True)
    ids = table.column("rna_id")
    t4 = time.perf_counter()
    rows = [{"window_id": f"{rid}_{start}", "rna_id": rid, "window_start": start,
             "window_end": start + L - 1, "seq_len": len(st),
             "embedding_vector": embed.format_embedding(vec)}
            for rid, st, (starts, embs) in zip(ids, structures, res)
            for start, vec in zip(starts.tolist(), embs)]
    write_tsv(out_tsv, list(rows[0]), rows)
    t5 = time.perf_counter()
    return {"csv_read_s": t1 - t0, "checkpoint_load_s": t2 - t1, "prep_s": t3 - t2,
            "tsv_write_s": t5 - t4}


def dp_tensors(mats, dev, L1=None, L2=None):
    """A batch of score matrices padded as ``affine_align_batch`` pads it,
    on ``dev``, with the real sides also on the host."""
    scores, l1, l2 = pad_batch(mats, L1, L2)
    return (torch.from_numpy(scores).to(dev), torch.from_numpy(l1).to(dev),
            torch.from_numpy(l2).to(dev), l1, l2)


def dp_compare(mats, go, ge, mode, dev, both=False) -> tuple[float, list, str]:
    """K2 against the plain wavefront on the same batch on the card, on
    the route the wrapper chooses and, with ``both``, on the CTA route
    too when the wrapper chose the warp route: identical paths, best
    cells and codes on every pair's rectangle, |score| within DP_TOL.
    Returns the max score difference, the plain version's (score, path)
    per pair and the route the wrapper took (read from the launch
    counts)."""
    s, l1d, l2d, l1, l2 = dp_tensors(mats, dev)
    n, n_warp = dp_wavefront.launches, dp_wavefront.warp_launches
    runs = [dp_wavefront(s, l1d, l2d, go, ge, mode)]
    took = "warp" if dp_wavefront.warp_launches > n_warp else "cta"
    if dp_wavefront.launches != n + 1 or took != route(s.shape[1])[0]:
        raise AssertionError(f"K2 took the {took} route at L1 = {s.shape[1]}")
    if both and took == "warp":
        runs.append(launch(("cta", 0), s, l1d, l2d, go, ge, mode))
    ref = [t.cpu().numpy() for t in wavefront_plain(s, l1d, l2d, go, ge, mode)]
    real = rectangle_mask(l1, l2, *s.shape[1:])
    paths = paths_from_codes(ref[3], l1, l2, ref[1], ref[2], mode)
    errs = []
    for rte, out in zip((took, "cta"), runs):
        got = [t.cpu().numpy() for t in out]
        err = float(np.abs(got[0] - ref[0]).max())
        what = f"K2 ({rte}) vs plain ({mode}, {go}, {ge}, L1 = {s.shape[1]})"
        if not (err <= DP_TOL and np.isfinite(got[0]).all()):
            raise AssertionError(f"{what}: |score| {err} > {DP_TOL}")
        if not (np.array_equal(got[1], ref[1]) and np.array_equal(got[2], ref[2])):
            raise AssertionError(f"{what}: best cells differ")
        if not np.array_equal(got[3][real], ref[3][real]):
            raise AssertionError(f"{what}: codes differ on a pair's rectangle")
        if paths != paths_from_codes(got[3], l1, l2, got[1], got[2], mode):
            raise AssertionError(f"{what}: paths differ")
        errs.append(err)
    return max(errs), list(zip(ref[0].tolist(), paths)), took


def dp_cases(rng: np.random.Generator, max_l1: int) -> dict:
    """The inputs K2 is held to its plain version on: seeded normal
    matrices with sides 3-384, integer-valued matrices (ties everywhere),
    the rectangular extremes 3x37 and 31x4, all-negative matrices (local
    mode: an empty path), one pair near the gate's upper limit, and
    normal matrices padded to each warp-route width from R = 4 to 16
    rows a lane."""
    f32 = np.float32
    sides = [(3, 384), (384, 3), (384, 384)] + [
        (int(rng.integers(3, 385)), int(rng.integers(3, 385))) for _ in range(13)]
    cases = {
        "normal_3_384": [rng.normal(size=sz).astype(f32) for sz in sides],
        "integer_ties": [rng.integers(-2, 3, size=(int(rng.integers(20, 200)),
                                                   int(rng.integers(20, 200)))).astype(f32)
                         for _ in range(4)],
        "rect_3x37_31x4": [rng.normal(size=(3, 37)).astype(f32),
                           rng.normal(size=(31, 4)).astype(f32)],
        "all_negative": [np.full((8, 11), -2.0, f32),
                         -np.abs(rng.normal(size=(40, 25))).astype(f32)],
        f"near_gate_{max_l1}x8": [rng.normal(size=(max_l1, 8)).astype(f32)],
    }
    for rows in (100, 170, 240, 300, 360, 500):  # R = 4, 6, 8, 10, 12, 16
        sz = [(rows, int(rng.integers(rows // 2, rows + 40))),
              (int(rng.integers(3, rows)), int(rng.integers(3, rows + 40)))]
        cases[f"normal_{rows}_rows"] = [rng.normal(size=z).astype(f32) for z in sz]
    return cases


def dp_bounds(l1: np.ndarray, l2: np.ndarray) -> tuple[float, str, float]:
    """Least time for K2's work on these pairs: the scores its cells read
    (each real cell once) and the codes it must write (one byte for each
    cell of each pair's rectangle, the only codes it specifies) over the
    memory rate, against DP_OPS_PER_CELL float32 operations per real
    cell over the float32 rate."""
    cells = float(((l1.astype(np.int64) + 1) * (l2.astype(np.int64) + 1)).sum())
    nbytes = 4.0 * float((l1.astype(np.int64) * l2).sum()) + cells
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, cells * DP_OPS_PER_CELL / F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes


def ptxas_summary(log: str) -> dict:
    """ptxas's registers, stack and spills of every kernel in ``build.log``,
    by kernel; the warp route's instantiations as ``dp_warp_kernel<R,
    global|local>``, K1's routes as ``windows_encoder_kernel<3xtf32|bf16>``."""
    out = {}
    for name, props, used in re.findall(
            r"Function properties for (\S+)\n\s*(.*)\nptxas info\s*: (Used .*)", log):
        m = re.search(r"(\w+_kernel)(?:ILi(\d+)ELb([01])E|ILb([01])E)?E", name)
        short = re.sub(r"^.*\d", "", m.group(1)) if m else name
        if m and m.group(2):
            short += f"<{m.group(2)}, {'local' if m.group(3) == '1' else 'global'}>"
        elif m and m.group(4):
            short += "<bf16>" if m.group(4) == "1" else "<3xtf32>"
        out[short] = f"{used.strip()}; {props.strip()}"
    return out


def graph_embed_split(src: str, ckpt: str, out_tsv: str, dev) -> dict:
    """The embed CLI's work again, stage by stage on the host clock: CSV
    read, checkpoint load, graph build, then per planned batch the host's
    padding and ``forward_once`` (upload and model; a CUDA event span over
    all batches beside it), the one download, and the TSV text."""
    t0 = time.perf_counter()
    table = read_table(src)
    t1 = time.perf_counter()
    eng = InferenceEngine.from_checkpoint(ckpt, device=dev)
    t2 = time.perf_counter()
    graphs = preprocess_structures(table.column("secondary_structure"),
                                   graph_encoding=eng.config.graph_encoding,
                                   feature_dim=eng.config.node_feature_dim).graphs
    t3 = time.perf_counter()
    batch_s, parts, order = 0.0, [], []
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    t4 = time.perf_counter()
    for idxs in eng._plan(graphs):
        tb = time.perf_counter()
        chunk = [graphs[i] for i in idxs]
        batch = batch_graphs(chunk, *bucket_sizes(sum(g.n_nodes for g in chunk),
                                                  sum(g.n_edges for g in chunk)),
                             _round_capacity(len(chunk)))
        batch_s += time.perf_counter() - tb
        parts.append(eng.model.forward_once(batch)[: len(idxs)])
        order += idxs
    end.record()
    torch.cuda.synchronize()
    t5 = time.perf_counter()
    emb = np.zeros((len(graphs), eng.config.output_dim), np.float32)
    emb[order] = torch.cat(parts).cpu().numpy()
    t6 = time.perf_counter()
    rows = [{"rid": r["rid"], "embedding_vector": embed.format_embedding(e)}
            for r, e in zip(table.rows, emb)]
    write_tsv(out_tsv, ["rid", "embedding_vector"], rows)
    t7 = time.perf_counter()
    return dict(csv_read_s=t1 - t0, checkpoint_load_s=t2 - t1, graph_build_s=t3 - t2,
                batches=len(parts), batch_pad_host_s=batch_s,
                forward_s=t5 - t4 - batch_s, forward_device_span_ms=start.elapsed_time(end),
                download_s=t6 - t5, tsv_write_s=t7 - t6)


def check_top_k(rows: list, emb: np.ndarray, k: int) -> dict:
    """The top-k CLI's rows against float64 distances: each query has its k
    nearest rows, the distances agree with float64 within 1e-5 (|q|^2 +
    |c|^2), and where a neighbour differs from ``brute_force_topk``'s the
    two lie within that tolerance of each other (a near-tie)."""
    e64 = emb.astype(np.float64)
    sq = np.sum(e64 * e64, axis=1)
    d64 = sq[:, None] - 2 * e64 @ e64.T + sq[None, :]
    _, ref = brute_force_topk(emb, emb, k + 1)
    got: dict = {}
    for r in rows:
        got.setdefault(int(r["rid_1"][3:]), []).append((int(r["rid_2"][3:]),
                                                         float(r["distance"])))
    if sorted(got) != list(range(len(emb))) or any(len(v) != k for v in got.values()):
        raise AssertionError("top-k CLI: a query without its k neighbours")
    swaps, worst = 0, 0.0
    for q, nb in got.items():
        ids = [c for c, _ in nb]
        ref_ids = [c for c in ref[q] if c != q][:k]
        for (c, d), rc in zip(nb, ref_ids):
            tol = 1e-5 * (sq[q] + max(sq[c], sq[rc]))
            worst = max(worst, abs(d - d64[q, c]) / tol)
            if abs(d - d64[q, c]) > tol or c == q:
                raise AssertionError(f"top-k CLI: query {q}, neighbour {c}: {d} vs {d64[q, c]}")
            if c != rc:
                swaps += 1
                if abs(d64[q, c] - d64[q, rc]) > tol:
                    raise AssertionError(f"top-k CLI: query {q} has {ids}, brute force "
                                         f"{ref_ids}, and they are no near-tie")
    return dict(top_k_pairs=len(rows), top_k_near_tie_swaps=swaps,
                top_k_max_err_over_tol=worst)


def search_run(corpus: np.ndarray, queries: np.ndarray, truth: np.ndarray, dev, **kw) -> dict:
    """A warm ``TopKSearcher`` search: queries/s on the host clock (the
    search returns host arrays), recall@k, and the first query block split
    by CUDA events into the Gram over all tiles, the tiles' top-k, the
    float32 re-score (compressed storage) and the rest (merges, copies)."""
    k = truth.shape[1]
    t0 = time.perf_counter()
    s = TopKSearcher(corpus, device=dev, **kw)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    s.search(queries, k)
    t0 = time.perf_counter()
    _, ids = s.search(queries, k)
    search_s = time.perf_counter() - t0
    with torch.no_grad():
        q = torch.from_numpy(queries[: s.query_block]).to(dev)
        n_tiles = s._corpus.shape[0] // s.corpus_tile
        block_ms = cuda_ms(lambda: s._search_block(q, k), 5)
        q_mat, q_scale = s._query_matrix(q)
        gram_ms = n_tiles * cuda_ms(lambda: s._gram(q_mat, q_scale, 0, s.corpus_tile), 10)
        scores = s._gram(q_mat, q_scale, 0, s.corpus_tile)
        row_ids = torch.arange(s.corpus_tile, device=dev)
        k_tile = s._k_tile(k) if (s._f32_fast or s._dev_rescore) else k
        select_ms = n_tiles * cuda_ms(lambda: _topk(scores, row_ids, k_tile), 10)
        rescore_ms = 0.0
        if s._dev_rescore:
            cv, ci = s._scan(q, k_tile)
            rescore_ms = cuda_ms(lambda: s._refine(q, cv, ci, k), 10)
    nq = queries.shape[0]
    return dict(queries=nq, k=k, tiles=n_tiles, corpus_tile=s.corpus_tile, build_s=build_s,
                search_s=search_s, queries_per_s=nq / search_s,
                recall_at_k=recall_at_k(ids, truth), block_ms=block_ms, gram_ms=gram_ms,
                tile_topk_ms=select_ms, rescore_ms=rescore_ms,
                rest_ms=block_ms - gram_ms - select_ms - rescore_ms,
                gram_at_f32_fma_rate_ms=1e3 * 2.0 * q.shape[0] * s.n * s.dim / F32_FLOPS)


def graph_path(tmp: str, cfg, dev) -> dict:
    """Whole-structure embeddings, all-pairs distances, the top-k CLI and a
    warm search, through the port's entry points; returns the phase's
    record.  Launches neither K1 nor K2."""
    rng = np.random.default_rng(SEED + 5)
    rnas = [random_structure(rng, int(rng.integers(150, 351))) for _ in range(GRAPH_RNAS)]
    params, state = seeded_model(cfg, SEED + 5)
    ckpt = os.path.join(tmp, "flagship.pth")
    export_torch_checkpoint(ckpt, cfg, params, state)
    src = write_csv(os.path.join(tmp, "structures.csv"), "rid", rnas)
    out = os.path.join(tmp, "graphs.tsv")
    rec = dict(structures=GRAPH_RNAS, nodes=sum(len(s) for s in rnas))

    forward_windows.launches = dp_wavefront.launches = wavefront_plain.launches = 0
    dp_wavefront.warp_launches = 0
    t0 = time.perf_counter()
    embed.main(["--input", src, "--id-column", "rid", "--output", out, "--model-path", ckpt,
                "--quiet", "--device", str(dev)])
    torch.cuda.synchronize()
    rec.update(embed_cli_seconds=time.perf_counter() - t0)
    rec["structures_per_s"] = GRAPH_RNAS / rec["embed_cli_seconds"]

    with open(out, newline="") as f:
        rows = list(csv.DictReader(f, delimiter="\t"))
    emb = distances.parse_embedding_column([r["embedding_vector"] for r in rows])
    if [r["rid"] for r in rows] != [f"rna{i}" for i in range(GRAPH_RNAS)]:
        raise AssertionError("graph TSV: rows missing or out of order")
    if emb.shape != (GRAPH_RNAS, cfg.output_dim) or not np.isfinite(emb).all():
        raise AssertionError(f"graph TSV: embeddings of shape {emb.shape} or not finite")
    take = np.random.default_rng(SEED + 6).choice(GRAPH_RNAS, GRAPH_SAMPLE, replace=False)
    cpu = InferenceEngine.from_checkpoint(ckpt, device="cpu").embed_graphs(
        preprocess_structures([rnas[i] for i in take]).graphs)
    rec["sample_max_abs_err_vs_cpu"] = float(np.abs(cpu - emb[take]).max())
    if rec["sample_max_abs_err_vs_cpu"] > TOL:
        raise AssertionError(f"graph embeddings vs the CPU: max abs "
                             f"{rec['sample_max_abs_err_vs_cpu']} > {TOL}")
    rec["embed_split"] = graph_embed_split(src, ckpt, os.path.join(tmp, "split.tsv"), dev)

    # all pairs of the first rows, through the distances CLI
    pairs_in = os.path.join(tmp, "pairs_in.tsv")
    with open(out) as f, open(pairs_in, "w") as g:
        g.writelines(line for _, line in zip(range(PAIRS_RNAS + 1), f))
    pairs_out = os.path.join(tmp, "pairs.tsv")
    said = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(said):
        distances.main(["--input", pairs_in, "--output", pairs_out, "--id-column", "rid",
                        "--device", str(dev)])
    all_pairs_s = time.perf_counter() - t0
    n_pairs = PAIRS_RNAS * (PAIRS_RNAS - 1) // 2
    if f"Finished processing {n_pairs} pairs." not in said.getvalue():
        raise AssertionError(f"distances CLI said {said.getvalue()!r}")
    with open(pairs_out, newline="") as f:
        prow = list(csv.DictReader(f, delimiter="\t"))
    i1, i2 = distances.all_pairs_indices(PAIRS_RNAS)
    if len(prow) != n_pairs or [(r["rid_1"], r["rid_2"]) for r in prow[:3]] != \
            [(f"rna{a}", f"rna{b}") for a, b in zip(i1[:3], i2[:3])]:
        raise AssertionError("all-pairs TSV: wrong rows")
    sel = np.random.default_rng(SEED + 7).choice(n_pairs, min(n_pairs, 2_000), replace=False)
    d = np.array([float(prow[j]["distance"]) for j in sel])
    e64 = emb[:PAIRS_RNAS].astype(np.float64)
    d64 = np.sum((e64[i1[sel]] - e64[i2[sel]]) ** 2, axis=1)
    rel = np.abs(d - d64) / np.maximum(d64, 1e-30)
    rec.update(pairs=n_pairs, all_pairs_seconds=all_pairs_s, pairs_per_s=n_pairs / all_pairs_s,
               pairs_checked=len(sel), pairs_max_rel_err=float(rel.max()))
    if not (np.isfinite(d).all() and rel.max() <= DIST_REL):
        raise AssertionError(f"all-pairs distances vs float64: relative {rel.max()} > {DIST_REL}")
    t0 = time.perf_counter()
    table = read_table(pairs_in, sep="\t")
    t1 = time.perf_counter()
    pe = distances.parse_embedding_column(table.column("embedding_vector"))
    t2 = time.perf_counter()
    distances.pair_distances(pe, i1, i2, device=dev)
    t3 = time.perf_counter()
    rec["all_pairs_split"] = dict(tsv_read_s=t1 - t0, parse_s=t2 - t1, device_s=t3 - t2,
                                  tsv_write_s_by_difference=all_pairs_s - (t3 - t0))

    # the nearest rows of every row, through the CLI's --top-k
    topk_out = os.path.join(tmp, "topk.tsv")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        distances.main(["--input", out, "--output", topk_out, "--id-column", "rid",
                        "--top-k", str(TOP_K), "--device", str(dev)])
    rec["top_k_cli_seconds"] = time.perf_counter() - t0
    with open(topk_out, newline="") as f:
        rec.update(check_top_k(list(csv.DictReader(f, delimiter="\t")), emb, TOP_K))

    # a warm search of a corpus as bench.py's measure_search_quick builds it
    srng = np.random.default_rng(SEED + 8)
    corpus = srng.normal(size=(SEARCH_ROWS, SEARCH_DIM)).astype(np.float32)
    queries = corpus[srng.integers(0, SEARCH_ROWS, size=SEARCH_QUERIES)] + \
        0.05 * srng.normal(size=(SEARCH_QUERIES, SEARCH_DIM)).astype(np.float32)
    c64 = torch.from_numpy(corpus).to(dev, torch.float64)
    q64 = torch.from_numpy(queries).to(dev, torch.float64)
    d = (q64 * q64).sum(1)[:, None] - 2.0 * q64 @ c64.T + (c64 * c64).sum(1)[None, :]
    truth = torch.topk(d, TOP_K, dim=1, largest=False).indices.cpu().numpy()
    del c64, q64, d
    rec["search"] = {}
    for name, kw, bar in SEARCH_MODES:
        res = search_run(corpus, queries, truth, dev, **kw)
        rec["search"][name] = res
        if res["recall_at_k"] < bar:
            raise AssertionError(f"search {name}: recall@{TOP_K} {res['recall_at_k']} < {bar}")
    torch.cuda.synchronize()
    rec.update(window_kernel_launches=forward_windows.launches,
               dp_kernel_launches=dp_wavefront.launches,
               plain_dp_launches=wavefront_plain.launches)
    if forward_windows.launches or dp_wavefront.launches or wavefront_plain.launches:
        raise AssertionError("the graph path launched K1 or K2")
    return rec


def variant_model(cfg: GINConfig, seed: int):
    """``seeded_model``, with norm affines away from 1 and 0 and batch-norm
    running statistics away from 0 and 1."""
    params, state = seeded_model(cfg, seed)
    g = torch.Generator().manual_seed(seed + 1)
    params["norms"] = [{k: v + 0.2 * torch.randn(v.shape, generator=g) for k, v in n.items()}
                       for n in params["norms"]]
    for bn in state.get("batch_norms", []):
        bn["running_mean"] = 0.3 * torch.randn(bn["running_mean"].shape, generator=g)
        bn["running_var"] = 0.5 + torch.rand(bn["running_var"].shape, generator=g)
    return params, state


def write_csv(path: str, id_col: str, structures) -> str:
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow([id_col, "secondary_structure"])
        w.writerows((f"rna{i}", s) for i, s in enumerate(structures))
    return path


def read_vectors(path: str, key: str) -> dict:
    """``key`` -> embedding of each row of an embedding TSV."""
    with open(path, newline="") as f:
        return {r[key]: np.array(r["embedding_vector"].split(","), np.float32)
                for r in csv.DictReader(f, delimiter="\t")}


def quiet_main(fn, argv) -> float:
    """Seconds of one CLI run, its prints held back, the card drained."""
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        fn(argv)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def batch_as(batch, dtype):
    """``batch`` with its float tensors in ``dtype``."""
    return dataclasses.replace(batch, **{k: getattr(batch, k).to(dtype) for k in (
        "node_feat", "node_mask", "base_mask", "edge_attr", "edge_mask")})


def check_err(what: str, err: float, tol: float = TOL) -> float:
    if not err <= tol:
        raise AssertionError(f"{what}: max abs {err} > {tol}")
    return err


def forgi_extras(tmp: str, ckpt: str, cfg, rnas, win_csv: str, fused: dict, dev) -> dict:
    """The forgi flagship's node embeddings (base rows only) and the
    two-step window flow, both against the port's own references."""
    rec = {}
    src = write_csv(os.path.join(tmp, "nodes_in.csv"), "rid", rnas[:NODE_RNAS])
    nodes = os.path.join(tmp, "forgi_nodes.tsv")
    rec["node_embed_seconds"] = quiet_main(node_embed.main, [
        "--input", src, "--id-column", "rid", "--output", nodes, "--model-path", ckpt,
        "--quiet", "--device", str(dev)])
    with open(nodes, newline="") as f:
        mats = [node_embed.parse_matrix(r["node_embeddings"])
                for r in csv.DictReader(f, delimiter="\t")]
    if [m.shape for m in mats] != [(len(s), cfg.hidden_dims[-1]) for s in rnas[:NODE_RNAS]]:
        raise AssertionError("forgi node embeddings: not one row per base")
    # unit rows of a 6-layer GraphNorm stack, not averaged by a pool: the
    # float32 order of the CPU and of the card differ by more than 1e-4,
    # so a float64 run on the CPU breaks the tie (as the CPU tests do)
    graphs = preprocess_structures(rnas[:4], graph_encoding="forgi",
                                   feature_dim=cfg.node_feature_dim).graphs
    batch = batch_graphs(graphs)
    base = batch.base_mask.numpy() > 0
    got = np.concatenate(mats[:4])
    _, params, state, _ = load_checkpoint(ckpt)
    ref = {}
    for dt in (torch.float32, torch.float64):
        m = GINModel(cfg, params, state).to(dt)
        ref[dt] = get_node_embeddings(cfg, m.params, m.state, batch_as(batch, dt)).numpy()[base]
    r32, r64 = ref[torch.float32], ref[torch.float64]
    rec.update(node_max_abs_err_vs_cpu=float(np.abs(got - r32).max()),
               node_card_vs_float64=float(np.abs(got - r64).max()),
               node_cpu_vs_float64=float(np.abs(r32 - r64).max()))
    if not (rec["node_max_abs_err_vs_cpu"] <= TOL or
            rec["node_card_vs_float64"] <= 2 * rec["node_cpu_vs_float64"] + 1e-6):
        raise AssertionError(f"forgi node embeddings: {rec['node_card_vs_float64']} from "
                             f"float64 on the card, {rec['node_cpu_vs_float64']} on the CPU")

    wdir = os.path.join(tmp, "windows")
    t0 = time.perf_counter()
    windows.main(["--input", win_csv, "--id-column", "rna_id", "--L", str(WINDOW),
                  "--keep-paired-neighbors", "--format", "both", "--quiet",
                  "--output-dir", wdir])
    rec["windows_cli_seconds"] = time.perf_counter() - t0
    launches = forward_windows.launches
    for fmt in ("npz", "pt"):
        out = os.path.join(tmp, f"two_step_{fmt}.tsv")
        rec[f"graph_pt_{fmt}_seconds"] = quiet_main(embed.main, [
            "--graph-pt", os.path.join(wdir, f"windows_graphs.{fmt}"),
            "--meta-tsv", os.path.join(wdir, "windows_metadata.tsv"), "--id-column", "rna_id",
            "--model-path", ckpt, "--output", out, "--device", str(dev)])
        two = read_vectors(out, "window_id")
        if two.keys() != fused.keys():
            raise AssertionError(f"two-step flow ({fmt}): other windows than the fused path")
        rec[f"graph_pt_{fmt}_max_abs_err_vs_fused"] = check_err(
            f"two-step flow ({fmt}) vs the fused window path",
            max(float(np.abs(two[k] - fused[k]).max()) for k in fused))
    if forward_windows.launches != launches:
        raise AssertionError("embed --graph-pt launched K1")
    return rec


def variant_corpora() -> tuple[list, list]:
    """The variants' seeded structures (graph mode) and window corpus."""
    rng = np.random.default_rng(SEED + 9)
    rnas = [random_structure(rng, int(rng.integers(150, 351))) for _ in range(VARIANT_RNAS)]
    return rnas, corpus(rng, VARIANT_WINDOWS, WINDOW)


def variants_path(tmp: str, dev) -> dict:
    """Each variant of the flagship through the embed CLI's graph and window
    modes; the forgi flagship also through node embeddings and the
    two-step window flow.  Returns the phase's record."""
    rnas, structs = variant_corpora()
    n_windows = sum(len(s) - WINDOW + 1 for s in structs)
    graph_csv = write_csv(os.path.join(tmp, "structures.csv"), "rid", rnas)
    win_csv = write_csv(os.path.join(tmp, "corpus.csv"), "rna_id", structs)
    take = np.random.default_rng(SEED + 10).choice(VARIANT_RNAS, VARIANT_SAMPLE, replace=False)
    sub, k = [], 0
    while sum(len(s) - WINDOW + 1 for s in sub) < 64:
        sub.append(structs[k])
        k += 1
    rec = dict(structures=VARIANT_RNAS, nodes=sum(len(s) for s in rnas),
               window_structures=len(structs), windows=n_windows)
    for name, change in VARIANTS:
        cfg = GINConfig.create(**{**FLAGSHIP, **change})
        params, state = variant_model(cfg, SEED + 11)
        ckpt = os.path.join(tmp, f"{name}.pth")
        export_torch_checkpoint(ckpt, cfg, params, state)
        v = {"window_route": "K1" if _dense_forward_ok(cfg) else "compact"}
        forward_windows.launches = dp_wavefront.launches = 0

        out = os.path.join(tmp, f"{name}_graphs.tsv")
        v["graph_cli_seconds"] = quiet_main(embed.main, [
            "--input", graph_csv, "--id-column", "rid", "--output", out, "--model-path", ckpt,
            "--quiet", "--device", str(dev)])
        v["structures_per_s"] = VARIANT_RNAS / v["graph_cli_seconds"]
        emb = read_vectors(out, "rid")
        if list(emb) != [f"rna{i}" for i in range(VARIANT_RNAS)] or not all(
                e.shape == (cfg.output_dim,) and np.isfinite(e).all() for e in emb.values()):
            raise AssertionError(f"{name}: graph TSV rows missing, misordered or not finite")
        cpu = InferenceEngine.from_checkpoint(ckpt, device="cpu").embed_graphs(
            preprocess_structures([rnas[i] for i in take], graph_encoding=cfg.graph_encoding,
                                  feature_dim=cfg.node_feature_dim).graphs)
        v["graph_max_abs_err_vs_cpu"] = check_err(f"{name} graph embeddings vs the CPU", float(
            np.abs(cpu - np.stack([emb[f"rna{i}"] for i in take])).max()))
        v["graph_embed_split"] = graph_embed_split(graph_csv, ckpt,
                                                   os.path.join(tmp, "split.tsv"), dev)

        wout = os.path.join(tmp, f"{name}_windows.tsv")
        forward_windows.launches = 0
        v["window_cli_seconds"] = quiet_main(embed.main, [
            "--input", win_csv, "--id-column", "rna_id", "--output", wout,
            "--model-path", ckpt, "--window-size", str(WINDOW), "--keep-paired-neighbors",
            "--quiet", "--device", str(dev)])
        v["windows_per_s"] = n_windows / v["window_cli_seconds"]
        v["window_kernel_launches"] = forward_windows.launches
        if (forward_windows.launches > 0) != (v["window_route"] == "K1"):
            raise AssertionError(f"{name}: K1 launched {forward_windows.launches} times on "
                                 f"the {v['window_route']} window route")
        fused = read_vectors(wout, "window_id")
        if len(fused) != n_windows or not all(np.isfinite(e).all() for e in fused.values()):
            raise AssertionError(f"{name}: window TSV has {len(fused)} rows or a value that "
                                 f"is not finite")
        model = GINModel(cfg, params, state)
        res = embed_corpus_windows(model, sub, WINDOW, True, device="cpu")
        v["window_max_abs_err_vs_cpu"] = check_err(f"{name} window embeddings vs the CPU", max(
            float(np.abs(fused[f"rna{i}_{st}"] - e).max())
            for i, (starts, embs) in enumerate(res) for st, e in zip(starts.tolist(), embs)))
        v["windows_checked"] = sum(len(st) for st, _ in res)
        v["window_cli_host_split"] = cli_host_split(win_csv, ckpt, os.path.join(tmp, "w.tsv"),
                                                    structs, WINDOW, dev)
        if name == "forgi":
            v.update(forgi_extras(tmp, ckpt, cfg, rnas, win_csv, fused, dev))
        if dp_wavefront.launches:
            raise AssertionError(f"{name}: the variants path launched K2")
        rec[name] = v
    return rec


def row_cosines(a: dict, b: dict) -> np.ndarray:
    """Cosine of each row of ``a`` against the row of ``b`` with its key."""
    x = np.stack([a[k] for k in b]).astype(np.float64)
    y = np.stack(list(b.values())).astype(np.float64)
    return (x * y).sum(1) / np.maximum(np.linalg.norm(x, axis=1) * np.linalg.norm(y, axis=1),
                                       1e-30)


def cosine_record(what: str, cos: np.ndarray) -> dict:
    """Mean and min of ``cos``; fails when the mean is below BF16_MEAN_COS."""
    if not (np.isfinite(cos).all() and cos.mean() >= BF16_MEAN_COS):
        raise AssertionError(f"{what}: mean cosine {cos.mean()} against f32 < {BF16_MEAN_COS}")
    return {"cosine_vs_f32_mean": float(cos.mean()), "cosine_vs_f32_min": float(cos.min())}


def trace_busy(trace_dir: str) -> dict:
    """The card's kernel spans in the one trace of ``trace_dir``: their
    union (ms), the trace's span from its first to its last event (ms),
    and K1's launches and time in it."""
    files = [f for f in os.listdir(trace_dir) if f.endswith(".json")]
    if len(files) != 1:
        raise AssertionError(f"--profile-dir wrote {files}, not one trace")
    with open(os.path.join(trace_dir, files[0])) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    kern = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), e["name"])
                  for e in events if e.get("cat") == "kernel")
    busy, end = 0.0, -1.0
    for a, b, _ in kern:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    k1 = [b - a for a, b, n in kern if "windows_encoder_kernel" in n]
    if not k1:
        raise AssertionError("the profiler trace holds no window-encoder kernel")
    span = max(float(e["ts"]) + float(e.get("dur", 0)) for e in events) - \
        min(float(e["ts"]) for e in events)
    return dict(trace_bytes=os.path.getsize(os.path.join(trace_dir, files[0])),
                kernels=len(kern), kernel_busy_ms=busy / 1e3, trace_span_ms=span / 1e3,
                k1_kernels=len(k1), k1_ms=sum(k1) / 1e3)


def bf16_path(tmp: str, cfg, params, state, structures, f32_emb: dict, dev) -> dict:
    """The speed mode through the embed CLI: the window cell at ``--precision
    bf16`` (K1's bf16 route alone: no 3xTF32 launch), again with
    ``--bf16-check`` and under ``--profile-dir``; the graph cell at f32
    and bf16 in turns; the layer-norm variant's windows (the compact path,
    no K1 launch) at f32 and bf16.  Each bf16 result against its f32 run,
    window by window or structure by structure."""
    rec = {}
    ckpt = os.path.join(tmp, "flagship.pth")
    export_torch_checkpoint(ckpt, cfg, params, state)
    src = write_csv(os.path.join(tmp, "corpus.csv"), "rna_id", structures)
    win = ["--input", src, "--id-column", "rna_id", "--model-path", ckpt,
           "--window-size", str(WINDOW), "--keep-paired-neighbors", "--precision", "bf16",
           "--device", str(dev)]
    out = os.path.join(tmp, "bf16.tsv")
    forward_windows.launches = forward_windows.bf16_launches = dp_wavefront.launches = 0
    w = rec["windows"] = {"windows": len(f32_emb)}
    w["cli_seconds"] = quiet_main(embed.main, [*win, "--output", out, "--quiet"])
    w["cli_windows_per_s"] = len(f32_emb) / w["cli_seconds"]
    w["bf16_kernel_launches"] = forward_windows.bf16_launches
    w["tf32x3_kernel_launches"] = forward_windows.launches - forward_windows.bf16_launches
    if forward_windows.bf16_launches <= 0 or w["tf32x3_kernel_launches"] or \
            dp_wavefront.launches:
        raise AssertionError(f"the bf16 window run launched K1's bf16 route "
                             f"{forward_windows.bf16_launches} times, its 3xTF32 route "
                             f"{w['tf32x3_kernel_launches']} times and K2 "
                             f"{dp_wavefront.launches} times")
    bf = read_vectors(out, "window_id")
    if bf.keys() != f32_emb.keys() or not all(
            v.shape == (cfg.output_dim,) and np.isfinite(v).all() for v in bf.values()):
        raise AssertionError("bf16 window TSV: other windows than the f32 run, or a row "
                             "that is not finite and 128 wide")
    w.update(cosine_record("bf16 windows", row_cosines(bf, f32_emb)))

    said = io.StringIO()
    launches = forward_windows.launches
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(said):
        embed.main([*win, "--output", os.path.join(tmp, "check.tsv"),
                    "--bf16-check", str(BF16_CHECK)])
    torch.cuda.synchronize()
    m = re.search(r"\[bf16-check\] (\d+) windows re-embedded at f32: cosine mean (\S+), "
                  r"min ([0-9.e-]+)", said.getvalue())
    if not m:
        raise AssertionError(f"no [bf16-check] line in {said.getvalue()[-500:]!r}")
    w["bf16_check"] = {"cli_seconds": time.perf_counter() - t0, "windows": int(m.group(1)),
                       "cosine_mean": float(m.group(2).rstrip(",")),
                       "cosine_min": float(m.group(3)),
                       "kernel_launches": forward_windows.launches - launches}

    prof = os.path.join(tmp, "profile")
    w["profiled_cli_seconds"] = quiet_main(embed.main, [
        *win, "--output", os.path.join(tmp, "prof.tsv"), "--quiet", "--profile-dir", prof])
    # the profiler adds host time of its own (the trace written at the end
    # among it), not device work: the busy share is of the unprofiled run
    t = w["trace"] = trace_busy(prof)
    t["busy_share_of_cli"] = t["kernel_busy_ms"] / (1e3 * w["cli_seconds"])
    t["busy_share_of_trace_span"] = t["kernel_busy_ms"] / t["trace_span_ms"]

    # the graph cell, as graph_path builds it, at f32 and bf16 in turns
    rng = np.random.default_rng(SEED + 5)
    rnas = [random_structure(rng, int(rng.integers(150, 351))) for _ in range(GRAPH_RNAS)]
    gckpt = os.path.join(tmp, "graph.pth")
    export_torch_checkpoint(gckpt, cfg, *seeded_model(cfg, SEED + 5))
    gsrc = write_csv(os.path.join(tmp, "structures.csv"), "rid", rnas)
    g = rec["graphs"] = {"structures": GRAPH_RNAS, "seconds": {"f32": [], "bf16": []}}
    vecs = {}
    forward_windows.launches = 0
    for prec in ("f32", "bf16", "bf16", "f32"):
        gout = os.path.join(tmp, f"graphs_{prec}.tsv")
        g["seconds"][prec].append(quiet_main(embed.main, [
            "--input", gsrc, "--id-column", "rid", "--output", gout, "--model-path", gckpt,
            "--precision", prec, "--quiet", "--device", str(dev)]))
        vecs[prec] = read_vectors(gout, "rid")
    g["structures_per_s"] = {k: GRAPH_RNAS * len(v) / sum(v) for k, v in g["seconds"].items()}
    if list(vecs["bf16"]) != [f"rna{i}" for i in range(GRAPH_RNAS)] or forward_windows.launches:
        raise AssertionError("bf16 graph TSV: rows missing or misordered, or K1 launched")
    g.update(cosine_record("bf16 graphs", row_cosines(vecs["bf16"], vecs["f32"])))

    # one compact-path variant (layer norm): no K1 launch at either precision
    _, structs = variant_corpora()
    vcfg = GINConfig.create(**{**FLAGSHIP, "norm_type": "layer"})
    vckpt = os.path.join(tmp, "layer_norm.pth")
    export_torch_checkpoint(vckpt, vcfg, *variant_model(vcfg, SEED + 11))
    vsrc = write_csv(os.path.join(tmp, "variant.csv"), "rna_id", structs)
    c = rec["compact_layer_norm"] = {"windows": sum(len(x) - WINDOW + 1 for x in structs)}
    vecs = {}
    for prec in ("f32", "bf16"):
        vout = os.path.join(tmp, f"variant_{prec}.tsv")
        c[f"{prec}_cli_seconds"] = quiet_main(embed.main, [
            "--input", vsrc, "--id-column", "rna_id", "--output", vout, "--model-path", vckpt,
            "--window-size", str(WINDOW), "--keep-paired-neighbors", "--precision", prec,
            "--quiet", "--device", str(dev)])
        vecs[prec] = read_vectors(vout, "window_id")
    c["bf16_windows_per_s"] = c["windows"] / c["bf16_cli_seconds"]
    c["kernel_launches"] = forward_windows.launches
    if forward_windows.launches or len(vecs["bf16"]) != c["windows"]:
        raise AssertionError(f"compact path at bf16: {forward_windows.launches} K1 launches, "
                             f"{len(vecs['bf16'])} rows")
    c.update(cosine_record("bf16 compact windows", row_cosines(vecs["bf16"], vecs["f32"])))
    rec["bf16_matmul"] = bf16_matmul_route(dev)
    return rec


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
                   tf32_cudnn=torch.backends.cudnn.allow_tf32,
                   bf16_reduced_precision_reduction=(
                       torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction),
                   bf16_matmul=bf16_matmul_route(dev))

    with phase("build", {}) as rec:
        lib = _build.build_library()
        log = (lib.parent / "build.log").read_text()
        rec.update(library=os.path.relpath(lib, os.path.dirname(os.path.abspath(__file__))),
                   ptxas=ptxas_summary(log),
                   ptxas_notes=[ln.strip() for ln in log.splitlines() if "(C75" in ln])

    errs, bf16_errs = [], []
    with phase("kernel_vs_plain", {"tolerance": TOL, "bf16_tolerance": BF16_TOL,
                                   "bf16_min_cosine": BF16_COS}) as rec:
        structs = corpus(rng, 2000, 120)
        for name, cfg, L, own in KERNEL_CASES:
            m = GINModel(cfg, *seeded_model(cfg, SEED + 1)).to(dev)
            p, s = m.params, m.state
            x0, flags = chunk_inputs(cfg, p, own or structs, L, dev, C=64)
            got = forward_windows(cfg, p, s, x0, *flags, L)
            ref = forward_windows_reference(cfg, p, s, x0, *flags, L)
            torch.cuda.synchronize()
            err = (got - ref).abs().max().item()
            rows = L + flags[2].sum(dim=1)
            rec[name] = {"max_abs_err": err, "windows": x0.shape[0], "L": L,
                         "max_active_rows": int(rows.max().item())}
            errs.append(err)
            if not (err <= TOL and torch.isfinite(got).all()):
                raise AssertionError(f"kernel vs plain {name}: max abs {err} > {TOL}")
            # the bf16 route on the inputs the bf16 path gives it
            cb = cfg.with_precision("bf16")
            x0, flags = chunk_inputs(cb, p, own or structs, L, dev, C=64)
            n = forward_windows.bf16_launches
            got = forward_windows(cb, p, s, x0, *flags, L)
            ref = forward_windows_reference(cb, p, s, x0, *flags, L, precision="bf16")
            torch.cuda.synchronize()
            err = (got - ref).abs().max().item()
            cos = torch.nn.functional.cosine_similarity(got.double(), ref.double(), dim=1)
            rec[name]["bf16"] = {"max_abs_err": err, "min_cosine": cos.min().item()}
            bf16_errs.append(err)
            if forward_windows.bf16_launches != n + 1:
                raise AssertionError(f"kernel vs plain {name}: the bf16 route did not launch")
            if not (err <= BF16_TOL and cos.min().item() >= BF16_COS
                    and torch.isfinite(got).all()):
                raise AssertionError(f"kernel vs plain {name} (bf16): max abs {err} > "
                                     f"{BF16_TOL} or a cosine {cos.min().item()} < {BF16_COS}")

    dp_errs = []
    with phase("dp_kernel_vs_plain", {"tolerance": DP_TOL}) as rec:
        limit = smem_limit(dev)
        max_l1 = max(L for L in range(1, 20000) if dp_kernel_ok(L, 8, "global", limit))
        cases = dp_cases(np.random.default_rng(SEED + 5), max_l1)
        n_pairs = 0
        pairs_by_route = {"warp": 0, "cta": 0}
        case_routes = {}
        for mode in ("global", "local"):
            for go, ge in DP_GAPS:
                for name, mats in cases.items():
                    err, res, took = dp_compare(mats, go, ge, mode, dev, both=True)
                    if name == "all_negative" and mode == "local" and \
                            any(r != (0.0, []) for r in res):
                        raise AssertionError(f"local all-negative: {res} is not empty")
                    dp_errs.append(err)
                    n_pairs += len(mats)
                    pairs_by_route[took] += len(mats)
                    case_routes[name] = took
        if case_routes.pop(f"near_gate_{max_l1}x8") != "cta" or \
                set(case_routes.values()) != {"warp"}:
            raise AssertionError(f"K2 routes: {case_routes}, near_gate not on the CTA route")
        rec.update(pairs_compared=n_pairs, pairs_by_route=pairs_by_route,
                   cta_route_pairs=n_pairs, warp_rows_per_lane=sorted(
                       {route(max(m.shape[0] for m in ms))[1] for ms in cases.values()} - {0}),
                   max_abs_err=max(dp_errs), codes_compared="each pair's rectangle",
                   smem_optin=limit, gate_max_l1=max_l1, cases=sorted(cases))

    with tempfile.TemporaryDirectory() as tmp, phase("main_path", {"card": card}) as rec:
        cfg = GINConfig.create(**FLAGSHIP)
        params, state = seeded_model(cfg, SEED + 2)
        ckpt = os.path.join(tmp, "flagship.pth")
        export_torch_checkpoint(ckpt, cfg, params, state)
        structures = corpus(rng, N_WINDOWS, WINDOW)
        n_windows = sum(len(s) - WINDOW + 1 for s in structures)
        src = write_csv(os.path.join(tmp, "corpus.csv"), "rna_id", structures)
        out = os.path.join(tmp, "windows.tsv")

        forward_windows.launches = dp_wavefront.launches = 0
        t0 = time.perf_counter()
        embed.main(["--input", src, "--id-column", "rna_id", "--output", out,
                    "--model-path", ckpt, "--window-size", str(WINDOW),
                    "--keep-paired-neighbors", "--quiet"])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        launches = forward_windows.launches
        if launches <= 0:
            raise AssertionError("the main path launched no window-encoder kernel")
        rec["dp_kernel_launches"] = dp_wavefront.launches

        emb = read_vectors(out, "window_id")
        if len(emb) != n_windows:
            raise AssertionError(f"TSV has {len(emb)} rows, expected {n_windows}")
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
                   warm_embed_windows_per_s=n_windows / warm_s,
                   warm_split=warm_split(model, structures, WINDOW),
                   cli_host_split=cli_host_split(src, ckpt, os.path.join(tmp, "split.tsv"),
                                                 structures, WINDOW, dev))
    main_params, main_state, main_emb = params, state, emb

    with tempfile.TemporaryDirectory() as tmp, phase("align_path", {"card": card}) as rec:
        rnas = [random_structure(rng, int(rng.integers(150, 351)))
                for _ in range(ALIGN_RNAS)]
        params, state = seeded_model(cfg, SEED + 4)
        ckpt = os.path.join(tmp, "flagship.pth")
        export_torch_checkpoint(ckpt, cfg, params, state)
        src = write_csv(os.path.join(tmp, "structures.csv"), "rid", rnas)
        nodes = os.path.join(tmp, "nodes.tsv")
        out_dir = os.path.join(tmp, "pairs")
        n_pairs = ALIGN_RNAS * (ALIGN_RNAS - 1) // 2

        forward_windows.launches = dp_wavefront.launches = wavefront_plain.launches = 0
        dp_wavefront.warp_launches = 0
        t0 = time.perf_counter()
        node_embed.main(["--input", src, "--id-column", "rid", "--output", nodes,
                         "--model-path", ckpt, "--keep-cols", "secondary_structure",
                         "--quiet", "--device", "cuda"])
        torch.cuda.synchronize()
        node_embed_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        align_batch.main(["--input", nodes, "--id-column", "rid", "--output-dir", out_dir,
                          "--batch-size", str(ALIGN_BATCH), "--mode", "global",
                          "--structure-column-name", "secondary_structure",
                          "--device", "cuda"])
        torch.cuda.synchronize()
        align_batch_s = time.perf_counter() - t0
        batch_launches = dp_wavefront.launches
        align.main(["--input", nodes, "--id-column", "rid", "--rna1", "rna0", "--rna2",
                    "rna1", "--mode", "local", "--structure-column-name",
                    "secondary_structure", "--output-prefix", os.path.join(tmp, "pair"),
                    "--device", "cuda"])
        torch.cuda.synchronize()
        dp_launches, plain_launches = dp_wavefront.launches, wavefront_plain.launches
        warp_launches = dp_wavefront.warp_launches
        window_launches = forward_windows.launches
        expected = -(-n_pairs // ALIGN_BATCH)
        if batch_launches != expected or dp_launches != expected + 1 or plain_launches:
            raise AssertionError(f"the align path launched K2 {batch_launches} + "
                                 f"{dp_launches - batch_launches} times (expected {expected}"
                                 f" + 1) and the plain DP {plain_launches} times")
        if warp_launches != dp_launches:
            raise AssertionError(f"{dp_launches - warp_launches} of the align path's "
                                 f"{dp_launches} K2 launches took the CTA route")

        # node embeddings: one matrix per RNA, unit rows (zscore_l2), equal
        # on a sample to the port's CPU run of the same checkpoint
        with open(nodes, newline="") as f:
            rows = list(csv.DictReader(f, delimiter="\t"))
        mats = [node_embed.parse_matrix(r["node_embeddings"]) for r in rows]
        if [m.shape for m in mats] != [(len(st), cfg.hidden_dims[-1]) for st in rnas]:
            raise AssertionError("node-embedding matrices of the wrong shape")
        norms = np.concatenate([np.linalg.norm(m, axis=1) for m in mats])
        if not (np.isfinite(norms).all() and np.abs(norms - 1).max() < 1e-4):
            raise AssertionError("node embeddings are not finite unit rows")
        cpu = InferenceEngine.from_checkpoint(ckpt, device="cpu").node_embeddings(
            preprocess_structures(rnas[:4]).graphs)
        node_err = max(float(np.abs(c - m).max()) for c, m in zip(cpu, mats))
        if node_err > TOL:
            raise AssertionError(f"node embeddings vs the CPU: max abs {node_err} > {TOL}")

        with open(os.path.join(out_dir, "summary.tsv"), newline="") as f:
            summary = list(csv.DictReader(f, delimiter="\t"))
        scores = np.array([float(r["score"]) for r in summary])
        if len(summary) != n_pairs or not np.isfinite(scores).all():
            raise AssertionError("summary.tsv: wrong row count or a score that is not finite")
        with open(os.path.join(tmp, "pair.alignment.tsv")) as f:
            if 'mode="local"' not in f.read():
                raise AssertionError("align CLI wrote no local alignment")

        # the CLI's work again, stage by stage: host similarity, device DP
        # (upload, kernel, download), host un-shear and traceback; and 32
        # pairs re-aligned by the plain wavefront on the card
        pairs = [(i, j) for i in range(ALIGN_RNAS) for j in range(i + 1, ALIGN_RNAS)]
        t_sim = t_dev = t_host = 0.0
        dp_batches = []
        for s0 in range(0, n_pairs, ALIGN_BATCH):
            chunk = pairs[s0:s0 + ALIGN_BATCH]
            t0 = time.perf_counter()
            sims = [cosine_similarity_matrix(mats[i], mats[j]).astype(np.float32)
                    for i, j in chunk]
            t1 = time.perf_counter()
            sd, l1d, l2d, l1, l2 = dp_tensors(sims, dev)
            best, bi, bj, codes = (t.cpu().numpy() for t in
                                   dp_wavefront(sd, l1d, l2d, -1.0, -1.0, "global"))
            t2 = time.perf_counter()
            paths_from_codes(codes, l1, l2, bi, bj, "global")
            t3 = time.perf_counter()
            t_sim, t_dev, t_host = t_sim + t1 - t0, t_dev + t2 - t1, t_host + t3 - t2
            dp_batches.append(sims)
        sims = dp_batches[0][:32]
        err, plain_res, recheck_route = dp_compare(sims, -1.0, -1.0, "global", dev)
        plain_scores = np.array([sc for sc, _ in plain_res])
        cli_err = float(np.abs(plain_scores - scores[:len(sims)]).max())
        if cli_err > DP_TOL:
            raise AssertionError(f"align CLI vs plain wavefront: |score| {cli_err} > {DP_TOL}")
        dp_errs += [err, cli_err]
        rec.update(structures=ALIGN_RNAS, pairs=n_pairs, node_embed_seconds=node_embed_s,
                   node_max_abs_err_vs_cpu=node_err,
                   align_batch_seconds=align_batch_s,
                   align_batch_pairs_per_s=n_pairs / align_batch_s,
                   dp_kernel_launches=dp_launches, dp_kernel_launches_batch_cli=batch_launches,
                   dp_kernel_warp_launches=warp_launches,
                   window_kernel_launches=window_launches,
                   plain_dp_launches=plain_launches,
                   host_similarity_seconds=t_sim, device_dp_seconds=t_dev,
                   host_codes_dense_traceback_seconds=t_host,
                   plain_recheck_pairs=len(sims), plain_recheck_route=recheck_route,
                   plain_recheck_max_abs_err=max(err, cli_err))

    with tempfile.TemporaryDirectory() as tmp, phase("graph_path", {"card": card}) as rec:
        rec.update(graph_path(tmp, cfg, dev))

    with tempfile.TemporaryDirectory() as tmp, phase("variants_path", {"card": card}) as rec:
        rec.update(variants_path(tmp, dev))

    with tempfile.TemporaryDirectory() as tmp, phase("bf16_path", {"card": card}) as rec:
        rec.update(bf16_path(tmp, cfg, main_params, main_state, structures, main_emb, dev))
        bf16_launches = rec["windows"]["bf16_kernel_launches"]

    with phase("kernel_timing", {"card": card}) as rec:
        p, s = model.params, model.state
        x0, flags = chunk_inputs(cfg, p, structures, WINDOW, dev)
        packed = pack_params(cfg, p, s)
        got = forward_windows(cfg, p, s, x0, *flags, WINDOW, packed=packed)
        ref = forward_windows_reference(cfg, p, s, x0, *flags, WINDOW)
        errs.append((got - ref).abs().max().item())
        ms = cuda_ms(lambda: forward_windows(cfg, p, s, x0, *flags, WINDOW, packed=packed), 50)
        plain_ms = cuda_ms(lambda: forward_windows_reference(cfg, p, s, x0, *flags, WINDOW), 20)
        bound_ms, bound_by, fma_bound_ms = encoder_bound_ms(cfg, x0, flags, packed, WINDOW)
        rows = WINDOW + flags[2].sum(dim=1)
        rec.update(windows=x0.shape[0], L=WINDOW, ms=ms, plain_ms=plain_ms,
                   bound_ms=bound_ms, bound_by=bound_by, fma_bound_ms=fma_bound_ms,
                   active_rows_mean=rows.mean().item(), active_rows_max=rows.max().item(),
                   smem_rows=_library().windows_encoder_smem_rows(WINDOW, cfg.hidden_dims[-1]),
                   max_abs_err=errs[-1])

        # K1's bf16 route on the same windows, as the bf16 path builds them
        cb = cfg.with_precision("bf16")
        xb, fb = chunk_inputs(cb, p, structures, WINDOW, dev)
        pb = pack_params(cb, p, s)
        got = forward_windows(cb, p, s, xb, *fb, WINDOW, packed=pb)
        ref = forward_windows_reference(cb, p, s, xb, *fb, WINDOW)
        bf16_errs.append((got - ref).abs().max().item())
        b_ms = cuda_ms(lambda: forward_windows(cb, p, s, xb, *fb, WINDOW, packed=pb), 50)
        b_plain = cuda_ms(lambda: forward_windows_reference(cb, p, s, xb, *fb, WINDOW), 20)
        b_bound, b_by, _ = encoder_bound_ms(cb, xb, fb, pb, WINDOW, BF16_FLOPS)
        rec["bf16"] = dict(ms=b_ms, plain_ms=b_plain, bound_ms=b_bound, bound_by=b_by,
                           share_of_bound=b_bound / b_ms, f32_route_over_bf16=ms / b_ms,
                           max_abs_err=bf16_errs[-1])
        k1_bf16 = rec["bf16"]

        # K2 on the align path's first batch, as the CLI pads it and padded
        # to 384 x 384: the route the wrapper takes (ms, the warp route) and
        # the CTA route (cta_ms) on the same inputs, in turns.  The
        # dependency floor is the CTA route's: the probe's time for the same
        # number of diagonal steps in CTAs of the same shape
        sims = dp_batches[0]
        dp_t = {}
        for key, L in (("batch", None), ("384", 384)):
            sd, l1d, l2d, l1, l2 = dp_tensors(sims, dev, L, L)
            B, L1, L2 = sd.shape
            run = (sd, l1d, l2d, -1.0, -1.0, "global")
            rte = route(L1)
            times = {"warp": [], "cta": []}
            for kind in ("warp", "cta", "cta", "warp"):
                fn = (lambda: dp_wavefront(*run)) if kind == "warp" else \
                    (lambda: launch(("cta", 0), *run))
                times[kind].append(cuda_ms(fn, 10))
            p_ms = cuda_ms(lambda: wavefront_plain(*run), 2)
            b_ms, b_by, nbytes = dp_bounds(l1, l2)
            dep_ms = cuda_ms(lambda: barrier_probe(B, L1 + L2, L1, dev), 20)
            k_ms, c_ms = (sum(times[k]) / 2 for k in ("warp", "cta"))
            dp_t[key] = dict(pairs=B, L1=L1, L2=L2, route=rte[0], rows_per_lane=rte[1],
                             ms=k_ms, cta_ms=c_ms, ms_runs=times["warp"],
                             cta_ms_runs=times["cta"], plain_ms=p_ms, bound_ms=b_ms,
                             bound_by=b_by, bytes=nbytes, share_of_bound=b_ms / k_ms,
                             dependency_floor_ms=dep_ms, dependency_floor_of="cta route")
        rec["dp_wavefront"] = dp_t

    print(card)
    k2 = dp_t["batch"]
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
    }, {
        "name": "windows_encoder_bf16",
        "route": "cuda",
        "precision": "bf16",
        "source": "ginfinity_tpu_torch/ops/csrc/windows_encoder.cu",
        "replaces": "ginfinity_tpu/ops/pallas_windows.py:84",
        "launches": bf16_launches,
        "max_abs_err": max(bf16_errs),
        "ms": k1_bf16["ms"],
        "plain_ms": k1_bf16["plain_ms"],
        "bound_ms": k1_bf16["bound_ms"],
        "bound_by": k1_bf16["bound_by"],
        "library_ms": None,
    }, {
        "name": "dp_wavefront",
        "route": "cuda",
        "design": "warp-per-pair",
        "source": "ginfinity_tpu_torch/ops/csrc/dp_wavefront.cu",
        "replaces": "ginfinity_tpu/ops/pallas_dp.py:48",
        "launches": dp_launches,
        "max_abs_err": max(dp_errs),
        "ms": k2["ms"],
        "plain_ms": k2["plain_ms"],
        "bound_ms": k2["bound_ms"],
        "bound_by": k2["bound_by"],
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
