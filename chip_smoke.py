#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, holds
each kernel against its plain PyTorch version on the card, then drives
the port's paths, the embedding paths with a seeded flagship checkpoint
(6 x GINE-128, GraphNorm, mean pool, zscore_l2):

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
  (the compact path) at bf16;
* multiple alignment, ``ginfinity-embed-msa`` on the family of
  ``bench_msa_scale.py`` (200 records of 240-300 positions, 128-d, seed
  5) with its flags (``--alpha 5 --beta 0 --topk 20
  --consistency-rounds 1 --max-pairs 2000``), in library mode (the
  default) and in profile mode: pair-HMM posteriors, consistency, and
  the progressive stage on the device pools (the library pool scatters
  the consistency slabs where they lie; the profile pool merges on the
  card), each level's traceback by the port's ``value_traceback`` kernel
  (it must launch; K1 and K2 must not);
* the MSA's consistency round at rRNA length (``msa_long_path``): (a)
  the round alone on seeded slabs at the CLI's shapes (400 records of
  1,900-2,000 positions, 2,000 kNN-like pairs, 20 columns a row), whose
  memo round (every slab dense, ~98 GB) the card cannot hold, so the
  tiled round runs under the card's default budget: its seconds and peak
  memory above the resident slabs within the round's estimate, two runs
  identical, 4 seeded pairs recomputed on the CPU and alone on the card
  (1 and 3 products to a batched product) identical, and on 100 records
  and 500 pairs, where both rounds fit, memo and tiled identical, each
  within its estimate; (b) ``ginfinity-embed-msa`` on 16 records of
  1,400-1,500 positions, 128-d, in both modes on the pools, under the
  card's default budget (memo) and 1 MiB below the memo estimate
  (tiled): the same ``.fasta``, ``.sto`` and ``.aln.tsv``;
* the MSA tools (``msa_tools_path``, no kernel either): ``--refine-iters
  32`` on the first 100 records of that family in library mode; a 24-record family refined in
  both modes on the card and the CPU; ``msa_eval`` on a known-homology
  family of 24 members (``make_family``, ancestor 300 nt) embedded with
  the flagship, aligned in both modes and scored against the truth;
  ``ginfinity-optimize-msa`` for 3 trials on it; ``ginfinity-prewarm``
  in window mode (the kernel library) and ``--msa 24 120``;
* training, ``ginfinity-train`` at the packaged width (6 x GINE-128,
  GraphNorm, ``zscore_l2``, nodes normalised before the pool, dropout
  0.05) and ``train_eval``'s probes (``train_path``): (a) one train step
  per mode (triplet, regression, alignment, and regression with batch
  norm) at dropout 0 on the card and the CPU, (b) the same step twice on
  the card at dropout 0.05 from one generator seed, bit-equal, (c)
  ``train_packaged_architecture`` on ``generate_alignment_training_data``'s
  120 families, two rounds from a seeded checkpoint, the loss lower at
  the end, and one more epoch split into host batch assembly and the
  step's node embeddings, loss, backward and Adam from the CUDA events
  of the port's spans (``utils/trace.py``), (d) both probes of
  the trained and the starting checkpoint on the 24 held-out families
  (K2 on the warp route, no K1), (e) triplet and regression through the
  CLI with ``--fit-node-stats``, (f) a run stopped in epoch 2 and resumed
  from its ``--save-every 1`` checkpoint, bit-equal to the straight run,
  (g) the flagship architecture (4 layers 256 -> 512 x 3, forgi) for one
  epoch;
* ``--data-parallel`` (``mesh_path``), every data mesh the port builds
  patched to two shards on the one card: the window, graph, top-k,
  align-batch and 24-record MSA (both modes) CLIs rerun on the earlier
  phases' inputs, each output identical to the unsharded run (K1's and
  K2's launches under the mesh go into the ``kernels`` line as
  ``mesh_launches``); the sharded train step bit-equal to the mean of
  its shards' single-device steps, against a CPU mesh under
  ``card_vs_cpu``'s gradient rules, and twice bit-equal; one epoch of
  ``train_packaged_architecture`` twice, bit-equal; and a mixed
  ``[cuda:0, cpu]`` mesh (a graph embed and an align-batch: the card
  shard's results identical to the card's, the CPU shard's within the
  card-vs-CPU bar). Two shards on one card show the sharded code, not a
  speed-up: the machine has one card.

Each phase prints one JSON line with its name and seconds.  The
``main_path`` line also splits the warm window pass (upload, window
build, K1, download) and the CLI's host stages (CSV read, checkpoint
load, prep, TSV write) from the port's spans of one run each; ``kernel_timing`` gives K1's
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
bf16 (the same four rounding points) for each case.
``staged_kernel_vs_plain`` holds K1's staged route (no plane in shared
memory: A copied through a ring in shared memory) to the plain version,
with every launch required to take it: a 128-window chunk of the
``windows-long`` cell's first request at forgi-4x512's widths and
weights on both routes within the cell's ``emb_gap`` bar, timed beside
its bound and the plain version (the ``windows_encoder_staged`` entries
of the ``kernels`` line), and the flagship at L 200, where its X plane
no longer fits in shared memory.  ``bf16_path``
prints windows/s and structures/s at bf16 with each window's and each
structure's cosine against the f32 run, the CLI's own ``[bf16-check]``
numbers and the trace's busy share.  ``msa_path`` prints each mode's
seconds, pairs/s, stage seconds and the pool's split, and holds the run
to its checks: (a) the exact profile DP on the card bit-equal (column
dots, M/X/Y, op codes) to a numpy copy of the reference's float32 DP on
8 leaf merges of the family; (b) two posterior batches' slabs on the
card within 1e-5 of the port's CPU run; (c) a 24-record family's
``.aln.tsv`` in both modes, on the pools and under
``GINFINITY_MSA_POOL=0``, identical on the card and the CPU; (e) both
modes took their pool with no overflow, beside the progressive seconds
of ``GINFINITY_MSA_POOL=0`` on the same family and the ``.aln.tsv``
rows in which the two differ; (f) the library accumulator of the root
split, on the run's own slabs, equal on the card and the CPU (max abs
0), and two card runs of the library pool writing the same
``.aln.tsv``; (g) both pools' enqueue loops under
``torch.cuda.set_sync_debug_mode("error")``; (i) the TSV read with the
native scanner and with ``json`` alone, the arrays identical.  (h) The
``traceback_kernel_vs_plain`` phase holds the traceback kernel to its
plain version on the states of random and of tie-rich scores at B = 64,
P = 384, and times both.  ``msa_tools_path`` prints each
part's seconds and holds them to checks: the refined SP score no lower
than the progressive one and the outputs complete; the small family's
refined ``.aln.tsv`` and refinement stats identical on the card and the
CPU; msa_eval's node rows within 1e-4 of the CPU's (or no farther from
float64 than twice the CPU's), the truth MSA at recall and precision 1.0,
and a CPU rerun of the library-mode alignment identical; three finite
optimizer trials and a complete ``best_params.json``; no K1 or K2
launch; library mode's refinement realigns all take the fused device
scatter and DP.  Before the last line it prints the card's name and power limit (as nvidia-smi
gives them) and one JSON line of per-kernel numbers; the last line is
``{"ok": true, "device": {...}}``.  Any failure exits non-zero without
that line, and so does a machine without a CUDA device.  Imports only
the port, torch, numpy and the standard library.
"""

from __future__ import annotations

import builtins
import contextlib
import csv
import dataclasses
import io
import json
import operator
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import torch

# the checkout stays as git has it: the only files a run leaves are the
# built kernels under ginfinity_tpu_torch/_build/
sys.dont_write_bytecode = True

from ginfinity_tpu_torch.models.checkpoint import export_torch_checkpoint, load_checkpoint
from ginfinity_tpu_torch.models.gine import (
    GINConfig,
    GINModel,
    _leaves,
    bf16_matmul_route,
    get_node_embeddings,
    init_params,
)
from ginfinity_tpu_torch.ops import _build
from ginfinity_tpu_torch.ops import contrastive_loss as closs
from ginfinity_tpu_torch.ops.dp import (
    affine_align_batch,
    pack_batch,
    pad_batch,
    paths_from_codes,
)
from ginfinity_tpu_torch.ops.dp_traceback import dp_traceback, paths_from_arrays
from ginfinity_tpu_torch.ops.dp_wavefront import (
    dp_kernel_ok,
    dp_wavefront,
    launch,
    rectangle_mask,
    route,
    smem_limit,
    wavefront_plain,
)
from ginfinity_tpu_torch.ops.windows_encoder import (
    forward_windows,
    forward_windows_reference,
    pack_params,
)
from ginfinity_tpu_torch.parallel import mesh as mesh_mod
from ginfinity_tpu_torch.parallel.mesh import DataMesh
from ginfinity_tpu_torch.parallel.search import (
    TopKSearcher,
    _topk,
    brute_force_topk,
    recall_at_k,
)
from ginfinity_tpu_torch.ops import library_pool, pairhmm, profile_pool
from ginfinity_tpu_torch.ops.value_traceback import value_traceback, value_traceback_plain
from ginfinity_tpu_torch.pipelines import (
    align,
    align_batch,
    distances,
    embed,
    msa,
    msa_eval,
    node_embed,
    optimize_msa,
    prewarm,
    train_eval,
    windows,
)
from ginfinity_tpu_torch.pipelines.msa_eval import random_structure
from ginfinity_tpu_torch.pipelines.align import cosine_similarity_matrix
from ginfinity_tpu_torch.pipelines.engine import InferenceEngine, preprocess_structures
from ginfinity_tpu_torch.pipelines.fast_windows import (
    _chunk_for,
    _dense_forward_ok,
    _group_host,
    _pack_group,
    _prep_corpus_groups,
    _window_chunk,
    embed_corpus_windows,
)
from ginfinity_tpu_torch.graphs.batching import _round_capacity, batch_graphs, bucket_sizes
from ginfinity_tpu_torch.training import data as train_data
from ginfinity_tpu_torch.training import train as train_module
from ginfinity_tpu_torch.training import train_cli
from ginfinity_tpu_torch.training.losses import (
    AlignmentLossConfig,
    alignment_contrastive_loss,
    plain_alignment_loss,
)
from ginfinity_tpu_torch.training.train import (
    EarlyStopping,
    TrainState,
    alignment_loss_fn,
    make_train_step,
    regression_loss_fn,
    tree_map,
    triplet_loss_fn,
)
from ginfinity_tpu_torch.utils.device import disable_tf32
from ginfinity_tpu_torch.utils import native, trace
from ginfinity_tpu_torch.utils.io import read_table, write_tsv
from portbench.kinds import windows as windows_kind

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
HERE = os.path.dirname(os.path.abspath(__file__))
FORGI_CONFIG = os.path.join(HERE, "portbench", "configs", "forgi-4x512.json")
WINDOWS_TRAFFIC = os.path.join(HERE, "portbench", "traffic", "windows-long.json")
EMB_GAP = 3e-4             # the windows cell's bar on an embedding entry
STAGED_CHUNK = 128         # windows of a main-path chunk of the cell's long groups
STAGED_128_L = 200         # a window length at which a 128-wide X plane leaves shared memory
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
# the MSA family of bench_msa_scale.py (N = 200, L <= 300, 128-d, seed 5)
# and its flags: kNN-capped pairs, top-k 20, one consistency round
MSA_N, MSA_LMAX, MSA_DIM, MSA_SEED = 200, 300, 128, 5
MSA_FLAGS = ["--alpha", "5", "--beta", "0", "--topk", "20",
             "--consistency-rounds", "1", "--max-pairs", "2000"]
MSA_SMALL = (24, 120)      # the family of the card-vs-CPU .aln.tsv check
MSA_EXACT_MERGES = 8       # leaf merges held to the numpy oracle DP
MSA_SLAB_BATCHES = 2       # posterior batches re-run on the CPU
MSA_SLAB_TOL = 1e-5        # their slabs, card vs CPU, max abs
TB_SHAPE = (64, 384)       # merges and padded length of the traceback kernel's check
# msa_long_path: (a) the consistency round alone at rRNA length, on seeded
# slabs (records, pairs, width, columns a row) whose memo round passes the
# card's memory, 4 of its pairs recomputed on the CPU, and an instance
# where both rounds fit; (b) the CLI on a family (records, shortest and
# longest length) in both modes, memo and tiled
MSA_LONG = (400, 2_000, 2_000, 20)
MSA_LONG_BOTH = (100, 500)
MSA_LONG_CPU_PAIRS = 4
MSA_LONG_FAMILY = (16, 1_400, 1_500)
# the MSA tools: refinement on the N = 200 family and on the small one,
# msa_eval's family (make_family's seed, members, ancestor length), the
# optimizer's trials and the region (ancestor coordinates) it scores
MSA_REFINE_ITERS, MSA_SMALL_REFINE_ITERS = 32, 8
MSA_REFINE_ROWS = 100      # records of the refined run (cut to hold the smoke's time)
MSA_EVAL_FAMILY = (13, 24, 300)
OPT_TRIALS, OPT_REGION = 3, (50, 149)
NODE_CPU_TOL = 1e-4        # node rows, card vs CPU (the align path's bar)
# train_path: one train step, card vs CPU (loss relative, gradients scaled
# by max(1, max|g|)); the training run's schedule, two rounds from a
# seeded checkpoint; the flagship's; the triplet/regression rows of (e), (f)
TRAIN_TOL = 1e-5
TRAIN_ROUNDS = [{"lr": 5e-4, "decay_rate": 0.98, "patience": 10, "num_epochs": 3},
                {"lr": 1e-4, "decay_rate": 0.95, "patience": 10, "num_epochs": 2}]
FLAGSHIP_ROUNDS = [{"lr": 5e-4, "decay_rate": 0.98, "patience": 10, "num_epochs": 1}]
TRAIN_PAIR_ROWS = 96
MESH_SHARDS = 2            # shards of the mesh_path phase, all on the one card
MESH_MIXED_RNAS = 64       # structures of the mixed [card, CPU] mesh's graph embed
MESH_MIXED_PAIRS = 64      # pairs of its align-batch

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


def windows_cell(config_path: str, dev, seed: int = 0):
    """The ``windows-long`` cell's model under a benchmark configuration
    (weights drawn as the cell draws them for ``seed``), the transcripts
    of its first request, and its window length: the cell's own set-up
    (``portbench/kinds/windows.py::setup``), without its warm-up calls."""
    with open(config_path) as f:
        md = json.load(f)
    with open(WINDOWS_TRAFFIC) as f:
        t = json.load(f)
    env = types.SimpleNamespace(traffic={**t, "warmup_calls": 0}, config=md, seed=seed,
                                device=dev, stage=lambda name: contextlib.nullcontext())
    S = windows_kind.setup(env)
    return S.model, S.pool[:t["per_call"]], S.L


def plain_windows(model, per, n_cap: int, idxs, L: int) -> torch.Tensor:
    """Every window of one length group through the plain encoder as the
    JAX package's XLA path computes it (partner rows gathered exactly),
    chunk by chunk as the main path cuts the group, on the model's device."""
    cfg, dev = model.config, model.device
    feats, pts, si, st, w_cap = _group_host(cfg, per, n_cap, idxs)
    feats_d = torch.from_numpy(feats).to(dev)
    pts_d = torch.from_numpy(pts).to(dev, torch.int64)
    si, st = (torch.from_numpy(a).to(dev, torch.int64) for a in (si, st))
    chunk = _chunk_for(w_cap)
    out = []
    for c0 in range(0, si.shape[0], chunk):
        x0, flags = _window_chunk(cfg, model.params, feats_d, pts_d, si[c0:c0 + chunk],
                                  st[c0:c0 + chunk], L, True)
        out.append(forward_windows_reference(cfg, model.params, model.state, x0, *flags, L,
                                             exact_gather=True))
    return torch.cat(out)


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


def program_spans(run) -> list:
    """The port's spans (``utils/trace.py``) of one ``run()``."""
    trace.clear()
    with trace.recording():
        run()
    recs = trace.recorded()
    trace.clear()
    return recs


def span_sum(recs, name: str, device: bool = False) -> float:
    """Milliseconds of the spans ``name``: host stamps, or CUDA events."""
    return sum(r.device_ms if device else r.ms for r in recs if r.name == name)


def warm_split(model, structures, L: int) -> dict:
    """The warm window pass, stage by stage, from the program's spans:
    host prep and packing, per group the upload and the download (the
    wait, then the copy), on the host clock; per chunk the window build
    (``_window_chunk``) and K1 from CUDA events.  An event span includes
    the device's wait for the host to enqueue the stage, so the host's
    enqueue time of the window build and of K1 is given beside it
    (``*_host_s``)."""
    recs = program_spans(lambda: embed_corpus_windows(model, structures, L, True))
    (root,) = [r for r in recs if r.name == "windows.embed"]
    return {"upload_ms": span_sum(recs, "windows.upload"),
            "window_build_ms": span_sum(recs, "windows.build", device=True),
            "k1_ms": span_sum(recs, "windows.encoder", device=True),
            "download_ms": span_sum(recs, "windows.download"),
            "host_prep_s": span_sum(recs, "windows.prep") / 1e3,
            "host_pack_s": span_sum(recs, "windows.pack") / 1e3,
            "window_build_host_s": span_sum(recs, "windows.build") / 1e3,
            "k1_host_s": span_sum(recs, "windows.encoder") / 1e3,
            "call_s": root.ms / 1e3, **root.counts}


def cli_host_split(src: str, ckpt: str, out_tsv: str, L: int, dev) -> dict:
    """The window CLI's host stages, from the program's spans of one run:
    CSV read, checkpoint load (and the model's upload), prep (pair
    tables, window features, grouping) and the TSV write of the
    embeddings (text formatting included)."""
    recs = program_spans(lambda: quiet_main(embed.main, [
        "--input", src, "--id-column", "rna_id", "--output", out_tsv, "--model-path", ckpt,
        "--window-size", str(L), "--keep-paired-neighbors", "--quiet", "--device", str(dev)]))
    return {k: span_sum(recs, name) / 1e3 for k, name in (
        ("csv_read_s", "embed.read"), ("checkpoint_load_s", "embed.load"),
        ("prep_s", "windows.prep"), ("tsv_write_s", "embed.write"))}


def dp_tensors(mats, dev, L1=None, L2=None):
    """A batch of score matrices padded as ``affine_align_batch`` pads it,
    on ``dev``, with the real sides also on the host."""
    scores, l1, l2 = pad_batch(mats, L1, L2)
    return (torch.from_numpy(scores).to(dev), torch.from_numpy(l1).to(dev),
            torch.from_numpy(l2).to(dev), l1, l2)


def dp_compare(mats, go, ge, mode, dev, both=False) -> tuple[float, list, str]:
    """K2 against the plain wavefront on the same batch on the card, on
    the route the wrapper chooses and, with ``both``, on the CTA route
    too when the wrapper chose the warp route: identical paths (walked
    on the host and by the card's walk kernel), best cells and codes on
    every pair's rectangle, |score| within DP_TOL.
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
        walk = dp_traceback(out[3], l1d, l2d, out[1], out[2], mode)
        if paths != paths_from_arrays(*(t.cpu().numpy() for t in walk)):
            raise AssertionError(f"{what}: the card's walk (dp_traceback) differs")
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


def staged_kernel_vs_plain(dev) -> dict:
    """K1's staged route against the plain version, with the launch
    counters zeroed first: each of the four checked launches must take
    the route.  (a) A ``STAGED_CHUNK``-window chunk of the windows cell's
    first request at forgi-4x512's widths and weights (``windows_cell``),
    on the 3xTF32 and the bf16 route, each within the cell's ``EMB_GAP``
    of the plain version at its precision; then its time, the plain
    version's and its bound.  (b) The flagship 6 x 128 at L
    ``STAGED_128_L``, where its X plane no longer fits in shared memory
    and one output tile's product writes the plane it reads, within
    ``TOL`` and ``BF16_TOL``."""
    forward_windows.launches = forward_windows.bf16_launches = 0
    forward_windows.staged_launches = 0
    model, structures, L = windows_cell(FORGI_CONFIG, dev)
    flag_cfg = GINConfig.create(**FLAGSHIP)
    flag = GINModel(flag_cfg, *seeded_model(flag_cfg, SEED + 1)).to(dev)
    flag_structs = corpus(np.random.default_rng(SEED + 41), 2000, STAGED_128_L)
    out, timed = {"forgi": {"L": L}, "flagship": {"L": STAGED_128_L}}, []
    for key, m, structs, n, win, tols in (
            ("forgi", model, structures, STAGED_CHUNK, L, (EMB_GAP, EMB_GAP)),
            ("flagship", flag, flag_structs, 64, STAGED_128_L, (TOL, BF16_TOL))):
        p, s = m.params, m.state
        for prec, tol in zip(("highest", "bf16"), tols):
            cfg = m.config.with_precision(prec)
            x0, flags = chunk_inputs(cfg, p, structs, win, dev, C=n)
            packed = pack_params(cfg, p, s)
            got = forward_windows(cfg, p, s, x0, *flags, win, packed=packed)
            ref = forward_windows_reference(cfg, p, s, x0, *flags, win)
            torch.cuda.synchronize()
            err = (got - ref).abs().max().item()
            rows = win + flags[2].sum(dim=1)
            out[key][prec] = dict(windows=x0.shape[0], max_abs_err=err,
                                  active_rows_mean=rows.float().mean().item(),
                                  active_rows_max=int(rows.max().item()))
            if not (err <= tol and torch.isfinite(got).all()):
                raise AssertionError(f"staged route, {key} at L {win} ({prec}): max abs {err} "
                                     f"> {tol}")
            if key == "forgi":
                timed.append((prec, cfg, p, s, x0, flags, packed))
    out.update(launches=forward_windows.launches, bf16_launches=forward_windows.bf16_launches,
               staged_launches=forward_windows.staged_launches)
    if (forward_windows.launches, forward_windows.bf16_launches,
            forward_windows.staged_launches) != (4, 2, 4):
        raise AssertionError(f"{forward_windows.staged_launches} of {forward_windows.launches} "
                             f"launches ({forward_windows.bf16_launches} bf16) took the staged "
                             "route; want 4 of 4 (2 bf16)")
    for prec, cfg, p, s, x0, flags, packed in timed:
        rate = TF32X3_FLOPS if prec == "highest" else BF16_FLOPS
        ms = cuda_ms(lambda: forward_windows(cfg, p, s, x0, *flags, L, packed=packed), 20)
        plain_ms = cuda_ms(lambda: forward_windows_reference(cfg, p, s, x0, *flags, L), 5)
        bound_ms, bound_by, _ = encoder_bound_ms(cfg, x0, flags, packed, L, rate)
        out["forgi"][prec].update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                  bound_by=bound_by, share_of_bound=bound_ms / ms)
    return out


def ptxas_summary(log: str) -> dict:
    """ptxas's registers, stack and spills of every kernel in ``build.log``,
    by kernel; the warp route's instantiations as ``dp_warp_kernel<R,
    global|local>``, K1's routes as ``windows_encoder_kernel<3xtf32|bf16>``
    and, staged, ``windows_encoder_kernel<3xtf32|bf16, staged>``, the loss's
    templates as ``contrastive_*_kernel<double|float>``."""
    out = {}
    for name, props, used in re.findall(
            r"Function properties for (\S+)\n\s*(.*)\nptxas info\s*: (Used .*)", log):
        m = re.search(r"(\w+_kernel)(?:ILi(\d+)ELb([01])E|ILb([01])E(?:Lb([01])E)?"
                      r"|I([df])E)?E", name)
        short = re.sub(r"^.*\d", "", m.group(1)) if m else name
        if m and m.group(2):
            short += f"<{m.group(2)}, {'local' if m.group(3) == '1' else 'global'}>"
        elif m and m.group(4):
            short += ("<bf16" if m.group(4) == "1" else "<3xtf32") + (
                ", staged>" if m.group(5) == "1" else ">")
        elif m and m.group(6):
            short += "<double>" if m.group(6) == "d" else "<float>"
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
        n_tiles = s._shards[0].corpus.shape[0] // s.corpus_tile
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


def quiet_main(fn, argv, said: io.StringIO | None = None) -> float:
    """Seconds of one CLI run, its prints held back (in ``said`` when
    given), the card drained."""
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(said if said is not None else io.StringIO()):
        fn(argv)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def batch_as(batch, dtype):
    """``batch`` (a graph batch, or a train batch of them) with its float
    tensors in ``dtype``."""
    out = {}
    for f in dataclasses.fields(batch):
        v = getattr(batch, f.name)
        if dataclasses.is_dataclass(v):
            out[f.name] = batch_as(v, dtype)
        elif isinstance(v, torch.Tensor) and v.is_floating_point():
            out[f.name] = v.to(dtype)
    return dataclasses.replace(batch, **out)


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
                                                    WINDOW, dev)
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

def msa_family_tsv(path: str, n: int, lmax: int, d: int = MSA_DIM, seed: int = MSA_SEED,
                   lmin: int | None = None) -> str:
    """``bench_msa_scale.py::build_family_tsv`` without pandas: one base
    matrix, each record (of length ``lmin``, by default 0.8 ``lmax``, to
    ``lmax``) a prefix of it plus 0.15 noise (or the base and a noisy
    tail), values rounded to 4 places, written as ``DataFrame.to_csv``
    writes them."""
    rng = np.random.default_rng(seed)
    base_len = int(lmax * 0.95)
    base = rng.normal(size=(base_len, d)).astype(np.float32)
    with open(path, "w", newline="") as f:
        w = csv.writer(f, delimiter="\t", lineterminator="\n")
        w.writerow(["Name", "node_embeddings"])
        for k in range(n):
            Lk = int(rng.integers(int(lmax * 0.8) if lmin is None else lmin, lmax + 1))
            if Lk <= base_len:
                emb = base[:Lk] + 0.15 * rng.normal(size=(Lk, d)).astype(np.float32)
            else:
                emb = np.concatenate(
                    [base, 0.15 * rng.normal(size=(Lk - base_len, d)).astype(np.float32)])
            w.writerow([f"s{k}", json.dumps(emb.round(4).tolist())])
    return path


def oracle_seq_dot(muA: np.ndarray, muB: np.ndarray) -> np.ndarray:
    """The reference's column dots: one rounded float32 multiply and one
    rounded add per embedding dim (tests/test_profile_exact.py)."""
    S = np.zeros((muA.shape[0], muB.shape[0]), np.float32)
    for d in range(muA.shape[1]):
        S = S + muA[:, None, d] * muB[None, :, d]
    return S


def oracle_dp(S: np.ndarray, comp: np.ndarray, go: float, ge: float):
    """The reference's float32 profile DP (tests/test_profile_exact.py::oracle_dp)."""
    neg = np.float32(-1e30)
    La, Lb = S.shape
    M = np.full((La + 1, Lb + 1), neg, np.float32)
    X = np.full((La + 1, Lb + 1), neg, np.float32)
    Y = np.full((La + 1, Lb + 1), neg, np.float32)
    M[0, 0] = 0.0
    go32, ge32 = np.float32(go), np.float32(ge)
    for i in range(1, La + 1):
        X[i, 0] = max(np.float32(M[i - 1, 0] + go32), np.float32(X[i - 1, 0] + ge32))
    for j in range(1, Lb + 1):
        Y[0, j] = max(np.float32(M[0, j - 1] + go32), np.float32(Y[0, j - 1] + ge32))
    for d in range(2, La + Lb + 1):
        lo, hi = max(1, d - Lb), min(La, d - 1)
        if lo > hi:
            continue
        i = np.arange(lo, hi + 1)
        j = d - i
        prev = np.maximum(np.maximum(M[i - 1, j - 1], X[i - 1, j - 1]), Y[i - 1, j - 1])
        M[i, j] = (prev + S[i - 1, j - 1]) + comp[i - 1, j - 1]
        X[i, j] = np.maximum(M[i - 1, j] + go32, X[i - 1, j] + ge32)
        Y[i, j] = np.maximum(M[i, j - 1] + go32, Y[i, j - 1] + ge32)
    return M, X, Y


def oracle_walk(M, X, Y, La: int, Lb: int) -> list:
    """The reference's value-based traceback (tests/test_profile_exact.py::oracle_walk)."""
    i, j = La, Lb
    ops = []
    while i > 0 or j > 0:
        cur, st = -1e31, 0
        if i > 0 and j > 0 and M[i, j] > cur:
            cur, st = M[i, j], 0
        if i > 0 and X[i, j] > cur:
            cur, st = X[i, j], 1
        if j > 0 and Y[i, j] > cur:
            cur, st = Y[i, j], 2
        ops.append(st)
        if st == 0:
            i, j = i - 1, j - 1
        elif st == 1:
            i -= 1
        else:
            j -= 1
    return ops[::-1]


def msa_run(src: str, out_prefix: str, extra: list, device: str, pool: bool = True,
            said: io.StringIO | None = None) -> dict:
    """One run of the MSA CLI: wall seconds (the card drained), pairs,
    stage seconds, the progressive stage's path and split from
    run_meta.json.  ``pool=False`` runs it under ``GINFINITY_MSA_POOL=0``;
    its prints go to ``said`` when given."""
    old = os.environ.pop("GINFINITY_MSA_POOL", None)
    if not pool:
        os.environ["GINFINITY_MSA_POOL"] = "0"
    try:
        t = quiet_main(msa.main, ["--input", src, "--out-prefix", out_prefix,
                                  "--device", device] + MSA_FLAGS + extra, said)
    finally:
        os.environ.pop("GINFINITY_MSA_POOL", None)
        if old is not None:
            os.environ["GINFINITY_MSA_POOL"] = old
    with open(f"{out_prefix}.diagnostics/run_meta.json") as f:
        meta = json.load(f)
    refine = meta.get("refinement_split_sec", {})
    rec = {"seconds": t, "pairs": meta["num_pairs"], "pairs_per_s": meta["num_pairs"] / t,
           "stage_seconds": meta["stage_times_sec"],
           "outside_stages_seconds": t - sum(meta["stage_times_sec"].values())
           - refine.get("total_s", 0.0),
           "progressive_path": meta["progressive_path"],
           "progressive_pool": meta.get("progressive_pool"),
           "progressive_split_seconds": meta["progressive_split_sec"],
           "progressive_rounds": meta["progressive_rounds"]}
    if "refinement" in meta:
        rec.update(refinement=meta["refinement"], refinement_split_seconds=refine)
    return rec


def check_msa_outputs(out_prefix: str, records) -> None:
    """Every record in .fasta/.sto/.aln.tsv, one alignment length, each
    row its record with gaps; expected scores finite, N x N."""
    with open(f"{out_prefix}.aln.tsv", newline="") as f:
        rows = list(csv.DictReader(f, delimiter="\t"))
    lengths = {r.name: r.emb.shape[0] for r in records}
    if sorted(r["Name"] for r in rows) != sorted(lengths):
        raise AssertionError("the .aln.tsv does not hold every record once")
    if len({len(r["Aligned"]) for r in rows}) != 1:
        raise AssertionError("aligned rows of different lengths")
    for r in rows:
        if len(r["Aligned"].replace("-", "")) != lengths[r["Name"]]:
            raise AssertionError(f"{r['Name']}: the aligned row is not its record")
    with open(f"{out_prefix}.fasta") as f:
        if f.read().count(">") != len(lengths):
            raise AssertionError(".fasta: wrong record count")
    exp = np.loadtxt(f"{out_prefix}.diagnostics/expected_scores.tsv", ndmin=2)
    if exp.shape != (len(lengths),) * 2 or not np.isfinite(exp).all():
        raise AssertionError("expected_scores.tsv: wrong shape or not finite")


def msa_exact_check(records, dev) -> dict:
    """Check (a): the exact profile DP on the card, on MSA_EXACT_MERGES
    seeded leaf pairs of the family in one batch, against the numpy
    oracle: the column dots, M/X/Y and the op codes bit-equal."""
    rng = np.random.default_rng(SEED + 7)
    profiles = msa.initial_profiles(records)
    pick = rng.choice(len(profiles), size=(MSA_EXACT_MERGES, 2), replace=False)
    A = [profiles[a] for a, _ in pick]
    B = [profiles[b] for _, b in pick]
    go, ge = -10.0, -0.5
    l1 = np.array([a.mu_struct.shape[0] for a in A])
    l2 = np.array([b.mu_struct.shape[0] for b in B])
    P, Q, d = int(l1.max()), int(l2.max()), A[0].mu_struct.shape[1]
    mua = np.zeros((len(A), P, d), np.float32)
    mub = np.zeros((len(A), Q, d), np.float32)
    sta = np.zeros((len(A), P), np.float32)
    stb = np.zeros((len(A), Q), np.float32)
    for k, (a, b) in enumerate(zip(A, B)):
        mua[k, : l1[k]], mub[k, : l2[k]] = a.mu_struct, b.mu_struct
        sta[k, : l1[k]], stb[k, : l2[k]] = a.stem, b.stem
    t = lambda x: torch.from_numpy(x).to(dev)  # noqa: E731
    S = pairhmm._seq_dot_scores(t(mua), t(mub))
    C = pairhmm._comp_bonus(t(sta), t(stb))
    M, X, Y = pairhmm._dense(pairhmm._profile_states(S, t(l1), t(l2), go, ge, C))
    S = S.cpu().numpy()
    ops = pairhmm.profile_align_batch_ops_exact(
        [(a.mu_struct, b.mu_struct) for a, b in zip(A, B)], [(a.stem, b.stem) for a, b in zip(A, B)],
        go, ge, device=dev)
    cells = 0
    for k, (a, b) in enumerate(zip(A, B)):
        La, Lb = int(l1[k]), int(l2[k])
        So = oracle_seq_dot(a.mu_struct, b.mu_struct)
        if not np.array_equal(S[k, :La, :Lb], So):
            raise AssertionError(f"exact DP merge {k}: column dots differ from the oracle")
        comp = np.where((a.stem[:, None] >= 0.5) == (b.stem[None, :] >= 0.5),
                        np.float32(0.2), np.float32(0.0))
        Mo, Xo, Yo = oracle_dp(So, comp, go, ge)
        for name, got, want in (("M", M, Mo), ("X", X, Xo), ("Y", Y, Yo)):
            g = got[k, : La + 1, : Lb + 1]
            if not (np.array_equal(g > -1e29, want > -1e29)
                    and np.array_equal(g[want > -1e29], want[want > -1e29])):
                raise AssertionError(f"exact DP merge {k}: {name} differs from the oracle")
        if list(ops[k]) != oracle_walk(Mo, Xo, Yo, La, Lb):
            raise AssertionError(f"exact DP merge {k}: op codes differ from the oracle")
        cells += (La + 1) * (Lb + 1)
    return {"merges": len(A), "d": d, "lengths": [[int(x), int(y)] for x, y in zip(l1, l2)],
            "cells_compared": cells, "bit_equal": True}


def msa_slab_check(records, dev) -> dict:
    """Check (b): the library run's first posterior batches (the CLI's
    pairs, flags and library-mode gap open -4), on the card and on the
    CPU, densified: max abs difference."""
    pairs = msa.pairwise_pairs_to_compute(records, 2000)
    lmax = max(r.emb.shape[0] for r in records)
    k = min(20, _round_capacity(lmax))
    W = max(lmax, k)
    embs = np.zeros((len(records), W, records[0].emb.shape[1]), np.float32)
    lens = np.array([r.emb.shape[0] for r in records])
    for i, r in enumerate(records):
        embs[i, : lens[i]] = r.emb
    worst, n = 0.0, 0
    for s0 in range(0, 64 * MSA_SLAB_BATCHES, 64):
        chunk = pairs[s0:s0 + 64]
        dense = []
        for where in (dev, torch.device("cpu")):
            kv, ki, _ = pairhmm._pair_posteriors_from_embs(
                torch.from_numpy(embs).to(where), torch.from_numpy(lens).to(where),
                torch.tensor([a for a, _ in chunk], device=where),
                torch.tensor([b for _, b in chunk], device=where),
                5.0, 0.0, -4.0, -0.5, 1e-4, False, k)
            out = torch.zeros((len(chunk), W, W), dtype=torch.float64, device=where)
            dense.append(out.scatter_add_(2, ki, kv.double()).cpu())
        worst = max(worst, float((dense[0] - dense[1]).abs().max()))
        n += len(chunk)
    if not worst <= MSA_SLAB_TOL:
        raise AssertionError(f"posterior slabs, card vs CPU: max abs {worst} > {MSA_SLAB_TOL}")
    return {"pairs": n, "max_abs_err": worst, "tolerance": MSA_SLAB_TOL}


def head_tsv(src: str, dst: str, rows: int) -> str:
    """``src``, or its header and first ``rows`` records written to ``dst``
    when it holds more."""
    if rows >= MSA_N:
        return src
    with open(src) as f, open(dst, "w") as g:
        for i, line in enumerate(f):
            if i <= rows:
                g.write(line)
    return dst


def aln_rows(prefix: str) -> dict:
    with open(f"{prefix}.aln.tsv", newline="") as f:
        return {r["Name"]: r["Aligned"] for r in csv.DictReader(f, delimiter="\t")}


def parse_check(src: str) -> dict:
    """Check (i): the family's TSV read with the native scanner (its build
    first, timed apart) and with the json path alone: seconds, and the
    arrays identical."""
    t0 = time.perf_counter()
    native.build_library()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fast = msa.load_tsv(src, "Name", "node_embeddings")
    fast_s = time.perf_counter() - t0
    real = msa.parse_float_matrix
    msa.parse_float_matrix = lambda cell: None  # every cell through json
    try:
        t0 = time.perf_counter()
        slow = msa.load_tsv(src, "Name", "node_embeddings")
        json_s = time.perf_counter() - t0
    finally:
        msa.parse_float_matrix = real
    same = len(fast) == len(slow) and all(
        a.name == b.name and a.emb.dtype == b.emb.dtype and a.emb.shape == b.emb.shape
        and a.emb.tobytes() == b.emb.tobytes() for a, b in zip(fast, slow))
    if not same:
        raise AssertionError("the native scanner's arrays differ from the json path's")
    return {"native_build_seconds": build_s, "tsv_parse_seconds": fast_s,
            "tsv_parse_json_seconds": json_s, "arrays_identical": same, "records": len(fast)}, fast


def accumulator_check(run: dict, dev) -> dict:
    """Check (f), first half: the library run's own slabs and alignment,
    split at the guide tree's root, scattered by ``_accumulate_device`` on
    the card and on the CPU: max abs difference (0: the card adds in the
    CPU's order)."""
    lib, tree, aln, profiles = run["library"], run["tree"], run["aln"], run["profiles"]

    def members(node):
        return [node] if isinstance(node, int) else members(node[0]) + members(node[1])

    left = set(members(tree[0]))
    A = msa.extract_subprofile(aln, [m for m in aln.member_indices if m in left], profiles)
    B = msa.extract_subprofile(aln, [m for m in aln.member_indices if m not in left], profiles)
    S_card, las, lbs, _ = lib._accumulate_device([(A, B)])
    cpu = msa.PosteriorLibrary(lib.pairs, None, None, lib.lengths,
                               device_slabs=tuple(x.cpu() for x in lib.device_slabs))
    S_cpu = cpu._accumulate_device([(A, B)])[0]
    err = float((S_card.cpu() - S_cpu).abs().max())
    nA, nB = len(A.member_indices), len(B.member_indices)
    entries = sum(1 for a, b in lib.pairs if (a in left) != (b in left))
    chunk = library_pool._entry_chunk_width(len(lib.pairs))
    rec = {"merge": [nA, nB], "columns": [las[0], lbs[0]], "entries": entries,
           "entry_chunks": -(-entries // chunk), "max_abs_err": err,
           "nonzero_cells": int((S_cpu != 0).sum())}
    if err != 0.0:
        raise AssertionError(f"library accumulator, card vs CPU: max abs {err}")
    return rec


def msa_path(tmp: str, dev) -> dict:
    """``ginfinity-embed-msa`` on the N=200 / L<=300 family with the bench's
    flags, in library mode (the default) and profile mode, on the device
    pools, with checks (a)-(i); returns the phase's record and the
    family's records."""
    rec = {}
    t0 = time.perf_counter()
    src = msa_family_tsv(os.path.join(tmp, "family.tsv"), MSA_N, MSA_LMAX)
    rec["family"] = {"records": MSA_N, "lmax": MSA_LMAX, "dim": MSA_DIM, "seed": MSA_SEED,
                     "write_seconds": time.perf_counter() - t0,
                     "tsv_bytes": os.path.getsize(src)}
    rec["parse"], records = parse_check(src)  # check (i)
    rec["tsv_parse_seconds"] = rec["parse"]["tsv_parse_seconds"]
    for r in records:
        r.emb = msa._l2_normalize_rows(r.emb)

    # the main path: both modes on the pools, every enqueue loop under the
    # sync guard (check (g)); the library run's stage kept for check (f)
    kept = {}
    real_tree = msa.msa_from_tree

    def keep(tree, profiles, *a, **kw):
        aln = real_tree(tree, profiles, *a, **kw)
        kept.update(tree=tree, profiles=profiles, library=kw.get("library"), aln=aln)
        return aln

    forward_windows.launches = forward_windows.bf16_launches = 0
    dp_wavefront.launches = wavefront_plain.launches = 0
    value_traceback.launches = 0
    profile_pool.check_no_sync, guarded0 = True, profile_pool.guarded_loops
    msa.msa_from_tree = keep
    try:
        lib = os.path.join(tmp, "lib", "msa")
        rec["library"] = msa_run(src, lib, [], str(dev))
        lib_run = dict(kept)
        prof = os.path.join(tmp, "prof", "msa")
        rec["profile"] = msa_run(src, prof, ["--dp-score", "profile"], str(dev))
    finally:
        msa.msa_from_tree = real_tree
        profile_pool.check_no_sync = False
    rec["traceback_kernel_launches"] = value_traceback.launches
    rec["guarded_enqueue_loops"] = profile_pool.guarded_loops - guarded0
    main_counts = (forward_windows.launches, forward_windows.bf16_launches,
                   dp_wavefront.launches, wavefront_plain.launches)
    check_msa_outputs(lib, records)
    check_msa_outputs(prof, records)
    rec["profile"]["records"] = MSA_N

    # (e) the pools ran, with no overflow; the same inputs on the host path
    paths = {m: rec[m]["progressive_path"] for m in ("library", "profile")}
    if paths != {"library": "library_pool", "profile": "pool"} \
            or rec["guarded_enqueue_loops"] != 2 or value_traceback.launches <= 0:
        raise AssertionError(f"the N = {MSA_N} family's progressive paths {paths}, "
                             f"{rec['guarded_enqueue_loops']} guarded loops, "
                             f"{value_traceback.launches} traceback launches")
    host = rec["pool_vs_host"] = {}
    for mode, pre in (("library", lib), ("profile", prof)):
        out = os.path.join(tmp, f"{mode}_host", "msa")
        h = msa_run(src, out, ["--dp-score", mode], str(dev), pool=False)
        a, b = aln_rows(pre), aln_rows(out)
        host[mode] = {"pool_progressive_seconds": rec[mode]["stage_seconds"]
                      ["progressive_alignment"],
                      "host_progressive_seconds": h["stage_seconds"]["progressive_alignment"],
                      "host_path": h["progressive_path"], "host_seconds": h["seconds"],
                      "host_split_seconds": h["progressive_split_seconds"],
                      "aln_tsv_rows_differing": sum(a[k] != b.get(k) for k in a),
                      "rows": len(a)}

    # (f) the accumulator, card against CPU; two card runs of the library pool
    rec["accumulator_card_vs_cpu"] = accumulator_check(lib_run, dev)
    again = os.path.join(tmp, "lib_again", "msa")
    rec["library_again_seconds"] = msa_run(src, again, [], str(dev))["seconds"]
    with open(f"{lib}.aln.tsv", "rb") as f, open(f"{again}.aln.tsv", "rb") as g:
        rec["library_two_card_runs_identical"] = f.read() == g.read()
    if not rec["library_two_card_runs_identical"]:
        raise AssertionError("two card runs of the library pool wrote different .aln.tsv")

    rec["exact_dp_vs_oracle"] = msa_exact_check(records, dev)
    rec["slabs_card_vs_cpu"] = msa_slab_check(records, dev)

    # check (c): a small family's alignments, card against the port's CPU
    # run, on the pools and on the host path
    small = msa_family_tsv(os.path.join(tmp, "small.tsv"), *MSA_SMALL)
    same = {}
    for mode in ("library", "profile"):
        for pool in (True, False):
            texts = []
            for where in (str(dev), "cpu"):
                tag = f"small_{mode}_{'pool' if pool else 'host'}_{where.replace(':', '')}"
                out = os.path.join(tmp, tag, "msa")
                msa_run(small, out, ["--dp-score", mode], where, pool=pool)
                with open(f"{out}.aln.tsv", "rb") as f:
                    texts.append(f.read())
            same[f"{mode}_{'pool' if pool else 'host'}"] = texts[0] == texts[1]
    rec["small_family_aln_tsv_card_equals_cpu"] = same
    if not all(same.values()):
        raise AssertionError(f"small family .aln.tsv, card vs CPU: {same}")

    # check (d): the MSA's main path launches neither K1 nor K2
    rec.update(window_kernel_launches=main_counts[0], dp_kernel_launches=main_counts[2],
               plain_dp_launches=main_counts[3])
    if any(main_counts) or forward_windows.launches or dp_wavefront.launches:
        raise AssertionError("the MSA path launched K1 or K2")
    return rec, records


def traceback_check(dev) -> dict:
    """Check (h): the traceback kernel against its plain version on the
    card, on the states of random and of integer (tie-rich) scores at
    B = 64, P = 384, and its times; launches here are not the path's."""
    rng = np.random.default_rng(SEED + 11)
    B, P = TB_SHAPE
    rec, errs = {}, []
    for name, ties in (("random", False), ("ties", True)):
        S = rng.normal(size=(B, P, P)).astype(np.float32)
        if ties:
            S = np.round(S * 2).astype(np.float32)
        l1 = torch.from_numpy(rng.integers(P // 2, P + 1, B)).to(dev)
        l2 = torch.from_numpy(rng.integers(P // 2, P + 1, B)).to(dev)
        l1[0] = l2[0] = P
        ST = pairhmm._profile_states(torch.from_numpy(S).to(dev), l1, l2, -1.0, -0.5)
        got = value_traceback(ST, l1, l2)
        want = value_traceback_plain(ST, l1, l2)
        torch.cuda.synchronize()
        diff = int((got.int() - want.int()).abs().max())
        steps = int((got != 3).sum())
        rec[name] = {"codes_max_abs_err": diff, "codes_differing": int((got != want).sum()),
                     "path_steps": steps}
        errs.append(diff)
        if diff:
            raise AssertionError(f"traceback kernel vs plain ({name}): codes differ")
        if name == "random":
            ms = cuda_ms(lambda: value_traceback(ST, l1, l2), 20)
            plain_ms = cuda_ms(lambda: value_traceback_plain(ST, l1, l2), 2)
            # bytes: three floats read per step walked, a code byte written per
            # step, the lengths read; a handful of compares per step
            nbytes = 12 * steps + B * 2 * P + 8 * B
            bound_ms = max(nbytes / HBM_BYTES_PER_S, 10 * steps / 67e12) * 1e3
            rec.update(B=B, P=P, ms=ms, plain_ms=plain_ms, bytes=nbytes, bound_ms=bound_ms,
                       bound_by="bytes", chain_steps=2 * P,
                       ns_per_chain_step=ms * 1e6 / (2 * P), states_bytes=ST.numel() * 4)
    rec["max_abs_err"] = max(errs)
    return rec


def long_slabs(n: int, n_pairs: int, W: int, k: int, seed: int, dev):
    """Seeded row slabs for ``msa_long_path`` (a), made on ``dev``: records
    of length W - 100 .. W; pairs joining each record of a seeded order to
    the next 1, 2, ... 5 (then 6) records, about 10 neighbours a record,
    as ``--max-pairs`` picks nearest neighbours; each row of a pair k
    distinct columns within the partner's length (random gaps of at most
    (W - 100) / k), values in (0, 1]; rows past the record's length empty,
    as the posterior stage leaves them."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(W - 100, W + 1, size=n)
    order = rng.permutation(n)
    pairs: set = set()
    d = 1
    while len(pairs) < n_pairs:
        for i in range(n - d):
            if len(pairs) < n_pairs:
                pairs.add(tuple(sorted((int(order[i]), int(order[i + d])))))
        d += 1
    pairs = sorted(pairs)
    g = torch.Generator(device=dev).manual_seed(seed)
    T = len(pairs)
    la = torch.tensor([lens[a] for a, _ in pairs], device=dev)
    lb = torch.tensor([lens[b] for _, b in pairs], device=dev)
    ends = torch.randint(1, (W - 100) // k + 1, (T, W, k), generator=g, device=dev).cumsum(-1)
    room = lb[:, None] - ends[..., -1]
    off = (torch.rand((T, W), generator=g, device=dev) * (room + 1)).floor().long()
    live = (torch.arange(W, device=dev)[None, :] < la[:, None])[..., None]
    ki = torch.where(live, off[..., None] + ends - 1, torch.arange(k, device=dev))
    kv = (1.0 - torch.rand((T, W, k), generator=g, device=dev)) ** 3 * live
    return pairs, kv, ki


@contextlib.contextmanager
def dense_budget(mb: int | None):
    """``GINFINITY_MSA_DENSE_BUDGET_MB`` set to ``mb`` (unset: the card's
    default) for the block, restored after."""
    old = os.environ.pop("GINFINITY_MSA_DENSE_BUDGET_MB", None)
    if mb is not None:
        os.environ["GINFINITY_MSA_DENSE_BUDGET_MB"] = str(mb)
    try:
        yield
    finally:
        os.environ.pop("GINFINITY_MSA_DENSE_BUDGET_MB", None)
        if old is not None:
            os.environ["GINFINITY_MSA_DENSE_BUDGET_MB"] = old


def timed_rounds(kv, ki, pairs, n: int, k: int, dev, mb: int | None = None):
    """One consistency round on the card under budget ``mb``: the new
    slabs, and the round's record with its seconds and peak memory.  The
    memory the round takes above what was resident before must stay
    within the estimate that chose it."""
    with dense_budget(mb):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        start = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        out = msa._consistency_rounds_on_slabs(kv, ki, pairs, n, 1, 0.5, 1e-4, k)
        torch.cuda.synchronize()
        rec = dict(msa.last_consistency_round, seconds=time.perf_counter() - t0,
                   peak_bytes=torch.cuda.max_memory_allocated(dev),
                   peak_reserved_bytes=torch.cuda.max_memory_reserved(dev),
                   resident_before_bytes=start)
    estimate = rec[f"{rec['round']}_bytes"]
    if rec["peak_bytes"] - start > estimate:
        raise AssertionError(f"the {rec['round']} round took {rec['peak_bytes'] - start} B "
                             f"above resident, past its estimate {estimate} B")
    return out, rec


def memo_then_tiled(run, same) -> dict:
    """``run(mb)`` -> (output, record) under the card's default budget (the
    memo round), then 1 MiB below the memo estimate (the tiled round, on
    the same blocks); ``same`` must hold for the two outputs."""
    memo_out, memo = run(None)
    tiled_out, tiled = run((memo["memo_bytes"] >> 20) - 1)
    blocks = [(r["pair_block"], r["product_batch"]) for r in (memo, tiled)]
    if (memo["round"], tiled["round"]) != ("memo", "tiled") or blocks[0] != blocks[1]:
        raise AssertionError(f"rounds {memo['round']}, {tiled['round']} on blocks {blocks}")
    if not same(memo_out, tiled_out):
        raise AssertionError("the tiled round's output differs from the memo round's")
    return {"memo": memo, "tiled": tiled, "identical": True}


def round_of_pairs(kv, ki, pairs, n: int, ids: np.ndarray, k: int, batch: int):
    """One tiled round's new slabs ``(values, indices)`` of the pairs
    ``ids`` (ascending) alone, on kv's device, ``batch`` products to a
    batched product: what ``_consistency_rounds_on_slabs`` gives them."""
    sched = msa._schedule(pairs, n)
    return msa._update_pairs(msa._Slabs(kv, ki, kv.device, memo=False), ids, sched,
                             msa._round_consts(sched[4], 0.5, kv.dtype, kv.device),
                             float(np.float32(1e-4)), k, batch)


def msa_long_path(tmp: str, dev) -> dict:
    """The consistency round at rRNA length: (a) alone, on seeded slabs
    (N = 400, T = 2,000, W = 2,000, k = 20) whose memo round the card
    cannot hold: the tiled round under the card's default budget, its
    peak memory within its estimate, two runs identical, 4 seeded pairs
    recomputed on the CPU and alone on the card in batches of 1 and 3
    products identical; and a smaller instance (N = 100, T = 500) where
    both rounds fit, identical, each within its estimate; (b)
    ``ginfinity-embed-msa`` on a 16-record family of
    L 1,400-1,500, d 128, in both modes on the pools, memo and tiled:
    the same ``.fasta``, ``.sto`` and ``.aln.tsv``."""
    torch.cuda.empty_cache()
    n, T, W, k = MSA_LONG
    t0 = time.perf_counter()
    pairs, kv, ki = long_slabs(n, T, W, k, MSA_SEED, dev)
    torch.cuda.synchronize()
    a = {"records": n, "pairs": T, "width": W, "k": k,
         "slabs_seconds": time.perf_counter() - t0,
         "card_bytes": torch.cuda.get_device_properties(dev).total_memory}
    outs, runs = [], []
    for _ in range(2):
        out, r = timed_rounds(kv, ki, pairs, n, k, dev)
        outs.append(out)
        runs.append(r)
    # dense float64 products, at the card's FP64 tensor-core peak (67 TFLOP/s)
    tflop = 2 * runs[0]["products"] * W ** 3 / 1e12
    a.update(runs=runs, product_tflop=tflop, product_bound_seconds=tflop / 67,
             two_runs_identical=all(torch.equal(x, y) for x, y in zip(outs[0], outs[1])))
    if runs[0]["round"] != "tiled" or runs[0]["memo_bytes"] <= a["card_bytes"]:
        raise AssertionError(f"(a) took the {runs[0]['round']} round, memo estimate "
                             f"{runs[0]['memo_bytes']} B on a {a['card_bytes']} B card")
    if not a["two_runs_identical"]:
        raise AssertionError("(a) two card runs of the tiled round differ")
    ids = np.sort(np.random.default_rng(MSA_SEED).choice(T, MSA_LONG_CPU_PAIRS, replace=False))
    card = [x[torch.from_numpy(ids).to(dev)] for x in outs[0]]
    t0 = time.perf_counter()
    cpu = round_of_pairs(kv.cpu(), ki.cpu(), pairs, n, ids, k, runs[0]["product_batch"])
    a["cpu_seconds"] = time.perf_counter() - t0
    a.update(cpu_pairs=[pairs[t] for t in ids.tolist()], cpu_identical=torch.equal(
        msa._densify(*cpu), msa._densify(*card).cpu()))
    if not a["cpu_identical"]:
        raise AssertionError(f"(a) pairs {a['cpu_pairs']}: card and CPU slabs differ")
    # the products' batching does not reach the sums: those pairs alone,
    # 1 and 3 products to a batched product, on the card
    for batch in (1, 3):
        if not torch.equal(msa._densify(*round_of_pairs(kv, ki, pairs, n, ids, k, batch)),
                           msa._densify(*card)):
            raise AssertionError(f"(a) pairs {a['cpu_pairs']} differ in batches of {batch}")
    a["batches_identical"] = [1, 3, runs[0]["product_batch"]]
    del outs, kv, ki, card

    n2, T2 = MSA_LONG_BOTH
    pairs2, kv2, ki2 = long_slabs(n2, T2, W, k, MSA_SEED + 1, dev)

    def run_small(mb):
        (v, i), r = timed_rounds(kv2, ki2, pairs2, n2, k, dev, mb)
        return (v.cpu(), i.cpu()), r

    a["both_fit"] = {"records": n2, "pairs": T2, **memo_then_tiled(
        run_small, lambda x, y: all(torch.equal(p, q) for p, q in zip(x, y)))}
    del kv2, ki2
    torch.cuda.empty_cache()

    # (b) the CLI at full width, memo then tiled, each mode
    fam_n, lmin, lmax = MSA_LONG_FAMILY
    src = msa_family_tsv(os.path.join(tmp, "long.tsv"), fam_n, lmax, lmin=lmin)
    b = {"family": {"records": fam_n, "lmin": lmin, "lmax": lmax, "dim": MSA_DIM,
                    "seed": MSA_SEED}}
    records = msa.load_tsv(src, "Name", "node_embeddings")
    for mode in ("library", "profile"):
        def run_cli(mb, mode=mode):
            out = os.path.join(tmp, f"{mode}_{'memo' if mb is None else 'tiled'}", "msa")
            launches = value_traceback.launches
            with dense_budget(mb):
                torch.cuda.reset_peak_memory_stats(dev)
                r = msa_run(src, out, ["--dp-score", mode], str(dev))
            check_msa_outputs(out, records)
            r.update(msa.last_consistency_round, peak_bytes=torch.cuda.max_memory_allocated(dev),
                     traceback_kernel_launches=value_traceback.launches - launches)
            files = []
            for suffix in (".fasta", ".sto", ".aln.tsv"):
                with open(out + suffix, "rb") as f:
                    files.append(f.read())
            return files, r

        b[mode] = memo_then_tiled(run_cli, operator.eq)
    return {"round_alone": a, "cli": b}


def truth_msa(members) -> dict:
    """The true alignment of a family: one column per ancestor coordinate
    and one per insertion (tests/test_msa_quality.py)."""
    keys, per_member = set(), []
    for mi, m in enumerate(members):
        prev, serial, mkeys = -1, 0, []
        for anc in m.posmap:
            if anc >= 0:
                prev, serial = int(anc), 0
                k = (int(anc), 0, 0, 0)
            else:
                serial += 1
                k = (prev, 1, mi, serial)
            keys.add(k)
            mkeys.append(k)
        per_member.append(mkeys)
    col_of = {k: i for i, k in enumerate(sorted(keys))}
    out = {}
    for m, mkeys in zip(members, per_member):
        row = ["-"] * len(col_of)
        for k in mkeys:
            row[col_of[k]] = "x"
        out[m.name] = "".join(row)
    return out


def node_rows(tsv: str) -> dict:
    with open(tsv, newline="") as f:
        return {r["Name"]: node_embed.parse_matrix(r["node_embeddings"])
                for r in csv.DictReader(f, delimiter="\t")}


def region_pair(members, lo: int, hi: int):
    """Two members' spans of the positions with ancestor coordinates in
    [lo, hi], as (name, start, end) with 1-based positions, and how many
    offsets of the two spans are homologous (the same ancestor
    coordinate): of the pairs whose spans are equally long (the optimizer
    scores equal spans offset by offset), the one with the most."""
    spans = []
    for m in members:
        pos = np.nonzero((m.posmap >= lo) & (m.posmap <= hi))[0]
        spans.append((m.name, int(pos[0]), int(pos[-1])))
    best = None
    for a in range(len(spans)):
        for b in range(a + 1, len(spans)):
            (_, a0, a1), (_, b0, b1) = spans[a], spans[b]
            if a1 - a0 != b1 - b0:
                continue
            pa, pb = members[a].posmap[a0:a1 + 1], members[b].posmap[b0:b1 + 1]
            hom = int(((pa == pb) & (pa >= 0)).sum())
            if best is None or hom > best[0]:
                best = (hom, a, b)
    if best is None:
        raise AssertionError("no two members span the region equally")
    hom, a, b = best
    return [(n, s0 + 1, s1 + 1) for n, s0, s1 in (spans[a], spans[b])], hom


def msa_tools_path(tmp: str, dev, records, cfg, params, state) -> dict:
    """Refinement, msa_eval, the optimizer and prewarm on the card, with
    checks (a)-(f); ``tmp`` holds msa_path's family TSVs."""
    forward_windows.launches = forward_windows.bf16_launches = 0
    dp_wavefront.launches = wavefront_plain.launches = 0
    rec = {}
    parts = rec["part_seconds"] = {}
    t_part = time.perf_counter()

    # (a) refinement at full width: the family's first MSA_REFINE_ROWS
    # records in library mode
    out = os.path.join(tmp, "refine", "msa")
    src = head_tsv(os.path.join(tmp, "family.tsv"), os.path.join(tmp, "family_refine.tsv"),
                   MSA_REFINE_ROWS)
    rec["refine_full"] = r = msa_run(src, out, ["--refine-iters", str(MSA_REFINE_ITERS)],
                                     str(dev))
    r["records"] = min(MSA_REFINE_ROWS, MSA_N)
    check_msa_outputs(out, records[:MSA_REFINE_ROWS])
    if not r["refinement"]["sp_final"] >= r["refinement"]["sp_initial"] - 1e-6:
        raise AssertionError(f"refinement lowered the SP score: {r['refinement']}")
    # library mode's realigns take the fused device scatter + DP
    if r["refinement_split_seconds"]["fused"] != MSA_REFINE_ITERS:
        raise AssertionError(f"{r['refinement_split_seconds']['fused']} of "
                             f"{MSA_REFINE_ITERS} realigns took the fused merge_ops")

    parts["a_refine_full"] = time.perf_counter() - t_part
    t_part = time.perf_counter()

    # (b) the small family refined in both modes, card against CPU
    small = os.path.join(tmp, "small.tsv")
    rec["refine_small"] = {}
    for mode in ("library", "profile"):
        runs = []
        for where in (str(dev), "cpu"):
            out = os.path.join(tmp, f"refine_small_{mode}_{where.replace(':', '')}", "msa")
            runs.append(msa_run(small, out, ["--dp-score", mode, "--refine-iters",
                                             str(MSA_SMALL_REFINE_ITERS)], where))
            with open(f"{out}.aln.tsv", "rb") as f:
                runs[-1]["aln"] = f.read()
        same = runs[0].pop("aln") == runs[1].pop("aln")
        rec["refine_small"][mode] = {
            "card": runs[0], "cpu_seconds": runs[1]["seconds"], "aln_tsv_card_equals_cpu": same,
            "refinement_card_equals_cpu": runs[0]["refinement"] == runs[1]["refinement"]}
        if not (same and runs[0]["refinement"] == runs[1]["refinement"]):
            raise AssertionError(f"small family refined ({mode}), card vs CPU: "
                                 f"{runs[0]['refinement']} vs {runs[1]['refinement']}")

    parts["b_refine_small_card_cpu"] = time.perf_counter() - t_part
    t_part = time.perf_counter()

    # (c) msa_eval: a known-homology family embedded with the flagship on
    # the card and the CPU, aligned in both modes, scored against the truth
    seed, n_seqs, anc_len = MSA_EVAL_FAMILY
    members = msa_eval.make_family(seed, n_seqs=n_seqs, anc_len=anc_len)
    ckpt = os.path.join(tmp, "flagship.pth")
    export_torch_checkpoint(ckpt, cfg, params, state)
    tsv = {}
    ev = rec["msa_eval"] = {"family": {"seed": seed, "members": n_seqs, "anc_len": anc_len,
                                       "lengths": [len(m.structure) for m in members]}}
    for where in (str(dev), "cpu"):
        tsv[where] = os.path.join(tmp, f"eval_{where.replace(':', '')}.tsv")
        t0 = time.perf_counter()
        msa_eval.family_to_tsv(members, ckpt, tsv[where], device=where)
        ev[f"family_to_tsv_seconds_{'cpu' if where == 'cpu' else 'card'}"] = \
            time.perf_counter() - t0
    card_rows, cpu_rows = node_rows(tsv[str(dev)]), node_rows(tsv["cpu"])
    err = max(float(np.abs(card_rows[m.name] - cpu_rows[m.name]).max()) for m in members)
    ev["node_max_abs_err_vs_cpu"] = err
    if err > NODE_CPU_TOL:
        # F3's bar: no farther from a float64 run than twice the CPU's rows
        graphs = preprocess_structures([m.structure for m in members],
                                       [m.sequence for m in members]).graphs
        m64 = GINModel(cfg, params, state).to(torch.float64)
        x64 = get_node_embeddings(cfg, m64.params, m64.state,
                                  batch_as(batch_graphs(graphs), torch.float64)).numpy()
        offs = np.cumsum([0] + [g.n_nodes for g in graphs])
        ref = {m.name: x64[a:b] for m, a, b in zip(members, offs[:-1], offs[1:])}
        card64 = max(float(np.abs(card_rows[k] - ref[k]).max()) for k in ref)
        cpu64 = max(float(np.abs(cpu_rows[k] - ref[k]).max()) for k in ref)
        ev.update(node_card_vs_float64=card64, node_cpu_vs_float64=cpu64)
        if card64 > 2 * cpu64 + 1e-6:
            raise AssertionError(f"msa_eval node rows: card {err} from the CPU, {card64} "
                                 f"from float64 (CPU {cpu64})")
    truth = msa_eval.sp_scores(truth_msa(members), members)
    ev["truth"] = truth
    if not truth["sp_recall"] == truth["sp_precision"] == 1.0:
        raise AssertionError(f"the truth MSA scores {truth}")
    for mode in ("profile", "library"):
        prefix = os.path.join(tmp, f"eval_{mode}", "msa")
        with contextlib.redirect_stdout(io.StringIO()):
            sec = msa_eval.run_repo_msa(tsv[str(dev)], prefix, {}, dp_score=mode, device=dev)
        torch.cuda.synchronize()
        ev[mode] = {"seconds": sec,
                    **msa_eval.sp_scores(msa_eval.load_aln_tsv(prefix + ".aln.tsv"), members)}
    prefix = os.path.join(tmp, "eval_library_cpu", "msa")
    with contextlib.redirect_stdout(io.StringIO()):
        ev["library_cpu_seconds"] = msa_eval.run_repo_msa(tsv[str(dev)], prefix, {},
                                                          dp_score="library", device="cpu")
    with open(prefix + ".aln.tsv", "rb") as f, \
            open(os.path.join(tmp, "eval_library", "msa.aln.tsv"), "rb") as g:
        ev["library_aln_tsv_cpu_equals_card"] = f.read() == g.read()
    if not ev["library_aln_tsv_cpu_equals_card"]:
        raise AssertionError("msa_eval family: the CPU rerun wrote another .aln.tsv")

    parts["c_msa_eval"] = time.perf_counter() - t_part
    t_part = time.perf_counter()

    # (d) the optimizer on (c)'s TSV, scored on a region of known homology
    ((na, a0, a1), (nb, b0, b1)), hom = region_pair(members, *OPT_REGION)
    regions = os.path.join(tmp, "regions.tsv")
    with open(regions, "w") as f:
        f.write(f"Name\tStart\tEnd\n{na}\t{a0}\t{a1}\n{nb}\t{b0}\t{b1}\n")
    od = os.path.join(tmp, "opt")
    t = quiet_main(optimize_msa.main, [
        "--input", tsv[str(dev)], "--regions-tsv", regions, "--name-a", na, "--name-b", nb,
        "--n-trials", str(OPT_TRIALS), "--seed", "42", "--topk", "20",
        "--consistency-rounds", "1", "--outdir", od, "--study-name", "smoke",
        "--device", str(dev)])
    with open(os.path.join(od, "smoke", "trials.csv"), newline="") as f:
        trials = list(csv.DictReader(f))
    with open(os.path.join(od, "smoke", "best_params.json")) as f:
        best = json.load(f)
    values = [float(r["value"]) for r in trials]
    secs = []
    for k in range(len(trials)):
        with open(os.path.join(od, "smoke", f"trial_rs{k}", "trial_meta.json")) as f:
            secs.append(json.load(f)["elapsed_sec"])
    rec["optimize"] = {"seconds": t, "region": [[na, a0, a1], [nb, b0, b1]],
                       "homologous_offsets": hom, "true_alignment_score": 2 * hom - (a1 - a0 + 1),
                       "trials": [{"refine_iters": int(r["refine_iters"]), "value": v,
                                   "seconds": sc} for r, v, sc in zip(trials, values, secs)],
                       "best_params": best}
    if len(trials) != OPT_TRIALS or not all(np.isfinite(v) and v > -1e9 for v in values) \
            or set(best) != set(optimize_msa.PARAM_KEYS):
        raise AssertionError(f"optimizer: trials {values}, best_params {best}")

    parts["d_optimize"] = time.perf_counter() - t_part
    t_part = time.perf_counter()

    # (e) prewarm: the library build (window mode) and one MSA bucket
    corpus_csv = write_csv(os.path.join(tmp, "prewarm.csv"), "rid",
                           [m.structure for m in members])
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        res = prewarm.main(["--input", corpus_csv, "--model-path", ckpt, "--window-size",
                            str(WINDOW), "--keep-paired-neighbors"])
    rec["prewarm_windows"] = {"seconds": time.perf_counter() - t0,
                              "build_seconds": res["build_seconds"], "groups": res["groups"]}
    rec["prewarm_msa_seconds"] = quiet_main(prewarm.main, ["--msa", *map(str, MSA_SMALL)])

    parts["e_prewarm"] = time.perf_counter() - t_part

    # (f) none of it launches a kernel of the port
    rec.update(window_kernel_launches=forward_windows.launches,
               dp_kernel_launches=dp_wavefront.launches,
               plain_dp_launches=wavefront_plain.launches)
    if forward_windows.launches or forward_windows.bf16_launches or dp_wavefront.launches \
            or wavefront_plain.launches:
        raise AssertionError("the MSA tools launched K1 or K2")
    return rec


# --------------------------------------------------------------------------
# train_path: ginfinity-train and the train_eval probes
# --------------------------------------------------------------------------

# the alignment loss's kernel against the plain loss: the training cell's
# subset size (32 families of 5 graphs, M ~32k of width 512) and a size past
# 2^31 pairs, where only the float64 twin fits
LOSS_CELL_M, LOSS_WIDE_M, LOSS_DIM = 32_768, 50_000, 512


def loss_rows(seed: int, m: int, d: int, dev, groups: int = 32, members: int = 5):
    """``m`` rows shaped like the training cell's subset: ``groups``
    families of ``members`` graphs whose aligned positions share a label
    (and lie near one another), a tenth non-conserved, the last 1/64
    padding."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    n = m - m // 64
    per = -(-n // (groups * members))
    fam = torch.arange(n) // (members * per)
    member = (torch.arange(n) // per) % members
    pos = torch.arange(n) % per
    labels = torch.cat([fam * 100_000 + pos, -1 - torch.arange(m - n)])
    gids = torch.cat([fam * members + member, torch.full((m - n,), -1)])
    cats = torch.cat([(torch.rand(n, generator=g) < 0.1).to(torch.int64) * 4,
                      torch.full((m - n,), 5)])
    valid = torch.cat([torch.ones(n), torch.zeros(m - n)])
    centre = torch.randn(groups * per, d, generator=g)
    emb = torch.randn(m, d, generator=g)
    emb[:n] += 3.0 * centre[fam * per + pos]
    return [t.to(dev) for t in (emb, labels, gids, cats, valid)]


def _unit_rows(e):
    return e / torch.clamp(torch.linalg.vector_norm(e, dim=1, keepdim=True), min=1e-8)


def loss_kernel_vs_plain(m: int, d: int, dev, seed: int = SEED + 30, plain: bool = True,
                         margin: float = 0.2, temperature: float = 0.1) -> dict:
    """The alignment loss's kernel route (float32, through the loss's own
    normalisation) against the float64 twin, and the plain float32 loss
    against it where ``plain``: relative loss gaps, the gradient's largest
    element gap over its largest element, its norm gap (the cell's
    ``grad_gap`` of one leaf); two kernel runs bit-equal."""
    emb, labels, gids, cats, valid = loss_rows(seed, m, d, dev)
    cfg = AlignmentLossConfig(margin=margin, temperature=temperature)

    def kernel_run():
        e = emb.clone().requires_grad_(True)
        loss = alignment_contrastive_loss(e, labels, gids, cats, valid, cfg)
        loss.backward()
        return loss.detach(), e.grad

    n0 = (closs.contrastive_loss.launches, closs.contrastive_loss.backward_launches)
    loss_k, g_k = kernel_run()
    loss_k2, g_k2 = kernel_run()
    out = {"m": m, "d": d, "launches": closs.contrastive_loss.launches - n0[0],
           "backward_launches": closs.contrastive_loss.backward_launches - n0[1],
           "repeat_bitwise": bool(torch.equal(loss_k, loss_k2) and torch.equal(g_k, g_k2))}
    del g_k2
    e64 = emb.double().requires_grad_(True)
    x64 = _unit_rows(e64)
    loss64, dx64 = closs.contrastive_loss_blockwise(x64.detach(), labels, gids, cats, valid,
                                                    temperature, margin)
    x64.backward(dx64)
    g64 = e64.grad
    del dx64, x64
    scale, n64 = float(g64.abs().max()), float(torch.linalg.vector_norm(g64))

    def gaps(loss, g, tag):
        out[f"{tag}_loss_gap"] = abs(float(loss) - float(loss64)) / abs(float(loss64))
        out[f"{tag}_grad_max_gap"] = float((g.double() - g64).abs().max()) / scale
        out[f"{tag}_grad_norm_gap"] = abs(float(torch.linalg.vector_norm(g.double())) - n64) / n64

    gaps(loss_k, g_k, "kernel")
    out["loss"] = float(loss64)
    del g_k
    if plain:
        e = emb.clone().requires_grad_(True)
        loss_p = plain_alignment_loss(_unit_rows(e), labels, gids, cats, valid, cfg)
        loss_p.backward()
        gaps(loss_p.detach(), e.grad, "plain")
        del e, loss_p
    torch.cuda.empty_cache()
    return out


def check_loss_kernel(rec: dict) -> dict:
    """The kernel route's bars: its loss within 1e-6 of float64 (the training
    cell's ``loss_gap`` limit), its gradient's norm within the cell's
    ``grad_gap`` limit (0.02), and where the plain float32 loss fits, the
    gradient's elements no farther from float64 than 8 times the plain
    loss's (the rule of ``card_vs_cpu``: a float32 element is a sum over M
    terms); one launch each way a run, two runs bit-equal."""
    if not (rec["launches"] == 2 and rec["backward_launches"] == 2 and rec["repeat_bitwise"]
            and rec["kernel_loss_gap"] <= 1e-6 and rec["kernel_grad_norm_gap"] <= 0.02
            and rec["kernel_grad_max_gap"] <= 8 * rec.get("plain_grad_max_gap", np.inf)):
        raise AssertionError(f"loss kernel against float64: {rec}")
    return rec


def loss_kernel_ms(m: int, d: int, dev, reps: int = 5) -> dict:
    """The kernel route alone at ``m`` x ``d`` (CUDA events): forward, and
    forward plus backward, with the three products' floors."""
    emb, labels, gids, cats, valid = loss_rows(SEED + 31, m, d, dev)
    x = _unit_rows(emb)

    def fwd():
        with torch.no_grad():
            closs.contrastive_loss(x, labels, gids, cats, valid, 0.1, 0.2)

    def fwd_bwd():
        xr = x.detach().requires_grad_(True)
        closs.contrastive_loss(xr, labels, gids, cats, valid, 0.1, 0.2).backward()

    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    f, fb = cuda_ms(fwd, reps), cuda_ms(fwd_bwd, reps)
    flops = 3 * 2 * m * m * d
    return {"m": m, "d": d, "forward_ms": f, "backward_ms": fb - f, "total_ms": fb,
            "floor_3xtf32_ms": flops / TF32X3_FLOPS * 1e3, "floor_fma_ms": flops / F32_FLOPS * 1e3,
            "peak_above_inputs_bytes": torch.cuda.max_memory_allocated() - base}


def train_config(norm_type: str = "graph", dropout: float = 0.05, arch: str = "packaged"):
    """The config ``train_packaged_architecture`` trains (its flags through
    the train CLI's own parser and ``make_config``)."""
    args = train_cli.build_parser().parse_args([
        *train_eval.ARCH_FLAGS[arch], "--norm_type", norm_type, "--node_embed_norm",
        "zscore_l2", "--normalize_nodes_before_pool", "--dropout", str(dropout)])
    hidden = [int(h) for h in args.hidden_dim.split(",")]
    return train_cli.make_config(args, hidden if len(hidden) > 1 else hidden[0])


def write_pair_tables(tmp: str, families, seed: int) -> tuple[str, str]:
    """A triplet TSV (anchor and positive from one family, the negative
    from the next) and a regression TSV (random targets) over ``families``."""
    rng = np.random.default_rng(seed)
    n = len(families)
    trip = [[families[f][0].structure, families[f][1].structure,
             families[(f + 1) % n][2].structure] for f in range(n)]
    pairs = [[families[f][0].structure, families[f][3].structure, float(rng.random())]
             for f in range(n)]
    t = os.path.join(tmp, "triplets.tsv")
    write_tsv(t, ["anchor_structure", "positive_structure", "negative_structure"], trip)
    r = os.path.join(tmp, "pairs.tsv")
    write_tsv(r, ["anchor_structure", "positive_structure", "f_total_modifications"], pairs)
    return t, r


def one_step(cfg, loss_fn, params, state, batch, dev, dtype=torch.float32, seed=0):
    """Loss, gradients (by leaf path, float64 on the CPU) and new state of
    one train-mode forward and backward on ``dev``."""
    p = tree_map(lambda t: t.to(dev, dtype).clone().requires_grad_(True), params)
    s = tree_map(lambda t: t.to(dev, dtype), state)
    gen = torch.Generator(device=dev).manual_seed(seed)
    loss, new_state = loss_fn(cfg, p, s, batch_as(batch.to(dev), dtype), gen)
    loss.backward()
    grads = {"/".join(k): (v.grad if v.grad is not None else torch.zeros_like(v))
             .detach().cpu().double() for k, v in _leaves((), p)}
    return float(loss.detach()), grads, tree_map(lambda t: t.cpu().double(), new_state)


def mesh_step(cfg, loss_fn, params, state, stacked, dev, dtype=torch.float32, seed=0):
    """``one_step`` of a stack of ``MESH_SHARDS`` batches through the
    sharded train step on the mesh ``[dev] * MESH_SHARDS``: the shards'
    mean loss and gradients (by leaf path, float64 on the CPU) and the
    averaged new state."""
    mesh = DataMesh([dev] * MESH_SHARDS)
    ts = TrainState.create(tree_map(lambda t: t.to(dev, dtype), params),
                           tree_map(lambda t: t.to(dev, dtype), state), 1e-4)
    gen = torch.Generator(device=dev).manual_seed(seed)
    ts, loss = make_train_step(cfg, loss_fn, mesh)(ts, batch_as(stacked, dtype), gen)
    grads = {"/".join(k): (v.grad if v.grad is not None else torch.zeros_like(v))
             .detach().cpu().double() for k, v in _leaves((), ts.params)}
    return float(loss), grads, tree_map(lambda t: t.cpu().double(), ts.model_state)


def card_vs_cpu(cfg, loss_fn, params, state, batch, dev, step=one_step) -> dict:
    """One step on the card and on the CPU (float32): the loss within 1e-5
    relative; each gradient leaf (and batch norm's running statistics)
    within ``1e-5 * max(1, max|g|)`` of the CPU's, or no farther from a
    float64 CPU run than twice the float32 CPU run is (+1e-6 of the leaf's
    scale: the node checks' tie-break), or, failing both, the card's
    float64 run within 1e-9 (scaled) of the CPU's, the same function, and
    the card's float32 no farther from float64 than 8 times the CPU's
    (cuBLAS's float32 sums: up to 5 times the CPU's distance in alignment
    mode on an H100; a product in TF32 would sit 10-100 times farther).
    ``step`` is ``one_step`` or ``mesh_step``."""
    cpu_dev = torch.device("cpu")
    card = step(cfg, loss_fn, params, state, batch, dev)
    cpu = step(cfg, loss_fn, params, state, batch, cpu_dev)
    rel = abs(card[0] - cpu[0]) / max(abs(cpu[0]), 1e-30)
    if not rel <= TRAIN_TOL:
        raise AssertionError(f"train step loss: card {card[0]} vs CPU {cpu[0]}")

    def by_path(run):
        return {**{f"grad/{k}": v for k, v in run[1].items()},
                **{f"state/{'/'.join(p)}": v for p, v in _leaves((), run[2])
                   if "batch_norms" in p}}

    c32, w32 = by_path(card), by_path(cpu)
    f64 = {}
    routes = {"cpu_1e-5": 0, "float64_tie_break": 0, "float64_on_both": 0}
    worst = {"card_vs_cpu": 0.0, "card_to_f64_over_cpu_to_f64": 0.0}
    for k, w in w32.items():
        scale = max(1.0, float(w.abs().max()))
        err = float((c32[k] - w).abs().max()) / scale
        worst["card_vs_cpu"] = max(worst["card_vs_cpu"], err)
        if err <= TRAIN_TOL:
            routes["cpu_1e-5"] += 1
            continue
        if not f64:
            f64["cpu"] = by_path(step(cfg, loss_fn, params, state, batch, cpu_dev,
                                      torch.float64))
            f64["card"] = by_path(step(cfg, loss_fn, params, state, batch, dev,
                                       torch.float64))
        card_d = float((c32[k] - f64["cpu"][k]).abs().max())
        cpu_d = float((w - f64["cpu"][k]).abs().max())
        worst["card_to_f64_over_cpu_to_f64"] = max(worst["card_to_f64_over_cpu_to_f64"],
                                                   card_d / max(cpu_d, 1e-30))
        if card_d <= 2 * cpu_d + 1e-6 * scale:
            routes["float64_tie_break"] += 1
            continue
        same64 = float((f64["card"][k] - f64["cpu"][k]).abs().max()) <= 1e-9 * scale
        if not (same64 and card_d <= 8 * cpu_d + 1e-6 * scale):
            raise AssertionError(f"train step {k}: card {err * scale} from the CPU, "
                                 f"{card_d} from float64 (CPU {cpu_d}), float64 runs "
                                 f"{'equal' if same64 else 'apart'}")
        routes["float64_on_both"] += 1
    if f64:  # the same function: the card's float64 run against the CPU's
        worst["float64_card_vs_cpu"] = max(
            float((f64["card"][k] - v).abs().max()) / max(1.0, float(v.abs().max()))
            for k, v in f64["cpu"].items())
    return {"loss_card": card[0], "loss_cpu": cpu[0], "loss_rel_err": rel,
            "leaves": len(w32), "leaves_by_route": routes, **worst}


def repeat_step(cfg, loss_fn, params, state, batch, dev, mesh=None) -> dict:
    """The same train step (dropout on, one generator seed) twice on the
    card: gradients, updated parameters and state bit-equal.  With
    ``mesh``, the sharded step of a stacked ``batch``."""
    runs = []
    for _ in range(2):
        ts = TrainState.create(tree_map(lambda t: t.to(dev), params),
                               tree_map(lambda t: t.to(dev), state), 5e-4)
        gen = torch.Generator(device=dev).manual_seed(SEED + 7)
        ts, loss = make_train_step(cfg, loss_fn, mesh)(
            ts, batch if mesh is not None else batch.to(dev), gen)
        runs.append(([leaf.grad.clone() for _, leaf in _leaves((), ts.params)
                      if leaf.grad is not None],
                     [leaf.detach().clone() for _, leaf in _leaves((), ts.params)]
                     + [t.clone() for _, t in _leaves((), ts.model_state)], float(loss)))
    (g1, p1, l1), (g2, p2, l2) = runs
    same = (l1 == l2 and len(g1) == len(g2) and all(map(torch.equal, g1, g2))
            and all(map(torch.equal, p1, p2)))
    if not same:
        raise AssertionError("two runs of one train step on the card differ")
    return {"bit_equal": True, "loss": l1, "grad_leaves": len(g1)}


def epoch_split(cfg, params, state, ds, dev, loss_cfg) -> dict:
    """One training epoch of the alignment dataset as the train CLI runs
    it (batch size 32, 16 unaligned a graph, 5,000 negatives): host batch
    assembly and upload on the host's clock, each step's node embeddings,
    loss, backward and Adam from the CUDA events of the program's spans,
    and the epoch's wall time (synchronised)."""
    ts = TrainState.create(tree_map(lambda t: t.to(dev), params),
                           tree_map(lambda t: t.to(dev), state), 1e-4)
    step = make_train_step(cfg, alignment_loss_fn(loss_cfg))
    gen = torch.Generator(device=dev).manual_seed(SEED)
    batches = train_data.iter_alignment_batches(ds, 32, 16, np.random.default_rng(SEED),
                                                max_negatives=5000)
    host_s = upload_s = 0.0
    subsets, graphs, nodes = [], 0, 0
    torch.cuda.synchronize()
    trace.clear()
    t0 = time.perf_counter()
    with trace.recording():
        while True:
            t = time.perf_counter()
            b = next(batches, None)
            host_s += time.perf_counter() - t
            if b is None:
                break
            t = time.perf_counter()
            bd = b.to(dev)
            upload_s += time.perf_counter() - t
            graphs += int((b.graphs.n_nodes > 0).sum())
            nodes += int(b.graphs.node_mask.sum())
            step(ts, bd, gen)
            subsets.append((int(b.valid.sum()), b.valid.shape[0]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    recs = trace.recorded()
    trace.clear()
    ms = {k: span_sum(recs, f"train.{k}", device=True)
          for k in ("encode", "loss", "backward", "adam")}
    return {"steps": len(subsets), "graphs": graphs, "nodes": nodes,
            "subset_nodes": [m for m, _ in subsets], "subset_capacity": [c for _, c in subsets],
            "epoch_seconds": wall, "steps_per_s": len(subsets) / wall,
            "graphs_per_s": graphs / wall, "host_assembly_seconds": host_s,
            "upload_seconds": upload_s, "device_encode_ms": ms["encode"],
            "device_loss_ms": ms["loss"], "device_forward_ms": ms["encode"] + ms["loss"],
            "device_backward_ms": ms["backward"], "device_adam_ms": ms["adam"],
            "device_step_ms": span_sum(recs, "train.step", device=True)}


def log_series(log_path: str, key: str) -> list:
    with open(log_path) as f:
        return [float(ln.split(":", 1)[1]) for ln in f if ln.startswith(key + ":")]


@contextlib.contextmanager
def interrupted_at_epoch(epoch: int):
    """Ctrl-C at the given epoch's early-stopping update, the best-weights
    prompt answered "n" (the train CLI's interactive path, unattended)."""
    call, ask, calls = EarlyStopping.__call__, builtins.input, []

    def interrupting(es, val, ts):
        calls.append(1)
        if len(calls) >= epoch:
            raise KeyboardInterrupt
        return call(es, val, ts)

    EarlyStopping.__call__, builtins.input = interrupting, lambda *a: "n"
    try:
        yield
    finally:
        EarlyStopping.__call__, builtins.input = call, ask


def train_path(tmp: str, dev) -> dict:
    """Training and its probes on the card, at the packaged width (6 x
    GINE-128, GraphNorm, zscore_l2, nodes normalised before the pool,
    dropout 0.05); returns the phase's record."""
    rec = {}
    data_p, map_p, eval_fams = train_eval.generate_alignment_training_data(
        os.path.join(tmp, "data"))
    train_fams = [msa_eval.make_family(7 + f, n_seqs=5, anc_len=100, sub_rate=0.05,
                                       del_rate=0.03, ins_rate=0.03)
                  for f in range(TRAIN_PAIR_ROWS)]
    trip_p, pair_p = write_pair_tables(tmp, train_fams, SEED + 21)
    with open(map_p) as f:
        amap = json.load(f)
    align_ds = train_data.AlignmentDataset(read_table(data_p), amap)
    loss_cfg = AlignmentLossConfig(margin=0.2, temperature=0.1)  # the CLI's defaults
    loss_fns = {"triplet": triplet_loss_fn(1.0), "regression": regression_loss_fn(),
                "alignment": alignment_loss_fn(loss_cfg)}

    def first_batch(mode, groups):
        if mode == "alignment":
            return train_data.assemble_alignment_batch(
                align_ds.groups[:groups], 16, np.random.default_rng(SEED), max_negatives=5000)
        table = read_table(trip_p if mode == "triplet" else pair_p)
        ds = (train_data.TripletDataset if mode == "triplet" else train_data.PairDataset)(table)
        build_fn = train_data._triplet_batch if mode == "triplet" else train_data._pair_batch
        return build_fn(ds, np.arange(groups), _round_capacity(groups), None)

    forward_windows.launches = dp_wavefront.launches = wavefront_plain.launches = 0
    dp_wavefront.warp_launches = closs.contrastive_loss.launches = 0

    # (a) card vs CPU, dropout 0, one step per mode and the batch-norm variant
    t0 = time.perf_counter()
    rec["card_vs_cpu"] = {}
    for name, mode, norm, groups in (("triplet", "triplet", "graph", 16),
                                     ("regression", "regression", "graph", 16),
                                     ("alignment", "alignment", "graph", 4),
                                     ("regression_batch_norm", "regression", "batch", 16)):
        cfg = train_config(norm, dropout=0.0)
        params, state = variant_model(cfg, SEED + 22)
        rec["card_vs_cpu"][name] = card_vs_cpu(cfg, loss_fns[mode], params, state,
                                               first_batch(mode, groups), dev)
    rec["card_vs_cpu_seconds"] = time.perf_counter() - t0

    # (b) two runs of a step on the card, dropout 0.05, batches of 32
    t0 = time.perf_counter()
    cfg = train_config()
    rec["determinism"] = {
        mode: repeat_step(cfg, loss_fns[mode], *seeded_model(cfg, SEED + 23),
                          first_batch(mode, 32), dev)
        for mode in ("triplet", "regression", "alignment")}
    rec["determinism_seconds"] = time.perf_counter() - t0

    # (c) the training run: two rounds from a seeded checkpoint
    start = os.path.join(tmp, "start.pth")
    export_torch_checkpoint(start, cfg, *seeded_model(cfg, SEED + 24))
    out_dir = os.path.join(tmp, "run")
    with contextlib.redirect_stdout(io.StringIO()):
        trained, wall = train_eval.train_packaged_architecture(
            data_p, map_p, out_dir, rounds=TRAIN_ROUNDS, checkpoint=start)
    torch.cuda.synchronize()
    rounds = []
    for r in range(1, len(TRAIN_ROUNDS) + 1):
        log = os.path.join(out_dir, "output", "trained_eval", f"round_{r:02d}", "train.log")
        rounds.append({"train_loss": log_series(log, "Training Loss"),
                       "val_loss": log_series(log, "Validation Loss"),
                       "learning_rate": log_series(log, "Learning Rate")})
    epochs = sum(len(r["train_loss"]) - 1 for r in rounds)
    n_train = len(align_ds) - max(1, round(len(align_ds) * 0.03))
    steps = epochs * -(-n_train // 32)
    # the first and last epochs' mean train-mode losses (each log's first
    # line is an inference-mode evaluation of 5% of the batches)
    initial, final = rounds[0]["train_loss"][1], rounds[-1]["train_loss"][-1]
    rec["training_run"] = {
        "families": len(align_ds), "train_families": n_train, "rounds": rounds,
        "epochs": epochs, "steps": steps, "cli_seconds": wall,
        "cli_steps_per_s": steps / wall, "cli_graphs_per_s": 5 * n_train * epochs / wall,
        "initial_train_loss": initial, "final_train_loss": final}
    if not (np.isfinite(final) and final < initial):
        raise AssertionError(f"training did not lower the loss: {initial} -> {final}")
    tcfg, tparams, tstate, _ = load_checkpoint(trained)
    rec["epoch_split"] = epoch_split(tcfg, tparams, tstate, align_ds, dev, loss_cfg)

    # (d) the probes of the trained and the starting checkpoint
    t0 = time.perf_counter()
    k2_before = dp_wavefront.launches
    rec["probes"] = {name: {
        "recall_at_10": train_eval.retrieval_recall_at_10(path, eval_fams),
        "alignment_sp_f1": train_eval.alignment_sp_f1(path, eval_fams),
    } for name, path in (("trained", trained), ("start", start))}
    torch.cuda.synchronize()
    rec["probes"].update(
        seconds=time.perf_counter() - t0, eval_families=len(eval_fams),
        eval_pairs=sum(len(f) * (len(f) - 1) // 2 for f in eval_fams),
        dp_kernel_launches=dp_wavefront.launches - k2_before)

    # (e) triplet and regression through the CLI, --fit-node-stats
    t0 = time.perf_counter()
    rec["other_modes"] = {}
    for mode, path in (("triplet", trip_p), ("regression", pair_p)):
        wd = os.path.join(tmp, mode)
        os.makedirs(wd)
        t1 = time.perf_counter()
        with contextlib.chdir(wd), contextlib.redirect_stdout(io.StringIO()):
            train_cli.main(["--input_path", path, "--training_mode", mode, "--model_id", mode,
                            *train_eval.ARCH_FLAGS["packaged"], "--norm_type", "graph",
                            "--node_embed_norm", "zscore_l2", "--fit-node-stats",
                            "--dropout", "0.05", "--batch_size", "32", "--num_epochs", "2",
                            "--lr", "5e-4"])
        torch.cuda.synchronize()
        sd = torch.load(os.path.join(wd, "output", mode, f"{mode}.pth"),
                        weights_only=False)["state_dict"]
        mu, sigma = sd["node_mu"], sd["node_sigma"]
        if torch.equal(mu, torch.zeros_like(mu)) or torch.equal(sigma, torch.ones_like(sigma)):
            raise AssertionError(f"{mode}: --fit-node-stats left node_mu/node_sigma at 0/1")
        log = os.path.join(wd, "output", mode, "train.log")
        rec["other_modes"][mode] = {
            "seconds": time.perf_counter() - t1, "train_loss": log_series(log, "Training Loss"),
            "node_mu_abs_mean": float(mu.abs().mean()), "node_sigma_mean": float(sigma.mean())}
    rec["other_modes_seconds"] = time.perf_counter() - t0

    # (f) exact resume: --save-every 1, stopped in epoch 2, resumed
    t0 = time.perf_counter()
    wd = os.path.join(tmp, "resume")
    os.makedirs(wd)
    argv = ["--input_path", trip_p, "--training_mode", "triplet",
            *train_eval.ARCH_FLAGS["packaged"], "--dropout", "0.05", "--batch_size", "32",
            "--num_epochs", "3", "--patience", "10", "--lr", "5e-4", "--save-every", "1"]
    with contextlib.chdir(wd), contextlib.redirect_stdout(io.StringIO()):
        train_cli.main(argv + ["--model_id", "full"])
        with interrupted_at_epoch(2):
            train_cli.main(argv + ["--model_id", "part"])
        train_cli.main(argv + ["--model_id", "part", "--resume-from",
                               os.path.join("output", "part", "checkpoints")])
    full, part = (torch.load(os.path.join(wd, "output", m, f"{m}.pth"), weights_only=False)
                  for m in ("full", "part"))
    resumed_equal = (full["epoch"] == part["epoch"]
                     and full["state_dict"].keys() == part["state_dict"].keys()
                     and all(torch.equal(v, part["state_dict"][k])
                             for k, v in full["state_dict"].items()))
    if not resumed_equal:
        raise AssertionError("the resumed run's .pth differs from the uninterrupted run's")
    rec["resume"] = {"bit_equal": True, "epoch": full["epoch"],
                     "seconds": time.perf_counter() - t0}

    # (g) the flagship architecture (4 layers 256 -> 512 x 3, forgi)
    t0 = time.perf_counter()
    out_dir = os.path.join(tmp, "flagship")
    with contextlib.redirect_stdout(io.StringIO()):
        flag_ckpt, flag_wall = train_eval.train_packaged_architecture(
            data_p, map_p, out_dir, rounds=FLAGSHIP_ROUNDS, arch="flagship")
    torch.cuda.synchronize()
    fcfg, fparams, fstate, _ = load_checkpoint(flag_ckpt)
    forgi_ds = train_data.AlignmentDataset(read_table(data_p), amap, graph_encoding="forgi")
    rec["flagship"] = {"cli_seconds": flag_wall, "hidden_dims": list(fcfg.hidden_dims),
                       "output_dim": fcfg.output_dim, "graph_encoding": fcfg.graph_encoding,
                       **epoch_split(fcfg, fparams, fstate, forgi_ds, dev, loss_cfg),
                       "seconds": time.perf_counter() - t0}

    # (h) the alignment loss's kernel against the plain loss and float64
    t0 = time.perf_counter()
    rec["loss_kernel_steps"] = closs.contrastive_loss.launches
    if not closs.contrastive_loss.launches:
        raise AssertionError("alignment training on the card never launched the loss kernel")
    rec["loss_kernel_vs_plain"] = {
        "cell": check_loss_kernel(loss_kernel_vs_plain(LOSS_CELL_M, LOSS_DIM, dev)),
        "past_2_31_pairs": check_loss_kernel(
            loss_kernel_vs_plain(LOSS_WIDE_M, LOSS_DIM, dev, plain=False)),
        "timing": loss_kernel_ms(LOSS_CELL_M, LOSS_DIM, dev),
        "seconds": time.perf_counter() - t0}

    rec.update(window_kernel_launches=forward_windows.launches,
               dp_kernel_launches=dp_wavefront.launches,
               dp_kernel_warp_launches=dp_wavefront.warp_launches,
               plain_dp_launches=wavefront_plain.launches)
    if forward_windows.launches or not dp_wavefront.launches or \
            dp_wavefront.warp_launches != dp_wavefront.launches or wavefront_plain.launches:
        raise AssertionError(f"train_path: K1 {forward_windows.launches}, K2 "
                             f"{dp_wavefront.launches} ({dp_wavefront.warp_launches} on the "
                             f"warp route), plain DP {wavefront_plain.launches}")
    return rec


@contextlib.contextmanager
def shards_on_each_device(k: int = MESH_SHARDS):
    """Every data mesh the port builds (``--data-parallel``, the search's
    default) spans ``k`` shards on the caller's device: two shards on one
    card take every sharded code path a host of two cards takes."""
    real = mesh_mod.visible_devices
    mesh_mod.visible_devices = lambda device: [device] * k
    try:
        yield
    finally:
        mesh_mod.visible_devices = real


def worst_leaf(card: dict, cpu32: dict, ref: dict) -> dict:
    """The leaf whose card value lies farthest from the float64 ``ref``,
    relative to the float32 CPU run's distance: both distances (scaled by
    max(1, max|ref|)) and their ratio."""
    worst = {"ratio": 0.0}
    for k, r in ref.items():
        scale = max(1.0, float(r.abs().max()))
        c, w = (float((g[k] - r).abs().max()) / scale for g in (card, cpu32))
        if c / max(w, 1e-30) > worst["ratio"]:
            worst = {"leaf": k, "card": c, "cpu": w, "ratio": c / max(w, 1e-30)}
    return worst


def float64_distances(step, cfg, loss_fn, params, state, batch, dev) -> dict:
    """``worst_leaf`` of the gradients of one step on the card, on the CPU
    and on the CPU in float64.  A measurement, with no bar."""
    cpu = torch.device("cpu")
    return worst_leaf(*(step(cfg, loss_fn, params, state, batch, d, dt)[1] for d, dt in (
        (dev, torch.float32), (cpu, torch.float32), (cpu, torch.float64))))


class GradTaps(torch.overrides.TorchFunctionMode):
    """While on, keeps the gradient of every floating output of a torch
    function that autograd tracks (``retain_grad``), in call order."""

    def __init__(self):
        super().__init__()
        self.taps = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in out if isinstance(out, (tuple, list)) else (out,):
            if isinstance(t, torch.Tensor) and t.is_floating_point() and t.grad_fn is not None:
                t.retain_grad()
                self.taps.append((getattr(func, "__name__", str(func)), t))
        return out


def op_gradients(cfg, loss_fn, params, state, batch, dev, dtype) -> list:
    """``(function, gradient)`` of every tracked output of one train-mode
    step's forward and loss on ``dev`` in ``dtype`` (gradients float64 on
    the CPU), in the forward's call order; the alignment loss counts as
    one call (``loss_unseen``)."""
    p = tree_map(lambda t: t.to(dev, dtype).clone().requires_grad_(True), params)
    s = tree_map(lambda t: t.to(dev, dtype), state)
    b = batch_as(batch.to(dev), dtype)
    taps = GradTaps()
    with loss_unseen(), taps:
        loss, _ = loss_fn(cfg, p, s, b, torch.Generator(device=dev).manual_seed(0))
    loss.backward()
    return [(name, None if t.grad is None else t.grad.detach().cpu().double())
            for name, t in taps.taps]


def backward_split(cfg, loss_fn, params, state, batch, dev, floor: float = 1e-7,
                   keep_rows: bool = False) -> dict:
    """Where in the backward the card's float32 gradients leave the CPU's:
    the gradient of every tracked output of the forward (``op_gradients``)
    on the card and on the CPU in float32, each against the CPU in
    float64 (max-abs, scaled by max(1, max|float64|)).  The backward
    runs the forward's ops in reverse, so ``first_departure`` is the op
    latest in the forward whose card distance exceeds 4 times the CPU's
    (and ``floor``): its gradient is the first to depart.  ``worst``: the
    five largest ratios."""
    cpu = torch.device("cpu")
    ref = op_gradients(cfg, loss_fn, params, state, batch, cpu, torch.float64)
    dists = {}
    for name, d in (("card", dev), ("cpu", cpu)):
        got = op_gradients(cfg, loss_fn, params, state, batch, d, torch.float32)
        if [n for n, _ in got] != [n for n, _ in ref]:
            raise AssertionError(f"backward_split: the {name} run called other functions")
        dists[name] = [None if r is None or g is None else
                       float((g - r).abs().max()) / max(1.0, float(r.abs().max()))
                       for (_, g), (_, r) in zip(got, ref)]
        del got
    rows = [{"op": i, "function": ref[i][0], "shape": list(ref[i][1].shape),
             "card": c, "cpu": w, "ratio": c / max(w, 1e-30)}
            for i, (c, w) in enumerate(zip(dists["card"], dists["cpu"])) if c is not None]
    departed = [r for r in rows if r["ratio"] > 4 and r["card"] > floor]
    return {"ops": len(ref), "first_departure": departed[-1] if departed else None,
            "departures": len(departed),
            "worst": sorted(rows, key=lambda r: -r["ratio"])[:5],
            **({"rows": rows} if keep_rows else {})}


def _is_relu(func, args, kwargs) -> bool:
    """A ReLU kink: ``relu``, or ``clamp`` with ``min=0`` alone."""
    if func in (torch.relu, torch.nn.functional.relu):
        return True
    return (func is torch.clamp and len(args) == 1 and kwargs.get("max") is None
            and kwargs.get("min") == 0)


@contextlib.contextmanager
def loss_unseen():
    """The alignment loss as one call that the torch function modes below
    (``KinkPins``, ``GradTaps``) do not look into, on every device: on the
    card it is one kernel, whose margin kink and intermediates no mode can
    see, so the CPU's M x M ops are hidden too and both runs call the same
    functions.  The loss's margin kink is then left unpinned."""
    real = train_module.alignment_contrastive_loss

    def opaque(*args, **kwargs):
        with torch._C.DisableTorchFunction():
            return real(*args, **kwargs)

    train_module.alignment_contrastive_loss = opaque
    try:
        yield
    finally:
        train_module.alignment_contrastive_loss = real


class KinkPins(torch.overrides.TorchFunctionMode):
    """The ReLU kinks of a run (``_is_relu``), in call order.  Recording
    (``masks`` None): each call's branch ``out > 0`` and its input (float64
    on the CPU) are kept.  Pinning: the ``k``-th call returns its input
    where the recorded run's ``k``-th branch is open and 0 elsewhere, so
    the forward and the gradient take the recorded run's branch; each
    call where this run's own branch differs is listed in ``flips``."""

    def __init__(self, masks=None, inputs=None):
        super().__init__()
        self.record = masks is None
        self.masks = [] if masks is None else masks
        self.inputs = [] if inputs is None else inputs
        self.calls = 0
        self.flips = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not _is_relu(func, args, kwargs):
            return out
        k, self.calls = self.calls, self.calls + 1
        if self.record:
            self.masks.append((out > 0).cpu())
            self.inputs.append(args[0].detach().cpu().double())
            return out
        mask = self.masks[k].to(out.device)
        flip = ((out > 0) != mask).cpu()
        if flip.any():
            self.flips.append({"call": k, "function": func.__name__, "elements": int(flip.sum()),
                               "max_abs_float64_input": float(self.inputs[k][flip].abs().max())})
        x = args[0]
        return torch.where(mask, x, torch.zeros((), dtype=x.dtype, device=x.device))


def kink_pinned(step, cfg, loss_fn, params, state, batch):
    """``step`` (``one_step`` or ``mesh_step``) with every ReLU kink outside
    the alignment loss (``loss_unseen``) on the branch that a float64 CPU
    run of the same step on ``batch`` takes (``KinkPins``), and the list
    that each pinned run adds its flips to.
    Where a float32 ReLU input lies within rounding of 0, the card and
    the CPU may each round it to either side; pinned, both differentiate
    the float64 run's branch of the same function."""
    ref = KinkPins()
    with loss_unseen(), ref:
        step(cfg, loss_fn, params, state, batch, torch.device("cpu"), torch.float64)
    flips = []

    def pinned(cfg, loss_fn, params, state, batch, dev, dtype=torch.float32, seed=0):
        pins = KinkPins(ref.masks, ref.inputs)
        with loss_unseen(), pins:
            out = step(cfg, loss_fn, params, state, batch, dev, dtype, seed)
        if pins.calls != ref.calls:
            raise AssertionError(f"kink_pinned: {pins.calls} ReLU calls, {ref.calls} recorded")
        flips.append({"device": dev.type, "dtype": str(dtype).removeprefix("torch."),
                      "calls": pins.calls, "flipped": pins.flips})
        return out

    return pinned, flips


def mesh_train_steps(trip_p: str, align_ds, dev) -> dict:
    """The sharded train step of ``MESH_SHARDS`` batches, packaged width,
    on each mode's first stack of the epoch plans (triplet rows in size
    order; alignment groups in the seeded shuffle the CLI takes): at
    dropout 0 on the card, bit-equal to the mean of its shards'
    single-device steps, and against a CPU mesh under ``card_vs_cpu``'s
    rules with every ReLU kink on the float64 run's branch
    (``kink_pinned``); at dropout 0.05 twice on the card, bit-equal.
    Unpinned, the alignment stack's gradients are measured against
    float64 (sharded and each shard alone) and split op by op
    (``backward_split``, shard 0), with no bar."""
    trip_ds = train_data.TripletDataset(read_table(trip_p))

    def first_stack(it):
        return next(b for b, stacked in it if stacked)

    loss_fns = {"triplet": triplet_loss_fn(1.0),
                "alignment": alignment_loss_fn(AlignmentLossConfig(margin=0.2,
                                                                   temperature=0.1))}
    stacks = {
        "triplet": first_stack(train_data.iter_graph_pair_batches_dp(
            trip_ds, 16, MESH_SHARDS, None, train_data._triplet_batch)),
        "alignment": first_stack(train_data.iter_alignment_batches_dp(
            align_ds, 4, 16, MESH_SHARDS, np.random.default_rng(SEED), max_negatives=5000)),
    }
    cfg0, cfg = train_config(dropout=0.0), train_config()
    params0, state0 = variant_model(cfg0, SEED + 22)
    mesh = DataMesh([dev] * MESH_SHARDS)
    rec = {"card_vs_cpu": {}, "determinism": {}, "mean_of_single_steps": {}}
    for mode, stacked in stacks.items():
        fn = loss_fns[mode]
        loss, grads, _ = mesh_step(cfg0, fn, params0, state0, stacked, dev)
        singles = [one_step(cfg0, fn, params0, state0, train_data._unstack(stacked, s), dev)
                   for s in range(MESH_SHARDS)]
        same = loss == float(np.float32(sum(np.float32(r[0]) for r in singles)) / MESH_SHARDS)
        for k, g in grads.items():
            acc = singles[0][1][k].float()
            for r in singles[1:]:
                acc = acc + r[1][k].float()
            same = same and torch.equal(g, (acc / MESH_SHARDS).double())
        rec["mean_of_single_steps"][mode] = same
        if not same:
            raise AssertionError(f"{mode}: the sharded step on the card is not the mean of "
                                 f"its shards' single-device steps")
        pinned, flips = kink_pinned(mesh_step, cfg0, fn, params0, state0, stacked)
        rec["card_vs_cpu"][mode] = card_vs_cpu(cfg0, fn, params0, state0, stacked, dev,
                                               step=pinned)
        rec["card_vs_cpu"][mode]["kink_flips"] = flips
        rec["determinism"][mode] = repeat_step(cfg, fn, *seeded_model(cfg, SEED + 23),
                                               stacked, dev, mesh=mesh)
    stacked, fn = stacks["alignment"], loss_fns["alignment"]
    rec["alignment_unpinned"] = {
        "float64_distances": {"sharded": float64_distances(
            mesh_step, cfg0, fn, params0, state0, stacked, dev), **{
                f"shard{s}_alone": float64_distances(one_step, cfg0, fn, params0, state0,
                                                     train_data._unstack(stacked, s), dev)
                for s in range(MESH_SHARDS)}},
        "backward_split_shard0": backward_split(cfg0, fn, params0, state0,
                                                train_data._unstack(stacked, 0), dev)}
    return rec


def same_bytes(a: str, b: str) -> bool:
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


def topk_rows(path: str) -> dict:
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f, delimiter="\t"))
    out: dict = {}
    for r in rows:
        out.setdefault(r["rid_1"], []).append((r["rid_2"], float(r["distance"])))
    return out


def mesh_path(work: str, dev) -> dict:
    """The port's ``--data-parallel`` paths on a mesh of ``MESH_SHARDS``
    shards on the one card, each held to the unsharded run of an earlier
    phase on the same inputs (kept under ``work``), and a mixed [card,
    CPU] mesh; returns the phase's record."""
    tmp = os.path.join(work, "mesh_path")
    os.makedirs(tmp)
    rec = {"shards": MESH_SHARDS}
    parts = rec["part_seconds"] = {}
    t_part = time.perf_counter()

    def part(name):
        nonlocal t_part
        parts[name] = time.perf_counter() - t_part
        t_part = time.perf_counter()

    forward_windows.launches = forward_windows.bf16_launches = 0
    dp_wavefront.launches = dp_wavefront.warp_launches = wavefront_plain.launches = 0
    with shards_on_each_device():
        # (a) the window CLI on main_path's corpus: its TSV byte for byte
        main_dir = os.path.join(work, "main_path")
        out = os.path.join(tmp, "windows.tsv")
        said = io.StringIO()
        with contextlib.redirect_stdout(said):
            embed.main(["--input", os.path.join(main_dir, "corpus.csv"), "--id-column",
                        "rna_id", "--output", out, "--model-path",
                        os.path.join(main_dir, "flagship.pth"), "--window-size", str(WINDOW),
                        "--keep-paired-neighbors", "--device", str(dev), "--data-parallel"])
        torch.cuda.synchronize()
        rec["windows"] = {"k1_launches": forward_windows.launches,
                          "tsv_identical": same_bytes(out, os.path.join(main_dir,
                                                                        "windows.tsv"))}
        if f"data parallel over {MESH_SHARDS} devices" not in said.getvalue():
            raise AssertionError(f"window CLI: no mesh ({said.getvalue()!r})")
        if not (rec["windows"]["tsv_identical"] and forward_windows.launches > 0):
            raise AssertionError(f"window CLI on the mesh: {rec['windows']}")
        part("a_windows")

        # (b) the graph CLI and (c) the top-k CLI on graph_path's corpus
        graph_dir = os.path.join(work, "graph_path")
        out = os.path.join(tmp, "graphs.tsv")
        said = io.StringIO()
        with contextlib.redirect_stdout(said):
            embed.main(["--input", os.path.join(graph_dir, "structures.csv"), "--id-column",
                        "rid", "--output", out, "--model-path",
                        os.path.join(graph_dir, "flagship.pth"), "--device", str(dev),
                        "--data-parallel"])
        if f"data parallel over {MESH_SHARDS} devices" not in said.getvalue():
            raise AssertionError(f"graph CLI: no mesh ({said.getvalue()!r})")
        rec["graph_tsv_identical"] = same_bytes(out, os.path.join(graph_dir, "graphs.tsv"))
        if not rec["graph_tsv_identical"]:
            raise AssertionError("graph CLI on the mesh: another TSV")
        part("b_graphs")
        topk = os.path.join(tmp, "topk.tsv")
        searchers = []
        real_search = TopKSearcher.search

        def search(self, *a, **kw):
            searchers.append([sh.device.type for sh in self._shards])
            return real_search(self, *a, **kw)

        TopKSearcher.search = search
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                distances.main(["--input", out, "--output", topk, "--id-column", "rid",
                                "--top-k", str(TOP_K), "--device", str(dev)])
        finally:
            TopKSearcher.search = real_search
        got, want = topk_rows(topk), topk_rows(os.path.join(graph_dir, "topk.tsv"))
        rel = max(abs(d - wd) / max(abs(wd), 1e-30) for q in want
                  for (_, d), (_, wd) in zip(got[q], want[q]))
        rec["top_k"] = {"queries": len(want), "searcher_shards": searchers,
                        "neighbours_identical": all(
                            [c for c, _ in got[q]] == [c for c, _ in want[q]] for q in want),
                        "distance_max_rel_diff": rel}
        if searchers != [["cuda"] * MESH_SHARDS]:
            raise AssertionError(f"top-k CLI: the corpus is not sharded ({searchers})")
        if not (rec["top_k"]["neighbours_identical"] and sorted(got) == sorted(want)):
            raise AssertionError("top-k CLI on the mesh: other neighbours")
        part("c_top_k")

        # (d) align-batch on align_path's node embeddings: its summary byte
        # for byte, each batch one K2 launch per shard
        align_dir = os.path.join(work, "align_path")
        out_dir = os.path.join(tmp, "pairs")
        n0 = dp_wavefront.launches
        with contextlib.redirect_stdout(io.StringIO()):
            align_batch.main(["--input", os.path.join(align_dir, "nodes.tsv"), "--id-column",
                              "rid", "--output-dir", out_dir, "--batch-size", str(ALIGN_BATCH),
                              "--mode", "global", "--structure-column-name",
                              "secondary_structure", "--device", str(dev), "--data-parallel"])
        torch.cuda.synchronize()
        n_pairs = ALIGN_RNAS * (ALIGN_RNAS - 1) // 2
        rec["align_batch"] = {
            "pairs": n_pairs, "k2_launches": dp_wavefront.launches - n0,
            "k2_warp_launches": dp_wavefront.warp_launches,
            "summary_identical": same_bytes(os.path.join(out_dir, "summary.tsv"),
                                            os.path.join(align_dir, "pairs", "summary.tsv"))}
        if not (rec["align_batch"]["summary_identical"] and rec["align_batch"]["k2_launches"]
                == MESH_SHARDS * -(-n_pairs // ALIGN_BATCH) == dp_wavefront.warp_launches):
            raise AssertionError(f"align-batch on the mesh: {rec['align_batch']}")
        part("d_align_batch")

        # (e) the MSA's 24-record family in both modes, unsharded and sharded
        small = os.path.join(work, "msa_path", "small.tsv")
        rec["msa_small"] = {}
        for mode in ("library", "profile"):
            runs = {}
            for name, extra in (("unsharded", []), ("sharded", ["--data-parallel"])):
                prefix = os.path.join(tmp, f"msa_{mode}_{name}", "msa")
                said = io.StringIO()
                runs[name] = msa_run(small, prefix, ["--dp-score", mode, *extra], str(dev),
                                     said=said)
                if extra and f"data parallel over {MESH_SHARDS} devices" not in said.getvalue():
                    raise AssertionError(f"MSA ({mode}): no mesh")
            same = same_bytes(os.path.join(tmp, f"msa_{mode}_unsharded", "msa.aln.tsv"),
                              os.path.join(tmp, f"msa_{mode}_sharded", "msa.aln.tsv"))
            rec["msa_small"][mode] = {
                "seconds": {k: r["seconds"] for k, r in runs.items()},
                "stage_seconds": {k: r["stage_seconds"] for k, r in runs.items()},
                "aln_tsv_identical": same}
            if not same:
                raise AssertionError(f"MSA ({mode}) on the mesh: another .aln.tsv")
        part("e_msa")

    # (f) training: the sharded step on the card (bit-equal to the mean of
    # its shards' single-device steps; twice, bit-equal), against the same
    # on a CPU mesh (card_vs_cpu's gradient rules); an epoch twice, bit-equal
    train_dir = os.path.join(tmp, "train")
    data_p, map_p, _ = train_eval.generate_alignment_training_data(
        os.path.join(train_dir, "data"))
    with open(map_p) as f:
        align_ds = train_data.AlignmentDataset(read_table(data_p), json.load(f))
    rec["train"] = mesh_train_steps(os.path.join(work, "train_path", "triplets.tsv"),
                                    align_ds, dev)
    part("f_train_steps")
    cfg = train_config()
    start = os.path.join(train_dir, "start.pth")
    export_torch_checkpoint(start, cfg, *seeded_model(cfg, SEED + 24))
    runs = []
    with shards_on_each_device():
        for k in range(2):
            said = io.StringIO()
            with contextlib.redirect_stdout(said):
                ckpt, wall = train_eval.train_packaged_architecture(
                    data_p, map_p, os.path.join(train_dir, f"run{k}"), rounds=FLAGSHIP_ROUNDS,
                    checkpoint=start, device=str(dev))
            if f"[train] data parallel over {MESH_SHARDS} devices" not in said.getvalue():
                raise AssertionError("train_packaged_architecture: no mesh")
            log = os.path.join(os.path.dirname(ckpt), "train.log")
            runs.append((torch.load(ckpt, weights_only=False)["state_dict"],
                         log_series(log, "Training Loss"), log_series(log, "Validation Loss"),
                         wall))
    (sd0, tr0, va0, w0), (sd1, tr1, va1, w1) = runs
    rec["train"]["epoch"] = {"cli_seconds": [w0, w1], "train_loss": tr0, "val_loss": va0,
                             "bit_equal": sd0.keys() == sd1.keys() and all(
                                 torch.equal(v, sd1[k]) for k, v in sd0.items())
                             and (tr0, va0) == (tr1, va1)}
    if not (rec["train"]["epoch"]["bit_equal"] and np.isfinite(tr0).all()):
        raise AssertionError(f"two sharded epochs on the card differ: {tr0} vs {tr1}")
    part("f_train_epochs")

    # (g) a mixed mesh [card, CPU]: a tensor left on the wrong device
    # raises; the card shard's rows equal the card's unsharded run, the CPU
    # shard's within the card-vs-CPU bar
    cpu = torch.device("cpu")
    mixed = DataMesh([dev, cpu])
    graph_dir = os.path.join(work, "graph_path")
    rnas = read_table(os.path.join(graph_dir, "structures.csv")).column(
        "secondary_structure")[:MESH_MIXED_RNAS]
    graphs = preprocess_structures(rnas).graphs
    ckpt = os.path.join(graph_dir, "flagship.pth")
    eng = InferenceEngine.from_checkpoint(ckpt, mesh=mixed, max_nodes_per_batch=2048)
    got = eng.embed_graphs(graphs)
    card = InferenceEngine.from_checkpoint(ckpt, device=dev,
                                           max_nodes_per_batch=2048).embed_graphs(graphs)
    shard_of = np.zeros(len(graphs), np.int64)
    for s, idxs, _ in eng._sharded(list(eng._batches(graphs))):
        shard_of[idxs] = s
    on_cpu = shard_of == 1
    rec["mixed"] = {"graph_rows": len(graphs), "cpu_shard_rows": int(on_cpu.sum()),
                    "card_shard_identical": bool(np.array_equal(got[~on_cpu], card[~on_cpu])),
                    "cpu_shard_max_abs_err": float(np.abs(got[on_cpu] - card[on_cpu]).max())}
    with open(os.path.join(work, "align_path", "nodes.tsv"), newline="") as f:
        mats = [node_embed.parse_matrix(r["node_embeddings"])
                for r in csv.DictReader(f, delimiter="\t")]
    pairs = [(i, j) for i in range(len(mats)) for j in range(i + 1, len(mats))]
    sims = [cosine_similarity_matrix(mats[i], mats[j]).astype(np.float32)
            for i, j in pairs[:MESH_MIXED_PAIRS]]
    n0 = dp_wavefront.launches
    mixed_res = affine_align_batch(sims, -1.0, -1.0, "global", mesh=mixed)
    rec["mixed"]["align_pairs"] = len(sims)
    rec["mixed"]["align_k2_launches"] = dp_wavefront.launches - n0
    rec["mixed"]["align_identical"] = mixed_res == affine_align_batch(sims, -1.0, -1.0,
                                                                      "global", device=dev)
    if not (rec["mixed"]["card_shard_identical"] and 0 < on_cpu.sum() < len(graphs)
            and rec["mixed"]["cpu_shard_max_abs_err"] <= TOL
            and rec["mixed"]["align_identical"] and rec["mixed"]["align_k2_launches"] == 1):
        raise AssertionError(f"the mixed mesh: {rec['mixed']}")
    part("g_mixed")
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
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        return run_phases(work)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def kept_dir(work: str, name: str) -> contextlib.nullcontext:
    """A phase's directory under ``work``, kept until the run ends so that
    ``mesh_path`` can rerun its inputs on the mesh."""
    path = os.path.join(work, name)
    os.makedirs(path)
    return contextlib.nullcontext(path)


def run_phases(work: str) -> int:
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

    with phase("staged_kernel_vs_plain", {"emb_gap": EMB_GAP, "tolerance": TOL,
                                          "bf16_tolerance": BF16_TOL}) as rec:
        rec.update(staged_kernel_vs_plain(dev))
        staged = rec

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

    with kept_dir(work, "main_path") as tmp, phase("main_path", {"card": card}) as rec:
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
            plain = plain_windows(model, per, n_cap, idxs, WINDOW).cpu().numpy()
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
                                                 WINDOW, dev))
    main_params, main_state, main_emb = params, state, emb

    with kept_dir(work, "align_path") as tmp, phase("align_path", {"card": card}) as rec:
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
        dp_wavefront.warp_launches = dp_traceback.launches = 0
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
        walk_launches = dp_traceback.launches
        expected = -(-n_pairs // ALIGN_BATCH)
        if batch_launches != expected or dp_launches != expected + 1 or plain_launches:
            raise AssertionError(f"the align path launched K2 {batch_launches} + "
                                 f"{dp_launches - batch_launches} times (expected {expected}"
                                 f" + 1) and the plain DP {plain_launches} times")
        if walk_launches != expected + 1:
            raise AssertionError(f"the align path launched the walk kernel {walk_launches} "
                                 f"times (expected {expected} + 1): a path was walked on "
                                 "the host")
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
        graphs = preprocess_structures(rnas[:4]).graphs
        cpu = InferenceEngine.from_checkpoint(ckpt, device="cpu").node_embeddings(graphs)
        node_err = max(float(np.abs(c - m).max()) for c, m in zip(cpu, mats))
        # the same rows in float64 on the CPU, and twice more on the card:
        # the card's segment sums run in index order, so its rows repeat
        batch = batch_graphs(graphs)
        n_real = sum(g.n_nodes for g in graphs)
        m64 = GINModel(cfg, params, state).to(torch.float64)
        r64 = get_node_embeddings(cfg, m64.params, m64.state,
                                  batch_as(batch, torch.float64)).numpy()[:n_real]
        on_card = GINModel(cfg, params, state).to(dev)
        reps = [on_card.get_node_embeddings(batch).cpu().numpy()[:n_real] for _ in range(2)]
        rec.update(node_max_abs_err_vs_cpu=node_err,
                   node_card_vs_float64=float(np.abs(np.concatenate(mats[:4]) - r64).max()),
                   node_cpu_vs_float64=float(np.abs(np.concatenate(cpu) - r64).max()),
                   node_card_repeats=bool(np.array_equal(reps[0], reps[1])))
        if node_err > TOL:
            raise AssertionError(f"node embeddings vs the CPU: max abs {node_err} > {TOL} "
                                 f"(card {rec['node_card_vs_float64']}, CPU "
                                 f"{rec['node_cpu_vs_float64']} from float64)")
        if not rec["node_card_repeats"]:
            raise AssertionError("node embeddings on the card differ between two runs")

        with open(os.path.join(out_dir, "summary.tsv"), newline="") as f:
            summary = list(csv.DictReader(f, delimiter="\t"))
        scores = np.array([float(r["score"]) for r in summary])
        if len(summary) != n_pairs or not np.isfinite(scores).all():
            raise AssertionError("summary.tsv: wrong row count or a score that is not finite")
        with open(os.path.join(tmp, "pair.alignment.tsv")) as f:
            if 'mode="local"' not in f.read():
                raise AssertionError("align CLI wrote no local alignment")

        # the CLI's work again, stage by stage as affine_align_batch runs
        # it: host similarity, packing into page-locked memory, upload and
        # K2, the walk kernel and the download of its paths, the host's
        # decode; and 32 pairs re-aligned by the plain wavefront on the card
        pairs = [(i, j) for i in range(ALIGN_RNAS) for j in range(i + 1, ALIGN_RNAS)]
        stage_s = dict.fromkeys(("similarity", "pack", "upload_k2", "walk_download",
                                 "decode"), 0.0)
        dp_batches = []
        for s0 in range(0, n_pairs, ALIGN_BATCH):
            chunk = pairs[s0:s0 + ALIGN_BATCH]
            t = [time.perf_counter()]
            sims = [cosine_similarity_matrix(mats[i], mats[j]).astype(np.float32)
                    for i, j in chunk]
            t.append(time.perf_counter())
            shape = (len(sims), max(m.shape[0] for m in sims), max(m.shape[1] for m in sims))
            pinned = torch.empty(shape, dtype=torch.float32, pin_memory=True)
            sides = torch.empty((2, len(sims)), dtype=torch.int32, pin_memory=True)
            pack_batch(sims, pinned.numpy(), *sides.numpy())
            t.append(time.perf_counter())
            sd, l1d, l2d = (x.to(dev, non_blocking=True) for x in (pinned, *sides))
            best, bi, bj, codes = dp_wavefront(sd, l1d, l2d, -1.0, -1.0, "global")
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            walk = [x.to("cpu", non_blocking=True)
                    for x in dp_traceback(codes, l1d, l2d, bi, bj, "global")]
            best = best.to("cpu", non_blocking=True)
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            paths_from_arrays(*(x.numpy() for x in walk))
            t.append(time.perf_counter())
            for k, key in enumerate(stage_s):
                stage_s[key] += t[k + 1] - t[k]
            dp_batches.append(sims)
        sims = dp_batches[0][:32]
        err, plain_res, recheck_route = dp_compare(sims, -1.0, -1.0, "global", dev)
        plain_scores = np.array([sc for sc, _ in plain_res])
        cli_err = float(np.abs(plain_scores - scores[:len(sims)]).max())
        if cli_err > DP_TOL:
            raise AssertionError(f"align CLI vs plain wavefront: |score| {cli_err} > {DP_TOL}")
        dp_errs += [err, cli_err]
        rec.update(structures=ALIGN_RNAS, pairs=n_pairs, node_embed_seconds=node_embed_s,
                   align_batch_seconds=align_batch_s,
                   align_batch_pairs_per_s=n_pairs / align_batch_s,
                   dp_kernel_launches=dp_launches, dp_kernel_launches_batch_cli=batch_launches,
                   dp_kernel_warp_launches=warp_launches,
                   window_kernel_launches=window_launches,
                   plain_dp_launches=plain_launches,
                   dp_walk_kernel_launches=walk_launches,
                   stage_seconds=stage_s,
                   plain_recheck_pairs=len(sims), plain_recheck_route=recheck_route,
                   plain_recheck_max_abs_err=max(err, cli_err))

    with kept_dir(work, "graph_path") as tmp, phase("graph_path", {"card": card}) as rec:
        rec.update(graph_path(tmp, cfg, dev))

    with tempfile.TemporaryDirectory() as tmp, phase("variants_path", {"card": card}) as rec:
        rec.update(variants_path(tmp, dev))

    with tempfile.TemporaryDirectory() as tmp, phase("bf16_path", {"card": card}) as rec:
        rec.update(bf16_path(tmp, cfg, main_params, main_state, structures, main_emb, dev))
        bf16_launches = rec["windows"]["bf16_kernel_launches"]

    with kept_dir(work, "msa_path") as tmp:
        with phase("msa_path", {"card": card}) as rec:
            msa_rec, msa_records = msa_path(tmp, dev)
            rec.update(msa_rec)
            tb_launches = msa_rec["traceback_kernel_launches"]
        with phase("msa_tools_path", {"card": card}) as rec:
            rec.update(msa_tools_path(tmp, dev, msa_records, cfg, main_params, main_state))

    with tempfile.TemporaryDirectory() as tmp, phase("msa_long_path", {"card": card}) as rec:
        rec.update(msa_long_path(tmp, dev))

    with phase("traceback_kernel_vs_plain", {"card": card}) as rec:
        tb = traceback_check(dev)
        rec.update(tb)

    with kept_dir(work, "train_path") as tmp, phase("train_path", {"card": card}) as rec:
        rec.update(train_path(tmp, dev))
        train_k2_launches = rec["dp_kernel_launches"]

    with phase("mesh_path", {"card": card}) as rec:
        rec.update(mesh_path(work, dev))
        mesh_k1_launches = rec["windows"]["k1_launches"]
        mesh_k2_launches = rec["align_batch"]["k2_launches"]

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
                   smem_rows=_build.library().windows_encoder_smem_rows(WINDOW,
                                                                       cfg.hidden_dims[-1]),
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
        # the CTA route (cta_ms) on the same inputs, in turns
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
            k_ms, c_ms = (sum(times[k]) / 2 for k in ("warp", "cta"))
            dp_t[key] = dict(pairs=B, L1=L1, L2=L2, route=rte[0], rows_per_lane=rte[1],
                             ms=k_ms, cta_ms=c_ms, ms_runs=times["warp"],
                             cta_ms_runs=times["cta"], plain_ms=p_ms, bound_ms=b_ms,
                             bound_by=b_by, bytes=nbytes, share_of_bound=b_ms / k_ms)
        rec["dp_wavefront"] = dp_t

        # the walk kernel on the same batch's K2 codes, against the host
        # walk of the same codes.  Its floor is its longest path alone: a
        # chain of dependent loads, one a step, which no number of pairs
        # beside it shortens
        sd, l1d, l2d, l1, l2 = dp_tensors(sims, dev)
        best, bi, bj, codes = dp_wavefront(sd, l1d, l2d, -1.0, -1.0, "global")
        args = [codes, l1d, l2d, bi, bj]
        got = paths_from_arrays(*(t.cpu().numpy() for t in dp_traceback(*args, "global")))
        h_bi, h_bj, h_codes = (t.cpu().numpy() for t in (bi, bj, codes))
        host_s = []
        for _ in range(3):
            t0 = time.perf_counter()
            want = paths_from_codes(h_codes, l1, l2, h_bi, h_bj, "global")
            host_s.append(time.perf_counter() - t0)
        if got != want:
            raise AssertionError("the walk kernel's paths differ from the host walk's")
        steps = [len(p) for p in want]
        k = int(np.argmax(steps))
        w_ms = cuda_ms(lambda: dp_traceback(*args, "global"), 50)
        floor_ms = cuda_ms(lambda: dp_traceback(*(t[k:k + 1] for t in args), "global"), 50)
        rec["dp_traceback"] = dict(
            pairs=len(sims), L1=sd.shape[1], L2=sd.shape[2],
            steps=sum(steps), ms=w_ms, plain_ms=min(host_s) * 1e3, plain_on="host",
            bound_ms=floor_ms, bound_by="longest path alone", chain_steps=steps[k],
            ns_per_chain_step=floor_ms * 1e6 / steps[k], share_of_bound=floor_ms / w_ms)
        walk_t = rec["dp_traceback"]

    print(card)
    k2 = dp_t["batch"]
    print(json.dumps({"kernels": [{
        "name": "windows_encoder",
        "route": "cuda",
        "source": "ginfinity_tpu_torch/ops/csrc/windows_encoder.cu",
        "replaces": "ginfinity_tpu/ops/pallas_windows.py:84",
        "launches": launches,
        "mesh_launches": mesh_k1_launches,
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
    }] + [{
        "name": "windows_encoder_staged" + ("" if prec == "highest" else "_bf16"),
        "route": "cuda",
        "precision": prec,
        "config": "forgi-4x512",
        "source": "ginfinity_tpu_torch/ops/csrc/windows_encoder.cu",
        "replaces": "ginfinity_tpu/ops/pallas_windows.py:84",
        "launches": (staged["bf16_launches"] if prec == "bf16"
                     else staged["launches"] - staged["bf16_launches"]),
        "max_abs_err": staged["forgi"][prec]["max_abs_err"],
        "ms": staged["forgi"][prec]["ms"],
        "plain_ms": staged["forgi"][prec]["plain_ms"],
        "bound_ms": staged["forgi"][prec]["bound_ms"],
        "bound_by": staged["forgi"][prec]["bound_by"],
        "library_ms": None,
    } for prec in ("highest", "bf16")] + [{
        "name": "dp_wavefront",
        "route": "cuda",
        "design": "warp-per-pair",
        "source": "ginfinity_tpu_torch/ops/csrc/dp_wavefront.cu",
        "replaces": "ginfinity_tpu/ops/pallas_dp.py:48",
        "launches": dp_launches,
        "train_path_launches": train_k2_launches,
        "mesh_launches": mesh_k2_launches,
        "max_abs_err": max(dp_errs),
        "ms": k2["ms"],
        "plain_ms": k2["plain_ms"],
        "bound_ms": k2["bound_ms"],
        "bound_by": k2["bound_by"],
        "library_ms": None,
    }, {
        "name": "dp_traceback",
        "route": "cuda",
        "design": "thread-per-pair",
        "source": "ginfinity_tpu_torch/ops/csrc/dp_traceback.cu",
        "replaces": "ginfinity_tpu/ops/dp.py:213 (host walk, no TPU kernel)",
        "launches": walk_launches,
        "paths_differing": 0,
        "ms": walk_t["ms"],
        "plain_ms": walk_t["plain_ms"],
        "bound_ms": walk_t["bound_ms"],
        "bound_by": walk_t["bound_by"],
        "library_ms": None,
    }, {
        "name": "value_traceback",
        "route": "cuda",
        "source": "ginfinity_tpu_torch/ops/csrc/value_traceback.cu",
        "replaces": "ginfinity_tpu/ops/pairhmm.py:470",
        "launches": tb_launches,
        "max_abs_err": tb["max_abs_err"],
        "ms": tb["ms"],
        "plain_ms": tb["plain_ms"],
        "bound_ms": tb["bound_ms"],
        "bound_by": tb["bound_by"],
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
