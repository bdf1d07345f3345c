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
  affine-gap DP wavefront).

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
from ginfinity_tpu_torch.ops.dp import (
    dp_kernel_ok,
    pad_batch,
    paths_from_codes,
    wavefront_plain,
)
from ginfinity_tpu_torch.ops.dp_wavefront import barrier_probe, dp_wavefront, smem_limit
from ginfinity_tpu_torch.ops.windows_encoder import (
    forward_windows,
    forward_windows_reference,
    pack_params,
)
from ginfinity_tpu_torch.pipelines import align, align_batch, embed, node_embed
from ginfinity_tpu_torch.pipelines.align import cosine_similarity_matrix
from ginfinity_tpu_torch.pipelines.engine import InferenceEngine, preprocess_structures
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
DP_GAPS = ((-1.0, -1.0), (-2.0, -0.5), (-10.0, -0.5), (-1.5, -0.3))
DP_TOL = 1e-4              # |score| kernel vs plain version (0 expected)
DP_OPS_PER_CELL = 10       # float32 adds and compares per DP cell
ALIGN_RNAS = 64            # structures of the alignment path: 2,016 pairs
ALIGN_BATCH = 64           # pairs per DP launch (the CLI's default)

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


def dp_tensors(mats, dev, L1=None, L2=None):
    """A batch of score matrices padded as ``affine_align_batch`` pads it,
    on ``dev``, with the real sides also on the host."""
    scores, l1, l2 = pad_batch(mats, L1, L2)
    return (torch.from_numpy(scores).to(dev), torch.from_numpy(l1).to(dev),
            torch.from_numpy(l2).to(dev), l1, l2)


def dp_compare(mats, go, ge, mode, dev) -> tuple[float, list]:
    """K2 against the plain wavefront on the same batch on the card:
    identical paths and best cells, |score| within DP_TOL.  Returns the
    max score difference and the plain version's (score, path) per pair."""
    s, l1d, l2d, l1, l2 = dp_tensors(mats, dev)
    got = [t.cpu().numpy() for t in dp_wavefront(s, l1d, l2d, go, ge, mode)]
    ref = [t.cpu().numpy() for t in wavefront_plain(s, l1d, l2d, go, ge, mode)]
    err = float(np.abs(got[0] - ref[0]).max())
    if not (err <= DP_TOL and np.isfinite(got[0]).all()):
        raise AssertionError(f"K2 vs plain ({mode}, {go}, {ge}): |score| {err} > {DP_TOL}")
    if not (np.array_equal(got[1], ref[1]) and np.array_equal(got[2], ref[2])):
        raise AssertionError(f"K2 vs plain ({mode}, {go}, {ge}): best cells differ")
    paths = paths_from_codes(ref[3], l1, l2, ref[1], ref[2], mode)
    if paths != paths_from_codes(got[3], l1, l2, got[1], got[2], mode):
        raise AssertionError(f"K2 vs plain ({mode}, {go}, {ge}): paths differ")
    return err, list(zip(ref[0].tolist(), paths))


def dp_cases(rng: np.random.Generator, max_l1: int) -> dict:
    """The inputs K2 is held to its plain version on: seeded normal
    matrices with sides 3-384, integer-valued matrices (ties everywhere),
    the rectangular extremes 3x37 and 31x4, all-negative matrices (local
    mode: an empty path) and one pair near the gate's upper limit."""
    f32 = np.float32
    sides = [(3, 384), (384, 3), (384, 384)] + [
        (int(rng.integers(3, 385)), int(rng.integers(3, 385))) for _ in range(13)]
    return {
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


def dp_bounds(l1: np.ndarray, l2: np.ndarray, L1: int, L2: int) -> tuple[float, str, float]:
    """Least time for K2's work on these pairs: the scores its cells read
    (each real cell once) and the codes it writes ([B, L1+L2, L1+1]
    bytes) over the memory rate, against DP_OPS_PER_CELL float32
    operations per real cell over the float32 rate."""
    cells = float(((l1.astype(np.int64) + 1) * (l2.astype(np.int64) + 1)).sum())
    nbytes = 4.0 * float((l1.astype(np.int64) * l2).sum()) + len(l1) * (L1 + L2) * (L1 + 1)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, cells * DP_OPS_PER_CELL / F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes


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

    dp_errs = []
    with phase("dp_kernel_vs_plain", {"tolerance": DP_TOL}) as rec:
        limit = smem_limit(dev)
        max_l1 = max(L for L in range(1, 20000) if dp_kernel_ok(L, 8, "global", limit))
        cases = dp_cases(np.random.default_rng(SEED + 5), max_l1)
        n_pairs = 0
        for mode in ("global", "local"):
            for go, ge in DP_GAPS:
                for name, mats in cases.items():
                    err, res = dp_compare(mats, go, ge, mode, dev)
                    if name == "all_negative" and mode == "local" and \
                            any(r != (0.0, []) for r in res):
                        raise AssertionError(f"local all-negative: {res} is not empty")
                    dp_errs.append(err)
                    n_pairs += len(mats)
        rec.update(pairs_compared=n_pairs, max_abs_err=max(dp_errs), smem_optin=limit,
                   gate_max_l1=max_l1, cases=sorted(cases))

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

    with tempfile.TemporaryDirectory() as tmp, phase("align_path", {"card": card}) as rec:
        rnas = [random_structure(rng, int(rng.integers(150, 351)))
                for _ in range(ALIGN_RNAS)]
        params, state = seeded_model(cfg, SEED + 4)
        ckpt = os.path.join(tmp, "flagship.pth")
        export_torch_checkpoint(ckpt, cfg, params, state)
        src = os.path.join(tmp, "structures.csv")
        with open(src, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["rid", "secondary_structure"])
            w.writerows((f"rna{i}", s) for i, s in enumerate(rnas))
        nodes = os.path.join(tmp, "nodes.tsv")
        out_dir = os.path.join(tmp, "pairs")
        n_pairs = ALIGN_RNAS * (ALIGN_RNAS - 1) // 2

        forward_windows.launches = dp_wavefront.launches = wavefront_plain.launches = 0
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
        window_launches = forward_windows.launches
        expected = -(-n_pairs // ALIGN_BATCH)
        if batch_launches != expected or dp_launches != expected + 1 or plain_launches:
            raise AssertionError(f"the align path launched K2 {batch_launches} + "
                                 f"{dp_launches - batch_launches} times (expected {expected}"
                                 f" + 1) and the plain DP {plain_launches} times")

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
        err, plain_res = dp_compare(sims, -1.0, -1.0, "global", dev)
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
                   window_kernel_launches=window_launches,
                   plain_dp_launches=plain_launches,
                   host_similarity_seconds=t_sim, device_dp_seconds=t_dev,
                   host_codes_dense_traceback_seconds=t_host,
                   plain_recheck_pairs=len(sims), plain_recheck_max_abs_err=max(err, cli_err))

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

        # K2 on the align path's first batch, as the CLI pads it and padded
        # to 384 x 384; its dependency floor is the probe's time for the
        # same number of diagonal steps in CTAs of the same shape
        sims = dp_batches[0]
        dp_t = {}
        for key, L in (("batch", None), ("384", 384)):
            sd, l1d, l2d, l1, l2 = dp_tensors(sims, dev, L, L)
            B, L1, L2 = sd.shape
            run = (sd, l1d, l2d, -1.0, -1.0, "global")
            k_ms = cuda_ms(lambda: dp_wavefront(*run), 20)
            p_ms = cuda_ms(lambda: wavefront_plain(*run), 2)
            b_ms, b_by, nbytes = dp_bounds(l1, l2, L1, L2)
            dep_ms = cuda_ms(lambda: barrier_probe(B, L1 + L2, L1, dev), 20)
            dp_t[key] = dict(pairs=B, L1=L1, L2=L2, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                             bound_by=b_by, bytes=nbytes, dependency_floor_ms=dep_ms)
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
        "name": "dp_wavefront",
        "route": "cuda",
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
