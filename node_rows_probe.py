"""Run-to-run spread of the port's node rows on the card.

Feeds the inputs of ``chip_smoke.py``'s two node checks through
``get_node_embeddings`` on the card several times: the flagship of
``align_path`` (seed ``SEED + 4``) on the first 4 of its structures, and
the forgi flagship of ``variants_path`` (seed ``SEED + 11``) on the first
4 of ``variant_corpora()``.  Prints one JSON line per case: each run's max
abs distance from the CPU's float32 rows and from float64 rows, and
whether the runs are bit-equal.  ``--atomic`` sums the segments on the
card with ``index_add_`` (atomic adds, in an order that changes between
runs) in place of the port's index-ordered sums, to show what they fix.
``--time`` then times the graph path's forward (``embed_graphs`` on the
2,000 structures of ``graph_path``, graphs built beforehand) with the
atomic and the ordered sums in turns, in the same process.

    python3 node_rows_probe.py [--runs 4] [--atomic] [--time]
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np
import torch

import chip_smoke as cs
from ginfinity_tpu_torch.models import gine

_ORDERED = gine._segment_sum  # the port's own: index order on the card


def _atomic_segment_sum(x: torch.Tensor, seg: torch.Tensor, num_segments: int) -> torch.Tensor:
    out = torch.zeros((num_segments,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    return out.index_add_(0, seg, x)


def cases(rng: np.random.Generator):
    """(name, config, params, state, graphs) of the smoke's two node checks."""
    cs.corpus(rng, 2000, 120)
    cs.corpus(rng, cs.N_WINDOWS, cs.WINDOW)
    rnas = [cs.random_structure(rng, int(rng.integers(150, 351)))
            for _ in range(cs.ALIGN_RNAS)]
    cfg = cs.GINConfig.create(**cs.FLAGSHIP)
    yield ("align_path", cfg, *cs.seeded_model(cfg, cs.SEED + 4),
           cs.preprocess_structures(rnas[:4]).graphs)
    forgi = cs.GINConfig.create(**{**cs.FLAGSHIP, "graph_encoding": "forgi"})
    vr, _ = cs.variant_corpora()
    yield ("forgi_flagship", forgi, *cs.variant_model(forgi, cs.SEED + 11),
           cs.preprocess_structures(vr[:4], graph_encoding="forgi",
                                    feature_dim=forgi.node_feature_dim).graphs)


def rows(cfg, params, state, batch, dtype, dev) -> np.ndarray:
    m = cs.GINModel(cfg, params, state).to(dtype).to(dev)
    b = cs.batch_as(batch.to(dev), dtype)
    out = cs.get_node_embeddings(cfg, m.params, m.state, b).cpu().numpy()
    return out[batch.base_mask.numpy() > 0].astype(np.float64)


def time_forward(dev, rounds: int = 5) -> dict:
    """Median seconds of ``embed_graphs`` over the graph path's corpus,
    atomic and ordered sums in turns."""
    rng = np.random.default_rng(cs.SEED + 5)
    rnas = [cs.random_structure(rng, int(rng.integers(150, 351))) for _ in range(cs.GRAPH_RNAS)]
    cfg = cs.GINConfig.create(**cs.FLAGSHIP)
    engine = cs.InferenceEngine(cs.GINModel(cfg, *cs.seeded_model(cfg, cs.SEED + 5)), device=dev)
    graphs = cs.preprocess_structures(rnas).graphs
    secs = {"atomic": [], "ordered": []}
    for _ in range(rounds + 1):
        for name, fn in (("atomic", _atomic_segment_sum), ("ordered", _ORDERED)):
            gine._segment_sum = fn
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            engine.embed_graphs(graphs)
            torch.cuda.synchronize()
            secs[name].append(time.perf_counter() - t0)
    med = {k: statistics.median(v[1:]) for k, v in secs.items()}  # the first round warms up
    return {"case": "graph_path_forward", "card": cs.card_name_and_limit(),
            "structures": len(graphs), "median_seconds": med,
            "structures_per_s": {k: len(graphs) / v for k, v in med.items()}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=4)
    ap.add_argument("--atomic", action="store_true")
    ap.add_argument("--time", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("node_rows_probe: no CUDA device is available", file=sys.stderr)
        return 2
    dev = cs.DEVICE
    torch.cuda.set_device(dev)
    cs.disable_tf32()
    if args.atomic:
        gine._segment_sum = _atomic_segment_sum
    for name, cfg, params, state, graphs in cases(np.random.default_rng(cs.SEED)):
        batch = cs.batch_graphs(graphs)
        cpu = torch.device("cpu")
        r32, r64 = (rows(cfg, params, state, batch, dt, cpu)
                    for dt in (torch.float32, torch.float64))
        runs = [rows(cfg, params, state, batch, torch.float32, dev) for _ in range(args.runs)]
        print(json.dumps({
            "case": name, "atomic": args.atomic, "card": cs.card_name_and_limit(),
            "cpu_vs_float64": float(np.abs(r32 - r64).max()),
            "card_vs_cpu": [float(np.abs(r - r32).max()) for r in runs],
            "card_vs_float64": [float(np.abs(r - r64).max()) for r in runs],
            "runs_bit_equal": all(np.array_equal(r, runs[0]) for r in runs)}), flush=True)
    if args.time:
        print(json.dumps(time_forward(dev)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
