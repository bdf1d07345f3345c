"""Train-to-a-measured-model harness.

Port of ``ginfinity_tpu/pipelines/train_eval.py``: it generates
alignment-mode training data with exact ground truth (the msa_eval
family generator: ancestor coordinates double as alignment positions),
trains an architecture through the real multi-round schedule path (the
port's ``ginfinity-train --schedule``), exports ``.pth``, and scores a
checkpoint on two probes over held-out families:

- **retrieval recall@10**: graph embeddings of all held-out members;
  for each query member, the fraction of its same-family relatives
  among its 10 nearest neighbours (squared Euclidean, exact).
- **pairwise-alignment SP-F1**: node embeddings -> cosine similarity ->
  global affine DP (the ginfinity-align path: the DP wavefront kernel
  on the card), scored against the known homology.

``compare_trained_vs_packaged`` also scores the reference's packaged
weights, read from the reference GINFINITY checkout that
``GINFINITY_REFERENCE_ROOT`` names (``msa_eval.reference_path``).
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

from ginfinity_tpu_torch.pipelines.msa_eval import FamilyMember, make_family, reference_path
from ginfinity_tpu_torch.utils.io import write_tsv

# the packaged weights, relative to the reference checkout's root
PACKAGED = ("src", "ginfinity", "weights", "gin_weights_regression_180925.pth")


# --------------------------------------------------------------------------
# Training-data generation (alignment mode, categorised maps)
# --------------------------------------------------------------------------


def _member_map_entry(m: FamilyMember) -> dict:
    """The categorised alignment map of one member: conserved positions,
    keyed 1-based by structure position, -> alignment position (the
    ancestor coordinate), by pairedness; insertions are unaligned."""
    cats: dict[str, dict] = {}

    def put(cat, sp, ap):
        cats.setdefault(cat, {})[str(sp + 1)] = ap

    for i, anc in enumerate(m.posmap):
        ch = m.structure[i]
        base = "5-paired" if ch == "(" else ("3-paired" if ch == ")" else "unpaired")
        if anc >= 0:
            put(base, i, int(anc))
        else:
            put("unaligned-" + base, i, -1)
    return cats


def generate_alignment_training_data(
    outdir: str,
    n_train_families: int = 120,
    n_eval_families: int = 24,
    n_seqs: int = 5,
    anc_len: int = 100,
    seed: int = 7,
) -> tuple[str, str, list[list[FamilyMember]]]:
    """Write the alignment-mode training TSV + map JSON (the JAX
    package's bytes); return the held-out evaluation families (never
    seen in training)."""
    os.makedirs(outdir, exist_ok=True)
    rows = []
    amap = {}
    for f in range(n_train_families):
        members = make_family(
            seed + f, n_seqs=n_seqs, anc_len=anc_len,
            sub_rate=0.05, del_rate=0.03, ins_rate=0.03,
        )
        aid = f"fam{f}"
        amap[aid] = {}
        for s, m in enumerate(members):
            rows.append([aid, s, m.structure, m.sequence])
            amap[aid][str(s)] = _member_map_entry(m)
    data_p = os.path.join(outdir, "align_train.tsv")
    write_tsv(data_p, ["alignment_id", "sequence_id", "structure", "sequence"], rows)
    map_p = os.path.join(outdir, "align_map.json")
    with open(map_p, "w") as fh:
        json.dump(amap, fh)

    eval_families = [
        make_family(
            seed + 100_000 + f, n_seqs=n_seqs, anc_len=anc_len,
            sub_rate=0.05, del_rate=0.03, ins_rate=0.03,
        )
        for f in range(n_eval_families)
    ]
    return data_p, map_p, eval_families


# --------------------------------------------------------------------------
# Training through the real schedule path
# --------------------------------------------------------------------------

METHODS_BUDGET = [  # the reference's 3-round budget: lr 5e-4/1e-4/1e-5
    {"lr": 5e-4, "decay_rate": 0.98, "patience": 10, "num_epochs": 200},
    {"lr": 1e-4, "decay_rate": 0.95, "patience": 15, "num_epochs": 200},
    {"lr": 1e-5, "decay_rate": 0.98, "patience": 15, "num_epochs": 200},
]


# Architecture flag sets.  "packaged" mirrors the shipped checkpoint (6 x
# GINE-128, standard encoding); "flagship" is the reference's production
# alignment-training config: 4 layers, hidden 256,512,512,512 -> output
# 512, forgi encoding.
ARCH_FLAGS = {
    "packaged": ["--hidden_dim", "128", "--gin_layers", "6",
                 "--output_dim", "128"],
    "flagship": ["--hidden_dim", "256,512,512,512", "--gin_layers", "4",
                 "--output_dim", "512", "--graph_encoding", "forgi",
                 "--pooling_type", "global_mean_pool"],
}


def train_packaged_architecture(
    data_p: str,
    map_p: str,
    outdir: str,
    rounds: list[dict] | None = None,
    batch_size: int = 32,
    model_id: str = "trained_eval",
    arch: str = "packaged",
    checkpoint: str | None = None,
    device: str | None = None,
) -> tuple[str, float]:
    """Run the multi-round schedule on a named architecture (see
    ``ARCH_FLAGS``; the default mirrors the packaged checkpoint) with the
    alignment-contrastive objective; returns (.pth path, wall-clock
    seconds).  ``checkpoint`` (a ``.pth``) becomes the schedule's
    starting weights, and then its architecture is the one trained;
    ``device`` is the CLI's ``--device``."""
    from ginfinity_tpu_torch.training.train_cli import main as train_main

    rounds = rounds if rounds is not None else METHODS_BUDGET
    schedule = [
        {
            "round": i + 1,
            "input": data_p,
            "alignment_map": map_p,
            "patience": r["patience"],
            "epochs": r["num_epochs"],
            "learning_rate": r["lr"],
            "decay_rate": r["decay_rate"],
            "keep_weights": True,
        }
        for i, r in enumerate(rounds)
    ]
    if checkpoint is not None:
        schedule = {"checkpoint": os.path.abspath(checkpoint), "rounds": schedule}
    sched_p = os.path.join(outdir, "schedule.json")
    os.makedirs(outdir, exist_ok=True)
    with open(sched_p, "w") as fh:
        json.dump(schedule, fh)
    cwd = os.getcwd()
    t0 = time.perf_counter()
    try:
        os.chdir(outdir)
        train_main([
            "--schedule", sched_p, "--model_id", model_id,
            "--training_mode", "alignment",
            *ARCH_FLAGS[arch],
            "--norm_type", "graph", "--node_embed_norm", "zscore_l2",
            "--normalize_nodes_before_pool", "--dropout", "0.05",
            "--batch_size", str(batch_size), "--val_fraction", "0.03",
            "--min_delta", "1e-4", "--data-parallel",
            *(["--device", device] if device is not None else []),
        ])
    finally:
        os.chdir(cwd)
    wall = time.perf_counter() - t0
    last = f"round_{len(rounds):02d}"
    ckpt = os.path.join(
        outdir, "output", model_id, last, f"{model_id}_{last}.pth"
    )
    if not os.path.exists(ckpt):
        raise RuntimeError(f"training did not produce {ckpt}")
    return ckpt, wall


# --------------------------------------------------------------------------
# Evaluation probes
# --------------------------------------------------------------------------


def _engine(ckpt: str, device=None):
    from ginfinity_tpu_torch.pipelines.engine import InferenceEngine

    return InferenceEngine.from_checkpoint(ckpt, device=device)


def _family_graphs(engine, families: list[list[FamilyMember]]):
    from ginfinity_tpu_torch.pipelines.engine import preprocess_structures

    cfg = engine.config
    flat = [(fi, m) for fi, fam in enumerate(families) for m in fam]
    pre = preprocess_structures(
        [m.structure for _, m in flat],
        [m.sequence for _, m in flat],
        graph_encoding=cfg.graph_encoding or "standard",
        seq_weight=cfg.seq_weight,
        feature_dim=cfg.node_feature_dim,
    )
    if len(pre.graphs) != len(flat):
        raise RuntimeError(f"eval structures skipped: {pre.skipped}")
    return flat, pre.graphs


def retrieval_recall_at_10(ckpt: str, families: list[list[FamilyMember]],
                           device=None) -> float:
    """Mean over queries of |top-10 ∩ same-family| / |same-family|."""
    engine = _engine(ckpt, device)
    flat, graphs = _family_graphs(engine, families)
    embs = np.asarray(engine.embed_graphs(graphs), np.float32)
    fam_ids = np.array([fi for fi, _ in flat])
    d2 = (
        (embs**2).sum(1)[:, None]
        + (embs**2).sum(1)[None, :]
        - 2.0 * embs @ embs.T
    )
    np.fill_diagonal(d2, np.inf)
    recalls = []
    for q in range(len(flat)):
        rel = np.nonzero(fam_ids == fam_ids[q])[0]
        rel = rel[rel != q]
        if rel.size == 0:
            continue
        # argpartition needs kth < len; tiny eval sets (<= 11 members)
        # rank every candidate
        kth = min(10, len(flat) - 1)
        top = np.argpartition(d2[q], kth)[:10]
        recalls.append(len(set(top.tolist()) & set(rel.tolist())) / rel.size)
    return float(np.mean(recalls))


def alignment_sp_f1(
    ckpt: str,
    families: list[list[FamilyMember]],
    gap_open: float = -0.5,
    gap_extend: float = -0.1,
    device=None,
) -> float:
    """Pairwise-alignment probe: node embeddings -> cosine -> global
    affine DP (one batch: the DP wavefront kernel on the card); SP-F1 of
    the aligned position pairs vs the known homology, averaged over all
    within-family pairs."""
    from ginfinity_tpu_torch.ops.dp import affine_align_batch
    from ginfinity_tpu_torch.pipelines.msa import _l2_normalize_rows

    engine = _engine(ckpt, device)
    flat, graphs = _family_graphs(engine, families)
    mats = engine.node_embeddings(graphs, base_only=True)
    mats = [_l2_normalize_rows(np.asarray(m, np.float32)) for m in mats]
    by_fam: dict[int, list[int]] = {}
    for k, (fi, _) in enumerate(flat):
        by_fam.setdefault(fi, []).append(k)

    score_mats = []
    pair_members = []
    for fi, idxs in by_fam.items():
        for x in range(len(idxs)):
            for y in range(x + 1, len(idxs)):
                a, b = idxs[x], idxs[y]
                score_mats.append(mats[a] @ mats[b].T)
                pair_members.append((flat[a][1], flat[b][1]))
    results = affine_align_batch(score_mats, gap_open, gap_extend, mode="global",
                                 device=engine.device)

    f1s = []
    for (score, path), (A, B) in zip(results, pair_members):
        anc_to_b = {int(p): j for j, p in enumerate(B.posmap) if p >= 0}
        true_pairs = {
            (i, anc_to_b[int(p)])
            for i, p in enumerate(A.posmap)
            if p >= 0 and int(p) in anc_to_b
        }
        pred = {
            (int(i), int(j))
            for i, j in path
            if i is not None and j is not None  # gap steps carry None
        }
        if not true_pairs:
            continue
        hit = len(true_pairs & pred)
        recall = hit / len(true_pairs)
        precision = hit / max(len(pred), 1)
        f1s.append(
            2 * precision * recall / (precision + recall)
            if precision + recall > 0
            else 0.0
        )
    return float(np.mean(f1s))


def compare_trained_vs_packaged(
    workdir: str,
    rounds: list[dict] | None = None,
    n_train_families: int = 120,
    n_eval_families: int = 24,
    arch: str = "packaged",
    device: str | None = None,
) -> dict:
    """End-to-end: generate data, train, evaluate both checkpoints."""
    data_p, map_p, eval_families = generate_alignment_training_data(
        workdir, n_train_families=n_train_families,
        n_eval_families=n_eval_families,
    )
    ckpt, train_wall = train_packaged_architecture(
        data_p, map_p, workdir, rounds=rounds, arch=arch, device=device
    )
    out = {"train_wall_sec": round(train_wall, 1)}
    for name, path in (("trained", ckpt), ("packaged", reference_path(PACKAGED))):
        out[name + "_recall_at_10"] = round(
            retrieval_recall_at_10(path, eval_families, device), 4
        )
        out[name + "_alignment_sp_f1"] = round(
            alignment_sp_f1(path, eval_families, device=device), 4
        )
    out["n_train_families"] = n_train_families
    out["n_eval_families"] = n_eval_families
    out["arch"] = arch
    return out
