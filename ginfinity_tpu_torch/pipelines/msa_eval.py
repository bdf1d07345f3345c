"""MSA output quality against families of known homology.

Port of ``ginfinity_tpu/pipelines/msa_eval.py``: the same family
generator (bit-equal from the same seeds), embedding TSV, scoring,
runners and CLI (plus ``--device``).  A family is a random ancestor
mutated by substitutions and indels, every surviving position tracked
back to its ancestor coordinate.  Every member is node-embedded with a
checkpoint, the port's ``ginfinity-embed-msa`` aligns them, and the
alignment is scored against the truth:

- **SP (sum-of-pairs) recall/precision/F1**: over all sequence pairs,
  the fraction of truly homologous position pairs co-aligned into one
  column (recall), and of co-aligned pairs that are truly homologous
  (precision).
- **Column agreement**: +1 per correctly co-aligned homologous position
  pair, -1 otherwise, equal to (2 * recall - 1) * n_true_pairs.

``compare_on_family`` and ``posterior_stage_quality`` also run the
reference's ``embed_msa.py`` and its forward/backward;
``load_reference_ancestors`` reads the reference's example data.  Both
come from the reference GINFINITY checkout whose root
``GINFINITY_REFERENCE_ROOT`` names (the JAX package reads a fixed
location); where it is unset or the files are absent they raise
``FileNotFoundError``, as the JAX package's do without its checkout.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

from ginfinity_tpu_torch.graphs.dotbracket import pair_table
from ginfinity_tpu_torch.utils.device import resolve_device
from ginfinity_tpu_torch.utils.io import cell_text, read_table, write_tsv

# the reference checkout's files, relative to its root
REFERENCE_MSA = ("src", "ginfinity", "scripts", "embed_msa.py")
REFERENCE_DATA = ("example_data", "sample_dataset.csv")


def reference_path(parts) -> str:
    """A file of the reference GINFINITY checkout under
    ``$GINFINITY_REFERENCE_ROOT``."""
    root = os.environ.get("GINFINITY_REFERENCE_ROOT")
    if not root:
        raise FileNotFoundError(
            "GINFINITY_REFERENCE_ROOT is not set: it names the reference GINFINITY "
            "checkout whose files this step reads")
    return os.path.join(root, *parts)


# --------------------------------------------------------------------------
# Synthetic families with known homology
# --------------------------------------------------------------------------


@dataclasses.dataclass
class FamilyMember:
    name: str
    structure: str
    sequence: str
    # posmap[i] = ancestor position of member position i, or -1 (insertion)
    posmap: np.ndarray


def random_structure(
    rng: np.random.Generator,
    n: int,
    p_stem: float = 0.75,
    min_paired_frac: float = 0.3,
) -> str:
    """Valid dot-bracket of length exactly ``n``: nested stems with
    hairpin loops >= 3 nt, occasional multiloop branching.  Drawn again
    until at least ``min_paired_frac`` of positions are paired (an
    all-loop structure anchors no structural alignment)."""

    def draw() -> str:
        out: list[str] = []

        def gen(m: int, depth: int) -> None:
            if m < 11 or rng.random() > p_stem * (0.9 ** depth):
                out.append("." * m)
                return
            if m >= 26 and rng.random() < 0.35:  # multiloop: two branches
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


_PAIRED = {"A": "U", "U": "A", "G": "C", "C": "G"}
_BASES = "ACGU"


def random_sequence(rng: np.random.Generator, structure: str) -> str:
    pt = pair_table(structure)
    seq = [""] * len(structure)
    for i, p in enumerate(pt):
        if p < 0:
            seq[i] = _BASES[int(rng.integers(4))]
        elif p > i:
            seq[i] = _BASES[int(rng.integers(4))]
            seq[p] = _PAIRED[seq[i]]
    return "".join(seq)


def mutate_member(
    rng: np.random.Generator,
    structure: str,
    sequence: str,
    name: str,
    sub_rate: float = 0.1,
    del_rate: float = 0.05,
    ins_rate: float = 0.05,
) -> FamilyMember:
    """One descendant: delete positions (a deleted position's partner
    becomes unpaired, so the structure stays valid), insert unpaired
    runs, substitute letters; every surviving position keeps its
    ancestor coordinate."""
    pt = pair_table(structure)
    n = len(structure)
    keep = rng.random(n) >= del_rate
    chars: list[str] = []
    seq_out: list[str] = []
    posmap: list[int] = []
    for i in range(n):
        if not keep[i]:
            continue
        c = structure[i]
        if pt[i] >= 0 and not keep[pt[i]]:
            c = "."  # partner deleted -> unpaired
        chars.append(c)
        s = sequence[i]
        if rng.random() < sub_rate:
            s = _BASES[int(rng.integers(4))]
        seq_out.append(s)
        posmap.append(i)
        if rng.random() < ins_rate:
            for _ in range(int(rng.integers(1, 4))):
                chars.append(".")
                seq_out.append(_BASES[int(rng.integers(4))])
                posmap.append(-1)
    return FamilyMember(name, "".join(chars), "".join(seq_out), np.asarray(posmap, np.int64))


def make_family(
    seed: int,
    n_seqs: int = 6,
    anc_len: int = 120,
    sub_rate: float = 0.1,
    del_rate: float = 0.05,
    ins_rate: float = 0.05,
) -> list[FamilyMember]:
    rng = np.random.default_rng(seed)
    anc_struct = random_structure(rng, anc_len)
    anc_seq = random_sequence(rng, anc_struct)
    return [
        mutate_member(rng, anc_struct, anc_seq, f"seq{k + 1}", sub_rate, del_rate, ins_rate)
        for k in range(n_seqs)
    ]


def load_reference_ancestors(
    min_len: int = 0,
    max_len: int = 10**9,
    limit: int | None = None,
    csv_path: str | None = None,
) -> list[tuple[str, str, str]]:
    """The reference's example dataset (100 Rfam RNase-MRP structures,
    198-593 nt) as (id, structure, sequence) ancestors for
    :func:`make_family_from_ancestor`, shortest first, so ``limit`` gives
    a deterministic, cost-bounded subset."""
    table = read_table(csv_path or reference_path(REFERENCE_DATA))
    rows = [
        (str(r["rnacentral_id"]), str(r["secondary_structure"]), str(r["sequence"]))
        for r in table.rows
        if min_len <= len(str(r["secondary_structure"])) <= max_len
    ]
    rows.sort(key=lambda t: (len(t[1]), t[0]))
    return rows[:limit] if limit is not None else rows


def make_family_from_ancestor(
    seed: int,
    structure: str,
    sequence: str,
    n_seqs: int = 6,
    sub_rate: float = 0.1,
    del_rate: float = 0.05,
    ins_rate: float = 0.05,
) -> list[FamilyMember]:
    """Known-homology family whose ancestor is a given (real) structure."""
    rng = np.random.default_rng(seed)
    return [
        mutate_member(rng, structure, sequence, f"seq{k + 1}", sub_rate, del_rate, ins_rate)
        for k in range(n_seqs)
    ]


# --------------------------------------------------------------------------
# Embeddings and the shared input TSV
# --------------------------------------------------------------------------


def family_to_tsv(
    members: list[FamilyMember],
    model_path: str,
    out_tsv: str,
    include_structure: bool = True,
    device=None,
) -> None:
    """Node-embed every member with the checkpoint on ``device`` (the card
    unless ``"cpu"``) and write the TSV the MSA pipeline reads: Name,
    node_embeddings JSON [, DotBracket]."""
    from ginfinity_tpu_torch.pipelines.engine import InferenceEngine, preprocess_structures
    from ginfinity_tpu_torch.pipelines.node_embed import serialize_matrix

    device = resolve_device(device)  # refuse before reading the checkpoint
    engine = InferenceEngine.from_checkpoint(model_path, device=device)
    cfg = engine.config
    pre = preprocess_structures(
        [m.structure for m in members],
        [m.sequence for m in members],
        graph_encoding=cfg.graph_encoding or "standard",
        seq_weight=cfg.seq_weight,
        feature_dim=cfg.node_feature_dim,
    )
    if len(pre.graphs) != len(members):
        raise RuntimeError(f"structures skipped in preprocessing: {pre.skipped}")
    mats = engine.node_embeddings(pre.graphs, base_only=True)
    columns = ["Name", "node_embeddings"] + (["DotBracket"] if include_structure else [])
    rows = [[m.name, serialize_matrix(mat)] + ([m.structure] if include_structure else [])
            for m, mat in zip(members, mats)]
    write_tsv(out_tsv, columns, rows)


# --------------------------------------------------------------------------
# Ground-truth scoring
# --------------------------------------------------------------------------


def _pos_to_col(aligned: str) -> np.ndarray:
    """cols[k] = alignment column of the k-th non-gap position."""
    a = np.frombuffer(aligned.encode("latin-1"), np.uint8)
    return np.nonzero(a != ord("-"))[0]


def sp_scores(msa: dict[str, str], members: list[FamilyMember]) -> dict:
    """Sum-of-pairs recall/precision/F1 and column agreement of an
    alignment against the known ancestor homology."""
    n_true = n_pred = n_hit = 0
    for ai in range(len(members)):
        for bi in range(ai + 1, len(members)):
            A, B = members[ai], members[bi]
            if A.name not in msa or B.name not in msa:
                raise ValueError(f"names missing from MSA: {A.name}, {B.name}")
            colA = _pos_to_col(msa[A.name])
            colB = _pos_to_col(msa[B.name])
            if colA.size != A.posmap.size or colB.size != B.posmap.size:
                raise ValueError(
                    f"aligned length mismatch for {A.name}/{B.name}: "
                    f"{colA.size}/{A.posmap.size}, {colB.size}/{B.posmap.size}"
                )
            # homologous positions are exactly those sharing an ancestor
            # coordinate
            anc_to_a = {int(p): i for i, p in enumerate(A.posmap) if p >= 0}
            anc_to_b = {int(p): j for j, p in enumerate(B.posmap) if p >= 0}
            common = set(anc_to_a) & set(anc_to_b)
            n_true += len(common)
            n_hit += sum(1 for anc in common if colA[anc_to_a[anc]] == colB[anc_to_b[anc]])
            # predicted co-aligned pairs: columns where both are non-gap
            n_pred += np.intersect1d(colA, colB, assume_unique=True).size
    recall = n_hit / n_true if n_true else 0.0
    precision = n_hit / n_pred if n_pred else 0.0
    f1 = (2 * precision * recall / (precision + recall)
          if (precision + recall) > 0 else 0.0)
    return {
        "sp_recall": recall,
        "sp_precision": precision,
        "sp_f1": f1,
        "column_agreement": 2 * n_hit - n_true,
        "n_true_pairs": n_true,
    }


def load_aln_tsv(path: str) -> dict[str, str]:
    table = read_table(path, sep="\t")
    return {cell_text(r["Name"]): cell_text(r["Aligned"]) for r in table.rows}


# --------------------------------------------------------------------------
# Pipeline runners
# --------------------------------------------------------------------------

_SHARED_FLAGS = (
    "--name-col", "Name", "--embeds-col", "node_embeddings",
    "--tree", "nj", "--refine-iters", "0",
)


def _param_flags(params: dict) -> list[str]:
    out = []
    # refine_iters comes after _SHARED_FLAGS' "--refine-iters 0", so
    # argparse's last-wins override applies
    for k in ("topk", "consistency_rounds", "alpha", "beta", "gap_open",
              "gap_extend", "max_pairs", "seed", "refine_iters",
              "refine_min_gain"):
        if k in params:
            out += [f"--{k.replace('_', '-')}", str(params[k])]
    return out


def run_repo_msa(tsv: str, out_prefix: str, params: dict,
                 dp_score: str = "profile", device=None) -> float:
    """Seconds of one run of the port's ``ginfinity-embed-msa`` on
    ``device`` (the card unless ``"cpu"``)."""
    from ginfinity_tpu_torch.pipelines.msa import main as msa_main

    dev = [] if device is None else ["--device", str(device)]
    t0 = time.perf_counter()
    msa_main(["--input", tsv, "--out-prefix", out_prefix, "--dp-score", dp_score,
              *_SHARED_FLAGS, *_param_flags(params), *dev])
    return time.perf_counter() - t0


def run_reference_msa(tsv: str, out_prefix: str, params: dict,
                      timeout: int = 3600) -> float:
    """Subprocess the reference's embed_msa.py (pure-Python kernels)."""
    script = reference_path(REFERENCE_MSA)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, script, "--input", tsv,
         "--out-prefix", out_prefix, *_SHARED_FLAGS, *_param_flags(params)],
        capture_output=True, text=True, timeout=timeout,
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"reference embed_msa.py failed (rc={proc.returncode}):\n"
            f"{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}"
        )
    return time.perf_counter() - t0


DEFAULT_PARAMS = {
    # both CLIs' documented defaults, pinned so the comparison is
    # parameter-identical
    "topk": 20, "consistency_rounds": 1, "alpha": 5.0, "beta": 0.0,
    "gap_open": -10.0, "gap_extend": -0.5, "seed": 42,
}


def compare_on_family(
    members: list[FamilyMember],
    model_path: str,
    workdir: str,
    params: dict | None = None,
    device=None,
) -> dict:
    """Run the port's pipeline (profile mode, library mode, library mode
    at its own defaults) and the reference's on one family's shared
    embeddings TSV, and score every alignment against the known
    homology."""
    os.makedirs(workdir, exist_ok=True)
    params = dict(DEFAULT_PARAMS, **(params or {}))
    tsv = os.path.join(workdir, "family_node_embeddings.tsv")
    family_to_tsv(members, model_path, tsv, device=device)

    repo_prefix = os.path.join(workdir, "repo", "msa")
    lib_prefix = os.path.join(workdir, "repo_library", "msa")
    tuned_prefix = os.path.join(workdir, "repo_library_tuned", "msa")
    ref_prefix = os.path.join(workdir, "ref", "msa")
    repo_sec = run_repo_msa(tsv, repo_prefix, params, device=device)
    lib_sec = run_repo_msa(tsv, lib_prefix, params, dp_score="library", device=device)
    # library mode at its out-of-box defaults (mode-resolved gap_open and
    # alpha): what a user gets with no flags
    tuned_params = {k: v for k, v in params.items()
                    if k not in ("alpha", "beta", "gap_open", "gap_extend")}
    tuned_sec = run_repo_msa(tsv, tuned_prefix, tuned_params, dp_score="library",
                             device=device)
    ref_sec = run_reference_msa(tsv, ref_prefix, params)

    repo_scores = sp_scores(load_aln_tsv(repo_prefix + ".aln.tsv"), members)
    lib_scores = sp_scores(load_aln_tsv(lib_prefix + ".aln.tsv"), members)
    tuned_scores = sp_scores(load_aln_tsv(tuned_prefix + ".aln.tsv"), members)
    ref_scores = sp_scores(load_aln_tsv(ref_prefix + ".aln.tsv"), members)
    return {
        "repo": {**repo_scores, "wall_sec": round(repo_sec, 2)},
        "repo_library": {**lib_scores, "wall_sec": round(lib_sec, 2)},
        "repo_library_tuned": {**tuned_scores, "wall_sec": round(tuned_sec, 2)},
        "reference": {**ref_scores, "wall_sec": round(ref_sec, 2)},
        "params": params,
        "n_seqs": len(members),
        "lengths": [len(m.structure) for m in members],
    }


# --------------------------------------------------------------------------
# The pair-HMM stage alone
# --------------------------------------------------------------------------


def _reference_msa_module():
    """The reference's embed_msa.py imported as a module (read-only)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("_ref_embed_msa",
                                                  reference_path(REFERENCE_MSA))
    mod = importlib.util.module_from_spec(spec)
    sys.modules["_ref_embed_msa"] = mod  # dataclass processing needs this
    spec.loader.exec_module(mod)
    return mod


def posterior_stage_quality(
    members: list[FamilyMember],
    model_path: str,
    workdir: str,
    params: dict | None = None,
    max_pairs: int = 6,
    device=None,
) -> dict:
    """The same calibrated log-odds through the port's sum-product
    forward/backward and the reference's
    ``forward_backward_affine_logspace``: the fraction of posterior mass
    on truly homologous cells and the mean posterior on them."""
    from ginfinity_tpu_torch.ops.pairhmm import pairhmm_posteriors
    from ginfinity_tpu_torch.pipelines.msa import (
        _l2_normalize_rows,
        _parse_matrix_cell,
        calibrate_log_odds,
    )

    params = dict(DEFAULT_PARAMS, **(params or {}))
    tsv = os.path.join(workdir, "family_node_embeddings.tsv")
    if not os.path.exists(tsv):
        os.makedirs(workdir, exist_ok=True)
        family_to_tsv(members, model_path, tsv, device=device)
    cells = {cell_text(r["Name"]): r["node_embeddings"] for r in read_table(tsv, sep="\t").rows}
    embs = {m.name: _l2_normalize_rows(_parse_matrix_cell(cells[m.name])) for m in members}
    ref_mod = _reference_msa_module()

    pair_list = [(a, b) for a in range(len(members))
                 for b in range(a + 1, len(members))][:max_pairs]
    mats = []
    truths = []
    for a, b in pair_list:
        A, B = members[a], members[b]
        S = embs[A.name] @ embs[B.name].T
        mats.append(calibrate_log_odds(S, params["alpha"], params["beta"]))
        anc_to_b = {int(p): j for j, p in enumerate(B.posmap) if p >= 0}
        t = np.zeros(S.shape, bool)
        for i, p in enumerate(A.posmap):
            j = anc_to_b.get(int(p), None) if p >= 0 else None
            if j is not None:
                t[i, j] = True
        truths.append(t)

    ours = pairhmm_posteriors(mats, params["gap_open"], params["gap_extend"], device=device)
    theirs = [
        ref_mod.forward_backward_affine_logspace(
            m.astype(np.float32), params["gap_open"], params["gap_extend"])
        for m in mats
    ]

    def stats(posts):
        # a pair can have no surviving homologous position (heavy indel
        # draws); an empty mask's mean would make the report NaN
        kept = [(p, t) for p, t in zip(posts, truths) if t.any()]
        if not kept:
            return {"true_mass_fraction": 0.0, "mean_posterior_on_true": 0.0,
                    "finite_fraction": 1.0}
        mass_frac = float(np.mean([p[t].sum() / max(p.sum(), 1e-9) for p, t in kept]))
        mean_true = float(np.mean([p[t].mean() for p, t in kept]))
        finite = float(np.mean([np.isfinite(p).mean() for p in posts]))
        return {"true_mass_fraction": mass_frac, "mean_posterior_on_true": mean_true,
                "finite_fraction": finite}

    return {"repo": stats(ours), "reference": stats(theirs), "n_pairs": len(pair_list)}


# --------------------------------------------------------------------------
# CLI
# --------------------------------------------------------------------------


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Compare MSA output quality vs the reference pipeline "
        "on synthetic families with known homology (PyTorch port)."
    )
    ap.add_argument("--model-path", required=True)
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--families", type=int, default=3)
    ap.add_argument("--n-seqs", type=int, default=6)
    ap.add_argument("--anc-len", type=int, default=120)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json-out", default=None)
    ap.add_argument(
        "--ancestors", choices=["generator", "reference"], default="generator",
        help="family ancestors: the synthetic generator (default) or real "
        "Rfam structures from the reference's example_data",
    )
    ap.add_argument("--anc-min-len", type=int, default=0,
                    help="reference-ancestor length filter (lower bound)")
    ap.add_argument("--anc-max-len", type=int, default=10**9,
                    help="reference-ancestor length filter (upper bound)")
    ap.add_argument("--max-pairs", type=int, default=None,
                    help="kNN pair cap passed to BOTH engines")
    ap.add_argument("--device", default=None,
                    help="Device of the embeddings and the MSA: the CUDA device "
                         "when not given, 'cpu' only when asked.")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    params = {"max_pairs": args.max_pairs} if args.max_pairs else {}
    ancestors = None
    if args.ancestors == "reference":
        ancestors = load_reference_ancestors(args.anc_min_len, args.anc_max_len,
                                             limit=args.families)
        if len(ancestors) < args.families:
            raise SystemExit(
                f"only {len(ancestors)} reference ancestors in "
                f"[{args.anc_min_len}, {args.anc_max_len}]"
            )
    results = []
    for f in range(args.families):
        if ancestors is not None:
            anc_id, struct, seq = ancestors[f]
            members = make_family_from_ancestor(args.seed + 1000 * f, struct, seq,
                                                n_seqs=args.n_seqs)
        else:
            members = make_family(args.seed + 1000 * f, n_seqs=args.n_seqs,
                                  anc_len=args.anc_len)
        wd = os.path.join(args.workdir, f"family{f}")
        res = compare_on_family(members, args.model_path, wd, params=params, device=device)
        if ancestors is not None:
            res["ancestor_id"] = anc_id
        res["posterior_stage"] = posterior_stage_quality(members, args.model_path, wd,
                                                         params=params, device=device)
        results.append(res)
        print(
            f"family {f}: repo SP-F1 {res['repo']['sp_f1']:.4f} "
            f"({res['repo']['wall_sec']}s) vs reference "
            f"{res['reference']['sp_f1']:.4f} ({res['reference']['wall_sec']}s)"
        )
    summary = {
        "repo_sp_f1_mean": float(np.mean([r["repo"]["sp_f1"] for r in results])),
        "reference_sp_f1_mean": float(np.mean([r["reference"]["sp_f1"] for r in results])),
        "families": results,
    }
    print(json.dumps({k: v for k, v in summary.items() if k != "families"}))
    if args.json_out:
        with open(args.json_out, "w") as fh:
            json.dump(summary, fh, indent=2)
    return summary


if __name__ == "__main__":
    main()
