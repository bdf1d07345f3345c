"""``ginfinity-compute-distances`` — squared Euclidean distances between
rows' embedding vectors.

Port of ``ginfinity_tpu/pipelines/distances.py``: the same flags and
defaults (``--device`` picks the device: the card unless ``cpu`` is
asked for), the same TSV: the kept columns suffixed ``_1`` and ``_2``,
then ``distance``, the **squared** distance as float32 text.  All pairs
(``--mode 1``) or one query against the other rows (``--mode 2``) are
computed on the device in batches of index pairs; ``--top-k`` keeps each
row's nearest neighbours instead, through :class:`TopKSearcher`.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ginfinity_tpu_torch.utils.device import disable_tf32, resolve_device
from ginfinity_tpu_torch.utils.io import read_table, write_tsv


def parse_embedding_column(cells) -> np.ndarray:
    """Comma-joined embedding strings to a float32 ``[n, D]`` matrix."""
    return np.stack([np.array(s.split(","), dtype=np.float32) for s in cells])


def pair_distances(emb: np.ndarray, idx1: np.ndarray, idx2: np.ndarray,
                   batch: int = 262144, device=None) -> np.ndarray:
    """``sum((emb[i1] - emb[i2])^2)`` in float32 for each index pair,
    ``batch`` pairs at a time on the device."""
    dev = resolve_device(device)
    n_pairs = idx1.shape[0]
    batch = min(batch, max(1, n_pairs))
    out = np.empty(n_pairs, np.float32)
    x = torch.from_numpy(np.ascontiguousarray(emb, np.float32)).to(dev)
    with torch.no_grad():
        for s in range(0, n_pairs, batch):
            i1 = torch.from_numpy(idx1[s: s + batch]).to(dev)
            i2 = torch.from_numpy(idx2[s: s + batch]).to(dev)
            d = x[i1] - x[i2]
            out[s: s + batch] = (d * d).sum(dim=1).cpu().numpy()
    return out


def all_pairs_indices(n: int) -> tuple[np.ndarray, np.ndarray]:
    """Upper-triangular (i < j) index pairs, in combinations() order."""
    iu = np.triu_indices(n, k=1)
    return iu[0].astype(np.int64), iu[1].astype(np.int64)


def top_k_pairs(emb: np.ndarray, queries: np.ndarray, remap, top_k: int, device=None):
    """Each query row's ``top_k`` nearest rows (``remap`` maps the searched
    rows to table rows, ``None`` when every row is searched, where the
    self match is skipped): ``(idx1, idx2, distances)``."""
    from ginfinity_tpu_torch.parallel.search import TopKSearcher

    corpus = emb if remap is None else emb[remap]
    k = min(top_k + 1, len(corpus)) if remap is None else min(top_k, len(corpus))
    d, ids = TopKSearcher(corpus, metric="sqeuclidean", device=device).search(emb[queries], k)
    l1, l2, dist = [], [], []
    for r, qi in enumerate(queries):
        kept = 0
        for dv, ci in zip(d[r], ids[r]):
            ci = int(ci) if remap is None else int(remap[int(ci)])
            if ci == qi:
                continue
            l1.append(int(qi))
            l2.append(ci)
            dist.append(dv)
            kept += 1
            if kept == top_k:
                break
    return np.asarray(l1, np.int64), np.asarray(l2, np.int64), np.asarray(dist, np.float32)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Compute squared Euclidean distances between rows' embedding vectors "
                    "(PyTorch/CUDA)."
    )
    parser.add_argument("--input", required=True)
    parser.add_argument("--output", required=True)
    parser.add_argument("--embedding-col", default="embedding_vector")
    parser.add_argument("--keep-cols", default=None)
    parser.add_argument("--num-workers", type=int, default=1,
                        help="Reference CLI compatibility (compute is on the device).")
    parser.add_argument("--device", default=None,
                        help="Device to run on: the CUDA device when not given, "
                             "'cpu' only when asked.")
    parser.add_argument("--batch-size", type=int, default=262144,
                        help="Pairs per device batch.")
    parser.add_argument("--mode", type=int, default=1, choices=[1, 2])
    parser.add_argument("--id-column", default="exon_id")
    parser.add_argument("--query")
    parser.add_argument("--top-k", type=int, default=None,
                        help="Emit only each row's K nearest neighbours (exact top-k "
                             "search) instead of every pair.")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        disable_tf32()
    if not args.keep_cols:
        args.keep_cols = args.id_column

    table = read_table(args.input, sep="\t")
    columns_to_keep = [c.strip() for c in args.keep_cols.split(",")]
    missing = [c for c in columns_to_keep if c not in table.columns]
    if missing:
        raise ValueError(f"Missing columns in input: {', '.join(missing)}")

    emb = parse_embedding_column(table.column(args.embedding_col))

    n = len(table.rows)
    if args.mode == 2:
        if not args.query:
            raise ValueError("--query must be provided when --mode=2.")
        # a typed cell as ``Series.astype(str)`` gives it; a missing cell
        # stays missing and matches no query
        mask_q = np.array([v is not None and str(v) == str(args.query)
                           for v in table.column(args.id_column)], bool)
        idx_q = np.nonzero(mask_q)[0]
        if idx_q.size == 0:
            raise ValueError(f"No rows where {args.id_column} == {args.query}")
        idx_o = np.nonzero(~mask_q)[0]

    if args.top_k is not None:
        if args.top_k < 1:
            raise ValueError("--top-k must be >= 1.")
        if args.mode == 1:
            idx1, idx2, distances = top_k_pairs(emb, np.arange(n), None, args.top_k, device)
        else:
            if idx_o.size == 0:
                raise ValueError("No non-query rows to search against.")
            idx1, idx2, distances = top_k_pairs(emb, idx_q, idx_o, args.top_k, device)
    else:
        if args.mode == 1:
            idx1, idx2 = all_pairs_indices(n)
        else:
            idx1 = np.repeat(idx_q, idx_o.size)
            idx2 = np.tile(idx_o, idx_q.size)
        distances = pair_distances(emb, idx1, idx2, batch=args.batch_size, device=device)

    rows = table.rows
    header = ([f"{c}_1" for c in columns_to_keep] + [f"{c}_2" for c in columns_to_keep]
              + ["distance"])
    write_tsv(args.output, header, (
        [rows[a][c] for c in columns_to_keep] + [rows[b][c] for c in columns_to_keep] + [d]
        for a, b, d in zip(idx1.tolist(), idx2.tolist(), distances)
    ), na_rep="")
    print(f"Finished processing {len(idx1)} pairs. Output written to {args.output}")


if __name__ == "__main__":
    main()
