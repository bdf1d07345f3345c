"""``ginfinity-generate-windows`` — sliding-window subgraphs.

Port of ``ginfinity_tpu/pipelines/windows.py`` (numpy and the standard
library; the ``.pt`` archive through torch).  Window semantics:

- windows of length L at every start offset;
- ``--keep-paired-neighbors`` pulls out-of-window pairing partners in as
  isolated nodes whose backbone ('adjacent') edges are cut;
- node features come from the *full* structure (loop metadata and paired
  flags are computed before slicing);
- low-complexity mask: a window whose fraction of '(' and ')' characters
  is below ``--mask-threshold`` is skipped;
- the adjacent-base-pair quirk: a pair (i, i+1) is an 'adjacent' edge in
  the reference graph, so such partners are not pulled in and such edges
  are cut with the backbone.

Storage: ``windows_graphs.npz`` (packed columnar arrays), or the
reference's ``windows_graphs.pt`` (a dict of PyG ``Data`` objects), and
``windows_metadata.tsv``.  The CLI builds graphs on the host and needs no
device:

    python -m ginfinity_tpu_torch.pipelines.windows --input in.csv \\
        --id-column id --L 120 --keep-paired-neighbors --output-dir out
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ginfinity_tpu_torch.graphs.build import (
    FORGI_NODE_TYPES,
    GraphArrays,
    _directed_both_ways,
    standard_node_features,
)
from ginfinity_tpu_torch.graphs.dotbracket import pair_table
from ginfinity_tpu_torch.utils.io import (
    Table,
    log_information,
    read_table,
    setup_and_read_input,
    write_tsv,
)


def window_starts_mask(structure: str, L: int, mask_threshold: float) -> np.ndarray:
    """Low-complexity filter: ``keep[start]`` is True when the window's
    fraction of '(' and ')' characters reaches ``mask_threshold``."""
    n = len(structure)
    n_windows = n - L + 1
    if n_windows <= 0:
        return np.zeros(0, dtype=bool)
    if mask_threshold <= 0:
        return np.ones(n_windows, dtype=bool)
    codes = np.frombuffer(structure.encode("latin-1"), dtype=np.uint8)
    paired = ((codes == ord("(")) | (codes == ord(")"))).astype(np.int32)
    csum = np.concatenate(([0], np.cumsum(paired)))
    counts = csum[L:] - csum[:-L]
    return (counts / L) >= mask_threshold


def slice_window(
    pt: np.ndarray,
    full_feat: np.ndarray,
    start: int,
    L: int,
    keep_paired_neighbors: bool = True,
) -> GraphArrays:
    """One window subgraph as flat arrays: the window's positions and,
    with ``keep_paired_neighbors``, their outside partners, in position
    order; backbone edges inside the window, then base-pair edges whose
    ends are both kept, each both ways."""
    n = pt.shape[0]
    idx = np.arange(n, dtype=np.int32)
    in_win = np.zeros(n, dtype=bool)
    in_win[start: start + L] = True
    partner = np.clip(pt, 0, n - 1)
    bp_real = (pt >= 0) & (np.abs(pt - idx) != 1)

    if keep_paired_neighbors:
        pulled = idx[in_win & bp_real & ~in_win[partner]]
        outside = np.unique(pt[pulled])
        nodes = np.sort(np.concatenate([idx[in_win], outside.astype(np.int32)]))
    else:
        nodes = idx[in_win]

    keep = np.zeros(n, dtype=bool)
    keep[nodes] = True
    local = np.full(n, -1, dtype=np.int32)
    local[nodes] = np.arange(nodes.shape[0], dtype=np.int32)

    bb_i = idx[(idx >= start + 1) & (idx < start + L)]
    bp_i = idx[bp_real & (idx < pt) & keep & keep[partner]]
    src = np.concatenate([local[bb_i], local[bp_i]])
    dst = np.concatenate([local[bb_i - 1], local[pt[bp_i]]])
    attr2 = np.zeros((src.shape[0], 2), np.float32)
    attr2[: bb_i.shape[0], 0] = 1.0
    attr2[bb_i.shape[0]:, 1] = 1.0
    s, d, attr = _directed_both_ways(src, dst, attr2)
    return GraphArrays(
        node_feat=full_feat[nodes],
        edge_src=s.astype(np.int32),
        edge_dst=d.astype(np.int32),
        edge_attr=attr,
        n_nodes=int(nodes.shape[0]),
        n_base_nodes=int(nodes.shape[0]),
    )


def structure_to_windows(
    structure: str,
    L: int,
    keep_paired_neighbors: bool = True,
    mask_threshold: float = 0.0,
    seq_weight: float = 0.0,
    sequence: str | None = None,
) -> list[tuple[int, GraphArrays]]:
    """``(start, window graph)`` of every kept window; none for an
    invalid structure or one shorter than ``L``."""
    pt = pair_table(structure, strict=False)
    if pt is None or pt.shape[0] < L:
        return []
    full_feat = standard_node_features(pt, sequence, seq_weight)
    keep = window_starts_mask(structure, L, mask_threshold)
    return [
        (start, slice_window(pt, full_feat, start, L, keep_paired_neighbors))
        for start in np.nonzero(keep)[0]
    ]


def save_windows_graphs(path: str, graph_map: dict[str, GraphArrays]):
    """Packed columnar ``.npz``: every graph's arrays concatenated into one
    member per field, with node and edge offset tables."""
    wids = list(graph_map.keys())
    if not wids:
        np.savez_compressed(path, manifest=np.array([], dtype=str))
        return
    graphs = list(graph_map.values())
    node_offsets = np.zeros(len(graphs) + 1, np.int64)
    edge_offsets = np.zeros(len(graphs) + 1, np.int64)
    np.cumsum([g.node_feat.shape[0] for g in graphs], out=node_offsets[1:])
    np.cumsum([g.edge_src.shape[0] for g in graphs], out=edge_offsets[1:])
    np.savez_compressed(
        path,
        manifest=np.array(wids),
        node_offsets=node_offsets,
        edge_offsets=edge_offsets,
        node_feat=np.concatenate([g.node_feat for g in graphs]),
        edge_src=np.concatenate([g.edge_src for g in graphs]),
        edge_dst=np.concatenate([g.edge_dst for g in graphs]),
        edge_attr=np.concatenate([g.edge_attr for g in graphs]),
        nb=np.array([[g.n_nodes, g.n_base_nodes] for g in graphs], np.int32),
    )


def save_windows_graphs_pt(path: str, graph_map: dict[str, GraphArrays]):
    """The reference's archive: a dict of PyG ``Data`` objects written with
    ``torch.save``, each with ``base_node_mask``, ``num_base_nodes`` and
    ``graph_encoding``."""
    import torch

    from ginfinity_tpu_torch.graphs.pyg_compat import ensure_pyg

    tgd = ensure_pyg()
    out = {}
    for wid, g in graph_map.items():
        data = tgd.Data(
            x=torch.from_numpy(np.ascontiguousarray(g.node_feat, np.float32)),
            edge_index=torch.from_numpy(
                np.stack([g.edge_src, g.edge_dst]).astype(np.int64)),
            edge_attr=torch.from_numpy(np.ascontiguousarray(g.edge_attr, np.float32)),
        )
        base_mask = torch.zeros(g.n_nodes, dtype=torch.bool)
        base_mask[: g.n_base_nodes] = True
        data.base_node_mask = base_mask
        data.num_base_nodes = int(g.n_base_nodes)
        data.graph_encoding = "standard"
        out[wid] = data
    torch.save(out, path)


def load_windows_graphs(path: str) -> dict[str, GraphArrays]:
    """Window graphs by window id, from a ``.pt`` archive or an ``.npz``
    (packed columnar, or the older one-member-per-graph layout)."""
    if path.endswith(".pt"):
        return _load_torch_windows(path)
    out: dict[str, GraphArrays] = {}
    with np.load(path) as z:
        wids = [str(w) for w in z["manifest"]]
        if not wids:
            return out
        if "node_offsets" in z.files:
            no, eo, nb = z["node_offsets"], z["edge_offsets"], z["nb"]
            feat, src, dst, attr = (z[k] for k in ("node_feat", "edge_src", "edge_dst",
                                                   "edge_attr"))
            for k, wid in enumerate(wids):
                ns, ne, es, ee = no[k], no[k + 1], eo[k], eo[k + 1]
                out[wid] = GraphArrays(feat[ns:ne], src[es:ee], dst[es:ee], attr[es:ee],
                                       int(nb[k, 0]), int(nb[k, 1]))
            return out
        for k, wid in enumerate(wids):
            nbk = z[f"g{k}_nb"]
            out[wid] = GraphArrays(z[f"g{k}_feat"], z[f"g{k}_src"], z[f"g{k}_dst"],
                                   z[f"g{k}_attr"], int(nbk[0]), int(nbk[1]))
    return out


def _base_mask_from_data(data, x: np.ndarray) -> np.ndarray:
    """Boolean base-node mask of a foreign ``Data``: its ``base_node_mask``
    when it has one of the right length, else a ``num_base_nodes``
    prefix, else the forgi layout's ``is_base`` column (just before the
    7-way element type), else all nodes."""
    n = x.shape[0]
    mask = getattr(data, "base_node_mask", None)
    if mask is not None:
        m = np.asarray(mask).reshape(-1).astype(bool)
        if m.size == n:
            return m
    nb = getattr(data, "num_base_nodes", None)
    if nb is not None:
        m = np.zeros(n, bool)
        m[: min(int(nb), n)] = True
        return m
    if x.ndim == 2 and x.shape[1] >= 9 + len(FORGI_NODE_TYPES):
        return x[:, x.shape[1] - len(FORGI_NODE_TYPES) - 1] > 0.5
    return np.ones(n, bool)


def _load_torch_windows(path: str) -> dict[str, GraphArrays]:
    """Read a ``windows_graphs.pt``; each ``Data`` is read by attribute,
    whichever package's classes unpickled it.  Base nodes become a
    prefix: a mask that is not one is met by a stable base-first
    permutation of the nodes, edges remapped."""
    import torch

    from ginfinity_tpu_torch.graphs.pyg_compat import ensure_pyg

    ensure_pyg()
    # the archive holds pickled objects, not only tensors
    raw = torch.load(path, weights_only=False)
    out = {}
    for wid, data in raw.items():
        x = data.x.numpy().astype(np.float32)
        ei = data.edge_index.numpy().astype(np.int32)
        ea = data.edge_attr.numpy().astype(np.float32)
        m = _base_mask_from_data(data, x)
        nb = int(m.sum())
        src, dst = ei[0], ei[1]
        if nb < x.shape[0] and not m[:nb].all():
            order = np.argsort(~m, kind="stable")
            inv = np.empty_like(order)
            inv[order] = np.arange(order.size, dtype=order.dtype)
            x = x[order]
            src = inv[src].astype(np.int32)
            dst = inv[dst].astype(np.int32)
        out[wid] = GraphArrays(x, src, dst, ea, x.shape[0], nb)
    return out


def load_precomputed(graph_pt: str, meta_tsv: str) -> tuple[Table, list[GraphArrays]]:
    """A window corpus for ``--graph-pt``: its metadata table and the
    graph of each metadata row, in row order."""
    graph_map = load_windows_graphs(graph_pt)
    meta = read_table(meta_tsv, sep="\t")
    return meta, [graph_map[r["window_id"]] for r in meta.rows]


def write_precomputed(path: str, meta: Table, id_column: str, column: str, cells) -> None:
    """Each metadata row with ``column`` added: ``window_id``, the id
    column and the window bounds first, then ``column``, then the other
    metadata columns in file order."""
    cols = [c for c in ("window_id", id_column, "window_start", "window_end")
            if c in meta.columns]
    cols.append(column)
    rows = [{**r, column: cell} for r, cell in zip(meta.rows, cells)]
    write_tsv(path, cols + [c for c in meta.columns if c not in cols], rows)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Generate windowed subgraphs from RNA structures (PyTorch port)."
    )
    parser.add_argument("--input", type=str, required=True)
    parser.add_argument("--output-dir", type=str, default="windows_output")
    parser.add_argument("--id-column", type=str, required=True)
    parser.add_argument("--structure-column-name", type=str, default="secondary_structure")
    parser.add_argument("--L", type=int, required=True)
    parser.add_argument("--keep-paired-neighbors", action="store_true")
    parser.add_argument("--mask-threshold", type=float, default=0.0)
    parser.add_argument("--keep-cols", type=str, default=None)
    parser.add_argument("--num-workers", type=int, default=1,
                        help="Reference CLI compatibility (slicing is vectorized).")
    parser.add_argument("--format", choices=["npz", "pt", "both"], default="npz",
                        help="Archive format: 'npz' (packed columnar, fast load), 'pt' "
                             "(reference windows_graphs.pt), or 'both'.")
    parser.add_argument("--quiet", action="store_true")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    os.makedirs(args.output_dir, exist_ok=True)
    graphs_npz = os.path.join(args.output_dir, "windows_graphs.npz")
    graphs_pt = os.path.join(args.output_dir, "windows_graphs.pt")
    meta_tsv = os.path.join(args.output_dir, "windows_metadata.tsv")
    args.output = meta_tsv  # the run log goes beside the metadata
    table, log_path, propagate = setup_and_read_input(args, need_model=False)

    graph_map: dict[str, GraphArrays] = {}
    meta_rows = []
    for row in table.rows:
        rid, struct = row[args.id_column], row[args.structure_column_name]
        if not isinstance(struct, str):
            if not args.quiet:
                print(f"Skipping {rid}: not a string")
            log_information(log_path, {"skipped_not_a_string": f"ID {rid}"})
            continue
        if pair_table(struct, strict=False) is None:
            if not args.quiet:
                print(f"Skipping {rid}: invalid dot-bracket")
            log_information(log_path, {"skipped_invalid_dot_bracket": f"ID {rid}"})
            continue
        other = {c: row[c] for c in propagate if c in row}
        for start, g in structure_to_windows(struct, args.L, args.keep_paired_neighbors,
                                             args.mask_threshold):
            if int(g.edge_src.max(initial=-1)) >= g.n_nodes:
                raise RuntimeError(f"Bad window at {rid}_{start}")
            wid = f"{rid}_{start}"
            graph_map[wid] = g
            meta_rows.append({"window_id": wid, args.id_column: rid,
                              "window_start": int(start),
                              "window_end": int(start) + args.L - 1,
                              "seq_len": len(struct), **other})

    saved = {}
    if args.format in ("npz", "both"):
        save_windows_graphs(graphs_npz, graph_map)
        saved["graphs"] = graphs_npz
    if args.format in ("pt", "both"):
        save_windows_graphs_pt(graphs_pt, graph_map)
        saved["graphs_pt"] = graphs_pt
    columns = ["window_id", args.id_column, "window_start", "window_end", "seq_len"]
    for r in meta_rows[:1]:
        columns += [c for c in r if c not in columns]
    write_tsv(meta_tsv, columns, meta_rows)
    if not args.quiet:
        for p in saved.values():
            print(f"Saved {len(graph_map)} graphs to {p}")
        print(f"Saved metadata to {meta_tsv}")
    log_information(log_path, {**saved, "metadata": meta_tsv, "n_windows": len(meta_rows)},
                    "Summary")


if __name__ == "__main__":
    main()
