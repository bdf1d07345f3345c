"""``ginfinity-align-node-embeddings`` — align two RNAs in embedding space.

Port of ``ginfinity_tpu/pipelines/align.py``: the same flags and
defaults (``--device`` picks the device of the DP: the card unless
``cpu`` is asked for) and the same output files.  The cosine similarity
of the two node-embedding matrices (optionally blended with base
embeddings by ``--seq-weight``) is computed in numpy float32 on the
host, exactly as the JAX package does, so both hand the DP the same
score bits; the global (NW) or local (SW) affine-gap DP runs in
``ops/dp.py`` (the CUDA kernel on the card).
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ginfinity_tpu_torch.ops.dp import affine_align
from ginfinity_tpu_torch.pipelines.node_embed import parse_matrix
from ginfinity_tpu_torch.utils.device import resolve_device
from ginfinity_tpu_torch.utils.io import read_table_auto


def cosine_similarity_matrix(A: np.ndarray, B: np.ndarray, eps: float = 1e-8) -> np.ndarray:
    if A.shape[1] != B.shape[1]:
        raise ValueError(f"Embedding dims mismatch: {A.shape[1]} vs {B.shape[1]}")
    A_n = A / (np.linalg.norm(A, axis=1, keepdims=True) + eps)
    B_n = B / (np.linalg.norm(B, axis=1, keepdims=True) + eps)
    return A_n @ B_n.T


def alignment_to_tsv(path, score_matrix, s1=None, s2=None) -> str:
    """Alignment path -> TSV text: step, i, j, the cell's score (``NaN``
    on a gap), and the two structure characters when given."""
    base_header = "step\ti_index\tj_index\tcell_score"
    lines = [base_header + "\tchar1\tchar2"] if (s1 is not None and s2 is not None) else [base_header]
    len1 = len(s1) if s1 is not None else 0
    len2 = len(s2) if s2 is not None else 0
    for k, (i, j) in enumerate(path):
        cell = "NaN"
        if i is not None and j is not None:
            cell = f"{score_matrix[i, j]:.6f}"
        part = f"{k}\t{'' if i is None else i}\t{'' if j is None else j}\t{cell}"
        if s1 is not None and s2 is not None:
            c1 = "-" if i is None else (s1[i] if i < len1 else "?")
            c2 = "-" if j is None else (s2[j] if j < len2 else "?")
            part += f"\t{c1}\t{c2}"
        lines.append(part)
    return "\n".join(lines)


def aligned_structures(path, s1: str, s2: str) -> tuple[str, str]:
    """The two structures along the path, ``-`` on a gap."""
    a1 = "".join("-" if i is None else (s1[i] if i < len(s1) else "?") for i, _ in path)
    a2 = "".join("-" if j is None else (s2[j] if j < len(s2) else "?") for _, j in path)
    return a1, a2


def save_matrix_tsv(matrix: np.ndarray, path: str):
    L1, L2 = matrix.shape
    with open(path, "w") as f:
        f.write("\t".join(["i/j"] + [str(j) for j in range(L2)]) + "\n")
        for i in range(L1):
            f.write("\t".join([str(i)] + [f"{matrix[i, j]:.6f}" for j in range(L2)]) + "\n")


def save_matrix_png(matrix: np.ndarray, path: str, title=None):
    try:
        import matplotlib

        matplotlib.use("Agg", force=True)
        import matplotlib.pyplot as plt
    except Exception as e:
        raise RuntimeError("matplotlib is required to write PNGs.") from e

    L1, L2 = matrix.shape
    size = lambda n: max(4.0, min(12.0, 0.08 * n))
    fig, ax = plt.subplots(figsize=(size(L2), size(L1)), dpi=200)
    im = ax.imshow(matrix, cmap="coolwarm", vmin=-1, vmax=1, aspect="auto",
                   interpolation="nearest", origin="upper")
    ax.set_xlabel("RNA2 node index")
    ax.set_ylabel("RNA1 node index")
    if title:
        ax.set_title(title)
    fig.colorbar(im, ax=ax, fraction=0.046, pad=0.04).set_label("cosine similarity")
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)


_OPEN, _CLOSE = "([{<", ")]}>"


def _struct_kind(ch: str) -> str:
    if ch == ".":
        return "unpaired"
    if ch in _OPEN:
        return "stem (opening)"
    if ch in _CLOSE:
        return "stem (closing)"
    return "other"


def _compat_kind(c1: str, c2: str) -> str:
    if c1 == "." and c2 == ".":
        return "both unpaired"
    if c1 in _OPEN and c2 in _OPEN:
        return "both stem opening"
    if c1 in _CLOSE and c2 in _CLOSE:
        return "both stem closing"
    if (c1 in _OPEN and c2 in _CLOSE) or (c1 in _CLOSE and c2 in _OPEN):
        return "complementary stems"
    if c1 == "." or c2 == ".":
        return "mixed (paired/unpaired)"
    return "other combination"


def save_matrix_html(matrix, path, title=None, s1=None, s2=None, rna1_id="RNA1", rna2_id="RNA2"):
    """Interactive HTML heatmap: each cell's hover shows the positions,
    the cosine similarity, each RNA's structure character and the
    structural-compatibility class; the first 50 structure characters
    label the axes.  Skipped with a warning when plotly is missing."""
    try:
        import plotly.graph_objects as go
        import plotly.offline as pyo
    except ImportError:
        print("[warn] plotly not available; skipping HTML heatmap.")
        return

    L1, L2 = matrix.shape
    frag1 = [
        f"<br>{rna1_id} structure: {s1[i]} ({_struct_kind(s1[i])})" if (s1 and i < len(s1)) else ""
        for i in range(L1)
    ]
    frag2 = [
        f"<br>{rna2_id} structure: {s2[j]} ({_struct_kind(s2[j])})" if (s2 and j < len(s2)) else ""
        for j in range(L2)
    ]
    hover_text = [
        [
            f"{rna1_id} position: {i}<br>{rna2_id} position: {j}"
            f"<br>Cosine similarity: {matrix[i, j]:.6f}"
            + frag1[i]
            + frag2[j]
            + (
                f"<br>Structural compatibility: {_compat_kind(s1[i], s2[j])}"
                if (s1 and s2 and i < len(s1) and j < len(s2))
                else ""
            )
            for j in range(L2)
        ]
        for i in range(L1)
    ]

    fig = go.Figure(data=go.Heatmap(
        z=matrix,
        hoverongaps=False,
        hovertemplate="%{hovertext}<extra></extra>",
        hovertext=hover_text,
        colorscale="RdBu_r",
        zmid=0,
        zmin=-1,
        zmax=1,
        colorbar=dict(title="Cosine Similarity"),
    ))
    fig.update_layout(
        title=title or f"Interactive Similarity Matrix: {rna1_id} vs {rna2_id}",
        xaxis_title=f"{rna2_id} Node Index",
        yaxis_title=f"{rna1_id} Node Index",
        xaxis=dict(side="bottom"),
        yaxis=dict(autorange="reversed"),
        width=max(600, min(1200, L2 * 15)),
        height=max(600, min(1200, L1 * 15)),
        font=dict(size=12),
    )
    annotations = []
    if s1:
        annotations += [
            dict(x=-0.02, y=i, xref="paper", yref="y", text=s1[i], showarrow=False,
                 font=dict(size=10, family="monospace"), xanchor="right")
            for i in range(min(len(s1), L1, 50))
        ]
    if s2:
        annotations += [
            dict(x=j, y=-0.02, xref="x", yref="paper", text=s2[j], showarrow=False,
                 font=dict(size=10, family="monospace"), yanchor="top")
            for j in range(min(len(s2), L2, 50))
        ]
    fig.update_layout(annotations=annotations)
    pyo.plot(fig, filename=path, auto_open=False)


def blend_similarity(sim_struct, base_table, args, rna_ids, struct_shapes):
    """Blend in the cosine similarity of base (sequence-model) embeddings
    by ``--seq-weight``, trimming BOS/EOS rows when they are there.
    Returns ``(sim, sim_base, used_base)``."""
    w = float(args.seq_weight)
    if args.base_embeds_col not in base_table.columns:
        print(f"[warn] Base embeddings column '{args.base_embeds_col}' not found; continuing with structural only.")
        return sim_struct, None, False
    br1 = [r for r in base_table.rows if r.get(args.id_column) == rna_ids[0]]
    br2 = [r for r in base_table.rows if r.get(args.id_column) == rna_ids[1]]
    if len(br1) != 1 or len(br2) != 1:
        print("[warn] Could not find unique base embeddings rows for both RNAs; skipping base weighting.")
        return sim_struct, None, False
    A_base = parse_matrix(br1[0][args.base_embeds_col])
    B_base = parse_matrix(br2[0][args.base_embeds_col])
    (l1, l2) = struct_shapes
    if A_base.shape[0] == l1 + 2 and B_base.shape[0] == l2 + 2:
        A_base, B_base = A_base[1:-1], B_base[1:-1]
        print("[info] Trimmed BOS/EOS from base embeddings to match structural length.")
    if A_base.shape[0] != l1 or B_base.shape[0] != l2:
        print("[warn] Length mismatch between base and structural embeddings; skipping base weighting.")
        return sim_struct, None, False
    sim_base = cosine_similarity_matrix(A_base, B_base)
    return (1.0 - w) * sim_struct + w * sim_base, sim_base, True


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Align two RNAs using node embeddings (affine-gap DP on the GPU)."
    )
    parser.add_argument("--input", required=True)
    parser.add_argument("--id-column", required=True)
    parser.add_argument("--rna1", required=True)
    parser.add_argument("--rna2", required=True)
    parser.add_argument("--base-input", default=None)
    parser.add_argument("--base-embeds-col", default="base_embeddings")
    parser.add_argument("--seq-weight", type=float, default=0.0)
    parser.add_argument("--gap-open", type=float, default=-1.0)
    parser.add_argument("--gap-extend", type=float, default=-1.0)
    parser.add_argument("--gap", type=float, default=None, help=argparse.SUPPRESS)
    parser.add_argument("--mode", choices=["global", "local"], default="global")
    parser.add_argument("--output-prefix", default=None)
    parser.add_argument("--plot-matrix", action="store_true")
    parser.add_argument("--structure-column-name", default=None)
    parser.add_argument("--save-components", action="store_true")
    parser.add_argument("--device", default=None,
                        help="Device of the DP: the CUDA device when not given, "
                             "'cpu' only when asked.")
    return parser


def _unique_row(table, id_column, rid):
    rows = [r for r in table.rows if r.get(id_column) == rid]
    if len(rows) == 0:
        raise ValueError(f"No row found where {id_column} == {rid}")
    if len(rows) > 1:
        raise ValueError(f"Multiple rows found for {id_column} == {rid}; expected exactly one.")
    return rows[0]


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    if not (0.0 <= float(args.seq_weight) <= 1.0):
        raise ValueError("--seq-weight must be in [0,1].")

    table = read_table_auto(args.input)
    if args.id_column not in table.columns:
        raise ValueError(f"Required column '{args.id_column}' not found in input.")
    if "node_embeddings" not in table.columns:
        raise ValueError("Input does not contain a 'node_embeddings' column.")
    row1 = _unique_row(table, args.id_column, args.rna1)
    row2 = _unique_row(table, args.id_column, args.rna2)

    A = parse_matrix(row1["node_embeddings"])
    B = parse_matrix(row2["node_embeddings"])
    sim_struct = cosine_similarity_matrix(A, B)
    sim = sim_struct
    sim_base = None
    used_base = False
    if args.seq_weight > 0.0:
        base_table = read_table_auto(args.base_input) if args.base_input else table
        sim, sim_base, used_base = blend_similarity(
            sim_struct, base_table, args, (args.rna1, args.rna2), (A.shape[0], B.shape[0])
        )

    if args.gap is not None:
        print("[align] --gap is deprecated; use --gap-open and --gap-extend. Treating --gap as --gap-open.")
        args.gap_open = args.gap
    if args.gap_extend is None:
        # never taken (--gap-extend defaults to -1.0, as in the reference):
        # a legacy --gap X gives affine (X, -1.0) there too
        args.gap_extend = args.gap_open

    best_score, path = affine_align(sim.astype(np.float32), args.gap_open, args.gap_extend,
                                    args.mode, device=device)

    if args.output_prefix is None:
        base = os.path.splitext(os.path.basename(args.input))[0]
        args.output_prefix = f"{base}__{args.rna1}__vs__{args.rna2}"
    matrix_out = args.output_prefix + ".matrix.tsv"
    align_out = args.output_prefix + ".alignment.tsv"
    struct_txt_out = args.output_prefix + ".structures.txt"
    os.makedirs(os.path.dirname(matrix_out) or ".", exist_ok=True)

    s1 = s2 = None
    if args.structure_column_name:
        if args.structure_column_name not in table.columns:
            raise ValueError(f"Structure column '{args.structure_column_name}' not found in input data.")
        s1 = str(row1[args.structure_column_name])
        s2 = str(row2[args.structure_column_name])

    save_matrix_tsv(sim, matrix_out)
    if args.plot_matrix:
        save_matrix_png(sim, args.output_prefix + ".matrix.png",
                        title=f"Cosine similarity (combined): {args.rna1} vs {args.rna2}")
        save_matrix_html(sim, args.output_prefix + ".matrix.html",
                         s1=s1, s2=s2, rna1_id=args.rna1, rna2_id=args.rna2)
    if used_base and args.save_components:
        save_matrix_tsv(sim_struct, args.output_prefix + ".matrix.struct.tsv")
        if sim_base is not None:
            save_matrix_tsv(sim_base, args.output_prefix + ".matrix.base.tsv")

    with open(align_out, "w") as f:
        f.write(f'# mode="{args.mode}"\n')
        f.write(f'# gap_open="{args.gap_open}"\n')
        f.write(f'# gap_extend="{args.gap_extend}"\n')
        f.write(f'# rna1="{args.rna1}", rna2="{args.rna2}"\n')
        f.write(f'# total_alignment_score="{best_score:.6f}"\n')
        if used_base:
            f.write(f'# seq_weight="{args.seq_weight}"\n')
        if s1 is not None and s2 is not None:
            f.write('# aligned_structures_present="true"\n')
        f.write(alignment_to_tsv(path, sim, s1, s2))

    if s1 is not None and s2 is not None:
        a1, a2 = aligned_structures(path, s1, s2)
        with open(struct_txt_out, "w") as f:
            f.write(f"{args.rna1}\t{a1}\n")
            f.write(f"{args.rna2}\t{a2}\n")

    print(f"Scoring matrix written to {matrix_out}")
    print(f"Alignment written to {align_out}")
    print(f"Total alignment score: {best_score:.6f}")


if __name__ == "__main__":
    main()
