"""Host-side training datasets and fixed-shape batch assembly.

Port of ``ginfinity_tpu/training/data.py``, host numpy throughout: given
the same ``np.random.Generator`` it draws in the same order and builds
the same batches, byte for byte, as the JAX package.  Datasets read a
:class:`~ginfinity_tpu_torch.utils.io.Table` (rows as dicts) where the
JAX package reads a DataFrame.

- Triplet rows -> TripletBatch (anchor/positive/negative GraphBatches
  sharing one padded graph capacity + a real-triplet mask).
- Pair rows    -> PairBatch (targets = ``f_total_modifications``).
- Alignment groups -> AlignmentBatch: all group structures packed into
  one GraphBatch, plus the gathered node subset with the reference's
  label scheme: conserved label = ``alignment_offset * 10^6 +
  align_pos``; sampled unaligned negatives = ``-((graph_idx + 1) * 10^6)
  - k``.

The dynamic parts (pair mining, negative sampling) happen here on the
host with a seeded generator, so the loss sees static shapes.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterator

import numpy as np
import torch

from ginfinity_tpu_torch.graphs.batching import GraphBatch, _round_capacity, batch_graphs
from ginfinity_tpu_torch.graphs.build import GraphArrays, build_graph_arrays
from ginfinity_tpu_torch.graphs.dotbracket import pair_table
from ginfinity_tpu_torch.training.train import AlignmentBatch, PairBatch, TripletBatch
from ginfinity_tpu_torch.utils import trace
from ginfinity_tpu_torch.utils.io import Table

CATEGORY_TO_ID = {
    "5-paired": 0,
    "3-paired": 1,
    "unpaired": 2,
    "unaligned-5-paired": 3,
    "unaligned-3-paired": 4,
    "unaligned-unpaired": 5,
}
LABEL_STRIDE = 10**6


def _valid(s) -> bool:
    return isinstance(s, str) and pair_table(s, strict=False) is not None


def remove_invalid_structures(table: Table, columns) -> Table:
    """The rows whose every named column is a valid dot-bracket string."""
    for c in columns:
        if c not in table.columns:
            raise KeyError(c)
    rows = [r for r in table.rows if all(_valid(r.get(c)) for c in columns)]
    return Table(list(table.columns), rows)


def _build(row: dict, struct_col, seq_col, graph_encoding, seq_weight) -> GraphArrays:
    seq = row.get(seq_col)
    if not isinstance(seq, str):
        seq = None
    return build_graph_arrays(
        row[struct_col], seq, seq_weight=seq_weight, graph_encoding=graph_encoding
    )


def group_rows(rows: list[dict], key: str) -> list[tuple[Any, list[dict]]]:
    """``(key, rows)`` per value of ``key`` in order of first appearance,
    rows without a value (missing) left out: ``DataFrame.groupby(key,
    sort=False)``."""
    groups: dict[Any, list[dict]] = {}
    for r in rows:
        k = r.get(key)
        if k is None:
            continue
        groups.setdefault(k, []).append(r)
    return list(groups.items())


# --------------------------------------------------------------------------
# Triplet / pair datasets
# --------------------------------------------------------------------------


class TripletDataset:
    COLS = ("anchor_structure", "positive_structure", "negative_structure")
    SEQ_COLS = ("anchor_seq", "positive_seq", "negative_seq")

    def __init__(self, table: Table, graph_encoding="standard", seq_weight=0.0):
        self.items = [
            tuple(_build(r, c, sc, graph_encoding, seq_weight)
                  for c, sc in zip(self.COLS, self.SEQ_COLS))
            for r in table.rows
        ]

    def __len__(self):
        return len(self.items)


class PairDataset:
    def __init__(self, table: Table, graph_encoding="standard", seq_weight=0.0):
        self.items = []
        self.targets = []
        for r in table.rows:
            self.items.append((
                _build(r, "anchor_structure", "anchor_seq", graph_encoding, seq_weight),
                _build(r, "positive_structure", "positive_seq", graph_encoding, seq_weight),
            ))
            self.targets.append(float(r["f_total_modifications"]))

    def __len__(self):
        return len(self.items)


def _pack_group(graphs: list[GraphArrays], graph_cap: int,
                caps: tuple[int, int] | None = None) -> GraphBatch:
    total_nodes = sum(g.n_nodes for g in graphs)
    total_edges = sum(g.n_edges for g in graphs)
    n_cap = caps[0] if caps else _round_capacity(total_nodes)
    e_cap = caps[1] if caps else _round_capacity(total_edges)
    return batch_graphs(graphs, n_cap, e_cap, graph_cap)


def _triplet_batch(dataset: TripletDataset, idxs, g_cap: int,
                   caps: tuple[int, int] | None) -> TripletBatch:
    anchors = [dataset.items[i][0] for i in idxs]
    pos = [dataset.items[i][1] for i in idxs]
    neg = [dataset.items[i][2] for i in idxs]
    mask = np.zeros(g_cap, np.float32)
    mask[: len(idxs)] = 1.0
    return TripletBatch(
        anchor=_pack_group(anchors, g_cap, caps),
        positive=_pack_group(pos, g_cap, caps),
        negative=_pack_group(neg, g_cap, caps),
        mask=torch.from_numpy(mask),
    )


def _pair_batch(dataset: PairDataset, idxs, g_cap: int,
                caps: tuple[int, int] | None) -> PairBatch:
    anchors = [dataset.items[i][0] for i in idxs]
    pos = [dataset.items[i][1] for i in idxs]
    target = np.zeros(g_cap, np.float32)
    target[: len(idxs)] = [dataset.targets[i] for i in idxs]
    mask = np.zeros(g_cap, np.float32)
    mask[: len(idxs)] = 1.0
    return PairBatch(
        anchor=_pack_group(anchors, g_cap, caps),
        positive=_pack_group(pos, g_cap, caps),
        target=torch.from_numpy(target),
        mask=torch.from_numpy(mask),
    )


def iter_triplet_batches(
    dataset: TripletDataset, batch_size: int, rng: np.random.Generator | None = None,
    caps: tuple[int, int] | None = None,
) -> Iterator[TripletBatch]:
    order = np.arange(len(dataset))
    if rng is not None:
        rng.shuffle(order)
    g_cap = _round_capacity(batch_size)
    for s in range(0, len(order), batch_size):
        yield _triplet_batch(dataset, order[s : s + batch_size], g_cap, caps)


def iter_pair_batches(
    dataset: PairDataset, batch_size: int, rng: np.random.Generator | None = None,
    caps: tuple[int, int] | None = None,
) -> Iterator[PairBatch]:
    order = np.arange(len(dataset))
    if rng is not None:
        rng.shuffle(order)
    g_cap = _round_capacity(batch_size)
    for s in range(0, len(order), batch_size):
        yield _pair_batch(dataset, order[s : s + batch_size], g_cap, caps)


# --------------------------------------------------------------------------
# Length-bucketed data-parallel batch plans
#
# A data-parallel stack needs its n_dev batches to share one padded
# shape.  Items are shuffled, stably sorted by their capacity-ladder
# bucket (similar sizes land in one stack, order within a bucket stays
# random), and each stack of n_dev batches gets ladder caps from its own
# maxima.  Remainder batches (< n_dev) are yielded unstacked for a
# single-device step; nothing is dropped.  The training CLI's
# --data-parallel runs each stack's batch s on the mesh's device s
# (training/train.py, make_train_step(mesh=)).
# --------------------------------------------------------------------------


def bucketed_batch_plan(
    sizes, batch_size: int, n_dev: int, rng: np.random.Generator | None
):
    """Returns (stacks, leftovers): stacks = list of n_dev-long lists of
    index arrays; leftovers = list of index arrays."""
    n = len(sizes)
    order = np.arange(n)
    if rng is not None:
        rng.shuffle(order)
    buckets = np.array([_round_capacity(max(1, int(sizes[i]))) for i in order])
    order = order[np.argsort(buckets, kind="stable")]
    batches = [order[s : s + batch_size] for s in range(0, n, batch_size)]
    n_full = (len(batches) // n_dev) * n_dev
    stacks = [batches[s : s + n_dev] for s in range(0, n_full, n_dev)]
    leftovers = batches[n_full:]
    if rng is not None and stacks:
        perm = rng.permutation(len(stacks))
        stacks = [stacks[i] for i in perm]
    return stacks, leftovers


def _stack(batches):
    """Batches of one shape stacked leaf by leaf on a new leading axis
    (static fields, such as ``num_graphs``, from the first)."""
    first = batches[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(batches)
    return dataclasses.replace(first, **{
        f.name: _stack([getattr(b, f.name) for b in batches])
        for f in dataclasses.fields(first)
        if isinstance(getattr(first, f.name), torch.Tensor)
        or dataclasses.is_dataclass(getattr(first, f.name))
    })


def _unstack(batch, s: int):
    """Batch ``s`` of a stack made by :func:`_stack`."""
    if isinstance(batch, torch.Tensor):
        return batch[s]
    return dataclasses.replace(batch, **{
        f.name: _unstack(getattr(batch, f.name), s)
        for f in dataclasses.fields(batch)
        if isinstance(getattr(batch, f.name), torch.Tensor)
        or dataclasses.is_dataclass(getattr(batch, f.name))
    })


def iter_graph_pair_batches_dp(
    dataset, batch_size: int, n_dev: int, rng: np.random.Generator | None,
    build,
) -> Iterator[tuple[Any, bool]]:
    """Shared triplet/pair DP iterator: yields (batch, stacked) where
    stacked batches carry a leading n_dev axis and per-stack ladder caps."""
    sizes = [sum(g.n_nodes for g in t) for t in dataset.items]
    g_cap = _round_capacity(batch_size)
    stacks, leftovers = bucketed_batch_plan(sizes, batch_size, n_dev, rng)
    n_pos = len(dataset.items[0]) if dataset.items else 1
    for stack in stacks:
        # caps apply to ONE tuple position's _pack_group (anchor OR
        # positive OR negative), so they are sized per position
        worst_n = max(
            sum(dataset.items[i][p].n_nodes for i in idxs)
            for idxs in stack for p in range(n_pos)
        )
        worst_e = max(
            sum(dataset.items[i][p].n_edges for i in idxs)
            for idxs in stack for p in range(n_pos)
        )
        caps = (_round_capacity(worst_n), _round_capacity(worst_e))
        yield _stack([build(dataset, idxs, g_cap, caps) for idxs in stack]), True
    for idxs in leftovers:
        yield build(dataset, idxs, g_cap, None), False


def iter_alignment_batches_dp(
    dataset: "AlignmentDataset",
    batch_size: int,
    max_unaligned_per_graph: int,
    n_dev: int,
    rng: np.random.Generator | None = None,
    max_negatives: int | None = None,
    hard_negative_fraction: float = 0.85,
    debug_log=None,
) -> Iterator[tuple[AlignmentBatch, bool]]:
    """Length-bucketed DP iterator over alignment groups."""
    per_group = []
    for _, sts in dataset.groups:
        nodes = sum(s.graph.n_nodes for s in sts)
        edges = sum(s.graph.n_edges for s in sts)
        subset = sum(
            len(s.mapping) + min(max_unaligned_per_graph, len(s.unaligned)) for s in sts
        )
        mapped = sum(len(s.mapping) for s in sts)
        per_group.append((nodes, edges, len(sts), subset, mapped))
    sizes = [t[0] for t in per_group]
    stacks, leftovers = bucketed_batch_plan(sizes, batch_size, n_dev, rng)

    def assemble(idxs, caps, g_cap, m_cap):
        return assemble_alignment_batch(
            [dataset.groups[i] for i in idxs],
            max_unaligned_per_graph,
            rng,
            subset_capacity=m_cap,
            caps=caps,
            graph_capacity=g_cap,
            max_negatives=max_negatives,
            hard_negative_fraction=hard_negative_fraction,
            debug_log=debug_log,
        )

    for stack in stacks:
        worst = [
            max(sum(per_group[i][d] for i in idxs) for idxs in stack)
            for d in range(5)
        ]
        caps = (_round_capacity(worst[0]), _round_capacity(worst[1]))
        g_cap = _round_capacity(worst[2])
        # with negative subsampling the kept subset is bounded by the
        # aligned (participant) nodes + max_negatives
        m_bound = worst[3]
        if max_negatives is not None:
            m_bound = min(m_bound, worst[4] + max(0, int(max_negatives)))
        m_cap = _round_capacity(m_bound)
        built = [assemble(idxs, caps, g_cap, m_cap) for idxs in stack]
        if any(b is None for b in built):
            # rare: a batch with no usable nodes breaks the stack; the
            # valid ones run single-device instead
            for b in built:
                if b is not None:
                    yield b, False
            continue
        yield _stack(built), True
    for idxs in leftovers:
        b = assemble(idxs, None, None, None)
        if b is not None:
            yield b, False


# --------------------------------------------------------------------------
# Alignment dataset
# --------------------------------------------------------------------------


@dataclasses.dataclass
class AlignedStructure:
    graph: GraphArrays
    mapping: dict[int, int]  # align_pos -> struct_pos (0-based)
    categories: dict[int, int]  # struct_pos -> category id
    unaligned: list[int]


def _is_old_format(rna_data: dict) -> bool:
    return not any(k in CATEGORY_TO_ID for k in rna_data)


def resolve_alignment_mapping(alignment_entry: dict, sequence_id) -> tuple[dict, dict, list]:
    """Parse both alignment-map JSON formats: the old one (align_pos ->
    1-based struct_pos) and the categorised one (category -> 1-based
    struct_pos -> align_pos)."""
    mapping: dict[int, int] = {}
    categories: dict[int, int] = {}
    unaligned: list[int] = []

    rna_data = None
    if sequence_id is not None:
        for key in (str(sequence_id), f"rna_{sequence_id}", f"seq_{sequence_id}"):
            if key in alignment_entry:
                rna_data = alignment_entry[key]
                break
    if rna_data is None:
        return mapping, categories, unaligned

    if _is_old_format(rna_data):
        for align_pos_str, struct_pos in rna_data.items():
            try:
                ap = int(align_pos_str)
                sp = int(struct_pos) - 1
            except (TypeError, ValueError):
                continue
            if sp >= 0:
                mapping[ap] = sp
                categories[sp] = 2
    else:
        for category_name, positions in rna_data.items():
            cid = CATEGORY_TO_ID.get(category_name)
            if cid is None:
                continue
            conserved = cid < 3
            for struct_pos_str, align_pos in positions.items():
                try:
                    sp = int(struct_pos_str) - 1
                    ap = int(align_pos)
                except (TypeError, ValueError):
                    continue
                if sp >= 0:
                    categories[sp] = cid
                    if conserved:
                        mapping[ap] = sp
                    else:
                        unaligned.append(sp)
    return mapping, categories, sorted(unaligned)


class AlignmentDataset:
    """Groups rows by alignment_id; precomputes graphs + annotations."""

    def __init__(
        self,
        table: Table,
        alignment_map: dict,
        graph_encoding="standard",
        seq_weight=0.0,
        structure_column="structure",
    ):
        self.groups: list[tuple[Any, list[AlignedStructure]]] = []
        for alignment_id, rows in group_rows(table.rows, "alignment_id"):
            structures = []
            for r in rows:
                graph = _build(r, structure_column, "sequence", graph_encoding, seq_weight)
                seq_id = r.get("sequence_id")
                if seq_id is not None and not (isinstance(seq_id, float) and np.isnan(seq_id)):
                    try:
                        seq_id = int(seq_id)
                    except (TypeError, ValueError):
                        pass
                else:
                    seq_id = None
                mapping, categories, unaligned = resolve_alignment_mapping(
                    alignment_map.get(alignment_id, alignment_map.get(str(alignment_id), {})),
                    seq_id,
                )
                n = graph.n_nodes
                mapping = {a: s for a, s in mapping.items() if 0 <= s < n}
                categories = {s: c for s, c in categories.items() if 0 <= s < n}
                unaligned = [s for s in unaligned if 0 <= s < n]
                structures.append(AlignedStructure(graph, mapping, categories, unaligned))
            self.groups.append((alignment_id, structures))

    def __len__(self):
        return len(self.groups)


def subsample_negatives(
    labels: np.ndarray,
    graph_ids: np.ndarray,
    categories: np.ndarray,
    max_negatives: int | None,
    hard_negative_fraction: float,
    rng,
) -> np.ndarray:
    """The reference loss's InfoNCE subset selection, on the host: keep
    every node in a positive pair; of the rest keep at most
    ``max_negatives``, aiming at a ``hard_negative_fraction`` share of
    hard negatives (conserved category, < 3).  ``max_negatives`` of
    ``None``/``0`` keeps the participating nodes only.  The quota can
    drop candidates under the cap: ``n_easy = sample_size - n_hard`` is
    clipped to the easy pool and the hard pool does not make up for it,
    as in the reference.

    Returns the sorted indices of the kept nodes.
    """
    n = labels.shape[0]
    conserved = categories < 3
    # a node participates iff its label occurs on a conserved node of
    # another graph; one node per graph carries a label, so "count >= 2
    # among conserved nodes" is exact
    cons_labels = labels[conserved]
    uniq, counts = np.unique(cons_labels, return_counts=True)
    multi = uniq[counts >= 2]
    participating = conserved & np.isin(labels, multi)
    part_idx = np.nonzero(participating)[0]

    if max_negatives is None or max_negatives <= 0:
        return part_idx
    if part_idx.size == n:
        return part_idx

    cand = np.nonzero(~participating)[0]
    sample_size = min(int(max_negatives), cand.size)
    if sample_size <= 0:
        return part_idx
    hard = cand[categories[cand] < 3]
    easy = cand[categories[cand] >= 3]
    n_hard = min(int(round(sample_size * hard_negative_fraction)), hard.size)
    n_easy = min(sample_size - n_hard, easy.size)
    parts = [part_idx]
    r = rng if rng is not None else np.random.default_rng(0)
    if n_hard > 0:
        parts.append(np.asarray(r.permutation(hard))[:n_hard])
    if n_easy > 0:
        parts.append(np.asarray(r.permutation(easy))[:n_easy])
    return np.sort(np.concatenate(parts))


def assemble_alignment_batch(
    groups: list[tuple[Any, list[AlignedStructure]]],
    max_unaligned_per_graph: int,
    rng: np.random.Generator | None,
    subset_capacity: int | None = None,
    caps: tuple[int, int] | None = None,
    graph_capacity: int | None = None,
    max_negatives: int | None = None,
    hard_negative_fraction: float = 0.85,
    debug_log=None,
) -> AlignmentBatch | None:
    """Pack alignment groups into one AlignmentBatch (the reference's
    label scheme, on the host, fixed-shape; traced as ``train.assembly``).

    ``max_negatives``/``hard_negative_fraction`` apply the reference
    loss's negative subsampling at assembly time; ``max_negatives=None``
    keeps the full assembled set."""
    with trace.span("train.assembly"):
        structures: list[AlignedStructure] = []
        group_of: list[Any] = []
        for aid, sts in groups:
            structures.extend(sts)
            group_of.extend([aid] * len(sts))
        if len(structures) < 2:
            return None

        graphs = [s.graph for s in structures]
        g_cap = graph_capacity or _round_capacity(len(graphs))
        gb = _pack_group(graphs, g_cap, caps)

        # node offsets in the packed batch (the packing order of batch_graphs)
        offsets = np.cumsum([0] + [g.n_nodes for g in graphs[:-1]])

        alignment_offsets: dict[Any, int] = {}
        node_idx, labels, graph_ids, categories = [], [], [], []
        for graph_idx, st in enumerate(structures):
            aid = group_of[graph_idx]
            if aid not in alignment_offsets:
                alignment_offsets[aid] = len(alignment_offsets)
            a_off = alignment_offsets[aid] * LABEL_STRIDE

            for align_pos, struct_pos in st.mapping.items():
                node_idx.append(offsets[graph_idx] + struct_pos)
                labels.append(a_off + int(align_pos))
                graph_ids.append(graph_idx)
                categories.append(st.categories.get(struct_pos, 2))

            if max_unaligned_per_graph > 0 and st.unaligned:
                k = min(max_unaligned_per_graph, len(st.unaligned))
                if rng is not None and k < len(st.unaligned):
                    sel = list(rng.choice(len(st.unaligned), size=k, replace=False))
                    selected = [st.unaligned[i] for i in sel]
                else:
                    selected = st.unaligned[:k]
                base_label = -((graph_idx + 1) * LABEL_STRIDE)
                for off, sp in enumerate(selected):
                    node_idx.append(offsets[graph_idx] + sp)
                    labels.append(base_label - off)
                    graph_ids.append(graph_idx)
                    categories.append(st.categories.get(sp, 5))

        if not node_idx:
            return None

        if max_negatives is not None:
            keep = subsample_negatives(
                np.asarray(labels, np.int64),
                np.asarray(graph_ids, np.int32),
                np.asarray(categories, np.int32),
                max_negatives,
                hard_negative_fraction,
                rng,
            )
            if debug_log is not None:
                debug_log(
                    "negative_subsampling",
                    {
                        "assembled_nodes": len(node_idx),
                        "kept_nodes": int(keep.size),
                        "max_negatives": int(max_negatives),
                        "hard_negative_fraction": float(hard_negative_fraction),
                    },
                )
            if keep.size == 0:
                return None
            node_idx = [node_idx[i] for i in keep]
            labels = [labels[i] for i in keep]
            graph_ids = [graph_ids[i] for i in keep]
            categories = [categories[i] for i in keep]

        m = len(node_idx)
        m_cap = subset_capacity or _round_capacity(m)
        if m > m_cap:
            # truncate deterministically (does not happen with ladder caps)
            node_idx, labels, graph_ids, categories = (
                x[:m_cap] for x in (node_idx, labels, graph_ids, categories)
            )
            m = m_cap

        def pad(arr, fill, dtype):
            out = np.full(m_cap, fill, dtype)
            out[:m] = arr
            return torch.from_numpy(out)

        # padding labels: unique values far outside the real range, so they
        # never form a same-label pair (and valid=0 masks them out anyway)
        lab = np.full(m_cap, 0, np.int64)
        lab[:m] = labels
        lab[m:] = -2 * 10**9 - np.arange(m_cap - m, dtype=np.int64)

        return AlignmentBatch(
            graphs=gb,
            node_idx=pad(node_idx, 0, np.int32),
            labels=torch.from_numpy(lab),
            graph_ids=pad(graph_ids, -1, np.int32),
            categories=pad(categories, 5, np.int32),
            valid=pad(np.ones(m, np.float32), 0.0, np.float32),
        )


def iter_alignment_batches(
    dataset: AlignmentDataset,
    batch_size: int,
    max_unaligned_per_graph: int,
    rng: np.random.Generator | None = None,
    subset_capacity: int | None = None,
    caps: tuple[int, int] | None = None,
    graph_capacity: int | None = None,
    max_negatives: int | None = None,
    hard_negative_fraction: float = 0.85,
    debug_log=None,
) -> Iterator[AlignmentBatch]:
    order = np.arange(len(dataset))
    if rng is not None:
        rng.shuffle(order)
    for s in range(0, len(order), batch_size):
        idxs = order[s : s + batch_size]
        batch = assemble_alignment_batch(
            [dataset.groups[i] for i in idxs],
            max_unaligned_per_graph,
            rng,
            subset_capacity,
            caps,
            graph_capacity,
            max_negatives,
            hard_negative_fraction,
            debug_log,
        )
        if batch is not None:
            yield batch
