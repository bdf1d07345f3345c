"""``align.dp_cells_useful``: the share of the DP's padded cells that
belong to a pair: the counts of each ``affine_align_batch`` call (span
``dp.align_batch``), 100 * sum of ``cells_real`` ((l1+1)(l2+1) a pair)
over sum of ``cells_padded`` (B (L1+1)(L2+1) of the padded batch)."""

from portbench import spans


def read(r):
    tops = spans.roots(spans.recorded(), "dp.align_batch")
    padded = sum(t.counts.get("cells_padded", 0) for t in tops)
    if not padded:
        return None
    return 100.0 * sum(t.counts.get("cells_real", 0) for t in tops) / padded
