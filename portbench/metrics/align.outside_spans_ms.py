"""``align.outside_spans_ms``: the part of an alignment batch that
neither the similarity (root spans ``align.similarity``) nor the DP (root
spans ``dp.align_batch``) holds: the traced segment's milliseconds less
every such root, divided by the number of ``dp.align_batch`` roots (one a
batch).  It holds the batch loop's own work, the benchmark's sample and
counts, and the garbage collector.  With ``align.similarity_ms`` and
``align.dp_ms`` it adds up to the traced segment's milliseconds a batch."""

from portbench import spans


def read(r):
    if r.trace is None:
        return None
    sims, batches = spans.root_ms("align.similarity"), spans.root_ms("dp.align_batch")
    if sims is None or batches is None:
        return None
    return (1e3 * r.trace["window_s"] - sum(sims) - sum(batches)) / len(batches)
