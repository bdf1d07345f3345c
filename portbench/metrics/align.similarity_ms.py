"""``align.similarity_ms``: the host's similarity matrices of a batch of
pairs (``pipelines/align.py::cosine_similarity_matrix``, one root span
``align.similarity`` a pair), their milliseconds summed and divided by
the number of ``ops/dp.py::affine_align_batch`` calls (root spans
``dp.align_batch``, one a batch)."""

from portbench import spans


def read(r):
    sims, batches = spans.root_ms("align.similarity"), spans.root_ms("dp.align_batch")
    if sims is None or batches is None:
        return None
    return sum(sims) / len(batches)
