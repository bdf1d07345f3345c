"""``align.similarity_ms``: the host clock around the
``pipelines/align.py::cosine_similarity_matrix`` calls of a batch of
pairs, mean milliseconds a batch."""


def read(r):
    s = r.spans.get("align.similarity")
    return 1e3 * sum(s) / len(s) if s else None
