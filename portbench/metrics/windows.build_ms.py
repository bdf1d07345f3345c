"""``windows.build_ms``: the window build of every chunk
(``fast_windows._window_chunk``, or ``_window_graphs`` on the compact
path; span ``windows.build``) from its CUDA events, milliseconds per
``embed_corpus_windows`` call (span ``windows.embed``)."""

from portbench import spans


def read(r):
    return spans.per_root("windows.embed", ("windows.build",), device=True)
