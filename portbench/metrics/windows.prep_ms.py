"""``windows.prep_ms``: the host's prep of a window call
(``fast_windows._prep_corpus_groups``: pair tables, window features,
length groups; span ``windows.prep``), milliseconds per
``embed_corpus_windows`` call (span ``windows.embed``)."""

from portbench import spans


def read(r):
    return spans.per_root("windows.embed", ("windows.prep",))
