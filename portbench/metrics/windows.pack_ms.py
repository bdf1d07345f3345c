"""``windows.pack_ms``: the host's work between length groups of a
window call, while the card has nothing of the group queued: each group's
packing (``fast_windows._group_host``, span ``windows.pack``) and upload
(``_upload`` over the mesh, span ``windows.upload``), milliseconds per
``embed_corpus_windows`` call (span ``windows.embed``)."""

from portbench import spans


def read(r):
    return spans.per_root("windows.embed", ("windows.pack", "windows.upload"))
