"""The per-layer metrics that read the program's spans: their values on
a synthetic span list, and ``None`` where the spans they need are absent
or the program has no tracing module (the parent of the change that
brought it)."""

import sys

import pytest

from ginfinity_tpu_torch.utils import trace
from portbench import harness

MS = 1_000_000
SPAN_METRICS = {
    "windows-long.forgi-4x512": ("windows.prep_ms", "windows.pack_ms", "windows.build_ms"),
    "align-allpairs.packaged-6x128": ("align.unshear_ms", "align.traceback_ms",
                                      "align.dp_cells_useful"),
    "train-align.forgi-4x512": ("train.encode_ms", "train.loss_ms", "train.backward_ms",
                                "train.adam_ms"),
}


class Spans:
    """A span list built by hand: ``add(name, ms, parent)``."""

    def __init__(self):
        self.recs, self.t = [], 0

    def add(self, name, ms, parent=None, device_ms=None, **counts):
        rid = len(self.recs) + 1
        request = rid if parent is None else parent.request
        rec = trace.Record(name, self.t, self.t + int(ms * MS), rid,
                           None if parent is None else parent.id, request, counts, device_ms)
        self.t += int(ms * MS)
        self.recs.append(rec)
        return rec


def _synthetic():
    s = Spans()
    for _ in range(2):  # two window calls
        root = s.add("windows.embed", 100.0, windows=10, groups=2, chunks=3)
        s.add("windows.prep", 4.0, root)
        for _ in range(2):
            s.add("windows.pack", 1.5, root)
            s.add("windows.upload", 0.5, root)
        for _ in range(3):
            s.add("windows.build", 0.1, root, device_ms=0.25)
            s.add("windows.encoder", 0.2, root, device_ms=8.0)
    s.add("windows.prep", 50.0)  # outside any call: not counted
    for cells_real, cells_padded in ((300, 400), (100, 400)):
        root = s.add("dp.align_batch", 300.0, pairs=2, cells_real=cells_real,
                     cells_padded=cells_padded)
        for _ in range(2):
            s.add("dp.unshear", 20.0, root)
            s.add("dp.traceback", 100.0, root)
    for _ in range(4):
        root = s.add("train.step", 1.0, device_ms=250.0)
        for name, ms in (("encode", 60.0), ("loss", 100.0), ("backward", 85.0),
                         ("adam", 4.0)):
            s.add(f"train.{name}", 0.1, root, device_ms=ms)
    return s.recs


WANT = {"windows.prep_ms": 4.0, "windows.pack_ms": 4.0, "windows.build_ms": 0.75,
        "align.unshear_ms": 40.0, "align.traceback_ms": 200.0,
        "align.dp_cells_useful": 50.0, "train.encode_ms": 60.0, "train.loss_ms": 100.0,
        "train.backward_ms": 85.0, "train.adam_ms": 4.0}


def _readers(cell):
    return {m["name"]: m["reader"] for m in harness.load_cell(cell).per_layer
            if m["name"] in SPAN_METRICS[cell]}


@pytest.mark.parametrize("cell", sorted(SPAN_METRICS))
def test_readers_on_a_synthetic_span_list(cell, monkeypatch):
    readers = _readers(cell)
    assert set(readers) == set(SPAN_METRICS[cell])
    recs = _synthetic()
    monkeypatch.setattr(trace, "recorded", lambda: list(recs))
    for name, reader in readers.items():
        assert reader.read(None) == pytest.approx(WANT[name]), name


@pytest.mark.parametrize("cell", sorted(SPAN_METRICS))
def test_readers_read_nothing_without_their_spans(cell, monkeypatch):
    readers = _readers(cell)
    monkeypatch.setattr(trace, "recorded", lambda: [])
    assert all(r.read(None) is None for r in readers.values())
    recs = _synthetic()
    kids = [r for r in recs if r.parent is not None]
    monkeypatch.setattr(trace, "recorded", lambda: kids)
    assert all(r.read(None) is None for r in readers.values())
    # roots alone: only the counter, which the roots carry, still reads
    tops = [r for r in recs if r.parent is None]
    monkeypatch.setattr(trace, "recorded", lambda: tops)
    assert {n for n, r in readers.items() if r.read(None) is not None} <= \
        {"align.dp_cells_useful"}


@pytest.mark.parametrize("cell", sorted(SPAN_METRICS))
def test_readers_read_nothing_without_the_tracing_module(cell, monkeypatch):
    readers = _readers(cell)
    import ginfinity_tpu_torch.utils

    monkeypatch.setitem(sys.modules, "ginfinity_tpu_torch.utils.trace", None)
    monkeypatch.delattr(ginfinity_tpu_torch.utils, "trace")
    assert all(r.read(None) is None for r in readers.values())
