"""The per-layer metrics that read the program's spans: their values on
a synthetic span list, and ``None`` where the spans they need are absent
or the program has no tracing module (the parent of the change that
brought it); and the trace summary's idle gaps, labelled by the program's
spans before the harness's marks."""

import sys
import types

import pytest

from ginfinity_tpu_torch.utils import trace
from portbench import harness

MS = 1_000_000
SPAN_METRICS = {
    "windows-long.forgi-4x512": ("windows.prep_ms", "windows.pack_ms", "windows.build_ms"),
    "align-allpairs.packaged-6x128": ("align.similarity_ms", "align.dp_ms",
                                      "align.outside_spans_ms", "align.traceback_ms",
                                      "align.dp_cells_useful"),
    "train-align.forgi-4x512": ("train.step_ms", "train.assembly_ms", "train.encode_ms",
                                "train.loss_ms", "train.backward_ms", "train.adam_ms"),
}
# those that read only root spans (and the counter the roots carry)
FROM_ROOTS = {"align.similarity_ms", "align.dp_ms", "align.outside_spans_ms",
              "align.dp_cells_useful", "train.step_ms", "train.assembly_ms"}
# the traced segment that the synthetic span list fills
READING = types.SimpleNamespace(trace={"window_s": 1.2})


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
    for cells_real, cells_padded in ((300, 400), (100, 400)):  # two alignment batches
        for _ in range(2):
            s.add("align.similarity", 40.0)
        root = s.add("dp.align_batch", 300.0, pairs=2, cells_real=cells_real,
                     cells_padded=cells_padded)
        for _ in range(2):
            s.add("dp.traceback", 100.0, root)
    for _ in range(4):
        s.add("train.assembly", 70.0)
        root = s.add("train.step", 1.0, device_ms=250.0)
        for name, ms in (("encode", 60.0), ("loss", 100.0), ("backward", 85.0),
                         ("adam", 4.0)):
            s.add(f"train.{name}", 0.1, root, device_ms=ms)
    return s.recs


# align: 1,200 ms of segment, two batches of 80 ms of similarity and 300
# of DP, so 600 - 80 - 300 ms a batch outside them
WANT = {"windows.prep_ms": 4.0, "windows.pack_ms": 4.0, "windows.build_ms": 0.75,
        "align.similarity_ms": 80.0, "align.dp_ms": 300.0, "align.outside_spans_ms": 220.0,
        "align.traceback_ms": 200.0, "align.dp_cells_useful": 50.0,
        "train.step_ms": 250.0, "train.assembly_ms": 70.0, "train.encode_ms": 60.0,
        "train.loss_ms": 100.0, "train.backward_ms": 85.0, "train.adam_ms": 4.0}


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
        assert reader.read(READING) == pytest.approx(WANT[name]), name


@pytest.mark.parametrize("cell", sorted(SPAN_METRICS))
def test_readers_read_nothing_without_their_spans(cell, monkeypatch):
    readers = _readers(cell)
    monkeypatch.setattr(trace, "recorded", lambda: [])
    assert all(r.read(READING) is None for r in readers.values())
    recs = _synthetic()
    kids = [r for r in recs if r.parent is not None]
    monkeypatch.setattr(trace, "recorded", lambda: kids)
    assert all(r.read(READING) is None for r in readers.values())
    # roots alone: only the metrics of roots and of the roots' counts read
    tops = [r for r in recs if r.parent is None]
    monkeypatch.setattr(trace, "recorded", lambda: tops)
    assert {n for n, r in readers.items() if r.read(READING) is not None} == \
        FROM_ROOTS & set(readers)
    # the DP's roots without the similarity's: no batch split reads
    monkeypatch.setattr(trace, "recorded",
                        lambda: [r for r in recs if r.name != "align.similarity"])
    for name in ("align.similarity_ms", "align.outside_spans_ms"):
        if name in readers:
            assert readers[name].read(READING) is None, name


@pytest.mark.parametrize("cell", sorted(SPAN_METRICS))
def test_readers_read_nothing_without_the_tracing_module(cell, monkeypatch):
    readers = _readers(cell)
    import ginfinity_tpu_torch.utils

    monkeypatch.setitem(sys.modules, "ginfinity_tpu_torch.utils.trace", None)
    monkeypatch.delattr(ginfinity_tpu_torch.utils, "trace")
    assert all(r.read(READING) is None for r in readers.values())


def test_outside_spans_reads_nothing_untraced(monkeypatch):
    reader = _readers("align-allpairs.packaged-6x128")["align.outside_spans_ms"]
    recs = _synthetic()
    monkeypatch.setattr(trace, "recorded", lambda: list(recs))
    assert reader.read(types.SimpleNamespace(trace=None)) is None


def test_idle_gaps_take_the_innermost_program_span_then_the_mark():
    # device busy over [0, 10] and [100, 110] ms and [300, 310]; gaps
    # (10, 100) mid 55, (110, 300) mid 205, (310, 400) mid 355
    events = [("k", 0, 10 * MS), ("k", 100 * MS, 10 * MS), ("k", 300 * MS, 10 * MS)]
    s = Spans()
    s.t = 20 * MS
    root = s.add("dp.align_batch", 60.0)       # 20-80 ms
    s.t = 40 * MS
    s.add("dp.traceback", 30.0, root)          # 40-70 ms, holds 55
    s.t = 150 * MS
    s.add("align.similarity", 100.0)           # 150-250 ms, holds 205
    marks = [("align.batch", 0, 320 * MS)]     # holds 55, 205 and not 355
    out = harness.summarise_trace(events, marks, 0, 400 * MS, s.recs)
    assert out["idle_gaps"] == [["align.similarity", 0.19], ["dp.traceback", 0.09],
                                ["between calls", 0.09]]
    out = harness.summarise_trace(events, marks, 0, 400 * MS)
    assert [g[0] for g in out["idle_gaps"]] == ["align.batch", "align.batch",
                                                "between calls"]
