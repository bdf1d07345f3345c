"""``utils/trace.py``: spans record only while a profiler or
``trace.recording()`` is on, nest with parent and request ids, share the
profiler's clock, and leave the port's outputs bit for bit as they are;
the window path, the DP, the train step and the window CLI record the
span trees their benchmark metrics read."""

import contextlib
import inspect
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ginfinity_tpu_torch.models.checkpoint import export_torch_checkpoint
from ginfinity_tpu_torch.models.gine import GINConfig, GINModel, init_params
from ginfinity_tpu_torch.ops.dp import affine_align_batch
from ginfinity_tpu_torch.parallel.mesh import DataMesh
from ginfinity_tpu_torch.pipelines import embed
from ginfinity_tpu_torch.pipelines.align import cosine_similarity_matrix
from ginfinity_tpu_torch.pipelines.fast_windows import embed_corpus_windows
from ginfinity_tpu_torch.pipelines.msa_eval import random_structure
from ginfinity_tpu_torch.pipelines.train_eval import generate_alignment_training_data
from ginfinity_tpu_torch.training import data as D
from ginfinity_tpu_torch.training import train as T
from ginfinity_tpu_torch.training.losses import AlignmentLossConfig
from ginfinity_tpu_torch.utils import trace
from ginfinity_tpu_torch.utils.io import read_table

CPU = torch.device("cpu")
CLOCK_SLACK_NS = 100_000
SMALL = dict(hidden_dim=32, output_dim=16, gin_layers=2, pooling_type="global_mean_pool",
             node_embed_norm="zscore_l2", norm_type="graph", use_residual=True,
             normalize_nodes_before_pool=True)


@pytest.fixture(autouse=True)
def fresh_spans():
    trace.clear()
    yield
    trace.clear()


def _on(how):
    return profile(activities=[ProfilerActivity.CPU]) if how == "profiler" \
        else trace.recording()


def _tree(recs):
    """``{name: count}`` and ``{name: {parent name}}`` of ``recs``."""
    by_id = {r.id: r for r in recs}
    counts, parents = {}, {}
    for r in recs:
        counts[r.name] = counts.get(r.name, 0) + 1
        parents.setdefault(r.name, set()).add(by_id[r.parent].name if r.parent else None)
    return counts, parents


def test_off_records_nothing_and_reads_no_clock(monkeypatch):
    stamps = []
    monkeypatch.setattr(trace, "_clock", lambda: stamps.append(1) or 0)
    assert not trace.enabled()
    with trace.span("a") as a, trace.span("b", device=True) as b:
        a.add(n=1)
    assert a is b is trace.span("c") is trace.current()
    assert stamps == [] and trace.recorded() == []


@pytest.mark.parametrize("how", ["profiler", "recording"])
def test_nested_spans_parent_request_and_self_time(how):
    with _on(how):
        assert trace.enabled()
        with trace.span("root") as root_span:
            root_span.add(n=2)
            with trace.span("kid"):
                with trace.span("grandkid"):
                    torch.ones(64).sum()
            with trace.span("kid"):
                trace.current().add(n=1)
            root_span.add(n=3)
        with trace.span("root2"):
            pass
    with trace.span("after"):
        pass
    recs = trace.recorded()
    assert [r.name for r in recs] == ["grandkid", "kid", "kid", "root", "root2"]
    gk, k1, k2, root, root2 = recs
    assert root.parent is None and root.request == root.id and root.counts == {"n": 5}
    assert (k1.parent, k2.parent, gk.parent) == (root.id, root.id, k1.id)
    assert k2.counts == {"n": 1}
    assert {r.request for r in (gk, k1, k2)} == {root.id}
    assert root2.parent is None and root2.request == root2.id != root.id
    assert all(r.start_ns <= r.end_ns and r.device_ms is None for r in recs)
    assert root.start_ns <= k1.start_ns <= gk.start_ns <= gk.end_ns <= k1.end_ns \
        <= k2.start_ns <= k2.end_ns <= root.end_ns <= root2.start_ns
    dur = lambda r: r.end_ns - r.start_ns
    assert trace.self_ns(root, recs) == dur(root) - dur(k1) - dur(k2) >= 0
    assert trace.self_ns(k1, recs) == dur(k1) - dur(gk)
    assert trace.self_ns(gk, recs) == dur(gk)
    assert trace.recorded() == recs  # reading does not clear
    trace.clear()
    assert trace.recorded() == []


def test_spans_share_the_profilers_clock():
    names = [f"clock.{k}" for k in range(4)]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span(names[0]):
            for n in names[1:]:
                with trace.span(n):
                    torch.randn(256, 256) @ torch.randn(256, 256)
    recs = {r.name: r for r in trace.recorded()}
    events = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.name() in recs and e.is_user_annotation()}
    assert set(events) == set(names)
    for n, e in events.items():
        r = recs[n]
        assert r.start_ns - CLOCK_SLACK_NS <= e.start_ns(), n
        assert e.start_ns() + e.duration_ns() <= r.end_ns + CLOCK_SLACK_NS, n


def _score_mats(seed, n=7):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((int(a), int(b))).astype(np.float32)
            for a, b in rng.integers(3, 40, size=(n, 2))]


@pytest.mark.parametrize("mode", ["global", "local"])
def test_dp_span_tree_counts_and_outputs(mode):
    mats = _score_mats(3)
    off = affine_align_batch(mats, -1.0, -0.3, mode, device="cpu")
    with trace.recording():
        on = affine_align_batch(mats, -1.0, -0.3, mode, device="cpu")
    assert on == off
    recs = trace.recorded()
    counts, parents = _tree(recs)
    assert counts == {"dp.align_batch": 1, "dp.traceback": len(mats)}
    assert parents == {"dp.align_batch": {None}, "dp.traceback": {"dp.align_batch"}}
    root = next(r for r in recs if r.name == "dp.align_batch")
    L1 = max(m.shape[0] for m in mats)
    L2 = max(m.shape[1] for m in mats)
    assert root.counts == {
        "pairs": len(mats),
        "cells_real": sum((a + 1) * (b + 1) for a, b in (m.shape for m in mats)),
        "cells_padded": len(mats) * (L1 + 1) * (L2 + 1)}


def test_similarity_is_a_root_span():
    a, b = (np.random.default_rng(k).standard_normal((5 + k, 8)).astype(np.float32)
            for k in range(2))
    off = cosine_similarity_matrix(a, b)
    with trace.recording():
        on = cosine_similarity_matrix(a, b)
    assert np.array_equal(on, off)
    assert [(r.name, r.parent) for r in trace.recorded()] == [("align.similarity", None)]


def _model(kw, seed=5):
    cfg = GINConfig.create(**kw)
    params, state = init_params(torch.Generator().manual_seed(seed), cfg)
    return GINModel(cfg, params, state)


def _corpus(seed=0, n=6):
    rng = np.random.default_rng(seed)
    return [random_structure(rng, int(k)) for k in rng.integers(30, 150, size=n)] + ["." * 10]


WINDOW_TREE = {"windows.embed": {None}, "windows.prep": {"windows.embed"},
               "windows.pack": {"windows.embed"}, "windows.upload": {"windows.embed"},
               "windows.build": {"windows.embed"}, "windows.encoder": {"windows.embed"},
               "windows.download": {"windows.embed"}}


@pytest.mark.parametrize("kw", [SMALL, {**SMALL, "norm_type": "batch"}],
                         ids=["dense", "compact"])
def test_window_span_tree_and_outputs(kw):
    model, corpus = _model(kw), _corpus()
    off = embed_corpus_windows(model, corpus, 24, True, device="cpu")
    with trace.recording():
        on = embed_corpus_windows(model, corpus, 24, True, device="cpu")
    for (s0, e0), (s1, e1) in zip(off, on):
        assert np.array_equal(s0, s1) and np.array_equal(e0, e1)
    recs = trace.recorded()
    counts, parents = _tree(recs)
    assert parents == WINDOW_TREE
    root = next(r for r in recs if r.name == "windows.embed")
    groups, chunks = root.counts["groups"], root.counts["chunks"]
    assert root.counts["windows"] == sum(len(s) for s, _ in on) > 0
    assert groups > 1 and chunks >= groups
    assert counts == {"windows.embed": 1, "windows.prep": 1, "windows.pack": groups,
                      "windows.upload": groups, "windows.build": chunks,
                      "windows.encoder": chunks, "windows.download": groups}
    # no CUDA device, no device time
    assert all(r.device_ms is None for r in recs)


def test_window_cli_span_tree(tmp_path):
    model = _model(SMALL)
    ckpt = str(tmp_path / "m.pth")
    export_torch_checkpoint(ckpt, model.config, model.params, model.state)
    src = tmp_path / "in.csv"
    src.write_text("rid,secondary_structure\n" + "".join(
        f"r{k},{s}\n" for k, s in enumerate(_corpus())))
    with trace.recording():
        embed.main(["--input", str(src), "--id-column", "rid", "--output",
                    str(tmp_path / "w.tsv"), "--model-path", ckpt, "--window-size", "24",
                    "--keep-paired-neighbors", "--device", "cpu", "--quiet"])
    counts, parents = _tree(trace.recorded())
    assert parents == {**WINDOW_TREE, "embed.read": {None}, "embed.load": {None},
                       "embed.write": {None}}
    assert counts["embed.read"] == counts["embed.load"] == counts["embed.write"] == 1


@pytest.fixture(scope="module")
def alignment_batch(tmp_path_factory):
    d = tmp_path_factory.mktemp("align")
    data_p, map_p, _ = generate_alignment_training_data(
        str(d), n_train_families=4, n_eval_families=1, n_seqs=4, anc_len=30, seed=11)
    with open(map_p) as f:
        ds = D.AlignmentDataset(read_table(data_p, sep="\t"), json.load(f))
    with trace.recording():
        batch = D.assemble_alignment_batch(ds.groups[:3], 4, np.random.default_rng(0),
                                           max_negatives=50)
    assembled = trace.recorded()
    trace.clear()
    return batch, assembled


def _train_step(batch, on: bool):
    kw = {**SMALL, "dropout": 0.1}
    cfg = GINConfig.create(**kw)
    params, state = init_params(torch.Generator().manual_seed(2), cfg)
    ts = T.TrainState.create(params, state, 1e-3)
    step = T.make_train_step(cfg, T.alignment_loss_fn(AlignmentLossConfig()))
    gen = torch.Generator().manual_seed(4)
    with trace.recording() if on else contextlib.nullcontext():
        ts, loss = step(ts, batch, gen)
    return loss, [leaf.detach().clone() for _, leaf in T._leaves((), ts.params)]


def test_train_step_span_tree_and_outputs(alignment_batch):
    batch, assembled = alignment_batch
    assert [(r.name, r.parent) for r in assembled] == [("train.assembly", None)]
    loss0, params0 = _train_step(batch, on=False)
    assert trace.recorded() == []
    loss1, params1 = _train_step(batch, on=True)
    assert torch.equal(loss0, loss1)
    assert len(params0) == len(params1) and all(map(torch.equal, params0, params1))
    recs = trace.recorded()
    counts, parents = _tree(recs)
    assert counts == {"train.step": 1, "train.encode": 1, "train.loss": 1,
                      "train.backward": 1, "train.adam": 1}
    assert parents == {"train.step": {None}, **{f"train.{k}": {"train.step"} for k in
                                                 ("encode", "loss", "backward", "adam")}}
    order = [r.name for r in sorted(recs, key=lambda r: r.start_ns) if r.parent]
    assert order == ["train.encode", "train.loss", "train.backward", "train.adam"]


@pytest.mark.parametrize("mesh", [None, DataMesh([CPU, CPU])], ids=["one", "sharded"])
def test_train_steps_take_no_marks(mesh):
    step = T.make_train_step(GINConfig.create(**SMALL), T.alignment_loss_fn(), mesh)
    assert list(inspect.signature(step).parameters) == ["ts", "batch", "generator"]
