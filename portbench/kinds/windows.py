"""Window embedding of long transcripts, as ``ginfinity-embed
--window-size L --keep-paired-neighbors`` runs it on the card.

Set-up draws a pool of nested structures (``gen.random_structure``) of
lengths spread over the traffic's range; their lengths and order are the
same for every seed, their structures are the seed's.  The pool is dealt
so that every ``per_call`` consecutive transcripts hold one of each of
``per_call`` length strata, and so every request does about the same
work.  Each request is one ``fast_windows.embed_corpus_windows`` call on
the next ``per_call`` transcripts of the pool (cyclically): every start is
embedded and the float32 rows come back to the host.  Of the finished
transcripts only the check's sample is kept (``harness.Sample``: the
longest and a reservoir drawn from the seed).

``correct``: the sampled transcripts must have every start, in order
(``starts_wrong``, a count), and a sample of their windows is rebuilt
and embedded by the plain reference (window graph with pulled partners
in the model's feature and edge layout, GINE stack, node norm, mean
pool, fc) in float32: ``emb_gap`` is the largest absolute difference of
an embedding entry.
"""

from __future__ import annotations

import numpy as np
import torch

from ginfinity_tpu_torch.models.gine import GINConfig, GINModel
from ginfinity_tpu_torch.ops.windows_encoder import forward_windows
from ginfinity_tpu_torch.pipelines.fast_windows import embed_corpus_windows
from portbench import gen, weights
from portbench.counts import gine as gine_counts
from portbench.counts import k1 as k1_counts
from portbench.harness import Sample, Work
from portbench.reference import gine as ref
from portbench.reference import graphs as rg
from portbench.reference.precision import matmul

REF_BLOCK = 512  # windows a reference forward


class State:
    pass


def setup(env):
    t, cfg = env.traffic, env.config
    ref.check_config(cfg)
    S = State()
    S.L = t["window"]
    with env.stage("inputs"):
        lengths = gen.lengths(t["pool"], t["length_min"], t["length_max"], t["spread"])
        lengths = np.sort(lengths).reshape(t["per_call"], -1).T.reshape(-1)
        S.pool = [gen.random_structure(np.random.default_rng(gen.sub_seed(env.seed, 1, k)),
                                       int(n)) for k, n in enumerate(lengths)]
        rows = [k1_counts.window_rows(rg.pair_table(s), S.L) for s in S.pool]
        S.rows = [float(r.sum()) for r in rows]
        S.windows = [float(r.size) for r in rows]
    with env.stage("weights"):
        S.params, S.state = weights.make(cfg, gen.sub_seed(env.seed, 2), env.device, trained=True)
        S.model = GINModel(GINConfig.from_metadata(cfg), S.params, S.state).to(env.device)
    S.cursor, S.sample = 0, None
    with env.stage("warmup"):
        for _ in range(t["warmup_calls"]):
            call(S, env)
    S.cursor, S.sample = 0, Sample(t["check_transcripts"], gen.sub_seed(env.seed, 8))
    return S


def call(S, env) -> Work:
    t, cfg = env.traffic, env.config
    idx = [(S.cursor + k) % len(S.pool) for k in range(t["per_call"])]
    S.cursor += t["per_call"]
    before = forward_windows.launches
    with env.span("windows.call"):
        out = embed_corpus_windows(S.model, [S.pool[i] for i in idx], S.L,
                                   t["keep_paired_neighbors"], 0.0, device=env.device)
    if S.sample is not None:  # a kept row is copied: a view would hold its group's rows
        for k, (i, (starts, emb)) in enumerate(zip(idx, out)):
            S.sample.offer((S.cursor, k), len(S.pool[i]), (i, starts, emb),
                           lambda v: (v[0], v[1], v[2].copy()))
    rows = sum(S.rows[i] for i in idx)
    wins = sum(S.windows[i] for i in idx)
    return Work(sum(st.size for st, _ in out), {
        "gine_flops": gine_counts.encoder_flops(cfg, rows) + k1_counts.flops(cfg, rows, wins),
        "k1_flops": k1_counts.flops(cfg, rows, wins),
        "k1_bytes": k1_counts.nbytes(cfg, rows, wins, S.L, forward_windows.launches - before),
    })


def end_to_end(units: int, seconds: float) -> dict:
    return {"windows_per_s": units / seconds}


def _reference_rows(cfg, params, state, graphs, device, tf32: bool) -> np.ndarray:
    out = []
    with torch.no_grad(), matmul(tf32):
        for k in range(0, len(graphs), REF_BLOCK):
            b = ref.flat_batch(graphs[k:k + REF_BLOCK], device)
            out.append(ref.graph_embeddings(cfg, params, state, b).cpu().numpy())
    return np.concatenate(out)


def check(S, env, control: bool = False) -> dict:
    t, cfg, L = env.traffic, env.config, S.L
    rng = np.random.default_rng(gen.sub_seed(env.seed, 7))
    starts_wrong, graphs, prog = 0, [], []
    for _, (i, starts, emb) in S.sample.picks():
        s = S.pool[i]
        n_starts = len(s) - L + 1
        starts_wrong += int(not np.array_equal(starts, np.arange(n_starts)))
        sel = np.unique(np.concatenate([[0, n_starts - 1], rng.choice(
            n_starts, size=min(t["check_windows_each"], n_starts), replace=False)]))
        where = {int(v): k for k, v in enumerate(starts)}
        prog.append(np.stack([emb[where[v]] if v in where else
                              np.full(cfg["output_dim"], np.nan, np.float32) for v in sel]))
        pt = rg.pair_table(s)
        feat = rg.window_features(pt, cfg["node_feature_dim"], cfg["graph_encoding"])
        graphs += [rg.window_graph(pt, feat, int(v), L, cfg["edge_feature_dim"]) for v in sel]
    prog = np.concatenate(prog)
    # the program's state goes before the reference runs
    del S.model
    S.sample = None
    if env.device.type == "cuda":
        torch.cuda.empty_cache()
    want = _reference_rows(cfg, S.params, S.state, graphs, env.device, tf32=False)
    if control:
        prog = _reference_rows(cfg, S.params, S.state, graphs, env.device, tf32=True)
    gap = np.abs(prog.astype(np.float64) - want)
    return {"starts_wrong": float(starts_wrong),
            "emb_gap": float(np.nan_to_num(gap, nan=np.inf).max())}
