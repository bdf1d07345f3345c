"""All-pairs alignment of node embeddings, as
``ginfinity-align-node-embeddings-batch`` runs it on the card.

Set-up draws families with known homology (``gen.family``; ancestor
lengths spread over the traffic's range, the same for every seed) and
makes every member's node embeddings with the program, as
``pipelines/node_embed.py`` does (graphs built and cut to the model's
feature width, batched inference, zscore_l2 rows of the bases).  Each
request is one batch of the CLI's loop over the pairs ``i < j`` in order:
``cosine_similarity_matrix`` for each pair on the host, then
``affine_align_batch`` (K2 on the card, host un-shear and traceback).
Of the finished pairs' scores and paths only the check's sample is kept
(``harness.Sample``: the largest pair and a reservoir drawn from the
seed).

``correct``: on that sample the plain reference embeds the structures
again (``node_gap``, the largest absolute difference of a node-embedding
entry).  The reference's DP
(float32, the CLI's tie rules and traceback) then runs on the similarity
of the program's own rows: a near-tie in the rows' last bits may turn a
path, so the DP stage is followed from the program's state, and the
rows are held to the reference's apart.  ``score_gap`` is the largest
difference of a pair's score, ``paths_wrong`` counts the pairs whose
path differs.
"""

from __future__ import annotations

import numpy as np
import torch

from ginfinity_tpu_torch.models.gine import GINConfig, GINModel
from ginfinity_tpu_torch.ops.dp import affine_align_batch
from ginfinity_tpu_torch.pipelines.align import cosine_similarity_matrix
from ginfinity_tpu_torch.pipelines.engine import InferenceEngine, preprocess_structures
from portbench import gen, weights
from portbench.counts import k2 as k2_counts
from portbench.counts import similarity as sim_counts
from portbench.harness import Sample, Work
from portbench.reference import dp as rdp
from portbench.reference import gine as ref
from portbench.reference import graphs as rg
from portbench.reference.precision import matmul


class State:
    pass


def setup(env):
    t, cfg, dev = env.traffic, env.config, env.device
    ref.check_config(cfg)
    S = State()
    with env.stage("inputs"):
        anc = gen.lengths(t["families"], t["ancestor_min"], t["ancestor_max"], t["spread"])
        S.structures = [m.structure for f in range(t["families"]) for m in gen.family(
            gen.sub_seed(env.seed, 1, f), t["members"], int(anc[f]), t["sub_rate"],
            t["del_rate"], t["ins_rate"])]
        n = len(S.structures)
        S.pairs = [(i, j) for i in range(n) for j in range(i + 1, n)]
    with env.stage("weights"):
        S.params, S.state = weights.make(cfg, gen.sub_seed(env.seed, 2), dev, trained=True)
        model = GINModel(GINConfig.from_metadata(cfg), S.params, S.state)
    with env.stage("node_embed"):
        engine = InferenceEngine(model, max_nodes_per_batch=t["node_batch"], device=dev)
        pre = preprocess_structures(S.structures, None, cfg["graph_encoding"],
                                    cfg["seq_weight"], feature_dim=cfg["node_feature_dim"])
        S.mats = engine.node_embeddings(pre.graphs, base_only=True)
        del engine, model
    S.cursor, S.sample = 0, None
    with env.stage("warmup"):
        call(S, env)
    S.cursor, S.sample = 0, Sample(t["check_pairs"], gen.sub_seed(env.seed, 8))
    return S


def call(S, env) -> Work:
    t = env.traffic
    chunk = [S.pairs[(S.cursor + k) % len(S.pairs)] for k in range(t["batch_pairs"])]
    S.cursor += len(chunk)
    with env.span("align.similarity"):
        sims = [cosine_similarity_matrix(S.mats[i], S.mats[j]).astype(np.float32)
                for i, j in chunk]
    with env.span("align.dp"):
        results = affine_align_batch(sims, t["gap_open"], t["gap_extend"], t["mode"],
                                     device=env.device)
    if S.sample is not None:
        for (i, j), r in zip(chunk, results):
            S.sample.offer((i, j), len(S.structures[i]) * len(S.structures[j]), r)
    shapes = [s.shape for s in sims]
    d = S.mats[chunk[0][0]].shape[1]
    return Work(len(chunk), {"k2_bytes": sum(k2_counts.nbytes(a, b) for a, b in shapes),
                             "k2_ops": sum(k2_counts.ops(a, b) for a, b in shapes),
                             "sim_flops": sum(sim_counts.flops(a, b, d) for a, b in shapes)})


def end_to_end(units: int, seconds: float) -> dict:
    return {"align_pairs_per_s": units / seconds}


def cosine(a: np.ndarray, b: np.ndarray, eps: float = 1e-8) -> np.ndarray:
    an = a / (np.linalg.norm(a, axis=1, keepdims=True) + eps)
    bn = b / (np.linalg.norm(b, axis=1, keepdims=True) + eps)
    return (an @ bn.T).astype(np.float32)


def _reference_rows(cfg, params, state, structures, device, tf32: bool,
                    dtype=torch.float32) -> list:
    graphs = [rg.standard_graph(s, cfg["node_feature_dim"]) for s in structures]
    cast = lambda tree: weights.cast(tree, dtype)
    with torch.no_grad(), matmul(tf32):
        b = ref.flat_batch(graphs, device, dtype)
        x = ref.node_embeddings(cfg, cast(params), cast(state), b).cpu().numpy()
    return [x[o:o + n] for o, n in zip(b["offsets"], b["sizes"])]


def check(S, env, control: bool = False) -> dict:
    t, cfg = env.traffic, env.config
    sample = S.sample.picks()
    ids = sorted({i for (p, _) in sample for i in p})
    rows = {i: S.mats[i] for i in ids}
    del S.mats
    S.sample = None
    if env.device.type == "cuda":
        torch.cuda.empty_cache()
    structures = [S.structures[i] for i in ids]
    want = dict(zip(ids, _reference_rows(cfg, S.params, S.state, structures, env.device,
                                         tf32=False)))
    if control:
        rows = dict(zip(ids, _reference_rows(cfg, S.params, S.state, structures, env.device,
                                             tf32=True)))
        sims = [cosine(rows[i], rows[j]) for (i, j), _ in sample]
        sample = list(zip([p for p, _ in sample],
                          rdp.global_align(sims, t["gap_open"], t["gap_extend"], env.device)))
    node_gap = max(float(np.abs(rows[i].astype(np.float64) - want[i]).max())
                   if rows[i].shape == want[i].shape else np.inf for i in ids)
    # the DP is followed from the program's own rows: near-ties decide paths
    sims = [cosine(rows[i], rows[j]) for (i, j), _ in sample]
    expect = rdp.global_align(sims, t["gap_open"], t["gap_extend"], env.device)
    return {"node_gap": node_gap,
            "score_gap": max(abs(r[0] - e[0]) for (_, r), e in zip(sample, expect)),
            "paths_wrong": float(sum(r[1] != e[1] for (_, r), e in zip(sample, expect)))}
