"""Alignment-mode training steps, as ``ginfinity-train --training_mode
alignment`` runs them on the card.

Set-up draws a pool of families with known homology (``gen.family``;
ancestor lengths spread over the traffic's range, the same for every
seed), builds the program's ``AlignmentDataset`` over them (forgi graphs,
categorised alignment maps), makes the weights as the trainer
initialises a model, and builds one ``TrainState`` and one step of
``make_train_step``.  It then drives that state through the first
``checked_steps`` steps through the window's own call and feed (batches
of distinct families), and hands it to the window.  Each request is one
step: ``assemble_alignment_batch`` on the host (groups in an order
reshuffled every epoch, each batch one family of each of ``batch_groups``
length strata; unaligned picks and negative subsampling from the run's
generator), the upload, then forward (dropout from the step's
generator), loss, backward and Adam.  Before each step of the window
the state it starts from is copied into buffers made once (parameters,
Adam's moments and count, model state, the batch's groups, the host
generator's state before the batch and the dropout generator's), so
that the check can follow the window's last step.

``correct``: the plain reference (``reference/``) follows the first
steps from the same weights, families, generator states and dropout
draws: it builds the forgi graphs and the mined subset again, and
computes the forward, loss, gradients and Adam in float64 (a float32
reference crosses ReLU kinks of its own, as the program does, and reads
as far from the float64 result as the program).  Compared: each checked
step's loss (``loss_gap``, relative, the largest), the reference's loss
taken at the program's own parameters before that step (after one Adam
step every parameter whose gradient is at round-off level has moved
+-lr either way, so the two runs' later parameters part by that noise);
the first gradient as Adam got it (``grad_gap``); and each parameter's
change over the checked steps, the reference on its own trajectory
(``change_gap``); both by the median leaf: the gap between the
program's norm and the reference's over the larger of the reference's
norm of that leaf and of the median leaf (a kink crossed moves a few
leaves far, so the worst leaf swings from seed to seed).  Leaves whose
reference gradient is under a thousandth of the median leaf's (moved by
round-off alone under Adam) are left out of ``change_gap``.  The
window's last step is followed from the program's own state before it
(its parameters and Adam's moments, as the copy holds them): its loss
(``late_loss_gap``, relative) and each parameter's change in that step
(``late_change_gap``, the median moving leaf, as above), so that a step
of the window that departs from the first ones is caught too.
"""

from __future__ import annotations

import numpy as np
import torch

from ginfinity_tpu_torch.models.gine import GINConfig
from ginfinity_tpu_torch.training.data import AlignmentDataset, assemble_alignment_batch
from ginfinity_tpu_torch.training.losses import AlignmentLossConfig
from ginfinity_tpu_torch.training.train import TrainState, alignment_loss_fn, make_train_step
from ginfinity_tpu_torch.utils.device import disable_tf32
from ginfinity_tpu_torch.utils.io import Table
from portbench import gen, weights
from portbench.counts import gine as gine_counts
from portbench.harness import Work
from portbench.reference import gine as ref
from portbench.reference import graphs as rg
from portbench.reference import train as rt
from portbench.reference.precision import matmul

# node-count ladder of the program's padded batches (the dropout masks
# are drawn over the padded rows, so the reference draws the same)
_LADDER = (32, 64, 128, 192, 256, 384, 512, 768, 1024, 1536, 2048, 3072,
           4096, 6144, 8192, 12288, 16384)
B1 = 0.9  # Adam's first-moment decay


def padded_rows(n: int) -> int:
    for c in _LADDER:
        if n <= c:
            return c
    return -(-n // 4096) * 4096


class State:
    pass


def setup(env):
    t, cfg, dev = env.traffic, env.config, env.device
    ref.check_config(cfg)
    if dev.type == "cuda":
        disable_tf32()  # as the training CLI does on a card
    S = State()
    F = t["families"]
    with env.stage("inputs"):
        if F % t["batch_groups"]:
            raise ValueError("families must be a multiple of batch_groups")
        S.lengths = anc = gen.lengths(F, t["ancestor_min"], t["ancestor_max"], t["spread"])
        S.families = [gen.family(gen.sub_seed(env.seed, 1, f), t["members"], int(anc[f]),
                                 t["sub_rate"], t["del_rate"], t["ins_rate"]) for f in range(F)]
        rows, amap = [], {}
        for f, fam in enumerate(S.families):
            amap[f"fam{f}"] = {}
            for s, m in enumerate(fam):
                rows.append({"alignment_id": f"fam{f}", "sequence_id": s,
                             "structure": m.structure, "sequence": m.sequence})
                amap[f"fam{f}"][str(s)] = {c: {str(p): a for p, a in pos.items()} for c, pos in
                                           rt.member_map(m.structure, m.posmap).items()}
    with env.stage("graphs"):
        S.ds = AlignmentDataset(Table(["alignment_id", "sequence_id", "structure", "sequence"],
                                      rows), amap, cfg["graph_encoding"], cfg["seq_weight"],
                                "structure")
    with env.stage("weights"):
        S.params, S.mstate = weights.make(cfg, gen.sub_seed(env.seed, 2), dev, trained=False)
    with env.stage("train_state"):  # the first Adam imports torch._dynamo
        S.ts = TrainState.create(S.params, S.mstate, cfg["learning_rate"])
        S.step = make_train_step(GINConfig.from_metadata(cfg), alignment_loss_fn(
            AlignmentLossConfig(margin=cfg["alignment_margin"],
                                temperature=cfg["alignment_temperature"])))
        S.dropout_seed = gen.sub_seed(env.seed, 3)
        S.gen = torch.Generator(device=dev).manual_seed(S.dropout_seed)
        S.rng = np.random.default_rng(gen.sub_seed(env.seed, 4))
    S.cursor, S.perm, S.first, S.before, S.snap = 0, None, [], [], None
    with env.stage("first_steps"):
        for k in range(t["checked_steps"]):
            S.before.append({p: v.detach().clone() for p, v in weights.leaves(S.ts.params)})
            w = call(S, env)
            S.first.append({"groups": S.last_groups, "rng": S.last_rng, "loss": S.last_loss})
            if k == 0:
                opt = S.ts.optimizer.state
                S.first_grad = {p: (opt[leaf]["exp_avg"] / (1.0 - B1)).clone() if leaf in opt
                                else None for p, leaf in weights.leaves(S.ts.params)}
        S.after = {p: leaf.detach().clone() for p, leaf in weights.leaves(S.ts.params)}
        for rec in S.first:
            rec["loss"] = float(rec["loss"])
        del w
        S.names, S.live = zip(*weights.leaves(S.ts.params))
        opt = S.ts.optimizer.state
        S.moved = [k for k, leaf in enumerate(S.live) if leaf in opt]
        S.snap = ([v.detach().clone() for v in S.live],
                  [opt[S.live[k]]["exp_avg"].clone() for k in S.moved],
                  [opt[S.live[k]]["exp_avg_sq"].clone() for k in S.moved])
    return S


def _snapshot(S) -> dict:
    """The state the next step starts from: the parameters and Adam's
    moments copied into ``S.snap``; the rest returned."""
    opt = S.ts.optimizer.state
    moved = [S.live[k] for k in S.moved]
    torch._foreach_copy_(S.snap[0], [v.detach() for v in S.live])
    if moved:
        torch._foreach_copy_(S.snap[1], [opt[v]["exp_avg"] for v in moved])
        torch._foreach_copy_(S.snap[2], [opt[v]["exp_avg_sq"] for v in moved])
    return {"t": int(opt[moved[0]]["step"]) if moved else 0, "mstate": S.ts.model_state,
            "gen": S.gen.get_state()}


def epoch_order(lengths: np.ndarray, batch: int, rng) -> np.ndarray:
    """The families of one epoch in batches of ``batch``: the families cut
    by ancestor length into ``batch`` strata, each stratum shuffled, and
    batch ``k`` taking the ``k``-th family of every stratum, so that every
    batch holds about the same number of nodes whatever the seed."""
    strata = np.argsort(lengths, kind="stable").reshape(batch, -1)
    strata = np.stack([rng.permutation(s) for s in strata])
    return strata.T.reshape(-1)


def call(S, env) -> Work:
    t, cfg = env.traffic, env.config
    F, B = len(S.families), t["batch_groups"]
    if S.cursor % F == 0:
        S.perm = epoch_order(S.lengths, B, S.rng)
    groups = [int(g) for g in S.perm[S.cursor % F:S.cursor % F + B]]
    S.cursor += len(groups)
    S.last_groups, S.last_rng = groups, S.rng.bit_generator.state
    with env.span("train.assembly"):
        batch = assemble_alignment_batch(
            [S.ds.groups[g] for g in groups], cfg["alignment_unaligned_per_graph"], S.rng,
            max_negatives=cfg["alignment_max_negatives"],
            hard_negative_fraction=cfg["hard_negative_fraction"])
    with env.span("train.upload"):
        on_dev = batch.to(env.device)
    if S.snap is not None:
        S.late = dict(_snapshot(S), groups=groups, rng=S.last_rng)
    with env.span("train.step", device_events=True):
        S.ts, S.last_loss = S.step(S.ts, on_dev, S.gen)
    rows, subset = float(batch.graphs.node_mask.sum()), float(batch.valid.sum())
    graphs = int((batch.graphs.n_nodes > 0).sum())
    return Work(graphs, {"train_flops": gine_counts.train_step_flops(cfg, rows, subset)})


def end_to_end(units: int, seconds: float) -> dict:
    return {"train_graphs_per_s": units / seconds}


def _step_loss(S, env, rec: dict, state: dict, dtype, drop_gen):
    """The loss of the step ``rec`` (its groups and the host generator's
    state before its batch) as a function of the parameters, in
    ``dtype``: the forgi graphs and the mined subset built again, the
    dropout drawn from ``drop_gen``."""
    cfg, dev = env.config, env.device
    members, graphs = [], []
    for gi, g in enumerate(rec["groups"]):
        for m in S.families[g]:
            graphs.append(rg.forgi_graph(m.structure))
            members.append((gi, m))
    b = ref.flat_batch(graphs, dev, dtype)
    n_pad = padded_rows(int(b["sizes"].sum()))
    keep = 1.0 - cfg["dropout"]

    def dropout(h):  # the draws are float32 whatever the reference's dtype
        mask = torch.rand((n_pad, h.shape[1]), generator=drop_gen, dtype=torch.float32,
                          device=dev)[:h.shape[0]] < keep
        return torch.where(mask, h / keep, 0.0)

    rng = np.random.default_rng()
    rng.bit_generator.state = rec["rng"]
    sub = rt.mined_subset(
        [(gi, int(off), *rt.annotations(rt.member_map(m.structure, m.posmap)))
         for (gi, m), off in zip(members, b["offsets"])],
        cfg["alignment_unaligned_per_graph"], cfg["alignment_max_negatives"],
        cfg["hard_negative_fraction"], rng)
    index = torch.as_tensor(sub["index"], device=dev)

    def loss_at(params):
        x = ref.node_norm(cfg, state, ref.encode(cfg, params, b, dropout))
        return rt.contrastive_loss(x[index], sub, cfg["alignment_temperature"],
                                   cfg["alignment_margin"])

    return loss_at


def _grad_step(S, leaves: dict, loss_at, adam, tf32: bool):
    """The loss at ``leaves``, its gradients, and one Adam step on them."""
    with matmul(tf32):
        loss = loss_at(_tree(S.params, leaves))
        names = list(leaves)
        grads = dict(zip(names, torch.autograd.grad(loss, [leaves[p] for p in names],
                                                    allow_unused=True)))
    adam.step(leaves, grads)
    return float(loss.detach()), {p: None if g is None else g.detach() for p, g in grads.items()}


def _reference_steps(S, env, tf32: bool, dtype=torch.float32, follow=None) -> dict:
    """The reference's checked steps in ``dtype``: its own losses, first
    gradients, parameters before each step and after the last; with
    ``follow`` (parameters before each step of another run), also the loss
    of each step at those parameters, on the same batch and dropout
    draws."""
    cfg, dev = env.config, env.device
    leaves = {p: v.detach().to(dtype, copy=True).requires_grad_(True)
              for p, v in weights.leaves(S.params)}
    state = {k: v.detach().to(dtype) for k, v in S.mstate.items()}
    adam = rt.Adam(cfg["learning_rate"])
    drop_gen = torch.Generator(device=dev).manual_seed(S.dropout_seed)
    out = {"loss": [], "followed": [], "before": [], "first": None}
    for k, rec in enumerate(S.first):
        loss_at = _step_loss(S, env, rec, state, dtype, drop_gen)
        out["before"].append({p: v.detach().clone() for p, v in leaves.items()})
        if follow is not None:
            draws = drop_gen.get_state()
            with torch.no_grad(), matmul(tf32):
                there = {p: v.to(dtype) for p, v in follow[k].items()}
                out["followed"].append(float(loss_at(_tree(S.params, there))))
            drop_gen.set_state(draws)
        loss, grads = _grad_step(S, leaves, loss_at, adam, tf32)
        if out["first"] is None:
            out["first"] = grads
        out["loss"].append(loss)
    out["after"] = {p: v.detach() for p, v in leaves.items()}
    return out


def _reference_late(S, env, tf32: bool, dtype=torch.float32) -> dict:
    """The window's last step in ``dtype`` from the program's state before
    it (``S.snap``, ``S.late``): its loss, gradients and each parameter's
    change."""
    cfg, late = env.config, S.late
    start = {p: v.to(dtype, copy=True) for p, v in zip(S.names, S.snap[0])}
    leaves = {p: v.clone().requires_grad_(True) for p, v in start.items()}
    adam = rt.Adam(cfg["learning_rate"])
    adam.t = late["t"]
    for k, m, v in zip(S.moved, S.snap[1], S.snap[2]):
        adam.m[S.names[k]], adam.v[S.names[k]] = m.to(dtype), v.to(dtype)
    drop_gen = torch.Generator(device=env.device)
    drop_gen.set_state(late["gen"])
    state = {k: v.detach().to(dtype) for k, v in late["mstate"].items()}
    loss, grads = _grad_step(S, leaves, _step_loss(S, env, late, state, dtype, drop_gen),
                             adam, tf32)
    return {"loss": loss, "grads": grads,
            "change": {p: leaves[p].detach() - start[p] for p in leaves}}


def _tree(like, leaves: dict, path=()):
    """``like``'s tree with its leaves taken from ``leaves`` by path."""
    if isinstance(like, dict):
        return {k: _tree(v, leaves, path + (str(k),)) for k, v in like.items()}
    if isinstance(like, list):
        return [_tree(v, leaves, path + (str(i),)) for i, v in enumerate(like)]
    return leaves["/".join(path)]


def _norm(v) -> float:
    return 0.0 if v is None else float(torch.linalg.vector_norm(v.double()))


def leaf_gaps(prog: dict, want: dict, names) -> list:
    """Per leaf, the gap of the program's norm to the reference's over the
    larger of the reference's norm of that leaf and of the median leaf."""
    ref_norms = {p: _norm(want[p]) for p in names}
    med = float(np.median(list(ref_norms.values())))
    return [abs(_norm(prog[p]) - ref_norms[p]) / max(ref_norms[p], med, 1e-30) for p in names]


def check(S, env, control: bool = False) -> dict:
    start = {p: v.detach() for p, v in weights.leaves(S.params)}
    prog = {"loss": [r["loss"] for r in S.first], "first": S.first_grad, "after": S.after,
            "before": S.before}
    late_prog = {"loss": float(S.last_loss),
                 "change": {p: v.detach().double() - b.double()
                            for p, v, b in zip(S.names, S.live, S.snap[0])}}
    del S.ts, S.step, S.last_loss, S.live
    if env.device.type == "cuda":
        torch.cuda.empty_cache()
    if control:
        prog = _reference_steps(S, env, tf32=True)
        late_prog = _reference_late(S, env, tf32=True)
    want = _reference_steps(S, env, tf32=False, dtype=torch.float64, follow=prog["before"])
    late = _reference_late(S, env, tf32=False, dtype=torch.float64)
    moving = _moving(want["first"])
    late_moving = _moving(late["grads"])
    change = lambda a: {p: a[p].double() - start[p].double() for p in moving}
    gaps = {
        "grad": leaf_gaps(prog["first"], want["first"], list(_moving(want["first"], 0.0))),
        "change": leaf_gaps(change(prog["after"]), change(want["after"]), moving),
        "late_change": leaf_gaps(late_prog["change"], late["change"], late_moving),
    }
    env.notes.update({f"{k}_worst": max(v) for k, v in gaps.items()})
    return {
        "loss_gap": max(abs(a - b) / max(abs(b), 1e-30)
                        for a, b in zip(prog["loss"], want["followed"])),
        "grad_gap": float(np.median(gaps["grad"])),
        "change_gap": float(np.median(gaps["change"])),
        "late_loss_gap": abs(late_prog["loss"] - late["loss"]) / max(abs(late["loss"]), 1e-30),
        "late_change_gap": float(np.median(gaps["late_change"])),
    }


def _moving(grads: dict, share: float = 1e-3) -> list:
    """The leaves whose reference gradient reaches ``share`` of the median
    leaf's (those under it move by round-off alone under Adam)."""
    norms = {p: _norm(g) for p, g in grads.items() if g is not None}
    med = float(np.median(list(norms.values())))
    return [p for p, n in norms.items() if n >= share * med]
