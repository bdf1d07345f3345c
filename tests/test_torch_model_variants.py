"""The rest of the model in inference mode against the JAX package on the
CPU: layer, instance and batch norm (with running statistics that are
not ``init_params``' 0 and 1) and Set2Set pooling.

``forward_once`` and ``get_node_embeddings`` of the port are held to the
JAX package's within 1e-5, or, where GraphNorm-like normalisation
amplifies float32 order beyond that, to no farther than twice the JAX
result from a float64 run of the port (the rule of
``tests/test_torch_graph_embed.py``).  That float64 run is in turn held
to an independent oracle written here from the layers' definitions, in
float64 and one graph at a time with torch's own ``instance_norm``,
``batch_norm`` and ``nn.LSTM``, reading the weights from the exported
reference ``.pth``.  ``tests/torch_oracle.py`` covers GraphNorm with add
and mean pooling only, so it serves the forgi tests, not these.  The
checkpoint round trips (``.pth`` both ways, the JAX package's native
``.zip``) carry every tensor exactly."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from test_torch_graph_embed import _batch64, _float64, _hold

from ginfinity_tpu.graphs import batching as jbatching
from ginfinity_tpu.graphs import build as jbuild
from ginfinity_tpu.models import gine as jgine
from ginfinity_tpu.models.checkpoint import export_torch_checkpoint as jexport
from ginfinity_tpu.models.checkpoint import import_torch_checkpoint as jimport
from ginfinity_tpu.models.checkpoint import save_checkpoint as jsave
from ginfinity_tpu.models.gine import GINConfig as JConfig
from ginfinity_tpu.models.gine import GINModel as JModel
from ginfinity_tpu.pipelines.msa_eval import random_structure
from ginfinity_tpu_torch.graphs import batching, build
from ginfinity_tpu_torch.models import gine
from ginfinity_tpu_torch.models.checkpoint import (
    export_torch_checkpoint,
    load_checkpoint,
    params_from_jax,
)
from ginfinity_tpu_torch.models.gine import GINConfig, GINModel

BASE = dict(hidden_dim=32, output_dim=24, gin_layers=2, node_embed_norm="zscore_l2",
            use_residual=True)
CASES = {
    "layer_mean": dict(norm_type="layer", pooling_type="global_mean_pool",
                       normalize_nodes_before_pool=True),
    "instance_add": dict(norm_type="instance", pooling_type="global_add_pool",
                         node_embed_norm="l2"),
    "batch_mean_no_dropout": dict(norm_type="batch", pooling_type="global_mean_pool",
                                  dropout=0.0),
    "graph_set2set": dict(norm_type="graph", pooling_type="set2set",
                          normalize_nodes_before_pool=True),
    "batch_set2set_32_48": dict(norm_type="batch", pooling_type="set2set",
                                hidden_dim=[32, 48]),
    "layer_set2set_forgi": dict(norm_type="layer", pooling_type="set2set",
                                graph_encoding="forgi"),
}


def _kw(case):
    return {**BASE, **CASES[case]}


def _jax_tree(case, seed=2):
    """JAX parameters and state with non-trivial norm affines, running
    statistics and node statistics."""
    jc = JConfig.create(**_kw(case))
    params, state = jgine.init_params(jax.random.PRNGKey(seed), jc)
    rng = np.random.default_rng(seed)
    f32 = lambda a: jnp.asarray(np.asarray(a, np.float32))
    params = dict(params)
    params["norms"] = [{k: f32((1.0 if k != "bias" else 0.0) + 0.3 * rng.normal(size=v.shape))
                        for k, v in n.items()} for n in params["norms"]]
    state = dict(state)
    h = jc.hidden_dims[-1]
    state["node_mu"] = f32(0.1 * rng.normal(size=h))
    state["node_sigma"] = f32(1.0 + rng.random(h))
    if "batch_norms" in state:
        state["batch_norms"] = [
            {"running_mean": f32(0.5 * rng.normal(size=d)),
             "running_var": f32(0.3 + 2.0 * rng.random(d))} for d in jc.hidden_dims]
    return jc, params, state


def _models(case, seed=2):
    jc, params, state = _jax_tree(case, seed)
    pc = GINConfig.create(**_kw(case))
    pp, ps = params_from_jax(pc, jax.tree_util.tree_map(np.asarray, params),
                             jax.tree_util.tree_map(np.asarray, state))
    return (jc, params, state), JModel(jc, params, state), GINModel(pc, pp, ps)


def _structures(seed=9, n=10):
    rng = np.random.default_rng(seed)
    return [random_structure(rng, int(k)) for k in rng.integers(15, 130, size=n)] + \
        ["((..[[..))..]]..", "(.(...))", "..."]


STRUCTURES = _structures()


def _batches(case, structs=STRUCTURES, pad=(29, 41, 3)):
    enc = _kw(case).get("graph_encoding", "standard")
    pg = [build.build_graph_arrays(s, graph_encoding=enc) for s in structs]
    jg = [jbuild.build_graph_arrays(s, graph_encoding=enc) for s in structs]
    caps = (sum(g.n_nodes for g in pg) + pad[0], sum(g.n_edges for g in pg) + pad[1],
            len(pg) + pad[2])
    return jbatching.batch_graphs(jg, *caps), batching.batch_graphs(pg, *caps), pg


def _oracle(ckpt: str, graphs, nodes: bool = False) -> np.ndarray:
    """The reference model's forward in float64, one graph at a time,
    from the layers' definitions and the ``.pth`` state dict."""
    ck = torch.load(ckpt, map_location="cpu", weights_only=False)
    md, sd = ck["metadata"], {k: v.double() for k, v in ck["state_dict"].items()}
    mlp1 = 3 if md["dropout"] > 0 else 2
    lin = lambda x, p: x @ sd[f"{p}.weight"].T + sd[f"{p}.bias"]
    norm_type = md["norm_type"]

    def node_norm(x):
        mode = md["node_embed_norm"]
        if mode.startswith("zscore"):
            x = (x - sd["node_mu"]) / (sd["node_sigma"] + md["eps"])
        if mode.endswith("l2"):
            x = x / torch.linalg.vector_norm(x, dim=1, keepdim=True).clamp(min=md["eps"])
        return x

    out = []
    for g in graphs:
        x = lin(torch.from_numpy(g.node_feat).double(), "node_encoder")
        src, dst = torch.from_numpy(g.edge_src).long(), torch.from_numpy(g.edge_dst).long()
        ea = torch.from_numpy(g.edge_attr).double()
        for i in range(md["gin_layers"]):
            h_in = x
            msg = F.relu(x[src] + lin(ea, f"convs.{i}.lin"))
            h = (1 + sd[f"convs.{i}.eps"]) * x + torch.zeros_like(x).index_add_(0, dst, msg)
            h = F.relu(lin(F.relu(lin(h, f"convs.{i}.nn.0")), f"convs.{i}.nn.{mlp1}"))
            if norm_type == "graph":
                o = h - h.mean(0) * sd[f"norms.{i}.mean_scale"]
                h = sd[f"norms.{i}.weight"] * o / (o.pow(2).mean(0) + 1e-5).sqrt() + \
                    sd[f"norms.{i}.bias"]
            elif norm_type == "layer":
                o = h - h.mean()
                h = o / (o.pow(2).mean() + 1e-5).sqrt() * sd[f"norms.{i}.weight"] + \
                    sd[f"norms.{i}.bias"]
            elif norm_type == "instance":
                h = F.instance_norm(h.T[None], eps=1e-5)[0].T
            elif norm_type == "batch":
                p = f"norms.{i}.module"
                h = F.batch_norm(h, sd[f"{p}.running_mean"], sd[f"{p}.running_var"],
                                 sd[f"{p}.weight"], sd[f"{p}.bias"], training=False, eps=1e-5)
            if md["use_residual"] and h.shape == h_in.shape:
                h = h + h_in
            x = h
        if nodes:
            out.append(node_norm(x))
            continue
        if md["normalize_nodes_before_pool"]:
            x = node_norm(x)
        if md["pooling_type"] == "set2set":
            d = x.shape[1]
            lstm = torch.nn.LSTM(2 * d, d).double()
            with torch.no_grad():
                for k in ("weight_ih_l0", "weight_hh_l0", "bias_ih_l0", "bias_hh_l0"):
                    getattr(lstm, k).copy_(sd[f"pooling.lstm.{k}"])
                q_star, hc = torch.zeros(1, 1, 2 * d, dtype=x.dtype), None
                for _ in range(2):
                    q, hc = lstm(q_star, hc)
                    a = torch.softmax((x * q.view(1, d)).sum(1), 0)
                    q_star = torch.cat([q.view(d), (a[:, None] * x).sum(0)]).view(1, 1, 2 * d)
            pooled = q_star.view(2 * d)
        elif md["pooling_type"] == "global_mean_pool":
            pooled = x.mean(0)
        else:
            pooled = x.sum(0)
        out.append(lin(pooled[None], "fc")[0])
    return torch.cat(out).numpy() if nodes else torch.stack(out).numpy()


@pytest.mark.parametrize("case", list(CASES))
def test_forward_once_matches_jax_and_oracle(case, tmp_path):
    (jc, jp, js), jm, pm = _models(case)
    jbatch, batch, graphs = _batches(case)
    ref = np.asarray(jm.forward_once(jbatch))
    got = pm.forward_once(batch).numpy()
    x64 = gine.forward_once(pm.config, _float64(pm.params), _float64(pm.state),
                            _batch64(batch)).numpy()
    assert got.shape == (len(graphs) + 3, 24) and np.isfinite(got).all()
    _hold(got, ref, x64)
    ckpt = str(tmp_path / "m.pth")
    jexport(ckpt, jc, jp, js)
    oracle = _oracle(ckpt, graphs)
    np.testing.assert_allclose(x64[: len(graphs)], oracle, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("case", list(CASES))
def test_node_embeddings_match_jax_and_oracle(case, tmp_path):
    (jc, jp, js), jm, pm = _models(case)
    jbatch, batch, graphs = _batches(case)
    ref = np.asarray(jm.get_node_embeddings(jbatch))
    got = pm.get_node_embeddings(batch).numpy()
    x64 = gine.get_node_embeddings(pm.config, _float64(pm.params), _float64(pm.state),
                                   _batch64(batch)).numpy()
    n = sum(g.n_nodes for g in graphs)
    _hold(got[:n], ref[:n], x64[:n])
    ckpt = str(tmp_path / "m.pth")
    jexport(ckpt, jc, jp, js)
    np.testing.assert_allclose(x64[:n], _oracle(ckpt, graphs, nodes=True), rtol=1e-9,
                               atol=1e-9)


@pytest.mark.parametrize("case", list(CASES))
def test_checkpoint_round_trips_carry_every_tensor(case, tmp_path):
    """JAX ``.pth`` and native ``.zip`` into the port, and the port's
    ``.pth`` into JAX: batch-norm running statistics and the Set2Set LSTM
    included, bit for bit."""
    (jc, jp, js), _, pm = _models(case)

    def flat(tree, prefix=""):
        if isinstance(tree, dict):
            return {k2: v2 for k, v in tree.items() for k2, v2 in flat(v, f"{prefix}{k}.").items()}
        if isinstance(tree, (list, tuple)):
            return {k2: v2 for i, v in enumerate(tree)
                    for k2, v2 in flat(v, f"{prefix}{i}.").items()}
        return {prefix[:-1]: np.asarray(tree)}

    want = flat({"params": pm.params, "state": pm.state})
    assert ("state.batch_norms.1.running_var" in want) == (jc.norm_type == "batch")
    assert ("params.set2set.w_hh" in want) == (jc.pooling_type == "set2set")
    for name, writer in (("m.pth", jexport), ("m.zip", jsave)):
        path = str(tmp_path / name)
        writer(path, jc, jp, js)
        cfg, params, state, _ = load_checkpoint(path)
        assert cfg == pm.config
        got = flat({"params": GINModel(cfg, params, state).params,
                    "state": GINModel(cfg, params, state).state})
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    back = str(tmp_path / "port.pth")
    export_torch_checkpoint(back, pm.config, pm.params, pm.state)
    _, jp2, js2, _ = jimport(back)
    assert flat({"params": jp2, "state": js2}).keys() == want.keys()
    for k, v in flat({"params": jp2, "state": js2}).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)


@pytest.mark.parametrize("case", list(CASES))
def test_init_params_has_the_jax_tree(case):
    """The port's seeded ``init_params`` gives the JAX package's tree:
    the same keys and shapes, the LSTM and a ``2 x last`` ``fc`` for
    Set2Set, running statistics 0 and 1 for batch norm."""
    jc = JConfig.create(**_kw(case))
    jp, js = jgine.init_params(jax.random.PRNGKey(0), jc)
    pp, ps = gine.init_params(torch.Generator().manual_seed(0), GINConfig.create(**_kw(case)))
    shapes = lambda t: jax.tree_util.tree_map(lambda a: tuple(np.shape(a)), t)
    assert shapes(pp) == shapes(jp) and shapes(ps) == shapes(js)
    for bn in ps.get("batch_norms", []):
        assert bn["running_mean"].eq(0).all() and bn["running_var"].eq(1).all()


def test_model_registers_state_and_lstm_on_the_module():
    """Running statistics are buffers and the LSTM frozen parameters, so
    ``.to(...)`` moves them with the rest."""
    _, _, pm = _models("batch_set2set_32_48")
    buffers = dict(pm.named_buffers())
    assert {"batch_norms__0__running_mean", "batch_norms__1__running_var", "node_mu"} <= \
        set(buffers)
    params = dict(pm.named_parameters())
    assert {"set2set__w_ih", "set2set__b_hh"} <= set(params)
    assert not any(p.requires_grad for p in params.values())
    moved = pm.to(torch.float64)
    assert moved.state["batch_norms"][1]["running_var"].dtype == torch.float64
    assert moved.params["set2set"]["w_ih"].dtype == torch.float64


def test_set2set_empty_graphs_read_zero_not_nan():
    """Graph slots without a real node (padding) and the trash segment
    give finite Set2Set states: the attention read-out is 0."""
    _, _, pm = _models("graph_set2set")
    _, batch, graphs = _batches("graph_set2set", STRUCTURES[:3], pad=(5, 5, 4))
    x = gine.get_node_embeddings(pm.config, pm.params, pm.state, batch)
    q_star = gine._set2set(pm.params, x, batch)
    assert q_star.shape == (batch.num_graphs + 1, 64) and torch.isfinite(q_star).all()
    assert q_star[len(graphs):, 32:].abs().max().item() == 0.0


def test_train_mode_raises_naming_item_10():
    """Train mode, once refused naming ROADMAP item 10, is its own entry
    (``forward_once_train``) and the inference forward takes no ``train``
    flag.  Layer norm has no batch statistics, so at dropout 0 train mode
    gives the inference output bit for bit and leaves the state as it
    was."""
    _, _, pm = _models("layer_mean")
    _, batch, _ = _batches("layer_mean", STRUCTURES[:2])
    with pytest.raises(TypeError, match="train"):
        gine.forward_once(pm.config, pm.params, pm.state, batch, train=True)
    cfg = dataclasses.replace(pm.config, dropout=0.0)
    out, state = gine.forward_once_train(cfg, pm.params, pm.state, batch,
                                         torch.Generator().manual_seed(0))
    assert torch.equal(out, gine.forward_once(cfg, pm.params, pm.state, batch))
    before = pm.state
    assert state.keys() == before.keys() and all(
        torch.equal(state[k], before[k]) for k in state)
