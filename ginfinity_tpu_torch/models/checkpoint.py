"""Checkpoint I/O in the reference ``.pth`` layout, the JAX package's
native ``.zip`` reader, and the carry from a JAX parameter tree.

Port of ``ginfinity_tpu/models/checkpoint.py``.  A ``.pth`` holds
``{metadata, state_dict}`` in the reference key layout: the second
conv-MLP linear lives at ``nn.3`` when dropout > 0 (a Dropout module
occupies ``nn.2``) and at ``nn.2`` otherwise; torch ``[out, in]``
weights are transposed to the ``[in, out]`` kernel layout.
"""

from __future__ import annotations

import io
import json
import os
import zipfile

import numpy as np
import torch

from ginfinity_tpu_torch.models.gine import GINConfig, Params, State, listify


def _mlp1_key(i: int, dropout: float) -> str:
    return f"convs.{i}.nn.{3 if dropout > 0 else 2}"


def _norm_keys(config: GINConfig, i: int) -> dict[str, str]:
    """Parameter name -> state-dict key of layer ``i``'s norm."""
    if config.norm_type == "graph":
        return {k: f"norms.{i}.{k}" for k in ("weight", "bias", "mean_scale")}
    if config.norm_type == "layer":
        return {k: f"norms.{i}.{k}" for k in ("weight", "bias")}
    if config.norm_type == "batch":
        return {k: f"norms.{i}.module.{k}" for k in ("weight", "bias")}
    return {}


def _tree_from_state_dict(config: GINConfig, sd: dict) -> tuple[Params, State]:
    def t(key):
        return torch.as_tensor(np.asarray(sd[key], np.float32))

    def lin(prefix: str) -> dict:
        return {"kernel": t(f"{prefix}.weight").T.contiguous(), "bias": t(f"{prefix}.bias")}

    params: Params = {"node_encoder": lin("node_encoder")}
    params["convs"] = [
        {
            "eps": t(f"convs.{i}.eps").reshape(1),
            "mlp0": lin(f"convs.{i}.nn.0"),
            "mlp1": lin(_mlp1_key(i, config.dropout)),
            "edge_lin": lin(f"convs.{i}.lin"),
        }
        for i in range(config.gin_layers)
    ]
    params["norms"] = [
        {k: t(key) for k, key in _norm_keys(config, i).items()}
        for i in range(config.gin_layers)
    ]
    if config.pooling_type == "set2set":
        params["set2set"] = {
            "w_ih": t("pooling.lstm.weight_ih_l0"),
            "w_hh": t("pooling.lstm.weight_hh_l0"),
            "b_ih": t("pooling.lstm.bias_ih_l0"),
            "b_hh": t("pooling.lstm.bias_hh_l0"),
        }
    params["fc"] = lin("fc")
    state: State = {"node_mu": t("node_mu"), "node_sigma": t("node_sigma")}
    if config.norm_type == "batch":
        state["batch_norms"] = [
            {
                "running_mean": t(f"norms.{i}.module.running_mean"),
                "running_var": t(f"norms.{i}.module.running_var"),
            }
            for i in range(config.gin_layers)
        ]
    return params, state


def import_torch_checkpoint(path: str) -> tuple[GINConfig, Params, State, dict]:
    """Load a reference ``.pth`` checkpoint into (config, params, state,
    extra), applying the loader's metadata fallbacks.  Tensors land on
    the CPU."""
    # weights_only=False as the reference's own loader: its metadata
    # may hold plain Python objects beyond tensors
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    config = GINConfig.from_metadata(dict(ckpt["metadata"]))
    sd = {k: v.detach().cpu().numpy() for k, v in ckpt["state_dict"].items()}
    params, state = _tree_from_state_dict(config, sd)
    extra = {k: ckpt[k] for k in ("epoch",) if k in ckpt}
    return config, params, state, extra


def export_torch_checkpoint(
    path: str,
    config: GINConfig,
    params: Params,
    state: State,
    epoch: int | None = None,
):
    """Write a checkpoint the reference's ``GINModel.load_from_checkpoint``
    can read (the same state-dict key layout)."""
    def c(v):
        return torch.as_tensor(v, dtype=torch.float32).detach().cpu().clone()

    sd: dict = {"node_mu": c(state["node_mu"]), "node_sigma": c(state["node_sigma"])}

    def put_lin(prefix: str, p: dict):
        sd[f"{prefix}.weight"] = c(p["kernel"]).T.contiguous()
        sd[f"{prefix}.bias"] = c(p["bias"])

    put_lin("node_encoder", params["node_encoder"])
    for i, conv in enumerate(params["convs"]):
        sd[f"convs.{i}.eps"] = c(conv["eps"]).reshape(1)
        put_lin(f"convs.{i}.nn.0", conv["mlp0"])
        put_lin(_mlp1_key(i, config.dropout), conv["mlp1"])
        put_lin(f"convs.{i}.lin", conv["edge_lin"])
    for i, norm in enumerate(params["norms"]):
        for k, key in _norm_keys(config, i).items():
            sd[key] = c(norm[k])
        if config.norm_type == "batch":
            bn = state["batch_norms"][i]
            sd[f"norms.{i}.module.running_mean"] = c(bn["running_mean"])
            sd[f"norms.{i}.module.running_var"] = c(bn["running_var"])
            sd[f"norms.{i}.module.num_batches_tracked"] = torch.tensor(0)
    if config.pooling_type == "set2set":
        s2s = params["set2set"]
        sd["pooling.lstm.weight_ih_l0"] = c(s2s["w_ih"])
        sd["pooling.lstm.weight_hh_l0"] = c(s2s["w_hh"])
        sd["pooling.lstm.bias_ih_l0"] = c(s2s["b_ih"])
        sd["pooling.lstm.bias_hh_l0"] = c(s2s["b_hh"])
    put_lin("fc", params["fc"])

    ckpt = {"metadata": config.to_metadata(), "state_dict": sd}
    if epoch is not None:
        ckpt["epoch"] = epoch
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save(ckpt, path)


def params_from_jax(config: GINConfig, params_np: dict, state_np: dict) -> tuple[Params, State]:
    """Carry a JAX parameter tree and state, given as numpy arrays (for
    example ``jax.tree.map(np.asarray, params)``), into the port's
    tensors.  The two share the tree layout, so this is a leafwise copy
    into float32 CPU tensors."""
    def carry(tree):
        if isinstance(tree, dict):
            return {k: carry(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [carry(v) for v in tree]
        return torch.tensor(np.asarray(tree, np.float32))

    if len(params_np["convs"]) != config.gin_layers:
        raise ValueError(
            f"parameter tree has {len(params_np['convs'])} layers, config {config.gin_layers}"
        )
    return carry(params_np), carry(state_np)


def load_checkpoint(path: str) -> tuple[GINConfig, Params, State, dict]:
    """A reference ``.pth``/``.pt``, or the JAX package's native ``.zip``
    (``metadata.json`` + ``arrays.npz`` of dotted keys)."""
    if path.endswith(".pth") or path.endswith(".pt"):
        return import_torch_checkpoint(path)
    with zipfile.ZipFile(path, "r") as z:
        md = json.loads(z.read("metadata.json"))
        with np.load(io.BytesIO(z.read("arrays.npz"))) as npz:
            flat = {k: npz[k] for k in npz.files}
    root: dict = {}
    for key, value in flat.items():
        parts = key.split(".")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value

    tree = listify(root)
    config = GINConfig.from_metadata({k: v for k, v in md.items() if k != "extra"})
    params, state = params_from_jax(config, tree["params"], tree["state"])
    # layers whose norm has no parameters leave no keys in the archive
    params["norms"] = params.get("norms", []) + [{}] * (
        config.gin_layers - len(params.get("norms", []))
    )
    return config, params, state, md.get("extra", {})
