"""``ginfinity-train`` on PyTorch: train a GIN model on RNA secondary
structures.

    python -m ginfinity_tpu_torch.training.train_cli --input_path data.tsv \
        --training_mode triplet [--device cpu]

Port of ``ginfinity_tpu/training/train_cli.py`` with every flag: the
three training modes, Adam with per-epoch multiplicative LR decay, early
stopping with best-weights restore, the initial fractional evaluation,
multi-round JSON schedules with checkpoint chaining and keep/delete
weights, Ctrl-C with the interactive best-weights save,
``--diagnostic-alignment`` PNGs, ``--fit-node-stats``, and
``--save-every``/``--resume-from`` (``torch.save`` files in place of
orbax, the last 3 kept).  Runs on the card unless ``--device cpu``.
Without pandas: the dataset is read by ``utils/io.py::read_table`` and
grouped, sampled and split as the JAX CLI's pandas calls do it.  The
saved checkpoint is the reference's ``.pth``.
"""

from __future__ import annotations

import argparse
import glob
import json
import math
import os
import random
import re
import time

import numpy as np
import torch

from ginfinity_tpu_torch.models.gine import init_params
from ginfinity_tpu_torch.utils.device import disable_tf32, resolve_device
from ginfinity_tpu_torch.utils.io import Table, log_information, log_setup, read_table


# --------------------------------------------------------------------------
# Schedule parsing
# --------------------------------------------------------------------------


def read_schedule(schedule_path: str) -> dict:
    with open(schedule_path, "r", encoding="utf-8") as handle:
        data = json.load(handle)
    if isinstance(data, list):
        data = {"start_from_round": 1, "checkpoint": None, "rounds": data}
    elif not isinstance(data, dict) or "rounds" not in data:
        raise ValueError("Schedule JSON must contain a 'rounds' list.")

    start_from_round = data.get("start_from_round", 1)
    if not isinstance(start_from_round, int) or start_from_round < 1:
        raise ValueError("'start_from_round' must be an integer >= 1.")
    checkpoint = data.get("checkpoint")
    if checkpoint is not None:
        checkpoint = os.path.expandvars(os.path.expanduser(str(checkpoint).strip()))
        if not os.path.isfile(checkpoint):
            raise FileNotFoundError(f"Checkpoint file not found: {checkpoint}")

    rounds = []
    seen = set()
    for index, raw in enumerate(data["rounds"]):
        if not isinstance(raw, dict) or "round" not in raw:
            raise ValueError(f"Schedule entry at index {index} is invalid.")
        rnum = raw["round"]
        if not isinstance(rnum, int) or rnum < 1 or rnum in seen:
            raise ValueError(f"Bad round number at index {index}.")
        seen.add(rnum)

        dataset_path = next((raw[k] for k in ("input", "input_path", "dataset", "input_tsv")
                             if k in raw), None)
        if not dataset_path:
            raise ValueError(f"Schedule round {rnum} must include an 'input' dataset path.")
        dataset_path = os.path.expandvars(os.path.expanduser(dataset_path.strip()))
        if not os.path.isfile(dataset_path):
            raise FileNotFoundError(f"Dataset for round {rnum} not found: {dataset_path}")

        map_path = next((raw[k] for k in ("alignment_map", "alignment_map_path") if k in raw),
                        None)
        if not map_path:
            raise ValueError(f"Schedule round {rnum} must include an 'alignment_map' path.")
        map_path = os.path.expandvars(os.path.expanduser(map_path.strip()))
        if not os.path.isfile(map_path):
            raise FileNotFoundError(f"Alignment map for round {rnum} not found: {map_path}")
        with open(map_path, "r", encoding="utf-8") as h:
            json.load(h)

        for field, cond in (
            ("patience", lambda v: isinstance(v, int) and v >= 1),
            ("decay_rate", lambda v: isinstance(v, (int, float)) and not isinstance(v, bool)
             and v > 0),
            ("keep_weights", lambda v: isinstance(v, bool)),
        ):
            if field not in raw or not cond(raw[field]):
                raise ValueError(f"Schedule round {rnum} must define a valid '{field}'.")
        epochs = next((raw[k] for k in ("epochs", "num_epochs") if k in raw), None)
        if not isinstance(epochs, int) or epochs < 1:
            raise ValueError(f"Schedule round {rnum} must define 'epochs' >= 1.")
        lr = next((raw[k] for k in ("learning_rate", "lr") if k in raw), None)
        if lr is None or isinstance(lr, bool) or not isinstance(lr, (int, float)) or float(lr) <= 0:
            raise ValueError(f"Schedule round {rnum} must define 'learning_rate' > 0.")

        rounds.append(
            {
                "round": rnum,
                "dataset_path": dataset_path,
                "alignment_map_path": map_path,
                "patience": raw["patience"],
                "num_epochs": epochs,
                "lr": float(lr),
                "decay_rate": float(raw["decay_rate"]),
                "keep_weights": raw["keep_weights"],
                "raw": raw,
            }
        )

    if not rounds:
        raise ValueError("Schedule file does not contain any training rounds.")
    rounds.sort(key=lambda r: r["round"])
    for expected, r in enumerate(rounds, start=1):
        if r["round"] != expected:
            raise ValueError("Schedule rounds must be sequential starting at 1.")
    if start_from_round > len(rounds):
        raise ValueError("'start_from_round' exceeds total rounds.")
    if start_from_round > 1 and checkpoint is None:
        raise ValueError("'checkpoint' must be provided when 'start_from_round' > 1.")
    return {"rounds": rounds, "start_from_round": start_from_round, "checkpoint": checkpoint}


# --------------------------------------------------------------------------
# Dataset preparation: the JAX CLI's pandas calls, on table rows
# --------------------------------------------------------------------------


def _sample_rows(rows: list, n: int, seed: int) -> list:
    """``DataFrame.sample(n=n, random_state=seed)``: ``RandomState(seed)``
    chooses ``n`` positions without replacement."""
    picks = np.random.RandomState(seed).choice(len(rows), size=n, replace=False)
    return [rows[i] for i in picks]


def _unique(values: list) -> list:
    """``Series.unique()``: values in order of first appearance, a missing
    value (None) among them."""
    return list(dict.fromkeys(values))


def prepare_dataset(args, dataset_path: str, alignment_map_path):
    """``(table, train_table, val_table, alignment_map, path)``, with the
    rows the JAX CLI's pandas calls choose, in the same order."""
    from ginfinity_tpu_torch.training.data import group_rows, remove_invalid_structures

    path = os.path.expandvars(os.path.expanduser(dataset_path))
    if not os.path.isfile(path):
        raise FileNotFoundError(f"Dataset not found: {path}")
    table = read_table(path, sep="\t", comment="#")

    if args.training_mode == "triplet":
        table = remove_invalid_structures(
            table, ["anchor_structure", "positive_structure", "negative_structure"]
        )
    elif args.training_mode == "regression":
        table = remove_invalid_structures(table, ["anchor_structure", "positive_structure"])
    else:
        table = remove_invalid_structures(table, [args.structure_column])
        # groupby(sort=False).filter(len >= 2): rows keep the file's order
        keep = {k for k, g in group_rows(table.rows, "alignment_id") if len(g) >= 2}
        table = Table(table.columns, [r for r in table.rows if r.get("alignment_id") in keep])
        if not table.rows:
            raise ValueError(
                "No alignments with at least two structures available after preprocessing "
                "the dataset."
            )
    if not table.rows:
        raise ValueError("No data available for training after preprocessing the dataset.")
    columns, rows = table.columns, table.rows

    rng = random.Random(args.seed)
    if args.f_sample_dataset < 1.0:
        if args.training_mode == "alignment":
            # groupby().size(): group sizes by sorted key
            sizes = {k: len(g) for k, g in group_rows(rows, "alignment_id")}
            ids = sorted(k for k, n in sizes.items() if n >= 2)
            rng.shuffle(ids)
            total = sum(sizes[k] for k in ids)
            target = max(2, min(int(total * args.f_sample_dataset + 0.5), total))
            selected, acc = [], 0
            for aid in ids:
                if acc >= target:
                    break
                selected.append(aid)
                acc += sizes[aid]
            if not selected:
                selected.append(ids[0])
            chosen = set(selected)
            rows = [r for r in rows if r.get("alignment_id") in chosen]
        else:
            n = max(1, min(int(len(rows) * args.f_sample_dataset + 0.5), len(rows)))
            rows = _sample_rows(rows, n, args.seed)

    alignment_map = None
    if args.training_mode == "alignment":
        if "alignment_id" not in columns:
            raise ValueError("alignment_id column missing from input for alignment training mode.")
        if not alignment_map_path:
            raise ValueError("alignment_map_path must be provided for alignment training mode.")
        with open(os.path.expandvars(os.path.expanduser(alignment_map_path))) as h:
            alignment_map = json.load(h)
        ids = _unique([r.get("alignment_id") for r in rows])
        perm = np.random.RandomState(args.seed).permutation(len(ids))
        n_val = max(1, int(round(len(ids) * args.val_fraction)))
        val_ids = {ids[i] for i in perm[:n_val]}
        train_rows = [r for r in rows if r.get("alignment_id") not in val_ids]
        val_rows = [r for r in rows if r.get("alignment_id") in val_ids]
    else:
        perm = np.random.RandomState(args.seed).permutation(len(rows))
        n_val = max(1, int(round(len(rows) * args.val_fraction)))
        val_rows = [rows[i] for i in perm[:n_val]]
        train_rows = [rows[i] for i in perm[n_val:]]

    return (Table(columns, rows), Table(columns, train_rows), Table(columns, val_rows),
            alignment_map, path)


# --------------------------------------------------------------------------
# Per-epoch alignment diagnostics: the first two structures of a
# diagnostic dataset, their node embeddings' cosine matrix as a PNG
# under <output>/similarity_matrices/
# --------------------------------------------------------------------------


def resolve_diagnostic_dataset_path() -> str:
    env_override = os.environ.get("GINFINITY_DIAGNOSTIC_ALIGNMENT_PATH")
    if env_override:
        return os.path.abspath(os.path.expanduser(env_override))
    return os.path.abspath(os.path.join(os.getcwd(), "dev", "terts.csv"))


def setup_diagnostic_alignment_context(cfg, log_path: str, output_dir: str, device):
    """A context with the batches of the first two diagnostic structures
    (on ``device``), or None when diagnostics are unavailable (missing or
    unusable dataset: logged and skipped)."""
    dataset_path = resolve_diagnostic_dataset_path()
    if not os.path.exists(dataset_path):
        log_information(log_path, {"status": "missing_dataset", "path": dataset_path},
                        "diagnostic_alignment_setup")
        print(f"[diagnostic-alignment] Dataset not found at {dataset_path}; "
              "skipping diagnostics.")
        return None
    try:
        table = read_table(dataset_path, sep=",")
    except Exception as exc:
        log_information(log_path, {"status": "read_error", "path": dataset_path,
                                   "error": str(exc)}, "diagnostic_alignment_setup")
        print(f"[diagnostic-alignment] Failed to read {dataset_path}: {exc}")
        return None
    missing = {"Name", "DotBracket"} - set(table.columns)
    if missing:
        log_information(log_path, {"status": "missing_columns", "path": dataset_path,
                                   "missing": ",".join(sorted(missing))},
                        "diagnostic_alignment_setup")
        print(f"[diagnostic-alignment] Required columns {missing} not found in "
              f"{dataset_path}; skipping diagnostics.")
        return None
    if len(table.rows) < 2:
        log_information(log_path, {"status": "insufficient_rows", "path": dataset_path,
                                   "rows": len(table.rows)}, "diagnostic_alignment_setup")
        print(f"[diagnostic-alignment] Expected at least two sequences in {dataset_path}; "
              "skipping diagnostics.")
        return None

    from ginfinity_tpu_torch.graphs.batching import batch_graphs
    from ginfinity_tpu_torch.graphs.build import build_graph_arrays

    batches, names, n_nodes = [], [], []
    for row in table.rows[:2]:
        seq = row.get("seq")
        g = build_graph_arrays(
            str(row["DotBracket"]),
            seq if isinstance(seq, str) else None,
            seq_weight=cfg.seq_weight,
            graph_encoding=cfg.graph_encoding,
            feature_dim=cfg.node_feature_dim,
        )
        batches.append(batch_graphs([g]).to(device))
        names.append(str(row["Name"]))
        n_nodes.append(g.n_base_nodes)  # forgi meta-nodes dropped
    similarity_dir = os.path.join(output_dir, "similarity_matrices")
    log_information(log_path, {
        "status": "ready", "dataset": dataset_path,
        "rna1": names[0], "rna2": names[1], "output_dir": similarity_dir,
    }, "diagnostic_alignment_setup")
    return {"cfg": cfg, "batches": batches, "names": names, "n_nodes": n_nodes,
            "similarity_dir": similarity_dir, "dataset": dataset_path}


def run_alignment_diagnostics(ctx, params, model_state, epoch_index: int, log_path: str):
    """One epoch's diagnostic with the current weights: node embeddings of
    the two structures -> cosine matrix -> PNG.  A failure (matplotlib
    missing among them) is logged and training goes on."""
    from ginfinity_tpu_torch.models.gine import get_node_embeddings
    from ginfinity_tpu_torch.pipelines.align import cosine_similarity_matrix, save_matrix_png

    try:
        with torch.no_grad():
            embs = [
                get_node_embeddings(ctx["cfg"], params, model_state, b).cpu().numpy()[:n]
                for b, n in zip(ctx["batches"], ctx["n_nodes"])
            ]
        sim = cosine_similarity_matrix(embs[0], embs[1])
        os.makedirs(ctx["similarity_dir"], exist_ok=True)
        destination = os.path.join(ctx["similarity_dir"], f"epoch_{epoch_index:03d}.png")
        save_matrix_png(sim, destination,
                        title=f"Epoch {epoch_index}: {ctx['names'][0]} vs {ctx['names'][1]}")
        log_information(log_path, {"epoch": epoch_index, "png": destination,
                                   "dataset": ctx["dataset"]}, "diagnostic_alignment")
        print(f"[diagnostic-alignment] Saved similarity matrix for epoch {epoch_index} "
              f"to {destination}")
    except Exception as exc:
        log_information(log_path, {"epoch": epoch_index, "error": str(exc)},
                        "diagnostic_alignment_error")
        print(f"[diagnostic-alignment] failed for epoch {epoch_index}: {exc}")


# --------------------------------------------------------------------------
# Periodic checkpoints and exact resume (the JAX CLI's orbax manager:
# max_to_keep 3)
# --------------------------------------------------------------------------

CHECKPOINTS_KEPT = 3
_CKPT_NAME = re.compile(r"epoch_(\d+)\.pt$")


def _checkpoint_files(ckpt_dir: str) -> list[tuple[int, str]]:
    """``(epoch, path)`` of the checkpoints in ``ckpt_dir``, oldest first."""
    found = []
    for p in glob.glob(os.path.join(ckpt_dir, "epoch_*.pt")):
        m = _CKPT_NAME.search(os.path.basename(p))
        if m:
            found.append((int(m.group(1)), p))
    return sorted(found)


def _save_epoch_checkpoint(ckpt_dir: str, epoch: int, ts, generator, early, rng_np,
                           extra: dict):
    """Write the whole training state after ``epoch``: parameters, model
    state, Adam's state, the step, the dropout generator's state, the
    best-weights tracker and the numpy generator's state, so a resume is
    exact.  Keeps the last 3."""
    os.makedirs(ckpt_dir, exist_ok=True)
    state = {
        "params": ts.params,
        "model_state": ts.model_state,
        "optimizer": ts.optimizer.state_dict(),
        "step": ts.step,
        "generator": generator.get_state(),
        "best_params": early.best_params,
        "best_model_state": early.best_model_state,
        "meta": {
            **extra,
            "epoch": int(epoch),
            "early_best_loss": None if early.best_loss is None else float(early.best_loss),
            "early_counter": int(early.counter),
            "np_rng_state": rng_np.bit_generator.state,
        },
    }
    path = os.path.join(ckpt_dir, f"epoch_{epoch}.pt")
    torch.save(state, path + ".tmp")
    os.replace(path + ".tmp", path)
    for _, old in _checkpoint_files(ckpt_dir)[:-CHECKPOINTS_KEPT]:
        os.remove(old)


def _restore_checkpoint(ckpt_dir: str, ts, generator, early, rng_np) -> dict:
    """Load the latest checkpoint in ``ckpt_dir`` into the given pieces, in
    place; returns its meta."""
    from ginfinity_tpu_torch.models.gine import _leaves
    from ginfinity_tpu_torch.training.train import tree_map

    files = _checkpoint_files(ckpt_dir)
    if not files:
        raise FileNotFoundError(f"No checkpoints found under {ckpt_dir}")
    # the file is this program's own (pickled numpy generator state)
    saved = torch.load(files[-1][1], map_location="cpu", weights_only=False)
    dev = next(leaf for _, leaf in _leaves((), ts.params)).device
    with torch.no_grad():
        for (_, live), (_, value) in zip(_leaves((), ts.params), _leaves((), saved["params"])):
            live.copy_(value)
    ts.model_state = tree_map(lambda t: t.to(dev), saved["model_state"])
    ts.optimizer.load_state_dict(saved["optimizer"])
    ts.step = saved["step"]
    generator.set_state(saved["generator"])
    early.best_params = tree_map(lambda t: t.to(dev), saved["best_params"])
    early.best_model_state = tree_map(lambda t: t.to(dev), saved["best_model_state"])
    meta = saved["meta"]
    early.best_loss = meta["early_best_loss"]
    early.counter = meta["early_counter"]
    rng_np.bit_generator.state = meta["np_rng_state"]
    return meta


# --------------------------------------------------------------------------
# One training run (one schedule round or the single-run mode)
# --------------------------------------------------------------------------


def _fit_node_stats_on_train(args, cfg, params, state, train_ds, log_path):
    """Fit the zscore ``node_mu``/``node_sigma`` buffers on the train
    set's raw node embeddings before export; returns the model state."""
    if not getattr(args, "fit_node_stats", False):
        return state
    if not cfg.node_embed_norm.startswith("zscore"):
        print("[train] --fit-node-stats ignored: "
              f"node_embed_norm={cfg.node_embed_norm!r} has no zscore buffers")
        return state
    from ginfinity_tpu_torch.graphs.batching import _round_capacity, batch_graphs, bucket_sizes
    from ginfinity_tpu_torch.models.gine import fit_node_stats

    if args.training_mode == "alignment":
        graphs = [s.graph for _, structs in train_ds.groups for s in structs]
    else:  # triplet items are 3-tuples, regression pairs 2-tuples
        graphs = [g for item in train_ds.items for g in item]

    def batches():
        order = sorted(range(len(graphs)), key=lambda i: graphs[i].n_nodes)

        def make(chunk):
            n_cap, e_cap = bucket_sizes(
                sum(g.n_nodes for g in chunk), sum(g.n_edges for g in chunk)
            )
            return batch_graphs(chunk, n_cap, e_cap, _round_capacity(len(chunk)))

        cur, cur_nodes = [], 0
        for i in order:
            n = graphs[i].n_nodes
            if cur and (cur_nodes + n > 4096 or len(cur) >= 256):
                yield make(cur)
                cur, cur_nodes = [], 0
            cur.append(graphs[i])
            cur_nodes += n
        if cur:
            yield make(cur)

    new_state = fit_node_stats(cfg, params, state, batches())
    print(f"[train] fitted node_mu/node_sigma on {len(graphs)} train graphs")
    log_information(log_path, {"fit_node_stats_graphs": len(graphs)})
    return new_state


def _epoch_mean(losses: list) -> float:
    """The per-batch losses' mean as the JAX CLI forms it: a float64 sum
    of the float32 values in order, over their count.  One download."""
    if not losses:
        return 0.0
    running = 0.0
    for v in torch.stack(losses).cpu().tolist():
        running += v
    return running / len(losses)


def run_training(args, cfg, params, state, train_df, val_df, alignment_map,
                 lr, decay_rate, num_epochs, patience, checkpoint_path, log_path, device):
    from ginfinity_tpu_torch.models.checkpoint import export_torch_checkpoint
    from ginfinity_tpu_torch.training import data as D
    from ginfinity_tpu_torch.training import train as T
    from ginfinity_tpu_torch.training.losses import AlignmentLossConfig

    mode = args.training_mode
    rng_np = np.random.default_rng(args.seed)

    if mode == "triplet":
        train_ds = D.TripletDataset(train_df, args.graph_encoding, args.seq_weight)
        val_ds = D.TripletDataset(val_df, args.graph_encoding, args.seq_weight)
        loss_fn = T.triplet_loss_fn(margin=1.0)
        make_iter = lambda ds, shuffle: D.iter_triplet_batches(
            ds, args.batch_size, rng_np if shuffle else None
        )
    elif mode == "regression":
        train_ds = D.PairDataset(train_df, args.graph_encoding, args.seq_weight)
        val_ds = D.PairDataset(val_df, args.graph_encoding, args.seq_weight)
        loss_fn = T.regression_loss_fn()
        make_iter = lambda ds, shuffle: D.iter_pair_batches(
            ds, args.batch_size, rng_np if shuffle else None
        )
    else:
        train_ds = D.AlignmentDataset(
            train_df, alignment_map, args.graph_encoding, args.seq_weight, args.structure_column
        )
        val_ds = D.AlignmentDataset(
            val_df, alignment_map, args.graph_encoding, args.seq_weight, args.structure_column
        )
        loss_fn = T.alignment_loss_fn(
            AlignmentLossConfig(
                margin=args.alignment_margin, temperature=args.alignment_temperature
            )
        )
        max_unaligned = max(0, int(args.alignment_unaligned_per_graph))
        # the reference loss's subsampling, at assembly time; <= 0 keeps
        # the full set
        max_negatives = (
            int(args.alignment_max_negatives)
            if args.alignment_max_negatives and args.alignment_max_negatives > 0
            else None
        )
        hard_frac = float(args.hard_negative_fraction)
        debug_log = (
            (lambda event, payload: log_information(
                log_path, {"event": event, **payload}, "AlignmentLoss Debug"))
            if args.debug
            else None
        )
        make_iter = lambda ds, shuffle: D.iter_alignment_batches(
            ds, args.batch_size, max_unaligned, rng_np if shuffle else None,
            max_negatives=max_negatives, hard_negative_fraction=hard_frac,
            debug_log=debug_log,
        )

    params = T.tree_map(lambda t: t.to(device), params)
    state = T.tree_map(lambda t: t.to(device), state)
    ts = T.TrainState.create(params, state, lr)
    train_step = T.make_train_step(cfg, loss_fn)
    eval_step = T.make_eval_step(cfg, loss_fn)
    generator = torch.Generator(device=device).manual_seed(args.seed)

    def avg_loss(ds, max_fraction=None):
        batches = list(make_iter(ds, shuffle=False))
        if max_fraction is not None and math.isfinite(max_fraction):
            limit = min(len(batches), max(1, math.ceil(len(batches) * max_fraction)))
            batches = batches[:limit]
        if not batches:
            return float("nan")
        return _epoch_mean([eval_step(ts, b.to(device)) for b in batches])

    initial_train = avg_loss(train_ds, args.initial_eval_fraction)
    initial_val = avg_loss(val_ds, args.initial_eval_fraction)
    early = T.EarlyStopping(patience=patience, min_delta=args.min_delta)
    early.best_loss = initial_val
    early.best_params, early.best_model_state = ts.detached()
    train_losses, val_losses = [initial_train], [initial_val]
    best_val = initial_val
    best_epoch = -1
    print(f"Epoch 0/{num_epochs}, Training Loss: {initial_train}, "
          f"Validation Loss: {initial_val}")
    log_information(log_path, {
        "Epoch": f"0/{num_epochs}",
        "Training Loss": initial_train,
        "Validation Loss": initial_val,
    })

    diag_ctx = (
        setup_diagnostic_alignment_context(cfg, log_path, os.path.dirname(log_path), device)
        if getattr(args, "diagnostic_alignment", False)
        else None
    )
    if diag_ctx is not None:
        run_alignment_diagnostics(diag_ctx, ts.params, ts.model_state, 0, log_path)

    current_lr = lr
    start_epoch = 0
    save_every = int(getattr(args, "save_every", 0) or 0)
    ckpt_dir = os.path.join(os.path.dirname(log_path), "checkpoints")
    if getattr(args, "resume_from", None):
        meta = _restore_checkpoint(args.resume_from, ts, generator, early, rng_np)
        start_epoch = meta["epoch"] + 1
        current_lr = float(meta["current_lr"])
        best_val = float(meta["best_val"])
        best_epoch = int(meta["best_epoch"])
        train_losses = list(meta["train_losses"])
        val_losses = list(meta["val_losses"])
        print(f"Resumed from epoch {meta['epoch']} checkpoint in {args.resume_from}")
        log_information(log_path, {"Resumed from": args.resume_from,
                                   "Resume epoch": start_epoch})
    last_epoch = start_epoch - 1
    interrupted = False
    try:
        for epoch in range(start_epoch, num_epochs):
            last_epoch = epoch
            losses = []
            for b in make_iter(train_ds, shuffle=True):
                ts, loss = train_step(ts, b.to(device), generator)
                losses.append(loss)
            avg_train = _epoch_mean(losses)

            # per-epoch multiplicative LR decay, held in float32 by Adam
            current_lr *= decay_rate
            ts.set_learning_rate(current_lr)

            avg_val = avg_loss(val_ds)
            train_losses.append(avg_train)
            val_losses.append(avg_val)
            if avg_val < best_val:
                best_val = avg_val
                best_epoch = epoch
                # diagnostics after each new best validation loss
                if diag_ctx is not None:
                    run_alignment_diagnostics(
                        diag_ctx, ts.params, ts.model_state, epoch + 1, log_path
                    )
            early(avg_val, ts)
            log_information(log_path, {
                "Epoch": f"{epoch + 1}/{num_epochs}",
                "Training Loss": avg_train,
                "Validation Loss": avg_val,
                "Best Validation Loss": best_val,
                "Early Stopping Counter": f"{early.counter}/{patience}",
                "Learning Rate": current_lr,
            })
            print(f"Epoch {epoch + 1}/{num_epochs}, Training Loss: {avg_train}, "
                  f"Validation Loss: {avg_val}")
            if save_every > 0 and (epoch + 1) % save_every == 0:
                _save_epoch_checkpoint(
                    ckpt_dir, epoch, ts, generator, early, rng_np,
                    {"current_lr": current_lr, "best_val": best_val,
                     "best_epoch": best_epoch, "train_losses": train_losses,
                     "val_losses": val_losses},
                )
            if early.early_stop:
                print("Early stopping")
                break
    except KeyboardInterrupt:
        print("\nTraining interrupted by user.")
        interrupted = True

    save_best = bool(getattr(args, "save_best_weights", True))
    final_params, final_state = ts.detached()
    if interrupted:
        # the interactive best-weights save
        log_information(log_path, {"Training finished": "Interrupted by user"})
        saved = False
        epoch_for_save = max(best_epoch, 0)
        if save_best and early.best_params is not None:
            while True:
                try:
                    response = input(
                        "Do you want to save the model with the best weights? [y/n]: "
                    ).strip().lower()
                except EOFError:
                    response = "n"
                except KeyboardInterrupt:
                    print("\nSkipping save of best weights.")
                    response = "n"
                if response in ("y", "yes"):
                    final_params = early.best_params
                    final_state = _fit_node_stats_on_train(
                        args, cfg, final_params, early.best_model_state, train_ds, log_path)
                    os.makedirs(os.path.dirname(checkpoint_path) or ".", exist_ok=True)
                    export_torch_checkpoint(
                        checkpoint_path, cfg, final_params, final_state, epoch=epoch_for_save
                    )
                    log_information(log_path, {"Best weights saved after interrupt": True})
                    saved = True
                    break
                if response in ("n", "no", ""):
                    print("Best weights were not saved.")
                    log_information(log_path, {"Best weights saved after interrupt": False})
                    break
                print("Please respond with 'y' or 'n'.")
        else:
            print("No best weights available to save.")
        _plot_loss_curves(train_losses, val_losses, os.path.dirname(log_path), log_path,
                          epoch_for_save + 1 if saved else None)
        return {
            "checkpoint_path": checkpoint_path if saved else None,
            "params": final_params,
            "model_state": final_state,
            "interrupted": True,
        }

    # restore the best weights
    epoch_for_save = max(last_epoch, 0)
    if early.early_stop and save_best and early.best_params is not None:
        final_params, final_state = early.best_params, early.best_model_state
        if best_epoch >= 0:
            epoch_for_save = best_epoch

    final_state = _fit_node_stats_on_train(args, cfg, final_params, final_state, train_ds,
                                           log_path)
    os.makedirs(os.path.dirname(checkpoint_path) or ".", exist_ok=True)
    export_torch_checkpoint(checkpoint_path, cfg, final_params, final_state,
                            epoch=epoch_for_save)
    log_information(log_path, {"Model saved path": checkpoint_path})
    print("Training complete.")

    _plot_loss_curves(train_losses, val_losses, os.path.dirname(log_path), log_path,
                      epoch_for_save + 1)
    return {"checkpoint_path": checkpoint_path, "params": final_params,
            "model_state": final_state}


def _plot_loss_curves(train_losses, val_losses, output_dir, log_path, saved_epoch=None):
    if not train_losses or not val_losses:
        return
    try:
        import matplotlib

        matplotlib.use("Agg", force=True)
        import matplotlib.pyplot as plt
    except ImportError as exc:
        log_information(log_path, {"Loss plot": f"Skipped (matplotlib unavailable: {exc})"})
        return
    epochs = list(range(len(train_losses)))
    plt.figure()
    plt.plot(epochs, train_losses, label="Training Loss")
    plt.plot(epochs, val_losses, label="Validation Loss")
    plt.xlabel("Epoch")
    plt.ylabel("Loss")
    plt.title("Training and Validation Loss")
    plt.grid(True, alpha=0.3)
    if saved_epoch is not None:
        plt.axvline(saved_epoch, linestyle="--", color="red", linewidth=1.0,
                    label="Saved Weights")
    plt.legend()
    plt.tight_layout()
    out = os.path.join(output_dir, "loss_curve.png")
    plt.savefig(out)
    plt.close()
    log_information(log_path, {"Loss plot saved": out})


# --------------------------------------------------------------------------
# CLI
# --------------------------------------------------------------------------


def build_parser():
    parser = argparse.ArgumentParser(
        description="Train a GIN model on RNA secondary structures (PyTorch/CUDA).")
    parser.add_argument("--input_path", type=str, default=None)
    parser.add_argument("--model_id", type=str, default="gin_model")
    parser.add_argument("--graph_encoding", type=str, choices=["standard", "forgi"],
                        default="standard")
    parser.add_argument("--hidden_dim", type=str, default="256")
    parser.add_argument("--output_dim", type=int, default=128)
    parser.add_argument("--batch_size", type=int, default=100)
    parser.add_argument("--num_epochs", type=int, default=10)
    parser.add_argument("--patience", type=int, default=5)
    parser.add_argument("--lr", type=float, default=0.001)
    parser.add_argument("--gin_layers", type=int, default=1)
    parser.add_argument("--num_workers", type=int, default=None,
                        help="Reference CLI compatibility.")
    parser.add_argument("--device", type=str, default=None,
                        help="'cuda' (the default: the current card) or 'cpu'.")
    parser.add_argument("--min_delta", type=float, default=0.001)
    parser.add_argument("--decay_rate", type=float, default=0.01)
    parser.add_argument("--pooling_type", type=str,
                        choices=["global_add_pool", "global_mean_pool", "set2set"],
                        default="global_add_pool")
    parser.add_argument("--use_residual", action=argparse.BooleanOptionalAction, default=True)
    parser.add_argument("--dropout", type=float, default=0.0)
    parser.add_argument("--val_fraction", type=float, default=0.2)
    parser.add_argument("--f_sample_dataset", type=float, default=1.0)
    parser.add_argument("--initial_eval_fraction", type=float, default=0.05)
    parser.add_argument("--debug", action="store_true", default=False,
                        help="Log per-batch alignment-loss assembly events "
                             "(negative subsampling stats) to the run log.")
    # the reference's flag, typo included: after each new best validation
    # loss, align the first two structures of the diagnostic dataset (env
    # GINFINITY_DIAGNOSTIC_ALIGNMENT_PATH or dev/terts.csv) and save the
    # similarity-matrix PNG
    parser.add_argument("--diagnostic-aligment", dest="diagnostic_alignment",
                        action="store_true", default=False,
                        help="After each new best validation loss, run "
                             "alignment diagnostics and save the similarity "
                             "matrix PNG.")
    parser.add_argument("--diagnostic-alignment", dest="diagnostic_alignment",
                        action="store_true", help=argparse.SUPPRESS)
    # the reference's type=bool quirk: any non-empty string parses True
    parser.add_argument("--save_best_weights", type=bool, default=True,
                        help="Restore/save the best weights (early stopping "
                             "and Ctrl-C); False saves the final weights.")
    parser.add_argument("--cache-alignments", dest="cache_alignments",
                        action="store_true", default=True,
                        help="Reference CLI compatibility: preprocessing "
                             "here is eager and cached by construction.")
    parser.add_argument("--no-cache-alignments", dest="cache_alignments",
                        action="store_false")
    parser.add_argument("--alignment-prefetch-factor", type=int, default=2,
                        help="Reference CLI compatibility (no dataloader "
                             "workers exist; batches assemble eagerly).")
    parser.add_argument("--no-preprocessing-progress",
                        dest="preprocessing_progress", action="store_false",
                        default=True,
                        help="Reference CLI compatibility (no progress bars "
                             "are shown).")
    parser.add_argument("--save-every", type=int, default=0,
                        help="Write a checkpoint of the WHOLE training state "
                             "every N epochs (0 = off); the last 3 are kept.")
    parser.add_argument("--resume-from", type=str, default=None,
                        help="Resume exactly from the latest checkpoint in "
                             "this directory (params, optimizer, RNG "
                             "streams, early stopping, loss history).")
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--training_mode", choices=["triplet", "regression", "alignment"],
                        default="triplet")
    parser.add_argument("--seq_weight", type=float, default=0.0)
    parser.add_argument("--norm_type", type=str,
                        choices=["none", "batch", "graph", "layer", "instance"], default="graph")
    parser.add_argument("--node_embed_norm", type=str,
                        choices=["none", "l2", "zscore", "zscore_l2"], default="none")
    parser.add_argument("--normalize_nodes_before_pool", action="store_true")
    parser.add_argument("--fit-node-stats", dest="fit_node_stats", action="store_true",
                        help="After training, fit the zscore node_mu/node_sigma "
                             "buffers on the train set's raw node embeddings "
                             "before export.")
    parser.add_argument("--alignment_map_path", type=str, default=None)
    parser.add_argument("--alignment_margin", type=float, default=0.2)
    parser.add_argument("--alignment_unaligned_per_graph", type=int, default=16)
    parser.add_argument("--hard_negative_fraction", type=float, default=0.85)
    parser.add_argument("--alignment_temperature", type=float, default=0.1)
    parser.add_argument("--alignment_max_negatives", type=int, default=5000)
    parser.add_argument("--structure_column", type=str, default="structure")
    parser.add_argument("--gin_eps", type=float, default=0.0)
    parser.add_argument("--train_eps", action="store_true")
    parser.add_argument("--schedule", type=str, default=None)
    parser.add_argument("--data-parallel", dest="data_parallel",
                        action="store_true", default=False,
                        help="Shard training batches over all cards: one card "
                             "runs single-device; several are not ported yet.")
    return parser


def make_config(args, hidden_dim):
    """The reference's feature-width rules for a new model."""
    from ginfinity_tpu_torch.graphs.build import FORGI_NODE_TYPES
    from ginfinity_tpu_torch.models.gine import GINConfig

    if args.graph_encoding == "forgi":
        node_feature_dim = 2 + 2 + 4 + 1 + len(FORGI_NODE_TYPES)
        edge_feature_dim = 7
    else:
        node_feature_dim = 4 + (4 if args.seq_weight > 0 else 0)
        edge_feature_dim = 4
    return GINConfig.create(
        hidden_dim=hidden_dim,
        output_dim=args.output_dim,
        gin_layers=args.gin_layers,
        graph_encoding=args.graph_encoding,
        pooling_type=args.pooling_type,
        dropout=args.dropout,
        node_feature_dim=node_feature_dim,
        edge_feature_dim=edge_feature_dim,
        norm_type=args.norm_type,
        use_residual=args.use_residual,
        node_embed_norm=args.node_embed_norm,
        normalize_nodes_before_pool=args.normalize_nodes_before_pool,
        gin_eps=args.gin_eps,
        train_eps=args.train_eps,
        seq_weight=float(args.seq_weight),
    )


def main(argv=None):
    from ginfinity_tpu_torch.models.checkpoint import load_checkpoint

    args = build_parser().parse_args(argv)

    if not math.isfinite(args.initial_eval_fraction) or args.initial_eval_fraction <= 0:
        raise ValueError("initial_eval_fraction must be a positive, finite value.")
    if not math.isfinite(args.f_sample_dataset) or not (0 < args.f_sample_dataset <= 1):
        raise ValueError("f_sample_dataset must be a positive, finite fraction in (0, 1].")

    schedule_plan = None
    if args.schedule:
        sp = os.path.expandvars(os.path.expanduser(args.schedule))
        if not os.path.isfile(sp):
            raise FileNotFoundError(f"Schedule file not found: {sp}")
        if args.training_mode != "alignment":
            raise ValueError("--schedule can only be used when training_mode is 'alignment'.")
        if args.input_path:
            raise ValueError("--input_path cannot be used together with --schedule.")
        if args.alignment_map_path:
            raise ValueError("--alignment_map_path cannot be used together with --schedule.")
        if args.resume_from:
            raise ValueError("--resume-from applies to single runs; schedules "
                             "resume via 'start_from_round' + 'checkpoint'.")
        schedule_plan = read_schedule(sp)
        print("Warning: schedule provided; ignoring CLI patience, lr, num_epochs, "
              "and decay_rate.")
    elif not args.input_path:
        raise ValueError("--input_path is required when no schedule is provided.")

    if "," in args.hidden_dim:
        hidden_dim = [int(x.strip()) for x in args.hidden_dim.split(",")]
    else:
        hidden_dim = int(args.hidden_dim)
    if args.batch_size < 1:
        raise ValueError("--batch_size must be a positive integer.")

    device = resolve_device(args.device)
    if device.type == "cuda":
        disable_tf32()
    if args.data_parallel and device.type == "cuda" and torch.cuda.device_count() > 1:
        raise NotImplementedError(
            "--data-parallel over several cards is not ported yet (ROADMAP queue 1, item 11)"
        )
    random.seed(args.seed)

    cfg = make_config(args, hidden_dim)
    params, state = init_params(torch.Generator().manual_seed(args.seed), cfg)

    if schedule_plan is None:
        output_folder = os.path.join("output", args.model_id)
        os.makedirs(output_folder, exist_ok=True)
        log_path = os.path.join(output_folder, "train.log")
        log_setup(log_path, print_log=False)
        table, train_df, val_df, alignment_map, data_path = prepare_dataset(
            args, args.input_path, args.alignment_map_path
        )
        log_information(log_path, {
            "train_data_path": data_path,
            "train_data_samples": len(table.rows),
            "training_mode": args.training_mode,
            "lr": args.lr, "decay_rate": args.decay_rate,
        }, "Training params")
        t0 = time.time()
        run_training(
            args, cfg, params, state, train_df, val_df, alignment_map,
            args.lr, args.decay_rate, args.num_epochs, args.patience,
            os.path.join(output_folder, f"{args.model_id}.pth"), log_path, device,
        )
        print(f"Finished. Total execution time: {(time.time() - t0) / 60:.6f} minutes")
        return

    # schedule mode
    rounds = [r for r in schedule_plan["rounds"]
              if r["round"] >= schedule_plan["start_from_round"]]
    if not rounds:
        raise ValueError("No rounds to execute after applying 'start_from_round'.")
    base_dir = os.path.join("output", args.model_id)
    os.makedirs(base_dir, exist_ok=True)

    pending_ckpt = schedule_plan["checkpoint"]
    delete_after_load = False
    for exec_idx, rcfg in enumerate(rounds):
        round_label = f"round_{rcfg['round']:02d}"
        round_dir = os.path.join(base_dir, round_label)
        os.makedirs(round_dir, exist_ok=True)
        log_path = os.path.join(round_dir, "train.log")
        log_setup(log_path, print_log=False)
        log_information(log_path, dict(rcfg["raw"]), "Schedule round config")

        if pending_ckpt:
            cfg, params, state, _ = load_checkpoint(pending_ckpt)
            if delete_after_load and os.path.exists(pending_ckpt):
                os.remove(pending_ckpt)
            pending_ckpt = None
            delete_after_load = False

        _, train_df, val_df, alignment_map, _ = prepare_dataset(
            args, rcfg["dataset_path"], rcfg["alignment_map_path"]
        )
        ckpt_path = os.path.join(round_dir, f"{args.model_id}_{round_label}.pth")
        outcome = run_training(
            args, cfg, params, state, train_df, val_df, alignment_map,
            rcfg["lr"], rcfg["decay_rate"], rcfg["num_epochs"], rcfg["patience"],
            ckpt_path, log_path, device,
        )
        params = outcome["params"]
        state = outcome["model_state"]
        if outcome.get("interrupted"):
            print(f"Schedule interrupted during round {rcfg['round']}.")
            return
        print(f"Finished round {rcfg['round']}.")

        pending_ckpt = outcome["checkpoint_path"]
        delete_after_load = not rcfg["keep_weights"]
        if delete_after_load and exec_idx == len(rounds) - 1 and pending_ckpt:
            if os.path.exists(pending_ckpt):
                os.remove(pending_ckpt)
            pending_ckpt = None
            delete_after_load = False
    print("Schedule completed.")


if __name__ == "__main__":
    main()
