"""Seeded training inputs for the port's training tests: triplet and
regression TSVs (with a few invalid structures, sequences and comment
lines), alignment data from ``generate_alignment_training_data`` (the
JAX package's bytes), and the JAX package's initial weights carried into
the port."""

import jax
import numpy as np

from ginfinity_tpu.models.gine import GINConfig as JConfig
from ginfinity_tpu.models.gine import init_params as jinit
from ginfinity_tpu_torch.models.checkpoint import params_from_jax
from ginfinity_tpu_torch.models.gine import GINConfig
from ginfinity_tpu_torch.pipelines.msa_eval import random_structure
from ginfinity_tpu_torch.pipelines.train_eval import generate_alignment_training_data


def structures(rng, n, lo=12, hi=48):
    return [random_structure(rng, int(rng.integers(lo, hi))) for _ in range(n)]


def _sequence(rng, structure):
    return "".join("ACGU"[i] for i in rng.integers(0, 4, size=len(structure)))


def write_pairs(path, mode, n=24, seed=2, invalid=(3, 11)):
    """A triplet or regression TSV of ``n`` rows: seeded structures and
    sequences, the rows in ``invalid`` given a malformed anchor, and two
    comment lines."""
    rng = np.random.default_rng(seed)
    cols = ["anchor", "positive"] + (["negative"] if mode == "triplet" else [])
    table = {c: structures(rng, n) for c in cols}
    for i in invalid:
        table["anchor"][i] = "((.."
    header = [f"{c}_structure" for c in cols] + [f"{c}_seq" for c in cols]
    if mode == "regression":
        header.append("f_total_modifications")
    with open(path, "w") as f:
        f.write("# seeded training pairs\n" + "\t".join(header) + "\n")
        for i in range(n):
            cells = [table[c][i] for c in cols] + [_sequence(rng, table[c][i]) for c in cols]
            if mode == "regression":
                cells.append(repr(float(rng.random())))
            f.write("\t".join(cells) + "\n")
            if i == n // 2:
                f.write("# a comment between rows\n")
    return str(path)


def write_alignment(outdir, n_families=5, anc_len=30, seed=7):
    """Alignment-mode TSV and map of ``n_families`` families of 5."""
    data_p, map_p, _ = generate_alignment_training_data(
        str(outdir), n_train_families=n_families, n_eval_families=1, n_seqs=5,
        anc_len=anc_len, seed=seed)
    return data_p, map_p


def jax_init(kw, seed=0):
    """The JAX package's initial weights for config ``kw`` (``GINConfig.create``
    keywords), as numpy trees, and the same weights as port tensors."""
    jc = JConfig.create(**kw)
    params, state = jinit(jax.random.PRNGKey(seed), jc)
    params = jax.tree_util.tree_map(np.asarray, params)
    state = jax.tree_util.tree_map(np.asarray, state)
    return jc, params, state, params_from_jax(GINConfig.create(**kw), params, state)
