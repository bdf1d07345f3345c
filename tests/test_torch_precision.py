"""The bf16 speed mode of the port (``GINConfig.matmul_precision="bf16"``,
``ginfinity-embed --precision bf16``, ``--bf16-check``) and
``--profile-dir``, against the JAX package on the same inputs.

- The config field and ``with_precision`` behave as the JAX package's.
- ``bf16_round`` is round to nearest even with the bits of
  ``jnp.asarray(x, jnp.bfloat16)``, NaN and infinities included.
- ``_dense`` at bf16 equals a numpy emulation (operands rounded to bf16,
  exact products summed in float64) within the float32 sum's own bound.
- The port's bf16 CLI against the JAX CLI's bf16 run in window, graph and
  ``--graph-pt`` mode: every cell but the vectors identical, each vector
  within cosine 0.999.  On the CPU the JAX package computes
  ``Precision.DEFAULT`` in float32, while the port rounds as the TPU does
  (bf16 against f32: a mean cosine of ~0.99995 was measured at full
  depth), so cosine and not digits is the bar.
- ``--bf16-check`` logs the JAX CLI's keys over the same sample of windows;
  ``--wire`` switches to f16 under bf16 as in the JAX CLI; ``--profile-dir``
  writes a trace and leaves the TSV unchanged.
"""

import ast
import csv
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ginfinity_tpu.models.checkpoint import export_torch_checkpoint
from ginfinity_tpu.models.gine import GINConfig as JConfig
from ginfinity_tpu.models.gine import init_params as jinit
from ginfinity_tpu.pipelines import embed as jembed
from ginfinity_tpu.pipelines.msa_eval import random_structure
from ginfinity_tpu_torch.models import gine
from ginfinity_tpu_torch.models.gine import GINConfig
from ginfinity_tpu_torch.pipelines import embed, windows

COS = 0.999


# ------------------------------------------------------------ config


def test_precision_config_plumbing():
    cfg = GINConfig.create(hidden_dim=8, output_dim=4)
    jcfg = JConfig.create(hidden_dim=8, output_dim=4)
    assert cfg.matmul_precision == jcfg.matmul_precision == "highest"
    bf = cfg.with_precision("bf16")
    assert bf.matmul_precision == "bf16" and cfg.matmul_precision == "highest"
    assert bf.with_precision("highest") == cfg
    for c in (cfg, jcfg):
        with pytest.raises(ValueError):
            c.with_precision("tf32")
    assert "matmul_precision" not in bf.to_metadata()
    assert bf.to_metadata() == cfg.to_metadata() == jcfg.with_precision("bf16").to_metadata()
    assert GINConfig.from_metadata(bf.to_metadata()).matmul_precision == "highest"


def test_packed_windows_cache_keys_on_precision():
    cfg = GINConfig.create(hidden_dim=128, output_dim=128, gin_layers=1)
    params, state = gine.init_params(torch.Generator().manual_seed(0), cfg)
    f32 = gine.GINModel(cfg, params, state).packed_windows()
    model = gine.GINModel(cfg.with_precision("bf16"), params, state)
    bf = model.packed_windows()
    assert (f32.precision, bf.precision) == ("highest", "bf16")
    assert model.packed_windows() is bf
    model.config = cfg
    assert model.packed_windows().precision == "highest"


# ------------------------------------------------------------ rounding


def _bf16_sweep():
    """Seeded float32 values over the whole exponent range, exact ties
    (odd and even), subnormals, the largest finite values, infinities and
    NaNs with payloads and both signs."""
    rng = np.random.default_rng(0)
    bits = [rng.integers(0, 2 ** 32, 20000, dtype=np.uint64).astype(np.uint32)]
    hi = rng.integers(0, 2 ** 16, 4000, dtype=np.uint64).astype(np.uint32) << 16
    bits += [hi | 0x8000, hi | 0x7FFF, hi | 0x8001, hi]  # ties, just below and above
    bits.append(rng.integers(0, 2 ** 23, 4000, dtype=np.uint64).astype(np.uint32))  # subnormal
    bits.append(np.array([0x7F7FFFFF, 0xFF7FFFFF, 0x7F7F8000, 0x7F7F7FFF, 0x7F800000,
                          0xFF800000, 0x7FC00000, 0xFFC00000, 0x7F800001, 0x7FC12345,
                          0xFFFFFFFF, 0x00000000, 0x80000000, 0x00008000, 0x00018000],
                         np.uint32))
    x = np.concatenate(bits).view(np.float32)
    return np.concatenate([x, -x])


def test_bf16_round_matches_jax_bit_for_bit():
    x = _bf16_sweep()
    with np.errstate(invalid="ignore"):
        ref = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32)).view(np.uint32)
    got = gine.bf16_round(torch.from_numpy(x)).numpy().view(np.uint32)
    assert np.isnan(x).any() and np.isinf(x).any()
    np.testing.assert_array_equal(got, ref)


def test_bf16_round_is_to_nearest_even():
    one, ulp = 1.0, 2.0 ** -7
    x = torch.tensor([one + ulp / 2, one + 1.5 * ulp, -(one + ulp / 2),
                      one + ulp / 2 + 2.0 ** -20, 2.0 ** -130, -0.0], dtype=torch.float32)
    got = gine.bf16_round(x).tolist()
    assert got[:4] == [one, one + 2 * ulp, -one, one + ulp]
    assert got[4] == 2.0 ** -130 and str(got[5]) == "-0.0"
    assert gine.bf16_round(x.double()).dtype == torch.float64


def _np_bf16(a):
    with np.errstate(invalid="ignore"):
        return np.asarray(jnp.asarray(np.asarray(a, np.float32), jnp.bfloat16)
                          .astype(jnp.float32)).astype(np.float64)


@pytest.mark.parametrize("shape", [(64, 128, 128), (300, 4, 128), (7, 256, 96)])
def test_dense_bf16_matches_numpy_emulation(shape):
    """``_dense`` at bf16: operands rounded to bf16, the exact products
    summed; against float64 sums of the same rounded operands, within the
    float32 sum's bound K * 2^-24 * (|a| @ |w|) (+ the bias's rounding)."""
    n, k, m = shape
    rng = np.random.default_rng(n)
    a = rng.normal(size=(n, k)).astype(np.float32)
    p = {"kernel": torch.from_numpy(rng.normal(size=(k, m)).astype(np.float32)),
         "bias": torch.from_numpy(rng.normal(size=m).astype(np.float32))}
    got = gine._dense(torch.from_numpy(a), p, "bf16").numpy().astype(np.float64)
    ra, rw = _np_bf16(a), _np_bf16(p["kernel"].numpy())
    ref = ra @ rw + p["bias"].numpy()
    bound = k * 2.0 ** -24 * (np.abs(ra) @ np.abs(rw)) + 2.0 ** -24 * np.abs(ref)
    assert np.all(np.abs(got - ref) <= bound)
    # the rounding is there: float32 operands give another result
    f32 = gine._dense(torch.from_numpy(a), p).numpy().astype(np.float64)
    assert np.abs(f32 - ref).max() > 10 * bound.max()
    with pytest.raises(ValueError):
        gine._matmul(torch.from_numpy(a), p["kernel"], "tf32")


def test_bf16_matmul_route_on_the_cpu_is_the_emulation():
    assert gine.bf16_matmul_route(torch.device("cpu")) == "emulation"


# ------------------------------------------------------------ the CLI


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("precision_cli")
    jc = JConfig.create(hidden_dim=128, output_dim=128, gin_layers=2,
                        pooling_type="global_mean_pool", node_embed_norm="zscore_l2",
                        norm_type="graph", use_residual=True,
                        normalize_nodes_before_pool=True)
    params, state = jinit(jax.random.PRNGKey(11), jc)
    rng = np.random.default_rng(11)
    state = dict(state)
    state["node_mu"] = 0.1 * rng.normal(size=128).astype(np.float32)
    state["node_sigma"] = (1.0 + rng.random(128)).astype(np.float32)
    model = str(d / "model.pth")
    export_torch_checkpoint(model, jc, params, state)
    rows = [(f"r{i}", random_structure(rng, int(n)), f"fam {i % 3}")
            for i, n in enumerate(rng.integers(45, 110, size=6))]
    rows.append(("bad", "((..", "fam x"))
    rows.append(("pk", "((..[[..))..]].." * 4, ""))
    src = d / "in.csv"
    with open(src, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["rid", "secondary_structure", "family"])
        w.writerows(rows)
    return d, str(src), model


def _read(path):
    with open(path, newline="") as f:
        return list(csv.reader(f, delimiter="\t"))


def _same_but_vectors(ref, got, col="embedding_vector"):
    """Every cell identical but the vectors; each vector's cosine."""
    assert got[0] == ref[0] and len(got) == len(ref) > 2
    k = ref[0].index(col)
    assert [g[:k] + g[k + 1:] for g in got] == [r[:k] + r[k + 1:] for r in ref]
    a = np.array([np.array(g[k].split(","), np.float64) for g in got[1:]])
    b = np.array([np.array(r[k].split(","), np.float64) for r in ref[1:]])
    assert np.isfinite(a).all() and a.shape == b.shape
    return (a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))


def _both(jmain, pmain, args, tmp_path, out="tsv"):
    jmain([*args, "--output", str(tmp_path / f"jax.{out}")])
    pmain([*args, "--output", str(tmp_path / f"port.{out}"), "--device", "cpu"])
    return _read(tmp_path / f"jax.{out}"), _read(tmp_path / f"port.{out}")


@pytest.mark.parametrize("extra", [
    ["--window-size", "40", "--keep-paired-neighbors"],
    ["--window-size", "40", "--keep-paired-neighbors", "--wire", "f32", "--keep-cols", "family"],
    ["--window-size", "32", "--mask-threshold", "0.3"],
    [],
    ["--keep-cols", "family"],
])
def test_bf16_cli_matches_jax_cli(inputs, extra, tmp_path):
    _, src, model = inputs
    base = ["--input", src, "--id-column", "rid", "--model-path", model, "--quiet", *extra]
    ref, got = _both(jembed.main, embed.main, [*base, "--precision", "bf16"], tmp_path)
    cos = _same_but_vectors(ref, got)
    assert cos.min() >= COS, cos.min()
    # the port's bf16 is not its f32: the rounding points are there
    embed.main([*base, "--output", str(tmp_path / "f32.tsv"), "--device", "cpu"])
    assert _read(tmp_path / "f32.tsv") != got


@pytest.mark.parametrize("fmt", ["npz", "pt"])
def test_bf16_graph_pt_matches_jax_cli(inputs, fmt, tmp_path):
    _, src, model = inputs
    windows.main(["--input", src, "--id-column", "rid", "--L", "30", "--format", "both",
                  "--keep-paired-neighbors", "--keep-cols", "family", "--quiet",
                  "--output-dir", str(tmp_path / "win")])
    args = ["--graph-pt", str(tmp_path / "win" / f"windows_graphs.{fmt}"),
            "--meta-tsv", str(tmp_path / "win" / "windows_metadata.tsv"),
            "--id-column", "rid", "--model-path", model, "--precision", "bf16",
            "--batch-nodes", "700"]
    ref, got = _both(jembed.main, embed.main, args, tmp_path)
    cos = _same_but_vectors(ref, got)
    assert len(got) > 20 and cos.min() >= COS, cos.min()


def _log_block(path, name):
    text = open(path).read()
    block = text.split("=" * 50 + "\n" + name + "\n")[1].split("\n" + "=" * 50)[0]
    return dict(line.split(": ", 1) for line in block.strip().splitlines())


@pytest.mark.parametrize("wire", [[], ["--wire", "f32"]])
def test_bf16_check_logs_the_jax_keys_and_sample(inputs, wire, tmp_path, capsys):
    _, src, model = inputs
    args = ["--input", src, "--id-column", "rid", "--model-path", model,
            "--window-size", "40", "--keep-paired-neighbors", "--precision", "bf16",
            "--bf16-check", "30", *wire]
    _both(jembed.main, embed.main, args, tmp_path)
    said = capsys.readouterr().out
    assert said.count("[bf16-check]") == 2 and "windows re-embedded at f32" in said
    assert said.count("--bf16-check N") == 1  # the port's notice names the check
    ref, got = _log_block(tmp_path / "jax.log", "bf16_check"), \
        _log_block(tmp_path / "port.log", "bf16_check")
    assert list(got) == list(ref)
    assert ("wire_note" in got) == (not wire) and got.get("wire_note") == ref.get("wire_note")
    assert got["bf16_check_windows"] == ref["bf16_check_windows"]
    assert int(got["bf16_check_windows"]) >= 30
    assert COS <= float(got["bf16_cosine_vs_f32_min"]) <= float(
        got["bf16_cosine_vs_f32_mean"]) <= 1.0
    worst = ast.literal_eval(got["bf16_worst_windows"])  # a dict, as the JAX log writes it
    assert len(worst) == 5 and set(worst) <= {r[0] for r in _read(tmp_path / "port.tsv")[1:]}
    assert ast.literal_eval(ref["bf16_worst_windows"]).keys() <= {
        r[0] for r in _read(tmp_path / "jax.tsv")}


def test_bf16_check_needs_bf16(inputs, tmp_path):
    _, src, model = inputs
    embed.main(["--input", src, "--id-column", "rid", "--model-path", model, "--quiet",
                "--window-size", "40", "--bf16-check", "30", "--output",
                str(tmp_path / "o.tsv"), "--device", "cpu"])
    assert "bf16_check_windows" not in open(tmp_path / "o.log").read()


def test_bf16_auto_enables_f16_wire(inputs, tmp_path, monkeypatch, capsys):
    """--precision bf16 with --window-size takes the f16 wire; an explicit
    --wire f32 wins; f32 keeps the f32 wire; the notice goes with it."""
    _, src, model = inputs
    seen = {}
    real = embed.generate_window_embeddings

    def spy(**kw):
        seen["wire"] = kw.get("wire")
        return real(**kw)

    monkeypatch.setattr(embed, "generate_window_embeddings", spy)
    base = ["--input", src, "--model-path", model, "--id-column", "rid",
            "--window-size", "40", "--device", "cpu"]
    embed.main(base + ["--output", str(tmp_path / "o1.tsv"), "--precision", "bf16"])
    assert seen["wire"] == "f16"
    assert "using the f16 result wire" in capsys.readouterr().out
    embed.main(base + ["--output", str(tmp_path / "o2.tsv"), "--precision", "bf16",
                       "--wire", "f32"])
    assert seen["wire"] is None
    embed.main(base + ["--output", str(tmp_path / "o3.tsv")])
    assert seen["wire"] is None
    assert "f16 result wire" not in capsys.readouterr().out
    # the f16 wire rounds each value to float16 on the way down
    a = np.array([r[5].split(",") for r in _read(tmp_path / "o1.tsv")[1:]], np.float64)
    b = np.array([r[5].split(",") for r in _read(tmp_path / "o2.tsv")[1:]], np.float64)
    assert 0 < np.abs(a - b).max() <= 2.0 ** -11 * np.abs(b).max() + 1e-6


@pytest.mark.parametrize("extra", [["--window-size", "40", "--keep-paired-neighbors"], []])
def test_profile_dir_writes_a_trace_and_keeps_the_tsv(inputs, extra, tmp_path):
    _, src, model = inputs
    args = ["--input", src, "--id-column", "rid", "--model-path", model, "--quiet",
            "--device", "cpu", *extra]
    embed.main([*args, "--output", str(tmp_path / "plain.tsv")])
    embed.main([*args, "--output", str(tmp_path / "prof.tsv"),
                "--profile-dir", str(tmp_path / "trace")])
    traces = glob.glob(str(tmp_path / "trace" / "*.pt.trace.json"))
    assert len(traces) == 1 and os.path.getsize(traces[0]) > 0
    assert '"traceEvents"' in open(traces[0]).read()
    assert (tmp_path / "prof.tsv").read_bytes() == (tmp_path / "plain.tsv").read_bytes()
