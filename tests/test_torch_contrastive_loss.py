"""The alignment-contrastive loss's kernel route.

On the CPU: the kernel's algorithm in plain PyTorch
(``ops/contrastive_loss.py::contrastive_loss_blockwise``: online
log-sum-exp over column tiles, the closed-form ``G``, ``(G + G^T) x``)
against autograd through the plain M x M loss, in float64, and the
wrapper's input checks.

On a card (marker ``card``; run there with ``python -m pytest --noconftest
tests/test_torch_contrastive_loss.py -m card``, since the card's machine
has no JAX for ``tests/conftest.py``): the kernel against the float64
twin at small shapes in both types, and ``chip_smoke.py``'s checks of
its train phase: the kernel against the plain loss and the float64 twin
at the training cell's M and past 2^31 pairs, two runs bit-equal.  This
file imports no JAX.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ginfinity_tpu_torch.ops import contrastive_loss as CL
from ginfinity_tpu_torch.training import losses as L


def _inputs(seed, n, d=16, pad=0, n_labels=10, n_graphs=4, dtype=np.float64):
    """Random rows, labels, graphs and categories, ``pad`` padding rows at
    the end (distinct labels, graph -1, category 5, valid 0)."""
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(n + pad, d)).astype(dtype)
    labels = np.concatenate([rng.integers(0, n_labels, size=n),
                             -2_000_000_000 - np.arange(pad)]).astype(np.int64)
    graph_ids = np.concatenate([rng.integers(0, n_graphs, size=n),
                                np.full(pad, -1)]).astype(np.int32)
    cats = np.concatenate([rng.integers(0, 6, size=n), np.full(pad, 5)]).astype(np.int32)
    valid = np.concatenate([np.ones(n), np.zeros(pad)]).astype(np.float32)
    return [torch.from_numpy(a) for a in (emb, labels, graph_ids, cats, valid)]


def _normalise(e, eps=1e-8):
    return e / torch.clamp(torch.linalg.vector_norm(e, dim=1, keepdim=True), min=eps)


def _twin_vs_autograd(emb, labels, gids, cats, valid, margin, temperature, block):
    """Loss and d loss / d emb of the twin (through torch's normalisation)
    and of autograd through the plain loss, both in float64."""
    cfg = L.AlignmentLossConfig(margin=margin, temperature=temperature)
    e_plain = emb.clone().requires_grad_(True)
    want = L.alignment_contrastive_loss(e_plain, labels, gids, cats, valid, cfg)
    want.backward()
    e_twin = emb.clone().requires_grad_(True)
    x = _normalise(e_twin)
    got, dx = CL.contrastive_loss_blockwise(x.detach(), labels, gids, cats, valid,
                                            temperature, margin, block=block)
    x.backward(dx)
    return float(got), float(want.detach()), e_twin.grad, e_plain.grad


@pytest.mark.parametrize("margin,temperature,n,pad,block", [
    (0.0, 0.07, 40, 0, 16),   # ragged last tile (16 + 16 + 8)
    (0.2, 0.07, 40, 12, 16),  # padded rows
    (1.5, 0.5, 37, 5, 8),
    (0.2, 0.5, 23, 0, 64),    # one tile wider than M
    (0.0, 0.5, 50, 3, 7),
    (1.5, 0.07, 45, 4, 13),   # the margin's kink reached by many negatives
])
def test_blockwise_twin_matches_autograd(margin, temperature, n, pad, block):
    emb, labels, gids, cats, valid = _inputs(n + block, n, pad=pad)
    got, want, g_got, g_want = _twin_vs_autograd(emb, labels, gids, cats, valid, margin,
                                                 temperature, block)
    assert want > 0 and abs(got - want) <= 1e-12 * abs(want)
    scale = float(g_want.abs().max())
    assert scale > 0 and float((g_got - g_want).abs().max()) <= 1e-12 * scale
    if pad:  # padding rows get no gradient
        assert float(g_got[-pad:].abs().max()) == 0.0


@pytest.mark.parametrize("margin", [0.0, 0.2])
def test_blockwise_twin_without_positives_is_zero(margin):
    emb, _, gids, cats, valid = _inputs(3, 12)
    labels = torch.arange(12, dtype=torch.int64)
    got, want, g_got, g_want = _twin_vs_autograd(emb, labels, gids, cats, valid, margin,
                                                 0.1, 5)
    assert got == 0.0 and want == 0.0
    assert float(g_got.abs().max()) == 0.0 and float(g_want.abs().max()) == 0.0


@pytest.mark.parametrize("margin", [0.0, 0.2])
def test_blockwise_twin_row_without_entries(margin):
    """One label for every valid row: no negatives anywhere, positives
    across graphs, and a non-conserved row that is in no pair at all (its
    log-sum-exp runs over nothing)."""
    emb, _, gids, cats, valid = _inputs(5, 20, pad=2)
    labels = torch.zeros(22, dtype=torch.int64)
    labels[-2:] = torch.tensor([-1, -2])
    cats[:-2] = 0
    cats[0] = 4
    got, want, g_got, g_want = _twin_vs_autograd(emb, labels, gids, cats, valid, margin,
                                                 0.1, 6)
    assert want > 0 and abs(got - want) <= 1e-12 * abs(want)
    scale = float(g_want.abs().max())
    assert float((g_got - g_want).abs().max()) <= 1e-12 * scale
    assert float(g_got[0].abs().max()) == 0.0


def test_blockwise_twin_float32_close_to_plain():
    """In float32 the twin stays within float32 noise of the plain loss."""
    emb, labels, gids, cats, valid = _inputs(11, 60, d=32, pad=4, dtype=np.float32)
    cfg = L.AlignmentLossConfig(margin=0.2, temperature=0.1)
    x = _normalise(emb)
    want = float(L.plain_alignment_loss(x, labels, gids, cats, valid, cfg))
    got, _ = CL.contrastive_loss_blockwise(x, labels, gids, cats, valid, 0.1, 0.2, block=16)
    assert abs(float(got) - want) <= 1e-6 * abs(want)


def test_row_flags_and_padding():
    valid = torch.tensor([1.0, 0.0, 1.0, 0.5])
    cats = torch.tensor([0, 2, 3, 5], dtype=torch.int32)
    assert CL._row_flags(valid, cats).tolist() == [3, 2, 1, 1]
    x = torch.ones(3, 40)
    xp = CL._padded(x)
    assert xp.shape == (3, 64) and float(xp[:, 40:].abs().max()) == 0.0
    assert CL._padded(torch.ones(2, 64)).shape == (2, 64)
    assert CL._padded(torch.ones(2, 20, dtype=torch.float64)).shape == (2, 32)


def test_kernel_route_refuses_cpu_tensors():
    emb, labels, gids, cats, valid = _inputs(2, 8, dtype=np.float32)
    with pytest.raises(ValueError, match="CUDA device"):
        CL.contrastive_loss(_normalise(emb), labels, gids, cats, valid, 0.1, 0.2)


# -- on the card -----------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run there: python -m pytest --noconftest "
                    "tests/test_torch_contrastive_loss.py -m card)")
    from ginfinity_tpu_torch.utils.device import disable_tf32

    disable_tf32()
    return torch.device("cuda", 0)


@pytest.fixture
def smoke():
    """``chip_smoke.py``, whose train phase runs the same kernel checks."""
    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke

    return chip_smoke


@pytest.mark.card
def test_kernel_at_the_cell_size(cuda_device, smoke):
    smoke.check_loss_kernel(smoke.loss_kernel_vs_plain(smoke.LOSS_CELL_M, smoke.LOSS_DIM,
                                                       cuda_device))


@pytest.mark.card
def test_kernel_past_2_31_pairs(cuda_device, smoke):
    smoke.check_loss_kernel(smoke.loss_kernel_vs_plain(smoke.LOSS_WIDE_M, smoke.LOSS_DIM,
                                                       cuda_device, plain=False))


@pytest.mark.card
@pytest.mark.parametrize("m,d,margin,temperature", [
    (3000, 200, 0.2, 0.1), (1000, 128, 0.0, 0.07), (777, 33, 1.5, 0.5), (1, 8, 0.2, 0.1),
])
def test_kernel_small_shapes(cuda_device, m, d, margin, temperature):
    """Ragged tiles, padded widths, margins and temperatures, in float32
    against the float64 twin and in float64 against it to 1e-12."""
    emb, labels, gids, cats, valid = _inputs(m, m, d=d, n_labels=max(2, m // 8),
                                             n_graphs=5, dtype=np.float32)
    emb, labels, gids, cats, valid = (t.to(cuda_device) for t in
                                      (emb, labels, gids, cats, valid))
    cfg = L.AlignmentLossConfig(margin=margin, temperature=temperature)
    x64 = _normalise(emb.double())
    want, dx64 = CL.contrastive_loss_blockwise(x64, labels, gids, cats, valid, temperature,
                                               margin, block=256)
    for dtype, tol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        x = x64.to(dtype).requires_grad_(True)
        got = CL.contrastive_loss(x, labels, gids, cats, valid, temperature, margin)
        got.backward()
        scale = max(float(dx64.abs().max()), 1e-30)
        assert abs(float(got) - float(want)) <= tol * max(abs(float(want)), 1e-30)
        assert float((x.grad.double() - dx64).abs().max()) <= tol * scale, dtype
    assert float(L.alignment_contrastive_loss(emb, labels, gids, cats, valid, cfg)) == \
        pytest.approx(float(want), rel=1e-5, abs=1e-7)


def _float32_route(dev, m, d, margin, distinct_labels=False, temperature=0.1):
    """The float32 kernel route twice on normalised random float32 rows, and
    the float64 twin on the same rows: ``(runs, (loss64, dx64))``, each run
    ``(loss, dloss/dx)``."""
    emb, labels, gids, cats, valid = _inputs(7 * m + d, m, d=d, n_labels=max(2, m // 8),
                                             n_graphs=5, dtype=np.float32)
    if distinct_labels:
        labels = torch.arange(m, dtype=torch.int64)
    emb, labels, gids, cats, valid = (t.to(dev) for t in (emb, labels, gids, cats, valid))
    x32 = _normalise(emb.double()).float()
    want = CL.contrastive_loss_blockwise(x32.double(), labels, gids, cats, valid, temperature,
                                         margin, block=1024)
    runs = []
    for _ in range(2):
        x = x32.clone().requires_grad_(True)
        got = CL.contrastive_loss(x, labels, gids, cats, valid, temperature, margin)
        got.backward()
        runs.append((got.detach(), x.grad))
    return runs, want


@pytest.mark.card
@pytest.mark.parametrize("margin", [0.0, 0.2])
@pytest.mark.parametrize("d", [64, 500, 512])
@pytest.mark.parametrize("m", [1, 63, 1000, 4097, 32768])
def test_float32_route_against_float64_twin(cuda_device, m, d, margin):
    """The float32 route (3xTF32 ``wgmma``) at ragged M and D: loss and
    gradient within 1e-5 of the float64 twin on the same rows (relative;
    the gradient's largest element gap over its largest element), and a
    second call on the same inputs equal bit for bit."""
    runs, (want, dx64) = _float32_route(cuda_device, m, d, margin)
    (got, g), (got2, g2) = runs
    assert torch.equal(got, got2) and torch.equal(g, g2)
    scale = max(float(dx64.abs().max()), 1e-30)
    assert abs(float(got) - float(want)) <= 1e-5 * max(abs(float(want)), 1e-30)
    assert float((g.double() - dx64).abs().max()) <= 1e-5 * scale


@pytest.mark.card
@pytest.mark.parametrize("margin", [0.0, 0.2])
def test_float32_route_without_positives(cuda_device, margin):
    """Distinct labels everywhere: no positive pair, so the loss and its
    gradient are exactly 0, twice."""
    runs, (want, dx64) = _float32_route(cuda_device, 1000, 500, margin, distinct_labels=True)
    assert float(want) == 0.0 and float(dx64.abs().max()) == 0.0
    for got, g in runs:
        assert float(got) == 0.0 and float(g.abs().max()) == 0.0
