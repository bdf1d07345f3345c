"""K1's staged route (``ops/csrc/windows_encoder.cu`` with no plane in
shared memory: every model wider than 128), where each warp copies its 16
rows of every stage's A block from the workspace into a ring in shared
memory with 16-byte ``cp.async`` and builds its wgmma fragments there.

On the CPU: a Python model of the ring's indexing (``AStager``): every
float of a slot is written by exactly one copy, every fragment read finds
the A element it asks for, and on the 3xTF32 route each fragment read
hits 32 distinct banks.

On a card (marker ``card``; run there with ``python -m pytest --noconftest
tests/test_torch_windows_staged.py -m card``, since the card's machine has
no JAX for ``tests/conftest.py``): the kernel at the forgi-4x512 widths
(256/512/512/512) against the plain version at the windows cell's
``emb_gap`` bar, for windows of 2, 3 and 4 row tiles on both routes; the
flagship's 128 wide at L 200, where its X plane leaves shared memory and
the route runs there too; the longest window the card takes at width
512, past the ring's room, on the workspace route; the launch counter of
the route; and, when a reference build of the kernel's
source is put at ``_k1_reference/windows_encoder.cu`` (for example a
parent commit's, ``git show <rev>:ginfinity_tpu_torch/ops/csrc/windows_encoder.cu``),
equal output bytes from both builds on the same inputs.  This file
imports no JAX.
"""

import json
import subprocess
from pathlib import Path

import pytest
import torch

from ginfinity_tpu_torch.models.gine import GINConfig, GINModel, init_params
from ginfinity_tpu_torch.ops import _build
from ginfinity_tpu_torch.ops.windows_encoder import forward_windows, forward_windows_reference
from ginfinity_tpu_torch.pipelines.fast_windows import (
    _pack_group,
    _prep_corpus_groups,
    _window_chunk,
)

ROOT = Path(__file__).resolve().parents[1]
FORGI = ROOT / "portbench" / "configs" / "forgi-4x512.json"
REFERENCE_SOURCE = ROOT / "_k1_reference" / "windows_encoder.cu"
L = 120
EMB_GAP = 3e-4  # the windows cell's bar on an embedding entry (PERF.md section 2)

# the kernel's tiling: rows a warp's fragments hold, stage depth per route
ROWS_PER_WARP = 16
DEPTH = {"highest": 16, "bf16": 64}


# -- the ring's indexing, on the CPU -----------------------------------------------


def _swizzle(depth: int, row: int) -> int:
    return 2 * (row & 3) if depth == 64 else (row >> 1) & 3


def _copies(depth: int):
    """``AStager::issue``: (lane, smem float offset in the slot, row, first
    column) of every 16-byte copy of one stage."""
    chunks = depth // 4
    for i in range(ROWS_PER_WARP * chunks // 32):
        for lane in range(32):
            row, ch = divmod(lane + 32 * i, chunks)
            yield lane, row * depth + 4 * (ch ^ _swizzle(depth, row)), row, 4 * ch


def _read(depth: int, lane: int, q: int, c: int) -> int:
    """``AStager::operator()``: the slot offset lane ``lane`` reads for its
    row ``q`` and column ``c``."""
    row, col = (lane >> 2) + 8 * q, c & (depth - 1)
    return row * depth + 4 * ((col >> 2) ^ _swizzle(depth, row)) + (col & 3)


def _fragment_reads(depth: int):
    """Per fragment read of ``tile_product``'s stage step (one load
    instruction of the warp), each lane's (q, column) in the stage."""
    if depth == 16:  # two k8 steps, fragment f: row f & 1, column t + 4 (f >> 1)
        for kk in range(2):
            for f in range(4):
                yield [(f & 1, 8 * kk + (lane & 3) + 4 * (f >> 1)) for lane in range(32)]
    else:  # four k16 steps, fragment f: row f & 1, columns 2t + 8 (f >> 1) and the next
        for kk in range(4):
            for f in range(4):
                for half in range(2):
                    yield [(f & 1, 16 * kk + 2 * (lane & 3) + 8 * (f >> 1) + half)
                           for lane in range(32)]


@pytest.mark.parametrize("precision", sorted(DEPTH))
def test_ring_slot_written_once_and_read_back(precision):
    depth = DEPTH[precision]
    held = {}
    for _, off, row, col in _copies(depth):
        for j in range(4):
            assert off + j not in held
            held[off + j] = (row, col + j)
    assert sorted(held) == list(range(ROWS_PER_WARP * depth))
    for reads in _fragment_reads(depth):
        for lane, (q, c) in enumerate(reads):
            assert held[_read(depth, lane, q, c)] == ((lane >> 2) + 8 * q, c)


def test_3xtf32_fragment_reads_hit_distinct_banks():
    for reads in _fragment_reads(DEPTH["highest"]):
        banks = {_read(16, lane, q, c) % 32 for lane, (q, c) in enumerate(reads)}
        assert len(banks) == 32


@pytest.mark.parametrize("precision", sorted(DEPTH))
def test_ring_copies_read_whole_rows(precision):
    """Each copy instruction of the warp (its 32 lanes) reads whole rows of
    the stage, 64 (3xTF32) or 256 (bf16) contiguous bytes each, so every
    32-byte sector it touches is read whole."""
    depth = DEPTH[precision]
    copies = list(_copies(depth))
    for k in range(0, len(copies), 32):
        cols_by_row = {}
        for _, _, row, col in copies[k:k + 32]:
            cols_by_row.setdefault(row, []).append(col)
        for cols in cols_by_row.values():
            assert sorted(cols) == list(range(0, depth, 4))


# -- on the card ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run there: python -m pytest --noconftest "
                    "tests/test_torch_windows_staged.py -m card)")
    from ginfinity_tpu_torch.utils.device import disable_tf32

    disable_tf32()
    return torch.device("cuda", 0)


# windows by the 64-row tiles of their active rows (L + pulled partners):
# one structure each and the range of rows its chosen windows hold
BUCKETS = {
    "2_tiles": ("((((....))))" * 25, 120, 120),           # hairpins inside the window
    "3_tiles": ("((((....))))" * 5 + "(" * 60 + "." * 60 + ")" * 60, 129, 192),
    "4_tiles": ("(" * 130 + "." * 8 + ")" * 130, 193, 240),  # every slot pulled
}


def _forgi(precision: str, dev):
    """The windows cell's model: forgi-4x512's config, weights drawn as the
    cell draws them."""
    from portbench import weights

    md = json.loads(FORGI.read_text())
    cfg = GINConfig.from_metadata(md).with_precision(precision)
    params, state = weights.make(md, 11, dev, trained=True)
    return cfg, params, state


def _flagship(dev):
    """The shipped 6 x 128 architecture with seeded weights."""
    cfg = GINConfig.create(hidden_dim=128, output_dim=128, gin_layers=6,
                           pooling_type="global_mean_pool", node_embed_norm="zscore_l2",
                           norm_type="graph", use_residual=True, normalize_nodes_before_pool=True)
    model = GINModel(cfg, *init_params(torch.Generator().manual_seed(3), cfg)).to(dev)
    return cfg, model.params, model.state


def _windows(cfg, params, bucket: str, dev, C: int = 32, L: int = L):
    """Up to ``C`` windows of length ``L`` of the bucket's structure (a
    key of ``BUCKETS``, or a structure) whose active rows lie in its
    range, built by the main path's own code."""
    structure, lo, hi = BUCKETS[bucket] if bucket in BUCKETS else (bucket, 0, 2 * L)
    per, groups = _prep_corpus_groups(cfg, [structure], L, True, 0.0)
    (n_cap, idxs), = groups.items()
    feats, pts, sidx, starts, _ = _pack_group(cfg, per, n_cap, idxs)
    n = per[idxs[0]][4].size
    x0, flags = _window_chunk(
        cfg, params, torch.from_numpy(feats).to(dev), torch.from_numpy(pts).to(dev, torch.int64),
        torch.from_numpy(sidx[:n]).to(dev, torch.int64),
        torch.from_numpy(starts[:n]).to(dev, torch.int64), L, True)
    rows = L + flags[2].sum(dim=1)
    sel = torch.nonzero((rows >= lo) & (rows <= hi)).flatten()
    sel = sel[torch.linspace(0, sel.numel() - 1, min(C, sel.numel())).long()]
    assert sel.numel() > 0, f"no window of {bucket[:20]} has {lo}-{hi} active rows"
    return x0[sel].contiguous(), tuple(f[sel].contiguous() for f in flags)


@pytest.mark.card
@pytest.mark.parametrize("bucket", sorted(BUCKETS))
@pytest.mark.parametrize("precision", ["highest", "bf16"])
def test_card_wide_route_matches_plain(cuda_device, precision, bucket):
    """K1 at 256/512/512/512 on the staged route against the plain version
    at the same precision, within the windows cell's ``emb_gap`` bar."""
    cfg, params, state = _forgi(precision, cuda_device)
    x0, flags = _windows(cfg, params, bucket, cuda_device)
    counts = (forward_windows.launches, forward_windows.staged_launches)
    got = forward_windows(cfg, params, state, x0, *flags, L)
    want = forward_windows_reference(cfg, params, state, x0, *flags, L)
    torch.cuda.synchronize()
    assert (forward_windows.launches, forward_windows.staged_launches) == (
        counts[0] + 1, counts[1] + 1)
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= EMB_GAP


@pytest.mark.card
def test_card_staged_launches_follow_width(cuda_device):
    """A 512-wide model's launch takes the staged route; the 6 x 128
    flagship's, whose planes stay in shared memory at L 120, does not."""
    wide = _forgi("highest", cuda_device)
    narrow = _flagship(cuda_device)
    for (cfg, p, s), staged in ((wide, 1), (narrow, 0), (wide, 1)):
        x0, flags = _windows(cfg, p, "3_tiles", cuda_device, C=8)
        counts = (forward_windows.launches, forward_windows.staged_launches)
        forward_windows(cfg, p, s, x0, *flags, L)
        assert (forward_windows.launches, forward_windows.staged_launches) == (
            counts[0] + 1, counts[1] + staged)


@pytest.mark.card
@pytest.mark.parametrize("precision", ["highest", "bf16"])
def test_card_128_wide_past_shared_memory_takes_staged_route(cuda_device, precision):
    """The flagship's 128 wide at L 200: its X plane no longer fits in
    shared memory, so the launch stages A, and each layer's one output
    tile is written into the plane its product reads.  Windows of up to
    every slot pulled (2L rows), against the plain version within the
    smoke's float32 (1e-4) and bf16 (2e-3) bars."""
    cfg, p, s = _flagship(cuda_device)
    cfg = cfg.with_precision(precision)
    x0, flags = _windows(cfg, p, "(" * 230 + "." * 8 + ")" * 230, cuda_device, C=48, L=200)
    assert (200 + flags[2].sum(dim=1)).max().item() == 400
    counts = (forward_windows.launches, forward_windows.staged_launches)
    got = forward_windows(cfg, p, s, x0, *flags, 200)
    want = forward_windows_reference(cfg, p, s, x0, *flags, 200)
    torch.cuda.synchronize()
    assert (forward_windows.launches, forward_windows.staged_launches) == (
        counts[0] + 1, counts[1] + 1)
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= (1e-4 if precision == "highest" else 2e-3)


@pytest.mark.card
@pytest.mark.parametrize("precision", ["highest", "bf16"])
def test_card_longest_wide_window_reads_a_from_workspace(cuda_device, precision):
    """At width 512 the longest window the card's shared memory takes is
    the same on both routes (the A ring never shortens the range): past
    the ring's room a launch reads A from the workspace, unstaged, and
    still matches the plain version within the ``emb_gap`` bar."""
    lib, route = _build.library(), int(precision == "bf16")
    fits = [n for n in range(120, 4000)
            if lib.windows_encoder_smem_bytes(n, 512, route) <= _build.HOPPER_SMEM_OPTIN]
    L_max = max(fits)
    assert fits == list(range(120, L_max + 1))
    assert lib.windows_encoder_smem_bytes(L_max, 512, 0) == \
        lib.windows_encoder_smem_bytes(L_max, 512, 1)
    assert lib.windows_encoder_staged(120, 512, route) == 1
    assert lib.windows_encoder_staged(L_max, 512, route) == 0
    cfg, params, state = _forgi(precision, cuda_device)
    x0, flags = _windows(cfg, params, "((((....))))" * (L_max // 12 + 2), cuda_device, C=4,
                         L=L_max)
    counts = (forward_windows.launches, forward_windows.staged_launches)
    got = forward_windows(cfg, params, state, x0, *flags, L_max)
    want = forward_windows_reference(cfg, params, state, x0, *flags, L_max)
    torch.cuda.synchronize()
    assert (forward_windows.launches, forward_windows.staged_launches) == (
        counts[0] + 1, counts[1])
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= EMB_GAP


@pytest.fixture(scope="module")
def reference_library(cuda_device, tmp_path_factory):
    """The kernel built from ``REFERENCE_SOURCE`` alone, bound as
    ``k1_phases.py`` binds a source's build."""
    if not REFERENCE_SOURCE.exists():
        pytest.skip(f"no reference source at {REFERENCE_SOURCE.relative_to(ROOT)} (put "
                    "there the windows_encoder.cu to compare with)")
    lib = tmp_path_factory.mktemp("k1_reference") / "libk1_reference.so"
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-shared",
                    "-o", str(lib), str(REFERENCE_SOURCE)], check=True, capture_output=True)
    import k1_phases

    return k1_phases.bind_windows_library(lib, REFERENCE_SOURCE.read_text())


@pytest.mark.card
@pytest.mark.parametrize("precision", ["highest", "bf16"])
def test_card_wide_route_bit_identical_to_reference_build(cuda_device, reference_library,
                                                          monkeypatch, precision):
    """The same forgi-4x512 chunks through this build and the reference
    build of the kernel: the same output bytes, window for window."""
    cfg, params, state = _forgi(precision, cuda_device)
    chunks = [_windows(cfg, params, b, cuda_device) for b in sorted(BUCKETS)]
    got = [forward_windows(cfg, params, state, x0, *flags, L) for x0, flags in chunks]
    monkeypatch.setattr(_build, "_lib", reference_library)
    want = [forward_windows(cfg, params, state, x0, *flags, L) for x0, flags in chunks]
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
