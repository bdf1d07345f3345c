"""The alignment DP's path around K2: the packing of a batch
(``ops/dp.py::pack_batch``) and the walk of each pair's path where its
codes were made (``ops/dp_traceback.py``, kernel
``csrc/dp_traceback.cu`` on a card).

On the CPU: the packing against ``pad_batch`` and the mesh's dummy pairs,
bit for bit, over arrays that held other values; ``affine_align_batch``
on CPU meshes against the padded batch's plain wavefront and host walk;
the decode of the kernel's path arrays against the host walk's step
lists; and a Python
model of the kernel's loop, line for line (one load a step, its address
chosen without a branch), against ``paths_from_codes`` on random code
bytes and on the plain wavefront's codes.

On a card (marker ``card``; run there with ``python -m pytest --noconftest
tests/test_torch_dp_walk.py -m card``, since the card's machine has no
JAX for ``tests/conftest.py``): the kernel's paths against
``paths_from_codes`` on K2's own codes in both modes, on the warp and the
CTA route, for one pair and 64, with ties, empty local paths and a
two-shard mesh on one card.  This file imports no JAX.
"""

import threading

import numpy as np
import pytest
import torch

from ginfinity_tpu_torch.ops import dp
from ginfinity_tpu_torch.ops.dp_traceback import dp_traceback, paths_from_arrays
from ginfinity_tpu_torch.ops.dp_wavefront import wavefront_plain
from ginfinity_tpu_torch.parallel.mesh import DataMesh
from ginfinity_tpu_torch.utils import trace

MODES = ["global", "local"]


def _ragged(seed, n, lo=1, hi=40, integer=False):
    rng = np.random.default_rng(seed)
    sides = rng.integers(lo, hi, size=(n, 2))
    if integer:  # diag/E/F and open/extend ties everywhere
        return [rng.integers(-2, 3, size=(int(a), int(b))).astype(np.float32)
                for a, b in sides]
    return [rng.standard_normal((int(a), int(b))).astype(np.float32) for a, b in sides]


def _padded(mats, n):
    """``pad_batch`` followed by the mesh's dummy 1 x 1 pairs, as the CPU
    path builds a batch of ``n`` rows."""
    scores, l1, l2 = dp.pad_batch(mats)
    pad = n - len(mats)
    return (np.concatenate([scores, np.zeros((pad, *scores.shape[1:]), np.float32)]),
            np.concatenate([l1, np.ones(pad, np.int32)]),
            np.concatenate([l2, np.ones(pad, np.int32)]))


# -- the packing ------------------------------------------------------------------


def _packed(mats, n, fill):
    """``pack_batch`` into arrays of the batch's shape that start out as
    ``fill``."""
    L1 = max(1, max(m.shape[0] for m in mats))
    L2 = max(1, max(m.shape[1] for m in mats))
    got = (np.full((n, L1, L2), fill, np.float32), np.full(n, -7, np.int32),
           np.full(n, -7, np.int32))
    dp.pack_batch(mats, *got)
    return got


@pytest.mark.parametrize("shards", [1, 2, 3])
def test_pack_batch_equals_pad_batch_and_dummies(shards):
    """Batches of ragged shapes, each over arrays that start out as NaN:
    each equals ``pad_batch`` and the dummy pairs of a mesh of ``shards``
    bit for bit, zeros outside every rectangle."""
    for seed, n_pairs, hi in [(0, 7, 40), (1, 5, 12), (2, 1, 3), (3, 9, 30), (4, 2, 50)]:
        mats = _ragged(seed, n_pairs, hi=hi)
        n = DataMesh(["cpu"] * shards).padded(n_pairs)
        for g, w in zip(_packed(mats, n, np.nan), _padded(mats, n)):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)


def test_pack_batch_single_row_and_column_sides():
    mats = [np.full((1, 6), 2.5, np.float32), np.full((4, 1), -1.0, np.float32),
            np.zeros((0, 3), np.float32)]
    for g, w in zip(_packed(mats, 4, 9.0), _padded(mats, 4)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("shards", [1, 2, 3])
@pytest.mark.parametrize("mode", MODES)
def test_align_batch_on_cpu_meshes_equals_padded_walk(mode, shards):
    """Batches of other sizes in turn, larger and smaller, on a CPU mesh
    of ``shards``: the plain wavefront's scores and the host walk's paths
    of the padded batch, the dummy pairs dropped."""
    mesh = DataMesh(["cpu"] * shards)
    for seed, n_pairs, hi in [(40, 9, 45), (41, 4, 12), (42, 1, 30), (43, 11, 25)]:
        mats = _ragged(seed, n_pairs, hi=hi)
        scores, l1, l2 = dp.pad_batch(mats)
        best, bi, bj, codes = (t.numpy() for t in wavefront_plain(
            torch.from_numpy(scores), torch.from_numpy(l1), torch.from_numpy(l2), -1.5, -0.3,
            mode))
        want = list(zip(best.tolist(), dp.paths_from_codes(codes, l1, l2, bi, bj, mode)))
        assert dp.affine_align_batch(mats, -1.5, -0.3, mode, mesh=mesh) == want


# -- the walk's arrays and its decode ----------------------------------------------


def _arrays(paths, D, junk):
    """Known step lists laid out as the kernel lays them out, the entries
    before each path ``junk``."""
    B = len(paths)
    path_i = np.full((B, D), junk, np.int32)
    path_j = np.full((B, D), junk, np.int32)
    for k, p in enumerate(paths):
        for t, (a, b) in enumerate(p):
            path_i[k, D - len(p) + t] = -1 if a is None else a
            path_j[k, D - len(p) + t] = -1 if b is None else b
    return path_i, path_j, np.array([len(p) for p in paths], np.int32)


@pytest.mark.parametrize("junk", [-2, 0, 7])
def test_decode_known_paths(junk):
    """Paths the host walks give (all-gap ones, the empty local path, a
    path filling its whole row) come back as the same lists of Python
    ints and ``None``, whatever the entries before them hold."""
    rng = np.random.default_rng(0)
    L1, L2 = 4, 5
    plane = rng.integers(0, 256, size=(L1 + L2, L1 + 1), dtype=np.uint8)
    diag = np.zeros_like(plane)
    up = np.full_like(plane, 1 | 4)     # TH up, TE stay in the gap
    left = np.full_like(plane, 2 | 8)   # TH left, TF stay in the gap
    stop = np.full_like(plane, 3)
    paths = [dp._traceback_global(plane, L1, L2), dp._traceback_global(diag, L1, L2),
             dp._traceback_global(up, L1, 0), dp._traceback_global(left, 0, L2),
             dp._traceback_local(stop, L1, L2), dp._traceback_local(plane, 3, 2),
             dp._traceback_local(diag, 0, 0), [(k, None) for k in range(5)] +
             [(None, k) for k in range(4)]]
    assert paths[2] == [(k, None) for k in range(L1)]
    assert paths[3] == [(None, k) for k in range(L2)]
    assert paths[4] == [] and paths[6] == []
    assert len(paths[7]) == L1 + L2
    got = paths_from_arrays(*_arrays(paths, L1 + L2, junk))
    assert got == paths
    assert all(type(x) is int for p in got for s in p for x in s if x is not None)
    assert paths_from_arrays(*_arrays([], L1 + L2, junk)) == []


def test_decode_wide_sides():
    """Indices up to the last of a row past 512 on each side, gaps at
    both ends, and a path of one step beside it."""
    D = 1300
    wide = [[(None, 0)] + [(k, k + 1) for k in range(599)] + [(599, None)] +
            [(None, j) for j in range(600, 700)]]
    paths = wide + [[(None, D - 1)], [(D - 1, None)]]
    assert paths_from_arrays(*_arrays(paths, D, -2)) == paths


def _kernel_model(codes, l1, l2, bi, bj, local):
    """``dp_traceback_kernel`` of ``csrc/dp_traceback.cu`` in Python, one
    thread (pair) at a time, as the kernel writes it: in global mode one
    load a step, of the cell a diagonal step reaches or the cell a gap
    step leaves, and the next state from it without a branch on the
    cell; the path written backwards from the row's end."""
    B, D, W = codes.shape
    path_i = np.full((B, D), -2, np.int32)
    path_j = np.full((B, D), -2, np.int32)
    n = np.zeros(B, np.int32)
    for b in range(B):
        plane = codes[b].reshape(-1)

        def rd(i, j):
            return int(plane[(i + j - 1) * W + i]) if (i or j) else 0

        t = D
        if local:
            i, j = int(bi[b]), int(bj[b])
            while i > 0 and j > 0:
                tb = rd(i, j) & 3
                if tb == 3:
                    break
                di, dj = tb != 2, tb != 1
                t -= 1
                path_i[b, t], path_j[b, t] = (i - 1 if di else -1), (j - 1 if dj else -1)
                i, j = i - di, j - dj
        else:
            i, j = int(l1[b]), int(l2[b])
            state = rd(i, j) & 3
            while i > 0 or j > 0:
                diag, up = state == 0, state == 1
                if (diag and (i == 0 or j == 0)) or (up and i == 0) or \
                        (not diag and not up and j == 0):
                    break
                di, dj = diag or up, not up
                t -= 1
                path_i[b, t], path_j[b, t] = (i - 1 if di else -1), (j - 1 if dj else -1)
                ni, nj = i - di, j - dj
                c = rd(ni, nj) if diag else rd(i, j)
                state = c & 3 if diag else ((c >> 2) & 1 if up else 2 * ((c >> 3) & 1))
                i, j = ni, nj
        n[b] = D - t
    return path_i, path_j, n


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("mode", MODES)
def test_kernel_model_on_random_codes(mode, seed):
    """Random code bytes (TH 3 in global mode too) on planes padded past
    every pair's sides, all-diagonal planes that end on row 0 and column
    0, 1 x 1 and 0-step pairs: the kernel's loop gives the host walk's
    paths, and so does the wrapper's plain route."""
    rng = np.random.default_rng(seed)
    sides = [(1, 1), (4, 9), (9, 4), (0, 5), (5, 0)] + \
        [tuple(rng.integers(1, 30, size=2)) for _ in range(11)]
    l1 = np.array([a for a, _ in sides], np.int32)
    l2 = np.array([b for _, b in sides], np.int32)
    L1, L2 = int(l1.max()) + 3, int(l2.max()) + 5
    codes = rng.integers(0, 256, size=(len(sides), L1 + L2, L1 + 1), dtype=np.uint8)
    codes[1:3] = 0
    bi = np.array([rng.integers(0, a + 1) for a in l1], np.int32)
    bj = np.array([rng.integers(0, b + 1) for b in l2], np.int32)
    bi[:3], bj[:3] = l1[:3], l2[:3]
    want = dp.paths_from_codes(codes, l1, l2, bi, bj, mode)
    model = _kernel_model(codes, l1, l2, bi, bj, mode == "local")
    assert paths_from_arrays(*model) == want
    plain = [t.numpy() for t in dp_traceback(*(torch.from_numpy(x) for x in
                                               (codes, l1, l2, bi, bj)), mode)]
    assert paths_from_arrays(*plain) == want
    np.testing.assert_array_equal(plain[2], model[2])
    tail = np.arange(L1 + L2)[None, :] >= (L1 + L2 - model[2])[:, None]
    np.testing.assert_array_equal(plain[0][tail], model[0][tail])
    np.testing.assert_array_equal(plain[1][tail], model[1][tail])


@pytest.mark.parametrize("integer", [False, True], ids=["normal", "integer_ties"])
@pytest.mark.parametrize("gaps", [(-1.0, -1.0), (-1.5, -0.3)], ids=["-1_-1", "-1.5_-0.3"])
@pytest.mark.parametrize("mode", MODES)
def test_kernel_model_on_wavefront_codes(mode, gaps, integer):
    """The plain wavefront's codes of a ragged batch (with all-negative
    pairs, whose local path is empty): the kernel's loop gives the host
    walk's paths, and ``affine_align_batch`` on the CPU gives them too."""
    mats = _ragged(5 + integer, 9, lo=1, hi=35, integer=integer)
    mats += [np.full((6, 8), -2.0, np.float32), -np.abs(_ragged(9, 1)[0])]
    scores, l1, l2 = dp.pad_batch(mats)
    best, bi, bj, codes = (t.numpy() for t in wavefront_plain(
        torch.from_numpy(scores), torch.from_numpy(l1), torch.from_numpy(l2), *gaps, mode))
    want = dp.paths_from_codes(codes, l1, l2, bi, bj, mode)
    if mode == "local":
        assert want[-1] == [] and want[-2] == []
    assert paths_from_arrays(*_kernel_model(codes, l1, l2, bi, bj, mode == "local")) == want
    got = dp.affine_align_batch(mats, *gaps, mode, device="cpu")
    assert got == [(float(b), p) for b, p in zip(best, want)]


def test_cpu_path_spans_and_counts():
    """A CPU mesh walks on the host, in one ``dp.traceback`` span a batch
    under the root, which counts no pair walked on the card."""
    mats = _ragged(3, 5)
    with trace.recording():
        trace.clear()
        dp.affine_align_batch(mats, -1.0, -1.0, "global", mesh=DataMesh(["cpu", "cpu"]))
        recs = trace.recorded()
    trace.clear()
    root = next(r for r in recs if r.name == "dp.align_batch")
    assert root.counts["walked_on_card"] == 0 and root.counts["pairs"] == len(mats)
    walk = [r for r in recs if r.name == "dp.traceback"]
    assert len(walk) == 1 and walk[0].parent == root.id


def test_wrapper_refuses_other_devices():
    codes = torch.zeros((1, 2, 2), dtype=torch.uint8, device="meta")
    one = torch.ones(1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        dp_traceback(codes, one, one, one, one, "global")
    cpu = torch.zeros((1, 2, 2), dtype=torch.uint8)
    with pytest.raises(ValueError):
        dp_traceback(cpu, *(torch.ones(1, dtype=torch.int32),) * 4, "semiglobal")


# -- on the card -----------------------------------------------------------------


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run there: python -m pytest --noconftest "
                    "tests/test_torch_dp_walk.py -m card)")
    from ginfinity_tpu_torch.utils.device import disable_tf32

    disable_tf32()
    return torch.device("cuda", 0)


def _card_cases():
    """name -> score matrices: the warp route (L1 <= 511) and the CTA
    route (L1 > 511), one pair and 64, integer ties, all-negative pairs."""
    rng = np.random.default_rng(23)
    cta = [rng.standard_normal((int(a), int(b))).astype(np.float32)
           for a, b in zip(rng.integers(20, 560, 6), rng.integers(5, 60, 6))]
    cta[0] = rng.standard_normal((540, 37)).astype(np.float32)
    return {
        "warp_b1": _ragged(11, 1, lo=200, hi=300),
        "warp_b64": _ragged(12, 64, lo=100, hi=420),
        "warp_b64_ties": _ragged(13, 64, lo=5, hi=200, integer=True),
        "cta_b1": [rng.standard_normal((600, 45)).astype(np.float32)],
        "cta_b6": cta,
        "negative": [np.full((30, 41), -2.0, np.float32), -np.abs(_ragged(14, 1, 5, 90)[0])]
        + _ragged(15, 3, hi=60),
    }


def _host_walk_of_k2(mats, gaps, mode, dev):
    """K2 on the padded batch, its codes walked on the host: the paths
    the card's walk must give."""
    from ginfinity_tpu_torch.ops.dp_wavefront import dp_wavefront, route

    scores, l1, l2 = dp.pad_batch(mats)
    t = [torch.from_numpy(x).to(dev) for x in (scores, l1, l2)]
    out = dp_wavefront(*t, *gaps, mode)
    best, bi, bj, codes = (x.cpu().numpy() for x in out)
    return (out, t, route(scores.shape[1])[0],
            [(float(b), p) for b, p in zip(best, dp.paths_from_codes(codes, l1, l2, bi, bj,
                                                                     mode))])


@pytest.mark.card
@pytest.mark.parametrize("gaps", [(-1.0, -1.0), (-1.5, -0.3)], ids=["-1_-1", "-1.5_-0.3"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", sorted(_card_cases()))
def test_card_walk_equals_host_walk_of_k2(cuda_device, case, mode, gaps):
    """The kernel's arrays on K2's own codes decode to the host walk's
    paths, and ``affine_align_batch`` on the card (packing, K2, the walk)
    gives K2's scores and those paths, walking every pair on the card."""
    mats = _card_cases()[case]
    (best, bi, bj, codes), (_, l1, l2), rte, want = _host_walk_of_k2(mats, gaps, mode,
                                                                    cuda_device)
    assert rte == ("cta" if case.startswith("cta") else "warp")
    n0 = dp_traceback.launches
    arrays = [x.cpu().numpy() for x in dp_traceback(codes, l1, l2, bi, bj, mode)]
    assert dp_traceback.launches == n0 + 1
    assert paths_from_arrays(*arrays) == [p for _, p in want]
    if case == "negative" and mode == "local":
        assert want[0][1] == [] and want[1][1] == []
    with trace.recording():
        trace.clear()
        got = dp.affine_align_batch(mats, *gaps, mode, device=cuda_device)
        recs = trace.recorded()
    trace.clear()
    assert got == want
    root = next(r for r in recs if r.name == "dp.align_batch")
    assert root.counts["walked_on_card"] == root.counts["pairs"] == len(mats)
    assert sum(r.name == "dp.traceback" for r in recs) == 1


@pytest.mark.card
@pytest.mark.parametrize("mode", MODES)
def test_card_two_shards_on_one_card(cuda_device, mode):
    """13 pairs over a mesh of two shards on one card (padded to 14 with a
    dummy pair): the paths of one shard alone and of K2's host walk."""
    mats = _ragged(16, 13, lo=3, hi=300)
    *_, want = _host_walk_of_k2(mats, (-1.0, -0.5), mode, cuda_device)
    mesh = DataMesh([cuda_device, cuda_device])
    assert dp.affine_align_batch(mats, -1.0, -0.5, mode, mesh=mesh) == want
    assert dp.affine_align_batch(mats, -1.0, -0.5, mode, device=cuda_device) == want


@pytest.mark.card
def test_card_batches_of_other_sizes_in_turn(cuda_device):
    """Batches of other sizes, larger and smaller, one after the other,
    each packed into page-locked memory that may hold an earlier batch:
    each equals K2's host walk."""
    for seed, n_pairs, hi in [(17, 40, 400), (18, 8, 60), (19, 64, 300), (20, 3, 30)]:
        mats = _ragged(seed, n_pairs, hi=hi)
        *_, want = _host_walk_of_k2(mats, (-1.0, -1.0), "global", cuda_device)
        assert dp.affine_align_batch(mats, -1.0, -1.0, "global", device=cuda_device) == want


@pytest.mark.card
def test_card_batches_from_threads(cuda_device):
    """Four threads aligning batches of other sizes at once, each packing
    into page-locked memory: each equals K2's host walk."""
    jobs = [_ragged(30 + k, 16 + 8 * k, hi=60 + 90 * k) for k in range(4)]
    wants = [_host_walk_of_k2(m, (-1.0, -1.0), "global", cuda_device)[-1] for m in jobs]
    got = [None] * len(jobs)

    def run(k):
        for _ in range(3):
            got[k] = dp.affine_align_batch(jobs[k], -1.0, -1.0, "global", device=cuda_device)

    threads = [threading.Thread(target=run, args=(k,)) for k in range(len(jobs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert got == wants
