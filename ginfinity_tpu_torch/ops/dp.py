"""Affine-gap alignment (Gotoh) of a batch of pairs, and the walk of its
traceback codes.

Port of ``ginfinity_tpu/ops/dp.py``.  :func:`affine_align_batch` pads a
batch, runs the DP wavefront (``ops/dp_wavefront.py::dp_wavefront``,
which picks the CUDA kernel or the plain version) on each shard's
device, and walks each pair's codes in place on the diagonal planes, on
the device that made them: on a card by the kernel
``csrc/dp_traceback.cu`` (``ops/dp_traceback.py``), so that the planes
never leave it; on the CPU by :func:`paths_from_codes`.
"""

from __future__ import annotations

import numpy as np
import torch

from ginfinity_tpu_torch.ops.dp_wavefront import _check_mode, dp_wavefront
from ginfinity_tpu_torch.parallel.mesh import DataMesh
from ginfinity_tpu_torch.utils import trace
from ginfinity_tpu_torch.utils.device import resolve_device


def _cell_codes(plane: np.ndarray):
    """``code(i, j)`` of one pair's diagonal code plane ``[D, L1+1]``, as
    the wavefront writes it: cell (i, j) sits at ``plane[i + j - 1, i]``;
    cell (0, 0), which has no diagonal, reads 0."""
    flat = memoryview(np.ascontiguousarray(plane, np.uint8)).cast("B")
    w = plane.shape[1]

    def code(i: int, j: int) -> int:
        return flat[(i + j - 1) * w + i] if i or j else 0

    return code


def _traceback_global(plane, l1, l2):
    """Follow TH (``code & 3``) back from ``(l1, l2)``; a gap step stays
    in its gap while TE (``code >> 2 & 1``, up) or TF (``code >> 3 & 1``,
    left) of the cell it leaves says so."""
    code = _cell_codes(plane)
    path = []
    i, j = l1, l2
    state = code(i, j) & 3
    while i > 0 or j > 0:
        if state == 0:
            if i == 0 or j == 0:
                break
            path.append((i - 1, j - 1))
            i -= 1
            j -= 1
            state = code(i, j) & 3
        elif state == 1:
            if i == 0:
                break
            path.append((i - 1, None))
            prev = (code(i, j) >> 2) & 1
            i -= 1
            state = 0 if prev == 0 else 1
        else:
            if j == 0:
                break
            path.append((None, j - 1))
            prev = (code(i, j) >> 3) & 1
            j -= 1
            state = 0 if prev == 0 else 2
    path.reverse()
    return path


def _traceback_local(plane, bi, bj):
    """Follow TH from the best cell until a stop cell (code 3) or an
    edge; a gap step continues through TH at the new cell."""
    code = _cell_codes(plane)
    path = []
    i, j = bi, bj
    while i > 0 and j > 0:
        tb = code(i, j) & 3
        if tb == 3:
            break
        if tb == 0:
            path.append((i - 1, j - 1))
            i -= 1
            j -= 1
        elif tb == 1:
            path.append((i - 1, None))
            i -= 1
        else:
            path.append((None, j - 1))
            j -= 1
    path.reverse()
    return path


def paths_from_codes(codes: np.ndarray, l1: np.ndarray, l2: np.ndarray,
                     bi: np.ndarray, bj: np.ndarray, mode: str) -> list[list]:
    """Walk every pair's ``[D, L1+1]`` code plane back to its path, on
    the host: the walk of a CPU device's codes, and the plain version of
    the card's walk (``ops/dp_traceback.py``), which follows the same
    rules."""
    if mode == "global":
        return [_traceback_global(codes[k], int(l1[k]), int(l2[k]))
                for k in range(codes.shape[0])]
    return [_traceback_local(codes[k], int(bi[k]), int(bj[k])) for k in range(codes.shape[0])]


def pad_batch(score_mats: list[np.ndarray], L1: int | None = None,
              L2: int | None = None) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Score matrices zero-padded into one float32 ``[B, L1, L2]`` array
    (by default the batch's largest sides), with their real sides
    ``l1, l2 [B]`` int32."""
    B = len(score_mats)
    L1 = L1 or max(1, max(m.shape[0] for m in score_mats))
    L2 = L2 or max(1, max(m.shape[1] for m in score_mats))
    scores = np.zeros((B, L1, L2), np.float32)
    l1 = np.zeros(B, np.int32)
    l2 = np.zeros(B, np.int32)
    for k, m in enumerate(score_mats):
        scores[k, : m.shape[0], : m.shape[1]] = m
        l1[k], l2[k] = m.shape
    return scores, l1, l2


def pack_batch(score_mats: list[np.ndarray], scores: np.ndarray, l1: np.ndarray,
               l2: np.ndarray) -> None:
    """Writes what :func:`pad_batch` gives, followed by ``len(scores) -
    len(score_mats)`` dummy 1 x 1 pairs of score 0 (a mesh's padding),
    into the caller's arrays, whatever they held: the scores ``[n, L1,
    L2]``, every cell outside a pair's rectangle 0, and the sides ``l1``,
    ``l2 [n]``."""
    B = len(score_mats)
    for k, m in enumerate(score_mats):
        a, b = m.shape
        scores[k, :a, :b] = m
        scores[k, :a, b:] = 0
        scores[k, a:] = 0
        l1[k], l2[k] = a, b
    scores[B:] = 0
    l1[B:] = l2[B:] = 1


def affine_align_batch(score_mats: list[np.ndarray], gap_open: float, gap_extend: float,
                       mode: str = "global", device=None, mesh=None) -> list[tuple[float, list]]:
    """Align a batch of similarity matrices; returns ``[(score, path)]``
    with paths of ``(i, j)`` steps (``None`` for a gap).

    The batch is padded to its largest ``L1 x L2``; padding cells are
    masked by each pair's real lengths.  The batch axis shards over
    ``mesh`` (``parallel/mesh.py``; by default ``device`` alone, the card
    unless ``"cpu"`` is asked for): the batch is padded with dummy 1 x 1
    pairs to a multiple of the mesh size, each shard's block of pairs runs
    on its device (the kernel on a card), and the results come back in
    order, the dummies dropped.  The batch is packed once
    (:func:`pack_batch`), into page-locked memory when the mesh has a
    card, so that each shard's upload is one asynchronous copy.  Each
    shard's paths are walked where its codes were made
    (``ops/dp_traceback.py``): on a card by the kernel
    ``csrc/dp_traceback.cu``, so that only the scores and paths come
    down, in one synchronisation a card; on the CPU by
    :func:`paths_from_codes`.  The root span also counts
    ``walked_on_card``, the pairs the kernel walked.
    """
    from ginfinity_tpu_torch.ops.dp_traceback import dp_traceback, paths_from_arrays

    _check_mode(mode)
    mesh = mesh or DataMesh([resolve_device(device)])
    if not score_mats:
        return []
    B, n = len(score_mats), mesh.padded(len(score_mats))
    L1 = max(1, max(m.shape[0] for m in score_mats))
    L2 = max(1, max(m.shape[1] for m in score_mats))
    cards = [d for d in dict.fromkeys(mesh.devices) if d.type == "cuda"]
    with trace.span("dp.align_batch") as sp:
        scores = torch.empty((n, L1, L2), dtype=torch.float32, pin_memory=bool(cards))
        lengths = torch.empty((2, n), dtype=torch.int32, pin_memory=bool(cards))
        pack_batch(score_mats, scores.numpy(), *lengths.numpy())
        l1, l2 = lengths.numpy()[:, :B].astype(np.int64)
        sp.add(pairs=B, cells_real=int(((l1 + 1) * (l2 + 1)).sum()),
               cells_padded=B * (L1 + 1) * (L2 + 1),
               walked_on_card=sum(len(r) for r, d in zip(mesh.blocks(B), mesh.devices)
                                  if d.type == "cuda"))
        shards = zip(*(mesh.split(x, non_blocking=True) for x in (scores, *lengths)))
        parts = [(s_l1, s_l2, *dp_wavefront(s, s_l1, s_l2, float(gap_open), float(gap_extend),
                                               mode))
                 for s, s_l1, s_l2 in shards]
        for d in cards:  # K2 done: the walk's span times the walk alone
            torch.cuda.synchronize(d)
        with trace.span("dp.traceback"):
            # a card's results come down into page-locked memory, in one
            # synchronisation a card
            walks = [[t.to("cpu", non_blocking=True) for t in
                      (best, *dp_traceback(codes, s_l1, s_l2, bi, bj, mode))]
                     for s_l1, s_l2, best, bi, bj, codes in parts]
            for d in cards:
                torch.cuda.current_stream(d).synchronize()
            results = [r for best, *walk in walks for r in
                       zip(best.tolist(), paths_from_arrays(*(t.numpy() for t in walk)))]
    return results[:B]


def affine_align(score: np.ndarray, gap_open: float, gap_extend: float,
                 mode: str = "global", device=None) -> tuple[float, list]:
    """One pair (the reference's needleman_wunsch_affine /
    smith_waterman_affine)."""
    return affine_align_batch([score], gap_open, gap_extend, mode, device)[0]
