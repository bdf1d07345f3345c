"""Global affine-gap alignment (Gotoh) in plain PyTorch and Python, with
the reference CLI's traceback.

``H[i, j]`` is the best score of aligning the first ``i`` rows with the
first ``j`` columns, ``E`` ends in a gap in the columns (a step down),
``F`` in a gap in the rows (a step right); opening a gap costs ``go``,
extending it ``ge``; the first row and column are ``go + (k - 1) ge``,
rounded once.  Ties: ``E`` and ``F`` prefer opening from ``H``; ``H``
prefers the diagonal, then ``E``, then ``F``.  The batch runs one
anti-diagonal at a time in float32, recording for each cell where
``H``, ``E`` and ``F`` came from.

The traceback is the reference CLI's (``align_node_embeddings.py``):
from ``(l1, l2)``, a diagonal step re-reads ``H``'s origin at the new
cell; a gap step continues in the gap or, when the gap was opened there,
returns to the diagonal state without re-reading; the walk stops on the
first row or column in the diagonal state.
"""

from __future__ import annotations

import numpy as np
import torch

NEG = -1e9


def _codes(sims: list[np.ndarray], go: float, ge: float, device):
    """``(best [B], TH, TE, TF)``, the codes as ``[B, L1 + 1, L2 + 1]``
    numpy arrays."""
    B = len(sims)
    l1 = np.array([s.shape[0] for s in sims])
    l2 = np.array([s.shape[1] for s in sims])
    L1, L2 = int(l1.max()), int(l2.max())
    S = np.zeros((B, L1 + 1, L2 + 1), np.float32)
    for k, s in enumerate(sims):
        S[k, 1:s.shape[0] + 1, 1:s.shape[1] + 1] = s
    S = torch.as_tensor(S, device=device)
    f32 = torch.float32
    i = torch.arange(L1 + 1, device=device)
    gof = torch.tensor(go, dtype=f32, device=device)
    gef = torch.tensor(ge, dtype=f32, device=device)
    edge = lambda k: (gof.double() + (k.double() - 1.0) * gef.double()).to(f32)
    full = lambda: torch.full((B, L1 + 1), NEG, dtype=f32, device=device)
    H2, H1, E1, F1 = full(), full(), full(), full()
    H1[:, 0] = 0.0
    neg = torch.full((B, 1), NEG, dtype=f32, device=device)
    down = lambda x: torch.cat([neg, x[:, :-1]], dim=1)
    D = L1 + L2
    codes = torch.zeros((3, B, D + 1, L1 + 1), dtype=torch.uint8, device=device)
    best = torch.zeros(B, dtype=f32, device=device)
    ends = torch.as_tensor(l1 + l2, device=device)
    rows = torch.as_tensor(l1, device=device)[:, None]
    for d in range(1, D + 1):
        j = d - i
        inside = (j >= 0) & (j <= L2)
        s = S[:, i, j.clamp(0, L2)]
        eh, ee = down(H1) + gof, down(E1) + gef
        E, TE = torch.maximum(eh, ee), (eh < ee)
        fh, ff = H1 + gof, F1 + gef
        F, TF = torch.maximum(fh, ff), (fh < ff)
        diag = down(H2) + s
        take = (diag >= E) & (diag >= F)
        e_ge_f = E >= F
        H = torch.where(take, diag, torch.where(e_ge_f, E, F))
        TH = torch.where(take, 0, torch.where(e_ge_f, 1, 2))
        bound = (i == 0) | (j == 0)
        H = torch.where(bound, torch.where(i == 0, edge(j), edge(i)), H)
        TH = torch.where(bound, torch.where(i == 0, 2, 1), TH)
        E = torch.where(bound, NEG, E)
        F = torch.where(bound, NEG, F)
        H, E, F = (torch.where(inside, x, NEG) for x in (H, E, F))
        codes[0, :, d] = TH.to(torch.uint8)
        codes[1, :, d] = TE.to(torch.uint8)
        codes[2, :, d] = TF.to(torch.uint8)
        best = torch.where(ends == d, torch.gather(H, 1, rows)[:, 0], best)
        H2, H1, E1, F1 = H1, H, E, F
    codes = codes.cpu().numpy()
    # sheared [d, i] -> dense [i, j = d - i]
    dd, ii = np.meshgrid(np.arange(D + 1), np.arange(L1 + 1), indexing="ij")
    jj = dd - ii
    ok = (jj >= 0) & (jj <= L2)
    dense = np.zeros((3, B, L1 + 1, L2 + 1), np.uint8)
    dense[:, :, ii[ok], jj[ok]] = codes[:, :, dd[ok], ii[ok]]
    return best.cpu().numpy(), dense[0], dense[1], dense[2]


def _walk(TH, TE, TF, l1: int, l2: int) -> list:
    path, i, j = [], l1, l2
    state = TH[i, j]
    while i > 0 or j > 0:
        if state == 0:
            if i == 0 or j == 0:
                break
            path.append((i - 1, j - 1))
            i, j = i - 1, j - 1
            state = TH[i, j]
        elif state == 1:
            if i == 0:
                break
            path.append((i - 1, None))
            state = 0 if TE[i, j] == 0 else 1
            i -= 1
        else:
            if j == 0:
                break
            path.append((None, j - 1))
            state = 0 if TF[i, j] == 0 else 2
            j -= 1
    return path[::-1]


def global_align(sims: list[np.ndarray], go: float, ge: float, device) -> list:
    """``[(score, path)]`` of each similarity matrix, the path's steps
    ``(i, j)`` with ``None`` on a gap."""
    best, TH, TE, TF = _codes(sims, go, ge, device)
    return [(float(best[k]), _walk(TH[k], TE[k], TF[k], *sims[k].shape))
            for k in range(len(sims))]
