"""3-state affine pair-HMM forward/backward and profile-DP wavefronts.

Port of ``ginfinity_tpu/ops/pairhmm.py``: batched anti-diagonal loops in
eager torch on an explicit device (no kernel of its own: the JAX package
runs these as XLA scans, outside Pallas).

Sum-product (posteriors), in log space:

  forward   M[i,j] = L[i-1,j-1] + lse(M,X,Y at [i-1,j-1]);  M[0,0] = 0
            X[i,j] = lse(M[i-1,j] + go, X[i-1,j] + ge)
            Y[i,j] = lse(M[i,j-1] + go, Y[i,j-1] + ge)
  backward  B_M[i,j] = lse(L[i,j] + B_M[i+1,j+1], go + B_X[i+1,j], go + B_Y[i,j+1])
            B_X[i,j] = lse(L[i,j] + B_M[i+1,j+1], ge + B_X[i+1,j])
            B_Y[i,j] = lse(L[i,j] + B_M[i+1,j+1], ge + B_Y[i,j+1])
  posterior P[i-1,j-1] = exp(M[i,j] + B_M[i,j] - Z)

The states are float32 and every add that the JAX package rounds in
float32 is rounded in float32 here.  Each log-sum-exp, the calibration
and the final ``exp`` are evaluated in float64 and rounded once: the
float32 ``exp``/``log`` of the card and of the CPU differ in the last
bit, and at the family scale (states ~1e3, ulp ~1e-4) one such bit
moves a posterior by ~1e-4; rounded once from float64, both give the
same float32.  Products that feed the posteriors (the cosine scores,
the expected score) are float64 products rounded once for the same
reason.

Profile DP (max-plus), with the reference's value-based traceback:
``_profile_wavefront`` scores a given matrix (library mode, and profile
mode under ``GINFINITY_PROFILE_DP=fast``); ``_profile_wavefront_exact``
is the reference's exact float32 op order (profile mode's default): the
column dot accumulated over the embedding dim with one rounded multiply
and one rounded add per term, ``M = (best + s) + comp`` as two adds,
and the boundary chains out of the recurrence.  Every one of these is a
separate eager elementwise op, rounded on its own on the CPU and the
card alike, so the DP matrices are the same bits on both (and the same
as the reference's; XLA on the CPU contracts the dot's multiply-add
into an FMA, the TPU and this port do not).

Each diagonal is stored with one padding column of NEG (before index 0
for the forward loops, after the last index for the backward loop), so
the shifted neighbours ``x[i-1]`` and ``x[i+1]`` are views, not copies.
The state tensors are ``[D+1, 3, B, I+1]`` with the states in the order
X, M, Y, so that ``(X, M)`` at ``i-1`` and ``(M, Y)`` at ``i`` of the
previous diagonal are two views of one tensor.

Padding is masked by the real lengths and changes no real cell, so a
batch runs at its own largest lengths; the JAX package's shape ladders
(``_pow2_batch``, ``_profile_pad_shape``) are compile-cache machinery
and are not ported.  The value traceback runs on the host over the
dense M/X/Y, downloaded once per batch.
"""

from __future__ import annotations

import numpy as np
import torch

from ginfinity_tpu_torch.utils.device import resolve_device

NEG = float(np.float32(-1e30))  # the float32 value, as a Python float
_F32 = torch.float32
_F64 = torch.float64
# sigmoid clip bounds as float32 constants, as JAX makes them
_P_LO = float(np.float32(1e-6))
_P_HI = float(np.float32(1.0 - 1e-6))


# ---------------------------------------------------------------------------
# log-sum-exp, float64 inside, one float32 rounding


def _lse(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """``m + log(sum(exp(x - m)))`` over ``dim`` with ``m`` clamped at NEG,
    evaluated in float64 and rounded once to the dtype of ``x``.  All
    terms at NEG give NEG (NEG + log(n) rounds back to NEG)."""
    dt = x.dtype
    x = x.to(_F64)
    m = x.amax(dim=dim, keepdim=True).clamp_min_(NEG)
    return (m.squeeze(dim) + (x - m).exp_().sum(dim=dim).log_()).to(dt)


def _lse2(a, b):
    return _lse(torch.stack([a, b]))


def _lse3(a, b, c):
    return _lse(torch.stack([a, b, c]))


def _lse_masked_rows(vals, mask):
    """Per-row logsumexp over masked entries; NEG where the mask is
    empty."""
    v = torch.where(mask, vals, NEG)
    return _lse(v, dim=1)


def _f32(x, dev, dtype=_F32) -> torch.Tensor:
    """The float32 value of ``x`` as a 0-dim tensor of ``dtype``."""
    return torch.tensor(float(np.float32(x)), dtype=dtype, device=dev)


def _fma_chain(go: float, ge: float, k: torch.Tensor, dtype=_F32) -> torch.Tensor:
    """``go + ge * (k - 1)`` rounded once, as the fused multiply-add XLA
    makes of the JAX package's expression."""
    return (float(np.float32(go)) + float(np.float32(ge)) * (k.to(_F64) - 1.0)).to(dtype)


def _gap_offsets(go, ge, dtype, dev) -> torch.Tensor:
    """(ge, go, go, ge) as [4, 1, 1]: the adds of (X, M) at i-1 and
    (M, Y) at i in the X/Y updates."""
    g_o, g_e = float(np.float32(go)), float(np.float32(ge))
    return torch.tensor([g_e, g_o, g_o, g_e], dtype=dtype, device=dev)[:, None, None]


def _shear(L: torch.Tensor, D: int, shift: int) -> torch.Tensor:
    """``L[:, i - shift, d - i - shift]`` (indices clipped into range) for
    every diagonal ``d`` in ``0..D`` and row ``i`` in ``0..L1``, as one
    gather: ``[D+1, B, L1+1]``."""
    B, L1, L2 = L.shape
    dev = L.device
    i = torch.arange(L1 + 1, device=dev)
    d = torch.arange(D + 1, device=dev)[:, None]
    ii = i[None, :] - shift
    jj = d - i[None, :] - shift
    flat = ii.clamp(0, L1 - 1) * L2 + jj.clamp(0, L2 - 1)  # [D+1, I]
    return L.reshape(B, L1 * L2)[:, flat].permute(1, 0, 2).contiguous()


def _valid(D: int, L1: int, l1: torch.Tensor, l2: torch.Tensor) -> torch.Tensor:
    """[D+1, B, L1+1]: cell (i, d-i) lies inside the pair's matrix."""
    dev = l1.device
    i = torch.arange(L1 + 1, device=dev)
    j = torch.arange(D + 1, device=dev)[:, None] - i[None, :]  # [D+1, I]
    return ((i[None, None, :] <= l1[None, :, None]) & (j[:, None, :] >= 0)
            & (j[:, None, :] <= l2[None, :, None]))


# ---------------------------------------------------------------------------
# pair-HMM sum-product


def _forward_states(L, l1, l2, go, ge, local: bool):
    """Forward states of every diagonal, ``[D+1, 3 (X, M, Y), B, I+1]``
    with a NEG padding column before index 0."""
    B, L1, L2 = L.shape
    D = L1 + L2
    dev = L.device
    l1 = l1.to(dev, torch.int64)
    l2 = l2.to(dev, torch.int64)
    dt = L.dtype
    S = _shear(L, D, 1)
    valid = _valid(D, L1, l1, l2)
    ST = torch.full((D + 1, 3, B, L1 + 2), NEG, dtype=dt, device=dev)
    if not local:
        ST[0, 1, :, 1] = 0.0
    offs = _gap_offsets(go, ge, dt, dev)
    # boundary columns: i = 0 (index 1) and j = 0 (index d + 1)
    d = torch.arange(D + 1, device=dev)
    chain = _fma_chain(go, ge, d, dt)  # go + ge * (d - 1)
    col_i0 = torch.full((D + 1, 3, B), NEG, dtype=dt, device=dev)
    col_j0 = torch.full((D + 1, 3, B), NEG, dtype=dt, device=dev)
    if not local:
        col_i0[:, 2] = torch.where(d[:, None] <= l2[None, :], chain[:, None], NEG)
        col_j0[:, 0] = torch.where(d[:, None] <= l1[None, :], chain[:, None], NEG)
    zero = torch.zeros((), dtype=dt, device=dev)
    neg = torch.tensor(NEG, dtype=dt, device=dev)
    neg3 = torch.full((3, B, L1 + 1), NEG, dtype=dt, device=dev)
    for k in range(1, D + 1):
        prev2 = ST[k - 2, :, :, :-1] if k >= 2 else neg3
        merge = _lse(prev2)
        if local:
            merge = _lse2(merge, zero.expand_as(merge))
        M = S[k] + merge
        prev = ST[k - 1]
        terms = torch.cat([prev[0:2, :, :-1], prev[1:3, :, 1:]]) + offs
        XY = _lse(terms.view(2, 2, B, L1 + 1), dim=1)
        new = torch.stack([XY[0], M, XY[1]])
        torch.where(valid[k][None], new, neg, out=ST[k, :, :, 1:])
        ST[k, :, :, 1] = col_i0[k]
        if k <= L1:
            ST[k, :, :, k + 1] = col_j0[k]
    return ST


def _forward(L, l1, l2, go, ge, local: bool = False):
    """Sum-product forward. Returns (M diagonals [D+1, B, I], Z [B]).

    ``local=True``: every match cell may start a fresh alignment (the +1
    restart term in the M merge), there are no leading-gap boundary
    chains, and Z sums alignment weight over all match cells."""
    ST = _forward_states(L, l1, l2, go, ge, local)
    return ST[:, 1, :, 1:], _partition(ST, l1, l2, local)


def _partition(ST, l1, l2, local: bool):
    B = ST.shape[2]
    dev = ST.device
    l1 = l1.to(dev, torch.int64)
    l2 = l2.to(dev, torch.int64)
    if local:
        # every match cell (M is NEG elsewhere) ends an alignment
        M = ST[:, 1, :, 1:].permute(1, 0, 2).reshape(B, -1)
        return _lse(M, dim=1)
    b = torch.arange(B, device=dev)
    end = ST[l1 + l2, :, b, l1 + 1]  # [B, 3]
    return _lse(end.T)


def _backward_states(L, l1, l2, go, ge, local: bool):
    """Backward states ``[D+1, 3 (X, M, Y), B, I+1]`` with a NEG padding
    column after the last index."""
    B, L1, L2 = L.shape
    D = L1 + L2
    dev = L.device
    l1 = l1.to(dev, torch.int64)
    l2 = l2.to(dev, torch.int64)
    # L[i, j] for the transition out of (i, j); NEG outside the matrix
    S = _shear(L, D, 0)
    i = torch.arange(L1 + 1, device=dev)
    j = torch.arange(D + 1, device=dev)[:, None] - i[None, :]
    in_range = (i[None, None, :] < l1[None, :, None]) & (j[:, None, :] < l2[None, :, None])
    S = torch.where(in_range, S, NEG)
    dt = L.dtype
    valid = _valid(D, L1, l1, l2)
    ST = torch.full((D + 1, 3, B, L1 + 2), NEG, dtype=dt, device=dev)
    g_o, g_e = float(np.float32(go)), float(np.float32(ge))
    ninf = float("-inf")
    # output k in (X, M, Y) = lse over terms (diag, B_X[i+1] + g, B_Y[j+1] + g)
    offs = torch.tensor([[0.0, g_e, ninf], [0.0, g_o, g_o], [0.0, ninf, g_e]],
                        dtype=dt, device=dev)[:, :, None, None]
    match = None
    if local:
        match = (i[None, None, :] >= 1) & (j[:, None, :] >= 1)
        match = match.expand(D + 1, B, L1 + 1)
    ends = {}
    if not local:
        for b, e in enumerate((l1 + l2).tolist()):
            ends.setdefault(e, []).append(b)
    zero = torch.zeros((), dtype=dt, device=dev)
    neg = torch.tensor(NEG, dtype=dt, device=dev)
    for k in range(D, -1, -1):
        BMdd = ST[k + 2, 1, :, 1:] if k + 2 <= D else None
        diag = S[k] + BMdd if BMdd is not None else S[k] + NEG
        if k + 1 <= D:
            nxt = ST[k + 1]
            A = torch.stack([diag, nxt[0, :, 1:], nxt[2, :, :-1]])
        else:
            A = torch.stack([diag, diag.new_full(diag.shape, NEG),
                             diag.new_full(diag.shape, NEG)])
        out = _lse(A[None] + offs, dim=1)  # [3, B, I]
        if local:
            BMr = _lse2(out[1], zero.expand_as(out[1]))
            out[1] = torch.where(match[k], BMr, out[1])
        torch.where(valid[k][None], out, neg, out=ST[k, :, :, :-1])
        if k in ends:
            bs = torch.tensor(ends[k], device=dev)
            ST[k, :, bs, l1[bs]] = 0.0
    return ST


def _backward(L, l1, l2, go, ge, local: bool = False):
    """Sum-product backward; returns B_M over diagonals [D+1, B, I].

    ``local=True``: every match cell may end an alignment (a +1 term in
    B_M), in place of the global end-at-(l1, l2) condition."""
    return _backward_states(L, l1, l2, go, ge, local)[:, 1, :, :-1]


def _posteriors_dense(L, l1, l2, go, ge, local: bool = False):
    """Forward + backward + dense posteriors ``[B, L1, L2]``; the
    diagonal-major states stay on the device."""
    _, L1, L2 = L.shape
    dev = L.device
    F = _forward_states(L, l1, l2, go, ge, local)
    Z = _partition(F, l1, l2, local)
    Bk = _backward_states(L, l1, l2, go, ge, local)
    # cell (i+1, j+1) lives on diagonal i+j+2 at index i+1
    ii = torch.arange(L1, device=dev)[:, None]
    jj = torch.arange(L2, device=dev)[None, :]
    dsel = ii + jj + 2
    isel = (ii + 1).expand(L1, L2)
    Mf = F[:, 1].permute(1, 0, 2)[:, dsel, isel + 1]  # [B, L1, L2]
    Mb = Bk[:, 1].permute(1, 0, 2)[:, dsel, isel]
    t = (Mf + Mb) - Z[:, None, None]
    return t.clamp(-80.0, 0.0).to(_F64).exp_().to(L.dtype)


def pairhmm_posteriors(score_mats: list, gap_open: float, gap_extend: float,
                       mode: str = "global", device=None) -> list:
    """Batched match posteriors P(i~j) for log-odds matrices: per pair
    ``[La, Lb]`` float32 in [0, 1].  ``mode="local"`` uses the
    restart/end-anywhere local model."""
    if mode not in ("global", "local"):
        raise ValueError(f"mode must be 'global' or 'local', got {mode!r}")
    dev = resolve_device(device)
    B = len(score_mats)
    L1 = max(m.shape[0] for m in score_mats)
    L2 = max(m.shape[1] for m in score_mats)
    L = np.full((B, L1, L2), -1e4, np.float32)
    l1 = np.zeros(B, np.int64)
    l2 = np.zeros(B, np.int64)
    for k, m in enumerate(score_mats):
        L[k, : m.shape[0], : m.shape[1]] = m
        l1[k], l2[k] = m.shape
    P = _posteriors_dense(torch.from_numpy(L).to(dev), torch.from_numpy(l1).to(dev),
                          torch.from_numpy(l2).to(dev), gap_open, gap_extend,
                          local=mode == "local").cpu().numpy()
    return [P[k, : m.shape[0], : m.shape[1]].copy() for k, m in enumerate(score_mats)]


def _pad_value(dtype) -> float:
    """What a cell outside a pair's matrix holds in the padded dense
    posteriors: ``exp(-80)``, the floor of every real cell too."""
    return float(torch.tensor(-80.0, dtype=_F64).exp().to(dtype))


def _pair_posteriors_from_embs(embs, lens, ia, ib, alpha, beta, go, ge, pmin,
                               local: bool, topk: int, base_embs=None,
                               has_base=None, seq_weight=None):
    """Embedding-resident posterior stage for a batch of pairs.

    embs [N, W, d] (rows L2-normalized, zero-padded), lens [N], ia/ib [B]
    pair indices, all on one device.  Cosine scores (blended with the
    base-embedding cosines by ``seq_weight`` where both records carry
    base embeddings, ``has_base`` [N] 0/1), log-odds calibration,
    forward/backward posteriors and the row-and-column top-k
    sparsification with ``pmin``; returns the kept entries as row slabs
    ``kvals`` [B, W, k] float32, ``kidx`` [B, W, k] int64 and
    ``expected`` [B] = sum(S * kept P), all on the device.

    The DP runs at the batch's largest lengths; the dense posteriors are
    padded to ``[B, W, W]`` with the value padding cells take at any
    width, so ``k = min(topk, W)`` and the slabs equal the JAX
    package's at its capacity ``Lcap`` whenever ``W >= min(topk, Lcap)``
    (the caller pads ``embs`` so)."""
    dev = embs.device
    dt = embs.dtype
    W = embs.shape[1]
    l1 = lens[ia].to(torch.int64)
    l2 = lens[ib].to(torch.int64)
    L1 = int(l1.max())
    L2 = int(l2.max())
    A = embs[ia, :L1].to(_F64)
    Bm = embs[ib, :L2].to(_F64)
    S = torch.bmm(A, Bm.transpose(1, 2))
    if base_embs is not None:
        Sb = torch.bmm(base_embs[ia, :L1].to(_F64), base_embs[ib, :L2].to(_F64).transpose(1, 2))
        # float32 scores first, then the blend in float32, as JAX orders it
        S, Sb = S.to(dt), Sb.to(dt)
        wb = (_f32(seq_weight, dev, dt) * has_base[ia] * has_base[ib])[:, None, None]
        S = (1.0 - wb) * S + wb * Sb
    S = S.to(dt)
    rows = torch.arange(L1, device=dev)
    cols = torch.arange(L2, device=dev)
    mask = (rows[None, :, None] < l1[:, None, None]) & (cols[None, None, :] < l2[:, None, None])
    x = float(np.float32(alpha)) * S.to(_F64) + float(np.float32(beta))
    p = torch.sigmoid(x).clamp_(_P_LO, _P_HI)
    L = torch.where(mask, (p.log() - torch.log1p(-p)).to(dt), -1e4)
    P = torch.full((ia.shape[0], W, W), _pad_value(dt), dtype=dt, device=dev)
    P[:, :L1, :L2] = _posteriors_dense(L, l1, l2, go, ge, local=local)

    k = min(int(topk), W)
    row_kth = torch.topk(P, k, dim=-1).values[..., -1:]
    col_kth = torch.topk(P, k, dim=-2).values[..., -1:, :]
    full_mask = torch.zeros((ia.shape[0], W, W), dtype=torch.bool, device=dev)
    full_mask[:, :L1, :L2] = mask
    keep = (P >= row_kth) & (P >= col_kth) & (P >= float(np.float32(pmin))) & full_mask
    Pk = torch.where(keep, P, 0.0)
    expected = (S.to(_F64) * Pk[:, :L1, :L2].to(_F64)).sum(dim=(-1, -2)).to(dt)
    kvals, kidx = torch.topk(Pk, k, dim=-1)  # kept entries sit in the row top-k
    return kvals, kidx, expected


# ---------------------------------------------------------------------------
# profile DP (max-plus) and the value traceback


def _profile_states(S, l1, l2, go, ge, C=None):
    """Max-plus wavefront, ``[D+1, 3 (X, M, Y), B, I+1]``.

    ``C is None``: ``M = s + best`` with the closed-form boundary chains
    ``go + ge * (k - 1)`` (the fast DP).  Otherwise the reference's exact
    order ``M = (best + s) + c`` with the chains out of the recurrence
    (``-1e30 + go`` rounds back to ``-1e30``)."""
    B, L1, L2 = S.shape
    D = L1 + L2
    dev = S.device
    l1 = l1.to(dev, torch.int64)
    l2 = l2.to(dev, torch.int64)
    Ssh = _shear(S, D, 1)
    Csh = _shear(C, D, 1) if C is not None else None
    dt = S.dtype
    valid = _valid(D, L1, l1, l2)
    ST = torch.full((D + 1, 3, B, L1 + 2), NEG, dtype=dt, device=dev)
    ST[0, 1, :, 1] = 0.0
    offs = _gap_offsets(go, ge, dt, dev)
    d = torch.arange(D + 1, device=dev)
    if C is None:
        chain = _fma_chain(go, ge, d, dt)
        y_i0 = torch.where(d[:, None] <= l2[None, :], chain[:, None], NEG)
        x_j0 = torch.where(d[:, None] <= l1[None, :], chain[:, None], NEG)
    neg = torch.tensor(NEG, dtype=dt, device=dev)
    neg3 = torch.full((3, B, L1 + 1), NEG, dtype=dt, device=dev)
    for k in range(1, D + 1):
        prev2 = ST[k - 2, :, :, :-1] if k >= 2 else neg3
        best = prev2.amax(dim=0)
        M = Ssh[k] + best if Csh is None else (best + Ssh[k]) + Csh[k]
        prev = ST[k - 1]
        terms = torch.cat([prev[0:2, :, :-1], prev[1:3, :, 1:]]) + offs
        XY = terms.view(2, 2, B, L1 + 1).amax(dim=1)
        torch.where(valid[k][None], torch.stack([XY[0], M, XY[1]]), neg,
                    out=ST[k, :, :, 1:])
        ST[k, 1, :, 1] = NEG  # M at i = 0
        if C is None:
            ST[k, 2, :, 1] = y_i0[k]
        if k <= L1:
            ST[k, 1, :, k + 1] = NEG  # M at j = 0
            if C is None:
                ST[k, 0, :, k + 1] = x_j0[k]
    return ST


def _diagonals(ST):
    return ST[:, 1, :, 1:], ST[:, 0, :, 1:], ST[:, 2, :, 1:]


def _profile_wavefront(S, l1, l2, go, ge):
    """Fast profile DP: (M, X, Y) diagonals, each [D+1, B, L1+1]."""
    return _diagonals(_profile_states(S, l1, l2, go, ge))


def _profile_wavefront_exact(S, C, l1, l2, go, ge):
    """Reference-exact profile DP on split (dot, comp) scores: (M, X, Y)
    diagonals, each [D+1, B, L1+1]."""
    return _diagonals(_profile_states(S, l1, l2, go, ge, C))


def _dense(ST):
    """Diagonal states -> dense float32 (M, X, Y) [B, L1+1, L2+1] on the
    host; cell (i, j) lives on diagonal i+j at index i."""
    D = ST.shape[0] - 1
    L1 = ST.shape[3] - 2
    L2 = D - L1
    dev = ST.device
    ii = torch.arange(L1 + 1, device=dev)[:, None]
    jj = torch.arange(L2 + 1, device=dev)[None, :]
    dense = ST.permute(2, 1, 0, 3)[:, :, ii + jj, ii.expand(L1 + 1, L2 + 1) + 1]
    dense = dense.cpu().numpy()  # [B, 3 (X, M, Y), L1+1, L2+1]
    return dense[:, 1], dense[:, 0], dense[:, 2]


def _profile_dense(S, l1, l2, go, ge):
    """Fast wavefront, un-sheared: dense (M, X, Y) [B, L1+1, L2+1] numpy."""
    return _dense(_profile_states(S, l1, l2, go, ge))


def _walk(M, X, Y, a: int, b: int, n_steps: int) -> np.ndarray:
    neg = np.float32(-1e30)
    ops = np.full(n_steps, 3, np.int8)
    i, j = a, b
    for t in range(n_steps):
        if i == 0 and j == 0:
            break
        best = M[i, j] if (i > 0 and j > 0) else neg
        state = 0
        cx = X[i, j] if i > 0 else neg
        if cx > best:
            state, best = 1, cx
        cy = Y[i, j] if j > 0 else neg
        if cy > best:
            state = 2
        ops[t] = state
        if state != 2:
            i -= 1
        if state != 1:
            j -= 1
    return ops


def _value_traceback(M, X, Y, l1, l2) -> np.ndarray:
    """The reference's value-based traceback on dense [B, L1+1, L2+1]
    float32 M/X/Y (strict-greater priority M, then X, then Y).  Returns
    op codes [B, L1+L2] in traceback (reverse) order: 0 match, 1
    gap-in-B, 2 gap-in-A, 3 padding."""
    n_steps = (M.shape[1] - 1) + (M.shape[2] - 1)
    return np.stack([_walk(M[k], X[k], Y[k], int(l1[k]), int(l2[k]), n_steps)
                     for k in range(M.shape[0])])


def _forward_ops(ops: np.ndarray) -> list:
    return [o[o != 3][::-1].copy() for o in ops]


def _profile_ops_impl(S, l1, l2, go, ge):
    """Fast profile DP + value traceback: codes [B, L1+L2], reverse order."""
    M, X, Y = _profile_dense(S, l1, l2, go, ge)
    return _value_traceback(M, X, Y, l1.cpu().numpy(), l2.cpu().numpy())


def _seq_dot_scores(MUA, MUB):
    """[B, P, d] x [B, Q, d] -> [B, P, Q] with the reference's sequential
    float32 accumulation: one rounded multiply and one rounded add per
    embedding dim (no FMA, no tree reduction)."""
    B, P, d = MUA.shape
    S = torch.zeros((B, P, MUB.shape[1]), dtype=_F32, device=MUA.device)
    for k in range(d):
        S = S + MUA[:, :, k, None] * MUB[:, None, :, k]
    return S


def _comp_bonus(STA, STB):
    """[B, P] x [B, Q] -> [B, P, Q] stem-compatibility bonus: 0.2 where
    both columns lie on the same side of the 0.5 stem-fraction split."""
    agree = (STA[:, :, None] >= 0.5) == (STB[:, None, :] >= 0.5)
    return torch.where(agree, float(np.float32(0.2)), 0.0).to(_F32)


def _profile_ops_from_split_scores(S, C, l1, l2, go, ge):
    """Exact wavefront on split (dot, comp) scores + value traceback."""
    M, X, Y = _dense(_profile_states(S, l1, l2, go, ge, C))
    return _value_traceback(M, X, Y, l1.cpu().numpy(), l2.cpu().numpy())


def _profile_ops_exact_impl(MUA, MUB, STA, STB, l1, l2, go, ge,
                            MBA=None, MBB=None, sw=None):
    """Reference-exact profile DP + value traceback from raw column
    embeddings.  Dual modality in the reference's op order too:
    ``s = (1 - w) * s_struct + w * s_base``, each term rounded."""
    S = _seq_dot_scores(MUA, MUB)
    if MBA is not None:
        Sb = _seq_dot_scores(MBA, MBB)
        w = np.float32(sw)
        S = S * _f32(np.float32(1.0) - w, S.device) + Sb * _f32(w, S.device)
    return _profile_ops_from_split_scores(S, _comp_bonus(STA, STB), l1, l2, go, ge)


def _lengths(pairs) -> tuple[np.ndarray, np.ndarray]:
    return (np.asarray([a.shape[0] for a, _ in pairs], np.int64),
            np.asarray([b.shape[0] for _, b in pairs], np.int64))


def profile_align_batch_ops_exact(mu_pairs, stem_pairs, gap_open: float,
                                  gap_extend: float, base_pairs=None,
                                  seq_weight: float = 0.0, device=None) -> list:
    """Batched reference-exact profile DP from raw column embeddings;
    returns forward-order op sequences (0 match, 1 gap-in-B, 2 gap-in-A)."""
    dev = resolve_device(device)
    B = len(mu_pairs)
    l1, l2 = _lengths(mu_pairs)
    P, Q = int(l1.max()), int(l2.max())
    d = mu_pairs[0][0].shape[1]
    MUA = np.zeros((B, P, d), np.float32)
    MUB = np.zeros((B, Q, d), np.float32)
    STA = np.zeros((B, P), np.float32)
    STB = np.zeros((B, Q), np.float32)
    for k, ((a, b), (sa, sb)) in enumerate(zip(mu_pairs, stem_pairs)):
        MUA[k, : a.shape[0]] = a
        MUB[k, : b.shape[0]] = b
        STA[k, : sa.shape[0]] = sa
        STB[k, : sb.shape[0]] = sb
    t = lambda x: torch.from_numpy(x).to(dev)  # noqa: E731
    kw = {}
    if base_pairs is not None and seq_weight > 0.0:
        db = next((a.shape[1] for a, _ in base_pairs if a is not None), 0)
        if db:
            MBA = np.zeros((B, P, db), np.float32)
            MBB = np.zeros((B, Q, db), np.float32)
            for k, (a, b) in enumerate(base_pairs):
                if a is not None:
                    MBA[k, : a.shape[0]] = a
                if b is not None:
                    MBB[k, : b.shape[0]] = b
            kw = {"MBA": t(MBA), "MBB": t(MBB), "sw": seq_weight}
    ops = _profile_ops_exact_impl(t(MUA), t(MUB), t(STA), t(STB), t(l1), t(l2),
                                  gap_open, gap_extend, **kw)
    return _forward_ops(ops)


def _pad_scores(S_list) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    B = len(S_list)
    l1 = np.asarray([s.shape[0] for s in S_list], np.int64)
    l2 = np.asarray([s.shape[1] for s in S_list], np.int64)
    Sp = np.full((B, int(l1.max()), int(l2.max())), -1e4, np.float32)
    for k, s in enumerate(S_list):
        Sp[k, : s.shape[0], : s.shape[1]] = s
    return Sp, l1, l2


def profile_align_batch_ops(S_list, gap_open: float, gap_extend: float,
                            device=None) -> list:
    """Batched fast profile DP on given score matrices; returns
    forward-order op sequences (0 match, 1 gap-in-B, 2 gap-in-A)."""
    dev = resolve_device(device)
    Sp, l1, l2 = _pad_scores(S_list)
    ops = _profile_ops_impl(torch.from_numpy(Sp).to(dev), torch.from_numpy(l1).to(dev),
                            torch.from_numpy(l2).to(dev), gap_open, gap_extend)
    return _forward_ops(ops)


def profile_align_batch(S_list, gap_open: float, gap_extend: float, device=None) -> list:
    """Batched fast profile DP: per pair the dense (M, X, Y) cropped to
    its real (L1+1, L2+1)."""
    dev = resolve_device(device)
    Sp, l1, l2 = _pad_scores(S_list)
    M, X, Y = _profile_dense(torch.from_numpy(Sp).to(dev), torch.from_numpy(l1).to(dev),
                             torch.from_numpy(l2).to(dev), gap_open, gap_extend)
    return [(M[k, : a + 1, : b + 1], X[k, : a + 1, : b + 1], Y[k, : a + 1, : b + 1])
            for k, (a, b) in enumerate(zip(l1, l2))]


def profile_align(S: np.ndarray, gap_open: float, gap_extend: float, device=None):
    """The profile DP on one score matrix: dense (M, X, Y)
    [(L1+1, L2+1)] for the value-based traceback."""
    return profile_align_batch([S], gap_open, gap_extend, device=device)[0]
