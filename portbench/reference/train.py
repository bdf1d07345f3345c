"""Alignment-mode training in plain PyTorch: the mined node subset, the
alignment-contrastive loss and Adam.

The subset follows the reference trainer's rules, written out here:
every conserved position of every member carries the label
``group * 10**6 + ancestor position``; up to ``max_unaligned`` unaligned
positions a member (chosen by ``rng.choice`` when there are more) carry
labels of their own; then every node whose label occurs on conserved
nodes of two members is kept, and of the rest at most ``max_negatives``,
a ``hard_fraction`` share of them conserved (``rng.permutation`` of each
pool).  The loss is ``mean(1 - cos)`` over cross-member same-label
conserved pairs plus an InfoNCE over the subset at temperature ``T``,
plus a soft margin on the scaled negatives.
"""

from __future__ import annotations

import numpy as np
import torch

CATEGORIES = ("5-paired", "3-paired", "unpaired",
              "unaligned-5-paired", "unaligned-3-paired", "unaligned-unpaired")
STRIDE = 10**6


def member_map(structure: str, posmap: np.ndarray) -> dict:
    """Category -> {1-based position: ancestor position} of one member,
    categories in order of first appearance along the member."""
    cats: dict = {}
    for i, anc in enumerate(posmap):
        base = {"(": "5-paired", ")": "3-paired"}.get(structure[i], "unpaired")
        cat = base if anc >= 0 else "unaligned-" + base
        cats.setdefault(cat, {})[i + 1] = int(anc)
    return cats


def annotations(cats: dict) -> tuple[dict, dict, list]:
    """``(ancestor position -> position, position -> category id,
    sorted unaligned positions)``, in the map's order."""
    mapping, category, unaligned = {}, {}, []
    for name, positions in cats.items():
        cid = CATEGORIES.index(name)
        for pos1, anc in positions.items():
            category[pos1 - 1] = cid
            if cid < 3:
                mapping[anc] = pos1 - 1
            else:
                unaligned.append(pos1 - 1)
    return mapping, category, sorted(unaligned)


def mined_subset(members: list[tuple[int, int, dict, dict, list]], max_unaligned: int,
                 max_negatives: int, hard_fraction: float, rng) -> dict:
    """The subset of one batch.  ``members``: per member in batch order
    ``(group, node offset, mapping, category, unaligned)``.  Returns
    numpy ``index, label, member, category`` arrays."""
    idx, lab, mem, cat = [], [], [], []
    for m, (group, off, mapping, category, unaligned) in enumerate(members):
        for anc, pos in mapping.items():
            idx.append(off + pos)
            lab.append(group * STRIDE + anc)
            mem.append(m)
            cat.append(category.get(pos, 2))
        if max_unaligned > 0 and unaligned:
            k = min(max_unaligned, len(unaligned))
            if k < len(unaligned):
                chosen = [unaligned[i] for i in rng.choice(len(unaligned), size=k, replace=False)]
            else:
                chosen = unaligned[:k]
            for j, pos in enumerate(chosen):
                idx.append(off + pos)
                lab.append(-((m + 1) * STRIDE) - j)
                mem.append(m)
                cat.append(category.get(pos, 5))
    lab_a, cat_a = np.asarray(lab, np.int64), np.asarray(cat, np.int64)
    conserved = cat_a < 3
    values, counts = np.unique(lab_a[conserved], return_counts=True)
    part = conserved & np.isin(lab_a, values[counts >= 2])
    keep = np.nonzero(part)[0]
    cand = np.nonzero(~part)[0]
    size = min(max_negatives, cand.size)
    if size > 0 and keep.size < lab_a.size:
        hard, easy = cand[cat_a[cand] < 3], cand[cat_a[cand] >= 3]
        n_hard = min(int(round(size * hard_fraction)), hard.size)
        n_easy = min(size - n_hard, easy.size)
        parts = [keep]
        if n_hard > 0:
            parts.append(rng.permutation(hard)[:n_hard])
        if n_easy > 0:
            parts.append(rng.permutation(easy)[:n_easy])
        keep = np.sort(np.concatenate(parts))
    return {"index": np.asarray(idx, np.int64)[keep], "label": lab_a[keep],
            "member": np.asarray(mem, np.int64)[keep], "category": cat_a[keep]}


def contrastive_loss(x: torch.Tensor, sub: dict, temperature: float, margin: float,
                     eps: float = 1e-8) -> torch.Tensor:
    """The loss of the subset's embeddings ``x [M, D]``."""
    dev = x.device
    t = lambda a: torch.as_tensor(a, device=dev)
    lab, mem, cat = t(sub["label"]), t(sub["member"]), t(sub["category"])
    u = x / torch.linalg.vector_norm(x, dim=1, keepdim=True).clamp(min=eps)
    cos = u @ u.T
    m = x.shape[0]
    off_diag = ~torch.eye(m, dtype=torch.bool, device=dev)
    same = lab[:, None] == lab[None, :]
    cons = cat < 3
    pos = same & (mem[:, None] != mem[None, :]) & cons[:, None] & cons[None, :] & off_diag
    neg = ~same & off_diag
    n_pos = pos.sum().clamp(min=1)
    pos_term = torch.where(pos, 1.0 - cos, 0.0).sum() / n_pos
    logits = cos / temperature
    both = pos | neg
    low = torch.finfo(logits.dtype).min
    row_max = torch.where(both, logits, low).amax(dim=1, keepdim=True)
    lse = torch.log(torch.where(both, torch.exp(logits - row_max), 0.0)
                    .sum(dim=1, keepdim=True).clamp(min=1e-38)) + row_max
    nce = -torch.where(pos, logits - lse, 0.0).sum() / n_pos
    if margin > 0:
        nce = nce + torch.where(neg, (logits - margin).clamp(min=0.0), 0.0).sum() \
            / neg.sum().clamp(min=1)
    return torch.where(pos.any(), pos_term + nce, 0.0)


class Adam:
    """Adam (b1 0.9, b2 0.999, eps 1e-8, no weight decay) over the leaves
    that receive a gradient."""

    def __init__(self, lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.m, self.v, self.t = {}, {}, 0

    def step(self, leaves: dict, grads: dict) -> None:
        self.t += 1
        c1, c2 = 1.0 - self.b1 ** self.t, 1.0 - self.b2 ** self.t
        with torch.no_grad():
            for k, g in grads.items():
                if g is None:
                    continue
                m = self.m[k] = self.b1 * self.m.get(k, 0.0) + (1.0 - self.b1) * g
                v = self.v[k] = self.b2 * self.v.get(k, 0.0) + (1.0 - self.b2) * g * g
                leaves[k] -= self.lr * (m / c1) / (torch.sqrt(v / c2) + self.eps)
