"""Training losses, as fixed-shape masked tensor ops.

Port of ``ginfinity_tpu/training/losses.py``:

- triplet: ``nn.TripletMarginLoss(margin, p=2)``, its eps inside the norm;
- regression: MSE;
- alignment-contrastive: positive ``mean(1 - cos)`` over cross-graph
  same-label conserved pairs, plus a supervised InfoNCE over the node
  subset with temperature-scaled cosine logits, where pairs of different
  labels (intra-graph ones included) are negatives, plus an optional soft
  margin penalty on the negatives.  The margin compares against the
  TEMPERATURE-SCALED similarities (cos / T), as the reference's loss
  does: a margin meant on the cosine scale must be divided by T.

The subset (pair mining, negative subsampling) is chosen on the host
(``training/data.py``), so the loss sees fixed ``[M]`` label, graph,
category and valid arrays.
"""

from __future__ import annotations

import dataclasses

import torch


def triplet_loss(anchor: torch.Tensor, positive: torch.Tensor, negative: torch.Tensor,
                 margin: float = 1.0, eps: float = 1e-6) -> torch.Tensor:
    """``torch.nn.TripletMarginLoss(margin, p=2)`` with ``eps`` inside the
    norm, for a finite gradient at 0."""
    d_ap = torch.sqrt(((anchor - positive) ** 2).sum(dim=1) + eps)
    d_an = torch.sqrt(((anchor - negative) ** 2).sum(dim=1) + eps)
    return torch.clamp(d_ap - d_an + margin, min=0.0).mean()


def regression_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return ((pred - target) ** 2).mean()


@dataclasses.dataclass(frozen=True)
class AlignmentLossConfig:
    margin: float = 0.0
    temperature: float = 0.1
    eps: float = 1e-8


def alignment_contrastive_loss(
    embeddings: torch.Tensor,  # [M, D] gathered subset node embeddings
    labels: torch.Tensor,  # [M] alignment labels
    graph_ids: torch.Tensor,  # [M]
    categories: torch.Tensor,  # [M] (0-5; < 3 = conserved)
    valid: torch.Tensor,  # [M] float (0 for padding)
    cfg: AlignmentLossConfig = AlignmentLossConfig(),
) -> torch.Tensor:
    x = embeddings / torch.clamp(torch.linalg.vector_norm(embeddings, dim=1, keepdim=True),
                                 min=cfg.eps)
    m = x.shape[0]
    cos = x @ x.T

    vpair = (valid[:, None] > 0) & (valid[None, :] > 0)
    not_diag = ~torch.eye(m, dtype=torch.bool, device=x.device)
    same_label = labels[:, None] == labels[None, :]
    same_graph = graph_ids[:, None] == graph_ids[None, :]
    conserved = categories < 3
    cons_pair = conserved[:, None] & conserved[None, :]

    positive_mask = same_label & ~same_graph & cons_pair & vpair & not_diag
    negative_mask = ~same_label & vpair & not_diag

    n_pos = positive_mask.sum()
    pos_den = torch.clamp(n_pos, min=1)

    # positive term: mean(1 - cos) over positive pairs
    pos_loss = torch.where(positive_mask, 1.0 - cos, 0.0).sum() / pos_den

    # InfoNCE with temperature-scaled cosine logits
    logits = cos / max(cfg.temperature, 1e-8)
    valid_mask = positive_mask | negative_mask
    neg_inf = torch.finfo(logits.dtype).min
    masked = torch.where(valid_mask, logits, neg_inf)
    row_max = torch.amax(masked, dim=1, keepdim=True)
    row_max = torch.where(torch.isfinite(row_max), row_max, 0.0)
    exp = torch.where(valid_mask, torch.exp(masked - row_max), 0.0)
    logsumexp = torch.log(torch.clamp(exp.sum(dim=1, keepdim=True), min=1e-38)) + row_max
    log_probs = logits - logsumexp
    nce = -torch.where(positive_mask, log_probs, 0.0).sum() / pos_den

    # soft margin penalty on (scaled) negative similarities
    if cfg.margin > 0.0:
        n_neg = torch.clamp(negative_mask.sum(), min=1)
        penalty = torch.where(negative_mask, torch.clamp(logits - cfg.margin, min=0.0),
                              0.0).sum() / n_neg
        nce = nce + penalty

    total = pos_loss + nce
    return torch.where(n_pos > 0, total, 0.0)
