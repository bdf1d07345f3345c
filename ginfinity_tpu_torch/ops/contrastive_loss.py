"""The alignment-contrastive loss on the card: the CUDA kernel's wrapper
and its plain blockwise twin.

``training/losses.py::alignment_contrastive_loss`` builds every mask and
intermediate at M x M, and autograd keeps them all for the backward: at
the training cell's M of ~32k that is a dozen tensors of 1-4 GB and
~200 ms a step.  On a CUDA device it instead normalises the rows and
calls :func:`contrastive_loss`, a ``torch.autograd.Function`` over the
hand-written kernel ``csrc/contrastive_loss.cu``: a tiled forward with
an online log-sum-exp, and a backward that recomputes each cosine tile
and adds ``(G + G^T) x`` from closed-form weights, so that no M x M
tensor is made.  Its loss and gradient are those of the plain loss, to
float32 accuracy (float64 inputs run the same algorithm in float64).
In float32 each call first writes the TF32 hi and lo planes of the rows
(and, for the backward, of their transpose) into a scratch buffer that
the wrapper allocates at the size the library asks for.

:func:`contrastive_loss_blockwise` is the kernel's algorithm in plain
PyTorch, column tile by column tile (an ``[M, block]`` tensor at a
time): the CPU tests hold it to autograd of the plain loss, and on the
card it is the float64 reference at sizes whose M x M tensors do not
fit.
"""

from __future__ import annotations

import torch

from ginfinity_tpu_torch.ops import _build

# D is padded with zero columns to a multiple of this (the float32 route's
# pack kernel takes 32 columns a block, the float64 route's cosine stage 16)
_BK = {torch.float32: 32, torch.float64: 16}
_ROWS_PER_CTA = 64


def _row_flags(valid: torch.Tensor, categories: torch.Tensor) -> torch.Tensor:
    """Per row: bit 0 valid (``valid > 0``), bit 1 conserved (category < 3)."""
    return ((valid > 0).to(torch.int32) | ((categories < 3).to(torch.int32) << 1)).contiguous()


def contrastive_loss(x: torch.Tensor, labels: torch.Tensor, graph_ids: torch.Tensor,
                     categories: torch.Tensor, valid: torch.Tensor, temperature: float,
                     margin: float) -> torch.Tensor:
    """The alignment-contrastive loss (0-d, ``x``'s type) of the normalised
    rows ``x`` ([M, D] float32 or float64 on a CUDA device), differentiable
    in ``x``; the metadata are ``[M]`` tensors on the same device.  Each
    forward launch adds one to ``contrastive_loss.launches``, each
    backward one to ``contrastive_loss.backward_launches``."""
    if x.device.type != "cuda":
        raise ValueError(f"contrastive_loss: the kernel runs on a CUDA device, got {x.device}")
    if x.dtype not in _BK or x.dim() != 2:
        raise ValueError("x must be a float32 or float64 [M, D] tensor, got "
                         f"{x.dtype} {tuple(x.shape)}")
    m = x.shape[0]
    for name, t in (("labels", labels), ("graph_ids", graph_ids),
                    ("categories", categories), ("valid", valid)):
        if t.shape != (m,) or t.device != x.device:
            raise ValueError(f"{name} must be a [{m}] tensor on {x.device}, got "
                             f"{tuple(t.shape)} on {t.device}")
    return _Loss.apply(x, labels.to(torch.int64).contiguous(),
                       graph_ids.to(torch.int64).contiguous(), _row_flags(valid, categories),
                       float(max(temperature, 1e-8)), float(margin))


contrastive_loss.launches = 0
contrastive_loss.backward_launches = 0


def _padded(x: torch.Tensor) -> torch.Tensor:
    """``x`` contiguous, with zero columns up to a multiple of the stage depth."""
    bk = _BK[x.dtype]
    d = x.shape[1]
    dp = max(bk, -(-d // bk) * bk)
    x = x.contiguous()
    return x if dp == d else torch.nn.functional.pad(x, (0, dp - d))


def _scratch(is_double: int, m: int, dp: int, backward: int,
             dev: torch.device) -> torch.Tensor:
    """The kernel's scratch for one call, as many bytes as the library asks."""
    n = _build.library().contrastive_loss_scratch_bytes(is_double, m, dp, backward)
    return torch.empty(n, dtype=torch.uint8, device=dev)


class _Loss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lab, grp, flags, temperature, margin):
        xp = _padded(x)
        m, dp = xp.shape
        dev = x.device
        nblk = -(-m // _ROWS_PER_CTA)
        f64 = dict(dtype=torch.float64, device=dev)
        lse = torch.empty(m, **f64)
        pcount = torch.empty(m, dtype=torch.int32, device=dev)
        part_f = torch.empty(4 * nblk, **f64)
        part_i = torch.empty(2 * nblk, dtype=torch.int64, device=dev)
        loss = torch.empty((), dtype=x.dtype, device=dev)
        stats = torch.empty(3, **f64)
        is_double = int(x.dtype == torch.float64)
        scratch = _scratch(is_double, m, dp, 0, dev)
        _build.call("contrastive_loss_forward", dev, is_double,
                    xp.data_ptr(), m, dp, lab.data_ptr(), grp.data_ptr(), flags.data_ptr(),
                    temperature, margin, int(margin > 0.0), lse.data_ptr(), pcount.data_ptr(),
                    part_f.data_ptr(), part_i.data_ptr(), loss.data_ptr(), stats.data_ptr(),
                    scratch.data_ptr())
        contrastive_loss.launches += 1
        ctx.save_for_backward(xp, lab, grp, flags, lse, pcount, stats)
        ctx.d, ctx.temperature, ctx.margin = x.shape[1], temperature, margin
        return loss

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        xp, lab, grp, flags, lse, pcount, stats = ctx.saved_tensors
        m, dp = xp.shape
        dev = xp.device
        grad = grad.to(xp.dtype).contiguous()
        dx = torch.empty_like(xp)
        is_double = int(xp.dtype == torch.float64)
        scratch = _scratch(is_double, m, dp, 1, dev)
        _build.call("contrastive_loss_backward", dev, is_double,
                    xp.data_ptr(), m, dp, lab.data_ptr(), grp.data_ptr(), flags.data_ptr(),
                    ctx.temperature, ctx.margin, int(ctx.margin > 0.0), lse.data_ptr(),
                    pcount.data_ptr(), stats.data_ptr(), grad.data_ptr(), dx.data_ptr(),
                    scratch.data_ptr())
        contrastive_loss.backward_launches += 1
        return dx[:, :ctx.d], None, None, None, None, None


def contrastive_loss_blockwise(x: torch.Tensor, labels: torch.Tensor, graph_ids: torch.Tensor,
                               categories: torch.Tensor, valid: torch.Tensor,
                               temperature: float, margin: float,
                               block: int = 2048) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's algorithm in plain PyTorch, on ``x``'s device and type:
    ``(loss, dloss/dx)`` of the normalised rows ``x`` [M, D], by
    column tiles of ``block``: the forward keeps per row an online
    log-sum-exp of ``l = cos / T`` over the pairs in the loss and the count
    of positives; the backward recomputes each tile's cosines and adds
    ``(G + G^T)`` of the tile times its rows of ``x``."""
    t = float(max(temperature, 1e-8))
    m = x.shape[0]
    lab, grp = labels.to(torch.int64), graph_ids.to(torch.int64)
    flags = _row_flags(valid, categories)
    rows = torch.arange(m, device=x.device)
    neg_inf = torch.tensor(float("-inf"), dtype=x.dtype, device=x.device)

    def tile(c0):
        """Cosines, l, and the positive and negative masks of columns c0.."""
        cols = slice(c0, min(c0 + block, m))
        cos = x @ x[cols].T
        both = flags[:, None] & flags[None, cols]
        pair = ((both & 1) > 0) & (rows[:, None] != rows[None, cols])
        same = lab[:, None] == lab[None, cols]
        pos = pair & same & (grp[:, None] != grp[None, cols]) & ((both & 2) > 0)
        return cols, cos, cos / t, pos, pair & ~same

    mx = torch.full((m,), float("-inf"), dtype=x.dtype, device=x.device)
    s = torch.zeros(m, dtype=x.dtype, device=x.device)
    p = torch.zeros(m, dtype=torch.int64, device=x.device)
    pos_cos = pos_l = pen = x.new_zeros(())
    nneg = torch.zeros((), dtype=torch.int64, device=x.device)
    for c0 in range(0, m, block):
        _, cos, lt, pos, neg = tile(c0)
        inside = pos | neg
        mn = torch.maximum(mx, torch.where(inside, lt, neg_inf).amax(dim=1))
        live = torch.isfinite(mn)
        scale = torch.where(live, torch.exp(mx - torch.where(live, mn, 0.0)), 0.0)
        s = s * scale + torch.where(inside, torch.exp(lt - mn[:, None]), 0.0).sum(dim=1)
        mx = mn
        p = p + pos.sum(dim=1)
        pos_cos = pos_cos + torch.where(pos, 1.0 - cos, 0.0).sum()
        pos_l = pos_l + torch.where(pos, lt, 0.0).sum()
        nneg = nneg + neg.sum()
        if margin > 0.0:
            pen = pen + torch.where(neg, torch.clamp(lt - margin, min=0.0), 0.0).sum()
    lse = torch.where(s > 0, mx + torch.log(torch.where(s > 0, s, 1.0)), 0.0)
    n_pos = p.sum()
    pd = torch.clamp(n_pos, min=1).to(x.dtype)
    nn = torch.clamp(nneg, min=1).to(x.dtype)
    total = (pos_cos + (p.to(x.dtype) * lse).sum() - pos_l) / pd
    if margin > 0.0:
        total = total + pen / nn
    on = (n_pos > 0).to(x.dtype)
    loss = on * total

    c_pos = on * (-2.0 / pd) * (1.0 + 1.0 / t)
    c_soft = on / (t * pd)
    c_neg = on * 2.0 / (t * nn)
    pf = p.to(x.dtype)
    dx = torch.zeros_like(x)
    for c0 in range(0, m, block):
        cols, _, lt, pos, neg = tile(c0)
        inside = pos | neg
        soft = pf[:, None] * torch.exp(torch.where(inside, lt - lse[:, None], 0.0)) \
            + pf[None, cols] * torch.exp(torch.where(inside, lt - lse[None, cols], 0.0))
        w = torch.where(inside, c_soft * soft, 0.0) + torch.where(pos, c_pos, 0.0)
        if margin > 0.0:
            w = w + torch.where(neg & (lt - margin >= 0), c_neg, 0.0)
        dx = dx + w @ x[cols]
    return loss, dx
