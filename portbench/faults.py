"""Faults planted under a cell's timed path, to show that its check
fails them: each ``plant(kind_module, name)`` wraps the program function
the kind calls.  The tests and ``calibrate.py --fault`` use them; the
benchmark's own runs never do.

- ``altered``: an answer changed where it is produced (an embedding
  entry, a step's loss, a score and a path);
- ``half``: half of a batch left out (half of each transcript's
  windows; the loss's mean over half of the subset; the batch step run
  on half of the pairs, its answers copied to the rest);
- ``unchanged``: a train step that returns its state unchanged;
- ``late``: a train step that returns its state unchanged once the
  traffic's checked first steps are past, as a fast path that starts
  only after a warm-up would.
"""

from __future__ import annotations

import dataclasses

FAULTS = {"windows": ("altered", "half"),
          "train_align": ("altered", "half", "unchanged", "late"),
          "align_pairs": ("altered", "half")}
CHECKED_STEPS = 3  # the training traffic's ``checked_steps``


def _windows(mod, name):
    real = mod.embed_corpus_windows

    def embed(*a, **kw):
        out = real(*a, **kw)
        if name == "altered":
            for _, emb in out:
                emb[0, 0] += 1e-2
            return out
        return [(st[: st.size // 2], emb[: st.size // 2]) for st, emb in out]

    mod.embed_corpus_windows = embed


def _train(mod, name):
    if name in ("unchanged", "late"):
        real_make = mod.make_train_step

        def make(cfg, loss_fn, mesh=None):
            real, calls = real_make(cfg, loss_fn), [0]

            def step(ts, batch, gen):
                calls[0] += 1
                if name == "late" and calls[0] <= CHECKED_STEPS:
                    return real(ts, batch, gen)
                loss, _ = loss_fn(cfg, ts.params, ts.model_state, batch, gen)
                ts.step += 1
                return ts, loss.detach()
            return step

        mod.make_train_step = make
        return
    real_loss = mod.alignment_loss_fn

    def loss_fn(loss_cfg):
        inner = real_loss(loss_cfg)

        def fn(cfg, params, mstate, batch, gen):
            if name == "half":
                valid = batch.valid.clone()
                valid[valid.shape[0] // 2:] = 0.0
                batch = dataclasses.replace(batch, valid=valid)
            loss, state = inner(cfg, params, mstate, batch, gen)
            return (loss * 1.01 if name == "altered" else loss), state
        return fn

    mod.alignment_loss_fn = loss_fn


def _align(mod, name):
    real = mod.pair_batch

    def batch(mats, chunk, *a, **kw):
        if name == "half":
            sims, done = real(mats, chunk[: max(1, len(chunk) // 2)], *a, **kw)
            return sims, [done[k % len(done)] for k in range(len(chunk))]
        sims, out = real(mats, chunk, *a, **kw)
        for k in range(0, len(out), 4):
            out[k] = (out[k][0] + 1e-2, out[k][1])
            if k + 1 < len(out) and len(out[k + 1][1]) > 1:
                path = out[k + 1][1]
                out[k + 1] = (out[k + 1][0], path[:-2] + path[-1:] + path[-2:-1])
        return sims, out

    mod.pair_batch = batch


def plant(kind_module, kind: str, name: str) -> None:
    if name not in FAULTS[kind]:
        raise ValueError(f"no fault {name!r} for kind {kind!r}")
    {"windows": _windows, "train_align": _train, "align_pairs": _align}[kind](kind_module, name)

