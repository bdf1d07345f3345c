"""``ginfinity-generate-base-embeddings`` — per-nucleotide embeddings from
an external RNA language model.

Port of ``ginfinity_tpu/pipelines/base_embed.py``: the same flags,
backends and TSV.  ``--backend rinalmo`` (RiNALMo ``giga-v1``) and
``--backend hf`` (any HuggingFace ``transformers`` encoder, from a hub id
or a local directory: per-residue rows of ``last_hidden_state`` under the
attention mask, re-tokenized as spaced characters when the tokenizer is
not character-level) both trim BOS/EOS rows, with the center-crop
fallback, and write one JSON matrix per row in column
``base_embeddings``, which feeds ``--seq-weight`` in the aligners and
the MSA.  Each backend's package is imported only when it runs; where
it is missing the CLI exits with the JAX package's message.

One deliberate difference: the device.  The JAX package's loaders run
on the CPU unless a device is named, and fall back to the CPU when CUDA
is asked for but missing.  Here, as in every entry point of the port,
``--device`` defaults to the card and raises without one; the CPU runs
only when ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from ginfinity_tpu_torch.utils.device import resolve_device
from ginfinity_tpu_torch.utils.io import Table, cell_text, read_table, write_tsv


def _load_rinalmo(model_name: str, dev: torch.device):
    try:
        from rinalmo.pretrained import get_pretrained_model
    except ImportError as exc:
        raise SystemExit(
            "ERROR: the 'rinalmo' package (and a torch build able to run it) "
            "is required for base embeddings. Install it or skip this step; "
            "all downstream tools accept --seq-weight 0 (structure only)."
        ) from exc
    model, alphabet = get_pretrained_model(model_name=model_name)
    model.eval()
    return model.to(dev), alphabet


def _load_hf(model_name: str, dev: torch.device):
    try:
        from transformers import AutoModel, AutoTokenizer
    except ImportError as exc:
        raise SystemExit(
            "ERROR: the 'transformers' package is required for --backend hf."
        ) from exc
    tokenizer = AutoTokenizer.from_pretrained(model_name)
    model = AutoModel.from_pretrained(model_name)
    model.eval()
    return model.to(dev), tokenizer


def _hf_embed_batch(model, tokenizer, chunk, dev):
    """Per-residue hidden states for a batch of RNA sequences from a
    transformers encoder.  One token per nucleotide is needed; when the
    tokenizer merges characters (BPE/WordPiece) the sequence is
    re-tokenized as space-separated characters, which vocab-lookup
    tokenizers read as one token each."""
    n_special = tokenizer.num_special_tokens_to_add()
    texts = []
    for seq in chunk:
        ids = tokenizer(seq, add_special_tokens=True)["input_ids"]
        texts.append(seq if len(ids) == len(seq) + n_special else " ".join(seq))
    enc = tokenizer(texts, return_tensors="pt", padding=True)
    enc = {k: v.to(dev) for k, v in enc.items()}
    with torch.no_grad():
        out = model(**enc)
    rep = out.last_hidden_state  # [B, T, D]
    mask = enc["attention_mask"].bool()
    return [rep[k][mask[k]].float().cpu().numpy() for k in range(rep.shape[0])]


def _trim_special(mat, seq_len: int):
    """BOS/EOS trim with the reference's conservative center-crop
    fallback."""
    Lr = mat.shape[0]
    if Lr == seq_len + 2:
        return mat[1:-1]
    if Lr != seq_len and Lr > seq_len and seq_len > 0:
        start = max(0, (Lr - seq_len) // 2)
        end = min(Lr, start + seq_len)
        if end - start == seq_len:
            return mat[start:end]
    return mat


def generate_base_embeddings(table: Table, output_path, id_column, sequence_column,
                             batch_size=8, quiet=False, keep_cols=None,
                             model_name="giga-v1", use_amp=True,
                             trim_special=True, device=None,
                             backend="rinalmo"):
    """Embed every row's sequence (upper-cased, T -> U) on ``device`` (the
    card unless ``"cpu"``) and write the TSV: id, seq_len,
    base_embeddings (JSON rounded to 6 places), then the kept columns in
    sorted order."""
    dev = resolve_device(device)
    if backend == "hf":
        model, tokenizer = _load_hf(model_name, dev)
    else:
        model, alphabet = _load_rinalmo(model_name, dev)
    seqs = [cell_text(v).upper().replace("T", "U") for v in table.column(sequence_column)]
    ids = table.column(id_column)
    keep_cols = [c for c in (keep_cols or []) if c in table.columns]
    use_amp = use_amp and dev.type == "cuda"
    rows = []
    with torch.no_grad():
        for s in range(0, len(seqs), batch_size):
            chunk = seqs[s : s + batch_size]
            if backend == "hf":
                # pad rows are already dropped by the attention mask
                mats = _hf_embed_batch(model, tokenizer, chunk, dev)
            else:
                tokens = torch.tensor(alphabet.batch_tokenize(chunk), dtype=torch.int64,
                                      device=dev)
                if use_amp:
                    with torch.autocast("cuda"):
                        out = model(tokens)["representation"]
                else:
                    out = model(tokens)["representation"]
                mats = [out[k].float().cpu().numpy() for k in range(len(chunk))]
            for k, seq in enumerate(chunk):
                rep = mats[k]
                if trim_special:
                    # batch_tokenize right-pads to the batch's longest; the
                    # real rows are the leading seq_len + 2 (BOS + EOS).
                    # Slicing first keeps pad rows out of the center crop
                    if rep.shape[0] > len(seq) + 2:
                        rep = rep[: len(seq) + 2]
                    rep = _trim_special(rep, len(seq))
                row = {
                    id_column: ids[s + k],
                    "seq_len": int(rep.shape[0]),
                    "base_embeddings": json.dumps(
                        np.round(rep.astype(np.float64), 6).tolist(), separators=(",", ":")),
                }
                for c in keep_cols:
                    row[c] = table.rows[s + k][c]
                rows.append(row)
    cols = [id_column, "seq_len", "base_embeddings"]
    write_tsv(output_path, cols + sorted(set(keep_cols) - set(cols)), rows)
    if not quiet:
        print(f"Base embeddings saved to {output_path}")


def build_parser():
    parser = argparse.ArgumentParser(
        description="Per-nucleotide embeddings from the RiNALMo RNA language model "
                    "(PyTorch port)."
    )
    parser.add_argument("--input", required=True)
    parser.add_argument("--output", required=True)
    parser.add_argument("--id-column", required=True)
    parser.add_argument("--sequence-column-name", "--sequence-column",
                        dest="sequence_column", default="sequence")
    parser.add_argument("--keep-cols", default=None,
                        help="Comma-separated extra columns to carry through.")
    parser.add_argument("--model-name", default="giga-v1",
                        help="RiNALMo pretrained model name, or (with "
                             "--backend hf) a transformers hub id / local "
                             "model directory.")
    parser.add_argument("--backend", choices=("rinalmo", "hf"), default="rinalmo",
                        help="LM backend: 'rinalmo' (reference parity) or "
                             "'hf' (any HuggingFace transformers encoder).")
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--device", default=None,
                        help="The CUDA device when not given, 'cpu' only when asked.")
    parser.add_argument("--no-amp", dest="use_amp", action="store_false", default=True,
                        help="Disable autocast (only active on CUDA anyway).")
    parser.add_argument("--no-trim-special", dest="trim_special", action="store_false",
                        default=True, help="Keep BOS/EOS rows instead of trimming.")
    parser.add_argument("--quiet", action="store_true")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    table = read_table(args.input)
    for col in (args.id_column, args.sequence_column):
        if col not in table.columns:
            raise ValueError(f"Column '{col}' not found in input.")
    keep_cols = ([c.strip() for c in args.keep_cols.split(",") if c.strip()]
                 if args.keep_cols else None)
    os.makedirs(os.path.dirname(args.output) or ".", exist_ok=True)
    generate_base_embeddings(
        table, args.output, args.id_column, args.sequence_column,
        args.batch_size, args.quiet, keep_cols, args.model_name,
        args.use_amp, args.trim_special, device=args.device, backend=args.backend,
    )


if __name__ == "__main__":
    main()
