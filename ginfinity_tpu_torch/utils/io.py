"""Tables, run logs and input validation.

Port of ``ginfinity_tpu/utils/io.py`` over the standard library's
``csv`` module: the run log is the same append-style ``key: value``
block log written next to every pipeline output, with a header of
timestamp, argv and system info.

Each column gets one type, inferred as ``pandas.read_csv`` infers it (the
JAX package reads every table through pandas): ``int`` when every cell
is an integer, ``float`` when every cell is a number and one is a float
or missing, ``bool`` for ``True``/``False`` columns, otherwise the cell
text.  A missing cell (empty, or one of pandas' NA strings) is ``None``
and is written back as ``NaN``; a float is written as ``DataFrame.to_csv``
writes it: a Python or float64 value as ``repr`` (``7.0``, ``0.5``), a
float32 value as the shortest text that reads back to it
(``0.33333334``).
"""

from __future__ import annotations

import csv
import os
import platform
import re
import sys
from datetime import datetime

import numpy as np

# pandas' default NA strings (``pandas.read_csv(na_values=None)``)
_NA = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
    "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null",
})
_INT = re.compile(r"[+-]?[0-9]+")
_FLOAT = re.compile(r"[+-]?(?:[0-9]+\.?[0-9]*|\.[0-9]+)(?:[eE][+-]?[0-9]+)?"
                    r"|[+-]?(?:inf|Inf|INF|infinity|Infinity|INFINITY)")
_BOOL = {"True": True, "TRUE": True, "true": True,
         "False": False, "FALSE": False, "false": False}


def _typed_column(cells: list) -> list:
    """One column's cells (text, or None when missing) as pandas types
    them."""
    present = [c.strip(" ") for c in cells if c is not None]
    if present and all(_INT.fullmatch(c) for c in present):
        ints = [int(c) for c in present]
        # int64, or uint64 when every value fits it; wider stays text
        if min(ints) >= -2**63 and (max(ints) < 2**63 or (min(ints) >= 0 and max(ints) < 2**64)):
            if len(present) == len(cells):
                return [int(c.strip(" ")) for c in cells]
            return [None if c is None else float(int(c.strip(" "))) for c in cells]
        return cells
    if all(_INT.fullmatch(c) or _FLOAT.fullmatch(c) for c in present):
        return [None if c is None else float(c.strip(" ")) for c in cells]
    if all(c in _BOOL for c in present):
        return [None if c is None else _BOOL[c.strip(" ")] for c in cells]
    return cells


class Table:
    """A CSV/TSV table: ``columns`` in file order and one dict per row."""

    def __init__(self, columns: list[str], rows: list[dict]):
        self.columns = columns
        self.rows = rows

    def column(self, name: str) -> list:
        return [r[name] for r in self.rows]


def cell_text(v) -> str:
    """A typed cell as ``str`` of its pandas value (missing -> ``nan``), as
    ``Series.astype(str)`` gives it."""
    return "nan" if v is None else str(v)


def _drop_comment(cells: list[str], comment: str) -> list[str]:
    """A parsed row cut at its first ``comment`` character, the cells after
    it dropped, as pandas' python engine cuts it (inside quotes too)."""
    for k, c in enumerate(cells):
        if comment in c:
            return cells[:k] + [c[: c.index(comment)]]
    return cells


def _rows(reader, comment: str | None):
    """The reader's rows without blank ones; with ``comment``, each row
    cut at it first and a row left with one blank cell skipped."""
    for cells in reader:
        if comment is not None:
            cells = _drop_comment(cells, comment)
            if len(cells) == 1 and not cells[0].strip():
                continue
        if cells:
            yield cells


def read_table(path: str, sep: str | None = None, comment: str | None = None) -> Table:
    """Read a CSV, or a TSV when the name ends in ``.tsv`` (or with the
    separator ``sep``); blank lines are skipped.  ``comment`` is
    ``pandas.read_csv(comment=..., engine="python")``'s: every row, the
    header too, ends at that character."""
    if sep is None:
        sep = "\t" if path.endswith(".tsv") else ","
    # a node-embeddings cell (an L x D matrix as JSON) runs to megabytes,
    # far beyond the csv module's default field limit of 128 KiB
    csv.field_size_limit(max(csv.field_size_limit(), 2**31 - 1))
    with open(path, newline="") as f:
        rows = _rows(csv.reader(f, delimiter=sep), comment)
        columns = next(rows, [])
        lines = []
        for cells in rows:
            cells = cells + [""] * (len(columns) - len(cells))
            lines.append([None if v in _NA else v for v in cells])
    typed = [_typed_column([ln[k] for ln in lines]) for k in range(len(columns))]
    rows = [{c: typed[k][i] for k, c in enumerate(columns)} for i in range(len(lines))]
    return Table(columns, rows)


def read_table_auto(path: str) -> Table:
    """A ``.tsv`` name reads as a TSV and a ``.csv`` name as a CSV; any
    other name takes the separator ``csv.Sniffer`` finds in its first
    line, as pandas' ``sep=None`` does."""
    if path.endswith(".tsv") or path.endswith(".csv"):
        return read_table(path)
    with open(path, newline="") as f:
        first = f.readline()
    return read_table(path, csv.Sniffer().sniff(first).delimiter)


def _cell(v, na_rep: str):
    if v is None:
        return na_rep
    if isinstance(v, np.float32):
        return str(v)  # numpy's shortest float32 text, as pandas writes it
    return v


def write_tsv(path: str, columns: list[str], rows: list, na_rep: str = "NaN") -> None:
    """Write rows (dicts keyed by column, or lists in column order) as a
    TSV with a header; a missing cell reads ``na_rep``, a float32 cell
    its shortest text and any other float its ``repr``."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f, delimiter="\t", lineterminator="\n")
        w.writerow(columns)
        for r in rows:
            cells = [r.get(c) for c in columns] if isinstance(r, dict) else r
            w.writerow([_cell(v, na_rep) for v in cells])


def get_system_info() -> dict:
    import torch

    info = {
        "Operating System": f"{platform.system()} {platform.release()}",
        "Platform": platform.platform(),
        "Python Version": platform.python_version(),
        "PyTorch Version": torch.__version__,
        "CUDA Version": torch.version.cuda,
        "CPU Cores": os.cpu_count(),
    }
    if torch.cuda.is_available():
        info["Devices"] = ", ".join(
            torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())
        )
    else:
        info["Devices"] = "no CUDA device"
    return info


def log_information(log_path, info_dict, log_name=None, open_type="a", print_log=False):
    """Append a key:value block to the run log."""
    if log_path is None:
        return
    with open(log_path, open_type) as f:
        sep = "\n" + "=" * 50 + "\n"
        f.write(sep)
        if print_log:
            print(sep)
        if log_name:
            f.write(f"{log_name}\n")
            if print_log:
                print(log_name)
        for key, value in info_dict.items():
            line = f"{key}: {value}\n"
            f.write(line)
            if print_log:
                print(line, end="")


def log_setup(log_path, print_log=True):
    log_information(
        log_path,
        {"Date and Time": str(datetime.now()), "Command Run": " ".join(sys.argv)},
        "Run Info",
        "w",
    )
    log_information(log_path, get_system_info(), "System Info", print_log=print_log)


def setup_and_read_input(args, need_model: bool = False):
    """Shared pipeline input handling: log setup, read the input table,
    validate the id/structure columns, resolve the columns to keep.
    Returns ``(table, log_path, keep_columns)``."""
    os.makedirs(os.path.dirname(args.output) or ".", exist_ok=True)
    log_path = os.path.splitext(args.output)[0] + ".log"
    quiet = getattr(args, "quiet", False)
    log_setup(log_path, print_log=not quiet)
    log_information(log_path, vars(args), "Arguments", print_log=not quiet)

    table = read_table(args.input)

    if args.structure_column_name not in table.columns:
        raise ValueError(
            f"Structure column '{args.structure_column_name}' not found in input data."
        )
    if args.id_column not in table.columns:
        raise ValueError(f"ID column '{args.id_column}' not found in input data.")
    ids = table.column(args.id_column)
    if len(set(ids)) != len(ids):
        log_information(log_path, {"warning": "duplicate IDs"}, "Warning")

    if need_model:
        if not hasattr(args, "model_path"):
            raise ValueError("need_model=True but args has no model_path attribute.")
        if not os.path.exists(args.model_path):
            raise ValueError(f"Model path '{args.model_path}' does not exist.")

    if getattr(args, "keep_cols", None):
        requested = [c.strip() for c in args.keep_cols.split(",")]
        missing = [c for c in requested if c not in table.columns]
        if missing:
            raise ValueError(
                f"The following columns specified in --keep-cols do not exist in the input file: {missing}"
            )
        propagate = requested
    else:
        propagate = [
            c for c in table.columns if c not in (args.id_column, args.structure_column_name)
        ]
    return table, log_path, propagate
