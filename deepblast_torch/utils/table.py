"""Tables as lists of dict rows, read and written as pandas reads and
writes them, without pandas (the JAX package's CLIs and parsers keep their
tables in ``pandas.DataFrame``s).

:func:`write_csv` gives the bytes of ``pd.DataFrame(rows).to_csv(path,
sep=sep, header=header, index=index)``: the columns in order of first
appearance, a column of numbers with a missing value or a float written as
floats (``repr``), a missing value as an empty field, Python's ``csv``
quoting (pandas writes through it) and ``\\n`` line ends.  :func:`read_csv`
reads a file as ``pd.read_csv(path, index_col=0)`` does: a column of
integers as ``int``, of numbers as ``float``, else as ``str``, with
pandas' default missing-value strings as None; it does not turn
``True``/``False`` into booleans.
"""

from __future__ import annotations

import csv
import math
import re

__all__ = ["columns", "fill", "write_csv", "read_csv"]

#: pandas' default ``na_values``
NA_STRINGS = frozenset([
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"])
_INT = re.compile(r"[+-]?\d+")


def _missing(v):
    return v is None or (isinstance(v, float) and math.isnan(v))


def _number(v):
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def columns(rows):
    """The keys of ``rows`` in order of first appearance, as
    ``pd.DataFrame(rows).columns``."""
    seen = {}
    for r in rows:
        for k in r:
            seen.setdefault(k, None)
    return list(seen)


def fill(rows):
    """Each row with every column of ``rows`` in :func:`columns`' order, a
    missing value as None: ``pd.DataFrame(rows).to_dict("records")`` with
    None where pandas puts NaN."""
    cols = columns(rows)
    return [{c: r.get(c) for c in cols} for r in rows]


def _formatter(values):
    """How pandas writes one column: floats where the column is numbers
    and holds a float or a missing value, else each value's ``str``."""
    present = [v for v in values if not _missing(v)]
    as_float = all(_number(v) for v in present) and (
        len(present) < len(values) or any(isinstance(v, float)
                                          for v in present))
    if as_float:
        return lambda v: "" if _missing(v) else repr(float(v))
    return lambda v: "" if _missing(v) else str(v)


def write_csv(path, rows, sep=",", header=True, index=True, index_label=""):
    """Write dict rows (or sequences, whose columns are 0, 1, ...) as
    ``pd.DataFrame(rows).to_csv``; ``index`` True writes 0..n-1 before
    each row, a list writes its values, False none; ``index_label`` heads
    the index column."""
    rows = [r if isinstance(r, dict) else dict(enumerate(r)) for r in rows]
    cols = columns(rows)
    fmts = [_formatter([r.get(c) for r in rows]) for c in cols]
    if index is True:
        index = list(range(len(rows)))
    index = None if index is False else list(map(_formatter(index), index))
    with open(path, "w", newline="") as f:
        w = csv.writer(f, delimiter=sep, lineterminator="\n")
        if header:
            w.writerow(([] if index is None else [index_label])
                       + [str(c) for c in cols])
        for i, r in enumerate(rows):
            w.writerow(([] if index is None else [index[i]])
                       + [fmt(r.get(c)) for c, fmt in zip(cols, fmts)])


def _parse(values):
    """One column's strings as pandas types them."""
    present = [v for v in values if v not in NA_STRINGS]
    if present and all(_INT.fullmatch(v) for v in present):
        if len(present) == len(values):
            return [int(v) for v in values]
        return [float("nan") if v in NA_STRINGS else float(v)
                for v in values]
    try:
        return [float("nan") if v in NA_STRINGS else float(v)
                for v in values] if present else [None] * len(values)
    except ValueError:
        return [None if v in NA_STRINGS else v for v in values]


def read_csv(path, sep=","):
    """``(index_label, index, rows)`` of a file with a header whose first
    column is the index, as ``pd.read_csv(path, index_col=0)`` reads it:
    the rows are dicts keyed by the header's other cells."""
    with open(path, newline="") as f:
        lines = list(csv.reader(f, delimiter=sep))
    head, body = lines[0], [r for r in lines[1:] if r]
    cols = [_parse([r[j] if j < len(r) else "" for r in body])
            for j in range(len(head))]
    rows = [{head[j]: cols[j][i] for j in range(1, len(head))}
            for i in range(len(body))]
    return head[0], cols[0], rows
