"""Whitespace-separated result tables, read and written with numpy alone.

The writers reproduce, byte for byte, what the reference's pandas calls
produce (`DataFrame.to_csv(sep=" ", header=False, index=False)`): integers
as `str(int)`, float64 as the shortest round-trip `repr`, float32 as
numpy's shortest float32 form, an optional printf `float_format` applied to
every float, and NaN as an empty field.  Keeping pandas off this path lets
`import gmat_tpu` and the REMMAX pipeline run where pandas is not
installed.
"""
from __future__ import annotations

import numpy as np


def _format_column(col, float_format: str | None) -> list[str]:
    col = np.asarray(col)
    if col.dtype.kind in "iuUSO":
        return [str(v) for v in col.tolist()]
    if col.dtype.kind != "f":
        raise TypeError(f"cannot format a {col.dtype} column")
    if float_format is not None:
        out = [float_format % v for v in col.tolist()]
    elif col.dtype == np.float32:
        out = [str(v) for v in col]
    else:
        out = [repr(v) for v in col.tolist()]
    for k in np.flatnonzero(np.isnan(col)):
        out[k] = ""
    return out


def write_rows(fout, *columns, float_format: str | None = None) -> None:
    """Append one space-separated line per row of the given equal-length
    columns to the open text file `fout`."""
    if not columns or not len(columns[0]):
        return
    cols = [_format_column(c, float_format) for c in columns]
    fout.write("\n".join(" ".join(row) for row in zip(*cols)) + "\n")


def read_int_pairs(path: str, skiprows: int = 1) -> np.ndarray:
    """(rows, 2) int64 array of the first two columns of a pair file (the
    `snp_0 snp_1 ...` tables); a header-only file gives shape (0, 2)."""
    with open(path) as fin:
        for _ in range(skiprows):
            fin.readline()
        rows = [line.split()[:2] for line in fin if line.strip()]
    return np.asarray(rows, dtype=np.int64).reshape(-1, 2)


def read_numeric_table(path: str) -> dict[str, np.ndarray]:
    """Header-named float64 columns of a numeric table with one header
    line (e.g. the `snp_0 snp_1 eff var chi p` pair-test output)."""
    with open(path) as fin:
        names = fin.readline().split()
        rows = [line.split() for line in fin if line.strip()]
    data = np.asarray(rows, dtype=np.float64).reshape(-1, len(names))
    return {name: data[:, k] for k, name in enumerate(names)}


def count_records(path: str) -> int:
    """Number of non-blank lines (records of a `.bim` or `.fam` file)."""
    with open(path) as fin:
        return sum(1 for line in fin if line.strip())
