"""Small shared helpers mirroring the reference's `gmat/common/common.py`.

Reference parity (`/root/reference/gmat/common/common.py:5-75`): string
predicates `is_int`/`is_float`, the nested-defaultdict factories
`dct_{1,2,3}D` (+ the `dct_21D`/`dct_3{1,2}D` internals), and the
triple-product helpers `tri_matT`/`tri_mat`/`Dtri_matT`/`Dtri_mat`.

The reference's own `gmat.common` package is broken in the snapshot —
`common/__init__.py:2` imports a nonexistent `get_logger` — so this module
also provides a working `get_logger` with the logging conventions the rest
of the reference establishes via `logging.basicConfig` (`README.md:95-96`).

The triple products accept numpy or jax arrays (under jit they trace to two
GEMMs); the diagonal `D` variants take the diagonal as a row vector,
exactly like the reference.
"""
from __future__ import annotations

import logging
from collections import defaultdict


def is_int(num) -> bool:
    """True if `num` parses as an int (reference common.py:5-10)."""
    try:
        int(num)
        return True
    except (TypeError, ValueError):
        return False


def is_float(num) -> bool:
    """True if `num` parses as a float (reference common.py:13-18)."""
    try:
        float(num)
        return True
    except (TypeError, ValueError):
        return False


def dct_32D():
    return defaultdict()


def dct_31D():
    return defaultdict(dct_32D)


def dct_3D():
    """Three-level nested defaultdict (reference common.py:22-24)."""
    return defaultdict(dct_31D)


def dct_21D():
    return defaultdict()


def dct_2D():
    """Two-level nested defaultdict (reference common.py:36-38)."""
    return defaultdict(dct_21D)


def dct_1D():
    """Flat defaultdict (reference common.py:45-47)."""
    return defaultdict()


def tri_matT(a, b):
    """a @ b @ aᵀ (reference common.py:50-54)."""
    return (a @ b) @ a.T


def tri_mat(a, b, c):
    """a @ b @ c (reference common.py:57-61)."""
    return (a @ b) @ c


def Dtri_matT(a, b):
    """a @ diag(b) @ aᵀ with b as a row vector (reference common.py:64-68)."""
    return (a * b) @ a.T


def Dtri_mat(a, b, c):
    """a @ diag(b) @ c with b as a row vector (reference common.py:71-75)."""
    return (a * b) @ c


def get_logger(name: str = "gmat_tpu", level: int = logging.INFO):
    """Module logger with the reference's INFO-level convention.

    The reference's `common/__init__.py:2` imports this name but never
    defines it (broken import, SURVEY.md §5); implemented here so
    `from gmat_tpu.common import get_logger` works as users of the
    reference would expect."""
    logger = logging.getLogger(name)
    logger.setLevel(level)
    return logger
