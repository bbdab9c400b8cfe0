"""Phenotype parsing and mixed-model design structures.

Parity target: reference `uvlmm/design_matrix.py:7-113`
(`design_matrix_wemai_multi_gmat[_pred]`): phenotype files keyed by
(family id, individual id), third column all-ones for the population mean,
covariates between, phenotype last; repeated records per individual allowed;
records ordered by the .fam file; 'NA'/'NaN'/'nan'/'na' phenotypes dropped.

Design: the reference materializes the random-effect incidence Z
as a scipy csr_matrix.  Here Z is represented by an integer *record->column*
index vector (`rec_ids`): Z @ A == A[rec_ids] (gather) and Z.T @ B ==
segment_sum(B, rec_ids) — both native XLA ops that fuse and shard, with no
sparse formats anywhere near the device.
"""
from __future__ import annotations

from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np
from jax.ops import segment_sum

_NA = {"NA", "NaN", "nan", "na"}


@dataclass(frozen=True)
class DesignMatrices:
    """y (n_rec,), X (n_rec, p), and the incidence map for Z (n_rec x n_col).

    `rec_ids[r]` is the Z column (individual slot) of record r.
    `n_col` can exceed the number of phenotyped individuals in the `pred`
    variant (un-phenotyped individuals own empty Z columns, reference
    design_matrix.py:95-112).
    """

    y: np.ndarray
    xmat: np.ndarray
    rec_ids: np.ndarray
    n_col: int

    @property
    def n_rec(self) -> int:
        return self.y.shape[0]

    def zdot(self, a):
        """Z @ a  — gather rows of a per record."""
        return jnp.asarray(a)[self.rec_ids]

    def ztdot(self, b):
        """Z.T @ b — sum records into individual slots."""
        return segment_sum(jnp.asarray(b), jnp.asarray(self.rec_ids),
                           num_segments=self.n_col)

    def zgzt(self, gmat):
        """Z G Z^T as a dense (n_rec, n_rec) array (records small enough to
        hold; the reference materializes the same product, uvlmm_varcom.py:34).

        GRM uploads ride the identity-keyed device cache: the approx
        pipelines call this for the same host arrays once per stage
        (core/devcache.py)."""
        from gmat_tpu.core.devcache import device_put_cached

        g = device_put_cached(gmat)
        return g[jnp.asarray(self.rec_ids)][:, jnp.asarray(self.rec_ids)]

    def z_dense(self):
        z = np.zeros((self.n_rec, self.n_col))
        z[np.arange(self.n_rec), self.rec_ids] = 1.0
        return z


def _parse_pheno(pheno_file: str):
    """-> dict '(fid iid)' -> list of token-rows (filtered for NA pheno)."""
    recs: dict[str, list[list[str]]] = {}
    with open(pheno_file) as fin:
        for line in fin:
            arr = line.split()
            if not arr or arr[-1] in _NA:
                continue
            recs.setdefault(" ".join(arr[:2]), []).append(arr)
    return recs


def _fam_keys(bed_prefix: str):
    keys = []
    with open(bed_prefix + ".fam") as fin:
        for line in fin:
            arr = line.split()
            keys.append((" ".join(arr[:2]), arr[1]))
    return keys


def design_matrix(pheno_file: str, bed_prefix: str) -> DesignMatrices:
    """All genotyped individuals must be phenotyped (reference
    design_matrix.py:31-34 exits otherwise; we raise)."""
    recs = _parse_pheno(pheno_file)
    keys = _fam_keys(bed_prefix)
    missing = [k for k, _ in keys if k not in recs]
    if missing:
        raise ValueError(
            "genotyped ids missing from the phenotype file: "
            + ", ".join(missing[:5])
            + ("..." if len(missing) > 5 else "")
        )
    y, xmat, rec_ids = [], [], []
    id_slot: dict[str, int] = {}
    for key, iid in keys:
        for arr in recs[key]:
            y.append(float(arr[-1]))
            xmat.append([float(v) for v in arr[2:-1]])
            if iid not in id_slot:
                id_slot[iid] = len(id_slot)
            rec_ids.append(id_slot[iid])
    return DesignMatrices(
        y=np.asarray(y),
        xmat=np.asarray(xmat, dtype=float).reshape(len(y), -1),
        rec_ids=np.asarray(rec_ids, dtype=np.int32),
        n_col=len(id_slot),
    )


def design_matrix_pred(pheno_file: str, bed_prefix: str) -> DesignMatrices:
    """Prediction variant: un-phenotyped individuals keep (empty) Z columns
    so BLUPs are produced for them (reference design_matrix.py:60-113)."""
    recs = _parse_pheno(pheno_file)
    keys = _fam_keys(bed_prefix)
    y, xmat, rec_ids = [], [], []
    id_slot: dict[str, int] = {}
    n_col = 0
    for key, iid in keys:
        if key in recs:
            for arr in recs[key]:
                y.append(float(arr[-1]))
                xmat.append([float(v) for v in arr[2:-1]])
                if iid not in id_slot:
                    id_slot[iid] = n_col
                    n_col += 1
                rec_ids.append(id_slot[iid])
        else:
            n_col += 1
    return DesignMatrices(
        y=np.asarray(y),
        xmat=np.asarray(xmat, dtype=float).reshape(len(y), -1),
        rec_ids=np.asarray(rec_ids, dtype=np.int32),
        n_col=n_col,
    )


def _dm_to_tuple(dm: DesignMatrices):
    from scipy import sparse

    n_rec = len(dm.rec_ids)
    zmat = sparse.csr_matrix(
        (np.ones(n_rec), (np.arange(n_rec), dm.rec_ids)),
        shape=(n_rec, dm.n_col),
    )
    return dm.y.reshape(-1, 1), dm.xmat, zmat


def design_matrix_wemai_multi_gmat(pheno_file: str, bed_prefix: str):
    """Reference-name API (design_matrix.py:7-57): returns (y, xmat, zmat)
    with y an (n,1) column, X dense and Z a CSR record->individual
    incidence — the tuple the reference's own examples unpack."""
    return _dm_to_tuple(design_matrix(pheno_file, bed_prefix))


def design_matrix_wemai_multi_gmat_pred(pheno_file: str, bed_prefix: str):
    """Reference-name API (design_matrix.py:60-113): prediction variant with
    empty Z columns for un-phenotyped individuals."""
    return _dm_to_tuple(design_matrix_pred(pheno_file, bed_prefix))
