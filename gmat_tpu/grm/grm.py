"""Genomic relationship matrices (additive / dominance) and genomic inbreeding.

Reference parity:
- `agmat`    -> `/root/reference/gmat/gmatrix/gmatrix.py:34-94`
- `dgmat_as` -> `gmatrix.py:97-159`
- `ginbreedcoef` -> `gmatrix.py:162-183`

Design: the K = M M^T / scale product is a single large GEMM on one device;
on a mesh its SNP columns are sharded and the partial Gram matrices summed
with one `psum` (see gmat_tpu/dist/mesh.py for the sharded variant).
The diagonal inflation `d * (1 + small_val)` and output formats match the
reference exactly for golden compatibility.
"""
from __future__ import annotations

import logging

import jax
import jax.numpy as jnp
import numpy as np

from gmat_tpu import config  # noqa: F401  (enables x64)
from gmat_tpu.core.coding import additive_code, dominance_code
from gmat_tpu.io.bed import Bed, impute_geno
from gmat_tpu.io.grm_io import write_grm

logger = logging.getLogger(__name__)


@jax.jit
def additive_grm(geno, small_val=0.001):
    """K_a = M M^T / sum(2p(1-p)) with diagonal inflated by (1+small_val)."""
    mat, _, scale = additive_code(geno)
    kin = (mat @ mat.T) / scale
    diag = jnp.diag(kin) * (1.0 + small_val)
    return kin.at[jnp.diag_indices_from(kin)].set(diag)


@jax.jit
def dominance_grm(geno, small_val=0.001):
    """K_d = D D^T / sum(s(1-s)) with diagonal inflated by (1+small_val)."""
    mat, _, scale = dominance_code(geno)
    kin = (mat @ mat.T) / scale
    diag = jnp.diag(kin) * (1.0 + small_val)
    return kin.at[jnp.diag_indices_from(kin)].set(diag)


def _run_grm(bed_prefix, kind, inv, small_val, out_fmt, impute_seed,
             mesh=None):
    bed = Bed(bed_prefix)
    geno = bed.read()
    if np.any(np.isnan(geno)):
        logger.info("Missing genotypes are imputed with random genotypes (seed=%d).",
                    impute_seed)
        geno = impute_geno(geno, seed=impute_seed)
    logger.info("There are %d individuals and %d SNPs.", *geno.shape)
    if mesh is not None:
        from gmat_tpu.dist.mesh import sharded_additive_grm, sharded_dominance_grm

        fn = sharded_additive_grm if kind == "add" else sharded_dominance_grm
        kin = np.asarray(fn(geno, mesh, small_val))
        suffix, inv_suffix = ((".agrm", ".agiv") if kind == "add"
                              else (".dgrm_as", ".dgiv_as"))
    elif kind == "add":
        kin = np.asarray(additive_grm(jnp.asarray(geno), small_val))
        suffix, inv_suffix = ".agrm", ".agiv"
    else:
        kin = np.asarray(dominance_grm(jnp.asarray(geno), small_val))
        suffix, inv_suffix = ".dgrm_as", ".dgiv_as"
    ids = bed.iids
    write_grm(kin, ids, bed_prefix + suffix, out_fmt)
    kin_inv = None
    if inv:
        kin_inv = np.asarray(
            jax.jit(jnp.linalg.inv)(jnp.asarray(kin))
        )
        write_grm(kin_inv, ids, bed_prefix + inv_suffix, out_fmt)
    return kin, kin_inv


def agmat(bed_prefix: str, inv: bool = False, small_val: float = 0.001,
          out_fmt: str = "mat", impute_seed: int = 0, mesh=None):
    """Additive GRM (and optional inverse); writes `<prefix>.agrm*`.

    Parity: reference `gmatrix.agmat` (gmatrix.py:34-94).  With `mesh`, the
    Gram product shards SNP columns over the device mesh (one psum).
    """
    return _run_grm(bed_prefix, "add", inv, small_val, out_fmt, impute_seed,
                    mesh=mesh)


def dgmat_as(bed_prefix: str, inv: bool = False, small_val: float = 0.001,
             out_fmt: str = "mat", impute_seed: int = 0, mesh=None):
    """Dominance GRM (and optional inverse); writes `<prefix>.dgrm_as*`.

    Parity: reference `gmatrix.dgmat_as` (gmatrix.py:97-159).  With `mesh`,
    the Gram product shards SNP columns over the device mesh (one psum).
    """
    return _run_grm(bed_prefix, "dom", inv, small_val, out_fmt, impute_seed,
                    mesh=mesh)


@jax.jit
def _inbreed_stats(geno):
    n, m = geno.shape
    homo_f = 1.0 - jnp.sum(jnp.abs(geno - 1.0) < 0.01, axis=1) / m
    freq = jnp.sum(geno, axis=0) / (2.0 * n)
    scale_vec = 2.0 * freq * (1.0 - freq)
    scale = jnp.sum(scale_vec)
    cen = geno - 2.0 * freq[None, :]
    grm_f1 = jnp.sum(cen * cen, axis=1) / scale - 1.0
    grm_f2 = jnp.sum(cen * cen / scale_vec[None, :], axis=1) / m - 1.0
    return homo_f, grm_f1, grm_f2


def ginbreedcoef(bed_prefix: str, impute_seed: int = 0):
    """Genomic inbreeding coefficients; writes `<prefix>.ginbreedcoef`.

    Parity: reference `gmatrix.ginbreedcoef` (gmatrix.py:162-183):
    homozygosity F, GRM-diagonal F1 (common scale), F2 (per-SNP scale).
    """
    import pandas as pd

    bed = Bed(bed_prefix)
    geno = bed.read()
    if np.any(np.isnan(geno)):
        geno = impute_geno(geno, seed=impute_seed)
    homo_f, grm_f1, grm_f2 = (np.asarray(a) for a in _inbreed_stats(jnp.asarray(geno)))
    df = pd.DataFrame(
        {"id": bed.iids, "homo_F": homo_f,
         "grm_F1": grm_f1, "grm_F2": grm_f2}
    )
    df.to_csv(bed_prefix + ".ginbreedcoef", sep=" ", header=True, index=False)
    return df
