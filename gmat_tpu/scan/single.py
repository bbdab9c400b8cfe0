"""Single-SNP score tests under the random SNP-BLUP model.

Parity: reference `remma_add` (/root/reference/gmat/remma/remma_add.py:15-94)
and `remma_dom` (remma_dom.py:15-96).  Per SNP j:

    eff_j = (Mᵀ pymat)_j · σ²_g / scale
    var_j = (M_j ᵀ pvpmat M_j) · σ⁴_g / scale²
    eff_fixed_j = eff_j σ²_g / (var_j · scale)
    chi_j = eff_j² / var_j,  p_j = P[χ²₁ > chi_j]

The whole SNP axis is two GEMMs — the reference's loop-free numpy form maps
directly (remma_add.py:59-63).  The result is a pandas DataFrame, so pandas
is imported by these functions only.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from gmat_tpu.core.coding import additive_code, dominance_code
from gmat_tpu.core.stats import chi2_sf
from gmat_tpu.io.pheno import design_matrix
from gmat_tpu.scan.common import prepare_genotypes, score_pieces


@jax.jit
def _single_scan_kernel(mat, pymat, pvpmat, sigma2, scale):
    eff = (mat.T @ pymat) * sigma2 / scale
    var = jnp.sum(mat * (pvpmat @ mat), axis=0) * sigma2 * sigma2 / (scale * scale)
    eff_fixed = eff * sigma2 / (var * scale)
    chi = eff * eff / var
    return eff, var, eff_fixed, chi, chi2_sf(chi, 1)


def _run_single(pheno_file, bed_prefix, gmat_lst, var_com, coding, sigma2,
                out_file):
    dm = design_matrix(pheno_file, bed_prefix)
    pieces = score_pieces(dm, gmat_lst, var_com)
    geno, bim, _ = prepare_genotypes(bed_prefix)
    mat, _, scale = coding(jnp.asarray(geno))
    eff, var, eff_fixed, chi, p = (
        np.asarray(a)
        for a in _single_scan_kernel(mat, pieces.pymat, pieces.pvpmat,
                                     float(sigma2), scale)
    )
    res = bim[["chro", "snp_ID", "pos", "allele1", "allele2"]].copy()
    res["eff_val"] = eff
    res["chi_val"] = chi
    res["eff_val_to_fixed"] = eff_fixed
    res["p_val"] = p
    if out_file:
        res.to_csv(out_file, index=False, header=True, sep=" ")
    return res


def remma_add(pheno_file: str, bed_prefix: str, gmat_lst, var_com,
              out_file: str = "remma_add"):
    """Additive single-SNP test; var_com[0] must be the additive variance."""
    return _run_single(pheno_file, bed_prefix, gmat_lst, var_com,
                       additive_code, var_com[0], out_file)


def remma_dom(pheno_file: str, bed_prefix: str, gmat_lst, var_com,
              out_file: str = "remma_dom"):
    """Dominance single-SNP test; var_com[1] must be the dominance variance."""
    return _run_single(pheno_file, bed_prefix, gmat_lst, var_com,
                       dominance_code, var_com[1], out_file)
