"""Fixed-effect (exact) single-SNP and pairwise LMM tests + plain OLS.

Parity targets:
- `uvlmm_gwas_add` / `uvlmm_gwas_dom` (/root/reference/gmat/uvlmm/
  uvlmm_gwas.py:12-131): per SNP append the (centered) SNP column to X and
  GLS-test its coefficient under V = sum sig2_k G_k + sig2_e I.
- `uvlmm_gwas_epiAA` (:145-198): per pair append s_i, s_j, s_i*s_j and test
  the interaction coefficient.
- `uvlmm_gwas_*_eigen` — EMPTY stubs in the reference (:68-77,133-142);
  implemented for real here via the single-GRM eigen rotation.
- `lm_snp_eff` / `lm_pred` (uvlmm/lm.py:11-54): per-SNP OLS effects and a
  naive GBLUP-ish prediction.

Design: the reference loops SNPs in Python with a fresh (p+1)x(p+1)
inverse each (uvlmm_gwas.py:44-52).  By partitioned regression the added
coefficient is eff = (sᵀPy)/(sᵀPs) with P the fixed-effects projection of
V^-1 — the entire panel is two GEMMs.  The pair scan reuses the anchor-tile
pattern of scan/pairs.py with P-inner-product projections of s_i and s_j.
"""
from __future__ import annotations

import logging

import jax
import jax.numpy as jnp
import numpy as np

from gmat_tpu.core.coding import additive_code, dominance_code
from gmat_tpu.core.linalg import chol_inv_logdet, projection_pieces
from gmat_tpu.core.stats import chi2_sf
from gmat_tpu.scan.common import prepare_genotypes

logger = logging.getLogger(__name__)


@jax.jit
def _pmat_direct(var_com, y, xmat, gmat_stack):
    """P from V = sum sig2_k G_k + sig2_e I (no Z; uvlmm_gwas.py:23-29)."""
    n = y.shape[0]
    vmat = jnp.einsum("k,kij->ij", var_com[:-1], gmat_stack)
    vmat = vmat + var_com[-1] * jnp.eye(n, dtype=vmat.dtype)
    vinv, _ = chol_inv_logdet(vmat)
    pmat, _ = projection_pieces(vinv, xmat)
    return pmat


@jax.jit
def _single_fixed_kernel(mat, pmat, y):
    py = pmat @ y
    eff_num = mat.T @ py         # sᵀPy
    quad = jnp.sum(mat * (pmat @ mat), axis=0)  # sᵀPs
    eff = eff_num / quad
    var = 1.0 / quad
    chi = eff * eff / var
    return eff, var, chi, chi2_sf(chi, 1)


def _run_fixed_single(y, xmat, gmat_lst, var_com, bed_prefix, coding, out_file):
    y = jnp.asarray(np.asarray(y, float).reshape(-1))
    xmat = jnp.asarray(np.asarray(xmat, float).reshape(y.shape[0], -1))
    gstack = jnp.stack([jnp.asarray(np.asarray(g, float)) for g in gmat_lst])
    pmat = _pmat_direct(jnp.asarray(np.asarray(var_com, float)), y, xmat,
                        gstack)
    geno, bim, _ = prepare_genotypes(bed_prefix)
    mat, freq, scale = coding(jnp.asarray(geno))
    eff, var, chi, p = (np.asarray(a) for a in
                        _single_fixed_kernel(mat, pmat, y))
    res = bim[["chro", "snp_ID", "pos", "allele1", "allele2"]].copy()
    res["eff_val"] = eff
    res["scale_val"] = float(np.asarray(var_com)[0]) / (float(scale) * var)
    res["chi_val"] = chi
    res["p_val"] = p
    if out_file:
        res.to_csv(out_file, sep=" ", index=False)
    return res


def uvlmm_gwas_add(y, xmat, gmat_lst, var_com, bed_prefix, out_file=None):
    return _run_fixed_single(y, xmat, gmat_lst, var_com, bed_prefix,
                             additive_code, out_file)


@jax.jit
def _dom_fixed_kernel(mat_a, mat_d, pmat, y):
    """Dominance coefficient adjusted for the additive column — the reference
    fits [X | s_add | s_dom] per SNP and tests the last coefficient
    (uvlmm_gwas.py:113-117).  2x2 partitioned solve per SNP, vectorized."""
    py = pmat @ y
    pa = pmat @ mat_a
    pd_ = pmat @ mat_d
    aa = jnp.sum(mat_a * pa, axis=0)
    ad = jnp.sum(mat_a * pd_, axis=0)
    dd = jnp.sum(mat_d * pd_, axis=0)
    ay = mat_a.T @ py
    dy = mat_d.T @ py
    det = aa * dd - ad * ad
    eff = (aa * dy - ad * ay) / det
    var = aa / det
    chi = eff * eff / var
    return eff, var, chi, chi2_sf(chi, 1)


def uvlmm_gwas_dom(y, xmat, gmat_lst, var_com, bed_prefix, out_file=None):
    y = jnp.asarray(np.asarray(y, float).reshape(-1))
    xmat = jnp.asarray(np.asarray(xmat, float).reshape(y.shape[0], -1))
    gstack = jnp.stack([jnp.asarray(np.asarray(g, float)) for g in gmat_lst])
    pmat = _pmat_direct(jnp.asarray(np.asarray(var_com, float)), y, xmat,
                        gstack)
    geno, bim, _ = prepare_genotypes(bed_prefix)
    g = jnp.asarray(geno)
    mat_a, _, _ = additive_code(g)
    mat_d, _, _ = dominance_code(g)
    eff, var, chi, p = (np.asarray(a) for a in
                        _dom_fixed_kernel(mat_a, mat_d, pmat, y))
    res = bim[["chro", "snp_ID", "pos", "allele1", "allele2"]].copy()
    res["eff_val"] = eff
    res["chi_val"] = chi
    res["p_val"] = p
    if out_file:
        res.to_csv(out_file, sep=" ", index=False)
    return res


def _eigen_pmat(var_com, y, xmat, gmat):
    """Eigen fast path for a single GRM: V^-1 diagonal in rotated space."""
    from scipy import linalg as sla

    lam, u = sla.eigh(np.asarray(gmat))
    yr = jnp.asarray(u.T @ np.asarray(y, float).reshape(-1))
    xr = jnp.asarray(u.T @ np.asarray(xmat, float).reshape(len(lam), -1))
    vdiag = 1.0 / (jnp.asarray(lam) * var_com[0] + var_com[-1])

    @jax.jit
    def project(m):
        vx = vdiag[:, None] * xr
        xvx_inv = jnp.linalg.inv(xr.T @ vx)
        return vdiag[:, None] * (m - xr @ (xvx_inv @ (vx.T @ m)))

    return u, yr, project


def uvlmm_gwas_add_eigen(y, xmat, agmat, var_com, bed_prefix, out_file=None):
    """Eigen-accelerated additive test (the reference declares this function
    but leaves it empty, uvlmm_gwas.py:68-71 — implemented here)."""
    return _run_fixed_eigen(y, xmat, agmat, var_com, bed_prefix,
                            additive_code, out_file)


def uvlmm_gwas_dom_eigen(y, xmat, agmat, var_com, bed_prefix, out_file=None):
    """Eigen-accelerated dominance test (additive-adjusted, like the direct
    path; the reference stub is empty)."""
    var_com = np.asarray(var_com, float)
    u, yr, project = _eigen_pmat(var_com, y, xmat, agmat)
    geno, bim, _ = prepare_genotypes(bed_prefix)
    g = jnp.asarray(geno)
    ur = jnp.asarray(u.T)
    mat_a = ur @ additive_code(g)[0]
    mat_d = ur @ dominance_code(g)[0]
    py = project(yr[:, None])[:, 0]
    pa = project(mat_a)
    pd_ = project(mat_d)
    aa = np.asarray(jnp.sum(mat_a * pa, axis=0))
    ad = np.asarray(jnp.sum(mat_a * pd_, axis=0))
    dd = np.asarray(jnp.sum(mat_d * pd_, axis=0))
    ay = np.asarray(mat_a.T @ py)
    dy = np.asarray(mat_d.T @ py)
    det = aa * dd - ad * ad
    eff = (aa * dy - ad * ay) / det
    var = aa / det
    chi = eff * eff / var
    res = bim[["chro", "snp_ID", "pos", "allele1", "allele2"]].copy()
    res["eff_val"] = eff
    res["chi_val"] = chi
    res["p_val"] = np.asarray(chi2_sf(jnp.asarray(chi), 1))
    if out_file:
        res.to_csv(out_file, sep=" ", index=False)
    return res


def _run_fixed_eigen(y, xmat, gmat, var_com, bed_prefix, coding, out_file):
    var_com = np.asarray(var_com, float)
    u, yr, project = _eigen_pmat(var_com, y, xmat, gmat)
    geno, bim, _ = prepare_genotypes(bed_prefix)
    mat, freq, scale = coding(jnp.asarray(geno))
    mr = jnp.asarray(u.T) @ mat
    py = project(yr[:, None])[:, 0]
    pm = project(mr)
    eff_num = np.asarray(mr.T @ py)
    quad = np.asarray(jnp.sum(mr * pm, axis=0))
    eff = eff_num / quad
    var = 1.0 / quad
    chi = eff * eff / var
    res = bim[["chro", "snp_ID", "pos", "allele1", "allele2"]].copy()
    res["eff_val"] = eff
    res["scale_val"] = var_com[0] / (float(scale) * var)
    res["chi_val"] = chi
    res["p_val"] = np.asarray(chi2_sf(jnp.asarray(chi), 1))
    if out_file:
        res.to_csv(out_file, sep=" ", index=False)
    return res


@jax.jit
def _epi_fixed_anchor(a_col, mat, pmat, py, pm):
    """Exact interaction test for one anchor against all partners.

    Model per pair: y ~ X + s_i + s_j + s_i*s_j; the interaction coefficient
    is tested after projecting out X (in pmat), then s_i and s_j by
    Gram-Schmidt in the P-metric.
    """
    s_i = mat[:, a_col]
    ps_i = pm[:, a_col]
    d_ii = jnp.dot(s_i, ps_i)
    # project each partner s_j on s_i
    d_ij = s_i @ pm  # (m,)
    # interaction columns
    e = s_i[:, None] * mat  # (n, m)
    pe = pmat @ e
    # P-inner products
    e_y = e.T @ py
    e_i = pe.T @ s_i
    e_j = jnp.sum(pe * mat, axis=0)
    e_e = jnp.sum(e * pe, axis=0)
    d_jj = jnp.sum(mat * pm, axis=0)
    s_y = jnp.dot(s_i, py)
    j_y = mat.T @ py
    # 3x3 normal equations per partner: unknowns (b_i, b_j, b_e)
    a11 = d_ii
    a12 = d_ij
    a13 = e_i
    a22 = d_jj
    a23 = e_j
    a33 = e_e
    amat = jnp.stack(
        [
            jnp.stack([jnp.full_like(a12, a11), a12, a13], axis=-1),
            jnp.stack([a12, a22, a23], axis=-1),
            jnp.stack([a13, a23, a33], axis=-1),
        ],
        axis=-2,
    )  # (m, 3, 3)
    rhs = jnp.stack([jnp.full_like(e_y, s_y), j_y, e_y], axis=-1)  # (m, 3)
    ainv = jnp.linalg.inv(amat)
    beta = jnp.einsum("mij,mj->mi", ainv, rhs)
    eff = beta[:, 2]
    var = ainv[:, 2, 2]
    chi = eff * eff / var
    return eff, chi, chi2_sf(chi, 1)


def uvlmm_gwas_epiAA(y, xmat, gmat_lst, var_com, bed_prefix, snp_lst_0=None,
                     p_cut=1.0, out_file=None):
    """Exhaustive fixed-effect interaction scan (uvlmm_gwas.py:145-198).
    Returns rows (snpi, snpj, snp_eff, p_val) with j > i."""
    import pandas as pd

    y = jnp.asarray(np.asarray(y, float).reshape(-1))
    xmat = jnp.asarray(np.asarray(xmat, float).reshape(y.shape[0], -1))
    gstack = jnp.stack([jnp.asarray(np.asarray(g, float)) for g in gmat_lst])
    pmat = _pmat_direct(jnp.asarray(np.asarray(var_com, float)), y, xmat,
                        gstack)
    geno, _, _ = prepare_genotypes(bed_prefix)
    mat, _, _ = additive_code(jnp.asarray(geno))
    num_snp = mat.shape[1]
    py = pmat @ y
    pm = pmat @ mat
    anchors = range(num_snp - 1) if snp_lst_0 is None else snp_lst_0
    rows = []
    for i in anchors:
        eff, chi, p = (np.asarray(a) for a in
                       _epi_fixed_anchor(i, mat, pmat, py, pm))
        js = np.arange(i + 1, num_snp)
        keep = p[i + 1:] < p_cut
        for j, e, pp in zip(js[keep], eff[i + 1:][keep], p[i + 1:][keep]):
            rows.append((i, j, e, pp))
    res = pd.DataFrame(rows, columns=["snpi", "snpj", "snp_eff", "p_val"])
    if out_file:
        res.to_csv(out_file, sep=" ", index=False)
    return res


def lm_snp_eff(pheno_file, bed_prefix, out_file="lm_snp_eff"):
    """Per-SNP OLS effects (uvlmm/lm.py:11-32) — via partitioned regression,
    whole panel at once."""
    from gmat_tpu.io.pheno import design_matrix

    dm = design_matrix(pheno_file, bed_prefix)
    geno, bim, _ = prepare_genotypes(bed_prefix)
    y = jnp.asarray(dm.y)
    x = jnp.asarray(dm.xmat)
    m = jnp.asarray(geno)

    @jax.jit
    def kernel(y_, x_, m_):
        xtx_inv = jnp.linalg.inv(x_.T @ x_)
        proj = lambda v: v - x_ @ (xtx_inv @ (x_.T @ v))
        ry = proj(y_)
        rm = proj(m_)
        return (rm.T @ ry) / jnp.sum(rm * rm, axis=0)

    eff = np.asarray(kernel(y, x, m))
    df = bim.copy()
    df["eff"] = eff
    df.to_csv(out_file, sep=" ", header=False, index=False)
    return df


def lm_pred(pheno_file, bed_prefix, agmat, out_file="lm_pred"):
    """Naive prediction with V = I (uvlmm/lm.py:35-54, replicated as-is)."""
    from gmat_tpu.io.pheno import design_matrix

    dm = design_matrix(pheno_file, bed_prefix)
    y = jnp.asarray(dm.y)
    x = jnp.asarray(dm.xmat)

    @jax.jit
    def kernel(y_, x_, g):
        n = y_.shape[0]
        xtx_inv = jnp.linalg.inv(x_.T @ x_)
        py = y_ - x_ @ (xtx_inv @ (x_.T @ y_))
        return g @ jax.ops.segment_sum(py, jnp.asarray(dm.rec_ids),
                                       num_segments=dm.n_col)

    eff = np.asarray(kernel(y, x, jnp.asarray(np.asarray(agmat, float))))
    np.savetxt(out_file + ".rand_eff", eff)
    return eff
