"""Balanced longitudinal random-regression REML (eigen-space, batched).

Model (reference /root/reference/gmat/longwas/balance/): every individual i
shares the T timepoints; after rotating phenotypes by the kinship
eigenvectors U (K = U diag(lam) Uᵀ), records decouple per individual:

    V_i = lam_i * Phi K_a Phiᵀ + Phi K_p Phiᵀ + sigma2_e I_T

with Phi the (T, cd) Legendre basis (cd = rorder+1), K_a/K_p the additive /
permanent-environment covariance matrices of the random-regression
coefficients.  Parameters: tril(K_a) ++ tril(K_p) ++ [sigma2_e]
(balance_varcom.py:146-165).

Algorithm parity: `balance_emai` + `pre_fdai_mat_eigen_glm` + `pre_em_mat_eigen`
+ the Cholesky-gated EM-weight search (balance_emai.py:13-84,
iter_mat.py:500-587,294-319, pre_mat.py:123-146).

Design: the reference's per-parameter Python loop over 3-D numpy batches
becomes stacked einsums over (n, T, T) arrays inside one jitted step; the
whole EM-weight grid (default 1001 candidates) is a batched solve + batched
Cholesky validity scan.
"""
from __future__ import annotations

import logging
from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from scipy import linalg as sla

from gmat_tpu import config  # noqa: F401
from gmat_tpu.longwas.data import LongData, parse_long_data, read_kin_by_codes
from gmat_tpu.longwas.legendre import leg_basis

logger = logging.getLogger(__name__)


def var_index(cov_dim: int) -> np.ndarray:
    """(nv, 3) parameter index table: (block 0/1/2, row j, col k) — reference
    balance_emai.py:26-36."""
    tril = np.tril_indices(cov_dim)
    rows = []
    for block in (0, 1):
        for j, k in zip(*tril):
            rows.append((block, j, k))
    rows.append((2, 0, 0))
    return np.array(rows)


def unpack_cov(cov_dim: int, var_com: np.ndarray):
    """var vector -> (K_a, K_p, sigma2_e); None if any block is not PD
    (reference pre_cov_mat_eigen, pre_mat.py:123-146)."""
    ntr = cov_dim * (cov_dim + 1) // 2
    tril = np.tril_indices(cov_dim)

    def block(vals):
        m = np.zeros((cov_dim, cov_dim))
        m[tril] = vals
        return m + np.tril(m, -1).T

    cov_add = block(var_com[:ntr])
    cov_per = block(var_com[ntr:2 * ntr])
    for m in (cov_add, cov_per):
        try:
            sla.cholesky(m)
        except sla.LinAlgError:
            return None
    if var_com[-1] < 0:
        return None
    return cov_add, cov_per, float(var_com[-1])


def _tit_stack(leg_tp: np.ndarray, vind: np.ndarray) -> np.ndarray:
    """(nv-1, T, T) stack of Phi (E_jk + E_kj - diag) Phiᵀ derivative kernels."""
    cd = leg_tp.shape[1]
    mats = []
    for block, j, k in vind[:-1]:
        one = np.zeros((cd, cd))
        one[j, k] = 1.0
        one = one + one.T - np.diag(np.diag(one))
        mats.append(leg_tp @ one @ leg_tp.T)
    return np.stack(mats)


@partial(jax.jit, static_argnames=("cov_dim",))
def _fdai_step(y, xmat, leg_tp, lam, cov_add, cov_per, res_var, tit, is_add,
               jj, kk, cov_dim):
    """fd vector and AI matrix (reference pre_fdai_mat_eigen_glm)."""
    n, t, p = xmat.shape
    eye_t = jnp.eye(t, dtype=y.dtype)
    vmat = (
        lam[:, None, None] * (leg_tp @ cov_add @ leg_tp.T)[None]
        + (leg_tp @ cov_per @ leg_tp.T)[None]
        + res_var * eye_t[None]
    )
    vinv = jnp.linalg.inv(vmat)
    xvx_inv = jnp.linalg.inv(jnp.einsum("ntp,ntu,nuq->pq", xmat, vinv, xmat))
    xvy = jnp.einsum("ntp,ntu,nu->p", xmat, vinv, y)
    beta = xvx_inv @ xvy
    py = jnp.einsum("ntu,nu->nt", vinv, y - xmat @ beta)

    c = jnp.where(is_add[:, None], lam[None, :], 1.0)  # (nm, n)

    # trace(V^-1 dV): via Phiᵀ V^-1 Phi sums
    g_all = jnp.einsum("tc,ntu,ud->ncd", leg_tp, vinv, leg_tp)  # (n, cd, cd)
    s_add = jnp.einsum("n,ncd->cd", lam, g_all)
    s_one = jnp.sum(g_all, axis=0)
    dbl = jnp.where(jj != kk, 2.0, 1.0)
    trvk = jnp.where(is_add, s_add[kk, jj], s_one[kk, jj]) * dbl

    # trace(P dV) correction: Phiᵀ V^-1 X per id
    h_all = jnp.einsum("tc,ntu,nup->ncp", leg_tp, vinv, xmat)  # (n, cd, p)
    t4_add = jnp.einsum("n,ncp,ndq->cdpq", lam, h_all, h_all)
    t4_one = jnp.einsum("ncp,ndq->cdpq", h_all, h_all)
    xvkvx = jnp.where(is_add[:, None, None], t4_add[jj, kk], t4_one[jj, kk])
    xvkvx = xvkvx + jnp.where(
        (jj != kk)[:, None, None], jnp.swapaxes(xvkvx, 1, 2), 0.0
    )
    trpk = jnp.einsum("pq,mpq->m", xvx_inv, xvkvx)

    # kpy / ypkpy / fd (non-residual entries)
    kpy = jnp.einsum("mtu,nu->mnt", tit, py) * c[:, :, None]  # (nm, n, T)
    ypkpy = jnp.einsum("mnt,nt->m", kpy, py)
    fd_m = -0.5 * (trvk - trpk) + 0.5 * ypkpy

    # residual entry
    trvk_res = jnp.einsum("ntt->", vinv)
    xvvx = jnp.einsum("ntp,ntu,nuv,nvq->pq", xmat, vinv, vinv, xmat)
    trpk_res = jnp.sum(xvx_inv * xvvx)
    fd_res = -0.5 * (trvk_res - trpk_res) + 0.5 * jnp.sum(py * py)
    fd = jnp.concatenate([fd_m, fd_res[None]])

    # pkpy: project each kpy through P
    kpy_all = jnp.concatenate([kpy, py[None]], axis=0)  # (nv, n, T)
    vinv_x = jnp.einsum("ntu,nup->ntp", vinv, xmat)
    u_all = jnp.einsum("mnt,ntp->mp", kpy_all, vinv_x)
    kpy_xb = kpy_all - jnp.einsum("ntp,mp->mnt", xmat, u_all @ xvx_inv.T)
    pkpy_all = jnp.einsum("ntu,mnu->mnt", vinv, kpy_xb)

    ai_full = jnp.einsum("mnt,knt->mk", kpy_all, pkpy_all)
    ai = jnp.tril(ai_full) + jnp.tril(ai_full, -1).T  # reference symmetrization
    return fd, 0.5 * ai


def em_mat_eigen(cov_dim: int, cov_add, cov_per, ran_df: int, var_com,
                 num_record: int) -> np.ndarray:
    """EM-style Hessian (reference pre_em_mat_eigen, iter_mat.py:294-319)."""
    nv = len(var_com)
    em = np.zeros((nv, nv))
    ind = np.tril_indices(cov_dim)
    ntr = len(ind[0])
    for blk, cov in ((0, cov_add), (1, cov_per)):
        tmp = np.zeros((ntr, ntr))
        for j in range(ntr):
            for k in range(j + 1):
                tmp[j, k] = tmp[k, j] = (
                    cov[ind[0][j], ind[0][k]] * cov[ind[1][j], ind[1][k]]
                    + cov[ind[0][j], ind[1][k]] * cov[ind[1][j], ind[0][k]]
                ) / (2.0 * ran_df)
        off = blk * ntr
        em[off:off + ntr, off:off + ntr] = sla.inv(tmp)
    em[-1, -1] = num_record / (var_com[-1] * var_com[-1])
    return em / 2.0


def weight_search(ai, em, fd, var_com, cov_dim: int, step: float):
    """First gamma in {0, step, ..., 1} whose blended update keeps both
    covariance blocks PD and the residual >= 0 (reference balance_emai.py:53-64)."""
    gammas = np.arange(0.0, 1.0, step)
    gammas = np.append(gammas, 1.0)
    ntr = cov_dim * (cov_dim + 1) // 2
    tril = np.tril_indices(cov_dim)

    @jax.jit
    def scan(ai_, em_, fd_, var_):
        def one(g):
            return jnp.linalg.solve((1 - g) * ai_ + g * em_, fd_)

        deltas = jax.vmap(one)(jnp.asarray(gammas))
        cands = var_[None, :] + deltas

        def block(vals):
            m = jnp.zeros((cov_dim, cov_dim), dtype=vals.dtype)
            m = m.at[tril].set(vals)
            return m + jnp.tril(m, -1).T

        badd = jax.vmap(block)(cands[:, :ntr])
        bper = jax.vmap(block)(cands[:, ntr:2 * ntr])
        ca = jnp.linalg.cholesky(badd)
        cp = jnp.linalg.cholesky(bper)
        ok = (
            ~jnp.any(jnp.isnan(ca), axis=(1, 2))
            & ~jnp.any(jnp.isnan(cp), axis=(1, 2))
            & (cands[:, -1] >= 0)
        )
        idx = jnp.argmax(ok)
        return jnp.any(ok), idx, deltas[idx]

    ok, idx, delta = scan(jnp.asarray(ai), jnp.asarray(em), jnp.asarray(fd),
                          jnp.asarray(var_com))
    if not bool(ok):
        raise RuntimeError("no EM weight yields positive-definite covariances")
    return float(gammas[int(idx)]), np.asarray(delta)


def balance_emai(y, xmat, leg_tp, kin_eigen_val, init, maxiter=30,
                 cc_par=1.0e-8, cc_gra=1.0e-6, em_weight_step=0.02):
    """Core REML loop; returns the tidy (vari, varij, varik, var_val) frame
    (reference balance_emai.py:13-84)."""
    import pandas as pd

    y = np.asarray(y, dtype=np.float64)
    if y.ndim == 3:
        y = y[:, :, 0]
    num_record = y.size
    ran_df = len(kin_eigen_val)
    cov_dim = leg_tp.shape[1]
    var_com = np.asarray(init, dtype=np.float64)
    vind = var_index(cov_dim)
    tit = _tit_stack(leg_tp, vind)
    is_add = jnp.asarray(vind[:-1, 0] == 0)
    jj = jnp.asarray(vind[:-1, 1])
    kk = jnp.asarray(vind[:-1, 2])
    cov = unpack_cov(cov_dim, var_com)
    if cov is None:
        raise ValueError("The covariances are not positive defined!")
    cov_add, cov_per, res_var = cov
    args = (jnp.asarray(y), jnp.asarray(xmat), jnp.asarray(leg_tp),
            jnp.asarray(kin_eigen_val))
    cc_par_val = cc_gra_val = 1e30
    for it in range(1, maxiter + 1):
        fd, ai = _fdai_step(*args, jnp.asarray(cov_add), jnp.asarray(cov_per),
                            res_var, jnp.asarray(tit), is_add, jj, kk, cov_dim)
        fd, ai = np.asarray(fd), np.asarray(ai)
        em = em_mat_eigen(cov_dim, cov_add, cov_per, ran_df, var_com,
                          num_record)
        gamma, delta = weight_search(ai, em, fd, var_com, cov_dim,
                                     em_weight_step)
        var_new = var_com + delta
        cov = unpack_cov(cov_dim, var_new)
        if cov is None:
            raise RuntimeError("updated variances are not positive definite")
        cov_add, cov_per, res_var = cov
        cc_par_val = np.sqrt(np.sum(delta**2) / np.sum(var_new**2))
        cc_gra_val = np.sqrt(np.sum(fd**2)) / len(var_com)
        var_com = var_new
        logger.info("Round %d: gamma %.3f | cc_par %.3e | cc_gra %.3e",
                    it, gamma, cc_par_val, cc_gra_val)
        if cc_par_val < cc_par and cc_gra_val < cc_gra:
            logger.info("Variances Converged")
            break
    return pd.DataFrame(
        {
            "vari": vind[:, 0] + 1,
            "varij": vind[:, 1] + 1,
            "varik": vind[:, 2] + 1,
            "var_val": var_com,
        }
    )


@dataclass
class BalanceModel:
    """Prepared eigen-space balanced design (shared by varcom + GWAS)."""

    data: LongData
    y: np.ndarray  # (n, T) rotated
    xmat: np.ndarray  # (n, T, p) rotated fixed design
    leg_fix: np.ndarray  # (T, forder+1) unrotated fixed Legendre basis
    leg_tp: np.ndarray  # (T, rorder+1)
    eigvals: np.ndarray
    eigvecs: np.ndarray
    tpoint: np.ndarray


def prepare_balance(data_file, id_col, tpoint, trait, kin_file, forder=3,
                    rorder=3, na_method="omit") -> BalanceModel:
    data = parse_long_data(data_file, id_col, na_method)
    ids = data.df[id_col].to_numpy()
    if len(set(ids)) != len(ids):
        raise ValueError("Duplicated ids exist in the data file!")
    kin = read_kin_by_codes(kin_file, data)
    eigvals, eigvecs = sla.eigh(kin)
    tpoint = np.asarray(tpoint, dtype=float)
    leg_fix = leg_basis(tpoint, forder)  # (T, forder+1)
    leg_tp = leg_basis(tpoint, rorder)
    n = len(data.df)
    y = data.df.iloc[:, list(trait)].to_numpy(dtype=float)
    y = eigvecs.T @ y  # rotate over individuals
    # fixed design: per id the same Legendre rows, rotated by U^T over ids
    # (reference balance_varcom.py:134-142): X_i[t, c] = sum_j U[j,i] leg_fix[t, c]
    # i.e. rotated X has X_rot[i] = (U^T 1)_i * leg_fix
    colsum = eigvecs.sum(axis=0)  # (U^T 1)_i
    xmat = colsum[:, None, None] * leg_fix[None, :, :]
    return BalanceModel(data=data, y=y, xmat=xmat, leg_fix=leg_fix,
                        leg_tp=leg_tp, eigvals=eigvals, eigvecs=eigvecs,
                        tpoint=tpoint)


def default_init(y, cov_dim):
    """Initial variances (reference balance_varcom.py:150-156)."""
    y_var = np.var(y) / (cov_dim * 2 + 1)
    ntr = cov_dim * (cov_dim + 1) // 2
    tril_vals = np.diag([y_var] * cov_dim)[np.tril_indices(cov_dim)]
    return np.concatenate([tril_vals, tril_vals, [y_var]])


def balance_varcom(data_file, id_col, tpoint, trait, kin_file, tfix=None,
                   fix=None, forder=3, rorder=3, na_method="omit", init=None,
                   maxiter=100, cc_par=1.0e-8, cc_gra=1.0e6,
                   em_weight_step=0.001, prefix_outfile="balance_varcom"):
    """Reference balance_varcom (balance_varcom.py:13-174).  tfix/fix must be
    None (same restriction as the reference's current version)."""
    if tfix is not None or fix is not None:
        raise NotImplementedError(
            "tfix/fix must be None for balanced data (reference parity)"
        )
    model = prepare_balance(data_file, id_col, tpoint, trait, kin_file,
                            forder, rorder, na_method)
    cov_dim = model.leg_tp.shape[1]
    raw_y = model.data.df.iloc[:, list(trait)].to_numpy(dtype=float)
    var_com = default_init(raw_y, cov_dim) if init is None else np.asarray(init)
    res = balance_emai(model.y, model.xmat, model.leg_tp, model.eigvals,
                       init=var_com, maxiter=maxiter, cc_par=cc_par,
                       cc_gra=cc_gra, em_weight_step=em_weight_step)
    res.to_csv(prefix_outfile + ".var", sep=" ", index=False)
    return res
