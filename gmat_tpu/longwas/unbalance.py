"""Unbalanced longitudinal random-regression REML (Henderson MME, EM+AI).

Model (reference /root/reference/gmat/longwas/unbalance/): records y_r at
arbitrary times t_r per individual,

    y = X b + Z_a u_a + Z_p u_p + e,
    u_a ~ N(0, K_a ⊗ G),  u_p ~ N(0, K_p ⊗ I),  e ~ N(0, sigma2 I)

with Z_* the Legendre-weighted incidence matrices, blocks ordered
coefficient-major (all individuals for coefficient 0, then coefficient 1, ...)
so the MME penalty is kron(K_*^{-1}, G^{-1}) (unbalance_varcom.py:199-219,
unbalance_emai.py:79-90).

Parity: `unbalance_emai` + `pre_fd_mat_x` + `pre_ai_mat` + `pre_em_mat` +
`pre_covi_mat` (unbalance_emai.py:15-135, iter_mat.py:40-190,
pre_mat.py:11-29), including the reference's quirk that a non-PD AI matrix
silently degrades the blended update to a pure EM step (pre_ai_mat returns
False, and (1-gamma)*False == 0).

Design: Z matrices never materialize — every Z product is a gather /
segment_sum keyed by the record->individual index; the dense MME coefficient
matrix is assembled blockwise on device and inverted once per iteration (the
single O(D^3) hot op); fd/AI/EM and the EM-weight grid are batched
einsums inside the same jitted step.
"""
from __future__ import annotations

import logging
from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.ops import segment_sum
from scipy import linalg as sla

from gmat_tpu import config  # noqa: F401
from gmat_tpu.longwas.data import (
    LongData,
    build_fixed_formula,
    check_sorted_by_id,
    parse_long_data,
    read_kin_by_codes,
)
from gmat_tpu.longwas.legendre import leg_basis

logger = logging.getLogger(__name__)


@dataclass
class UnbalanceModel:
    data: LongData
    y: np.ndarray          # (n_rec,)
    xmat: np.ndarray       # (n_rec, p)
    rec_ids: np.ndarray    # (n_rec,) 0-based individual codes
    leg_a: np.ndarray      # (n_rec, cd_a)
    leg_p: np.ndarray      # (n_rec, cd_p)
    leg_f: np.ndarray      # (n_rec, forder+1) fixed-effect basis per record
    kin: np.ndarray        # (q_a, q_a): G^-1 for varcom, G for the GWAS phase
    q_a: int
    q_p: int
    tmin: float
    tmax: float
    tpoint_col: str


def prepare_unbalance(data_file, id_col, tpoint, trait, kin_file, tfix=None,
                      fix=None, forder=3, aorder=3, porder=3,
                      na_method="omit", kin_is_inverse=True) -> UnbalanceModel:
    data = parse_long_data(data_file, id_col, na_method)
    check_sorted_by_id(data)
    t = data.df[tpoint].to_numpy(dtype=float)
    y = data.df[trait].to_numpy(dtype=float)
    leg_f = leg_basis(t, forder)
    # time-varied fixed design (reference unbalance_varcom.py:125-142)
    if tfix is None:
        xmat_t = leg_f.copy()
    else:
        if tfix not in data.class_vec:
            raise ValueError(f"{tfix} is not a class variate")
        codes = data.df[tfix].to_numpy(dtype=np.int64) - 1
        n_lev = codes.max() + 1
        onehot = np.zeros((len(codes), n_lev))
        onehot[np.arange(len(codes)), codes] = 1.0
        xmat_t = np.concatenate(
            [onehot * leg_f[:, i:i + 1] for i in range(leg_f.shape[1])], axis=1
        )
    xmat_nt = build_fixed_formula(data, fix)
    xmat = xmat_t if xmat_nt is None else np.concatenate([xmat_t, xmat_nt], 1)
    q_p = int(data.df[id_col].max())
    kin = read_kin_by_codes(kin_file, data, add_missing=kin_is_inverse)
    return UnbalanceModel(
        data=data, y=y, xmat=xmat,
        rec_ids=data.df[id_col].to_numpy(dtype=np.int64) - 1,
        leg_a=leg_basis(t, aorder), leg_p=leg_basis(t, porder), leg_f=leg_f,
        kin=kin, q_a=kin.shape[0], q_p=q_p,
        tmin=float(t.min()), tmax=float(t.max()), tpoint_col=tpoint,
    )


def _covi(cov_dim, vals):
    """Inverse of a tril-packed covariance; None if not PD / residual <= 0
    handled by caller (reference pre_covi_mat, pre_mat.py:11-29)."""
    tril = np.tril_indices(cov_dim)
    m = np.zeros((cov_dim, cov_dim))
    m[tril] = vals
    m = m + np.tril(m, -1).T
    try:
        sla.cholesky(m)
    except sla.LinAlgError:
        return None, None
    return sla.inv(m), m


def _var_layout(cd_a, cd_p):
    """Index bookkeeping for the packed parameter vector."""
    ntr_a = cd_a * (cd_a + 1) // 2
    ntr_p = cd_p * (cd_p + 1) // 2
    vari, varij, varik = [], [], []
    for blk, cd in ((1, cd_a), (2, cd_p)):
        for j in range(cd):
            for k in range(j + 1):
                vari.append(blk)
                varij.append(j + 1)
                varik.append(k + 1)
    vari.append(3)
    varij.append(1)
    varik.append(1)
    return ntr_a, ntr_p, np.array(vari), np.array(varij), np.array(varik)


class _MmePieces:
    """Static per-dataset precomputations shared across iterations."""

    def __init__(self, model: UnbalanceModel):
        m = model
        self.p = m.xmat.shape[1]
        self.cd_a = m.leg_a.shape[1]
        self.cd_p = m.leg_p.shape[1]
        self.q_a, self.q_p = m.q_a, m.q_p
        self.d_tot = self.p + self.cd_a * self.q_a + self.cd_p * self.q_p
        self.n_rec = len(m.y)
        x = jnp.asarray(m.xmat)
        la = jnp.asarray(m.leg_a)
        lp = jnp.asarray(m.leg_p)
        rid = jnp.asarray(m.rec_ids)
        y = jnp.asarray(m.y)

        def seg(v, q):
            return segment_sum(v, rid, num_segments=q)

        # dense W^T W assembled blockwise (coefficient-major Z layout)
        d = self.d_tot
        c = jnp.zeros((d, d))
        c = c.at[: self.p, : self.p].set(x.T @ x)
        off_a = self.p
        off_p = self.p + self.cd_a * self.q_a

        def blk_a(j):
            return off_a + j * self.q_a

        def blk_p(j):
            return off_p + j * self.q_p

        for j in range(self.cd_a):
            xz = seg(x * la[:, j:j + 1], self.q_a).T  # (p, q_a)
            c = c.at[: self.p, blk_a(j):blk_a(j) + self.q_a].set(xz)
            c = c.at[blk_a(j):blk_a(j) + self.q_a, : self.p].set(xz.T)
        for j in range(self.cd_p):
            xz = seg(x * lp[:, j:j + 1], self.q_p).T
            c = c.at[: self.p, blk_p(j):blk_p(j) + self.q_p].set(xz)
            c = c.at[blk_p(j):blk_p(j) + self.q_p, : self.p].set(xz.T)
        for j in range(self.cd_a):
            for k in range(self.cd_a):
                dg = seg(la[:, j] * la[:, k], self.q_a)
                idx = jnp.arange(self.q_a)
                c = c.at[blk_a(j) + idx, blk_a(k) + idx].set(dg)
            for k in range(self.cd_p):
                dg = seg(la[:, j] * lp[:, k], self.q_p)
                idx = jnp.arange(self.q_p)
                c = c.at[blk_a(j) + idx, blk_p(k) + idx].set(dg)
                c = c.at[blk_p(k) + idx, blk_a(j) + idx].set(dg)
        for j in range(self.cd_p):
            for k in range(self.cd_p):
                dg = seg(lp[:, j] * lp[:, k], self.q_p)
                idx = jnp.arange(self.q_p)
                c = c.at[blk_p(j) + idx, blk_p(k) + idx].set(dg)
        self.cmat_pure = c
        rhs = jnp.concatenate(
            [x.T @ y]
            + [seg(y * la[:, j], self.q_a) for j in range(self.cd_a)]
            + [seg(y * lp[:, j], self.q_p) for j in range(self.cd_p)]
        )
        self.rhs_pure = rhs
        self.x, self.la, self.lp, self.rid, self.y = x, la, lp, rid, y
        self.off_a, self.off_p = off_a, off_p


def _iter_step(pieces: _MmePieces, kin_inv, covi_a, covi_p, var_e, var_com,
               gammas, tril_a, tril_p):
    """One EM+AI iteration; returns (fd, ai, em) plus effect residuals."""
    p, cd_a, cd_p = pieces.p, pieces.cd_a, pieces.cd_p
    q_a, q_p = pieces.q_a, pieces.q_p
    n_rec = pieces.n_rec
    cmat = pieces.cmat_pure / var_e
    pen_a = jnp.kron(covi_a, kin_inv)
    pen_p = jnp.kron(covi_p, jnp.eye(q_p))
    sa = slice(pieces.off_a, pieces.off_a + cd_a * q_a)
    sp_ = slice(pieces.off_p, pieces.off_p + cd_p * q_p)
    cmat = cmat.at[sa, sa].add(pen_a)
    cmat = cmat.at[sp_, sp_].add(pen_p)
    cmati = jnp.linalg.inv(cmat)
    eff = cmati @ (pieces.rhs_pure / var_e)
    u_a = eff[sa].reshape(cd_a, q_a)
    u_p = eff[sp_].reshape(cd_p, q_p)
    zu = (
        jnp.einsum("rc,cr->r", pieces.la, u_a[:, pieces.rid])
        + jnp.einsum("rc,cr->r", pieces.lp, u_p[:, pieces.rid])
    )
    e = pieces.y - pieces.x @ eff[:p] - zu

    # --- fd (reference pre_fd_mat_x)
    def fd_block(covi, u_mat, q, off, cd, kin_dense):
        cinv_blocks = cmati[off:off + cd * q, off:off + cd * q].reshape(
            cd, q, cd, q
        )
        if kin_dense is None:
            tmat = jnp.einsum("jaka->jk", cinv_blocks)
            km = u_mat @ covi  # (q, cd)  "eff_mat"
            quad = km.T @ km
        else:
            tmat = jnp.einsum("ab,jakb->jk", kin_dense, cinv_blocks)
            km = u_mat @ covi
            quad = km.T @ (kin_dense @ km)
        temp = q * covi - covi @ tmat @ covi - quad
        dbl = temp + jnp.tril(temp, -1)  # doubles strict-lower entries
        tril = jnp.tril_indices(cd)
        return -0.5 * dbl[tril]

    fd_a = fd_block(covi_a, u_a.T, q_a, pieces.off_a, cd_a, kin_inv)
    fd_p = fd_block(covi_p, u_p.T, q_p, pieces.off_p, cd_p, None)
    fd_res = -0.5 * (
        n_rec / var_e
        - jnp.sum(pieces.cmat_pure * cmati) / (var_e * var_e)
        - jnp.dot(e, e) / (var_e * var_e)
    )
    fd = jnp.concatenate([fd_a, fd_p, fd_res[None]])

    # --- AI working variables (reference pre_ai_mat)
    def wv_block(covi, u_mat, leg, cd, tril):
        # for each tril pair (j,k): column r = sum_c leg[r,c] (U M^T)[id_r, c]
        # reference var_fd: 1.0 at (j,k) and (k,j) — a single 1 when j == k
        i0, i1 = tril
        eye = jnp.eye(cd)
        esym = jnp.where(
            (i0 == i1)[:, None, None],
            eye[i0][:, :, None] * eye[i1][:, None, :],
            (eye[i0][:, :, None] * eye[i1][:, None, :]
             + eye[i1][:, :, None] * eye[i0][:, None, :]),
        )
        m_all = jnp.einsum("mjc,cd->mjd", esym, covi)
        tc = jnp.einsum("qc,mjc->mqj", u_mat, m_all)  # (ntr, q, cd)
        return jnp.einsum("rc,mrc->rm", leg, tc[:, pieces.rid, :])

    wv_a = wv_block(covi_a, u_a.T, pieces.la, cd_a, tril_a)
    wv_p = wv_block(covi_p, u_p.T, pieces.lp, cd_p, tril_p)
    qmat = jnp.concatenate([wv_a, wv_p, (e / var_e)[:, None]], axis=1)
    nv = qmat.shape[1]
    qrq = (qmat.T @ qmat) / var_e

    def wt_dot(v):  # W^T v for a (n_rec,) vector
        return jnp.concatenate(
            [pieces.x.T @ v]
            + [segment_sum(v * pieces.la[:, j], pieces.rid, num_segments=q_a)
               for j in range(cd_a)]
            + [segment_sum(v * pieces.lp[:, j], pieces.rid, num_segments=q_p)
               for j in range(cd_p)]
        )

    left = jax.vmap(wt_dot, in_axes=1, out_axes=1)(qmat) / var_e
    ai = 0.5 * (qrq - left.T @ (cmati @ left))
    # reference: non-PD AI silently becomes 0 (pure EM step)
    ai_ok = ~jnp.any(jnp.isnan(jnp.linalg.cholesky(ai)))
    ai = jnp.where(ai_ok, ai, jnp.zeros_like(ai))

    # --- EM (reference pre_em_mat: build, x2, symmetrize, invert)
    def em_block(cov, q, tril):
        i0, i1 = tril
        t = (
            cov[i0[:, None], i0[None, :]] * cov[i1[:, None], i1[None, :]]
            + cov[i0[:, None], i1[None, :]] * cov[i1[:, None], i0[None, :]]
        ) / (2.0 * q)
        return jnp.tril(t)

    ntr_a, ntr_p = len(tril_a[0]), len(tril_p[0])
    cov_a = jnp.linalg.inv(covi_a)
    cov_p = jnp.linalg.inv(covi_p)
    em = jnp.zeros((nv, nv))
    em = em.at[:ntr_a, :ntr_a].set(em_block(cov_a, q_a, tril_a))
    em = em.at[ntr_a:ntr_a + ntr_p, ntr_a:ntr_a + ntr_p].set(
        em_block(cov_p, q_p, tril_p)
    )
    em = em.at[-1, -1].set((var_e * var_e) / n_rec)
    em = 2.0 * em
    em = em + jnp.tril(em, -1).T
    em = jnp.linalg.inv(em)

    # --- batched weight-search deltas
    def delta_for(g):
        return jnp.linalg.solve((1 - g) * ai + g * em, fd)

    deltas = jax.vmap(delta_for)(gammas)
    return fd, deltas


def unbalance_emai(model: UnbalanceModel, init=None, maxiter=30,
                   cc_par=1.0e-8, cc_gra=1.0e-6, em_weight_step=0.001):
    """MME-based EM+AI driver (reference unbalance_emai.py:15-135)."""
    import pandas as pd

    cd_a = model.leg_a.shape[1]
    cd_p = model.leg_p.shape[1]
    ntr_a, ntr_p, vari, varij, varik = _var_layout(cd_a, cd_p)
    if init is None:
        y_var = np.var(model.y) / (cd_a + cd_p + 1)
        var_com = np.zeros(ntr_a + ntr_p + 1)
        diag_a = [j * (j + 3) // 2 for j in range(cd_a)]
        diag_p = [ntr_a + j * (j + 3) // 2 for j in range(cd_p)]
        var_com[diag_a] = y_var
        var_com[diag_p] = y_var
        var_com[-1] = y_var
    else:
        var_com = np.asarray(init, dtype=float)
    pieces = _MmePieces(model)
    kin_inv = jnp.asarray(model.kin)
    tril_a = np.tril_indices(cd_a)
    tril_p = np.tril_indices(cd_p)
    gammas = np.append(np.arange(0.0, 1.0, em_weight_step), 1.0)
    step = jax.jit(
        partial(_iter_step, pieces, kin_inv, gammas=jnp.asarray(gammas),
                tril_a=tril_a, tril_p=tril_p)
    )
    covi_a, _ = _covi(cd_a, var_com[:ntr_a])
    covi_p, _ = _covi(cd_p, var_com[ntr_a:ntr_a + ntr_p])
    if covi_a is None or covi_p is None or var_com[-1] <= 0:
        raise ValueError("initial variances are not positive definite")
    cc_par_val = cc_gra_val = 1e30
    for it in range(1, maxiter + 1):
        fd, deltas = step(jnp.asarray(covi_a), jnp.asarray(covi_p),
                          float(var_com[-1]), jnp.asarray(var_com))
        fd, deltas = np.asarray(fd), np.asarray(deltas)
        # first gamma whose update keeps both blocks PD and residual > 0
        chosen = None
        for g_idx in range(len(gammas)):
            cand = var_com + deltas[g_idx]
            if cand[-1] <= 0:
                continue
            ca, _ = _covi(cd_a, cand[:ntr_a])
            cp, _ = _covi(cd_p, cand[ntr_a:ntr_a + ntr_p])
            if ca is not None and cp is not None:
                chosen = (g_idx, cand, ca, cp)
                break
        if chosen is None:
            raise RuntimeError("updated variances are not positive definite")
        g_idx, var_new, covi_a, covi_p = chosen
        delta = deltas[g_idx]
        cc_par_val = np.sqrt(np.sum(delta**2) / np.sum(var_new**2))
        cc_gra_val = np.sqrt(np.sum(fd**2)) / len(var_com)
        var_com = var_new
        logger.info("Round %d: gamma %.3f | cc_par %.3e | cc_gra %.3e",
                    it, gammas[g_idx], cc_par_val, cc_gra_val)
        if cc_par_val < cc_par and cc_gra_val < cc_gra:
            logger.info("Variances Converged")
            break
    return pd.DataFrame(
        {"vari": vari, "varij": varij, "varik": varik, "var_val": var_com}
    )


def unbalance_varcom(data_file, id_col, tpoint, trait, kin_inv_file,
                     tfix=None, fix=None, forder=3, aorder=3, porder=3,
                     na_method="omit", init=None, maxiter=100, cc_par=1.0e-8,
                     cc_gra=1.0e6, em_weight_step=0.001,
                     prefix_outfile="unbalance_varcom"):
    """Reference unbalance_varcom (unbalance_varcom.py:15-226)."""
    model = prepare_unbalance(data_file, id_col, tpoint, trait, kin_inv_file,
                              tfix, fix, forder, aorder, porder, na_method,
                              kin_is_inverse=True)
    res = unbalance_emai(model, init=init, maxiter=maxiter, cc_par=cc_par,
                         cc_gra=cc_gra, em_weight_step=em_weight_step)
    res.to_csv(prefix_outfile + ".var", sep=" ", index=False)
    return res
