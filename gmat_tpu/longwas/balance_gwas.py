"""Balanced longitudinal GWAS: fixed-regression and linear-transformation tests.

Parity targets:
- `balance_longwas_fixed` (/root/reference/gmat/longwas/balance/
  balance_longwas_fixed.py:14-243 + balance_longwas_emai.py:13-95): per SNP,
  append SNP x Legendre fixed columns (rotated), re-run a short (maxiter=10)
  EM+AI REML, Wald chi-square on the SNP coefficients, plus per-timepoint
  p values, p_min and accumulated-effect p.
- `balance_longwas_trans` (balance_longwas_trans.py:185-269): single V/P
  computation, per SNP the effect is recovered from GBLUP retransformation
  snp_eff = K_a Phiᵀ (sum_i s_i py_i); no per-SNP REML.
- `*_permutation` twins (balance_longwas_fixed_permutation.py:185-252):
  shuffle individual rows of the SNP matrix per replicate (seeded here) and
  rerun, one result file per replicate.

Design: the reference loops SNPs in Python, one small REML per iteration.
Here the *entire per-SNP REML* (fori_loop over iterations, batched EM-weight
search, convergence masking) is vmapped over SNP batches — hundreds of SNPs
iterate in lockstep; the trans test is three einsums for ALL SNPs.
"""
from __future__ import annotations

import logging
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from gmat_tpu.core.stats import chi2_sf
from gmat_tpu.longwas.balance import (
    BalanceModel,
    _tit_stack,
    prepare_balance,
    var_index,
)
from gmat_tpu.longwas.legendre import leg_basis

logger = logging.getLogger(__name__)


def _resolve_dtype(precision: str):
    """Compute dtype for the longwas test statistics: 'auto' -> float64 on
    every device; 'f32' is the explicit reduced-precision path.
    GMAT_TPU_LONGWAS=f32|f64 overrides.  Calls are traced under
    `jax.default_matmul_precision("float32")` so f32 contractions run in
    full float32 (no TF32/bf16 operand rounding), keeping the golden-gated
    parity band (tests pin the f32 path against the reference f64
    goldens)."""
    import os

    mode = os.environ.get("GMAT_TPU_LONGWAS", precision).lower()
    if mode == "auto":
        mode = "f64"
    if mode not in ("f32", "f64"):
        raise ValueError(f"unknown longwas precision {mode!r}")
    return np.float32 if mode == "f32" else np.float64


def _unpack_cov_df(var_com_df, block):
    sub = var_com_df[var_com_df["vari"] == block]
    dim = int(sub["varij"].max())
    m = np.zeros((dim, dim))
    m[sub["varij"] - 1, sub["varik"] - 1] = sub["var_val"]
    return m + np.tril(m, -1).T


def _load_snp(model: BalanceModel, bed_prefix, snp_lst):
    """Raw (uncentered — reference parity) SNP matrix rows matched to the
    data order."""
    from gmat_tpu.scan.common import prepare_genotypes

    geno, bim, fam = prepare_genotypes(bed_prefix)
    id_geno = list(fam["iid"].astype(str))
    raw_ids = model.data.raw_ids_in_code_order()
    missing = set(raw_ids) - set(id_geno)
    if missing:
        raise ValueError(f"ids not in the snp file: {sorted(missing)[:5]}")
    rows = [id_geno.index(i) for i in raw_ids]
    if snp_lst is None:
        snp_lst = list(range(geno.shape[1]))
    snp_lst = list(snp_lst)
    return geno[np.ix_(rows, snp_lst)], bim, snp_lst, geno.shape[0]


# ---------------------------------------------------------------------------
# fixed-regression test: vmapped per-SNP REML
# ---------------------------------------------------------------------------

def _tril_index_map(cov_dim, tril):
    """(k, k) int map from matrix position to packed-tril slot."""
    idx = np.zeros((cov_dim, cov_dim), dtype=np.int32)
    idx[tril] = np.arange(len(tril[0]), dtype=np.int32)
    return np.maximum(idx, idx.T)


def _cov_from_vec(var, cov_dim, tril):
    """Unpack (..., 2*ntr+1) parameter vectors into the two (k, k)
    covariance blocks + residual — a static gather, so it batches over
    leading axes with no per-element scatter (the round-4 .at[].set form
    emitted one tiny scatter per weight candidate)."""
    ntr = len(tril[0])
    idx = jnp.asarray(_tril_index_map(cov_dim, tril))
    return (var[..., :ntr][..., idx], var[..., ntr:2 * ntr][..., idx],
            var[..., -1])


def _chol_pd_unrolled(cov):
    """PD test for (..., k, k) batches via the UNROLLED Cholesky
    recurrence (static small k): k(k+1)/2 elementwise ops instead of one
    LAPACK Cholesky call per batch element — the weight search tests
    ~256k 4x4 candidates per REML iteration."""
    k = cov.shape[-1]
    tiny = jnp.asarray(np.finfo(np.dtype(cov.dtype)).tiny, cov.dtype)
    l: list = [[None] * k for _ in range(k)]
    ok = jnp.ones(cov.shape[:-2], bool)
    for i in range(k):
        for j in range(i + 1):
            s = cov[..., i, j]
            for p in range(j):
                s = s - l[i][p] * l[j][p]
            if i == j:
                # isfinite: an exploded (inf) candidate must fail like the
                # LAPACK cholesky's NaN would
                ok = ok & (s > 0) & jnp.isfinite(s)
                l[i][i] = jnp.sqrt(jnp.maximum(s, tiny))
            else:
                l[i][j] = s / l[j][j]
    return ok


def _pd_ok(cov_add, cov_per, res):
    return (_chol_pd_unrolled(cov_add) & _chol_pd_unrolled(cov_per)
            & (res >= 0))


def _model_pieces(xmat, leg_tp, lam, cov_add, cov_per, res_var):
    """Per-id V^-1 in closed form from ONE (t, t) Cholesky + eigh.

    V_i = lam_i * A + C with A = leg K_a leg' and C = leg K_p leg' + r I
    shared by every id — only the scalar kinship eigenvalue lam_i varies.
    Whiten A by C = M M' and eigendecompose W = M^-1 A M^-T = Q D Q';
    with U = M^-T Q,  V_i^-1 = U diag(1/(lam_i d + 1)) U'.  This replaces
    a batched LU inverse over every (SNP, id) pair with one small
    cholesky+eigh pair."""
    from jax.scipy.linalg import solve_triangular

    t = leg_tp.shape[0]
    amat = leg_tp @ cov_add @ leg_tp.T
    cmat = (leg_tp @ cov_per @ leg_tp.T
            + res_var * jnp.eye(t, dtype=xmat.dtype))
    mchol = jnp.linalg.cholesky(cmat)
    w = solve_triangular(
        mchol, solve_triangular(mchol, amat, lower=True).T, lower=True)
    w = (w + w.T) / 2
    d, q = jnp.linalg.eigh(w)
    u = solve_triangular(mchol.T, q, lower=False)  # (t, t), not orthogonal
    wgt = 1.0 / (lam[:, None] * d[None, :] + 1.0)  # (n, t)
    vinv = jnp.einsum("tc,nc,uc->ntu", u, wgt, u)
    xvx_inv = jnp.linalg.inv(jnp.einsum("ntp,ntu,nuq->pq", xmat, vinv, xmat))
    return vinv, xvx_inv


def _fdai_core(y, xmat, leg_tp, lam, cov_add, cov_per, res_var, tit, is_add,
               jj, kk):
    """fd/AI — same math as balance._fdai_step but uncompiled so it can be
    vmapped over per-SNP designs."""
    vinv, xvx_inv = _model_pieces(xmat, leg_tp, lam, cov_add, cov_per, res_var)
    xvy = jnp.einsum("ntp,ntu,nu->p", xmat, vinv, y)
    py = jnp.einsum("ntu,nu->nt", vinv, y - xmat @ (xvx_inv @ xvy))
    c = jnp.where(is_add[:, None], lam[None, :], 1.0)
    g_all = jnp.einsum("tc,ntu,ud->ncd", leg_tp, vinv, leg_tp)
    s_add = jnp.einsum("n,ncd->cd", lam, g_all)
    s_one = jnp.sum(g_all, axis=0)
    dbl = jnp.where(jj != kk, 2.0, 1.0)
    trvk = jnp.where(is_add, s_add[kk, jj], s_one[kk, jj]) * dbl
    h_all = jnp.einsum("tc,ntu,nup->ncp", leg_tp, vinv, xmat)
    t4_add = jnp.einsum("n,ncp,ndq->cdpq", lam, h_all, h_all)
    t4_one = jnp.einsum("ncp,ndq->cdpq", h_all, h_all)
    xvkvx = jnp.where(is_add[:, None, None], t4_add[jj, kk], t4_one[jj, kk])
    xvkvx = xvkvx + jnp.where((jj != kk)[:, None, None],
                              jnp.swapaxes(xvkvx, 1, 2), 0.0)
    trpk = jnp.einsum("pq,mpq->m", xvx_inv, xvkvx)
    kpy = jnp.einsum("mtu,nu->mnt", tit, py) * c[:, :, None]
    ypkpy = jnp.einsum("mnt,nt->m", kpy, py)
    fd_m = -0.5 * (trvk - trpk) + 0.5 * ypkpy
    trvk_res = jnp.einsum("ntt->", vinv)
    xvvx = jnp.einsum("ntp,ntu,nuv,nvq->pq", xmat, vinv, vinv, xmat)
    trpk_res = jnp.sum(xvx_inv * xvvx)
    fd_res = -0.5 * (trvk_res - trpk_res) + 0.5 * jnp.sum(py * py)
    fd = jnp.concatenate([fd_m, fd_res[None]])
    kpy_all = jnp.concatenate([kpy, py[None]], axis=0)
    vinv_x = jnp.einsum("ntu,nup->ntp", vinv, xmat)
    u_all = jnp.einsum("mnt,ntp->mp", kpy_all, vinv_x)
    kpy_xb = kpy_all - jnp.einsum("ntp,mp->mnt", xmat, u_all @ xvx_inv.T)
    pkpy_all = jnp.einsum("ntu,mnu->mnt", vinv, kpy_xb)
    ai_full = jnp.einsum("mnt,knt->mk", kpy_all, pkpy_all)
    ai = jnp.tril(ai_full) + jnp.tril(ai_full, -1).T
    return fd, 0.5 * ai


def _em_core(cov_add, cov_per, ran_df, res_var, num_record, cov_dim, tril):
    """EM Hessian in jnp (reference pre_em_mat_eigen)."""
    i0 = jnp.asarray(tril[0])
    i1 = jnp.asarray(tril[1])
    ntr = len(tril[0])
    nv = 2 * ntr + 1

    def block(cov):
        t = (cov[i0[:, None], i0[None, :]] * cov[i1[:, None], i1[None, :]]
             + cov[i0[:, None], i1[None, :]] * cov[i1[:, None], i0[None, :]]
             ) / (2.0 * ran_df)
        return jnp.linalg.inv(t)

    em = jnp.zeros((nv, nv), dtype=cov_add.dtype)
    em = em.at[:ntr, :ntr].set(block(cov_add))
    em = em.at[ntr:2 * ntr, ntr:2 * ntr].set(block(cov_per))
    em = em.at[-1, -1].set(num_record / (res_var * res_var))
    return em / 2.0


def _emai_single(y, xmat, leg_tp, lam, var0, tit, is_add, jj, kk, gammas,
                 cov_dim, tril, maxiter, cc_par, cc_gra):
    """One SNP's short REML (reference balance_longwas_emai.py:13-95),
    vmappable over xmat/var0."""
    num_record = y.size
    ran_df = y.shape[0]

    def body(_, state):
        var, converged, ccp, ccg = state
        cov_add, cov_per, res_var = _cov_from_vec(var, cov_dim, tril)
        fd, ai = _fdai_core(y, xmat, leg_tp, lam, cov_add, cov_per, res_var,
                            tit, is_add, jj, kk)
        em = _em_core(cov_add, cov_per, ran_df, res_var, num_record, cov_dim,
                      tril)

        # delta(g) = ((1-g) ai + g em)^-1 fd for the WHOLE gamma grid via
        # one Cholesky of em + one symmetric eigendecomposition of the
        # whitened pencil A' = L^-1 ai L^-T (em = L L^T):
        #   delta(g) = L^-T Q diag(1/((1-g) lam + g)) Q^T L^-1 fd
        # O(k^2) per gamma instead of a k^3 LU each (the vmapped-solve
        # form ran 256k batched 21x21 LUs per REML iteration).
        # A non-PD blend ((1-g) lam + g <= 0) yields an exploded/NaN
        # delta, which the PD candidate gate below rejects exactly like
        # the LU form's singular solve.
        from jax.scipy.linalg import solve_triangular

        lmat = jnp.linalg.cholesky(em)
        b = solve_triangular(lmat, ai, lower=True)
        aw = solve_triangular(lmat, b.T, lower=True)
        aw = (aw + aw.T) / 2
        lam_w, q = jnp.linalg.eigh(aw)
        rhs = q.T @ solve_triangular(lmat, fd, lower=True)
        denom = (1 - gammas)[:, None] * lam_w[None, :] + gammas[:, None]
        coef = rhs[None, :] / denom  # (G, nv)
        deltas = solve_triangular(lmat.T, q @ coef.T, lower=False).T
        cands = var[None, :] + deltas

        ca, cp, r = _cov_from_vec(cands, cov_dim, tril)
        ok = _pd_ok(ca, cp, r)
        idx = jnp.where(jnp.any(ok), jnp.argmax(ok), len(gammas) - 1)
        delta = deltas[idx]
        var_new = var + delta
        ccp_new = jnp.sqrt(jnp.sum(delta**2) / jnp.sum(var_new**2))
        ccg_new = jnp.sqrt(jnp.sum(fd**2)) / var.shape[0]
        done_now = (ccp_new < cc_par) & (ccg_new < cc_gra)
        var_out = jnp.where(converged, var, var_new)
        ccp_out = jnp.where(converged, ccp, ccp_new)
        ccg_out = jnp.where(converged, ccg, ccg_new)
        return var_out, converged | done_now, ccp_out, ccg_out

    state = (var0, jnp.asarray(False), jnp.asarray(1e4, var0.dtype),
             jnp.asarray(1e4, var0.dtype))
    var, _, ccp, ccg = jax.lax.fori_loop(0, maxiter, body, state)

    # Wald test on the trailing cov_dim SNP coefficients
    cov_add, cov_per, res_var = _cov_from_vec(var, cov_dim, tril)
    vinv, xvx_inv = _model_pieces(xmat, leg_tp, lam, cov_add, cov_per, res_var)
    xvy = jnp.einsum("ntp,ntu,nu->p", xmat, vinv, y)
    b = xvx_inv @ xvy
    eff = b[-cov_dim:]
    eff_var = xvx_inv[-cov_dim:, -cov_dim:]
    chi = eff @ jnp.linalg.inv(eff_var) @ eff
    return ccp, ccg, eff, chi, eff_var


def _tpoint_stats(eff, eff_var, leg_tpoint_mat):
    """per-timepoint chi/p inputs + accumulated effect (reference
    balance_longwas_fixed.py:211-222)."""
    et = leg_tpoint_mat @ eff  # (T,)
    vt = jnp.einsum("tc,cd,td->t", leg_tpoint_mat, eff_var, leg_tpoint_mat)
    chi_t = et * et / vt
    accum = jnp.sum(leg_tpoint_mat, axis=0)
    ea = accum @ eff
    va = accum @ eff_var @ accum
    return chi_t, ea * ea / va


def balance_longwas_fixed(data_file, id_col, tpoint, trait, kin_file,
                          bed_prefix, var_com, snp_lst=None, tfix=None,
                          fix=None, forder=3, rorder=3, na_method="omit",
                          maxiter=10, cc_par=1.0e-6, cc_gra=1.0e6,
                          em_weight_step=0.001,
                          prefix_outfile="balance_longwas_fixed",
                          snp_batch=64, _snp_shuffle=None, precision="auto"):
    import pandas as pd

    if tfix is not None or fix is not None:
        raise NotImplementedError("tfix/fix must be None (reference parity)")
    dt = _resolve_dtype(precision)
    model = prepare_balance(data_file, id_col, tpoint, trait, kin_file,
                            forder, rorder, na_method)
    cov_dim = model.leg_tp.shape[1]
    if isinstance(var_com, pd.DataFrame):
        var0 = var_com["var_val"].to_numpy(dtype=float)
    else:
        var0 = np.asarray(var_com, dtype=float)
    snp_mat, bim, snp_lst, _ = _load_snp(model, bed_prefix, snp_lst)
    if _snp_shuffle is not None:
        snp_mat = snp_mat[_snp_shuffle, :]
    # rotated SNP fixed block: X_snp[i] = (U^T s)_i * leg_fix
    snp_rot = (model.eigvecs.T @ snp_mat).astype(dt)  # (n, S)
    vind = var_index(cov_dim)
    tit = _tit_stack(model.leg_tp, vind)
    tril = np.tril_indices(cov_dim)
    gammas = np.append(np.arange(0.0, 1.0, em_weight_step), 1.0)
    leg_tpoint_mat = leg_basis(model.tpoint, forder)

    single = partial(
        _emai_single,
        jnp.asarray(model.y.astype(dt)),
        leg_tp=jnp.asarray(model.leg_tp.astype(dt)),
        lam=jnp.asarray(model.eigvals.astype(dt)),
        var0=jnp.asarray(var0.astype(dt)),
        tit=jnp.asarray(tit.astype(dt)), is_add=jnp.asarray(vind[:-1, 0] == 0),
        jj=jnp.asarray(vind[:-1, 1]), kk=jnp.asarray(vind[:-1, 2]),
        gammas=jnp.asarray(gammas.astype(dt)), cov_dim=cov_dim, tril=tril,
        maxiter=maxiter, cc_par=cc_par, cc_gra=cc_gra,
    )
    leg_fix_d = jnp.asarray(model.leg_fix.astype(dt))
    xmat_d = jnp.asarray(model.xmat.astype(dt))
    ltm_d = jnp.asarray(leg_tpoint_mat.astype(dt))

    @jax.jit
    def batch_fn(snp_rot_block):
        def one(s_rot):
            x_snp = s_rot[:, None, None] * leg_fix_d[None]
            xmat = jnp.concatenate([xmat_d, x_snp], axis=2)
            ccp, ccg, eff, chi, eff_var = single(xmat=xmat)
            chi_t, chi_acc = _tpoint_stats(eff, eff_var, ltm_d)
            return ccp, ccg, eff, chi, chi_t, chi_acc

        return jax.vmap(one)(snp_rot_block.T)

    out = {k: [] for k in ("ccp", "ccg", "eff", "chi", "chi_t", "chi_acc")}
    s_total = snp_rot.shape[1]
    for start in range(0, s_total, snp_batch):
        block = snp_rot[:, start:start + snp_batch]
        pad = snp_batch - block.shape[1]
        if pad:
            block = np.pad(block, ((0, 0), (0, pad)), mode="edge")
        # full-float32 contractions (no TF32/bf16 operand rounding)
        with jax.default_matmul_precision("float32"):
            res = batch_fn(jnp.asarray(block))
        for k, v in zip(out, res):
            out[k].append(np.asarray(v)[: snp_batch - pad])
    ccp, ccg, eff, chi, chi_t, chi_acc = (
        np.concatenate(out[k]) for k in out
    )
    p_val = np.asarray(chi2_sf(jnp.asarray(chi), cov_dim))
    p_t = np.asarray(chi2_sf(jnp.asarray(chi_t), 1))
    p_min = p_t.min(axis=1)
    p_accum = np.asarray(chi2_sf(jnp.asarray(chi_acc), 1))

    res_df = bim.iloc[snp_lst][["chro", "snp_ID", "pos", "allele1", "allele2"]].copy()
    res_df.insert(0, "order", snp_lst)
    res_df["cc_par_val"] = ccp
    res_df["cc_gra_val"] = ccg
    for i in range(eff.shape[1]):
        res_df[f"eff{i}"] = eff[:, i]
    res_df["chi_val"] = chi
    res_df["p_val"] = p_val
    res_df["p_min"] = p_min
    res_df["p_accum"] = p_accum
    res_df.to_csv(prefix_outfile + ".res", sep=" ", index=False)
    return res_df


# ---------------------------------------------------------------------------
# linear-transformation test: all SNPs in a handful of einsums
# ---------------------------------------------------------------------------

def balance_longwas_trans(data_file, id_col, tpoint, trait, kin_file,
                          bed_prefix, var_com, snp_lst=None, tfix=None,
                          fix=None, forder=3, rorder=3, na_method="omit",
                          prefix_outfile="balance_longwas_trans",
                          snp_batch=1024, _snp_shuffle=None, precision="auto"):
    if tfix is not None or fix is not None:
        raise NotImplementedError("tfix/fix must be None (reference parity)")
    dt = _resolve_dtype(precision)
    model = prepare_balance(data_file, id_col, tpoint, trait, kin_file,
                            forder, rorder, na_method)
    cov_dim = model.leg_tp.shape[1]
    cov_add = _unpack_cov_df(var_com, 1)
    cov_per = _unpack_cov_df(var_com, 2)
    res_var = float(var_com["var_val"].to_numpy()[-1])
    snp_mat, bim, snp_lst, num_id_full = _load_snp(model, bed_prefix, snp_lst)
    # trans uses CENTERED (-2p) then eigen-rotated dosages (reference
    # balance_longwas_trans.py:181-184); the fixed test uses raw dosages
    freq = snp_mat.sum(axis=0) / (2.0 * num_id_full)
    snp_mat = (model.eigvecs.T @ (snp_mat - 2.0 * freq[None, :])).astype(dt)
    if _snp_shuffle is not None:
        # the reference permutes the EIGEN-ROTATED rows, not the raw dosage
        # rows (balance_longwas_trans_permutation.py:187,225) — unlike the
        # fixed twin, which shuffles before its per-SNP rotation
        snp_mat = snp_mat[_snp_shuffle, :]
    leg_tpoint_mat = leg_basis(model.tpoint, forder).astype(dt)

    @jax.jit
    def pieces():
        leg_tp = jnp.asarray(model.leg_tp.astype(dt))
        lam = jnp.asarray(model.eigvals.astype(dt))
        xmat = jnp.asarray(model.xmat.astype(dt))
        y = jnp.asarray(model.y.astype(dt))
        t = leg_tp.shape[0]
        vmat = (
            lam[:, None, None]
            * (leg_tp @ jnp.asarray(cov_add.astype(dt)) @ leg_tp.T)[None]
            + (leg_tp @ jnp.asarray(cov_per.astype(dt)) @ leg_tp.T)[None]
            + jnp.asarray(res_var, dtype=dt) * jnp.eye(t, dtype=dt)[None]
        )
        vinv = jnp.linalg.inv(vmat)
        vx = jnp.einsum("ntu,nup->ntp", vinv, xmat)
        xvx_inv = jnp.linalg.inv(jnp.einsum("ntp,ntq->pq", xmat, vx))
        xvy = jnp.einsum("ntp,ntu,nu->p", xmat, vinv, y)
        py = jnp.einsum("ntu,nu->nt", vinv, y - xmat @ (xvx_inv @ xvy))
        return vinv, vx, xvx_inv, py

    with jax.default_matmul_precision("float32"):
        vinv, vx, xvx_inv, py = pieces()
    temp_gt = jnp.asarray((cov_add @ model.leg_tp.T).astype(dt))  # (cd, T)

    @jax.jit
    def trans_batch(snp):
        # snp: (n, S) raw dosages
        eff = temp_gt @ jnp.einsum("nt,ns->ts", py, snp)  # (cd, S)
        w2 = jnp.einsum("ns,ntu->stu", snp * snp, vinv)
        cov1 = jnp.einsum("ct,stu,du->scd", temp_gt, w2, temp_gt)
        bx = jnp.einsum("ns,ntp->stp", snp, vx)
        b2 = jnp.einsum("ct,stp->scp", temp_gt, bx)
        cov2 = jnp.einsum("scp,pq,sdq->scd", b2, xvx_inv, b2)
        cov = cov1 - cov2
        effs = eff.T  # (S, cd)
        chi = jnp.einsum("sc,scd,sd->s", effs, jnp.linalg.inv(cov), effs)
        ltm = jnp.asarray(leg_tpoint_mat)  # already cast to dt
        et = jnp.einsum("tc,sc->st", ltm, effs)
        vt = jnp.einsum("tc,scd,td->st", ltm, cov, ltm)
        chi_t = et * et / vt
        accum = jnp.sum(ltm, axis=0)
        ea = effs @ accum
        va = jnp.einsum("c,scd,d->s", accum, cov, accum)
        return effs, chi, chi_t, ea * ea / va

    effs, chis, chi_ts, chi_accs = [], [], [], []
    for start in range(0, snp_mat.shape[1], snp_batch):
        with jax.default_matmul_precision("float32"):
            e, c, ct, ca = trans_batch(
                jnp.asarray(snp_mat[:, start:start + snp_batch]))
        effs.append(np.asarray(e))
        chis.append(np.asarray(c))
        chi_ts.append(np.asarray(ct))
        chi_accs.append(np.asarray(ca))
    eff = np.concatenate(effs)
    chi = np.concatenate(chis)
    p_val = np.asarray(chi2_sf(jnp.asarray(chi), cov_dim))
    p_t = np.asarray(chi2_sf(jnp.asarray(np.concatenate(chi_ts)), 1))
    p_min = p_t.min(axis=1)
    p_accum = np.asarray(chi2_sf(jnp.asarray(np.concatenate(chi_accs)), 1))

    res_df = bim.iloc[snp_lst][["chro", "snp_ID", "pos", "allele1", "allele2"]].copy()
    res_df.insert(0, "order", snp_lst)
    for i in range(eff.shape[1]):
        res_df[f"eff{i}"] = eff[:, i]
    res_df["chi_val"] = chi
    res_df["p_val"] = p_val
    res_df["p_min"] = p_min
    res_df["p_accum"] = p_accum
    res_df.to_csv(prefix_outfile + ".res", sep=" ", index=False)
    return res_df


def _permutation_driver(test_fn, permutation_lst, seed, prefix_outfile,
                        n_id, **kwargs):
    """Seeded permutation replicates (the reference's unseeded
    random.shuffle is a documented deviation).  The perm vector is shuffled
    cumulatively, matching the reference's in-place re-shuffling of the SNP
    matrix (balance_longwas_fixed_permutation.py:195-198); each replicate
    file is `<prefix>.<rep>` (reference :251)."""
    import os

    if permutation_lst is None:
        permutation_lst = range(1000)
    rng = np.random.default_rng(seed)
    perm = np.arange(n_id)
    results = []
    for rep in permutation_lst:
        rng.shuffle(perm)
        res = test_fn(_snp_shuffle=perm.copy(),
                      prefix_outfile=f"{prefix_outfile}.{rep}", **kwargs)
        # the inner test writes <prefix>.<rep>.res; the reference's
        # per-replicate contract is <prefix>.<rep> with no suffix
        os.replace(f"{prefix_outfile}.{rep}.res", f"{prefix_outfile}.{rep}")
        results.append(res)
    return results


def balance_longwas_fixed_permutation(data_file, id_col, tpoint, trait,
                                      kin_file, bed_prefix, var_com,
                                      permutation_lst=None, snp_lst=None,
                                      forder=3, rorder=3, na_method="omit",
                                      maxiter=10, cc_par=1.0e-6, cc_gra=1.0e6,
                                      em_weight_step=0.001, seed=0,
                                      prefix_outfile="balance_longwas_fixed_permutation"):
    """Permutation replicates of the fixed test (reference
    balance_longwas_fixed_permutation.py; seeded here)."""
    import pandas as pd

    data = pd.read_csv(data_file, sep=r"\s+", header=0)
    n_id = len(data.dropna())
    return _permutation_driver(
        partial(balance_longwas_fixed, data_file, id_col, tpoint, trait,
                kin_file, bed_prefix, var_com, snp_lst=snp_lst, forder=forder,
                rorder=rorder, na_method=na_method, maxiter=maxiter,
                cc_par=cc_par, cc_gra=cc_gra, em_weight_step=em_weight_step),
        permutation_lst, seed, prefix_outfile, n_id,
    )


def balance_longwas_trans_permutation(data_file, id_col, tpoint, trait,
                                      kin_file, bed_prefix, var_com,
                                      permutation_lst=None, snp_lst=None,
                                      forder=3, rorder=3, na_method="omit",
                                      seed=0,
                                      prefix_outfile="balance_longwas_trans_permutation"):
    import pandas as pd

    data = pd.read_csv(data_file, sep=r"\s+", header=0)
    n_id = len(data.dropna())
    return _permutation_driver(
        partial(balance_longwas_trans, data_file, id_col, tpoint, trait,
                kin_file, bed_prefix, var_com, snp_lst=snp_lst, forder=forder,
                rorder=rorder, na_method=na_method),
        permutation_lst, seed, prefix_outfile, n_id,
    )
