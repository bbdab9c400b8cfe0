"""Unbalanced longitudinal GWAS: fixed-regression and retransformation tests.

Parity targets:
- `unbalance_longwas_fixed` (/root/reference/gmat/longwas/unbalance/
  unbalance_longwas_fixed.py:17-333): observation-space
  V = Z_a (K_a ⊗ G) Z_aᵀ + Z_p (K_p ⊗ I) Z_pᵀ + sigma2 I built ONCE; per SNP a
  GLS with appended SNP x Legendre fixed columns (raw dosages), Wald
  chi-square with df = forder+1, per-timepoint p, p_min, p_accum.
- `unbalance_longwas_trans` (unbalance_longwas_trans.py:17-333): P-projection
  and qpymat = Z_aᵀ P y once; per SNP the kron(K_a, sᵀ) retransformation.
- permutation twins: shuffle individual rows of the SNP matrix per replicate.

Design: V assembly is three einsums (no kron materialization); the
per-SNP loops are vmapped batches; Z products are segment_sums.
"""
from __future__ import annotations

import logging
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.ops import segment_sum

from gmat_tpu.core.stats import chi2_sf
from gmat_tpu.longwas.legendre import leg_basis
from gmat_tpu.longwas.unbalance import UnbalanceModel, prepare_unbalance

logger = logging.getLogger(__name__)


def _unpack_cov_df(var_com_df, block):
    sub = var_com_df[var_com_df["vari"] == block]
    dim = int(sub["varij"].max())
    m = np.zeros((dim, dim))
    m[np.asarray(sub["varij"]) - 1, np.asarray(sub["varik"]) - 1] = sub["var_val"]
    return m + np.tril(m, -1).T


def _load_snp_by_code_order(model: UnbalanceModel, bed_prefix, snp_lst):
    from gmat_tpu.scan.common import prepare_genotypes

    geno, bim, fam = prepare_genotypes(bed_prefix)
    id_geno = list(fam["iid"].astype(str))
    raw_ids = model.data.raw_ids_in_code_order()[: model.q_p]
    missing = set(raw_ids) - set(id_geno)
    if missing:
        raise ValueError(f"ids not in the snp file: {sorted(missing)[:5]}")
    rows = [id_geno.index(i) for i in raw_ids]
    if snp_lst is None:
        snp_lst = list(range(geno.shape[1]))
    snp_lst = list(snp_lst)
    return geno[np.ix_(rows, snp_lst)], bim, snp_lst


def _variance_pieces(model: UnbalanceModel, cov_add, cov_per, res_var):
    """V and V^-1 in observation space (unbalance_longwas_fixed.py:250-256)."""
    la = jnp.asarray(model.leg_a)
    lp = jnp.asarray(model.leg_p)
    rid = jnp.asarray(model.rec_ids)
    gg = jnp.asarray(model.kin)[rid][:, rid]
    same = (rid[:, None] == rid[None, :]).astype(la.dtype)
    vmat = (
        (la @ jnp.asarray(cov_add) @ la.T) * gg
        + (lp @ jnp.asarray(cov_per) @ lp.T) * same
        + res_var * jnp.eye(la.shape[0], dtype=la.dtype)
    )
    return jnp.linalg.inv(vmat)


def _tpoint_mats(model: UnbalanceModel, forder):
    tvec = np.array(sorted(set(model.data.df[model.tpoint_col])))
    ltm = leg_basis(tvec, forder, tmin=model.tmin, tmax=model.tmax)
    return ltm


def _snp_stats(eff, eff_var, ltm):
    et = jnp.einsum("tc,sc->st", ltm, eff)
    vt = jnp.einsum("tc,scd,td->st", ltm, eff_var, ltm)
    chi_t = et * et / vt
    accum = jnp.sum(ltm, axis=0)
    ea = eff @ accum
    va = jnp.einsum("c,scd,d->s", accum, eff_var, accum)
    return chi_t, ea * ea / va


def _result_frame(bim, snp_lst, eff, chi, p_val, p_min, p_accum, extra=None):
    res_df = bim.iloc[snp_lst][["chro", "snp_ID", "pos", "allele1",
                                "allele2"]].copy()
    res_df.insert(0, "order", snp_lst)
    if extra:
        for k, v in extra.items():
            res_df[k] = v
    for i in range(eff.shape[1]):
        res_df[f"eff{i}"] = eff[:, i]
    res_df["chi_val"] = chi
    res_df["p_val"] = p_val
    res_df["p_min"] = p_min
    res_df["p_accum"] = p_accum
    return res_df


def unbalance_longwas_fixed(data_file, id_col, tpoint, trait, bed_prefix,
                            kin_file, var_com, snp_lst=None, tfix=None,
                            fix=None, forder=3, aorder=3, porder=3,
                            na_method="omit",
                            prefix_outfile="unbalance_longwas_fixed",
                            snp_batch=256, _snp_shuffle=None):
    model = prepare_unbalance(data_file, id_col, tpoint, trait, kin_file,
                              tfix, fix, forder, aorder, porder, na_method,
                              kin_is_inverse=False)
    cov_add = _unpack_cov_df(var_com, 1)
    cov_per = _unpack_cov_df(var_com, 2)
    res_var = float(np.asarray(var_com["var_val"])[-1])
    vinv = _variance_pieces(model, cov_add, cov_per, res_var)
    snp_mat, bim, snp_lst = _load_snp_by_code_order(model, bed_prefix, snp_lst)
    if _snp_shuffle is not None:
        snp_mat = snp_mat[_snp_shuffle, :]
    chi_df = forder + 1
    ltm = jnp.asarray(_tpoint_mats(model, forder))
    x = jnp.asarray(model.xmat)
    y = jnp.asarray(model.y)
    leg_f = jnp.asarray(model.leg_f)
    rid = jnp.asarray(model.rec_ids)

    @jax.jit
    def batch_fn(snp_block):  # (q, S) raw dosages by individual code
        def one(s):
            block = leg_f * s[rid][:, None]
            xs = jnp.concatenate([x, block], axis=1)
            xv = xs.T @ vinv
            xvx_inv = jnp.linalg.inv(xv @ xs)
            b = xvx_inv @ (xv @ y)
            eff = b[-chi_df:]
            eff_var = xvx_inv[-chi_df:, -chi_df:]
            chi = eff @ jnp.linalg.inv(eff_var) @ eff
            return eff, eff_var, chi

        eff, eff_var, chi = jax.vmap(one, in_axes=1)(snp_block)
        chi_t, chi_acc = _snp_stats(eff, eff_var, ltm)
        return eff, chi, chi_t, chi_acc

    effs, chis, chi_ts, chi_accs = [], [], [], []
    for start in range(0, snp_mat.shape[1], snp_batch):
        e, c, ct, ca = batch_fn(jnp.asarray(snp_mat[:, start:start + snp_batch]))
        effs.append(np.asarray(e))
        chis.append(np.asarray(c))
        chi_ts.append(np.asarray(ct))
        chi_accs.append(np.asarray(ca))
    eff = np.concatenate(effs)
    chi = np.concatenate(chis)
    p_val = np.asarray(chi2_sf(jnp.asarray(chi), chi_df))
    p_min = np.asarray(chi2_sf(jnp.asarray(np.concatenate(chi_ts)), 1)).min(1)
    p_accum = np.asarray(chi2_sf(jnp.asarray(np.concatenate(chi_accs)), 1))
    res_df = _result_frame(bim, snp_lst, eff, chi, p_val, p_min, p_accum)
    res_df.to_csv(prefix_outfile + ".res", sep=" ", index=False)
    return res_df


def unbalance_longwas_trans(data_file, id_col, tpoint, trait, bed_prefix,
                            kin_file, var_com, snp_lst=None, tfix=None,
                            fix=None, forder=3, aorder=3, porder=3,
                            na_method="omit",
                            prefix_outfile="unbalance_longwas_trans",
                            snp_batch=1024, _snp_shuffle=None):
    model = prepare_unbalance(data_file, id_col, tpoint, trait, kin_file,
                              tfix, fix, forder, aorder, porder, na_method,
                              kin_is_inverse=False)
    cov_add = _unpack_cov_df(var_com, 1)
    cov_per = _unpack_cov_df(var_com, 2)
    res_var = float(np.asarray(var_com["var_val"])[-1])
    cd_a = model.leg_a.shape[1]
    q = model.kin.shape[0]
    vinv = _variance_pieces(model, cov_add, cov_per, res_var)
    x = jnp.asarray(model.xmat)
    y = jnp.asarray(model.y)
    la = jnp.asarray(model.leg_a)
    rid = jnp.asarray(model.rec_ids)

    @jax.jit
    def pieces():
        vx = vinv @ x
        xvx_inv = jnp.linalg.inv(x.T @ vx)
        pmat = vinv - vx @ xvx_inv @ vx.T
        py = pmat @ y
        qpy = jnp.stack(
            [segment_sum(py * la[:, j], rid, num_segments=q)
             for j in range(cd_a)]
        )  # (cd_a, q)
        # qpq[j,a,k,b] = Z_a^j_col_a^T P Z_a^k_col_b
        pz = jnp.stack(
            [
                jax.vmap(
                    lambda col: segment_sum(col * la[:, k], rid, num_segments=q),
                    in_axes=0,
                )(pmat)
                for k in range(cd_a)
            ]
        )  # (cd_a, n_rec, q)
        qpq = jnp.stack(
            [
                jnp.stack(
                    [
                        segment_sum(pz[k] * la[:, j][:, None], rid,
                                    num_segments=q)
                        for k in range(cd_a)
                    ]
                )
                for j in range(cd_a)
            ]
        )  # (cd_a, cd_a, q, q) -> qpq[j,k,a,b]
        return qpy, qpq

    qpy, qpq = pieces()
    ka = jnp.asarray(cov_add)
    snp_mat, bim, snp_lst = _load_snp_by_code_order(model, bed_prefix, snp_lst)
    if _snp_shuffle is not None:
        snp_mat = snp_mat[_snp_shuffle, :]
    ltm = jnp.asarray(_tpoint_mats(model, forder))

    @jax.jit
    def trans_batch(snp):  # (q, S)
        eff = ka @ (qpy @ snp)  # (cd_a, S)
        w = jnp.einsum("as,jkab,bs->sjk", snp, qpq, snp)
        cov = jnp.einsum("cj,sjk,dk->scd", ka, w, ka)
        effs = eff.T
        chi = jnp.einsum("sc,scd,sd->s", effs, jnp.linalg.inv(cov), effs)
        chi_t, chi_acc = _snp_stats(effs, cov, ltm)
        return effs, chi, chi_t, chi_acc

    effs, chis, chi_ts, chi_accs = [], [], [], []
    for start in range(0, snp_mat.shape[1], snp_batch):
        e, c, ct, ca = trans_batch(jnp.asarray(snp_mat[:, start:start + snp_batch]))
        effs.append(np.asarray(e))
        chis.append(np.asarray(c))
        chi_ts.append(np.asarray(ct))
        chi_accs.append(np.asarray(ca))
    eff = np.concatenate(effs)
    chi = np.concatenate(chis)
    p_val = np.asarray(chi2_sf(jnp.asarray(chi), cd_a))
    p_min = np.asarray(chi2_sf(jnp.asarray(np.concatenate(chi_ts)), 1)).min(1)
    p_accum = np.asarray(chi2_sf(jnp.asarray(np.concatenate(chi_accs)), 1))
    res_df = _result_frame(bim, snp_lst, eff, chi, p_val, p_min, p_accum)
    res_df.to_csv(prefix_outfile + ".res", sep=" ", index=False)
    return res_df


def _perm_driver(fn, permutation_lst, seed, prefix_outfile, n_id, kwargs):
    """Seeded permutation replicates; cumulative shuffle and `<prefix>.<rep>`
    per-replicate files as in the reference
    (unbalance_longwas_fixed_permutation.py:295-297,340)."""
    import os

    if permutation_lst is None:
        permutation_lst = range(1000)
    rng = np.random.default_rng(seed)
    perm = np.arange(n_id)
    out = []
    for rep in permutation_lst:
        rng.shuffle(perm)
        out.append(fn(_snp_shuffle=perm.copy(),
                      prefix_outfile=f"{prefix_outfile}.{rep}", **kwargs))
        os.replace(f"{prefix_outfile}.{rep}.res", f"{prefix_outfile}.{rep}")
    return out


def unbalance_longwas_fixed_permutation(data_file, id_col, tpoint, trait,
                                        bed_prefix, kin_file, var_com,
                                        permutation_lst=None, snp_lst=None,
                                        forder=3, aorder=3, porder=3,
                                        na_method="omit", seed=0,
                                        prefix_outfile="unbalance_longwas_fixed_permutation"):
    model = prepare_unbalance(data_file, id_col, tpoint, trait, kin_file,
                              None, None, forder, aorder, porder, na_method,
                              kin_is_inverse=False)
    return _perm_driver(
        partial(unbalance_longwas_fixed, data_file, id_col, tpoint, trait,
                bed_prefix, kin_file, var_com, snp_lst=snp_lst, forder=forder,
                aorder=aorder, porder=porder, na_method=na_method),
        permutation_lst, seed, prefix_outfile, model.q_p, {},
    )


def unbalance_longwas_trans_permutation(data_file, id_col, tpoint, trait,
                                        bed_prefix, kin_file, var_com,
                                        permutation_lst=None, snp_lst=None,
                                        forder=3, aorder=3, porder=3,
                                        na_method="omit", seed=0,
                                        prefix_outfile="unbalance_longwas_trans_permutation"):
    model = prepare_unbalance(data_file, id_col, tpoint, trait, kin_file,
                              None, None, forder, aorder, porder, na_method,
                              kin_is_inverse=False)
    return _perm_driver(
        partial(unbalance_longwas_trans, data_file, id_col, tpoint, trait,
                bed_prefix, kin_file, var_com, snp_lst=snp_lst, forder=forder,
                aorder=aorder, porder=porder, na_method=na_method),
        permutation_lst, seed, prefix_outfile, model.q_p, {},
    )
