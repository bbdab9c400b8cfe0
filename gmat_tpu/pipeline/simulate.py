"""Phenotype simulators with known A/D/AA/AD/DD architecture.

Parity: reference `/root/reference/gmat/remma/simu/simu.py:8-143`:
- effect files: `snp_index effect` (A/D) or `snp0 snp1 effect` (epi);
- effects rescaled so each component hits its target variance ratio
  (default [2, 1, 0.5, 0.5, 0.5, 1] relative to the residual), empirical
  variance for `simu_epistasis`, theoretical 2p(1-p)-based for the A/D
  components of `simu_epistasis_freq`;
- outputs: `<eff_file>.norm` rescaled effects, `<out>.res` residuals,
  `<out>.pheno` fam-keyed phenotype file (3rd column all ones).
- NOTE (reference quirk preserved): the DD component's target ratio reuses
  ratio[3] — the AD slot — in both variants (simu.py:55,123).

Deviation: seeded RNG (the reference is unseeded).
"""
from __future__ import annotations

import logging

import numpy as np

from gmat_tpu.core.coding import additive_code, dominance_code
from gmat_tpu.scan.common import prepare_genotypes

logger = logging.getLogger(__name__)


def _load_effects(path, ncol):
    import pandas as pd

    df = pd.read_csv(path, header=None, sep=r"\s+")
    return df


def _simulate(bed_prefix, add_file, dom_file, epiAA_file, epiAD_file,
              epiDD_file, ratio, mean, res_var, out_file, freq_based, seed):
    import jax.numpy as jnp

    geno, _, fam = prepare_genotypes(bed_prefix)
    n = geno.shape[0]
    g = jnp.asarray(geno)
    mat_a = np.asarray(additive_code(g)[0])
    mat_d = np.asarray(dominance_code(g)[0])
    freq = geno.sum(axis=0) / (2 * n)
    ratio = np.asarray(
        [2.0, 1.0, 0.5, 0.5, 0.5, 1.0] if ratio is None else ratio, float
    )

    def norm_single(df, mat, target, theo_var=None):
        idx = df.iloc[:, 0].to_numpy(dtype=int)
        eff = df.iloc[:, 1].to_numpy(dtype=float)
        if theo_var is not None:
            comp_var = theo_var(idx, eff)
        else:
            comp_var = np.var(mat[:, idx] * eff[None, :], axis=0)
        df.iloc[:, 1] = eff / np.sqrt(np.sum(comp_var) / target)
        return df

    def norm_pair(df, m0, m1, target):
        i0 = df.iloc[:, 0].to_numpy(dtype=int)
        i1 = df.iloc[:, 1].to_numpy(dtype=int)
        eff = df.iloc[:, 2].to_numpy(dtype=float)
        comp_var = np.var(m0[:, i0] * m1[:, i1] * eff[None, :], axis=0)
        df.iloc[:, 2] = eff / np.sqrt(np.sum(comp_var) / target)
        return df

    add_df = _load_effects(add_file, 2)
    dom_df = _load_effects(dom_file, 2)
    if freq_based:
        add_df = norm_single(
            add_df, mat_a, ratio[0] / ratio[-1] * res_var,
            theo_var=lambda idx, e: 2 * freq[idx] * (1 - freq[idx]) * e * e,
        )
        dom_df = norm_single(
            dom_df, mat_d, ratio[1] / ratio[-1] * res_var,
            theo_var=lambda idx, e: (
                2 * freq[idx] * (1 - freq[idx])
                * (1 - 2 * freq[idx] * (1 - freq[idx])) * e * e
            ),
        )
    else:
        add_df = norm_single(add_df, mat_a, ratio[0] / ratio[-1] * res_var)
        dom_df = norm_single(dom_df, mat_d, ratio[1] / ratio[-1] * res_var)
    aa_df = norm_pair(_load_effects(epiAA_file, 3), mat_a, mat_a,
                      ratio[2] / ratio[-1] * res_var)
    ad_df = norm_pair(_load_effects(epiAD_file, 3), mat_a, mat_d,
                      ratio[3] / ratio[-1] * res_var)
    # reference quirk: DD reuses ratio[3] (simu.py:55,123)
    dd_df = norm_pair(_load_effects(epiDD_file, 3), mat_d, mat_d,
                      ratio[3] / ratio[-1] * res_var)
    for df, path in ((add_df, add_file), (dom_df, dom_file),
                     (aa_df, epiAA_file), (ad_df, epiAD_file),
                     (dd_df, epiDD_file)):
        df.to_csv(path + ".norm", sep=" ", header=False, index=False)

    rng = np.random.default_rng(seed)
    res_vec = rng.normal(0, np.sqrt(res_var), n)
    np.savetxt(out_file + ".res", res_vec)

    def comp_single(df, mat):
        return np.sum(
            mat[:, df.iloc[:, 0].to_numpy(int)]
            * df.iloc[:, 1].to_numpy(float)[None, :], axis=1
        )

    def comp_pair(df, m0, m1):
        return np.sum(
            m0[:, df.iloc[:, 0].to_numpy(int)]
            * m1[:, df.iloc[:, 1].to_numpy(int)]
            * df.iloc[:, 2].to_numpy(float)[None, :], axis=1
        )

    pheno = (
        mean
        + comp_single(add_df, mat_a)
        + comp_single(dom_df, mat_d)
        + comp_pair(aa_df, mat_a, mat_a)
        + comp_pair(ad_df, mat_a, mat_d)
        + comp_pair(dd_df, mat_d, mat_d)
        + res_vec
    )
    res_df = fam.iloc[:, :4].copy()
    res_df.iloc[:, 2] = 1
    res_df.iloc[:, 3] = pheno
    res_df.to_csv(out_file + ".pheno", sep=" ", header=False, index=False)
    return res_df


def simu_epistasis(bed_prefix, add_file, dom_file, epiAA_file, epiAD_file,
                   epiDD_file, ratio=None, mean=1.0, res_var=1.0,
                   out_file="simu_epistasis", seed=0):
    """Empirical-variance rescaling variant (reference simu.py:78-143)."""
    return _simulate(bed_prefix, add_file, dom_file, epiAA_file, epiAD_file,
                     epiDD_file, ratio, mean, res_var, out_file, False, seed)


def simu_epistasis_freq(bed_prefix, add_file, dom_file, epiAA_file,
                        epiAD_file, epiDD_file, ratio=None, mean=1.0,
                        res_var=1.0, out_file="simu_epistasis_freq", seed=0):
    """Theoretical 2p(1-p)-variance variant for A/D (reference simu.py:8-75)."""
    return _simulate(bed_prefix, add_file, dom_file, epiAA_file, epiAD_file,
                     epiDD_file, ratio, mean, res_var, out_file, True, seed)
