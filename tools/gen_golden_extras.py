"""Golden fixtures for the uvlmm extras (eigen REML, MME variants,
fixed-effect GWAS, lm) from the reference implementation.

    JAX_PLATFORMS=cpu python tools/gen_golden_extras.py
"""
from __future__ import annotations

import contextlib
import io
import logging
import sys
import tempfile
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).parent))
sys.path.insert(0, str(Path(__file__).parents[1]))

from reference_oracle import load_reference  # noqa: E402

ROOT = Path(__file__).parents[1]
DATA = ROOT / "tests" / "data"
GOLDEN = ROOT / "tests" / "golden"
BED = str(DATA / "plink")
PHENO = str(DATA / "pheno")

logging.basicConfig(level=logging.WARNING)


def np_agrm(geno, small_val=0.001):
    n = geno.shape[0]
    freq = geno.sum(axis=0) / (2 * n)
    scale = np.sum(2 * freq * (1 - freq))
    cen = geno - 2 * freq[None, :]
    kin = cen @ cen.T / scale
    np.fill_diagonal(kin, np.diag(kin) * (1 + small_val))
    return kin


def main():
    ref = load_reference()
    from gmat_tpu.io.bed import read_plink

    geno = read_plink(BED)
    ag = np_agrm(geno)
    y, xmat, zmat = ref.design_matrix.design_matrix_wemai_multi_gmat(PHENO, BED)
    yv = np.asarray(y)
    xv = np.asarray(xmat)
    var_2g = np.load(GOLDEN / "reml_var.npz")["a_axa"]

    silence = contextlib.redirect_stdout(io.StringIO())

    # eigen REML (prints in the reference; silence it)
    with silence:
        var_eig, _, _ = ref.uvlmm_varcom_eigen.uvlmm_varcom_eigen(
            yv, xv, ag, maxiter=20
        )

    # MME family on G^-1
    ag_inv = np.linalg.inv(ag)
    y1 = yv.ravel()
    mme = {}
    for name in ("em_mme", "pxem_mme", "ai_mme", "emai_mme", "pxemai_mme"):
        with silence:
            mme[name] = np.asarray(
                getattr(ref.uvlmm_varcom, name)(y1, xv, ag_inv, maxiter=5)
            )
        print(name, mme[name])

    # varcom/em.py multi variants (zmat identity here: one record per id)
    from scipy.sparse import identity

    z_id = identity(len(y1), format="csr")
    with silence:
        em_multi = ref.varcom_em.em_mme(
            yv, xv, [z_id], [ag_inv], maxiter=5
        )
        em_vmat = ref.varcom_em.em_vmat(
            yv, xv, [z_id, z_id], [ag, ag * ag], maxiter=5
        )

    # fixed-effect GWAS (uvlmm_gwas); gmat_lst enters V directly
    with silence:
        add_df = ref.uvlmm_gwas.uvlmm_gwas_add(yv, xv, [ag, ag * ag], var_2g, BED)
        dom_df = ref.uvlmm_gwas.uvlmm_gwas_dom(yv, xv, [ag, ag * ag], var_2g, BED)
    # interaction scan restricted: monkey-source loop over 4 anchors is not
    # parameterizable in the reference; slice the genotype file instead
    from gmat_tpu.io.bed import Bed, write_bed

    bed = Bed(BED)
    full = bed.read()
    # pick 40 pairwise-non-collinear SNPs (the reference's fixed-effect
    # interaction model is singular for duplicated columns)
    corr = np.corrcoef(full.T)
    picked = []
    for j in range(full.shape[1]):
        if all(abs(corr[j, k]) < 0.95 for k in picked):
            picked.append(j)
        if len(picked) == 40:
            break
    picked = np.asarray(picked)
    with tempfile.TemporaryDirectory() as td:
        sub_prefix = td + "/sub"
        write_bed(sub_prefix, full[:, picked], bim=bed.bim.iloc[picked],
                  fam=bed.fam)
        with silence:
            epi_df = ref.uvlmm_gwas.uvlmm_gwas_epiAA(
                yv, xv, [ag, ag * ag], var_2g, sub_prefix
            )
        lm_df = None
        # lm_snp_eff writes a file; run on the 60-SNP subset for speed
        with silence:
            ref.lm.lm_snp_eff(PHENO, sub_prefix, out_file=td + "/lm_eff")
        lm_eff = np.loadtxt(td + "/lm_eff", usecols=6)

    np.savez_compressed(
        GOLDEN / "uvlmm_extras.npz",
        var_eigen=var_eig,
        **{f"mme_{k}": v for k, v in mme.items()},
        em_multi=em_multi,
        em_vmat=em_vmat,
        add_eff=add_df["eff_val"].to_numpy(float),
        add_chi=add_df["chi_val"].to_numpy(float),
        add_scale=add_df["scale_val"].to_numpy(float),
        add_p=add_df["p_val"].to_numpy(float),
        dom_eff=dom_df["eff_val"].to_numpy(float),
        dom_p=dom_df["p_val"].to_numpy(float),
        epi=np.column_stack(
            [epi_df["snpi"], epi_df["snpj"], epi_df["snp_eff"], epi_df["p_val"]]
        ),
        lm_eff=lm_eff,
        var_2g=var_2g,
        picked=picked,
    )
    print("eigen:", var_eig, "\nextras golden written")


if __name__ == "__main__":
    main()
