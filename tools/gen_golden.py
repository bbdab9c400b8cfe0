"""Generate golden fixtures from the reference implementation.

Runs the reference's pure-numpy algorithms (loaded via tools/reference_oracle)
on the bundled mouse fixture and stores compact arrays under tests/golden/.
Run once (CPU, float64):

    JAX_PLATFORMS=cpu python tools/gen_golden.py
"""
from __future__ import annotations

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


def np_dgrm(geno, small_val=0.001):
    n = geno.shape[0]
    freq = geno.sum(axis=0) / (2 * n)
    sv = 2 * freq * (1 - freq)
    scale = np.sum(sv * (1 - sv))
    g = geno.copy()
    g[g > 1.5] = 0.0
    cen = g - sv[None, :]
    kin = cen @ cen.T / scale
    np.fill_diagonal(kin, np.diag(kin) * (1 + small_val))
    return kin


def main():
    GOLDEN.mkdir(exist_ok=True)
    ref = load_reference()
    from gmat_tpu.io.bed import read_plink

    geno = read_plink(BED)
    ag = np_agrm(geno)
    dg = np_dgrm(geno)

    y, xmat, zmat = ref.design_matrix.design_matrix_wemai_multi_gmat(PHENO, BED)
    np.savez_compressed(GOLDEN / "design.npz", y=y, xmat=xmat,
                        z_dense=np.asarray(zmat.todense()))

    configs = {
        "a_axa": [ag, ag * ag],
        "a_d_axa": [ag, dg, ag * ag],
        "a_d_axa_axd_dxd": [ag, dg, ag * ag, ag * dg, dg * dg],
    }
    var_out = {}
    for name, lst in configs.items():
        var_out[name] = ref.uvlmm_varcom._wemai_multi_gmat(y, xmat, zmat, lst)
        print(name, var_out[name])
    np.savez_compressed(GOLDEN / "reml_var.npz", **var_out)

    # single-SNP score tests (remma_add / remma_dom), config a_axa
    var_com = var_out["a_axa"]
    with tempfile.TemporaryDirectory() as td:
        add_df = ref.remma_add._remma_add(
            y, xmat, zmat, [ag, ag * ag], var_com, BED, out_file=td + "/add"
        )
        dom_df = ref.remma_dom._remma_dom(
            y, xmat, zmat, [ag, dg, ag * ag], var_out["a_d_axa"], BED,
            out_file=td + "/dom",
        )
    np.savez_compressed(
        GOLDEN / "remma_single.npz",
        add_eff=np.asarray(add_df["eff_val"], dtype=float),
        add_chi=np.asarray(add_df["chi_val"], dtype=float),
        add_p=np.asarray(add_df["p_val"], dtype=float),
        add_eff_fixed=np.asarray(add_df["eff_val_to_fixed"], dtype=float),
        dom_eff=np.asarray(dom_df["eff_val"], dtype=float),
        dom_p=np.asarray(dom_df["p_val"], dtype=float),
        var_a_axa=var_com,
        var_a_d_axa=var_out["a_d_axa"],
    )

    # exact epiAA/AD/DD scans restricted to 40 anchors (full partner range)
    anchors = list(range(0, 40))
    with tempfile.TemporaryDirectory() as td:
        ref.remma_epiAA._remma_epiAA(
            y, xmat, zmat, [ag, ag * ag], var_com, BED,
            snp_lst_0=anchors, p_cut=1.1, out_file=td + "/aa",
        )
        aa = np.loadtxt(td + "/aa", skiprows=1)
        ref.remma_epiAD._remma_epiAD(
            y, xmat, zmat, [ag, ag * ag], var_com, BED,
            snp_lst_0=anchors, p_cut=1.1, out_file=td + "/ad",
        )
        ad = np.loadtxt(td + "/ad", skiprows=1)
        ref.remma_epiDD._remma_epiDD(
            y, xmat, zmat, [ag, ag * ag], var_com, BED,
            snp_lst_0=anchors, p_cut=1.1, out_file=td + "/dd",
        )
        dd = np.loadtxt(td + "/dd", skiprows=1)
    np.savez_compressed(
        GOLDEN / "epi_scans.npz", aa=aa, ad=ad, dd=dd,
        anchors=np.asarray(anchors), var_com=var_com,
    )

    # pair-list exact test incl. the var column (remma_epiAA_pair)
    rng = np.random.default_rng(123)
    m = geno.shape[1]
    pairs = rng.integers(0, m, size=(2000, 2))
    pairs = pairs[pairs[:, 0] < pairs[:, 1]]
    with tempfile.TemporaryDirectory() as td:
        np.savetxt(td + "/pairs", pairs, fmt="%d", header="snp_0 snp_1", comments="")
        ref.remma_epiAA_pair._remma_epiAA_pair(
            y, xmat, zmat, [ag, ag * ag], var_com, BED, td + "/pairs",
            p_cut=1.1, out_file=td + "/res",
        )
        res = np.loadtxt(td + "/res", skiprows=1)
    np.savez_compressed(GOLDEN / "epiAA_pairs.npz", pairs=pairs, res=res,
                        var_com=var_com)
    print("golden fixtures written to", GOLDEN)


if __name__ == "__main__":
    main()
