"""Golden fixtures for the longwas subsystem, from the reference implementation.

Balance branch runs on the full mouse_long fixture; the unbalance branch (whose
MME is O((2*4*n_id)^3) per iteration) runs on a 150-individual subset.

    JAX_PLATFORMS=cpu python tools/gen_golden_longwas.py
"""
from __future__ import annotations

import logging
import sys
import tempfile
from pathlib import Path

import numpy as np
import pandas as pd

sys.path.insert(0, str(Path(__file__).parent))
sys.path.insert(0, str(Path(__file__).parents[1]))

from reference_oracle import load_reference  # noqa: E402

ROOT = Path(__file__).parents[1]
ML = ROOT / "tests" / "data" / "mouse_long"
GOLDEN = ROOT / "tests" / "golden"

logging.basicConfig(level=logging.WARNING)

N_SUB = 150  # unbalance subset size
GWAS_SNPS = list(range(30))


def make_kin_file(tmp: Path) -> str:
    from gmat_tpu.grm.grm import agmat
    import shutil

    prefix = str(tmp / "plink")
    for ext in (".bed", ".bim", ".fam"):
        shutil.copy(str(ML / ("plink" + ext)), prefix + ext)
    agmat(prefix, inv=True, out_fmt="id_id_val")
    return prefix


def subset_unbalance(tmp: Path, ids: list[str]) -> str:
    df = pd.read_csv(ML / "phe.unbalance.txt", sep=r"\s+", header=0,
                     dtype={"ID": str})
    df = df[df["ID"].isin(ids)]
    out = tmp / "phe.unbalance.sub.txt"
    df.to_csv(out, sep=" ", index=False)
    return str(out)


def main():
    GOLDEN.mkdir(exist_ok=True)
    ref = load_reference()
    tmp = Path(tempfile.mkdtemp())
    prefix = make_kin_file(tmp)
    kin_file = prefix + ".agrm2"
    kin_inv_file = prefix + ".agiv2"

    tpoint = np.array(range(16)) + 1.0
    trait = list(range(2, 18))

    # --- balance varcom (reduced maxiter keeps the oracle quick but exercises
    # several EM+AI rounds deterministically)
    res_var = ref.balance_varcom.balance_varcom(
        str(ML / "phe.balance.txt"), "ID", tpoint, trait, kin_file,
        maxiter=5, prefix_outfile=str(tmp / "balance_varcom"),
    )
    np.savez_compressed(
        GOLDEN / "longwas_balance_var.npz",
        var_val=res_var["var_val"].to_numpy(),
        vari=res_var["vari"].to_numpy(),
        varij=res_var["varij"].to_numpy(),
        varik=res_var["varik"].to_numpy(),
    )
    print("balance var:", res_var["var_val"].to_numpy()[:5], "...")

    # --- balance GWAS fixed + trans on 30 SNPs
    fixed_df = ref.balance_longwas_fixed.balance_longwas_fixed(
        str(ML / "phe.balance.txt"), "ID", tpoint, trait, kin_file,
        str(ML / "plink"), res_var, snp_lst=GWAS_SNPS,
        prefix_outfile=str(tmp / "bfix"),
    )
    trans_df = ref.balance_longwas_trans.balance_longwas_trans(
        str(ML / "phe.balance.txt"), "ID", tpoint, trait, kin_file,
        str(ML / "plink"), res_var, snp_lst=GWAS_SNPS,
        prefix_outfile=str(tmp / "btrans"),
    )
    np.savez_compressed(
        GOLDEN / "longwas_balance_gwas.npz",
        fixed=fixed_df.select_dtypes("number").to_numpy(dtype=float),
        fixed_cols=np.array(fixed_df.select_dtypes("number").columns, dtype=str),
        trans=trans_df.select_dtypes("number").to_numpy(dtype=float),
        trans_cols=np.array(trans_df.select_dtypes("number").columns, dtype=str),
    )
    print("balance gwas fixed p:", fixed_df["p_val"].to_numpy()[:3])

    # --- unbalance branch on a subset
    fam = pd.read_csv(ML / "plink.fam", sep=r"\s+", header=None, dtype=str)
    sub_ids = list(fam[1][:N_SUB])
    data_sub = subset_unbalance(tmp, sub_ids)
    res_uvar = ref.unbalance_varcom.unbalance_varcom(
        data_sub, "ID", "weak", "trait", kin_inv_file,
        maxiter=5, prefix_outfile=str(tmp / "unb_varcom"),
    )
    np.savez_compressed(
        GOLDEN / "longwas_unbalance_var.npz",
        var_val=res_uvar["var_val"].to_numpy(),
        vari=res_uvar["vari"].to_numpy(),
        varij=res_uvar["varij"].to_numpy(),
        varik=res_uvar["varik"].to_numpy(),
    )
    print("unbalance var:", res_uvar["var_val"].to_numpy()[:5], "...")

    ufixed = ref.unbalance_longwas_fixed.unbalance_longwas_fixed(
        data_sub, "ID", "weak", "trait", str(ML / "plink"), kin_file,
        res_uvar, snp_lst=GWAS_SNPS, prefix_outfile=str(tmp / "ufix"),
    )
    utrans = ref.unbalance_longwas_trans.unbalance_longwas_trans(
        data_sub, "ID", "weak", "trait", str(ML / "plink"), kin_file,
        res_uvar, snp_lst=GWAS_SNPS, prefix_outfile=str(tmp / "utrans"),
    )
    np.savez_compressed(
        GOLDEN / "longwas_unbalance_gwas.npz",
        fixed=ufixed.select_dtypes("number").to_numpy(dtype=float),
        fixed_cols=np.array(ufixed.select_dtypes("number").columns, dtype=str),
        trans=utrans.select_dtypes("number").to_numpy(dtype=float),
        trans_cols=np.array(utrans.select_dtypes("number").columns, dtype=str),
    )
    print("unbalance gwas fixed p:", ufixed["p_val"].to_numpy()[:3])
    print("golden longwas fixtures written")


if __name__ == "__main__":
    main()
