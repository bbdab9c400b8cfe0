"""Golden fixtures for the longwas PERMUTATION twins, from the reference.

The reference permutation modules draw their shuffles from the (unseeded)
stdlib `random.shuffle` (balance_longwas_fixed_permutation.py:197).  To get a
golden with a KNOWN permuted matrix, `random.shuffle` is monkeypatched to
write an absolute permutation into the id list, and each replicate runs in
its own oracle call so the reference's cumulative in-place shuffle reduces
to `snp_mat[perm]` — exactly the semantics of our seeded driver
(gmat_tpu/longwas/balance_gwas.py:_permutation_driver).

The injected perms are the ones our drivers generate from
np.random.default_rng(SEED) (cumulative shuffles of arange(n_id)), so the
test can run the PUBLIC `*_permutation` entry points and compare files.

Note: the reference unbalance twins read `num_id` from the FULL bed
(unbalance_longwas_trans_permutation.py:267) but index the data-subset
matrix with it — an index-error for any subset cohort.  The injection sets
the id list to a subset-sized perm, which is the only semantics that runs;
our implementation uses the subset size by construction.

    JAX_PLATFORMS=cpu python tools/gen_golden_permutation.py
"""
from __future__ import annotations

import logging
import random
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

SEED = 42
N_SUB = 150
GWAS_SNPS = list(range(30))


def var_df(npz_name: str) -> pd.DataFrame:
    d = np.load(GOLDEN / npz_name)
    return pd.DataFrame({
        "vari": d["vari"], "varij": d["varij"], "varik": d["varik"],
        "var_val": d["var_val"],
    })


def perms_for(n_id: int, reps: int) -> list[np.ndarray]:
    """The cumulative shuffles our _permutation_driver(seed=SEED) applies."""
    rng = np.random.default_rng(SEED)
    perm = np.arange(n_id)
    out = []
    for _ in range(reps):
        rng.shuffle(perm)
        out.append(perm.copy())
    return out


def run_with_injected_perm(fn, perm, rep, prefix, args, kwargs):
    """One oracle replicate with `random.shuffle` forced to `perm`."""
    real_shuffle = random.shuffle

    def fake(lst):
        lst[:] = [int(x) for x in perm]

    random.shuffle = fake
    try:
        fn(*args, permutation_lst=[rep], prefix_outfile=prefix, **kwargs)
    finally:
        random.shuffle = real_shuffle
    df = pd.read_csv(f"{prefix}.{rep}", sep=r"\s+", header=0)
    return df


def main():
    ref = load_reference()
    tmp = Path(tempfile.mkdtemp())

    # kinship files (same as gen_golden_longwas)
    import shutil

    from gmat_tpu.grm.grm import agmat

    prefix = str(tmp / "plink")
    for ext in (".bed", ".bim", ".fam"):
        shutil.copy(str(ML / ("plink" + ext)), prefix + ext)
    agmat(prefix, inv=True, out_fmt="id_id_val")
    kin_file = prefix + ".agrm2"

    tpoint = np.array(range(16)) + 1.0
    trait = list(range(2, 18))
    bal_var = var_df("longwas_balance_var.npz")

    data = pd.read_csv(ML / "phe.balance.txt", sep=r"\s+", header=0)
    n_bal = len(data.dropna())
    bal_perms = perms_for(n_bal, 2)

    out = {"seed": SEED, "n_balance": n_bal}
    for rep in (0, 1):
        df = run_with_injected_perm(
            ref.balance_longwas_fixed_permutation
            .balance_longwas_fixed_permutation,
            bal_perms[rep], rep, str(tmp / "bfixp"),
            (str(ML / "phe.balance.txt"), "ID", tpoint, trait, kin_file,
             str(ML / "plink"), bal_var),
            {"snp_lst": GWAS_SNPS},
        )
        num = df.select_dtypes("number")
        out[f"balance_fixed_{rep}"] = num.to_numpy(dtype=float)
        out[f"balance_fixed_cols_{rep}"] = np.array(num.columns, dtype=str)
        df = run_with_injected_perm(
            ref.balance_longwas_trans_permutation
            .balance_longwas_trans_permutation,
            bal_perms[rep], rep, str(tmp / "btrp"),
            (str(ML / "phe.balance.txt"), "ID", tpoint, trait, kin_file,
             str(ML / "plink"), bal_var),
            {"snp_lst": GWAS_SNPS},
        )
        num = df.select_dtypes("number")
        out[f"balance_trans_{rep}"] = num.to_numpy(dtype=float)
        out[f"balance_trans_cols_{rep}"] = np.array(num.columns, dtype=str)
        print(f"balance rep {rep}: fixed/trans done", flush=True)

    # unbalance branch on the 150-id subset; the reference perm modules
    # exit() when the kin file holds ids absent from the data
    # (unbalance_longwas_fixed_permutation.py:191), so subset the kin file
    # to the cohort like tests/test_longwas_unbalance.py does
    fam = pd.read_csv(ML / "plink.fam", sep=r"\s+", header=None, dtype=str)
    sub_ids = list(fam[1][:N_SUB])
    sub_set = set(sub_ids)
    kin_sub = str(tmp / "kin.sub")
    with open(kin_file) as fin, open(kin_sub, "w") as fout:
        for line in fin:
            a = line.split()
            if a[0] in sub_set and a[1] in sub_set:
                fout.write(line)
    udata = pd.read_csv(ML / "phe.unbalance.txt", sep=r"\s+", header=0,
                        dtype={"ID": str})
    udata = udata[udata["ID"].isin(sub_ids)]
    data_sub = tmp / "phe.unbalance.sub.txt"
    udata.to_csv(data_sub, sep=" ", index=False)
    n_unb = udata["ID"].nunique()
    unb_perms = perms_for(n_unb, 2)
    unb_var = var_df("longwas_unbalance_var.npz")
    out["n_unbalance"] = n_unb
    kin_file = kin_sub

    for rep in (0, 1):
        df = run_with_injected_perm(
            ref.unbalance_longwas_fixed_permutation
            .unbalance_longwas_fixed_permutation,
            unb_perms[rep], rep, str(tmp / "ufixp"),
            (str(data_sub), "ID", "weak", "trait", str(ML / "plink"),
             kin_file, unb_var),
            {"snp_lst": GWAS_SNPS},
        )
        num = df.select_dtypes("number")
        out[f"unbalance_fixed_{rep}"] = num.to_numpy(dtype=float)
        out[f"unbalance_fixed_cols_{rep}"] = np.array(num.columns, dtype=str)
        df = run_with_injected_perm(
            ref.unbalance_longwas_trans_permutation
            .unbalance_longwas_trans_permutation,
            unb_perms[rep], rep, str(tmp / "utrp"),
            (str(data_sub), "ID", "weak", "trait", str(ML / "plink"),
             kin_file, unb_var),
            {"snp_lst": GWAS_SNPS},
        )
        num = df.select_dtypes("number")
        out[f"unbalance_trans_{rep}"] = num.to_numpy(dtype=float)
        out[f"unbalance_trans_cols_{rep}"] = np.array(num.columns, dtype=str)
        print(f"unbalance rep {rep}: fixed/trans done", flush=True)

    np.savez_compressed(GOLDEN / "longwas_permutation.npz", **out)
    print("golden permutation fixtures written")


if __name__ == "__main__":
    main()
