"""Generate FULL-TABLE epistasis goldens from the reference implementation.

Runs the reference's exact scans (remma_epiAA/AD/DD, p_cut=1.1 = keep all)
over the complete mouse fixture — all 989,121 AA pairs, 1,979,649 AD ordered
pairs, 989,121 DD pairs — and stores the resulting eff/chi/p tables
(BASELINE.md north-star #1: bit/tolerance-matched full mouse p-table).

Tables are stored float32 (quantization 6e-8 << the 1e-6 parity tolerance);
a 2,000-row random subset is kept in float64 for tight (rtol 1e-10) spot
checks.  Row indices are implied by the reference's write order (anchor
ascending, partner ascending; every pair survives p_cut=1.1 because the
mouse fixture has no monomorphic SNPs) and verified by stored row counts +
the f64 subset's explicit indices.

Run once (CPU, float64, ~5-10 min on 2 cores):

    JAX_PLATFORMS=cpu python tools/gen_golden_full.py
"""
from __future__ import annotations

import sys
import tempfile
import time
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


def main():
    GOLDEN.mkdir(exist_ok=True)
    ref = load_reference()
    from gmat_tpu.io.bed import read_plink

    geno = read_plink(BED)
    m = geno.shape[1]
    y, xmat, zmat = ref.design_matrix.design_matrix_wemai_multi_gmat(PHENO, BED)
    var_com = np.load(GOLDEN / "reml_var.npz")["a_axa"]

    n_freq = geno.sum(axis=0) / (2 * geno.shape[0])
    ag = None  # rebuild exactly as gen_golden.np_agrm to match reml_var
    cen = geno - 2 * n_freq[None, :]
    scale = np.sum(2 * n_freq * (1 - n_freq))
    ag = cen @ cen.T / scale
    np.fill_diagonal(ag, np.diag(ag) * 1.001)
    gmat_lst = [ag, ag * ag]

    rng = np.random.default_rng(7)
    out = {"var_com": var_com}
    specs = [
        ("aa", ref.remma_epiAA._remma_epiAA, m * (m - 1) // 2),
        ("ad", ref.remma_epiAD._remma_epiAD, m * m),
        ("dd", ref.remma_epiDD._remma_epiDD, m * (m - 1) // 2),
    ]
    for name, fn, expect in specs:
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as td:
            fn(y, xmat, zmat, gmat_lst, var_com, BED, snp_lst_0=None,
               p_cut=1.1, out_file=td + "/t")
            tab = np.loadtxt(td + "/t", skiprows=1)
        assert tab.shape == (expect, 5), (name, tab.shape, expect)
        idx = tab[:, :2].astype(np.int32)
        # verify the implied canonical write order so the test can
        # reconstruct indices without storing them
        if name == "ad":
            want0 = np.repeat(np.arange(m, dtype=np.int32), m)
            want1 = np.tile(np.arange(m, dtype=np.int32), m)
        else:
            want0, want1 = (a.astype(np.int32)
                            for a in np.triu_indices(m, k=1))
        assert np.array_equal(idx[:, 0], want0), name
        assert np.array_equal(idx[:, 1], want1), name
        out[f"{name}_eff"] = tab[:, 2].astype(np.float32)
        out[f"{name}_chi"] = tab[:, 3].astype(np.float32)
        out[f"{name}_p"] = tab[:, 4].astype(np.float32)
        sub = rng.choice(expect, size=2000, replace=False)
        sub.sort()
        out[f"{name}_sub_rows"] = sub.astype(np.int64)
        out[f"{name}_sub"] = tab[sub]  # full f64 rows incl. indices
        print(f"{name}: {expect} pairs in {time.perf_counter() - t0:.1f} s")
    np.savez_compressed(GOLDEN / "epi_full.npz", **out)
    print("written", GOLDEN / "epi_full.npz")


if __name__ == "__main__":
    main()
