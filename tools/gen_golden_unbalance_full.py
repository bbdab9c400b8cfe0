"""Full-cohort (1212-id) unbalance_varcom golden from the reference oracle
(VERDICT round-1 weak #4: the round-1 golden used a 150-id subset).

The reference MME is ~(2 + forder+1 + (aorder+1) + (porder+1)) blocks of
n_id -> a ~9700-dim dense solve per EM+AI round on this cohort; maxiter=3
keeps the oracle run to minutes while exercising several full-size rounds.

    JAX_PLATFORMS=cpu python tools/gen_golden_unbalance_full.py
"""
from __future__ import annotations

import logging
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).parent))
sys.path.insert(0, str(Path(__file__).parents[1]))

from reference_oracle import load_reference  # noqa: E402
from gen_golden_longwas import make_kin_file  # noqa: E402

ROOT = Path(__file__).parents[1]
ML = ROOT / "tests" / "data" / "mouse_long"
GOLDEN = ROOT / "tests" / "golden"

MAXITER = 3


def main():
    logging.basicConfig(level=logging.INFO)
    ref = load_reference()
    tmp = Path(tempfile.mkdtemp())
    prefix = make_kin_file(tmp)
    t0 = time.perf_counter()
    res = ref.unbalance_varcom.unbalance_varcom(
        str(ML / "phe.unbalance.txt"), "ID", "weak", "trait",
        prefix + ".agiv2", maxiter=MAXITER,
        prefix_outfile=str(tmp / "unb_full"),
    )
    print(f"reference full-cohort unbalance_varcom ({MAXITER} iters): "
          f"{time.perf_counter() - t0:.1f} s")
    np.savez_compressed(
        GOLDEN / "longwas_unbalance_var_full.npz",
        var_val=res["var_val"].to_numpy(),
        vari=res["vari"].to_numpy(),
        varij=res["varij"].to_numpy(),
        varik=res["varik"].to_numpy(),
        maxiter=MAXITER,
    )
    print("var:", res["var_val"].to_numpy())


if __name__ == "__main__":
    main()
