"""Subprocess body for test_multihost.py: one process of a 2-process
jax.distributed CPU cluster (SURVEY §4 test item 3).

Usage: python multihost_worker.py <process_id> <num_processes> <port> <out>
"""
import os
import sys
from pathlib import Path

# hermetic: runnable from a bare checkout without `pip install -e .`
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

os.environ["JAX_PLATFORMS"] = "cpu"
# 2 virtual devices per process -> a 4-device global mesh across 2 processes
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402


def main():
    pid, nproc, port, out = (int(sys.argv[1]), int(sys.argv[2]),
                             int(sys.argv[3]), sys.argv[4])
    from gmat_tpu.dist import initialize_multihost
    from gmat_tpu.dist.mesh import sharded_additive_grm, sharded_screen_hits

    mesh = initialize_multihost(
        coordinator_address=f"localhost:{port}",
        num_processes=nproc, process_id=pid,
    )
    assert jax.process_count() == nproc
    assert mesh.devices.size == jax.device_count()
    rng = np.random.default_rng(7)  # same data on every process
    geno = rng.choice([0.0, 1.0, 2.0], size=(40, 64))
    kin = np.asarray(sharded_additive_grm(geno, mesh))  # replicated output

    # a sharded SCREEN on the multi-process mesh (not just GRM): the anchor
    # worklist spreads over both processes' devices; output is replicated
    # and must be byte-identical to the single-process screen
    mat = np.asarray(geno - geno.mean(axis=0), dtype=np.float32)
    py = (rng.standard_normal(40) * 0.1).astype(np.float32)
    hits_i, hits_j, hits_e = sharded_screen_hits(mat, py, 1.0, mesh, tile=16)

    # the PRODUCTION fused screen via the file-level API across the real
    # 2-process cluster (VERDICT r3 #5): each process stages an identical
    # synthetic cohort (same rng sequence) and runs remma_epiAA_eff(mesh=);
    # pid 0 records the output table for byte-comparison with a
    # single-process run
    import pandas as pd

    from gmat_tpu.grm.grm import additive_grm
    from gmat_tpu.io.bed import write_bed
    from gmat_tpu.scan.screen import remma_epiAA_eff

    import jax.numpy as jnp

    work = Path(out).parent / f"proc{pid}"
    work.mkdir(exist_ok=True)
    geno2 = rng.choice([0.0, 1.0, 2.0], size=(40, 96))
    prefix = str(work / "plink")
    write_bed(prefix, geno2)
    fam = pd.read_csv(prefix + ".fam", sep=r"\s+", header=None, dtype=str)
    yvec = rng.standard_normal(40)
    with open(work / "pheno", "w") as f:
        for (f0, i0), yv in zip(fam[[0, 1]].to_numpy(), yvec):
            f.write(f"{f0} {i0} 1 {yv:.8f}\n")
    ag = np.asarray(additive_grm(jnp.asarray(geno2)))
    var_com = [0.5, 0.5]
    # cut at the |eff| 0.9 quantile: real hits, mixed row densities
    from gmat_tpu.core.stats import chi2_isf

    mat2 = np.asarray(geno2 - geno2.mean(axis=0), dtype=np.float32)
    eff = (mat2 * 0.01).T @ mat2  # scale only sets a ballpark cut
    cut = float(np.quantile(np.abs(eff[np.triu_indices(96, 1)]), 0.9))
    var_app = cut * cut / chi2_isf(1e-5, 1)
    eff_file = str(work / "epiAA_eff")
    remma_epiAA_eff(str(work / "pheno"), prefix, [ag], var_com,
                    var_app=var_app, p_cut=1e-5, out_file=eff_file,
                    mesh=mesh)

    if pid == 0:
        np.savez(out, kin=kin, geno=geno, ndev=int(jax.device_count()),
                 mat=mat, py=py, hits_i=hits_i, hits_j=hits_j, hits_e=hits_e,
                 geno2=geno2, yvec=yvec, var_app=var_app,
                 eff_table=Path(eff_file).read_bytes())
    print(f"proc {pid} done", flush=True)


if __name__ == "__main__":
    main()
