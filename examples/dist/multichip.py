"""Multi-chip sharding demo on a virtual 8-device mesh.

The reference's only multi-machine story is manual `parallel=[N, i]` runs
merged by file concatenation (README.md:125-204). Here the same three hot
phases run sharded over a `jax.sharding.Mesh` with XLA collectives instead:

  - additive GRM: genotype columns sharded, partial M·Mᵀ summed with one psum
  - effect screen: interleaved anchor blocks per device, deterministic
    hit merge
  - exact scan tile: anchors data-parallel over the mesh

On real hardware remove the host-device override; on CPU this forces 8
virtual devices (must be set before JAX initializes its backend).
"""
import os
import sys
from pathlib import Path

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from _common import out_dir, stage_mouse  # noqa: E402

import jax  # noqa: E402
import numpy as np  # noqa: E402

from gmat_tpu.dist.mesh import (  # noqa: E402
    make_mesh,
    sharded_additive_grm,
    sharded_exact_scan_tile,
    sharded_screen_hits,
)
from gmat_tpu.grm.grm import agmat  # noqa: E402
from gmat_tpu.io.bed import read_plink  # noqa: E402

out = out_dir(__file__)
bed = stage_mouse(out)

print("devices:", jax.device_count(), jax.devices()[0].platform)
mesh = make_mesh(8)

geno = np.asarray(read_plink(bed), dtype=np.float64)
n, m = geno.shape

# 1) sharded GRM == single-chip GRM
kin_sharded = np.asarray(sharded_additive_grm(geno, mesh))
kin_single, _ = agmat(bed, out_fmt="mat")
print("sharded GRM max |delta| vs single-chip:",
      float(np.abs(kin_sharded - np.asarray(kin_single)).max()))

# 2) sharded effect screen with deterministic hit merge
p_hat = geno.sum(0) / (2 * n)
mat = (geno - 2 * p_hat[None, :]).astype(np.float32)
py = np.random.default_rng(0).standard_normal(n).astype(np.float32) * 0.1
row = np.abs((mat[:, :64] * py[:, None]).T @ mat)
cut = float(np.quantile(row, 1 - 1e-4))
i0, i1, eff = sharded_screen_hits(mat, py, cut, mesh)
print(f"sharded screen: {len(i0)} hits above |eff|={cut:.3f}")

# 3) exact-scan tile, anchors sharded over the mesh
rng = np.random.default_rng(1)
a = rng.standard_normal((n, n))
pvp = a @ a.T / n + np.eye(n)
anchors = np.arange(16, dtype=np.int32)
p = np.asarray(sharded_exact_scan_tile(anchors, mat.astype(np.float64), py.astype(np.float64), pvp, mesh))
print("exact tile p-matrix:", p.shape, "finite:", bool(np.isfinite(p).all()))

# 4) the PRODUCTION file-level pipeline on the mesh (round 2): every scan,
# screen, approx pipeline, and GRM entry point accepts `mesh=`, and the CLI
# exposes it as `gmat-tpu --devices N ...`.  Output files are byte-identical
# to single-device runs (tests/test_dist.py proves it on this fixture).
from gmat_tpu.grm.grm import additive_grm  # noqa: E402
from gmat_tpu.scan.screen import remma_epiAA_approx  # noqa: E402
import jax.numpy as jnp  # noqa: E402

ag = np.asarray(additive_grm(jnp.asarray(geno)))
var_com = np.array([0.06289206, 0.07641075, 0.08121168])
pheno = str(Path(bed).parent / "pheno")
remma_epiAA_approx(pheno, bed, [ag, ag * ag], var_com, p_cut=1e-4,
                   num_random_pair=5000, out_file=str(out / "epiAA_meshed"),
                   mesh=mesh)
print("meshed approx pipeline rows:",
      sum(1 for _ in open(out / "epiAA_meshed")) - 1)

# 5) multi-host: on a cluster every process calls
#     mesh = gmat_tpu.dist.initialize_multihost(coordinator, n_proc, rank)
# once at startup and passes the returned global mesh exactly as above
# (tests/test_multihost.py runs a real 2-process CPU cluster this way).
