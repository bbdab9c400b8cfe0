"""Accelerator effect-screen API (the reference's `gmat.remma.remma_gpu`).

Reference parity (`/root/reference/gmat/remma/remma_gpu/remma_epiAA_gpu.py:
12-99`): `remma_epiAA_eff_gpu(y, xmat, gmat_lst, var_com, bed_file, ...)`
streams SNP column blocks (`max_test_pair` at a time) to a CUDA GPU via
cupy, computes `eff = epi_matᵀ · pymat` per anchor, keeps `|eff| > eff_cut`,
writes the rows with `np.savetxt(header='snp_0 snp_1 eff')` and returns the
kept (snp_0, snp_1, eff) float array.

Here the whole scan is the production screen (gmat_tpu/scan/screen.py) —
one compiled program per phase instead of a per-anchor host loop, with the
genotype panel resident in device memory, so `max_test_pair` column
streaming is unnecessary (accepted and ignored).  The
default `eff_cut=-999.0` keeps every pair, exactly like the reference.

Note the reference's gpu signature has no `zmat`: one record per individual
(Z = I), unlike the legacy `remma_cpu` API.
"""
from __future__ import annotations

import numpy as np

from gmat_tpu.io.pheno import DesignMatrices
from gmat_tpu.scan.common import imputed_genotypes, score_pieces


def remma_epiAA_eff_gpu(y, xmat, gmat_lst, var_com, bed_file, snp_lst_0=None,
                        max_test_pair=50000, eff_cut=-999.0,
                        out_file="remma_epiAA_eff_gpu"):
    """Additive-by-additive effect-only screen on the accelerator.

    Returns the kept rows as a float array with columns
    (snp_0, snp_1, eff), and writes them to `out_file` via `np.savetxt`
    with the reference's `snp_0 snp_1 eff` header
    (remma_epiAA_gpu.py:97-99)."""
    import jax.numpy as jnp

    from gmat_tpu.core.coding import additive_code
    from gmat_tpu.scan.screen import _run_screen

    del max_test_pair  # column-block streaming knob; the panel is resident
    y = np.asarray(y, float).reshape(-1)
    n = y.shape[0]
    xmat = np.asarray(xmat, float).reshape(n, -1)
    dm = DesignMatrices(y=y, xmat=xmat,
                        rec_ids=np.arange(n, dtype=np.int32), n_col=n)
    pieces = score_pieces(dm, gmat_lst, var_com)
    geno = imputed_genotypes(bed_file)
    m = geno.shape[1]
    mat = additive_code(jnp.asarray(geno))[0].astype(jnp.float32)
    py = pieces.pymat.astype(jnp.float32)

    # materialize once up front: a generator would be consumed by max() and
    # leave min()/list() empty
    anchors = list(snp_lst_0) if snp_lst_0 is not None else list(range(m - 1))
    if snp_lst_0 is not None and (max(anchors) >= m - 1 or min(anchors) < 0):
        raise ValueError("snp_lst_0 is out of range!")

    # the raw (possibly negative) cut flows through: |eff| > -999 keeps every
    # pair INCLUDING exact zeros (monomorphic SNPs give eff == 0.0 exactly),
    # matching the reference's keep-all default (remma_epiAA_gpu.py:88-93)
    cut = float(eff_cut)
    bins = np.zeros(m, dtype=np.int64)
    table = np.full(111, cut, dtype=np.float32)
    # keep-everything cuts flood wide tiles; match the legacy engine's sizing
    tile = min(256, 1 << max(0, int(len(anchors) - 1)).bit_length())
    idx0, idx1, eff = _run_screen(mat, mat, py, anchors, bins, bins, table,
                                  "tri", tile)
    res = np.column_stack([idx0.astype(float), idx1.astype(float), eff])
    np.savetxt(out_file, res, header="snp_0 snp_1 eff", comments="")
    return res
