"""Legacy array-level REMMA API (the reference's `gmat.remma.remma_cpu`).

These take (y, xmat, zmat) directly instead of a phenotype file — the older
generation of the reference API (/root/reference/gmat/remma/remma_cpu/):
`remma_add_cpu`/`remma_dom_cpu` (remma_add_cpu.py:14, exported by the
reference __init__) plus the per-epi-type `{_cpu,_select_cpu,_pair_cpu,
_eff_cpu}` family (remma_epiAA_cpu.py:15,88,174,252).

`zmat` may be a scipy-sparse incidence matrix, a dense 0/1 array, or a
DesignMatrices; it is converted to the record->individual index map used by
the modern engine.  The "_cpu" suffix is historical — everything runs on
the configured JAX backend.
"""
from __future__ import annotations

import numpy as np

from gmat_tpu.io.pheno import DesignMatrices
from gmat_tpu.scan.common import prepare_genotypes, score_pieces
from gmat_tpu.scan.pairs import _CODINGS, _scan_anchors, _validate_anchors


def _as_dm(y, xmat, zmat) -> DesignMatrices:
    y = np.asarray(y, float).reshape(-1)
    xmat = np.asarray(xmat, float).reshape(len(y), -1)
    if isinstance(zmat, DesignMatrices):
        return zmat
    z = np.asarray(zmat.todense()) if hasattr(zmat, "todense") else np.asarray(zmat)
    if z.ndim != 2 or not np.all((z == 0) | (z == 1)) or not np.all(
        z.sum(axis=1) == 1
    ):
        raise ValueError("zmat must be a 0/1 incidence matrix with one 1 per row")
    rec_ids = np.argmax(z, axis=1).astype(np.int32)
    return DesignMatrices(y=y, xmat=xmat, rec_ids=rec_ids, n_col=z.shape[1])


def remma_add_cpu(y, xmat, zmat, gmat_lst, var_com, bed_file,
                  out_file="remma_add_cpu"):
    from gmat_tpu.core.coding import additive_code

    dm = _as_dm(y, xmat, zmat)
    return _run_single_dm(dm, gmat_lst, var_com, bed_file, additive_code,
                          var_com[0], out_file)


def remma_dom_cpu(y, xmat, zmat, gmat_lst, var_com, bed_file,
                  out_file="remma_dom_cpu"):
    from gmat_tpu.core.coding import dominance_code

    dm = _as_dm(y, xmat, zmat)
    return _run_single_dm(dm, gmat_lst, var_com, bed_file, dominance_code,
                          var_com[1], out_file)


def _run_single_dm(dm, gmat_lst, var_com, bed_prefix, coding, sigma2,
                   out_file):
    import jax.numpy as jnp

    from gmat_tpu.scan.single import _single_scan_kernel

    pieces = score_pieces(dm, gmat_lst, var_com)
    geno, bim, _ = prepare_genotypes(bed_prefix)
    mat, _, scale = coding(jnp.asarray(geno))
    eff, var, eff_fixed, chi, p = (
        np.asarray(a)
        for a in _single_scan_kernel(mat, pieces.pymat, pieces.pvpmat,
                                     float(sigma2), scale)
    )
    res = bim[["chro", "snp_ID", "pos", "allele1", "allele2"]].copy()
    res["eff_val"] = eff
    res["chi_val"] = chi
    res["eff_val_to_fixed"] = eff_fixed
    res["p_val"] = p
    if out_file:
        res.to_csv(out_file, index=False, header=True, sep=" ")
    return res


def _epi_cpu(kind, y, xmat, zmat, gmat_lst, var_com, bed_file, snp_lst_0,
             p_cut, out_file):
    import jax.numpy as jnp

    code0, code1, triangular = _CODINGS[kind]
    dm = _as_dm(y, xmat, zmat)
    pieces = score_pieces(dm, gmat_lst, var_com)
    geno, _, _ = prepare_genotypes(bed_file)
    g = jnp.asarray(geno)
    mat0, mat1 = code0(g)[0], code1(g)[0]
    snp_lst_0 = _validate_anchors(snp_lst_0, geno.shape[1], triangular)
    return _scan_anchors(mat0, mat1, pieces, snp_lst_0, geno.shape[1],
                         triangular, p_cut, out_file)


def remma_epiAA_cpu(y, xmat, zmat, gmat_lst, var_com, bed_file,
                    snp_lst_0=None, p_cut=0.0001, out_file="remma_epiAA_cpu"):
    return _epi_cpu("AA", y, xmat, zmat, gmat_lst, var_com, bed_file,
                    snp_lst_0, p_cut, out_file)


def remma_epiAD_cpu(y, xmat, zmat, gmat_lst, var_com, bed_file,
                    snp_lst_0=None, p_cut=0.0001, out_file="remma_epiAD_cpu"):
    return _epi_cpu("AD", y, xmat, zmat, gmat_lst, var_com, bed_file,
                    snp_lst_0, p_cut, out_file)


def remma_epiDD_cpu(y, xmat, zmat, gmat_lst, var_com, bed_file,
                    snp_lst_0=None, p_cut=0.0001, out_file="remma_epiDD_cpu"):
    return _epi_cpu("DD", y, xmat, zmat, gmat_lst, var_com, bed_file,
                    snp_lst_0, p_cut, out_file)


def remma_epiAA_cpu_parallel(y, xmat, zmat, gmat_lst, var_com, bed_file,
                             parallel, p_cut=0.0001,
                             out_file="remma_epiAA_cpu_parallel"):
    """Balanced-split shard of the exact AA scan (reference
    remma_epiAA_cpu.py parallel twin); writes `<out>.<i>`."""
    from gmat_tpu.scan.pairs import balanced_anchor_split

    geno, _, _ = prepare_genotypes(bed_file)
    snp_lst_0 = balanced_anchor_split(geno.shape[1], parallel[0], parallel[1])
    return _epi_cpu("AA", y, xmat, zmat, gmat_lst, var_com, bed_file,
                    snp_lst_0, p_cut, f"{out_file}.{parallel[1]}")


def _epi_select_cpu(kind, y, xmat, zmat, gmat_lst, var_com, bed_file,
                    snp_lst_0, snp_lst_1, p_cut, out_file):
    """Rectangular scan of snp_lst_0 x snp_lst_1 ordered pairs, j != i
    (reference remma_epiAA_cpu.py:88-171, remma_epiAD_cpu.py:93-178 with
    anchors additive- and partners dominance-coded, remma_epiDD_cpu.py)."""
    import jax.numpy as jnp
    import pandas as pd

    from gmat_tpu.scan.pairs import _CODINGS, _pair_kernel

    code0, code1, _ = _CODINGS[kind]
    dm = _as_dm(y, xmat, zmat)
    pieces = score_pieces(dm, gmat_lst, var_com)
    geno, _, _ = prepare_genotypes(bed_file)
    m = geno.shape[1]
    g = jnp.asarray(geno)
    mat, mat1 = code0(g)[0], code1(g)[0]
    lst0 = np.asarray(list(range(m)) if snp_lst_0 is None else snp_lst_0)
    lst1 = np.asarray(list(range(m)) if snp_lst_1 is None else snp_lst_1)
    if lst0.max() >= m or lst0.min() < 0 or lst1.max() >= m or lst1.min() < 0:
        raise ValueError("snp list is out of range!")
    np.savetxt(out_file, ["snp_0 snp_1 eff var chi p"], fmt="%s")
    with open(out_file, "a") as fout:
        for i in lst0:
            cols0 = jnp.full(lst1.shape, int(i), dtype=jnp.int32)
            eff, var, chi, p = (
                np.asarray(a)
                for a in _pair_kernel(cols0, jnp.asarray(lst1), mat, mat1,
                                      pieces.pymat, pieces.pvpmat)
            )
            keep = (p < p_cut) & (lst1 != i)
            df = pd.DataFrame(
                {0: np.full(keep.sum(), i), 1: lst1[keep], 2: eff[keep],
                 3: var[keep], 4: chi[keep], 5: p[keep]}
            )
            df.to_csv(fout, sep=" ", header=False, index=False)
    return 0


def remma_epiAA_select_cpu(y, xmat, zmat, gmat_lst, var_com, bed_file,
                           snp_lst_0=None, snp_lst_1=None, p_cut=1.0,
                           out_file="remma_epiAA_select_cpu"):
    return _epi_select_cpu("AA", y, xmat, zmat, gmat_lst, var_com, bed_file,
                           snp_lst_0, snp_lst_1, p_cut, out_file)


def remma_epiAD_select_cpu(y, xmat, zmat, gmat_lst, var_com, bed_file,
                           snp_lst_0=None, snp_lst_1=None, p_cut=1.0,
                           out_file="remma_epiAD_select_cpu"):
    return _epi_select_cpu("AD", y, xmat, zmat, gmat_lst, var_com, bed_file,
                           snp_lst_0, snp_lst_1, p_cut, out_file)


def remma_epiDD_select_cpu(y, xmat, zmat, gmat_lst, var_com, bed_file,
                           snp_lst_0=None, snp_lst_1=None, p_cut=1.0,
                           out_file="remma_epiDD_select_cpu"):
    return _epi_select_cpu("DD", y, xmat, zmat, gmat_lst, var_com, bed_file,
                           snp_lst_0, snp_lst_1, p_cut, out_file)


def _epi_pair_cpu(kind, y, xmat, zmat, gmat_lst, var_com, bed_file,
                  snp_pair_file, max_test_pair, p_cut, out_file):
    dm = _as_dm(y, xmat, zmat)
    # reuse the modern pair engine with the prepared design
    import jax.numpy as jnp
    import pandas as pd

    from gmat_tpu.scan.pairs import _CODINGS, _HEADER_PAIR, _pair_kernel

    code0, code1, _ = _CODINGS[kind]
    pieces = score_pieces(dm, gmat_lst, var_com)
    geno, _, _ = prepare_genotypes(bed_file)
    g = jnp.asarray(geno)
    mat0, mat1 = code0(g)[0], code1(g)[0]
    pairs = pd.read_csv(snp_pair_file, sep=r"\s+", usecols=[0, 1], skiprows=1,
                        header=None).to_numpy(dtype=np.int64)
    np.savetxt(out_file, [_HEADER_PAIR], fmt="%s")
    with open(out_file, "a") as fout:
        for start in range(0, len(pairs), max_test_pair):
            chunk = pairs[start:start + max_test_pair]
            eff, var, chi, p = (
                np.asarray(a)
                for a in _pair_kernel(jnp.asarray(chunk[:, 0]),
                                      jnp.asarray(chunk[:, 1]), mat0, mat1,
                                      pieces.pymat, pieces.pvpmat)
            )
            keep = p < p_cut
            df = pd.DataFrame(
                {0: chunk[keep, 0], 1: chunk[keep, 1], 2: eff[keep],
                 3: var[keep], 4: chi[keep], 5: p[keep]}
            )
            df.to_csv(fout, sep=" ", header=False, index=False)
    return 0


def remma_epiAA_pair_cpu(y, xmat, zmat, gmat_lst, var_com, bed_file,
                         snp_pair_file, max_test_pair=50000, p_cut=1.0e-4,
                         out_file="remma_epiAA_pair_cpu"):
    return _epi_pair_cpu("AA", y, xmat, zmat, gmat_lst, var_com, bed_file,
                         snp_pair_file, max_test_pair, p_cut, out_file)


def remma_epiAD_pair_cpu(y, xmat, zmat, gmat_lst, var_com, bed_file,
                         snp_pair_file, max_test_pair=50000, p_cut=1.0e-4,
                         out_file="remma_epiAD_pair_cpu"):
    return _epi_pair_cpu("AD", y, xmat, zmat, gmat_lst, var_com, bed_file,
                         snp_pair_file, max_test_pair, p_cut, out_file)


def remma_epiDD_pair_cpu(y, xmat, zmat, gmat_lst, var_com, bed_file,
                         snp_pair_file, max_test_pair=50000, p_cut=1.0e-4,
                         out_file="remma_epiDD_pair_cpu"):
    return _epi_pair_cpu("DD", y, xmat, zmat, gmat_lst, var_com, bed_file,
                         snp_pair_file, max_test_pair, p_cut, out_file)


def _epi_eff_cpu(kind, y, xmat, zmat, gmat_lst, var_com, bed_file, snp_lst_0,
                 eff_cut, out_file):
    """Effect-only screen with an explicit |eff| threshold
    (reference remma_epiAA_cpu.py:252-317; eff_cut=-999 keeps everything).
    AD screens both orientations like the modern engine (C kernel
    _remma_epi_eff_cpu.c:233-247)."""
    import jax.numpy as jnp

    from gmat_tpu.scan.pairs import _CODINGS
    from gmat_tpu.scan.screen import _run_screen

    code0, code1, _ = _CODINGS[kind]
    dm = _as_dm(y, xmat, zmat)
    pieces = score_pieces(dm, gmat_lst, var_com)
    geno, _, _ = prepare_genotypes(bed_file)
    m = geno.shape[1]
    g = jnp.asarray(geno)
    mat0 = code0(g)[0].astype(jnp.float32)
    mat1 = code1(g)[0].astype(jnp.float32)
    py = pieces.pymat.astype(jnp.float32)
    anchors = list(range(m - 1)) if snp_lst_0 is None else list(snp_lst_0)
    cut = max(float(eff_cut), 0.0)
    bins = np.zeros(m, dtype=np.int64)
    table = np.full(111, cut, dtype=np.float32)
    # tile no wider than the anchor list: padding duplicates anchors, and a
    # keep-everything cut (the reference's eff_cut=-999) floods the tile
    tile = min(256, 1 << max(0, int(len(anchors) - 1)).bit_length())
    res = [_run_screen(mat0, mat1, py, anchors, bins, bins, table, "tri",
                       tile)]
    if kind == "AD":
        res.append(_run_screen(mat1, mat0, py, anchors, bins, bins, table,
                               "tri", tile, flip_output=True))
    with open(out_file, "w") as f:
        f.write("snp_0 snp_1 eff\n")
        for i0, i1, eff in res:
            for a, b, e in zip(i0, i1, eff):
                f.write(f"{a} {b} {e:g}\n")
    return 0


def remma_epiAA_eff_cpu(y, xmat, zmat, gmat_lst, var_com, bed_file,
                        snp_lst_0=None, eff_cut=-999.0,
                        out_file="remma_epiAA_eff_cpu"):
    return _epi_eff_cpu("AA", y, xmat, zmat, gmat_lst, var_com, bed_file,
                        snp_lst_0, eff_cut, out_file)


def remma_epiAD_eff_cpu(y, xmat, zmat, gmat_lst, var_com, bed_file,
                        snp_lst_0=None, eff_cut=-999.0,
                        out_file="remma_epiAD_eff_cpu"):
    return _epi_eff_cpu("AD", y, xmat, zmat, gmat_lst, var_com, bed_file,
                        snp_lst_0, eff_cut, out_file)


def remma_epiDD_eff_cpu(y, xmat, zmat, gmat_lst, var_com, bed_file,
                        snp_lst_0=None, eff_cut=-999.0,
                        out_file="remma_epiDD_eff_cpu"):
    return _epi_eff_cpu("DD", y, xmat, zmat, gmat_lst, var_com, bed_file,
                        snp_lst_0, eff_cut, out_file)


# the reference's `_eff_cpu_c` twins differ from `_eff_cpu` only in being
# C-accelerated (remma_epiAA_cpu.py:320+); here both names hit the same
# screen engine
remma_epiAA_eff_cpu_c = remma_epiAA_eff_cpu
remma_epiAD_eff_cpu_c = remma_epiAD_eff_cpu
remma_epiDD_eff_cpu_c = remma_epiDD_eff_cpu


def remma_epiAA_eff_cpu_c_parallel(y, xmat, zmat, gmat_lst, var_com, bed_file,
                                   parallel, eff_cut=-999.0,
                                   out_file="remma_epiAA_eff_cpu_c_parallel"):
    from gmat_tpu.scan.pairs import balanced_anchor_split

    geno, _, _ = prepare_genotypes(bed_file)
    snp_lst_0 = balanced_anchor_split(geno.shape[1], parallel[0], parallel[1])
    return _epi_eff_cpu("AA", y, xmat, zmat, gmat_lst, var_com, bed_file,
                        snp_lst_0, eff_cut, f"{out_file}.{parallel[1]}")
