"""Shared score-test machinery for the REMMA engine.

Every REMMA test needs the same two projections of the phenotype under the
null random-SNP-BLUP model (reference remma_add.py:27-46, remma_epiAA.py:31-49):

    pymat  = Zᵀ P y          (n_id,)
    pvpmat = Zᵀ P Z          (n_id, n_id)   [uses the PVP = P identity]

with P = V⁻¹ − V⁻¹X(XᵀV⁻¹X)⁻¹XᵀV⁻¹ and V = Σ_i σ²_i Z G_i Zᵀ + σ²_e I.

Computed once per (model, variance) pair on device via Cholesky, then reused
by every scan.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from gmat_tpu.core.linalg import (chol_inv_logdet, mixed_inv_psd,
                                  projection_pieces)
from gmat_tpu.io.pheno import DesignMatrices
from gmat_tpu.reml.wemai import _resolve_precision, build_zgzt_stack


@dataclass(frozen=True)
class ScorePieces:
    pymat: jnp.ndarray  # (n_id,)
    pvpmat: jnp.ndarray  # (n_id, n_id)


@partial(jax.jit, static_argnums=(5, 6))
def _pieces_kernel(var_com, y, xmat, zg_stack, rec_ids, n_col, mixed=False):
    n = y.shape[0]
    vmat = jnp.einsum("k,kij->ij", var_com[:-1], zg_stack)
    vmat = vmat + var_com[-1] * jnp.eye(n, dtype=vmat.dtype)
    # mixed: f32 Cholesky + split-precision Newton refinement
    # (core/linalg.mixed_inv_psd); otherwise a float64 Cholesky
    vinv, _ = mixed_inv_psd(vmat) if mixed else chol_inv_logdet(vmat)
    pmat, _ = projection_pieces(vinv, xmat, mixed=mixed)
    py = pmat @ y
    pymat = jax.ops.segment_sum(py, rec_ids, num_segments=n_col)
    zp = jax.ops.segment_sum(pmat, rec_ids, num_segments=n_col)  # Zᵀ P
    pvpmat = jax.ops.segment_sum(zp.T, rec_ids, num_segments=n_col)
    return pymat, pvpmat


def score_pieces(dm: DesignMatrices, gmat_lst, var_com) -> ScorePieces:
    pymat, pvpmat = _pieces_kernel(
        jnp.asarray(np.asarray(var_com, dtype=np.float64)),
        jnp.asarray(dm.y),
        jnp.asarray(dm.xmat),
        build_zgzt_stack(dm, gmat_lst),
        jnp.asarray(dm.rec_ids),
        dm.n_col,
        _resolve_precision("auto"),
    )
    return ScorePieces(pymat=pymat, pvpmat=pvpmat)


_PIECES_CACHE: dict = {}


def score_pieces_cached(dm: DesignMatrices, gmat_lst, var_com) -> ScorePieces:
    """`score_pieces` with a size-1 cache keyed by the INPUT OBJECT
    identities (dm, each GRM) plus the variance values.

    The approx pipelines compute the same (pymat, pvpmat) three times
    (calibrate -> screen -> exact re-test stages each call score_pieces
    with the same dm/gmat_lst/var_com; reference remma_epiAA_approx.py
    re-derives them per stage too) — one O(n³) mixed-precision inverse per
    stage.  Identity keys are safe here because `design_matrix_cached`
    returns a stable dm object and callers thread one gmat_lst through the
    stages; any fresh object is a cache miss (recompute, never stale)."""
    key = (id(dm), tuple(id(g) for g in gmat_lst),
           np.asarray(var_com, dtype=np.float64).tobytes())
    ent = _PIECES_CACHE.get("ent")
    if ent is not None and ent[0] == key and ent[1][0] is dm \
            and all(a is b for a, b in zip(ent[1][1], gmat_lst)):
        return ent[2]
    pieces = score_pieces(dm, gmat_lst, var_com)
    _PIECES_CACHE["ent"] = (key, (dm, tuple(gmat_lst)), pieces)
    return pieces


_DM_CACHE: dict = {}


def design_matrix_cached(pheno_file: str, bed_prefix: str) -> DesignMatrices:
    """`design_matrix` with a size-1 cache keyed by file paths + mtimes,
    returning a STABLE DesignMatrices object across pipeline stages (which
    makes `score_pieces_cached`'s identity key effective)."""
    import os as _os

    from gmat_tpu.io.pheno import design_matrix as _design_matrix

    key = (str(pheno_file), _os.path.getmtime(str(pheno_file)),
           str(bed_prefix), _os.path.getmtime(str(bed_prefix) + ".fam"))
    ent = _DM_CACHE.get("ent")
    if ent is not None and ent[0] == key:
        return ent[1]
    dm = _design_matrix(pheno_file, bed_prefix)
    _DM_CACHE["ent"] = (key, dm)
    return dm


def imputed_genotypes(bed_prefix: str, impute_seed: int = 0) -> np.ndarray:
    """Read + (deterministically) impute genotypes (numpy only)."""
    from gmat_tpu.io.bed import Bed, impute_geno

    geno = Bed(bed_prefix).read()
    if np.any(np.isnan(geno)):
        geno = impute_geno(geno, seed=impute_seed)
    return geno


def prepare_genotypes(bed_prefix: str, impute_seed: int = 0):
    """`imputed_genotypes` plus the `.bim`/`.fam` tables as DataFrames;
    returns (geno, bim, fam)."""
    from gmat_tpu.io.bed import Bed

    bed = Bed(bed_prefix)
    return imputed_genotypes(bed_prefix, impute_seed), bed.bim, bed.fam


_DEVICE_GENO_CACHE: dict = {}
_MISSING_BYTE_LUT = np.array(
    [any(((b >> s) & 3) == 1 for s in (0, 2, 4, 6)) for b in range(256)],
    dtype=bool,
)


@partial(jax.jit, static_argnums=(1,))
def _unpack_f64_device(raw, num_id):
    """On-device unpack of packed 2-bit codes to (num_id, num_snp) f64.

    Gather-free: the reference's `(code² + code)/6` mapping
    (_read_plink_bed.c:37) sends codes {0, 2, 3} -> dosages {0, 1, 2}
    with pure VPU arithmetic (a 4-entry LUT take lowers to a slow XLA
    gather at this element count).  Caller guarantees no missing codes."""
    shifts = jnp.array([0, 2, 4, 6], dtype=jnp.uint8)
    codes = (raw[..., None] >> shifts) & jnp.uint8(3)
    codes = codes.reshape(raw.shape[0], -1)[:, :num_id]
    c = codes.astype(jnp.float32)
    return ((c * c + c) * (1.0 / 6.0)).T.astype(jnp.float64)


def prepare_genotypes_device(bed_prefix: str, impute_seed: int = 0):
    """Device-resident (n, m) float64 genotype panel with a size-1 cache,
    keyed by (path, .bed mtime, seed).

    The approx pipelines run three stages against the same panel
    (calibrate -> screen -> exact re-test, reference
    remma_epiAA_approx.py:10-53) and each would otherwise re-upload it.
    When the panel has NO missing genotypes (checked from the packed bytes
    via a 256-entry LUT), the raw 2-bit codes cross host->device 16x
    compressed and expand on the device (`io/bed.unpack_codes_device`) —
    at the yeast shape a 29 MB transfer instead of 941 MB of decoded f64.
    Panels with missing
    genotypes keep the host impute + dense upload path (seeded, parity).
    Returns (geno_device (n, m) float64, num_snp)."""
    import os as _os

    key = (str(bed_prefix),
           _os.path.getmtime(str(bed_prefix) + ".bed"), impute_seed)
    if _DEVICE_GENO_CACHE.get("key") != key:
        from gmat_tpu.io.bed import Bed

        bed = Bed(bed_prefix)
        raw = bed.read_raw()
        # trailing pad bits in the last byte per SNP can read as the
        # missing code in foreign files; mask the full bytes only and
        # check the tail explicitly
        n_full = bed.num_id // 4
        has_missing = bool(_MISSING_BYTE_LUT[raw[:, :n_full]].any())
        if not has_missing and n_full < raw.shape[1]:
            tail = raw[:, n_full]
            for s in range(0, 2 * (bed.num_id - 4 * n_full), 2):
                has_missing |= bool((((tail >> s) & 3) == 1).any())
        if has_missing:
            dev = jnp.asarray(imputed_genotypes(bed_prefix, impute_seed))
        else:
            dev = _unpack_f64_device(jnp.asarray(raw), bed.num_id)
        _DEVICE_GENO_CACHE.clear()
        _clear_coding_cache()
        _DEVICE_GENO_CACHE.update(key=key, dev=dev)
    dev = _DEVICE_GENO_CACHE["dev"]
    return dev, dev.shape[1]


_CODING_CACHE: dict = {}


def _clear_coding_cache():
    _CODING_CACHE.clear()


def coded_matrix(g, kind: str, dtype=None):
    """Cached genotype coding: `kind` in ('add', 'dom'), optional dtype cast.

    Keyed by the identity of `g` (the stable device array from
    `prepare_genotypes_device`; entries hold a strong reference so the id
    can never be recycled, and the cache clears when the panel changes).
    The approx pipelines re-derive the same (n, m) coded panel per stage —
    an elementwise f64 pass — and the screen additionally derives the f32
    twin; one device copy each serves all stages."""
    from gmat_tpu.core.coding import additive_code, dominance_code

    key = (id(g), kind, np.dtype(dtype).str if dtype is not None else None)
    ent = _CODING_CACHE.get(key)
    if ent is not None and ent[0] is g:
        return ent[1]
    base_key = (id(g), kind, None)
    base = _CODING_CACHE.get(base_key)
    if base is not None and base[0] is g:
        mat = base[1]
    else:
        mat = (additive_code(g) if kind == "add" else dominance_code(g))[0]
        _CODING_CACHE[base_key] = (g, mat)
    if dtype is not None:
        mat = mat.astype(dtype)
        _CODING_CACHE[key] = (g, mat)
    return mat
