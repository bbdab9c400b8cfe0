"""Exact epistasis score-test scans (epiAA / epiAD / epiDD) and pair tests.

Parity targets:
- `remma_epiAA`  (/root/reference/gmat/remma/remma_epiAA/remma_epiAA.py:16-86):
  strict upper-triangle scan over additive x additive pairs,
  columns `snp_0 snp_1 eff chi p_val`, keep p < p_cut.
- `remma_epiAD`  (remma_epiAD/remma_epiAD.py:50-90): full ordered rectangle
  (anchor over all SNPs, partner over all SNPs, i==j included),
  anchor additive-coded, partner dominance-coded.
- `remma_epiDD`  (remma_epiDD/remma_epiDD.py:50-92): triangular, both
  dominance-coded.
- `remma_epi*_pair` (remma_epiAA_pair.py:16-92): explicit pair lists,
  columns `snp_0 snp_1 eff var chi p`.
- `*_parallel` (remma_epiAA.py:109-140): balanced triangular anchor split.

Per pair (i, j) with epistasis covariate e = m_i ⊙ m_j (elementwise over
individuals):   eff = eᵀ·pymat,   var = eᵀ·pvpmat·e,   chi = eff²/var.

Design: the per-anchor partner sweep is a batched GEMM — vmap over a tile
of anchors of (pvpmat @ E) with E = m_i ⊙ M, giving (n x n x tile·m)
float64 contractions; chi/p computed on device; the
host only filters p < p_cut per tile and appends rows (file contract
preserved).  The anchor tiling doubles as the unit of multi-chip sharding
(gmat_tpu/dist/mesh.py).
"""
from __future__ import annotations

import logging
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from gmat_tpu.config import ScanConfig
from gmat_tpu.core.coding import additive_code, dominance_code
from gmat_tpu.core.roofline import log_phase, maybe_trace
from gmat_tpu.core.stats import chi2_sf
from gmat_tpu.io.text import count_records, read_int_pairs, write_rows

logger = logging.getLogger(__name__)

_HEADER_SCAN = "snp_0 snp_1 eff chi p_val"
_HEADER_PAIR = "snp_0 snp_1 eff var chi p"


def _one_anchor(a_col, mat0, mat1, pymat, pvpmat):
    e = mat0[:, a_col][:, None] * mat1  # (n, m)
    eff = e.T @ pymat
    var = jnp.sum(e * (pvpmat @ e), axis=0)
    return eff, var


@jax.jit
def _anchor_tile_kernel(anchor_cols, mat0, mat1, pymat, pvpmat):
    """(TA,) anchors -> eff, chi, p over the full partner axis: (TA, m)."""
    eff, var = jax.vmap(_one_anchor, in_axes=(0, None, None, None, None))(
        anchor_cols, mat0, mat1, pymat, pvpmat
    )
    chi = eff * eff / var
    return eff, var, chi, chi2_sf(chi, 1)


_SCAN_HIT_CAP = 65536  # fixed per-anchor-tile hit capacity (static shapes)


def _anchor_hits_body(tstart, anchors_padded, avalid, mat0, mat1, pymat,
                      pvpmat, chi_crit, triangular, tile, cap, pch=None):
    """Fused exact-scan tile: eff/var/chi for one anchor tile against all
    partners, thresholded and compacted ON DEVICE so only O(hits) rows cross
    to host (the reference filters p<p_cut per anchor on host,
    remma_epiAA.py:78-82; here chi > chi2.isf(p_cut, 1) is the same test).

    The partner axis is CHUNKED (`pch` columns per lax.scan step): the
    vmapped epistasis covariate tensor e is (tile, n, pch), so HBM holds
    one chunk's working set instead of the whole (tile, n, m) block — a
    61 GB allocation at the yeast shape before this chunking (the blockwise
    decomposition SURVEY §5 prescribes for the m x m scan).

    anchors_padded/avalid: (n_tiles*TA,) anchor ids and validity mask
    (padding anchors duplicate the last anchor and are masked out).  Returns
    (count, snp_0, snp_1, eff, var, chi) with fixed capacity `cap`; the
    caller re-invokes with a larger cap when count > cap.  Compaction is an
    int32 prefix-sum + scatter (`jnp.nonzero` under the package-global x64
    mode emits int64 index math)."""
    anchor_cols = jax.lax.dynamic_slice_in_dim(anchors_padded, tstart, tile)
    row_valid = jax.lax.dynamic_slice_in_dim(avalid, tstart, tile)
    m = mat1.shape[1]
    pch = min(pch or m, m)
    n_chunks = -(-m // pch)
    if n_chunks == 1:
        # single-chunk fast path: ONE flat-index scatter + value gathers
        # instead of the streaming form's five per-chunk scatters
        eff, var = jax.vmap(_one_anchor_chunk,
                            in_axes=(0, None, None, None, None))(
            anchor_cols, mat0, mat1, pymat, pvpmat)
        chi = eff * eff / var  # (TA, m); 0/0 -> NaN -> never a hit
        j_ids = jnp.arange(m, dtype=jnp.int32)[None, :]
        valid = row_valid[:, None]
        if triangular:
            valid = valid & (j_ids > anchor_cols[:, None])
        hit = (chi > chi_crit) & valid
        flat = hit.ravel()
        pos = jnp.cumsum(flat.astype(jnp.int32)) - 1
        count = pos[-1] + 1
        dest = jnp.where(flat, pos, cap)
        flat_idx = jnp.arange(flat.shape[0], dtype=jnp.int32)
        buf = jnp.zeros((cap + 1,), jnp.int32).at[dest].set(flat_idx,
                                                            mode="drop")
        sel = buf[:cap]
        rows = sel // m
        cols = sel % m
        return (count, anchor_cols[rows], cols, eff[rows, cols],
                var[rows, cols], chi[rows, cols])
    mat1_p = mat1
    if n_chunks * pch != m:
        # zero partner columns: var 0 -> chi NaN -> never a hit; the
        # explicit j < m mask below also covers keep-all negative crits
        mat1_p = jnp.pad(mat1, ((0, 0), (0, n_chunks * pch - m)))
    jt = jnp.arange(pch, dtype=jnp.int32)

    def step(carry, pc):
        bufs, total = carry
        pstart = pc * pch
        mat1_c = jax.lax.dynamic_slice_in_dim(mat1_p, pstart, pch, axis=1)
        eff, var = jax.vmap(_one_anchor_chunk,
                            in_axes=(0, None, None, None, None))(
            anchor_cols, mat0, mat1_c, pymat, pvpmat)
        chi = eff * eff / var  # (TA, pch); 0/0 -> NaN -> never a hit
        j_ids = (pstart + jt)[None, :]
        valid = row_valid[:, None] & (j_ids < jnp.int32(m))
        if triangular:
            valid = valid & (j_ids > anchor_cols[:, None])
        hit = (chi > chi_crit) & valid
        flat = hit.ravel()
        pos = jnp.cumsum(flat.astype(jnp.int32)) - 1 + total
        dest = jnp.where(flat, jnp.minimum(pos, cap), cap)
        bi, bj, be, bv, bc = bufs
        bi = bi.at[dest].set(
            jnp.broadcast_to(anchor_cols[:, None], hit.shape).ravel(),
            mode="drop")
        bj = bj.at[dest].set(jnp.broadcast_to(j_ids, hit.shape).ravel(),
                             mode="drop")
        be = be.at[dest].set(eff.ravel(), mode="drop")
        bv = bv.at[dest].set(var.ravel(), mode="drop")
        bc = bc.at[dest].set(chi.ravel(), mode="drop")
        return ((bi, bj, be, bv, bc), pos[-1] + 1), None

    dtype = mat0.dtype
    zero = tstart * 0  # device-varying under shard_map (carry-type match)
    init_bufs = (jnp.zeros((cap + 1,), jnp.int32) + zero,
                 jnp.zeros((cap + 1,), jnp.int32) + zero,
                 jnp.zeros((cap + 1,), dtype) + zero.astype(dtype),
                 jnp.zeros((cap + 1,), dtype) + zero.astype(dtype),
                 jnp.zeros((cap + 1,), dtype) + zero.astype(dtype))
    ((bi, bj, be, bv, bc), count), _ = jax.lax.scan(
        step, (init_bufs, zero), jnp.arange(n_chunks, dtype=jnp.int32))
    return count, bi[:cap], bj[:cap], be[:cap], bv[:cap], bc[:cap]


def _one_anchor_chunk(a_col, mat0, mat1_c, pymat, pvpmat):
    e = mat0[:, a_col][:, None] * mat1_c  # (n, pch)
    eff = e.T @ pymat
    var = jnp.sum(e * (pvpmat @ e), axis=0)
    return eff, var


@partial(jax.jit, static_argnames=("triangular", "tile", "cap", "pch"))
def _anchor_tiles_batch(tstarts, anchors_padded, avalid, mat0, mat1, pymat,
                        pvpmat, chi_crit, triangular, tile, cap, pch=None):
    """ONE dispatch for a batch of anchor tiles: lax.map of
    `_anchor_hits_body` over the (K,) tile starts."""

    def one(tstart):
        return _anchor_hits_body(tstart, anchors_padded, avalid, mat0, mat1,
                                 pymat, pvpmat, chi_crit, triangular, tile,
                                 cap, pch)

    return jax.lax.map(one, tstarts)


def _anchor_tiles_mesh(mesh, tstarts, anchors_padded, avalid, mat0, mat1,
                       pymat, pvpmat, chi_crit, triangular, tile, cap,
                       pch=None):
    """Exact-scan tiles over a device mesh: the tile list is sharded over
    the mesh axis, genotype codings and pymat/pvpmat replicated.  Each
    device runs the SAME per-tile math as the single-device path, so the
    merged output is byte-identical to a single-device run."""
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from gmat_tpu.dist.mesh import AXIS

    # replicated outputs: multi-process hosts cannot fetch sharded arrays
    @partial(jax.jit, out_shardings=NamedSharding(mesh, P()))
    @partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(AXIS), P(None), P(None), P(None, None), P(None, None),
                  P(None), P(None, None)),
        out_specs=(P(AXIS),) + (P(AXIS, None),) * 5,
    )
    def kernel(ts, ap, av, m0, m1, py, pvp):
        def one(tstart):
            return _anchor_hits_body(tstart, ap, av, m0, m1, py, pvp,
                                     chi_crit, triangular, tile, cap, pch)

        return jax.lax.map(one, ts)

    return kernel(tstarts, anchors_padded, avalid, mat0, mat1, pymat, pvpmat)


@jax.jit
def _pair_kernel(cols0, cols1, mat0, mat1, pymat, pvpmat):
    e = mat0[:, cols0] * mat1[:, cols1]  # (n, B)
    eff = e.T @ pymat
    var = jnp.sum(e * (pvpmat @ e), axis=0)
    chi = eff * eff / var
    return eff, var, chi, chi2_sf(chi, 1)


def _chi2_sf_host(chi):
    """Host-side df=1 survival function, same erfc identity as
    core.stats.chi2_sf (avoids one device dispatch per tile)."""
    from scipy.special import erfc

    return erfc(np.sqrt(np.maximum(chi, 0.0) / 2.0))


def _scan_anchors(*args, **kwargs):
    """`_scan_anchors_impl` under the optional jax.profiler trace hook
    (GMAT_TPU_TRACE_DIR; core/roofline.py)."""
    with maybe_trace("exact_scan"):
        return _scan_anchors_impl(*args, **kwargs)


def _scan_anchors_impl(mat0, mat1, pieces, snp_lst_0, num_snp, triangular,
                       p_cut, out_file, tile=None, mesh=None):
    """Device-tiled anchor sweep with ON-DEVICE p-filtering + compaction:
    one dispatch per anchor-tile group, O(hits) host transfer (VERDICT item
    3 — the previous version fetched four full (tile, m) float64 panels and
    filtered per anchor in Python).  With `mesh`, each dispatch spreads
    ndev tiles over the device mesh (same per-tile math, so mesh output is
    byte-identical to single-device)."""
    import time

    from gmat_tpu.core.stats import chi2_isf

    np.savetxt(out_file, [_HEADER_SCAN], fmt="%s")
    anchors = np.asarray(list(snp_lst_0), dtype=np.int32)
    chi_crit = chi2_isf(p_cut, 1) if p_cut < 1.0 else -1.0
    ndev = int(mesh.devices.size) if mesh is not None else 1
    # shrink the tile when the anchor list is small so padding anchors
    # (duplicates of the last anchor, masked from the output but not from
    # the GEMM) never dominate the FLOPs; per-anchor results are
    # tile-size-independent, so this cannot change the output
    tile = tile or ScanConfig.anchor_tile
    tile = max(8, min(tile, -(-len(anchors) // ndev)))
    if chi_crit <= 0:
        # keep-all scans fill EVERY buffer slot; an unbounded
        # tile*num_snp capacity would allocate ~231M slots x 5 outputs at
        # yeast scale (VERDICT round-2 weak #6).  Shrink the anchor tile so
        # the fixed-capacity buffer stays ~4M slots and stream more tile
        # groups instead.
        tile = max(8, min(tile, (1 << 22) // max(1, num_snp)))
    # partner-chunk budget: the vmapped per-tile covariate tensor holds
    # ~3 copies of (tile, n, pch); bound that working set at ~6 GB so wide
    # panels (yeast: 61 GB un-chunked) stream instead of running out of
    # device memory (a safe lower bound on an 80 GB card; not yet tuned)
    m_partner = mat1.shape[1]
    per_col = mat0.shape[0] * 3 * np.dtype(mat0.dtype).itemsize
    max_cols = max(4096, int((6 << 30) // per_col))
    pch = None
    if tile * m_partner > max_cols:
        tile = max(8, min(tile, max_cols // 4096))
        pch = max(1024, min(m_partner, max_cols // tile))
    n_tiles = -(-len(anchors) // tile)
    n_tiles_pad = -(-n_tiles // ndev) * ndev
    padded_all = np.pad(anchors, (0, n_tiles_pad * tile - len(anchors)),
                        constant_values=anchors[-1])
    avalid = np.arange(len(padded_all)) < len(anchors)
    padded_d = jnp.asarray(padded_all)
    avalid_d = jnp.asarray(avalid)
    # keep-all scans (p_cut >= 1, the approx re-test convention) fill a tile
    # completely: size the buffer up front instead of retrying every tile
    cap0 = _SCAN_HIT_CAP if chi_crit > 0 else 1 << (tile * num_snp - 1).bit_length()
    clock_t0 = time.perf_counter()
    n_hits = 0
    with open(out_file, "a") as fout:
        for g in range(0, n_tiles_pad, ndev):
            tstarts = jnp.asarray(
                np.arange(g, g + ndev, dtype=np.int32) * tile
            )
            if mesh is not None:
                out = _anchor_tiles_mesh(mesh, tstarts, padded_d, avalid_d,
                                         mat0, mat1, pieces.pymat,
                                         pieces.pvpmat, chi_crit, triangular,
                                         tile, cap0, pch)
            else:
                out = _anchor_tiles_batch(tstarts, padded_d, avalid_d, mat0,
                                          mat1, pieces.pymat, pieces.pvpmat,
                                          chi_crit, triangular, tile, cap0,
                                          pch)
            counts = np.asarray(out[0])
            arrs = [np.asarray(a) for a in out[1:]]
            for k in range(min(ndev, n_tiles - g)):
                count = int(counts[k])
                if count > cap0:
                    # rare: a p_cut<1 tile denser than the default buffer —
                    # re-extract just that tile with a capacity that fits
                    cap = 1 << int(count - 1).bit_length()
                    sub = _anchor_tiles_batch(
                        tstarts[k:k + 1], padded_d, avalid_d, mat0, mat1,
                        pieces.pymat, pieces.pvpmat, chi_crit, triangular,
                        tile, cap, pch)
                    count = int(np.asarray(sub[0])[0])
                    row = [np.asarray(a)[0, :count] for a in sub[1:]]
                else:
                    row = [a[k, :count] for a in arrs]
                if count == 0:
                    continue
                i_sel, j_sel, eff, var, chi = row
                # chunked extraction emits hits chunk-major; restore the
                # canonical (anchor, partner) row order of the reference
                order = np.lexsort((j_sel, i_sel))
                i_sel, j_sel = i_sel[order], j_sel[order]
                eff, var, chi = eff[order], var[order], chi[order]
                n_hits += count
                write_rows(fout, i_sel.astype(np.int64),
                           j_sel.astype(np.int64), eff, chi,
                           _chi2_sf_host(chi))
    # scan-timing log contract (reference remma_epiAA.py:69-85 logs clock/CPU
    # time around the anchor loop), plus the pairs/s rate
    dt = time.perf_counter() - clock_t0
    n_pairs = (
        int(np.sum(num_snp - 1 - anchors)) if triangular
        else len(anchors) * num_snp
    )
    logger.info("Exact scan: %d anchors, %d tests, %d hits in %.3f s "
                "(%.3g pairs/s)", len(anchors), n_pairs, n_hits, dt,
                n_pairs / max(dt, 1e-9))
    # the pair-variance GEMM (pvp @ E, 2*n^2*m per padded anchor) dominates
    # the exact scan's FLOPs — the roofline SURVEY §3.3 names north-star
    n = mat0.shape[0]
    log_phase("exact_scan", float(n_tiles_pad * tile)
              * (2.0 * n * n + 4.0 * n) * mat1.shape[1], dt, items=n_pairs,
              precision="f64" if mat0.dtype == np.float64 else "f32")
    return 0


_CODINGS = {
    "AA": (additive_code, additive_code, True),
    "AD": (additive_code, dominance_code, False),
    "DD": (dominance_code, dominance_code, True),
}


_CODING_KINDS = {"AA": ("add", "add"), "AD": ("add", "dom"),
                 "DD": ("dom", "dom")}


def _epi_setup(pheno_file, bed_prefix, gmat_lst, var_com, kind):
    """Pipeline-stage setup with identity caches: the approx pipelines run
    calibrate -> screen -> exact re-test against the SAME phenotype, GRMs,
    variance components, and panel (reference remma_epiAA_approx.py:10-53);
    the design parse, the O(n³) score-piece inverse, and the (n, m) coded
    panels are each computed once and reused across the stages."""
    from gmat_tpu.scan.common import (coded_matrix, design_matrix_cached,
                                      prepare_genotypes_device,
                                      score_pieces_cached)

    k0, k1 = _CODING_KINDS[kind]
    triangular = _CODINGS[kind][2]
    dm = design_matrix_cached(pheno_file, bed_prefix)
    pieces = score_pieces_cached(dm, gmat_lst, var_com)
    g, num_snp = prepare_genotypes_device(bed_prefix)
    mat0 = coded_matrix(g, k0)
    mat1 = coded_matrix(g, k1)
    return mat0, mat1, pieces, num_snp, triangular


def _validate_anchors(snp_lst_0, num_snp, triangular):
    hi = num_snp - 1 if triangular else num_snp
    if snp_lst_0 is None:
        return range(hi)
    if max(snp_lst_0) >= hi or min(snp_lst_0) < 0:
        raise ValueError("snp_lst_0 is out of range!")
    return snp_lst_0


def _remma_epi(kind, pheno_file, bed_prefix, gmat_lst, var_com, snp_lst_0,
               p_cut, out_file, tile=None, mesh=None):
    mat0, mat1, pieces, num_snp, triangular = _epi_setup(
        pheno_file, bed_prefix, gmat_lst, var_com, kind
    )
    snp_lst_0 = _validate_anchors(snp_lst_0, num_snp, triangular)
    return _scan_anchors(mat0, mat1, pieces, snp_lst_0, num_snp, triangular,
                         p_cut, out_file, tile=tile, mesh=mesh)


def remma_epiAA(pheno_file, bed_prefix, gmat_lst, var_com, snp_lst_0=None,
                p_cut=1.0e-5, out_file="epiAA", mesh=None):
    """Exhaustive additive x additive scan (strict upper triangle)."""
    return _remma_epi("AA", pheno_file, bed_prefix, gmat_lst, var_com,
                      snp_lst_0, p_cut, out_file, mesh=mesh)


def remma_epiAD(pheno_file, bed_prefix, gmat_lst, var_com, snp_lst_0=None,
                p_cut=1.0e-5, out_file="epiAD", mesh=None):
    """Exhaustive additive x dominance scan (full ordered rectangle)."""
    return _remma_epi("AD", pheno_file, bed_prefix, gmat_lst, var_com,
                      snp_lst_0, p_cut, out_file, mesh=mesh)


def remma_epiDD(pheno_file, bed_prefix, gmat_lst, var_com, snp_lst_0=None,
                p_cut=1.0e-5, out_file="epiDD", mesh=None):
    """Exhaustive dominance x dominance scan (strict upper triangle)."""
    return _remma_epi("DD", pheno_file, bed_prefix, gmat_lst, var_com,
                      snp_lst_0, p_cut, out_file, mesh=mesh)


def balanced_anchor_split(num_snp: int, n_parts: int, part: int,
                          triangular: bool = True) -> list[int]:
    """Balanced triangular anchor split for manual multi-machine sharding.

    Pairs block (part-1) with block (2*n_parts - part) so every worker sees
    the same pair count (reference remma_epiAA.py:126-137; the AD variant
    caps at num_snp instead of num_snp-1, remma_epiAD.py:133-142).
    """
    num_snp_part = num_snp // (2 * n_parts)
    p0 = (part - 1) * num_snp_part
    p1 = part * num_snp_part
    p2 = (2 * n_parts - part) * num_snp_part
    p3 = (2 * n_parts - part + 1) * num_snp_part
    if part == 1:
        p3 = num_snp - 1 if triangular else num_snp
    return list(range(p0, p1)) + list(range(p2, p3))


def _remma_epi_parallel(kind, pheno_file, bed_prefix, gmat_lst, var_com,
                        parallel, p_cut, out_file):
    num_snp = count_records(bed_prefix + ".bim")
    triangular = _CODINGS[kind][2]
    snp_lst_0 = balanced_anchor_split(num_snp, parallel[0], parallel[1],
                                      triangular=triangular)
    logger.info("Parallel part %d/%d: %d anchors", parallel[1], parallel[0],
                len(snp_lst_0))
    return _remma_epi(kind, pheno_file, bed_prefix, gmat_lst, var_com,
                      snp_lst_0, p_cut, f"{out_file}.{parallel[1]}")


def remma_epiAA_parallel(pheno_file, bed_prefix, gmat_lst, var_com, parallel,
                         p_cut=1.0e-5, out_file="epiAA_parallel"):
    return _remma_epi_parallel("AA", pheno_file, bed_prefix, gmat_lst,
                               var_com, parallel, p_cut, out_file)


def remma_epiAD_parallel(pheno_file, bed_prefix, gmat_lst, var_com, parallel,
                         p_cut=1.0e-5, out_file="epiAD_parallel"):
    return _remma_epi_parallel("AD", pheno_file, bed_prefix, gmat_lst,
                               var_com, parallel, p_cut, out_file)


def remma_epiDD_parallel(pheno_file, bed_prefix, gmat_lst, var_com, parallel,
                         p_cut=1.0e-5, out_file="epiDD_parallel"):
    return _remma_epi_parallel("DD", pheno_file, bed_prefix, gmat_lst,
                               var_com, parallel, p_cut, out_file)


def _pair_kernel_mesh(mesh, cols0, cols1, mat0, mat1, pymat, pvpmat):
    """Pair test with the pair list sharded over the device mesh (codings
    and pymat/pvpmat replicated); same math as `_pair_kernel`, byte-identical
    output.  The caller pads the pair list to a mesh-size multiple."""
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from gmat_tpu.dist.mesh import AXIS

    @partial(jax.jit, out_shardings=NamedSharding(mesh, P()))
    @partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(AXIS), P(AXIS), P(None, None), P(None, None), P(None),
                  P(None, None)),
        out_specs=(P(AXIS),) * 4,
    )
    def kernel(c0, c1, m0, m1, py, pvp):
        e = m0[:, c0] * m1[:, c1]  # (n, B_local)
        eff = e.T @ py
        var = jnp.sum(e * (pvp @ e), axis=0)
        chi = eff * eff / var
        return eff, var, chi, chi2_sf(chi, 1)

    return kernel(cols0, cols1, mat0, mat1, pymat, pvpmat)


def _remma_epi_pair(kind, pheno_file, bed_prefix, gmat_lst, var_com,
                    snp_pair_file, max_test_pair, p_cut, out_file, mesh=None):
    """Exact test for an explicit pair list, chunked max_test_pair at a time
    (reference remma_epiAA_pair.py:16-92)."""
    mat0, mat1, pieces, num_snp, _ = _epi_setup(
        pheno_file, bed_prefix, gmat_lst, var_com, kind
    )
    # a header-only pair file (a screen with zero survivors is a normal
    # outcome for strict cuts) gives an empty, header-only result
    pairs = read_int_pairs(snp_pair_file)
    if pairs.size and (pairs.max() > num_snp - 1 or pairs.min() < 0):
        raise ValueError("snp_pair is out of range!")
    ndev = int(mesh.devices.size) if mesh is not None else 1
    # canonical chunk width, identical on every path: the batch width
    # changes the BLAS accumulation strategy and hence the last ulp of
    # var/chi, so EVERY chunk (single-device and per-device) is padded to
    # the same width — mesh output stays byte-identical to single-device
    width = max_test_pair
    if len(pairs):
        width = min(max_test_pair,
                    max(8, 1 << int(len(pairs) - 1).bit_length()))
    np.savetxt(out_file, [_HEADER_PAIR], fmt="%s")

    def flush(fout, chunk, outs):
        # ONE transfer for all four result vectors
        eff, var, chi, p = (np.asarray(a)[: len(chunk)]
                            for a in jax.device_get(outs))
        keep = p < p_cut
        write_rows(fout, chunk[keep, 0].astype(np.int64),
                   chunk[keep, 1].astype(np.int64), eff[keep], var[keep],
                   chi[keep], p[keep])

    # sliding dispatch window: chunks enqueue ahead of the fetches so each
    # chunk's device->host transfer and host-side text append overlap the
    # next chunks' compute on the async queue; results flush in dispatch
    # order, so the file contract is unchanged
    window = 8
    pending: list = []
    with open(out_file, "a") as fout:
        step = width * ndev if mesh is not None else width
        for start in range(0, len(pairs), step):
            chunk = pairs[start:start + step]
            npad = (-len(chunk)) % step
            cpad = np.concatenate([chunk, np.repeat(chunk[-1:], npad, 0)])
            if mesh is not None:
                outs = _pair_kernel_mesh(
                    mesh, jnp.asarray(cpad[:, 0]), jnp.asarray(cpad[:, 1]),
                    mat0, mat1, pieces.pymat, pieces.pvpmat)
            else:
                outs = _pair_kernel(
                    jnp.asarray(cpad[:, 0]), jnp.asarray(cpad[:, 1]),
                    mat0, mat1, pieces.pymat, pieces.pvpmat)
            pending.append((chunk, outs))
            if len(pending) >= window:
                flush(fout, *pending.pop(0))
        for chunk, outs in pending:
            flush(fout, chunk, outs)
    return 0


def remma_epiAA_pair(pheno_file, bed_prefix, gmat_lst, var_com, snp_pair_file,
                     max_test_pair=50000, p_cut=1.0e-4, out_file="epiAA_pair",
                     mesh=None):
    return _remma_epi_pair("AA", pheno_file, bed_prefix, gmat_lst, var_com,
                           snp_pair_file, max_test_pair, p_cut, out_file,
                           mesh=mesh)


def remma_epiAD_pair(pheno_file, bed_prefix, gmat_lst, var_com, snp_pair_file,
                     max_test_pair=50000, p_cut=1.0e-4, out_file="epiAD_pair",
                     mesh=None):
    return _remma_epi_pair("AD", pheno_file, bed_prefix, gmat_lst, var_com,
                           snp_pair_file, max_test_pair, p_cut, out_file,
                           mesh=mesh)


def remma_epiDD_pair(pheno_file, bed_prefix, gmat_lst, var_com, snp_pair_file,
                     max_test_pair=50000, p_cut=1.0e-4, out_file="epiDD_pair",
                     mesh=None):
    return _remma_epi_pair("DD", pheno_file, bed_prefix, gmat_lst, var_com,
                           snp_pair_file, max_test_pair, p_cut, out_file,
                           mesh=mesh)
