"""Multi-chip sharding for GRM construction, REML, and the pair scans.

The reference's "distributed backend" is manual multi-machine sharding with
file merges (SURVEY.md §2.2; remma_epiAA.py:126-140, README.md:125-204).
Here the same parallel axes map onto a `jax.sharding.Mesh`:

- GRM (K = M Mᵀ / scale): genotype columns (SNPs) sharded over the mesh —
  each device holds full individuals x local SNPs, centers locally, computes
  a partial Gram matrix, and a `psum` reduces to the replicated K.
  (The reference relies on one machine's BLAS threads, gmatrix.py:63.)
- Pair scans / screens: the anchor-SNP axis is data-parallel over devices —
  the balanced triangular split of the reference becomes an interleaved
  anchor assignment (device d takes anchors d, d+D, d+2D, ... whose partner
  counts average out); partner matrix and pymat/pvpmat are replicated;
  per-device fixed-capacity hit buffers replace the reference's per-machine
  output files + concatenation.
- REML: V is (n_rec x n_rec) and its Cholesky dominates; it stays replicated
  (n_rec is small), while the ZG_iZᵀ prep and trace terms shard naturally.

All entry points take an explicit mesh so tests can use the virtual 8-device
CPU mesh and the driver's `dryrun_multichip` can validate any device count.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from gmat_tpu.core.stats import chi2_sf

AXIS = "d"


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    return jax.make_mesh((len(devices),), (AXIS,), devices=devices)


def _pad_cols(arr: np.ndarray, mult: int) -> np.ndarray:
    pad = (-arr.shape[1]) % mult
    if pad:
        arr = np.concatenate([arr, np.zeros((arr.shape[0], pad), arr.dtype)], 1)
    return arr


def _sharded_grm(geno: np.ndarray, mesh: Mesh, small_val: float, kind: str):
    """GRM over the mesh: SNP columns sharded, one psum.

    Matches `gmat_tpu.grm.{additive,dominance}_grm` (reference
    gmatrix.py:53-66 / :116-127) numerically: per-column freq/centering is
    local because every device owns whole columns; only `scale` and the Gram
    partial need the collective."""
    ndev = mesh.devices.size
    geno_p = _pad_cols(np.asarray(geno), ndev)

    @partial(jax.jit, out_shardings=NamedSharding(mesh, P()))
    @partial(jax.shard_map, mesh=mesh, in_specs=P(None, AXIS), out_specs=P())
    def kernel(g):
        n = g.shape[0]
        freq = jnp.sum(g, axis=0) / (2.0 * n)
        # padded columns are all-zero -> freq 0 -> centered value 0, scale 0
        is_real = jnp.any(g != 0.0, axis=0)
        sv = 2.0 * freq * (1.0 - freq)
        if kind == "add":
            scale_part = jnp.where(is_real, sv, 0.0)
            cen = jnp.where(is_real[None, :], g - 2.0 * freq[None, :], 0.0)
        else:
            scale_part = jnp.where(is_real, sv * (1.0 - sv), 0.0)
            het = jnp.where(g > 1.5, 0.0, g)
            cen = jnp.where(is_real[None, :], het - sv[None, :], 0.0)
        scale = jax.lax.psum(jnp.sum(scale_part), AXIS)
        return jax.lax.psum(cen @ cen.T, AXIS) / scale

    kin = kernel(jnp.asarray(geno_p))
    diag = jnp.diag(kin) * (1.0 + small_val)
    return kin.at[jnp.diag_indices_from(kin)].set(diag)


def sharded_additive_grm(geno: np.ndarray, mesh: Mesh, small_val: float = 0.001):
    return _sharded_grm(geno, mesh, small_val, "add")


def sharded_dominance_grm(geno: np.ndarray, mesh: Mesh, small_val: float = 0.001):
    return _sharded_grm(geno, mesh, small_val, "dom")


def interleaved_anchor_split(num_snp: int, ndev: int) -> np.ndarray:
    """(ndev, ceil/...) anchor assignment: device d gets anchors d::ndev.

    Interleaving balances the triangular partner counts to within one row —
    the mesh-native analog of the reference's block-paired split
    (remma_epiAA.py:126-137).  Padded entries repeat the last anchor and are
    masked out by the caller.
    """
    anchors = np.arange(num_snp - 1)
    per = -(-len(anchors) // ndev)
    out = np.full((ndev, per), anchors[-1], dtype=np.int32)
    for d in range(ndev):
        chunk = anchors[d::ndev]
        out[d, : len(chunk)] = chunk
    return out


def sharded_screen_counts(mat: np.ndarray, pymat: np.ndarray, cut: float,
                          mesh: Mesh, tile: int = 256):
    """Device-parallel AA effect screen returning per-anchor hit counts.

    Each device sweeps its interleaved anchor subset against the replicated
    partner matrix; the (num_snp-1,) hit-count vector comes back sharded and
    is summed on host.  The screen GEMM S = (A ⊙ py)ᵀ B is identical to the
    single-chip path (scan/screen.py)."""
    from gmat_tpu.scan.screen import _screen_slack, _sdot

    num_snp = mat.shape[1]
    ndev = mesh.devices.size
    assign = interleaved_anchor_split(num_snp, ndev)

    cut = float(cut) * (1.0 - _screen_slack())

    # replicated output: on a multi-process cluster a sharded result spans
    # non-addressable devices and the host could not fetch it
    @partial(jax.jit, out_shardings=NamedSharding(mesh, P()))
    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(AXIS, None), P(None, None), P(None)),
        out_specs=P(AXIS, None),
    )
    def kernel(anchor_ids, m, py):
        anchor_ids = anchor_ids[0]  # (per,)
        per = anchor_ids.shape[0]
        j_ids = jnp.arange(m.shape[1])[None, :]
        nt = -(-per // tile)
        padded = jnp.pad(anchor_ids, (0, nt * tile - per), mode="edge")

        def count_tile(start):
            ids = jax.lax.dynamic_slice_in_dim(padded, start, tile)
            a = m[:, ids]
            s = _sdot((a * py[:, None]).T, m)
            hit = (jnp.abs(s) > cut) & (j_ids > ids[:, None])
            return jnp.sum(hit, axis=1)

        counts = jax.lax.map(count_tile, jnp.arange(nt) * tile)
        return counts.reshape(-1)[:per][None, :]

    counts = kernel(jnp.asarray(assign), jnp.asarray(mat), jnp.asarray(pymat))
    counts = np.asarray(counts)  # (ndev, per)
    total = np.zeros(num_snp - 1, dtype=np.int64)
    for d in range(ndev):
        chunk = np.arange(num_snp - 1)[d::ndev]
        total[chunk] = counts[d, : len(chunk)]
    return total


def sharded_screen_hits(mat: np.ndarray, pymat: np.ndarray, cut: float,
                        mesh: Mesh, tile: int = 256):
    """Full device-parallel AA screen: counts over the mesh, then hits.

    Phase 1 reuses `sharded_screen_counts` (each device sweeps its interleaved
    anchors). Phase 2 extracts hits only for the (rare) anchors with a
    non-zero count, its hot-tile work list itself sharded over the mesh —
    the deterministic replacement for the reference's per-machine output
    files + concatenation (README.md:191-204).  Hits are returned sorted by
    (i, j) so the merged table is byte-stable across topologies."""
    import jax.numpy as jnp

    from gmat_tpu.scan.screen import _run_screen

    counts = sharded_screen_counts(mat, pymat, cut, mesh, tile=tile)
    hot = np.nonzero(counts)[0]
    if len(hot) == 0:
        return (np.empty(0, np.int64),) * 2 + (np.empty(0, np.float32),)
    bins = np.zeros(mat.shape[1], dtype=np.int64)
    table = np.full(111, float(cut), dtype=np.float32)
    i0, i1, eff = _run_screen(jnp.asarray(mat, dtype=jnp.float32),
                              jnp.asarray(mat, dtype=jnp.float32),
                              jnp.asarray(pymat, dtype=jnp.float32),
                              hot, bins, bins, table, "tri",
                              min(tile, len(hot)), mesh=mesh)
    order = np.lexsort((i1, i0))
    return i0[order], i1[order], eff[order]


def sharded_exact_scan_tile(anchor_block: np.ndarray, mat: np.ndarray,
                            pymat: np.ndarray, pvpmat: np.ndarray, mesh: Mesh):
    """One data-parallel exact-scan step: (ndev*TA,) anchors -> eff/chi/p.

    The anchors are sharded over the mesh; mat/pymat/pvpmat replicated.  This
    is the multi-chip version of scan/pairs._anchor_tile_kernel and the unit
    the dryrun compiles."""

    @partial(jax.jit, out_shardings=NamedSharding(mesh, P(AXIS, None)))
    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(AXIS), P(None, None), P(None), P(None, None)),
        out_specs=P(AXIS, None),
    )
    def kernel(anchors, m, py, pvp):
        def one(a_col):
            e = m[:, a_col][:, None] * m
            eff = e.T @ py
            var = jnp.sum(e * (pvp @ e), axis=0)
            return eff, var

        eff, var = jax.vmap(one)(anchors)
        chi = eff * eff / var
        return chi  # (TA_local, m)

    chi = kernel(jnp.asarray(anchor_block), jnp.asarray(mat),
                 jnp.asarray(pymat), jnp.asarray(pvpmat))
    return chi2_sf(chi, 1)
