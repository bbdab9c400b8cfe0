#!/usr/bin/env python
"""Production screen at a >=1M-SNP panel (VERDICT r4 #2).

The reference's multi-machine workflow exists because real REMMAX panels
are millions of SNPs (C kernel: no panel-size limit,
_remma_epi_eff_cpu.c:125-137; README.md:125-204).  This drives the SAME
`_run_screen` engine every `remma_epi*_eff/_approx` call runs at
m = 2^20 SNPs x n = 1304 ids = 5.497e11 pairs, single chip.

Design notes (all measured constraints):
- the panel is generated ON-DEVICE (a 5.5 GB host upload would time the
  host link, not the engine);
- tile=4096 keeps the worklist at ~33k visits; the fused per-visit
  index space is (tile, tile) so the legacy (tile*m < 2^31) ceiling
  does not apply;
- device-memory budget: panel 5.5 GB + scaled anchor gather 5.5 GB +
  chunk buffers ~1 GB (the engine materializes no sentinel-padded
  partner copy).

Run: python tools/stress_bigpanel.py [m_log2=20] [hit_frac=1e-7]
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

N_ID = 1304


def run(m_log2: int = 20, hit_frac: float = 1e-7, reps: int = 1):
    import jax
    import jax.numpy as jnp

    from scipy.stats import norm

    from gmat_tpu.config import use_compile_cache

    from gmat_tpu.scan.screen import _run_screen

    use_compile_cache()
    m = 1 << m_log2
    tile = 4096

    @jax.jit
    def gen(key):
        # genotype-like columns: one uniform draw gives binomial(2, p)
        # (P(g=2)=p^2, P(g>=1)=2p-p^2), centered per column
        k1, k2 = jax.random.split(key)
        p = jax.random.uniform(k1, (m,), jnp.float32, 0.05, 0.95)
        u = jax.random.uniform(k2, (N_ID, m), jnp.float32)
        g = ((u < p * p).astype(jnp.float32)
             + (u < 2 * p - p * p).astype(jnp.float32))
        return g - jnp.mean(g, axis=0)[None, :]

    mat = gen(jax.random.PRNGKey(0))
    py = jnp.asarray(
        (np.random.default_rng(1).standard_normal(N_ID) * 0.1)
        .astype(np.float32))
    # analytic cut for ~hit_frac of pairs (bench.py _screen_cut formula,
    # moments computed on-device)
    v = float(jnp.mean(mat * mat))
    sig = float(jnp.sqrt(jnp.sum(py * py) / N_ID)) * v * np.sqrt(N_ID)
    cut = float(norm.isf(hit_frac / 2) * sig)
    anchors = np.arange(m - 1, dtype=np.int32)
    bins = np.zeros(m, dtype=np.int64)
    table = np.full(111, cut, dtype=np.float32)

    times, n_hits = [], 0
    for rep in range(reps + 1):  # rep 0 = compile + warmup
        t0 = time.perf_counter()
        i0, j0, e0 = _run_screen(mat, mat, py, anchors, bins, bins, table,
                                 "tri", tile)
        dt = time.perf_counter() - t0
        n_hits = len(i0)
        print(f"rep {rep}: {dt:.2f} s, {n_hits} hits", flush=True)
        if rep:
            times.append(dt)
    dt = float(np.median(times))
    pairs = m * (m - 1) // 2
    stats = {}
    try:
        stats = jax.local_devices()[0].memory_stats() or {}
    except Exception:
        pass
    peak = stats.get("peak_bytes_in_use")
    print(f"bigpanel m={m}: {pairs / dt:.4g} pairs/s "
          f"({pairs:.4g} pairs in {dt:.2f} s), {n_hits} hits, "
          f"peak HBM {peak / 2**30:.2f} GiB" if peak else
          f"bigpanel m={m}: {pairs / dt:.4g} pairs/s in {dt:.2f} s, "
          f"{n_hits} hits (no memory stats)")
    return pairs / dt, n_hits, peak


if __name__ == "__main__":
    m_log2 = int(sys.argv[1]) if len(sys.argv) > 1 else 20
    frac = float(sys.argv[2]) if len(sys.argv) > 2 else 1e-7
    run(m_log2, frac)
