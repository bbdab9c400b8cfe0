#!/usr/bin/env python
"""Benchmark of the production epiAA effect screen and the paths around it.

Measures `gmat_tpu.scan.screen._run_screen` — the exact code path every
`remma_epi*_eff` / `remma_epi*_approx` call runs (one fused sweep that
counts AND extracts per-visit hits, fetching O(hits) bytes; dense visits
escalate to a tier-2 re-dispatch before the legacy two-phase engine) — at
a threshold that yields real hits, on a mouse-sized cohort (n=1304) with a
synthetic 262144-SNP panel (34.4G pairs), the accelerator counterpart of
the reference's C/OpenMP `remma_epiAA_eff_cpu` kernel
(_remma_epi_eff_cpu.c:91-137).

Secondary metrics (in the JSON line's "extra" field):
  - screen_gemm_ceiling_pairs_per_s / yeast_gemm_ceiling_pairs_per_s: the
    same sweep's GEMMs with a no-hit cut and no extraction, at the
    262144-SNP and the yeast shape — the most a fused GEMM + threshold +
    compaction kernel could gain over the production screen
  - yeast_screen_pairs_per_s: production screen at the reference's yeast
    shape (n=4168, m=28220; README.md:1626's 398M-pair workload)
  - exact_scan_pairs_per_s / exact_scan_tflops: the exhaustive exact scan
    (eff + variance GEMM + on-device compaction, scan/pairs.py) at mouse
    shape, all 989,121 pairs, f32
  - reml, bigpanel, longwas and the yeast approx pipeline end to end.

Runs on the default JAX device and refuses the CPU.  Times are medians of
REPS runs after a warm-up call (compilation is set-up, not timed); every
result ends in a host fetch, so the device work is complete.  Any section
that fails makes the script exit non-zero after the others have run.

Prints the device, the card's name and power limit, and then ONE JSON
line:
  {"metric": ..., "value": N, "unit": "pairs/s", "device": {...},
   "extra": {...}}
"""
from __future__ import annotations

import json
import logging
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).parent

N_ID = 1304
N_SNP = 262144
TILE = 4096
REPS = 5  # per-rep times are MEDIAN-combined, so one slow rep does not
# drag the recorded rate

logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                    format="bench: %(message)s")
log = logging.getLogger("bench")


def _panel(rng, n, m):
    freqs = rng.uniform(0.05, 0.95, size=m)
    geno = rng.binomial(2, freqs[None, :], size=(n, m)).astype(np.float32)
    p_hat = geno.sum(0) / (2 * n)
    return np.asarray(geno - 2 * p_hat[None, :], dtype=np.float32)


def _screen_cut(mat, py, hit_frac):
    """|eff| threshold hitting ~hit_frac of pairs: eff_ij = sum_k m_ik m_jk
    py_k is ~normal with var ~= (sum py^2/n) * v_i * v_j; use the mean
    column moment and the normal quantile."""
    from scipy.stats import norm

    v = float(np.mean(np.mean(mat * mat, axis=0)))
    sig = np.sqrt(np.sum(py * py) / py.size) * v * np.sqrt(mat.shape[0])
    return float(norm.isf(hit_frac / 2) * sig)


def bench_production_screen(jnp, mat, py, n_snp, tile, hit_frac=2e-7):
    """End-to-end `_run_screen` wall-clock: phase-1 counts + phase-2
    extraction + host-side assembly, exactly as remma_epiAA_eff runs it."""
    from gmat_tpu.scan.screen import _run_screen

    m = mat.shape[1]
    anchors = np.arange(m - 1, dtype=np.int32)
    bins = np.zeros(m, dtype=np.int64)
    cut = _screen_cut(np.asarray(mat), np.asarray(py), hit_frac)
    table = np.full(111, cut)
    kw = dict(mask_mode="tri", tile=tile)
    i0, j0, e0 = _run_screen(mat, mat, py, anchors, bins, bins, table, **kw)
    n_hits = len(i0)
    log.info("production screen warmup: %d hits at cut %.4g", n_hits, cut)
    times = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        i0, j0, e0 = _run_screen(mat, mat, py, anchors, bins, bins, table,
                                 **kw)
        times.append(time.perf_counter() - t0)
    dt = float(np.median(times))
    assert len(i0) == n_hits and n_hits > 0
    pairs = m * (m - 1) // 2
    return pairs / dt, n_hits


def bench_gemm_ceiling(jax, jnp, mat_d, py_d, tile=TILE):
    """The production sweep's GEMMs alone: the same (anchor-tile,
    partner-tile) worklist and screen precision, a cut so high nothing
    hits and no extraction — the screen's ceiling on this device."""
    from gmat_tpu.scan.screen import _sdot, _tile_worklist

    m = mat_d.shape[1]
    m_pad = -(-m // tile) * tile
    if m_pad != m:  # zero columns never pass the cut
        mat_d = jnp.pad(mat_d, ((0, 0), (0, m_pad - m)))
    cut = np.float32(1.0e9)
    work = jnp.asarray(
        _tile_worklist(np.arange(m_pad, dtype=np.int32), m_pad, "tri", tile))
    jt = jnp.arange(tile, dtype=jnp.int32)

    @jax.jit
    def screen_all(mm, py_):
        a_scaled = mm * py_[:, None]

        def pair_fn(tp):
            t, pt = tp[0] * tile, tp[1] * tile
            a = jax.lax.dynamic_slice_in_dim(a_scaled, t, tile, axis=1)
            b = jax.lax.dynamic_slice_in_dim(mm, pt, tile, axis=1)
            s = _sdot(a.T, b)
            valid = (pt + jt)[None, :] > (t + jt)[:, None]
            return jnp.sum((jnp.abs(s) > cut) & valid)

        return jnp.sum(jax.lax.map(pair_fn, work))

    total = int(screen_all(mat_d, py_d))  # compile + warmup
    times = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        total = int(screen_all(mat_d, py_d))
        times.append(time.perf_counter() - t0)
    dt = float(np.median(times))
    assert total == 0
    return (m * (m - 1) // 2) / dt


def bench_yeast_screen(jax, jnp, rng):
    """Production screen and its GEMM ceiling at the reference's yeast
    shape: n=4168, m=28220, 398,170,090 pairs.  Returns (production
    pairs/s, hits, ceiling pairs/s)."""
    n, m = 4168, 28220
    mat = jnp.asarray(_panel(rng, n, m))
    py = jnp.asarray((rng.standard_normal(n) * 0.1).astype(np.float32))
    rate, hits = bench_production_screen(jnp, mat, py, m, 4096,
                                         hit_frac=2e-5)
    return rate, hits, bench_gemm_ceiling(jax, jnp, mat, py, 4096)


def bench_bigpanel(jax, jnp, m_log2=20, hit_frac=1e-7):
    """Production screen at a >=1M-SNP panel: the
    reference's whole multi-machine workflow exists because real REMMAX
    panels are millions of SNPs (C kernel: no panel-size limit,
    _remma_epi_eff_cpu.c:125-137).  m=2^20 x n=1304 = 5.497e11 pairs on
    one device; the panel is generated ON-DEVICE (a 5.5 GB host upload
    would time the host link, not the screen).  Returns (pairs/s, n_hits,
    peak_device_bytes)."""
    sys.path.insert(0, str(ROOT / "tools"))
    import stress_bigpanel as sb

    return sb.run(m_log2=m_log2, hit_frac=hit_frac, reps=1)


def bench_exact_scan(jax, jnp, rng):
    """Exhaustive exact scan at mouse shape: eff + pair-variance GEMM +
    on-device chi/p threshold compaction (scan/pairs.py), all 989,121
    pairs.  Returns (pairs/s, achieved TF/s on the variance GEMM)."""
    from gmat_tpu.scan.pairs import _anchor_tiles_batch

    n, m = 1304, 1407
    mat = jnp.asarray(_panel(rng, n, m))
    py = jnp.asarray((rng.standard_normal(n) * 0.1).astype(np.float32))
    a = rng.standard_normal((n, n)).astype(np.float32) * 0.01
    pvp = jnp.asarray(a @ a.T + np.eye(n, dtype=np.float32))
    tile = 128
    anchors = np.arange(m - 1, dtype=np.int32)
    n_tiles = -(-len(anchors) // tile)
    padded = np.pad(anchors, (0, n_tiles * tile - len(anchors)),
                    constant_values=anchors[-1])
    avalid = jnp.asarray(np.arange(len(padded)) < len(anchors))
    padded_d = jnp.asarray(padded)
    tstarts = jnp.asarray(np.arange(n_tiles, dtype=np.int32) * tile)
    chi_crit = jnp.asarray(50.0, dtype=jnp.float32)  # ~p<1e-12: few hits

    def run():
        out = _anchor_tiles_batch(tstarts, padded_d, avalid, mat, mat, py,
                                  pvp, chi_crit, True, tile, 4096)
        return int(np.asarray(out[0]).sum())

    run()  # compile + warmup
    times = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        run()
        times.append(time.perf_counter() - t0)
    dt = float(np.median(times))
    pairs = m * (m - 1) // 2
    # FLOPs: per padded anchor, pvp@E is 2*n^2*m; eff and the colsum add
    # 4*n*m more (negligible)
    flops = n_tiles * tile * (2.0 * n * n * m + 4.0 * n * m)
    return pairs / dt, flops / dt / 1e12


def bench_reml_mixed(jax, jnp, rng):
    """Mixed-precision REML iteration at the yeast repeated-measures shape
    (n_rec=6435, n_id=4168, gmat_lst=[ag, ag*ag, pe]):
    f32 Cholesky + split-precision Newton refinement on the device vs the
    host CPU f64 step the reference's numpy path corresponds to.  Returns
    (device_iter_s, cpu_iter_s)."""
    from gmat_tpu.reml.wemai import _reml_step

    n_id, n_rec, m = 4168, 6435, 2048
    geno = rng.binomial(2, rng.uniform(0.1, 0.9, size=m)[None, :],
                        size=(n_id, m)).astype(np.float32)
    extra_rec = rng.integers(0, n_id, size=n_rec - n_id)
    rec_ids = np.sort(np.concatenate([np.arange(n_id), extra_rec]))
    rec_ids = rec_ids.astype(np.int32)
    y = rng.standard_normal(n_rec)
    xmat = np.column_stack([np.ones(n_rec), rng.standard_normal(n_rec)])
    var0 = np.array([0.5, 0.3, 0.5, 1.0])

    @jax.jit
    def build_zg(g32, rec):
        p = jnp.mean(g32, axis=0) / 2.0
        mcen = g32 - 2.0 * p[None, :]
        scale = jnp.sum(2.0 * p * (1.0 - p))
        ag = ((mcen @ mcen.T) / scale).astype(jnp.float64)
        pe = jnp.eye(n_id, dtype=jnp.float64)
        stack = jnp.stack([ag, ag * ag, pe])
        return stack[:, rec[:, None], rec[None, :]]

    def run(device, mixed, reps):
        with jax.default_device(device):
            zg = build_zg(jnp.asarray(geno), jnp.asarray(rec_ids))
            y_d, x_d = jnp.asarray(y), jnp.asarray(xmat)
            var = jnp.asarray(var0)
            out = _reml_step(var, y_d, x_d, zg, mixed=mixed)
            np.asarray(out[0])  # compile + warmup fetch
            t0 = time.perf_counter()
            var = jnp.asarray(var0)
            for _ in range(reps):
                out = _reml_step(var, y_d, x_d, zg, mixed=mixed)
                var = jnp.asarray(np.asarray(out[0]))  # host round-trip,
                # exactly as the wemai_reml driver iterates
            return (time.perf_counter() - t0) / reps

    dev_iter = run(jax.devices()[0], True, 3)
    log.info("reml mixed step (%s): %.3f s/iter at n_rec=%d",
             jax.devices()[0].device_kind, dev_iter, n_rec)
    cpu_iter = run(jax.devices("cpu")[0], False, 1)
    log.info("reml f64 step (host CPU): %.3f s/iter", cpu_iter)
    return dev_iter, cpu_iter


def bench_yeast_approx(jax, jnp, rng):
    """The FLAGSHIP pipeline end-to-end at the yeast shape:
    remma_epiAA_approx = 100k-random-pair calibration -> fused screen of
    398M pairs -> exact re-test of survivors -> merge, via the same
    file-level API a user calls.  Returns (wall_s, n_result_rows)."""
    import tempfile

    from gmat_tpu.grm.grm import additive_grm
    from gmat_tpu.io.bed import write_bed
    from gmat_tpu.scan.screen import remma_epiAA_approx

    n, m = 4168, 28220
    geno = rng.binomial(2, rng.uniform(0.05, 0.95, size=m)[None, :],
                        size=(n, m)).astype(np.float32)
    with tempfile.TemporaryDirectory() as td:
        prefix = str(Path(td) / "plink")
        write_bed(prefix, geno.astype(np.float64))
        yvec = rng.standard_normal(n)
        with open(prefix + ".fam") as fam, \
                open(Path(td) / "pheno", "w") as f:
            for line, yv in zip(fam, yvec):
                f0, i0 = line.split()[:2]
                f.write(f"{f0} {i0} 1 {yv:.8f}\n")
        ag = np.asarray(
            additive_grm(jnp.asarray(geno)).astype(jnp.float64))
        out = str(Path(td) / "epiAA_approx")
        t0 = time.perf_counter()
        remma_epiAA_approx(str(Path(td) / "pheno"), prefix, [ag, ag * ag],
                           [0.4, 0.1, 0.6], p_cut=1e-5,
                           num_random_pair=100000, out_file=out)
        dt = time.perf_counter() - t0
        # second call: device caches (genotype panel, GRMs, codings,
        # score pieces) warm — the steady state of a multi-trait /
        # multi-scan session against one panel
        t0 = time.perf_counter()
        remma_epiAA_approx(str(Path(td) / "pheno"), prefix, [ag, ag * ag],
                           [0.4, 0.1, 0.6], p_cut=1e-5,
                           num_random_pair=100000, out_file=out)
        dt_warm = time.perf_counter() - t0
        with open(out) as f:
            rows = sum(1 for _ in f) - 1
    from gmat_tpu.scan import screen as screen_mod

    stages = dict(screen_mod.LAST_APPROX_STAGES)
    log.info("yeast approx end-to-end: %.1f s cold / %.1f s warm, %d "
             "result rows; warm stages %s", dt, dt_warm, rows, stages)
    return dt, rows, stages, dt_warm


def bench_longwas(jax, jnp):
    """Longitudinal GWAS on-chip: balance fixed + trans at
    the full mouse_long scale (1212 ids x 11,833 SNPs, 16 timepoints,
    forder=3 — the reference's own fixture workload).  The fixed test is
    11,833 vmapped 10-iteration REMLs; trans is a handful of einsums per
    1024-SNP batch.  float64 ('auto'), golden-gated at the documented
    bands (tests/test_longwas_balance_gwas.py).
    Returns (fixed_snps_per_s, trans_snps_per_s)."""
    import shutil
    import tempfile

    import pandas as pd

    from gmat_tpu.grm.grm import agmat
    from gmat_tpu.longwas.balance_gwas import (balance_longwas_fixed,
                                               balance_longwas_trans)

    ml = ROOT / "tests" / "data" / "mouse_long"
    g = np.load(ROOT / "tests" / "golden" / "longwas_balance_var.npz")
    var_df = pd.DataFrame({k: g[k]
                           for k in ("vari", "varij", "varik", "var_val")})
    tp = np.arange(16) + 1.0
    trait = list(range(2, 18))
    with tempfile.TemporaryDirectory() as td:
        prefix = str(Path(td) / "plink")
        for ext in (".bed", ".bim", ".fam"):
            shutil.copy(str(ml / ("plink" + ext)), prefix + ext)
        agmat(prefix, inv=False, out_fmt="id_id_val")
        args = (str(ml / "phe.balance.txt"), "ID", tp, trait,
                prefix + ".agrm2", prefix, var_df)

        def timed(fn, label, **kw):
            # cold call absorbs the batch-program compiles; the warm call
            # is the steady state (a permutation/multi-trait session runs
            # the same programs hundreds of times)
            t0 = time.perf_counter()
            res = fn(*args, **kw)
            cold = time.perf_counter() - t0
            t0 = time.perf_counter()
            res = fn(*args, **kw)
            warm = time.perf_counter() - t0
            log.info("longwas %s: %d SNPs in %.2f s warm / %.2f s cold "
                     "(%.3g SNPs/s)", label, len(res), warm, cold,
                     len(res) / warm)
            return len(res), warm

        n_snp, trans_s = timed(balance_longwas_trans, "trans",
                               prefix_outfile=str(Path(td) / "trans"))
        n_f, fixed_s = timed(balance_longwas_fixed, "fixed (10-iter REML)",
                             snp_batch=256,
                             prefix_outfile=str(Path(td) / "fixed"))
        assert n_f == n_snp
    return n_snp / fixed_s, n_snp / trans_s


def main():
    import traceback

    import jax
    import jax.numpy as jnp

    from gmat_tpu.config import use_compile_cache
    from gmat_tpu.core.roofline import card_name_and_power_limit

    dev = jax.devices()[0]
    if dev.platform == "cpu":
        sys.exit("bench.py measures an accelerator; JAX found only the CPU")
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": jax.device_count()}
    card = card_name_and_power_limit()
    log.info("device %s; card (name, power limit): %s", device, card)
    log.info("compilation cache: %s", use_compile_cache())

    rng = np.random.default_rng(0)
    mat = _panel(rng, N_ID, N_SNP)
    py = (rng.standard_normal(N_ID) * 0.1).astype(np.float32)
    mat_d = jax.device_put(jnp.asarray(mat))
    py_d = jax.device_put(jnp.asarray(py))

    extra = {}
    failed = []

    def section(name, fn):
        try:
            t0 = time.perf_counter()
            out = fn()
            log.info("%s done in %.1f s (incl. compile)", name,
                     time.perf_counter() - t0)
            return out
        except Exception:  # run the other sections, then exit non-zero
            log.error("%s failed:\n%s", name, traceback.format_exc())
            failed.append(name)
            return None

    prod = section("production_screen",
                   lambda: bench_production_screen(jnp, mat_d, py_d, N_SNP,
                                                   TILE))
    if prod:
        extra["screen_hits"] = prod[1]
    ceiling = section("gemm_ceiling",
                      lambda: bench_gemm_ceiling(jax, jnp, mat_d, py_d))
    if ceiling:
        extra["screen_gemm_ceiling_pairs_per_s"] = ceiling
    yeast = section("yeast_screen",
                    lambda: bench_yeast_screen(jax, jnp, rng))
    if yeast:
        extra["yeast_screen_pairs_per_s"] = yeast[0]
        extra["yeast_screen_hits"] = yeast[1]
        extra["yeast_gemm_ceiling_pairs_per_s"] = yeast[2]
    exact = section("exact_scan", lambda: bench_exact_scan(jax, jnp, rng))
    if exact:
        extra["exact_scan_pairs_per_s"] = exact[0]
        extra["exact_scan_tflops"] = exact[1]
    reml = section("reml_mixed", lambda: bench_reml_mixed(jax, jnp, rng))
    if reml:
        extra["reml_mixed_iter_s"] = reml[0]
        extra["reml_cpu_f64_iter_s"] = reml[1]
    bigpanel = section("bigpanel", lambda: bench_bigpanel(jax, jnp))
    if bigpanel:
        extra["bigpanel_pairs_per_s"] = bigpanel[0]
        extra["bigpanel_hits"] = bigpanel[1]
        extra["bigpanel_peak_device_bytes"] = bigpanel[2]
    longwas = section("longwas", lambda: bench_longwas(jax, jnp))
    if longwas:
        extra["longwas_fixed_snps_per_s"] = longwas[0]
        extra["longwas_trans_snps_per_s"] = longwas[1]
    approx = section("yeast_approx",
                     lambda: bench_yeast_approx(jax, jnp, rng))
    if approx:
        extra["yeast_approx_end_to_end_s"] = approx[0]
        extra["yeast_approx_rows"] = approx[1]
        extra["yeast_approx_stages"] = approx[2]
        extra["yeast_approx_warm_s"] = approx[3]

    print(f"card: {card}")
    if failed:
        sys.exit(f"bench.py: failed sections: {', '.join(failed)}")
    print(json.dumps({
        "metric": "epiAA_production_screen_pairs_per_s",
        "value": prod[0],
        "unit": "pairs/s",
        "device": device,
        "extra": extra,
    }))


if __name__ == "__main__":
    main()
