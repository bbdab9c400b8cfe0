"""Yeast-scale stress run: the reference's headline workload shape.

The reference yeast fixture is 4168 ids x 28220 SNPs = 398,170,090 epiAA
pairs (its .bed is absent upstream — SURVEY §6), so this generates a
synthetic panel of the same shape and runs the production screen (phase-1
counts + phase-2 extraction) end-to-end, verifying extracted hits against a
direct recomputation on sampled anchor rows.

    python tools/stress_yeast_scale.py                      # default device
    JAX_PLATFORMS=cpu python tools/stress_yeast_scale.py    # host CPU
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).parents[1]))

N_ID = 4168
N_SNP = 28220
TILE = 4096


def main():
    import jax.numpy as jnp

    from gmat_tpu.scan.screen import _run_screen

    rng = np.random.default_rng(0)
    freqs = rng.uniform(0.05, 0.95, size=N_SNP)
    geno = rng.binomial(2, freqs[None, :], size=(N_ID, N_SNP)).astype(np.float32)
    p_hat = geno.sum(0) / (2 * N_ID)
    mat = np.asarray(geno - 2 * p_hat[None, :], dtype=np.float32)
    py = (rng.standard_normal(N_ID) * 0.02).astype(np.float32)
    # pick a threshold that leaves a realistic survivor count (~1e-5 of pairs)
    sample = np.abs((mat[:, :512] * py[:, None]).T @ mat)
    cut = float(np.quantile(sample, 1 - 1e-5))
    print(f"n={N_ID} m={N_SNP} pairs={N_SNP*(N_SNP-1)//2:,} cut={cut:.3f}")

    mat_d = jnp.asarray(mat)
    py_d = jnp.asarray(py)
    anchors = np.arange(N_SNP - 1, dtype=np.int32)
    bins = np.zeros(N_SNP, dtype=np.int64)
    table = np.full(111, cut, dtype=np.float32)
    pairs = N_SNP * (N_SNP - 1) // 2
    t0 = time.perf_counter()
    i0, i1, eff = _run_screen(mat_d, mat_d, py_d, anchors, bins, bins, table,
                              "tri", TILE)
    dt = time.perf_counter() - t0
    print(f"cold (incl. compile): {dt:.1f} s -> {pairs/dt/1e6:.1f} M pairs/s,"
          f" {len(i0):,} hits")
    t0 = time.perf_counter()
    i0, i1, eff = _run_screen(mat_d, mat_d, py_d, anchors, bins, bins, table,
                              "tri", TILE)
    dt = time.perf_counter() - t0
    print(f"warm: {dt:.1f} s -> {pairs/dt/1e6:.1f} M pairs/s, "
          f"{len(i0):,} hits")

    # Verify a sample of extracted hits and a no-miss check on 8 anchor rows.
    # The screen GEMM runs at its declared full-float32 precision
    # (screen.py SCREEN_PRECISION), so extracted eff values carry only f32
    # accumulation error and the threshold has no slack.
    from gmat_tpu.scan.screen import _screen_slack

    slack = _screen_slack()
    tol = 1e-3  # f32 accumulation over n=4168 terms
    sel = rng.choice(len(i0), size=min(200, len(i0)), replace=False)
    for k in sel:
        direct = float(mat[:, i0[k]] * py @ mat[:, i1[k]])
        assert abs(direct - eff[k]) < tol * max(1.0, abs(direct)), (
            i0[k], i1[k], direct, eff[k])
    hit_set = set(zip(i0.tolist(), i1.tolist()))
    for a in rng.choice(N_SNP - 1, size=8, replace=False):
        row = (mat[:, a] * py) @ mat
        expect = {(int(a), int(j)) for j in np.where(np.abs(row) > cut)[0]
                  if j > a}
        got = {p for p in hit_set if p[0] == int(a)}
        missed = expect - got
        assert not missed, missed  # slack guarantees no false negatives
        for p in got - expect:  # extras sit in the slack band below the cut
            assert abs(row[p[1]]) > (1.0 - slack - tol) * cut, (
                p, row[p[1]], cut)
    print("hit verification OK")


def keep_all():
    """Keep-everything cliffs at yeast shape (VERDICT round-2 item 7).

    (a) exact scan with p_cut>=1 over an anchor subset: the fixed-capacity
        hit buffer must be bounded by the shrunken anchor tile, not
        tile*num_snp (~231M slots before the fix);
    (b) screen with a keep-all negative cut over one anchor tile: the dense
        extraction path must fetch raw panels instead of allocating
        panel-sized compaction buffers.
    Run with --keep-all; peak RSS is reported to prove the memory bound.
    """
    import resource

    import jax.numpy as jnp

    from gmat_tpu.scan.pairs import _scan_anchors
    from gmat_tpu.scan.screen import _run_screen

    rng = np.random.default_rng(0)
    freqs = rng.uniform(0.05, 0.95, size=N_SNP)
    geno = rng.binomial(2, freqs[None, :], size=(N_ID, N_SNP)).astype(np.float32)
    p_hat = geno.sum(0) / (2 * N_ID)
    mat = np.asarray(geno - 2 * p_hat[None, :], dtype=np.float32)
    py = (rng.standard_normal(N_ID) * 0.02).astype(np.float32)
    a = rng.standard_normal((N_ID, N_ID)).astype(np.float32) * 0.01
    pvp = np.asarray(a @ a.T + np.eye(N_ID, dtype=np.float32))

    from types import SimpleNamespace
    import tempfile

    pieces = SimpleNamespace(pymat=jnp.asarray(py), pvpmat=jnp.asarray(pvp))
    n_anchor = 300
    t0 = time.perf_counter()
    out = tempfile.mktemp()
    _scan_anchors(jnp.asarray(mat), jnp.asarray(mat), pieces,
                  range(n_anchor), N_SNP, True, p_cut=1.1, out_file=out)
    rows = sum(1 for _ in open(out)) - 1
    want = sum(N_SNP - 1 - a_ for a_ in range(n_anchor))
    assert rows == want, (rows, want)
    print(f"keep-all exact scan: {n_anchor} anchors -> {rows:,} rows in "
          f"{time.perf_counter()-t0:.1f} s")

    anchors = np.arange(4096, dtype=np.int32)
    bins = np.zeros(N_SNP, dtype=np.int64)
    table = np.full(111, -999.0, dtype=np.float32)  # accel.py keep-all cut
    t0 = time.perf_counter()
    i0, i1, eff = _run_screen(jnp.asarray(mat), jnp.asarray(mat),
                              jnp.asarray(py), anchors, bins, bins, table,
                              "tri", 4096)
    want = sum(N_SNP - 1 - a_ for a_ in range(4096))
    assert len(i0) == want, (len(i0), want)
    print(f"keep-all screen: 4096 anchors -> {len(i0):,} hits in "
          f"{time.perf_counter()-t0:.1f} s")
    peak_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    print(f"peak host RSS: {peak_gb:.1f} GB")


if __name__ == "__main__":
    if "--keep-all" in sys.argv:
        keep_all()
    else:
        main()
