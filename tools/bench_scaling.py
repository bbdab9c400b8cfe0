#!/usr/bin/env python
"""Scaling curve for the PRODUCTION fused screen (BASELINE north-star #3).

Round 5: measures the full `_run_screen` engine (fused count+extract,
chunked dispatches with in-program head slices — the same code every
`remma_epi*_eff/_approx` call runs) on 1/2/4/8-device meshes, STRONG
scaling: one fixed panel, the (anchor-tile, partner-tile) worklist
sharded over the mesh, output asserted byte-identical across mesh sizes.
(Earlier rounds measured only the two-phase counts kernel.)

It runs on 8 virtual CPU devices, which share the host's cores, so past
a few devices the curve measures host-core oversubscription, not the
device links.  Usage:

    python tools/bench_scaling.py

Prints one JSON line: {"devices": [...], "pairs_per_s": [...],
"efficiency": [...]}.
"""
from __future__ import annotations

import json
import os
import sys
import time

if "xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8")
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402
import numpy as np  # noqa: E402

N_ID = 256
TILE = 512
N_TILES = 16  # fixed panel: m = TILE * N_TILES, 256 visits (nodiag)
REPS = 3


def main():
    import jax.numpy as jnp

    from gmat_tpu.dist.mesh import make_mesh
    from gmat_tpu.scan.screen import _run_screen

    rng = np.random.default_rng(0)
    m = TILE * N_TILES
    geno = rng.binomial(2, 0.3, size=(N_ID, m)).astype(np.float32)
    mat_np = np.asarray(geno - geno.mean(0, keepdims=True), dtype=np.float32)
    py_np = (rng.standard_normal(N_ID) * 0.1).astype(np.float32)
    eff = (mat_np * py_np[:, None]).T @ mat_np
    cut = float(np.quantile(np.abs(eff), 1 - 1e-5))  # ~670 hits
    mat = jnp.asarray(mat_np)
    py = jnp.asarray(py_np)
    anchors = np.arange(m, dtype=np.int32)
    bins = np.zeros(m, dtype=np.int64)
    table = np.full(111, cut, dtype=np.float32)
    args = (mat, mat, py, anchors, bins, bins, table, "nodiag", TILE)

    devices = [1, 2, 4, 8]
    rates = []
    ref = None
    n_pairs = m * m  # nodiag sweep work (self pairs masked, negligible)
    for d in devices:
        mesh = make_mesh(d) if d > 1 else None
        out = _run_screen(*args, mesh=mesh)  # compile + warmup
        if ref is None:
            ref = out
        else:
            for a, b in zip(ref, out):
                np.testing.assert_array_equal(a, b)  # byte-identity
        times = []
        for _ in range(REPS):
            t0 = time.perf_counter()
            _run_screen(*args, mesh=mesh)
            times.append(time.perf_counter() - t0)
        rates.append(n_pairs / float(np.median(times)))
    eff_c = [r / (rates[0] * d) for d, r in zip(devices, rates)]
    print(json.dumps({
        "devices": devices,
        "pairs_per_s": [round(r, 1) for r in rates],
        "efficiency": [round(e, 3) for e in eff_c],
        "engine": "fused _run_screen (round-5; chunked + head slices)",
        "hits": int(len(ref[0])),
        "note": ("virtual CPU devices share this host's 2 cores; past 2 "
                 "devices the curve measures host oversubscription, not "
                 "ICI; run on a real multi-chip host for ICI-limited "
                 "numbers"),
    }))


if __name__ == "__main__":
    sys.exit(main())
