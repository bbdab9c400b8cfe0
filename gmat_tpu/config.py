"""Global numeric policy for gmat-tpu.

The statistical path (REML, exact score tests) follows the reference
(`/root/reference/gmat/uvlmm/uvlmm_varcom.py`) in using float64 end-to-end so
variance components and p-values tolerance-match the reference.  The screening
path (pair-effect GEMMs) runs in full float32 (`scan/screen.py`
SCREEN_PRECISION); survivors are re-tested exactly, mirroring the
reference's own screen-then-exact design (`remma_epiAA_approx.py`).
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from pathlib import Path

import jax

# Enable x64 once, at first import of the package.  All exact-path statistics
# assume float64 unless the caller passes an explicit dtype.
jax.config.update("jax_enable_x64", True)


def default_exact_dtype():
    import jax.numpy as jnp

    return jnp.float64 if jax.config.read("jax_enable_x64") else jnp.float32


@dataclass(frozen=True)
class RemlConfig:
    """Knobs of the weighted EM+AI REML loop.

    Mirrors the keyword defaults of the reference
    (`uvlmm_varcom.py:107`: maxiter=200, cc_par=1e-8, cc_gra=1e-6,
    EM-weight grid step 0.01).
    """

    maxiter: int = 200
    cc_par: float = 1.0e-8
    cc_gra: float = 1.0e-6
    n_weights: int = 101  # weight grid {0, 0.01, ..., 1.0}


@dataclass(frozen=True)
class ScanConfig:
    """Knobs of the epistasis scan (reference `remma_epiAA.py:89`,
    `remma_epiAA_approx.py:10`, `remma_epiAA_pair.py:16`)."""

    p_cut: float = 1.0e-5
    num_random_pair: int = 100_000
    max_test_pair: int = 50_000
    anchor_tile: int = 128  # anchors per device step in the exact scan
    # screening GEMM block edge is auto-sized (scan/screen.py:_auto_tile);
    # pass tile=... to the screen engines to override


def use_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; returns its directory.

    When `JAX_COMPILATION_CACHE_DIR` is set, JAX already reads it and
    nothing else is set.  Otherwise the cache goes to `.jax_cache` at the
    root of the checkout — a fixed path, because the path is part of the
    cache key and a moving directory never hits."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = str(Path(__file__).resolve().parents[1] / ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def host_device_count() -> int:
    return int(os.environ.get("GMAT_TPU_FORCE_DEVICES", "0")) or jax.device_count()
