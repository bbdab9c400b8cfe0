"""Dense symmetric linear algebra helpers for the mixed-model core.

All Cholesky-based: `jnp.linalg.inv`'s LU path is slower and less stable
than a Cholesky solve for the SPD V / XᵀV⁻¹X matrices the REML loop
produces, and the log-determinant falls out of the factor for free (the
reference pays a separate slogdet + inv, uvlmm_varcom.py:47-48).
"""
from __future__ import annotations

import jax.numpy as jnp
from jax.scipy.linalg import cho_solve, cholesky


def chol_inv_logdet(a):
    """(A⁻¹, log|A|) for SPD A via one Cholesky factorization."""
    c = cholesky(a, lower=True)
    logdet = 2.0 * jnp.sum(jnp.log(jnp.diag(c)))
    inv = cho_solve((c, True), jnp.eye(a.shape[0], dtype=a.dtype))
    return inv, logdet


def mixed_inv_psd(a, rounds: int = 2):
    """(A⁻¹, log|A|) for SPD float64 A via a float32 Cholesky plus `rounds`
    Newton refinement steps with split-precision residuals.

    Reduced-precision twin of `chol_inv_logdet` for the REML O(n³) hot
    loop (reference uvlmm_varcom.py:44-55), selected only by an explicit
    `precision="mixed"`.  The factorization and solves run in full float32
    (default_matmul_precision "float32": no TF32/bf16 operand rounding)
    and accuracy is recovered by Newton's method for the inverse,

        W <- W + W (I - A W),

    whose residual I - A W is computed against the split A = A1 + A2
    (A1 = f32(A), A2 = f32(A - A1)) so the cancellation around I survives
    at float64 resolution.  Per round the elementwise error contracts from
    eps to ~eps² κ(A); two rounds from an f32 seed land near the f64 noise
    floor for the κ ≲ 1e6 GRM mixtures REML produces.  The log-determinant
    comes from the f32 factor — it only feeds the REPORTED -2logL, never
    the update direction (wemai.py `_reml_step`).
    """
    import jax

    n = a.shape[0]
    a1 = a.astype(jnp.float32)
    a2 = (a - a1).astype(jnp.float32)
    with jax.default_matmul_precision("float32"):
        c = cholesky(a1, lower=True)
        logdet = 2.0 * jnp.sum(jnp.log(jnp.diag(c)).astype(a.dtype))
        w = cho_solve((c, True), jnp.eye(n, dtype=jnp.float32))
        w = (0.5 * (w + w.T)).astype(a.dtype)
        eye = jnp.eye(n, dtype=a.dtype)
        for _ in range(rounds):
            w1 = w.astype(jnp.float32)
            w2 = (w - w1).astype(jnp.float32)
            r = (eye - (a1 @ w1).astype(a.dtype)
                 - (a1 @ w2).astype(a.dtype)
                 - (a2 @ w1).astype(a.dtype))  # a2@w2 ~ eps² — dropped
            w = w + (w1 @ r.astype(jnp.float32)).astype(a.dtype)
        w = 0.5 * (w + w.T)
    return w, logdet


def projection_pieces(vinv, xmat, mixed: bool = False):
    """P = V⁻¹ − V⁻¹X (XᵀV⁻¹X)⁻¹ XᵀV⁻¹ and log|XᵀV⁻¹X|.

    Matches the reference's P-matrix construction (uvlmm_varcom.py:50-55).
    `mixed` routes the tiny XᵀV⁻¹X inverse through `mixed_inv_psd` as
    well, so the mixed path has no float64 factorization at all."""
    vx = vinv @ xmat
    xvx = xmat.T @ vx
    xvx_inv, ll_xvx = (mixed_inv_psd(xvx) if mixed
                       else chol_inv_logdet(xvx))
    pmat = vinv - vx @ xvx_inv @ vx.T
    return pmat, ll_xvx


def sym_trace_product(a, b):
    """tr(A·B) for symmetric A, B — elementwise instead of a GEMM+diag.

    The reference computes np.trace(np.dot(P, ZGZᵀ)) (uvlmm_varcom.py:66),
    an O(n³) product for an O(n²) answer; ⟨A, B⟩_F is the O(n²) form.
    """
    return jnp.sum(a * b)
