"""Weighted EM + AI REML for the multi-GRM univariate mixed model.

Model: y = Xb + Σ_i Z u_i + e,  u_i ~ N(0, G_i σ²_i),  e ~ N(0, I σ²_e).

Algorithm parity with the reference `_wemai_multi_gmat`
(/root/reference/gmat/uvlmm/uvlmm_varcom.py:8-104):
- per iteration: V, log|V|, V⁻¹, P, -2logL, gradient, AI matrix, EM Hessian
  diag(n/σ⁴), then a 0.01-step weight line-search picking the first
  w ∈ {0, .01, …, 1} whose blended update keeps all variances positive;
- dual convergence on ‖Δ‖/‖σ²‖ < cc_par and ‖∇‖ < cc_gra.

Re-design inside one jitted step:
- V⁻¹ and log|V| from a single Cholesky (reference pays slogdet + LU inv);
- trace terms as Frobenius inner products ⟨P, ZG_iZᵀ⟩ (O(n²) each instead of
  the reference's O(n³) matmul-then-trace);
- the whole 101-candidate weight search is one vmapped batch of (k+1)×(k+1)
  solves + an argmax — no data-dependent Python control flow;
- ZG_iZᵀ built by gather (G[rec,rec]) from the record->individual index map,
  never a sparse matmul.

The iteration loop stays on the host (compiled step reused every iteration)
so per-round logging matches the reference's observability contract.

Precision: `precision="auto"` (the default) runs the step float64
end-to-end on every device (bit-level parity with the reference's fully-f64
math).  `precision="mixed"` switches the O(n³) inverse to
`core.linalg.mixed_inv_psd` (f32 Cholesky + split-precision Newton
refinement) while every O(n²) reduction that shapes the update direction
stays f64 elementwise.  GMAT_TPU_REML=mixed|f64 overrides the argument.
"""
from __future__ import annotations

import logging
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from gmat_tpu import config  # noqa: F401
from gmat_tpu.core.linalg import (chol_inv_logdet, mixed_inv_psd,
                                  projection_pieces)
from gmat_tpu.io.pheno import DesignMatrices, design_matrix, design_matrix_pred

logger = logging.getLogger(__name__)


def build_zgzt_stack(dm: DesignMatrices, gmat_lst) -> jnp.ndarray:
    """(k, n_rec, n_rec) stack of Z G_i Zᵀ (reference uvlmm_varcom.py:32-34)."""
    return jnp.stack([dm.zgzt(g) for g in gmat_lst])


@partial(jax.jit, static_argnames=("mixed",))
def _reml_step(var_com, y, xmat, zg_stack, mixed=False):
    n = y.shape[0]
    k = zg_stack.shape[0]
    vmat = jnp.einsum("k,kij->ij", var_com[:-1], zg_stack)
    vmat = vmat + var_com[-1] * jnp.eye(n, dtype=vmat.dtype)
    # mixed: the O(n³) inverse runs as an f32 Cholesky + Newton
    # refinement (core/linalg.mixed_inv_psd); every O(n²) reduction that
    # shapes the update direction stays float64 elementwise
    vinv, ll_v = mixed_inv_psd(vmat) if mixed else chol_inv_logdet(vmat)
    pmat, ll_xvx = projection_pieces(vinv, xmat, mixed=mixed)
    py = pmat @ y
    ll_val = -2.0 * (ll_v + ll_xvx + jnp.dot(y, py))

    # gradient: fd_i = ½(−tr(P ZG_i) + yᵀP ZG_i Py); residual uses ZG := I
    tr_terms = jnp.einsum("ij,kij->k", pmat, zg_stack)
    quad_terms = jnp.einsum("i,kij,j->k", py, zg_stack, py)
    fd_e = -jnp.trace(pmat) + jnp.dot(py, py)
    fd = 0.5 * jnp.concatenate([-tr_terms + quad_terms, fd_e[None]])

    # AI matrix: W = [ZG_1·Py, …, ZG_k·Py, Py];  AI = ½ Wᵀ P W
    wv = jnp.concatenate(
        [jnp.einsum("kij,j->ik", zg_stack, py), py[:, None]], axis=1
    )
    ai = 0.5 * wv.T @ (pmat @ wv)
    em = jnp.diag(n / (var_com * var_com))

    # vectorized 0.01-step weight search (reference uvlmm_varcom.py:82-89)
    weights = jnp.linspace(0.0, 1.0, 101)

    def delta_for(w):
        a = (1.0 - w) * ai + w * em
        if not mixed:
            return jnp.linalg.solve(a, fd)
        # these (k+1)-sized SPD blends solve in f32 + two f64-residual
        # refinements (the residual matvec is a tiny elementwise-f64 op)
        a32 = a.astype(jnp.float32)
        x = jnp.linalg.solve(a32, fd.astype(jnp.float32)).astype(a.dtype)
        for _ in range(2):
            r = fd - a @ x
            x = x + jnp.linalg.solve(a32, r.astype(jnp.float32)
                                     ).astype(a.dtype)
        return x

    deltas = jax.vmap(delta_for)(weights)  # (101, k+1)
    cands = var_com[None, :] + deltas
    valid = jnp.min(cands, axis=1) > 0.0
    idx = jnp.where(jnp.any(valid), jnp.argmax(valid), 100)
    delta = deltas[idx]
    var_new = var_com + delta

    cc_par = jnp.sqrt(jnp.sum(delta * delta) / jnp.sum(var_new * var_new))
    cc_gra = jnp.sqrt(jnp.sum(fd * fd))
    return var_new, ll_val, cc_par, cc_gra, weights[idx]


def _resolve_precision(precision: str) -> bool:
    """True = mixed-precision (f32 Cholesky + Newton refinement).

    `precision`: "mixed", "f64", or "auto" (the default, = "f64" on every
    device).  The GMAT_TPU_REML env var overrides the argument."""
    import os

    mode = os.environ.get("GMAT_TPU_REML", precision).lower()
    if mode == "auto":
        mode = "f64"
    if mode not in ("mixed", "f64"):
        raise ValueError(f"unknown REML precision {mode!r}")
    return mode == "mixed"


def wemai_reml(dm: DesignMatrices, gmat_lst, init=None, maxiter: int = 200,
               cc_par: float = 1.0e-8, cc_gra: float = 1.0e-6,
               precision: str = "auto"):
    """Core REML driver; returns the converged variance-component vector."""
    k = len(gmat_lst)
    var_com = np.array(init, dtype=np.float64) if init is not None else np.ones(k + 1)
    y = jnp.asarray(dm.y)
    xmat = jnp.asarray(dm.xmat)
    zg = build_zgzt_stack(dm, gmat_lst)
    mixed = _resolve_precision(precision)
    logger.info("Initial variances: %s", " ".join(map(str, var_com)))
    converged = False
    for it in range(1, maxiter + 1):
        var_new, ll_val, ccp, ccg, weight = _reml_step(
            jnp.asarray(var_com), y, xmat, zg, mixed=mixed
        )
        var_com = np.asarray(var_new)
        ccp, ccg = float(ccp), float(ccg)
        logger.info(
            "Round %d: -2logL %.6f | grad %.3e | update %.3e | weight %.2f | vars %s",
            it, float(ll_val), ccg, ccp, float(weight),
            " ".join(f"{v:.6g}" for v in var_com),
        )
        if ccg < cc_gra and ccp < cc_par:
            converged = True
            break
    logger.info("Variances %sconverged.", "" if converged else "not ")
    return var_com


def wemai_multi_gmat(pheno_file: str, bed_prefix: str, gmat_lst, init=None,
                     maxiter: int = 200, cc_par: float = 1.0e-8,
                     cc_gra: float = 1.0e-6,
                     out_file: str = "wemai_multi_gmat.var",
                     precision: str = "auto"):
    """File-level wrapper; writes the variance vector (reference
    uvlmm_varcom.py:107-126)."""
    dm = design_matrix(pheno_file, bed_prefix)
    var_com = wemai_reml(dm, gmat_lst, init=init, maxiter=maxiter,
                         cc_par=cc_par, cc_gra=cc_gra, precision=precision)
    np.savetxt(out_file, var_com)
    return var_com


@partial(jax.jit, static_argnums=(6, 7))
def _blup_effects(var_com, y, xmat, zg_stack, gmat_stack, rec_ids, n_col,
                  mixed=False):
    n = y.shape[0]
    vmat = jnp.einsum("k,kij->ij", var_com[:-1], zg_stack)
    vmat = vmat + var_com[-1] * jnp.eye(n, dtype=vmat.dtype)
    vinv, _ = mixed_inv_psd(vmat) if mixed else chol_inv_logdet(vmat)
    pmat, _ = projection_pieces(vinv, xmat, mixed=mixed)
    py = pmat @ y
    zpy = jax.ops.segment_sum(py, rec_ids, num_segments=n_col)
    # u_i = σ²_i G_i Zᵀ P y  (reference uvlmm_varcom.py:161-165)
    return jnp.einsum("k,kij,j->ik", var_com[:-1], gmat_stack, zpy)


def wemai_multi_gmat_pred(pheno_file: str, bed_prefix: str, gmat_lst,
                          init=None, maxiter: int = 200, cc_par: float = 1.0e-8,
                          cc_gra: float = 1.0e-6,
                          out_file: str = "wemai_multi_gmat_pred",
                          precision: str = "auto"):
    """REML + BLUP of the random effects; writes `<out>.var` and
    `<out>.rand_eff`.

    Parity note: the reference (uvlmm_varcom.py:152-160) builds its
    "P matrix" for prediction from V instead of V⁻¹ — it drops the
    `np.linalg.inv(vmat)` call present in the estimation path, so its
    published BLUPs are computed from a non-inverted V.  That is a bug we do
    NOT replicate (documented deviation; SURVEY.md §5 quirks): we use the
    correct P = V⁻¹ − V⁻¹X(XᵀV⁻¹X)⁻¹XᵀV⁻¹.
    """
    dm = design_matrix_pred(pheno_file, bed_prefix)
    var_com = wemai_reml(dm, gmat_lst, init=init, maxiter=maxiter,
                         cc_par=cc_par, cc_gra=cc_gra, precision=precision)
    np.savetxt(out_file + ".var", var_com)
    rand_eff = _blup_effects(
        jnp.asarray(var_com),
        jnp.asarray(dm.y),
        jnp.asarray(dm.xmat),
        build_zgzt_stack(dm, gmat_lst),
        jnp.stack([jnp.asarray(g) for g in gmat_lst]),
        jnp.asarray(dm.rec_ids),
        dm.n_col,
        _resolve_precision(precision),
    )
    np.savetxt(out_file + ".rand_eff", np.asarray(rand_eff))
    return var_com
