"""Roofline observability: achieved-vs-peak logging and profiler hooks.

SURVEY.md §5 (tracing/profiling row) asks for more than wall-clock logs:
each hot phase should report how close it runs to the hardware ceiling, and
a jax.profiler trace should be one env var away.  The reference's only
observability is its "Running time: Clock time" prints
(/root/reference/gmat/remma/remma_epiAA/remma_epiAA.py:84-86).

Peaks are published dense rates, keyed by `device.device_kind` and by the
precision a phase computes in.  A device missing from the table gets its
achieved rate logged and no share: no peak is ever assumed.
"""
from __future__ import annotations

import contextlib
import logging
import os

logger = logging.getLogger(__name__)

#: Published dense peaks (TFLOP/s per precision, memory bandwidth in TB/s).
#: NVIDIA H100 SXM data sheet: bf16 989, TF32 495, float32 and float64 67
#: TFLOP/s, HBM3 at 3.35 TB/s — at the full 700 W power limit.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16": 989.0, "tf32": 495.0, "f32": 67.0,
                              "f64": 67.0, "hbm_tbps": 3.35},
}


def peak_tflops(precision: str, device_kind: str | None = None):
    """Peak TFLOP/s of `device_kind` (default: the first JAX device) at
    `precision` ("bf16", "tf32", "f32", "f64"); None when unknown."""
    if device_kind is None:
        import jax

        device_kind = jax.devices()[0].device_kind
    return PEAKS.get(device_kind, {}).get(precision)


def card_name_and_power_limit() -> str:
    """What `nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader` reports (one line per card), for printing beside
    every time measured on a GPU."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unavailable ({exc.__class__.__name__})"
    return out.strip()


def log_phase(name: str, flops: float, seconds: float,
              items: float | None = None, unit: str = "pairs",
              precision: str = "f32") -> float:
    """Log one phase's achieved TF/s and, on a device with a known peak at
    `precision`, its share of that peak; returns TF/s.

    `items`/`unit` adds the domain-rate (e.g. pairs/s) so the roofline line
    replaces, not duplicates, the wall-clock log.
    """
    tf = flops / max(seconds, 1e-12) / 1e12
    extra = ""
    if items is not None:
        extra = " | %.3g %s/s" % (items / max(seconds, 1e-12), unit)
    peak = peak_tflops(precision)
    share = ("%.0f%% of %.0f TF/s %s peak" % (100.0 * tf / peak, peak,
                                              precision)
             if peak else "no %s peak known for this device" % precision)
    logger.info("Roofline %s: %.2f TF/s (%s), %.3f s%s", name, tf, share,
                seconds, extra)
    return tf


@contextlib.contextmanager
def maybe_trace(label: str = "gmat"):
    """jax.profiler trace hook: set GMAT_TPU_TRACE_DIR=/path to capture a
    TensorBoard-loadable trace of whatever runs inside the context; no-op
    (zero overhead) otherwise."""
    trace_dir = os.environ.get("GMAT_TPU_TRACE_DIR")
    if not trace_dir:
        yield
        return
    import jax

    with jax.profiler.trace(os.path.join(trace_dir, label)):
        yield
    logger.info("jax.profiler trace written under %s/%s", trace_dir, label)
