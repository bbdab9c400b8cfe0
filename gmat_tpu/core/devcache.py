"""Identity-keyed device-array cache for big host arrays.

The multi-stage pipelines (remma_epi*_approx: calibrate -> screen ->
exact re-test, reference remma_epiAA_approx.py:10-53) pass the SAME host
GRM arrays to every stage, and each stage's jnp.asarray would re-upload
them (139 MB per GRM at the yeast shape, three times per pipeline).
`device_put_cached` keeps one device copy per live host
array, keyed by id() and guarded by a weakref so a recycled id can never
alias a different array (the entry self-evicts when the host array is
garbage-collected).

In-place mutation guard (ADVICE r4): a cache hit re-verifies a cheap
fingerprint — the data pointer plus a checksum over a strided element
sample and, for square matrices, the full diagonal (the classic user
tweak is adding `small_val` to a GRM's diagonal between calls).  A
mutated array re-uploads.  Off-diagonal point edits that dodge the
sample can still alias; docs/MIGRATING.md documents the constraint
(pass a fresh array after in-place surgery).
"""
from __future__ import annotations

import weakref

import jax.numpy as jnp
import numpy as np

_CACHE: dict = {}


def _fingerprint(arr: np.ndarray):
    """Cheap content fingerprint: data pointer, strided sample, diagonal."""
    try:
        ptr = arr.__array_interface__["data"][0]
    except (AttributeError, KeyError, TypeError):
        ptr = None
    flat = arr.reshape(-1) if arr.flags["C_CONTIGUOUS"] else arr
    sample = ()
    if isinstance(flat, np.ndarray) and flat.ndim == 1 and flat.size:
        step = max(1, flat.size // 64)
        sample = flat[::step][:64].tobytes()
    diag = b""
    if arr.ndim == 2 and arr.shape[0] == arr.shape[1]:
        diag = np.ascontiguousarray(arr.diagonal()).tobytes()
    return (ptr, arr.shape, arr.dtype.str, hash(sample), hash(diag))


def device_put_cached(arr):
    """jnp.asarray with a per-object device cache (numpy inputs only;
    device arrays and non-arrays pass straight through)."""
    if not isinstance(arr, np.ndarray):
        return jnp.asarray(arr)
    key = id(arr)
    ent = _CACHE.get(key)
    if ent is not None and ent[0]() is arr and ent[2] == _fingerprint(arr):
        return ent[1]
    dev = jnp.asarray(arr)
    try:
        ref = weakref.ref(arr, lambda _r, k=key: _CACHE.pop(k, None))
    except TypeError:  # some ndarray subclasses refuse weakrefs
        return dev
    _CACHE[key] = (ref, dev, _fingerprint(arr))
    return dev
