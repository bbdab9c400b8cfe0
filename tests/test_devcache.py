"""Identity-keyed device-array cache (core/devcache): the approx
pipelines' GRM uploads must reuse one device copy per live host array,
and a garbage-collected host array must not alias a later one through a
recycled id."""
import gc

import numpy as np

from gmat_tpu.core import devcache


def test_cache_hit_same_object():
    a = np.arange(12.0).reshape(3, 4)
    d1 = devcache.device_put_cached(a)
    d2 = devcache.device_put_cached(a)
    assert d1 is d2
    np.testing.assert_array_equal(np.asarray(d1), a)


def test_distinct_objects_distinct_entries():
    a = np.ones((4, 4))
    b = np.ones((4, 4))
    da = devcache.device_put_cached(a)
    db = devcache.device_put_cached(b)
    assert da is not db


def test_no_stale_hit_after_gc():
    """After the host array dies, a fresh array must never receive the old
    device copy.  (On CPU jnp.asarray ALIASES the numpy buffer, so the
    weakref may stay alive as long as the device copy does — which itself
    rules out id recycling; either way the `ref() is arr` identity guard
    must hold.)"""
    a = np.full((8, 8), 3.0)
    key = id(a)
    devcache.device_put_cached(a)
    assert key in devcache._CACHE
    del a
    gc.collect()
    ent = devcache._CACHE.get(key)
    # entry either evicted or its weakref still resolves (no dangling key)
    assert ent is None or ent[0]() is not None
    # a fresh array (possibly at a recycled id) gets its own upload
    b = np.full((8, 8), 7.0)
    np.testing.assert_array_equal(np.asarray(devcache.device_put_cached(b)),
                                  b)


def test_non_numpy_passthrough():
    import jax.numpy as jnp

    dev = jnp.ones((2, 2))
    assert devcache.device_put_cached(dev) is not None
    out = devcache.device_put_cached([1.0, 2.0])
    np.testing.assert_array_equal(np.asarray(out), [1.0, 2.0])


def test_zgzt_reuses_device_copy():
    from gmat_tpu.io.pheno import DesignMatrices

    g = np.eye(5) + 0.1
    dm = DesignMatrices(y=np.zeros(7), xmat=np.ones((7, 1)),
                        rec_ids=np.array([0, 0, 1, 2, 3, 4, 4]), n_col=5)
    z1 = np.asarray(dm.zgzt(g))
    z2 = np.asarray(dm.zgzt(g))
    np.testing.assert_array_equal(z1, z2)
    want = g[dm.rec_ids][:, dm.rec_ids]
    np.testing.assert_allclose(z1, want, rtol=1e-12)


def test_diagonal_mutation_reuploads():
    """In-place diagonal tweak (the classic `+ small_val` GRM edit) must
    invalidate the cached device copy (ADVICE r4)."""
    g = np.eye(32) * 2.0
    d1 = devcache.device_put_cached(g)
    np.testing.assert_array_equal(np.asarray(d1), g)
    g[np.diag_indices(32)] += 0.001
    d2 = devcache.device_put_cached(g)
    assert d2 is not d1
    np.testing.assert_array_equal(np.asarray(d2), g)


def test_sampled_mutation_reuploads():
    """A first-element edit is caught by the strided sample."""
    a = np.zeros(1000)
    e1 = devcache.device_put_cached(a)
    a[0] = 5.0
    e2 = devcache.device_put_cached(a)
    assert e2 is not e1
    np.testing.assert_array_equal(np.asarray(e2), a)
