"""Device policy with no platform branches: the screen's declared precision
and its slack, float64 'auto' precision, the pair chunk width, the peak
table, the compile cache, no silent CPU fallback, and the REMMAX path
without pandas."""
import os
import subprocess
import sys
from pathlib import Path
from unittest import mock

import jax
import numpy as np
import pytest

from conftest import DATA, GOLDEN

ROOT = Path(__file__).resolve().parents[1]


# screen precision ------------------------------------------------------------

@pytest.mark.parametrize("precision,slack", [
    (jax.lax.Precision.HIGHEST, 0.0),
    (jax.lax.Precision.HIGH, 2.0 ** -9),
    (jax.lax.Precision.DEFAULT, 2.0 ** -6),
])
def test_screen_slack_follows_declared_precision(precision, slack):
    from gmat_tpu.scan.screen import SCREEN_PRECISION, _screen_slack

    assert _screen_slack(precision) == slack
    # the declared precision is full float32, whose slack is zero
    assert SCREEN_PRECISION == jax.lax.Precision.HIGHEST
    assert _screen_slack() == 0.0


@pytest.mark.parametrize("binned", [False, True])
def test_screen_brackets_f64_oracle_at_dense_cut(rng, binned):
    """At its declared precision the screen misses no pair above
    cut*(1+1e-5) and keeps none below cut*(1-1e-5), at a cut dense enough
    (~2% of pairs) to put thousands of pairs in the borderline band; the
    binned case takes the one-hot threshold-dot path."""
    import jax.numpy as jnp

    from gmat_tpu.scan.screen import _run_screen

    n, m = 96, 700
    geno = rng.binomial(2, rng.uniform(0.1, 0.9, m)[None, :], size=(n, m))
    a = geno - geno.mean(axis=0)
    py = rng.standard_normal(n) * 0.1
    eff = (a * py[:, None]).T @ a  # float64 oracle
    iu = np.triu_indices(m, k=1)
    bins = np.arange(m) % 3 if binned else np.zeros(m, np.int64)
    cut0 = float(np.quantile(np.abs(eff[iu]), 0.98))
    table = np.full(111, cut0)
    if binned:
        table[np.arange(11)[:, None] * 10 + np.arange(11)] = \
            cut0 * (1.0 + 0.05 * np.arange(11))[:, None]
    cuts = table[bins[:, None] * 10 + bins[None, :]]
    a32 = jnp.asarray(a, jnp.float32)
    i0, i1, _ = _run_screen(a32, a32, jnp.asarray(py, jnp.float32),
                            np.arange(m - 1), bins, bins,
                            table.astype(np.float32), "tri", 128)
    hits = set(zip(i0.tolist(), i1.tolist()))
    mag = np.abs(eff)
    core = {(i, j) for i, j in zip(*iu) if mag[i, j] > cuts[i, j] * (1 + 1e-5)}
    hull = {(i, j) for i, j in zip(*iu) if mag[i, j] > cuts[i, j] * (1 - 1e-5)}
    assert len(core) > 1000
    assert core <= hits <= hull


# precision policy ------------------------------------------------------------

@pytest.mark.parametrize("which", ["reml", "longwas"])
def test_auto_precision_is_float64(which):
    with mock.patch.object(jax, "default_backend", return_value="gpu"), \
            mock.patch.dict(os.environ):
        os.environ.pop("GMAT_TPU_REML", None)
        os.environ.pop("GMAT_TPU_LONGWAS", None)
        if which == "reml":
            from gmat_tpu.reml.wemai import _resolve_precision

            assert _resolve_precision("auto") is False  # False = float64
            assert _resolve_precision("mixed") is True
        else:
            from gmat_tpu.longwas.balance_gwas import _resolve_dtype

            assert _resolve_dtype("auto") == np.float64
            assert _resolve_dtype("f32") == np.float32


def test_pair_chunk_width_ignores_platform(tmp_path, mouse_pheno,
                                           mouse_prefix):
    """The exact pair test pads every chunk to the canonical width
    min(max_test_pair, next pow2 of the pair count) on every platform."""
    import jax.numpy as jnp

    from gmat_tpu.grm.grm import additive_grm
    from gmat_tpu.io.bed import read_plink
    from gmat_tpu.scan import pairs

    ag = np.asarray(additive_grm(jnp.asarray(read_plink(mouse_prefix))))
    pair_file = tmp_path / "pairs"
    rs = np.random.default_rng(0)
    p = np.sort(rs.choice(1407, size=(9000, 2)), axis=1)
    p = p[p[:, 0] < p[:, 1]]
    np.savetxt(pair_file, p, fmt="%d", header="snp_0 snp_1", comments="")
    widths = []
    orig = pairs._pair_kernel

    def spy(c0, *rest):
        widths.append(c0.shape[0])
        return orig(c0, *rest)

    for backend in ("cpu", "gpu"):
        with mock.patch.object(pairs, "_pair_kernel", spy), \
                mock.patch.object(jax, "default_backend",
                                  return_value=backend):
            pairs.remma_epiAA_pair(mouse_pheno, mouse_prefix, [ag, ag * ag],
                                   [0.3, 0.2, 0.6], str(pair_file),
                                   p_cut=1.1,
                                   out_file=str(tmp_path / backend))
    assert set(widths) == {1 << (len(p) - 1).bit_length()}
    assert (tmp_path / "cpu").read_bytes() == (tmp_path / "gpu").read_bytes()


# roofline peaks ----------------------------------------------------------------

def test_peak_table_has_h100_entries():
    from gmat_tpu.core.roofline import peak_tflops

    kind = "NVIDIA H100 80GB HBM3"
    assert peak_tflops("bf16", kind) == 989.0
    assert peak_tflops("tf32", kind) == 495.0
    assert peak_tflops("f32", kind) == 67.0
    assert peak_tflops("f64", kind) == 67.0


def test_unknown_device_gets_rate_without_share(caplog):
    from gmat_tpu.core.roofline import log_phase, peak_tflops

    assert peak_tflops("bf16", "Some Future Accelerator") is None
    assert peak_tflops("f32") is None  # the CPU test device
    with caplog.at_level("INFO", logger="gmat_tpu.core.roofline"):
        tf = log_phase("x", 2e12, 1.0)
    assert tf == pytest.approx(2.0)
    assert "no f32 peak known" in caplog.text and "%" not in caplog.text


# compile cache -------------------------------------------------------------------

@pytest.mark.parametrize("env_dir", [None, "given"])
def test_compile_cache_helper(tmp_path, env_dir):
    from gmat_tpu.config import use_compile_cache

    before = jax.config.jax_compilation_cache_dir
    env = {} if env_dir is None else {
        "JAX_COMPILATION_CACHE_DIR": str(tmp_path / env_dir)}
    try:
        with mock.patch.dict(os.environ, env):
            if env_dir is None:
                os.environ.pop("JAX_COMPILATION_CACHE_DIR", None)
            with mock.patch.object(jax.config, "update") as upd:
                got = use_compile_cache()
        if env_dir is None:
            assert got == str(ROOT / ".jax_cache")
            upd.assert_called_once_with("jax_compilation_cache_dir", got)
        else:
            assert got == str(tmp_path / env_dir)
            upd.assert_not_called()
    finally:
        assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_env_dir_receives_entries(tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, compiled programs land there:
    it is the only cache directory JAX is configured with."""
    cache = tmp_path / "cache"
    code = ("from gmat_tpu.config import use_compile_cache; "
            "import jax, jax.numpy as jnp; print(use_compile_cache()); "
            "print(float(jax.jit(lambda x: (x @ x).sum())(jnp.ones((8, 8))))); "
            "print(jax.config.jax_compilation_cache_dir)")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(cache),
               JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0] == lines[2] == str(cache)
    assert any(cache.iterdir())


# no silent fallback ------------------------------------------------------------

def test_dryrun_raises_when_devices_are_short():
    sys.path.insert(0, str(ROOT))
    try:
        import __graft_entry__ as ge
    finally:
        sys.path.remove(str(ROOT))
    with pytest.raises(RuntimeError, match="need 64 devices"):
        ge.dryrun_multichip(64)
    assert jax.default_backend() == "cpu"


# the REMMAX path without pandas ---------------------------------------------

_NO_PANDAS = r"""
import sys
sys.modules["pandas"] = None
import numpy as np
from gmat_tpu import agmat, remma_epiAA_approx
prefix, pheno, out, var = sys.argv[1:5]
var = [float(v) for v in var.split(",")]
kin, _ = agmat(prefix)
agmat(prefix, out_fmt="id_id_val")
remma_epiAA_approx(pheno, prefix, [kin, kin * kin], var,
                   p_cut=1e-3, num_random_pair=11000, out_file=out, seed=3)
assert "pandas" not in [m for m in sys.modules if sys.modules[m] is not None]
"""


def test_remmax_path_without_pandas_matches_normal_run(tmp_path):
    """agmat -> remma_epiAA_approx (calibrate, screen, exact re-test,
    merge) with pandas blocked writes the same bytes as the in-process run
    with pandas importable."""
    import shutil

    from gmat_tpu import agmat, remma_epiAA_approx

    var = np.load(GOLDEN / "epi_scans.npz")["var_com"]
    runs = {}
    for label in ("plain", "nopandas"):
        d = tmp_path / label
        d.mkdir()
        for ext in (".bed", ".bim", ".fam"):
            shutil.copy(DATA / ("plink" + ext), d / ("plink" + ext))
        runs[label] = d
    d = runs["plain"]
    kin, _ = agmat(str(d / "plink"))
    agmat(str(d / "plink"), out_fmt="id_id_val")
    remma_epiAA_approx(str(DATA / "pheno"), str(d / "plink"),
                       [kin, kin * kin], var, p_cut=1e-3,
                       num_random_pair=11000, out_file=str(d / "approx"),
                       seed=3)
    d = runs["nopandas"]
    out = subprocess.run(
        [sys.executable, "-c", _NO_PANDAS, str(d / "plink"),
         str(DATA / "pheno"), str(d / "approx"),
         ",".join(repr(float(v)) for v in var)],
        cwd=ROOT, env=dict(os.environ, JAX_PLATFORMS="cpu"),
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    for name in ("approx", "plink.agrm0", "plink.agrm2"):
        a = (runs["plain"] / name).read_bytes()
        assert a and a == (runs["nopandas"] / name).read_bytes(), name
    assert len((runs["plain"] / "approx").read_text().splitlines()) > 100


def test_import_without_pandas():
    code = ("import sys; sys.modules['pandas'] = None; import gmat_tpu; "
            "import gmat_tpu.cli, gmat_tpu.longwas.balance_gwas; "
            "print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


# on the card ------------------------------------------------------------------

@pytest.mark.gpu
def test_screen_on_gpu_matches_cpu(gpu_device, rng):
    """The fused screen compiled for the GPU returns the hits of the same
    screen on the host CPU (both at the declared full-float32 precision)."""
    import jax.numpy as jnp

    from gmat_tpu.scan.screen import _run_screen

    n, m = 512, 4096
    geno = rng.binomial(2, rng.uniform(0.1, 0.9, m)[None, :], size=(n, m))
    a = np.asarray(geno - geno.mean(axis=0), np.float32)
    py = np.asarray(rng.standard_normal(n) * 0.1, np.float32)
    bins = np.zeros(m, np.int64)
    sample = (a[:, :64] * py[:, None]).T @ a
    table = np.full(111, np.quantile(np.abs(sample), 0.999), np.float32)
    res = {}
    for dev in (gpu_device, jax.devices("cpu")[0]):
        with jax.default_device(dev):
            res[dev.platform] = _run_screen(
                jnp.asarray(a), jnp.asarray(a), jnp.asarray(py),
                np.arange(m - 1), bins, bins, table, "tri", 1024)
    for g, c in zip(res["gpu"][:2], res["cpu"][:2]):
        np.testing.assert_array_equal(g, c)
    np.testing.assert_allclose(res["gpu"][2], res["cpu"][2], rtol=1e-4)


def test_gpu_marker_is_registered():
    out = subprocess.run([sys.executable, "-m", "pytest", "--markers"],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120, env=dict(os.environ,
                                               JAX_PLATFORMS="cpu"))
    assert "@pytest.mark.gpu:" in out.stdout
