"""Pandas-free result tables (gmat_tpu/io/text.py) and chip_smoke.py's
comparison helpers and refusal without a GPU."""
import io
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

ROOT = Path(__file__).resolve().parents[1]


def _to_csv(cols, **kw):
    buf = io.StringIO()
    pd.DataFrame({k: c for k, c in enumerate(cols)}).to_csv(
        buf, sep=" ", header=False, index=False, **kw)
    return buf.getvalue()


@pytest.mark.parametrize("case", ["int_f64", "f32_format", "f32", "ids"])
def test_write_rows_matches_pandas_bytes(case):
    from gmat_tpu.io.text import write_rows

    rs = np.random.default_rng(7)
    f64 = np.concatenate([rs.standard_normal(50) * 10.0 ** rs.integers(
        -30, 30, 50), [0.0, -0.0, 1e16, 1e-5, 0.1 + 0.2, np.inf, np.nan,
                       5e-324, 123456789.0]])
    ints = rs.integers(0, 2 ** 40, len(f64))
    kw = {}
    if case == "int_f64":
        cols = [ints, ints[::-1].copy(), f64]
    elif case == "f32_format":
        cols = [ints, f64.astype(np.float32)]
        kw = {"float_format": "%g"}
    elif case == "f32":
        cols = [ints, f64.astype(np.float32)]
    else:
        cols = [np.array([f"id{k}" for k in range(len(f64))]), f64]
    buf = io.StringIO()
    write_rows(buf, *cols, **kw)
    assert buf.getvalue() == _to_csv(cols, **kw)


def test_write_bed_default_records_match_pandas(tmp_path):
    """The placeholder .bim/.fam records are the bytes the pandas writer
    produced."""
    from gmat_tpu.io.bed import write_bed

    n, m = 7, 5
    write_bed(str(tmp_path / "g"), np.zeros((n, m)))
    bim = pd.DataFrame({"chro": np.ones(m, dtype=int),
                        "snp_ID": [f"snp{i}" for i in range(m)],
                        "cm": np.zeros(m, dtype=int),
                        "pos": np.arange(1, m + 1),
                        "allele1": ["A"] * m, "allele2": ["B"] * m})
    fam = pd.DataFrame({"fid": [f"f{i}" for i in range(n)],
                        "iid": [f"i{i}" for i in range(n)],
                        "father": [0] * n, "mother": [0] * n,
                        "sex": [0] * n, "pheno": [-9] * n})
    for ext, df in ((".bim", bim), (".fam", fam)):
        want = df.to_csv(sep="\t", header=False, index=False)
        assert (tmp_path / ("g" + ext)).read_text() == want


def test_table_readers(tmp_path):
    from gmat_tpu.io.bed import Bed
    from gmat_tpu.io.text import count_records, read_int_pairs, \
        read_numeric_table

    p = tmp_path / "pairs"
    p.write_text("snp_0 snp_1 eff\n")
    assert read_int_pairs(str(p)).shape == (0, 2)
    assert read_numeric_table(str(p))["eff"].shape == (0,)
    p.write_text("snp_0 snp_1 eff\n3 9 0.5\n\n4 7 -1e-300\n")
    np.testing.assert_array_equal(read_int_pairs(str(p)), [[3, 9], [4, 7]])
    tab = read_numeric_table(str(p))
    np.testing.assert_array_equal(tab["eff"], [0.5, -1e-300])
    assert count_records(str(p)) == 3
    bed = Bed(str(ROOT / "tests" / "data" / "plink"))
    assert (bed.num_id, bed.num_snp) == (1304, 1407)
    np.testing.assert_array_equal(bed.iids, bed.fam["iid"].astype(str))


# chip_smoke.py ---------------------------------------------------------------

@pytest.fixture(scope="module")
def smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


def _bracket_case(smoke, tweak):
    m, cut = 50, 10.0
    hit_i, hit_j = np.array([1, 2, 5]), np.array([4, 9, 30])
    eff = np.array([12.0, -10.0005, 10.0002])
    core_i, core_j = np.array([1, 2]), np.array([4, 9])
    if tweak == "dropped":
        hit_i, hit_j, eff = hit_i[1:], hit_j[1:], eff[1:]
    elif tweak == "outside":
        eff = np.array([12.0, -10.0005, 9.0])
    return smoke.screen_bracket(hit_i, hit_j, eff, core_i, core_j, m, cut,
                                0.0, 1e-4)


@pytest.mark.parametrize("tweak,ok", [("none", True), ("dropped", False),
                                      ("outside", False)])
def test_smoke_screen_bracket(smoke, tweak, ok):
    assert _bracket_case(smoke, tweak)[0] is ok


@pytest.mark.parametrize("tweak,ok", [("none", True), ("p_off", False),
                                      ("chi_off", False), ("short", False)])
def test_smoke_retest_agreement(smoke, tweak, ok):
    want = {"eff": np.array([1.5, -2.0]), "chi": np.array([30.0, 42.0]),
            "p": np.array([4.1e-8, 1.2e-10])}
    got = {k: v * (1 + 1e-13) for k, v in want.items()}
    if tweak == "p_off":
        got["p"] = got["p"] * (1 + 1e-5)
    elif tweak == "chi_off":
        got["chi"] = got["chi"] * (1 + 1e-8)
    elif tweak == "short":
        got = {k: v[:1] for k, v in got.items()}
    assert smoke.retest_agreement(got, want)[0] is ok


@pytest.mark.parametrize("tweak,ok", [("none", True), ("dropped", False),
                                      ("p_off", False)])
def test_smoke_mesh_agreement(smoke, tweak, ok):
    single = {"snp_0": np.array([1.0, 2, 3]), "snp_1": np.array([5.0, 6, 7]),
              "p": np.array([1e-6, 2e-7, 3e-9])}
    meshed = {k: v[::-1].copy() for k, v in single.items()}
    if tweak == "dropped":
        meshed = {k: v[1:] for k, v in meshed.items()}
    elif tweak == "p_off":
        meshed["p"] = meshed["p"] * (1 + 1e-6)
    assert smoke.mesh_agreement(single, meshed, 10)[0] is ok


def test_smoke_oracle_matches_numpy(smoke, rng):
    import jax.numpy as jnp

    n, m = 40, 300
    a = rng.standard_normal((n, m))
    py = rng.standard_normal(n)
    eff = (a * py[:, None]).T @ a
    cut = float(np.quantile(np.abs(eff[np.triu_indices(m, 1)]), 0.99))
    hit_i, hit_j = np.array([0, 7]), np.array([5, 299])
    ci, cj, he = smoke.oracle_screen(jnp.asarray(a), jnp.asarray(py), cut,
                                     hit_i, hit_j, block=128)
    iu = np.triu_indices(m, 1)
    keep = np.abs(eff[iu]) > cut
    np.testing.assert_array_equal(np.sort(ci * m + cj),
                                  np.sort(iu[0][keep] * m + iu[1][keep]))
    np.testing.assert_allclose(he, eff[hit_i, hit_j], rtol=1e-12)


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_refuses_without_gpu(tmp_path, where):
    script = ROOT / "chip_smoke.py"
    if where == "alone":
        (tmp_path / "chip_smoke.py").write_bytes(script.read_bytes())
        script = tmp_path / "chip_smoke.py"
    out = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
