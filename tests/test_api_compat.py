"""Reference-name API aliases and the parallel-twin coverage added for full
symbol parity with the reference package (SURVEY.md §2.3)."""
import numpy as np
import pytest


def test_design_matrix_reference_tuple(mouse_pheno, mouse_prefix):
    from gmat_tpu.io.pheno import (
        design_matrix,
        design_matrix_wemai_multi_gmat,
        design_matrix_wemai_multi_gmat_pred,
    )

    y, xmat, zmat = design_matrix_wemai_multi_gmat(mouse_pheno, mouse_prefix)
    dm = design_matrix(mouse_pheno, mouse_prefix)
    assert y.shape == (len(dm.y), 1)
    np.testing.assert_array_equal(y[:, 0], dm.y)
    np.testing.assert_array_equal(xmat, dm.xmat)
    # CSR incidence: one 1 per record, column = individual slot
    assert zmat.shape == (len(dm.rec_ids), dm.n_col)
    np.testing.assert_array_equal(np.asarray(zmat.argmax(axis=1)).ravel(),
                                  dm.rec_ids)
    np.testing.assert_array_equal(np.asarray(zmat.sum(axis=1)).ravel(), 1.0)
    y2, _, z2 = design_matrix_wemai_multi_gmat_pred(mouse_pheno, mouse_prefix)
    assert z2.shape[0] == len(y2)


def test_leg_reference_contracts():
    from gmat_tpu.longwas.legendre import leg, leg_basis, leg_mt

    t = np.array([1.0, 3.0, 5.0, 7.0])
    cols = leg(t, 3)
    assert len(cols) == 4 and all(c.shape == (4, 1) for c in cols)
    np.testing.assert_allclose(np.concatenate(cols, axis=1), leg_basis(t, 3))
    # leg_mt takes (time, tmax, tmin, order) — reference argument order
    mt = leg_mt(t, 10.0, 0.0, 2)
    np.testing.assert_allclose(mt, leg_basis(t, 2, tmin=0.0, tmax=10.0))


def test_longwas_lm_matches_lstsq(rng):
    from gmat_tpu.longwas.data import longwas_lm

    x = rng.standard_normal((50, 3))
    beta = np.array([1.0, -2.0, 0.5])
    y = x @ beta + rng.standard_normal(50) * 0.1
    eff, eff_var, sigma = longwas_lm(y, x)
    want, res_ss, *_ = np.linalg.lstsq(x, y, rcond=None)
    np.testing.assert_allclose(eff.ravel(), want, rtol=1e-10)
    np.testing.assert_allclose(sigma, float(res_ss) / (50 - 3), rtol=1e-10)
    assert eff_var.shape == (3, 3)


def test_output_mat_reference_semantics(tmp_path):
    from gmat_tpu.io.grm_io import output_mat

    mat = np.array([[2.0, 0.5], [0.5, 1.5]])
    ids = np.array(["a", "b"])
    assert output_mat(mat, ids, str(tmp_path / "k.agrm"), "mat") == 1
    np.testing.assert_allclose(np.loadtxt(tmp_path / "k.agrm0"), mat)
    assert output_mat(mat, ids, str(tmp_path / "k.agrm"), "id_id_val") == 1
    # reference returns 0 (no-op) on an unknown format instead of raising
    assert output_mat(mat, ids, str(tmp_path / "k.agrm"), "bogus") == 0


def test_simu_LDS_alias():
    from gmat_tpu.omics.simu_lds import simu_LDS, simu_lds

    np.testing.assert_array_equal(simu_LDS(100, 1.5, 3), simu_lds(100, 1.5, 3))


def test_parallel_anchor_split_coverage(mouse_prefix):
    """Shards must tile the anchor range exactly once; plain AD anchors
    extend to num_snp (reference remma_epiAD_eff.py:141-150), AA/DD to
    num_snp-1, and AD *maf* also to num_snp-1 (remma_epiAD_maf_eff.py:158)."""
    from gmat_tpu.io.bed import read_bim
    from gmat_tpu.scan.screen import _parallel_anchor_split

    num_snp = len(read_bim(mouse_prefix + ".bim"))
    cases = [("AA", num_snp - 1, False), ("AD", num_snp, False),
             ("DD", num_snp - 1, False), ("AA", num_snp - 1, True),
             ("AD", num_snp - 1, True), ("DD", num_snp - 1, True)]
    for kind, hi, maf in cases:
        shards = [_parallel_anchor_split(kind, mouse_prefix, [3, i], maf=maf)
                  for i in (1, 2, 3)]
        union = sorted(a for s in shards for a in s)
        assert union == list(range(hi)), (kind, maf)


@pytest.fixture(scope="module")
def legacy_setup(mouse_geno, mouse_pheno, mouse_prefix):
    import jax.numpy as jnp

    from gmat_tpu.grm.grm import additive_grm
    from gmat_tpu.io.pheno import design_matrix

    ag = np.asarray(additive_grm(jnp.asarray(mouse_geno)))
    var = np.array([0.06289206, 0.07641075, 0.08121168])
    dm = design_matrix(mouse_pheno, mouse_prefix)
    return dm, [ag, ag * ag], var


def test_legacy_AD_pair_matches_modern(tmp_path, legacy_setup, mouse_pheno,
                                       mouse_prefix):
    from gmat_tpu.scan.legacy import remma_epiAD_pair_cpu
    from gmat_tpu.scan.pairs import remma_epiAD_pair

    dm, gmat_lst, var = legacy_setup
    pair_file = tmp_path / "pairs"
    pair_file.write_text("snp_0 snp_1\n3 11\n100 200\n7 1000\n")
    remma_epiAD_pair_cpu(dm.y, dm.xmat, dm.z_dense(), gmat_lst, var,
                         mouse_prefix, str(pair_file), p_cut=1.1,
                         out_file=str(tmp_path / "legacy"))
    remma_epiAD_pair(mouse_pheno, mouse_prefix, gmat_lst, var,
                     snp_pair_file=str(pair_file), p_cut=1.1,
                     out_file=str(tmp_path / "modern"))
    a = np.loadtxt(tmp_path / "legacy", skiprows=1)
    b = np.loadtxt(tmp_path / "modern", skiprows=1)
    np.testing.assert_allclose(a, b, rtol=1e-12)


def test_legacy_DD_select_and_AD_eff(tmp_path, legacy_setup, mouse_prefix):
    import jax.numpy as jnp

    from gmat_tpu.core.coding import additive_code, dominance_code
    from gmat_tpu.scan.legacy import remma_epiAD_eff_cpu, remma_epiDD_select_cpu

    dm, gmat_lst, var = legacy_setup
    remma_epiDD_select_cpu(dm.y, dm.xmat, dm.z_dense(), gmat_lst, var,
                           mouse_prefix, snp_lst_0=[2], snp_lst_1=[4, 5],
                           p_cut=1.1, out_file=str(tmp_path / "ddsel"))
    rows = np.loadtxt(tmp_path / "ddsel", skiprows=1)
    assert rows.shape == (2, 6)

    # AD effect screen keeps both orientations: rows (i,j) and (j,i)
    remma_epiAD_eff_cpu(dm.y, dm.xmat, dm.z_dense(), gmat_lst, var,
                        mouse_prefix, snp_lst_0=[0, 1], eff_cut=-999.0,
                        out_file=str(tmp_path / "adeff"))
    out = np.loadtxt(tmp_path / "adeff", skiprows=1)
    i0 = out[:, 0].astype(int)
    i1 = out[:, 1].astype(int)
    assert set(i0) | set(i1) >= {0, 1}
    # spot-check one effect value against the direct f64 product
    from gmat_tpu.io.bed import read_plink
    from gmat_tpu.io.pheno import design_matrix  # noqa: F401
    from gmat_tpu.scan.common import score_pieces

    geno = read_plink(mouse_prefix)
    a = np.asarray(additive_code(jnp.asarray(geno))[0])
    d = np.asarray(dominance_code(jnp.asarray(geno))[0])
    pieces = score_pieces(dm, gmat_lst, var)
    py = np.asarray(pieces.pymat)
    k = 0
    direct = float((a[:, i0[k]] * d[:, i1[k]]) @ py)
    np.testing.assert_allclose(out[k, 2], direct, rtol=1e-3)


@pytest.mark.slow
def test_maf_eff_parallel_union_matches_serial(tmp_path, legacy_setup,
                                               mouse_pheno, mouse_prefix):
    """Two maf_eff shards must union to the serial run (same thresholds)."""
    from gmat_tpu.scan.screen import (
        remma_epiAA_maf_eff,
        remma_epiAA_maf_eff_parallel,
    )

    _, gmat_lst, var = legacy_setup
    deno = np.full(111, 1e-4)  # low denominators -> plenty of hits
    kw = dict(freq=None, freq_deno=deno, p_cut=1e-4)
    remma_epiAA_maf_eff(mouse_pheno, mouse_prefix, gmat_lst, var,
                        out_file=str(tmp_path / "serial"), **kw)
    for i in (1, 2):
        remma_epiAA_maf_eff_parallel(mouse_pheno, mouse_prefix, gmat_lst,
                                     var, parallel=[2, i],
                                     out_file=str(tmp_path / "shard"), **kw)

    def hits(path):
        rows = np.loadtxt(path, skiprows=1, ndmin=2)
        return {(int(r[0]), int(r[1])) for r in rows.reshape(-1, 5)}

    got = hits(tmp_path / "shard.1") | hits(tmp_path / "shard.2")
    assert hits(tmp_path / "shard.1").isdisjoint(hits(tmp_path / "shard.2"))
    assert got == hits(tmp_path / "serial")
    assert len(got) > 0


@pytest.mark.slow
def test_AD_maf_eff_parallel_union_matches_serial(tmp_path, legacy_setup,
                                                  mouse_pheno, mouse_prefix):
    """AD maf shards must cap anchors at num_snp-1 (the maf engine's own
    validation; reference remma_epiAD_maf_eff.py:157) — the shard with
    parallel[1]==1 used to include anchor num_snp-1 and raise."""
    from gmat_tpu.io.bed import read_plink
    from gmat_tpu.scan.screen import (
        _het_bins,
        _maf_bins,
        remma_epiAD_maf_eff,
        remma_epiAD_maf_eff_parallel,
    )

    _, gmat_lst, var = legacy_setup
    geno = read_plink(mouse_prefix)
    _, bins_a = _maf_bins(geno)
    _, bins_d = _het_bins(geno)
    deno = np.full(111, 2e-4)
    kw = dict(freqA=bins_a, freqD=bins_d, freq_deno=deno, p_cut=1e-4)
    remma_epiAD_maf_eff(mouse_pheno, mouse_prefix, gmat_lst, var,
                        out_file=str(tmp_path / "serial"), **kw)
    for i in (1, 2):
        remma_epiAD_maf_eff_parallel(mouse_pheno, mouse_prefix, gmat_lst,
                                     var, parallel=[2, i],
                                     out_file=str(tmp_path / "shard"), **kw)

    def hits(path):
        rows = np.loadtxt(path, skiprows=1, ndmin=2)
        return {(int(r[0]), int(r[1])) for r in rows.reshape(-1, 5)}

    got = hits(tmp_path / "shard.1") | hits(tmp_path / "shard.2")
    assert hits(tmp_path / "shard.1").isdisjoint(hits(tmp_path / "shard.2"))
    assert got == hits(tmp_path / "serial")
    assert len(got) > 0


def test_common_helpers():
    """gmat_tpu.common mirrors reference gmat/common/common.py:5-75."""
    from gmat_tpu.common import (
        Dtri_mat,
        Dtri_matT,
        dct_2D,
        dct_3D,
        get_logger,
        is_float,
        is_int,
        tri_mat,
        tri_matT,
    )

    assert is_int("42") and not is_int("4.2") and not is_int("x")
    assert is_float("4.2") and not is_float("x")
    d3 = dct_3D()
    d3["a"]["b"]["c"] = 1
    assert d3["a"]["b"]["c"] == 1
    d2 = dct_2D()
    d2["a"]["b"] = 2
    assert d2["a"]["b"] == 2
    rng = np.random.default_rng(0)
    a = rng.standard_normal((3, 4))
    b = rng.standard_normal((4, 4))
    c = rng.standard_normal((4, 2))
    dvec = rng.standard_normal(4)
    np.testing.assert_allclose(tri_matT(a, b), a @ b @ a.T, rtol=1e-12)
    np.testing.assert_allclose(tri_mat(a, b, c), a @ b @ c, rtol=1e-12)
    np.testing.assert_allclose(Dtri_matT(a, dvec), (a * dvec) @ a.T,
                               rtol=1e-12)
    np.testing.assert_allclose(Dtri_mat(a, dvec, c), (a * dvec) @ c,
                               rtol=1e-12)
    assert get_logger("t").name == "t"


def test_remma_epiAA_eff_gpu(tmp_path, legacy_setup, mouse_prefix):
    """The remma_gpu surface (reference remma_epiAA_gpu.py:12-99) on the
    accelerator screen engine:
    keep-everything default + threshold filtering vs a direct f64 oracle."""
    import jax.numpy as jnp

    from gmat_tpu.core.coding import additive_code
    from gmat_tpu.io.bed import read_plink
    from gmat_tpu.scan.accel import remma_epiAA_eff_gpu
    from gmat_tpu.scan.common import score_pieces

    dm, gmat_lst, var = legacy_setup
    anchors = [0, 5]
    res = remma_epiAA_eff_gpu(dm.y, dm.xmat, gmat_lst, var, mouse_prefix,
                              snp_lst_0=anchors,
                              out_file=str(tmp_path / "gpu_all"))
    geno = read_plink(mouse_prefix)
    m = geno.shape[1]
    # default eff_cut=-999 keeps every tested pair (reference :12,85)
    assert res.shape[0] == (m - 1) + (m - 6)
    a = np.asarray(additive_code(jnp.asarray(geno))[0])
    py = np.asarray(score_pieces(dm, gmat_lst, var).pymat)
    eff_oracle = {
        (i, j): float((a[:, i] * a[:, j]) @ py)
        for i in anchors
        for j in range(i + 1, m)
    }
    for i, j, e in res[::97]:
        np.testing.assert_allclose(e, eff_oracle[(int(i), int(j))], rtol=1e-3,
                                   atol=1e-6)
    # a positive cut keeps exactly the oracle's survivors (slack-adjusted)
    cut = float(np.quantile(np.abs(list(eff_oracle.values())), 0.99))
    res_cut = remma_epiAA_eff_gpu(dm.y, dm.xmat, gmat_lst, var, mouse_prefix,
                                  snp_lst_0=anchors, eff_cut=cut,
                                  out_file=str(tmp_path / "gpu_cut"))
    got = {(int(r[0]), int(r[1])) for r in res_cut}
    # screen runs in f32 with a slack-lowered cut: everything clearly above
    # the cut must survive; everything kept must be near-or-above the cut
    must_keep = {k for k, v in eff_oracle.items() if abs(v) > cut * 1.0001}
    may_keep = {k for k, v in eff_oracle.items() if abs(v) > cut * 0.98}
    assert must_keep <= got <= may_keep
    # file round-trips with the reference header
    loaded = np.loadtxt(tmp_path / "gpu_cut", skiprows=1, ndmin=2)
    assert loaded.shape == res_cut.shape


def test_remma_epiAA_eff_gpu_keeps_zero_effect_rows(tmp_path, rng):
    """Keep-everything default (eff_cut=-999) must keep pairs whose effect is
    exactly 0 — every pair involving a monomorphic SNP (centered column is
    all-zero), matching the reference remma_epiAA_gpu.py:85-93."""
    from gmat_tpu.grm.grm import additive_grm
    from gmat_tpu.io.bed import write_bed
    from gmat_tpu.scan.accel import remma_epiAA_eff_gpu

    import jax.numpy as jnp

    n, m = 40, 12
    geno = rng.choice([0.0, 1.0, 2.0], size=(n, m))
    geno[:, 3] = 2.0  # monomorphic: centered A-coding is exactly zero
    prefix = str(tmp_path / "mono")
    write_bed(prefix, geno)
    ag = np.asarray(additive_grm(jnp.asarray(geno)))
    y = rng.standard_normal(n)
    xmat = np.ones((n, 1))
    res = remma_epiAA_eff_gpu(y, xmat, [ag, ag * ag],
                              np.array([0.1, 0.05, 0.5]), prefix,
                              out_file=str(tmp_path / "gpu_mono"))
    # every tested pair present, including the m-1 zero-effect pairs
    assert res.shape[0] == m * (m - 1) // 2
    pairs = {(int(r[0]), int(r[1])): r[2] for r in res}
    for j in range(m):
        if j == 3:
            continue
        key = (min(3, j), max(3, j))
        assert key in pairs
        assert pairs[key] == 0.0


def test_array_level_underscore_api(tmp_path, legacy_setup, mouse_pheno,
                                    mouse_prefix):
    """The reference exports array-level `_`-twins from its __init__s
    (gmat/remma/__init__.py:4-5, remma_epiAA/__init__.py:8-11,
    uvlmm/__init__.py:1); they must match the file-level engines."""
    from gmat_tpu import (
        _remma_epiAA_eff,
        _remma_epiAA_pair,
        _wemai_multi_gmat,
    )
    from gmat_tpu.scan.screen import remma_epiAA_eff

    dm, gmat_lst, var = legacy_setup

    # REML on arrays reproduces the golden variance components
    var_arr = _wemai_multi_gmat(dm.y, dm.xmat, dm.z_dense(), gmat_lst)
    np.testing.assert_allclose(var_arr, var, rtol=1e-5)

    # array-level eff screen == file-level eff screen (incl. appended
    # chi_app/p_app columns)
    kw = dict(snp_lst_0=[0, 1, 2, 3], var_app=100.0, p_cut=1e-3)
    _remma_epiAA_eff(dm.y, dm.xmat, dm.z_dense(), gmat_lst, var,
                     mouse_prefix, out_file=str(tmp_path / "arr_eff"), **kw)
    remma_epiAA_eff(mouse_pheno, mouse_prefix, gmat_lst, var,
                    out_file=str(tmp_path / "file_eff"), **kw)
    a = np.loadtxt(tmp_path / "arr_eff", skiprows=1, ndmin=2)
    b = np.loadtxt(tmp_path / "file_eff", skiprows=1, ndmin=2)
    np.testing.assert_allclose(a, b, rtol=1e-12)
    assert a.shape[1] == 5 and a.shape[0] > 0

    # pair test with the reference default signature
    pair_file = tmp_path / "pairs"
    pair_file.write_text("snp_0 snp_1\n3 11\n100 200\n")
    _remma_epiAA_pair(dm.y, dm.xmat, dm.z_dense(), gmat_lst, var,
                      mouse_prefix, str(pair_file), p_cut=1.1,
                      out_file=str(tmp_path / "arr_pair"))
    rows = np.loadtxt(tmp_path / "arr_pair", skiprows=1, ndmin=2)
    assert rows.shape == (2, 6)
