"""Effect screen + approximate pipeline: the f32 screen must find exactly
the pairs the exact f64 effect computation puts above threshold (away from
the float32 borderline), and the approx pipeline must reproduce the
reference's file contract."""
import numpy as np
import pytest

from gmat_tpu.core.coding import additive_code, dominance_code
from gmat_tpu.scan.random_pair import random_pair, random_pairAD
from gmat_tpu.scan.screen import (
    remma_epiAA_approx,
    remma_epiAA_eff,
    remma_epiAA_maf_approx,
    remma_epiAD_eff,
)
from gmat_tpu.grm.grm import additive_grm

from conftest import GOLDEN


@pytest.fixture(scope="module")
def setup(mouse_geno, mouse_pheno, mouse_prefix):
    import jax.numpy as jnp

    from gmat_tpu.io.pheno import design_matrix
    from gmat_tpu.scan.common import score_pieces

    gold = np.load(GOLDEN / "epi_scans.npz")
    ag = np.asarray(additive_grm(jnp.asarray(mouse_geno)))
    var_com = gold["var_com"]
    dm = design_matrix(mouse_pheno, mouse_prefix)
    pieces = score_pieces(dm, [ag, ag * ag], var_com)
    return ag, var_com, np.asarray(pieces.pymat)


def _eff_matrix(geno, py, code0, code1):
    import jax.numpy as jnp

    a = np.asarray(code0(jnp.asarray(geno))[0])
    b = np.asarray(code1(jnp.asarray(geno))[0])
    return (a * py[:, None]).T @ b  # (m, m) float64 oracle


def _read_hits(path):
    rows = np.loadtxt(path, skiprows=1, ndmin=2)
    return rows


def test_screen_AA_matches_oracle(tmp_path, mouse_geno, mouse_pheno,
                                  mouse_prefix, setup):
    ag, var_com, py = setup
    eff = _eff_matrix(mouse_geno, py, additive_code, additive_code)
    m = eff.shape[0]
    tri = np.triu_indices(m, k=1)
    abs_eff = np.abs(eff[tri])
    cut = np.quantile(abs_eff, 1 - 2e-4)  # ~200 expected hits
    var_app = cut * cut / 19.511420964657572  # chi2.isf(1e-5, 1)
    out = str(tmp_path / "eff")
    remma_epiAA_eff(mouse_pheno, mouse_prefix, [ag, ag * ag], var_com,
                    var_app=var_app, p_cut=1e-5, out_file=out)
    got = _read_hits(out)
    got_set = {(int(r[0]), int(r[1])) for r in got}
    margin = 1e-4 * cut
    want_core = {
        (int(i), int(j))
        for i, j in zip(*tri)
        if np.abs(eff[i, j]) > cut + margin
    }
    want_max = {
        (int(i), int(j))
        for i, j in zip(*tri)
        if np.abs(eff[i, j]) > cut - margin
    }
    assert want_core <= got_set <= want_max
    # eff values in the file match the f64 oracle to f32 screen accuracy
    for r in got[:50]:
        assert abs(r[2] - eff[int(r[0]), int(r[1])]) < 1e-3 * max(1.0, abs(r[2]))
    # appended approx columns: chi_app = eff^2/var_app
    chi_app = got[:, 2] ** 2 / var_app
    np.testing.assert_allclose(got[:, 3], chi_app, rtol=1e-4)


def test_screen_AD_orientations(tmp_path, mouse_geno, mouse_pheno,
                                mouse_prefix, setup):
    ag, var_com, py = setup
    eff = _eff_matrix(mouse_geno, py, additive_code, dominance_code)
    m = eff.shape[0]
    mask = np.zeros_like(eff, dtype=bool)
    iu = np.triu_indices(m, k=1)
    mask[iu] = True  # orientation 1: (i, j>i) = A_i x D_j
    mask[np.tril_indices(m, k=-1)] = True  # orientation 2 written flipped
    cut = np.quantile(np.abs(eff[mask]), 1 - 1e-4)
    var_app = cut * cut / 19.511420964657572
    out = str(tmp_path / "effAD")
    remma_epiAD_eff(mouse_pheno, mouse_prefix, [ag, ag * ag], var_com,
                    var_app=var_app, p_cut=1e-5, out_file=out)
    got = _read_hits(out)
    got_set = {(int(r[0]), int(r[1])) for r in got}
    margin = 1e-4 * cut
    want_core = {
        (i, j) for i in range(m) for j in range(m)
        if i != j and np.abs(eff[i, j]) > cut + margin
    }
    want_max = {
        (i, j) for i in range(m) for j in range(m)
        if i != j and np.abs(eff[i, j]) > cut - margin
    }
    assert want_core <= got_set <= want_max


def test_approx_pipeline(tmp_path, mouse_pheno, mouse_prefix, setup):
    ag, var_com, _ = setup
    out = str(tmp_path / "approx")
    remma_epiAA_approx(mouse_pheno, mouse_prefix, [ag, ag * ag], var_com,
                       p_cut=1e-4, num_random_pair=20000, out_file=out)
    with open(out) as f:
        header = f.readline().split()
    assert header == ["snp_0", "snp_1", "eff", "var", "chi", "p_app", "p"]
    rows = np.loadtxt(out, skiprows=1, ndmin=2)
    if rows.size:
        # exact chi = eff^2/var and p monotone with chi
        np.testing.assert_allclose(rows[:, 4], rows[:, 2] ** 2 / rows[:, 3],
                                   rtol=1e-6)
        assert np.all(rows[:, 6] <= 1.0)
    # golden epiAA top hits (p < 1e-4 among anchors 0..39) must be recovered
    gold = np.load(GOLDEN / "epi_scans.npz")["aa"]
    strong = gold[gold[:, 4] < 1e-6]
    got_pairs = {(int(r[0]), int(r[1])) for r in rows.reshape(-1, 7)}
    for r in strong:
        assert (int(r[0]), int(r[1])) in got_pairs


def test_maf_approx_pipeline(tmp_path, mouse_pheno, mouse_prefix, setup):
    ag, var_com, _ = setup
    out = str(tmp_path / "mafapprox")
    remma_epiAA_maf_approx(mouse_pheno, mouse_prefix, [ag, ag * ag], var_com,
                           p_cut=1e-4, num_random_pair=20000, out_file=out)
    import os

    assert os.path.exists(out + ".freq")
    assert os.path.exists(out + ".freq_denominator")
    rows = np.loadtxt(out, skiprows=1, ndmin=2)
    assert rows.shape[1] == 7 if rows.size else True


def test_random_pair_unique_and_seeded(tmp_path):
    p1 = random_pair(500, out_file=str(tmp_path / "rp1"), num_pair=3000,
                     num_each_pair=1000, seed=42)
    p2 = random_pair(500, out_file=str(tmp_path / "rp2"), num_pair=3000,
                     num_each_pair=1000, seed=42)
    np.testing.assert_array_equal(p1, p2)
    assert np.all(p1[:, 0] < p1[:, 1])
    assert len({(a, b) for a, b in p1}) == 3000
    pad = random_pairAD(500, out_file=str(tmp_path / "rpAD"), num_pair=3000,
                        num_each_pair=1000, seed=1)
    assert np.all(pad[:, 0] != pad[:, 1])
    with pytest.raises(ValueError):
        random_pair(10, num_pair=1000, num_each_pair=10)


def test_annotation(tmp_path, mouse_prefix, setup):
    from gmat_tpu.scan.annotation import annotation_snp_pos

    res = tmp_path / "res"
    res.write_text(
        "snp_0 snp_1 eff chi p_val\n"
        "0 1 1.0 10.0 1e-6\n"       # same chr, nearby -> filtered if dis big
        "0 1000 2.0 20.0 1e-8\n"
        "5 6 0.5 1.0 0.5\n"          # p too large
    )
    annotation_snp_pos(str(res), mouse_prefix, p_cut=1e-5, dis=0)
    lines = open(str(res) + ".anno").read().strip().split("\n")
    assert "snp0_chr" in lines[0]
    body = [l.split() for l in lines[1:]]
    kept = {(r[0], r[7]) for r in body}
    assert ("0", "1000") in kept
    assert all(p != "5" for p, _ in kept)
    # tokens are verbatim input text (the file contract the reference's
    # text joiner guarantees; annotation.py:40-44)
    assert ["2.0", "20.0", "1e-8"] in [r[14:] for r in body]
    # LD pruning: r2 > cut removes the (snp0_ID, snp1_ID) pair, either order
    id0 = body[0][2]
    id1 = body[0][9]
    ld = res.parent / "ld"
    ld.write_text("CHR_A BP_A SNP_A CHR_B BP_B SNP_B R2\n"
                  f"1 1 {id1} 1 2 {id0} 0.9\n")
    annotation_snp_pos(str(res), mouse_prefix, p_cut=1e-5, dis=0,
                       ld_file=str(ld), r2=0.2)
    pruned = open(str(res) + ".anno.ld").read().strip().split("\n")
    assert len(pruned) == len(lines) - 1
    assert all(l.split()[2] != id0 or l.split()[9] != id1
               for l in pruned[1:])


def test_het_bins_and_AD_maf_threshold_rule(tmp_path, mouse_geno,
                                            mouse_pheno, mouse_prefix, setup):
    """AD maf screen binning (reference C kernel :330,337): thresholds are
    indexed freqA[anchor]*10 + freqD[partner] in BOTH orientations, with
    freqA = int(maf*20) and freqD = int(het_freq*20); p_app uses the WRITTEN
    row order (remma_epiAD_maf_eff.py:102)."""
    from gmat_tpu.scan.screen import _het_bins, _maf_bins, remma_epiAD_maf_eff

    ag, var_com, py = setup
    geno = mouse_geno
    n, m = geno.shape
    freq_het, bins_d = _het_bins(geno)
    het_direct = (np.abs(geno - 1.0) < 0.001).sum(0) / n
    het_direct = np.where(het_direct > 0.5, 1.0 - het_direct, het_direct)
    np.testing.assert_allclose(freq_het, het_direct, rtol=1e-12)
    assert bins_d.max() <= 10
    _, bins_a = _maf_bins(geno)
    # het bins differ from maf bins somewhere on real data, else the test
    # could not distinguish the two indexings
    assert np.any(bins_a != bins_d)

    eff_ad = _eff_matrix(mouse_geno, py, additive_code, dominance_code)
    chi_cut = 19.511420964657572  # chi2.isf(1e-5, 1)
    # bin-dependent denominators so wrong indexing changes the hit set
    tri = np.triu_indices(m, k=1)
    base = np.quantile(np.abs(eff_ad[tri]) ** 2 / chi_cut, 1 - 1e-3)
    rng = np.random.default_rng(3)
    freq_deno = base * rng.uniform(0.5, 2.0, size=111)
    anchors = list(range(12))
    out = str(tmp_path / "admaf")
    remma_epiAD_maf_eff(mouse_pheno, mouse_prefix, [ag, ag * ag], var_com,
                        snp_lst_0=anchors, freqA=bins_a, freqD=bins_d,
                        freq_deno=freq_deno, p_cut=1e-5, out_file=out)
    got = _read_hits(out)
    got_set = {(int(r[0]), int(r[1])) for r in got.reshape(-1, 5)}
    cut_of = lambda i, j: np.sqrt(chi_cut * freq_deno[bins_a[i] * 10
                                                      + bins_d[j]])
    want_core, want_max = set(), set()
    for i in anchors:
        for j in range(i + 1, m):
            cut = cut_of(i, j)
            # orientation 1: A_i x D_j -> row (i, j)
            if np.abs(eff_ad[i, j]) > cut * (1 + 1e-4):
                want_core.add((i, j))
            if np.abs(eff_ad[i, j]) > cut * (1 - 0.02):
                want_max.add((i, j))
            # orientation 2: D_i x A_j -> row (j, i), SAME threshold index
            if np.abs(eff_ad[j, i]) > cut * (1 + 1e-4):
                want_core.add((j, i))
            if np.abs(eff_ad[j, i]) > cut * (1 - 0.02):
                want_max.add((j, i))
    assert want_core <= got_set <= want_max
    assert len(want_core) > 0
    # p_app denominator follows the WRITTEN row: freq_deno[bA[s0]*10+bD[s1]]
    for r in got.reshape(-1, 5)[:50]:
        s0, s1, eff, chi_app = int(r[0]), int(r[1]), r[2], r[3]
        deno = freq_deno[bins_a[s0] * 10 + bins_d[s1]]
        np.testing.assert_allclose(chi_app, eff ** 2 / deno, rtol=1e-4)


def test_maf_approx_bin_files_AD_DD(tmp_path, mouse_pheno, mouse_prefix,
                                    setup):
    """AD maf_approx writes .maf + .heter and a NON-symmetrized denominator
    table over set(freqA) x set(freqD) (reference remma_epiAD_maf_approx.py:
    41,48,68-75); DD bins by het frequency and writes .heter
    (remma_epiDD_maf_approx.py:39-44)."""
    import os

    from gmat_tpu.scan.screen import (
        _het_bins,
        _maf_bins,
        remma_epiAD_maf_approx,
        remma_epiDD_maf_approx,
    )
    from gmat_tpu.io.bed import read_plink

    ag, var_com, _ = setup
    geno = read_plink(mouse_prefix)
    out = str(tmp_path / "admafapprox")
    remma_epiAD_maf_approx(mouse_pheno, mouse_prefix, [ag, ag * ag], var_com,
                           p_cut=1e-4, num_random_pair=5000, out_file=out)
    assert os.path.exists(out + ".maf")
    assert os.path.exists(out + ".heter")
    freq_a, bins_a = _maf_bins(geno)
    freq_d, bins_d = _het_bins(geno)
    np.testing.assert_allclose(np.loadtxt(out + ".maf"), freq_a, rtol=1e-10)
    np.testing.assert_allclose(np.loadtxt(out + ".heter"), freq_d,
                               rtol=1e-10)
    deno_rows = np.loadtxt(out + ".freq_denominator", ndmin=2)
    keys = {(int(r[0]), int(r[1])) for r in deno_rows}
    assert keys == {(a, b) for a in set(bins_a) for b in set(bins_d)}
    rows = np.loadtxt(out, skiprows=1, ndmin=2)
    assert rows.shape[1] == 7 if rows.size else True

    out_dd = str(tmp_path / "ddmafapprox")
    remma_epiDD_maf_approx(mouse_pheno, mouse_prefix, [ag, ag * ag], var_com,
                           p_cut=1e-4, num_random_pair=5000, out_file=out_dd)
    assert os.path.exists(out_dd + ".heter")
    assert not os.path.exists(out_dd + ".freq")
    np.testing.assert_allclose(np.loadtxt(out_dd + ".heter"), freq_d,
                               rtol=1e-10)


def test_fused_rmax_escalation_merge(rng):
    """Visits whose fullest (row, block) cell exceeds the tier-1 round
    budget (GMAT_TPU_RMAX=1 here) must escalate to the rmax=128 tier and
    the merged output — tier-1-served visits plus escalated visits — must
    equal the brute-force hit set exactly, in canonical order."""
    import jax.numpy as jnp

    from gmat_tpu.scan import screen as sc

    n, m = 32, 1024  # tile 512 -> 2 anchor tiles, 3 triangular visits
    geno = rng.choice([0.0, 1.0, 2.0], size=(n, m))
    mat = np.asarray(geno - geno.mean(0, keepdims=True), dtype=np.float32)
    py = (rng.standard_normal(n) * 0.1).astype(np.float32)
    # inflate one anchor moderately so row 7's |eff| distribution OVERLAPS
    # the rest: the global-quantile cut then yields rows at every density
    mat[:, 7] *= 8.0
    eff = (mat * py[:, None]).T @ mat
    iu = np.triu_indices(m, 1)
    cut = float(np.quantile(np.abs(eff[iu]), 0.995))
    rc = ((np.abs(eff) > cut)
          & (np.arange(m)[None, :] > np.arange(m)[:, None])).sum(1)
    assert rc.max() > 128, "fixture must have a row denser than one round"
    assert np.any(rc == 1), "fixture must have tier-1 rows"
    anchors = np.arange(m - 1, dtype=np.int32)
    bins = np.zeros(m, dtype=np.int64)
    table = np.full(111, cut)
    import unittest.mock as mock

    with mock.patch.dict("os.environ", {"GMAT_TPU_SCREEN": "fused",
                                        "GMAT_TPU_RMAX": "1"}):
        i0, i1, e = sc._run_screen(jnp.asarray(mat), jnp.asarray(mat),
                                   jnp.asarray(py), anchors, bins, bins,
                                   table, "tri", 512)
    want = {(a, b) for a, b in zip(*np.where(
        (np.abs(eff) > cut)
        & (np.arange(m)[None, :] > np.arange(m)[:, None])))}
    assert set(zip(i0.tolist(), i1.tolist())) == want
    # canonical order
    assert np.all(np.lexsort((i1, i0)) == np.arange(len(i0)))


def test_fused_tier2_serves_dense_without_legacy(rng):
    """A visit with rows denser than the tier-1 round budget but within
    the rmax=128 escalation must be served ENTIRELY by the fused engine —
    the legacy two-phase extraction must never run (VERDICT r3 #2: the
    reference C kernel handles unbounded hits per anchor in one pass)."""
    import unittest.mock as mock

    import jax.numpy as jnp

    from gmat_tpu.scan import screen as sc

    n, m = 32, 512
    geno = rng.choice([0.0, 1.0, 2.0], size=(n, m))
    mat = np.asarray(geno - geno.mean(0, keepdims=True), dtype=np.float32)
    py = (rng.standard_normal(n) * 0.1).astype(np.float32)
    eff = (mat * py[:, None]).T @ mat
    iu = np.triu_indices(m, 1)
    cut = float(np.quantile(np.abs(eff[iu]), 0.993))
    hitm = (np.abs(eff) > cut) & (np.arange(m)[None, :]
                                  > np.arange(m)[:, None])
    # bitmask-enumeration budgets at tile 128: `rounds` bounds hits per
    # (row, 32-lane group), `krow` hits per row-within-visit.  Some visit
    # must exceed the tier-1 budget (2 rounds, krow 8) and all must fit
    # tier 2 (8 rounds, krow 64) so the escalation — and never the legacy
    # engine — serves
    rc_v = np.stack([hitm[:, p * 128:(p + 1) * 128].sum(1)
                     for p in range(m // 128)])
    bc_v = hitm.reshape(m, m // 32, 32).sum(2)
    assert bc_v.max() > 2 or rc_v.max() > 8, "fixture must exceed tier 1"
    assert bc_v.max() <= 8 and rc_v.max() <= 64, "fixture must fit tier 2"
    anchors = np.arange(m - 1, dtype=np.int32)
    bins = np.zeros(m, dtype=np.int64)
    table = np.full(111, cut)
    with mock.patch.dict("os.environ", {"GMAT_TPU_SCREEN": "fused",
                                        "GMAT_TPU_RMAX": "2"}), \
            mock.patch.object(sc, "_screen_tiles_batch",
                              side_effect=AssertionError("legacy ran")):
        i0, i1, e = sc._run_screen(jnp.asarray(mat), jnp.asarray(mat),
                                   jnp.asarray(py), anchors, bins, bins,
                                   table, "tri", 128)
    want = {(a, b) for a, b in zip(*np.where(
        (np.abs(eff) > cut)
        & (np.arange(m)[None, :] > np.arange(m)[:, None])))}
    assert set(zip(i0.tolist(), i1.tolist())) == want


@pytest.mark.parametrize("use_mesh,seed", [(False, 9), (False, 2026),
                                           (True, 9)])
def test_fused_cap_overflow_salvage(use_mesh, seed):
    """When the global hit budget (_FUSED_CAP) is too small, per-visit
    buffers AND the global buffer overflow, the affected visits flag, and
    the escalation/legacy cascade must recover the EXACT hit set (VERDICT
    r3 #6) — on both the single-device and the mesh driver.  Seed 9
    reproduces the round-4 silent-truncation bug: a visit whose own kcap
    budget held but whose global-buffer slice landed past `cap` lost its
    hits without flagging."""
    import unittest.mock as mock

    import jax.numpy as jnp

    from gmat_tpu.scan import screen as sc

    rng = np.random.default_rng(seed)
    n, m = 32, 512
    geno = rng.choice([0.0, 1.0, 2.0], size=(n, m))
    mat = np.asarray(geno - geno.mean(0, keepdims=True), dtype=np.float32)
    py = (rng.standard_normal(n) * 0.1).astype(np.float32)
    eff = (mat * py[:, None]).T @ mat
    iu = np.triu_indices(m, 1)
    cut = float(np.quantile(np.abs(eff[iu]), 0.99))  # ~1300 hits total
    anchors = np.arange(m - 1, dtype=np.int32)
    bins = np.zeros(m, dtype=np.int64)
    table = np.full(111, cut)
    mesh = None
    if use_mesh:
        from gmat_tpu.dist.mesh import make_mesh

        mesh = make_mesh()
    # kcap collapses to 64 slots: visits with >64 hits overflow -> flag
    with mock.patch.dict("os.environ", {"GMAT_TPU_SCREEN": "fused"}), \
            mock.patch.object(sc, "_FUSED_CAP", 128):
        i0, i1, e = sc._run_screen(jnp.asarray(mat), jnp.asarray(mat),
                                   jnp.asarray(py), anchors, bins, bins,
                                   table, "tri", 128, mesh=mesh)
    want = {(a, b) for a, b in zip(*np.where(
        (np.abs(eff) > cut)
        & (np.arange(m)[None, :] > np.arange(m)[:, None])))}
    assert len(want) > 500
    assert set(zip(i0.tolist(), i1.tolist())) == want


def test_fused_tier_policy():
    """The measured tier policy (BASELINE.md rounds 4-5): big worklists
    start lean (GMAT_TPU_RMAX rounds, 4x/row, tile^2/2^15-slot buffers — the
    global-compaction scatter source is wc*kcap rows and degrades past
    ~1M rows) and escalate to (8, 64, 32k); short worklists start
    dense-capable to skip a cascade round trip; the env override always
    wins."""
    import unittest.mock as mock

    from gmat_tpu.scan.screen import _fused_tiers

    assert _fused_tiers(4096, 128, 2080) == [(2, 8, 512), (8, 64, 32768)]
    assert _fused_tiers(4096, 128, 28) == [(8, 16, 8192), (8, 64, 32768)]
    with mock.patch.dict("os.environ", {"GMAT_TPU_RMAX": "1"}):
        assert _fused_tiers(4096, 128, 28) == [(1, 4, 512),
                                               (8, 64, 32768)]
    # RMAX >= 9: the escalation tier must not shrink below tier 1 (it
    # would re-dispatch visits it provably cannot serve; ADVICE r4)
    with mock.patch.dict("os.environ", {"GMAT_TPU_RMAX": "9"}):
        assert _fused_tiers(4096, 128, 2080) == [(9, 36, 512),
                                                 (9, 64, 32768)]
    # tiny tiles clamp rounds/krow to the block/tile geometry
    rounds, krow, _ = _fused_tiers(64, 64, 3)[0]
    assert rounds <= 64 and krow <= 64


def test_fused_compaction_single_dot():
    """The hit VALUES/COLUMNS must never flow through a matmul: slot
    extraction is prefix-rank masked reduces (exact int32/f32 adds), so
    the flat-cut visit lowers to exactly TWO dot_generals — the score
    GEMM and the integer prefix-rank triangular dot, which must carry
    HIGHEST (bf16x3) precision (integer ranks < 2^24 stay exact; a
    default-precision bf16 dot corrupts counts above 255).  The round-4
    one-hot value contraction this guards against corrupted snp_1
    indices above 256 on the production backend, invisibly to CPU-pinned
    tests (ADVICE r4 high)."""
    import jax

    from gmat_tpu.scan.screen import _fused_visit

    def f(tp, ag, bm, ap, ba, t2):
        return _fused_visit(tp, ag, bm, ap, ba, t2, "tri", 128, 2, 8,
                            True, 128)

    text = jax.jit(f).lower(
        np.zeros(2, np.int32), np.zeros((4, 128), np.float32),
        np.zeros((4, 128), np.float32), np.zeros(128, np.int32),
        np.zeros(128, np.int32), np.zeros((11, 1), np.float32),
    ).as_text()
    assert text.count("dot_general") == 2
    assert "HIGHEST" in text


@pytest.mark.parametrize("seed", [11, 12, 13, 14])
def test_fused_fuzz_oracle(seed):
    """Seeded fuzz over engine-relevant degrees of freedom (shape, tile,
    mask mode, cut density, RMAX) — every configuration must reproduce the
    brute-force hit set exactly.  Guards the class of data-dependent
    compaction bugs the round-4 overflow test caught."""
    import unittest.mock as mock

    import jax.numpy as jnp

    from gmat_tpu.scan import screen as sc

    rng = np.random.default_rng(seed)
    n = int(rng.integers(16, 48))
    tile = int(rng.choice([128, 256, 512]))
    m = tile * int(rng.integers(2, 5)) - int(rng.integers(0, tile // 2))
    mask_mode = str(rng.choice(["tri", "nodiag"]))
    q = float(rng.uniform(0.95, 0.999))
    rmax = str(rng.integers(1, 4))
    geno = rng.choice([0.0, 1.0, 2.0], size=(n, m))
    mat = np.asarray(geno - geno.mean(0, keepdims=True), dtype=np.float32)
    py = (rng.standard_normal(n) * 0.1).astype(np.float32)
    eff = (mat * py[:, None]).T @ mat
    cut = float(np.quantile(np.abs(eff), q))
    anchors = np.arange(m - 1, dtype=np.int32)
    bins = np.zeros(m, dtype=np.int64)
    table = np.full(111, cut)
    with mock.patch.dict("os.environ", {"GMAT_TPU_SCREEN": "fused",
                                        "GMAT_TPU_RMAX": rmax}):
        i0, i1, e = sc._run_screen(jnp.asarray(mat), jnp.asarray(mat),
                                   jnp.asarray(py), anchors, bins, bins,
                                   table, mask_mode, tile)
    ii, jj = np.meshgrid(np.arange(m), np.arange(m), indexing="ij")
    valid = (jj > ii) if mask_mode == "tri" else \
        ((jj != ii) & (ii < m - 1))
    want = {(a, b) for a, b in zip(*np.where((np.abs(eff) > cut) & valid))}
    got = set(zip(i0.tolist(), i1.tolist()))
    assert got == want, (
        f"seed={seed} n={n} m={m} tile={tile} mode={mask_mode} q={q} "
        f"rmax={rmax}: missing={len(want - got)} extra={len(got - want)}")
    # eff values match the oracle to f32 screen accuracy
    emap = dict(zip(zip(i0.tolist(), i1.tolist()), e.tolist()))
    for (a, b) in list(want)[:20]:
        assert abs(emap[(a, b)] - eff[a, b]) < 1e-3 * max(1.0, abs(eff[a, b]))


def test_fused_maf_cut_panel(rng):
    """The fused engine's per-pair MAF threshold branch (one-hot cut
    panels, flat_cut=False) must match a brute-force per-bin-pair
    threshold test exactly."""
    import unittest.mock as mock

    import jax.numpy as jnp

    from gmat_tpu.scan import screen as sc

    n, m = 32, 384
    geno = rng.choice([0.0, 1.0, 2.0], size=(n, m))
    mat = np.asarray(geno - geno.mean(0, keepdims=True), dtype=np.float32)
    py = (rng.standard_normal(n) * 0.1).astype(np.float32)
    eff = (mat * py[:, None]).T @ mat
    bins_a = rng.integers(0, 10, size=m).astype(np.int64)
    bins_b = rng.integers(0, 10, size=m).astype(np.int64)
    base = float(np.quantile(np.abs(eff[np.triu_indices(m, 1)]), 0.97))
    # unused bin-pair entries must stay FINITE: the one-hot cut matmul
    # (both engines) turns 0*inf into NaN cuts for every real pair
    table = np.full(111, 1e30)
    for ka in range(10):
        for kb in range(10):
            table[ka * 10 + kb] = base * (0.6 + 0.08 * ((ka + kb) % 6))
    anchors = np.arange(m - 1, dtype=np.int32)
    with mock.patch.dict("os.environ", {"GMAT_TPU_SCREEN": "fused-always"}):
        i0, i1, e = sc._run_screen(jnp.asarray(mat), jnp.asarray(mat),
                                   jnp.asarray(py), anchors, bins_a, bins_b,
                                   table, "tri", 128)
    cuts = table[bins_a[:, None] * 10 + bins_b[None, :]]
    want = {(a, b) for a, b in zip(*np.where(
        (np.abs(eff) > cuts)
        & (np.arange(m)[None, :] > np.arange(m)[:, None])))}
    assert len(want) > 50
    assert set(zip(i0.tolist(), i1.tolist())) == want


def test_fused_8way_chunked_worklist(rng):
    """Worklists past 1024 visits dispatch in 8 equal-shape chunks whose
    in-program head fetches pipeline behind the next chunk's compute; the
    merged output must equal the brute-force hit set exactly (the
    production 2080-visit sweep takes this path)."""
    import unittest.mock as mock

    import jax.numpy as jnp

    from gmat_tpu.scan import screen as sc

    n, m, tile = 8, 2048, 32  # 64 anchor tiles -> 2080 visits
    geno = rng.choice([0.0, 1.0, 2.0], size=(n, m))
    mat = np.asarray(geno - geno.mean(0, keepdims=True), dtype=np.float32)
    py = (rng.standard_normal(n) * 0.1).astype(np.float32)
    eff = (mat * py[:, None]).T @ mat
    iu = np.triu_indices(m, 1)
    cut = float(np.quantile(np.abs(eff[iu]), 0.999))
    anchors = np.arange(m - 1, dtype=np.int32)
    bins = np.zeros(m, dtype=np.int64)
    table = np.full(111, cut)
    with mock.patch.dict("os.environ", {"GMAT_TPU_SCREEN": "fused"}):
        i0, i1, e = sc._run_screen(jnp.asarray(mat), jnp.asarray(mat),
                                   jnp.asarray(py), anchors, bins, bins,
                                   table, "tri", tile)
    want = {(a, b) for a, b in zip(*np.where(
        (np.abs(eff) > cut)
        & (np.arange(m)[None, :] > np.arange(m)[:, None])))}
    assert set(zip(i0.tolist(), i1.tolist())) == want
    assert np.all(np.lexsort((i1, i0)) == np.arange(len(i0)))


def test_approx_pipeline_zero_survivors(tmp_path, mouse_pheno, mouse_prefix,
                                        setup):
    """A screen with ZERO survivors is a normal outcome for strict cuts
    (e.g. miscalibrated variance components): the approx pipeline must
    produce a header-only result file, not crash the exact re-test on a
    header-only pair file (pandas EmptyDataError)."""
    ag, _, _ = setup
    out = str(tmp_path / "approx0")
    # arbitrary (non-fitted) variance components blow up the calibration
    # median -> eff_cut far beyond any effect -> 0 screen hits
    remma_epiAA_approx(mouse_pheno, mouse_prefix, [ag, ag * ag],
                       [0.4, 0.1, 0.6], p_cut=1e-4, num_random_pair=20000,
                       out_file=out)
    with open(out) as f:
        lines = f.read().strip().split("\n")
    assert lines[0].split() == ["snp_0", "snp_1", "eff", "var", "chi",
                                "p_app", "p"]
    assert len(lines) == 1


def test_fused_identity_anchor_scale_in_visit(rng):
    """Full scans over panels past the gather budget take the
    identity-anchor path: the raw coded panel is sliced per visit (no
    gathered+scaled copy — a 3x-panel peak OOMs a 16 GB chip at >=1M
    SNPs), pymat scaling happens in-visit, and padding slots carry a
    sentinel id whose rows must stay hitless.  Output must be
    byte-identical to the gather path."""
    import unittest.mock as mock

    import jax.numpy as jnp

    from gmat_tpu.scan import screen as sc

    n, m, tile = 16, 500, 32  # 499 anchors -> 512-wide padded tail
    geno = rng.choice([0.0, 1.0, 2.0], size=(n, m))
    mat = np.asarray(geno - geno.mean(0, keepdims=True), dtype=np.float32)
    py = (rng.standard_normal(n) * 0.1).astype(np.float32)
    eff = (mat * py[:, None]).T @ mat
    # sparse cut: the fused tiers must serve every visit (the legacy
    # fallback for flagged visits uses the gather path by design)
    cut = float(np.quantile(np.abs(eff[np.triu_indices(m, 1)]), 0.998))
    anchors = np.arange(m - 1, dtype=np.int32)
    bins = np.zeros(m, dtype=np.int64)
    table = np.full(111, cut)
    args = (jnp.asarray(mat), jnp.asarray(mat), jnp.asarray(py), anchors,
            bins, bins, table, "tri", tile)
    with mock.patch.dict("os.environ", {"GMAT_TPU_SCREEN": "fused"}):
        base = sc._run_screen(*args)
        with mock.patch.object(sc, "_GATHER_BYTES_MAX", 0), \
                mock.patch.object(sc, "_gather_scale",
                                  side_effect=AssertionError("gather ran")):
            ident = sc._run_screen(*args)
    for b, i in zip(base, ident):
        np.testing.assert_array_equal(b, i)
    assert len(base[0]) > 0
