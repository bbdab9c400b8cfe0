#!/usr/bin/env python
"""Proof that the REMMAX main path runs on an NVIDIA GPU.

    python chip_smoke.py             # one GPU
    python chip_smoke.py --chips 4   # only the 4-GPU mesh path vs one GPU

One GPU, phases in order:

1. Device report: platform, device kind and count, JAX version, x64
   state, the card's name and power limit (nvidia-smi), which `.bed`
   decoder is in use, and how far a default-precision float32 matmul is
   from one at precision HIGHEST (TF32 shows as ~1e-3).
2. REMMAX at the reference's yeast shape (n=4168 ids, m=28220 SNPs,
   398,170,090 pairs) on seeded synthetic genotypes written with
   `write_bed`: `agmat` -> `wemai_multi_gmat` -> `remma_epiAA_approx`
   (p_cut 1e-5, 100,000 calibration pairs), through the public entry
   points.  Checks: (a) the screen's hit set against a float64
   recomputation of |eff| on the device (no false negatives), (b) eff,
   chi and p of 1,000 re-tested pairs against numpy float64 on the host,
   (c) one REML step on the GPU against the same step on the host CPU.
3. Goldens on the card: REML on the mouse fixture and, where pandas is
   installed, balanced longwas trans/fixed on mouse_long.

With `--chips 4` only the mesh path runs: `remma_epiAA_approx(...,
mesh=make_mesh(4))` at the yeast shape against the one-GPU run in the same
process.

Every time printed sits beside the card's name and power limit.  Any
failed check exits non-zero; the last line of a passing run is
`{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}`.
Without a GPU, or without the gmat_tpu package beside this file, the
script exits non-zero and prints no such line.
"""
from __future__ import annotations

import argparse
import contextlib
import inspect
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

YEAST_N, YEAST_M = 4168, 28220
P_CUT = 1.0e-5
NUM_RANDOM_PAIR = 100_000
SEED = 0
# (a): relative margin of the float32 HIGHEST screen around the cut.  Its
# error is f32 rounding of the inputs and the n-term accumulation, relative
# to sum|terms| ~ 12 |eff| near the cut at n=4168: ~1e-5 worst case.
SCREEN_DELTA = {"HIGHEST": 1e-4, "HIGH": 2.0 ** -9, "DEFAULT": 2.0 ** -7}
RTOL_CHI = 1e-9    # (b) float64 on both sides, different summation order
RTOL_P = 1e-7      # (b) p = erfc(sqrt(chi/2)): dp/p ~ chi/2 * dchi/chi
RTOL_REML = 1e-8   # (c) one float64 REML step, GPU vs host CPU
RTOL_MESH_P = 1e-9  # --chips 4: per-device math is the single-device math


class Report:
    """Prints each result and remembers the failed checks."""

    def __init__(self):
        self.failed: list[str] = []
        self.card = ""

    def line(self, msg: str) -> None:
        print(msg, flush=True)

    def time(self, what: str, seconds: float) -> None:
        print(f"time {what}: {seconds:.3f} s [{self.card}]", flush=True)

    def check(self, name: str, ok: bool, detail: str) -> bool:
        print(f"{'PASS' if ok else 'FAIL'} {name}: {detail}", flush=True)
        if not ok:
            self.failed.append(name)
        return ok


@contextlib.contextmanager
def timed(rep: Report, what: str):
    t0 = time.perf_counter()
    yield
    rep.time(what, time.perf_counter() - t0)


# comparison helpers (pure numpy; the CPU tests drive them) -----------------

def pair_keys(i, j, m: int) -> np.ndarray:
    return np.asarray(i, np.int64) * np.int64(m) + np.asarray(j, np.int64)


def screen_bracket(hit_i, hit_j, hit_eff64, core_i, core_j, m: int,
                   cut: float, slack: float, delta: float):
    """(ok, detail) for a screen hit set against its float64 oracle:
    every pair with |eff64| > cut*(1+delta) (the core) must be a hit (no
    false negatives), and every hit must have |eff64| > cut*(1-slack-delta)
    (inside the hull)."""
    hits = pair_keys(hit_i, hit_j, m)
    core = pair_keys(core_i, core_j, m)
    missed = int(np.count_nonzero(~np.isin(core, hits)))
    floor = cut * (1.0 - slack - delta)
    outside = int(np.count_nonzero(np.abs(hit_eff64) <= floor))
    ok = missed == 0 and outside == 0 and len(np.unique(hits)) == len(hits)
    return ok, (f"{len(hits)} hits, {len(core)} core pairs, "
                f"{missed} false negatives, {outside} hits below the hull "
                f"(cut {cut:.9g}, slack {slack}, delta {delta})")


def retest_agreement(got: dict, want: dict, rtol_chi: float = RTOL_CHI,
                     rtol_p: float = RTOL_P):
    """(ok, detail): eff and chi within rtol_chi, p within rtol_p (each
    dict holds equal-length `eff`, `chi`, `p` arrays)."""
    def rel(k):
        a, b = np.asarray(got[k], float), np.asarray(want[k], float)
        if a.shape != b.shape:
            return np.inf
        return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300),
                            initial=0.0))

    r_eff, r_chi, r_p = rel("eff"), rel("chi"), rel("p")
    ok = r_eff <= rtol_chi and r_chi <= rtol_chi and r_p <= rtol_p
    return ok, (f"{len(want['chi'])} pairs; max rel diff eff {r_eff:.3e}, "
                f"chi {r_chi:.3e} (rtol {rtol_chi}), p {r_p:.3e} "
                f"(rtol {rtol_p})")


def mesh_agreement(single: dict, meshed: dict, m: int,
                   rtol_p: float = RTOL_MESH_P):
    """(ok, detail): the same hit set, and p within rtol_p pair by pair
    (dicts of `snp_0`, `snp_1`, `p` columns)."""
    ks = pair_keys(single["snp_0"], single["snp_1"], m)
    km = pair_keys(meshed["snp_0"], meshed["snp_1"], m)
    same = np.array_equal(np.sort(ks), np.sort(km))
    r_p = np.inf
    if same:
        ps = np.asarray(single["p"])[np.argsort(ks)]
        pm = np.asarray(meshed["p"])[np.argsort(km)]
        r_p = float(np.max(np.abs(ps - pm) / np.maximum(np.abs(ps), 1e-300),
                           initial=0.0))
    ok = same and r_p <= rtol_p
    return ok, (f"{len(ks)} vs {len(km)} pairs, same set: {same}, "
                f"max rel p diff {r_p:.3e} (rtol {rtol_p})")


# device oracle ---------------------------------------------------------------

def oracle_screen(a64, py64, cut_hi: float, hit_i, hit_j, block: int = 4096):
    """Float64 |eff| oracle with plain jnp: returns (core_i, core_j,
    hit_eff64), where the core is every pair j > i with
    |eff64(i, j)| > cut_hi and hit_eff64 is eff64 at the given hits.
    eff(i, j) = sum_k a_ki py_k a_kj."""
    import jax
    import jax.numpy as jnp

    n, m = a64.shape
    m_pad = -(-m // block) * block
    a_anchor = jnp.pad(a64, ((0, 0), (0, m_pad - m))) * py64[:, None]

    @jax.jit
    def core_block(anchor, a, start):
        blk = jax.lax.dynamic_slice_in_dim(anchor, start, block, axis=1)
        s = jnp.matmul(blk.T, a, precision=jax.lax.Precision.HIGHEST)
        i = start + jnp.arange(block)[:, None]
        j = jnp.arange(m)[None, :]
        return (jnp.abs(s) > cut_hi) & (j > i) & (i < m)

    ci, cj = [], []
    for start in range(0, m_pad, block):
        r, c = np.nonzero(np.asarray(core_block(a_anchor, a64, start)))
        ci.append(r + start)
        cj.append(c)

    @jax.jit
    def eff_at(a, py, i, j):
        return jnp.sum(a[:, i] * py[:, None] * a[:, j], axis=0)

    hit_i = np.asarray(hit_i, np.int64)
    hit_j = np.asarray(hit_j, np.int64)
    effs = [np.asarray(eff_at(a64, py64, jnp.asarray(hit_i[s:s + 8192]),
                              jnp.asarray(hit_j[s:s + 8192])))
            for s in range(0, len(hit_i), 8192)]
    hit_eff = np.concatenate(effs) if effs else np.empty(0)
    return np.concatenate(ci), np.concatenate(cj), hit_eff


def host_retest(geno: np.ndarray, pymat: np.ndarray, pvpmat: np.ndarray,
                i, j) -> dict:
    """Exact epiAA test of pairs (i, j) in numpy float64."""
    from scipy.stats import chi2

    def coded(cols):
        g = geno[:, cols].astype(np.float64)
        return g - geno.mean(axis=0, dtype=np.float64)[cols]

    e = coded(i) * coded(j)
    eff = e.T @ pymat
    var = np.sum(e * (pvpmat @ e), axis=0)
    chi = eff * eff / var
    return {"eff": eff, "chi": chi, "p": chi2.sf(chi, 1)}


# phases ----------------------------------------------------------------------

def make_cohort(td: Path, n: int, m: int, seed: int = SEED):
    """Seeded synthetic PLINK fileset + phenotype (five planted AxA pairs
    plus noise) under `td`; returns (prefix, pheno_file, genotypes)."""
    from gmat_tpu.io.bed import write_bed

    rng = np.random.default_rng(seed)
    freqs = rng.uniform(0.05, 0.95, size=m)
    geno = rng.binomial(2, freqs[None, :], size=(n, m)).astype(np.uint8)
    prefix = str(td / "plink")
    write_bed(prefix, geno)
    y = rng.standard_normal(n)
    for _ in range(5):
        i, j = rng.choice(m, size=2, replace=False)
        gi = geno[:, i] - geno[:, i].mean()
        gj = geno[:, j] - geno[:, j].mean()
        y += 0.4 * gi * gj
    pheno = td / "pheno"
    with open(prefix + ".fam") as fam, open(pheno, "w") as f:
        for line, yv in zip(fam, y):
            fid, iid = line.split()[:2]
            f.write(f"{fid} {iid} 1 {float(yv)!r}\n")
    return prefix, str(pheno), geno


class ScreenRecorder:
    """Records what the approx pipeline's screen stage saw and produced
    (the cut table, GRMs, variances and raw hits) and the first fused
    screen program's arguments, for the oracle and memory analysis."""

    def __init__(self):
        from gmat_tpu.scan import screen

        self.screen = screen
        self.engine = {}
        self.fused_args = None

    def __enter__(self):
        screen = self.screen
        orig_engine = screen._screen_engine
        orig_fused = screen._fused_screen_scan
        sig = inspect.signature(orig_engine)

        def engine(*a, **k):
            out = orig_engine(*a, **k)
            self.engine = dict(sig.bind(*a, **k).arguments, hits=out)
            return out

        def fused(*a, **k):
            if self.fused_args is None:
                self.fused_args = (a, k)
            return orig_fused(*a, **k)

        self._orig = (orig_engine, orig_fused)
        screen._screen_engine, screen._fused_screen_scan = engine, fused
        return self

    def __exit__(self, *exc):
        self.screen._screen_engine, self.screen._fused_screen_scan = self._orig

    def memory_analysis(self):
        if self.fused_args is None:
            return None
        a, k = self.fused_args
        return self.screen._fused_screen_scan.lower(*a, **k).compile() \
            .memory_analysis()


def device_report(rep: Report) -> dict:
    import jax
    import jax.numpy as jnp

    from gmat_tpu.io.bed import _load_native

    dev = jax.devices()[0]
    info = {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}
    rep.line(f"device: {info}; jax {jax.__version__}; "
             f"x64 {bool(jax.config.read('jax_enable_x64'))}")
    rep.line(f"card (name, power limit): {rep.card}")
    rep.line(".bed decoder: "
             + ("native C++ (csrc/)" if _load_native() is not None
                else "numpy fallback"))
    key = jax.random.PRNGKey(SEED)
    x = jax.random.normal(key, (4096, 4096), jnp.float32)
    y = jax.random.normal(jax.random.fold_in(key, 1), (4096, 4096),
                          jnp.float32)
    d = jnp.matmul(x, y)
    h = jnp.matmul(x, y, precision=jax.lax.Precision.HIGHEST)
    err = float(jnp.linalg.norm(d - h) / jnp.linalg.norm(h))
    rep.line(f"f32 4096^2 matmul, default vs HIGHEST precision: relative "
             f"error {err:.3e} ({'TF32-like' if err > 1e-5 else 'full f32'}"
             f" default)")
    try:
        import pandas  # noqa: F401
        rep.line("pandas: installed")
    except ImportError:
        rep.line("pandas: not installed")
    return info


def yeast_phase(rep: Report, td: Path) -> None:
    import jax
    import jax.numpy as jnp

    from gmat_tpu import agmat, remma_epiAA_approx, wemai_multi_gmat
    from gmat_tpu.io.pheno import design_matrix
    from gmat_tpu.io.text import read_numeric_table
    from gmat_tpu.reml.wemai import _reml_step, build_zgzt_stack
    from gmat_tpu.scan import screen
    from gmat_tpu.scan.common import (design_matrix_cached,
                                      prepare_genotypes_device,
                                      score_pieces_cached)

    n, m = YEAST_N, YEAST_M
    rep.line(f"REMMAX at the yeast shape: n={n}, m={m}, "
             f"{m * (m - 1) // 2} pairs, seed {SEED}")
    with timed(rep, "cohort synthesis + write_bed (host)"):
        prefix, pheno, geno = make_cohort(td, n, m)
    with timed(rep, "agmat"):
        ag, _ = agmat(prefix)
    gmat_lst = [ag, ag * ag]
    with timed(rep, "wemai_multi_gmat"):
        var = wemai_multi_gmat(pheno, prefix, gmat_lst,
                               out_file=str(td / "var"))
    rep.line(f"variance components: {var.tolist()}")
    out = td / "epiAA_approx"
    with ScreenRecorder() as recorder, timed(rep, "remma_epiAA_approx"):
        remma_epiAA_approx(pheno, prefix, gmat_lst, var, p_cut=P_CUT,
                           num_random_pair=NUM_RANDOM_PAIR,
                           out_file=str(out), seed=SEED)
    for stage, sec in screen.LAST_APPROX_STAGES.items():
        rep.time(f"approx stage {stage}", sec)
    stats = jax.devices()[0].memory_stats() or {}
    rep.line(f"peak device memory: {stats.get('peak_bytes_in_use')} bytes")
    rep.line(f"fused screen program memory analysis: "
             f"{recorder.memory_analysis()}")

    # (a) screen hit set against a float64 oracle on the device
    eng = recorder.engine
    hit_i, hit_j, _ = eng["hits"]
    cut = float(np.asarray(eng["eff_cut_table"]).ravel()[0])
    prec = jax.lax.Precision(screen.SCREEN_PRECISION).name
    slack = screen._screen_slack()
    delta = SCREEN_DELTA[prec]
    dm = design_matrix_cached(pheno, prefix)
    pieces = score_pieces_cached(dm, eng["gmat_lst"], eng["var_com"])
    g, _ = prepare_genotypes_device(prefix)
    a64 = g - jnp.mean(g, axis=0)[None, :]
    with timed(rep, "float64 screen oracle (device)"):
        core_i, core_j, hit_eff = oracle_screen(
            a64, pieces.pymat, cut * (1.0 + delta), hit_i, hit_j)
    rep.check("screen vs float64 oracle", *screen_bracket(
        hit_i, hit_j, hit_eff, core_i, core_j, m, cut, slack, delta))
    rep.line(f"  screen precision {prec} (float32 panel), slack {slack}; "
             f"oracle precision float64")
    del a64

    # (b) 1,000 re-tested pairs against numpy float64 on the host
    res = read_numeric_table(str(out))
    rows = len(res["p"])
    pick = np.random.default_rng(SEED).choice(rows, size=min(1000, rows),
                                              replace=False)
    i = res["snp_0"][pick].astype(np.int64)
    j = res["snp_1"][pick].astype(np.int64)
    want = host_retest(geno, np.asarray(pieces.pymat),
                       np.asarray(pieces.pvpmat), i, j)
    got = {"eff": res["eff"][pick], "chi": res["chi"][pick],
           "p": res["p"][pick]}
    rep.check("exact re-test vs numpy float64",
              *retest_agreement(got, want))

    # (c) one REML step on the GPU against the host CPU, float64
    cpu = jax.devices("cpu")[0]
    dm = design_matrix(pheno, prefix)
    zg = build_zgzt_stack(dm, gmat_lst)
    args = (jnp.ones(len(gmat_lst) + 1), jnp.asarray(dm.y),
            jnp.asarray(dm.xmat), zg)
    with timed(rep, "REML step (GPU, incl. compile)"):
        on_gpu = jax.device_get(_reml_step(*args))
    with timed(rep, "REML step (host CPU, incl. compile)"):
        on_cpu = jax.device_get(_reml_step(*jax.device_put(args, cpu)))
    names = ("var_new", "-2logL", "cc_par", "cc_gra")
    rels = {k: float(np.max(np.abs(np.asarray(a) - np.asarray(b))
                            / np.maximum(np.abs(np.asarray(b)), 1e-300)))
            for k, a, b in zip(names, on_gpu[:4], on_cpu[:4])}
    ok = (all(v <= RTOL_REML for v in rels.values())
          and float(on_gpu[4]) == float(on_cpu[4]))
    rep.check("REML step GPU vs CPU", ok,
              f"max rel diff {rels}, weight {float(on_gpu[4])} vs "
              f"{float(on_cpu[4])} (rtol {RTOL_REML}, float64)")


def golden_phase(rep: Report, td: Path) -> None:
    import jax.numpy as jnp

    from gmat_tpu.grm.grm import additive_grm, dominance_grm
    from gmat_tpu.io.bed import read_plink
    from gmat_tpu.io.pheno import design_matrix
    from gmat_tpu.reml.wemai import wemai_reml

    data, golden = ROOT / "tests" / "data", ROOT / "tests" / "golden"
    geno = jnp.asarray(read_plink(str(data / "plink")))
    ag, dg = np.asarray(additive_grm(geno)), np.asarray(dominance_grm(geno))
    dm = design_matrix(str(data / "pheno"), str(data / "plink"))
    gold = np.load(golden / "reml_var.npz")
    models = {"a_axa": [ag, ag * ag], "a_d_axa": [ag, dg, ag * ag],
              "a_d_axa_axd_dxd": [ag, dg, ag * ag, ag * dg, dg * dg]}
    for key, lst in models.items():
        with timed(rep, f"mouse REML {key}"):
            var = wemai_reml(dm, lst)
        err = np.abs(var - gold[key]) - (1e-10 + 1e-6 * np.abs(gold[key]))
        rep.check(f"mouse REML golden {key}", bool(np.all(err <= 0)),
                  f"max rel diff {np.max(np.abs(var / gold[key] - 1)):.3e} "
                  f"(rtol 1e-6, atol 1e-10)")
    try:
        import pandas  # noqa: F401
    except ImportError:
        rep.line("longwas goldens: not run (pandas is not installed)")
        return
    longwas_goldens(rep, td)


def longwas_goldens(rep: Report, td: Path) -> None:
    import shutil

    import pandas as pd

    from gmat_tpu.grm.grm import agmat
    from gmat_tpu.longwas.balance_gwas import (balance_longwas_fixed,
                                               balance_longwas_trans)

    ml = ROOT / "tests" / "data" / "mouse_long"
    golden = ROOT / "tests" / "golden"
    prefix = str(td / "mouse_long")
    for ext in (".bed", ".bim", ".fam"):
        shutil.copy(str(ml / ("plink" + ext)), prefix + ext)
    agmat(prefix, out_fmt="id_id_val")
    gv = np.load(golden / "longwas_balance_var.npz")
    var_df = pd.DataFrame({k: gv[k] for k in ("vari", "varij", "varik",
                                              "var_val")})
    g = np.load(golden / "longwas_balance_gwas.npz")
    args = (str(ml / "phe.balance.txt"), "ID", np.arange(16) + 1.0,
            list(range(2, 18)), prefix + ".agrm2", str(ml / "plink"), var_df)
    bands = {"trans": (balance_longwas_trans,
                       {"eff0": 1e-5, "eff1": 1e-5, "eff2": 1e-5,
                        "eff3": 1e-5, "chi_val": 1e-5, "p_val": 1e-4,
                        "p_min": 1e-4, "p_accum": 1e-4}),
             "fixed": (balance_longwas_fixed,
                       {"chi_val": 1e-6, "p_val": 1e-6, "eff0": 1e-6,
                        "eff1": 1e-6, "eff2": 1e-6, "eff3": 1e-6})}
    for which, (fn, cols) in bands.items():
        want = pd.DataFrame(g[which], columns=list(g[which + "_cols"]))
        with timed(rep, f"longwas {which} (30 SNPs)"):
            res = fn(*args, snp_lst=list(range(30)),
                     prefix_outfile=str(td / which))
        worst = {}
        ok = True
        for col, rtol in cols.items():
            a = res[col].to_numpy(float)
            b = want[col].to_numpy(float)
            atol = 1e-12 if col.startswith("p") else 1e-10
            ok &= bool(np.all(np.abs(a - b) <= atol + rtol * np.abs(b)))
            worst[col] = float(np.max(np.abs(a - b)
                                      / np.maximum(np.abs(b), 1e-300)))
        rep.check(f"longwas {which} golden", ok,
                  f"max rel diffs {worst} (bands {cols})")


def mesh_phase(rep: Report, td: Path, chips: int) -> None:
    from gmat_tpu import agmat, remma_epiAA_approx
    from gmat_tpu.dist.mesh import make_mesh
    from gmat_tpu.io.text import read_numeric_table

    n, m = YEAST_N, YEAST_M
    rep.line(f"mesh path: remma_epiAA_approx at n={n}, m={m} on a "
             f"{chips}-device mesh vs one device")
    prefix, pheno, _ = make_cohort(td, n, m)
    ag, _ = agmat(prefix)
    gmat_lst = [ag, ag * ag]
    var = np.array([0.4, 0.1, 0.6])  # fixed components: no REML here
    outs = {}
    for label, mesh in (("single", None), ("mesh", make_mesh(chips))):
        out = td / f"approx_{label}"
        with timed(rep, f"remma_epiAA_approx {label} (incl. compile)"):
            remma_epiAA_approx(pheno, prefix, gmat_lst, var, p_cut=P_CUT,
                               num_random_pair=NUM_RANDOM_PAIR,
                               out_file=str(out), seed=SEED, mesh=mesh)
        outs[label] = out
    rep.check("mesh vs single-device approx", *mesh_agreement(
        read_numeric_table(str(outs["single"])),
        read_numeric_table(str(outs["mesh"])), m))
    same = outs["single"].read_bytes() == outs["mesh"].read_bytes()
    rep.line(f"mesh output bytes identical to single-device: {same}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--chips", type=int, default=1, choices=(1, 4),
                        help="4: run only the mesh path on four GPUs")
    args = parser.parse_args(argv)

    import jax

    try:
        gpus = jax.devices("gpu")
    except RuntimeError:
        gpus = []
    if not gpus:
        print("chip_smoke: JAX finds no GPU", file=sys.stderr)
        return 2
    if len(gpus) < args.chips:
        print(f"chip_smoke: {args.chips} GPUs needed, {len(gpus)} found",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    try:
        import gmat_tpu
    except ImportError as exc:
        print(f"chip_smoke: the gmat_tpu package is missing ({exc})",
              file=sys.stderr)
        return 2
    if Path(gmat_tpu.__file__).resolve().parents[1] != ROOT:
        print("chip_smoke: gmat_tpu must come from this checkout",
              file=sys.stderr)
        return 2
    from gmat_tpu.config import use_compile_cache
    from gmat_tpu.core.roofline import card_name_and_power_limit

    rep = Report()
    rep.card = " | ".join(card_name_and_power_limit().splitlines())
    rep.line(f"compilation cache: {use_compile_cache()}")
    info = device_report(rep)
    with tempfile.TemporaryDirectory() as tmp:
        td = Path(tmp)
        phases = ([("mesh", lambda: mesh_phase(rep, td, args.chips))]
                  if args.chips > 1 else
                  [("yeast", lambda: yeast_phase(rep, td)),
                   ("goldens", lambda: golden_phase(rep, td))])
        for name, fn in phases:
            try:
                fn()
            except Exception as exc:  # report, run the rest, exit non-zero
                import traceback

                traceback.print_exc()
                rep.check(f"phase {name}", False, repr(exc))
    rep.line(f"card (name, power limit): {rep.card}")
    if rep.failed:
        print(f"chip_smoke: failed: {', '.join(rep.failed)}", file=sys.stderr)
        return 1
    info["count"] = len(jax.devices())
    print(json.dumps({"ok": True, "device": info}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
