"""Command-line interface for the standard REMMAX workflows.

The reference has no CLI (SURVEY.md §1: "the user-facing API is Python
functions orchestrated manually per README recipes"); this wraps the same
4-step recipe plus the longwas pipelines as subcommands:

    gmat-tpu agmat plink --inv --out-fmt id_id_val
    gmat-tpu reml pheno plink --grm ag --grm 'ag*ag' --out var.txt
    gmat-tpu remma-add pheno plink --var var.txt --out remma_add
    gmat-tpu epiaa-approx pheno plink --var var.txt --p-cut 1e-5 --out epiAA
    gmat-tpu annotate epiAA plink --p-cut 1e-5
    gmat-tpu longwas-balance-varcom data.txt --id ID --tpoints 1..16 ...
"""
from __future__ import annotations

import argparse
import logging
import sys

import numpy as np


def _load_grms(specs, bed_prefix):
    """Parse --grm specs: 'ag', 'dg', or products like 'ag*ag', 'ag*dg'."""
    import jax.numpy as jnp

    from gmat_tpu.grm.grm import additive_grm, dominance_grm
    from gmat_tpu.io.bed import read_plink

    geno = jnp.asarray(read_plink(bed_prefix))
    base = {}
    mats = []
    for spec in specs:
        prod = None
        for term in spec.split("*"):
            term = term.strip()
            if term not in ("ag", "dg"):
                raise SystemExit(f"unknown GRM term {term!r} (use ag/dg)")
            if term not in base:
                fn = additive_grm if term == "ag" else dominance_grm
                base[term] = np.asarray(fn(geno))
            prod = base[term] if prod is None else prod * base[term]
        mats.append(prod)
    return mats


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="gmat-tpu",
        description="REMMAX on JAX: GRMs, REML, epistasis scans, longwas",
    )
    parser.add_argument("-v", "--verbose", action="store_true")
    parser.add_argument(
        "--devices", type=int, default=None, metavar="N",
        help="shard the compute over an N-device mesh (0 = all local "
             "devices; omit for single-device). For multi-host clusters "
             "call gmat_tpu.dist.initialize_multihost first and pass 0.",
    )
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("agmat", help="additive GRM")
    p.add_argument("bed_prefix")
    p.add_argument("--inv", action="store_true")
    p.add_argument("--small-val", type=float, default=0.001)
    p.add_argument("--out-fmt", default="mat",
                   choices=["mat", "row_col_val", "id_id_val"])

    p = sub.add_parser("dgmat", help="dominance GRM")
    p.add_argument("bed_prefix")
    p.add_argument("--inv", action="store_true")
    p.add_argument("--small-val", type=float, default=0.001)
    p.add_argument("--out-fmt", default="mat",
                   choices=["mat", "row_col_val", "id_id_val"])

    p = sub.add_parser("inbreed", help="genomic inbreeding coefficients")
    p.add_argument("bed_prefix")

    p = sub.add_parser("reml", help="multi-GRM weighted EM+AI REML")
    p.add_argument("pheno")
    p.add_argument("bed_prefix")
    p.add_argument("--grm", action="append", required=True,
                   help="GRM spec: ag, dg, ag*ag, ag*dg, dg*dg (repeatable)")
    p.add_argument("--maxiter", type=int, default=200)
    p.add_argument("--out", default="wemai_multi_gmat.var")

    for name, helptext in (("remma-add", "additive score test"),
                           ("remma-dom", "dominance score test")):
        p = sub.add_parser(name, help=helptext)
        p.add_argument("pheno")
        p.add_argument("bed_prefix")
        p.add_argument("--grm", action="append", required=True)
        p.add_argument("--var", required=True, help="variance file from reml")
        p.add_argument("--out", default=name.replace("-", "_"))

    for kind in ("aa", "ad", "dd"):
        p = sub.add_parser(f"epi{kind}", help=f"exact epi{kind.upper()} scan")
        p.add_argument("pheno")
        p.add_argument("bed_prefix")
        p.add_argument("--grm", action="append", required=True)
        p.add_argument("--var", required=True)
        p.add_argument("--p-cut", type=float, default=1.0e-5)
        p.add_argument("--parallel", nargs=2, type=int, metavar=("N", "I"))
        p.add_argument("--out", default=f"epi{kind.upper()}")

        p = sub.add_parser(f"epi{kind}-approx",
                           help=f"screen->exact epi{kind.upper()} pipeline")
        p.add_argument("pheno")
        p.add_argument("bed_prefix")
        p.add_argument("--grm", action="append", required=True)
        p.add_argument("--var", required=True)
        p.add_argument("--p-cut", type=float, default=1.0e-5)
        p.add_argument("--num-random-pair", type=int, default=100000)
        p.add_argument("--maf", action="store_true",
                       help="MAF-stratified thresholds")
        p.add_argument("--out", default=f"epi{kind.upper()}_approx")

    p = sub.add_parser("annotate", help="join scan results to .bim info")
    p.add_argument("res_file")
    p.add_argument("bed_prefix")
    p.add_argument("--p-cut", type=float, default=1.0)
    p.add_argument("--dis", type=float, default=0.0)
    p.add_argument("--ld-file")
    p.add_argument("--r2", type=float, default=0.2)

    p = sub.add_parser("longwas-balance-varcom")
    p.add_argument("data_file")
    p.add_argument("--id", required=True)
    p.add_argument("--tpoints", required=True,
                   help="comma-separated timepoints, e.g. 1,2,...,16")
    p.add_argument("--traits", required=True,
                   help="comma-separated 0-based trait column indexes")
    p.add_argument("--kin-file", required=True)
    p.add_argument("--forder", type=int, default=3)
    p.add_argument("--rorder", type=int, default=3)
    p.add_argument("--maxiter", type=int, default=100)
    p.add_argument("--out", default="balance_varcom")

    p = sub.add_parser("longwas-unbalance-varcom")
    p.add_argument("data_file")
    p.add_argument("--id", required=True)
    p.add_argument("--tpoint", required=True, help="time column name")
    p.add_argument("--trait", required=True, help="trait column name")
    p.add_argument("--kin-inv-file", required=True)
    p.add_argument("--maxiter", type=int, default=100)
    p.add_argument("--out", default="unbalance_varcom")

    p = sub.add_parser("remmax", help="one-call pipeline: GRM -> REML -> "
                       "scan -> annotate (stage-resumable)")
    p.add_argument("pheno")
    p.add_argument("bed_prefix")
    p.add_argument("--out", default="remmax")
    p.add_argument("--model", default="a_axa",
                   choices=["a_axa", "a_d_axa", "a_d_axa_axd_dxd"])
    p.add_argument("--scan", default="epiAA_approx")
    p.add_argument("--p-cut", type=float, default=1.0e-5)
    p.add_argument("--num-random-pair", type=int, default=100000)
    p.add_argument("--dis", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--no-resume", action="store_true")

    p = sub.add_parser("bench", help="run the headline benchmark")

    args = parser.parse_args(argv)
    logging.basicConfig(
        level=logging.INFO if args.verbose else logging.WARNING,
        format="%(message)s",
    )

    from gmat_tpu.config import use_compile_cache

    use_compile_cache()
    mesh = None
    if args.devices is not None:
        from gmat_tpu.dist.mesh import make_mesh

        mesh = make_mesh(args.devices or None)

    if args.cmd == "agmat":
        from gmat_tpu.grm.grm import agmat

        agmat(args.bed_prefix, inv=args.inv, small_val=args.small_val,
              out_fmt=args.out_fmt, mesh=mesh)
    elif args.cmd == "dgmat":
        from gmat_tpu.grm.grm import dgmat_as

        dgmat_as(args.bed_prefix, inv=args.inv, small_val=args.small_val,
                 out_fmt=args.out_fmt, mesh=mesh)
    elif args.cmd == "inbreed":
        from gmat_tpu.grm.grm import ginbreedcoef

        ginbreedcoef(args.bed_prefix)
    elif args.cmd == "reml":
        from gmat_tpu.reml.wemai import wemai_multi_gmat

        gmat_lst = _load_grms(args.grm, args.bed_prefix)
        wemai_multi_gmat(args.pheno, args.bed_prefix, gmat_lst,
                         maxiter=args.maxiter, out_file=args.out)
    elif args.cmd in ("remma-add", "remma-dom"):
        from gmat_tpu.scan.single import remma_add, remma_dom

        gmat_lst = _load_grms(args.grm, args.bed_prefix)
        var = np.loadtxt(args.var)
        fn = remma_add if args.cmd == "remma-add" else remma_dom
        fn(args.pheno, args.bed_prefix, gmat_lst, var, out_file=args.out)
    elif args.cmd.startswith("epi") and not args.cmd.endswith("approx"):
        from gmat_tpu.scan import pairs

        kind = args.cmd[3:5].upper()
        gmat_lst = _load_grms(args.grm, args.bed_prefix)
        var = np.loadtxt(args.var)
        if args.parallel:
            fn = getattr(pairs, f"remma_epi{kind}_parallel")
            fn(args.pheno, args.bed_prefix, gmat_lst, var, args.parallel,
               p_cut=args.p_cut, out_file=args.out)
        else:
            fn = getattr(pairs, f"remma_epi{kind}")
            fn(args.pheno, args.bed_prefix, gmat_lst, var, p_cut=args.p_cut,
               out_file=args.out, mesh=mesh)
    elif args.cmd.endswith("approx"):
        from gmat_tpu.scan import screen

        kind = args.cmd[3:5].upper()
        gmat_lst = _load_grms(args.grm, args.bed_prefix)
        var = np.loadtxt(args.var)
        name = f"remma_epi{kind}_maf_approx" if args.maf else \
            f"remma_epi{kind}_approx"
        getattr(screen, name)(args.pheno, args.bed_prefix, gmat_lst, var,
                              p_cut=args.p_cut,
                              num_random_pair=args.num_random_pair,
                              out_file=args.out, mesh=mesh)
    elif args.cmd == "annotate":
        from gmat_tpu.scan.annotation import annotation_snp_pos

        annotation_snp_pos(args.res_file, args.bed_prefix, p_cut=args.p_cut,
                           dis=args.dis, ld_file=args.ld_file, r2=args.r2)
    elif args.cmd == "longwas-balance-varcom":
        from gmat_tpu.longwas.balance import balance_varcom

        tp = np.array([float(v) for v in args.tpoints.split(",")])
        traits = [int(v) for v in args.traits.split(",")]
        balance_varcom(args.data_file, args.id, tp, traits, args.kin_file,
                       forder=args.forder, rorder=args.rorder,
                       maxiter=args.maxiter, prefix_outfile=args.out)
    elif args.cmd == "longwas-unbalance-varcom":
        from gmat_tpu.longwas.unbalance import unbalance_varcom

        unbalance_varcom(args.data_file, args.id, args.tpoint, args.trait,
                         args.kin_inv_file, maxiter=args.maxiter,
                         prefix_outfile=args.out)
    elif args.cmd == "remmax":
        from gmat_tpu.pipeline.remmax import remmax

        remmax(args.pheno, args.bed_prefix, out_prefix=args.out,
               model=args.model, scan=args.scan, p_cut=args.p_cut,
               num_random_pair=args.num_random_pair, dis=args.dis,
               seed=args.seed, resume=not args.no_resume)
    elif args.cmd == "bench":
        import runpy
        from pathlib import Path

        runpy.run_path(str(Path(__file__).parents[1] / "bench.py"),
                       run_name="__main__")
    return 0


if __name__ == "__main__":
    sys.exit(main())
