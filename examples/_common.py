"""Shared example-script setup: logging, fixture paths, out dir.

The examples run on JAX's default device; pick the platform with
`JAX_PLATFORMS` (e.g. `JAX_PLATFORMS=cpu` for the CPU).
"""
from __future__ import annotations

import logging
import shutil
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
DATA = REPO / "tests" / "data"
MOUSE_LONG = DATA / "mouse_long"

logging.basicConfig(level=logging.INFO, stream=sys.stdout,
                    format="%(levelname)s %(name)s: %(message)s")


def out_dir(script_file: str) -> Path:
    out = Path(script_file).resolve().parent / "out"
    out.mkdir(exist_ok=True)
    return out


def stage_mouse(out: Path) -> str:
    """Copy the mouse fixture next to the outputs (GRM writers drop their
    files beside the .bed, like the reference's `<bed>.agrm0` contract)."""
    for ext in (".bed", ".bim", ".fam"):
        shutil.copy(DATA / ("plink" + ext), out / ("plink" + ext))
    shutil.copy(DATA / "pheno", out / "pheno")
    return str(out / "plink")


def stage_mouse_long(out: Path) -> str:
    for ext in (".bed", ".bim", ".fam"):
        shutil.copy(MOUSE_LONG / ("plink" + ext), out / ("plink" + ext))
    for f in ("phe.balance.txt", "phe.unbalance.txt"):
        shutil.copy(MOUSE_LONG / f, out / f)
    return str(out / "plink")
