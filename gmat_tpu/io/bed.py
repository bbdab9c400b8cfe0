"""PLINK binary genotype IO.

Three decode paths, all producing the reference's genotype convention —
PLINK 2-bit codes {0b00, 0b01, 0b10, 0b11} -> {0, missing, 1, 2}
(reference `/root/reference/gmat/process_plink/_read_plink_bed.c:37`,
`read_plink_bed.py:26-28`):

1. native C++/OpenMP decoder (csrc/bed_reader.cpp, loaded via ctypes) — the
   host-side fast path, replacing the reference's cffi `_cread_plink_bed`.
2. pure-numpy bit-twiddling fallback (no build step required).
3. `unpack_codes_device` — a jitted jnp unpacker taking the *raw packed bytes*
   so genotypes cross host->device 16x compressed and are expanded on the
   device.  The reference has no equivalent.

`read_plink` mirrors the reference API (`process_plink/process_plink.py:7-9`):
returns a (num_id, num_snp) float array with NaN for missing genotypes.
"""
from __future__ import annotations

import ctypes
import logging
import subprocess
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from gmat_tpu.io.text import count_records

_CSRC = Path(__file__).resolve().parents[2] / "csrc"
_LIB_PATH = _CSRC / "libgmat_native.so"
_MAGIC = b"\x6c\x1b\x01"

_lib = None
_lib_tried = False


def _load_native():
    """Load (building if needed) the native decoder; returns None on failure."""
    global _lib, _lib_tried
    if _lib_tried:
        return _lib
    _lib_tried = True
    try:
        if not _LIB_PATH.exists():
            subprocess.run(
                ["make", "-s", "-C", str(_CSRC)], check=True, capture_output=True
            )
        lib = ctypes.CDLL(str(_LIB_PATH))
        lib.gmat_read_bed_f64.restype = ctypes.c_int
        lib.gmat_read_bed_f64.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_double),
        ]
        lib.gmat_read_bed_f32.restype = ctypes.c_int
        lib.gmat_read_bed_f32.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float),
        ]
        lib.gmat_read_bed_raw.restype = ctypes.c_int
        lib.gmat_read_bed_raw.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_ubyte),
        ]
        _lib = lib
    except (OSError, AttributeError, subprocess.CalledProcessError) as exc:
        detail = getattr(exc, "stderr", b"") or b""
        logging.getLogger(__name__).warning(
            "native .bed decoder unavailable, using numpy: %r %s", exc,
            detail.decode(errors="replace").strip())
        _lib = None
    return _lib


@dataclass
class Bed:
    """PLINK fileset handle: `<prefix>.bed/.bim/.fam`.

    Reference equivalent: `process_plink/read_plink_bed.py:6-28` (class Bed).
    The counts and individual ids need numpy only; the `bim`/`fam` tables
    are pandas DataFrames, read on first access.
    """

    prefix: str

    def __post_init__(self):
        self.num_snp = count_records(self.prefix + ".bim")
        self.num_id = count_records(self.prefix + ".fam")

    @property
    def bim(self):
        return read_bim(self.prefix + ".bim")

    @property
    def fam(self):
        return read_fam(self.prefix + ".fam")

    @property
    def iids(self) -> np.ndarray:
        """Individual ids (second `.fam` column), as strings."""
        with open(self.prefix + ".fam") as fin:
            return np.array([line.split()[1] for line in fin if line.strip()])

    def read(self, dtype=np.float64) -> np.ndarray:
        """Decode to a dense (num_id, num_snp) array, NaN for missing."""
        return _decode(self.prefix + ".bed", self.num_id, self.num_snp, dtype)

    def read_raw(self) -> np.ndarray:
        """Raw packed codes, shape (num_snp, bytes_per_snp) uint8."""
        return read_bed_raw(self.prefix + ".bed", self.num_id, self.num_snp)


def read_bim(path: str):
    """The `.bim` table as a pandas DataFrame."""
    import pandas as pd

    df = pd.read_csv(path, sep=r"\s+", header=None)
    df.columns = ["chro", "snp_ID", "cm", "pos", "allele1", "allele2"][: df.shape[1]]
    return df


def read_fam(path: str):
    """The `.fam` table as a pandas DataFrame."""
    import pandas as pd

    df = pd.read_csv(path, sep=r"\s+", header=None)
    cols = ["fid", "iid", "father", "mother", "sex", "pheno"]
    df.columns = cols[: df.shape[1]] + list(df.columns[len(cols):])
    return df


def read_plink(bed_prefix: str, dtype=np.float64) -> np.ndarray:
    """(num_id, num_snp) genotype dosage array with NaN for missing.

    API parity with reference `process_plink.read_plink` (process_plink.py:7-9).
    """
    return Bed(bed_prefix).read(dtype=dtype)


def _decode(bed_path: str, num_id: int, num_snp: int, dtype) -> np.ndarray:
    lib = _load_native()
    dtype = np.dtype(dtype)
    if lib is not None and dtype in (np.float64, np.float32):
        out = np.empty((num_id, num_snp), dtype=dtype)
        fn = lib.gmat_read_bed_f64 if dtype == np.float64 else lib.gmat_read_bed_f32
        ptr_t = ctypes.c_double if dtype == np.float64 else ctypes.c_float
        rc = fn(
            bed_path.encode(),
            num_id,
            num_snp,
            out.ctypes.data_as(ctypes.POINTER(ptr_t)),
        )
        if rc != 0:
            raise IOError(f"native bed decode failed (rc={rc}) for {bed_path}")
        return out
    return _decode_numpy(bed_path, num_id, num_snp).astype(dtype, copy=False)


def _decode_numpy(bed_path: str, num_id: int, num_snp: int) -> np.ndarray:
    raw = read_bed_raw(bed_path, num_id, num_snp)
    codes = np.stack(
        [(raw >> shift) & 3 for shift in (0, 2, 4, 6)], axis=-1
    ).reshape(num_snp, -1)[:, :num_id]
    lut = np.array([0.0, np.nan, 1.0, 2.0])
    return lut[codes].T.copy()


def read_bed_raw(bed_path: str, num_id: int, num_snp: int) -> np.ndarray:
    """Packed 2-bit codes as uint8, shape (num_snp, bytes_per_snp)."""
    bytes_per_snp = (num_id + 3) // 4
    with open(bed_path, "rb") as f:
        header = f.read(3)
        if header != _MAGIC:
            raise IOError(f"{bed_path}: not a SNP-major PLINK .bed file")
        raw = np.fromfile(f, dtype=np.uint8)
    expect = bytes_per_snp * num_snp
    if raw.size != expect:
        raise IOError(f"{bed_path}: expected {expect} payload bytes, got {raw.size}")
    return raw.reshape(num_snp, bytes_per_snp)


def unpack_codes_device(raw, num_id: int, missing_value: float = float("nan")):
    """On-device unpack of packed codes -> (num_id, num_snp) float array.

    `raw` is the (num_snp, bytes_per_snp) uint8 array (possibly already a
    sharded device array).  Genotypes travel to HBM 16x compressed; the unpack
    is a handful of VPU ops and XLA fuses it into downstream consumers.
    """
    import jax.numpy as jnp

    num_snp = raw.shape[0]
    shifts = jnp.array([0, 2, 4, 6], dtype=jnp.uint8)
    codes = (raw[..., None] >> shifts) & jnp.uint8(3)
    codes = codes.reshape(num_snp, -1)[:, :num_id]
    lut = jnp.array([0.0, missing_value, 1.0, 2.0])
    return jnp.take(lut, codes.astype(jnp.int32)).T


def impute_geno(snp_mat: np.ndarray, seed: int = 0) -> np.ndarray:
    """Fill missing genotypes by sampling {0,1,2} with the observed per-SNP
    genotype-class frequencies.

    Parity: reference `process_plink.impute_geno` (process_plink.py:12-25),
    except the reference's RNG is *unseeded* (nondeterministic); we seed it
    (documented policy — SURVEY.md §5 quirks list) so pipelines and golden
    tests are reproducible.
    """
    rng = np.random.default_rng(seed)
    snp_mat = np.array(snp_mat, copy=True)
    nan_cols = np.unique(np.where(np.isnan(snp_mat))[1])
    for j in nan_cols:
        col = snp_mat[:, j]
        missing = np.isnan(col)
        counts = np.array(
            [np.sum(col[~missing] == v) for v in (0.0, 1.0, 2.0)], dtype=np.float64
        )
        total = counts.sum()
        if total == 0:
            raise ValueError(f"SNP column {j} has no observed genotypes")
        col[missing] = rng.choice([0.0, 1.0, 2.0], size=missing.sum(), p=counts / total)
        snp_mat[:, j] = col
    return snp_mat


def write_bed(prefix: str, geno: np.ndarray, bim=None, fam=None) -> None:
    """Write a (num_id, num_snp) {0,1,2,NaN} genotype array as a PLINK fileset.

    Used by `shuffle_bed` and the simulators; the reference relied on the
    optional pysnptools dependency for this (process_plink.py:28-47).
    `bim`/`fam` are DataFrames to write as they are; when omitted, numbered
    placeholder records are written (with numpy only).
    """
    num_id, num_snp = geno.shape
    code_lut = {0.0: 0, 1.0: 2, 2.0: 3}
    codes = np.full(geno.shape, 1, dtype=np.uint8)  # missing
    for val, code in code_lut.items():
        codes[geno == val] = code
    pad = (-num_id) % 4
    if pad:
        codes = np.concatenate(
            [codes, np.zeros((pad, num_snp), dtype=np.uint8)], axis=0
        )
    by_snp = codes.T.reshape(num_snp, -1, 4)
    packed = (
        by_snp[:, :, 0]
        | (by_snp[:, :, 1] << 2)
        | (by_snp[:, :, 2] << 4)
        | (by_snp[:, :, 3] << 6)
    ).astype(np.uint8)
    with open(prefix + ".bed", "wb") as f:
        f.write(_MAGIC)
        packed.tofile(f)
    if bim is None:
        with open(prefix + ".bim", "w") as f:
            f.writelines(f"1\tsnp{i}\t0\t{i + 1}\tA\tB\n"
                         for i in range(num_snp))
    else:
        bim.to_csv(prefix + ".bim", sep="\t", header=False, index=False)
    if fam is None:
        with open(prefix + ".fam", "w") as f:
            f.writelines(f"f{i}\ti{i}\t0\t0\t0\t-9\n" for i in range(num_id))
    else:
        fam.to_csv(prefix + ".fam", sep="\t", header=False, index=False)


def shuffle_bed(bed_prefix: str, seed: int = 0) -> str:
    """Permute genotypes independently per SNP, writing `<prefix>_shuffle.*`.

    Parity: reference `process_plink.shuffle_bed` (process_plink.py:28-47)
    minus its pysnptools dependency and `logging.INFO(...)` bug; seeded.
    """
    bed = Bed(bed_prefix)
    geno = bed.read()
    rng = np.random.default_rng(seed)
    for j in range(geno.shape[1]):
        rng.shuffle(geno[:, j])
    out_prefix = bed_prefix + "_shuffle"
    write_bed(out_prefix, geno, bim=bed.bim, fam=bed.fam)
    return out_prefix
