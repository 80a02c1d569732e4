"""Host hashes in C over ctypes: keccak-f[1600], Keccak-256 and the
Poseidon2 permutation.

Port of `plonky3_tpu/native/__init__.py`. The card runs the wide batched
hashing; these serve the host tails where Python and numpy per-call
overhead dominates: the Fiat-Shamir keccak-256 and its proof-of-work
grind, the duplex transcript's Poseidon2 absorb, the host keccak-f
batches, the byte hashers' rows. The sources are the port's own copies,
`csrc/host/keccak.c` and `csrc/host/poseidon2.c`; the first call builds
them with the system C compiler (`cc -O3 -shared -fPIC`) into
`_build/p3host-<source hash>.so` (git-ignored), under a temporary name
and a rename, so that processes building at once do not race. A failed
build raises with the compiler's output: there is no fallback, and no
switch that turns the library off. The numpy and torch versions in
`hashes/` stay as the plain versions the tests hold these against.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

_SRC_DIR = Path(__file__).resolve().parent.parent / "csrc" / "host"
SOURCES = ("keccak.c", "poseidon2.c")
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"

_LIBS: dict = {}
_u32p = ctypes.POINTER(ctypes.c_uint32)
_u8p = ctypes.POINTER(ctypes.c_uint8)
_SIGNATURES = {
    "p3_keccakf_batch": ([ctypes.POINTER(ctypes.c_uint64), ctypes.c_size_t],
                         None),
    "p3_keccak256": ([ctypes.c_char_p, ctypes.c_size_t, _u8p], None),
    "p3_keccak256_rows": ([_u8p, ctypes.c_size_t, ctypes.c_size_t, _u8p],
                          None),
    "p3_keccak256_grind": ([ctypes.c_char_p, ctypes.c_size_t, _u32p,
                            ctypes.c_size_t, ctypes.c_uint32],
                           ctypes.c_int64),
    "p3_p2_permute": ([_u32p, ctypes.c_uint32, ctypes.c_int, ctypes.c_int,
                       _u32p, ctypes.c_int, _u32p, ctypes.c_int, _u32p,
                       ctypes.c_int, _u32p], None),
    "p3_p2_duplex_chain": ([_u32p, _u32p, ctypes.c_size_t, ctypes.c_uint32,
                            ctypes.c_int, ctypes.c_int, ctypes.c_int,
                            _u32p, ctypes.c_int, _u32p, ctypes.c_int,
                            _u32p, ctypes.c_int, _u32p], None),
}


def so_path(build_dir=None) -> Path:
    digest = hashlib.sha256()
    for name in SOURCES:
        digest.update((_SRC_DIR / name).read_bytes())
    name = f"p3host-{digest.hexdigest()[:16]}.so"
    return Path(build_dir or BUILD_DIR) / name


def _compiler() -> str:
    for cc in ("cc", "gcc", "clang"):
        path = shutil.which(cc)
        if path:
            return path
    raise RuntimeError("no C compiler (cc, gcc or clang) found: the host "
                       "hashes in csrc/host/ cannot be built")


def build(build_dir=None) -> Path:
    """Build the library into `build_dir` (default `_build/`) unless it is
    there; returns its path. Raises with the compiler's output on a
    failure."""
    so = so_path(build_dir)
    if so.exists():
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_compiler(), "-O3", "-shared", "-fPIC",
           *(str(_SRC_DIR / name) for name in SOURCES), "-o", str(tmp)]
    run = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if run.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building csrc/host failed ({' '.join(cmd)}):\n"
                           f"{run.stdout}{run.stderr}")
    os.replace(tmp, so)
    return so


def lib(build_dir=None):
    """The loaded library (built on first use)."""
    key = str(build_dir or BUILD_DIR)
    hit = _LIBS.get(key)
    if hit is None:
        hit = ctypes.CDLL(str(build(build_dir)))
        for fn, (argtypes, restype) in _SIGNATURES.items():
            f = getattr(hit, fn)
            f.argtypes = argtypes
            f.restype = restype
        _LIBS[key] = hit
    return hit


def _u32arr(a, shape=None):
    """A contiguous u32 copy (or view) of `a` and its pointer; `shape`,
    where given, the shape the C function reads (-1: any length)."""
    a = np.ascontiguousarray(a, dtype=np.uint32)
    if shape is not None and (a.ndim != len(shape) or any(
            want not in (-1, got) for want, got in zip(shape, a.shape))):
        raise ValueError(f"a {a.shape} array where the C function reads "
                         f"{shape}")
    return a, a.ctypes.data_as(_u32p)


def _p2_tables(width, d, rc_ei, rc_int, rc_ef, diag):
    """The Poseidon2 constants' arrays and pointers, shapes checked (the C
    permutation takes a width of a multiple of 4 and d in {3, 5, 7})."""
    if width % 4 or d not in (3, 5, 7):
        raise ValueError(f"a width of {width} and an s-box degree of {d}")
    return (_u32arr(rc_ei, (-1, width)), _u32arr(rc_int, (-1,)),
            _u32arr(rc_ef, (-1, width)), _u32arr(diag, (width,)))


def keccakf_batch_u64(states: np.ndarray) -> np.ndarray:
    """keccak-f[1600] on (..., 25) uint64 states -> a new array."""
    st = np.array(states, dtype=np.uint64, order="C")
    if st.shape[-1:] != (25,):
        raise ValueError(f"keccak-f states of shape {st.shape}, not "
                         f"(..., 25)")
    n = st.size // 25
    lib().p3_keccakf_batch(st.ctypes.data_as(
        ctypes.POINTER(ctypes.c_uint64)), n)
    return st


def keccakf_batch_u32(lo: np.ndarray, hi: np.ndarray):
    """keccak-f[1600] on (n, 25) u32 (lo, hi) lane halves -> new (lo, hi)."""
    # the (n, 25, 2) u32 interleave is the little-endian u64 state layout
    st32 = np.empty(lo.shape + (2,), dtype=np.uint32)
    st32[..., 0] = lo
    st32[..., 1] = hi
    st = keccakf_batch_u64(st32.view(np.uint64)[..., 0]).view(np.uint32)
    st = st.reshape(lo.shape + (2,))
    return st[..., 0].copy(), st[..., 1].copy()


def keccak256(data: bytes) -> bytes:
    """One-shot Keccak-256 (0x01 padding, not SHA3-256)."""
    out = (ctypes.c_uint8 * 32)()
    lib().p3_keccak256(bytes(data), len(data), out)
    return bytes(out)


def keccak256_rows(rows: np.ndarray) -> np.ndarray:
    """Keccak-256 of each row of an (n, L) uint8 array -> (n, 32) uint8."""
    rows = np.ascontiguousarray(rows, dtype=np.uint8)
    n, L = rows.shape
    out = np.empty((n, 32), dtype=np.uint8)
    lib().p3_keccak256_rows(rows.ctypes.data_as(_u8p), n, L,
                            out.ctypes.data_as(_u8p))
    return out


def poseidon2_permute(state: np.ndarray, P: int, width: int, d: int,
                      rc_ei: np.ndarray, rc_int: np.ndarray,
                      rc_ef: np.ndarray, diag: np.ndarray) -> np.ndarray:
    """One Poseidon2 permutation of a (width,) standard-form state, with
    the constants in standard form ((rounds, width) external tables,
    (rounds,) internal, (width,) diagonal). Returns the new (width,) u32
    array."""
    st = np.array(state, dtype=np.uint32)  # owned, permuted in place
    _, stp = _u32arr(st, (width,))
    (ei, eip), (ii, iip), (ef, efp), (_, dgp) = _p2_tables(
        width, d, rc_ei, rc_int, rc_ef, diag)
    lib().p3_p2_permute(stp, P, width, d, eip, ei.shape[0], iip,
                        ii.shape[0], efp, ef.shape[0], dgp)
    return st


def poseidon2_duplex_chain(state: np.ndarray, blocks: np.ndarray, P: int,
                           width: int, rate: int, d: int,
                           rc_ei: np.ndarray, rc_int: np.ndarray,
                           rc_ef: np.ndarray, diag: np.ndarray) -> np.ndarray:
    """Absorb (nb, rate) standard-form full blocks into a (width,) duplex
    state (per block: overwrite the rate lanes, add the length tag, permute).
    Returns the new state."""
    if not 0 < rate < width:
        raise ValueError(f"a rate of {rate} for width {width}")
    st = np.array(state, dtype=np.uint32)
    _, stp = _u32arr(st, (width,))
    bl, blp = _u32arr(blocks, (-1, rate))
    (ei, eip), (ii, iip), (ef, efp), (_, dgp) = _p2_tables(
        width, d, rc_ei, rc_int, rc_ef, diag)
    lib().p3_p2_duplex_chain(stp, blp, bl.shape[0], P, width, rate, d, eip,
                             ei.shape[0], iip, ii.shape[0], efp, ef.shape[0],
                             dgp)
    return st


def keccak256_grind(prefix: bytes, wire: np.ndarray, mask: int) -> int:
    """The first index i with (the last four digest bytes of
    keccak256(prefix || wire[i] as 4 LE bytes), big-endian) & mask == 0,
    or -1."""
    wire, wp = _u32arr(wire, (-1,))
    return int(lib().p3_keccak256_grind(bytes(prefix), len(prefix), wp,
                                        wire.shape[0], mask & 0xFFFFFFFF))
