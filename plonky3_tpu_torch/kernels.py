"""Build, load and count the hand-written CUDA kernels.

Each `csrc/<name>.cu` is compiled by nvcc for sm_90a into a shared library
with a plain C interface (`_build/<name>-<source hash>.so`, git-ignored)
the first time a wrapper needs it, and loaded with ctypes. Nothing here
runs at import time. Every C entry launches one kernel on the stream it is
given and returns `cudaGetLastError()`; `check` raises on a nonzero code.

`LAUNCHES` counts kernel launches by name. A wrapper adds one right after
its kernel launched; nothing else touches the counts except
`reset_launches`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
ARCH = "arch=compute_90a,code=sm_90a"

LAUNCHES = {"ntt_k1": 0, "ntt_k2": 0, "keccak_sponge": 0,
            "keccak_compress": 0, "keccak_ladder": 0, "keccak256_chain": 0,
            "keccak_grind": 0, "poseidon2_duplex_chain": 0,
            "poseidon2_grind": 0, "poseidon2_duplex_chain_babybear": 0,
            "poseidon2_grind_babybear": 0, "gl_sponge": 0,
            "gl_compress": 0, "gl_permute": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_U = ctypes.c_uint32
# C signatures: every entry returns the cudaError_t of its launch.
_SIGNATURES = {
    "ntt": {
        "ntt_k1": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _L, _U, _P],
        "ntt_k2": [_P, _P, _P, _I, _I, _I, _I, _L, _U, _P],
    },
    "keccak": {
        "keccak_sponge_rows": [_P, _P, _L, _I, _P],
        "keccak_compress": [_P, _P, _P, _L, _P],
        "keccak_merkle_ladder": [_P, _P, _L, _I, _P],
        "keccak256_chain": [_P, _P, _L, _I, _P],
        "keccak_grind": [_P, _L, _I, _U, _P, _P],
    },
    "poseidon2": {
        "poseidon2_duplex_chain": [_P, _P, _L, _P, _P, _U, _U, _U, _I, _I,
                                   _P],
        "poseidon2_grind": [_P, _I, _I, _P, _U, _U, _U, _I, _I, _P, _P],
    },
    "goldilocks": {
        "gl_sponge_rows": [_P, _L, _I, _P, _P, _P],
        "gl_compress": [_P, _L, _P, _L, _L, _P, _P, _P],
        "gl_permute": [_P, _L, _P, _P],
    },
}

_LIBS: dict = {}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def so_path(name: str) -> Path:
    src = (_CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def start_nvcc(src, out):
    """Start nvcc building source `src` into the shared library `out`
    (ptxas's register report on stdout); returns the process."""
    cmd = [_nvcc(), "-gencode", ARCH, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(out), str(src)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def bind(so, name: str):
    """Load the library `so` built from a csrc/<name>.cu and give its C
    entries their signatures."""
    handle = ctypes.CDLL(str(so))
    for fn, argtypes in _SIGNATURES[name].items():
        f = getattr(handle, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    return handle


def _start_build(name: str):
    """Start nvcc for one source; returns (process, tmp path, target)."""
    so = so_path(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    return start_nvcc(_CSRC / f"{name}.cu", tmp), tmp, so


def _finish_build(name, proc, tmp, so) -> str:
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{out}")
    os.replace(tmp, so)
    return out


def build_all() -> dict:
    """Compile every kernel source not yet built, all nvcc processes at
    once. Returns {name: (seconds, compiler output)}."""
    t0 = time.perf_counter()
    started = {}
    for name in _SIGNATURES:
        if not so_path(name).exists():
            started[name] = _start_build(name)
    report = {}
    for name, (proc, tmp, so) in started.items():
        out = _finish_build(name, proc, tmp, so)
        report[name] = (time.perf_counter() - t0, out)
    return report


def lib(name: str):
    """The loaded ctypes library for csrc/<name>.cu (built on demand)."""
    hit = _LIBS.get(name)
    if hit is not None:
        return hit
    so = so_path(name)
    if not so.exists():
        _finish_build(name, *_start_build(name))
    handle = _LIBS[name] = bind(so, name)
    return handle


def check(rc: int, what: str):
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed (cudaError {rc})")


def stream_of(t):
    """The current CUDA stream of tensor t's device, as a ctypes pointer."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def require_cuda_tensor(t, what: str, dtype=None):
    """Raise unless t is a contiguous CUDA tensor (of `dtype` if given)."""
    if t.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{what}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: tensor must be contiguous")
