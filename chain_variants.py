#!/usr/bin/env python3
"""Time the transcript's two chain kernels, built from several kernel
sources, on one card in turns.

    python3 chain_variants.py --keccak A.cu B.cu ... --poseidon2 C.cu D.cu ...

Each source is a whole `csrc/keccak.cu` or `csrc/poseidon2.cu`: this
checkout's, one unpacked from an earlier commit (`git archive`), or a copy
with one edit. Every source is built by nvcc for sm_90a into a library of
its own, all builds at once, and the port's own wrappers launch from each
library in turn (it stands in `kernels._LIBS` while it runs), so every
version is called through the same C entries on the same inputs:

- keccak: `keccak256_chain` at the main path's longest call (10,536
  words, k = 2), and `keccak_merkle_ladder` over 2^18 digests (the levels
  near the root run the same warp round);
- poseidon2: `poseidon2_duplex_chain` at the Poseidon2 path's longest
  absorb (10,528 words, 658 blocks), with this checkout's constant table
  (whose first 239 words are the layout every version reads).

Each output must equal the plain version's at small sizes and the first
source's at full size. A time is CUDA events around 10 back-to-back
calls, over 10; the sources are visited forward, then backward, four
times over (two sources: old, new, new, old, old, new, new, old). Prints
the card's name and power limit, then one JSON line per kernel with each
source's times and ptxas's register report; exits nonzero on any
mismatch. Needs one NVIDIA GPU.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROUNDS = 4
LAUNCHES = 10


def build(sources, name):
    """{source: (ctypes library, ptxas lines)}, every nvcc run at once,
    with the flags and C signatures of `plonky3_tpu_torch.kernels`."""
    from plonky3_tpu_torch import kernels

    out_dir = kernels.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for src in sources:
        digest = hashlib.sha256(Path(src).read_bytes()).hexdigest()[:16]
        so = out_dir / f"{name}-{digest}.so"
        procs[src] = (so, kernels.start_nvcc(src, so))
    libs = {}
    for src, (so, proc) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {src}:\n{text}")
        regs = [ln.split(":", 1)[-1].strip() for ln in text.splitlines()
                if "registers" in ln or "entry function" in ln]
        libs[src] = (kernels.bind(so, name), regs)
    return libs


def timed_turns(torch, kernels, name, libs, fn):
    """{source: [ms a call, one a visit]} of fn() with each source's
    library standing in for csrc/<name>.cu, visited forward then backward
    ROUNDS times."""
    keys = list(libs)
    times = {k: [] for k in keys}
    for r in range(ROUNDS):
        for k in (keys if r % 2 == 0 else keys[::-1]):
            kernels._LIBS[name] = libs[k][0]
            fn()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(LAUNCHES):
                fn()
            end.record()
            end.synchronize()
            times[k].append(start.elapsed_time(end) / LAUNCHES)
    return times


def each(kernels, name, libs):
    """Yield each source with its library standing in for csrc/<name>.cu."""
    for src, (lib, _) in libs.items():
        kernels._LIBS[name] = lib
        yield src


def report(kernel, shape, libs, times):
    print(json.dumps({"kernel": kernel, "shape": shape, "sources": [
        {"source": str(src), "ms": times[src],
         "median_ms": statistics.median(times[src]), "ptxas": libs[src][1]}
        for src in libs]}), flush=True)


def check(what, got, want):
    import torch

    torch.cuda.synchronize()
    if not torch.equal(got.cpu(), want.cpu()):
        raise AssertionError(f"{what}: outputs differ")


def run_keccak(torch, np, sources):
    from plonky3_tpu_torch import kernels
    from plonky3_tpu_torch.hashes import keccak_cuda as kc

    libs = build(sources, "keccak")
    rng = np.random.default_rng(8)

    def words(shape):
        x = rng.integers(0, 1 << 32, size=shape, dtype=np.uint64)
        return torch.from_numpy(x.astype(np.int64)).to(torch.int32).cuda()

    for n in (0, 1, 33, 34, 35, 100):
        w = words((n,))
        want = kc.keccak256_chain_plain(w.cpu(), 3)
        for src in each(kernels, "keccak", libs):
            check(f"{src} chain {n}", kc.keccak256_chain(w, 3), want)
    d = words((32, 8))
    for src in each(kernels, "keccak", libs):
        check(f"{src} ladder 32", kc.keccak_merkle_ladder(d),
              kc.keccak_merkle_ladder_plain(d.cpu()))
    w, d = words((10536,)), words((1 << 18, 8))
    want_chain = want_ladder = None
    for src in each(kernels, "keccak", libs):
        got_chain, got_ladder = kc.keccak256_chain(w, 2), \
            kc.keccak_merkle_ladder(d)
        if want_chain is None:
            want_chain, want_ladder = got_chain, got_ladder
        check(f"{src} chain 10536", got_chain, want_chain)
        check(f"{src} ladder 2^18", got_ladder, want_ladder)
    report("keccak256_chain", [10536, 2], libs, timed_turns(
        torch, kernels, "keccak", libs, lambda: kc.keccak256_chain(w, 2)))
    report("keccak_ladder", [1 << 18, 8], libs, timed_turns(
        torch, kernels, "keccak", libs, lambda: kc.keccak_merkle_ladder(d)))


def run_poseidon2(torch, np, sources):
    from plonky3_tpu_torch import kernels
    from plonky3_tpu_torch.fields import KoalaBear as F
    from plonky3_tpu_torch.hashes import poseidon2_cuda as pc
    from plonky3_tpu_torch.hashes.poseidon2 import default_poseidon2

    libs = build(sources, "poseidon2")
    perm = default_poseidon2(F, 24)
    rng = np.random.default_rng(9)

    def words(n):
        x = rng.integers(0, F.P, size=n, dtype=np.uint64).astype(np.int64)
        return torch.from_numpy(x).to(torch.int32).cuda()

    for n in (0, 1, 15, 16, 17, 33):
        state, w = words(24), words(n)
        want = pc.poseidon2_duplex_chain_plain(perm, state.cpu(), w.cpu())
        for src in each(kernels, "poseidon2", libs):
            check(f"{src} duplex {n}",
                  pc.poseidon2_duplex_chain(perm, state, w), want)
    n = (2 * 1312 + 2 * 4) * 4
    state, w = words(24), words(n)
    want = None
    for src in each(kernels, "poseidon2", libs):
        got = pc.poseidon2_duplex_chain(perm, state, w)
        want = got if want is None else want
        check(f"{src} duplex {n}", got, want)
    report("poseidon2_duplex_chain", [n, -(-n // 16)], libs, timed_turns(
        torch, kernels, "poseidon2", libs,
        lambda: pc.poseidon2_duplex_chain(perm, state, w)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--keccak", nargs="*", default=[])
    ap.add_argument("--poseidon2", nargs="*", default=[])
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chain_variants: no CUDA device is available", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    if args.keccak:
        run_keccak(torch, np, args.keccak)
    if args.poseidon2:
        run_poseidon2(torch, np, args.poseidon2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
