#!/usr/bin/env python3
"""Time the transcript's kernels, the two chains and the two
proof-of-work grinds, built from several kernel sources, on one card in
turns.

    python3 chain_variants.py --keccak A.cu B.cu ... --poseidon2 C.cu D.cu ...

Each source is a whole `csrc/keccak.cu` or `csrc/poseidon2.cu`: this
checkout's, one unpacked from an earlier commit (`git archive`), or a copy
with one edit. Every source is built by nvcc for sm_90a into a library of
its own, all builds at once, and the port's own wrappers launch from each
library in turn (it stands in `kernels._LIBS` while it runs), so every
version is called through the same C entries on the same inputs:

- keccak: `keccak256_chain` at the main path's longest call (10,536
  words, k = 2), `keccak_merkle_ladder` over 2^18 digests (the levels
  near the root run the same warp round), and `keccak_grind` over
  `chip_smoke.py`'s sweep (16 staged 18-word messages at 16 bits);
- poseidon2: `poseidon2_duplex_chain` at the Poseidon2 path's longest
  absorb (10,528 words, 658 blocks), and `poseidon2_grind` over the
  sweep (16 staged states, lane 10, 16 bits), with this checkout's
  constant table (whose first 239 words are the layout every version
  reads).

A source whose grind entry still takes a thread count (the fixed-grid
grind that the persistent one replaced) is called with the count its
wrapper gave it, 2^min(17, pow_bits + 2).

Each output must equal the plain version's at small sizes and the first
source's at full size; every grind's witness must equal the plain
version's. A time is CUDA events around 10 back-to-back calls (a grind's
call: the whole sweep, one launch a state), over 10, after the stream
sleeps while the host queues them; the sources are visited forward, then
backward, four times over (two sources: old, new, new, old, old, new,
new, old). Prints the card's name and power limit, then one JSON line
per kernel with each source's times, ptxas's register report and, for a
grind, the kernel's SASS counts and its share of the sweep's summed
bound (`chip_smoke.grind_bound`, `p2_grind_bound`); exits nonzero on
any mismatch. Needs one NVIDIA GPU.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import re
import statistics
import sys
from pathlib import Path

import chip_smoke as cs

ROUNDS = 4
LAUNCHES = 10
# where a thread-count grind entry takes its count, by library
THREADS_AT = {"keccak": 4, "poseidon2": 3}
GRIND_KERNEL = {"keccak": "keccak_grind_kernel",
                "poseidon2": "duplex_grind_kernel"}


class ThreadCountGrind:
    """A library whose grind entry takes a thread count after its first
    arguments: stands in for the library, inserting the count that the
    entry's wrapper gave it, 2^min(17, pow_bits + 2)."""

    def __init__(self, lib, name):
        from plonky3_tpu_torch import kernels

        self._lib, self._fn, self._at = lib, f"{name}_grind", THREADS_AT[name]
        argtypes = list(kernels._SIGNATURES[name][self._fn])
        argtypes.insert(self._at, ctypes.c_int)
        getattr(lib, self._fn).argtypes = argtypes

    def __getattr__(self, fn):
        f = getattr(self._lib, fn)
        if fn != self._fn:
            return f

        def call(*args):
            a = list(args)
            a.insert(self._at, 1 << min(17, args[2] + 2))
            return f(*a)

        return call


def takes_thread_count(src, name):
    """Whether the grind entry of source `src` takes a thread count."""
    m = re.search(rf"int {name}_grind\(([^)]*)\)", Path(src).read_text())
    return m is not None and "threads" in m.group(1)


def build(sources, name):
    """{source: (ctypes library, ptxas lines, the grind's SASS counts)},
    every nvcc run at once, with the flags and C signatures of
    `plonky3_tpu_torch.kernels`."""
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
        lib = kernels.bind(so, name)
        if takes_thread_count(src, name):
            lib = ThreadCountGrind(lib, name)
        libs[src] = (lib, regs, cs.sass_counts(so, {
            "grind": GRIND_KERNEL[name]}).get("grind"))
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
            times[k].append(cs.events_ms(torch, fn, LAUNCHES))
    return times


def each(kernels, name, libs):
    """Yield each source with its library standing in for csrc/<name>.cu."""
    for src, (lib, *_) in libs.items():
        kernels._LIBS[name] = lib
        yield src


def report(kernel, shape, libs, times, bound_ms=None, each_ms=None):
    """One JSON line: each source's times, median and ptxas lines; with
    `bound_ms` and `each_ms` (a grind's sweep), its share of the bound,
    each state's time and its SASS counts."""
    rows = []
    for src in libs:
        row = {"source": str(src), "ms": times[src],
               "median_ms": statistics.median(times[src]),
               "ptxas": libs[src][1]}
        if bound_ms is not None:
            row.update(sweep_share=bound_ms / row["median_ms"],
                       each_ms=each_ms[src], sass=libs[src][2])
        rows.append(row)
    line = {"kernel": kernel, "shape": shape, "sources": rows}
    if bound_ms is not None:
        line["sweep_bound_ms"] = bound_ms
    print(json.dumps(line), flush=True)


def grind_turns(torch, kernels, name, libs, grind, plain, bound, cases,
                states):
    """Each source's grind (grind(x, pow_bits)) against the plain version
    at `cases` (x, pow_bits) and over the sweep's `states`, then the sweep
    in turns; returns (times, {source: each state's ms, once}, the sweep's
    summed bound(witness))."""
    for x, bits in cases:
        want = plain(x, bits)
        for src in each(kernels, name, libs):
            check(f"{src} grind, {bits} bits", grind(x, bits), want)
    total = 0.0
    for x in states:
        want = plain(x, cs.SWEEP_BITS)
        total += bound(int(want[0]))[0]
        for src in each(kernels, name, libs):
            check(f"{src} sweep", grind(x, cs.SWEEP_BITS), want)
    times = timed_turns(torch, kernels, name, libs, lambda: [
        grind(x, cs.SWEEP_BITS) for x in states])
    each_ms = {src: [cs.events_ms(torch, lambda: grind(x, cs.SWEEP_BITS))
                     for x in states] for src in each(kernels, name, libs)}
    return times, each_ms, total


def check(what, got, want):
    import torch

    torch.cuda.synchronize()
    if not torch.equal(got.cpu(), want.cpu()):
        raise AssertionError(f"{what}: outputs differ")


def card_of(torch):
    """What the grinds' bounds read of the card: its integer peak."""
    return cs.Card(cs.int_peak(torch)[0], 0.0)


def run_keccak(torch, np, sources):
    from plonky3_tpu_torch import kernels
    from plonky3_tpu_torch.fields import KoalaBear as F
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
    card = card_of(torch)
    times, each_ms, bound = grind_turns(
        torch, kernels, "keccak", libs,
        lambda x, bits: kc.keccak_grind(x, bits, F.P),
        lambda x, bits: kc.keccak_grind_plain(x, bits, F.P),
        lambda w: cs.grind_bound(card, cs.GRIND_WORDS, w),
        [(words((m,)), bits) for m, bits in ((18, 1), (33, 4), (40, 8))],
        [torch.from_numpy(x).to(torch.int32).cuda()
         for x in cs.sweep_states(np, F.P)[0]])
    report("keccak_grind", [cs.SWEEP_STATES, cs.GRIND_WORDS, cs.SWEEP_BITS],
           libs, times, bound, each_ms)


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
    card = card_of(torch)
    times, each_ms, bound = grind_turns(
        torch, kernels, "poseidon2", libs,
        lambda x, bits: pc.poseidon2_grind(perm, *x, bits),
        lambda x, bits: pc.poseidon2_grind_plain(perm, *x, bits),
        lambda w: cs.p2_grind_bound(card, w),
        [((words(24), lane), bits) for lane, bits in ((0, 1), (15, 4),
                                                       (3, 8))],
        [(torch.from_numpy(x).to(torch.int32).cuda(), cs.GRIND_LANE)
         for x in cs.sweep_states(np, F.P)[1]])
    report("poseidon2_grind", [cs.SWEEP_STATES, cs.GRIND_LANE,
                               cs.SWEEP_BITS], libs, times, bound, each_ms)


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
    print(cs.card_name(), flush=True)
    if args.keccak:
        run_keccak(torch, np, args.keccak)
    if args.poseidon2:
        run_poseidon2(torch, np, args.poseidon2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
