#!/usr/bin/env python3
"""Chip smoke test of plonky3_tpu_torch, the PyTorch/CUDA port.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, each printed as one JSON line:
  card     the GPU's name and power limit (nvidia-smi), its integer peak
           (SMs x 64 lanes x the maximum SM clock), then an nvcc build
           of every kernel in plonky3_tpu_torch/csrc/, with ptxas's
           register report and the SASS opcode counts of the main path's
           size-2^9 NTT kernels; then the latency probe (csrc/probe.cu):
           the cycles a dependent instruction takes (an IADD3/LOP3 chain
           and an IMAD.WIDE.U32 chain, the smaller is L; a shuffle's and a
           warp sum's beside) and the SM clock one busy warp sees, for the
           latency bound of serial chains;
  kernels  each kernel against its plain PyTorch version on the card, bit
           for bit, at the main path's shapes and at small ones (NTTs up
           to 2^22 rows, each with the k1 and k2 launches it made, which
           must match ntt_cuda.plan; the Merkle ladder from 2 to 2^18
           digests, with its launches against keccak_cuda.ladder_plan),
           with the median kernel time, the plain version's time, the
           kernel's bound (the least time for its bytes, for the busier
           integer pipe's operations on this card, or, for the serial
           transcript chains, for their dependent instructions one after
           another at L cycles each and the maximum clock) and its share
           (bound / time; above 1.05 the count is wrong and the script
           fails); at 2^18 leaves also the per-level compress route that
           the ladder replaced. The transcript's keccak-256 kernels
           likewise: the digest chain at the padding's edge lengths and
           at the main path's longest call (10,536 words), the
           proof-of-work grind at 1 to 16 bits; and the Poseidon2 duplex
           transcript's, in both instantiations (KoalaBear's <23, 3> and
           BabyBear's <21, 7>: internal rounds, s-box degree): the duplex
           chain at 0, 1 and 2 blocks, at partial last blocks and at its
           longest call on the Poseidon2 path (10,528 words, 658 blocks;
           BabyBear's 19,104 words, 1,194 blocks), the grind at 1 to 16
           bits from two staged states. Each grind also runs over a sweep
           of 16 staged states at 16 bits, each witness checked and each
           state timed by CUDA events and bounded (`sweep_ms`,
           `sweep_share`). K1, K2 and the sponge also at 2^18 x 2,384
           with BabyBear's words and tables (the `*_babybear` keys), and
           at 2^18 x 7,728 (Sha256Air's width, the `*_sha256_air` keys:
           the plain NTT 2,048 columns at a time, the plain sponge on the
           first 2^14 rows).
           Kernel times are device time under
           torch.profiler (`ms`), CUDA events around the call beside it
           (`wall_ms`);
  mixed    a commit of mixed-height matrices (injection levels through
           keccak_compress, the rest through the ladder) on CUDA equals
           the same commit on the CPU, with its launch counts;
  small    prove() and the device-transcript prover on CUDA equal both on
           the CPU (plain versions) for Poseidon2VectorAir(KoalaBear, 16,
           vector_len=8) at 2^8 rows, and the port's verifier
           (stark/verifier.py, host work) accepts every one of them;
  keccak_air_small  the generic AIR path (the AIR's eval over the
           prover backend): FibonacciAir at 2^8 rows and KeccakAir with
           10 permutations, both provers on CUDA equal to both on the CPU,
           every proof verified, and a changed public value (Fibonacci)
           and a changed next-row value (KeccakAir) rejected;
  blake3_air_small  Blake3Air (9,168 columns) at 2^8 rows the same way,
           and a changed next-row value rejected;
  periodic  PeriodicAir and NoNextRowAir (periodic columns; the second
           reads no next row, so its quotient folds in the committed
           bit-reversed order and its trace opens at zeta alone) at 2^8
           rows, both provers on CUDA equal to both on the CPU, verified;
  babybear_small  Poseidon2VectorAir(BabyBear, 16, 8) (2,384 columns,
           s-box x^7 with registers) at 2^8 rows, built by the CLI's
           `build`, under both configs: both provers on CUDA equal both
           on the CPU, every proof verified;
  sha256_air_small  Sha256Air (7,728 columns) at 2^8 rows under both
           configs: both provers on CUDA equal both on the CPU, every
           proof verified, a changed opened trace value rejected;
  poseidon1_small  Poseidon1VectorAir(KoalaBear, 16, 8) (1,312 columns,
           its own fold) at 2^8 rows under both configs, CUDA against the
           CPU, every proof verified;
  m15_small a JoinedAir of two named FibonacciAirs, both provers on CUDA
           equal both on the CPU; batch_inv on 2^20 KoalaBear and
           BabyBear words with zeros against the Fermat inverse on the
           card; the Ext8 fields' products and inverses, CUDA against the
           CPU;
  full     the benchmark workload: 2^20 Poseidon2 permutations, a
           2^17 x 1312 trace, keccak config, FriParameters
           .new_benchmark_high_arity(); two proves, the second timed, with
           the kernel launch counts of that prove; then a prove with
           per-stage spans ("spans") that also records every kernel
           launch's shape and its device time by CUDA events
           ("per_proof": each kernel's launches, bound and time summed
           over one proof), and one under torch.profiler
           ("profile": device time by kernel, the port's own kernels
           listed apart, the compressor's time, device idle share);
  fast     the main path: the same workload through the device-transcript
           prover (stark/fast_prover.py::_prove_device_fs, called directly
           so that no fallback hides a failure), cold and warm; the proof
           must equal the full phase's; its launches (one grind a proof),
           device-to-host copies, warm time against prove() in turns,
           peak memory, spans, per-proof bounds, the synchronizing calls
           of one prove (as torch.cuda.set_sync_debug_mode counts them)
           and its profile;
  verify   the port's verifier accepts the main path's full-size proof
           (its host time, and the host's CPU) and rejects three probes
           with the error class each must raise: a changed opened trace
           value, a changed sibling digest of a FRI commit-phase opening,
           and the honest proof held against the AIR with one more
           constraint (the out-of-domain check at full size);
  poseidon2 the same workload under poseidon2_stark_config (Poseidon2
           sponge and compression, field digests, the duplex transcript):
           the device-transcript prover cold and warm, its proof equal to
           prove()'s (its one call timed), launches (the duplex
           chain and grind, no keccak kernel), one device-to-host copy,
           peak memory, spans, per-proof bounds, profile; then the
           port's verifier accepts the proof and rejects a changed opened
           trace value, a changed trace root and a changed commit-phase
           sibling digest;
  keccak_air the reference CLI's keccak-f-permutations objective at
           full width: 5,461 permutations, a 2^17 x 2,633 KeccakAir trace,
           keccak config, new_benchmark_high_arity(), through the generic
           quotient path: the device-transcript prover cold and warm, its
           proof equal to prove()'s (its one call timed),
           launches, one copy, peak memory; the port's verifier accepts
           the proof and rejects a changed opened trace value, a changed
           commit-phase sibling digest and a changed next-row value; then
           spans, per-proof bounds, the profile and the transcript
           chain call by call. The kernels phase also
           holds the NTTs and the leaf sponge at this width against their
           plain versions (the `*_keccak_air` keys of the kernels line);
  blake3_air the reference CLI's blake3-permutations objective at full
           width: 131,072 compressions, a 2^17 x 9,168 Blake3Air trace
           built in row blocks, keccak config, new_benchmark_high_arity(),
           the same checks as keccak_air; the generic quotient folds by
           row blocks gathered from the committed LDE, the block size
           from the card's free memory (`fold_blocks`, `fold_block_rows`
           of each full-size phase line). The kernels phase holds the
           NTTs at 2^18 x 9,168 against their plain versions 2,048 columns
           at a time, and the sponge's first 2^14 rows of 2^18 x 9,168
           (the `*_blake3_air` keys of the kernels line);
  babybear the CLI's poseidon-2-permutations objective over BabyBear at
           full size (`plonky3_tpu_torch.cli.build`: 2^20 permutations, a
           2^17 x 2,384 trace, 2,256 constraints, keccak config,
           new_benchmark_high_arity()), the same checks as keccak_air, the
           probes a changed opened trace value, commit-phase sibling
           digest and s-box register value;
  cli      one run of `python -m plonky3_tpu_torch.cli prove --field
           baby-bear --objective poseidon-2-permutations
           --log-trace-length 17 --merkle-hash keccak-f --prover fast` in
           its own process: exit code 0, the objective line, the spans,
           the babybear phase's proof size and the soundness line;
  babybear_poseidon2  the same workload under the Poseidon2 config: the
           duplex kernels' <21, 7> (and no keccak kernel, no <23, 3>),
           the same checks and probes, the chain call by call;
  poseidon1 Poseidon1VectorAir(KoalaBear, 16, 8) at full size: 2^20
           permutations (inputs as the main path's), a 2^17 x 1,312
           trace, 1,184 constraints, keccak config, through the same
           checks as keccak_air with the warm fast prove and one prove()
           (probes: a changed opened trace value, commit-phase sibling
           digest, the AIR with one more constraint);
  poseidon1_poseidon2  the same under the Poseidon2 config (the duplex
           kernels' <23, 3>; probes: trace value, trace root, sibling
           digest);
  sha256_air Sha256Air at full width: 131,072 compressions, a 2^17 x
           7,728 trace built on the card, keccak config, the generic
           quotient folded by row blocks, the checks and probes of
           blake3_air with the warm fast prove and one prove();
  zk_small zk_stark_config (hiding MMCS, HidingFriPcs, the masked
           quotient, R) at 2^8 rows, log_blowup 2: FibonacciAir and
           KeccakAir with 10 permutations proven on the card equal to the
           CPU's from seed 1, verified; seed 2 gives other roots; a
           changed random opening is rejected; Poseidon2VectorAir under
           ZK raises;
  zk_air   KeccakAir at 2^17 x 2,633 (the CLI's keccak-f-permutations)
           under zk_stark_config, BLOWUP4_PARAMS (the main path's FRI
           with a blowup of 4: the ZK quotient's domain), prove(): a
           cold prove with spans (the host's random draw of 345 M words
           among them) and peak memory, a warm prove with per-launch
           events, both equal; its launches (K1, K2 at 2^20 x 2,634, the
           duplex grind, no keccak kernel); verified, and a changed opened trace value, random
           opening and salt word rejected; per-proof bounds. The kernels
           phase holds K1 and K2 at 2^18 and 2^20 x 2,634 (the `*_zk_air`
           keys);
  preprocessed  EvenZeroAir (a fixed selector column): CUDA equals the
           CPU at 2^8 rows, then 2^20 rows proven, verified, and a bad
           trace rejected (keccak config);
  lookup   RangeCheckAir with one LogUp lookup (log_blowup 2: its
           constraints reach degree 4): the permutation trace (built on
           the card by a prefix sum) and the proof equal the CPU's at 2^8
           rows; 2^20 rows proven and verified; an unbalanced trace
           refused; the permutation trace's time with batch_inv and with
           the Fermat inverse;
  batch    the lookup-free batch STARK: CUDA equals the CPU at 2^8-scale
           heights under both configs; then one keccak-config proof of
           Poseidon2VectorAir at 2^17 x 1,312, KeccakAir at 2^16 x 2,633
           and FibonacciAir at 2^10 (compress_kernel for the injected
           heights), cold, warm with its launches, verified, per-proof
           bounds;
  batch_ref the canonical batch STARK (LogUp buses, a global
           preprocessed column) under the Poseidon2 config over BabyBear:
           the CLI's poseidon-2-permutations trace at 2^17 x 2,384 (no
           bus), MulAirLookups at 2^20 x 7 and FibAirLookups at 2^20 on
           the MulFib bus; keygen, a cold and a warm prove with spans, a
           third with per-launch events, all equal, peak memory, launches
           (K1, K2, the <21, 7> grind), verified, a changed terminal,
           permutation value and trace value rejected, the proof through
           the postcard wire and back;
  interaction LogUp buses under the keccak config: 2^20 range queries
           into a 2^16-row table with multiplicities and 2^18 pairs on a
           permutation-check bus in one proof (compress_kernel for the
           injected heights), cold, warm, a third with per-launch events,
           equal, verified, an unbalanced table rejected;
  serde    the babybear_poseidon2 proof through the postcard wire and
           back; the canonical batch and the bus batch at 256 rows on
           CUDA equal to the CPU, verified;
  circle_small  the circle STARK over Mersenne-31 (circle_stark_config:
           CirclePcs over QM31, the KeccakF Merkle tree, the host
           transcript) at 256 rows: FibonacciAir and KeccakAir with 10
           permutations, prove() on CUDA equal to the CPU, verified, a
           changed opened value rejected;
  circle_keccak_air  the reference CLI's `--field mersenne-31`
           keccak-f-permutations objective at full width (5,461
           permutations, 2^17 x 2,633, `--fri benchmark`: arity 2, 100
           queries, 16 PoW bits) through `cli.build` and prove(): a cold
           and two warm proves with spans, equal; launches (the sponge
           and the ladder; no NTT, transcript or grind kernel), peak
           memory, verified, a changed opened value and a changed FRI
           final polynomial rejected, per-proof bounds, the profile. The
           kernels phase holds the sponge on canonical M31 words at 2^18
           x 2,633 (2^14 sampled rows against the plain version; the
           `*_circle_keccak_air` keys);
  monolith_air  MonolithAir at full width (3,520 columns), 2^16 rows (a
           cut of depth), under circle_stark_config(new_benchmark()):
           cold and warm proves, equal, launches, peak memory, verified,
           a changed opened value rejected, per-proof bounds;
  cli_circle  `python -m plonky3_tpu_torch.cli prove --field mersenne-31
           --objective keccak-f-permutations --log-trace-length 17 --fri
           benchmark` in its own process: exit code 0, the objective line,
           the stated prover (prove()), the circle_keccak_air phase's
           proof size, the soundness line.
  gl_small  the Goldilocks STARK (goldilocks_stark_config, 10 queries,
           8-bit query PoW): FibonacciAir at 256 rows and
           MonolithGoldilocksAir at 16 rows (3,536 columns), prove_gl on
           the card equal to prove_gl on the CPU (plain versions), the
           card's proofs verified, a changed opened value rejected;
  gl_fibonacci  FibonacciAir over Goldilocks at 2^20 rows under
           new_benchmark(): one prove with spans, the Poseidon2-GL
           kernels' launches and no other kernel, peak memory, verified,
           a changed trace root rejected, per-proof bounds;
  gl_monolith_air  MonolithGoldilocksAir at full width (3,536 columns),
           2^16 rows (a cut of depth), the trace generated on the card,
           under new_benchmark(): cold and warm proves, equal, spans,
           launches, peak memory, verified, two probes rejected,
           per-proof bounds, a profile (device busy share);
  m21_small  STIR (TwoAdicStirPcs at 2^8 x 8), WHIR (n_vars 10) and the
           multilinear STARK (FibonacciAir at 2^8 rows) on the card equal
           to the same proofs on the CPU, verified;
  pcs_comparison  `python -m plonky3_tpu_torch.cli pcs-comparison
           --log-trace-length 18 --width 16 --fri benchmark
           --security-level 100 --max-pow-bits 20` in its own process
           (exit 0, the FRI, STIR and WHIR lines, WHIR's soundness line;
           WHIR's codeword 2^24 rows of one column), then STIR and WHIR
           on the same matrix and point in this process: a cold prove
           with per-launch events and spans, a warm one equal to it,
           launches (K1, K2, the <23, 3> grind, nothing else), peak
           memory, verified, a changed opened value and a changed query
           row rejected with STIR's and WHIR's error classes, a profile
           (device idle share), per-proof bounds;
  multi_stark  FibonacciAir at 2^20 rows through prove_multi_stark over
           WHIR (the stacked MLE 2^21 entries, WhirConfig.from_security(
           100, johnson, 21, blowup 4, k 2, 16 PoW bits)): one prove with
           spans and per-launch events, launches, peak memory,
           verify_multi_stark, a changed public value rejected.
  m22_small  the zero-knowledge multilinear stack and the sharded paths
           at small size: hiding WHIR (n_vars 6), the masked zerocheck
           (FibonacciAir at 2^4 rows) and the sharded LDE (256 x 5) with
           its keccak and Poseidon2 trees in a one-rank group, each on the
           card equal to the CPU's (the CPU's proofs verified);
  hiding_whir  HidingWhirPcs at full width: a 2^21-evaluation MLE, the
           extended polynomial 2^22 coefficients, the zk-encoded witness
           codeword and the mask's ext codeword 2^24 rows each (KoalaBear's
           two-adicity at blowup 4: the largest hiding commit),
           WhirConfig.from_security(100, johnson, 22, blowup 4, k 2, 16
           PoW bits); commit_hiding and open_hiding cold (per-launch
           events, spans) and warm (equal), a profile (idle share),
           launches (K1, K2, the <23, 3> grind, nothing else), peak
           memory; verify_hiding accepts, a changed value and a changed
           round-0 mask row are rejected with the reference's classes;
  masked_zerocheck  FibonacciAir at 2^20 rows through
           prove_masked_zerocheck, the mask PCS sized by `_mask_layout` at
           100 bits, the trace and the PCS built before the clock: a cold
           prove (spans, per-launch events, launches, peak memory) and a
           warm one (spans, equal); verify_masked_zerocheck accepts, a
           changed wire is rejected;
  sharded  the full phase's trace (2^17 x 1,312, added_bits 1) through
           coset_lde_batch_sharded and its keccak tree through
           sharded_tree_layers (2^18 LDE rows): world size 1 over NCCL in
           this process, 2 processes on the one card over gloo (CUDA
           tensors staged through the host, the all_to_all one batch of
           sends and receives), one rank a card over NCCL
           where there are more cards; every rank's blocks equal the
           single device's coset_lde_batch and _build_layers bit for bit;
           wall times beside the single device's;
  native   each host C function (native/: keccak-f batches, keccak256,
           keccak256_rows, the transcript grind, the Poseidon2 permutation
           <16, 3>, <24, 3>, <24, 7>, the duplex chain) against its numpy
           or torch plain version on the host CPU, both timed, a build from
           nothing timed; a cProfile of one verify of the full phase's
           proof (the fast phase's, which equals it): the ten functions of
           most cumulative time.
`--phases a,b` runs the card and kernels phases and the named ones only
(a phase that reads another's result needs it named too; a name no
phase has fails the run at its end); without it every phase runs, as
above. The kernels phase holds K1/K2 at the M21
paths' shapes too (2^24 x 1, WHIR's commit and hiding WHIR's witness
codeword; 2^24 x 4, hiding WHIR's mask codeword; 2^22 x 4; STIR's 2^18 x
16 iDFT and 2^20 x 16 LDE; the `*_whir_commit`, `*_hiding_mask`,
`*_whir_ext_round`, `*_stir_idft`, `*_stir_lde` keys), each launch timed
and bounded.
The kernels phase also holds the Poseidon2-GL kernels (csrc/goldilocks.cu)
against their plain versions: the leaf sponge at 2^17 x 3,536 (the plain
version over 4 sampled rows), the compression on a 2^16-node level, the
permutation on a 2^18-state grind batch.
The CPU halves of the CUDA == CPU checks (the plain versions on the
host's CPU, `side_*` functions, CPU_JOBS) run in worker processes that
see no GPU, started after the card phase, beside the card's phases; the
port's verifier (host work) runs there once a proof, on the CPU's
proofs, which the card's must equal ("verified" counts them).
Every profile checks that it recorded each of the port's kernels as many
times as the prove launched it, and profiles again where it did not.
Before the last line: one JSON object listing every kernel. The last line
is {"ok": true, "device": {...}}. Any mismatch or error exits nonzero and
prints no result. Imports nothing of JAX or of plonky3_tpu.
"""

from __future__ import annotations

import argparse
import collections
import copy
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import NamedTuple

# The caching allocator maps a segment's pages as it grows
# (expandable_segments): the ZK phase's 22 GB matrices, allocated again
# in each prove, would otherwise find their earlier segments pinned by
# small long-lived tensors (the second prove ran out of memory with 40
# GB reserved and free). Read when the first CUDA tensor is made.
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

# H100 SXM published HBM bandwidth (NVIDIA data sheet). The integer peak
# is read from the card in phase_card: SMs × 64 lanes × the maximum SM
# clock, the rate of the ALU pipe (LOP3, SHF, IADD3, compare, select)
# and of the integer multiply on the FMA pipe (IMAD, IMUL, IMAD.HI).
HBM_BYTES_PER_S = 3.35e12
INT_LANES_PER_SM = 64


def emit(obj):
    print(json.dumps(obj), flush=True)


def cuda_ms(torch, fn, reps: int) -> float:
    """Median milliseconds of fn() over reps runs, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# torch.profiler passes over a tagged profile that misses launches or
# disagrees with CUDA events, and how far short of the events a profile
# may fall: a share of their time, and the gap and side work (a fill of
# the grinds' result word) around each launch
PROFILE_TRIES = 2
PROFILE_SLACK = 0.1
PROFILE_GAP_MS = 0.005


def _profile(torch, fn):
    """fn() under torch.profiler, after a warm-up step whose records are
    dropped: the profiler loses the device records of some launches, most
    often the first of a profile, and the warm-up step takes that place."""
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        prof.step()
        fn()
        torch.cuda.synchronize()
        prof.step()
    return prof


def device_records(prof):
    """[(device µs, kernel name, count)] of the CUDA records (kernels,
    copies, fills) of a finished profile, by name, the busiest first:
    summed from the profiler's raw records (key_averages builds a Python
    event tree first, tens of seconds for a prove's launches)."""
    import torch
    from torch.autograd import DeviceType

    us, count = collections.Counter(), collections.Counter()
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == DeviceType.CUDA:
            us[ev.name()] += (ev.end_ns() - ev.start_ns()) / 1e3
            count[ev.name()] += 1
    return sorted(((t, torch._C._demangle(k), count[k])
                   for k, t in us.items()), reverse=True)


def profiled_ms(torch, fn, reps: int, tag: str = ""):
    """(ms, source): device milliseconds of fn() per run, the summed time
    of the CUDA kernels whose name holds `tag` (every kernel for ""),
    under torch.profiler over reps runs after one warm-up. Unlike cuda_ms
    it leaves out the gaps in which the device waits for the host.

    With a tag, the kernels named are the port's own, and the profile
    must record as many of them as the wrappers launched
    (`kernels.LAUNCHES`) and agree with `events_ms` of the same runs: the
    events bracket every run, so the device time of the tagged kernels
    can fall short of theirs only by the gaps between launches and the
    other work of a run (PROFILE_SLACK of the events' time and
    PROFILE_GAP_MS a launch). A profile that misses launches or falls
    further short has lost or cut records, and is taken again, up to
    PROFILE_TRIES times. `source` says what the time is: "profiler" (every
    launch recorded), "profiler_mean" (the mean recorded launch times the
    launches a run: a device time, but from fewer launches) or "events"
    (no profile agreed: `events_ms`, the launches' gaps included). Every
    profile refused is listed in PROFILE_SHORT."""
    from plonky3_tpu_torch import kernels

    ev_ms = events_ms(torch, fn, reps)
    torch.cuda.synchronize()

    def runs():
        for _ in range(reps):
            fn()

    mean = None
    for _ in range(PROFILE_TRIES):
        before = sum(kernels.LAUNCHES.values())
        prof = _profile(torch, runs)
        launched = sum(kernels.LAUNCHES.values()) - before
        evs = [(t, c) for t, k, c in device_records(prof) if tag in k]
        us = sum(t for t, _ in evs)
        recorded = sum(c for _, c in evs)
        if not tag:
            return us / 1e3 / reps, "profiler"
        ms = us / recorded * launched / 1e3 / reps if recorded else 0.0
        agrees = ev_ms - ms <= (PROFILE_SLACK * ev_ms
                                + PROFILE_GAP_MS * launched / reps)
        if recorded == launched and agrees:
            return ms, "profiler"
        if recorded and agrees:
            mean = ms
        PROFILE_SHORT.append({"tag": tag, "recorded": recorded,
                              "launched": launched, "ms": ms,
                              "events_ms": ev_ms})
    if mean is not None:
        return mean, "profiler_mean"
    return ev_ms, "events"


# every tagged profile refused (missed launches or fell short of the
# events), retries included
PROFILE_SHORT = []


class Card(NamedTuple):
    """What the bounds read of the card (phase_card)."""
    int_ops_per_s: float  # SMs × 64 lanes × the maximum SM clock
    dep_instr_s: float  # L cycles (the probe) over the maximum SM clock


def bound_ms(card, n_bytes: float, alu_ops: float, mul_ops: float = 0,
             depth: float = 0):
    """The least time for the work and what sets it: the bytes over the
    HBM rate, the busier integer pipe over the card's integer peak, or
    `depth` dependent instructions one after another (a serial chain's
    latency)."""
    times = {"bytes": n_bytes / HBM_BYTES_PER_S * 1e3,
             "operations": max(alu_ops, mul_ops) / card.int_ops_per_s * 1e3,
             "latency": depth * card.dep_instr_s * 1e3}
    by = max(times, key=times.get)
    return times[by], by


def share(what, bound, ms):
    """bound ÷ time; above 1.05 the op or byte count must be wrong."""
    s = bound / ms
    if s > 1.05:
        raise AssertionError(f"{what}: {ms} ms beats its bound {bound} ms")
    return s


# 32-bit instructions per keccak-f[1600] with three-input logic (LOP3)
# and funnel shifts (SHF), per round: theta's five column parities of two
# 32-bit halves, 2 LOP3 each (20); the rotate by one of each parity, 2
# SHF each (10); C[x-1] ^ rot(C[x+1]) folded into each of the 25 lanes,
# one LOP3 per half (50); rho, 2 SHF for each of the 24 rotated lanes
# (48); chi, one LOP3 per half-lane (50); iota, two XORs (2). 180 per
# round, 24 rounds.
KECCAK_F_ALU = (20 + 10 + 50 + 48 + 50 + 2) * 24
# The depth of keccak-f's shortest dependency graph in those instructions
# (not the kernel's graph), per round. rho's rotation distributes over
# theta's xors, so a lane's new value is rot_r(A ^ C[x-1]) ^
# rot_(r+1)(C[x+1]): A ^ C[x-1] (six lanes) and C[x+1] (five) each a tree
# of 2 LOP3, one SHF a half, one LOP3 to join them: 4, and no fewer (a
# gate of depth 2 that holds rotated data covers at most 3 lanes, and a
# lane reads 11); chi, 1 LOP3. iota's constant and the absorbed words are
# known early: they join those trees as one more input, off the path.
# 5 a round, 24 rounds.
KECCAK_F_DEPTH = (4 + 1) * 24


def ntt_ops(butterflies: int, shoups: int):
    """(ALU, multiply) instructions of NTT butterflies and lone Shoup
    products (the correction, the zero_top stage 0). A reduction
    min(x, x - p) fuses with its add into one VIADDMNMX, so a butterfly
    is add + reduce twice and a reduce after the product (5 ALU) and
    the product's IMAD.HI, IMUL and IMAD (3 multiplies); a lone product
    is 1 ALU + 3 multiplies."""
    return 5 * butterflies + shoups, 3 * (butterflies + shoups)


def ntt_bound(card, kernel, log_a, log_b, w, zero_top, batch=1):
    """Bound of one k1 or k2 launch: `batch` transforms of 2^(log_a +
    log_b) rows × w words, their tables read once. k1 reads the input
    (half the rows with zero_top), its twiddles and the (std, Shoup)
    correction; with zero_top its stage 0 is one Shoup product per pair."""
    n = 1 << (log_a + log_b)
    pairs = n // 2 * w
    if kernel == "k1":
        rows = n // 2 if zero_top else n
        zt = pairs if zero_top else 0
        return bound_ms(card, 4 * (batch * (rows * w + n * w) + 2 * n
                                   + (1 << log_a)),
                        *(batch * c for c in ntt_ops(pairs * log_a - zt,
                                                     zt + n * w)))
    return bound_ms(card, 4 * (batch * 2 * n * w + (1 << log_b)),
                    *(batch * c for c in ntt_ops(pairs * log_b, 0)))


def sponge_bound(card, h, w):
    """Leaf sponge over (h, w) words: ceil(ceil(w/2) / 17) keccak-f a row."""
    nb = -(-((w + 1) // 2) // 17)
    return bound_ms(card, 4 * h * (w + 8), h * nb * KECCAK_F_ALU)


def compress_bound(card, h):
    """One level of h nodes: 16 words in and 8 out per node."""
    return bound_ms(card, 4 * h * 24, h * KECCAK_F_ALU)


# The Goldilocks kernels (csrc/goldilocks.cu): a Poseidon2-GL
# permutation is 722 field adds and 520 field products in the reference's
# schedule (the external layer 34 adds, 4 full rounds a side of 8
# constant adds, 8 x^7 of 4 products and the layer, 22 partial rounds of
# a constant add, one x^7, a sum of 7 adds and 8 products and adds). At
# the least, a 64-bit add mod P is 6 ALU instructions (the add and its
# carry in two halves, the carry's 2^32 - 1, the compare with P and its
# subtraction, two of them folded), a product 4 wide multiplies (the
# four 32 x 32 partial products) and 12 ALU (their sum into 128 bits and
# the reduction lo + w2·(2^32 - 1) - w3 with its carry, borrow and
# compare).
GL_PERM_ADDS, GL_PERM_MULS = 722, 520
GL_ADD_ALU, GL_MUL_ALU, GL_MUL_MUL = 6, 12, 4


def gl_perm_ops(perms):
    """(ALU, multiply) instructions of `perms` permutations."""
    return (perms * (GL_PERM_ADDS * GL_ADD_ALU + GL_PERM_MULS * GL_MUL_ALU),
            perms * GL_PERM_MULS * GL_MUL_MUL)


def gl_sponge_bound(card, h, w):
    """Leaf sponge over (h, w) elements: ceil(w / 4) permutations a row;
    8 bytes an element, 4 out a row."""
    return bound_ms(card, 8 * h * (w + 4), *gl_perm_ops(h * -(-w // 4)))


def gl_compress_bound(card, n):
    """One level of n nodes: 8 elements in, 4 out a node."""
    return bound_ms(card, 8 * n * 12, *gl_perm_ops(n))


def gl_permute_bound(card, n):
    """n states of 8 elements, read and written."""
    return bound_ms(card, 8 * n * 16, *gl_perm_ops(n))


def ladder_bound(card, m, nodes):
    """Ladder over m digests writing `nodes` nodes (m - 1 to the root)."""
    return bound_ms(card, 32 * (m + nodes), nodes * KECCAK_F_ALU)


# 32-bit instructions of one width-24 Poseidon2 permutation
# (csrc/poseidon2.cu), by pipe, for s-box degree d and R internal rounds:
# KoalaBear's (3, 23) and BabyBear's (7, 21), the kernels' instantiations
# <23, 3> and <21, 7>. A modular add is an add and a reduction min(s, s -
# p): 2 ALU. A Montgomery product is the 64-bit product, the quotient word
# and its product with p (3 multiplies) and the corrected difference of
# the high words (1 ALU). The s-box: x^3 two products (x2·x), x^7 four
# (x2, x3 = x2·x, x4 = x2·x2, x4·x3). The external layer: M4 on each of the
# 6 blocks of four (11 adds), the 4 position sums over the blocks (5 adds
# each), one add a lane: 110 adds. An external round: a constant add and
# the s-box on each of the 24 lanes, then the layer. An internal round:
# the constant add and the s-box on lane 0, the lane sum (23 adds), a
# product and an add on each lane. The layer runs once before the rounds;
# 8 external rounds, R internal.
#
# The depth of the function's shortest dependency graph in those forms
# (not the kernel's graph): an add or a subtraction 2, a product 4, so the
# s-box 8 (x^3, two products deep) or 12 (x^7, three). A round constant
# joins the linear map before its s-box as one more input, off the path.
# The external layer: an output word is a linear form of the 24 words
# whose coefficients sum to 49, so a tree of adds is at least 6 deep (a
# product by a constant, as deep as two adds, shortens no such tree here),
# and 2·o_i plus the other five blocks' o (o, M4's output, 3 adds) reaches
# 6: 12. An external round: the s-box and the layer. An internal round on
# lane 0's path: the s-box, then lane 0's next word Q_0 - s (V_0 = -2, so
# S + V_0·s = Q_0 - s, Q_0 the sum of the other 23 words, which the
# recurrence of csrc/poseidon2.cu keeps ready off the path): 2. The layer
# once, 8 external rounds, R internal: 402 for (3, 23), 498 for (7, 21).
class P2Counts(NamedTuple):
    adds: int
    products: int
    alu: int
    mul: int
    depth: int
    table_words: int  # the grind's: the round constants, diag, Shoup
    chain_table_words: int  # the chain's: the round constants, diag,
    # d_i^k and c_k


def p2_counts(d, rounds):
    sbox_products, sbox_depth = {3: (2, 8), 7: (4, 12)}[d]
    adds = 110 + 8 * (24 + 110) + rounds * (1 + 23 + 24)
    products = 8 * 24 * sbox_products + rounds * (sbox_products + 24)
    rc_words = 4 * 24 + rounds + 4 * 24
    return P2Counts(adds, products, 2 * adds + products, 3 * products,
                    12 + 8 * (sbox_depth + 12) + rounds * (sbox_depth + 2),
                    rc_words + 2 * 24, rc_words + 24 + rounds * 24 + 24)


KOALABEAR_P2 = (3, 23)
BABYBEAR_P2 = (7, 21)
# the records' names of each instantiation (poseidon2_cuda.INSTANCES)
P2_SUFFIX = {KOALABEAR_P2: "", BABYBEAR_P2: "_babybear"}
P2 = {k: p2_counts(*k) for k in (KOALABEAR_P2, BABYBEAR_P2)}


def p2_chain_depth(n, key=KOALABEAR_P2):
    """Dependent instructions of a duplex absorb of n words: nb = max(1,
    ceil(n/16)) permutations one after another. Between two of them the
    last layer, the absorb and the next first layer are one affine map of
    the 24 s-box outputs, each output reading all 24 with coefficients of
    at least 14: products by constants and a tree of 25 leaves, 14 deep,
    where the two layers took 24. With n > 0 the first layer reads only
    words 16..23 of the given state (coefficient sums of at most 21): 10,
    not 12."""
    nb = max(1, -(-n // 16))
    return nb * P2[key].depth - 10 * (nb - 1) - (2 if n > 0 else 0)


def p2_chain_bound(card, n, key=KOALABEAR_P2):
    """Duplex absorb of n words, at least p2_chain_depth(n) dependent
    instructions; the state, the words and the table read, the state
    written."""
    nb, c = max(1, -(-n // 16)), P2[key]
    return bound_ms(card, 4 * (24 + n + c.chain_table_words + 24),
                    nb * c.alu, nb * c.mul, p2_chain_depth(n, key))


def p2_grind_bound(card, w, key=KOALABEAR_P2):
    """The least work that finds witness w: w + 1 permutations."""
    c = P2[key]
    return bound_ms(card, 4 * (24 + c.table_words + 1),
                    (w + 1) * c.alu, (w + 1) * c.mul)


def chain_bound(card, n, k):
    """keccak-256 of n words, then k - 1 re-hashes of the digest: n//34 + 1
    + k - 1 keccak-f, one after another, each KECCAK_F_DEPTH dependent
    instructions deep, less one in each re-hash (its first round reads
    four digest lanes and constants: a lane's theta and rho take 3) and
    plus one for the last iota, which nothing after it absorbs."""
    f = n // 34 + k
    return bound_ms(card, 4 * n + 32 * k, f * KECCAK_F_ALU, 0,
                    f * KECCAK_F_DEPTH - (k - 1) + 1)


def grind_bound(card, m, w):
    """The least work that finds witness w after m words: the blocks
    before the witness's once, then w + 1 candidates of 1 block (2 when
    the padding opens a block)."""
    tail = 2 if (m + 1) % 34 == 0 else 1
    return bound_ms(card, 4 * m + 4,
                    (m // 34 + tail * (w + 1)) * KECCAK_F_ALU)


# The grinds' yardstick. A 16-bit witness is geometric with mean 2^16, so
# one witness says little of what a proof pays: each grind also runs over
# SWEEP_STATES staged states from np.random.default_rng(SWEEP_SEED) at
# SWEEP_BITS bits, keccak at the main path's message of GRIND_WORDS words,
# Poseidon2 at GRIND_LANE, the witness's lane at the Poseidon2 path's query
# grind (after the final polynomial's 4 words and the 6 arities).
SWEEP_SEED = 9
SWEEP_STATES = 16
SWEEP_BITS = 16
GRIND_WORDS = 18
GRIND_LANE = 10
# clock cycles the stream sleeps before a timed run of launches (about 2 ms
# at the H100's clock), while the host queues them
SLEEP_CYCLES = 1 << 22


def sweep_states(np, P):
    """The sweep's staged states, int64 arrays: SWEEP_STATES keccak
    messages of GRIND_WORDS u32 words and as many width-24 Poseidon2
    states of Montgomery words below P."""
    rng = np.random.default_rng(SWEEP_SEED)
    words = rng.integers(0, 1 << 32, (SWEEP_STATES, GRIND_WORDS),
                         dtype=np.uint64)
    states = rng.integers(0, P, (SWEEP_STATES, 24), dtype=np.uint64)
    return words.astype(np.int64), states.astype(np.int64)


def events_ms(torch, fn, launches: int = 10) -> float:
    """Milliseconds of one fn() by CUDA events around `launches` runs back
    to back, after one warm-up. The stream sleeps first while the host
    queues the runs, so the time is the device's, host gaps left out."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(launches):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / launches


def grind_sweep(torch, what, grind, plain, bound, states):
    """A grind over the sweep's staged states: each witness held against
    the plain version's, each state timed by `events_ms` and bounded by
    `bound(witness)`. The record's sweep keys: the witnesses, the times,
    `sweep_ms` (their sum) and `sweep_share` (the bounds' sum over it)."""
    witnesses, times, bounds = [], [], []
    for st in states:
        got = grind(st)
        compare(f"{what} sweep", got, plain(st))
        w = int(got[0])
        ms = events_ms(torch, lambda: grind(st))
        b = bound(w)[0]
        share(f"{what} sweep, witness {w}", b, ms)
        witnesses.append(w)
        times.append(ms)
        bounds.append(b)
    return {"sweep_witnesses": witnesses, "sweep_each_ms": times,
            "sweep_ms": sum(times), "sweep_bound_ms": sum(bounds),
            "sweep_share": share(f"{what} sweep", sum(bounds), sum(times))}


class LaunchRecorder:
    """Stands in for a loaded kernel library (`kernels._LIBS[name]`) and
    records every C entry called through it: its name, its arguments
    (sizes, widths, levels) and two CUDA events on the current stream
    around the launch, which time it on the device (a profile can miss
    launches, see `_profile`; events cannot)."""

    def __init__(self, lib, calls, torch):
        self._lib, self._calls, self._torch = lib, calls, torch

    def __getattr__(self, fn):
        f = getattr(self._lib, fn)
        cuda = self._torch.cuda

        def call(*args):
            start = cuda.Event(enable_timing=True)
            end = cuda.Event(enable_timing=True)
            start.record()
            rc = f(*args)
            end.record()
            self._calls.append((fn, args, start, end))
            return rc

        return call


def recorded(torch, kernels, fn):
    """fn() with every kernel launch recorded: (its result, [(C entry,
    arguments, device ms)])."""
    calls = []
    real = dict(kernels._LIBS)
    kernels._LIBS.update({k: LaunchRecorder(v, calls, torch)
                          for k, v in real.items()})
    try:
        out = fn()
    finally:
        kernels._LIBS.update(real)
    torch.cuda.synchronize()
    return out, [(f, a, start.elapsed_time(end))
                 for f, a, start, end in calls]


def launch_bounds(card, calls, witnesses=()):
    """{record name: {launches, bound_ms, ms}} summed over recorded
    launches (the C entries' arguments: sizes, widths, levels;
    `witnesses`, the grinds' results in launch order; ms, the launches'
    device time by CUDA events)."""
    out = collections.defaultdict(
        lambda: {"launches": 0, "bound_ms": 0.0, "ms": 0.0})
    found = iter(witnesses)
    for fn, a, ms in calls:
        if fn == "ntt_k1":
            name, b = "ntt_k1", ntt_bound(card, "k1", a[4], a[5], a[6],
                                          bool(a[7]), a[8])
        elif fn == "ntt_k2":
            name, b = "ntt_k2", ntt_bound(card, "k2", a[3], a[4], a[5],
                                          False, a[6])
        elif fn == "keccak_sponge_rows":
            name, b = "keccak_sponge", sponge_bound(card, a[2], a[3])
        elif fn == "keccak_compress":
            name, b = "keccak_compress", compress_bound(card, a[3])
        elif fn == "keccak256_chain":
            name, b = "keccak256_chain", chain_bound(card, a[2], a[3])
        elif fn == "keccak_grind":
            name, b = "keccak_grind", grind_bound(card, a[1], next(found))
        elif fn == "poseidon2_duplex_chain":  # a[8:10]: rounds, degree
            key = (a[9], a[8])
            name = fn + P2_SUFFIX[key]
            b = p2_chain_bound(card, a[2], key)
        elif fn == "gl_sponge_rows":
            name, b = "gl_sponge", gl_sponge_bound(card, a[1], a[2])
        elif fn == "gl_compress":
            name, b = "gl_compress", gl_compress_bound(card, a[4])
        elif fn == "gl_permute":
            name, b = "gl_permute", gl_permute_bound(card, a[1])
        elif fn == "poseidon2_grind":  # a[7:9]: rounds, degree
            key = (a[8], a[7])
            name = fn + P2_SUFFIX[key]
            b = p2_grind_bound(card, next(found), key)
        else:
            m, levels = a[2], a[3]
            name, b = "keccak_ladder", ladder_bound(card, m,
                                                     m - (m >> levels))
        out[name]["launches"] += 1
        out[name]["bound_ms"] += b[0]
        out[name]["ms"] += ms
    return dict(out)


def sass_counts(so, tags):
    """{key: static SASS instruction count and the commonest opcodes} of
    the kernels in library `so` whose mangled names hold tags[key]
    (cuobjdump of the built library)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(so)], capture_output=True,
                          text=True, check=True).stdout
    counts, cur = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            cur = None
            for key, tag in tags.items():
                if tag in line:
                    cur = counts.setdefault(key, collections.Counter())
            continue
        op = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z]\w*)",
                      line)
        if cur is not None and op:
            cur[op.group(1)] += 1
    return {k: {"total": sum(c.values()), **dict(c.most_common(8))}
            for k, c in sorted(counts.items())}


def ntt_sass(kernels):
    """The SASS counts (`sass_counts`) of the size-2^9 NTT kernels, the
    main path's sub-transforms. The kernel is unrolled, so the count is
    about what one thread issues."""
    return sass_counts(kernels.so_path("ntt"),
                       {"k1": "ILi9ELb1E", "k2": "ILi9ELb0E"})


# the probe's chains: 2^18 steps each
PROBE_REPS = 1 << 12
PROBE_SRC = Path(__file__).resolve().parent / "plonky3_tpu_torch/csrc/probe.cu"


def start_probe_build(kernels):
    """Start nvcc on csrc/probe.cu, an instrument of this script and not
    one of the port's kernels; returns (process, library path)."""
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = kernels.BUILD_DIR / f"probe-{os.getpid()}.so"
    return kernels.start_nvcc(PROBE_SRC, so), so


def latency_probe(torch, kernels, build):
    """(L, the SM clock one busy warp sees in MHz, the probe's record):
    csrc/probe.cu's dependent chains, the second of two launches, once
    `build` (start_probe_build's) has finished. L is the smaller of the
    IADD3/LOP3 and IMAD.WIDE.U32 chains' cycles a step."""
    import ctypes

    proc, so = build
    text, _ = proc.communicate()
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {PROBE_SRC}:\n{text}")
    probe = ctypes.CDLL(str(so)).latency_probe
    probe.argtypes = [ctypes.c_uint32, ctypes.c_uint32, ctypes.c_longlong,
                      ctypes.c_void_p, ctypes.c_void_p]
    probe.restype = ctypes.c_int
    out = torch.zeros(36, dtype=torch.int64, device="cuda")
    for _ in range(2):
        kernels.check(probe(0x9E3779B9, 0x7F4A7C15, PROBE_REPS,
                            out.data_ptr(), kernels.stream_of(out)),
                      "latency_probe")
        torch.cuda.synchronize()
    c_add, ns_add, c_mul, ns_mul = (int(v) for v in out[:4].tolist())
    steps = PROBE_REPS * 64
    rec = {"iadd3_lop3_cycles": c_add / (2 * steps),
           "imad_wide_cycles": c_mul / steps,
           "one_warp_sm_clock_mhz": (c_add + c_mul) / (ns_add + ns_mul) * 1e3}
    lat = min(rec["iadd3_lop3_cycles"], rec["imad_wide_cycles"])
    return lat, rec["one_warp_sm_clock_mhz"], rec


def card_name():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def int_peak(torch):
    """(integer operations a second, the maximum SM clock in MHz, SMs):
    SMs × 64 lanes × the maximum SM clock."""
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * INT_LANES_PER_SM * clock_mhz * 1e6, clock_mhz, sms


def phase_card(torch, kernels):
    smi = card_name()
    print(smi, flush=True)
    peak, clock_mhz, sms = int_peak(torch)
    t0 = time.perf_counter()
    probe_build = start_probe_build(kernels)
    try:
        report = kernels.build_all()
    except BaseException:
        probe_build[0].kill()
        raise
    build_s = round(time.perf_counter() - t0, 3)
    regs = {}
    for name, (_, out) in report.items():
        regs[name] = [ln.strip().replace("ptxas info    : ", "")
                      for ln in out.splitlines()
                      if "registers" in ln or "spill" in ln
                      or "entry function" in ln]
    lat, warp_mhz, probe = latency_probe(torch, kernels, probe_build)
    emit({"phase": "card", "nvidia_smi": smi, "sms": sms,
          "max_sm_clock_mhz": clock_mhz, "int_ops_per_s": peak,
          "dep_latency_cycles": lat, "one_warp_sm_clock_mhz": warp_mhz,
          "probe": probe,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": build_s, "built": sorted(report), "ptxas": regs,
          "ntt_sass": ntt_sass(kernels),
          "grind_sass": {
              **sass_counts(kernels.so_path("keccak"),
                            {"keccak_grind": "keccak_grind_kernel"}),
              **sass_counts(kernels.so_path("poseidon2"),
                            {"poseidon2_grind": "duplex_grind_kernelILi23",
                             "poseidon2_grind_babybear":
                                 "duplex_grind_kernelILi21"})}})
    return Card(peak, lat / (clock_mhz * 1e6))


# a draw of more words than this is made on the card: numpy took seconds
# and gigabytes of host memory for each of the 10^8-10^9 words of the
# kernel checks at the AIRs' widths
HOST_DRAW_WORDS = 1 << 22


def _rand_words(torch, rng, shape, P):
    """Words below P on the card, drawn by `rng`, or, above
    HOST_DRAW_WORDS words, on the card from a seed that `rng` draws."""
    import numpy as np

    if np.prod(shape) > HOST_DRAW_WORDS and P < 1 << 31:
        return _rand_words_device(torch, int(rng.integers(1 << 62)), shape,
                                  P)
    x = rng.integers(0, P, size=shape, dtype=np.uint64).astype(np.int64)
    return torch.from_numpy(x).to(torch.int32).cuda()


def _rand_words_device(torch, seed, shape, P):
    """Words below P drawn on the card by a seeded torch generator: the
    inputs at the wide widths, which numpy would take tens of seconds and
    tens of GB of host memory to draw."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randint(0, P, shape, generator=g, device="cuda",
                         dtype=torch.int32)


def compare(what, got, want):
    """A kernel's output against its plain version's: the max absolute
    difference, which must be 0."""
    import torch

    torch.cuda.synchronize()
    err = (got.to(torch.int64) - want.to(torch.int64)).abs().max()
    err = int(err) if got.numel() else 0
    if got.shape != want.shape or err != 0:
        raise AssertionError(f"{what}: kernel differs from plain "
                             f"(max abs err {err})")
    return err


# KeccakAir's and Blake3Air's widths (models/keccak_air.py
# NUM_KECCAK_COLS, models/blake3_air.py NUM_BLAKE3_COLS) and that of
# Poseidon2VectorAir(BabyBear, 16, 8) (8 × 298 columns, s-box registers):
# the NTTs and the leaf sponge run at them on the keccak-AIR, Blake3-AIR
# and BabyBear paths, the last with BabyBear's words and tables
KECCAK_AIR_WIDTH = 2633
BLAKE3_AIR_WIDTH = 9168
BABYBEAR_WIDTH = 2384
# Sha256Air's (models/sha256_air.py NUM_SHA256_COLS)
SHA256_AIR_WIDTH = 7728
# KeccakAir's ZK trace (`zk_air`): its columns and one random codeword
# column over the doubled domain, 2^18 rows, whose LDE at a blowup of 4
# has 2^20
ZK_TRACE_WIDTH = KECCAK_AIR_WIDTH + 1
AIR_WIDTHS = {KECCAK_AIR_WIDTH: "keccak_air", BLAKE3_AIR_WIDTH: "blake3_air",
              BABYBEAR_WIDTH: "babybear", SHA256_AIR_WIDTH: "sha256_air",
              ZK_TRACE_WIDTH: "zk_air"}
# the log height of a path's trace LDE, where it is not 18
LDE_LOG_N = {ZK_TRACE_WIDTH: 20}
# the widths whose inputs are drawn on the card and whose plain versions
# run on a part of the kernel's work (PLAIN_NTT_COLUMNS, PLAIN_SPONGE_ROWS)
WIDE_WIDTHS = (BLAKE3_AIR_WIDTH, SHA256_AIR_WIDTH, ZK_TRACE_WIDTH)
# columns of one plain NTT at a wide width (the whole 2^18 x 9,168 int64
# transform and its temporaries do not fit the card at once)
PLAIN_NTT_COLUMNS = 2048
# rows of the plain leaf sponge at a wide width (2^16 rows of 9,168
# columns took 22.7 s on an H100 80GB HBM3 at a 700 W power limit)
PLAIN_SPONGE_ROWS = 1 << 14


def at_width(path, err, ms, ms_src, wall, plain, b, sh, shape):
    """A kernel record's keys at an AIR path's shape."""
    return {f"max_abs_err_{path}": err, f"ms_{path}": ms,
            f"ms_source_{path}": ms_src, f"wall_ms_{path}": wall,
            f"plain_ms_{path}": plain, f"bound_ms_{path}": b[0],
            f"bound_by_{path}": b[1], f"share_{path}": sh,
            f"shape_{path}": shape}


def plain_by_columns(torch, plain, x, got, what,
                     columns=PLAIN_NTT_COLUMNS):
    """A column-wise function's plain version over x in blocks of
    `columns` columns, each held against the same columns of the
    kernel's output `got`: (max abs err, the plain versions' summed
    milliseconds by CUDA events)."""
    err, ms = 0, 0.0
    for c in range(0, x.shape[1], columns):
        part = x[:, c:c + columns].contiguous()
        want, t = once_ms(torch, lambda: plain(part))
        err = max(err, compare(f"{what} columns {c}",
                               got[:, c:c + columns], want))
        ms += t
        del want
    return err, ms


def sponge_m31(torch, card, records):
    """The leaf sponge on canonical Mersenne-31 words at the circle
    KeccakAir path's LDE shape (2^18 x 2,633; its first row all P - 1,
    its second all 0): the kernel over every row, the plain version over
    PLAIN_SPONGE_ROWS rows sampled across the matrix (a row's digest reads
    that row alone), bit for bit; the `*_circle_keccak_air` keys."""
    from plonky3_tpu_torch.fields.mersenne31 import Mersenne31
    from plonky3_tpu_torch.hashes import keccak_cuda as kc

    h, w, P = 1 << 18, KECCAK_AIR_WIDTH, Mersenne31.P
    flat = _rand_words_device(torch, 31, (h, w), P)
    flat[0] = P - 1
    flat[1] = 0
    got = kc.keccak_sponge_rows(flat)
    g = torch.Generator(device="cuda").manual_seed(32)
    idx = torch.cat([torch.arange(2, device="cuda"), torch.randint(
        2, h, (PLAIN_SPONGE_ROWS - 2,), generator=g, device="cuda")])
    rows = flat.index_select(0, idx)
    want, plain = once_ms(torch, lambda: kc.keccak_sponge_rows_plain(rows))
    err = compare(f"sponge m31 {h} {w}", got.index_select(0, idx), want)
    run = lambda: kc.keccak_sponge_rows(flat)  # noqa: E731
    ms, ms_src = profiled_ms(torch, run, 10, "sponge_rows_kernel")
    wall = cuda_ms(torch, run, 10)
    b = sponge_bound(card, h, w)
    sh = share(f"sponge m31 {w}", b[0], ms)
    records["keccak_sponge"].update(at_width(
        "circle_keccak_air", err, ms, ms_src, wall, plain, b, sh, [h, w]))
    records["keccak_sponge"]["plain_rows_circle_keccak_air"] = (
        PLAIN_SPONGE_ROWS)
    emit({"phase": "kernels", "kernel": "keccak_sponge", "field":
          "Mersenne31", "h": h, "w": w, "max_abs_err": err,
          "plain_rows": PLAIN_SPONGE_ROWS, "ms": ms, "ms_source": ms_src,
          "wall_ms": wall, "plain_ms": plain, "bound_ms": b[0],
          "bound_by": b[1], "share": sh})


def phase_kernels(torch, np, card):
    """Every kernel against its plain version; returns the per-kernel
    records of the main-path shapes."""
    from plonky3_tpu_torch import kernels
    from plonky3_tpu_torch.fields import BabyBear
    from plonky3_tpu_torch.fields import KoalaBear as F
    from plonky3_tpu_torch.hashes import keccak_cuda as kc
    from plonky3_tpu_torch.hashes.keccak_sponge import KeccakCompressor
    from plonky3_tpu_torch.merkle.mmcs import levels_by_compress
    from plonky3_tpu_torch.ops import ntt_cuda as nc

    def field_at(w):
        """BabyBear at the BabyBear path's width, else KoalaBear."""
        return BabyBear if w == BABYBEAR_WIDTH else F

    rng = np.random.default_rng(5)
    records = {}

    # NTT: (log_n, w, inverse, zero_top); the first two and the 13th
    # and 14th are the main path's shapes (trace iDFT and LDE,
    # quotient-chunk iDFT and LDE), the third to 12th the keccak-AIR,
    # Blake3-AIR, BabyBear, Sha256-AIR and ZK keccak-AIR paths' trace
    # iDFT and LDE (at the wide widths the plain version runs
    # PLAIN_NTT_COLUMNS columns at a time; at the BabyBear width over
    # BabyBear's tables; the ZK trace's LDE is 2^20 rows); the last
    # three go through more than one level of the plan.
    ntt_cases = [(17, 1312, True, False), (18, 1312, False, True),
                 (17, KECCAK_AIR_WIDTH, True, False),
                 (18, KECCAK_AIR_WIDTH, False, True),
                 (17, BLAKE3_AIR_WIDTH, True, False),
                 (18, BLAKE3_AIR_WIDTH, False, True),
                 (17, BABYBEAR_WIDTH, True, False),
                 (18, BABYBEAR_WIDTH, False, True),
                 (17, SHA256_AIR_WIDTH, True, False),
                 (18, SHA256_AIR_WIDTH, False, True),
                 (18, ZK_TRACE_WIDTH, True, False),
                 (20, ZK_TRACE_WIDTH, False, True),
                 (17, 4, True, False), (18, 4, False, True),
                 (1, 5, False, False), (1, 5, True, True),
                 (6, 5, False, False), (6, 5, True, False),
                 (6, 5, False, True), (9, 128, False, False),
                 (9, 128, True, False), (9, 128, False, True),
                 (13, 200, False, False), (21, 4, False, True),
                 (21, 4, True, False), (22, 3, False, False)]
    for log_n, w, inverse, zero_top in ntt_cases:
        Fw = field_at(w)
        rows = (1 << log_n) >> 1 if zero_top else 1 << log_n
        x = (_rand_words_device(torch, log_n, (rows, w), Fw.P)
             if w in WIDE_WIDTHS else
             _rand_words(torch, rng, (rows, w), Fw.P))
        before = dict(kernels.LAUNCHES)
        got = nc.dif_fused(Fw, x, log_n, inverse, zero_top)
        ran = {k: kernels.LAUNCHES[k] - before[k]
               for k in ("ntt_k1", "ntt_k2")}

        def plain_ntt(part):
            return nc.dif_fused_plain(Fw, part, log_n, inverse, zero_top)

        if w in WIDE_WIDTHS:
            # as many int64 values a block as 2^18 rows of
            # PLAIN_NTT_COLUMNS (the ZK LDE has 2^20 rows)
            err, plain = plain_by_columns(
                torch, plain_ntt, x, got, f"ntt {log_n} {w}",
                PLAIN_NTT_COLUMNS >> max(0, log_n - 18))
        elif w in AIR_WIDTHS:  # the plain run compared is the one timed
            want, plain = once_ms(torch, lambda: plain_ntt(x))
            err = compare(f"ntt {log_n} {w}", got, want)
            del want
        else:
            err = compare(f"ntt {log_n} {w}", got, plain_ntt(x))
        steps = nc.plan(log_n, zero_top)
        planned = {f"ntt_{k}": sum(s.kernel == k for s in steps)
                   for k in ("k1", "k2")}
        if ran != planned:
            raise AssertionError(f"ntt {log_n} {w}: launched {ran}, "
                                 f"planned {planned}")
        rec = {"log_n": log_n, "w": w, "field": Fw.name, "inverse": inverse,
               "zero_top": zero_top, "k1_launches": ran["ntt_k1"],
               "k2_launches": ran["ntt_k2"], "max_abs_err": err}
        if w in WIDE_WIDTHS:
            rec["plain_columns"] = PLAIN_NTT_COLUMNS
        if log_n in (17, 18) or (log_n, w) == (20, ZK_TRACE_WIDTH):
            n = 1 << log_n
            s1, s2 = steps
            log_a, log_b = s1.log_a, s1.log_b
            y1 = torch.empty((n, w), dtype=torch.int32, device=x.device)
            out = torch.empty_like(y1)
            # device time (ms); CUDA events around the call beside it
            run1 = lambda: nc.launch(Fw, s1, x, y1, inverse)  # noqa: E731
            run2 = lambda: nc.launch(Fw, s2, y1, out, inverse)  # noqa: E731
            k1, k1_src = profiled_ms(torch, run1, 10, "ntt_kernel<")
            k2, k2_src = profiled_ms(torch, run2, 10, "ntt_kernel<")
            k1_wall, k2_wall = cuda_ms(torch, run1, 10), cuda_ms(torch, run2,
                                                                 10)
            if w not in AIR_WIDTHS:
                plain = cuda_ms(torch, lambda: plain_ntt(x), 2)
            b1 = ntt_bound(card, "k1", log_a, log_b, w, zero_top)
            b2 = ntt_bound(card, "k2", log_a, log_b, w, zero_top)
            sh1, sh2 = share("ntt_k1", b1[0], k1), share("ntt_k2", b2[0], k2)
            rec.update(k1_ms=k1, k2_ms=k2, k1_ms_source=k1_src,
                       k2_ms_source=k2_src, k1_wall_ms=k1_wall,
                       k2_wall_ms=k2_wall, plain_ms=plain,
                       k1_bound_ms=b1[0], k1_bound_by=b1[1], k1_share=sh1,
                       k2_bound_ms=b2[0], k2_bound_by=b2[1], k2_share=sh2)
            if (log_n, w) == (18, 1312):
                src = "plonky3_tpu_torch/csrc/ntt.cu"
                for name, ms, ms_src, wall, b, sh, line in (
                        ("ntt_k1", k1, k1_src, k1_wall, b1, sh1, 149),
                        ("ntt_k2", k2, k2_src, k2_wall, b2, sh2, 158)):
                    records[name] = dict(
                        name=name, route="cuda", source=src,
                        replaces=f"plonky3_tpu/ops/ntt_pallas.py:{line}",
                        max_abs_err=err, ms=ms, ms_source=ms_src,
                        wall_ms=wall, plain_ms=plain,
                        bound_ms=b[0], bound_by=b[1], library_ms=None,
                        share=sh, shape=[log_n, w, "zero_top"])
            if log_n == LDE_LOG_N.get(w, 18) and w in AIR_WIDTHS:
                for name, ms, ms_src, wall, b, sh in (
                        ("ntt_k1", k1, k1_src, k1_wall, b1, sh1),
                        ("ntt_k2", k2, k2_src, k2_wall, b2, sh2)):
                    records[name].update(at_width(
                        AIR_WIDTHS[w], err, ms, ms_src, wall, plain, b, sh,
                        [log_n, w, "zero_top"]))
            del y1, out
        emit({"phase": "kernels", "kernel": "ntt", **rec})
        del x, got

    # the leaf sponge; at a wide width the kernel runs over all 2^18 rows
    # and its first PLAIN_SPONGE_ROWS rows are held against the plain
    # version (a row's digest reads that row alone); the plain run
    # compared is the one timed
    src = "plonky3_tpu_torch/csrc/keccak.cu"
    for h, w in [(1 << 18, 1312), (1 << 18, KECCAK_AIR_WIDTH),
                 (1 << 18, BLAKE3_AIR_WIDTH), (1 << 18, BABYBEAR_WIDTH),
                 (1 << 18, SHA256_AIR_WIDTH), (1 << 18, 8), (1 << 18, 32),
                 (1, 3), (5, 35), (300, 34), (7, 1)]:
        P = field_at(w).P
        flat = (_rand_words_device(torch, w, (h, w), P)
                if w in WIDE_WIDTHS else
                _rand_words(torch, rng, (h, w), P))
        got = kc.keccak_sponge_rows(flat)
        rec = {"h": h, "w": w}
        if w in WIDE_WIDTHS:
            rows = flat[:PLAIN_SPONGE_ROWS]
            want, plain = once_ms(torch,
                                  lambda: kc.keccak_sponge_rows_plain(rows))
            err = compare(f"sponge {h} {w}", got[:PLAIN_SPONGE_ROWS], want)
            rec.update(plain_rows=PLAIN_SPONGE_ROWS)
        else:
            want, plain = once_ms(torch,
                                  lambda: kc.keccak_sponge_rows_plain(flat))
            err = compare(f"sponge {h} {w}", got, want)
        rec["max_abs_err"] = err
        if h >= 1 << 18:
            run = lambda: kc.keccak_sponge_rows(flat)  # noqa: E731
            ms, ms_src = profiled_ms(torch, run, 10, "sponge_rows_kernel")
            wall = cuda_ms(torch, run, 10)
            b = sponge_bound(card, h, w)
            rec.update(ms=ms, ms_source=ms_src, wall_ms=wall, plain_ms=plain,
                       bound_ms=b[0], bound_by=b[1],
                       share=share(f"sponge {w}", b[0], ms))
            if w == 1312:
                records["keccak_sponge"] = dict(
                    name="keccak_sponge", route="cuda", source=src,
                    replaces="plonky3_tpu/hashes/keccak_pallas.py:124",
                    max_abs_err=err, ms=ms, ms_source=ms_src, wall_ms=wall,
                    plain_ms=plain, bound_ms=b[0],
                    bound_by=b[1], library_ms=None, share=rec["share"],
                    shape=[h, w])
            elif w in AIR_WIDTHS:
                records["keccak_sponge"].update(at_width(
                    AIR_WIDTHS[w], err, ms, ms_src, wall, plain, b,
                    rec["share"], [h, w]))
        emit({"phase": "kernels", "kernel": "keccak_sponge", **rec})
        del flat, got, want

    sponge_m31(torch, card, records)

    for h in [1 << 17, 1, 3, 1000]:
        left = _rand_words(torch, rng, (h, 8), 1 << 32)
        right = _rand_words(torch, rng, (h, 8), 1 << 32)
        got = kc.keccak_compress(left, right)
        want = kc.keccak_compress_plain(left, right)
        err = compare(f"compress {h}", got, want)
        rec = {"h": h, "max_abs_err": err}
        if h == 1 << 17:
            run = lambda: kc.keccak_compress(left, right)  # noqa: E731
            ms, ms_src = profiled_ms(torch, run, 20, "compress_kernel")
            wall = cuda_ms(torch, run, 20)
            plain = cuda_ms(torch,
                            lambda: kc.keccak_compress_plain(left, right), 2)
            b = compress_bound(card, h)
            rec.update(ms=ms, ms_source=ms_src, wall_ms=wall, plain_ms=plain,
                       bound_ms=b[0], bound_by=b[1],
                       share=share("compress", b[0], ms))
            records["keccak_compress"] = dict(
                name="keccak_compress", route="cuda", source=src,
                replaces="plonky3_tpu/hashes/keccak_pallas.py:227",
                max_abs_err=err, ms=ms, ms_source=ms_src, wall_ms=wall,
                plain_ms=plain, bound_ms=b[0],
                bound_by=b[1], library_ms=None, share=rec["share"],
                shape=[h, 8])
        emit({"phase": "kernels", "kernel": "keccak_compress", **rec})

    # Merkle ladder: one 2^18-leaf tree (the main path's), a two-launch
    # 2^15, exactly one subtree (2^9), a partial block (2^8, 2^3), 2.
    comp = KeccakCompressor()
    for log_n in (18, 15, 9, 8, 3, 1):
        n = 1 << log_n
        d = _rand_words(torch, rng, (n, 8), 1 << 32)
        before = kernels.LAUNCHES["keccak_ladder"]
        got = kc.keccak_merkle_ladder(d)
        ran = kernels.LAUNCHES["keccak_ladder"] - before
        want, plain = once_ms(torch,
                              lambda: kc.keccak_merkle_ladder_plain(d))
        err = compare(f"ladder {n}", got, want)
        if ran != len(kc.ladder_plan(n)):
            raise AssertionError(f"ladder {n}: launched {ran}, planned "
                                 f"{len(kc.ladder_plan(n))}")
        rec = {"n": n, "launches": ran, "max_abs_err": err}
        if log_n == 18:
            # ms: the ladder kernel's device time; *_wall_ms: CUDA events
            # around the Python call, host dispatch gaps included
            ladder = lambda: kc.keccak_merkle_ladder(d)  # noqa: E731
            ms, ms_src = profiled_ms(torch, ladder, 20, "merkle_ladder_kernel")
            wall = cuda_ms(torch, ladder, 20)
            leaves = d.to(torch.int64) & 0xFFFFFFFF
            # the route it replaced: one compress_device call per level
            old = lambda: levels_by_compress(comp, leaves)  # noqa: E731
            old_wall = cuda_ms(torch, old, 10)
            old_dev = profiled_ms(torch, old, 5)[0]
            route = cuda_ms(torch, lambda: comp.ladder_device(d), 10)
            b = ladder_bound(card, n, n - 1)
            rec.update(ms=ms, ms_source=ms_src, wall_ms=wall, plain_ms=plain,
                       per_level_route_device_ms=old_dev,
                       per_level_route_wall_ms=old_wall,
                       ladder_device_wall_ms=route,
                       speedup_device=old_dev / ms,
                       speedup_wall=old_wall / wall,
                       bound_ms=b[0], bound_by=b[1],
                       share=share("ladder", b[0], ms))
            records["keccak_ladder"] = dict(
                name="keccak_ladder", route="cuda", source=src,
                replaces="plonky3_tpu/hashes/keccak_pallas.py:227",
                max_abs_err=err, ms=ms, ms_source=ms_src, wall_ms=wall,
                plain_ms=plain, bound_ms=b[0], bound_by=b[1], library_ms=None,
                share=rec["share"], per_level_route_device_ms=old_dev,
                shape=[n, 8])
        emit({"phase": "kernels", "kernel": "keccak_ladder", **rec})

    # The transcript's digest chain: the padding's edge lengths (33: both
    # pads in one word; 34: a fresh block), and the main path's longest
    # call, the opened values absorbed before alpha2 (10,536 words, k = 2).
    # The plain chain of k digests is the first k rows of the plain chain
    # of 13, so each length runs its plain version once: at 10,536 words
    # (some 21 s) the timed plain chain of 2, its last digest then
    # re-hashed 11 times by the same plain function.
    serializing = "plonky3_tpu/challenger/device_serializing.py"
    for n in (0, 1, 33, 34, 35, 10536):
        words = _rand_words(torch, rng, (n,), 1 << 32)
        if n == 10536:
            want, plain = once_ms(torch, lambda: kc.keccak256_chain_plain(
                words, 2))
            want = torch.cat([want, kc.keccak256_chain_plain(want[1], 11)])
        else:
            want = kc.keccak256_chain_plain(words, 13)
        for k in (1, 2, 13):
            got = kc.keccak256_chain(words, k)
            err = compare(f"chain {n} {k}", got, want[:k])
            rec = {"n": n, "k": k, "max_abs_err": err}
            if (n, k) == (10536, 2):
                chain = lambda: kc.keccak256_chain(words, 2)  # noqa: E731
                ms, ms_src = profiled_ms(torch, chain, 10,
                                         "keccak256_chain_kernel")
                wall = cuda_ms(torch, chain, 10)
                b = chain_bound(card, n, k)
                rec.update(ms=ms, ms_source=ms_src, wall_ms=wall,
                           plain_ms=plain,
                           us_per_keccak_f=ms * 1e3 / (n // 34 + k),
                           bound_ms=b[0], bound_by=b[1],
                           share=share("chain", b[0], ms))
                records["keccak256_chain"] = dict(
                    name="keccak256_chain", route="cuda", source=src,
                    replaces=f"{serializing}:57", max_abs_err=err, ms=ms,
                    ms_source=ms_src, wall_ms=wall, plain_ms=plain,
                    bound_ms=b[0], bound_by=b[1], library_ms=None,
                    share=rec["share"],
                    us_per_keccak_f=rec["us_per_keccak_f"], shape=[n, k])
            emit({"phase": "kernels", "kernel": "keccak256_chain", **rec})

    # The proof-of-work grind: 18 words (the main path's message), 33 (the
    # witness ends a block: the padding opens one), 40 (a block before the
    # witness's); at 1 bit many candidates of a sweep pass and the
    # smallest must win.
    for m in (18, 33, 40):
        words = _rand_words(torch, rng, (m,), 1 << 32)
        for bits in (1, 4, 8, 12, 16):
            got = kc.keccak_grind(words, bits, F.P)
            want = kc.keccak_grind_plain(words, bits, F.P)
            err = compare(f"grind {m} {bits}", got, want)
            w = int(got[0])
            rec = {"m": m, "pow_bits": bits, "witness": w, "max_abs_err": err}
            if (m, bits) == (GRIND_WORDS, 16):
                grind = lambda: kc.keccak_grind(words, 16, F.P)  # noqa: E731
                ms, ms_src = profiled_ms(torch, grind, 10,
                                         "keccak_grind_kernel")
                wall = cuda_ms(torch, grind, 10)
                plain = cuda_ms(torch, lambda: kc.keccak_grind_plain(
                    words, 16, F.P), 2)
                b = grind_bound(card, m, w)
                rec.update(ms=ms, ms_source=ms_src, wall_ms=wall,
                           plain_ms=plain, bound_ms=b[0], bound_by=b[1],
                           share=share("grind", b[0], ms))
                records["keccak_grind"] = dict(
                    name="keccak_grind", route="cuda", source=src,
                    replaces=f"{serializing}:141", max_abs_err=err, ms=ms,
                    ms_source=ms_src, wall_ms=wall, plain_ms=plain,
                    bound_ms=b[0], bound_by=b[1], library_ms=None,
                    share=rec["share"], shape=[m, 16], witness=w)
            emit({"phase": "kernels", "kernel": "keccak_grind", **rec})
    messages = [torch.from_numpy(w).to(torch.int32).cuda()
                for w in sweep_states(np, F.P)[0]]
    sweep = grind_sweep(
        torch, "keccak grind",
        lambda w: kc.keccak_grind(w, SWEEP_BITS, F.P),
        lambda w: kc.keccak_grind_plain(w, SWEEP_BITS, F.P),
        lambda w: grind_bound(card, GRIND_WORDS, w), messages)
    records["keccak_grind"].update(sweep)
    emit({"phase": "kernels", "kernel": "keccak_grind", "m": GRIND_WORDS,
          "pow_bits": SWEEP_BITS, **sweep})
    phase_kernels_poseidon2(torch, np, card, rng, records)
    phase_kernels_goldilocks(torch, np, card, records)
    phase_kernels_m21(torch, np, card, records)
    return records


# the longest duplex absorb of the Poseidon2 path: the opened values before
# alpha2, 2 × 1312 trace values and 2 quotient chunks of 4, 4 words each;
# over BabyBear, 2 × 2,384 trace values
P2_ALPHA2_WORDS = (2 * 1312 + 2 * 4) * 4
P2_ALPHA2_WORDS_BABYBEAR = (2 * BABYBEAR_WIDTH + 2 * 4) * 4


def once_ms(torch, fn):
    """(fn(), its milliseconds by CUDA events) for one run: the plain
    versions, seconds long, run once."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def phase_kernels_poseidon2(torch, np, card, rng, records):
    """The Poseidon2 duplex transcript's kernels against their plain
    versions, both instantiations: KoalaBear's <23, 3> and BabyBear's
    <21, 7> (records `*_babybear`). The chain at 0 blocks (a bare
    permutation), 1 and 2 blocks, partial last blocks of 1 and 15 lanes,
    and the Poseidon2 path's longest absorb; the grind at 1 to 16 bits
    from two staged states and over the sweep's."""
    from plonky3_tpu_torch.fields import BabyBear, KoalaBear
    from plonky3_tpu_torch.hashes import poseidon2_cuda as pc
    from plonky3_tpu_torch.hashes.poseidon2 import default_poseidon2

    src = "plonky3_tpu_torch/csrc/poseidon2.cu"
    duplex = "plonky3_tpu/challenger/device_duplex.py"
    for F, longest in ((KoalaBear, P2_ALPHA2_WORDS),
                       (BabyBear, P2_ALPHA2_WORDS_BABYBEAR)):
        perm = default_poseidon2(F, 24)
        key = pc.instance(perm)
        chain_name = pc.launch_name("poseidon2_duplex_chain", perm)
        grind_name = pc.launch_name("poseidon2_grind", perm)
        tag = f"<{key[1]}, {key[0]}>"
        for n in (0, 16, 32, 1, 15, 17, 31, longest):
            state = _rand_words(torch, rng, (24,), F.P)
            words = _rand_words(torch, rng, (n,), F.P)
            got = pc.poseidon2_duplex_chain(perm, state, words)
            want, plain = once_ms(
                torch, lambda: pc.poseidon2_duplex_chain_plain(perm, state,
                                                               words))
            err = compare(f"{chain_name} {n}", got, want)
            nb, k = pc._blocks(n)
            rec = {"field": F.name, "instance": tag, "n": n, "blocks": nb,
                   "last_block_lanes": k, "max_abs_err": err,
                   "plain_ms": plain}
            if n == longest:
                chain = lambda: pc.poseidon2_duplex_chain(  # noqa: E731
                    perm, state, words)
                ms, ms_src = profiled_ms(
                    torch, chain, 10, "duplex_chain_kernel" + tag[:3])
                b = p2_chain_bound(card, n, key)
                rec.update(ms=ms, ms_source=ms_src,
                           wall_ms=cuda_ms(torch, chain, 10),
                           us_per_permutation=ms * 1e3 / nb, bound_ms=b[0],
                           bound_by=b[1], share=share(chain_name, b[0], ms))
                records[chain_name] = dict(
                    name=chain_name, route="cuda", source=src,
                    replaces=f"{duplex}:58", max_abs_err=err, ms=ms,
                    ms_source=ms_src, wall_ms=rec["wall_ms"],
                    plain_ms=plain, bound_ms=b[0], bound_by=b[1],
                    library_ms=None, share=rec["share"],
                    us_per_permutation=rec["us_per_permutation"],
                    instance=tag, shape=[n, nb])
            emit({"phase": "kernels", "kernel": chain_name, **rec})

        for lane in (0, GRIND_LANE):
            base = _rand_words(torch, rng, (24,), F.P)
            for bits in (1, 4, 8, 12, 16):
                got = pc.poseidon2_grind(perm, base, lane, bits)
                want, plain = once_ms(
                    torch, lambda: pc.poseidon2_grind_plain(perm, base,
                                                            lane, bits))
                err = compare(f"{grind_name} {lane} {bits}", got, want)
                w = int(got[0])
                rec = {"field": F.name, "instance": tag, "lane": lane,
                       "pow_bits": bits, "witness": w, "max_abs_err": err,
                       "plain_ms": plain}
                if (lane, bits) == (GRIND_LANE, 16):
                    grind = lambda: pc.poseidon2_grind(  # noqa: E731
                        perm, base, lane, 16)
                    ms, ms_src = profiled_ms(
                        torch, grind, 10, "duplex_grind_kernel" + tag[:3])
                    b = p2_grind_bound(card, w, key)
                    rec.update(ms=ms, ms_source=ms_src,
                               wall_ms=cuda_ms(torch, grind, 10),
                               bound_ms=b[0], bound_by=b[1],
                               share=share(grind_name, b[0], ms))
                    records[grind_name] = dict(
                        name=grind_name, route="cuda", source=src,
                        replaces=f"{duplex}:146", max_abs_err=err, ms=ms,
                        ms_source=ms_src, wall_ms=rec["wall_ms"],
                        plain_ms=plain, bound_ms=b[0], bound_by=b[1],
                        library_ms=None, share=rec["share"],
                        instance=tag, shape=[lane, 16], witness=w)
                emit({"phase": "kernels", "kernel": grind_name, **rec})
        bases = [torch.from_numpy(b).to(torch.int32).cuda()
                 for b in sweep_states(np, F.P)[1]]
        sweep = grind_sweep(
            torch, grind_name,
            lambda b: pc.poseidon2_grind(perm, b, GRIND_LANE, SWEEP_BITS),
            lambda b: pc.poseidon2_grind_plain(perm, b, GRIND_LANE,
                                               SWEEP_BITS),
            lambda w: p2_grind_bound(card, w, key), bases)
        records[grind_name].update(sweep)
        emit({"phase": "kernels", "kernel": grind_name, "lane": GRIND_LANE,
              "pow_bits": SWEEP_BITS, **sweep})


# the Goldilocks STARK's shapes: MonolithGoldilocksAir's width, its LDE
# (2^GL_MONOLITH_LOG_N rows, blowup 2), a tree level of its trace, and a
# grind batch (gl/stark.py GRIND_BATCH_CUDA)
GL_MONOLITH_WIDTH = 3536
GL_MONOLITH_LOG_N = 16  # a cut of depth from the CLI objectives' 2^17
GL_FIB_LOG_N = 20
GL_SRC = "plonky3_tpu_torch/csrc/goldilocks.cu"
# rows of the LDE-shaped leaf check that the plain version hashes
GL_PLAIN_SPONGE_ROWS = 4


def _gl_words_device(torch, seed, shape):
    """Canonical Goldilocks elements drawn on the card (int64, the u64
    bits): a high half below 2^32 - 1 and any low half."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    hi = torch.randint(0, 0xFFFFFFFF, shape, generator=g, device="cuda",
                       dtype=torch.int64)
    lo = torch.randint(0, 1 << 32, shape, generator=g, device="cuda",
                       dtype=torch.int64)
    return (hi << 32) | lo


def _gl_record(name, replaces, err, ms, ms_src, wall, plain, b, sh, shape,
               **extra):
    return dict(name=name, route="cuda", source=GL_SRC, replaces=replaces,
                max_abs_err=err, ms=ms, ms_source=ms_src, wall_ms=wall,
                plain_ms=plain, bound_ms=b[0], bound_by=b[1],
                library_ms=None, share=sh, shape=shape, **extra)


def _gl_sponge_sample(np):
    """The LDE-shaped leaf check's sampled rows: their indices, and their
    elements from np.random.default_rng(45), the first all P - 1, the
    second all 0."""
    from plonky3_tpu_torch.fields.goldilocks import Goldilocks

    h = 1 << (GL_MONOLITH_LOG_N + 1)
    rng = np.random.default_rng(45)
    idx = np.concatenate([[0, 1], rng.choice(np.arange(2, h),
                                             GL_PLAIN_SPONGE_ROWS - 2,
                                             replace=False)])
    rows = rng.integers(0, Goldilocks.P, (GL_PLAIN_SPONGE_ROWS,
                                          GL_MONOLITH_WIDTH), dtype=np.uint64)
    rows[0], rows[1] = Goldilocks.P - 1, 0
    return idx, rows


def side_gl_sponge(np, torch, dev):
    """The plain leaf sponge over `_gl_sponge_sample`'s rows on `dev`:
    some 7 million tensor ops whatever the rows (64 s on the card as
    launches), so it runs in a CPU worker (`cpu_side`)."""
    from plonky3_tpu_torch.fields import goldilocks_device as gd
    from plonky3_tpu_torch.gl.field import to_numpy, to_tensor

    _, rows = _gl_sponge_sample(np)
    return {"plain": to_numpy(gd.gl_sponge_rows_plain(
        to_tensor(rows, dev))).tolist()}


# The CPU halves of the CUDA == CPU checks (the plain versions) run in
# worker processes that see no GPU, beside the card's phases: each is a
# `side_*` function called with the device "cpu" (`cpu_side`). The host
# has 8 cores; the workers take CPU_WORKERS x CPU_WORKER_THREADS of them.
CPU_WORKERS = 3
CPU_WORKER_THREADS = 2
_CPU = {}
# VERIFY_ONCE: a side function verifies its proofs on the CPU only: the
# card's proofs must equal them (as_plain), and the port's verifier is
# host work that reads a proof's values alone, so it runs once a proof.


def _cpu_worker_init():
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    import torch

    torch.set_num_threads(CPU_WORKER_THREADS)


def _cpu_job(fn, args):
    """globals()[fn](np, torch, "cpu", *args) in a worker: its `plain`
    result, its `secs` and the job's seconds."""
    import numpy as np
    import torch

    t0 = time.perf_counter()
    out = globals()[fn](np, torch, "cpu", *args)
    return out["plain"], out.get("secs", {}), time.perf_counter() - t0


def start_cpu_jobs(phases=None):
    """Submit every job of CPU_JOBS (or those that `phases` read), in the
    order the phases read them, to a pool of CPU_WORKERS spawned
    processes (once). A script that imports this module and runs phases
    guards its own body with `if __name__ == "__main__"`: a spawned
    worker imports the main module."""
    if _CPU:
        return
    import multiprocessing

    pool = multiprocessing.get_context("spawn").Pool(CPU_WORKERS,
                                                     _cpu_worker_init)
    _CPU["pool"] = pool
    _CPU["jobs"] = {(fn, args): pool.apply_async(_cpu_job, (fn, args))
                    for phase, fn, args in CPU_JOBS
                    if phases is None or phase in phases}


def cpu_side(fn, *args):
    """(plain result, secs, job seconds) of `fn(np, torch, "cpu", *args)`,
    one of CPU_JOBS, from the worker pool; raises what the job raised."""
    start_cpu_jobs()
    return _CPU["jobs"][fn, args].get(timeout=1200)


def stop_cpu_jobs():
    if _CPU:
        _CPU["pool"].terminate()
        _CPU["pool"].join()
        _CPU.clear()


def sync(torch, dev):
    if dev == "cuda":
        torch.cuda.synchronize()


def phase_kernels_goldilocks(torch, np, card, records):
    """The Poseidon2-GL kernels against their plain versions, bit for bit:
    the leaf sponge at MonolithGoldilocksAir's LDE shape (2^17 x 3,536;
    the plain version over GL_PLAIN_SPONGE_ROWS sampled rows in a CPU
    worker, `side_gl_sponge`) and at narrow widths over every row (the
    tails of 1 to 3 elements), the compression on a whole 2^16-node level
    (the children of a reshaped level, as the trees pass them), the
    permutation on a grind batch. Each with its time, bound and share;
    plain_ms is the plain version's time on the card, and for the sponge
    the worker's on the CPU (`plain_device`)."""
    from plonky3_tpu_torch.fields import goldilocks_device as gd
    from plonky3_tpu_torch.gl.field import to_tensor
    from plonky3_tpu_torch.gl.stark import GRIND_BATCH_CUDA
    from plonky3_tpu_torch.hashes import poseidon2_goldilocks_cuda as pgc

    P = gd.P
    h, w = 1 << (GL_MONOLITH_LOG_N + 1), GL_MONOLITH_WIDTH
    mat = _gl_words_device(torch, 41, (h, w))
    idx, rows = _gl_sponge_sample(np)
    idx = torch.from_numpy(idx).cuda()
    mat[idx] = to_tensor(rows, "cuda")
    got = pgc.gl_sponge_rows(mat).index_select(0, idx)
    run = lambda: pgc.gl_sponge_rows(mat)  # noqa: E731
    ms, ms_src = profiled_ms(torch, run, 3, "gl_sponge_rows_kernel")
    wall = cuda_ms(torch, run, 3)
    b = gl_sponge_bound(card, h, w)
    sh = share(f"gl sponge {w}", b[0], ms)
    digests, _, plain_s = cpu_side("side_gl_sponge")
    want = to_tensor(np.array(digests, dtype=np.uint64), "cuda")
    err = compare(f"gl sponge {h} {w}", got, want)
    records["gl_sponge"] = _gl_record(
        "gl_sponge", "plonky3_tpu/gl/merkle.py:55", err, ms, ms_src, wall,
        plain_s * 1e3, b, sh, [h, w],
        plain_rows=GL_PLAIN_SPONGE_ROWS, plain_device="cpu")
    emit({"phase": "kernels", "kernel": "gl_sponge", "h": h, "w": w,
          "max_abs_err": err, "plain_rows": GL_PLAIN_SPONGE_ROWS, "ms": ms,
          "ms_source": ms_src, "wall_ms": wall,
          "plain_cpu_ms": plain_s * 1e3, "bound_ms": b[0],
          "bound_by": b[1], "share": sh})
    del mat
    for hw in ((1, 1), (5, 2), (33, 3), (130, 4), (257, 9), (64, 2)):
        m = _gl_words_device(torch, hw[1], hw)
        e = compare(f"gl sponge {hw}", pgc.gl_sponge_rows(m),
                    gd.gl_sponge_rows_plain(m))
        emit({"phase": "kernels", "kernel": "gl_sponge", "h": hw[0],
              "w": hw[1], "max_abs_err": e})

    n = 1 << GL_MONOLITH_LOG_N
    level = _gl_words_device(torch, 43, (2 * n, 4))
    level[0] = gd.to_i64(P - 1)
    pairs = level.reshape(n, 2, 4)
    got = pgc.gl_compress(pairs[:, 0], pairs[:, 1])
    want, plain = once_ms(torch, lambda: gd.gl_compress_plain(
        pairs[:, 0], pairs[:, 1]))
    err = compare(f"gl compress {n}", got, want)
    run = lambda: pgc.gl_compress(pairs[:, 0], pairs[:, 1])  # noqa: E731
    ms, ms_src = profiled_ms(torch, run, 20, "gl_compress_kernel")
    wall = cuda_ms(torch, run, 20)
    b = gl_compress_bound(card, n)
    sh = share("gl compress", b[0], ms)
    records["gl_compress"] = _gl_record(
        "gl_compress", "plonky3_tpu/gl/merkle.py:125", err, ms, ms_src,
        wall, plain, b, sh, [n, 4])
    emit({"phase": "kernels", "kernel": "gl_compress", "n": n,
          "max_abs_err": err, "ms": ms, "ms_source": ms_src,
          "wall_ms": wall, "plain_ms": plain, "bound_ms": b[0],
          "bound_by": b[1], "share": sh})

    n = GRIND_BATCH_CUDA
    states = _gl_words_device(torch, 44, (n, 8))
    states[0] = gd.to_i64(P - 1)
    states[1] = 0
    got = pgc.gl_permute(states)
    want, plain = once_ms(torch,
                          lambda: gd.poseidon2_goldilocks_plain(states))
    err = compare(f"gl permute {n}", got, want)
    run = lambda: pgc.gl_permute(states)  # noqa: E731
    ms, ms_src = profiled_ms(torch, run, 20, "gl_permute_kernel")
    wall = cuda_ms(torch, run, 20)
    b = gl_permute_bound(card, n)
    sh = share("gl permute", b[0], ms)
    records["gl_permute"] = _gl_record(
        "gl_permute", "plonky3_tpu/gl/stark.py:62", err, ms, ms_src, wall,
        plain, b, sh, [n, 8])
    emit({"phase": "kernels", "kernel": "gl_permute", "n": n,
          "max_abs_err": err, "ms": ms, "ms_source": ms_src,
          "wall_ms": wall, "plain_ms": plain, "bound_ms": b[0],
          "bound_by": b[1], "share": sh})


def phase_mixed(torch, np, kernels):
    """A commit of mixed-height matrices on CUDA equals the CPU's: the
    injection levels run keccak_compress, the levels between them the
    ladder. Returns the launch counts of the CUDA commit."""
    from plonky3_tpu_torch.fields import KoalaBear as F
    from plonky3_tpu_torch.hashes.keccak_sponge import (
        KeccakCompressor, KeccakFieldSponge)
    from plonky3_tpu_torch.merkle.mmcs import MerkleTreeMmcs

    rng = np.random.default_rng(40)
    mats = [F.rand_np(rng, s).astype(np.int64)
            for s in [(32, 3), (32, 4), (8, 7), (2, 1)]]
    mmcs = MerkleTreeMmcs(KeccakFieldSponge(F), KeccakCompressor())
    kernels.reset_launches()
    got = mmcs.commit([torch.from_numpy(m).cuda() for m in mats])
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    want = mmcs.commit([torch.from_numpy(m) for m in mats])
    if (got.commitment != want.commitment or len(got.layers)
            != len(want.layers) or not all(
                torch.equal(g.cpu(), w)
                for g, w in zip(got.layers, want.layers))):
        raise AssertionError("the mixed-height commit on CUDA differs "
                             "from the CPU's")
    for k in ("keccak_sponge", "keccak_compress", "keccak_ladder"):
        if launches[k] == 0:
            raise AssertionError(f"mixed-height commit: {k} not launched")
    emit({"phase": "mixed", "shapes": [list(m.shape) for m in mats],
          "cuda_equals_cpu": True, "launches": launches})
    return launches


def as_plain(x):
    """Nested tuples of ints of a proof object (classes dropped)."""
    if hasattr(x, "__dict__"):
        return tuple((k, as_plain(v)) for k, v in vars(x).items())
    if isinstance(x, (list, tuple)):
        if all(type(v) is int for v in x):  # the common leaf, at C speed
            return tuple(x)
        return tuple(as_plain(v) for v in x)
    return x


def _workload(np, log_n, params, device, merkle="keccak"):
    from plonky3_tpu_torch.compat import trace_inputs_from_numpy
    from plonky3_tpu_torch.fields import KoalaBear as F
    from plonky3_tpu_torch.fields import KoalaBearExt4 as E
    from plonky3_tpu_torch.models.poseidon2_air import (
        Poseidon2VectorAir, generate_vectorized_trace)
    from plonky3_tpu_torch.stark import config as stark_config

    air = Poseidon2VectorAir(F, 16, vector_len=8)
    rng = np.random.default_rng(1)
    inputs = trace_inputs_from_numpy(F.rand_np(rng, (8 << log_n, 16)),
                                     device)
    trace, _ = generate_vectorized_trace(air, inputs, device=device)
    make = getattr(stark_config, f"{merkle}_stark_config")
    return make(F, E, params, device=device), air, trace


def side_small(np, torch, dev, case):
    """phase_small's proofs on `dev`: "pow8", prove() and the device-
    transcript prover; "pow0", prove() and prove_fast without a query
    proof of work. On the CPU each verified (VERIFY_ONCE)."""
    import dataclasses

    from plonky3_tpu_torch.fri.config import FriParameters
    from plonky3_tpu_torch.stark.fast_prover import _prove_device_fs
    from plonky3_tpu_torch.stark.fast_prover import prove_fast
    from plonky3_tpu_torch.stark.prover import prove
    from plonky3_tpu_torch.stark.verifier import verify

    params = FriParameters(**SMALL_PARAMS)
    fns = (("prove", prove), ("fast", _prove_device_fs))
    if case == "pow0":
        params = dataclasses.replace(params, query_proof_of_work_bits=0)
        fns = (("prove", prove), ("prove_fast", prove_fast))
    config, air, trace = _workload(np, 8, params, dev)
    plain, secs = {}, {}
    for name, fn in fns:
        t0 = time.perf_counter()
        proof = fn(config, air, trace, [])
        sync(torch, dev)
        secs[f"{case}_{name}_{dev}_s"] = time.perf_counter() - t0
        if dev == "cpu":  # see VERIFY_ONCE
            t0 = time.perf_counter()
            verify(config, air, proof, [])  # raises on a rejection
            secs[f"{case}_{name}_{dev}_verify_s"] = time.perf_counter() - t0
        plain[name] = as_plain(proof)
    return {"plain": plain, "secs": secs, "width": air.width}


def phase_small(torch, np):
    """prove() and the device-transcript prover on the card equal both on
    the CPU at full width; so does prove_fast without a query proof of
    work (grind(0) on the device path: on the card prove_fast raises
    rather than fall back to prove())."""
    secs, verified = {}, 0
    for case in ("pow8", "pow0"):
        cuda = side_small(np, torch, "cuda", case)
        cpu, cpu_secs, _ = cpu_side("side_small", case)
        secs.update(cuda["secs"], **cpu_secs)
        got = list(cuda["plain"].values()) + list(cpu.values())
        if len(set(got)) != 1:
            raise AssertionError(f"the small {case} proofs differ")
        verified += len(cpu)
    emit({"phase": "small", "log_n": 8, "width": cuda["width"],
          "cuda_equals_cpu": True, "fast_equals_prove": True,
          "no_query_pow_equals_prove": True, "verified": verified, **secs})


def _air_workload(np, name, device, log_n=None, perms=None, F=None):
    """(air, trace, public values) of FibonacciAir at 2^log_n rows, of
    Blake3Air or Sha256Air over 2^log_n compressions or of KeccakAir over
    `perms` permutations, the inputs from np.random.default_rng(1) as the
    reference CLI makes them (plonky3_tpu/cli.py:125-156; Sha256Air's as
    Blake3Air's: 16 block words and 8 state words a row); over F, default
    KoalaBear."""
    from plonky3_tpu_torch.fields import KoalaBear
    from plonky3_tpu_torch.models import (blake3_air, fibonacci, keccak_air,
                                          sha256_air)

    F = F or KoalaBear
    if name == "fibonacci":
        trace, publics = fibonacci.generate_fibonacci_trace(F, log_n,
                                                            device=device)
        return fibonacci.FibonacciAir(F), trace, publics
    if name == "blake3":
        inputs = np.random.default_rng(1).integers(
            0, 1 << 32, size=(1 << log_n, 24),
            dtype=np.uint64).astype(np.uint32)
        return (blake3_air.Blake3Air(F),
                blake3_air.generate_blake3_trace(F, inputs, device=device),
                [])
    if name == "sha256":
        inputs = np.random.default_rng(1).integers(
            0, 1 << 32, size=(1 << log_n, 24),
            dtype=np.uint64).astype(np.uint32)
        return (sha256_air.Sha256Air(F),
                sha256_air.generate_sha256_trace(F, inputs, device=device),
                [])
    inputs = np.random.default_rng(1).integers(0, 1 << 64, size=(perms, 25),
                                               dtype=np.uint64)
    return (keccak_air.KeccakAir(F),
            keccak_air.generate_keccak_trace(F, inputs, device=device), [])


def side_keccak_air_small(np, torch, dev, name):
    """phase_keccak_air_small's proofs of `name` on `dev`; on the CPU each
    verified (VERIFY_ONCE)."""
    from plonky3_tpu_torch.fields import KoalaBear as F
    from plonky3_tpu_torch.fields import KoalaBearExt4 as E
    from plonky3_tpu_torch.fri.config import FriParameters
    from plonky3_tpu_torch.stark.config import keccak_stark_config
    from plonky3_tpu_torch.stark.fast_prover import _prove_device_fs
    from plonky3_tpu_torch.stark.prover import prove
    from plonky3_tpu_torch.stark.verifier import verify

    kw = {"fibonacci": {"log_n": 8}, "keccak": {"perms": 10}}[name]
    air, trace, publics = _air_workload(np, name, dev, **kw)
    config = keccak_stark_config(F, E, FriParameters(**SMALL_PARAMS),
                                 device=dev)
    plain, secs = {}, {}
    for fn_name, fn in (("prove", prove), ("fast", _prove_device_fs)):
        t0 = time.perf_counter()
        proof = fn(config, air, trace, publics)
        sync(torch, dev)
        secs[f"{name}_{fn_name}_{dev}_s"] = time.perf_counter() - t0
        if dev == "cpu":  # see VERIFY_ONCE
            verify(config, air, proof, publics)  # raises on a rejection
        plain[fn_name] = as_plain(proof)
    return {"plain": plain, "secs": secs, "config": config, "air": air,
            "rows": trace.shape[0], "publics": publics, "proof": proof}


def phase_keccak_air_small(torch, np):
    """The generic AIR path at small sizes: FibonacciAir (public values,
    every filter) at 2^8 rows and KeccakAir with 10 permutations (256
    rows). prove() and the device-transcript prover on the card equal both
    on the CPU (plain versions); the port's verifier accepts every proof,
    and rejects a changed public value (Fibonacci) and a changed
    trace_next[0] (KeccakAir) with the class the tests pin."""
    from plonky3_tpu_torch.fields import KoalaBear as F
    from plonky3_tpu_torch.fields import KoalaBearExt4 as E
    from plonky3_tpu_torch.stark.verifier import (InvalidOpeningArgument,
                                                  verify)

    secs, out = {}, {}
    for name in ("fibonacci", "keccak"):
        cuda = side_keccak_air_small(np, torch, "cuda", name)
        cpu, cpu_secs, _ = cpu_side("side_keccak_air_small", name)
        secs.update(cuda["secs"], **cpu_secs)
        got = list(cuda["plain"].values()) + list(cpu.values())
        if len(set(got)) != 1:
            raise AssertionError(f"the small {name} proofs differ")
        config, air, proof = cuda["config"], cuda["air"], cuda["proof"]
        publics = cuda["publics"]
        if name == "fibonacci":
            probe = "public_value"
            bad_publics = publics[:-1] + [(publics[-1] + 1) % F.P]
            bad = proof
        else:
            probe, bad_publics = "trace_next", publics
            bad = copy.deepcopy(proof)
            _bump_trace_next(bad, E)
        try:
            verify(config, air, bad, bad_publics)
        except InvalidOpeningArgument as e:
            out[name] = {"rows": cuda["rows"], "width": air.width,
                         "publics": len(publics), "verified": len(cpu),
                         "probe": probe, "raised": type(e).__name__,
                         "message": str(e)}
        else:
            raise AssertionError(f"verify accepted the {name} probe {probe}")
    emit({"phase": "keccak_air_small", "cuda_equals_cpu": True,
          "fast_equals_prove": True, **out, **secs})


SMALL_PARAMS = dict(log_blowup=1, log_final_poly_len=0, max_log_arity=3,
                    num_queries=10, commit_proof_of_work_bits=0,
                    query_proof_of_work_bits=8)


def _pair_case(np, torch, case, dev):
    """(air, trace, public values, config) of one CUDA == CPU case of the
    small phases at 2^8 rows, SMALL_PARAMS, on `dev`: Blake3Air,
    PeriodicAir and NoNextRowAir, the JoinedAir of two FibonacciAirs
    (KoalaBear keccak config), the CLI's BabyBear Poseidon2VectorAir,
    Sha256Air and Poseidon1VectorAir under the named config."""
    from plonky3_tpu_torch import cli
    from plonky3_tpu_torch.air.composition import JoinedAir, NamedAir
    from plonky3_tpu_torch.fields import BabyBear, BabyBearExt4
    from plonky3_tpu_torch.fields import KoalaBear as F
    from plonky3_tpu_torch.fields import KoalaBearExt4 as E
    from plonky3_tpu_torch.fri.config import FriParameters
    from plonky3_tpu_torch.models.fibonacci import (
        FibonacciAir, generate_fibonacci_trace)
    from plonky3_tpu_torch.stark import config as stark_config

    log_n, params = 8, FriParameters(**SMALL_PARAMS)
    kind, _, merkle = case.partition("_")
    make = getattr(stark_config, f"{merkle or 'keccak'}_stark_config", None)
    publics = []
    if case == "blake3":
        air, trace = _air_workload(np, "blake3", dev, log_n=log_n)[:2]
    elif case in ("PeriodicAir", "NoNextRowAir"):
        n = 1 << log_n
        rows = np.array([[PATTERN[i % 4], PATTERN[i % 4] * MASK[i % 2]]
                         for i in range(n)], dtype=np.uint32)
        cls = {c.__name__: c for c in _periodic_airs()}[case]
        air = cls(F)
        trace = torch.from_numpy(F.to_monty_np(rows).astype(
            np.int64)).to(dev)
    elif case == "joined":
        t1, publics_a = generate_fibonacci_trace(F, log_n, device=dev)
        t2, publics_b = generate_fibonacci_trace(F, log_n, a=2, b=3,
                                                 device=dev)
        air = JoinedAir(NamedAir("fib_a", FibonacciAir(F)),
                        NamedAir("fib_b", FibonacciAir(F)))
        trace, publics = torch.cat([t1, t2], dim=1), publics_a + publics_b
    elif kind == "babybear":
        job = cli.build("baby-bear", "poseidon-2-permutations", log_n, 3,
                        "testing", merkle, dev)
        air, trace = job.air, job.trace
        make = getattr(stark_config, {"keccak-f": "keccak"}.get(
            merkle, merkle) + "_stark_config")
        return air, trace, publics, make(BabyBear, BabyBearExt4, params,
                                         device=dev)
    elif kind == "sha256":
        air, trace = _air_workload(np, "sha256", dev, log_n=log_n)[:2]
    else:
        air, trace = _poseidon1_workload(np, log_n, dev)
    return air, trace, publics, make(F, E, params, device=dev)


def side_pair(np, torch, dev, case):
    """Both provers on `dev` for `_pair_case(case)`, on the CPU each proof
    verified (VERIFY_ONCE): the proofs, seconds, and the fold blocks of
    the fast prove."""
    from plonky3_tpu_torch.stark import prover as stark_prover
    from plonky3_tpu_torch.stark.fast_prover import _prove_device_fs
    from plonky3_tpu_torch.stark.verifier import verify

    air, trace, publics, config = _pair_case(np, torch, case, dev)
    plain, secs = {}, {}
    for fn_name, fn in (("prove", stark_prover.prove),
                        ("fast", _prove_device_fs)):
        before = stark_prover.FOLD_BLOCKS["count"]
        t0 = time.perf_counter()
        proof = fn(config, air, trace, publics)
        sync(torch, dev)
        secs[f"{case}_{fn_name}_{dev}_s"] = time.perf_counter() - t0
        blocks = stark_prover.FOLD_BLOCKS["count"] - before
        if dev == "cpu":  # see VERIFY_ONCE
            verify(config, air, proof, publics)  # raises on a rejection
        plain[fn_name] = as_plain(proof)
    return {"plain": plain, "secs": secs, "air": air, "config": config,
            "proof": proof, "blocks": blocks}


def _cuda_equals_cpu(torch, np, case, secs):
    """Both provers on CUDA (`side_pair`) and on the CPU (plain versions,
    in a CPU worker, each proof verified); all four must be equal.
    Returns (air, config, the CUDA fast proof, the blocks the CUDA fast
    prove's quotient folded)."""
    cuda = side_pair(np, torch, "cuda", case)
    cpu, cpu_secs, _ = cpu_side("side_pair", case)
    secs.update(cuda["secs"], **cpu_secs)
    if len(set(cuda["plain"].values()) | set(cpu.values())) != 1:
        raise AssertionError(f"the small {case} proofs differ")
    return cuda["air"], cuda["config"], cuda["proof"], cuda["blocks"]


def phase_blake3_air_small(torch, np):
    """Blake3Air (9,168 columns) at 2^8 rows: both provers on the card
    equal both on the CPU, every proof verified, and a changed
    trace_next[0] rejected with InvalidOpeningArgument."""
    from plonky3_tpu_torch.fields import KoalaBearExt4 as E
    from plonky3_tpu_torch.stark.verifier import (InvalidOpeningArgument,
                                                  verify)

    log_n, secs = 8, {}
    air, config, proof, blocks = _cuda_equals_cpu(torch, np, "blake3",
                                                  secs)
    bad = copy.deepcopy(proof)
    _bump_trace_next(bad, E)
    try:
        verify(config, air, bad, [])
    except InvalidOpeningArgument as e:
        raised = {"raised": type(e).__name__, "message": str(e)}
    else:
        raise AssertionError("verify accepted the blake3 probe trace_next")
    emit({"phase": "blake3_air_small", "rows": 1 << log_n,
          "width": air.width, "cuda_equals_cpu": True,
          "fast_equals_prove": True, "verified": 2, "fold_blocks": blocks,
          "probe": "trace_next", **raised, **secs})


# one period of each periodic column of the periodic AIRs (the model of
# tests/test_periodic.py and uni-stark/tests/periodic_air.rs)
PATTERN = (1, 7, 3, 9)
MASK = (5, 11)


def _periodic_airs():
    """(PeriodicAir, NoNextRowAir): col0 equals the period-4 pattern and
    col1 = col0 · mask (period 2); the second declares that it reads no
    next row, so its quotient folds in the committed bit-reversed order
    and its trace opens at zeta alone."""
    from plonky3_tpu_torch.air.api import BaseAir

    class PeriodicAir(BaseAir):
        width = 2
        num_public_values = 0

        def __init__(self, field):
            self.field = field

        def periodic_columns(self):
            return [list(PATTERN), list(MASK)]

        def eval(self, b):
            local = b.main.local
            b.assert_zero(local[0] - b.periodic[0])
            b.assert_zero(local[1] - local[0] * b.periodic[1])

    class NoNextRowAir(PeriodicAir):
        def main_next_row_columns(self):
            return []

    return PeriodicAir, NoNextRowAir


def phase_periodic(torch, np):
    """Periodic columns on the card at 2^8 rows: PeriodicAir and
    NoNextRowAir (the bit-reversed fold), both provers on CUDA equal to
    both on the CPU, every proof verified; the no-next-row proof opens
    no next row."""
    secs, out = {}, {}
    for name in ("PeriodicAir", "NoNextRowAir"):
        _, _, proof, blocks = _cuda_equals_cpu(torch, np, name, secs)
        opens_next = proof.opened_values.trace_next is not None
        if opens_next != (name == "PeriodicAir"):
            raise AssertionError(f"{name}: opens the next row "
                                 f"{opens_next}")
        out[name] = {"opens_next_row": opens_next, "fold_blocks": blocks}
    emit({"phase": "periodic", "rows": 256, "cuda_equals_cpu": True,
          "fast_equals_prove": True, "verified": 4, **out, **secs})


# the kernels the main path must launch
MAIN_PATH = ("ntt_k1", "ntt_k2", "keccak_sponge", "keccak_ladder")


def phase_full(torch, np, kernels, card):
    """The benchmark workload; returns the timed prove's launch counts,
    the per-proof bounds and the profiled device time by kernel. A third
    prove collects per-stage spans and records every launch's shape; a
    fourth runs under torch.profiler."""
    from plonky3_tpu_torch.fri.config import FriParameters
    from plonky3_tpu_torch.stark.prover import prove

    log_n = 17
    params = FriParameters.new_benchmark_high_arity()
    t0 = time.perf_counter()
    config, air, trace = _workload(np, log_n, params, "cuda")
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    first = prove(config, air, trace, [])
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    kernels.reset_launches()
    t0 = time.perf_counter()
    proof = prove(config, air, trace, [])
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    missing = [k for k in MAIN_PATH if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched by prove: {missing}")
    if as_plain(first) != as_plain(proof):
        raise AssertionError("two proves of the same trace differ")
    check_shape(proof, air, params, log_n)
    n_perms = 8 << log_n
    emit({"phase": "full", "log_n": log_n, "rows": 1 << log_n,
          "width": air.width, "perms": n_perms, "trace_gen_s": gen_s,
          "cold_prove_s": cold_s, "warm_prove_s": warm_s,
          "perms_per_s": n_perms / warm_s,
          "peak_mem_bytes": torch.cuda.max_memory_allocated(),
          "launches": launches})
    spans = {}
    _, calls = recorded(torch, kernels, lambda: prove(config, air, trace,
                                                      [], spans=spans))
    emit({"phase": "spans", "seconds": spans})
    per_proof = launch_bounds(card, calls)
    emit({"phase": "per_proof", "kernels": per_proof})
    device_ms = profile_prove(torch, kernels, prove, config, air, trace,
                              warm_s)
    return dict(launches=launches, per_proof=per_proof, device_ms=device_ms,
                proof=proof, workload=(config, air, trace))


def check_shape(proof, air, params, log_n):
    ov = proof.opened_values
    if (proof.degree_bits != log_n or len(ov.trace_local) != air.width
            or len(ov.trace_next) != air.width
            or len(ov.quotient_chunks) != 2
            or len(proof.opening_proof.commit_phase_steps[0].sibling_values)
            != params.num_queries):
        raise AssertionError("the full-size proof has the wrong shape")


# the transcript kernels the device-transcript prover adds to MAIN_PATH
FAST_PATH = MAIN_PATH + ("keccak256_chain", "keccak_grind")


def timer(torch, config, air, trace):
    """timed(prove_fn, **kw) -> (proof, wall seconds to the device's end)."""
    def timed(fn, **kw):
        t0 = time.perf_counter()
        proof = fn(config, air, trace, [], **kw)
        torch.cuda.synchronize()
        return proof, time.perf_counter() - t0

    return timed


def warm_turns(timed, prove, fast,
               order=("prove", "fast", "fast", "prove", "prove", "fast")):
    """Warm times of both provers in turns, on the same card."""
    turns = {"prove": [], "fast": []}
    for name in order:
        turns[name].append(timed(prove if name == "prove" else fast)[1])
    return turns


def sync_calls(torch, fn):
    """The synchronizing calls of fn() by message, as
    torch.cuda.set_sync_debug_mode("warn") reports them."""
    import warnings

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
            torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return collections.Counter(
        str(w.message).splitlines()[0][:80] for w in caught
        if "synchroniz" in str(w.message))


def phase_fast(torch, np, kernels, card, full):
    """The main path: the full phase's workload through the device-
    transcript prover (`_prove_device_fs`, what prove_fast runs; on the
    card prove_fast raises rather than fall back). Returns its launches,
    per-proof bounds and profiled device time by kernel."""
    from plonky3_tpu_torch.stark import fast_prover as fp
    from plonky3_tpu_torch.stark.prover import prove

    config, air, trace = full["workload"]
    params = config.pcs.fri
    log_n = trace.shape[0].bit_length() - 1

    timed = timer(torch, config, air, trace)
    torch.cuda.reset_peak_memory_stats()
    first, cold_s = timed(fp._prove_device_fs)
    kernels.reset_launches()
    pulls = fp.PULLS["count"]
    proof, warm_s = timed(fp._prove_device_fs)
    launches = dict(kernels.LAUNCHES)
    pulls = fp.PULLS["count"] - pulls
    peak_mem = torch.cuda.max_memory_allocated()
    missing = [k for k in FAST_PATH if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched by the fast prover: "
                             f"{missing}")
    grinds = 1 + (params.commit_proof_of_work_bits > 0) * len(
        proof.opening_proof.commit_phase_commits)
    if launches["keccak_grind"] != grinds:
        raise AssertionError(f"{launches['keccak_grind']} grinds, "
                             f"expected {grinds}")
    if pulls > 2:
        raise AssertionError(f"{pulls} device-to-host copies in one proof")
    if as_plain(proof) != as_plain(full["proof"]):
        raise AssertionError("the fast proof differs from prove()'s")
    if as_plain(first) != as_plain(proof):
        raise AssertionError("two fast proves of the same trace differ")
    check_shape(proof, air, params, log_n)
    turns = warm_turns(timed, prove, fp._prove_device_fs)
    n_perms = 8 << log_n
    fast_s = statistics.median(turns["fast"])
    emit({"phase": "fast", "log_n": log_n, "perms": n_perms,
          "cold_prove_s": cold_s, "warm_prove_s": warm_s,
          "perms_per_s": n_perms / warm_s, "peak_mem_bytes": peak_mem,
          "pulls": pulls, "launches": launches,
          "warm_fast_s_turns": turns["fast"],
          "warm_prove_s_turns": turns["prove"],
          "fast_median_s": fast_s,
          "prove_median_s": statistics.median(turns["prove"]),
          "equals_prove": True})
    phase_verify(config, air, proof, log_n)
    spans = {}
    traced, calls = recorded(torch, kernels, lambda: fp._prove_device_fs(
        config, air, trace, [], spans=spans))
    emit({"phase": "fast_spans", "seconds": spans})
    fri = traced.opening_proof
    witnesses = ([w for w in fri.commit_pow_witnesses]
                 if params.commit_proof_of_work_bits else [])
    per_proof = launch_bounds(card, calls,
                              witnesses + [fri.query_pow_witness])
    emit({"phase": "fast_per_proof", "kernels": per_proof})
    syncs = sync_calls(torch, lambda: fp._prove_device_fs(config, air,
                                                          trace, []))
    emit({"phase": "fast_syncs", "synchronizing_calls": sum(syncs.values()),
          "by_message": dict(syncs)})
    device_ms = profile_prove(torch, kernels, fp._prove_device_fs, config,
                              air, trace, fast_s)
    # the chain's device time call by call, beside each call's size
    emit({"phase": "fast_chain_calls",
          "calls": [{"n": a[2], "k": a[3], "keccak_f": a[2] // 34 + a[3],
                     "us": ms * 1e3,
                     "bound_us": chain_bound(card, a[2], a[3])[0] * 1e3}
                    for fn, a, ms in calls if fn == "keccak256_chain"]})
    return dict(launches=launches, per_proof=per_proof, device_ms=device_ms)


# the kernels the Poseidon2 path must launch, and those it must not
POSEIDON2_PATH = ("ntt_k1", "ntt_k2", "poseidon2_duplex_chain",
                  "poseidon2_grind")
KECCAK_KERNELS = ("keccak_sponge", "keccak_compress", "keccak_ladder",
                  "keccak256_chain", "keccak_grind")


def device_fs_phase(torch, kernels, card, phase, workload, path, stray,
                    turns_order, probes, info):
    """A full-size workload through the device-transcript prover
    (`_prove_device_fs`, what prove_fast runs): cold and warm, its
    launches (every kernel of `path`, none of `stray`, one grind, the
    last of `path`), one device-to-host copy, peak memory, its proof equal
    to prove()'s, warm times of both in turns (`turns_order`; with none,
    the warm fast prove and prove()'s first call are the only times); then the
    port's verifier on the proof with `probes`, spans, per-proof bounds
    and the profile, each line named after `phase` (the synchronizing
    calls are counted on the main path only, phase `fast`, for the
    script's time).
    Returns its launches, per-proof bounds, profiled device time by
    kernel and the recorded launches of one prove."""
    from plonky3_tpu_torch.stark import fast_prover as fp
    from plonky3_tpu_torch.stark.prover import FOLD_BLOCKS, prove

    config, air, trace = workload
    params = config.pcs.fri
    log_n = trace.shape[0].bit_length() - 1
    timed = timer(torch, config, air, trace)
    torch.cuda.reset_peak_memory_stats()
    first, cold_s = timed(fp._prove_device_fs)
    kernels.reset_launches()
    pulls, blocks = fp.PULLS["count"], FOLD_BLOCKS["count"]
    proof, warm_s = timed(fp._prove_device_fs)
    launches = dict(kernels.LAUNCHES)
    pulls = fp.PULLS["count"] - pulls
    blocks = FOLD_BLOCKS["count"] - blocks
    peak_mem = torch.cuda.max_memory_allocated()
    missing = [k for k in path if launches[k] == 0]
    launched = [k for k in stray if launches[k]]
    if missing or launched:
        raise AssertionError(f"{phase} fast prove: not launched {missing}, "
                             f"launched {launched}")
    grind = path[-1]
    grinds = 1 + (params.commit_proof_of_work_bits > 0) * len(
        proof.opening_proof.commit_phase_commits)
    if launches[grind] != grinds:
        raise AssertionError(f"{launches[grind]} grinds, expected {grinds}")
    if pulls != 1:
        raise AssertionError(f"{pulls} device-to-host copies in one proof")
    ref, prove_cold_s = timed(prove)
    if as_plain(proof) != as_plain(ref):
        raise AssertionError(f"the {phase} fast proof differs from "
                             f"prove()'s")
    if as_plain(first) != as_plain(proof):
        raise AssertionError(f"two {phase} fast proves differ")
    check_shape(proof, air, params, log_n)
    # no turns: the warm fast prove is the fast time, and prove() has
    # only its first call (cold_host_transcript_prove_s)
    turns = warm_turns(timed, prove, fp._prove_device_fs, turns_order)
    fast_s = statistics.median(turns["fast"] or [warm_s])
    emit({"phase": phase, "log_n": log_n, **info,
          "cold_prove_s": cold_s, "warm_prove_s": warm_s,
          "cold_host_transcript_prove_s": prove_cold_s,
          "perms_per_s": info["perms"] / fast_s, "peak_mem_bytes": peak_mem,
          "fold_blocks": blocks,
          "fold_block_rows": FOLD_BLOCKS["rows"] if blocks else None,
          "pulls": pulls, "launches": launches,
          "warm_fast_s_turns": turns["fast"],
          "warm_prove_s_turns": turns["prove"], "fast_median_s": fast_s,
          "prove_median_s": (statistics.median(turns["prove"])
                             if turns["prove"] else None),
          "proof_bytes": proof.size_in_bytes(), "equals_prove": True})
    phase_verify(config, air, proof, log_n, phase=f"{phase}_verify",
                 probes=probes)
    spans = {}
    traced, calls = recorded(torch, kernels, lambda: fp._prove_device_fs(
        config, air, trace, [], spans=spans))
    emit({"phase": f"{phase}_spans", "seconds": spans})
    fri = traced.opening_proof
    witnesses = (list(fri.commit_pow_witnesses)
                 if params.commit_proof_of_work_bits else [])
    per_proof = launch_bounds(card, calls,
                              witnesses + [fri.query_pow_witness])
    emit({"phase": f"{phase}_per_proof", "kernels": per_proof})
    device_ms = profile_prove(torch, kernels, fp._prove_device_fs, config,
                              air, trace, fast_s, phase=f"{phase}_profile")
    return dict(launches=launches, per_proof=per_proof, device_ms=device_ms,
                calls=calls, proof_bytes=proof.size_in_bytes(), proof=proof)


def phase_poseidon2(torch, np, kernels, card):
    """The benchmark workload under poseidon2_stark_config through
    `device_fs_phase` (probes: a changed opened trace value, trace root
    and commit-phase sibling digest; no warm turns beside the warm fast
    prove and prove()'s one call, for the script's time), then the duplex
    chain call by call and the plain-torch hashing of the trace tree.
    Returns its launches, per-proof bounds and profiled device time by
    kernel."""
    from plonky3_tpu_torch.fields import KoalaBear as F
    from plonky3_tpu_torch.fri.config import FriParameters
    from plonky3_tpu_torch.merkle.mmcs import levels_by_compress

    log_n = 17
    params = FriParameters.new_benchmark_high_arity()
    config, air, trace = _workload(np, log_n, params, "cuda", "poseidon2")
    out = device_fs_phase(
        torch, kernels, card, "poseidon2", (config, air, trace),
        POSEIDON2_PATH, KECCAK_KERNELS, (),
        ("trace_local", "trace_root", "commit_phase_sibling_digest"),
        {"perms": 8 << log_n})
    calls = out.pop("calls")
    chains = [(a[2], ms) for fn, a, ms in calls
              if fn == "poseidon2_duplex_chain"]
    longest = max(n for n, _ in chains)
    if longest != P2_ALPHA2_WORDS:
        raise AssertionError(f"the longest duplex absorb took {longest} "
                             f"words, the kernels phase {P2_ALPHA2_WORDS}")
    emit({"phase": "poseidon2_chain_calls", "longest_words": longest,
          "calls": [{"n": n, "blocks": max(1, -(-n // 16)), "us": ms * 1e3,
                     "bound_us": p2_chain_bound(card, n)[0] * 1e3}
                    for n, ms in chains],
          "grind_us": [ms * 1e3 for fn, _, ms in calls
                       if fn == "poseidon2_grind"]})
    # the plain-torch hashing of the trace tree alone, once each: the leaf
    # sponge over the LDE's shape and the compression levels above it
    mmcs = config.pcs.mmcs
    rows = _rand_words(torch, np.random.default_rng(7),
                       (2 << log_n, air.width), F.P).to(torch.int64)
    leaves, sponge_ms = once_ms(
        torch, lambda: mmcs.sponge.hash_rows_device([rows]))
    levels, ladder_ms = once_ms(
        torch, lambda: levels_by_compress(mmcs.compressor, leaves))
    emit({"phase": "poseidon2_hashing", "rows": rows.shape[0],
          "width": rows.shape[1], "sponge_ms": sponge_ms,
          "sponge_permutations": -(-air.width // 16),
          "ladder_ms": ladder_ms, "compression_levels": len(levels) - 1})
    return out


def phase_keccak_air(torch, np, kernels, card):
    """The keccak-f-permutations objective of the reference CLI at full
    width: 5,461 permutations, a 2^17 x 2,633 KeccakAir trace (generated
    once), keccak_stark_config, new_benchmark_high_arity(), through
    `device_fs_phase` (probes: a changed opened trace value, commit-phase
    sibling digest and next-row value; no warm turns, for the script's
    time),
    then the transcript chain call by call. Returns its launches,
    per-proof bounds and profiled device time by kernel."""
    from plonky3_tpu_torch.fields import KoalaBear as F
    from plonky3_tpu_torch.fields import KoalaBearExt4 as E
    from plonky3_tpu_torch.fri.config import FriParameters
    from plonky3_tpu_torch.models.keccak_air import NUM_KECCAK_COLS
    from plonky3_tpu_torch.stark.config import keccak_stark_config

    log_n = 17
    perms = (1 << log_n) // 24
    t0 = time.perf_counter()
    air, trace, _ = _air_workload(np, "keccak", "cuda", perms=perms)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    if air.width != NUM_KECCAK_COLS or trace.shape != (1 << log_n,
                                                       KECCAK_AIR_WIDTH):
        raise AssertionError(f"KeccakAir trace {tuple(trace.shape)}")
    config = keccak_stark_config(
        F, E, FriParameters.new_benchmark_high_arity(), device="cuda")
    out = device_fs_phase(
        torch, kernels, card, "keccak_air", (config, air, trace), FAST_PATH,
        (), (),
        ("trace_local", "commit_phase_sibling_digest", "trace_next"),
        {"rows": 1 << log_n, "width": air.width, "perms": perms,
         "trace_gen_s": gen_s})
    emit({"phase": "keccak_air_chain_calls",
          "calls": [{"n": a[2], "k": a[3], "us": ms * 1e3,
                     "bound_us": chain_bound(card, a[2], a[3])[0] * 1e3}
                    for fn, a, ms in out.pop("calls")
                    if fn == "keccak256_chain"]})
    return out


def phase_blake3_air(torch, np, kernels, card):
    """The blake3-permutations objective of the reference CLI at full
    width (`--objective blake3-permutations --merkle-hash keccak-f
    --prover fast --log-trace-length 17`): 131,072 compressions, a 2^17 x
    9,168 Blake3Air trace (built and moved in row blocks), keccak config,
    new_benchmark_high_arity(), through `device_fs_phase` with the
    generic quotient folded by row blocks straight from the committed
    LDE (probes: a changed opened trace value, commit-phase sibling
    digest and next-row value; no warm turns, for the script's time),
    then the
    transcript chain call by call. Returns its launches, per-proof bounds
    and profiled device time by kernel."""
    from plonky3_tpu_torch.fields import KoalaBear as F
    from plonky3_tpu_torch.fields import KoalaBearExt4 as E
    from plonky3_tpu_torch.fri.config import FriParameters
    from plonky3_tpu_torch.stark.config import keccak_stark_config

    log_n = 17
    t0 = time.perf_counter()
    air, trace, _ = _air_workload(np, "blake3", "cuda", log_n=log_n)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    if air.width != BLAKE3_AIR_WIDTH or trace.shape != (1 << log_n,
                                                        BLAKE3_AIR_WIDTH):
        raise AssertionError(f"Blake3Air trace {tuple(trace.shape)}")
    config = keccak_stark_config(
        F, E, FriParameters.new_benchmark_high_arity(), device="cuda")
    out = device_fs_phase(
        torch, kernels, card, "blake3_air", (config, air, trace), FAST_PATH,
        (), (),
        ("trace_local", "commit_phase_sibling_digest", "trace_next"),
        {"rows": 1 << log_n, "width": air.width, "perms": 1 << log_n,
         "compressions": 1 << log_n, "trace_gen_s": gen_s})
    emit({"phase": "blake3_air_chain_calls",
          "calls": [{"n": a[2], "k": a[3], "us": ms * 1e3,
                     "bound_us": chain_bound(card, a[2], a[3])[0] * 1e3}
                    for fn, a, ms in out.pop("calls")
                    if fn == "keccak256_chain"]})
    return out

# the duplex kernels' names by instantiation, and those of the BabyBear
# Poseidon2 path
P2_KERNELS = ("poseidon2_duplex_chain", "poseidon2_grind",
              "poseidon2_duplex_chain_babybear", "poseidon2_grind_babybear")
BABYBEAR_POSEIDON2_PATH = ("ntt_k1", "ntt_k2",
                           "poseidon2_duplex_chain_babybear",
                           "poseidon2_grind_babybear")
# the CLI's run of the BabyBear path (`phase_cli`)
CLI_ARGS = ("prove", "--field", "baby-bear", "--objective",
            "poseidon-2-permutations", "--log-trace-length", "17",
            "--merkle-hash", "keccak-f", "--prover", "fast")


def phase_babybear_small(torch, np):
    """Poseidon2VectorAir(BabyBear, 16, 8) (2,384 columns, s-box x^7 with
    registers) at 2^8 rows, built by the CLI's `build`, under both
    configs: both provers on the card equal both on the CPU, every proof
    verified."""
    log_n, secs, out = 8, {}, {}
    for merkle in ("keccak-f", "poseidon2"):
        air, _, proof, _ = _cuda_equals_cpu(torch, np, f"babybear_{merkle}",
                                            secs)
        out[merkle] = {"width": air.width, "proof_bytes":
                       proof.size_in_bytes()}
    emit({"phase": "babybear_small", "rows": 1 << log_n,
          "cuda_equals_cpu": True, "fast_equals_prove": True, "verified": 4,
          **out, **secs})


def phase_babybear(torch, np, kernels, card, merkle):
    """The CLI's poseidon-2-permutations objective over BabyBear at full
    size (`cli.build`: 2^20 permutations, a 2^17 x 2,384 trace with s-box
    registers, 2,256 constraints, new_benchmark_high_arity()) under the
    keccak config (phase `babybear`) or the Poseidon2 config
    (`babybear_poseidon2`, the duplex kernels' <21, 7>), through
    `device_fs_phase` (probes: a changed opened trace value, commit-phase
    sibling digest and s-box register value; no warm turns, for the
    script's time), then the transcript chain call by call. Returns
    its launches, per-proof bounds, profiled device time by kernel and
    the proof's size."""
    from plonky3_tpu_torch import cli

    log_n = 17
    phase = "babybear" if merkle == "keccak-f" else "babybear_poseidon2"
    t0 = time.perf_counter()
    job = cli.build("baby-bear", "poseidon-2-permutations", log_n, 3,
                    "benchmark-high-arity", merkle, "cuda")
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    if job.trace.shape != (1 << log_n, BABYBEAR_WIDTH):
        raise AssertionError(f"BabyBear trace {tuple(job.trace.shape)}")
    if merkle == "keccak-f":
        path, stray = FAST_PATH, P2_KERNELS
    else:
        path = BABYBEAR_POSEIDON2_PATH
        stray = KECCAK_KERNELS + P2_KERNELS[:2]
    out = device_fs_phase(
        torch, kernels, card, phase, (job.config, job.air, job.trace), path,
        stray, (),
        ("trace_local", "commit_phase_sibling_digest", "trace_register"),
        {"rows": 1 << log_n, "width": job.air.width,
         "perms": 8 << log_n, "constraints": 282 * 8,
         "trace_gen_s": gen_s, "objective": job.objective})
    calls = out.pop("calls")
    if merkle == "keccak-f":
        emit({"phase": f"{phase}_chain_calls",
              "calls": [{"n": a[2], "k": a[3], "us": ms * 1e3,
                         "bound_us": chain_bound(card, a[2], a[3])[0] * 1e3}
                        for fn, a, ms in calls if fn == "keccak256_chain"]})
        return out
    chains = [(a[2], ms) for fn, a, ms in calls
              if fn == "poseidon2_duplex_chain"]
    longest = max(n for n, _ in chains)
    if longest != P2_ALPHA2_WORDS_BABYBEAR:
        raise AssertionError(f"the longest duplex absorb took {longest} "
                             f"words, the kernels phase "
                             f"{P2_ALPHA2_WORDS_BABYBEAR}")
    emit({"phase": f"{phase}_chain_calls", "longest_words": longest,
          "calls": [{"n": n, "blocks": max(1, -(-n // 16)), "us": ms * 1e3,
                     "bound_us": p2_chain_bound(card, n, BABYBEAR_P2)[0]
                     * 1e3} for n, ms in chains],
          "grind_us": [ms * 1e3 for fn, _, ms in calls
                       if fn == "poseidon2_grind"]})
    return out


def run_cli(torch, args, wanted, phase, info):
    """One run of the port's CLI in its own process, as a user runs it
    (`python -m plonky3_tpu_torch.cli` with `args`, on the card): it
    exits 0 and prints the `wanted` lines, the spans and the soundness
    line. Emits the line `phase` with `info`."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()  # the child process needs the card's memory
    cmd = [sys.executable, "-m", "plonky3_tpu_torch.cli", *args]
    t0 = time.perf_counter()
    run = subprocess.run(cmd, capture_output=True, text=True, timeout=900,
                         cwd=Path(__file__).resolve().parent)
    secs = time.perf_counter() - t0
    lines = run.stdout.splitlines()
    if run.returncode != 0:
        raise AssertionError(f"the CLI exited {run.returncode}:\n"
                             f"{run.stdout[-2000:]}\n{run.stderr[-4000:]}")
    missing = [w for w in wanted if w not in lines]
    spans = [ln for ln in lines if ln.startswith("  ") and " ms" in ln]
    if (missing or not any("prove (total, run 0)" in ln for ln in spans)
            or not any(re.match(r"  soundness: [\d.]+ bits conjectured, "
                                r"[\d.]+ proven$", ln) for ln in lines)):
        raise AssertionError(f"the CLI's report lacks {missing}: {lines}")
    emit({"phase": phase, "argv": cmd[1:], "rc": run.returncode,
          "seconds": secs, **info, "stdout": lines})


def phase_cli(torch, babybear):
    """`run_cli` with CLI_ARGS: the objective line and the `babybear`
    phase's proof size."""
    run_cli(torch, CLI_ARGS, [
        "objective: 1048576 Poseidon2-16 permutations (8/row x 2^17 rows, "
        "width 2384)", f"  proof size: {babybear['proof_bytes']} bytes"],
        "cli", {"proof_bytes": babybear["proof_bytes"]})


def phase_sha256_air_small(torch, np):
    """Sha256Air (7,728 columns) at 2^8 rows under the keccak and the
    Poseidon2 configs: both provers on the card equal both on the CPU,
    every proof verified, and a changed opened trace value rejected."""
    from plonky3_tpu_torch.fields import KoalaBearExt4 as E
    from plonky3_tpu_torch.stark.verifier import (InvalidOpeningArgument,
                                                  OodEvaluationMismatch,
                                                  verify)

    log_n, secs, out = 8, {}, {}
    for merkle in ("keccak", "poseidon2"):
        air, config, proof, blocks = _cuda_equals_cpu(
            torch, np, f"sha256_{merkle}", secs)
        bad = copy.deepcopy(proof)
        _bump_trace_value(bad, E)
        try:
            verify(config, air, bad, [])
        except (OodEvaluationMismatch, InvalidOpeningArgument) as e:
            out[merkle] = {"fold_blocks": blocks,
                           "proof_bytes": proof.size_in_bytes(),
                           "probe": "trace_local",
                           "raised": type(e).__name__, "message": str(e)}
        else:
            raise AssertionError(f"verify accepted the sha256 {merkle} "
                                 f"probe trace_local")
    emit({"phase": "sha256_air_small", "rows": 1 << log_n,
          "width": air.width, "cuda_equals_cpu": True,
          "fast_equals_prove": True, "verified": 4, **out, **secs})


def _poseidon1_workload(np, log_n, device):
    """(air, trace) of Poseidon1VectorAir(KoalaBear, 16, 8) over 8·2^log_n
    permutations, the inputs from np.random.default_rng(1) as the main
    path's (standard form: the reference's trace generator takes them
    so)."""
    from plonky3_tpu_torch.fields import KoalaBear as F
    from plonky3_tpu_torch.models.poseidon1_air import (
        Poseidon1VectorAir, generate_vectorized_trace_p1)

    air = Poseidon1VectorAir(F, 16, vector_len=8)
    inputs = F.rand_np(np.random.default_rng(1), (8 << log_n, 16),
                       monty=False)
    trace, _ = generate_vectorized_trace_p1(air, inputs, device=device)
    return air, trace


def phase_poseidon1_small(torch, np):
    """Poseidon1VectorAir(KoalaBear, 16, 8) (1,312 columns, its own fold)
    at 2^8 rows under the keccak and the Poseidon2 configs: both provers
    on the card equal both on the CPU, every proof verified."""
    log_n, secs, out = 8, {}, {}
    for merkle in ("keccak", "poseidon2"):
        air, _, proof, _ = _cuda_equals_cpu(torch, np, f"poseidon1_{merkle}",
                                            secs)
        out[merkle] = {"width": air.width,
                       "proof_bytes": proof.size_in_bytes()}
    emit({"phase": "poseidon1_small", "rows": 1 << log_n,
          "cuda_equals_cpu": True, "fast_equals_prove": True, "verified": 4,
          **out, **secs})


def phase_m15_small(torch, np):
    """The rest of M15 on the card: a JoinedAir of two named FibonacciAirs
    (2^8 rows) proven on CUDA and on the CPU, equal and verified;
    batch_inv on 2^20 KoalaBear and BabyBear words (zeros included) equal
    to the elementwise inverse on the card, both timed by CUDA events;
    the Ext8 fields' products and inverses on the card equal the CPU's."""
    from plonky3_tpu_torch.fields import (BabyBear, BabyBearExt8, KoalaBear,
                                          KoalaBearExt8)

    secs, out = {}, {}
    air, _, proof, _ = _cuda_equals_cpu(torch, np, "joined", secs)
    out["joined"] = {"width": air.width, "publics": 6, "verified": 2,
                     "proof_bytes": proof.size_in_bytes()}
    rng = np.random.default_rng(15)
    for Fb, E8 in ((KoalaBear, KoalaBearExt8), (BabyBear, BabyBearExt8)):
        a = torch.from_numpy(Fb.rand_np(rng, (1 << 20,)).astype(
            np.int64)).cuda()
        a[::7] = 0
        got, batch_ms = once_ms(torch, lambda: Fb.batch_inv(a))
        want, fermat_ms = once_ms(torch, lambda: Fb.inv(a))
        err = compare(f"{Fb.name} batch_inv", got, want)
        xt = torch.from_numpy(Fb.rand_np(rng, (4096, 8)).astype(np.int64))
        yt = torch.from_numpy(Fb.rand_np(rng, (4096, 8)).astype(np.int64))
        mul_err = compare(f"{Fb.name} Ext8 mul",
                          E8.mul(xt.cuda(), yt.cuda()), E8.mul(xt, yt).cuda())
        inv_err = compare(f"{Fb.name} Ext8 inv", E8.inv(xt.cuda()),
                          E8.inv(xt).cuda())
        out[Fb.name] = {"batch_inv_words": a.shape[0],
                        "zeros": int((a == 0).sum()),
                        "batch_inv_max_abs_err": err,
                        "batch_inv_ms": batch_ms, "fermat_inv_ms": fermat_ms,
                        "ext8_elements": xt.shape[0],
                        "ext8_mul_max_abs_err": mul_err,
                        "ext8_inv_max_abs_err": inv_err}
    emit({"phase": "m15_small", **out, **secs})


def phase_sha256_air(torch, np, kernels, card):
    """Sha256Air at full width: 131,072 compressions, a 2^17 x 7,728
    trace built on the card in row blocks, keccak config,
    new_benchmark_high_arity(), through `device_fs_phase` with the
    generic quotient folded by row blocks gathered from the committed
    LDE (probes: a changed opened trace value, commit-phase sibling digest
    and next-row value; the warm fast prove and one prove(), for the
    script's time), then the transcript chain call by call. Returns its
    launches, per-proof bounds and profiled device time by kernel."""
    import gc

    from plonky3_tpu_torch.fields import KoalaBear as F
    from plonky3_tpu_torch.fields import KoalaBearExt4 as E
    from plonky3_tpu_torch.fri.config import FriParameters
    from plonky3_tpu_torch.stark.config import keccak_stark_config

    gc.collect()
    torch.cuda.empty_cache()  # the trace commit holds most of the card
    log_n = 17
    t0 = time.perf_counter()
    air, trace, _ = _air_workload(np, "sha256", "cuda", log_n=log_n)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    if air.width != SHA256_AIR_WIDTH or trace.shape != (1 << log_n,
                                                        SHA256_AIR_WIDTH):
        raise AssertionError(f"Sha256Air trace {tuple(trace.shape)}")
    config = keccak_stark_config(
        F, E, FriParameters.new_benchmark_high_arity(), device="cuda")
    out = device_fs_phase(
        torch, kernels, card, "sha256_air", (config, air, trace), FAST_PATH,
        P2_KERNELS, (),
        ("trace_local", "commit_phase_sibling_digest", "trace_next"),
        {"rows": 1 << log_n, "width": air.width, "perms": 1 << log_n,
         "compressions": 1 << log_n, "constraints": 8096,
         "trace_gen_s": gen_s})
    emit({"phase": "sha256_air_chain_calls",
          "calls": [{"n": a[2], "k": a[3], "us": ms * 1e3,
                     "bound_us": chain_bound(card, a[2], a[3])[0] * 1e3}
                    for fn, a, ms in out.pop("calls")
                    if fn == "keccak256_chain"]})
    return out


def phase_poseidon1(torch, np, kernels, card, merkle):
    """Poseidon1VectorAir(KoalaBear, 16, 8) at full size: 2^20
    permutations, a 2^17 x 1,312 trace built on the card, 1,184
    constraints folded by the AIR's own fold, new_benchmark_high_arity(),
    under the keccak config (phase `poseidon1`) or the Poseidon2 config
    (`poseidon1_poseidon2`, the duplex kernels' <23, 3>), through
    `device_fs_phase` (the warm fast prove and one prove(); probes: a
    changed opened trace value, a commit-phase sibling digest, and the
    proof against the AIR with one more constraint under the keccak
    config, a changed trace root under the Poseidon2 config). Returns
    its launches, per-proof bounds and profiled device time by kernel."""
    from plonky3_tpu_torch.fields import KoalaBear as F
    from plonky3_tpu_torch.fields import KoalaBearExt4 as E
    from plonky3_tpu_torch.fri.config import FriParameters
    from plonky3_tpu_torch.stark import config as stark_config

    log_n = 17
    phase = "poseidon1" if merkle == "keccak" else "poseidon1_poseidon2"
    t0 = time.perf_counter()
    air, trace = _poseidon1_workload(np, log_n, "cuda")
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    if trace.shape != (1 << log_n, 1312):
        raise AssertionError(f"Poseidon1 trace {tuple(trace.shape)}")
    config = getattr(stark_config, f"{merkle}_stark_config")(
        F, E, FriParameters.new_benchmark_high_arity(), device="cuda")
    if merkle == "keccak":
        path, stray = FAST_PATH, P2_KERNELS
        probes = ("trace_local", "commit_phase_sibling_digest", "other_air")
    else:
        path, stray = POSEIDON2_PATH, KECCAK_KERNELS + P2_KERNELS[2:]
        probes = ("trace_local", "trace_root", "commit_phase_sibling_digest")
    out = device_fs_phase(
        torch, kernels, card, phase, (config, air, trace), path, stray, (),
        probes, {"rows": 1 << log_n, "width": air.width, "perms": 8 << log_n,
                 "constraints": 148 * 8, "trace_gen_s": gen_s})
    calls = out.pop("calls")
    if merkle == "keccak":
        emit({"phase": f"{phase}_chain_calls",
              "calls": [{"n": a[2], "k": a[3], "us": ms * 1e3,
                         "bound_us": chain_bound(card, a[2], a[3])[0] * 1e3}
                        for fn, a, ms in calls if fn == "keccak256_chain"]})
    else:
        emit({"phase": f"{phase}_chain_calls",
              "calls": [{"n": a[2], "blocks": max(1, -(-a[2] // 16)),
                         "us": ms * 1e3,
                         "bound_us": p2_chain_bound(card, a[2])[0] * 1e3}
                        for fn, a, ms in calls
                        if fn == "poseidon2_duplex_chain"]})
    return out


# ---- M16 and the first part of M17: ZK, preprocessed, lookup, batch ----

# The main path's FRI parameters with a blowup of 4 and half the queries
# (116 conjectured bits, as its). KeccakAir under ZK (a trace of degree
# 2n, a quotient of degree up to 6n over 8n rows) and the LogUp
# constraints (degree 4, a quotient domain of 4n) need a quotient domain
# four times the trace's domain, which its LDE must hold
BLOWUP4_PARAMS = dict(log_blowup=2, log_final_poly_len=0, max_log_arity=3,
                      num_queries=50, commit_proof_of_work_bits=0,
                      query_proof_of_work_bits=16)
SMALL_BLOWUP4_PARAMS = {**SMALL_PARAMS, "log_blowup": 2}

# the kernels of the ZK path (Poseidon2 trees in plain torch, the host
# duplex transcript's grind on the card) and what it must not launch
ZK_PATH = ("ntt_k1", "ntt_k2", "poseidon2_grind")
ZK_STRAY = KECCAK_KERNELS + ("poseidon2_duplex_chain",)
# the kernels of the batch proof under the keccak config: the tree
# injects the shorter instances' matrices by `compress_kernel` (the host
# transcript hashes and grinds on the host)
BATCH_PATH = ("ntt_k1", "ntt_k2", "keccak_sponge", "keccak_compress",
              "keccak_ladder")


def _zk_config(params, seed, device):
    from plonky3_tpu_torch.fields import KoalaBear as F
    from plonky3_tpu_torch.fields import KoalaBearExt4 as E
    from plonky3_tpu_torch.stark.config import zk_stark_config

    return zk_stark_config(F, E, params, seed=seed, device=device)


def _bump_random_opening(proof, E):
    ov = proof.opened_values
    ov.random[0] = E.add_h(ov.random[0], E.one_h())


def _bump_salt(proof, E):
    """The last salt word of the trace round's first opened row."""
    row = proof.opening_proof.input_openings[1].opened_values[0][0]
    row[-1] = (row[-1] + 1) % E.base.P


def rejected(what, fn, prefixes):
    """fn() must raise VerificationError with a message that starts with
    one of `prefixes`: {raised, message, s}."""
    from plonky3_tpu_torch.stark.verifier import VerificationError

    t0 = time.perf_counter()
    try:
        fn()
    except VerificationError as e:
        if not str(e).startswith(prefixes):
            raise AssertionError(f"{what}: rejected as {e}") from e
        return {"raised": type(e).__name__, "message": str(e)[:120],
                "s": time.perf_counter() - t0}
    raise AssertionError(f"verify accepted the probe {what}")


def side_zk_small(np, torch, dev, name):
    """phase_zk_small's seed-1 proof of `name` on `dev`, verified on the
    CPU (VERIFY_ONCE)."""
    from plonky3_tpu_torch.fri.config import FriParameters
    from plonky3_tpu_torch.stark.prover import prove
    from plonky3_tpu_torch.stark.verifier import verify

    params = FriParameters(**SMALL_BLOWUP4_PARAMS)
    kw = {"fibonacci": {"log_n": 8}, "keccak": {"perms": 10}}[name]
    air, trace, publics = _air_workload(np, name, dev, **kw)
    t0 = time.perf_counter()
    proof = prove(_zk_config(params, 1, dev), air, trace, publics)
    sync(torch, dev)
    secs = {f"{name}_{dev}_s": time.perf_counter() - t0}
    if dev == "cpu":  # see VERIFY_ONCE
        verify(_zk_config(params, 1, dev), air, proof, publics)
    return {"plain": as_plain(proof), "secs": secs, "proof": proof}


def phase_zk_small(torch, np):
    """zk_stark_config at 2^8 rows (SMALL_BLOWUP4_PARAMS): FibonacciAir
    and KeccakAir (10 permutations) proven on the card equal to the same
    on the CPU (seed 1), every proof verified; seed 2 gives other trace,
    quotient and R roots; a changed random opening is rejected;
    Poseidon2VectorAir, whose own fold takes its width alone, raises
    ValueError."""
    from plonky3_tpu_torch.fields import KoalaBearExt4 as E
    from plonky3_tpu_torch.fri.config import FriParameters
    from plonky3_tpu_torch.stark.prover import prove
    from plonky3_tpu_torch.stark.verifier import verify

    params = FriParameters(**SMALL_BLOWUP4_PARAMS)
    secs, out = {}, {}
    for name, kw in (("fibonacci", {"log_n": 8}), ("keccak", {"perms": 10})):
        cuda = side_zk_small(np, torch, "cuda", name)
        cpu, cpu_secs, _ = cpu_side("side_zk_small", name)
        secs.update(cuda["secs"], **cpu_secs)
        if cuda["plain"] != cpu:
            raise AssertionError(f"the ZK {name} proofs differ")
        proof = cuda["proof"]
        air, trace, publics = _air_workload(np, name, "cuda", **kw)
        other = prove(_zk_config(params, 2, "cuda"), air, trace, publics)
        for root in ("trace", "quotient_chunks", "random"):
            if getattr(other.commitments, root) == getattr(
                    proof.commitments, root):
                raise AssertionError(f"seeds 1 and 2: one {root} root")
        bad = copy.deepcopy(proof)
        _bump_random_opening(bad, E)
        out[name] = {
            "rows": trace.shape[0], "width": air.width,
            "degree_bits": proof.degree_bits,
            "random_opening": rejected(
                "random_opening", lambda: verify(
                    _zk_config(params, 1, "cuda"), air, bad, publics),
                ("InvalidOpeningArgument", "OodEvaluationMismatch"))}
    _, air, trace = _workload(np, 8, params, "cuda")
    try:
        prove(_zk_config(params, 1, "cuda"), air, trace, [])
    except ValueError as e:
        own_fold = str(e)
    else:
        raise AssertionError("Poseidon2VectorAir proved under ZK")
    emit({"phase": "zk_small", "cuda_equals_cpu": True,
          "seeds_differ": True, **out,
          "poseidon2_vector_air_raises": own_fold, **secs})


def phase_zk_air(torch, np, kernels, card):
    """The keccak-f-permutations objective under zk_stark_config at full
    width: KeccakAir, 5,461 permutations, 2^17 x 2,633, randomized to
    2^18 x 2,634 and committed at 2^20 rows with salts (BLOWUP4_PARAMS:
    8 quotient chunks over 2^20 rows), prove() (the host transcript; the
    fast prover covers no ZK PCS). A cold prove with spans (the host's random
    draw and its conversion on the card among them) and peak memory, a
    warm prove with per-launch events and spans; the two proofs from seed
    1 equal; the warm prove's launches (K1, K2, the duplex grind, no
    keccak kernel); the port's verifier accepts the
    proof and rejects a changed opened trace value, random opening and
    salt word. Returns launches and per-proof bounds."""
    from plonky3_tpu_torch.fields import KoalaBearExt4 as E
    from plonky3_tpu_torch.fri.config import FriParameters
    from plonky3_tpu_torch.stark.prover import FOLD_BLOCKS, prove
    from plonky3_tpu_torch.stark.verifier import verify

    log_n = 17
    perms = (1 << log_n) // 24
    t0 = time.perf_counter()
    air, trace, _ = _air_workload(np, "keccak", "cuda", perms=perms)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    params = FriParameters(**BLOWUP4_PARAMS)

    def run(spans=None):
        t0 = time.perf_counter()
        proof = prove(_zk_config(params, 1, "cuda"), air, trace, [],
                      spans=spans)
        torch.cuda.synchronize()
        return proof, time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    cold_spans = {}
    first, cold_s = run(cold_spans)
    peak_mem = torch.cuda.max_memory_allocated()
    kernels.reset_launches()
    blocks = FOLD_BLOCKS["count"]
    warm_spans = {}
    (proof, warm_s), calls = recorded(torch, kernels,
                                      lambda: run(warm_spans))
    launches = dict(kernels.LAUNCHES)
    blocks = FOLD_BLOCKS["count"] - blocks
    missing = [k for k in ZK_PATH if launches[k] == 0]
    launched = [k for k in ZK_STRAY if launches[k]]
    if missing or launched:
        raise AssertionError(f"zk_air prove: not launched {missing}, "
                             f"launched {launched}")
    if as_plain(first) != as_plain(proof):
        raise AssertionError("two ZK proves from one seed differ")
    ov = proof.opened_values
    if (proof.degree_bits != log_n + 1 or len(ov.trace_local) != air.width
            or len(ov.quotient_chunks) != 8 or len(ov.random) != E.D):
        raise AssertionError("the ZK proof has the wrong shape")
    config = _zk_config(params, 1, "cuda")
    t0 = time.perf_counter()
    verify(config, air, proof, [])  # raises on a rejection
    verify_s = time.perf_counter() - t0
    tamper = {}
    for name, change in (("trace_local", _bump_trace_value),
                         ("random_opening", _bump_random_opening),
                         ("salt", _bump_salt)):
        bad = copy.deepcopy(proof)
        change(bad, E)
        tamper[name] = rejected(name, lambda: verify(config, air, bad, []),
                                ("InvalidOpeningArgument",
                                 "OodEvaluationMismatch"))
    emit({"phase": "zk_air", "log_n": log_n, "rows": 1 << log_n,
          "width": air.width, "perms": perms, "trace_gen_s": gen_s,
          "cold_prove_s": cold_s, "warm_events_prove_s": warm_s,
          "perms_per_s": perms / warm_s, "peak_mem_bytes": peak_mem,
          "fold_blocks": blocks, "fold_block_rows": FOLD_BLOCKS["rows"],
          "launches": launches, "equal_proofs": 2,
          "proof_bytes": proof.size_in_bytes(), "verify_s": verify_s,
          "tamper": tamper, "host_cpu": host_cpu()})
    emit({"phase": "zk_air_spans", "cold": cold_spans, "warm": warm_spans})
    per_proof = launch_bounds(card, calls, [proof.opening_proof
                                            .query_pow_witness])
    emit({"phase": "zk_air_per_proof", "kernels": per_proof})
    return dict(launches=launches, per_proof=per_proof, device_ms={})


def _even_zero_air():
    """EvenZeroAir (the reference's preprocessed test AIR): the main
    column is zero wherever the fixed selector column (even rows) is
    one."""
    import numpy as np

    from plonky3_tpu_torch.air.api import BaseAir

    class EvenZeroAir(BaseAir):
        width = 1
        num_public_values = 0

        def __init__(self, field):
            self.field = field

        def preprocessed_trace(self, log_n):
            sel = np.zeros((1 << log_n, 1), dtype=np.uint32)
            sel[::2, 0] = 1
            return sel

        def eval(self, b):
            b.assert_zero(b.preprocessed.local[0] * b.main.local[0])

    return EvenZeroAir


def _even_zero_trace(np, F, log_n, bad=False):
    t = np.random.default_rng(log_n).integers(1, F.P, size=(1 << log_n, 1),
                                              dtype=np.uint32)
    t[::2, 0] = 0
    if bad:
        t[2, 0] = 7  # breaks the selector's constraint
    return F.to_monty_np(t).astype(np.int64)


def side_preprocessed_small(np, torch, dev):
    """EvenZeroAir's setup root and proof at 2^8 rows on `dev`, verified
    on the CPU (VERIFY_ONCE)."""
    from plonky3_tpu_torch.fields import KoalaBear as F
    from plonky3_tpu_torch.fields import KoalaBearExt4 as E
    from plonky3_tpu_torch.fri.config import FriParameters
    from plonky3_tpu_torch.stark import preprocessed as pre
    from plonky3_tpu_torch.stark.config import keccak_stark_config

    air = _even_zero_air()(F)
    cfg = keccak_stark_config(F, E, FriParameters(**SMALL_PARAMS),
                              device=dev)
    setup = pre.setup_preprocessed(cfg, air, 8)
    proof = pre.prove_with_preprocessed(cfg, air, torch.from_numpy(
        _even_zero_trace(np, F, 8)).to(dev), [], setup)
    if dev == "cpu":  # see VERIFY_ONCE
        pre.verify_with_preprocessed(cfg, air, proof, [], setup.root, 1)
    return {"plain": (setup.root, as_plain(proof))}


def phase_preprocessed(torch, np):
    """Preprocessed columns under the keccak config: EvenZeroAir's setup
    root and proof on the card equal the CPU's at 2^8 rows, verified;
    then 2^20 rows with new_benchmark_high_arity(): setup, a cold and a
    warm prove, verified, and a trace that breaks the constraint, proven
    and rejected."""
    from plonky3_tpu_torch.fields import KoalaBear as F
    from plonky3_tpu_torch.fields import KoalaBearExt4 as E
    from plonky3_tpu_torch.fri.config import FriParameters
    from plonky3_tpu_torch.stark import preprocessed as pre
    from plonky3_tpu_torch.stark.config import keccak_stark_config

    air = _even_zero_air()(F)
    if (side_preprocessed_small(np, torch, "cuda")["plain"]
            != cpu_side("side_preprocessed_small")[0]):
        raise AssertionError("the preprocessed proofs differ")
    log_n = 20
    cfg = keccak_stark_config(F, E, FriParameters.new_benchmark_high_arity(),
                              device="cuda")
    t0 = time.perf_counter()
    setup = pre.setup_preprocessed(cfg, air, log_n)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    out = {}
    for name, bad in (("cold", False), ("warm", False), ("bad", True)):
        trace = torch.from_numpy(_even_zero_trace(np, F, log_n,
                                                  bad)).cuda()
        t0 = time.perf_counter()
        proof = pre.prove_with_preprocessed(cfg, air, trace, [], setup)
        torch.cuda.synchronize()
        out[f"{name}_prove_s"] = time.perf_counter() - t0

        def check():
            pre.verify_with_preprocessed(cfg, air, proof, [], setup.root, 1)

        if bad:
            out["bad_trace"] = rejected("bad trace", check,
                                        ("OodEvaluationMismatch",))
        else:
            t0 = time.perf_counter()
            check()
            out[f"{name}_verify_s"] = time.perf_counter() - t0
    emit({"phase": "preprocessed", "small_rows": 256,
          "cuda_equals_cpu": True, "log_n": log_n, "setup_s": setup_s,
          **out})


def _range_check_air():
    """RangeCheckAir (the reference's lookup test AIR): the table column
    counts 0..n-1; the lookup proves every looked-up value lies in it."""
    from plonky3_tpu_torch.air.api import BaseAir

    class RangeCheckAir(BaseAir):
        width = 4  # a, m_a, b, m_b
        num_public_values = 0

        def __init__(self, field):
            self.field = field

        def eval(self, bld):
            local, nxt = bld.main.local, bld.main.next
            bld.when_first_row().assert_zero(local[2])
            bld.when_transition().assert_eq(nxt[2], local[2] + 1)

    return RangeCheckAir


def _range_check_trace(np, F, log_n, unbalanced=False):
    n = 1 << log_n
    a = np.random.default_rng(log_n).integers(0, n, size=n)
    t = np.zeros((n, 4), dtype=np.uint32)
    t[:, 0], t[:, 1], t[:, 2] = a, 1, np.arange(n)
    t[:, 3] = np.bincount(a, minlength=n)
    if unbalanced:
        t[3, 0] = (t[3, 0] + 1) % n
    return F.to_monty_np(t).astype(np.int64)


def side_lookup_small(np, torch, dev):
    """RangeCheckAir at 2^8 rows on `dev`: the permutation trace for one
    beta (as lists of ints), the proof and its permutation root, verified
    on the CPU (VERIFY_ONCE)."""
    from plonky3_tpu_torch.fields import KoalaBear as F
    from plonky3_tpu_torch.fields import KoalaBearExt4 as E
    from plonky3_tpu_torch.fri.config import FriParameters
    from plonky3_tpu_torch.stark import lookup
    from plonky3_tpu_torch.stark.config import keccak_stark_config

    air = _range_check_air()(F)
    cols = lookup.LookupColumns(a=0, m_a=1, b=2, m_b=3)
    trace = torch.from_numpy(_range_check_trace(np, F, 8)).to(dev)
    cfg = keccak_stark_config(F, E, FriParameters(**SMALL_BLOWUP4_PARAMS),
                              device=dev)
    perm = lookup.build_permutation_trace(E, trace, cols, (5, 6, 7, 8))
    proof, root = lookup.prove_with_lookup(cfg, air, trace, [], cols)
    if dev == "cpu":  # see VERIFY_ONCE
        lookup.verify_with_lookup(cfg, air, proof, root, [], cols)
    return {"plain": (perm.cpu().tolist(), root, as_plain(proof))}


def phase_lookup(torch, np):
    """The LogUp lookup under the keccak config: RangeCheckAir at 2^8
    rows, the permutation trace (for one beta) and the proof and its
    permutation root on the card equal the CPU's, verified; at 2^20 rows
    with BLOWUP4_PARAMS a cold and a warm prove, verified, and an
    unbalanced trace refused; the permutation trace at 2^20 rows with the
    norms' inverse by `batch_inv` (the prover's) and by Fermat: the same
    words, each timed by CUDA events."""
    from plonky3_tpu_torch.fields import KoalaBear as F
    from plonky3_tpu_torch.fields import KoalaBearExt4 as E
    from plonky3_tpu_torch.fri.config import FriParameters
    from plonky3_tpu_torch.stark import lookup
    from plonky3_tpu_torch.stark.config import keccak_stark_config

    air = _range_check_air()(F)
    cols = lookup.LookupColumns(a=0, m_a=1, b=2, m_b=3)
    beta = (5, 6, 7, 8)
    if (side_lookup_small(np, torch, "cuda")["plain"]
            != cpu_side("side_lookup_small")[0]):
        raise AssertionError("the lookup proofs differ")
    log_n = 20
    cfg = keccak_stark_config(F, E, FriParameters(**BLOWUP4_PARAMS),
                              device="cuda")
    trace = torch.from_numpy(_range_check_trace(np, F, log_n)).cuda()
    out = {}
    for name in ("cold", "warm"):
        t0 = time.perf_counter()
        proof, root = lookup.prove_with_lookup(cfg, air, trace, [], cols)
        torch.cuda.synchronize()
        out[f"{name}_prove_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    lookup.verify_with_lookup(cfg, air, proof, root, [], cols)
    out["verify_s"] = time.perf_counter() - t0
    perm = {}
    for name, inv in (("batch_inv", F.batch_inv), ("fermat", F.inv)):
        perm[name] = lookup.build_permutation_trace(E, trace, cols, beta,
                                                    base_inv=inv)
        out[f"permutation_trace_{name}_ms"] = events_ms(
            torch, lambda: lookup.build_permutation_trace(
                E, trace, cols, beta, base_inv=inv), 5)
    if not torch.equal(perm["batch_inv"], perm["fermat"]):
        raise AssertionError("batch_inv and Fermat permutation traces "
                             "differ")
    bad = torch.from_numpy(_range_check_trace(np, F, log_n, True)).cuda()
    try:
        lookup.prove_with_lookup(cfg, air, bad, [], cols)
    except ValueError as e:
        out["unbalanced"] = str(e)
    else:
        raise AssertionError("an unbalanced lookup was proven")
    emit({"phase": "lookup", "small_rows": 256, "cuda_equals_cpu": True,
          "log_n": log_n, **out})


def _batch_instances(np, device, log_p2, keccak_perms, log_fib,
                     params=None):
    """Poseidon2VectorAir(KoalaBear, 16, 8) at 2^log_p2 rows (the main
    path's inputs), KeccakAir over `keccak_perms` permutations and
    FibonacciAir at 2^log_fib rows, as BatchInstances."""
    from plonky3_tpu_torch.fri.config import FriParameters
    from plonky3_tpu_torch.stark.batch import BatchInstance

    _, p2, p2_trace = _workload(np, log_p2,
                                params or FriParameters(**SMALL_PARAMS),
                                device)
    return [BatchInstance(p2, p2_trace, []),
            BatchInstance(*_air_workload(np, "keccak", device,
                                         perms=keccak_perms)),
            BatchInstance(*_air_workload(np, "fibonacci", device,
                                         log_n=log_fib))]


def side_batch_small(np, torch, dev, kind):
    """The batch proof at 2^8-scale heights under the `kind` config on
    `dev`, verified on the CPU (VERIFY_ONCE)."""
    from plonky3_tpu_torch.fields import KoalaBear as F
    from plonky3_tpu_torch.fields import KoalaBearExt4 as E
    from plonky3_tpu_torch.fri.config import FriParameters
    from plonky3_tpu_torch.stark import batch, config as stark_config

    inst = _batch_instances(np, dev, 8, 5, 4)
    cfg = getattr(stark_config, f"{kind}_stark_config")(
        F, E, FriParameters(**SMALL_PARAMS), device=dev)
    t0 = time.perf_counter()
    proof = batch.prove_batch(cfg, inst)
    sync(torch, dev)
    secs = {f"small_{kind}_{dev}_s": time.perf_counter() - t0}
    if dev == "cpu":  # see VERIFY_ONCE
        batch.verify_batch(cfg, [i.air for i in inst], proof,
                           [i.public_values for i in inst])
    return {"plain": as_plain(proof), "secs": secs}


def phase_batch(torch, np, kernels, card):
    """The lookup-free batch STARK: at 2^8-scale heights (2^8, 2^7 and
    2^4 rows) the batch proof on the card equals the CPU's under the
    keccak and the Poseidon2 config, verified; then under the keccak
    config one commitment of Poseidon2VectorAir(KoalaBear, 16, 8) at
    2^17 x 1,312 (bench.py's trace), KeccakAir at 2^16 x 2,633 and
    FibonacciAir at 2^10, new_benchmark_high_arity(): a cold and a warm
    prove with the launches of the warm one (compress_kernel for the
    injected heights among them), a third with per-launch events, all
    equal, verified. Returns launches and per-proof bounds."""
    from plonky3_tpu_torch.fields import KoalaBear as F
    from plonky3_tpu_torch.fields import KoalaBearExt4 as E
    from plonky3_tpu_torch.fri.config import FriParameters
    from plonky3_tpu_torch.stark import batch, config as stark_config

    secs = {}
    for kind in ("keccak", "poseidon2"):
        cuda = side_batch_small(np, torch, "cuda", kind)
        cpu, cpu_secs, _ = cpu_side("side_batch_small", kind)
        secs.update(cuda["secs"], **cpu_secs)
        if cuda["plain"] != cpu:
            raise AssertionError(f"the small {kind} batch proofs differ")
    params = FriParameters.new_benchmark_high_arity()
    inst = _batch_instances(np, "cuda", 17, (1 << 16) // 24, 10, params)
    heights = [list(i.trace.shape) for i in inst]
    cfg = stark_config.keccak_stark_config(F, E, params, device="cuda")

    def run():
        t0 = time.perf_counter()
        proof = batch.prove_batch(cfg, inst)
        torch.cuda.synchronize()
        return proof, time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    first, cold_s = run()
    peak_mem = torch.cuda.max_memory_allocated()
    kernels.reset_launches()
    proof, warm_s = run()
    launches = dict(kernels.LAUNCHES)
    missing = [k for k in BATCH_PATH if launches[k] == 0]
    if missing:
        raise AssertionError(f"batch prove: not launched {missing}")
    (traced, _), calls = recorded(torch, kernels, run)
    if not as_plain(first) == as_plain(proof) == as_plain(traced):
        raise AssertionError("three batch proves differ")
    t0 = time.perf_counter()
    batch.verify_batch(cfg, [i.air for i in inst], proof,
                       [i.public_values for i in inst])
    verify_s = time.perf_counter() - t0
    emit({"phase": "batch", "small_cuda_equals_cpu": True, **secs,
          "shapes": heights, "degree_bits": proof.degree_bits,
          "cold_prove_s": cold_s, "warm_prove_s": warm_s,
          "peak_mem_bytes": peak_mem, "launches": launches,
          "verify_s": verify_s, "equal_proofs": 3})
    per_proof = launch_bounds(card, calls)
    emit({"phase": "batch_per_proof", "kernels": per_proof})
    return dict(launches=launches, per_proof=per_proof, device_ms={})


# ---- the rest of M17 and M18: buses, the canonical batch, the wire ----

# the canonical batch proof under the Poseidon2 config over BabyBear: the
# NTTs and the host transcript's <21, 7> grind on the card (the trees are
# plain-torch Poseidon2)
BATCH_REF_PATH = ("ntt_k1", "ntt_k2", "poseidon2_grind_babybear")
BATCH_REF_STRAY = KECCAK_KERNELS + P2_KERNELS[:3]
# the bus batch under the keccak config: the trees inject the shorter
# instances' matrices by compress_kernel (the host transcript hashes and
# grinds on the host)
INTERACTION_PATH = BATCH_PATH
INTERACTION_STRAY = ("keccak256_chain", "keccak_grind") + P2_KERNELS


def _bus_airs():
    """The bus test AIRs of the reference's interaction test (copies, as
    `_range_check_air`): QueryAir looks its value up on the range bus,
    TableAir provides 0..n-1 with multiplicities; SendAir and RecvAir
    send and receive pairs on a permutation-check bus."""
    from plonky3_tpu_torch.air.api import BaseAir
    from plonky3_tpu_torch.stark.interaction import (LookupBus,
                                                     PermutationCheckBus)

    rng_bus, pipe = LookupBus("range16"), PermutationCheckBus("pipe")

    class QueryAir(BaseAir):
        width, num_public_values = 1, 0

        def __init__(self, field):
            self.field = field

        def eval(self, b):
            rng_bus.lookup_key(b, [b.main.local[0]], 1)

    class TableAir(BaseAir):
        width, num_public_values = 2, 0  # value, multiplicity

        def __init__(self, field):
            self.field = field

        def eval(self, b):
            local, nxt = b.main.local, b.main.next
            b.when_first_row().assert_zero(local[0])
            b.when_transition().assert_eq(nxt[0], local[0] + 1)
            rng_bus.table_entry(b, [local[0]], local[1])

    class SendAir(BaseAir):
        width, num_public_values = 2, 0

        def __init__(self, field):
            self.field = field

        def eval(self, b):
            pipe.send(b, [b.main.local[0], b.main.local[1]], 1)

    class RecvAir(BaseAir):
        width, num_public_values = 2, 0

        def __init__(self, field):
            self.field = field

        def eval(self, b):
            pipe.receive(b, [b.main.local[0], b.main.local[1]], 1)

    return QueryAir, TableAir, SendAir, RecvAir


def _bus_instances(torch, np, F, device, log_q, log_t, log_p,
                   unbalanced=False):
    """BatchInstances: 2^log_q range queries below 2^log_t into the
    2^log_t-row table (one multiplicity raised when `unbalanced`), and
    2^log_p pairs sent and received in another order."""
    from plonky3_tpu_torch.stark.batch import BatchInstance

    rng = np.random.default_rng(log_q)
    q = rng.integers(0, 1 << log_t, size=1 << log_q)
    counts = np.bincount(q, minlength=1 << log_t)
    if unbalanced:
        counts[0] += 1
    pairs = rng.integers(0, F.P, size=(1 << log_p, 2))
    traces = [q.reshape(-1, 1), np.stack([np.arange(1 << log_t), counts], 1),
              pairs, pairs[rng.permutation(1 << log_p)]]

    def dev(t):
        return torch.from_numpy(F.to_monty_np(t.astype(np.uint32))
                                .astype(np.int64)).to(device)

    return [BatchInstance(air(F), dev(t), [])
            for air, t in zip(_bus_airs(), traces)]


def _batch_ref_case(torch, np, device, log_p2, log_mul, params):
    """(config, instances, public values) of the canonical batch: the
    CLI's poseidon-2-permutations trace over BabyBear at 2^log_p2 rows
    (`cli.build`, no bus), MulAirLookups(BabyBear, reps=2, global) at
    2^log_mul x 7 and FibAirLookups at 2^log_mul with its preprocessed
    index column, the last two on the shared MulFib bus;
    poseidon2_stark_config(BabyBear, BabyBearExt4, params)."""
    from plonky3_tpu_torch import cli
    from plonky3_tpu_torch.compat import batch_fixture_airs as fx
    from plonky3_tpu_torch.fields import BabyBear as F
    from plonky3_tpu_torch.fields import BabyBearExt4 as E
    from plonky3_tpu_torch.stark.batch import BatchInstance
    from plonky3_tpu_torch.stark.config import poseidon2_stark_config

    job = cli.build("baby-bear", "poseidon-2-permutations", log_p2, 3,
                    "benchmark-high-arity", "poseidon2", device)
    config = poseidon2_stark_config(F, E, params, device=device)
    ft, fpis = fx.fibonacci_trace(F, log_mul)

    def dev(t):
        return torch.from_numpy(F.to_monty_np(t).astype(np.int64)).to(device)

    inst = [BatchInstance(job.air, job.trace, []),
            BatchInstance(fx.MulAirLookups(F, reps=2, is_global=True),
                          dev(fx.mul_trace(F, 1 << log_mul, 2)), []),
            BatchInstance(fx.FibAirLookups(F, log_height=log_mul),
                          dev(ft), fpis)]
    return config, inst, [i.public_values for i in inst]


def _bump_terminal(proof, E):
    proof.lookup_terminals[1] = E.add_h(proof.lookup_terminals[1],
                                        E.one_h())


def _bump_perm_value(proof, E):
    inst = proof.instances[1]
    inst.permutation_local = list(inst.permutation_local)
    inst.permutation_local[0] = E.add_h(inst.permutation_local[0],
                                        E.one_h())


def _bump_batch_trace_value(proof, E):
    inst = proof.instances[2]
    inst.trace_local = list(inst.trace_local)
    inst.trace_local[0] = E.add_h(inst.trace_local[0], E.one_h())


def phase_batch_ref(torch, np, kernels, card):
    """The canonical batch STARK (stark/batch_ref.py) at full size under
    poseidon2_stark_config(BabyBear, BabyBearExt4,
    new_benchmark_high_arity()): the CLI's poseidon-2-permutations trace
    over BabyBear (2^17 x 2,384, no bus), MulAirLookups at 2^20 x 7 and
    FibAirLookups at 2^20 with its preprocessed column on the MulFib bus.
    The MulFib columns stay unpacked (a merged pin would reach degree 3,
    above the budget of 2), so every constraint has degree 2 and one
    quotient chunk fits the LDE of log_blowup 1. keygen; a cold and a
    warm prove with spans, peak memory, the launches of the warm one; a
    third with per-launch events; all three equal; the host verify; a
    changed terminal, opened permutation value and trace value rejected;
    the proof through the postcard wire (batch_wire, TWO_ADIC_SPEC) and
    back, equal, with its byte count. Returns launches and per-proof
    bounds."""
    from plonky3_tpu_torch.compat.batch_wire import (
        decode_to_batch_ref_proof, encode_batch_ref_proof)
    from plonky3_tpu_torch.fields import BabyBear as F
    from plonky3_tpu_torch.fields import BabyBearExt4 as E
    from plonky3_tpu_torch.fri.config import FriParameters
    from plonky3_tpu_torch.serde.proof_codec import TWO_ADIC_SPEC
    from plonky3_tpu_torch.stark import batch_ref as br

    t0 = time.perf_counter()
    config, inst, publics = _batch_ref_case(
        torch, np, "cuda", 17, 20, FriParameters.new_benchmark_high_arity())
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    airs = [i.air for i in inst]
    t0 = time.perf_counter()
    common = br.keygen(config, airs,
                       [i.trace.shape[0].bit_length() - 1 for i in inst])
    torch.cuda.synchronize()
    keygen_s = time.perf_counter() - t0

    def run(spans=None):
        t0 = time.perf_counter()
        proof = br.prove_batch_ref(config, inst, common, spans=spans)
        torch.cuda.synchronize()
        return proof, time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    cold_spans, warm_spans = {}, {}
    first, cold_s = run(cold_spans)
    kernels.reset_launches()
    proof, warm_s = run(warm_spans)
    launches = dict(kernels.LAUNCHES)
    peak_mem = torch.cuda.max_memory_allocated()
    missing = [k for k in BATCH_REF_PATH if launches[k] == 0]
    launched = [k for k in BATCH_REF_STRAY if launches[k]]
    if missing or launched:
        raise AssertionError(f"batch_ref prove: not launched {missing}, "
                             f"launched {launched}")
    (traced, _), calls = recorded(torch, kernels, run)
    if not as_plain(first) == as_plain(proof) == as_plain(traced):
        raise AssertionError("three batch_ref proves differ")
    t0 = time.perf_counter()
    br.verify_batch_ref(config, airs, proof, publics, common)
    verify_s = time.perf_counter() - t0
    tamper = {}
    for name, change, want in (
            ("terminal", _bump_terminal, ("lookup terminal sum",)),
            ("permutation_local", _bump_perm_value,
             ("InvalidOpeningArgument", "OodEvaluationMismatch")),
            ("trace_local", _bump_batch_trace_value,
             ("InvalidOpeningArgument", "OodEvaluationMismatch"))):
        bad = copy.deepcopy(proof)
        change(bad, E)
        tamper[name] = rejected(name, lambda: br.verify_batch_ref(
            config, airs, bad, publics, common), want)
    t0 = time.perf_counter()
    wire = encode_batch_ref_proof(proof, F, TWO_ADIC_SPEC)
    back = decode_to_batch_ref_proof(wire, F, TWO_ADIC_SPEC)
    wire_s = time.perf_counter() - t0
    if as_plain(back) != as_plain(proof):
        raise AssertionError("the batch_ref proof changed on the wire")
    emit({"phase": "batch_ref", "shapes": [list(i.trace.shape)
                                           for i in inst],
          "degree_bits": proof.degree_bits, "plans": common.plans,
          "log_chunks": common.log_chunks, "fri": "new_benchmark_high_arity",
          "trace_gen_s": gen_s, "keygen_s": keygen_s,
          "cold_prove_s": cold_s, "warm_prove_s": warm_s,
          "peak_mem_bytes": peak_mem, "launches": launches,
          "equal_proofs": 3, "verify_s": verify_s, "tamper": tamper,
          "wire_bytes": len(wire), "wire_roundtrip_s": wire_s,
          "host_cpu": host_cpu()})
    emit({"phase": "batch_ref_spans", "cold": cold_spans,
          "warm": warm_spans})
    per_proof = launch_bounds(card, calls, [proof.opening_proof
                                            .query_pow_witness])
    emit({"phase": "batch_ref_per_proof", "kernels": per_proof})
    return dict(launches=launches, per_proof=per_proof, device_ms={})


def phase_interaction(torch, np, kernels, card):
    """LogUp buses across batch instances (stark/interaction.py) under
    keccak_stark_config(KoalaBear, KoalaBearExt4,
    new_benchmark_high_arity()): a 16-bit range check, 2^20 queries into
    the 2^16-row table with multiplicities, and 2^18 pairs on a
    permutation-check bus, in one proof (mixed heights: the trees inject
    by compress_kernel). A cold and a warm prove with spans, peak memory,
    the warm one's launches, a third with per-launch events, all equal;
    the host verify; a table with one multiplicity raised proven and
    rejected. Returns launches and per-proof bounds."""
    from plonky3_tpu_torch.fields import KoalaBear as F
    from plonky3_tpu_torch.fields import KoalaBearExt4 as E
    from plonky3_tpu_torch.fri.config import FriParameters
    from plonky3_tpu_torch.stark import interaction as it
    from plonky3_tpu_torch.stark.config import keccak_stark_config

    config = keccak_stark_config(F, E,
                                 FriParameters.new_benchmark_high_arity(),
                                 device="cuda")
    inst = _bus_instances(torch, np, F, "cuda", 20, 16, 18)
    airs = [i.air for i in inst]

    def run(instances, spans=None):
        t0 = time.perf_counter()
        proof = it.prove_batch_with_lookups(config, instances, spans=spans)
        torch.cuda.synchronize()
        return proof, time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    cold_spans, warm_spans = {}, {}
    first, cold_s = run(inst, cold_spans)
    kernels.reset_launches()
    proof, warm_s = run(inst, warm_spans)
    launches = dict(kernels.LAUNCHES)
    peak_mem = torch.cuda.max_memory_allocated()
    missing = [k for k in INTERACTION_PATH if launches[k] == 0]
    launched = [k for k in INTERACTION_STRAY if launches[k]]
    if missing or launched:
        raise AssertionError(f"interaction prove: not launched {missing}, "
                             f"launched {launched}")
    (traced, _), calls = recorded(torch, kernels, lambda: run(inst))
    if not as_plain(first) == as_plain(proof) == as_plain(traced):
        raise AssertionError("three interaction proves differ")
    publics = [[] for _ in inst]
    t0 = time.perf_counter()
    it.verify_batch_with_lookups(config, airs, proof, publics)
    verify_s = time.perf_counter() - t0
    bad = _bus_instances(torch, np, F, "cuda", 20, 16, 18, unbalanced=True)
    bad_proof, bad_s = run(bad)
    unbalanced = rejected("unbalanced table", lambda: (
        it.verify_batch_with_lookups(config, airs, bad_proof, publics)),
        ("cross-AIR lookup terminal sum",))
    emit({"phase": "interaction", "shapes": [list(i.trace.shape)
                                             for i in inst],
          "degree_bits": proof.base.degree_bits,
          "cold_prove_s": cold_s, "warm_prove_s": warm_s,
          "peak_mem_bytes": peak_mem, "launches": launches,
          "equal_proofs": 3, "verify_s": verify_s,
          "unbalanced_prove_s": bad_s, "unbalanced": unbalanced})
    emit({"phase": "interaction_spans", "cold": cold_spans,
          "warm": warm_spans})
    per_proof = launch_bounds(card, calls)
    emit({"phase": "interaction_per_proof", "kernels": per_proof})
    return dict(launches=launches, per_proof=per_proof, device_ms={})


def phase_serde(torch, np, babybear_poseidon2):
    """The postcard wire and the new provers at 256 rows: the
    babybear_poseidon2 phase's full-size proof through uni_stark_wire
    (TWO_ADIC_SPEC) and back, equal, with its byte count; the canonical
    batch (the CLI's BabyBear trace at 2^8 rows, MulAirLookups and
    FibAirLookups at 2^8, SMALL_PARAMS) and the bus batch (2^8 queries
    into 2^6 table rows, 2^8 pairs) proven on the card equal to the CPU's,
    verified, and the batch proof through batch_wire and back."""
    from plonky3_tpu_torch.compat.uni_stark_wire import (
        decode_to_our_proof, encode_our_proof)
    from plonky3_tpu_torch.fields import BabyBear as BF
    from plonky3_tpu_torch.serde.proof_codec import TWO_ADIC_SPEC

    out = {}
    proof = babybear_poseidon2["proof"]
    t0 = time.perf_counter()
    wire = encode_our_proof(proof, BF, TWO_ADIC_SPEC)
    back = decode_to_our_proof(wire, BF, TWO_ADIC_SPEC)
    out["uni_stark_wire_s"] = time.perf_counter() - t0
    if as_plain(back) != as_plain(proof):
        raise AssertionError("the babybear_poseidon2 proof changed on the "
                             "wire")
    out["uni_stark_wire_bytes"] = len(wire)
    cuda = side_serde_small(np, torch, "cuda")
    cpu, cpu_secs, _ = cpu_side("side_serde_small")
    out.update(cuda["secs"], **cpu_secs)
    if cuda["plain"] != cpu:
        raise AssertionError("the small batch_ref or interaction proofs "
                             "differ between CUDA and the CPU")
    emit({"phase": "serde", "small_rows": 256, "cuda_equals_cpu": True,
          "small_batch_ref_wire_bytes": len(cpu[1]), **out})


def side_serde_small(np, torch, dev):
    """phase_serde's canonical batch and bus batch at 256 rows on `dev`,
    with the batch proof's wire bytes; on the CPU both verified and the
    batch proof decoded back from the wire (VERIFY_ONCE)."""
    from plonky3_tpu_torch.compat.batch_wire import (
        decode_to_batch_ref_proof, encode_batch_ref_proof)
    from plonky3_tpu_torch.fields import BabyBear as BF
    from plonky3_tpu_torch.fields import KoalaBear as F
    from plonky3_tpu_torch.fields import KoalaBearExt4 as E
    from plonky3_tpu_torch.fri.config import FriParameters
    from plonky3_tpu_torch.serde.proof_codec import TWO_ADIC_SPEC
    from plonky3_tpu_torch.stark import batch_ref as br
    from plonky3_tpu_torch.stark import interaction as it
    from plonky3_tpu_torch.stark.config import keccak_stark_config

    params, secs = FriParameters(**SMALL_PARAMS), {}
    config, inst, publics = _batch_ref_case(torch, np, dev, 8, 8, params)
    airs = [i.air for i in inst]
    common = br.keygen(config, airs, [8, 8, 8])
    t0 = time.perf_counter()
    proof = br.prove_batch_ref(config, inst, common)
    sync(torch, dev)
    secs[f"batch_ref_{dev}_s"] = time.perf_counter() - t0
    wire = encode_batch_ref_proof(proof, BF, TWO_ADIC_SPEC)
    if dev == "cpu":  # see VERIFY_ONCE
        br.verify_batch_ref(config, airs, proof, publics, common)
        if as_plain(decode_to_batch_ref_proof(wire, BF, TWO_ADIC_SPEC)) != (
                as_plain(proof)):
            raise AssertionError("the small batch_ref proof changed on the "
                                 "wire")
    kconfig = keccak_stark_config(F, E, params, device=dev)
    binst = _bus_instances(torch, np, F, dev, 8, 6, 8)
    t0 = time.perf_counter()
    bproof = it.prove_batch_with_lookups(kconfig, binst)
    sync(torch, dev)
    secs[f"interaction_{dev}_s"] = time.perf_counter() - t0
    if dev == "cpu":  # see VERIFY_ONCE
        it.verify_batch_with_lookups(kconfig, [i.air for i in binst],
                                     bproof, [[] for _ in binst])
    return {"plain": (as_plain(proof), wire, as_plain(bproof)),
            "secs": secs}


# the circle STARK (M19): its commitments go through the keccak leaf
# sponge and the ladder (compress_kernel where a tree injects a shorter
# height); no NTT (Mersenne-31 has no two-adic subgroup: the circle DFT is
# plain torch), no transcript kernel (prove() runs the host transcript
# and grinds on the host)
CIRCLE_PATH = ("keccak_sponge", "keccak_ladder")
CIRCLE_STRAY = ("ntt_k1", "ntt_k2", "keccak256_chain",
                "keccak_grind") + P2_KERNELS
CIRCLE_SMALL_PARAMS = dict(SMALL_PARAMS, max_log_arity=1)
CIRCLE_CLI_ARGS = ("prove", "--field", "mersenne-31", "--objective",
                   "keccak-f-permutations", "--log-trace-length", "17",
                   "--fri", "benchmark")
MONOLITH_LOG_N = 16  # a cut of depth: the script's time limit


def _circle_launches(kernels, phase):
    """This prove's launches: every kernel of CIRCLE_PATH, none of
    CIRCLE_STRAY."""
    launches = dict(kernels.LAUNCHES)
    missing = [k for k in CIRCLE_PATH if launches[k] == 0]
    launched = [k for k in CIRCLE_STRAY if launches[k]]
    if missing or launched:
        raise AssertionError(f"{phase} prove: not launched {missing}, "
                             f"launched {launched}")
    return launches


def _bump_final_poly(proof, E):
    fri = proof.opening_proof.fri_proof
    fri.final_poly[0] = E.add_h(fri.final_poly[0], E.one_h())


def _circle_probes(config, air, proof, publics, names):
    """The port's verifier on `proof` (host time), then on each named
    change, which must be rejected."""
    from plonky3_tpu_torch.stark.verifier import verify

    t0 = time.perf_counter()
    verify(config, air, proof, publics)  # raises on a rejection
    verify_s = time.perf_counter() - t0
    changes = {"trace_local": (_bump_trace_value, (
        "OodEvaluationMismatch", "InvalidOpeningArgument")),
        # the final polynomial is in the transcript: the query PoW or
        # the final fold catches it
        "final_poly": (_bump_final_poly, ("InvalidOpeningArgument",))}
    tamper = {}
    for name in names:
        change, prefixes = changes[name]
        bad = copy.deepcopy(proof)
        change(bad, config.E)
        tamper[name] = rejected(name, lambda: verify(config, air, bad,
                                                     publics), prefixes)
    return verify_s, tamper


def side_circle_small(np, torch, dev, name):
    """phase_circle_small's proof of `name` on `dev`, verified; on the
    card a changed opened value rejected."""
    from plonky3_tpu_torch.fields.mersenne31 import Mersenne31
    from plonky3_tpu_torch.fri.config import FriParameters
    from plonky3_tpu_torch.stark.config import circle_stark_config
    from plonky3_tpu_torch.stark.prover import prove

    air, trace, publics = _air_workload(np, name, dev, log_n=8, perms=10,
                                        F=Mersenne31)
    config = circle_stark_config(FriParameters(**CIRCLE_SMALL_PARAMS),
                                 device=dev)
    t0 = time.perf_counter()
    proof = prove(config, air, trace, publics)
    sync(torch, dev)
    secs = {f"{name}_{dev}_s": time.perf_counter() - t0}
    _, tamper = _circle_probes(config, air, proof, publics,
                               ("trace_local",) if dev == "cuda" else ())
    return {"plain": as_plain(proof), "secs": secs, "tamper": tamper}


def phase_circle_small(torch, np):
    """The circle STARK at 256 rows (circle_stark_config, FRI folding by
    2, 10 queries): FibonacciAir and KeccakAir with 10 permutations,
    prove() on the card equal to prove() on the CPU (plain versions),
    every proof verified, and a changed opened value rejected."""
    secs, tamper = {}, {}
    for name in ("fibonacci", "keccak"):
        cuda = side_circle_small(np, torch, "cuda", name)
        cpu, cpu_secs, _ = cpu_side("side_circle_small", name)
        secs.update(cuda["secs"], **cpu_secs)
        tamper.update({f"{name}_{k}": v for k, v in cuda["tamper"].items()})
        if cuda["plain"] != cpu:
            raise AssertionError(f"the circle {name} proof on CUDA "
                                 f"differs from the CPU's")
    emit({"phase": "circle_small", "rows": 256, "equal_cuda_cpu": True,
          "seconds": secs, "tamper": tamper})


def phase_circle_keccak_air(torch, np, kernels, card):
    """The reference CLI's `--field mersenne-31` objective: 5,461
    keccak-f permutations, a 2^17 x 2,633 KeccakAir trace over
    Mersenne-31, `cli.build(..., fri="benchmark")`: circle_stark_config
    (CirclePcs over QM31, the KeccakF Merkle tree), folding by 2, 100
    queries, 16 PoW bits, proven by prove() (the CLI's stated choice).
    A cold prove and two warm ones with spans, all equal; the first warm
    one's launches (sponge and ladder, no NTT, transcript or grind
    kernel), the second's per-launch events (per-proof bounds); peak
    memory; the port's verifier accepts and rejects a changed opened
    value and a changed FRI final polynomial; the profile. Returns
    launches, per-proof bounds, profiled device time by kernel and the
    proof's size."""
    from plonky3_tpu_torch import cli
    from plonky3_tpu_torch.stark.prover import prove

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    job = cli.build("mersenne-31", "keccak-f-permutations", 17,
                    fri="benchmark", device=dev)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    config, air, trace = job.config, job.air, job.trace
    params = config.pcs.fri
    if (trace.shape != (1 << 17, KECCAK_AIR_WIDTH)
            or cli.chosen_prover(config, "fast") != "host"
            or (params.max_log_arity, params.num_queries,
                params.query_proof_of_work_bits) != (1, 100, 16)):
        raise AssertionError(f"circle KeccakAir job {tuple(trace.shape)} "
                             f"{params}")
    timed = timer(torch, config, air, trace)
    torch.cuda.reset_peak_memory_stats()
    spans = {"cold": {}, "warm": {}, "warm_events": {}}
    first, cold_s = timed(prove, spans=spans["cold"])
    kernels.reset_launches()
    proof, warm_s = timed(prove, spans=spans["warm"])
    launches = _circle_launches(kernels, "circle_keccak_air")
    (traced, warm_events_s), calls = recorded(
        torch, kernels, lambda: timed(prove, spans=spans["warm_events"]))
    peak_mem = torch.cuda.max_memory_allocated()
    if not as_plain(first) == as_plain(proof) == as_plain(traced):
        raise AssertionError("three circle KeccakAir proves differ")
    # FRI folds the y-folded 2^17-row first layer down to 2^log_blowup
    fri = proof.opening_proof.fri_proof
    rounds = 17 - params.log_blowup - params.log_final_poly_len
    if (proof.degree_bits != 17 or len(fri.final_poly) != 1
            or len(fri.commit_phase_commits) != rounds):
        raise AssertionError(
            f"the circle KeccakAir proof's shape: degree bits "
            f"{proof.degree_bits}, {len(fri.commit_phase_commits)} rounds")
    verify_s, tamper = _circle_probes(config, air, proof, [],
                                      ("trace_local", "final_poly"))
    per_proof = launch_bounds(card, calls)
    emit({"phase": "circle_keccak_air", "rows": 1 << 17,
          "width": air.width, "perms": (1 << 17) // 24,
          "trace_gen_s": gen_s, "cold_prove_s": cold_s,
          "warm_prove_s": warm_s, "warm_events_prove_s": warm_events_s,
          "perms_per_s": ((1 << 17) // 24) / warm_s,
          "peak_mem_bytes": peak_mem, "launches": launches,
          "equal_proofs": 3, "verify_s": verify_s, "tamper": tamper,
          "proof_bytes": proof.size_in_bytes()})
    emit({"phase": "circle_keccak_air_spans", "seconds": spans})
    emit({"phase": "circle_keccak_air_per_proof", "kernels": per_proof})
    device_ms = profile_prove(torch, kernels, prove, config, air, trace,
                              warm_s, phase="circle_keccak_air_profile")
    return dict(launches=launches, per_proof=per_proof, device_ms=device_ms,
                proof_bytes=proof.size_in_bytes())


def phase_monolith_air(torch, np, kernels, card):
    """MonolithAir at its full width (3,520 columns) over 2^16
    permutations (the depth cut to 2^MONOLITH_LOG_N rows for the
    script's time; inputs from np.random.default_rng(1)), the trace
    generated on the card, under circle_stark_config(new_benchmark()):
    a cold and a warm prove (spans; the cold one with per-launch
    events), equal; launches, peak memory, verified, a changed opened
    value rejected. Returns launches and per-proof bounds."""
    from plonky3_tpu_torch.fields.mersenne31 import Mersenne31 as F
    from plonky3_tpu_torch.fri.config import FriParameters
    from plonky3_tpu_torch.models.monolith_air import (
        NUM_MONOLITH_COLS, MonolithAir, generate_monolith_trace)
    from plonky3_tpu_torch.stark.config import circle_stark_config
    from plonky3_tpu_torch.stark.prover import prove

    n = 1 << MONOLITH_LOG_N
    inputs = np.random.default_rng(1).integers(
        0, F.P, size=(n, 16), dtype=np.uint64).astype(np.uint32)
    t0 = time.perf_counter()
    trace = generate_monolith_trace(F, inputs, device="cuda")
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    if trace.shape != (n, NUM_MONOLITH_COLS):
        raise AssertionError(f"MonolithAir trace {tuple(trace.shape)}")
    air = MonolithAir(F)
    config = circle_stark_config(FriParameters.new_benchmark(),
                                 device="cuda")
    timed = timer(torch, config, air, trace)
    torch.cuda.reset_peak_memory_stats()
    spans = {"cold": {}, "warm": {}}
    (first, cold_s), calls = recorded(
        torch, kernels, lambda: timed(prove, spans=spans["cold"]))
    kernels.reset_launches()
    proof, warm_s = timed(prove, spans=spans["warm"])
    launches = _circle_launches(kernels, "monolith_air")
    peak_mem = torch.cuda.max_memory_allocated()
    if as_plain(first) != as_plain(proof):
        raise AssertionError("two MonolithAir proves differ")
    verify_s, tamper = _circle_probes(config, air, proof, [],
                                      ("trace_local",))
    per_proof = launch_bounds(card, calls)
    emit({"phase": "monolith_air", "rows": n, "width": air.width,
          "perms": n, "cut": f"depth 2^{MONOLITH_LOG_N} rows",
          "trace_gen_s": gen_s, "cold_events_prove_s": cold_s,
          "warm_prove_s": warm_s, "perms_per_s": n / warm_s,
          "peak_mem_bytes": peak_mem, "launches": launches,
          "equal_proofs": 2, "verify_s": verify_s, "tamper": tamper,
          "proof_bytes": proof.size_in_bytes(), "spans": spans})
    emit({"phase": "monolith_air_per_proof", "kernels": per_proof})
    return dict(launches=launches, per_proof=per_proof, device_ms={})


def phase_cli_circle(torch, circle):
    """`run_cli` with CIRCLE_CLI_ARGS: the objective line, the stated
    prover (prove()) and the circle_keccak_air phase's proof size (the
    same inputs and config)."""
    run_cli(torch, CIRCLE_CLI_ARGS, [
        "objective: 5461 keccak-f[1600] permutations (24 rows each, width "
        "2633)", "prover: host",
        f"  proof size: {circle['proof_bytes']} bytes"], "cli_circle",
        {"log_trace_length": 17, "proof_bytes": circle["proof_bytes"]})


# the Goldilocks proofs launch the Poseidon2-GL kernels and no other
GL_PATH = ("gl_sponge", "gl_compress", "gl_permute")
GL_SMALL_PARAMS = dict(log_blowup=1, log_final_poly_len=0, max_log_arity=1,
                       num_queries=10, commit_proof_of_work_bits=0,
                       query_proof_of_work_bits=8)
GL_SMALL_MONOLITH_ROWS = 16


def _gl_launches(kernels, phase):
    """This prove's launches: every kernel of GL_PATH, no other."""
    launches = dict(kernels.LAUNCHES)
    missing = [k for k in GL_PATH if launches[k] == 0]
    launched = [k for k, v in launches.items() if v and k not in GL_PATH]
    if missing or launched:
        raise AssertionError(f"{phase} prove: not launched {missing}, "
                             f"launched {launched}")
    return launches


def _gl_workload(np, name, device, log_n):
    """(air, trace, public values): FibonacciAir at 2^log_n rows, or
    MonolithGoldilocksAir over 2^log_n permutations of inputs from
    np.random.default_rng(1), the trace generated on `device`."""
    from plonky3_tpu_torch.gl.field import GLF
    from plonky3_tpu_torch.models.fibonacci import (
        FibonacciAir, generate_fibonacci_trace)
    from plonky3_tpu_torch.models.monolith_gl_air import (
        MonolithGoldilocksAir, generate_monolith_gl_trace)

    if name == "fibonacci":
        trace, publics = generate_fibonacci_trace(GLF, log_n, device=device)
        return FibonacciAir(GLF), trace, publics
    inputs = np.random.default_rng(1).integers(0, GLF.P, (1 << log_n, 8),
                                               dtype=np.uint64)
    return (MonolithGoldilocksAir(),
            generate_monolith_gl_trace(inputs, device=device), [])


def _gl_probes(config, air, proof, publics, names):
    """The port's verifier on `proof` (host time), then on each named
    change, which must be rejected."""
    from plonky3_tpu_torch.stark.verifier import verify

    t0 = time.perf_counter()
    verify(config, air, proof, publics)  # raises on a rejection
    verify_s = time.perf_counter() - t0
    changes = {"trace_local": (_bump_trace_value, (
        "OodEvaluationMismatch", "InvalidOpeningArgument")),
        "trace_root": (_bump_trace_root, ("InvalidOpeningArgument",))}
    tamper = {}
    for name in names:
        change, prefixes = changes[name]
        bad = copy.deepcopy(proof)
        change(bad, config.E)
        tamper[name] = rejected(name, lambda: verify(config, air, bad,
                                                     publics), prefixes)
    return verify_s, tamper


# gl_small's cases: (AIR, log2 rows)
GL_SMALL_CASES = (("fibonacci", 8),
                  ("monolith", GL_SMALL_MONOLITH_ROWS.bit_length() - 1))


def side_gl_small(np, torch, dev, name):
    """One gl_small case's prove_gl proof on `dev`, its seconds, and its
    config, AIR, proof and public values."""
    from plonky3_tpu_torch.fri.config import FriParameters
    from plonky3_tpu_torch.gl.stark import goldilocks_stark_config, prove_gl

    log_n = dict(GL_SMALL_CASES)[name]
    air, trace, publics = _gl_workload(np, name, dev, log_n)
    config = goldilocks_stark_config(FriParameters(**GL_SMALL_PARAMS),
                                     device=dev)
    t0 = time.perf_counter()
    proof = prove_gl(config, air, trace, publics)
    sync(torch, dev)
    return {"plain": as_plain(proof),
            "secs": {f"{name}_{dev}_s": time.perf_counter() - t0},
            "config": config, "air": air, "proof": proof, "publics": publics}


def phase_gl_small(torch, np):
    """The Goldilocks STARK at small size (goldilocks_stark_config,
    GL_SMALL_PARAMS): FibonacciAir at 256 rows and MonolithGoldilocksAir
    at GL_SMALL_MONOLITH_ROWS rows (its 3,536 columns, 884 permutations a
    row), prove_gl on the card equal to prove_gl on the CPU (plain
    versions, in a CPU worker); the card's proofs verified, a changed
    opened value rejected."""
    secs, tamper = {}, {}
    for name, _ in GL_SMALL_CASES:
        cuda = side_gl_small(np, torch, "cuda", name)
        secs.update(cuda["secs"])
        secs[f"{name}_verify_s"], probes = _gl_probes(
            cuda["config"], cuda["air"], cuda["proof"], cuda["publics"],
            ("trace_local",))
        tamper.update({f"{name}_{k}": v for k, v in probes.items()})
        cpu, cpu_secs, _ = cpu_side("side_gl_small", name)
        secs.update(cpu_secs)
        if cuda["plain"] != cpu:
            raise AssertionError(f"the Goldilocks {name} proof on CUDA "
                                 f"differs from the CPU's")
    emit({"phase": "gl_small", "fibonacci_rows": 256,
          "monolith_rows": GL_SMALL_MONOLITH_ROWS, "equal_cuda_cpu": True,
          "seconds": secs, "tamper": tamper})


def phase_gl_fibonacci(torch, np, kernels, card):
    """FibonacciAir over Goldilocks at 2^GL_FIB_LOG_N rows, the tall and
    narrow case (goldilocks_stark_config(new_benchmark())): one prove with
    spans and per-launch events, its launches, peak memory, verified, a
    changed trace root rejected. Returns launches and per-proof bounds."""
    from plonky3_tpu_torch.fri.config import FriParameters
    from plonky3_tpu_torch.gl.stark import goldilocks_stark_config, prove_gl

    t0 = time.perf_counter()
    air, trace, publics = _gl_workload(np, "fibonacci", "cuda",
                                       GL_FIB_LOG_N)
    gen_s = time.perf_counter() - t0
    config = goldilocks_stark_config(FriParameters.new_benchmark(),
                                     device="cuda")
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    spans = {}

    def run():
        t0 = time.perf_counter()
        proof = prove_gl(config, air, trace, publics, spans=spans)
        torch.cuda.synchronize()
        return proof, time.perf_counter() - t0

    (proof, prove_s), calls = recorded(torch, kernels, run)
    launches = _gl_launches(kernels, "gl_fibonacci")
    peak_mem = torch.cuda.max_memory_allocated()
    verify_s, tamper = _gl_probes(config, air, proof, publics,
                                  ("trace_root",))
    per_proof = launch_bounds(card, calls)
    emit({"phase": "gl_fibonacci", "rows": 1 << GL_FIB_LOG_N,
          "width": air.width, "trace_gen_s": gen_s,
          "cold_events_prove_s": prove_s, "peak_mem_bytes": peak_mem,
          "launches": launches, "verify_s": verify_s, "tamper": tamper,
          "proof_bytes": proof.size_in_bytes(), "spans": spans})
    emit({"phase": "gl_fibonacci_per_proof", "kernels": per_proof})
    return dict(launches=launches, per_proof=per_proof, device_ms={})


def phase_gl_monolith_air(torch, np, kernels, card):
    """MonolithGoldilocksAir at its full width (3,536 columns) over
    2^GL_MONOLITH_LOG_N permutations (a cut of depth from the CLI
    objectives' 2^17 rows, for the script's time), the trace generated on
    the card, under goldilocks_stark_config(new_benchmark()): a cold prove
    (per-launch events) and a warm one with spans, equal; launches, peak
    memory, the port's verify, two probes rejected, and a profiled prove
    (device busy share). Returns launches, per-proof bounds and the
    profile's device ms."""
    from plonky3_tpu_torch.fri.config import FriParameters
    from plonky3_tpu_torch.gl.stark import goldilocks_stark_config, prove_gl
    from plonky3_tpu_torch.models.monolith_gl_air import NUM_MONOLITH_GL_COLS

    n = 1 << GL_MONOLITH_LOG_N
    t0 = time.perf_counter()
    air, trace, _ = _gl_workload(np, "monolith", "cuda", GL_MONOLITH_LOG_N)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    if trace.shape != (n, NUM_MONOLITH_GL_COLS):
        raise AssertionError(f"MonolithGoldilocksAir trace "
                             f"{tuple(trace.shape)}")
    config = goldilocks_stark_config(FriParameters.new_benchmark(),
                                     device="cuda")
    timed = timer(torch, config, air, trace)
    torch.cuda.reset_peak_memory_stats()
    spans = {"cold": {}, "warm": {}}
    (first, cold_s), calls = recorded(
        torch, kernels, lambda: timed(prove_gl, spans=spans["cold"]))
    kernels.reset_launches()
    proof, warm_s = timed(prove_gl, spans=spans["warm"])
    launches = _gl_launches(kernels, "gl_monolith_air")
    peak_mem = torch.cuda.max_memory_allocated()
    if as_plain(first) != as_plain(proof):
        raise AssertionError("two MonolithGoldilocksAir proves differ")
    verify_s, tamper = _gl_probes(config, air, proof, [],
                                  ("trace_local", "trace_root"))
    per_proof = launch_bounds(card, calls)
    emit({"phase": "gl_monolith_air", "rows": n, "width": air.width,
          "perms": n, "cut": f"depth 2^{GL_MONOLITH_LOG_N} rows",
          "trace_gen_s": gen_s, "cold_events_prove_s": cold_s,
          "warm_prove_s": warm_s, "perms_per_s": n / warm_s,
          "peak_mem_bytes": peak_mem, "launches": launches,
          "equal_proofs": 2, "verify_s": verify_s, "tamper": tamper,
          "proof_bytes": proof.size_in_bytes(), "spans": spans})
    emit({"phase": "gl_monolith_air_per_proof", "kernels": per_proof})
    device_ms = profile_prove(torch, kernels, prove_gl, config, air, trace,
                              warm_s, phase="gl_monolith_air_profile")
    return dict(launches=launches, per_proof=per_proof, device_ms=device_ms)


# ---------------------------------------------------------------------------
# M21: STIR, WHIR and the multilinear STARK
# ---------------------------------------------------------------------------
# the CLI's pcs-comparison at full size: 2^18 x 16, blowup 4, 100 bits, the
# WHIR codeword 2^24 rows (KoalaBear's two-adicity). 20 PoW bits: at 16
# (and 12) the reference's STIR schedule (StirConfig.new, capacity bound)
# refuses a degree of 2^18 (round 4's eta exceeds its side condition), and
# so does the port's, which copies it
PCS_ARGS = dict(field="koala-bear", log_trace_length=18, width=16,
                fri="benchmark", log_blowup=2, log_folding_factor=2,
                security_level=100, max_pow_bits=20)
PCS_CLI_ARGS = ("pcs-comparison", "--log-trace-length", "18", "--width",
                "16", "--fri", "benchmark", "--security-level", "100",
                "--max-pow-bits", "20")
MS_LOG_N = 20  # FibonacciAir rows of the multi_stark phase
M21_PATH = ("ntt_k1", "ntt_k2", "poseidon2_grind")
# the NTT shapes of the M21 paths held bit for bit in the kernels phase:
# WHIR's commit of the CLI's 2^22-coefficient MLE (one column, 2^24 rows)
# and the multi_stark phase's first extension round (2^20 coefficients of
# D = 4 columns onto 2^22 rows); hiding WHIR's mask codeword (2^22 ext
# coefficients onto 2^24 rows of D = 4 columns); STIR's LDE (2^18 x 16
# onto 2^20) beside
M21_NTT_CASES = ((24, 1, False, False, "whir_commit"),
                 (24, 4, False, False, "hiding_mask"),
                 (22, 4, False, False, "whir_ext_round"),
                 (18, 16, True, False, "stir_idft"),
                 (20, 16, False, True, "stir_lde"))


def _plan_timed(torch, card, nc, F, x, log_n, inverse, zero_top):
    """Each launch of `nc.plan` run and timed alone (torch.profiler) from
    its own buffers: {"k1"/"k2": [launches, ms, bound ms]}."""
    steps = nc.plan(log_n, zero_top)
    n = 1 << log_n
    bufs = [torch.empty((n, x.shape[1]), dtype=torch.int32, device=x.device)
            for _ in range(2)]
    out = {"k1": [0, 0.0, 0.0], "k2": [0, 0.0, 0.0]}
    src = x
    for i, step in enumerate(steps):
        dst = bufs[i % 2]
        ms, _ = profiled_ms(
            torch, lambda s=step, a=src, b=dst: nc.launch(F, s, a, b, inverse),
            5, "ntt_kernel<")
        b = ntt_bound(card, step.kernel, step.log_a, step.log_b, x.shape[1],
                      step.zero_top, step.batch)
        acc = out[step.kernel]
        acc[0] += 1
        acc[1] += ms
        acc[2] += b[0]
        src = dst
    return out


def phase_kernels_m21(torch, np, card, records):
    """K1/K2 at the M21 paths' shapes (M21_NTT_CASES) against the plain
    version, bit for bit, with the launches of `ntt_cuda.plan`, each
    launch's time and bound (`*_<path>` keys of the ntt records)."""
    from plonky3_tpu_torch import kernels
    from plonky3_tpu_torch.fields import KoalaBear as F
    from plonky3_tpu_torch.ops import ntt_cuda as nc

    for log_n, w, inverse, zero_top, path in M21_NTT_CASES:
        rows = (1 << log_n) >> 1 if zero_top else 1 << log_n
        x = _rand_words_device(torch, log_n + w, (rows, w), F.P)
        before = dict(kernels.LAUNCHES)
        t0 = time.perf_counter()
        got = nc.dif_fused(F, x, log_n, inverse, zero_top)
        torch.cuda.synchronize()
        call_s = time.perf_counter() - t0
        ran = {k: kernels.LAUNCHES[k] - before[k]
               for k in ("ntt_k1", "ntt_k2")}
        planned = {f"ntt_{k}": sum(s.kernel == k for s in nc.plan(
            log_n, zero_top)) for k in ("k1", "k2")}
        if ran != planned:
            raise AssertionError(f"ntt {log_n} {w}: launched {ran}, "
                                 f"planned {planned}")
        want, plain = once_ms(torch, lambda: nc.dif_fused_plain(
            F, x, log_n, inverse, zero_top))
        err = compare(f"ntt {log_n} {w}", got, want)
        del want, got
        per = _plan_timed(torch, card, nc, F, x, log_n, inverse, zero_top)
        rec = {"log_n": log_n, "w": w, "inverse": inverse,
               "zero_top": zero_top, "path": path, "max_abs_err": err,
               "k1_launches": ran["ntt_k1"], "k2_launches": ran["ntt_k2"],
               "first_call_s": call_s, "plain_ms": plain}
        for k in ("k1", "k2"):
            n_l, ms, b = per[k]
            sh = share(f"ntt_{k} {log_n} {w}", b, ms)
            rec.update({f"{k}_ms": ms, f"{k}_bound_ms": b,
                        f"{k}_share": sh})
            records[f"ntt_{k}"].update({
                f"max_abs_err_{path}": err, f"ms_{path}": ms,
                f"plain_ms_{path}": plain, f"bound_ms_{path}": b,
                f"share_{path}": sh, f"launches_plan_{path}": n_l,
                f"shape_{path}": [log_n, w, "zero_top" if zero_top
                                  else ("inverse" if inverse else "forward")]})
        emit({"phase": "kernels", "kernel": "ntt_m21", **rec})
        del x


def _logged_grinds(make):
    """(a challenger factory like `make` whose grinds of more than 0 bits
    append their witnesses to a list, the list): launch_bounds reads the
    witnesses in launch order."""
    found = []

    def challenger():
        ch = make()
        real = ch.grind

        def grind(bits, **kw):
            w = real(bits, **kw)
            if bits:
                found.append(w)
            return w

        ch.grind = grind
        return ch

    return challenger, found


def _m21_launches(kernels, phase):
    """The launches since the last reset: K1, K2 and the Poseidon2 grind
    each at least once, nothing else."""
    launched = {k: v for k, v in kernels.LAUNCHES.items() if v}
    missing = [k for k in M21_PATH if not launched.get(k)]
    stray = sorted(set(launched) - set(M21_PATH))
    if missing or stray:
        raise AssertionError(f"{phase}: launches {launched} (missing "
                             f"{missing}, stray {stray})")
    return launched


def _bump(e, P):
    return tuple((c + 1) % P for c in e)


def _pcs_probes(name, P):
    """The probes of a pcs_comparison proof: a changed opened value and a
    changed query row, each as (change, the class and message the
    verifier must raise). The classes are the reference's for the same
    tampers (tests/test_torch_stir.py, tests/test_torch_whir.py); the
    messages are those of this schedule (2^18 x 16, 20 PoW bits)."""
    def stir_value(run):
        run["value"] = [_bump(run["value"][0], P)] + list(run["value"][1:])

    def stir_row(run):
        rows_pq = run["proof"][0].input_openings[0][0]
        rows_pq[0][0][0] = (int(rows_pq[0][0][0]) + 1) % P

    def whir_value(run):
        run["value"] = _bump(run["value"], P)

    def whir_row(run):
        g = run["proof"].rounds[0].query_values
        first = g[0][0]
        g[0] = [((first[0] + 1) % P,) + tuple(first[1:])] + list(g[0][1:])

    if name == "stir":
        return {"opened_value": (stir_value, ("InvalidPowWitness",
                                              "round 0 folding PoW")),
                "query_row": (stir_row, ("StirError",
                                         "input opening rejected"))}
    return {"opened_value": (whir_value, ("WhirError",
                                          "SumcheckClaimMismatch")),
            "query_row": (whir_row, ("WhirError", "MmcsError"))}


def run_pcs_cli(torch):
    """The CLI's pcs-comparison at full size in its own process: exit 0,
    the header, the FRI, STIR and WHIR lines and WHIR's soundness line.
    Returns each scheme's numbers from its line."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()  # the child process needs the card's memory
    cmd = [sys.executable, "-m", "plonky3_tpu_torch.cli", *PCS_CLI_ARGS]
    t0 = time.perf_counter()
    run = subprocess.run(cmd, capture_output=True, text=True, timeout=900,
                         cwd=Path(__file__).resolve().parent)
    secs = time.perf_counter() - t0
    lines = run.stdout.splitlines()
    if run.returncode != 0:
        raise AssertionError(f"the CLI exited {run.returncode}:\n"
                             f"{run.stdout[-2000:]}\n{run.stderr[-4000:]}")
    got = {}
    for ln in lines:
        m = re.match(r"  (fri|stir|whir) +commit\+open +([\d.]+) ms +verify "
                     r"+([\d.]+) ms +proof (\d+) bytes$", ln)
        if m:
            got[m[1]] = {"prove_ms": float(m[2]), "verify_ms": float(m[3]),
                         "proof_bytes": int(m[4])}
    if (lines[:1] != ["pcs comparison: 2^18 x 16 koala-bear matrix, 1 "
                      "opening point"] or sorted(got) != ["fri", "stir",
                                                          "whir"]
            or not any(ln.lstrip().startswith("whir soundness (johnson, "
                                              "target 100b)")
                       for ln in lines)):
        raise AssertionError(f"the CLI's report lacks a line: {lines}")
    emit({"phase": "pcs_comparison_cli", "argv": cmd[1:], "rc": 0,
          "seconds": secs, "schemes": got, "stdout": lines})
    return got


def phase_pcs_comparison(torch, np, kernels, card):
    """The CLI's pcs-comparison at 2^18 x 16 in its own process, then STIR
    and WHIR in this process on the same matrix and point (cli.pcs_job):
    a cold prove with per-launch events and spans, a warm one equal to it,
    the port's verifier accepting it and rejecting the two probes, and a
    profiled prove for the device's idle share. Returns, per scheme, the
    launches and per-proof bounds."""
    from plonky3_tpu_torch import cli

    run_pcs_cli(torch)
    job = cli.pcs_job(**PCS_ARGS, device="cuda")
    job.challenger, found = _logged_grinds(job.challenger)
    out = {}
    for name in ("stir", "whir"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        kernels.reset_launches()
        found.clear()
        spans = {}

        def run(spans=None):
            t0 = time.perf_counter()
            got = cli.prove_pcs(job, name, spans=spans)
            torch.cuda.synchronize()
            return got, time.perf_counter() - t0

        (cold, cold_s), calls = recorded(torch, kernels,
                                         lambda: run(spans))
        launches = _m21_launches(kernels, f"pcs_{name}")
        peak = torch.cuda.max_memory_allocated() - held
        cold_found = list(found)
        per_proof = launch_bounds(card, calls, cold_found)
        warm_spans = {}
        warm, warm_s = run(warm_spans)
        if as_plain((warm["commit"], warm["value"], warm["proof"])) != (
                as_plain((cold["commit"], cold["value"], cold["proof"]))):
            raise AssertionError(f"pcs {name}: the warm proof differs")
        t0 = time.perf_counter()
        cli.verify_pcs(job, name, cold)
        verify_s = time.perf_counter() - t0
        tamper = {}
        for probe, (change, expected) in _pcs_probes(name,
                                                     job.F.P).items():
            bad = copy.deepcopy(cold)
            change(bad)
            try:
                cli.verify_pcs(job, name, bad)
            except Exception as e:  # noqa: BLE001 (its class is checked)
                if (type(e).__name__, str(e)) != expected:
                    raise AssertionError(
                        f"pcs {name}: the probe {probe} raised "
                        f"{type(e).__name__}({e}), not {expected}") from e
                tamper[probe] = {"raised": type(e).__name__,
                                 "message": str(e)}
            else:
                raise AssertionError(f"pcs {name}: the probe {probe} was "
                                     f"accepted")
        prof = _profile(torch, lambda: cli.prove_pcs(job, name))
        rows = device_records(prof)
        busy_s = sum(r[0] for r in rows) / 1e6
        device_ms = collections.Counter()
        for us, k, c in rows:
            for kname, tags in PROFILE_NAMES.items():
                if kname in M21_PATH and all(t in k for t in tags):
                    device_ms[kname] += us / 1e3
        emit({"phase": f"pcs_{name}", "rows": 1 << job.log_n,
              "width": job.width, "cold_prove_s": cold_s,
              "warm_prove_s": warm_s, "verify_s": verify_s,
              "peak_mem_bytes": peak, "launches": launches,
              "grind_witnesses": cold_found,
              "proof_bytes": cli.proof_bytes(cold["proof"]),
              "spans": spans, "warm_spans": warm_spans, "tamper": tamper,
              "device_busy_s": busy_s,
              "device_idle_share": 1 - busy_s / warm_s,
              "top": [{"kernel": k[:70], "ms": us / 1e3, "calls": c}
                      for us, k, c in rows[:10]],
              "device_ms": dict(device_ms)})
        emit({"phase": f"pcs_{name}_per_proof", "kernels": per_proof})
        out[name] = dict(launches=launches, per_proof=per_proof,
                         device_ms=dict(device_ms))
        del cold, warm
    return out


def _ms_setup(F, E, n_vars, small=False):
    """The multi_stark phase's WHIR PCS: the reference tests' Poseidon2
    MMCS and WhirConfig.from_security(100, johnson, n_vars, 4 x 31 field
    bits, blowup 4, k 2, 16 PoW bits); `small`: the m21_small schedule
    (8 queries, 1 OOD sample, 8 PoW bits a round, as
    tests/test_torch_cuda.py), whose CPU half grinds in seconds."""
    from plonky3_tpu_torch.hashes.poseidon2 import default_poseidon2
    from plonky3_tpu_torch.hashes.sponge import (PaddingFreeSponge,
                                                 TruncatedPermutation)
    from plonky3_tpu_torch.merkle.extension_mmcs import ExtensionMmcs
    from plonky3_tpu_torch.merkle.mmcs import MerkleTreeMmcs
    from plonky3_tpu_torch.multilinear.whir import WhirConfig, WhirPcs

    mmcs = MerkleTreeMmcs(
        sponge=PaddingFreeSponge(default_poseidon2(F, 24), rate=16, out=8),
        compressor=TruncatedPermutation(default_poseidon2(F, 16), chunk=8))
    if small:
        cfg = WhirConfig(log_blowup=2, folding_factor=2,
                         final_vars=2 + n_vars % 2, num_queries=8,
                         ood_samples=1, pow_bits=8)
    else:
        cfg = WhirConfig.from_security(100, "johnson", n_vars,
                                       field_bits=4 * 31, log_blowup=2,
                                       folding_factor=2, max_pow_bits=16)
    return WhirPcs(F=F, E=E, config=cfg, mmcs=mmcs,
                   fri_mmcs=ExtensionMmcs(inner=mmcs, D=E.D))


def phase_multi_stark(torch, np, kernels, card):
    """FibonacciAir at 2^MS_LOG_N rows through prove_multi_stark over
    WHIR (the stacked MLE 2^(MS_LOG_N+1) entries): one prove with
    per-launch events and spans, its launches and peak memory,
    verify_multi_stark, and a changed public value rejected. Returns the
    launches and per-proof bounds."""
    from plonky3_tpu_torch.challenger.duplex import DuplexChallenger
    from plonky3_tpu_torch.cli import proof_bytes
    from plonky3_tpu_torch.fields import KoalaBear as F
    from plonky3_tpu_torch.fields import KoalaBearExt4 as E
    from plonky3_tpu_torch.hashes.poseidon2 import default_poseidon2
    from plonky3_tpu_torch.models.fibonacci import (FibonacciAir,
                                                    generate_fibonacci_trace)
    from plonky3_tpu_torch.multilinear import multi_stark as ms

    t0 = time.perf_counter()
    trace, publics = generate_fibonacci_trace(F, MS_LOG_N, device="cuda")
    gen_s = time.perf_counter() - t0
    air = FibonacciAir(F)
    pcs = _ms_setup(F, E, MS_LOG_N + 1)
    pk, vk = ms.setup(pcs, air)
    challenger, found = _logged_grinds(lambda: DuplexChallenger(
        default_poseidon2(F, 24), device="cuda", rate=16))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    kernels.reset_launches()
    spans = {}

    def run():
        t0 = time.perf_counter()
        proof = ms.prove_multi_stark(pcs, air, trace, publics, challenger(),
                                     pk=pk, spans=spans)
        torch.cuda.synchronize()
        return proof, time.perf_counter() - t0

    (proof, prove_s), calls = recorded(torch, kernels, run)
    launches = _m21_launches(kernels, "multi_stark")
    peak = torch.cuda.max_memory_allocated() - held
    per_proof = launch_bounds(card, calls, list(found))
    t0 = time.perf_counter()
    ms.verify_multi_stark(pcs, air, proof, publics,
                          DuplexChallenger(default_poseidon2(F, 24),
                                           rate=16), vk=vk)
    verify_s = time.perf_counter() - t0
    bad = list(publics)
    bad[2] = (bad[2] + 1) % F.P
    # the reference's class and message for this tamper
    # (tests/test_torch_multilinear.py::
    # test_changed_public_value_rejected_by_both, the same at 2^5 rows)
    expected = ("ValueError", "SumcheckRoundMismatch round 1")
    try:
        ms.verify_multi_stark(pcs, air, proof, bad,
                              DuplexChallenger(default_poseidon2(F, 24),
                                               rate=16))
    except Exception as e:  # noqa: BLE001 (its class is checked)
        if (type(e).__name__, str(e)) != expected:
            raise AssertionError(f"multi_stark: a changed public value "
                                 f"raised {type(e).__name__}({e}), not "
                                 f"{expected}") from e
        tamper = {"public_value": {"raised": type(e).__name__,
                                   "message": str(e)}}
    else:
        raise AssertionError("multi_stark: a changed public value was "
                             "accepted")
    cfg = pcs.config
    emit({"phase": "multi_stark", "rows": 1 << MS_LOG_N, "width": air.width,
          "mle_vars": MS_LOG_N + 1, "trace_gen_s": gen_s,
          "cold_events_prove_s": prove_s, "peak_mem_bytes": peak,
          "launches": launches, "verify_s": verify_s, "tamper": tamper,
          "whir_rounds": cfg.num_rounds(MS_LOG_N + 1),
          "whir_queries": list(cfg.round_queries),
          "whir_pow_bits": list(cfg.round_pow_bits),
          "proof_bytes": proof_bytes(proof), "spans": spans})
    emit({"phase": "multi_stark_per_proof", "kernels": per_proof})
    return dict(launches=launches, per_proof=per_proof, device_ms={})


M21_SMALL = ("stir", "whir", "multi_stark")


def _m21_small_proof(np, torch, dev, name):
    """A small STIR PCS (2^8 x 8), WHIR (n_vars 10) or multilinear
    FibonacciAir (2^8 rows) proof on `dev` from seeded inputs, with the
    verifier's inputs: (proof, verify())."""
    from plonky3_tpu_torch.challenger.duplex import DuplexChallenger
    from plonky3_tpu_torch.fields import KoalaBear as F
    from plonky3_tpu_torch.fields import KoalaBearExt4 as E
    from plonky3_tpu_torch.hashes.poseidon2 import default_poseidon2
    from plonky3_tpu_torch.models.fibonacci import (FibonacciAir,
                                                    generate_fibonacci_trace)
    from plonky3_tpu_torch.multilinear import multi_stark as ms
    from plonky3_tpu_torch.stir import StirParameters
    from plonky3_tpu_torch.stir.pcs import TwoAdicStirPcs

    def ch():
        return DuplexChallenger(default_poseidon2(F, 24), device=dev,
                                rate=16)

    rng = np.random.default_rng(21)
    if name == "stir":
        whir = _ms_setup(F, E, 10, small=True)  # for its MMCS
        pcs = TwoAdicStirPcs(F=F, E=E, params=StirParameters(
            log_blowup=2, log_folding_factor=2, security_level=60,
            max_pow_bits=12), mmcs=whir.mmcs, stir_mmcs=whir.fri_mmcs)
        evals = torch.from_numpy(F.rand_np(rng, (256, 8)).astype(
            np.int64)).to(dev)
        z = E.rand_h(rng)
        domain = pcs.natural_domain_for_degree(256)
        data = pcs.commit([(domain, evals)])
        c = ch()
        c.observe_many(data.root_std)
        opened, proof = pcs.open([(data, [[z]])], c)

        def verify():
            v = ch()
            v.observe_many(data.root_std)
            pcs.verify([(data.root_std, [(domain, [(z, opened[0][0][0])])])],
                       proof, v)

        return (data.root_std, opened, proof), verify
    if name == "whir":
        pcs = _ms_setup(F, E, 10, small=True)
        evals = torch.from_numpy(F.rand_np(rng, (1 << 10,), monty=False)
                                 .astype(np.int64)).to(dev)
        point = [E.rand_h(rng) for _ in range(10)]
        commit, data = pcs.commit(evals)
        c = ch()
        c.observe_digest(commit)
        value, proof = pcs.open(data, point, c)

        def verify():
            v = ch()
            v.observe_digest(commit)
            pcs.verify(commit, 10, point, value, proof, v)

        return (commit, value, proof), verify
    pcs = _ms_setup(F, E, 9, small=True)
    trace, publics = generate_fibonacci_trace(F, 8, device=dev)
    air = FibonacciAir(F)
    proof = ms.prove_multi_stark(pcs, air, trace, publics, ch())
    return proof, lambda: ms.verify_multi_stark(pcs, air, proof, publics,
                                                ch())


def side_m21_small(np, torch, dev, name):
    """The small M21 proof `name` on `dev`; on the CPU it is verified
    (VERIFY_ONCE)."""
    t0 = time.perf_counter()
    proof, verify = _m21_small_proof(np, torch, dev, name)
    sync(torch, dev)
    secs = {f"{name}_{dev}_prove_s": time.perf_counter() - t0}
    if dev == "cpu":
        t0 = time.perf_counter()
        verify()
        secs[f"{name}_verify_s"] = time.perf_counter() - t0
    return {"plain": as_plain(proof), "secs": secs}


def phase_m21_small(torch, np):
    """STIR at 2^8 x 8, WHIR at n_vars 10 and the multilinear FibonacciAir
    at 2^8 rows: each CUDA proof equals the CPU's (plain versions, in a
    CPU worker, where each is verified once)."""
    from plonky3_tpu_torch import kernels

    secs, launched = {}, {}
    for name in M21_SMALL:
        kernels.reset_launches()
        cuda = side_m21_small(np, torch, "cuda", name)
        launched[name] = {k: v for k, v in kernels.LAUNCHES.items() if v}
        cpu, cpu_secs, _ = cpu_side("side_m21_small", name)
        secs.update(cuda["secs"], **cpu_secs)
        if cuda["plain"] != cpu:
            raise AssertionError(f"the small {name} proofs differ")
        if not launched[name].get("ntt_k1"):
            raise AssertionError(f"the small {name} proof launched no K1")
    emit({"phase": "m21_small", "equal": list(M21_SMALL),
          "launches": launched, "secs": secs})



# ---------------------------------------------------------------------------
# M21's rest and M22: hiding WHIR, the masked zerocheck, the sharded LDE and
# tree, the host hashes in C
# ---------------------------------------------------------------------------
HW_LOG_N = 21  # the witness MLE's variables: the extended polynomial 2^22
HW_SEED = 5
MZ_LOG_N = 20  # FibonacciAir rows of the masked_zerocheck phase
SHARDED_WORLD = 2  # ranks on the one card, over gloo


def _whir_schedule(n_vars):
    from plonky3_tpu_torch.multilinear.whir import WhirConfig

    return WhirConfig.from_security(100, "johnson", n_vars,
                                    field_bits=4 * 31, log_blowup=2,
                                    folding_factor=2, max_pow_bits=16)


def _hiding_pcs(F, E, cfg):
    """A HidingWhirPcs over the multi_stark phase's Poseidon2 MMCS."""
    from plonky3_tpu_torch.multilinear.hiding_whir import HidingWhirPcs

    base = _ms_setup(F, E, 10, small=True)
    return HidingWhirPcs(F=F, E=E, config=cfg, mmcs=base.mmcs,
                         fri_mmcs=base.fri_mmcs)


def _probe(what, fn, expected):
    """fn() must raise the (class name, message) `expected`."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001 (its class is checked)
        if (type(e).__name__, str(e)) != expected:
            raise AssertionError(f"{what} raised {type(e).__name__}({e}), "
                                 f"not {expected}") from e
        return {"raised": type(e).__name__, "message": str(e)}
    raise AssertionError(f"{what} was accepted")


def phase_hiding_whir(torch, np, kernels, card):
    """HidingWhirPcs at full width: a 2^HW_LOG_N-evaluation MLE (seeded
    default_rng), the extended polynomial 2^(HW_LOG_N+1) coefficients, both
    codewords 2^24 rows at blowup 4 (KoalaBear's two-adicity: the largest
    hiding commit), WhirConfig.from_security(100, johnson, 22, blowup 4, k
    2, 16 PoW bits). commit_hiding + open_hiding cold (per-launch events,
    spans), warm (equal), profiled (idle share); launches (K1, K2, the
    <23, 3> grind, nothing else), peak memory; verify_hiding accepts, a
    changed value and a changed round-0 mask row are rejected with the
    reference's classes."""
    from plonky3_tpu_torch.challenger.duplex import DuplexChallenger
    from plonky3_tpu_torch.cli import proof_bytes
    from plonky3_tpu_torch.fields import KoalaBear as F
    from plonky3_tpu_torch.fields import KoalaBearExt4 as E
    from plonky3_tpu_torch.hashes.poseidon2 import default_poseidon2

    cfg = _whir_schedule(HW_LOG_N + 1)
    pcs = _hiding_pcs(F, E, cfg)
    rng0 = np.random.default_rng(HW_SEED)
    evals = torch.from_numpy(F.rand_np(rng0, (1 << HW_LOG_N,), monty=False)
                             .astype(np.int64)).to("cuda")
    point = [E.rand_h(rng0) for _ in range(HW_LOG_N)]
    challenger, found = _logged_grinds(lambda: DuplexChallenger(
        default_poseidon2(F, 24), device="cuda", rate=16))

    def run(spans=None):
        rng = np.random.default_rng(HW_SEED + 1)
        t0 = time.perf_counter()
        commit, data = pcs.commit_hiding(evals, rng, spans=spans)
        ch = challenger()
        ch.observe_digest(commit)
        value, proof = pcs.open_hiding(data, point, ch, rng, spans=spans)
        torch.cuda.synchronize()
        return (commit, value, proof), time.perf_counter() - t0

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    kernels.reset_launches()
    spans = {}
    (cold, cold_s), calls = recorded(torch, kernels, lambda: run(spans))
    launches = _m21_launches(kernels, "hiding_whir")
    peak = torch.cuda.max_memory_allocated() - held
    per_proof = launch_bounds(card, calls, list(found))
    warm_spans = {}
    warm, warm_s = run(warm_spans)
    if as_plain(warm) != as_plain(cold):
        raise AssertionError("hiding_whir: the warm proof differs")
    prof = _profile(torch, run)
    busy_s = sum(r[0] for r in device_records(prof)) / 1e6
    commit, value, proof = cold

    def verify(v=value, p=proof):
        ch = DuplexChallenger(default_poseidon2(F, 24), rate=16)
        ch.observe_digest(commit)
        pcs.verify_hiding(commit, HW_LOG_N, point, v, p, ch)

    t0 = time.perf_counter()
    verify()
    verify_s = time.perf_counter() - t0
    bad = copy.deepcopy(proof)
    q = list(bad.inner.rounds[0].query_proof)
    q[3] = copy.deepcopy(q[3])
    q[3][0][0] = _bump(q[3][0][0], F.P)
    bad.inner.rounds[0].query_proof = tuple(q)
    # the classes and messages of tests/test_torch_hiding_whir.py's tampers
    tamper = {"value": _probe("hiding_whir: a changed value",
                              lambda: verify(v=_bump(value, F.P)),
                              ("WhirError", "SumcheckClaimMismatch")),
              "mask_row": _probe("hiding_whir: a changed mask row",
                                 lambda: verify(p=bad),
                                 ("WhirError", "MmcsError"))}
    del bad
    emit({"phase": "hiding_whir", "witness_vars": HW_LOG_N,
          "extended_coeffs": 1 << (HW_LOG_N + 1),
          "codeword_rows": 1 << (HW_LOG_N + 1 + cfg.log_blowup),
          "whir_rounds": cfg.num_rounds(HW_LOG_N + 1),
          "whir_queries": list(cfg.round_queries),
          "whir_pow_bits": list(cfg.round_pow_bits),
          "cold_events_s": cold_s, "warm_s": warm_s, "verify_s": verify_s,
          "peak_mem_bytes": peak, "launches": launches,
          "grind_witnesses": list(found), "spans": spans,
          "warm_spans": warm_spans, "device_busy_s": busy_s,
          "device_idle_share": 1 - busy_s / warm_s, "tamper": tamper,
          "proof_bytes": proof_bytes(proof)})
    emit({"phase": "hiding_whir_per_proof", "kernels": per_proof})
    return dict(launches=launches, per_proof=per_proof, device_ms={})


def _mask_pcs(F, E, log_n, small=False):
    """The masked zerocheck's mask PCS, sized by `_mask_layout` as
    tests/test_zk_multilinear.py::_mask_pcs_for sizes it: 100 bits
    (WhirConfig.from_security, johnson, blowup 4, k 2, 16 PoW bits), or
    `small`, that test's schedule (6 queries, 1 OOD sample, 1 PoW bit)."""
    from plonky3_tpu_torch.multilinear.whir import WhirConfig
    from plonky3_tpu_torch.multilinear.zk_sumcheck import _mask_layout

    _, _, _, flat_len = _mask_layout(E, log_n, 4)
    n1 = flat_len.bit_length()  # the committed variables, the zk one too
    cfg = (WhirConfig(log_blowup=2, folding_factor=2,
                      final_vars=n1 % 2 if n1 % 2 else 2, num_queries=6,
                      ood_samples=1, pow_bits=1)
           if small else _whir_schedule(n1))
    return _hiding_pcs(F, E, cfg)


def _mz_setup(np, dev, log_n, small, challenger=None):
    """A FibonacciAir masked zerocheck at 2^log_n rows on `dev`, its trace
    and mask PCS built here: (prove(spans, seed) -> proof, publics,
    verify(proof)). The prover's transcript comes from `challenger()`,
    default a duplex transcript that grinds on `dev`."""
    from plonky3_tpu_torch.challenger.duplex import DuplexChallenger
    from plonky3_tpu_torch.fields import KoalaBear as F
    from plonky3_tpu_torch.fields import KoalaBearExt4 as E
    from plonky3_tpu_torch.hashes.poseidon2 import default_poseidon2
    from plonky3_tpu_torch.models.fibonacci import (FibonacciAir,
                                                    generate_fibonacci_trace)
    from plonky3_tpu_torch.multilinear.zk_sumcheck import (
        prove_masked_zerocheck, verify_masked_zerocheck)

    def ch(device="cpu"):
        return DuplexChallenger(default_poseidon2(F, 24), device=device,
                                rate=16)

    trace, publics = generate_fibonacci_trace(F, log_n, device=dev)
    air = FibonacciAir(F)
    pcs = _mask_pcs(F, E, log_n, small)

    def prove(spans=None, seed=11):
        return prove_masked_zerocheck(
            E, air, trace, publics, (challenger or (lambda: ch(dev)))(),
            pcs, np.random.default_rng(seed), spans=spans)

    return prove, publics, lambda p: verify_masked_zerocheck(
        E, air, log_n, publics, p, ch(), pcs)


def phase_masked_zerocheck(torch, np, kernels, card):
    """FibonacciAir at 2^MZ_LOG_N rows (as multi_stark) through
    prove_masked_zerocheck, the mask PCS at 100 bits, the trace and the
    PCS built before the clock starts: one cold prove with spans and
    per-launch events, its launches and peak memory, a warm prove with
    spans (equal to the cold one); verify_masked_zerocheck accepts, a
    changed wire is rejected."""
    from plonky3_tpu_torch.challenger.duplex import DuplexChallenger
    from plonky3_tpu_torch.cli import proof_bytes
    from plonky3_tpu_torch.fields import KoalaBear as F
    from plonky3_tpu_torch.hashes.poseidon2 import default_poseidon2

    challenger, found = _logged_grinds(lambda: DuplexChallenger(
        default_poseidon2(F, 24), device="cuda", rate=16))
    t0 = time.perf_counter()
    prove, publics, verify = _mz_setup(np, "cuda", MZ_LOG_N, False,
                                       challenger=challenger)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    kernels.reset_launches()

    def run(spans):
        t0 = time.perf_counter()
        out = prove(spans)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    spans = {}
    (proof, prove_s), calls = recorded(torch, kernels, lambda: run(spans))
    launches = _m21_launches(kernels, "masked_zerocheck")
    peak = torch.cuda.max_memory_allocated() - held
    per_proof = launch_bounds(card, calls, list(found))
    warm_spans = {}
    warm, warm_s = run(warm_spans)
    if as_plain(warm) != as_plain(proof):
        raise AssertionError("masked_zerocheck: the warm proof differs")
    del warm
    t0 = time.perf_counter()
    verify(proof)
    verify_s = time.perf_counter() - t0
    bad = copy.deepcopy(proof)
    bad.rounds[0] = [_bump(bad.rounds[0][0], F.P)] + list(bad.rounds[0][1:])
    tamper = {"wire": _probe("masked_zerocheck: a changed wire",
                             lambda: verify(bad),
                             ("ValueError", "MaskedRoundMismatch round 0"))}
    emit({"phase": "masked_zerocheck", "rows": 1 << MZ_LOG_N,
          "setup_s": setup_s, "prove_events_s": prove_s,
          "warm_prove_s": warm_s, "verify_s": verify_s,
          "peak_mem_bytes": peak, "launches": launches, "spans": spans,
          "warm_spans": warm_spans, "tamper": tamper,
          "rounds": len(proof.rounds), "proof_bytes": proof_bytes(proof)})
    emit({"phase": "masked_zerocheck_per_proof", "kernels": per_proof})
    return dict(launches=launches, per_proof=per_proof, device_ms={})


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _ntt_launches(card, calls):
    """Each K1/K2 launch of `recorded` calls: its four-step split, width,
    slabs, device ms (events) and bound."""
    out = []
    for fn, a, ms in calls:
        if fn in ("ntt_k1", "ntt_k2"):
            k1 = fn == "ntt_k1"
            log_a, log_b, w, batch = (a[4], a[5], a[6], a[8]) if k1 else (
                a[3], a[4], a[5], a[6])
            b = ntt_bound(card, fn[4:], log_a, log_b, w, k1 and bool(a[7]),
                          batch)
            out.append({"kernel": fn, "log_a": log_a, "log_b": log_b,
                        "w": w, "batch": batch, "ms": ms,
                        "bound_ms": b[0], "bound_by": b[1]})
    return out


def _sharded_case(torch, F, mmcs, local, ab, group, want_lde, want_layers,
                  card, turns=("cold", "warm")):
    """The sharded LDE of this rank's block and the sharded tree of its
    LDE block, each against the single-device rows it must equal; their
    wall seconds and launches, the cold turn's K1/K2 launches by events
    with their bounds."""
    from plonky3_tpu_torch import kernels
    from plonky3_tpu_torch.parallel import world_rank
    from plonky3_tpu_torch.parallel.merkle import sharded_tree_layers
    from plonky3_tpu_torch.parallel.ntt import coset_lde_batch_sharded

    world, rank = world_rank(group)
    out = {}
    for turn in turns:
        kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if turn == "cold":
            lde, calls = recorded(torch, kernels, lambda: (
                coset_lde_batch_sharded(F, local, ab, F.GENERATOR, group)))
            out["ntt_launches"] = _ntt_launches(card, calls)
        else:
            lde = coset_lde_batch_sharded(F, local, ab, F.GENERATOR, group)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        layers = sharded_tree_layers(mmcs, lde, group)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        out[f"{turn}_lde_s"], out[f"{turn}_tree_s"] = t1 - t0, t2 - t1
        out[f"{turn}_launches"] = {k: v for k, v in kernels.LAUNCHES.items()
                                   if v}
    m = lde.shape[0]
    equal = torch.equal(lde, want_lde[rank * m:(rank + 1) * m])
    for got, want in zip(layers, want_layers):
        if want.shape[0] >= world:
            k = want.shape[0] // world
            want = want[rank * k:(rank + 1) * k]
        equal = equal and torch.equal(got, want)
    out["equal"] = bool(equal and len(layers) == len(want_layers))
    return out


def _single_device(torch, F, mmcs, trace, ab):
    """The single-device coset LDE and tree, timed (after a warm-up)."""
    from plonky3_tpu_torch.merkle.mmcs import _build_layers
    from plonky3_tpu_torch.ops.ntt import coset_lde_batch

    secs = {}
    for turn in ("cold", "warm"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lde = coset_lde_batch(F, trace, ab, F.GENERATOR)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        layers = _build_layers(mmcs, [lde])
        torch.cuda.synchronize()
        secs[f"{turn}_lde_s"] = t1 - t0
        secs[f"{turn}_tree_s"] = time.perf_counter() - t1
    return lde, layers, secs


def sharded_rank(rank, world, port, out_dir, backend, log_n, card):
    """One rank of the sharded phase (a spawned process): bench.py's trace
    at 2^log_n rows, this rank's block through the sharded LDE and tree,
    held against the single-device LDE and tree it computes itself;
    writes its result as JSON."""
    import numpy as np
    import torch
    import torch.distributed as dist

    dev = torch.device("cuda", rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        from plonky3_tpu_torch.fields import KoalaBear as F
        from plonky3_tpu_torch.fri.config import FriParameters

        config, _, trace = _workload(
            np, log_n, FriParameters.new_benchmark_high_arity(), dev)
        mmcs = config.pcs.mmcs
        lde, layers, _ = _single_device(torch, F, mmcs, trace, 1)
        m = trace.shape[0] // world
        dist.barrier()
        out = _sharded_case(torch, F, mmcs, trace[rank * m:(rank + 1) * m],
                            1, None, lde, layers, card, turns=("cold",))
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def _spawn_ranks(world, backend, log_n, card):
    import tempfile

    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(dir=Path(__file__).resolve().parent
                                     / "plonky3_tpu_torch" / "_build") as d:
        t0 = time.perf_counter()
        mp.spawn(sharded_rank, args=(world, _free_port(), d, backend, log_n,
                                     card), nprocs=world)
        secs = time.perf_counter() - t0
        ranks = [json.load(open(os.path.join(d, f"rank{r}.json")))
                 for r in range(world)]
    if not all(r["equal"] for r in ranks):
        raise AssertionError(f"sharded {backend} x {world}: a rank's blocks "
                             f"differ from the single device's")
    return {"backend": backend, "world": world, "process_s": secs,
            "ranks": ranks}


def phase_sharded(torch, np, kernels, card, full):
    """coset_lde_batch_sharded over bench.py's trace (2^17 x 1,312,
    added_bits 1, KoalaBear's generator), then sharded_tree_layers of its
    keccak MMCS over the 2^18 LDE rows: world size 1 in this process over
    NCCL, world size SHARDED_WORLD as processes on the one card over gloo
    (CUDA tensors staged through the host), and one rank a card over NCCL
    where there are more cards; every rank's blocks equal the single
    device's coset_lde_batch and _build_layers, bit for bit; wall times
    beside the single device's."""
    import torch.distributed as dist

    from plonky3_tpu_torch.fields import KoalaBear as F

    config, _, trace = full["workload"]
    log_n = trace.shape[0].bit_length() - 1
    mmcs = config.pcs.mmcs
    lde, layers, single = _single_device(torch, F, mmcs, trace, 1)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        one = _sharded_case(torch, F, mmcs, trace, 1, None, lde, layers,
                            card)
    finally:
        dist.destroy_process_group()
    if not one["equal"]:
        raise AssertionError("sharded nccl x 1: differs from the single "
                             "device")
    for k in ("ntt_k1", "ntt_k2", "keccak_sponge", "keccak_ladder"):
        if not one["warm_launches"].get(k):
            raise AssertionError(f"sharded: no {k} launched: "
                                 f"{one['warm_launches']}")
    del lde, layers
    torch.cuda.empty_cache()
    runs = [{"backend": "nccl", "world": 1, "ranks": [one]},
            _spawn_ranks(SHARDED_WORLD, "gloo", log_n, card)]
    if torch.cuda.device_count() > 1:
        runs.append(_spawn_ranks(torch.cuda.device_count(), "nccl", log_n,
                                 card))
    emit({"phase": "sharded", "rows": 1 << log_n, "width": trace.shape[1],
          "lde_rows": 2 << log_n, "single_device": single,
          "gloo_staging": "host: CUDA tensors copied to the CPU, "
                          "all_gather, and one batch of send/recv pairs "
                          "in place of all_to_all", "torch": torch.__version__,
          "runs": runs, "equal": True})


# (C function, what it computes) of the native phase
NATIVE_GRIND_BITS = 16
NATIVE_P2 = (("koala-bear", 16), ("koala-bear", 24), ("baby-bear", 24))


def _timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def phase_native(torch, np, full):
    """Each host C function (native/, csrc/host/) against its numpy or
    torch plain version on the host that runs the script, both timed: keccak-f
    batches, keccak256, keccak256_rows, the transcript grind's witness, the
    Poseidon2 permutation <16, 3>, <24, 3> and <24, 7>, the duplex chain;
    then a cProfile of one verify of the full phase's proof (the fast
    phase's, which equals it): the ten functions of most cumulative
    time."""
    import cProfile
    import pstats

    from plonky3_tpu_torch import native
    from plonky3_tpu_torch.challenger.duplex import DuplexChallenger
    from plonky3_tpu_torch.challenger.serializing import (
        SerializingChallenger32)
    from plonky3_tpu_torch.fields import BabyBear, KoalaBear
    from plonky3_tpu_torch.hashes import keccak
    from plonky3_tpu_torch.hashes.keccak256_mmcs import keccak256_rows_np
    from plonky3_tpu_torch.hashes.poseidon2 import default_poseidon2
    from plonky3_tpu_torch.stark.verifier import verify

    import tempfile

    with tempfile.TemporaryDirectory(dir=native.BUILD_DIR) as d:
        _, build_s = _timed(lambda: native.build(d))  # a build from nothing
    rng = np.random.default_rng(17)
    rows = {}

    def check(name, c_fn, plain_fn, same=lambda a, b: a == b):
        got, c_s = _timed(c_fn)
        want, plain_s = _timed(plain_fn)
        if not same(got, want):
            raise AssertionError(f"native {name}: C and plain differ")
        rows[name] = {"c_s": c_s, "plain_s": plain_s}

    arrays = lambda a, b: np.array_equal(a, b)  # noqa: E731
    st = rng.integers(0, 1 << 63, size=(1 << 14, 25), dtype=np.uint64)
    check("keccakf_batch 2^14 states",
          lambda: native.keccakf_batch_u64(st),
          lambda: keccak.keccak_f1600_plain(st), arrays)
    msgs = [rng.integers(0, 256, size=n, dtype=np.uint8).tobytes()
            for n in (0, 135, 136, 137, 10_536 * 4)]
    check("keccak256 5 messages", lambda: [native.keccak256(m) for m in msgs],
          lambda: [keccak.keccak256_plain(m) for m in msgs])
    byte_rows = rng.integers(0, 256, size=(1 << 12, 136), dtype=np.uint8)
    check("keccak256_rows 2^12 x 136 bytes",
          lambda: native.keccak256_rows(byte_rows),
          lambda: keccak256_rows_np(byte_rows), arrays)
    chs = [SerializingChallenger32(KoalaBear) for _ in range(2)]
    prefix = rng.integers(0, KoalaBear.P, size=24).tolist()
    for c in chs:
        c.observe_many(prefix)
    check(f"keccak grind {NATIVE_GRIND_BITS} bits",
          lambda: chs[0].grind(NATIVE_GRIND_BITS),
          lambda: chs[1].grind_plain(NATIVE_GRIND_BITS))
    fields = {"koala-bear": KoalaBear, "baby-bear": BabyBear}
    for field, width in NATIVE_P2:
        F = fields[field]
        perm = default_poseidon2(F, width)
        states = F.rand_np(rng, (256, width), monty=False)
        check(f"poseidon2 {field} <{width}, {perm.d}> 256 states",
              lambda: [perm.permute_host(s) for s in states],
              lambda: [perm.permute_np(s).tolist() for s in states])
    perm = default_poseidon2(KoalaBear, 24)
    P, width, d, *tables = perm.native_args
    state = KoalaBear.rand_np(rng, (24,), monty=False)
    blocks = KoalaBear.rand_np(rng, (658, 16), monty=False)

    def chain_plain():
        st = state.astype(np.int64)
        for b in blocks:
            st[:16] = b
            st[16] = (st[16] + 16) % P
            st = perm.permute_np(st)
        return st

    check("duplex chain 658 blocks <24, 3>", lambda: native.
          poseidon2_duplex_chain(state, blocks, P, width, 16, d, *tables),
          chain_plain, arrays)
    ch = DuplexChallenger(perm)
    ch.observe(1)
    _, absorb_s = _timed(lambda: ch.observe_base_array(blocks.reshape(-1)))
    rows["duplex observe_base_array 10,528 words"] = {"c_s": absorb_s}
    config, air, _ = full["workload"]
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.runcall(verify, config, air, full["proof"], [])
    verify_s = time.perf_counter() - t0
    stats = pstats.Stats(prof)
    top = sorted(stats.stats.items(), key=lambda kv: -kv[1][3])[:10]
    emit({"phase": "native", "build_s": build_s, "functions": rows,
          "host_cpu": host_cpu(), "verify_s": verify_s,
          "verify_top_cumulative": [
              {"function": f"{Path(f).name}:{line}:{name}", "calls": nc,
               "tottime_s": tt, "cumtime_s": ct}
              for (f, line, name), (_, nc, tt, ct, _) in top]})


M22_SMALL = ("hiding_whir", "masked_zerocheck", "sharded")


def side_m22_small(np, torch, dev, name):
    """The small M22 case `name` on `dev`: hiding WHIR at n_vars 6 (the
    CPU tests' config), the masked zerocheck at log_n 4 (the mask PCS of
    tests/test_zk_multilinear.py), the sharded LDE (256 x 5, added_bits 1)
    and the keccak and Poseidon2 trees of its rows in a one-rank group
    (nccl on the card, gloo on the CPU). The CPU's proofs are verified
    (VERIFY_ONCE)."""
    import torch.distributed as dist

    from plonky3_tpu_torch.challenger.duplex import DuplexChallenger
    from plonky3_tpu_torch.fields import KoalaBear as F
    from plonky3_tpu_torch.fields import KoalaBearExt4 as E
    from plonky3_tpu_torch.hashes.poseidon2 import default_poseidon2
    from plonky3_tpu_torch.multilinear.whir import WhirConfig

    secs = {}
    t0 = time.perf_counter()
    if name == "hiding_whir":
        pcs = _hiding_pcs(F, E, WhirConfig(log_blowup=2, folding_factor=2,
                                           final_vars=1, num_queries=8,
                                           ood_samples=1, pow_bits=2))
        rng = np.random.default_rng(3)
        evals = torch.from_numpy(F.rand_np(rng, (1 << 6,), monty=False)
                                 .astype(np.int64)).to(dev)
        commit, data = pcs.commit_hiding(evals, rng)
        point = [E.rand_h(rng) for _ in range(6)]
        value, proof = pcs.open_hiding(data, point, DuplexChallenger(
            default_poseidon2(F, 24), device=dev, rate=16), rng)
        out = (commit, value, proof)
        if dev == "cpu":
            pcs.verify_hiding(commit, 6, point, value, proof,
                              DuplexChallenger(default_poseidon2(F, 24),
                                               rate=16))
    elif name == "masked_zerocheck":
        prove, _, verify = _mz_setup(np, dev, 4, True)
        out = proof = prove()
        if dev == "cpu":
            verify(proof)
    else:
        from plonky3_tpu_torch.hashes.keccak_sponge import (
            KeccakCompressor, KeccakFieldSponge)
        from plonky3_tpu_torch.merkle.mmcs import MerkleTreeMmcs
        from plonky3_tpu_torch.parallel.merkle import sharded_tree_layers
        from plonky3_tpu_torch.parallel.ntt import coset_lde_batch_sharded

        mat = torch.from_numpy(F.rand_np(np.random.default_rng(0), (256, 5))
                               .astype(np.int64)).to(dev)
        dist.init_process_group("nccl" if dev == "cuda" else "gloo",
                                init_method=f"tcp://127.0.0.1:"
                                f"{_free_port()}", rank=0, world_size=1)
        try:
            lde = coset_lde_batch_sharded(F, mat, 1, F.GENERATOR)
            trees = [sharded_tree_layers(m, lde) for m in (
                MerkleTreeMmcs(sponge=KeccakFieldSponge(F),
                               compressor=KeccakCompressor()),
                _ms_setup(F, E, 10, small=True).mmcs)]
        finally:
            dist.destroy_process_group()
        out = (lde.cpu().tolist(),
               [[x.cpu().tolist() for x in t] for t in trees])
    sync(torch, dev)
    secs[f"{name}_{dev}_s"] = time.perf_counter() - t0
    return {"plain": as_plain(out), "secs": secs}


def phase_m22_small(torch, np):
    """Hiding WHIR at n_vars 6, the masked zerocheck at log_n 4 and the
    sharded LDE and tree at 256 rows: each CUDA result equals the CPU's
    (plain versions, in a CPU worker, where each proof is verified)."""
    from plonky3_tpu_torch import kernels

    secs, launched = {}, {}
    for name in M22_SMALL:
        kernels.reset_launches()
        cuda = side_m22_small(np, torch, "cuda", name)
        launched[name] = {k: v for k, v in kernels.LAUNCHES.items() if v}
        cpu, cpu_secs, _ = cpu_side("side_m22_small", name)
        secs.update(cuda["secs"], **cpu_secs)
        if cuda["plain"] != cpu:
            raise AssertionError(f"the small {name} results differ")
        if not launched[name].get("ntt_k1"):
            raise AssertionError(f"the small {name} case launched no K1")
    emit({"phase": "m22_small", "equal": list(M22_SMALL),
          "launches": launched, "secs": secs})


def host_cpu() -> str:
    """The first CPU's model name with its vendor, family, model and
    clock from /proc/cpuinfo (where the name reads "unknown", family
    and model still identify the part)."""
    info = {}
    with open("/proc/cpuinfo") as f:
        for line in f:
            if not line.strip():
                break
            key, _, value = line.partition(":")
            info[key.strip()] = value.strip()
    return (f"{info.get('model name', '?')} ({info.get('vendor_id', '?')} "
            f"family {info.get('cpu family', '?')} model "
            f"{info.get('model', '?')}, {info.get('cpu MHz', '?')} MHz)")


def _bump_trace_value(proof, E):
    ov = proof.opened_values
    ov.trace_local[0] = E.add_h(ov.trace_local[0], E.one_h())


def _bump_sibling_digest(proof, E):
    sibs = proof.opening_proof.commit_phase_steps[0].opening_proof
    sibs[0] = ((sibs[0][0] + 1) & 0xFFFFFFFF,) + tuple(sibs[0][1:])


def _bump_trace_next(proof, E):
    ov = proof.opened_values
    ov.trace_next[0] = E.add_h(ov.trace_next[0], E.one_h())


def _bump_trace_root(proof, E):
    root = proof.commitments.trace
    proof.commitments.trace = ((root[0] + 1) % E.base.P,) + tuple(root[1:])


def _bump_trace_column(proof, E, col):
    ov = proof.opened_values
    ov.trace_local[col] = E.add_h(ov.trace_local[col], E.one_h())


def _with_extra_constraint(air):
    """`air` with one more constraint: its first trace column is zero."""
    class Extra(type(air)):
        def eval(self, b):
            super().eval(b)
            b.assert_zero(b.main.local[0])

    extra = copy.copy(air)
    extra.__class__ = Extra
    return extra


def phase_verify(config, air, proof, log_n, phase="verify",
                 probes=("trace_local", "commit_phase_sibling_digest",
                         "other_air")):
    """The port's verifier (host work) on a full-size proof, then on the
    named probes, each of which must raise one of the classes named for
    it; any other outcome fails the run."""
    from plonky3_tpu_torch.stark.verifier import (
        InvalidOpeningArgument, OodEvaluationMismatch, verify)

    known = {
        "trace_local": (_bump_trace_value,
                        (OodEvaluationMismatch, InvalidOpeningArgument)),
        "trace_root": (_bump_trace_root, (InvalidOpeningArgument,)),
        "trace_next": (_bump_trace_next,
                       (OodEvaluationMismatch, InvalidOpeningArgument)),
        "commit_phase_sibling_digest": (_bump_sibling_digest,
                                        (InvalidOpeningArgument,)),
        # an s-box register of Poseidon2VectorAir (BabyBear): the first
        # permutation's first full round, lane 0
        "trace_register": (
            lambda p, E: _bump_trace_column(p, E, air._off_full(0, 0)[0]),
            (OodEvaluationMismatch, InvalidOpeningArgument)),
        "other_air": (None, (OodEvaluationMismatch,))}
    t0 = time.perf_counter()
    verify(config, air, proof, [])  # raises on a rejection
    verify_s = time.perf_counter() - t0
    tamper = {}
    for name in probes:
        change, expected = known[name]
        bad, probe_air = proof, air
        if change is None:
            probe_air = _with_extra_constraint(air)
        else:
            bad = copy.deepcopy(proof)
            change(bad, config.E)
        t0 = time.perf_counter()
        try:
            verify(config, probe_air, bad, [])
        except expected as e:
            tamper[name] = {"raised": type(e).__name__, "message": str(e),
                            "s": time.perf_counter() - t0}
        else:
            raise AssertionError(f"verify accepted the probe {name}")
    emit({"phase": phase, "log_n": log_n, "accepted": True,
          "verify_s": verify_s, "tamper": tamper, "host_cpu": host_cpu(),
          "host_cpus": os.cpu_count()})


def profile_prove(torch, kernels, prove, config, air, trace, warm_s,
                  phase="profile"):
    """One prove under torch.profiler: device time by kernel, and the
    device's busy share of the unprofiled warm prove's wall time.
    Returns the port's kernels' device ms by record name.

    A profile can miss launches (see `_profile`): one that recorded five
    of a prove's six K2 launches gave a per-proof device time below the
    per-proof bound. So each of the port's kernels must be recorded as
    many times as the prove launched it (`kernels.LAUNCHES`). One that
    is short has no profiled time (`unrecorded` in the line); its
    per-proof time comes from CUDA events (`recorded`). The prove is
    profiled once: a second pass, seconds long at 10^5 launches, came out
    short as often as the first."""
    def run():
        kernels.reset_launches()
        prove(config, air, trace, [])

    torch.cuda.synchronize()
    prof = _profile(torch, run)
    launched = {k: v for k, v in kernels.LAUNCHES.items() if v}
    rows = device_records(prof)
    device_ms, calls = collections.Counter(), collections.Counter()
    for us, k, c in rows:
        for name, tags in PROFILE_NAMES.items():
            if all(t in k for t in tags):
                device_ms[name] += us / 1e3
                calls[name] += c
    short = {k: [calls[k], n] for k, n in launched.items()
             if calls[k] != n}
    for k in short:
        device_ms.pop(k, None)
    busy_s = sum(r[0] for r in rows) / 1e6
    ours = tuple(tags[0] for tags in PROFILE_NAMES.values())
    compressor = ("keccak_ladder", "keccak_compress")
    emit({"phase": phase, "device_busy_s": busy_s,
          "warm_prove_s": warm_s, "device_idle_share": 1 - busy_s / warm_s,
          "top": [{"kernel": k[:70], "ms": us / 1e3, "calls": c}
                  for us, k, c in rows[:12]],
          "port_kernels": [{"kernel": k[:70], "ms": us / 1e3, "calls": c}
                           for us, k, c in rows
                           if any(o in k for o in ours)],
          "launches": launched, "unrecorded": short,
          "compressor_ms": sum(device_ms.get(k, 0) for k in compressor),
          "compressor_launches": sum(calls[k] for k in compressor),
          "device_ms": dict(device_ms)})
    return dict(device_ms)


# profiler kernel names of each record: every tag must appear
PROFILE_NAMES = {"ntt_k1": ("ntt_kernel<", "true>"),
                 "ntt_k2": ("ntt_kernel<", "false>"),
                 # "::" keeps gl_sponge_rows_kernel and gl_compress_kernel
                 # out of the keccak records
                 "keccak_sponge": ("::sponge_rows_kernel",),
                 "keccak_compress": ("::compress_kernel",),
                 "keccak_ladder": ("merkle_ladder_kernel",),
                 "keccak256_chain": ("keccak256_chain_kernel",),
                 "keccak_grind": ("keccak_grind_kernel",),
                 "poseidon2_duplex_chain": ("duplex_chain_kernel<23",),
                 "poseidon2_grind": ("duplex_grind_kernel<23",),
                 "poseidon2_duplex_chain_babybear": ("duplex_chain_kernel<21",),
                 "poseidon2_grind_babybear": ("duplex_grind_kernel<21",),
                 "gl_sponge": ("gl_sponge_rows_kernel",),
                 "gl_compress": ("gl_compress_kernel",),
                 "gl_permute": ("gl_permute_kernel",)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=None,
                    help="comma-separated phases to run after the card and "
                         "kernels phases (default: every phase)")
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from plonky3_tpu_torch import kernels

    selected = None
    if args.phases:
        selected = {"card", "kernels"} | set(args.phases.split(","))
    seconds, seen = {}, set()

    def timed(name, fn, *args):
        """Run the phase `name`, or return None when the filter leaves it
        out; a phase that reads a left-out one's result cannot run."""
        seen.add(name)
        if selected is not None and name not in selected:
            return None
        if any(a is None for a in args):
            raise SystemExit(f"chip_smoke: phase {name} reads the result "
                             f"of a phase the filter left out")
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        return out

    card = timed("card", phase_card, torch, kernels)
    try:
        start_cpu_jobs(selected)
        records = _run_phases(torch, np, kernels, card, timed)
    finally:
        stop_cpu_jobs()
    unknown = (selected or set()) - seen
    if unknown:
        print(f"chip_smoke: unknown phases {sorted(unknown)}",
              file=sys.stderr)
        return 2
    emit({"phase": "profile_checks", "short": PROFILE_SHORT})
    emit({"phase": "phase_seconds", "seconds": seconds})
    emit({"kernels": [records[k] for k in sorted(records)]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


# The CPU halves of the CUDA == CPU checks, in the order the phases read
# them: (the phase that reads it, side function, its arguments after the
# device)
CPU_JOBS = (("kernels", "side_gl_sponge", ()),
            ("small", "side_small", ("pow8",)),
            ("small", "side_small", ("pow0",)),
            ("keccak_air_small", "side_keccak_air_small", ("fibonacci",)),
            ("keccak_air_small", "side_keccak_air_small", ("keccak",)),
            ("blake3_air_small", "side_pair", ("blake3",)),
            ("periodic", "side_pair", ("PeriodicAir",)),
            ("periodic", "side_pair", ("NoNextRowAir",)),
            ("babybear_small", "side_pair", ("babybear_keccak-f",)),
            ("babybear_small", "side_pair", ("babybear_poseidon2",)),
            ("sha256_air_small", "side_pair", ("sha256_keccak",)),
            ("sha256_air_small", "side_pair", ("sha256_poseidon2",)),
            ("poseidon1_small", "side_pair", ("poseidon1_keccak",)),
            ("poseidon1_small", "side_pair", ("poseidon1_poseidon2",)),
            ("m15_small", "side_pair", ("joined",)),
            ("zk_small", "side_zk_small", ("fibonacci",)),
            ("zk_small", "side_zk_small", ("keccak",)),
            ("preprocessed", "side_preprocessed_small", ()),
            ("lookup", "side_lookup_small", ()),
            ("batch", "side_batch_small", ("keccak",)),
            ("batch", "side_batch_small", ("poseidon2",)),
            ("serde", "side_serde_small", ()),
            ("circle_small", "side_circle_small", ("fibonacci",)),
            ("circle_small", "side_circle_small", ("keccak",)),
            ("gl_small", "side_gl_small", ("fibonacci",)),
            ("gl_small", "side_gl_small", ("monolith",)),
            ("m21_small", "side_m21_small", ("stir",)),
            ("m21_small", "side_m21_small", ("whir",)),
            ("m21_small", "side_m21_small", ("multi_stark",)),
            ("m22_small", "side_m22_small", ("hiding_whir",)),
            ("m22_small", "side_m22_small", ("masked_zerocheck",)),
            ("m22_small", "side_m22_small", ("sharded",)))


def _run_phases(torch, np, kernels, card, timed):
    """Every phase after the card's; returns the kernels line's records.
    A phase that the filter left out (None) leaves its launches None."""
    records = timed("kernels", phase_kernels, torch, np, card)
    mixed = timed("mixed", phase_mixed, torch, np, kernels)
    timed("small", phase_small, torch, np)
    timed("keccak_air_small", phase_keccak_air_small, torch, np)
    timed("blake3_air_small", phase_blake3_air_small, torch, np)
    timed("periodic", phase_periodic, torch, np)
    timed("babybear_small", phase_babybear_small, torch, np)
    timed("sha256_air_small", phase_sha256_air_small, torch, np)
    timed("poseidon1_small", phase_poseidon1_small, torch, np)
    timed("m15_small", phase_m15_small, torch, np)
    timed("zk_small", phase_zk_small, torch, np)
    full = timed("full", phase_full, torch, np, kernels, card)
    fast = timed("fast", phase_fast, torch, np, kernels, card, full)
    p2 = timed("poseidon2", phase_poseidon2, torch, np, kernels, card)
    kair = timed("keccak_air", phase_keccak_air, torch, np, kernels, card)
    b3 = timed("blake3_air", phase_blake3_air, torch, np, kernels, card)
    bb = timed("babybear", phase_babybear, torch, np, kernels, card,
               "keccak-f")
    timed("cli", phase_cli, torch, bb)
    bbp2 = timed("babybear_poseidon2", phase_babybear, torch, np, kernels,
                 card, "poseidon2")
    p1 = timed("poseidon1", phase_poseidon1, torch, np, kernels, card,
               "keccak")
    p1p2 = timed("poseidon1_poseidon2", phase_poseidon1, torch, np, kernels,
                 card, "poseidon2")
    sha = timed("sha256_air", phase_sha256_air, torch, np, kernels, card)
    zk = timed("zk_air", phase_zk_air, torch, np, kernels, card)
    timed("preprocessed", phase_preprocessed, torch, np)
    timed("lookup", phase_lookup, torch, np)
    bt = timed("batch", phase_batch, torch, np, kernels, card)
    bref = timed("batch_ref", phase_batch_ref, torch, np, kernels, card)
    inter = timed("interaction", phase_interaction, torch, np, kernels,
                  card)
    timed("serde", phase_serde, torch, np, bbp2)
    timed("circle_small", phase_circle_small, torch, np)
    circle = timed("circle_keccak_air", phase_circle_keccak_air, torch, np,
                   kernels, card)
    mono = timed("monolith_air", phase_monolith_air, torch, np, kernels,
                 card)
    timed("cli_circle", phase_cli_circle, torch, circle)
    timed("gl_small", phase_gl_small, torch, np)
    glf = timed("gl_fibonacci", phase_gl_fibonacci, torch, np, kernels, card)
    glm = timed("gl_monolith_air", phase_gl_monolith_air, torch, np,
                kernels, card)
    timed("m21_small", phase_m21_small, torch, np)
    pcs = timed("pcs_comparison", phase_pcs_comparison, torch, np, kernels,
                card)
    mst = timed("multi_stark", phase_multi_stark, torch, np, kernels, card)
    timed("m22_small", phase_m22_small, torch, np)
    hw = timed("hiding_whir", phase_hiding_whir, torch, np, kernels, card)
    mz = timed("masked_zerocheck", phase_masked_zerocheck, torch, np,
               kernels, card)
    timed("sharded", phase_sharded, torch, np, kernels, card, full)
    timed("native", phase_native, torch, np, full)
    # launches, proof_* : the main path (the fast prover) of the kernel's
    # config, keccak or (the duplex transcript's kernels) Poseidon2, and
    # for BabyBear's duplex kernels (<21, 7>, `*_babybear`) the BabyBear
    # Poseidon2 path; *_prove: the keccak config's prove(); *_poseidon2:
    # the NTT kernels on the Poseidon2 path; *_keccak_air, *_blake3_air,
    # *_babybear, *_sha256_air, *_poseidon1: the fast prover's kernels on
    # the keccak-AIR path (2^17 x 2,633), the Blake3-AIR path (2^17 x
    # 9,168), the BabyBear path (2^17 x 2,384), the Sha256-AIR path (2^17
    # x 7,728) and the Poseidon1 path (2^17 x 1,312), keccak config;
    # *_babybear_poseidon2: the NTT kernels on the BabyBear Poseidon2 path;
    # *_poseidon1_poseidon2: the NTT kernels and the <23, 3> duplex kernels
    # on the Poseidon1 path's Poseidon2 config; *_zk_air: K1, K2 and the
    # <23, 3> grind on the ZK KeccakAir path (prove(), zk_stark_config);
    # *_batch: the keccak kernels, K1 and K2 in the batch proof (keccak
    # config; compress_kernel's only per-proof line); *_circle_keccak_air,
    # *_monolith_air: the sponge, ladder and compress kernels (launches, 0
    # where none) in the circle proofs (prove(), circle_stark_config:
    # 2^17 x 2,633 KeccakAir, 2^16 x 3,520 MonolithAir). proof_ms: the kernel's
    # launches of one prove timed by CUDA events; proof_profiled_ms: by
    # torch.profiler, where it recorded every launch. Every per-proof
    # share goes through share().
    for name, rec in records.items():
        on_fast = not (name.endswith("_babybear") or name in GL_PATH
                       or name.startswith("poseidon2"))
        if name.endswith("_babybear"):
            main = bbp2
        elif name in GL_PATH:
            main = glm
        else:
            main = fast if on_fast else p2
        paths = [("", main)]
        if name in GL_PATH:
            paths.append(("_gl_fibonacci", glf))
        if on_fast:
            paths.append(("_prove", full))
            rec["launches_mixed_commit"] = (None if mixed is None
                                            else mixed[name])
        if name in POSEIDON2_PATH and on_fast:
            paths += [("_poseidon2", p2), ("_babybear_poseidon2", bbp2)]
        if name in POSEIDON2_PATH:
            paths.append(("_poseidon1_poseidon2", p1p2))
        if name in FAST_PATH:
            paths += [("_keccak_air", kair), ("_blake3_air", b3),
                      ("_babybear", bb), ("_sha256_air", sha),
                      ("_poseidon1", p1)]
        for key, got, path in (("_pcs_stir", pcs and pcs["stir"], M21_PATH),
                               ("_pcs_whir", pcs and pcs["whir"], M21_PATH),
                               ("_multi_stark", mst, M21_PATH),
                               ("_hiding_whir", hw, M21_PATH),
                               ("_masked_zerocheck", mz, M21_PATH),
                               ("_zk_air", zk, ZK_PATH),
                               ("_batch", bt, BATCH_PATH),
                               ("_batch_ref", bref, BATCH_REF_PATH),
                               ("_interaction", inter, INTERACTION_PATH),
                               ("_circle_keccak_air", circle,
                                KECCAK_KERNELS[:3]),
                               ("_monolith_air", mono, KECCAK_KERNELS[:3])):
            if name in path:
                paths.append((key, got))
        for key, got in paths:
            rec[f"launches{key}"] = (None if got is None
                                     else got["launches"][name])
            if got is None or name not in got["per_proof"]:
                continue
            bound = got["per_proof"][name]["bound_ms"]
            rec[f"proof_bound_ms{key}"] = bound
            for what, ms in (("", got["per_proof"][name]["ms"]),
                             ("_profiled", got["device_ms"].get(name))):
                if ms is not None:
                    rec[f"proof{what}_ms{key}"] = ms
                    rec[f"proof{what}_share{key}"] = share(
                        f"{name}{key} per proof{what}", bound, ms)
    return records

if __name__ == "__main__":
    sys.exit(main())
