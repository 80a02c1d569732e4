#!/usr/bin/env python3
"""Chip smoke test of plonky3_tpu_torch, the PyTorch/CUDA port.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, each printed as one JSON line:
  card     the GPU's name and power limit (nvidia-smi), its integer peak
           (SMs x 64 lanes x the maximum SM clock), then an nvcc build
           of every kernel in plonky3_tpu_torch/csrc/, with ptxas's
           register report and the SASS opcode counts of the main path's
           size-2^9 NTT kernels;
  kernels  each kernel against its plain PyTorch version on the card, bit
           for bit, at the main path's shapes and at small ones (NTTs up
           to 2^22 rows, each with the k1 and k2 launches it made, which
           must match ntt_cuda.plan), with the median kernel time, the
           plain version's
           time, the kernel's bound (the least time for its bytes or for
           the busier integer pipe's operations on this card) and its
           share (bound / time; above 1.05 the count is wrong and the
           script fails);
  small    prove() on CUDA equals prove() on the CPU (plain versions) for
           Poseidon2VectorAir(KoalaBear, 16, vector_len=8) at 2^8 rows;
  full     the benchmark workload: 2^20 Poseidon2 permutations, a
           2^17 x 1312 trace, keccak config, FriParameters
           .new_benchmark_high_arity(); two proves, the second timed, with
           the kernel launch counts of that prove; then a prove with
           per-stage spans ("spans") and one under torch.profiler
           ("profile": device time by kernel, the port's own kernels
           listed apart, device idle share).
Before the last line: one JSON object listing every kernel. The last line
is {"ok": true, "device": {...}}. Any mismatch or error exits nonzero and
prints no result. Imports nothing of JAX or of plonky3_tpu.
"""

from __future__ import annotations

import argparse
import collections
import json
import re
import shutil
import statistics
import subprocess
import sys
import time

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


def bound_ms(peak, n_bytes: float, alu_ops: float, mul_ops: float = 0):
    """The least time for the work and what sets it: the bytes over the
    HBM rate, or the busier integer pipe over `peak` ops/s."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(alu_ops, mul_ops) / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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


def ntt_ops(butterflies: int, shoups: int):
    """(ALU, multiply) instructions of NTT butterflies and lone Shoup
    products (the correction, the zero_top stage 0). A reduction
    min(x, x - p) fuses with its add into one VIADDMNMX, so a butterfly
    is add + reduce twice and a reduce after the product (5 ALU) and
    the product's IMAD.HI, IMUL and IMAD (3 multiplies); a lone product
    is 1 ALU + 3 multiplies."""
    return 5 * butterflies + shoups, 3 * (butterflies + shoups)


def ntt_sass(kernels):
    """{k1, k2: static SASS instruction count and the commonest opcodes}
    of the size-2^9 NTT kernels, the main path's sub-transforms (cuobjdump
    of the built library). The kernel is unrolled, so the count is about
    what one thread issues."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(kernels.so_path("ntt"))],
                          capture_output=True, text=True, check=True).stdout
    counts, cur = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            cur = None
            for key, tag in (("k1", "ILi9ELb1E"), ("k2", "ILi9ELb0E")):
                if tag in line:
                    cur = counts.setdefault(key, collections.Counter())
            continue
        op = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z]\w*)",
                      line)
        if cur is not None and op:
            cur[op.group(1)] += 1
    return {k: {"total": sum(c.values()), **dict(c.most_common(8))}
            for k, c in sorted(counts.items())}


def phase_card(torch, kernels):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(smi, flush=True)
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    peak = sms * INT_LANES_PER_SM * clock_mhz * 1e6
    t0 = time.perf_counter()
    report = kernels.build_all()
    regs = {}
    for name, (_, out) in report.items():
        regs[name] = [ln.strip().replace("ptxas info    : ", "")
                      for ln in out.splitlines()
                      if "registers" in ln or "spill" in ln
                      or "entry function" in ln]
    emit({"phase": "card", "nvidia_smi": smi, "sms": sms,
          "max_sm_clock_mhz": clock_mhz, "int_ops_per_s": peak,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": round(time.perf_counter() - t0, 3),
          "built": sorted(report), "ptxas": regs,
          "ntt_sass": ntt_sass(kernels)})
    return peak


def _rand_words(torch, rng, shape, P):
    import numpy as np

    x = rng.integers(0, P, size=shape, dtype=np.uint64).astype(np.int64)
    return torch.from_numpy(x).to(torch.int32).cuda()


def phase_kernels(torch, np, peak):
    """Every kernel against its plain version; returns the per-kernel
    records of the main-path shapes."""
    from plonky3_tpu_torch import kernels
    from plonky3_tpu_torch.fields import KoalaBear as F
    from plonky3_tpu_torch.hashes import keccak_cuda as kc
    from plonky3_tpu_torch.ops import ntt_cuda as nc

    rng = np.random.default_rng(5)
    records = {}

    def compare(what, got, want):
        torch.cuda.synchronize()
        err = (got.to(torch.int64) - want.to(torch.int64)).abs().max()
        err = int(err) if got.numel() else 0
        if got.shape != want.shape or err != 0:
            raise AssertionError(f"{what}: kernel differs from plain "
                                 f"(max abs err {err})")
        return err

    # NTT: (log_n, w, inverse, zero_top); the first four are the main
    # path's shapes (trace iDFT and LDE, quotient-chunk iDFT and LDE),
    # the last three go through more than one level of the plan.
    ntt_cases = [(17, 1312, True, False), (18, 1312, False, True),
                 (17, 4, True, False), (18, 4, False, True),
                 (1, 5, False, False), (1, 5, True, True),
                 (6, 5, False, False), (6, 5, True, False),
                 (6, 5, False, True), (9, 128, False, False),
                 (9, 128, True, False), (9, 128, False, True),
                 (13, 200, False, False), (21, 4, False, True),
                 (21, 4, True, False), (22, 3, False, False)]
    for log_n, w, inverse, zero_top in ntt_cases:
        rows = (1 << log_n) >> 1 if zero_top else 1 << log_n
        x = _rand_words(torch, rng, (rows, w), F.P)
        before = dict(kernels.LAUNCHES)
        got = nc.dif_fused(F, x, log_n, inverse, zero_top)
        ran = {k: kernels.LAUNCHES[k] - before[k]
               for k in ("ntt_k1", "ntt_k2")}
        want = nc.dif_fused_plain(F, x, log_n, inverse, zero_top)
        err = compare(f"ntt {log_n} {w}", got, want)
        steps = nc.plan(log_n, zero_top)
        planned = {f"ntt_{k}": sum(s.kernel == k for s in steps)
                   for k in ("k1", "k2")}
        if ran != planned:
            raise AssertionError(f"ntt {log_n} {w}: launched {ran}, "
                                 f"planned {planned}")
        rec = {"log_n": log_n, "w": w, "inverse": inverse,
               "zero_top": zero_top, "k1_launches": ran["ntt_k1"],
               "k2_launches": ran["ntt_k2"], "max_abs_err": err}
        if log_n in (17, 18):
            n = 1 << log_n
            s1, s2 = steps
            log_a, log_b = s1.log_a, s1.log_b
            y1 = torch.empty((n, w), dtype=torch.int32, device=x.device)
            out = torch.empty_like(y1)
            k1 = cuda_ms(torch, lambda: nc.launch(F, s1, x, y1, inverse), 10)
            k2 = cuda_ms(torch, lambda: nc.launch(F, s2, y1, out, inverse),
                         10)
            plain = cuda_ms(torch, lambda: nc.dif_fused_plain(
                F, x, log_n, inverse, zero_top), 2)
            # k1: with zero_top, stage 0 is one Shoup product per pair
            pairs = n // 2 * w
            zt = pairs if zero_top else 0
            b1 = bound_ms(peak, 4 * (rows * w + n * w + 2 * n + (1 << log_a)),
                          *ntt_ops(pairs * log_a - zt, zt + n * w))
            b2 = bound_ms(peak, 4 * (2 * n * w + (1 << log_b)),
                          *ntt_ops(pairs * log_b, 0))
            sh1, sh2 = share("ntt_k1", b1[0], k1), share("ntt_k2", b2[0], k2)
            rec.update(k1_ms=k1, k2_ms=k2, plain_ms=plain,
                       k1_bound_ms=b1[0], k1_bound_by=b1[1], k1_share=sh1,
                       k2_bound_ms=b2[0], k2_bound_by=b2[1], k2_share=sh2)
            if (log_n, w) == (18, 1312):
                src = "plonky3_tpu_torch/csrc/ntt.cu"
                for name, ms, b, sh, line in (("ntt_k1", k1, b1, sh1, 149),
                                              ("ntt_k2", k2, b2, sh2, 158)):
                    records[name] = dict(
                        name=name, route="cuda", source=src,
                        replaces=f"plonky3_tpu/ops/ntt_pallas.py:{line}",
                        max_abs_err=err, ms=ms, plain_ms=plain,
                        bound_ms=b[0], bound_by=b[1], library_ms=None,
                        share=sh, shape=[log_n, w, "zero_top"])
        emit({"phase": "kernels", "kernel": "ntt", **rec})

    src = "plonky3_tpu_torch/csrc/keccak.cu"
    for h, w in [(1 << 18, 1312), (1 << 18, 8), (1 << 18, 32), (1, 3),
                 (5, 35), (300, 34), (7, 1)]:
        flat = _rand_words(torch, rng, (h, w), F.P)
        got = kc.keccak_sponge_rows(flat)
        want = kc.keccak_sponge_rows_plain(flat)
        err = compare(f"sponge {h} {w}", got, want)
        rec = {"h": h, "w": w, "max_abs_err": err}
        if h >= 1 << 18:
            nb = -(-((w + 1) // 2) // kc.RATE)
            ms = cuda_ms(torch, lambda: kc.keccak_sponge_rows(flat), 10)
            plain = cuda_ms(torch, lambda: kc.keccak_sponge_rows_plain(flat),
                            1)
            b = bound_ms(peak, 4 * h * (w + 8), h * nb * KECCAK_F_ALU)
            rec.update(ms=ms, plain_ms=plain, bound_ms=b[0], bound_by=b[1],
                       share=share(f"sponge {w}", b[0], ms))
            if w == 1312:
                records["keccak_sponge"] = dict(
                    name="keccak_sponge", route="cuda", source=src,
                    replaces="plonky3_tpu/hashes/keccak_pallas.py:124",
                    max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b[0],
                    bound_by=b[1], library_ms=None, share=rec["share"],
                    shape=[h, w])
        emit({"phase": "kernels", "kernel": "keccak_sponge", **rec})

    for h in [1 << 17, 1, 3, 1000]:
        left = _rand_words(torch, rng, (h, 8), 1 << 32)
        right = _rand_words(torch, rng, (h, 8), 1 << 32)
        got = kc.keccak_compress(left, right)
        want = kc.keccak_compress_plain(left, right)
        err = compare(f"compress {h}", got, want)
        rec = {"h": h, "max_abs_err": err}
        if h == 1 << 17:
            ms = cuda_ms(torch, lambda: kc.keccak_compress(left, right), 20)
            plain = cuda_ms(torch,
                            lambda: kc.keccak_compress_plain(left, right), 2)
            b = bound_ms(peak, 4 * h * 24, h * KECCAK_F_ALU)
            rec.update(ms=ms, plain_ms=plain, bound_ms=b[0], bound_by=b[1],
                       share=share("compress", b[0], ms))
            records["keccak_compress"] = dict(
                name="keccak_compress", route="cuda", source=src,
                replaces="plonky3_tpu/hashes/keccak_pallas.py:124",
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b[0],
                bound_by=b[1], library_ms=None, share=rec["share"],
                shape=[h, 8])
        emit({"phase": "kernels", "kernel": "keccak_compress", **rec})
    return records


def as_plain(x):
    """Nested tuples of ints of a proof object (classes dropped)."""
    if hasattr(x, "__dict__"):
        return tuple((k, as_plain(v)) for k, v in vars(x).items())
    if isinstance(x, (list, tuple)):
        return tuple(as_plain(v) for v in x)
    return x


def _workload(np, log_n, params, device):
    from plonky3_tpu_torch.compat import trace_inputs_from_numpy
    from plonky3_tpu_torch.fields import KoalaBear as F
    from plonky3_tpu_torch.fields import KoalaBearExt4 as E
    from plonky3_tpu_torch.models.poseidon2_air import (
        Poseidon2VectorAir, generate_vectorized_trace)
    from plonky3_tpu_torch.stark.config import keccak_stark_config

    air = Poseidon2VectorAir(F, 16, vector_len=8)
    rng = np.random.default_rng(1)
    inputs = trace_inputs_from_numpy(F.rand_np(rng, (8 << log_n, 16)),
                                     device)
    trace, _ = generate_vectorized_trace(air, inputs, device=device)
    config = keccak_stark_config(F, E, params, device=device)
    return config, air, trace


def phase_small(torch, np):
    """prove() on the card equals prove() on the CPU at full width."""
    from plonky3_tpu_torch.fri.config import FriParameters
    from plonky3_tpu_torch.stark.prover import prove

    params = FriParameters(log_blowup=1, log_final_poly_len=0,
                           max_log_arity=3, num_queries=10,
                           commit_proof_of_work_bits=0,
                           query_proof_of_work_bits=8)
    proofs, secs = {}, {}
    for dev in ("cuda", "cpu"):
        config, air, trace = _workload(np, 8, params, dev)
        t0 = time.perf_counter()
        proofs[dev] = as_plain(prove(config, air, trace, []))
        torch.cuda.synchronize()
        secs[dev] = time.perf_counter() - t0
    if proofs["cuda"] != proofs["cpu"]:
        raise AssertionError("the CUDA proof differs from the CPU proof")
    emit({"phase": "small", "log_n": 8, "width": air.width,
          "cuda_equals_cpu": True, "cuda_s": secs["cuda"],
          "cpu_s": secs["cpu"]})


def phase_full(torch, np, kernels):
    """The benchmark workload; returns the timed prove's launch counts.
    A third prove collects per-stage spans and a fourth runs under
    torch.profiler."""
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
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels not launched by prove: {missing}")
    if as_plain(first) != as_plain(proof):
        raise AssertionError("two proves of the same trace differ")
    ov = proof.opened_values
    if (proof.degree_bits != log_n or len(ov.trace_local) != air.width
            or len(ov.trace_next) != air.width
            or len(ov.quotient_chunks) != 2
            or len(proof.opening_proof.commit_phase_steps[0].sibling_values)
            != params.num_queries):
        raise AssertionError("the full-size proof has the wrong shape")
    n_perms = 8 << log_n
    emit({"phase": "full", "log_n": log_n, "rows": 1 << log_n,
          "width": air.width, "perms": n_perms, "trace_gen_s": gen_s,
          "cold_prove_s": cold_s, "warm_prove_s": warm_s,
          "perms_per_s": n_perms / warm_s,
          "peak_mem_bytes": torch.cuda.max_memory_allocated(),
          "launches": launches})
    spans = {}
    prove(config, air, trace, [], spans=spans)
    emit({"phase": "spans", "seconds": spans})
    profile_prove(torch, prove, config, air, trace, warm_s)
    return launches


def profile_prove(torch, prove, config, air, trace, warm_s):
    """One prove under torch.profiler: device time by kernel, and the
    device's busy share of the unprofiled warm prove's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prove(config, air, trace, [])
        torch.cuda.synchronize()
    rows = sorted(((ev.self_device_time_total, ev.key, ev.count)
                   for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CUDA), reverse=True)
    busy_s = sum(r[0] for r in rows) / 1e6
    ours = ("ntt_kernel", "sponge_rows_kernel", "compress_kernel")
    emit({"phase": "profile", "device_busy_s": busy_s,
          "warm_prove_s": warm_s, "device_idle_share": 1 - busy_s / warm_s,
          "top": [{"kernel": k[:70], "ms": us / 1e3, "calls": c}
                  for us, k, c in rows[:12]],
          "port_kernels": [{"kernel": k[:70], "ms": us / 1e3, "calls": c}
                           for us, k, c in rows
                           if any(o in k for o in ours)]})


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(
        argv)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from plonky3_tpu_torch import kernels

    peak = phase_card(torch, kernels)
    records = phase_kernels(torch, np, peak)
    phase_small(torch, np)
    launches = phase_full(torch, np, kernels)
    for name, rec in records.items():
        rec["launches"] = launches[name]
    emit({"kernels": [records[k] for k in sorted(records)]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
