#!/usr/bin/env python3
"""The generic quotient's row-block fold on one NVIDIA GPU, block size by
block size.

    python3 fold_sweep.py [--air blake3|keccak] [--log-n 17]
                          [--log-blocks 13 14 15 16]

Commits the reference CLI's trace of the AIR (Blake3Air: 2^log_n
compressions; KeccakAir: 2^log_n // 24 permutations; inputs from
np.random.default_rng(1)) under the keccak config, then folds its
quotient from the committed LDE (`stark/prover.py::committed_quotient`)
at each block size in ascending order, and prints one JSON line each:
the wall seconds to the device's end, the blocks, the peak device memory
above what was allocated before the fold and that per row of a block.
Every size's quotient must equal the first's. A size that runs out of
device memory is printed as such and ends the sweep (the larger ones
need more). The first line gives the card (nvidia-smi name and power
limit), the peak device memory of the commit, the memory allocated
before the fold, the device's free memory
as the prover reads it and the block size the prover would choose.
Imports nothing of JAX or of plonky3_tpu.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time


def emit(obj):
    print(json.dumps(obj), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--air", choices=("blake3", "keccak"), default="blake3")
    ap.add_argument("--log-n", type=int, default=17)
    ap.add_argument("--log-blocks", type=int, nargs="+",
                    default=[13, 14, 15, 16])
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("fold_sweep: no CUDA device is available", file=sys.stderr)
        return 1
    from plonky3_tpu_torch import kernels
    from plonky3_tpu_torch.air.api import (
        get_log_num_quotient_chunks,
        get_symbolic_layout,
    )
    from plonky3_tpu_torch.fields import KoalaBear as F
    from plonky3_tpu_torch.fields import KoalaBearExt4 as E
    from plonky3_tpu_torch.fri.config import FriParameters
    from plonky3_tpu_torch.models import blake3_air, keccak_air
    from plonky3_tpu_torch.stark import prover
    from plonky3_tpu_torch.stark.config import keccak_stark_config

    kernels.build_all()
    rng = np.random.default_rng(1)
    n = 1 << args.log_n
    if args.air == "blake3":
        air = blake3_air.Blake3Air(F)
        inputs = rng.integers(0, 1 << 32, size=(n, 24),
                              dtype=np.uint64).astype(np.uint32)
        trace = blake3_air.generate_blake3_trace(F, inputs, device="cuda")
    else:
        air = keccak_air.KeccakAir(F)
        inputs = rng.integers(0, 1 << 64, size=(n // 24, 25),
                              dtype=np.uint64)
        trace = keccak_air.generate_keccak_trace(F, inputs, device="cuda")
    cfg = keccak_stark_config(F, E, FriParameters.new_benchmark_high_arity(),
                              device="cuda")
    pcs = cfg.pcs
    domain = pcs.natural_domain_for_degree(n)
    qd = domain.create_disjoint_domain(n << get_log_num_quotient_chunks(air))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    data = pcs.commit([(domain, trace)])
    torch.cuda.synchronize()
    commit_peak = torch.cuda.max_memory_allocated()
    prefix = pcs.get_evaluations_on_domain(data, 0, qd, order="bitrev")
    k, _ = get_symbolic_layout(air)
    pows = torch.from_numpy(F.rand_np(rng, (k, E.D)).astype(np.int64)).cuda()
    publics = torch.zeros(0, dtype=torch.int64, device="cuda")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    emit({"card": smi, "air": args.air, "rows": n, "width": air.width,
          "nq": qd.size, "commit_peak_bytes": commit_peak,
          "allocated_bytes": base,
          "free_bytes": prover._free_bytes(torch.device("cuda")),
          "chosen_block_rows": prover.fold_block_rows(
              air, qd.size, torch.device("cuda"))})
    want = None
    for log_b in sorted(args.log_blocks):
        rows = 1 << log_b
        if rows > qd.size:
            break
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            got = prover.committed_quotient(cfg, air, domain, qd, prefix,
                                            publics, pows, block_rows=rows)
            torch.cuda.synchronize()
        except torch.cuda.OutOfMemoryError as e:
            emit({"block_rows": rows, "out_of_memory": str(e)[:200]})
            break
        secs = time.perf_counter() - t0
        extra = torch.cuda.max_memory_allocated() - base
        if want is None:
            want = got
        elif not torch.equal(got, want):
            raise AssertionError(f"blocks of {rows} rows give another "
                                 f"quotient")
        emit({"block_rows": rows, "blocks": qd.size // rows, "s": secs,
              "peak_above_bytes": extra, "bytes_per_row": extra / rows})
        del got
    return 0


if __name__ == "__main__":
    sys.exit(main())
