#!/usr/bin/env python3
"""Where chip_smoke.py's time goes.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 smoke_timing.py [--out smoke_timing.json] [--check-records N]

Runs chip_smoke.main() (its output as usual) with every phase and the
helpers in HELPERS wrapped, and writes as JSON the wall seconds and calls
of each helper within each phase, every prove timed by `timer` under
"prove:<function>". Each profile of fewer than N device records (default
60,000; 0: none) is also read by torch's key_averages(), and its sums by
kernel name held against chip_smoke.device_records' (the raw records the
script sums): "records_checks". The wrappers and those checks add time of
their own, so the phases take longer than in a plain run.
"""

from __future__ import annotations

import argparse
import collections
import functools
import json
import sys
import time

import chip_smoke as c

HELPERS = ("profile_prove", "profiled_ms", "_profile", "recorded",
           "phase_verify", "_gl_probes", "rejected", "sync_calls",
           "warm_turns", "cuda_ms", "events_ms", "once_ms", "launch_bounds",
           "compare", "plain_by_columns", "grind_sweep", "run_cli",
           "cpu_side", "_cuda_equals_cpu", "check_shape", "_workload",
           "_air_workload", "_gl_workload", "sponge_m31",
           "phase_kernels_poseidon2", "phase_kernels_goldilocks",
           "device_fs_phase")

seconds = collections.defaultdict(collections.Counter)
calls = collections.defaultdict(collections.Counter)
checks = []
stack = []


def phase():
    return stack[0] if stack else "-"


def wrap(name, is_phase):
    f = getattr(c, name)

    @functools.wraps(f)
    def timed(*args, **kw):
        top = is_phase and not stack
        if top:
            stack.append(name)
        t0 = time.perf_counter()
        try:
            return f(*args, **kw)
        finally:
            if top:
                stack.pop()
            else:
                seconds[phase()][name] += time.perf_counter() - t0
                calls[phase()][name] += 1

    setattr(c, name, timed)


def wrap_timer():
    timer = c.timer

    def wrapped(torch, config, air, trace):
        run = timer(torch, config, air, trace)

        def timed(fn, **kw):
            t0 = time.perf_counter()
            try:
                return run(fn, **kw)
            finally:
                key = "prove:" + getattr(fn, "__name__", "?")
                seconds[phase()][key] += time.perf_counter() - t0
                calls[phase()][key] += 1

        return timed

    c.timer = wrapped


def wrap_records(limit):
    raw = c.device_records

    def checked(prof):
        rows = raw(prof)
        if sum(n for _, _, n in rows) < limit:
            from torch.autograd import DeviceType

            averaged = {ev.key: (ev.self_device_time_total, ev.count)
                        for ev in prof.key_averages()
                        if ev.device_type == DeviceType.CUDA}
            mine = {k: (us, n) for us, k, n in rows}
            checks.append({
                "phase": phase(), "names": len(averaged),
                "raw_names": len(mine),
                "max_us_diff": max([abs(mine.get(k, (0, 0))[0] - us)
                                    for k, (us, _) in averaged.items()]
                                   + [0]),
                "max_count_diff": max([abs(mine.get(k, (0, 0))[1] - n)
                                       for k, (_, n) in averaged.items()]
                                      + [0]),
                "missing": [k for k in averaged if k not in mine][:3]})
        return rows

    c.device_records = checked


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="smoke_timing.json")
    ap.add_argument("--check-records", type=int, default=60000)
    args = ap.parse_args()
    for name in dir(c):
        if (name.startswith("phase_") and name not in HELPERS
                and callable(getattr(c, name))):
            wrap(name, True)
    for name in HELPERS:
        wrap(name, False)
    wrap_timer()
    if args.check_records:
        wrap_records(args.check_records)
    t0 = time.perf_counter()
    try:
        return c.main([])
    finally:
        with open(args.out, "w") as fh:
            json.dump({"total_s": time.perf_counter() - t0,
                       "by_phase": {
                           ph: {k: [v, calls[ph][k]]
                                for k, v in d.most_common()}
                           for ph, d in seconds.items()},
                       "records_checks": checks}, fh, indent=1)


if __name__ == "__main__":
    sys.exit(main())
