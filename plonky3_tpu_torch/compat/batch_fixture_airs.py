"""The batch-stark golden-fixture AIRs, reproduced exactly.

Port of `plonky3_tpu/compat/batch_fixture_airs.py` (batch-stark/tests/
simple.rs: MulAir/MulAirLookups :157-314, FibonacciAir/FibAirLookups
:40-130,345-430, traces :120-155,316-343). The traces come from one
Fibonacci sequence in Python ints (the reference loops a row at a time).
"""

from __future__ import annotations

import numpy as np

from ..air.api import BaseAir
from ..models.fibonacci import FibonacciAir


class MulAirLookups(BaseAir):
    """MulAir (`reps` Fibonacci-fed multiplications and a lut column)
    with optional local and global lookups (simple.rs:157-314)."""

    num_public_values = 0

    def __init__(self, field, reps: int = 2, is_local: bool = False,
                 is_global: bool = True, global_names=("MulFib", "MulFib")):
        self.field = field
        self.reps = reps
        self.is_local = is_local
        self.is_global = is_global
        self.global_names = list(global_names)
        self.width = reps * 3 + 1

    def eval(self, b):
        local, nxt = b.main.local, b.main.next
        for i in range(self.reps):
            s = i * 3
            a, bb, c = local[s], local[s + 1], local[s + 2]
            b.assert_eq(a * bb, c)
            b.when_transition().assert_eq(bb, nxt[s])
            b.when_transition().assert_eq(a + bb, nxt[s + 1])
        lut = local[self.width - 1]
        for rep in range(self.reps):
            a, bb = local[rep * 3], local[rep * 3 + 1]
            if self.is_local:
                # query (receive, +1) then table (send, -1) in one column
                b.push_local_interaction([([a], 1), ([lut], -1)],
                                         count_weight=1)
            if self.is_global:
                b.push_interaction(self.global_names[rep], [a, bb], -1,
                                   count_weight=1)


def fibonacci_column(F, n: int) -> np.ndarray:
    """fib(0), ..., fib(n) mod P as a uint64 array (standard form)."""
    out, a, b = [0] * (n + 1), 0, 1
    for i in range(n + 1):
        out[i] = a
        a, b = b, (a + b) % F.P
    return np.asarray(out, dtype=np.uint64)


def mul_trace(F, rows: int, reps: int = 2) -> np.ndarray:
    """simple.rs:316-343: per rep the Fibonacci pairs (a, b) and a·b; the
    lut column holds b on every row but the last, which keeps zero.
    Standard-form uint32."""
    fib = fibonacci_column(F, rows)
    a, b = fib[:-1], fib[1:]
    w = reps * 3 + 1
    v = np.zeros((rows, w), dtype=np.uint64)
    for rep in range(reps):
        v[:, rep * 3] = a
        v[:, rep * 3 + 1] = b
        v[:, rep * 3 + 2] = a * b % np.uint64(F.P)
    v[:-1, w - 1] = b[:-1]
    return v.astype(np.uint32)


def fibonacci_trace(F, log_n: int):
    """The FibonacciAir trace from 0, 1 (standard-form uint32 (n, 2)) and
    its public values, as `models.fibonacci.generate_fibonacci_trace`
    gives them, from one Python-int sequence."""
    fib = fibonacci_column(F, 1 << log_n)
    rows = np.stack([fib[:-1], fib[1:]], axis=1).astype(np.uint32)
    return rows, [0, 1, int(rows[-1, 1])]


class FibAirLookups(BaseAir):
    """FibonacciAir, a preprocessed index column and an optional global
    receive (simple.rs:345-430)."""

    width = 2
    num_public_values = 3

    def __init__(self, field, log_height: int, is_global: bool = True,
                 name_and_mult=None):
        self.field = field
        self.log_height = log_height
        self.inner = FibonacciAir(field)
        self.is_global = is_global
        self.name_and_mult = name_and_mult or ("MulFib", 2)

    def preprocessed_trace(self):
        n = 1 << self.log_height
        return np.arange(n, dtype=np.uint32).reshape(n, 1)

    def eval(self, b):
        self.inner.eval(b)
        if self.is_global:
            left, right = b.main.local[0], b.main.local[1]
            name, mult = self.name_and_mult
            b.push_interaction(name, [left, right], mult, count_weight=mult)
