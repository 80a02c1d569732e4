"""Fibonacci AIR, the smallest end-to-end workload.

Port of `plonky3_tpu/models/fibonacci.py` (uni-stark/tests/fib_air.rs).
Columns (left, right); public values (a, b, x), x the claimed last right
value. Constraints:
  first row:  left = a, right = b
  transition: next.left = right, next.right = left + right
  last row:   right = x
"""

from __future__ import annotations

import numpy as np
import torch

from .. import default_device
from ..air.api import BaseAir


class FibonacciAir(BaseAir):
    width = 2
    num_public_values = 3

    def __init__(self, field):
        self.field = field

    def max_constraint_degree(self):
        return 2  # a selector (1) times a linear term (1)

    def eval(self, b):
        a, bb, x = b.public_values
        local, nxt = b.main.local, b.main.next
        first = b.when_first_row()
        first.assert_eq(local[0], a)
        first.assert_eq(local[1], bb)
        trans = b.when_transition()
        # the operands in fib_air.rs:63-68's order: the folded value, and
        # so the quotient, changes sign with them
        trans.assert_eq(local[1], nxt[0])
        trans.assert_eq(local[0] + local[1], nxt[1])
        b.when_last_row().assert_eq(local[1], x)


def generate_fibonacci_trace(F, log_n: int, a: int = 0, b: int = 1,
                             device=None):
    """((2^log_n, 2) int64 Montgomery trace on `device` (default cuda),
    public values [a, b, the last right value], standard form)."""
    dev = default_device(device)
    n = 1 << log_n
    rows = np.zeros((n, 2), dtype=np.uint64)
    x, y = a % F.P, b % F.P
    for i in range(n):
        rows[i] = (x, y)
        x, y = y, (x + y) % F.P
    publics = [a % F.P, b % F.P, int(rows[-1, 1])]
    trace = torch.from_numpy(F.to_monty_np(rows).astype(np.int64)).to(dev)
    return trace, publics
