"""Port-side copies of the periodic-column AIRs of `tests/test_periodic.py`
(uni-stark/tests/periodic_air.rs model), for the port's tests. This
module imports no JAX, so the card tests can use it."""

import numpy as np

from plonky3_tpu_torch.air.api import BaseAir

PATTERN = [1, 7, 3, 9]  # period 4
MASK = [5, 11]  # period 2


class PeriodicAir(BaseAir):
    """col0 must equal the period-4 pattern; col1 = col0 · mask."""

    width = 2
    num_public_values = 0

    def __init__(self, field):
        self.field = field

    def periodic_columns(self):
        return [PATTERN, MASK]

    def eval(self, b):
        local = b.main.local
        b.assert_zero(local[0] - b.periodic[0])
        b.assert_zero(local[1] - local[0] * b.periodic[1])


class NoNextRowAir(PeriodicAir):
    """The same constraints, and the declaration that they read no next
    row: the trace opens at zeta alone and the quotient folds in the
    committed bit-reversed order."""

    def main_next_row_columns(self):
        return []


def periodic_trace(P, n, bad_row=None):
    """The (n, 2) standard-form trace of PeriodicAir; `bad_row` changes
    col0 of that row (a wrong pattern)."""
    col0 = np.array([PATTERN[i % 4] for i in range(n)], np.uint32)
    col1 = np.array([(PATTERN[i % 4] * MASK[i % 2]) % P for i in range(n)],
                    np.uint32)
    trace = np.stack([col0, col1], axis=1)
    if bad_row is not None:
        trace[bad_row, 0] = (trace[bad_row, 0] + 1) % P
    return trace
