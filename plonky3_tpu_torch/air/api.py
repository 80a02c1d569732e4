"""AIR base class and the quotient-chunk count (minimal port of
`plonky3_tpu/air/api.py`; air/src/air.rs:9).

The reference derives an AIR's constraint count and degree with a symbolic
pass over its `eval`. That symbolic backend is not ported yet: an AIR here
states its layout itself through `constraint_layout()`.
"""

from __future__ import annotations

from ..utils.bits import log2_ceil


class BaseAir:
    width: int = 0
    num_public_values: int = 0

    def constraint_layout(self):
        """(number of constraints, max constraint degree)."""
        raise NotImplementedError

    def max_constraint_degree(self):
        return self.constraint_layout()[1]

    def main_next_row_columns(self):
        """Columns whose next-row entries the constraints read; None means
        all (the trace opens at zeta and zeta·g)."""
        return None


def get_log_num_quotient_chunks(air: BaseAir) -> int:
    """uni-stark/src/symbolic.rs:10: log2_ceil(max(deg, 2) - 1)."""
    degree = max(air.max_constraint_degree(), 2)
    return log2_ceil(max(degree - 1, 1))
