"""AIR base class, the builder entry and the quotient-chunk count.

Port of `plonky3_tpu/air/api.py` (air/src/air.rs:9). An AIR sets `width`
and implements `eval(builder)`, which the verifier runs at zeta
(`_make_builder` with a `VerifierBackend`).

The reference derives an AIR's constraint count and degree with a symbolic
pass over its `eval`. That symbolic backend is not ported yet: an AIR here
states its layout itself through `constraint_layout()`.
"""

from __future__ import annotations

from ..utils.bits import log2_ceil
from .builder import AirBuilder, RowWindow, Sym


class BaseAir:
    width: int = 0
    num_public_values: int = 0

    def eval(self, builder: AirBuilder):
        raise NotImplementedError

    def constraint_layout(self):
        """(number of constraints, max constraint degree)."""
        raise NotImplementedError

    def max_constraint_degree(self):
        return self.constraint_layout()[1]

    def main_next_row_columns(self):
        """Columns whose next-row entries the constraints read; None means
        all (the trace opens at zeta and zeta·g)."""
        return None


def _make_builder(backend, width, num_public, entry, public_entry):
    """The builder over `backend`: entry(kind, j) gives the value of
    local/next column j or of a selector (kind is its name, j 0)."""
    main = RowWindow(
        local=[Sym(backend, entry("local", j)) for j in range(width)],
        next=[Sym(backend, entry("next", j)) for j in range(width)],
    )
    return AirBuilder(
        backend, main,
        [Sym(backend, public_entry(j)) for j in range(num_public)],
        is_first_row=Sym(backend, entry("is_first_row", 0)),
        is_last_row=Sym(backend, entry("is_last_row", 0)),
        is_transition=Sym(backend, entry("is_transition", 0)),
    )


def get_log_num_quotient_chunks(air: BaseAir) -> int:
    """uni-stark/src/symbolic.rs:10: log2_ceil(max(deg, 2) - 1)."""
    degree = max(air.max_constraint_degree(), 2)
    return log2_ceil(max(degree - 1, 1))
