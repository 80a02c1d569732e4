"""AIR composition: a sub-builder over a column slice, named AIRs and two
AIRs joined side by side.

Port of `plonky3_tpu/air/composition.py` (uni-stark/src/sub_builder.rs:45
SubAirBuilder; air/src/named.rs:20-242). A component AIR evaluates
against its slice of a larger trace through the parent's backend, so its
constraints take their places in the parent's emission order; a name
labels the debug backend's failures.
"""

from __future__ import annotations

from .api import BaseAir
from .builder import AirBuilder, RowWindow


def sub_builder(parent: AirBuilder, col_start: int, col_end: int
                ) -> AirBuilder:
    """A builder that shows a sub-AIR only main columns [col_start,
    col_end); its constraints, filters and bus interactions land in the
    parent's backend and list (sub_builder.rs:45)."""
    child = AirBuilder(
        parent.backend,
        RowWindow(local=parent.main.local[col_start:col_end],
                  next=parent.main.next[col_start:col_end]),
        parent.public_values, parent.is_first_row, parent.is_last_row,
        parent.is_transition, parent.periodic)
    child._filter = parent._filter
    child.interactions = parent.interactions
    return child


class NamedAir(BaseAir):
    """An AIR under a namespace label (named.rs:20): the debug backend
    reports its failures as "<name>/<index>"; every other backend passes
    straight through."""

    def __init__(self, name: str, inner: BaseAir):
        self.name = name
        self.inner = inner
        self.field = inner.field
        self.width = inner.width
        self.num_public_values = inner.num_public_values

    def periodic_columns(self):
        return self.inner.periodic_columns()

    def main_next_row_columns(self):
        return self.inner.main_next_row_columns()

    def max_constraint_degree(self):
        return self.inner.max_constraint_degree()

    def eval(self, b):
        push = getattr(b.backend, "push_namespace", None)
        if push is not None:
            push(self.name)
        try:
            self.inner.eval(b)
        finally:
            if push is not None:
                b.backend.pop_namespace()


class JoinedAir(BaseAir):
    """Two AIRs side by side in one trace (named.rs Joined): the columns
    are [a | b], the public values a's then b's; each half evaluates
    through a sub-builder over its own columns."""

    def __init__(self, a: BaseAir, b: BaseAir):
        self.a = a
        self.b = b
        self.field = a.field
        self.width = a.width + b.width
        self.num_public_values = a.num_public_values + b.num_public_values

    def max_constraint_degree(self):
        da = self.a.max_constraint_degree()
        db = self.b.max_constraint_degree()
        if da is None or db is None:
            return None
        return max(da, db)

    def eval(self, builder):
        k = self.a.num_public_values
        ba = sub_builder(builder, 0, self.a.width)
        ba.public_values = builder.public_values[:k]
        self.a.eval(ba)
        bb = sub_builder(builder, self.a.width, self.width)
        bb.public_values = builder.public_values[k:]
        self.b.eval(bb)
