"""AIR base class, the builder entry, the symbolic pass and the debug check.

Port of `plonky3_tpu/air/api.py` (air/src/air.rs:9, the symbolic pass of
air/src/symbolic/builder.rs:105,166 and air/src/check_constraints.rs:429).
An AIR sets `width` and implements `eval(builder)`; the same `eval` gives
its constraint count and degrees (`get_symbolic_layout`), the prover's
fold over the quotient domain, the verifier's fold at zeta and the debug
check of a trace. Periodic columns (air/src/air.rs:28-99) are values
that both sides derive from the AIR, never committed: `builder.periodic`.
"""

from __future__ import annotations

import weakref

import numpy as np

from ..utils.bits import log2_ceil
from .builder import AirBuilder, DebugBackend, RowWindow, Sym, SymbolicBackend


class BaseAir:
    width: int = 0
    num_public_values: int = 0

    def eval(self, builder: AirBuilder):
        raise NotImplementedError

    def max_constraint_degree(self):
        """Optional hint (air/src/air.rs); None: found by the symbolic
        pass."""
        return None

    def periodic_columns(self):
        """Periodic tables (air/src/air.rs:36-62): lists of standard-form
        ints, each of a power-of-two length dividing the trace length."""
        return []

    def main_next_row_columns(self):
        """Columns whose next-row entries the constraints read; None means
        all (the trace opens at zeta and zeta·g)."""
        return None


def _make_builder(backend, width, num_public, entry, public_entry,
                  num_periodic=0, periodic_entry=None):
    """The builder over `backend`: entry(kind, j) gives the value of
    local/next column j or of a selector (kind is its name, j 0), and
    periodic_entry(j) that of periodic column j."""
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
        periodic=[Sym(backend, periodic_entry(j))
                  for j in range(num_periodic)],
    )


# per AIR instance: a wide AIR's symbolic pass takes tens of milliseconds
# and every prove asks for it
_LAYOUTS = weakref.WeakKeyDictionary()


def _symbolic_pass(air: BaseAir):
    hit = _LAYOUTS.get(air)
    if hit is not None:
        return hit
    backend = SymbolicBackend()
    builder = _make_builder(
        backend, air.width, air.num_public_values,
        lambda kind, j: 0 if kind == "is_transition" else 1, lambda j: 0,
        num_periodic=len(air.periodic_columns()),
        periodic_entry=lambda j: 1)  # f(X^r) has degree below n
    air.eval(builder)
    degs = backend.constraint_degrees
    out = ((len(degs), max(degs) if degs else 0), backend.widest)
    _LAYOUTS[air] = out
    return out


def get_symbolic_layout(air: BaseAir):
    """(number of constraints, max constraint degree) by the symbolic
    pass over `air.eval`."""
    return _symbolic_pass(air)[0]


def get_widest_stack(air: BaseAir) -> int:
    """The most values one stacked Sym of `air.eval` holds (1 for an AIR
    that stacks nothing): the widest temporary of the prover's fold, in
    values a row."""
    return _symbolic_pass(air)[1]


def get_log_num_quotient_chunks(air: BaseAir) -> int:
    """uni-stark/src/symbolic.rs:10: log2_ceil(max(deg, 2) - 1), deg the
    AIR's hint or else its symbolic degree."""
    hint = air.max_constraint_degree()
    if hint is None:
        _, hint = get_symbolic_layout(air)
    degree = max(hint, 2)
    return log2_ceil(max(degree - 1, 1))


def check_constraints(air: BaseAir, trace_std: np.ndarray, public_values):
    """Every row of a standard-form (n, width) numpy trace against the
    constraints; the next row of the last wraps to the first (the
    transition filter masks it). Returns the failures, [] when none.
    A field wider than 32 bits (Goldilocks, a uint64 trace) evaluates in
    Python ints."""
    n = trace_std.shape[0]
    backend = DebugBackend(air.field, n)
    dt = object if backend.big else np.uint64
    tr = np.asarray(trace_std).astype(np.uint64).astype(dt)
    nxt = np.roll(tr, -1, axis=0)
    first = np.zeros(n, np.uint64)
    first[0] = 1
    last = np.zeros(n, np.uint64)
    last[-1] = 1
    trans = np.ones(n, np.uint64)
    trans[-1] = 0
    first, last, trans = (v.astype(dt) for v in (first, last, trans))
    sels = {"is_first_row": first, "is_last_row": last,
            "is_transition": trans}

    def entry(kind, j):
        if kind == "local":
            return tr[:, j]
        if kind == "next":
            return nxt[:, j]
        return sels[kind]

    pcols = air.periodic_columns()
    builder = _make_builder(
        backend, air.width, air.num_public_values, entry,
        lambda j: np.full(n, public_values[j] % air.field.P, dt),
        num_periodic=len(pcols),
        periodic_entry=lambda j: np.asarray(
            pcols[j], np.uint64).astype(dt)[np.arange(n) % len(pcols[j])])
    air.eval(builder)
    return backend.failures
