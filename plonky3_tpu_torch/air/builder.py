"""The AIR builder that `air.eval` writes its constraints to.

Port of the verifier's part of `plonky3_tpu/air/builder.py`
(air/src/builder.rs:12-211). An AIR's `eval` runs over `Sym` values and
emits each constraint to a backend; the backend decides what a value is.
`VerifierBackend` holds extension tuples at the out-of-domain point zeta
and folds the constraints as they come, acc = acc·alpha + C
(uni-stark/src/verifier.rs verify_constraints), so constraint i of K gets
alpha^(K-1-i), the power the prover's fold gives it.

The reference's symbolic (degree) and prover backends, its filters
(`when_*`), its boolean and extension-field assertions, periodic columns
and bus interactions come with the generic AIR path and the first AIR
that needs them (ROADMAP M15, M17).
"""

from __future__ import annotations

from dataclasses import dataclass


class Sym:
    """A backend value with the field's operators."""

    __slots__ = ("b", "v")

    def __init__(self, backend, value):
        self.b = backend
        self.v = value

    def _lift(self, other):
        if isinstance(other, Sym):
            return other.v
        return self.b.const(int(other))

    def __add__(self, o):
        return Sym(self.b, self.b.add(self.v, self._lift(o)))

    __radd__ = __add__

    def __sub__(self, o):
        return Sym(self.b, self.b.sub(self.v, self._lift(o)))

    def __rsub__(self, o):
        return Sym(self.b, self.b.sub(self._lift(o), self.v))

    def __mul__(self, o):
        return Sym(self.b, self.b.mul(self.v, self._lift(o)))

    __rmul__ = __mul__

    def __neg__(self):
        return Sym(self.b, self.b.neg(self.v))


def stack_syms(syms):
    """Stack Syms into one vector Sym (leading axis len(syms)): a wide
    AIR's per-lane constraints become one block."""
    b = syms[0].b
    return Sym(b, b.stack([s.v for s in syms]))


def _ew(op, a, b):
    """Elementwise op over values that may be nested lists."""
    la, lb = isinstance(a, list), isinstance(b, list)
    if la or lb:
        if not la:
            a = [a] * len(b)
        if not lb:
            b = [b] * len(a)
        return [_ew(op, x, y) for x, y in zip(a, b)]
    return op(a, b)


def _flatten(v, out):
    if isinstance(v, list):
        for x in v:
            _flatten(x, out)
    else:
        out.append(v)
    return out


@dataclass
class RowWindow:
    local: list  # [Sym] the current row's entries
    next: list  # [Sym] the next row's entries


class AirBuilder:
    """The object handed to `air.eval`."""

    def __init__(self, backend, main: RowWindow, public_values,
                 is_first_row, is_last_row, is_transition):
        self.backend = backend
        self.main = main
        self.public_values = public_values  # [Sym]
        self.is_first_row = is_first_row  # Sym
        self.is_last_row = is_last_row
        self.is_transition = is_transition

    def assert_zero(self, x: Sym):
        self.backend.emit(x.v)

    def assert_zero_block(self, x: Sym, count: int):
        """`count` constraints at once from a vector Sym, row-major over
        its stacked axes."""
        self.backend.emit_block(x.v, count)

    def assert_eq_block(self, a: Sym, b: Sym, count: int):
        self.assert_zero_block(a - b, count)


class VerifierBackend:
    """Extension tuples at one out-of-domain point; Horner fold."""

    def __init__(self, E, alpha_host):
        self.E = E
        self.alpha = alpha_host
        self.acc = E.zero_h()

    def const(self, c):
        return self.E.from_base_h(c)

    def add(self, a, b):
        return _ew(self.E.add_h, a, b)

    def sub(self, a, b):
        return _ew(self.E.sub_h, a, b)

    def mul(self, a, b):
        return _ew(self.E.mul_h, a, b)

    def neg(self, a):
        return _ew(lambda x, _: self.E.neg_h(x), a, a)

    def emit(self, c):
        self.acc = self.E.add_h(self.E.mul_h(self.acc, self.alpha), c)

    def stack(self, vals):
        return list(vals)

    def emit_block(self, v, count):
        flat = _flatten(v, [])
        if len(flat) != count:
            raise ValueError(f"a block of {len(flat)} constraints, "
                             f"declared {count}")
        for c in flat:
            self.emit(c)
