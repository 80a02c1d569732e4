"""The AIR builder that `air.eval` writes its constraints to.

Port of `plonky3_tpu/air/builder.py` (air/src/builder.rs:12-211). An
AIR's `eval` runs over `Sym` values and emits each constraint to a
backend; the backend decides what a value is:

  * SymbolicBackend: a value is a polynomial degree in units of the trace
    length; it counts the constraints and their degrees
    (air/src/symbolic/builder.rs:105,166: entries and is_first/is_last
    have degree 1, is_transition 0, constants 0).
  * ProverBackend: a value is an int64 Montgomery tensor over the whole
    quotient domain; the constraints fold as they come, constraint i of K
    with alpha^(K-1-i) (uni-stark/src/folder.rs:98).
  * VerifierBackend: a value is an extension tuple at the out-of-domain
    point zeta; Horner fold acc = acc·alpha + C (uni-stark/src/verifier.rs
    verify_constraints), which gives constraint i the same alpha^(K-1-i).
  * DebugBackend: numpy rows in standard form, exact, with the failing
    constraints and rows listed (air/src/check_constraints.rs:429).

A filter (`when`, `when_first_row`, `when_last_row`, `when_transition`)
multiplies every constraint emitted through it, filter on the left, as
in the reference. `builder.periodic` holds the AIR's periodic columns.
`backend.const_vec(values)` is a vector of constants, one a lane of a
stacked value (Sha256Air's round constants). The debug backend labels
its failures with the namespaces an AIR pushes (`air/composition.py`).

An extension-field constraint (`assert_zero_ext`, D component values)
takes one alpha power, where D base constraints would take D
(air/src/builder.rs ExtensionBuilder). Bus interactions
(`push_interaction`, `push_local_interaction`; lookup/src/builder.rs)
are recorded in `builder.interactions`, a list the filtered children
share, for `stark/interaction.py` and `stark/batch_ref.py`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


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


def _check_count(flat, count):
    if len(flat) != count:
        raise ValueError(f"a block of {len(flat)} constraints, "
                         f"declared {count}")


@dataclass
class RowWindow:
    local: list  # [Sym] the current row's entries
    next: list  # [Sym] the next row's entries


class AirBuilder:
    """The object handed to `air.eval`."""

    def __init__(self, backend, main: RowWindow, public_values,
                 is_first_row, is_last_row, is_transition, periodic=()):
        self.backend = backend
        self.main = main
        self.public_values = public_values  # [Sym]
        self.is_first_row = is_first_row  # Sym
        self.is_last_row = is_last_row
        self.is_transition = is_transition
        self.periodic = list(periodic)  # [Sym] the periodic columns
        self._filter = None  # a Sym that multiplies every constraint
        # the bus messages of this eval, in order: dicts with the bus
        # name, kind, field (or tuple) Syms, count Syms and the count's
        # height weight; shared with the when() children
        self.interactions = []

    def lift(self, x):
        """x as a Sym: a Sym as it is, an int as a constant."""
        if isinstance(x, Sym):
            return x
        return Sym(self.backend, self.backend.const(int(x)))

    def _gated(self, count):
        """A message's count Sym, gated by the filter (an inactive row
        sends nothing)."""
        count = self.lift(count)
        return count if self._filter is None else self._filter * count

    # -- constraint emission ---------------------------------------------
    def assert_zero(self, x):
        if not isinstance(x, Sym):
            x = Sym(self.backend, self.backend.const(int(x)))
        if self._filter is not None:
            x = self._filter * x
        self.backend.emit(x.v)

    def assert_eq(self, a, b):
        self.assert_zero(a - b)

    def assert_one(self, x):
        self.assert_zero(x - 1)

    def assert_bool(self, x):
        self.assert_zero(x * (x - 1))

    def assert_zero_ext(self, comps):
        """One extension-field constraint from its D component values:
        it takes a single alpha power."""
        comps = [self.lift(c) for c in comps]
        if self._filter is not None:
            comps = [self._filter * c for c in comps]
        self.backend.emit_ext([c.v for c in comps])

    def assert_zero_block(self, x: Sym, count: int):
        """`count` constraints at once from a vector Sym, row-major over
        its stacked axes."""
        if self._filter is not None:
            x = self._filter * x
        self.backend.emit_block(x.v, count)

    def assert_eq_block(self, a: Sym, b: Sym, count: int):
        self.assert_zero_block(a - b, count)

    # -- filters (air/src/builder.rs when_* family) -----------------------
    def when(self, condition) -> "AirBuilder":
        child = AirBuilder(self.backend, self.main, self.public_values,
                           self.is_first_row, self.is_last_row,
                           self.is_transition, self.periodic)
        child._filter = (condition if self._filter is None
                         else self._filter * condition)
        child.interactions = self.interactions
        return child

    # -- bus interactions (lookup/src/builder.rs push_interaction) --------
    def push_interaction(self, bus_name, fields, count, count_weight=1,
                         kind="global"):
        """One message on the named bus: `fields` with multiplicity
        `count` (negative: received); `count_weight` bounds the count's
        magnitude a row (types.rs:48)."""
        self.interactions.append(dict(
            bus=bus_name, kind=kind, fields=[self.lift(f) for f in fields],
            count=self._gated(count), count_weight=count_weight))

    def push_local_interaction(self, pairs, count_weight=1):
        """A local lookup (push_local_interaction): one column holding the
        sum of the fractions of several (fields, count) pairs on a bus of
        its own, whose counts cancel within the instance."""
        self.interactions.append(dict(
            bus=None, kind="local",
            tuples=[[self.lift(f) for f in fields] for fields, _ in pairs],
            counts=[self._gated(count) for _, count in pairs],
            count_weight=count_weight))

    def when_first_row(self):
        return self.when(self.is_first_row)

    def when_last_row(self):
        return self.when(self.is_last_row)

    def when_transition(self):
        return self.when(self.is_transition)


class SymbolicBackend:
    """Degrees; records each constraint's degree in emission order, and
    in `widest` the most values a stacked value holds."""

    def __init__(self):
        self.constraint_degrees = []
        self.widest = 1

    def const(self, c):
        return 0

    def const_vec(self, values):
        return [0] * len(values)

    def add(self, a, b):
        return _ew(max, a, b)

    sub = add

    def mul(self, a, b):
        return _ew(lambda x, y: x + y, a, b)

    def neg(self, a):
        return a

    def emit(self, deg):
        self.constraint_degrees.append(deg)

    def emit_ext(self, comps):
        self.constraint_degrees.append(max(comps))

    def stack(self, vals):
        out = list(vals)
        self.widest = max(self.widest, len(_flatten(out, [])))
        return out

    def emit_block(self, v, count):
        flat = _flatten(v, [])
        _check_count(flat, count)
        self.constraint_degrees.extend(flat)


_CONST_VECS = {}  # (field, values, device) -> ProverBackend.const_vec


class ProverBackend:
    """Int64 Montgomery tensors over the quotient domain; eager fold.

    `alpha_pows` is a (K, D) int64 Montgomery tensor of descending powers,
    so constraint i gets alpha^(K-1-i). The accumulator holds, per
    extension coordinate, the sum of the products c·alpha reduced mod P
    one by one (fewer than 2^32 terms below P fit in int64); `finalize`
    reduces it and takes out the Montgomery factor once, which gives the
    canonical value of the reference's sum of Montgomery products."""

    def __init__(self, F, E, alpha_pows):
        self.F, self.E = F, E
        self.alpha_pows = alpha_pows
        self.idx = 0
        self.acc = None  # (..., D) int64

    def const(self, c):
        return self.F.const(c)

    def const_vec(self, values):
        """(L, 1): broadcasts against lane-stacked (L, Nq) values; made
        once per field, values and device (one copy a proof, not one a
        fold block)."""
        F, device = self.F, self.alpha_pows.device
        key = (F.name, tuple(int(v) for v in values), device)
        hit = _CONST_VECS.get(key)
        if hit is None:
            hit = _CONST_VECS[key] = torch.tensor(
                [F.const(v) for v in key[1]], dtype=torch.int64,
                device=device).reshape(-1, 1)
        return hit

    # two constants (Python ints, as `const` gives them) combine as ints:
    # the field's tensor ops need a tensor
    def add(self, a, b):
        if isinstance(a, int) and isinstance(b, int):
            return (a + b) % self.F.P
        return self.F.add(a, b)

    def sub(self, a, b):
        if isinstance(a, int) and isinstance(b, int):
            return (a - b) % self.F.P
        return self.F.sub(a, b)

    def mul(self, a, b):
        return self.F.mul(a, b)

    def neg(self, a):
        return self.sub(0, a)

    def _accumulate(self, term):
        self.acc = term if self.acc is None else self.acc + term

    def emit(self, c):
        ap = self.alpha_pows[self.idx]  # (D,)
        self.idx += 1
        self._accumulate(torch.as_tensor(c)[..., None] * ap % self.F.P)

    def emit_ext(self, comps):
        """One extension constraint: the D component values times one
        alpha power, an extension product whose partial products stay
        before the Montgomery factor, as `emit`'s do."""
        ap = self.alpha_pows[self.idx]  # (D,)
        self.idx += 1
        P, D, W = self.F.P, self.E.D, self.E.W
        comps = [torch.as_tensor(c, device=ap.device) for c in comps]
        out = []
        for k in range(D):
            acc = None
            for i in range(D):
                j = k - i if i <= k else k - i + D
                t = comps[i] * ap[j] % P
                if i > k:
                    t = t * W
                acc = t if acc is None else acc + t
            out.append(acc % P)
        self._accumulate(torch.stack(torch.broadcast_tensors(*out), dim=-1))

    def stack(self, vals):
        return torch.stack(torch.broadcast_tensors(*vals))

    def emit_block(self, v, count):
        """v: (..., Nq) whose leading axes flatten to `count` constraints;
        constraint k gets alpha power idx + k (row-major), one batched
        mul-reduce per extension coordinate."""
        flat = v.reshape(count, v.shape[-1])  # (K, Nq)
        ap = self.alpha_pows[self.idx:self.idx + count]  # (K, D)
        self.idx += count
        P = self.F.P
        self._accumulate(torch.stack(
            [(flat * ap[:, d, None] % P).sum(dim=0)
             for d in range(self.E.D)], dim=-1))

    def finalize(self, shape):
        """The folded constraints as a canonical (*shape, D) tensor."""
        F, D = self.F, self.E.D
        if self.acc is None:
            return torch.zeros(tuple(shape) + (D,), dtype=torch.int64,
                               device=self.alpha_pows.device)
        out = self.acc % F.P * F.RINV % F.P
        return out.expand(tuple(shape) + (D,)).contiguous()


class VerifierBackend:
    """Extension tuples at one out-of-domain point; Horner fold."""

    def __init__(self, E, alpha_host):
        self.E = E
        self.alpha = alpha_host
        self.acc = E.zero_h()

    def const(self, c):
        return self.E.from_base_h(c)

    def const_vec(self, values):
        return [self.E.from_base_h(int(v)) for v in values]

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

    def emit_ext(self, comps):
        """One extension constraint from D component values, each an
        extension value at zeta: Σ_d comps[d]·X^d, folded once."""
        val = self.E.zero_h()
        for d, c in enumerate(comps):
            basis = [0] * self.E.D
            basis[d] = 1
            val = self.E.add_h(val, self.E.mul_h(c, tuple(basis)))
        self.emit(val)

    def stack(self, vals):
        return list(vals)

    def emit_block(self, v, count):
        flat = _flatten(v, [])
        _check_count(flat, count)
        for c in flat:
            self.emit(c)


class DebugBackend:
    """Exact row-wise evaluation of standard-form values; lists each
    failing constraint with its first ten failing rows, labelled
    "a/b/<index>" under the namespaces pushed (air/src/named.rs
    NamedAirBuilder). Values are numpy uint64 arrays for the 31-bit
    fields (a product of two fits) and object arrays of Python ints for
    wider ones (Goldilocks), where a uint64 product would wrap."""

    def __init__(self, F, n_rows):
        self.P = np.uint64(F.P)
        self.big = F.P > 0xFFFFFFFF
        self.n = n_rows
        self.failures = []
        self.idx = 0
        self._namespaces = []

    def push_namespace(self, name):
        self._namespaces.append(str(name))

    def pop_namespace(self):
        self._namespaces.pop()

    def _label(self):
        if not self._namespaces:
            return self.idx
        return "/".join(self._namespaces) + f"/{self.idx}"

    def const(self, c):
        if self.big:
            return np.full(self.n, int(c) % int(self.P), dtype=object)
        return np.full(self.n, c % int(self.P), dtype=np.uint64)

    def const_vec(self, values):
        # a stacked value is a list here, so one scalar a lane
        if self.big:
            return [int(v) % int(self.P) for v in values]
        return [np.uint64(int(v) % int(self.P)) for v in values]

    def add(self, a, b):
        P = int(self.P) if self.big else self.P
        return _ew(lambda x, y: (x + y) % P, a, b)

    def sub(self, a, b):
        P = int(self.P) if self.big else self.P
        return _ew(lambda x, y: (x + P - y) % P, a, b)

    def mul(self, a, b):
        P = int(self.P) if self.big else self.P
        return _ew(lambda x, y: (x * y) % P, a, b)

    def neg(self, a):
        P = int(self.P) if self.big else self.P
        return _ew(lambda x, _: (P - x) % P, a, a)

    def emit(self, c):
        bad = np.nonzero(c != 0)[0]
        if bad.size:
            self.failures.append(dict(constraint=self._label(),
                                      rows=bad[:10].tolist()))
        self.idx += 1

    def emit_ext(self, comps):
        """One extension constraint: a row fails where any component is
        nonzero."""
        bad = np.zeros(self.n, dtype=bool)
        for c in comps:
            bad |= np.broadcast_to(np.asarray(c) != 0, (self.n,))
        rows = np.nonzero(bad)[0]
        if rows.size:
            self.failures.append(dict(constraint=self._label(),
                                      rows=rows[:10].tolist()))
        self.idx += 1

    def stack(self, vals):
        return list(vals)

    def emit_block(self, v, count):
        flat = _flatten(v, [])
        _check_count(flat, count)
        for c in flat:
            self.emit(np.broadcast_to(c, (self.n,)))
