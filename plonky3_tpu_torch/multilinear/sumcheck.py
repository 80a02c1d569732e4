"""Zerocheck via sumcheck: the `sumcheck` and `multi-stark` core.

Port of `plonky3_tpu/multilinear/sumcheck.py` (multi-stark/src/
zerocheck.rs:121,217; sumcheck/src/strategy.rs). It proves that the AIR
constraints C vanish on the whole hypercube by showing

    Σ_{x in H_n}  eq(r, x) · C(T(x), T(shift x)) = 0

for a verifier challenge r. Each sumcheck round binds the lowest unbound
variable: the prover sends the round polynomial at t = 0..deg (deg = the
AIR's multilinear degree + 1 for the eq factor); the verifier checks
p(0) + p(1) == claim, samples the round challenge and goes on with
claim = p(challenge) (Lagrange interpolation over {0..deg}).

Every column (the trace's, the shifted trace's, the eq table, the two
boundary selectors) is one slice of an (N, 2w+3, D) int64 Montgomery
tensor on the trace's device. A round evaluates C over the affine
extensions even + t·(odd - even), t = 0..deg, by replaying `air.eval`
eagerly over the port's `air/` builder (one launch an operation: cheap
for a narrow AIR, many launches for a wide one), and sums modulo P.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..air.api import _make_builder
from ..air.builder import SymbolicBackend, VerifierBackend
from .device_kernels import pull_ext
from .mle import eq_table_device


def get_ml_layout(air):
    """(num_constraints, max multilinear degree): every builder entry,
    trace columns and boundary selectors alike, is a degree-1
    multilinear factor on the hypercube (multi-stark/src/selectors.rs:
    the selectors are the closed-form MLEs eq(x,0), eq(x,1),
    1-eq(x,1))."""
    backend = SymbolicBackend()
    b = _make_builder(
        backend, air.width, air.num_public_values, lambda kind, j: 1,
        lambda j: 0, num_periodic=len(air.periodic_columns()),
        periodic_entry=lambda j: 1)
    air.eval(b)
    degs = backend.constraint_degrees
    return len(degs), (max(degs) if degs else 0)


def selector_tables_device(E, num_vars: int, device):
    """(2^n, D) ext tables of the boundary selector MLEs sel_first =
    eq(x, 0..0) and sel_last = eq(x, 1..1)."""
    n = 1 << num_vars
    one = E.const(E.one_h(), device)
    first = torch.zeros((n, E.D), dtype=torch.int64, device=device)
    last = torch.zeros_like(first)
    first[0] = one
    last[n - 1] = one
    return first, last


def boundary_evals_at(E, rs):
    """BoundaryEvals::at (selectors.rs:100): (first, last, transition)
    at the bound point rs."""
    first = E.one_h()
    last = E.one_h()
    for r in rs:
        first = E.mul_h(first, E.sub_h(E.one_h(), r))
        last = E.mul_h(last, r)
    return first, last, E.sub_h(E.one_h(), last)


class _ExtTensorBackend:
    """The AIR eval backend over (N, D) ext tensors, alpha-folded."""

    def __init__(self, E, alpha_pows_m):
        self.E = E
        self.alpha_pows = alpha_pows_m  # (K, D) Montgomery, on the device
        self.device = alpha_pows_m.device
        self.idx = 0
        self.acc = None

    def const(self, c):
        return self.E.const(self.E.from_base_h(int(c)), self.device)

    def add(self, a, b):
        return self.E.add(a, b)

    def sub(self, a, b):
        return self.E.sub(a, b)

    def mul(self, a, b):
        return self.E.mul(a, b)

    def neg(self, a):
        return self.E.neg(a)

    def _accumulate(self, term):
        self.acc = term if self.acc is None else self.E.add(self.acc, term)

    def emit(self, c):
        ap = self.alpha_pows[self.idx]
        self.idx += 1
        self._accumulate(self.E.mul(c, ap))

    def const_vec(self, values):
        # (L, 1, D): broadcasts against lane-stacked (L, N, D) values
        E = self.E
        return torch.stack([self.const(v) for v in values]).reshape(
            len(values), 1, E.D)

    def stack(self, vals):
        return torch.stack(torch.broadcast_tensors(*vals))

    def emit_ext(self, comps):
        # one ext constraint from D basis-coordinate ext values
        acc = None
        for d, c in enumerate(comps):
            basis = [0] * self.E.D
            basis[d] = 1
            term = self.E.mul(c, self.E.const(tuple(basis), self.device))
            acc = term if acc is None else self.E.add(acc, term)
        self.emit(acc)

    def emit_block(self, v, count):
        # v: (..., N, D) whose leading axes flatten to `count`
        flat = v.reshape(count, v.shape[-2], self.E.D)
        ap = self.alpha_pows[self.idx:self.idx + count]  # (count, D)
        self.idx += count
        term = self.E.base.sum(self.E.mul(flat, ap[:, None, :]), dim=0)
        self._accumulate(term)


def _eval_constraints(E, air, cols_local, cols_next, publics, alpha_pows_m,
                      sel_first=None, sel_last=None):
    """The alpha-folded constraint values over (N, D) ext tensors; the
    boundary selectors are the closed-form MLE columns."""
    backend = _ExtTensorBackend(E, alpha_pows_m)
    one = backend.const(1)
    zero = backend.const(0)

    def entry(kind, j):
        if kind == "local":
            return cols_local[j]
        if kind == "next":
            return cols_next[j]
        if kind == "is_transition":
            return E.sub(one, sel_last) if sel_last is not None else one
        if kind == "is_first_row":
            return sel_first if sel_first is not None else zero
        return sel_last if sel_last is not None else zero  # is_last_row

    builder = _make_builder(backend, air.width, air.num_public_values, entry,
                            lambda j: backend.const(publics[j]))
    air.eval(builder)
    return backend.acc  # (N, D)


@dataclass
class SumcheckProof:
    round_polys: list  # [round] -> [deg+1 ext tuples] evals at t=0..deg


def _lagrange_at(E, ys, z):
    """Interpolate the points (i, ys[i]), i = 0..d, at z (host exact)."""
    d = len(ys) - 1
    acc = E.zero_h()
    for i in range(d + 1):
        num = E.one_h()
        den = 1
        for j in range(d + 1):
            if j == i:
                continue
            num = E.mul_h(num, E.sub_h(z, E.from_base_h(j)))
            den = (den * (i - j)) % E.base.P
        term = E.mul_h(ys[i],
                       E.base_mul_h(E.base.inv_h(den % E.base.P), num))
        acc = E.add_h(acc, term)
    return acc


def _affine_t(E, T, t: int):
    """(2m, C, D) stacked tables -> (m, C, D) at the extension point t."""
    v = T.reshape(-1, 2, T.shape[1], E.D)
    even, odd = v[:, 0], v[:, 1]
    if t == 0:
        return even
    if t == 1:
        return odd
    tm = E.const(E.from_base_h(t), T.device)
    return E.add(even, E.mul(E.sub(odd, even), tm))


def _zerocheck_round(E, air, T, ap_m, deg_round: int, w: int, publics):
    """One sumcheck round: for each t = 0..deg_round the affine
    extension, the alpha-folded constraints and the eq-weighted modular
    sum; a (deg_round+1, D) tensor."""
    outs = []
    for t in range(deg_round + 1):
        Tt = _affine_t(E, T, t)
        cvals = _eval_constraints(
            E, air, [Tt[:, j] for j in range(w)],
            [Tt[:, w + j] for j in range(w)], list(publics), ap_m,
            sel_first=Tt[:, 2 * w + 1], sel_last=Tt[:, 2 * w + 2])
        outs.append(E.base.sum(E.mul(Tt[:, 2 * w], cvals), dim=0))
    return torch.stack(outs)


def _fold_cols(E, T, chm):
    """Bind the lowest variable of every stacked table at the challenge:
    (2m, C, D) -> (m, C, D)."""
    v = T.reshape(-1, 2, T.shape[1], E.D)
    even, odd = v[:, 0], v[:, 1]
    return E.add(even, E.mul(E.sub(odd, even), chm))


def prove_zerocheck(E, air, trace, publics, challenger):
    """trace: (n, w) int64 Montgomery tensor, n = 2^num_vars rows.

    Transition constraints hold cyclically (the next row wraps, as in
    check_constraints); first- and last-row constraints are gated by the
    boundary-selector MLEs (selectors.rs), which fold through the
    sumcheck like any other column and which the verifier evaluates in
    closed form. Returns (SumcheckProof, the claimed local and next MLE
    openings at the final point r', r')."""
    n, w = trace.shape
    dev = trace.device
    num_vars = n.bit_length() - 1
    n_cons, max_deg = get_ml_layout(air)
    deg_round = max_deg + 1  # the eq factor adds one

    r = [challenger.sample_ext(E.D) for _ in range(num_vars)]
    alpha = challenger.sample_ext(E.D)
    alpha_pows = [E.one_h()]
    for _ in range(n_cons - 1):
        alpha_pows.append(E.mul_h(alpha_pows[-1], alpha))
    ap_m = torch.stack([E.const(a, dev) for a in reversed(alpha_pows)])

    T = torch.zeros((n, 2 * w + 3, E.D), dtype=torch.int64, device=dev)
    T[:, :w, 0] = trace
    T[:, w:2 * w, 0] = torch.roll(trace, -1, dims=0)
    sel_first, sel_last = selector_tables_device(E, num_vars, dev)
    T[:, 2 * w] = eq_table_device(E, r, dev)
    T[:, 2 * w + 1] = sel_first
    T[:, 2 * w + 2] = sel_last

    round_polys = []
    chs = []
    for _ in range(num_vars):
        evals_t = pull_ext(E, _zerocheck_round(E, air, T, ap_m, deg_round, w,
                                               tuple(publics)))
        round_polys.append(evals_t)
        for y in evals_t:
            challenger.observe_ext(y)
        ch = challenger.sample_ext(E.D)
        chs.append(ch)
        T = _fold_cols(E, T, E.const(ch, dev))

    final = pull_ext(E, T[0])
    return SumcheckProof(round_polys=round_polys), final[:w], final[w:2 * w], chs


def verify_zerocheck(E, air, num_vars, publics, proof: SumcheckProof,
                     final_local, final_next, challenger):
    """Replays the transcript and returns the bound point (the
    challenges) once the sumcheck chain and the final constraint value at
    the claimed MLE openings check. Raises ValueError on failure."""
    n_cons, max_deg = get_ml_layout(air)
    deg_round = max_deg + 1
    r = [challenger.sample_ext(E.D) for _ in range(num_vars)]
    alpha = challenger.sample_ext(E.D)

    if len(proof.round_polys) != num_vars:
        raise ValueError("RoundCountMismatch")
    claim = E.zero_h()
    chs = []
    for rnd, evals_t in enumerate(proof.round_polys):
        if len(evals_t) != deg_round + 1:
            raise ValueError("RoundPolyDegreeMismatch")
        if E.add_h(evals_t[0], evals_t[1]) != claim:
            raise ValueError(f"SumcheckRoundMismatch round {rnd}")
        for y in evals_t:
            challenger.observe_ext(y)
        ch = challenger.sample_ext(E.D)
        chs.append(ch)
        claim = _lagrange_at(E, evals_t, ch)

    # eq(r, chs)
    eq_val = E.one_h()
    for ri, ci in zip(r, chs):
        term = E.add_h(E.mul_h(ri, ci),
                       E.mul_h(E.sub_h(E.one_h(), ri),
                               E.sub_h(E.one_h(), ci)))
        eq_val = E.mul_h(eq_val, term)

    backend = VerifierBackend(E, alpha)
    sel_first, sel_last, sel_trans = boundary_evals_at(E, chs)

    def entry(kind, j):
        if kind == "local":
            return final_local[j]
        if kind == "next":
            return final_next[j]
        if kind == "is_transition":
            return sel_trans
        if kind == "is_first_row":
            return sel_first
        return sel_last  # is_last_row

    builder = _make_builder(backend, air.width, air.num_public_values, entry,
                            lambda j: E.from_base_h(publics[j]))
    air.eval(builder)
    if E.mul_h(eq_val, backend.acc) != claim:
        raise ValueError("FinalEvaluationMismatch")
    return chs
