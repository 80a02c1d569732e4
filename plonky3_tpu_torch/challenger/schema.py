"""Transcript schemas: typed domain separators for shared challengers.

Port of `plonky3_tpu/challenger/schema.py` (the analog of
`whir/src/fiat_shamir/domain_separator.rs:1`). A `TranscriptSchema` is
the ordered list of (kind, label) slots a protocol's transcript takes,
built from its configuration alone, so prover and verifier declare the
same sequence. `SchemaChallenger` wraps any challenger: each op must
match the next declared slot, or `SchemaViolation` raises at the point
of drift. WHIR, the zerocheck and the multilinear STARK share their
challengers through it.
"""

from __future__ import annotations


class SchemaViolation(Exception):
    """A transcript op diverged from the declared domain separator."""


# op kinds, normalized over the challenger API surface
_KINDS = (
    "observe", "observe_ext", "observe_digest", "sample", "sample_ext",
    "sample_bits", "grind",
)


class TranscriptSchema:
    """An ordered list of (kind, label) transcript slots."""

    def __init__(self, name: str):
        self.name = name
        self.ops: list = []

    def _push(self, kind, label, count=1):
        if kind not in _KINDS:
            raise ValueError(f"unknown transcript op kind {kind!r}")
        self.ops.extend([(kind, label)] * count)
        return self

    def observe(self, label, count=1):
        return self._push("observe", label, count)

    def observe_ext(self, label, count=1):
        return self._push("observe_ext", label, count)

    def observe_digest(self, label, count=1):
        return self._push("observe_digest", label, count)

    def sample(self, label, count=1):
        return self._push("sample", label, count)

    def sample_ext(self, label, count=1):
        return self._push("sample_ext", label, count)

    def sample_bits(self, label, count=1):
        return self._push("sample_bits", label, count)

    def grind(self, label, count=1):
        return self._push("grind", label, count)


class SchemaChallenger:
    """A challenger that enforces a TranscriptSchema op by op.

    A grind of 0 bits still takes its `grind` slot (the schema holds the
    protocol's shape, not its parameter values). `finish()` raises unless
    the schema was consumed whole."""

    def __init__(self, inner, schema: TranscriptSchema):
        self._inner = inner
        self._schema = schema
        self._pos = 0

    def _expect(self, kind):
        if self._pos >= len(self._schema.ops):
            raise SchemaViolation(
                f"{self._schema.name}: transcript ran past the declared "
                f"schema (extra '{kind}' at position {self._pos})")
        want_kind, label = self._schema.ops[self._pos]
        if want_kind != kind:
            raise SchemaViolation(
                f"{self._schema.name}: op {self._pos} is '{kind}' but the "
                f"schema declares '{want_kind}' ({label})")
        self._pos += 1

    def finish(self):
        if self._pos != len(self._schema.ops):
            kind, label = self._schema.ops[self._pos]
            raise SchemaViolation(
                f"{self._schema.name}: transcript ended with "
                f"{len(self._schema.ops) - self._pos} undeclared ops left "
                f"(next: {kind} {label})")

    # -- wrapped surface -------------------------------------------------
    def observe(self, value):
        self._expect("observe")
        return self._inner.observe(value)

    def observe_many(self, values):
        for v in values:
            self.observe(v)

    def observe_ext(self, ext):
        self._expect("observe_ext")
        return self._inner.observe_ext(ext)

    def observe_digest(self, values):
        self._expect("observe_digest")
        return self._inner.observe_digest(values)

    def observe_base_array(self, values):
        self._expect("observe")
        return self._inner.observe_base_array(values)

    def sample(self):
        self._expect("sample")
        return self._inner.sample()

    def sample_ext(self, D):
        self._expect("sample_ext")
        return self._inner.sample_ext(D)

    def sample_bits(self, bits):
        self._expect("sample_bits")
        return self._inner.sample_bits(bits)

    def sample_uniform_bits(self, bits):
        self._expect("sample_bits")
        return self._inner.sample_uniform_bits(bits)

    def grind(self, bits, **kw):
        self._expect("grind")
        return self._inner.grind(bits, **kw)

    def check_witness(self, bits, witness):
        self._expect("grind")
        return self._inner.check_witness(bits, witness)


def whir_schema(cfg, n_vars: int, n_constraints: int = 1,
                name: str = "whir") -> TranscriptSchema:
    """WHIR's open/verify transcript from the config alone (the flow of
    `multilinear/whir.py`'s `_open_core` and `_verify_core`).
    `n_constraints` changes the claim, not the transcript."""
    s = TranscriptSchema(name)
    k = cfg.folding_factor
    M = cfg.num_rounds(n_vars)
    for rnd in range(M):
        for _ in range(k):
            s.observe_ext(f"r{rnd}:sumcheck_poly", 3)
            s.sample_ext(f"r{rnd}:sumcheck_challenge")
        if rnd == M - 1:
            s.observe_ext("final_poly", 1 << cfg.final_vars)
            s.grind(f"r{rnd}:pow")
            s.sample_bits(f"r{rnd}:queries", cfg.queries_at(rnd))
        else:
            s.observe_digest(f"r{rnd}:commit")
            for _ in range(cfg.ood_at(rnd)):
                s.sample_ext(f"r{rnd}:ood_point")
                s.observe_ext(f"r{rnd}:ood_value")
            s.grind(f"r{rnd}:pow")
            s.sample_bits(f"r{rnd}:queries", cfg.queries_at(rnd))
            s.sample_ext(f"r{rnd}:gamma")
    return s


def zerocheck_schema(num_vars: int, deg_round: int,
                     name: str = "zerocheck") -> TranscriptSchema:
    """The transcript of prove_zerocheck / verify_zerocheck."""
    s = TranscriptSchema(name)
    s.sample_ext("zc:r", num_vars)
    s.sample_ext("zc:alpha")
    for rnd in range(num_vars):
        s.observe_ext(f"zc:round{rnd}_poly", deg_round + 1)
        s.sample_ext(f"zc:round{rnd}_challenge")
    return s


def product_sumcheck_schema(num_vars: int, name: str) -> TranscriptSchema:
    s = TranscriptSchema(name)
    for rnd in range(num_vars):
        s.observe_ext(f"{name}:round{rnd}_poly", 3)
        s.sample_ext(f"{name}:round{rnd}_challenge")
    return s


def multi_stark_schema(cfg, air, n_vars: int, log_wp: int,
                       n_publics: int) -> TranscriptSchema:
    """The transcript of prove_multi_stark / verify_multi_stark: commit,
    zerocheck, shift reduction, then for each of the two points a column
    binding and a WHIR opening."""
    from ..multilinear.sumcheck import get_ml_layout

    s = TranscriptSchema("multi-stark")
    s.observe("ms:n_vars")
    s.observe_digest("ms:trace_commit")
    s.observe("ms:publics", n_publics)
    _, max_deg = get_ml_layout(air)
    s.ops += zerocheck_schema(n_vars, max_deg + 1).ops
    s.observe_ext("ms:zc_local", air.width)
    s.observe_ext("ms:zc_next", air.width)
    s.sample_ext("ms:delta")
    s.ops += product_sumcheck_schema(n_vars, "ms:shift").ops
    s.observe_ext("ms:shift_locals", air.width)
    for which in ("r", "u"):
        s.sample_ext(f"ms:gamma_{which}")
        s.ops += product_sumcheck_schema(log_wp, f"ms:colbind_{which}").ops
        s.ops += whir_schema(cfg, n_vars + log_wp,
                             name=f"ms:whir_{which}").ops
    return s
