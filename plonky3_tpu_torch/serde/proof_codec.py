"""Typed postcard codec for reference proof objects.

Port of `plonky3_tpu/serde/proof_codec.py` (plain Python, no tensors).

Decodes/encodes `p3_uni_stark::Proof` byte-streams (the golden fixtures at
`uni-stark/tests/fixtures/*.postcard`) into plain-python structures. Layouts
mirror `uni-stark/src/proof.rs`, `fri/src/proof.rs`, `circle/src/{pcs,proof}.rs`
and `merkle-tree/src/{pruning.rs,mmcs/pruned.rs}`:

    Proof { commitments{trace, quotient_chunks, random?},
            opened_values{trace_local, trace_next?, preprocessed_local?,
                          preprocessed_next?, quotient_chunks, random?},
            opening_proof, degree_bits }
    FriProof { commit_phase_commits, commit_pow_witnesses,
               input_openings: Vec<BatchMultiOpening>,
               commit_phase_openings: Vec<CommitPhaseMultiStep>,
               final_poly, query_pow_witness }
    MerkleCap = Vec<Digest>;  PrunedMerklePaths { sibling_hashes: Vec<Digest> }

All values stay in WIRE form (Monty u32 for monty-31 fields; raw bytes for
keccak digests). Conversion to standard form happens at the protocol layer
(`compat/uni_stark_wire.py`, `compat/batch_wire.py`).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .postcard import Reader, Writer


@dataclass(frozen=True)
class WireSpec:
    """Shape parameters of one STARK config's proof encoding."""

    ext_d: int  # challenge extension degree
    digest_kind: str  # "field" (n varints) | "bytes" (n raw bytes) | "u64s"
    digest_n: int  # DIGEST_ELEMS
    # circle=True switches opening_proof to CirclePcsProof layout
    circle: bool = False

    # ---- digests ----
    def read_digest(self, r: Reader):
        if self.digest_kind == "field":
            return tuple(r.varint() for _ in range(self.digest_n))
        if self.digest_kind == "bytes":
            return bytes(r.bytes(self.digest_n))
        if self.digest_kind == "u64s":
            return tuple(r.varint() for _ in range(self.digest_n))
        raise ValueError(self.digest_kind)

    def write_digest(self, w: Writer, d):
        if self.digest_kind == "bytes":
            w.bytes(bytes(d))
        else:
            for x in d:
                w.varint(x)

    def read_cap(self, r: Reader):
        return r.vec(lambda: self.read_digest(r))

    def write_cap(self, w: Writer, cap):
        w.vec(cap, lambda d: self.write_digest(w, d))

    # ---- field elements (wire form) ----
    def read_ext(self, r: Reader):
        return tuple(r.varint() for _ in range(self.ext_d))

    def write_ext(self, w: Writer, e):
        if len(e) != self.ext_d:
            raise ValueError(f"an extension element of {len(e)} "
                             f"components, the spec has {self.ext_d}")
        for x in e:
            w.varint(x)


@dataclass
class WireBatchMultiOpening:
    opened_values: list  # [query][matrix] -> list[base wire ints]
    sibling_hashes: list  # pruned proof: flat list of digests


@dataclass
class WireCommitPhaseStep:
    log_arity: int
    sibling_values: list  # [query] -> list of (arity-1) ext tuples
    sibling_hashes: list


@dataclass
class WireFriProof:
    commit_phase_commits: list  # [round] -> cap (list of digests)
    commit_pow_witnesses: list  # [round] -> wire int
    input_openings: list  # [batch] -> WireBatchMultiOpening
    commit_phase_openings: list  # [round] -> WireCommitPhaseStep
    final_poly: list  # ext tuples (or single ext for circle)
    query_pow_witness: int


@dataclass
class WireCircleInput:
    input_openings: list  # [batch] -> WireBatchMultiOpening
    first_layer_siblings: list  # [query] -> list of ext tuples
    first_layer_sibling_hashes: list


@dataclass
class WireCirclePcsProof:
    first_layer_commitment: list  # cap
    lambdas: list  # ext tuples
    fri: WireFriProof  # input_openings holds a WireCircleInput


@dataclass
class WireProof:
    trace_commit: list  # cap
    quotient_commit: list  # cap
    random_commit: object  # cap | None
    trace_local: list  # ext tuples
    trace_next: object  # list | None
    preprocessed_local: object
    preprocessed_next: object
    quotient_chunks: list  # [chunk] -> list of ext tuples
    random_values: object
    opening_proof: object  # WireFriProof | WireCirclePcsProof
    degree_bits: int


# ----------------------------------------------------------------------
def _read_bmo(r: Reader, spec: WireSpec) -> WireBatchMultiOpening:
    opened = r.vec(lambda: r.vec(lambda: r.vec(r.varint)))
    sibs = r.vec(lambda: spec.read_digest(r))
    return WireBatchMultiOpening(opened, sibs)


def _write_bmo(w: Writer, spec: WireSpec, b: WireBatchMultiOpening):
    w.vec(
        b.opened_values,
        lambda q: w.vec(q, lambda m: w.vec(m, w.varint)),
    )
    w.vec(b.sibling_hashes, lambda d: spec.write_digest(w, d))


def _read_step(r: Reader, spec: WireSpec) -> WireCommitPhaseStep:
    log_arity = r.u8()
    sib_vals = r.vec(lambda: r.vec(lambda: spec.read_ext(r)))
    sibs = r.vec(lambda: spec.read_digest(r))
    return WireCommitPhaseStep(log_arity, sib_vals, sibs)


def _write_step(w: Writer, spec: WireSpec, s: WireCommitPhaseStep):
    w.u8(s.log_arity)
    w.vec(s.sibling_values, lambda q: w.vec(q, lambda e: spec.write_ext(w, e)))
    w.vec(s.sibling_hashes, lambda d: spec.write_digest(w, d))


def _read_fri(r: Reader, spec: WireSpec) -> WireFriProof:
    commits = r.vec(lambda: spec.read_cap(r))
    pows = r.vec(r.varint)
    if spec.circle:
        inputs = WireCircleInput(
            input_openings=r.vec(lambda: _read_bmo(r, spec)),
            first_layer_siblings=r.vec(lambda: r.vec(lambda: spec.read_ext(r))),
            first_layer_sibling_hashes=r.vec(lambda: spec.read_digest(r)),
        )
    else:
        inputs = r.vec(lambda: _read_bmo(r, spec))
    steps = r.vec(lambda: _read_step(r, spec))
    if spec.circle:
        final_poly = spec.read_ext(r)  # constant final poly
    else:
        final_poly = r.vec(lambda: spec.read_ext(r))
    query_pow = r.varint()
    return WireFriProof(commits, pows, inputs, steps, final_poly, query_pow)


def _write_fri(w: Writer, spec: WireSpec, p: WireFriProof):
    w.vec(p.commit_phase_commits, lambda c: spec.write_cap(w, c))
    w.vec(p.commit_pow_witnesses, w.varint)
    if spec.circle:
        ci = p.input_openings
        w.vec(ci.input_openings, lambda b: _write_bmo(w, spec, b))
        w.vec(
            ci.first_layer_siblings,
            lambda q: w.vec(q, lambda e: spec.write_ext(w, e)),
        )
        w.vec(ci.first_layer_sibling_hashes, lambda d: spec.write_digest(w, d))
    else:
        w.vec(p.input_openings, lambda b: _write_bmo(w, spec, b))
    w.vec(p.commit_phase_openings, lambda s: _write_step(w, spec, s))
    if spec.circle:
        spec.write_ext(w, p.final_poly)
    else:
        w.vec(p.final_poly, lambda e: spec.write_ext(w, e))
    w.varint(p.query_pow_witness)


def decode_proof(data: bytes, spec: WireSpec) -> WireProof:
    r = Reader(data)
    trace_c = spec.read_cap(r)
    quotient_c = spec.read_cap(r)
    random_c = r.option(lambda: spec.read_cap(r))
    trace_local = r.vec(lambda: spec.read_ext(r))
    trace_next = r.option(lambda: r.vec(lambda: spec.read_ext(r)))
    pre_local = r.option(lambda: r.vec(lambda: spec.read_ext(r)))
    pre_next = r.option(lambda: r.vec(lambda: spec.read_ext(r)))
    q_chunks = r.vec(lambda: r.vec(lambda: spec.read_ext(r)))
    random_v = r.option(lambda: r.vec(lambda: spec.read_ext(r)))
    if spec.circle:
        flc = spec.read_cap(r)
        lambdas = r.vec(lambda: spec.read_ext(r))
        fri = _read_fri(r, spec)
        opening = WireCirclePcsProof(flc, lambdas, fri)
    else:
        opening = _read_fri(r, spec)
    degree_bits = r.varint()
    if not r.eof():
        raise ValueError(f"{r.remaining()} trailing bytes after proof")
    return WireProof(
        trace_c, quotient_c, random_c, trace_local, trace_next,
        pre_local, pre_next, q_chunks, random_v, opening, degree_bits,
    )


def encode_proof(p: WireProof, spec: WireSpec) -> bytes:
    w = Writer()
    spec.write_cap(w, p.trace_commit)
    spec.write_cap(w, p.quotient_commit)
    w.option(p.random_commit, lambda c: spec.write_cap(w, c))
    w.vec(p.trace_local, lambda e: spec.write_ext(w, e))
    w.option(p.trace_next, lambda v: w.vec(v, lambda e: spec.write_ext(w, e)))
    w.option(
        p.preprocessed_local, lambda v: w.vec(v, lambda e: spec.write_ext(w, e))
    )
    w.option(
        p.preprocessed_next, lambda v: w.vec(v, lambda e: spec.write_ext(w, e))
    )
    w.vec(p.quotient_chunks, lambda c: w.vec(c, lambda e: spec.write_ext(w, e)))
    w.option(p.random_values, lambda v: w.vec(v, lambda e: spec.write_ext(w, e)))
    if spec.circle:
        spec.write_cap(w, p.opening_proof.first_layer_commitment)
        w.vec(p.opening_proof.lambdas, lambda e: spec.write_ext(w, e))
        _write_fri(w, spec, p.opening_proof.fri)
    else:
        _write_fri(w, spec, p.opening_proof)
    w.varint(p.degree_bits)
    return w.getvalue()


TWO_ADIC_SPEC = WireSpec(ext_d=4, digest_kind="field", digest_n=8)
CIRCLE_SPEC = WireSpec(ext_d=3, digest_kind="bytes", digest_n=32, circle=True)


# ----------------------------------------------------------------------
# batch-stark proofs (batch-stark/src/proof.rs): BatchProof {
#   commitments{main, permutation?, quotient_chunks, random?},
#   opened_values{instances: Vec<OpenedValuesWithLookups{
#       base{trace_local, trace_next?, preprocessed_local?,
#            preprocessed_next?, quotient_chunks, random?},
#       permutation_local, permutation_next}},
#   opening_proof, lookup_terminals: Vec<Option<EF>>, degree_bits: Vec }
# ----------------------------------------------------------------------
@dataclass
class WireInstanceOpened:
    trace_local: list
    trace_next: object
    preprocessed_local: object
    preprocessed_next: object
    quotient_chunks: list
    random_values: object
    permutation_local: list
    permutation_next: list


@dataclass
class WireBatchProof:
    main_commit: list  # cap
    permutation_commit: object  # cap | None
    quotient_commit: list  # cap
    random_commit: object  # cap | None
    instances: list  # [WireInstanceOpened]
    opening_proof: object  # WireFriProof | WireCirclePcsProof
    lookup_terminals: list  # [ext tuple | None]
    degree_bits: list


def _read_instance(r: Reader, spec: WireSpec) -> WireInstanceOpened:
    exts = lambda: r.vec(lambda: spec.read_ext(r))
    return WireInstanceOpened(
        trace_local=exts(),
        trace_next=r.option(exts),
        preprocessed_local=r.option(exts),
        preprocessed_next=r.option(exts),
        quotient_chunks=r.vec(exts),
        random_values=r.option(exts),
        permutation_local=exts(),
        permutation_next=exts(),
    )


def _write_instance(w: Writer, spec: WireSpec, i: WireInstanceOpened):
    exts = lambda v: w.vec(v, lambda e: spec.write_ext(w, e))
    exts(i.trace_local)
    w.option(i.trace_next, exts)
    w.option(i.preprocessed_local, exts)
    w.option(i.preprocessed_next, exts)
    w.vec(i.quotient_chunks, exts)
    w.option(i.random_values, exts)
    exts(i.permutation_local)
    exts(i.permutation_next)


def decode_batch_proof(data: bytes, spec: WireSpec) -> WireBatchProof:
    r = Reader(data)
    main_c = spec.read_cap(r)
    perm_c = r.option(lambda: spec.read_cap(r))
    quotient_c = spec.read_cap(r)
    random_c = r.option(lambda: spec.read_cap(r))
    instances = r.vec(lambda: _read_instance(r, spec))
    if spec.circle:
        flc = spec.read_cap(r)
        lambdas = r.vec(lambda: spec.read_ext(r))
        fri = _read_fri(r, spec)
        opening = WireCirclePcsProof(flc, lambdas, fri)
    else:
        opening = _read_fri(r, spec)
    terminals = r.vec(lambda: r.option(lambda: spec.read_ext(r)))
    degree_bits = r.vec(r.varint)
    if not r.eof():
        raise ValueError(f"{r.remaining()} trailing bytes after batch proof")
    return WireBatchProof(
        main_c, perm_c, quotient_c, random_c, instances, opening,
        terminals, degree_bits,
    )


def encode_batch_proof(p: WireBatchProof, spec: WireSpec) -> bytes:
    w = Writer()
    spec.write_cap(w, p.main_commit)
    w.option(p.permutation_commit, lambda c: spec.write_cap(w, c))
    spec.write_cap(w, p.quotient_commit)
    w.option(p.random_commit, lambda c: spec.write_cap(w, c))
    w.vec(p.instances, lambda i: _write_instance(w, spec, i))
    if spec.circle:
        spec.write_cap(w, p.opening_proof.first_layer_commitment)
        w.vec(p.opening_proof.lambdas, lambda e: spec.write_ext(w, e))
        _write_fri(w, spec, p.opening_proof.fri)
    else:
        _write_fri(w, spec, p.opening_proof)
    w.vec(p.lookup_terminals, lambda t: w.option(t, lambda e: spec.write_ext(w, e)))
    w.vec(p.degree_bits, w.varint)
    return w.getvalue()
