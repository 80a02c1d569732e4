"""The generic AIR path of plonky3_tpu_torch against plonky3_tpu's: the
symbolic layout, the traces and the debug check of FibonacciAir and
KeccakAir, the verifier's fold at a point through the builder's filters,
the generic prover fold against Poseidon2VectorAir's own fold, and whole
proofs: FibonacciAir's from both of the port's provers equal to the JAX
`prove`'s, KeccakAir's from both provers equal to each other, each
accepted by both verifiers, and each tampered copy rejected by both with
the same error. Every comparison is exact. The KeccakAir proof against
the JAX `prove` (a cold JAX prove of 2,633 columns, minutes on a CPU) is
marked slow."""

import copy

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from plonky3_tpu.air.api import _make_builder as j_make_builder
from plonky3_tpu.air.api import check_constraints as j_check_constraints
from plonky3_tpu.air.api import get_symbolic_layout as j_symbolic_layout
from plonky3_tpu.air.builder import VerifierBackend as JVerifierBackend
from plonky3_tpu.fields import KoalaBear as JF
from plonky3_tpu.fields import KoalaBearExt4 as JE
from plonky3_tpu.models import keccak_air as j_keccak
from plonky3_tpu.models.fibonacci import FibonacciAir as JFibonacciAir
from plonky3_tpu.models.fibonacci import (
    generate_fibonacci_trace as j_fibonacci_trace,
)
from plonky3_tpu.models.poseidon2_air import Poseidon2VectorAir as JP2Air
from plonky3_tpu.stark.config import keccak_stark_config as j_config
from plonky3_tpu.stark.prover import prove as j_prove
from plonky3_tpu.stark.verifier import verify as j_verify
from plonky3_tpu_torch.air.api import (
    _make_builder,
    check_constraints,
    get_log_num_quotient_chunks,
    get_symbolic_layout,
)
from plonky3_tpu_torch.air.builder import VerifierBackend
from plonky3_tpu_torch.compat import fri_params_from
from plonky3_tpu_torch.fields import KoalaBear as F
from plonky3_tpu_torch.fields import KoalaBearExt4 as E
from plonky3_tpu_torch.models import keccak_air
from plonky3_tpu_torch.models.fibonacci import (
    FibonacciAir,
    generate_fibonacci_trace,
)
from plonky3_tpu_torch.models.poseidon2_air import (
    Poseidon2VectorAir,
    generate_vectorized_trace,
)
from plonky3_tpu_torch.stark import fast_prover
from plonky3_tpu_torch.stark.config import keccak_stark_config
from plonky3_tpu_torch.stark.prover import prove, quotient_values
from plonky3_tpu_torch.stark.verifier import verify
from test_torch_prove import PARAMS, _raised, as_plain, to_port, to_reference

LOG_N = 6
# the reference's keccak-f[1600] of the zero state, first lane
ZERO_STATE_LANE0 = 0xF1258F7940E1DDE7

AIRS = {
    "fibonacci": (lambda: FibonacciAir(F), lambda: JFibonacciAir(JF)),
    "keccak": (lambda: keccak_air.KeccakAir(F),
               lambda: j_keccak.KeccakAir(JF)),
    "poseidon2_v1": (lambda: Poseidon2VectorAir(F, 16, vector_len=1),
                     lambda: JP2Air(JF, 16, vector_len=1)),
    "poseidon2_v8": (lambda: Poseidon2VectorAir(F, 16, vector_len=8),
                     lambda: JP2Air(JF, 16, vector_len=8)),
}


def _keccak_inputs(perms, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << 64, size=(perms, 25), dtype=np.uint64)


# ---- (a) the symbolic layout ----------------------------------------------
@pytest.mark.parametrize("name", sorted(AIRS))
def test_symbolic_layout_equals_reference(name):
    ours, ref = (make() for make in AIRS[name])
    assert ours.width == ref.width
    got = get_symbolic_layout(ours)
    assert got == j_symbolic_layout(ref)
    assert get_symbolic_layout(ours) is got  # cached per instance


def test_keccak_layout_and_quotient_chunks():
    air = keccak_air.KeccakAir(F)
    assert air.width == keccak_air.NUM_KECCAK_COLS == 2633
    assert get_symbolic_layout(air) == (3182, 3)
    assert air.max_constraint_degree() == 3
    assert air.main_next_row_columns() is None
    assert get_log_num_quotient_chunks(air) == 1
    assert get_log_num_quotient_chunks(FibonacciAir(F)) == 0


def test_layout_without_a_degree_hint():
    """With no hint the degree comes from the symbolic pass: the
    filtered Fibonacci constraints have degree 2."""
    class NoHint(FibonacciAir):
        def max_constraint_degree(self):
            return None

    assert get_symbolic_layout(NoHint(F)) == (5, 2)
    assert get_log_num_quotient_chunks(NoHint(F)) == 0


# ---- (b) traces -------------------------------------------------------------
def test_keccak_f_reference_kat():
    out = keccak_air.keccak_f_reference(np.zeros(25, np.uint64))
    assert out[0] == ZERO_STATE_LANE0
    assert np.array_equal(out, j_keccak.keccak_f_reference(
        np.zeros(25, np.uint64)))


@pytest.mark.parametrize("perms", [2, 3])
def test_keccak_trace_equals_reference(perms):
    inputs = _keccak_inputs(perms, perms)
    want = j_keccak.generate_keccak_trace(JF, inputs)
    assert np.array_equal(keccak_air.keccak_trace_rows(inputs), want)
    got = keccak_air.generate_keccak_trace(F, inputs, device="cpu")
    assert got.dtype == torch.int64 and got.shape == want.shape
    assert np.array_equal(got.numpy(), JF.to_monty_np(want))


def test_keccak_trace_final_rows_are_the_permutation():
    inputs = _keccak_inputs(2, 7)
    rows = keccak_air.keccak_trace_rows(inputs)
    for b in range(2):
        want = keccak_air.keccak_f_reference(inputs[b])
        final = rows[b * 24 + 23]
        for x in range(5):
            for y in range(5):
                off = (keccak_air.OFF_A_PPP_00 if (x, y) == (0, 0)
                       else keccak_air._app(y, x, 0))
                got = sum(int(v) << (16 * i)
                          for i, v in enumerate(final[off:off + 4]))
                assert got == int(want[x + 5 * y])


@pytest.mark.parametrize("a,b", [(0, 1), (5, F.P + 3)])
def test_fibonacci_trace_equals_reference(a, b):
    want, want_pub = j_fibonacci_trace(JF, LOG_N, a, b)
    got, pub = generate_fibonacci_trace(F, LOG_N, a, b, device="cpu")
    assert pub == want_pub
    assert np.array_equal(got.numpy(), JF.to_monty_np(want))


# ---- (c) the debug check ----------------------------------------------------
def _tampered_cases():
    fib, fib_pub = j_fibonacci_trace(JF, LOG_N)
    k1 = j_keccak.generate_keccak_trace(JF, _keccak_inputs(1, 4))
    bad_k = k1.copy()
    bad_k[5, j_keccak._a(2, 3, 1)] ^= 1
    bad_fib = fib.copy()
    bad_fib[9, 1] += 1
    return {
        "fibonacci": ("fibonacci", fib, fib_pub),
        "fibonacci_bad_row": ("fibonacci", bad_fib, fib_pub),
        "fibonacci_bad_public": ("fibonacci", fib, [0, 1, 7]),
        "keccak": ("keccak", k1, []),
        "keccak_bad_bit": ("keccak", bad_k, []),
    }


@pytest.mark.parametrize("case", ["fibonacci", "fibonacci_bad_row",
                                  "fibonacci_bad_public", "keccak",
                                  "keccak_bad_bit"])
def test_check_constraints_equals_reference(case):
    name, trace, publics = _tampered_cases()[case]
    ours, ref = (make() for make in AIRS[name])
    got = check_constraints(ours, trace, publics)
    assert got == j_check_constraints(ref, trace, publics)
    assert (got == []) == ("bad" not in case)


# ---- (d) the verifier's fold at a point -------------------------------------
@pytest.mark.parametrize("name", ["fibonacci", "keccak"])
def test_verifier_fold_equals_reference(name):
    """At a random extension point, with random local, next, selector and
    public values, the port's fold equals the reference's."""
    ours, ref = (make() for make in AIRS[name])
    rng = np.random.default_rng(11)
    alpha = JE.rand_h(rng)
    vals = {kind: [JE.rand_h(rng) for _ in range(ours.width)]
            for kind in ("local", "next")}
    sels = {k: JE.rand_h(rng) for k in ("is_first_row", "is_last_row",
                                        "is_transition")}
    publics = [JE.rand_h(rng) for _ in range(ours.num_public_values)]

    def entry(kind, j):
        return vals[kind][j] if kind in vals else sels[kind]

    def fold(air, backend, make):
        air.eval(make(backend, air.width, air.num_public_values, entry,
                      lambda j: publics[j]))
        return backend.acc

    got = fold(ours, VerifierBackend(E, alpha), _make_builder)
    assert got == fold(ref, JVerifierBackend(JE, alpha), j_make_builder)
    assert got != E.zero_h()


# ---- (e) the generic prover fold against the AIR's own fold ----------------
class _GenericPoseidon2(Poseidon2VectorAir):
    """Poseidon2VectorAir without its own fold: the prover runs its `eval`
    over the ProverBackend."""

    def __getattribute__(self, name):
        if name == "fold_constraints_device":
            raise AttributeError(name)
        return super().__getattribute__(name)


class _GenericNoNextRow(_GenericPoseidon2):
    def main_next_row_columns(self):
        return []


def _quotient_setup(air, log_n, seed):
    cfg = keccak_stark_config(F, E, fri_params_from(PARAMS), device="cpu")
    domain = cfg.pcs.natural_domain_for_degree(1 << log_n)
    qd = domain.create_disjoint_domain(
        1 << (log_n + get_log_num_quotient_chunks(air)))
    rng = np.random.default_rng(seed)
    k, _ = get_symbolic_layout(air)
    pows = torch.from_numpy(F.rand_np(rng, (k, E.D)).astype(np.int64))
    return cfg, domain, qd, pows, rng


@pytest.mark.parametrize("vector_len", [1, 2])
def test_generic_fold_equals_poseidon2_fold(vector_len):
    """The generic path and `fold_constraints_device` assign alpha powers
    in one order, on random rows and on a trace's rows."""
    air = Poseidon2VectorAir(F, 16, vector_len=vector_len)
    generic = _GenericPoseidon2(F, 16, vector_len=vector_len)
    assert not hasattr(generic, "fold_constraints_device")
    cfg, domain, qd, pows, rng = _quotient_setup(air, 4, vector_len)
    trace, _ = generate_vectorized_trace(
        air, F.rand_np(rng, (32 * vector_len, 16)), device="cpu")
    for rows in (torch.from_numpy(F.rand_np(rng, (qd.size, air.width))
                                  .astype(np.int64)), trace):
        want = quotient_values(cfg, air, domain, qd, rows, None, pows)
        assert torch.equal(
            quotient_values(cfg, generic, domain, qd, rows, None, pows),
            want)


def test_generic_quotient_rows_bitrev_equal_natural():
    """The generic path in the committed bit-reversed row order, permuted
    back, gives the natural order for an AIR that reads no next row."""
    from plonky3_tpu_torch.utils.bits import bitrev_permute_axis0

    air = _GenericNoNextRow(F, 16, vector_len=1)
    cfg, domain, qd, pows, rng = _quotient_setup(air, 4, 5)
    trace, _ = generate_vectorized_trace(
        air, F.rand_np(rng, (16, 16)), device="cpu")
    data = cfg.pcs.commit([(domain, trace)])
    args = (cfg, air, domain, qd)
    nat = quotient_values(
        *args, cfg.pcs.get_evaluations_on_domain(data, 0, qd), None, pows)
    br = quotient_values(
        *args, cfg.pcs.get_evaluations_on_domain(data, 0, qd, "bitrev"),
        None, pows, rows_order="bitrev")
    assert torch.equal(bitrev_permute_axis0(br, qd.log_n), nat)


# ---- (f), (g) whole proofs ---------------------------------------------------
def _config():
    return keccak_stark_config(F, E, fri_params_from(PARAMS), device="cpu")


@pytest.fixture(scope="module")
def fibonacci():
    """The JAX prove of FibonacciAir at log_n 6 and both of the port's."""
    rows, publics = j_fibonacci_trace(JF, LOG_N)
    j_air, j_cfg = JFibonacciAir(JF), j_config(JF, JE, PARAMS)
    ref = j_prove(j_cfg, j_air, jnp.asarray(JF.to_monty_np(rows)), publics)
    air, cfg = FibonacciAir(F), _config()
    trace, pub = generate_fibonacci_trace(F, LOG_N, device="cpu")
    assert pub == publics
    return dict(ref=ref, ours=prove(cfg, air, trace, publics),
                fast=fast_prover._prove_device_fs(cfg, air, trace, publics),
                air=air, cfg=cfg, j_air=j_air, j_cfg=j_cfg,
                publics=publics)


@pytest.fixture(scope="module")
def keccak():
    """Both of the port's proves of KeccakAir with 2 permutations."""
    air, cfg = keccak_air.KeccakAir(F), _config()
    trace = keccak_air.generate_keccak_trace(F, _keccak_inputs(2, 5),
                                             device="cpu")
    return dict(ours=prove(cfg, air, trace, []),
                fast=fast_prover._prove_device_fs(cfg, air, trace, []),
                air=air, cfg=cfg, j_air=j_keccak.KeccakAir(JF),
                j_cfg=j_config(JF, JE, PARAMS), publics=[], trace=trace)


@pytest.mark.parametrize("which", ["ours", "fast"])
def test_fibonacci_proof_equals_reference(fibonacci, which):
    proof = fibonacci[which]
    assert as_plain(proof) == as_plain(fibonacci["ref"])
    assert proof.degree_bits == LOG_N
    assert len(proof.opened_values.quotient_chunks) == 1


def test_keccak_provers_agree(keccak):
    proof = keccak["ours"]
    assert keccak["fast"] == proof
    assert proof.degree_bits == LOG_N
    assert len(proof.opened_values.trace_local) == 2633
    assert len(proof.opened_values.trace_next) == 2633
    assert len(proof.opened_values.quotient_chunks) == 2


@pytest.mark.parametrize("which", ["ours", "fast"])
@pytest.mark.parametrize("case", ["fibonacci", "keccak"])
def test_both_verifiers_accept(fibonacci, keccak, case, which):
    d = fibonacci if case == "fibonacci" else keccak
    proof = d[which]
    assert verify(d["cfg"], d["air"], proof, d["publics"]) is None
    j_verify(d["j_cfg"], d["j_air"], to_reference(proof), d["publics"])


def test_port_verifier_accepts_reference_fibonacci_proof(fibonacci):
    proof = to_port(fibonacci["ref"])
    assert verify(fibonacci["cfg"], fibonacci["air"], proof,
                  fibonacci["publics"]) is None


def _tampered(proof, publics, name):
    """(a changed copy of `proof`, the public values to verify it with)."""
    bad = copy.deepcopy(proof)
    ov = bad.opened_values
    if name == "public_value":
        return bad, publics[:2] + [(publics[2] + 1) % F.P]
    if name == "trace_next":
        ov.trace_next[0] = E.add_h(ov.trace_next[0], E.one_h())
    elif name == "trace_local":
        ov.trace_local[1] = E.add_h(ov.trace_local[1], E.one_h())
    elif name == "quotient_chunk":
        ov.quotient_chunks[-1][0] = E.add_h(ov.quotient_chunks[-1][0],
                                            E.one_h())
    else:
        raise ValueError(name)
    return bad, publics


def _with_extra_constraint(air):
    """`air` with one more constraint: its first trace column is zero."""
    class Extra(type(air)):
        def eval(self, b):
            super().eval(b)
            b.assert_zero(b.main.local[0])

    extra = copy.copy(air)
    extra.__class__ = Extra
    return extra


# a changed opened value changes the transcript after it, so the query
# proof of work fails first; the honest proof against another AIR reaches
# the out-of-domain check
@pytest.mark.parametrize("case,name,error", [
    ("fibonacci", "public_value", "InvalidOpeningArgument"),
    ("fibonacci", "trace_next", "InvalidOpeningArgument"),
    ("fibonacci", "trace_local", "InvalidOpeningArgument"),
    ("fibonacci", "other_air", "OodEvaluationMismatch"),
    ("keccak", "trace_next", "InvalidOpeningArgument"),
    ("keccak", "trace_local", "InvalidOpeningArgument"),
    ("keccak", "quotient_chunk", "InvalidOpeningArgument"),
    ("keccak", "other_air", "OodEvaluationMismatch")])
def test_verifiers_reject_tampered_proof_alike(fibonacci, keccak, case,
                                               name, error):
    d = fibonacci if case == "fibonacci" else keccak
    air, j_air = d["air"], d["j_air"]
    if name == "other_air":
        bad, publics = d["ours"], d["publics"]
        air, j_air = _with_extra_constraint(air), _with_extra_constraint(
            j_air)
    else:
        bad, publics = _tampered(d["ours"], d["publics"], name)
    ours = _raised(lambda: verify(d["cfg"], air, bad, publics))
    ref = _raised(lambda: j_verify(d["j_cfg"], j_air, to_reference(bad),
                                   publics))
    assert ours == ref
    assert ours[0] == error


# ---- (h) the KeccakAir proof against the JAX prove --------------------------
@pytest.mark.slow
def test_keccak_proof_equals_reference(keccak):
    trace = JF.to_monty_np(j_keccak.generate_keccak_trace(
        JF, _keccak_inputs(2, 5)))
    ref = j_prove(keccak["j_cfg"], keccak["j_air"], jnp.asarray(trace), [])
    assert as_plain(keccak["ours"]) == as_plain(ref)
