"""The pieces of the plonky3_tpu_torch verifier against plonky3_tpu's, with
numpy and host oracles only, at small shapes: the MMCS verify side (pruned
multi-openings, the extension adapter), the keccak numpy hashes, the
domain's values at a point, the FRI fold of one group, and the Poseidon2 AIR's `eval` (its constraint
count, and its fold at a point against the reference's and against the
prover's fold). Every comparison is exact."""

import copy

import numpy as np
import pytest
import torch

from plonky3_tpu.air.builder import VerifierBackend as JVerifierBackend
from plonky3_tpu.air.api import _make_builder as j_make_builder
from plonky3_tpu.commit.domain import TwoAdicCoset as JCoset
from plonky3_tpu.fields import KoalaBear as JF
from plonky3_tpu.fields import KoalaBearExt4 as JE
from plonky3_tpu.fri.verifier import (
    _lagrange_interpolate_at as j_interpolate,
    fold_row_host as j_fold_row_host,
)
from plonky3_tpu.hashes.keccak_sponge import (
    KeccakCompressor as JCompressor,
    KeccakFieldSponge as JSponge,
)
from plonky3_tpu.merkle.extension_mmcs import ExtensionMmcs as JExtMmcs
from plonky3_tpu.merkle.mmcs import MerkleTreeMmcs as JMmcs
from plonky3_tpu.models.poseidon2_air import Poseidon2VectorAir as JAir
from plonky3_tpu_torch.air.api import _make_builder, get_symbolic_layout
from plonky3_tpu_torch.air.builder import VerifierBackend, _ew, _flatten
from plonky3_tpu_torch.commit.domain import TwoAdicCoset
from plonky3_tpu_torch.fields import KoalaBear as F
from plonky3_tpu_torch.fields import KoalaBearExt4 as E
from plonky3_tpu_torch.fri.verifier import (
    _lagrange_interpolate_at,
    fold_row_host,
)
from plonky3_tpu_torch.hashes.keccak_sponge import (
    KeccakCompressor,
    KeccakFieldSponge,
)
from plonky3_tpu_torch.merkle.extension_mmcs import ExtensionMmcs
from plonky3_tpu_torch.merkle.mmcs import MerkleTreeMmcs
from plonky3_tpu_torch.models.poseidon2_air import (
    Poseidon2VectorAir,
    generate_vectorized_trace,
)


def _mmcs(cap=0):
    ours = MerkleTreeMmcs(KeccakFieldSponge(F), KeccakCompressor(),
                          cap_height=cap)
    ref = JMmcs(JSponge(JF), JCompressor(), cap_height=cap)
    return ours, ref


def _commit(shapes, cap, seed):
    rng = np.random.default_rng(seed)
    mats = [JF.rand_np(rng, s) for s in shapes]
    ours, ref = _mmcs(cap)
    data = ours.commit([torch.from_numpy(m.astype(np.int64)) for m in mats])
    jdata = ref.commit(mats, jit_tree="np")
    assert data.commitment == jdata.commitment
    return ours, ref, data, jdata, [(m.shape[0], m.shape[1]) for m in mats]


def _bump(x):
    return (int(x) + 1) % F.P


# every height is at least 4, so caps 0 and 2 both commit
SHAPES = [
    [(16, 5)],
    [(32, 3), (32, 4), (8, 7), (4, 1)],  # same-height concat + injection
    [(4, 2), (64, 9), (16, 35)],  # taller matrices come first
]


def _multi_cases(rows_pq, sibs):
    """(name, rows, sibling digests) of one honest and four broken
    openings."""
    rows_bad = copy.deepcopy(rows_pq)
    rows_bad[0][0][0] = _bump(rows_bad[0][0][0])
    cases = [("honest", rows_pq, sibs), ("row", rows_bad, sibs),
             ("one_too_many", rows_pq, sibs + [sibs[0] if sibs
                                               else (0,) * 8])]
    if sibs:
        sib_bad = list(sibs)
        sib_bad[-1] = (sib_bad[-1][0] ^ 1,) + tuple(sib_bad[-1][1:])
        cases += [("one_too_few", rows_pq, sibs[:-1]),
                  ("digest", rows_pq, sib_bad)]
    return cases


@pytest.mark.parametrize("shapes", SHAPES)
@pytest.mark.parametrize("cap", [0, 2])
def test_verify_multi_batch_matches_reference(shapes, cap):
    """Pruned multi-openings with duplicate indices: the same bool as the
    reference for an honest opening, a changed row, a changed digest and
    one digest too many or too few."""
    ours, ref, data, jdata, dims = _commit(shapes, cap, len(shapes) + cap)
    h = max(d[0] for d in dims)
    rng = np.random.default_rng(cap)
    indices = [int(i) for i in rng.integers(0, h, 5)] + [0, h - 1, 0]
    rows_pq, sibs = ours.open_multi_batch(data, indices)
    results = []
    for name, rows, sib in _multi_cases(rows_pq, sibs):
        got = ours.verify_multi_batch(data.commitment, dims, indices, rows,
                                      sib)
        want = ref.verify_multi_batch(jdata.commitment, dims, indices, rows,
                                      sib)
        assert got == want, name
        results.append((name, got))
    assert results[0] == ("honest", True)
    assert not any(ok for _, ok in results[1:])


def test_verify_multi_batch_rejects_disagreeing_duplicates():
    ours, ref, data, jdata, dims = _commit(SHAPES[1], 0, 5)
    rows_pq, sibs = ours.open_multi_batch(data, [3, 3])
    rows_pq = copy.deepcopy(rows_pq)
    rows_pq[1][2][0] = _bump(rows_pq[1][2][0])
    for m, d in ((ours, data), (ref, jdata)):
        assert not m.verify_multi_batch(d.commitment, dims, [3, 3], rows_pq,
                                        sibs)


@pytest.mark.parametrize("cap", [0, 2])
def test_extension_mmcs_verify_matches_reference(cap):
    ext = JF.rand_np(np.random.default_rng(cap), (16, 3, 4))
    ours, ref = _mmcs(cap)
    e_ours, e_ref = ExtensionMmcs(ours, 4), JExtMmcs(ref, 4)
    data = e_ours.commit_ext_matrix(torch.from_numpy(ext.astype(np.int64)))
    jdata = e_ref.commit_ext_matrix(ext)
    dims = [(16, 3)]
    indices = [5, 2, 5, 15]
    rows_pq, sibs = e_ours.open_multi_batch(data, indices)
    assert (rows_pq, sibs) == tuple(e_ref.open_multi_batch(jdata, indices))
    bad = copy.deepcopy(rows_pq)
    bad[3][0][1] = E.add_h(bad[3][0][1], E.one_h())
    for k, rows in enumerate((rows_pq, bad)):
        got = e_ours.verify_multi_batch(data.commitment, dims, indices, rows,
                                        sibs)
        assert got == e_ref.verify_multi_batch(jdata.commitment, dims,
                                               indices, rows, sibs)
        assert got == (k == 0)


@pytest.mark.parametrize("widths", [[1], [2], [33], [34], [35], [5, 30],
                                    [1312]])
def test_hash_rows_np_matches_reference(widths):
    """Against the reference's batch hash and its one-row Python-int
    hash."""
    rng = np.random.default_rng(sum(widths))
    mats = [JF.rand_np(rng, (6, w)) for w in widths]
    got = KeccakFieldSponge(F).hash_rows_np(mats)
    want = JSponge(JF).hash_rows_np(mats)
    assert got.dtype == np.uint32 and np.array_equal(got, want)
    row = [int(x) for m in mats for x in JF.from_monty_np(m[2])]
    assert JSponge(JF).hash_iter_host(row) == tuple(int(x) for x in got[2])


def test_compress_np_matches_reference():
    """Against the reference's batch compression and its one-pair
    Python-int compression."""
    rng = np.random.default_rng(4)
    left, right = (rng.integers(0, 1 << 32, (5, 8), dtype=np.uint64)
                   .astype(np.uint32) for _ in range(2))
    got = KeccakCompressor().compress_np(left, right)
    assert got.dtype == np.uint32
    assert np.array_equal(got, JCompressor().compress_np(left, right))
    for q in range(5):
        as_int = ([int(x) for x in left[q]], [int(x) for x in right[q]])
        assert JCompressor().compress_host(*as_int) == \
            tuple(int(x) for x in got[q])


@pytest.mark.parametrize("shift,log_n", [(1, 3), (3, 5), (12345, 0)])
def test_domain_values_at_a_point_match_reference(shift, log_n):
    ours, ref = TwoAdicCoset(F, shift, log_n), JCoset(JF, shift, log_n)
    assert ours.first_point() == ref.first_point()
    rng = np.random.default_rng(log_n)
    for _ in range(3):
        z = JE.rand_h(rng)
        assert ours.vanishing_poly_at_point_ext(E, z) == \
            ref.vanishing_poly_at_point_ext(JE, z)
        if log_n:
            assert ours.selectors_at_point_ext(E, z) == \
                ref.selectors_at_point_ext(JE, z)
    # zero on the domain's first point
    assert ours.vanishing_poly_at_point_ext(
        E, E.from_base_h(ours.first_point())) == E.zero_h()


def test_extension_host_ops_match_reference():
    rng = np.random.default_rng(9)
    a, b = JE.rand_h(rng), JE.rand_h(rng)
    for op in ("add_h", "sub_h", "mul_h"):
        assert getattr(E, op)(a, b) == getattr(JE, op)(a, b), op
    assert E.neg_h(a) == JE.neg_h(a) and E.zero_h() == JE.zero_h()
    assert E.from_base_h(F.P + 5) == JE.from_base_h(F.P + 5)


@pytest.mark.parametrize("log_arity", [1, 2, 3])
def test_fold_row_host_matches_reference(log_arity):
    rng = np.random.default_rng(log_arity)
    evals = [JE.rand_h(rng) for _ in range(1 << log_arity)]
    beta = JE.rand_h(rng)
    for index, log_h in ((0, 1), (5, 4), (1, 3)):
        assert fold_row_host(E, index, log_h, log_arity, beta, evals) == \
            j_fold_row_host(JE, index, log_h, log_arity, beta, evals)
    # z on a node returns that node's value
    xs = [3, F.P - 3]
    assert _lagrange_interpolate_at(E, xs, evals[:2], E.from_base_h(3)) == \
        j_interpolate(JE, xs, evals[:2], JE.from_base_h(3)) == evals[0]


class _CountingBackend:
    """Counts the constraints `eval` emits; every value is 0."""

    def __init__(self):
        self.count = 0

    def const(self, c):
        return 0

    def add(self, a, b):
        return _ew(lambda x, y: 0, a, b)

    sub = mul = add

    def neg(self, a):
        return self.add(a, a)

    def stack(self, vals):
        return list(vals)

    def emit(self, c):
        self.count += 1

    def emit_block(self, v, count):
        assert len(_flatten(v, [])) == count
        self.count += count


@pytest.mark.parametrize("vector_len", [1, 8])
def test_eval_emits_constraint_layout_count(vector_len):
    air = Poseidon2VectorAir(F, 16, vector_len=vector_len)
    backend = _CountingBackend()
    air.eval(_make_builder(backend, air.width, 0, lambda k, j: 0, None))
    assert backend.count == get_symbolic_layout(air)[0]
    assert air.max_constraint_degree() == 3


@pytest.mark.parametrize("vector_len", [1, 2])
def test_eval_at_a_point_matches_reference_and_prover_fold(vector_len):
    """At a random extension point the port's `eval` folds to the
    reference's value. At a trace row (base values) it equals the
    prover's `fold_constraints_device` with the alpha powers descending:
    the two emit the constraints in one order."""
    air = Poseidon2VectorAir(F, 16, vector_len=vector_len)
    j_air = JAir(JF, 16, vector_len=vector_len)
    assert air.width == j_air.width
    rng = np.random.default_rng(vector_len)
    alpha = JE.rand_h(rng)
    sels = {k: JE.rand_h(rng) for k in ("is_first_row", "is_last_row",
                                        "is_transition")}
    point = [JE.rand_h(rng) for _ in range(air.width)]

    def run(a, e, backend, make, vals):
        def entry(kind, j):
            return vals[j] if kind in ("local", "next") else sels[kind]

        a.eval(make(backend, a.width, 0, entry, None))
        return backend.acc

    assert run(air, E, VerifierBackend(E, alpha), _make_builder, point) == \
        run(j_air, JE, JVerifierBackend(JE, alpha), j_make_builder, point)

    trace, _ = generate_vectorized_trace(
        air, F.rand_np(rng, (2 * vector_len, 16)), device="cpu")
    trace[1, 5] = (trace[1, 5] + 1) % F.P  # a row that breaks constraints
    k, _ = get_symbolic_layout(air)
    pows = torch.from_numpy(E.powers_np(alpha, k)[::-1].astype(np.int64))
    folded = air.fold_constraints_device(F, E, trace, None, None, None, pows)
    for r in range(2):
        row = [E.from_base_h(int(x))
               for x in F.from_monty_np(trace[r].numpy())]
        acc = run(air, E, VerifierBackend(E, alpha), _make_builder, row)
        assert acc == E.from_monty_np(folded[r].numpy())
        assert (acc == E.zero_h()) == (r == 0)
