"""The circle group and the circle PCS of the port against the
reference's: points and domains, `cfft_perm_indices`, the twiddles,
`cfft_interpolate` and `cfft_evaluate` (against JAX, round trip, and by
blocks of columns), the selectors and the vanishing polynomial, and
`CirclePcs` commit, open and verify against the JAX PCS at log_n <= 6
(the same root, opened values and proof; each verifier accepts the
other's proof and rejects a changed value and lambda).

Inputs come from numpy seeds; integers, so equality is the tolerance.
One JAX commit and open serves the file (a module fixture).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plonky3_tpu.challenger.serializing import (
    SerializingChallenger32 as JChallenger,
)
from plonky3_tpu.circle_pcs import CirclePcs as JCirclePcs
from plonky3_tpu.circle_pcs import pcs as j_pcs_mod
from plonky3_tpu.fields.mersenne31 import Mersenne31 as JF
from plonky3_tpu.fields.qm31 import QM31 as JQ
from plonky3_tpu.fri import proof as j_fri_proof
from plonky3_tpu.fri.config import FriParameters as JFri
from plonky3_tpu.fri.verifier import FriError as JFriError
from plonky3_tpu.hashes.keccak_sponge import (
    KeccakCompressor as JCompressor,
    KeccakFieldSponge as JSponge,
)
from plonky3_tpu.merkle.extension_mmcs import ExtensionMmcs as JExtMmcs
from plonky3_tpu.merkle.mmcs import MerkleTreeMmcs as JMmcs
from plonky3_tpu.ops import circle as jc
from plonky3_tpu.stark import proof as j_stark_proof
from plonky3_tpu_torch.challenger.serializing import SerializingChallenger32
from plonky3_tpu_torch.circle_pcs import CirclePcs
from plonky3_tpu_torch.circle_pcs import pcs as pcs_mod
from plonky3_tpu_torch.compat import fri_params_from, trace_inputs_from_numpy
from plonky3_tpu_torch.fields.mersenne31 import Mersenne31 as F
from plonky3_tpu_torch.fields.qm31 import QM31
from plonky3_tpu_torch.fri import proof as fri_proof
from plonky3_tpu_torch.fri.verifier import FriError
from plonky3_tpu_torch.hashes.keccak_sponge import (
    KeccakCompressor,
    KeccakFieldSponge,
)
from plonky3_tpu_torch.merkle.extension_mmcs import ExtensionMmcs
from plonky3_tpu_torch.merkle.mmcs import MerkleTreeMmcs
from plonky3_tpu_torch.ops import circle as pc
from plonky3_tpu_torch.stark import proof as stark_proof
from test_torch_prove import as_plain

P = (1 << 31) - 1
SHAPES = [(6, 2), (4, 5)]  # (log_n, width) of the committed matrices


def _classes(*mods):
    return {cls.__name__: cls for mod in mods for cls in vars(mod).values()
            if isinstance(cls, type) and dataclasses.is_dataclass(cls)}


_REF = _classes(j_stark_proof, j_fri_proof, j_pcs_mod)
_PORT = _classes(stark_proof, fri_proof, pcs_mod)


def _rebuild(x, classes):
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return classes[type(x).__name__](**{
            f.name: _rebuild(getattr(x, f.name), classes)
            for f in dataclasses.fields(x)})
    if isinstance(x, list):
        return [_rebuild(v, classes) for v in x]
    if isinstance(x, tuple):
        return tuple(_rebuild(v, classes) for v in x)
    return x


def to_reference(x):
    """A port proof object (circle PCS proofs too) as the reference's
    classes."""
    return _rebuild(x, _REF)


def to_port(x):
    return _rebuild(x, _PORT)


def _words(rng, shape):
    w = rng.integers(0, P, size=shape, dtype=np.uint64).astype(np.uint32)
    w.reshape(-1)[:2] = (0, P - 1)
    return w


def _t(x):
    return torch.from_numpy(np.asarray(x).astype(np.int64))


# ---- points, domains, permutations, twiddles ------------------------------
def test_points_and_domains_match_reference():
    g = pc.pt_generator(7)
    assert g == jc.pt_generator(7)
    assert pc.pt_mul(g, 37) == jc.pt_mul(g, 37)
    assert pc.pt_double(g) == jc.pt_double(g)
    assert pc.pt_sub(g, pc.pt_generator(5)) == jc.pt_sub(g, jc.pt_generator(5))
    assert pc.pt_v_n(g[0], 6) == jc.pt_v_n(g[0], 6)
    for log_n in (1, 2, 5):
        ours, ref = pc.CircleDomain.standard(log_n), jc.CircleDomain.standard(
            log_n)
        assert ours.shift == ref.shift and ours.is_standard()
        assert ours.points_natural() == ref.points_natural()
        assert ours.coset0_points() == ref.coset0_points()
        assert [ours.nth_point(i) for i in range(ours.size)] == [
            ref.nth_point(i) for i in range(ref.size)]
        assert ours.first_point() == ref.first_point()
    dom = pc.CircleDomain.standard(4)
    jdom = jc.CircleDomain.standard(4)
    big = dom.create_disjoint_domain(64)
    assert (big.log_n, big.shift) == (
        jdom.create_disjoint_domain(64).log_n,
        jdom.create_disjoint_domain(64).shift)
    assert [(d.log_n, d.shift) for d in big.split_domains(4)] == [
        (d.log_n, d.shift)
        for d in jdom.create_disjoint_domain(64).split_domains(4)]
    evals = _words(np.random.default_rng(0), (64, 3))
    for ours_c, ref_c in zip(big.split_evals(4, _t(evals)),
                             jc.CircleDomain.standard(6).split_evals(
                                 4, jnp.asarray(evals))):
        assert np.array_equal(ours_c.numpy(), np.asarray(ref_c))


@pytest.mark.parametrize("log_n", [0, 1, 3, 8])
def test_cfft_perm_indices_match_reference(log_n):
    want = jc.cfft_perm_indices(log_n)
    assert np.array_equal(pc.cfft_perm_indices(log_n), want)
    assert [pc.cfft_permute_index(i, log_n) for i in range(1 << log_n)] == \
        want.tolist()


def test_twiddles_match_reference():
    for log_n in (1, 2, 6):
        dom = pc.CircleDomain.standard(log_n)
        ours = pc.twiddles_np(dom)
        ref = jc.compute_twiddles(jc.CircleDomain.standard(log_n))
        assert len(ours) == len(ref)
        assert all(np.array_equal(a, b) for a, b in zip(ours, ref))
        inv = pc._twiddles(dom, True, "cpu")
        jinv = jc.compute_inv_twiddles(jc.CircleDomain.standard(log_n))
        assert all(np.array_equal(a.numpy(), b) for a, b in zip(inv, jinv))


# ---- the transforms --------------------------------------------------------
@pytest.mark.parametrize("log_n,added", [(2, 1), (5, 1), (6, 2)])
def test_cfft_matches_reference_and_round_trips(log_n, added):
    rng = np.random.default_rng(log_n)
    vals = _words(rng, (1 << log_n, 3))
    dom, jdom = pc.CircleDomain.standard(log_n), jc.CircleDomain.standard(
        log_n)
    coeffs = pc.cfft_interpolate(dom, _t(vals))
    assert np.array_equal(coeffs.numpy(),
                          np.asarray(jc.cfft_interpolate(jdom,
                                                         jnp.asarray(vals))))
    assert np.array_equal(pc.cfft_evaluate(dom, coeffs).numpy(), vals)
    big = pc.CircleDomain.standard(log_n + added)
    lde = pc.cfft_evaluate(big, coeffs)
    want = jc.cfft_evaluate(jc.CircleDomain.standard(log_n + added),
                            jnp.asarray(coeffs.numpy().astype(np.uint32)))
    assert np.array_equal(lde.numpy(), np.asarray(want))
    # the evaluations are the circle basis's at each point
    pts = big.points_natural()
    perm = pc.cfft_perm_indices(big.log_n)
    basis = pc.circle_basis_host(pts[perm[5]], log_n)
    assert int(lde[5, 0]) == sum(int(c) * b for c, b in zip(
        coeffs[:, 0].tolist(), basis)) % P


def test_cfft_column_blocks_give_the_whole_matrix(monkeypatch):
    rng = np.random.default_rng(9)
    vals = _t(_words(rng, (32, 7)))
    dom, big = pc.CircleDomain.standard(5), pc.CircleDomain.standard(7)
    whole = pc.cfft_evaluate(big, pc.cfft_interpolate(dom, vals))
    monkeypatch.setattr(pc, "_BLOCK_BYTES", 8 * 128 * 2)  # 2 columns
    assert pc._col_block(128) == 2
    blocks = pc.cfft_evaluate(big, pc.cfft_interpolate(dom, vals))
    assert torch.equal(whole, blocks)


# ---- selectors and the vanishing polynomial --------------------------------
def test_selectors_match_reference():
    dom, jdom = pc.CircleDomain.standard(4), jc.CircleDomain.standard(4)
    coset = dom.create_disjoint_domain(32)
    got = dom.selectors_on_coset_device(coset, "cpu")
    want = jdom.selectors_on_coset_device(jdom.create_disjoint_domain(32))
    assert set(got) == set(want)
    for k in want:
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k
    rng = np.random.default_rng(3)
    for E, JE in ((QM31, JQ),):
        t = tuple(int(v) for v in rng.integers(0, P, E.D))
        assert dom.selectors_at_point_ext(E, t) == \
            jdom.selectors_at_point_ext(JE, t)
        assert dom.vanishing_poly_at_point_ext(E, t) == \
            jdom.vanishing_poly_at_point_ext(JE, t)
        assert dom.next_point_ext(E, t) == jdom.next_point_ext(JE, t)
    # the vanishing polynomial is zero on the domain's own points
    for x, y in dom.points_natural():
        t = (y * pow(x + 1, P - 2, P)) % P
        assert dom.vanishing_poly_at_point_ext(QM31, (t, 0, 0, 0)) == \
            QM31.zero_h()


# ---- CirclePcs against the reference's ---------------------------------------
def _pcs():
    mmcs = MerkleTreeMmcs(sponge=KeccakFieldSponge(F),
                          compressor=KeccakCompressor())
    return CirclePcs(fri=fri_params_from(JFri.new_testing()), mmcs=mmcs,
                     fri_mmcs=ExtensionMmcs(inner=mmcs, D=4))


def _jpcs():
    mmcs = JMmcs(sponge=JSponge(JF), compressor=JCompressor())
    return JCirclePcs(fri=JFri.new_testing(), mmcs=mmcs,
                      fri_mmcs=JExtMmcs(inner=mmcs, D=4))


def _commit_open(pcs, mats, challenger, to_tensor):
    doms = [pcs.natural_domain_for_degree(m.shape[0]) for m in mats]
    data = pcs.commit([(d, to_tensor(m)) for d, m in zip(doms, mats)])
    challenger.observe_digest(data.root_std)
    zeta = challenger.sample_ext(4)
    opened, proof = pcs.open([(data, [[zeta]] * len(mats))], challenger)
    return data, doms, zeta, opened, proof


@pytest.fixture(scope="module")
def pcs_runs():
    rng = np.random.default_rng(11)
    mats = [_words(rng, (1 << log_n, w)) for log_n, w in SHAPES]
    ours = _commit_open(_pcs(), mats, SerializingChallenger32(F),
                        lambda m: trace_inputs_from_numpy(m, "cpu", F=F))
    ref = _commit_open(_jpcs(), mats, JChallenger(JF), jnp.asarray)
    return dict(mats=mats, ours=ours, ref=ref)


def _claims(run, values=None):
    data, doms, zeta, opened, _ = run
    values = values or [opened[0][i][0] for i in range(len(doms))]
    return [(data.root_std, [(d, [(zeta, v)])
                             for d, v in zip(doms, values)])]


def _verify(pcs, challenger, run, proof, values=None):
    challenger.observe_digest(run[0].root_std)
    challenger.sample_ext(4)
    pcs.verify(_claims(run, values), proof, challenger)


def test_pcs_commit_open_equal_reference(pcs_runs):
    ours, ref = pcs_runs["ours"], pcs_runs["ref"]
    assert ours[0].root_std == ref[0].root_std
    assert ours[2] == ref[2]
    assert as_plain(ours[3]) == as_plain(ref[3])
    assert as_plain(ours[4]) == as_plain(ref[4])
    # the LDE of each matrix in cfft order, and its evaluations back
    pcs = _pcs()
    for i, m in enumerate(pcs_runs["mats"]):
        assert np.array_equal(ours[0].matrices[i].numpy(),
                              np.asarray(ref[0].matrices[i]))
        own = pcs.get_evaluations_on_domain(ours[0], i, ours[1][i])
        assert np.array_equal(own.numpy(), m)


def test_pcs_verifiers_accept_each_others_proofs(pcs_runs):
    ours, ref = pcs_runs["ours"], pcs_runs["ref"]
    _verify(_pcs(), SerializingChallenger32(F), ours, to_port(ref[4]))
    _verify(_jpcs(), JChallenger(JF), ref, to_reference(ours[4]))


def test_pcs_verifiers_reject_changes(pcs_runs):
    ours, ref = pcs_runs["ours"], pcs_runs["ref"]
    values = [list(v) for v in (ours[3][0][i][0] for i in range(2))]
    values[0][0] = QM31.add_h(values[0][0], QM31.one_h())
    with pytest.raises(FriError):
        _verify(_pcs(), SerializingChallenger32(F), ours, ours[4], values)
    with pytest.raises(JFriError):
        _verify(_jpcs(), JChallenger(JF), ref, to_reference(ours[4]), values)
    bad = to_port(ours[4])
    bad.lambdas[0] = QM31.add_h(bad.lambdas[0], QM31.one_h())
    with pytest.raises(FriError):
        _verify(_pcs(), SerializingChallenger32(F), ours, bad)
    with pytest.raises(JFriError):
        _verify(_jpcs(), JChallenger(JF), ref, to_reference(bad))
