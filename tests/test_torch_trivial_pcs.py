"""TrivialPcs of plonky3_tpu_torch against plonky3_tpu's
(`commit/trivial_pcs.py`, the test PCS whose commitment is the
coefficients in the clear), function by function on the same random
evaluations over domains with shift 1 and another: the coefficients and
the flat root, the evaluations over a larger coset, the opened values
and the transcript after them, the verifier's acceptance and its
rejection of a changed value or root. The uni-stark prover takes neither
package's TrivialPcs: both raise the same AttributeError."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plonky3_tpu.challenger.serializing import (
    SerializingChallenger32 as JChallenger)
from plonky3_tpu.commit.domain import TwoAdicCoset as JCoset
from plonky3_tpu.commit.trivial_pcs import TrivialPcs as JTrivialPcs
from plonky3_tpu.fields import KoalaBearExt4 as JE
from plonky3_tpu.fields.params import KoalaBear as JF
from plonky3_tpu.fri.config import FriParameters as JFriParameters
from plonky3_tpu.models.fibonacci import FibonacciAir as JFibonacciAir
from plonky3_tpu.models.fibonacci import (
    generate_fibonacci_trace as j_fibonacci_trace)
from plonky3_tpu.stark.config import StarkConfig as JStarkConfig
from plonky3_tpu.stark.prover import prove as j_prove
from plonky3_tpu_torch.challenger.serializing import SerializingChallenger32
from plonky3_tpu_torch.commit.domain import TwoAdicCoset
from plonky3_tpu_torch.commit.trivial_pcs import TrivialPcs
from plonky3_tpu_torch.compat import fri_params_from
from plonky3_tpu_torch.fields import KoalaBear as F
from plonky3_tpu_torch.fields import KoalaBearExt4 as E
from plonky3_tpu_torch.models.fibonacci import (FibonacciAir,
                                                generate_fibonacci_trace)
from plonky3_tpu_torch.stark.config import StarkConfig
from plonky3_tpu_torch.stark.prover import prove
from test_torch_prove import _raised

PARAMS = JFriParameters.new_testing()
# (log_n, width, shift) of each committed matrix
MATS = [(4, 3, 1), (3, 2, 1), (3, 1, F.GENERATOR)]


def _setup():
    rng = np.random.default_rng(21)
    evals = [F.to_monty_np(rng.integers(0, F.P, (1 << log_n, w),
                                        dtype=np.uint64).astype(np.uint32))
             for log_n, w, _ in MATS]
    pcs = TrivialPcs(F=F, E=E, fri=fri_params_from(PARAMS))
    j_pcs = JTrivialPcs(F=JF, E=JE, fri=PARAMS)
    data = pcs.commit([(TwoAdicCoset(F, s, log_n),
                        torch.from_numpy(e.astype(np.int64)))
                       for (log_n, _, s), e in zip(MATS, evals)])
    j_data = j_pcs.commit([(JCoset(JF, s, log_n), jnp.asarray(e))
                           for (log_n, _, s), e in zip(MATS, evals)])
    return pcs, data, j_pcs, j_data


@pytest.fixture(scope="module")
def setup():
    return _setup()


@pytest.mark.parametrize("i", range(len(MATS)))
def test_commit_equals_reference(setup, i):
    _, data, _, j_data = setup
    assert np.array_equal(data.coeffs_std[i], j_data.coeffs_std[i])
    assert data.domains[i].log_n == j_data.domains[i].log_n


def test_root_equals_reference(setup):
    _, data, _, j_data = setup
    assert data.root_std == j_data.root_std


@pytest.mark.parametrize("i", range(len(MATS)))
@pytest.mark.parametrize("added", [0, 1, 2])
def test_evaluations_on_domain_equal_reference(setup, i, added):
    pcs, data, j_pcs, j_data = setup
    log_n = MATS[i][0] + added
    got = pcs.get_evaluations_on_domain(
        data, i, TwoAdicCoset(F, F.GENERATOR, log_n))
    want = j_pcs.get_evaluations_on_domain(
        j_data, i, JCoset(JF, JF.GENERATOR, log_n))
    assert np.array_equal(got.numpy().astype(np.uint32), np.asarray(want))


def _points():
    z = (3, 1, 4, 1)
    return [[z, E.base_mul_h(5, z)], [z], [E.one_h()]]


def _open_both(setup):
    pcs, data, j_pcs, j_data = setup
    ch, j_ch = SerializingChallenger32(F), JChallenger(JF)
    opened, proof = pcs.open([(data, _points())], ch)
    j_opened, j_proof = j_pcs.open([(j_data, _points())], j_ch)
    return opened, proof, ch, j_opened, j_proof, j_ch


def test_open_equals_reference(setup):
    opened, proof, ch, j_opened, j_proof, j_ch = _open_both(setup)
    assert opened == j_opened
    assert proof is None and j_proof is None
    assert ch.sample_ext(4) == j_ch.sample_ext(4)


def _claims(data, opened):
    return [(data.root_std, [
        (dom, list(zip(pts, vals)))
        for dom, pts, vals in zip(data.domains, _points(), opened[0])])]


@pytest.mark.parametrize("tamper", [None, "value", "root"])
def test_verify_as_reference(setup, tamper):
    pcs, data, j_pcs, j_data = setup
    opened = _open_both(setup)[0]
    claims = _claims(data, opened)
    if tamper == "value":
        vals = claims[0][1][0][1][0][1]
        vals[0] = tuple((x + 1) % F.P for x in vals[0])
    elif tamper == "root":
        claims = [(claims[0][0][:-1], claims[0][1])]

    def run(p):
        return lambda: p.verify(claims, None, SerializingChallenger32(F))

    if tamper is None:
        pcs.verify(claims, None, SerializingChallenger32(F))
        j_pcs.verify(claims, None, JChallenger(JF))
        return
    got = _raised(run(pcs))
    want = _raised(lambda: j_pcs.verify(claims, None, JChallenger(JF)))
    assert got == want
    assert got[0] == "FriError"


def test_uni_stark_prove_refuses_it_as_reference():
    """The reference's own uni-stark use of TrivialPcs fails: its prover
    data has no `commitment`. The port's prove fails alike."""
    rows, publics = j_fibonacci_trace(JF, 4)
    want = _raised(lambda: j_prove(
        JStarkConfig(pcs=JTrivialPcs(F=JF, E=JE, fri=PARAMS)),
        JFibonacciAir(JF), jnp.asarray(JF.to_monty_np(rows)), publics))
    trace, publics = generate_fibonacci_trace(F, 4, device="cpu")
    got = _raised(lambda: prove(
        StarkConfig(pcs=TrivialPcs(F=F, E=E, fri=fri_params_from(PARAMS)),
                    device=torch.device("cpu")),
        FibonacciAir(F), trace, publics))
    assert got == want
    assert got[0] == "AttributeError"
