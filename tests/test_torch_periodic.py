"""Periodic columns and the no-next-row quotient branch of
plonky3_tpu_torch against plonky3_tpu's, under the Poseidon2 config with
`FriParameters.new_testing()` (as `tests/test_periodic.py` runs them):
the debug check, the symbolic layout and the periodic values over the
quotient coset; `PeriodicAir` and `NoNextRowAir` (the first proof through
the bit-reversed fold) proven by both of the port's provers equal to the
JAX `prove`, accepted by both verifiers; a wrong-pattern trace and a
full-opening proof against the no-next-row AIR rejected by both with the
same error; and the bit-reversal gate: a PCS without
`supports_bitrev_evals` gives the prover natural rows, and the same
proof. Every comparison is exact."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from plonky3_tpu.air.api import check_constraints as j_check_constraints
from plonky3_tpu.air.api import get_symbolic_layout as j_symbolic_layout
from plonky3_tpu.fields import KoalaBear as JF
from plonky3_tpu.fields import KoalaBearExt4 as JE
from plonky3_tpu.fri.config import FriParameters as JFriParameters
from plonky3_tpu.stark.config import poseidon2_stark_config as j_config
from plonky3_tpu.stark.prover import periodic_on_coset as j_periodic_on_coset
from plonky3_tpu.stark.prover import prove as j_prove
from plonky3_tpu.stark.verifier import verify as j_verify
from plonky3_tpu_torch.air.api import check_constraints, get_symbolic_layout
from plonky3_tpu_torch.compat import fri_params_from
from plonky3_tpu_torch.fields import KoalaBear as F
from plonky3_tpu_torch.fields import KoalaBearExt4 as E
from plonky3_tpu_torch.stark import fast_prover
from plonky3_tpu_torch.stark.config import poseidon2_stark_config
from plonky3_tpu_torch.stark.prover import periodic_on_coset, prove
from plonky3_tpu_torch.stark.verifier import verify
from test_periodic import NoNextRowAir as JNoNextRowAir
from test_periodic import PeriodicAir as JPeriodicAir
from test_torch_prove import _raised, as_plain, to_reference
from torch_periodic_airs import NoNextRowAir, PeriodicAir, periodic_trace

LOG_N = 5
BAD_ROW = 3
PARAMS = JFriParameters.new_testing()
AIRS = {"periodic": (PeriodicAir, JPeriodicAir),
        "no_next_row": (NoNextRowAir, JNoNextRowAir)}


def _trace(bad=False):
    rows = periodic_trace(F.P, 1 << LOG_N, BAD_ROW if bad else None)
    return rows, torch.from_numpy(F.to_monty_np(rows).astype(np.int64))


@pytest.fixture(scope="module")
def proofs():
    """Both of the port's proofs of each AIR (honest and wrong-pattern
    traces) and the JAX proof of each honest trace."""
    cfg = poseidon2_stark_config(F, E, fri_params_from(PARAMS),
                                 device="cpu")
    j_cfg = j_config(JF, JE, PARAMS)
    out = {}
    for name, (make, j_make) in AIRS.items():
        air, j_air = make(F), j_make(JF)
        for bad in (False, True):
            rows, trace = _trace(bad)
            d = dict(ours=prove(cfg, air, trace, []),
                     fast=fast_prover._prove_device_fs(cfg, air, trace, []),
                     air=air, j_air=j_air)
            if not bad:
                d["ref"] = j_prove(j_cfg, j_air,
                                   jnp.asarray(JF.to_monty_np(rows)), [])
            out[name, bad] = d
    return dict(cases=out, cfg=cfg, j_cfg=j_cfg)


@pytest.mark.parametrize("name", sorted(AIRS))
@pytest.mark.parametrize("bad", [False, True])
def test_check_constraints_equal_reference(name, bad):
    make, j_make = AIRS[name]
    rows, _ = _trace(bad)
    got = check_constraints(make(F), rows, [])
    assert got == j_check_constraints(j_make(JF), rows, [])
    assert (got != []) == bad


@pytest.mark.parametrize("name", sorted(AIRS))
def test_symbolic_layout_equals_reference(name):
    make, j_make = AIRS[name]
    assert get_symbolic_layout(make(F)) == j_symbolic_layout(j_make(JF))


def test_periodic_values_equal_reference():
    """f(X^r) of each periodic column over the quotient coset."""
    cfg = poseidon2_stark_config(F, E, fri_params_from(PARAMS),
                                 device="cpu")
    j_cfg = j_config(JF, JE, PARAMS)
    cols = PeriodicAir(F).periodic_columns() + [[4, 2, 6, 8, 1, 0, 3, 5]]
    for log_q in (LOG_N, LOG_N + 1, LOG_N + 2):
        domain = cfg.pcs.natural_domain_for_degree(1 << LOG_N)
        j_domain = j_cfg.pcs.natural_domain_for_degree(1 << LOG_N)
        got = periodic_on_coset(
            F, cols, domain, domain.create_disjoint_domain(1 << log_q),
            "cpu")
        want = j_periodic_on_coset(
            JF, cols, j_domain, j_domain.create_disjoint_domain(1 << log_q))
        assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int64))


@pytest.mark.parametrize("which", ["ours", "fast"])
@pytest.mark.parametrize("name", sorted(AIRS))
def test_proof_equals_reference(proofs, name, which):
    d = proofs["cases"][name, False]
    assert as_plain(d[which]) == as_plain(d["ref"])
    assert (d[which].opened_values.trace_next is None) == (
        name == "no_next_row")


@pytest.mark.parametrize("which", ["ours", "fast"])
@pytest.mark.parametrize("name", sorted(AIRS))
def test_both_verifiers_accept(proofs, name, which):
    d = proofs["cases"][name, False]
    assert verify(proofs["cfg"], d["air"], d[which], []) is None
    j_verify(proofs["j_cfg"], d["j_air"], to_reference(d[which]), [])


@pytest.mark.parametrize("name", sorted(AIRS))
def test_wrong_pattern_rejected_alike(proofs, name):
    d = proofs["cases"][name, True]
    assert d["ours"] == d["fast"]
    ours = _raised(lambda: verify(proofs["cfg"], d["air"], d["ours"], []))
    ref = _raised(lambda: j_verify(proofs["j_cfg"], d["j_air"],
                                   to_reference(d["ours"]), []))
    assert ours == ref


def test_full_opening_rejected_by_no_next_row_air(proofs):
    """A proof that opens the next row does not verify against the AIR
    that declares none, in either verifier."""
    full = proofs["cases"]["periodic", False]["ours"]
    d = proofs["cases"]["no_next_row", False]
    ours = _raised(lambda: verify(proofs["cfg"], d["air"], full, []))
    ref = _raised(lambda: j_verify(proofs["j_cfg"], d["j_air"],
                                   to_reference(full), []))
    assert ours == ref
    assert ours[0] == "InvalidProofShape"


class _SpyPcs:
    """A PCS that records the row order the prover asks for, with or
    without the `supports_bitrev_evals` flag."""

    def __init__(self, inner, flag):
        self._inner = inner
        self.orders = []
        if flag:
            self.supports_bitrev_evals = True

    def __getattr__(self, name):
        if name == "supports_bitrev_evals":
            raise AttributeError(name)
        return getattr(self._inner, name)

    def get_evaluations_on_domain(self, data, mat_index, domain,
                                  order="natural"):
        self.orders.append(order)
        return self._inner.get_evaluations_on_domain(data, mat_index,
                                                     domain, order)


@pytest.mark.parametrize("name", sorted(AIRS))
@pytest.mark.parametrize("flag", [False, True])
def test_bitrev_gate(proofs, name, flag):
    """Without the flag both provers take natural rows; with it, the
    committed bit-reversed ones. The proofs are the same."""
    d = proofs["cases"][name, False]
    _, trace = _trace()
    for fn in (prove, fast_prover._prove_device_fs):
        spy = _SpyPcs(proofs["cfg"].pcs, flag)
        cfg = dataclasses.replace(proofs["cfg"], pcs=spy)
        assert as_plain(fn(cfg, d["air"], trace, [])) == as_plain(d["ours"])
        assert spy.orders == ["bitrev" if flag else "natural"]
