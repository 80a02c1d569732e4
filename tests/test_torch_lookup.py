"""The LogUp lookup of plonky3_tpu_torch against plonky3_tpu's
(`stark/lookup.py`), with the reference's RangeCheckAir (a 0..n-1 table
column and looked-up values with their multiplicities) under the
Poseidon2 config: the device-built permutation trace equals the
reference's host loop word for word at log_n 4 to 6, through either base
inverse; the proof and the permutation root equal the JAX package's and
each verifier accepts the other's; an unbalanced trace raises ValueError
in both provers, and a tampered permutation root is rejected by both
verifiers with the same error class and message."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plonky3_tpu.air.api import BaseAir as JBaseAir
from plonky3_tpu.fields import KoalaBear as JF
from plonky3_tpu.fields import KoalaBearExt4 as JE
from plonky3_tpu.fri.config import FriParameters as JFriParameters
from plonky3_tpu.stark import lookup as j_lookup
from plonky3_tpu.stark.config import poseidon2_stark_config as j_config
from plonky3_tpu_torch.air.api import BaseAir
from plonky3_tpu_torch.compat import fri_params_from
from plonky3_tpu_torch.fields import KoalaBear as F
from plonky3_tpu_torch.fields import KoalaBearExt4 as E
from plonky3_tpu_torch.stark import lookup
from plonky3_tpu_torch.stark.config import poseidon2_stark_config
from test_torch_prove import _raised, as_plain, to_port, to_reference

PARAMS = JFriParameters.new_testing()
COLS = lookup.LookupColumns(a=0, m_a=1, b=2, m_b=3)
J_COLS = j_lookup.LookupColumns(a=0, m_a=1, b=2, m_b=3)


def _range_check(base):
    class RangeCheckAir(base):
        """The table column counts 0, 1, ..., n-1; the lookup proves
        every `a` lies in it."""

        width = 4  # a, m_a, b, m_b
        num_public_values = 0

        def __init__(self, field):
            self.field = field

        def eval(self, bld):
            local, nxt = bld.main.local, bld.main.next
            bld.when_first_row().assert_zero(local[2])
            bld.when_transition().assert_eq(nxt[2], local[2] + 1)

    return RangeCheckAir


RangeCheckAir = _range_check(BaseAir)
JRangeCheckAir = _range_check(JBaseAir)


def make_trace(seed, log_n):
    """(n, 4) standard-form words: a, m_a = 1, the table 0..n-1 and its
    multiplicities (the reference test's trace)."""
    rng = np.random.default_rng(seed)
    n = 1 << log_n
    a = rng.integers(0, n, size=n)
    trace = np.zeros((n, 4), dtype=np.uint32)
    trace[:, 0] = a
    trace[:, 1] = 1
    trace[:, 2] = np.arange(n)
    trace[:, 3] = np.bincount(a, minlength=n)
    return trace


def _tensor(trace):
    return torch.from_numpy(F.to_monty_np(trace).astype(np.int64))


@pytest.mark.parametrize("log_n", [4, 5, 6])
def test_permutation_trace_equals_reference(log_n):
    trace = make_trace(log_n, log_n)
    beta = tuple(int(x) for x in
                 np.random.default_rng(log_n).integers(0, F.P, size=4))
    want = j_lookup.build_permutation_trace(JE, trace, J_COLS, beta)
    for base_inv in (None, F.inv):
        got = lookup.build_permutation_trace(E, _tensor(trace), COLS, beta,
                                             base_inv=base_inv)
        assert np.array_equal(F.from_monty_np(got.numpy()), want)


@pytest.fixture(scope="module")
def proofs():
    trace = make_trace(5, 4)
    j_cfg = j_config(JF, JE, PARAMS)
    ref, ref_root = j_lookup.prove_with_lookup(
        j_cfg, JRangeCheckAir(JF), jnp.asarray(JF.to_monty_np(trace)), [],
        J_COLS)
    cfg = poseidon2_stark_config(F, E, fri_params_from(PARAMS),
                                 device="cpu")
    ours, root = lookup.prove_with_lookup(cfg, RangeCheckAir(F),
                                          _tensor(trace), [], COLS)
    return dict(ref=ref, ref_root=ref_root, ours=ours, root=root,
                j_cfg=j_cfg, cfg=cfg)


def test_proof_equals_reference(proofs):
    assert proofs["root"] == proofs["ref_root"]
    assert as_plain(proofs["ours"]) == as_plain(proofs["ref"])
    j_lookup.verify_with_lookup(proofs["j_cfg"], JRangeCheckAir(JF),
                                to_reference(proofs["ours"]), proofs["root"],
                                [], J_COLS)
    lookup.verify_with_lookup(proofs["cfg"], RangeCheckAir(F),
                              to_port(proofs["ref"]), proofs["ref_root"], [],
                              COLS)


def test_unbalanced_lookup_raises(proofs):
    trace = make_trace(6, 4)
    trace[3, 0] = (trace[3, 0] + 1) % 16  # `a` no longer matches m_b
    with pytest.raises(ValueError, match="unbalanced lookup"):
        lookup.prove_with_lookup(proofs["cfg"], RangeCheckAir(F),
                                 _tensor(trace), [], COLS)
    with pytest.raises(ValueError, match="unbalanced lookup"):
        j_lookup.prove_with_lookup(proofs["j_cfg"], JRangeCheckAir(JF),
                                   jnp.asarray(JF.to_monty_np(trace)), [],
                                   J_COLS)


def test_tampered_perm_root_rejected(proofs):
    bad_root = tuple((x + 1) % F.P for x in proofs["root"])
    got = _raised(lambda: lookup.verify_with_lookup(
        proofs["cfg"], RangeCheckAir(F), proofs["ours"], bad_root, [], COLS))
    want = _raised(lambda: j_lookup.verify_with_lookup(
        proofs["j_cfg"], JRangeCheckAir(JF), to_reference(proofs["ours"]),
        bad_root, [], J_COLS))
    assert got == want
    assert got[0] == "VerificationError"
