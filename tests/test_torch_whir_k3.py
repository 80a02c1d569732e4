"""The port's WHIR at n_vars 9 with k 3, its plain-torch kernels and the
duplex challenger's `sample_uniform_bits` against the reference's.

The WHIR proof at n_vars 9 (k 3, final_vars 3) must equal the JAX
package's field for field (tolerance zero), and each verifier accepts
the other's proof; every `multilinear/device_kernels.py` function and
the eq table equal the reference's jnp ones on the same seeded inputs;
`sample_uniform_bits` draws the reference's values. The JAX proof is
made once, in a module-scoped fixture. The n_vars 6 proof, the tampers,
the schemas and the host math are in `test_torch_whir.py`.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from plonky3_tpu.multilinear import device_kernels as jdk
from plonky3_tpu.multilinear.mle import eq_table_device as j_eq_table
from plonky3_tpu_torch.fields import KoalaBear as F
from plonky3_tpu_torch.fields import KoalaBearExt4 as E
from plonky3_tpu_torch.multilinear import device_kernels as dk
from plonky3_tpu_torch.multilinear.mle import eq_table_device
from test_torch_whir import (
    JE,
    _ch,
    _jch,
    both_proofs,
    check_cross_verify,
    check_equal,
)


@pytest.fixture(scope="module")
def proofs():
    return both_proofs("n9_k3")


def test_whir_k3_proof_equals_reference(proofs):
    check_equal(proofs["ours"], proofs["ref"], "n9_k3")


def test_each_verifier_accepts_the_others_k3_proof(proofs):
    check_cross_verify(proofs, "n9_k3")


def test_sample_uniform_bits_matches_reference():
    ours, ref = _ch(), _jch()
    for i in range(40):
        ours.observe(i)
        ref.observe(i)
        for bits in (1, 7, 20, 24, 27, 30):
            assert ours.sample_uniform_bits(bits) == (
                ref.sample_uniform_bits(bits))


# ---------------------------------------------------------------------------
# the plain-torch kernels against the reference's jnp ones
# ---------------------------------------------------------------------------
def _rand_ext(rng, shape):
    return F.to_monty_np(rng.integers(0, F.P, shape + (E.D,),
                                      dtype=np.uint64))


def test_device_kernels_match_reference():
    rng = np.random.default_rng(4)
    t = lambda a: torch.from_numpy(np.asarray(a).astype(np.int64))  # noqa
    j = lambda a: np.asarray(a).astype(np.int64)  # noqa
    a, b = _rand_ext(rng, (16,)), _rand_ext(rng, (16,))
    r = _rand_ext(rng, ())
    assert np.array_equal(dk.fold_at(E, t(a), t(r)).numpy(),
                          j(jdk.fold_at(JE, jnp.asarray(a), jnp.asarray(r))))
    assert np.array_equal(
        dk.round_poly_012(E, t(a), t(b)).numpy(),
        j(jdk.round_poly_012(JE, jnp.asarray(a), jnp.asarray(b))))
    pts, scs = _rand_ext(rng, (3, 4)), _rand_ext(rng, (3,))
    assert np.array_equal(
        dk.weighted_eq_table(E, t(pts), t(scs), 4).numpy(),
        j(jdk.weighted_eq_table(JE, jnp.asarray(pts), jnp.asarray(scs), 4)))
    assert np.array_equal(
        dk.coeffs_to_evals_device(E, t(a)).numpy(),
        j(jdk.coeffs_to_evals_device(JE, jnp.asarray(a))))
    assert np.array_equal(dk.dot_ext(E, t(a), t(b)).numpy(),
                          j(jdk.dot_ext(JE, jnp.asarray(a), jnp.asarray(b))))
    assert np.array_equal(
        dk.horner_fold_pair(E, t(a), t(r)).numpy(),
        j(jdk.horner_fold_pair(JE, jnp.asarray(a), jnp.asarray(r))))
    assert np.array_equal(dk.ext_powers(E, t(r), 3).numpy(),
                          j(jdk.ext_powers(JE, jnp.asarray(r), 3)))
    z = JE.rand_h(rng)
    assert dk.eval_univariate_device(E, t(a), z) == (
        jdk.eval_univariate_device(JE, jnp.asarray(a), z))
    assert dk.pull_ext(E, t(a)) == jdk.pull_ext(JE, jnp.asarray(a))
    rs = [JE.rand_h(rng) for _ in range(4)]
    assert np.array_equal(eq_table_device(E, rs, "cpu").numpy(),
                          j(j_eq_table(JE, rs)))
