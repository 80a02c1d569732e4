"""AIR composition of plonky3_tpu_torch against plonky3_tpu's: two named
FibonacciAirs joined side by side (`air/composition.py`). The symbolic
layout, the debug check with its namespaced failures ("fib_b/<index>"),
the proof of `prove()` and of the device-transcript prover against the
JAX `prove` under the Poseidon2 config at 16 rows, both verifiers on it,
and a changed public value of the second half rejected by both with the
same error. Every comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plonky3_tpu.air import composition as j_comp
from plonky3_tpu.air.api import check_constraints as j_check_constraints
from plonky3_tpu.air.api import get_symbolic_layout as j_symbolic_layout
from plonky3_tpu.fields import KoalaBear as JF
from plonky3_tpu.fields import KoalaBearExt4 as JE
from plonky3_tpu.models import fibonacci as j_fib
from plonky3_tpu.stark.config import poseidon2_stark_config as j_config
from plonky3_tpu.stark.prover import prove as j_prove
from plonky3_tpu.stark.verifier import verify as j_verify
from plonky3_tpu_torch.air import composition
from plonky3_tpu_torch.air.api import check_constraints, get_symbolic_layout
from plonky3_tpu_torch.compat import fri_params_from
from plonky3_tpu_torch.fields import KoalaBear as F
from plonky3_tpu_torch.fields import KoalaBearExt4 as E
from plonky3_tpu_torch.models import fibonacci
from plonky3_tpu_torch.stark import fast_prover, prover
from plonky3_tpu_torch.stark.config import poseidon2_stark_config
from plonky3_tpu_torch.stark.verifier import verify
from test_torch_prove import PARAMS, _raised, as_plain, to_reference

LOG_N = 4


def _joined(comp, fib, field):
    return comp.JoinedAir(comp.NamedAir("fib_a", fib.FibonacciAir(field)),
                          comp.NamedAir("fib_b", fib.FibonacciAir(field)))


def _trace_std():
    t1, p1 = j_fib.generate_fibonacci_trace(JF, LOG_N)
    t2, p2 = j_fib.generate_fibonacci_trace(JF, LOG_N, a=2, b=3)
    return np.concatenate([t1, t2], axis=1), p1 + p2


@pytest.fixture(scope="module")
def joined():
    trace_std, publics = _trace_std()
    j_air = _joined(j_comp, j_fib, JF)
    j_cfg = j_config(JF, JE, PARAMS)
    ref = j_prove(j_cfg, j_air, jnp.asarray(JF.to_monty_np(trace_std)),
                  publics)
    air = _joined(composition, fibonacci, F)
    cfg = poseidon2_stark_config(F, E, fri_params_from(PARAMS), device="cpu")
    t1, q1 = fibonacci.generate_fibonacci_trace(F, LOG_N, device="cpu")
    t2, q2 = fibonacci.generate_fibonacci_trace(F, LOG_N, a=2, b=3,
                                                device="cpu")
    assert q1 + q2 == publics
    trace = torch.cat([t1, t2], dim=1)
    return dict(ref=ref, j_air=j_air, j_cfg=j_cfg, air=air, cfg=cfg,
                trace=trace, publics=publics, trace_std=trace_std,
                ours=prover.prove(cfg, air, trace, publics),
                fast=fast_prover._prove_device_fs(cfg, air, trace, publics))


def test_layout_equals_reference():
    air = _joined(composition, fibonacci, F)
    assert (air.width, air.num_public_values) == (4, 6)
    assert air.max_constraint_degree() == 2
    assert get_symbolic_layout(air) == j_symbolic_layout(
        _joined(j_comp, j_fib, JF)) == (10, 2)


@pytest.mark.parametrize("cell", [None, (3, 2), (0, 0), (15, 3), (7, 1)])
def test_namespaced_failures_equal_reference(cell):
    trace, publics = _trace_std()
    if cell is not None:
        trace[cell] = (int(trace[cell]) + 1) % F.P
    got = check_constraints(_joined(composition, fibonacci, F), trace,
                            publics)
    want = j_check_constraints(_joined(j_comp, j_fib, JF), trace, publics)
    assert got == want
    assert (got == []) == (cell is None)
    if cell is not None:
        half = "fib_a/" if cell[1] < 2 else "fib_b/"
        assert all(str(f["constraint"]).startswith(half) for f in got)


def test_unnamed_failures_are_indices():
    """A plain JoinedAir labels failures by index, as before."""
    trace, publics = _trace_std()
    trace[3, 2] += 1
    air = composition.JoinedAir(fibonacci.FibonacciAir(F),
                                fibonacci.FibonacciAir(F))
    got = check_constraints(air, trace, publics)
    assert got and all(isinstance(f["constraint"], int) for f in got)


def test_proofs_equal_reference(joined):
    assert as_plain(joined["ours"]) == as_plain(joined["ref"])
    assert joined["fast"] == joined["ours"]


@pytest.mark.parametrize("which", ["ours", "fast"])
def test_both_verifiers_accept(joined, which):
    proof = joined[which]
    assert verify(joined["cfg"], joined["air"], proof,
                  joined["publics"]) is None
    j_verify(joined["j_cfg"], joined["j_air"], to_reference(proof),
             joined["publics"])


def test_changed_public_rejected_as_reference(joined):
    publics = list(joined["publics"])
    publics[5] = (publics[5] + 1) % F.P  # fib_b's claimed last value
    got = _raised(lambda: verify(joined["cfg"], joined["air"],
                                 joined["ours"], publics))
    want = _raised(lambda: j_verify(joined["j_cfg"], joined["j_air"],
                                    to_reference(joined["ours"]), publics))
    assert got == want
