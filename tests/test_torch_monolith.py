"""Monolith-31 and MonolithAir (3,520 columns) in the port against the
reference (monolith-air/src/lib.rs tests): the SHAKE round constants and
the permutation (`permute`, `permute_np`, `permute_host`) against the
reference's `permute_np` on inputs with 0 and P - 1; the trace from
`generate_monolith_trace` cell for cell against the reference's, its
final post state the permutation's; the constraints hold on it and fail
on a changed cell; the symbolic layout equals the reference's; the
generic quotient over 16 random quotient-domain rows (a 4-row trace)
against the JAX `quotient_values` under `jax.disable_jit()`. Exact
equality. The proof under `circle_stark_config` is `-m slow`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plonky3_tpu.air.api import get_symbolic_layout as j_layout
from plonky3_tpu.air.api import check_constraints as j_check
from plonky3_tpu.fields.mersenne31 import Mersenne31 as JF
from plonky3_tpu.fields.qm31 import QM31 as JQ
from plonky3_tpu.fri.config import FriParameters as JFri
from plonky3_tpu.hashes.monolith import MonolithM31 as JMonolith
from plonky3_tpu.models.monolith_air import MonolithAir as JAir
from plonky3_tpu.models.monolith_air import (
    generate_monolith_trace as j_generate,
)
from plonky3_tpu.stark.config import circle_stark_config as j_config
from plonky3_tpu.stark.prover import prove as j_prove
from plonky3_tpu.stark.prover import quotient_values as j_quotient_values
from plonky3_tpu_torch.air.api import (
    check_constraints,
    get_log_num_quotient_chunks,
    get_symbolic_layout,
)
from plonky3_tpu_torch.compat import fri_params_from, trace_inputs_from_numpy
from plonky3_tpu_torch.fields.mersenne31 import Mersenne31 as F
from plonky3_tpu_torch.hashes.monolith import MonolithM31
from plonky3_tpu_torch.models.monolith_air import (
    NUM_MONOLITH_COLS,
    MonolithAir,
    _post_off,
    generate_monolith_trace,
)
from plonky3_tpu_torch.stark.config import circle_stark_config
from plonky3_tpu_torch.stark.prover import prove, quotient_values
from plonky3_tpu_torch.stark.verifier import verify
from test_torch_prove import as_plain

P = (1 << 31) - 1


def _inputs(seed, n):
    x = np.random.default_rng(seed).integers(0, P, size=(n, 16),
                                             dtype=np.uint64).astype(np.uint32)
    x[0] = P - 1
    x[1] = 0
    return x


def test_permutation_matches_reference():
    ours, ref = MonolithM31(), JMonolith()
    assert ours.rc == ref.rc
    x = _inputs(1, 64)
    want = ref.permute_np(x)
    assert np.array_equal(ours.permute_np(x), want)
    got = ours.permute(torch.from_numpy(x.astype(np.int64)))
    assert np.array_equal(got.numpy(), want.astype(np.int64))
    for row in x[:3]:
        assert ours.permute_host(row.tolist()) == ref.permute_host(
            row.tolist())


def test_trace_matches_reference():
    x = _inputs(2, 8)
    trace = generate_monolith_trace(F, x, device="cpu")
    assert trace.shape == (8, NUM_MONOLITH_COLS)
    want = j_generate(JF, x)
    assert np.array_equal(trace.numpy(), want.astype(np.int64))
    # a tensor input gives the same trace on its own device
    again = generate_monolith_trace(F, trace_inputs_from_numpy(x, "cpu",
                                                               F=F))
    assert torch.equal(again, trace)


def test_final_post_matches_permutation():
    x = _inputs(3, 4)
    trace = generate_monolith_trace(F, x, device="cpu").numpy()
    got = trace[:, _post_off(5):_post_off(5) + 16]
    assert np.array_equal(got, MonolithM31().permute_np(x).astype(np.int64))


def test_constraints_hold_and_catch_a_change():
    trace = generate_monolith_trace(F, _inputs(4, 4), device="cpu").numpy()
    air = MonolithAir(F)
    assert check_constraints(air, trace, []) == []
    assert get_symbolic_layout(air) == j_layout(JAir(JF))
    bad = trace.copy()
    bad[1, _post_off(3) + 4] ^= 1
    assert check_constraints(air, bad, []) != []
    assert j_check(JAir(JF), bad.astype(np.uint32), []) != []


def test_quotient_equals_reference():
    log_n = 2
    air, j_air = MonolithAir(F), JAir(JF)
    log_q = log_n + get_log_num_quotient_chunks(air)
    j_cfg = j_config(JFri.new_testing())
    cfg = circle_stark_config(fri_params_from(JFri.new_testing()),
                              device="cpu")
    j_dom = j_cfg.pcs.natural_domain_for_degree(1 << log_n)
    dom = cfg.pcs.natural_domain_for_degree(1 << log_n)
    qrows = np.random.default_rng(6).integers(
        0, P, size=(1 << log_q, air.width), dtype=np.uint64).astype(np.uint32)
    k, _ = get_symbolic_layout(air)
    pows = JF.rand_np(np.random.default_rng(7), (k, JQ.D))
    with jax.disable_jit():
        want = np.asarray(j_quotient_values(
            j_cfg, j_air, j_dom, j_dom.create_disjoint_domain(1 << log_q),
            jnp.asarray(qrows), jnp.zeros((0,), jnp.uint32),
            jnp.asarray(pows)))
    got = quotient_values(
        cfg, air, dom, dom.create_disjoint_domain(1 << log_q),
        torch.from_numpy(qrows.astype(np.int64)),
        torch.zeros(0, dtype=torch.int64),
        torch.from_numpy(pows.astype(np.int64)))
    assert np.array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.slow
def test_monolith_air_circle_proof_equals_reference():
    x = _inputs(8, 8)
    j_cfg = j_config(JFri.new_testing())
    ref = j_prove(j_cfg, JAir(JF), jnp.asarray(j_generate(JF, x)), [])
    cfg = circle_stark_config(fri_params_from(JFri.new_testing()),
                              device="cpu")
    ours = prove(cfg, MonolithAir(F),
                 generate_monolith_trace(F, x, device="cpu"), [])
    assert as_plain(ours) == as_plain(ref)
    verify(cfg, MonolithAir(F), ours, [])
