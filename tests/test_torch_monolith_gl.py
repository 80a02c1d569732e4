"""Monolith over Goldilocks and MonolithGoldilocksAir (3,536 columns): the
port's permutation, device trace generator, debug check and GL quotient
against the JAX package's (plonky3_tpu/hashes/monolith.py:159-252,
plonky3_tpu/models/monolith_gl_air.py, plonky3_tpu/gl/stark.py
`_gl_quotient_jit`), word for word. The whole proof against the JAX
`prove_gl` is `-m slow`, as the reference's own `test_gl_monolith_e2e`
is."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from plonky3_tpu.air.api import check_constraints as j_check
from plonky3_tpu.air.api import get_symbolic_layout as j_layout
from plonky3_tpu.commit.domain import TwoAdicCoset as JCoset
from plonky3_tpu.gl import stark as jstark
from plonky3_tpu.hashes import monolith as jmono
from plonky3_tpu.models import monolith_gl_air as jair
from plonky3_tpu_torch.air.api import check_constraints, get_symbolic_layout
from plonky3_tpu_torch.commit.domain import TwoAdicCoset
from plonky3_tpu_torch.gl import field as gf
from plonky3_tpu_torch.gl.ntt import gl_coset_lde_batch
from plonky3_tpu_torch.gl.stark import gl_alpha_powers, gl_quotient
from plonky3_tpu_torch.hashes.monolith import (
    MonolithGoldilocks,
    _bar64_swar8,
    bar64_tensor,
)
from plonky3_tpu_torch.models.monolith_gl_air import (
    NUM_MONOLITH_GL_COLS,
    MonolithGoldilocksAir,
    _post_off,
    generate_monolith_gl_trace,
)
from plonky3_tpu_torch.utils.bits import bitrev_permute_axis0

P = gf.GLF.P


def _inputs(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, P, (n, 8), dtype=np.uint64)
    x[0] = P - 1
    return x


@pytest.mark.parametrize("width", [8, 12])
def test_permutation_matches_reference(width):
    ours, ref = MonolithGoldilocks(width=width), jmono.MonolithGoldilocks(
        width=width)
    assert ours.rc == ref.rc and ours.mds_row == ref.mds_row
    rng = np.random.default_rng(width)
    for _ in range(4):
        s = [int(v) for v in rng.integers(0, P, width, dtype=np.uint64)]
        assert ours.permute_host(s) == ref.permute_host(s)
    assert ours.permute_host(list(range(width))) == ref.permute_host(
        list(range(width)))


def test_bar_tensor_matches_reference():
    rng = np.random.default_rng(9)
    v = np.concatenate([rng.integers(0, 1 << 63, 500, dtype=np.uint64) * 2
                        + 1, np.array([0, P - 1, (1 << 64) - 1, P],
                                      dtype=np.uint64)])
    got = gf.to_numpy(bar64_tensor(gf.to_tensor(v)))
    assert [int(g) for g in got] == [jmono._bar64_swar8(int(x)) for x in v]
    assert all(_bar64_swar8(int(x)) == int(g) for x, g in zip(v, got))


@pytest.mark.parametrize("n", [4, 8])
def test_trace_matches_reference(n):
    """The device generator (all rows at once, int64 tensors) against
    the reference's per-row object-dtype generator."""
    x = _inputs(n, n)
    tr = generate_monolith_gl_trace(x, device="cpu")
    assert tr.shape == (n, NUM_MONOLITH_GL_COLS)
    want = jair.generate_monolith_gl_trace(x.astype(object)).astype(
        np.uint64)
    assert (gf.to_numpy(tr) == want).all()
    perm = MonolithGoldilocks(width=8)
    for r in range(n):
        assert [int(v) for v in gf.to_numpy(tr[r, _post_off(5):_post_off(5)
                                                + 8])] == perm.permute_host(
            [int(v) for v in x[r]])


def test_layout_and_debug_check_match_reference():
    """The symbolic layout; the debug backend (Python ints for a 64-bit
    field) passes the trace and names the same failing constraints and
    rows as the reference's on a tampered one."""
    air, j_air = MonolithGoldilocksAir(), jair.MonolithGoldilocksAir()
    assert get_symbolic_layout(air) == j_layout(j_air)
    trace = gf.to_numpy(generate_monolith_gl_trace(_inputs(4, 1),
                                                   device="cpu"))
    assert check_constraints(air, trace, []) == []
    bad = trace.copy()
    bad[1, _post_off(2) + 3] = (int(bad[1, _post_off(2) + 3]) + 1) % P
    bad[3, 9] ^= np.uint64(1)  # a bit of round 0's first bar
    got = check_constraints(air, bad, [])
    assert got and got == j_check(j_air, bad.astype(object), [])


def test_quotient_matches_reference():
    """The GL quotient of an 8-row trace over its 16-point quotient coset,
    folded by blocks (2 rows a block, from the bit-reversed rows) against
    the reference's one-program fold, run op by op."""
    log_n, n = 3, 8
    air, j_air = MonolithGoldilocksAir(), jair.MonolithGoldilocksAir()
    trace = generate_monolith_gl_trace(_inputs(n, 2), device="cpu")
    dom = TwoAdicCoset(gf.GLF, 1, log_n)
    qdom = dom.create_disjoint_domain(2 * n)
    lde = gl_coset_lde_batch(trace, 1, qdom.shift)  # bit-reversed rows
    alpha = (123456789, P - 5)
    aps = gl_alpha_powers(air, alpha, torch.device("cpu"))
    got = gl_quotient(air, dom, qdom, lde, [], aps, block_rows=2)

    natural = gf.to_numpy(bitrev_permute_axis0(lde, qdom.log_n))
    jdom = JCoset(jstark.GLF, 1, log_n)
    jq = jdom.create_disjoint_domain(2 * n)
    sels = jstark.gl_selectors_on_coset(jdom, jq)
    lo, hi = gf.split_host(natural).reshape(2 * n, -1, 2).transpose(2, 0, 1)
    with jax.disable_jit():
        want = jstark._gl_quotient_jit(
            j_air, jnp.asarray(lo), jnp.asarray(hi), sels,
            (jnp.zeros(0, jnp.uint32), jnp.zeros(0, jnp.uint32)),
            jnp.asarray(gf.split_host(gf.to_numpy(aps))), False, 2)
    assert (gf.to_numpy(got) == gf.join_host(np.asarray(want))).all()


@pytest.mark.slow
def test_proof_equals_reference():
    from plonky3_tpu.fri.config import FriParameters as JFriParameters
    from plonky3_tpu.stark.verifier import verify as j_verify
    from plonky3_tpu_torch.fri.config import FriParameters
    from plonky3_tpu_torch.gl.stark import goldilocks_stark_config, prove_gl
    from plonky3_tpu_torch.stark.verifier import verify
    from torch_gl_reference import (as_plain, reference_config,
                                    reference_prove, to_reference)

    x = _inputs(4, 7)
    trace = generate_monolith_gl_trace(x, device="cpu")
    cfg = goldilocks_stark_config(FriParameters.new_testing(), device="cpu")
    proof = prove_gl(cfg, MonolithGoldilocksAir(), trace, [])
    j_cfg = reference_config(JFriParameters.new_testing())
    j_air = jair.MonolithGoldilocksAir()
    ref = reference_prove(j_cfg, j_air, gf.to_numpy(trace), [])
    assert as_plain(proof) == as_plain(ref)
    verify(cfg, MonolithGoldilocksAir(), proof, [])
    j_verify(j_cfg, j_air, to_reference(proof), [])
