"""Poseidon1, the MDS permutations and Poseidon1VectorAir of
plonky3_tpu_torch against plonky3_tpu's: `permute_host`, `permute_np`
and the tensor permutation over KoalaBear and BabyBear at widths 16 and
24; `CirculantMds`, `CosetMds` and the Karatsuba circulant product; the
AIR's trace (V = 2) and final states, its layout and debug check, its
fold against the port's generic fold and the JAX fold; and proofs at
log_n 6 (V = 1) equal to the JAX `prove` under the keccak and the
Poseidon2 configs, verified by both verifiers. Every comparison is
exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plonky3_tpu.air.api import check_constraints as j_check_constraints
from plonky3_tpu.fields import BabyBear as JBB
from plonky3_tpu.fields import KoalaBear as JF
from plonky3_tpu.fields import KoalaBearExt4 as JE
from plonky3_tpu.hashes import mds as j_mds
from plonky3_tpu.hashes import poseidon1 as j_p1
from plonky3_tpu.models import poseidon1_air as j_air
from plonky3_tpu.stark import config as j_config
from plonky3_tpu.stark.prover import prove as j_prove
from plonky3_tpu.stark.verifier import verify as j_verify
from plonky3_tpu_torch.air.api import (
    _make_builder,
    check_constraints,
    get_symbolic_layout,
)
from plonky3_tpu_torch.air.builder import ProverBackend
from plonky3_tpu_torch.compat import fri_params_from, poseidon1_from
from plonky3_tpu_torch.fields import BabyBear as BB
from plonky3_tpu_torch.fields import KoalaBear as F
from plonky3_tpu_torch.fields import KoalaBearExt4 as E
from plonky3_tpu_torch.hashes import mds
from plonky3_tpu_torch.hashes.poseidon1 import default_poseidon1
from plonky3_tpu_torch.models import poseidon1_air
from plonky3_tpu_torch.stark import config, fast_prover, prover
from plonky3_tpu_torch.stark.verifier import verify
from test_torch_prove import PARAMS, as_plain, to_reference

FIELDS = {"kb": (F, JF), "bb": (BB, JBB)}
LOG_N = 6


def _t(x):
    return torch.from_numpy(np.asarray(x).astype(np.int64))


@pytest.mark.parametrize("width", [16, 24])
@pytest.mark.parametrize("key", sorted(FIELDS))
def test_permutation_equals_reference(key, width):
    Fp, Jp = FIELDS[key]
    perm, ref = default_poseidon1(Fp, width), j_p1.default_poseidon1(Jp,
                                                                     width)
    assert poseidon1_from(ref) == perm
    assert (perm.d, perm.half_full, perm.partial) == (ref.d, ref.half_full,
                                                      ref.partial)
    rng = np.random.default_rng(width)
    for _ in range(3):
        st = [int(x) for x in rng.integers(0, Fp.P, width)]
        assert perm.permute_host(st) == ref.permute_host(st)
    states = Jp.rand_np(rng, (6, width))
    want = ref.permute_np(states)
    assert np.array_equal(perm.permute_np(states), want)
    assert np.array_equal(perm.permute_device(_t(states)).numpy(),
                          want.astype(np.int64))


@pytest.mark.parametrize("key", sorted(FIELDS))
def test_circulant_mds_equals_reference(key):
    Fp, Jp = FIELDS[key]
    row = default_poseidon1(Fp, 24).mds_first_row
    ours, ref = mds.CirculantMds(Fp, row), j_mds.CirculantMds(Jp, row)
    rng = np.random.default_rng(3)
    st = [int(x) for x in rng.integers(0, Fp.P, 24)]
    assert ours.permute_host(st) == ref.permute_host(st)
    states = rng.integers(0, Fp.P, (5, 24), dtype=np.uint64).astype(
        np.uint32)
    assert np.array_equal(ours.permute_np(states), ref.permute_np(states))
    monty = Jp.to_monty_np(states)
    want = np.asarray(ref.permute_device(jnp.asarray(monty)))
    assert np.array_equal(ours.permute_device(_t(monty)).numpy(),
                          want.astype(np.int64))


@pytest.mark.parametrize("width", [8, 16])
def test_coset_mds_equals_reference(width):
    ours, ref = mds.CosetMds(F, width), j_mds.CosetMds(JF, width)
    rng = np.random.default_rng(width)
    st = [int(x) for x in rng.integers(0, F.P, width)]
    assert ours.permute_host(st) == ref.permute_host(st)
    assert np.array_equal(ours._matrix_np(), ref._matrix_np())
    states = rng.integers(0, F.P, (4, width), dtype=np.uint64).astype(
        np.uint32)
    want = ref.permute_np(states)
    assert np.array_equal(ours.permute_np(states), want)
    got = ours.permute_device(_t(JF.to_monty_np(states)))
    assert np.array_equal(F.from_monty_tensor(got).numpy(),
                          want.astype(np.int64))


@pytest.mark.parametrize("width", [6, 8, 12, 16, 24])
def test_karatsuba_equals_reference(width):
    rng = np.random.default_rng(width)
    col = [int(x) for x in rng.integers(0, F.P, width)]
    states = rng.integers(0, F.P, (3, width), dtype=np.uint64).astype(
        np.uint32)
    got = mds.karatsuba_circulant_mul(F, col, states)
    assert np.array_equal(got, j_mds.karatsuba_circulant_mul(JF, col,
                                                             states))
    dense = np.array([[col[(i - j) % width] for j in range(width)]
                      for i in range(width)], dtype=np.uint64)
    want = (states.astype(np.uint64)[:, None, :] * dense % F.P).sum(
        -1) % F.P
    assert np.array_equal(got, want.astype(np.uint32))


def test_air_refuses_other_degrees():
    with pytest.raises(ValueError, match="degree-3"):
        poseidon1_air.Poseidon1VectorAir(BB, 16)


@pytest.fixture(scope="module")
def v2():
    air = poseidon1_air.Poseidon1VectorAir(F, 16, vector_len=2)
    j = j_air.Poseidon1VectorAir(JF, 16, vector_len=2)
    inputs = np.random.default_rng(11).integers(0, F.P, size=(16, 16),
                                                dtype=np.uint32)
    trace, out = poseidon1_air.generate_vectorized_trace_p1(air, inputs,
                                                            device="cpu")
    j_trace, j_out = j_air.generate_vectorized_trace_p1(j, inputs)
    return dict(air=air, j=j, inputs=inputs, trace=trace, out=out,
                j_trace=j_trace, j_out=j_out)


def test_layout_equals_reference(v2):
    air = v2["air"]
    assert (air.W, air.V, air.HF, air.PR) == (16, 2, 4, 20)
    assert air.width == v2["j"].width == 2 * 164
    assert get_symbolic_layout(air) == (2 * 148, 3)
    full = poseidon1_air.Poseidon1VectorAir(F, 16, vector_len=8)
    assert full.width == 1312 and get_symbolic_layout(full) == (1184, 3)


def test_trace_equals_reference(v2):
    assert np.array_equal(F.from_monty_tensor(v2["trace"]).numpy(),
                          v2["j_trace"].astype(np.int64))
    assert np.array_equal(v2["out"].numpy(), v2["j_out"].astype(np.int64))
    perm = v2["air"].perm
    assert v2["out"][5].tolist() == perm.permute_host(
        [int(x) for x in v2["inputs"][5]])


@pytest.mark.parametrize("col", [None, 16 + 3, 16 * 5 + 7, 164 + 100])
def test_check_constraints_equals_reference(v2, col):
    trace = v2["j_trace"].copy()
    if col is not None:
        trace[2, col] ^= 1
    got = check_constraints(v2["air"], trace, [])
    assert got == j_check_constraints(v2["j"], trace, [])
    assert (got == []) == (col is None)


def test_fold_equals_generic_and_reference(v2):
    air = v2["air"]
    rng = np.random.default_rng(12)
    local = JF.rand_np(rng, v2["j_trace"].shape)
    k, _ = get_symbolic_layout(air)
    alpha = tuple(int(x) for x in rng.integers(0, F.P, 4))
    ap = JE.powers_np(alpha, k)[::-1].copy()
    got = air.fold_constraints_device(F, E, _t(local), None, {}, None,
                                      _t(ap))
    backend = ProverBackend(F, E, _t(ap))
    air.eval(_make_builder(backend, air.width, 0,
                           lambda kind, j: _t(local[:, j]), lambda j: None))
    generic = backend.finalize((local.shape[0],))
    want = np.asarray(v2["j"].fold_constraints_device(
        JF, JE, jnp.asarray(local), jnp.asarray(local), {}, None,
        jnp.asarray(ap)))
    assert np.array_equal(got.numpy(), generic.numpy())
    assert np.array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("merkle", ["keccak", "poseidon2"])
def test_proofs_equal_reference(merkle):
    inputs = np.random.default_rng(5).integers(0, F.P, size=(1 << LOG_N, 16),
                                               dtype=np.uint32)
    j = j_air.Poseidon1VectorAir(JF, 16, vector_len=1)
    j_cfg = getattr(j_config, f"{merkle}_stark_config")(JF, JE, PARAMS)
    j_trace, _ = j_air.generate_vectorized_trace_p1(j, inputs)
    ref = j_prove(j_cfg, j, jnp.asarray(JF.to_monty_np(j_trace)), [])

    air = poseidon1_air.Poseidon1VectorAir(F, 16, vector_len=1)
    cfg = getattr(config, f"{merkle}_stark_config")(
        F, E, fri_params_from(PARAMS), device="cpu")
    trace, _ = poseidon1_air.generate_vectorized_trace_p1(air, inputs,
                                                          device="cpu")
    ours = prover.prove(cfg, air, trace, [])
    fast = fast_prover._prove_device_fs(cfg, air, trace, [])
    assert as_plain(ours) == as_plain(ref)
    assert fast == ours
    assert verify(cfg, air, fast, []) is None
    j_verify(j_cfg, j, to_reference(fast), [])
