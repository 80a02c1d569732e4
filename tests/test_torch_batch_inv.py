"""Batch inversion, the square root and the degree-8 extension fields of
plonky3_tpu_torch against plonky3_tpu's: `batch_inv` (the log-depth
scans) and `batch_inv_np` (the host Montgomery trick) with zeros mapped
to zero, `try_sqrt_h`, and KoalaBearExt8 / BabyBearExt8 products,
inverses (the reference's go through its `batch_inv` hook, the port's
through the base field's Fermat inverse: an inverse is unique), Frobenius
maps and powers against the reference's. Every comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plonky3_tpu import fields as jfields
from plonky3_tpu_torch import fields
from plonky3_tpu_torch.compat import field_from
from plonky3_tpu_torch.fields.batch_inv import batch_inv

BASES = {"kb": (fields.KoalaBear, jfields.KoalaBear),
         "bb": (fields.BabyBear, jfields.BabyBear)}
EXT8 = {"kb8": (fields.KoalaBearExt8, jfields.KoalaBearExt8),
        "bb8": (fields.BabyBearExt8, jfields.BabyBearExt8)}


def _t(x):
    return torch.from_numpy(np.asarray(x).astype(np.int64))


@pytest.mark.parametrize("n", [1, 2, 3, 64, 257, 1000])
@pytest.mark.parametrize("key", sorted(BASES))
def test_batch_inv_equals_reference(key, n):
    F, JF = BASES[key]
    a = JF.rand_np(np.random.default_rng(n), (n,))
    a[::7] = 0
    want = np.asarray(JF.batch_inv(jnp.asarray(a))).astype(np.int64)
    got = F.batch_inv(_t(a))
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got.numpy(), F.inv(_t(a)).numpy())
    assert (got.numpy()[::7] == 0).all()


@pytest.mark.parametrize("key", sorted(BASES))
def test_batch_inv_keeps_shape(key):
    F, JF = BASES[key]
    a = JF.rand_np(np.random.default_rng(4), (5, 3, 7))
    a[1, 2] = 0
    got = batch_inv(F, _t(a))
    assert got.shape == (5, 3, 7)
    assert np.array_equal(got.numpy(), F.inv(_t(a)).numpy())


@pytest.mark.parametrize("n", [0, 1, 33])
@pytest.mark.parametrize("key", sorted(BASES))
def test_batch_inv_np_equals_reference(key, n):
    F, JF = BASES[key]
    a = JF.rand_np(np.random.default_rng(9 + n), (n,))
    a[::5] = 0
    got = F.batch_inv_np(a)
    assert got.dtype == np.uint32
    assert np.array_equal(got, JF.batch_inv_np(a))


@pytest.mark.parametrize("key", sorted(BASES))
def test_try_sqrt_equals_reference(key):
    F, JF = BASES[key]
    kinds = set()
    for x in np.random.default_rng(11).integers(1, F.P, size=40,
                                                 dtype=np.uint64):
        r = F.try_sqrt_h(int(x))
        assert r == JF.try_sqrt_h(int(x))
        kinds.add(r is None)
        if r is not None:
            assert r * r % F.P == int(x)
    assert kinds == {True, False}
    assert F.try_sqrt_h(0) == 0


def test_field_from_maps_ext8():
    for key in EXT8:
        E, JE = EXT8[key]
        assert field_from(JE) is E


@pytest.mark.parametrize("key", sorted(EXT8))
def test_ext8_ops_equal_reference(key):
    E, JE = EXT8[key]
    assert (E.D, E.W, E.DTH_ROOT, E.EXT_GENERATOR, E.EXT_TWO_ADICITY) == (
        JE.D, JE.W, JE.DTH_ROOT, JE.EXT_GENERATOR, JE.EXT_TWO_ADICITY)
    rng = np.random.default_rng(12)
    JF = JE.base
    a = JF.rand_np(rng, (37, 8))
    b = JF.rand_np(rng, (37, 8))
    a[3] = 0  # the zero element: its inverse is zero
    want_mul = np.asarray(JE.mul(jnp.asarray(a), jnp.asarray(b)))
    want_inv = np.asarray(JE.inv(jnp.asarray(a)))
    want_frob = np.asarray(JE.frobenius(jnp.asarray(a)))
    assert np.array_equal(E.mul(_t(a), _t(b)).numpy(), want_mul)
    assert np.array_equal(E.mul_np(a, b), want_mul)
    assert np.array_equal(E.inv(_t(a)).numpy(), want_inv)
    assert np.array_equal(E.frobenius(_t(a)).numpy(), want_frob)
    assert not want_inv[3].any()
    one = E.mul(_t(a), E.inv(_t(a))).numpy()
    nz = np.arange(37) != 3
    assert (one[nz, 0] == E.base.to_monty_h(1)).all()
    assert not one[nz, 1:].any()


@pytest.mark.parametrize("key", sorted(EXT8))
def test_ext8_host_math_equals_reference(key):
    E, JE = EXT8[key]
    rng = np.random.default_rng(13)
    x = JE.rand_h(rng)
    y = JE.rand_h(rng)
    assert E.mul_h(x, y) == JE.mul_h(x, y)
    assert E.inv_h(x) == JE.inv_h(x)
    assert E.frobenius_h(x) == JE.frobenius_h(x)
    assert E.exp_h(x, 12345) == JE.exp_h(x, 12345)
    assert np.array_equal(E.powers_np(x, 21), JE.powers_np(x, 21))
