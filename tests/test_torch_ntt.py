"""plonky3_tpu_torch NTT against plonky3_tpu: the radix-2 network, the
coset LDE, the four-step kernel contract (held against the Pallas kernels
run in interpret mode, as tests/test_ntt_pallas.py runs them) and the
four-step tables the CUDA kernels read. Exact equality throughout."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from plonky3_tpu.fields import KoalaBear as JF
from plonky3_tpu.ops import ntt as jntt
from plonky3_tpu.ops.ntt_pallas import dif_fused as j_dif_fused
from plonky3_tpu_torch.fields import KoalaBear as F
from plonky3_tpu_torch.ops import ntt
from plonky3_tpu_torch.ops import ntt_cuda


def _t(x):
    return torch.from_numpy(np.asarray(x).astype(np.int64))


def _words(x):
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int32))


@pytest.mark.parametrize("log_n,w", [(1, 3), (4, 1), (7, 5), (10, 2)])
@pytest.mark.parametrize("inverse", [False, True])
def test_dif_matches_reference(log_n, w, inverse):
    rng = np.random.default_rng(log_n * 13 + w)
    x = JF.rand_np(rng, (1 << log_n, w))
    want = np.asarray(jntt._dif(JF, jnp.asarray(x), log_n, inverse))
    assert np.array_equal(ntt._dif(F, _t(x), log_n, inverse).numpy(), want)
    assert np.array_equal(
        ntt._dif_plain(F, _t(x), log_n, inverse).numpy(), want)


@pytest.mark.parametrize("log_n,w,added", [(3, 2, 1), (6, 3, 1), (5, 4, 2),
                                           (4, 1, 0)])
@pytest.mark.parametrize("order", ["bitrev", "natural"])
def test_coset_lde_matches_reference(log_n, w, added, order):
    rng = np.random.default_rng(log_n + 7 * w + added)
    x = JF.rand_np(rng, (1 << log_n, w))
    shift = JF.mul_h(JF.GENERATOR, 5)
    want, want_c = jntt.coset_lde_batch(JF, jnp.asarray(x), added, shift,
                                        out_order=order, with_coeffs=True)
    got, got_c = ntt.coset_lde_batch(F, _t(x), added, shift,
                                     out_order=order, with_coeffs=True)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(got_c.numpy(), np.asarray(want_c))


def test_dft_idft_eval_match_reference():
    rng = np.random.default_rng(11)
    x = JF.rand_np(rng, (32, 3))
    assert np.array_equal(ntt.dft(F, _t(x)).numpy(),
                          np.asarray(jntt.dft(JF, jnp.asarray(x))))
    assert np.array_equal(ntt.idft(F, _t(x)).numpy(),
                          np.asarray(jntt.idft(JF, jnp.asarray(x))))
    zp = JF.rand_np(rng, (32, 4))
    from plonky3_tpu.fields import KoalaBearExt4 as JE
    want = jntt.eval_coeffs_at_point_ext(JE, JF, jnp.asarray(x),
                                         jnp.asarray(zp))
    assert np.array_equal(
        ntt.eval_coeffs_at_point_ext(None, F, _t(x), _t(zp)).numpy(),
        np.asarray(want))
    want = jntt.coset_evals_from_coeffs(JF, jnp.asarray(x), 1, 3)
    assert np.array_equal(ntt.coset_evals_from_coeffs(F, _t(x), 1, 3)
                          .numpy(), np.asarray(want))


# the cases of tests/test_ntt_pallas.py (KoalaBear)
@pytest.mark.parametrize("log_n,w,inverse", [
    (6, 5, False), (6, 5, True), (9, 128, False), (9, 128, True),
    (13, 200, False)])
def test_dif_fused_matches_pallas(log_n, w, inverse):
    rng = np.random.default_rng(log_n * 31 + w)
    x = JF.rand_np(rng, (1 << log_n, w))
    want = np.asarray(j_dif_fused(JF, jnp.asarray(x), log_n, inverse))
    got = ntt_cuda.dif_fused(F, _words(x), log_n, inverse)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy().view(np.uint32), want)


@pytest.mark.parametrize("log_n,w", [(6, 5), (9, 128), (13, 200)])
def test_dif_fused_zero_top_matches_pallas(log_n, w):
    rng = np.random.default_rng(log_n * 7 + w)
    half = JF.rand_np(rng, (1 << (log_n - 1), w))
    want = np.asarray(j_dif_fused(JF, jnp.asarray(half), log_n, False,
                                  zero_top=True))
    got = ntt_cuda.dif_fused(F, _words(half), log_n, False, zero_top=True)
    assert np.array_equal(got.numpy().view(np.uint32), want)


def _shoup(a, w, wsh, P):
    """The kernels' Shoup product on uint64 numpy lanes."""
    q = (a * wsh) >> np.uint64(32)
    r = (a * w - q * np.uint64(P)) & np.uint64(0xFFFFFFFF)
    return np.where(r >= P, r - np.uint64(P), r)


def _four_step(x, log_n, inverse, zero_top):
    """numpy model of csrc/ntt.cu (k1 then k2) on the tables that
    ntt_cuda hands the kernels."""
    P = F.P
    log_a, log_b = ntt_cuda.split(log_n)
    A, B = 1 << log_a, 1 << log_b
    tw_a, tw_b, corr = (t.astype(np.uint64)
                        for t in ntt_cuda.tables_np(F, log_n, inverse))
    w = x.shape[1]

    def dif(s, log_m, first, tw):
        hm = (1 << log_m) >> 1
        for st in range(first, log_m):
            half = hm >> st
            idx = np.arange(hm)
            j = idx % half
            i0 = (idx // half) * 2 * half + j
            i1 = i0 + half
            t, u = s[i0], s[i1]
            k = (j << st)[:, None]
            s[i0] = (t + u) % P
            s[i1] = _shoup((t + P - u) % P, tw[k], tw[hm + k], P)
        return s

    a_in = A >> 1 if zero_top else A
    X = x.astype(np.uint64).reshape(a_in, B, w)
    y = np.zeros((A, B, w), np.uint64)
    for b in range(B):
        s = np.zeros((A, w), np.uint64)
        s[:a_in] = X[:, b]
        first = 0
        if zero_top:
            h = A >> 1
            s[h:] = _shoup(s[:h], tw_a[:h, None], tw_a[h:2 * h, None], P)
            first = 1
        s = dif(s, log_a, first, tw_a)
        r = np.arange(A) * B + b
        y[:, b] = _shoup(s, corr[r][:, None], corr[A * B + r][:, None], P)
    out = np.stack([dif(y[a].copy(), log_b, 0, tw_b) for a in range(A)])
    return out.reshape(A * B, w).astype(np.uint32)


@pytest.mark.parametrize("log_n,w", [(1, 3), (2, 2), (5, 3), (8, 4)])
@pytest.mark.parametrize("inverse", [False, True])
def test_four_step_tables_reproduce_dif(log_n, w, inverse):
    """The kernels' algorithm on their tables equals the radix-2
    network: the Shoup products with standard-form twiddles give the
    Montgomery products with Montgomery twiddles, and the four-step
    split with its correction gives the same rows."""
    rng = np.random.default_rng(log_n + w)
    x = JF.rand_np(rng, (1 << log_n, w))
    want = ntt._dif_plain(F, _t(x), log_n, inverse).numpy()
    assert np.array_equal(_four_step(x, log_n, inverse, False), want)
    if not inverse:
        half = x[: len(x) // 2]
        pad = np.concatenate([half, np.zeros_like(half)])
        want = ntt._dif_plain(F, _t(pad), log_n, False).numpy()
        assert np.array_equal(_four_step(half, log_n, False, True), want)


def test_shoup_twiddle_equals_monty_twiddle():
    rng = np.random.default_rng(2)
    a = JF.rand_np(rng, (1000,)).astype(np.uint64)
    w_std = JF.rand_np(rng, (1000,), monty=False)
    got = _shoup(a, w_std.astype(np.uint64),
                 F.shoup_np(w_std).astype(np.uint64), F.P)
    want = JF.mul_np(a.astype(np.uint32), JF.to_monty_np(w_std))
    assert np.array_equal(got.astype(np.uint32), want)


def test_wrapper_rejects_what_the_kernels_do_not_take():
    x = torch.zeros((8, 3), dtype=torch.int32)
    with pytest.raises(ValueError):
        ntt_cuda.dif_fused(F, x, 4, False)  # wrong height
    with pytest.raises(ValueError):
        ntt_cuda.dif_fused(F, x.to("meta"), 3, False)  # not CUDA
