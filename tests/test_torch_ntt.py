"""plonky3_tpu_torch NTT against plonky3_tpu: the radix-2 network, the
coset LDE, the four-step kernel contract (held against the Pallas kernels
run in interpret mode, as tests/test_ntt_pallas.py runs them), and numpy
models of what the CUDA kernels compute: the launch plan on the tables
they read, with the sub-transform cap lowered, and their register
schedule. Exact equality throughout."""

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


def _dif_axis1(s, log_m, first, tw):
    """The kernels' radix-2 DIF stages [first, log_m) along axis 1 of an
    (N, 2^log_m, w) uint64 array, stage st with twiddles tw[j << st]."""
    P = F.P
    hm = (1 << log_m) >> 1
    for st in range(first, log_m):
        half = hm >> st
        idx = np.arange(hm)
        j = idx % half
        i0 = (idx // half) * 2 * half + j
        i1 = i0 + half
        t, u = s[:, i0], s[:, i1]
        k = (j << st)[:, None]
        s[:, i0] = (t + u) % P
        s[:, i1] = _shoup((t + P - u) % P, tw[k], tw[hm + k], P)
    return s


def _run_plan(x, log_n, inverse, zero_top,
              max_log_half=ntt_cuda.MAX_LOG_HALF):
    """numpy model of `dif_fused` on the card: every launch of
    `ntt_cuda.plan` as csrc/ntt.cu computes it, on the tables that
    ntt_cuda hands the kernels."""
    P = F.P
    w = x.shape[1]
    cur = x.astype(np.uint64)
    for st in ntt_cuda.plan(log_n, zero_top, max_log_half):
        A, B = 1 << st.log_a, 1 << st.log_b
        tw_a, tw_b, corr = (
            t.astype(np.uint64)
            for t in ntt_cuda.tables_np(F, st.log_n, inverse, st.log_a))
        if st.kernel == "k2":
            cur = _dif_axis1(cur.reshape(st.batch * A, B, w), st.log_b, 0,
                             tw_b).reshape(-1, w)
            continue
        a_in = A >> 1 if st.zero_top else A
        s = np.zeros((st.batch, B, A, w), np.uint64)  # one row per (slab, b)
        s[:, :, :a_in] = cur.reshape(st.batch, a_in, B, w).transpose(
            0, 2, 1, 3)
        s = s.reshape(st.batch * B, A, w)
        first = 0
        if st.zero_top:
            h = A >> 1
            s[:, h:] = _shoup(s[:, :h], tw_a[:h, None], tw_a[h:2 * h, None],
                              P)
            first = 1
        s = _dif_axis1(s, st.log_a, first, tw_a).reshape(st.batch, B, A, w)
        c = corr.reshape(2, A, B).transpose(0, 2, 1)[:, None, :, :, None]
        s = _shoup(s, c[0], c[1], P)
        cur = s.transpose(0, 2, 1, 3).reshape(-1, w)
    return cur.astype(np.uint32)


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
    assert np.array_equal(_run_plan(x, log_n, inverse, False), want)
    if not inverse:
        half = x[: len(x) // 2]
        pad = np.concatenate([half, np.zeros_like(half)])
        want = ntt._dif_plain(F, _t(pad), log_n, False).numpy()
        assert np.array_equal(_run_plan(half, log_n, False, True), want)


@pytest.mark.parametrize("max_log_half", [2, 3])
@pytest.mark.parametrize("log_n", [5, 6, 7, 8])
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("zero_top", [False, True])
def test_plan_above_the_cap_reproduces_dif(max_log_half, log_n, inverse,
                                           zero_top):
    """With the sub-transform cap lowered, the plan's batched inner
    four-steps give the radix-2 network's rows, as they do above 2^20 on
    the card."""
    rng = np.random.default_rng(log_n * 5 + max_log_half)
    x = JF.rand_np(rng, (1 << log_n, 3))
    if zero_top:
        x[len(x) // 2:] = 0
    want = ntt._dif_plain(F, _t(x), log_n, inverse).numpy()
    inp = x[: len(x) // 2] if zero_top else x
    got = _run_plan(inp, log_n, inverse, zero_top, max_log_half)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("max_log_half", [2, 3, ntt_cuda.MAX_LOG_HALF])
def test_plan_levels_and_inner_generators(max_log_half):
    """Every launch fits the cap; up to 2·cap the plan is one (k1, k2) pair;
    above it each level hands A·batch slabs of B rows to the next, whose
    tables' generator w_B is the outer w_n^A."""
    for log_n in range(1, F.TWO_ADICITY + 1):
        for zero_top in (False, True):
            steps = ntt_cuda.plan(log_n, zero_top, max_log_half)
            assert [s.zero_top for s in steps] == [zero_top] + [False] * (
                len(steps) - 1)
            assert all(max(s.log_a, s.log_b if s.kernel == "k2" else 0)
                       <= max_log_half for s in steps)
            assert [s.kernel for s in steps] == ["k1"] * (len(steps) - 1) + [
                "k2"]
            if log_n <= 2 * max_log_half:
                log_a = log_n - log_n // 2
                assert steps == [
                    ntt_cuda.Launch(k, log_n, log_a, log_n - log_a, 1, z)
                    for k, z in (("k1", zero_top), ("k2", False))]
            for outer, inner in zip(steps, steps[1:-1]):
                assert outer.log_a == max_log_half
                assert inner.log_n == outer.log_b
                assert inner.batch == outer.batch << outer.log_a
                w_n = F.two_adic_generator_h(outer.log_n)
                assert F.two_adic_generator_h(inner.log_n) == pow(
                    w_n, 1 << outer.log_a, F.P)
            last_k1, k2 = steps[-2:]
            assert k2[1:5] == last_k1[1:5]


def _dif_passes(s, log_m, zero_top, tw):
    """numpy model of the register schedule of csrc/ntt.cu (`Shape`,
    `Pass`): pass p runs up to three stages on groups of R = 2^min(log_m, 3)
    rows base(u) + k·Q, with stage st's twiddle tw[(j + (k mod 2^e)·Q) <<
    st]; with zero_top the first stage is [x, x·tw]."""
    P = F.P
    M = 1 << log_m
    hm = M >> 1
    log_r = min(log_m, 3)
    R = 1 << log_r
    u = np.arange(M // R)
    passes = 0 if log_m == 0 else -(-log_m // log_r)
    for p in range(passes):
        s0 = log_r * p
        stages = min(log_r, log_m - s0)
        log_q = max(0, log_m - s0 - log_r)
        j = u & ((1 << log_q) - 1)
        base = ((u >> log_q) << (log_q + log_r)) | j
        rows = base[:, None] + (np.arange(R) << log_q)[None, :]
        assert sorted(rows.reshape(-1)) == list(range(M))
        v = s[:, rows]
        for e in range(stages - 1, -1, -1):
            h = 1 << e
            st = log_m - 1 - e - log_q
            for k in range(R):
                if k & h:
                    continue
                idx = (j + ((k & (h - 1)) << log_q)) << st
                wt, sh = tw[idx][:, None], tw[hm + idx][:, None]
                t, b = v[:, :, k].copy(), v[:, :, k + h].copy()
                if p == 0 and e == stages - 1 and zero_top:
                    v[:, :, k + h] = _shoup(t, wt, sh, P)
                else:
                    v[:, :, k] = (t + b) % P
                    v[:, :, k + h] = _shoup((t + P - b) % P, wt, sh, P)
        s[:, rows] = v
    return s


@pytest.mark.parametrize("log_m", range(0, 11))
def test_register_schedule_is_the_radix2_network(log_m):
    """The kernels' passes of up to three register stages between
    shared-memory exchanges do the same butterflies, on the same
    twiddles, as the stage-by-stage network."""
    rng = np.random.default_rng(log_m)
    tw = ntt_cuda.tables_np(F, log_m, False, log_m)[0].astype(np.uint64)
    x = JF.rand_np(rng, (2, 1 << log_m, 3)).astype(np.uint64)
    want = _dif_axis1(x.copy(), log_m, 0, tw)
    assert np.array_equal(_dif_passes(x.copy(), log_m, False, tw), want)
    if log_m:
        h = (1 << log_m) >> 1
        x[:, h:] = 0
        want = x.copy()
        want[:, h:] = _shoup(want[:, :h], tw[:h, None], tw[h:2 * h, None],
                             F.P)
        want = _dif_axis1(want, log_m, 1, tw)
        assert np.array_equal(_dif_passes(x.copy(), log_m, True, tw), want)


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
