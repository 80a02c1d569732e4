"""The proof-of-work grinds' candidate schedule, modelled in numpy, the
keccak grind's Montgomery form of a witness and the Poseidon2 grind's
Shoup products by the diagonal.

`csrc/keccak.cu::keccak_grind_kernel` and `csrc/poseidon2.cu::
duplex_grind_kernel` run a persistent grid of R threads, all resident at
once: thread s (block b, thread t of T: s = b·T + t) takes candidates
s, s + R, s + 2R, ..., so round r covers [r·R, (r + 1)·R). Before each
round a thread reads *best and stops if its candidate exceeds it (or
reaches p); a thread whose candidate passes atomicMins it into *best and
stops. The model runs those steps, each one atomic, in interleavings that
hypothesis draws, over random sets of passing candidates and grid sizes,
and holds the result to the smallest pass (0xFFFFFFFF when there is
none). Then it runs with the real predicates, each candidate hashed by
the plain versions' functions, against `keccak_grind_plain`,
`poseidon2_grind_plain` and the JAX package's host grind.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from plonky3_tpu.challenger.serializing import SerializingChallenger32
from plonky3_tpu.fields.params import KoalaBear as JF
from plonky3_tpu_torch.fields import KoalaBear as F
from plonky3_tpu_torch.hashes import keccak_cuda as kc
from plonky3_tpu_torch.hashes import poseidon2_cuda as pc
from plonky3_tpu_torch.hashes.poseidon2 import _permute_std, default_poseidon2

NONE = 0xFFFFFFFF
U = np.uint64
M32 = U(0xFFFFFFFF)


def schedule(blocks, threads, p, passes, pick):
    """The kernels' search: `passes(c)` says whether candidate c passes,
    `pick(running)` which running thread takes the next atomic step.
    Returns (*best, the candidates tried), checking on every step that
    *best only falls and holds a pass or NONE, and that no thread starts
    a candidate of a round after the round of the pass in *best."""
    R = blocks * threads
    best = NONE
    cand = list(range(R))
    hashing = [False] * R
    running = list(range(R))
    tried = set()
    while running:
        s = pick(running)
        c = cand[s]
        before = best
        if not hashing[s]:  # the round's check of *best
            if c >= p or c > best:
                running.remove(s)
            else:
                assert best == NONE or c // R <= best // R
                hashing[s] = True
        else:  # the candidate's hash, then atomicMin on a pass
            tried.add(c)
            hashing[s] = False
            if passes(c):
                best = min(best, c)
                running.remove(s)
            else:
                cand[s] = c + R
        assert best <= before and (best == NONE or passes(best))
    return best, tried


grids = st.tuples(st.integers(1, 4), st.integers(1, 6))


@settings(max_examples=150, deadline=None)
@given(grid=grids, p=st.integers(1, 60),
       pass_set=st.sets(st.integers(0, 70), max_size=8), rnd=st.randoms())
def test_schedule_returns_the_smallest_pass(grid, p, pass_set, rnd):
    best, tried = schedule(*grid, p, pass_set.__contains__, rnd.choice)
    below_p = [c for c in pass_set if c < p]
    assert best == (min(below_p) if below_p else NONE)
    # every candidate below the result was tried (and failed)
    assert set(range(min(best, p))) <= tried


@settings(max_examples=60, deadline=None)
@given(grid=grids, p=st.integers(1, 40), rnd=st.randoms())
def test_schedule_without_a_pass_tries_every_candidate(grid, p, rnd):
    best, tried = schedule(*grid, p, lambda c: False, rnd.choice)
    assert best == NONE and tried == set(range(p))


def round_robin():
    """A pick that steps the running threads in turn by index, so every
    thread checks *best, then every thread hashes, a round at a time."""
    last = [-1]

    def pick(running):
        later = [s for s in running if s > last[0]]
        last[0] = min(later) if later else min(running)
        return last[0]

    return pick


@pytest.mark.parametrize("R,w", [(8, 0), (8, 7), (8, 8), (8, 29), (6, 35)])
def test_schedule_in_turns_stops_in_the_witness_round(R, w):
    """Threads that step in turn (as resident warps run, a round at a
    time) try no candidate after the witness's round."""
    best, tried = schedule(2, R // 2, 1 << 20, {w, w + 3}.__contains__,
                           round_robin())
    assert best == w and max(tried) == (w // R + 1) * R - 1


# ---- the model with the real predicates -----------------------------------

PERM = default_poseidon2(F, 24)
WINDOW = 1 << 12


def _interleave(seed):
    rng = np.random.default_rng(seed)
    return lambda running: running[int(rng.integers(len(running)))]


@pytest.mark.parametrize("lane,bits", [(0, 1), (10, 3), (15, 5), (10, 8)])
def test_schedule_with_poseidon2_predicate_matches_plain(lane, bits):
    """Each candidate's permutation by the plain version's function, the
    model at 3 blocks of 5 threads, against `poseidon2_grind_plain`."""
    rng = np.random.default_rng(100 + lane + bits)
    base = rng.integers(0, F.P, 24, dtype=np.uint64).astype(np.int64)
    std = F.from_monty_tensor(torch.from_numpy(base))
    states = std.expand(WINDOW, 24).clone()
    states[:, lane] = torch.arange(WINDOW)
    out = _permute_std(states, PERM.std_tables("cpu"), F.P)
    ok = ((out[:, pc.RATE - 1] & ((1 << bits) - 1)) == 0).numpy()
    best, _ = schedule(3, 5, F.P, lambda c: bool(ok[c]), _interleave(bits))
    want = pc.poseidon2_grind_plain(
        PERM, torch.from_numpy(base).to(torch.int32), lane, bits)
    assert best < WINDOW - 15 and best == int(want[0])


def newton_inverse(p):
    """p^-1 mod 2^32 as the keccak grind's C entry forms it."""
    inv = p
    for _ in range(4):
        inv = inv * (2 - p * inv) & 0xFFFFFFFF
    return inv


def mont(x, p):
    """The keccak grind's `mont`: x·2^32 mod p as the Montgomery product
    of x and 2^64 mod p, with -p^-1 and an unsigned min (uint64 lanes)."""
    nmu = U((1 << 32) - newton_inverse(p))
    r2 = U((1 << 64) % p)
    P = U(p)
    y = x.astype(U) * r2
    t = ((y & M32) * nmu) & M32
    r = ((t * P + y) >> U(32)) & M32
    return np.minimum(r, (r - P) & M32)


@pytest.mark.parametrize("p", [F.P, 2013265921, (1 << 31) - 1, 3])
def test_mont_matches_shift_mod(p):
    assert newton_inverse(p) * p % (1 << 32) == 1
    x = np.random.default_rng(p).integers(0, p, 4000, dtype=np.uint64)
    x = np.concatenate([x, [0, 1, p - 1]]).astype(U)
    want = np.array([(int(v) << 32) % p for v in x], dtype=U)
    assert np.array_equal(mont(x, p), want)


@pytest.mark.parametrize("m,bits", [(18, 1), (18, 6), (33, 4), (40, 8)])
def test_schedule_with_keccak_predicate_matches_plain_and_host(m, bits):
    """Each candidate hashed by the plain version's keccak-256, its witness
    word formed by the kernel's `mont`, the model at 2 blocks of 7
    threads, against `keccak_grind_plain` and the JAX package's host
    `SerializingChallenger32.grind`."""
    words = np.random.default_rng(200 + m + bits).integers(
        0, 1 << 32, m, dtype=np.uint64)
    cand = np.arange(WINDOW, dtype=np.uint64)
    msgs = np.concatenate([np.broadcast_to(words, (WINDOW, m)),
                           mont(cand, F.P)[:, None]], axis=1)
    d = kc._keccak256_rows(torch.from_numpy(msgs.astype(np.int64)))
    first = kc.bswap32(d[:, 7].to(torch.int64) & 0xFFFFFFFF)
    ok = ((first & ((1 << bits) - 1)) == 0).numpy()
    best, _ = schedule(2, 7, F.P, lambda c: bool(ok[c]), _interleave(m))
    plain = kc.keccak_grind_plain(
        torch.from_numpy(words.astype(np.int64)).to(torch.int32), bits, F.P)
    host = SerializingChallenger32(JF)
    host.observe_digest(tuple(int(x) for x in words))
    assert best < WINDOW - 14 and best == int(plain[0]) == host.grind(bits)


def shoup(x, d, dq):
    """The Poseidon2 grind's `shoup`: x·d mod p from dq = floor(d·2^32/p),
    a high product and two low ones, then an unsigned min (uint64)."""
    P = U(F.P)
    q = (x * dq) >> U(32)
    r = (x * d - q * P) & M32
    return np.minimum(r, (r - P) & M32)


def test_shoup_products_match_montgomery():
    """The grind's table ends with the diagonal in standard form and its
    Shoup quotients; a Montgomery-form word times each gives the
    Montgomery product with the table's Montgomery diagonal, as the
    plain permutation's internal layer forms it."""
    t = pc.kernel_table(PERM, "cpu").numpy().astype(np.uint32).astype(U)
    d, dq = t[-48:-24], t[-24:]
    assert [int(v) for v in d] == [int(v) for v in PERM.diag_std]
    diag_m = t[215:239]
    x = np.random.default_rng(5).integers(0, F.P, (500, 24), dtype=np.uint64)
    x = np.concatenate([x, np.zeros((1, 24), U), np.full((1, 24), F.P - 1,
                                                         dtype=U)])
    want = F.mul(torch.from_numpy(x.astype(np.int64)),
                 torch.from_numpy(diag_m.astype(np.int64)))
    assert np.array_equal(shoup(x, d, dq), want.numpy().astype(U))
    assert np.array_equal(want.numpy().astype(U), x * d % U(F.P))
