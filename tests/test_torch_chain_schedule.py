"""The warp schedules of the transcript's two chain kernels, modelled lane
by lane in numpy, against the plain versions and the JAX package's host
transcripts.

`csrc/poseidon2.cu::duplex_chain_kernel` runs the width-24 permutation on
one warp, lane i holding state word i; `csrc/keccak.cu::
keccak256_chain_kernel` runs keccak-f on one warp, lane l holding state
lane l. The models below compute both as the kernels do: arrays of 32
lanes, each shuffle an index array of source lanes, each field operation
the kernels' Montgomery formulas on uint64, the duplex chain's tables
read from `poseidon2_cuda.kernel_table`. Every comparison is of integers,
exact.
"""

import numpy as np
import pytest
import torch

from plonky3_tpu.challenger.duplex import DuplexChallenger as JDuplex
from plonky3_tpu.fields.params import KoalaBear as JF
from plonky3_tpu.hashes.keccak import keccak256 as j_keccak256
from plonky3_tpu.hashes.poseidon2 import default_poseidon2 as j_poseidon2
from plonky3_tpu_torch.fields import KoalaBear as F
from plonky3_tpu_torch.hashes import keccak_cuda as kc
from plonky3_tpu_torch.hashes import poseidon2_cuda as pc
from plonky3_tpu_torch.hashes.keccak import PILN, RC64, ROTC, keccak_f1600_np
from plonky3_tpu_torch.hashes.poseidon2 import default_poseidon2

LANES = np.arange(32)
M32 = np.uint64(0xFFFFFFFF)
U = np.uint64
LENGTHS = [0, 1, 15, 16, 17, 33, 34, 35]


def shfl(v, src):
    """__shfl_sync: lane i reads lane src[i] (v: (..., 32))."""
    return v[..., np.broadcast_to(src, LANES.shape)]


def shfl_xor(v, o):
    return v[..., LANES ^ o]


def shfl_down(v, d):
    """__shfl_down_sync: a lane past the warp's end keeps its own value."""
    return v[..., np.where(LANES + d < 32, LANES + d, LANES)]


# ---- the Poseidon2 duplex chain ------------------------------------------

PERM = default_poseidon2(F, 24)
P = U(F.P)
# csrc/poseidon2.cu's table layout
OFF_EI, OFF_INT, OFF_EF, OFF_DIAG = 0, 96, 119, 215
OFF_POW, OFF_CSUM = 239, 239 + 23 * 24


NMU = U((1 << 32) - F.MU)  # -p^-1 mod 2^32


def madd(a, b):
    """The kernels' add: the unsigned min of s and s - p in 32 bits."""
    s = (a + b) & M32
    return np.minimum(s, (s - P) & M32)


def mmul(a, b):
    """The kernels' Montgomery product of words below p: t = lo(ab)·(-1/p),
    r = (ab + t·p) / 2^32 in [0, 2p), then the unsigned min of r, r - p."""
    x = a * b
    t = ((x & M32) * NMU) & M32
    r = ((t * P + x) >> U(32)) & M32
    return np.minimum(r, (r - P) & M32)


def sbox(x):
    return mmul(mmul(x, x), x)


def warp_consts():
    """WarpConsts of every lane, from the wrapper's table."""
    t = pc.kernel_table(PERM, "cpu").numpy().astype(np.uint32).astype(U)
    word = LANES < 24
    li = np.where(word, LANES, 0)

    def per_lane(off):
        return np.where(word, t[off + li], U(0))

    return {
        "rc_ext": [per_lane(OFF_EI + 24 * r) for r in range(4)]
        + [per_lane(OFF_EF + 24 * r) for r in range(4)],
        "rc_int": [t[OFF_INT + r] for r in range(23)],
        "pow_diag": [per_lane(OFF_POW + 24 * k) for k in range(23)],
        "diag": per_lane(OFF_DIAG), "c_lane": per_lane(OFF_CSUM),
        "group": LANES & ~3, "next": (LANES & ~3) | ((LANES + 1) & 3),
        "pos": LANES & 3}


WC = warp_consts()


def layer_warp(x):
    c = WC
    a0, a1, a2, a3 = (shfl(x, c["group"] + j) for j in range(4))
    y = shfl(x, c["next"])
    o = madd(madd(madd(a0, a1), madd(a2, a3)), madd(madd(x, y), y))
    q = [shfl(o, 4 * g + c["pos"]) for g in range(6)]
    s = madd(madd(madd(q[0], q[1]), madd(q[2], q[3])), madd(q[4], q[5]))
    return madd(o, s)


def internal_warp(x):
    c = WC
    zero = np.zeros_like(x)
    v = [mmul(c["pow_diag"][k], x) if k < 23 else zero for k in range(32)]
    for o in (16, 8, 4, 2, 1):
        up = (LANES & o) != 0
        for j in range(o):
            keep = np.where(up, v[o + j], v[j])
            send = np.where(up, v[j], v[o + j])
            v[j] = madd(keep, shfl_xor(send, o))
    q = v[0]
    for r in range(23):
        s = sbox(madd(x, c["rc_int"][r]))
        S = madd(s, q)
        qn, Sb = shfl_down(q, 1), shfl(S, 0)
        Su = np.where(LANES == 0, S, Sb)
        y = np.where(LANES == 0, s, x)
        x = madd(Su, mmul(c["diag"], y))
        q = madd(mmul(c["c_lane"], Su), qn)
    return x


def permute_warp(x):
    x = layer_warp(x)
    for r in range(4):
        x = layer_warp(sbox(madd(x, WC["rc_ext"][r])))
    x = internal_warp(x)
    for r in range(4, 8):
        x = layer_warp(sbox(madd(x, WC["rc_ext"][r])))
    return x


def duplex_chain_model(state, words):
    """duplex_chain_kernel on one warp: (24,) and (n,) Montgomery words."""
    n = len(words)
    w = np.asarray(words, dtype=U)
    x = np.zeros(32, dtype=U)
    x[:24] = state

    def block(b):
        i = b * 16 + LANES
        return np.where((LANES < 16) & (i < n), w[np.minimum(i, n - 1)]
                        if n else U(0), U(0))

    nb = max(1, -(-n // 16))
    nxt = block(0)
    for b in range(nb):
        k = min(n - 16 * b, 16)
        if k > 0:
            x = np.where(LANES < 16, nxt, x)
            tag = mmul(np.full(32, k, dtype=U), U((1 << 64) % F.P))
            x = np.where(LANES == 16, madd(x, tag), x)
        if b + 1 < nb:
            nxt = block(b + 1)
        x = permute_warp(x)
    return x[:24]


def _rand_monty(rng, shape):
    return rng.integers(0, F.P, size=shape, dtype=np.uint64)


def test_internal_tables_shift_register():
    """c_k is row k's sum, and Q_k = sum d_i^k x_i moves through an
    internal round as c_k·S + Q_{k+1} (standard form, Python ints)."""
    pows, csum = pc.internal_tables(PERM)
    p, d = F.P, PERM.diag_std
    assert pows[:, 0].tolist() == [0] * 23 and csum[23] == 0
    assert csum[:23].tolist() == [int(r) % p for r in pows.sum(axis=1)]
    rng = np.random.default_rng(1)
    x = [int(v) for v in rng.integers(0, p, 24)]
    S = int(rng.integers(0, p))
    after = [(S + d[i] * x[i]) % p for i in range(24)]
    for k in range(22):
        q = sum(int(pows[k, i]) * x[i] for i in range(24)) % p
        q_next = sum(int(pows[k + 1, i]) * x[i] for i in range(24)) % p
        q_after = sum(int(pows[k, i]) * after[i] for i in range(24)) % p
        assert q_after == (int(csum[k]) * S + q_next) % p
        assert q == sum(pow(d[i], k, p) * x[i] for i in range(1, 24)) % p


def test_warp_permutation_matches_plain():
    """256 random states through the lane model and the plain permutation."""
    x = np.zeros((256, 32), dtype=U)
    x[:, :24] = _rand_monty(np.random.default_rng(2), (256, 24))
    got = permute_warp(x)[:, :24]
    want = PERM.permute(torch.from_numpy(x[:, :24].astype(np.int64)))
    assert np.array_equal(got.astype(np.int64), want.numpy())


def test_warp_permutation_ignores_lanes_24_to_31():
    """No shuffle brings a word of lanes 24..31 into lanes 0..23."""
    rng = np.random.default_rng(3)
    x = np.zeros((64, 32), dtype=U)
    x[:, :24] = _rand_monty(rng, (64, 24))
    y = x.copy()
    y[:, 24:] = _rand_monty(rng, (64, 8))
    assert np.array_equal(permute_warp(x)[:, :24], permute_warp(y)[:, :24])


def _reference_absorb(state_std, words_std):
    """The JAX package's host DuplexChallenger after observing the words
    and duplexing what is left queued (a bare permutation for none)."""
    ch = JDuplex(j_poseidon2(JF, 24), rate=16)
    ch.state = list(state_std)
    ch.observe_many(words_std)
    if ch.input_buffer or not words_std:
        ch._duplexing()
    return ch.state


@pytest.mark.parametrize("n", LENGTHS)
def test_duplex_chain_model_matches_plain_and_reference(n):
    rng = np.random.default_rng(10 + n)
    state, words = _rand_monty(rng, 24), _rand_monty(rng, n)
    got = duplex_chain_model(state, words)
    plain = pc.poseidon2_duplex_chain_plain(
        PERM, torch.from_numpy(state.astype(np.int64)).to(torch.int32),
        torch.from_numpy(words.astype(np.int64)).to(torch.int32))
    assert got.tolist() == (plain.numpy().astype(np.uint32)).tolist()
    std = [JF.from_monty_np(v.astype(np.uint32)).tolist()
           for v in (state, words, got)]
    assert std[2] == _reference_absorb(std[0], std[1])


# ---- the keccak-256 chain ------------------------------------------------

def _rho_by_lane():
    """Each lane's rho rotation, from the rho-pi cycle of keccak.py: the
    value of lane PILN[i - 1] (lane 1 for i = 0) is rotated by ROTC[i]."""
    rho = [0] * 25
    src = 1
    for i in range(24):
        rho[src] = ROTC[i]
        src = PILN[i]
    return np.array(rho)


def warp_lanes():
    """WarpLane of every lane: lanes 25..31 shadow lanes 0..6."""
    l = np.where(LANES < 25, LANES, LANES - 25)
    x, y = l % 5, l // 5
    xm1, xp1, xp2 = (x + 4) % 5, (x + 1) % 5, (x + 2) % 5
    rho = _rho_by_lane()[l]
    return {"col": [x + 5 * ((y + 1 + j) % 5) for j in range(4)],
            "xm1": xm1 + 5 * y, "xp1": xp1 + 5 * y,
            "pi0": (x + 3 * y) % 5 + 5 * x,
            "pi1": (xp1 + 3 * y) % 5 + 5 * xp1,
            "pi2": (xp2 + 3 * y) % 5 + 5 * xp2,
            "rho": (rho & 31).astype(U), "rho_swap": (rho & 32) != 0,
            "iota": np.where(LANES == 0, ~U(0), U(0))}


WL = warp_lanes()


def fsl(lo, hi, s):
    """__funnelshift_l(lo, hi, s) for 0 <= s < 32 on 32-bit halves."""
    return ((hi << s) & M32) | (lo >> (U(32) - s))


def keccak_f_warp(a):
    w = WL
    for rc in RC64:
        c = a.copy()
        for j in range(4):
            c ^= shfl(a, w["col"][j])
        cm, cp = shfl(c, w["xm1"]), shfl(c, w["xp1"])
        t = a ^ cm ^ ((cp << U(1)) | (cp >> U(63)))
        lo, hi = t & M32, t >> U(32)
        l2 = np.where(w["rho_swap"], hi, lo)
        h2 = np.where(w["rho_swap"], lo, hi)
        ra = (fsl(l2, h2, w["rho"]) << U(32)) | fsl(h2, l2, w["rho"])
        b0, b1, b2 = (shfl(ra, w[k]) for k in ("pi0", "pi1", "pi2"))
        a = b0 ^ (~b1 & b2) ^ (U(rc) & w["iota"])
    return a


def rate_lane(words, n, nb, b):
    """The 17 rate lanes of block b of the padded message (kernel's
    rate_lane): words i, i + 1 with i = 34b + 2·lane, the 0x01 after the
    message and 0x80000000 into the block's last word."""
    out = np.zeros(32, dtype=U)
    for lane in range(17):
        half = []
        for i in (34 * b + 2 * lane, 34 * b + 2 * lane + 1):
            v = int(words[i]) if i < n else 0
            v ^= 1 if i == n else 0
            v ^= 0x80000000 if i == 34 * nb - 1 else 0
            half.append(v)
        out[lane] = half[0] | (half[1] << 32)
    return out


def keccak256_chain_model(words, k):
    """keccak256_chain_kernel on one warp -> (k, 8) u32 digest words."""
    n = len(words)
    nb = n // 34 + 1
    a = np.zeros(32, dtype=U)
    for b in range(nb):
        a ^= rate_lane(words, n, nb, b)
        a = keccak_f_warp(a)
    out = []
    for j in range(k):
        out.append([int(v) for lane in a[:4]
                    for v in (lane & M32, lane >> U(32))])
        a = np.where(LANES < 4, a, U(0))
        a[4], a[16] = U(1), U(1 << 63)
        a = keccak_f_warp(a)
    return out


def test_keccak_warp_round_matches_plain():
    """256 random states through the lane model and the plain keccak-f;
    lanes 25..31 hold noise that no lane below 25 may read."""
    rng = np.random.default_rng(4)
    a = rng.integers(0, 1 << 64, size=(256, 32), dtype=np.uint64)
    got = keccak_f_warp(a)[:, :25]
    assert np.array_equal(got, keccak_f1600_np(a[:, :25]))


@pytest.mark.parametrize("n", LENGTHS)
def test_keccak_chain_model_matches_plain_and_reference(n):
    words = np.random.default_rng(20 + n).integers(0, 1 << 32, n,
                                                   dtype=np.uint64)
    got = keccak256_chain_model(words, 3)
    plain = kc.keccak256_chain_plain(
        torch.from_numpy(words.astype(np.int64)).to(torch.int32), 3)
    assert got == plain.numpy().astype(np.uint32).tolist()
    d = j_keccak256(words.astype("<u4").tobytes())
    want = [d]
    for _ in range(2):
        d = j_keccak256(d)
        want.append(d)
    assert np.array(got, dtype="<u4").tobytes() == b"".join(want)
