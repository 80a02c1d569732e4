"""Poseidon2 over Goldilocks, width 8, on the host: exact ints and a
numpy batch.

Port of `plonky3_tpu/hashes/poseidon2_goldilocks.py`
(goldilocks/src/poseidon2.rs): S-box x^7, 4 + 4 full rounds and 22
partial rounds, the MDSMat4-based external light layer
(poseidon2/src/external.rs:96-112,135-170), the internal layer
out_i = sum + diag_i·s_i with MATRIX_DIAG_8 (poseidon2.rs:708,779); the
round constants are the port's copy of the reference's tables
(hashes/constants/poseidon2_goldilocks_constants.py).

`poseidon2_goldilocks_permute_np` permutes a batch of states at once on
numpy uint64 arrays (the reference loops over rows in Python ints): the
verifier hashes a wide row's 884 blocks for every query through it, one
batched permutation a block.
"""

from __future__ import annotations

import numpy as np

from ..fields.goldilocks import Goldilocks
from .constants.poseidon2_goldilocks_constants import (
    MATRIX_DIAG_8,
    RC8_EXTERNAL_FINAL,
    RC8_EXTERNAL_INITIAL,
    RC8_INTERNAL,
)

P = Goldilocks.P
WIDTH = 8


def _sbox7(x: int) -> int:
    x2 = (x * x) % P
    x4 = (x2 * x2) % P
    return (x4 * x2 % P) * x % P


def _apply_mat4(x):
    """MDSMat4 ([[2,3,1,1],[1,2,3,1],[1,1,2,3],[3,1,1,2]]) with the
    reference's add/double schedule."""
    t01 = (x[0] + x[1]) % P
    t23 = (x[2] + x[3]) % P
    t0123 = (t01 + t23) % P
    t01123 = (t0123 + x[1]) % P
    t01233 = (t0123 + x[3]) % P
    return [
        (t01123 + t01) % P,
        (t01123 + 2 * x[2]) % P,
        (t01233 + t23) % P,
        (t01233 + 2 * x[0]) % P,
    ]


def _mds_light(s):
    a = _apply_mat4(s[0:4])
    b = _apply_mat4(s[4:8])
    tot = [(x + y) % P for x, y in zip(a, b)]
    return ([(x + t) % P for x, t in zip(a, tot)]
            + [(y + t) % P for y, t in zip(b, tot)])


def _internal(s):
    total = sum(s) % P
    return [(total + MATRIX_DIAG_8[i] * s[i]) % P for i in range(WIDTH)]


def poseidon2_goldilocks_permute(state):
    """[8] canonical ints -> [8]."""
    s = [int(x) % P for x in state]
    s = _mds_light(s)
    for rc in RC8_EXTERNAL_INITIAL:
        s = _mds_light([_sbox7((x + c) % P) for x, c in zip(s, rc)])
    for c in RC8_INTERNAL:
        s[0] = _sbox7((s[0] + c) % P)
        s = _internal(s)
    for rc in RC8_EXTERNAL_FINAL:
        s = _mds_light([_sbox7((x + c) % P) for x, c in zip(s, rc)])
    return s


# ---- the numpy batch: (n, 8) uint64 arrays of canonical values ---------
# The verifier hashes a query's row of w elements as ceil(w / 4)
# permutations one after another, every query's row at once: an array of
# a few hundred elements an op, so the ops are few and lean (numpy's
# uint64 add, shift and compare wrap and compare unsigned).
_U = np.uint64
_M32 = _U(0xFFFFFFFF)
_EPS = _U(0xFFFFFFFF)  # 2^64 mod P
_P64 = _U(P)
_S32 = _U(32)
_RC_I = np.asarray(RC8_EXTERNAL_INITIAL, dtype=np.uint64)
_RC_P = np.asarray(RC8_INTERNAL, dtype=np.uint64)
_RC_F = np.asarray(RC8_EXTERNAL_FINAL, dtype=np.uint64)
_DIAG = np.asarray(MATRIX_DIAG_8, dtype=np.uint64)
# the external light layer's 8 x 8 matrix (a row sums to 21), transposed
_MDS_T = np.asarray(
    [[(2 if (i < 4) == (j < 4) else 1)
      * [[2, 3, 1, 1], [1, 2, 3, 1], [1, 1, 2, 3], [3, 1, 1, 2]][i % 4][j % 4]
      for i in range(WIDTH)] for j in range(WIDTH)], dtype=np.uint64)


def _add_np(a, b):
    s = a + b
    s = s + (s < a) * _EPS
    return s - (s >= _P64) * _P64


def _mul_np(a, b):
    """The 128-bit product from four 32 x 32 partial products, then
    w0 + w1·2^32 + w2·(2^32 - 1) - w3 mod P."""
    a0, a1, b0, b1 = a & _M32, a >> _S32, b & _M32, b >> _S32
    ll, lh, hl, hh = a0 * b0, a0 * b1, a1 * b0, a1 * b1
    t1 = (ll >> _S32) + (lh & _M32) + (hl & _M32)
    t2 = (t1 >> _S32) + (lh >> _S32) + (hl >> _S32) + (hh & _M32)
    lo = (t1 << _S32) | (ll & _M32)
    r = lo + (t2 & _M32) * _EPS
    r = r + (r < lo) * _EPS
    w3 = (t2 >> _S32) + (hh >> _S32)
    d = r - w3 - (r < w3) * _EPS
    return d - (d >= _P64) * _P64


def _combine_np(sl, sh):
    """SL + SH·2^32 mod P for SL, SH < 2^62."""
    sh = sh + (sl >> _S32)
    lo = (sh << _S32) | (sl & _M32)
    lo = lo - (lo >= _P64) * _P64
    return _add_np(lo, (sh >> _S32) * _EPS)


def _sbox7_np(x):
    """x^7 = x3·x4 in three product calls: x2, then x3 and x4 in one."""
    x2 = _mul_np(x, x)
    x34 = _mul_np(np.stack([x2, x2]), np.stack([x, x2]))
    return _mul_np(x34[0], x34[1])


def _mds_light_np(s):
    """The external layer on (8, n) lanes-first states."""
    return _combine_np(_MDS_T.T @ (s & _M32), _MDS_T.T @ (s >> _S32))


def poseidon2_goldilocks_permute_np(states) -> np.ndarray:
    """(n, 8) canonical values (any integer dtype) -> (n, 8) uint64. The
    state is kept lanes first, so lane 0 of the partial rounds is one
    contiguous row."""
    s = np.asarray(states, dtype=np.uint64).reshape(-1, WIDTH).T
    s = _mds_light_np(np.ascontiguousarray(s))
    for rc in _RC_I:
        s = _mds_light_np(_sbox7_np(_add_np(s, rc[:, None])))
    diag = _DIAG[:, None]
    for c in _RC_P:
        s[0] = _sbox7_np(_add_np(s[0], c))
        total = _combine_np((s & _M32).sum(axis=0), (s >> _S32).sum(axis=0))
        s = _add_np(total, _mul_np(s, diag))
    for rc in _RC_F:
        s = _mds_light_np(_sbox7_np(_add_np(s, rc[:, None])))
    return np.ascontiguousarray(s.T)
