"""The Monolith permutations over Mersenne-31 and Goldilocks (the
`monolith` crate).

Port of `plonky3_tpu/hashes/monolith.py`. The Mersenne-31 half
(monolith/src/monolith.rs:1-24): Concrete; then 5 x (Bars -> Bricks ->
Concrete -> AddRC); then Bars -> Bricks -> Concrete.
  Bars (bars/mersenne31.rs): chi-like S-boxes on (8, 8, 8, 7)-bit limbs
    of the first 8 lanes, as two 16-bit lookup tables (`_LOW16` for the
    low half, `_HIGH15` for the high 15 bits).
  Bricks: s_i += s_{i-1}^2.
  Concrete: the paper's 16 x 16 circulant (mds/mersenne31.rs:63).
  Round constants: SHAKE-128("Monolith" || width || rounds + 1 || p ||
    limbs), rejection-sampled below p (monolith.rs:88-101).

`permute_host` (one state of ints) and `permute_np` (numpy batches) are
the reference's; `permute` runs a batch as int64 tensors on their device
(the trace generator's arithmetic).

The Goldilocks half (reference :159-252; monolith/src/bars/goldilocks.rs,
MonolithGoldilocks8): Bars on eight 8-bit limbs of the first 4 lanes as
one SWAR chi over the 64-bit word and a rotate by one inside each byte
(`_bar64_swar8`; `bar64_tensor` on int64 tensors holding the u64 bits,
`gl/field.py`), the MDS rows of widths 8 and 12, SHAKE-128 constants
rejection-sampled as u64 below p.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

import numpy as np
import torch

from ..fields.mersenne31 import Mersenne31 as F

_P = F.P

MDS_ROW_16 = (
    61402, 17845, 26798, 59689, 12021, 40901, 41351, 27521, 56951,
    12034, 53865, 43244, 7454, 33823, 28750, 1108,
)


def _rotl8(v, r):
    return ((v << r) | (v >> (8 - r))) & 0xFF


def _s_box8(y: int) -> int:
    tmp = (y ^ (~_rotl8(y, 1) & _rotl8(y, 2) & _rotl8(y, 3))) & 0xFF
    return _rotl8(tmp, 1)


def _s_box7(y: int) -> int:
    r1 = ((y >> 6) | (y << 1)) & 0x7F
    r2 = ((y >> 5) | (y << 2)) & 0x7F
    tmp = (y ^ (~r1 & r2)) & 0x7F
    return ((tmp >> 6) | (tmp << 1)) & 0x7F


_LOW16 = np.array([(_s_box8(i >> 8) << 8) | _s_box8(i & 0xFF)
                   for i in range(1 << 16)], dtype=np.uint32)
_HIGH15 = np.array([(_s_box7(i >> 8) << 8) | _s_box8(i & 0xFF)
                    for i in range(1 << 15)], dtype=np.uint32)


def _shake_constants(width: int, num_full_rounds: int):
    shake = hashlib.shake_128()
    shake.update(b"Monolith")
    shake.update(bytes([width, num_full_rounds + 1]))
    shake.update(_P.to_bytes(4, "little"))
    shake.update(bytes([8, 8, 8, 7]))
    stream = shake.digest(16 * width * num_full_rounds * 8)
    pos, out = 0, []
    for _ in range(num_full_rounds):
        rcs = []
        while len(rcs) < width:
            v = int.from_bytes(stream[pos:pos + 4], "little")
            pos += 4
            if v < _P:
                rcs.append(v)
        out.append(tuple(rcs))
    return tuple(out)


def mds_matrix(width: int = 16) -> np.ndarray:
    """The circulant: row i, column j holds MDS_ROW_16[(j - i) % width]."""
    return np.array([[MDS_ROW_16[(j - i) % width] for j in range(width)]
                     for i in range(width)], dtype=np.int64)


_TABLES: dict = {}


def device_tables(device):
    """(low16, high15, mds) as int64 tensors on `device`, kept."""
    key = str(device)
    t = _TABLES.get(key)
    if t is None:
        t = _TABLES[key] = tuple(
            torch.from_numpy(np.asarray(a).astype(np.int64)).to(device)
            for a in (_LOW16, _HIGH15, mds_matrix()))
    return t


def concrete(state, mds):
    """The circulant on (n, 16) canonical int64 tensors."""
    return (state[:, None, :] * mds[None] % _P).sum(dim=-1) % _P


def bar(v, low16, high15):
    """The Bar S-box of canonical int64 words."""
    return (high15[v >> 16] << 16) | low16[v & 0xFFFF]


def bricks(state):
    """s_i += s_{i-1}^2, from the last lane down (each reads the old
    s_{i-1})."""
    sq = state[:, :-1] * state[:, :-1] % _P
    return torch.cat([state[:, :1], (state[:, 1:] + sq) % _P], dim=1)


@dataclass(frozen=True)
class MonolithM31:
    width: int = 16
    num_full_rounds: int = 5
    num_bars: int = 8

    def __post_init__(self):
        if self.width != 16:
            raise ValueError("the circulant is the width-16 one")
        object.__setattr__(self, "rc", _shake_constants(
            self.width, self.num_full_rounds))

    # ---- host ----------------------------------------------------------
    def _bar(self, v: int) -> int:
        return (int(_HIGH15[v >> 16]) << 16) | int(_LOW16[v & 0xFFFF])

    def _concrete(self, state):
        w = self.width
        return [sum(MDS_ROW_16[(j - i) % w] * state[j]
                    for j in range(w)) % _P for i in range(w)]

    def permute_host(self, state):
        state = self._concrete([x % _P for x in state])
        for r in range(self.num_full_rounds + 1):
            state = [self._bar(x) if i < self.num_bars else x
                     for i, x in enumerate(state)]
            for i in range(self.width - 1, 0, -1):
                state[i] = (state[i] + state[i - 1] * state[i - 1]) % _P
            state = self._concrete(state)
            if r < self.num_full_rounds:
                state = [(x + c) % _P for x, c in zip(state, self.rc[r])]
        return state

    # ---- numpy batches ---------------------------------------------------
    def permute_np(self, states):
        x = np.asarray(states, dtype=np.uint64) % np.uint64(_P)
        mds = mds_matrix(self.width).astype(np.uint64)

        def conc(v):
            return ((v[..., None, :] * mds) % _P).sum(axis=-1) % _P

        x = conc(x)
        for r in range(self.num_full_rounds + 1):
            b = x[..., :self.num_bars].astype(np.uint32)
            nb = ((_HIGH15[b >> 16] << 16) | _LOW16[b & 0xFFFF])
            x = np.concatenate([nb.astype(np.uint64),
                                x[..., self.num_bars:]], axis=-1)
            for i in range(self.width - 1, 0, -1):
                x[..., i] = (x[..., i] + x[..., i - 1] * x[..., i - 1]) % _P
            x = conc(x)
            if r < self.num_full_rounds:
                x = (x + np.array(self.rc[r], dtype=np.uint64)) % _P
        return x.astype(np.uint32)

    # ---- tensors ---------------------------------------------------------
    def permute(self, states):
        """(n, 16) canonical int64 tensor -> the permuted states, on the
        tensor's device."""
        low16, high15, mds = device_tables(states.device)
        x = concrete(states % _P, mds)
        for r in range(self.num_full_rounds + 1):
            x = torch.cat([bar(x[:, :self.num_bars], low16, high15),
                           x[:, self.num_bars:]], dim=1)
            x = concrete(bricks(x), mds)
            if r < self.num_full_rounds:
                x = (x + torch.tensor(self.rc[r], dtype=torch.int64,
                                      device=x.device)) % _P
        return x


# ---------------------------------------------------------------------------
# Monolith-64 over Goldilocks, LOOKUP_BITS = 8 (monolith/src/bars/
# goldilocks.rs)
# ---------------------------------------------------------------------------
_GL_P = (1 << 64) - (1 << 32) + 1
MDS_ROW_8_GL = (23, 8, 13, 10, 7, 6, 21, 8)
MDS_ROW_12_GL = (7, 23, 8, 26, 13, 10, 9, 7, 6, 22, 21, 8)
_M64 = (1 << 64) - 1


def _bar64_swar8(val: int) -> int:
    """SWAR chi on eight 8-bit lanes, then a rotate left by one inside
    each byte (bars/goldilocks.rs:48-68)."""
    val &= _M64
    nv = (~val) & _M64
    rot1 = ((nv & 0x8080808080808080) >> 7) | (
        (nv & 0x7F7F7F7F7F7F7F7F) << 1)
    rot2 = ((val & 0xC0C0C0C0C0C0C0C0) >> 6) | (
        (val & 0x3F3F3F3F3F3F3F3F) << 2)
    rot3 = ((val & 0xE0E0E0E0E0E0E0E0) >> 5) | (
        (val & 0x1F1F1F1F1F1F1F1F) << 3)
    tmp = val ^ (rot1 & rot2 & rot3 & _M64)
    return (((tmp & 0x8080808080808080) >> 7)
            | ((tmp & 0x7F7F7F7F7F7F7F7F) << 1)) & _M64


def _rotl_bytes(v, r: int):
    """Rotate each byte of int64 words left by r: the right shift masked
    after it (int64 shifts are arithmetic)."""
    hi = {1: 0x0101010101010101, 2: 0x0303030303030303,
          3: 0x0707070707070707}[r]
    lo = {1: 0x7F7F7F7F7F7F7F7F, 2: 0x3F3F3F3F3F3F3F3F,
          3: 0x1F1F1F1F1F1F1F1F}[r]
    return ((v >> (8 - r)) & hi) | ((v & lo) << r)


def bar64_tensor(v):
    """`_bar64_swar8` of every int64 word (u64 bits) of a tensor."""
    tmp = v ^ (_rotl_bytes(~v, 1) & _rotl_bytes(v, 2) & _rotl_bytes(v, 3))
    return _rotl_bytes(tmp, 1)


def _shake_constants_gl(width: int, num_full_rounds: int):
    """SHAKE-128("Monolith" || width || rounds + 1 || p as 8 bytes LE ||
    [8] * 8), rejection-sampled as u64 below p (monolith.rs:87-100,
    util.rs:14)."""
    shake = hashlib.shake_128()
    shake.update(b"Monolith")
    shake.update(bytes([width, num_full_rounds + 1]))
    shake.update(_GL_P.to_bytes(8, "little"))
    shake.update(bytes([8] * 8))
    stream = shake.digest(16 * width * num_full_rounds * 16)
    pos, out = 0, []
    for _ in range(num_full_rounds):
        rcs = []
        while len(rcs) < width:
            v = int.from_bytes(stream[pos:pos + 8], "little")
            pos += 8
            if v < _GL_P:
                rcs.append(v)
        out.append(tuple(rcs))
    return tuple(out)


@dataclass(frozen=True)
class MonolithGoldilocks:
    """Monolith-64 over Goldilocks, LOOKUP_BITS 8, 4 Bars, 5 + 1 rounds
    (monolith/src/monolith.rs:181 MonolithGoldilocks8; width 8 the
    compression mode, 12 the sponge mode), on the host in exact ints."""

    width: int = 12
    num_full_rounds: int = 5
    num_bars: int = 4

    def __post_init__(self):
        if self.width not in (8, 12):
            raise ValueError(f"width {self.width}: 8 or 12")
        object.__setattr__(self, "rc", _shake_constants_gl(
            self.width, self.num_full_rounds))
        object.__setattr__(self, "mds_row", (
            MDS_ROW_8_GL if self.width == 8 else MDS_ROW_12_GL))

    def _concrete(self, state):
        w, row = self.width, self.mds_row
        return [sum(row[(j - i) % w] * state[j] for j in range(w)) % _GL_P
                for i in range(w)]

    def permute_host(self, state):
        state = self._concrete([x % _GL_P for x in state])
        for r in range(self.num_full_rounds + 1):
            state = [_bar64_swar8(x) if i < self.num_bars else x
                     for i, x in enumerate(state)]
            for i in range(self.width - 1, 0, -1):
                state[i] = (state[i] + state[i - 1] * state[i - 1]) % _GL_P
            state = self._concrete(state)
            if r < self.num_full_rounds:
                state = [(x + c) % _GL_P for x, c in zip(state, self.rc[r])]
        return state
