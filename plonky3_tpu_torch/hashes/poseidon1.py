"""Poseidon1 (classic Poseidon), textbook form, on Python ints and int64
tensors.

Port of `plonky3_tpu/hashes/poseidon1.py` (poseidon1/src/lib.rs: RF/2
full rounds, RP partial rounds, RF/2 full rounds; a round is AddRC, the
s-box (every lane, or lane 0 in a partial round), then the dense MDS).
The MDS layer is the circulant matrix of the field's first row
(koala-bear/src/mds.rs:19-26): M[i][j] = row[(j - i) mod w].

The reference jits its device permutation; here it is plain torch on
(..., width) int64 Montgomery tensors. The MDS multiplies the values by
the matrix's standard-form entries: Montgomery form is linear, so the
sum is the Montgomery form of the product, and it reduces each product
mod P before the sum (a product of two words is below 2^62, and sixteen
of them would overflow int64).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .constants import poseidon1_constants as C
from .poseidon2 import S_BOX_DEGREE


def mds_mul(x, mds, P):
    """y[..., i] = Σ_j mds[i][j]·x[..., j] mod P on int64 tensors: x any
    linear form (standard or Montgomery), mds (w, w) standard-form
    entries; each product reduced before the sum."""
    return (x[..., None, :] * mds % P).sum(dim=-1) % P


@dataclass(frozen=True)
class Poseidon1:
    F: object
    width: int
    d: int
    half_full: int
    rc: tuple  # (rounds, width) standard ints: [full | partial | full]
    mds_first_row: tuple  # standard ints

    def __post_init__(self):
        if self.d not in (3, 5, 7):
            raise ValueError(f"no degree-{self.d} s-box")
        object.__setattr__(self, "_on_device", {})

    @property
    def partial(self):
        return len(self.rc) - 2 * self.half_full

    def is_partial(self, r: int) -> bool:
        return self.half_full <= r < self.half_full + self.partial

    # ---- host (exact ints, standard form) ------------------------------
    def _mds_host(self, state):
        P, w = self.F.P, self.width
        row = self.mds_first_row
        return [sum(row[(j - i) % w] * state[j] for j in range(w)) % P
                for i in range(w)]

    def _sbox_host(self, x):
        return pow(x, self.d, self.F.P)

    def permute_host(self, state):
        P = self.F.P
        state = [x % P for x in state]
        for r, rc in enumerate(self.rc):
            state = [(x + c) % P for x, c in zip(state, rc)]
            if self.is_partial(r):
                state[0] = self._sbox_host(state[0])
            else:
                state = [self._sbox_host(x) for x in state]
            state = self._mds_host(state)
        return state

    # ---- tensors (..., width) int64, Montgomery form --------------------
    def mds_matrix_np(self) -> np.ndarray:
        """(w, w) int64 standard-form circulant: M[i][j] = row[(j-i) % w]."""
        w, P = self.width, self.F.P
        return np.array([[self.mds_first_row[(j - i) % w] % P
                          for j in range(w)] for i in range(w)],
                        dtype=np.int64)

    def consts(self, device):
        """{'rc': (rounds, w) Montgomery, 'mds': (w, w) standard} int64
        tensors on `device`, made once per device."""
        key = torch.device(device)
        hit = self._on_device.get(key)
        if hit is None:
            F = self.F
            rc = F.to_monty_np(np.asarray(self.rc, dtype=np.uint64) % F.P)
            hit = self._on_device[key] = {
                "rc": torch.from_numpy(rc.astype(np.int64)).to(key),
                "mds": torch.from_numpy(self.mds_matrix_np()).to(key)}
        return hit

    def sbox(self, x):
        """x^d on Montgomery tensors (the reference's product chains)."""
        F = self.F
        if self.d == 3:
            return F.mul(F.square(x), x)
        if self.d == 5:
            return F.mul(F.square(F.square(x)), x)
        x2 = F.square(x)
        return F.mul(F.mul(F.square(x2), x2), x)

    def permute_device(self, states):
        """Batched permutation of (..., width) Montgomery int64 tensors."""
        c = self.consts(states.device)
        P = self.F.P
        x = states
        for r in range(len(self.rc)):
            x = self.F.add(x, c["rc"][r])
            if self.is_partial(r):
                x = torch.cat([self.sbox(x[..., :1]), x[..., 1:]], dim=-1)
            else:
                x = self.sbox(x)
            x = mds_mul(x, c["mds"], P)
        return x

    def permute_np(self, states):
        """Batched permutation of (..., width) Montgomery-form uint32
        arrays (the reference's `permute_np`) -> uint32."""
        x = torch.from_numpy(np.asarray(states).astype(np.int64))
        return self.permute_device(x).numpy().astype(np.uint32)


def default_poseidon1(F, width: int) -> Poseidon1:
    """default_{koalabear,babybear}_poseidon1_{16,24}
    (koala-bear/src/poseidon1.rs:461,471)."""
    prefix = F.name.upper()
    return Poseidon1(
        F=F, width=width, d=S_BOX_DEGREE[F.name], half_full=4,
        rc=getattr(C, f"{prefix}_POSEIDON1_RC_{width}"),
        mds_first_row=getattr(C, f"{prefix}_MDS_FIRST_ROW_{width}"))
