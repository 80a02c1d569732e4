"""Poseidon2 over KoalaBear, width 16, on int64 tensors.

Port of the array paths of `plonky3_tpu/hashes/poseidon2.py`
(poseidon2/src/lib.rs:139: external initial rounds, internal rounds,
external terminal rounds; external.rs:113 the MDS-light layer circ(2M4,
M4, ...) with M4 = [[2,3,1,1],[1,2,3,1],[1,1,2,3],[3,1,1,2]];
monty-31/src/poseidon2.rs:77-90 the internal layer J + Diag(V)). States
are (..., 16) int64 tensors in Montgomery form. `mds_light` is the same
layer over any values through an ops protocol (add, double): the AIR's
`eval` runs it on its symbolic values.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

# Internal diagonal V as (numerator, log2 denominator): V_i = num / 2^den
# mod P (koala-bear/src/poseidon2.rs:10-15). V[0] = -2.
DIAGONAL_KOALABEAR_16 = (
    (-2, 0), (1, 0), (2, 0), (1, 1), (3, 0), (4, 0), (-1, 1), (-3, 0),
    (-4, 0), (1, 8), (1, 3), (1, 24), (-1, 8), (-1, 3), (-1, 4), (-1, 24),
)
S_BOX_DEGREE = {"KoalaBear": 3}


def diag_values_std(F) -> list:
    return [(num * pow(pow(2, den, F.P), F.P - 2, F.P)) % F.P
            for num, den in DIAGONAL_KOALABEAR_16]


def _apply_mat4(ops, x):
    """M4 @ x with M4 = [[2,3,1,1],[1,2,3,1],[1,1,2,3],[3,1,1,2]], the
    add/double chain of external.rs:54-75."""
    t01 = ops.add(x[0], x[1])
    t23 = ops.add(x[2], x[3])
    t0123 = ops.add(t01, t23)
    t01123 = ops.add(t0123, x[1])
    t01233 = ops.add(t0123, x[3])
    return [ops.add(t01123, t01),  # 2x0 + 3x1 + x2 + x3
            ops.add(t01123, ops.double(x[2])),  # x0 + 2x1 + 3x2 + x3
            ops.add(t01233, t23),  # x0 + x1 + 2x2 + 3x3
            ops.add(t01233, ops.double(x[0]))]  # 3x0 + x1 + x2 + 2x3


def mds_light(ops, state):
    """The external layer on a list of values: M4 on each block of four,
    then each value plus the sum of its position across the blocks."""
    w = len(state)
    if w % 4:
        raise ValueError(f"width {w} is not a multiple of 4")
    st = [y for c in range(0, w, 4) for y in _apply_mat4(ops, state[c:c + 4])]
    sums = []
    for k in range(4):
        acc = st[k]
        for j in range(4 + k, w, 4):
            acc = ops.add(acc, st[j])
        sums.append(acc)
    return [ops.add(st[i], sums[i % 4]) for i in range(w)]


@dataclass(frozen=True)
class Poseidon2:
    F: object
    width: int
    d: int
    rc_external_initial: tuple  # (4, 16) standard ints
    rc_external_final: tuple
    rc_internal: tuple  # (20,) standard ints

    def __post_init__(self):
        object.__setattr__(self, "diag_std", diag_values_std(self.F))

    def _device_consts(self):
        """Round constants and diagonal as Montgomery uint32 host arrays."""
        F = self.F

        def to_m(xs):
            return F.to_monty_np(np.asarray(xs, dtype=np.uint32))

        return dict(rc_ei=to_m(self.rc_external_initial),
                    rc_ef=to_m(self.rc_external_final),
                    rc_int=to_m(self.rc_internal),
                    diag=to_m(self.diag_std))

    def consts(self, device):
        """`_device_consts` as int64 tensors on `device`."""
        return {k: torch.from_numpy(v.astype(np.int64)).to(device)
                for k, v in self._device_consts().items()}

    def _mds_light_arr(self, x):
        """External linear layer on (..., 16) tensors."""
        F, w = self.F, self.width
        b = x.reshape(x.shape[:-1] + (w // 4, 4))
        x0, x1, x2, x3 = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
        t01 = F.add(x0, x1)
        t23 = F.add(x2, x3)
        t0123 = F.add(t01, t23)
        t01123 = F.add(t0123, x1)
        t01233 = F.add(t0123, x3)
        st = torch.stack([F.add(t01123, t01), F.add(t01123, F.double(x2)),
                          F.add(t01233, t23), F.add(t01233, F.double(x0))],
                         dim=-1)
        tot = F.sum(st, dim=-2)
        return F.add(st, tot[..., None, :]).reshape(x.shape)

    def sbox(self, x):
        return self.F.mul(self.F.square(x), x)

    def internal_layer(self, s, diag):
        """out_i = Σ s + V_i·s_i (the s-box already applied to s_0)."""
        F = self.F
        return F.add(F.sum(s, dim=-1)[..., None], F.mul(s, diag))

    def permute(self, states):
        """Batched permutation of (..., 16) Montgomery int64 states."""
        F = self.F
        c = self.consts(states.device)
        x = self._mds_light_arr(states)
        for rc in c["rc_ei"]:
            x = self._mds_light_arr(self.sbox(F.add(x, rc)))
        for rc in c["rc_int"]:
            s0 = self.sbox(F.add(x[..., 0], rc))
            x = self.internal_layer(torch.cat([s0[..., None], x[..., 1:]],
                                              dim=-1), c["diag"])
        for rc in c["rc_ef"]:
            x = self._mds_light_arr(self.sbox(F.add(x, rc)))
        return x


def default_poseidon2(F, width: int = 16) -> Poseidon2:
    """The default KoalaBear width-16 instance (koala-bear/src/
    poseidon2.rs:190)."""
    from .constants import poseidon2_constants as consts

    if F.name != "KoalaBear" or width != 16:
        raise NotImplementedError("only KoalaBear width 16 is ported")
    return Poseidon2(
        F=F, width=16, d=S_BOX_DEGREE[F.name],
        rc_external_initial=consts.KOALABEAR_POSEIDON2_RC_16_EXTERNAL_INITIAL,
        rc_external_final=consts.KOALABEAR_POSEIDON2_RC_16_EXTERNAL_FINAL,
        rc_internal=consts.KOALABEAR_POSEIDON2_RC_16_INTERNAL,
    )
