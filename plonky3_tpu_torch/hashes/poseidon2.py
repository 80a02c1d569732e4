"""Poseidon2 over KoalaBear and BabyBear, widths 16 and 24, on int64
tensors and numpy.

Port of the array paths of `plonky3_tpu/hashes/poseidon2.py`
(poseidon2/src/lib.rs:139: external initial rounds, internal rounds,
external terminal rounds; external.rs:113 the MDS-light layer circ(2M4,
M4, ...) with M4 = [[2,3,1,1],[1,2,3,1],[1,1,2,3],[3,1,1,2]];
monty-31/src/poseidon2.rs:77-90 the internal layer J + Diag(V)). The
s-box is x^3 over KoalaBear and x^7 over BabyBear (`S_BOX_DEGREE`).

`permute` takes (..., width) int64 tensors in Montgomery form (the Merkle
sponge and compressor, the kernels' plain versions); `permute_np` takes
numpy arrays in standard form (host batches, and the plain version of
`permute_host`, one state through the C permutation of `native/`, the
host transcript's, as the reference's `permute_host`). Both run
`_permute_std`, one exact computation in standard form: Montgomery form
is a field isomorphism, so converting at the ends gives the reference's
bits, and a standard-form product needs one `%` where a Montgomery one
needs two. The AIR reads the Montgomery-form pieces (`consts`,
`_mds_light_arr`, `sbox`, `internal_layer`); `mds_light` is the same
layer over any values through an ops protocol (add, double): the AIR's
`eval` runs it on its symbolic values.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

# Internal diagonals V as (numerator, log2 denominator): V_i = num / 2^den
# mod P (koala-bear/src/poseidon2.rs:10-15, baby-bear/src/poseidon2.rs:
# 10-15). V[0] = -2.
DIAGONALS = {
    ("KoalaBear", 16): (
        (-2, 0), (1, 0), (2, 0), (1, 1), (3, 0), (4, 0), (-1, 1), (-3, 0),
        (-4, 0), (1, 8), (1, 3), (1, 24), (-1, 8), (-1, 3), (-1, 4),
        (-1, 24)),
    ("KoalaBear", 24): (
        (-2, 0), (1, 0), (2, 0), (1, 1), (3, 0), (4, 0), (-1, 1), (-3, 0),
        (-4, 0), (1, 8), (1, 2), (1, 3), (1, 4), (1, 5), (1, 6), (1, 24),
        (-1, 8), (-1, 3), (-1, 4), (-1, 5), (-1, 6), (-1, 7), (-1, 9),
        (-1, 24)),
    ("BabyBear", 16): (
        (-2, 0), (1, 0), (2, 0), (1, 1), (3, 0), (4, 0), (-1, 1), (-3, 0),
        (-4, 0), (1, 8), (1, 2), (1, 3), (1, 27), (-1, 8), (-1, 4),
        (-1, 27)),
    ("BabyBear", 24): (
        (-2, 0), (1, 0), (2, 0), (1, 1), (3, 0), (4, 0), (-1, 1), (-3, 0),
        (-4, 0), (1, 8), (1, 2), (1, 3), (1, 4), (1, 7), (1, 9), (1, 27),
        (-1, 8), (-1, 2), (-1, 3), (-1, 4), (-1, 5), (-1, 6), (-1, 7),
        (-1, 27)),
}
# Mersenne31's degree 5 comes with that field (the circle path).
S_BOX_DEGREE = {"KoalaBear": 3, "BabyBear": 7}


def diag_values_std(F, width: int) -> list:
    return [(num * pow(pow(2, den, F.P), F.P - 2, F.P)) % F.P
            for num, den in DIAGONALS[(F.name, width)]]


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


def _mds_light_std(x, P):
    """The external layer in place on (..., width) standard-form int64
    values in [0, P) (a tensor or a numpy array): M4 on each block of
    four, then each value plus the sum of its position across the blocks.
    Reduced once at the end: every sum stays below 49·P < 2^37."""
    x0, x1, x2, x3 = (x[..., k::4] for k in range(4))
    t01 = x0 + x1
    t23 = x2 + x3
    t0123 = t01 + t23
    t01123 = t0123 + x1
    t01233 = t0123 + x3
    ys = (t01123 + t01, t01123 + 2 * x2, t01233 + t23, t01233 + 2 * x0)
    for k, y in enumerate(ys):
        x[..., k::4] = (y + y.sum(-1)[..., None]) % P


def _sbox_std(x, P, d):
    """x^d for d = 3 (x2·x) or 7 (x4·x3, x2 = x·x, x3 = x2·x, x4 = x2·x2:
    four products, three deep)."""
    x2 = x * x % P
    x3 = x2 * x % P
    if d == 3:
        return x3
    return x2 * x2 % P * x3 % P


def _permute_std(x, c, P, d=3):
    """The permutation of (..., width) standard-form int64 values in
    [0, P) with the degree-d s-box (KoalaBear's 3 by default), updating
    the buffer `x` in place where it can; `c` holds the standard-form
    tables (`Poseidon2.std_tables`) as the same kind of array. Returns the
    permuted states."""
    _mds_light_std(x, P)
    for rc in c["rc_ei"]:
        x = _sbox_std((x + rc) % P, P, d)
        _mds_light_std(x, P)
    for rc in c["rc_int"]:
        x[..., 0] = _sbox_std((x[..., 0] + rc) % P, P, d)
        total = x.sum(-1)  # < 24·P
        x = (x * c["diag"] + total[..., None]) % P
    for rc in c["rc_ef"]:
        x = _sbox_std((x + rc) % P, P, d)
        _mds_light_std(x, P)
    return x


@dataclass(frozen=True)
class Poseidon2:
    F: object
    width: int
    d: int
    rc_external_initial: tuple  # (4, width) standard ints
    rc_external_final: tuple
    rc_internal: tuple  # (partial rounds,) standard ints

    def __post_init__(self):
        if self.d not in (3, 7):
            raise NotImplementedError(f"the degree-{self.d} s-box is not "
                                      f"ported (degrees 3 and 7 are)")
        object.__setattr__(self, "diag_std", diag_values_std(self.F,
                                                             self.width))
        # the standard-form tables as int64 numpy arrays
        object.__setattr__(self, "tables_np", {
            k: np.asarray(v, dtype=np.int64) for k, v in (
                ("rc_ei", self.rc_external_initial),
                ("rc_int", self.rc_internal),
                ("rc_ef", self.rc_external_final),
                ("diag", self.diag_std))})
        object.__setattr__(self, "_on_device", {})
        # the C permutation's arguments (native/): standard-form u32
        object.__setattr__(self, "native_args", (
            self.F.P, self.width, self.d,
            *(self.tables_np[k].astype(np.uint32)
              for k in ("rc_ei", "rc_int", "rc_ef", "diag"))))

    def on_device(self, name, device, make):
        """make(device), made once per (name, device) and kept: the
        tables a device path reads on every call."""
        key = (name, torch.device(device))
        hit = self._on_device.get(key)
        if hit is None:
            hit = self._on_device[key] = make(key[1])
        return hit

    def _device_consts(self):
        """Round constants and diagonal as Montgomery uint32 host arrays."""
        return {k: self.F.to_monty_np(v.astype(np.uint32))
                for k, v in self.tables_np.items()}

    def consts(self, device):
        """`_device_consts` as int64 tensors on `device`."""
        return {k: torch.from_numpy(v.astype(np.int64)).to(device)
                for k, v in self._device_consts().items()}

    def std_tables(self, device):
        """The standard-form tables as int64 tensors on `device`."""
        return self.on_device("std", device, lambda dev: {
            k: torch.from_numpy(v).to(dev)
            for k, v in self.tables_np.items()})

    def _mds_light_arr(self, x):
        """External linear layer on (..., width) Montgomery tensors."""
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
        """x^d on Montgomery tensors (as `_sbox_std`)."""
        F = self.F
        x2 = F.square(x)
        x3 = F.mul(x2, x)
        return x3 if self.d == 3 else F.mul(F.square(x2), x3)

    def internal_layer(self, s, diag):
        """out_i = Σ s + V_i·s_i (the s-box already applied to s_0)."""
        F = self.F
        return F.add(F.sum(s, dim=-1)[..., None], F.mul(s, diag))

    def permute(self, states):
        """Batched permutation of (..., width) Montgomery int64 tensors."""
        F = self.F
        x = self.permute_std(F.from_monty_tensor(states),
                             self.std_tables(states.device))
        return F.to_monty_tensor(x)

    def permute_std(self, x, tables):
        """`_permute_std` with this instance's field and degree: `x`, a
        (..., width) buffer of standard-form values, `tables` its kind of
        `std_tables`."""
        return _permute_std(x, tables, self.F.P, self.d)

    def permute_host(self, state) -> list:
        """One permutation of a (width,) standard-form state (ints) in C
        (native/poseidon2.c; the reference routes its `permute_host`
        there): a list of standard-form ints."""
        from .. import native

        P, width, d, *tables = self.native_args
        return native.poseidon2_permute(np.asarray(state, dtype=np.uint32),
                                        P, width, d, *tables).tolist()

    def permute_np(self, states):
        """Batched permutation of (..., width) standard-form values (any
        integer numpy array) -> int64 standard form."""
        x = np.array(states, dtype=np.int64)
        return self.permute_std(x, self.tables_np)


def default_poseidon2(F, width: int) -> Poseidon2:
    """The default KoalaBear and BabyBear instances of widths 16 and 24
    (koala-bear/src/poseidon2.rs:190, baby-bear/src/poseidon2.rs)."""
    from .constants import poseidon2_constants as consts

    if (F.name, width) not in DIAGONALS:
        raise NotImplementedError(
            f"Poseidon2 over {F.name} at width {width} is not ported "
            f"(KoalaBear and BabyBear, widths 16 and 24, are)")
    prefix = f"{F.name.upper()}_POSEIDON2_RC_{width}"
    return Poseidon2(
        F=F, width=width, d=S_BOX_DEGREE[F.name],
        rc_external_initial=getattr(consts, f"{prefix}_EXTERNAL_INITIAL"),
        rc_external_final=getattr(consts, f"{prefix}_EXTERNAL_FINAL"),
        rc_internal=getattr(consts, f"{prefix}_INTERNAL"),
    )
