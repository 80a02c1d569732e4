"""Vectorized Poseidon1 AIR: V permutations a row.

Port of `plonky3_tpu/models/poseidon1_air.py` (poseidon1-air/src/{air,
columns}.rs model), the trace layout of `models/poseidon2_air.py`: one
block of columns a permutation,

    inputs[W]
    HF × post[W]     beginning full rounds (the state after the MDS)
    PR × post_sbox   partial rounds (lane 0's s-box output, before the MDS)
    HF × post[W]     ending full rounds

in the textbook round form of `hashes/poseidon1.py` (AddRC, s-box, dense
circulant MDS), so every running value has degree 1 and every constraint
degree 3. Only the degree-3 s-box is ported, as in the reference (no
s-box registers): KoalaBear. The constraints come in the reference's
order (per round, the full rounds' posts w-major and V-minor, one block
of V a partial round), and `fold_constraints_device` gives each the same
alpha power.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import default_device
from ..air.api import BaseAir
from ..air.builder import stack_syms
from ..hashes.poseidon1 import Poseidon1, default_poseidon1, mds_mul

_FOLD_CHUNK = 1 << 15  # rows per fold step (bounds the temporaries)


class Poseidon1VectorAir(BaseAir):
    num_public_values = 0

    def __init__(self, field, state_width: int = 16, vector_len: int = 1,
                 perm: Poseidon1 | None = None):
        self.field = field
        self.perm = perm or default_poseidon1(field, state_width)
        if self.perm.d != 3:
            raise ValueError(f"Poseidon1VectorAir takes the degree-3 s-box "
                             f"only (no s-box registers); "
                             f"{self.perm.F.name}'s is {self.perm.d}")
        self.W = state_width
        self.V = vector_len
        self.HF = self.perm.half_full
        self.PR = self.perm.partial
        self.cols_per_perm = (self.W + self.HF * self.W + self.PR
                              + self.HF * self.W)
        self.width = vector_len * self.cols_per_perm

    def max_constraint_degree(self):
        return 3

    def _post_base(self, r: int) -> int:
        """The first column of full round r's post state."""
        W, HF = self.W, self.HF
        if r < HF:
            return W + r * W
        return W + HF * W + self.PR + (r - HF - self.PR) * W

    def _mds_syms(self, state):
        w = self.W
        row = self.perm.mds_first_row
        out = []
        for i in range(w):
            acc = state[0] * int(row[(0 - i) % w])
            for j in range(1, w):
                acc = acc + state[j] * int(row[(j - i) % w])
            out.append(acc)
        return out

    def eval(self, b):
        V, W, C = self.V, self.W, self.cols_per_perm
        cols = b.main.local

        def lane(c):
            return stack_syms([cols[v * C + c] for v in range(V)])

        state = [lane(w) for w in range(W)]
        rc = self.perm.rc
        for r in range(len(rc)):
            state = [state[i] + int(rc[r][i]) for i in range(W)]
            if not self.perm.is_partial(r):
                state = self._mds_syms([x * x * x for x in state])
                base = self._post_base(r)
                for w in range(W):
                    post = lane(base + w)
                    b.assert_eq_block(state[w], post, V)
                    state[w] = post
            else:
                post = lane(W + self.HF * W + (r - self.HF))
                b.assert_eq_block(state[0] * state[0] * state[0], post, V)
                state[0] = post
                state = self._mds_syms(state)

    def fold_constraints_device(self, F, E, local, nxt, sels, publics_m,
                                alpha_pows):
        """(Nq, width) Montgomery rows -> (Nq, D) alpha-folded constraints,
        Σ_k alpha_pows[k]·C_k in `eval`'s order: a Python loop over the
        rounds on (rows, V, W) tensors, a chunk of rows at a time (the
        reference runs three lax.scans). The constraints read no next
        row, so `nxt` is unused."""
        perm, P = self.perm, F.P
        V, W, C, HF = self.V, self.W, self.cols_per_perm, self.HF
        c = perm.consts(local.device)
        out = []
        for r0 in range(0, local.shape[0], _FOLD_CHUNK):
            xc = local[r0:r0 + _FOLD_CHUNK]
            rows = xc.shape[0]
            xc = xc.reshape(rows, V, C)
            acc = torch.zeros((rows, E.D), dtype=torch.int64,
                              device=local.device)
            k = 0
            state = xc[:, :, :W]
            for r in range(len(perm.rc)):
                s = F.add(state, c["rc"][r])
                if perm.is_partial(r):
                    post = xc[:, :, W + HF * W + (r - HF)]  # (rows, V)
                    cons = F.sub(perm.sbox(s[..., 0]), post)
                    state = mds_mul(torch.cat([post[..., None], s[..., 1:]],
                                              dim=-1), c["mds"], P)
                else:
                    base = self._post_base(r)
                    post = xc[:, :, base:base + W]
                    cons = F.sub(mds_mul(perm.sbox(s), c["mds"], P), post)
                    cons = cons.transpose(1, 2).reshape(rows, -1)
                    state = post
                a = alpha_pows[k:k + cons.shape[1]]
                acc += (cons[:, :, None] * a[None] % P).sum(dim=1)
                k += cons.shape[1]
            out.append(acc % P * F.RINV % P)
        return torch.cat(out, dim=0)


def generate_vectorized_trace_p1(air: Poseidon1VectorAir, inputs_std,
                                 device=None):
    """Trace generation on `device` (default cuda): (n_perms, W)
    standard-form inputs (numpy or a tensor; the reference's) ->
    ((n_perms / V, width) int64 Montgomery trace, the final states in
    standard form, int64). Exact int64 arithmetic in standard form; the
    trace's values are the reference's standard-form trace."""
    dev = default_device(device)
    if isinstance(inputs_std, np.ndarray):
        inputs_std = torch.from_numpy(inputs_std.astype(np.int64))
    perm, F = air.perm, air.field
    P = F.P
    x = inputs_std.to(device=dev, dtype=torch.int64) % P
    n = x.shape[0]
    if n % air.V:
        raise ValueError(f"{n} permutations do not fill rows of {air.V}")
    rc = torch.tensor(perm.rc, dtype=torch.int64, device=dev) % P
    mds = torch.from_numpy(perm.mds_matrix_np()).to(dev)
    pieces = [x]
    for r in range(len(perm.rc)):
        x = (x + rc[r]) % P
        if perm.is_partial(r):
            x3 = x[:, 0] * x[:, 0] % P * x[:, 0] % P
            pieces.append(x3[:, None])
            x = mds_mul(torch.cat([x3[:, None], x[:, 1:]], dim=1), mds, P)
        else:
            x = mds_mul(x * x % P * x % P, mds, P)
            pieces.append(x)
    trace = torch.cat(pieces, dim=1)
    del pieces
    trace = F.to_monty_tensor(trace)
    return trace.reshape(n // air.V, air.width), x
