"""Randomized Reed–Solomon encodings for the zero-knowledge variants: the
`zk-codes` crate as a component (zk-codes/src/{encoding,reed_solomon}.rs;
eprint 2026/391 §3.2.1).

Port of `plonky3_tpu/multilinear/zk_codes.py`. A codeword is the RS
evaluation of the coefficient vector [message || randomness_t || 0] over
a 2^log_m point coset: the t uniformly random coefficients make any t
codeword positions jointly uniform (perfect simulation, the MDS
property), so a spot-check protocol that queries at most t positions
learns nothing of the message.

The encoding runs on the device through `ops/ntt.py::
coset_evals_from_coeffs` (K1/K2 on a CUDA tensor); the random draws are
the reference's numpy calls, in its order.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops.ntt import coset_evals_from_coeffs
from ..utils.bits import bitrev_permute_axis0, log2_ceil


@dataclass(frozen=True)
class ReedSolomonZkEncoding:
    """zk-codes/src/reed_solomon.rs:40: the parameters of one encoding.
    `device`: where the encoding runs (default `cuda`)."""

    F: object  # the base field (Monty31)
    t: int  # the query budget: the number of random coefficients
    msg_len: int
    log_m: int  # codeword length 2^log_m
    shift_std: int = 1  # the evaluation coset's shift (1: the subgroup)
    device: object = None

    def __post_init__(self):
        if self.msg_len + self.t > (1 << self.log_m):
            raise ValueError("message + randomness exceed codeword length")

    @property
    def codeword_len(self) -> int:
        return 1 << self.log_m

    @property
    def randomness_len(self) -> int:
        return self.t

    @property
    def query_bound(self) -> int:
        return self.t

    def sample_randomness(self, rng) -> np.ndarray:
        return self.F.rand_np(rng, (self.t,), monty=False)

    def _device(self):
        from .. import default_device

        return default_device(self.device)

    def coefficients(self, msg_m, randomness_m):
        """[msg || randomness || 0] as a 1-D int64 Montgomery tensor of
        the least power-of-two length that holds both, on the message's
        device."""
        if msg_m.shape[0] != self.msg_len:
            raise ValueError(f"a message of {msg_m.shape[0]} words, not "
                             f"{self.msg_len}")
        if randomness_m.shape[0] != self.t:
            raise ValueError(f"{randomness_m.shape[0]} random words, not "
                             f"{self.t}")
        m = 1 << log2_ceil(max(self.msg_len + self.t, 1))
        c = torch.zeros(m, dtype=torch.int64, device=msg_m.device)
        c[:self.msg_len] = msg_m
        c[self.msg_len:self.msg_len + self.t] = randomness_m.to(msg_m.device)
        return c

    def codeword_bitrev(self, coeffs_m):
        """The codeword of the coefficient vector `coeffs_m` (int64
        Montgomery, a power-of-two length at most 2^log_m) over the
        coset, bit-reversed, as an (2^log_m, 1) Montgomery tensor: the
        same evaluations as the reference's full-length DFT of the
        zero-padded vector."""
        added = self.log_m - log2_ceil(coeffs_m.shape[0])
        return coset_evals_from_coeffs(self.F, coeffs_m.reshape(-1, 1),
                                       added, self.shift_std)

    def encode_with_randomness(self, msg_std, randomness_std):
        """The codeword (natural order, standard form, a numpy uint32
        array) of [msg || randomness || 0] (reed_solomon.rs:175)."""
        F = self.F
        dev = self._device()

        def monty(a):
            a = np.asarray(a, dtype=np.uint64).astype(np.uint32)
            return torch.from_numpy(F.to_monty_np(a).astype(np.int64)).to(
                dev)

        cw = self.codeword_bitrev(self.coefficients(monty(msg_std),
                                                    monty(randomness_std)))
        cw = bitrev_permute_axis0(cw, self.log_m)[:, 0]
        return F.from_monty_np(cw.cpu().numpy())

    def encode(self, msg_std, rng):
        return self.encode_with_randomness(msg_std,
                                           self.sample_randomness(rng))

    def simulate(self, query_set, rng) -> np.ndarray:
        """Identically distributed values at <= t distinct positions,
        without the message (encoding.rs:58)."""
        out = np.zeros(len(query_set), np.uint32)
        cache = {}
        for i, p in enumerate(query_set):
            if p not in cache:
                cache[p] = int(self.F.rand_np(rng, (1,), monty=False)[0])
            out[i] = cache[p]
        if len(cache) > self.t:
            raise ValueError("more distinct positions than budget")
        return out
