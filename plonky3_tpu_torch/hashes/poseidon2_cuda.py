"""The Poseidon2 transcript kernels (csrc/poseidon2.cu): wrappers and plain
versions.

The duplex transcript (`challenger/device_duplex.py`) of the Poseidon2
config (DuplexChallenger<F, Perm24, 24, 16>). The JAX package computes
both in jnp, not in a TPU kernel; they are kernels here because a width-24
permutation in plain PyTorch is some 450 launches, and the transcript's
longest absorb (the opened values before alpha2, about 660 blocks) would
be some 300,000 launches one after another.

- `poseidon2_duplex_chain`: a (24,) state and (n,) words -> the state
  after absorbing the words in rate blocks of 16, each block overwriting
  lanes 0..k-1 (a partial last block zeroes lanes k..15), adding the
  length tag k to lane 16 and permuting; with no words, one permutation.
  One launch. Replaces `native/poseidon2.c::p3_p2_duplex_chain` and the
  `lax.scan` absorb of `plonky3_tpu/challenger/device_duplex.py:58`.
- `poseidon2_grind`: the smallest proof-of-work witness, as a (1,) tensor
  on the device. One launch of a grid sized to the card, searching in
  ascending rounds. Replaces `device_duplex.py:146` `grind_field`.

Both take and return int32 tensors of Montgomery-form words and a width-24
`Poseidon2` whose tables they read: KoalaBear's (s-box degree 3, 23
internal rounds) or BabyBear's (degree 7, 21 rounds), the kernels'
instantiations `<23, 3>` and `<21, 7>` (`INSTANCES`); any other raises
`ValueError`. A CPU tensor takes the plain version (`Poseidon2.permute`);
a CUDA tensor launches the kernel. Each instantiation has its own launch
counts: `poseidon2_duplex_chain` and `poseidon2_grind` for `<23, 3>`, the
same names with `_babybear` for `<21, 7>`.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels

WIDTH = 24
RATE = 16
GRIND_MAX_WINDOW = 1 << 17
# the kernels' instantiations: (s-box degree, internal rounds) -> the suffix
# of their launch counts' names
INSTANCES = {(3, 23): "", (7, 21): "_babybear"}


def instance(perm):
    """(degree, rounds) of a width-24 permutation the kernels take; raises
    ValueError for any other."""
    key = (perm.d, len(perm.rc_internal))
    if perm.width != WIDTH or key not in INSTANCES:
        raise ValueError(
            f"the duplex kernels take a width-{WIDTH} permutation of s-box "
            f"degree and internal rounds in {sorted(INSTANCES)}, not width "
            f"{perm.width}, {key}")
    return key


def launch_name(kernel, perm):
    """The name of the launch count of `kernel` ("poseidon2_duplex_chain"
    or "poseidon2_grind") for `perm`'s instantiation."""
    return kernel + INSTANCES[instance(perm)]


def _blocks(n):
    """(block count, lanes of the last block) of an n-word absorb."""
    nb = max(1, -(-n // RATE))
    return nb, n - RATE * (nb - 1)


def poseidon2_duplex_chain_plain(perm, state, words):
    """`poseidon2_duplex_chain` in plain PyTorch."""
    F = perm.F
    st = state.to(torch.int64)
    w = words.to(torch.int64)
    nb, k_last = _blocks(w.shape[0])
    for b in range(nb):
        k = RATE if b + 1 < nb else k_last
        if k:
            blk = torch.zeros(RATE, dtype=torch.int64, device=st.device)
            blk[:k] = w[b * RATE:b * RATE + k]
            st = torch.cat([blk, F.add(st[RATE:RATE + 1], F.to_monty_h(k)),
                            st[RATE + 1:]])
        st = perm.permute(st)
    return st.to(torch.int32)


def grind_batch(pow_bits):
    """The plain version's window: about four times the expected
    2^pow_bits tries, at most GRIND_MAX_WINDOW candidates permuted at
    once. The kernel does not read it (its grid is sized to the card), and
    the witness found does not depend on it."""
    return min(GRIND_MAX_WINDOW, 1 << (pow_bits + 2))


def poseidon2_grind_plain(perm, base, lane, pow_bits):
    """The smallest w in [0, p) such that the permutation of `base` with
    lane `lane` set to w's Montgomery form has, in lane RATE - 1 (the
    first sample), a standard-form value with pow_bits low zero bits; as a
    (1,) int32 tensor (-1 if none exists). Plain PyTorch, in windows of
    `grind_batch` candidates, in standard form."""
    F = perm.F
    std = F.from_monty_tensor(base.to(torch.int64))
    tables = perm.std_tables(base.device)
    mask, batch = (1 << pow_bits) - 1, grind_batch(pow_bits)
    for start in range(0, F.P, batch):
        cand = torch.arange(start, min(start + batch, F.P),
                            dtype=torch.int64, device=base.device)
        states = std.expand(cand.shape[0], WIDTH).clone()
        states[:, lane] = cand
        out = perm.permute_std(states, tables)
        hit = (out[:, RATE - 1] & mask) == 0
        if bool(hit.any()):
            return cand[hit.to(torch.int8).argmax()].reshape(1).to(
                torch.int32)
    return torch.full((1,), -1, dtype=torch.int32, device=base.device)


def internal_tables(perm):
    """The duplex chain's internal-round tables in standard form, (R, 24)
    and (24,) int64 for R internal rounds: row k of the first holds d_i^k
    for lanes i >= 1 (0 in lane 0), the second c_k = sum of row k for
    k < R and 0 from k = R on.
    For i >= 1 an internal round maps x_i to S + d_i·x_i, so
    Q_k = sum_{i>=1} d_i^k·x_i becomes c_k·S + Q_{k+1}."""
    P, rounds = perm.F.P, len(perm.rc_internal)
    pows = np.array([[0] + [pow(d, k, P) for d in perm.diag_std[1:]]
                     for k in range(rounds)], dtype=np.int64)
    csum = np.zeros(WIDTH, dtype=np.int64)
    csum[:rounds] = pows.sum(axis=1) % P
    return pows, csum


def kernel_table(perm, device):
    """The kernels' constant table on `device`: Montgomery-form u32
    words, the external initial round constants (4 × 24), the internal
    ones (R), the external final ones (4 × 24), the internal diagonal
    (24); then the chain's `internal_tables` (R × 24, 24); then, for the
    grind's Shoup products, the diagonal in standard form d (24) and
    floor(d·2^32 / p) (24). The grind reads the round constants and the
    last part."""
    def make(dev):
        c = perm._device_consts()
        pows, csum = internal_tables(perm)
        mont = [perm.F.to_monty_np(t.reshape(-1).astype(np.uint32))
                for t in (pows, csum)]
        d = np.array(perm.diag_std, dtype=np.int64)
        flat = np.concatenate([c["rc_ei"].reshape(-1), c["rc_int"],
                               c["rc_ef"].reshape(-1), c["diag"], *mont,
                               d, (d << 32) // perm.F.P])
        flat = flat.astype(np.uint32).astype(np.int32)
        return torch.from_numpy(flat).to(dev)

    return perm.on_device("kernel", device, make)


def _field_args(F):
    """p, its inverse mod 2^32 and 2^64 mod p (to Montgomery form by a
    Montgomery product)."""
    return F.P, F.MU, (1 << 64) % F.P


def poseidon2_duplex_chain(perm, state, words):
    """Duplex absorb: (24,) int32 Montgomery state and (n,) int32
    Montgomery words, n >= 0 -> the (24,) state after them (see the module
    docstring). The input state is not changed."""
    degree, rounds = instance(perm)
    if state.shape != (WIDTH,) or words.dim() != 1:
        raise ValueError(f"poseidon2_duplex_chain: state {tuple(state.shape)}"
                         f", words {tuple(words.shape)}")
    if state.device != words.device:
        raise ValueError("poseidon2_duplex_chain: state and words must "
                         "share a device")
    if state.device.type == "cpu":
        return poseidon2_duplex_chain_plain(perm, state, words)
    kernels.require_cuda_tensor(state, "poseidon2_duplex_chain", torch.int32)
    kernels.require_cuda_tensor(words, "poseidon2_duplex_chain", torch.int32)
    out = torch.empty_like(state)
    p, mu, r2 = _field_args(perm.F)
    kernels.check(kernels.lib("poseidon2").poseidon2_duplex_chain(
        state.data_ptr(), words.data_ptr(), words.shape[0], out.data_ptr(),
        kernel_table(perm, state.device).data_ptr(), p, mu, r2, rounds,
        degree, kernels.stream_of(state)), "poseidon2_duplex_chain")
    kernels.LAUNCHES[launch_name("poseidon2_duplex_chain", perm)] += 1
    return out


def poseidon2_grind(perm, base, lane, pow_bits):
    """Proof-of-work search: the (24,) int32 Montgomery state staged for
    the witness's duplexing (the witness goes to lane `lane`) -> the
    smallest witness of `poseidon2_grind_plain`, as a (1,) int32 tensor on
    the device of `base`; nothing is copied to the host."""
    degree, rounds = instance(perm)
    if base.shape != (WIDTH,) or not 0 <= lane < RATE or not (
            1 <= pow_bits <= 30):
        raise ValueError(f"poseidon2_grind: state {tuple(base.shape)}, lane "
                         f"{lane}, {pow_bits} bits")
    if base.device.type == "cpu":
        return poseidon2_grind_plain(perm, base, lane, pow_bits)
    kernels.require_cuda_tensor(base, "poseidon2_grind", torch.int32)
    best = torch.full((1,), -1, dtype=torch.int32, device=base.device)
    p, mu, r2 = _field_args(perm.F)
    kernels.check(kernels.lib("poseidon2").poseidon2_grind(
        base.data_ptr(), lane, pow_bits,
        kernel_table(perm, base.device).data_ptr(), p, mu, r2, rounds,
        degree, best.data_ptr(), kernels.stream_of(base)), "poseidon2_grind")
    kernels.LAUNCHES[launch_name("poseidon2_grind", perm)] += 1
    return best
