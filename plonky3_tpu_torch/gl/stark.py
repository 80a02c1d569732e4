"""The Goldilocks uni-STARK: transcript, config, quotient and prover.

Port of `plonky3_tpu/gl/stark.py` (uni-stark/src/prover.rs:379 over
goldilocks/src/goldilocks.rs, TWO_ADICITY 32): the transcript order of
`stark/prover.py::prove`, with the field work on int64 Goldilocks tensors
(`gl/field.py`). The verifier is the port's `stark/verifier.py::verify`:
it touches the field through the host ops and `pcs.verify` only.

The transcript is a DuplexChallenger over the width-8 Poseidon2-GL
permutation at rate 4 (challenger/src/duplex_challenger.rs:33), on the
host in exact ints; its proof-of-work grind permutes batches of
candidates with `gl_permute` on the challenger's device.

The quotient: the reference folds the whole quotient domain in one jitted
program, the next row by `jnp.roll`. Here `air.eval` runs over
`GLProverBackend` by blocks of rows (`stark/prover.py::_fold_blocks`),
straight from the committed bit-reversed LDE: an AIR that reads no next
row folds the rows in their committed order, in slices; any other
gathers each block's rows and next rows. The bits are the reference's.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import default_device
from ..air.api import (
    BaseAir,
    get_log_num_quotient_chunks,
    get_symbolic_layout,
    get_widest_stack,
)
from ..challenger.duplex import DuplexChallenger
from ..fields import goldilocks_device as gd
from ..fields.goldilocks import Goldilocks
from ..fri.config import FriParameters
from ..hashes.poseidon2_goldilocks_cuda import gl_permute
from ..stark.config import StarkConfig
from ..stark.proof import Commitments, OpenedValues, Proof
from ..stark.prover import _fold_blocks, _free_bytes
from ..utils.bits import bitrev_indices, bitrev_permute_axis0, log2_strict
from ..utils.timing import stage_timer
from .field import (
    GLE,
    GLF,
    ext_base_mul,
    ext_mul,
    powers_device,
    to_tensor,
)
from .merkle import _GLPermShim, gl_merkle_mmcs
from .pcs import gl_pcs

_P = Goldilocks.P

# the most candidates a grind batch, on the card and on the CPU; a batch
# holds 4·2^bits where that is fewer (its first batch then holds the
# witness with probability 1 - e^-4)
GRIND_BATCH_CUDA = 1 << 18
GRIND_BATCH_CPU = 1 << 12


class GLDuplexChallenger(DuplexChallenger):
    """DuplexChallenger over Poseidon2-GL, width 8, rate 4: host ints,
    and a grind on `device` through the `gl_permute` kernel."""

    def __init__(self, device="cpu"):
        super().__init__(_GLPermShim(), device=device, rate=4)

    def _duplexing(self):
        k = len(self.input_buffer)
        self.state[:k] = self.input_buffer
        self.input_buffer = []
        if k:
            self.state[k:self.rate] = [0] * (self.rate - k)
            self.state[self.rate] = (self.state[self.rate] + k) % _P
        self.state = self.perm.permute_host(self.state)
        self.output_buffer = self.state[:self.rate]

    def grind(self, bits: int) -> int:
        """The smallest witness w: the staged state (the queued inputs,
        then w in lane k, the length tag k + 1) permuted, whose last rate
        lane's low `bits` bits are zero. Candidates go in ascending
        batches, one `gl_permute` launch and one host read a batch."""
        if bits == 0:
            return 0
        rate, k = self.rate, len(self.input_buffer)
        base = list(self.state)
        base[:k] = self.input_buffer
        base[k + 1:rate] = [0] * (rate - k - 1)
        base[rate] = (base[rate] + k + 1) % _P
        dev = self.device
        base_t = to_tensor(base, dev)
        batch = min(GRIND_BATCH_CUDA if dev.type == "cuda"
                    else GRIND_BATCH_CPU, 4 << bits)
        mask = (1 << bits) - 1
        for start in range(0, _P, batch):
            states = base_t.repeat(batch, 1)
            states[:, k] = torch.arange(start, start + batch, device=dev)
            out = gl_permute(states)[:, rate - 1]
            hits = torch.nonzero((out & mask) == 0)
            if hits.numel():
                w = start + int(hits[0, 0])
                if not self.check_witness(bits, w):
                    raise RuntimeError("grind witness failed its replay")
                return w
        raise RuntimeError("no grinding witness found")


def goldilocks_stark_config(fri_params: FriParameters, cap_height: int = 0,
                            device=None) -> StarkConfig:
    """Poseidon2-GL Merkle trees and the GL duplex transcript, proving on
    `device` (`cuda` unless named)."""
    dev = default_device(device)
    pcs = gl_pcs(fri_params, gl_merkle_mmcs(cap_height=cap_height))
    return StarkConfig(pcs=pcs, device=dev,
                       challenger_factory=lambda: GLDuplexChallenger(dev))


# ---------------------------------------------------------------------------
# the quotient
# ---------------------------------------------------------------------------
def _i64(x: int) -> int:
    return gd.to_i64(int(x) % _P)


_CONST_VECS = {}  # (values, device) -> (L, 1) tensor


class GLProverBackend:
    """`air/builder.py::ProverBackend` for Goldilocks: a value is an int64
    tensor over a block of the quotient domain or a Python int (a
    constant, as the int64 that holds its bits); constraint i of K folds
    with alpha^(K-1-i), each product and sum exact mod P. Two constants
    combine on the host."""

    def __init__(self, F, E, alpha_pows):
        self.alpha_pows = alpha_pows  # (K, 2) descending powers
        self.idx = 0
        self.acc = None  # (..., 2)

    def const(self, c):
        return _i64(c)

    def const_vec(self, values):
        """(L, 1), made once per values and device."""
        device = self.alpha_pows.device
        key = (tuple(int(v) % _P for v in values), device)
        hit = _CONST_VECS.get(key)
        if hit is None:
            hit = _CONST_VECS[key] = to_tensor(key[0], device).reshape(-1, 1)
        return hit

    @staticmethod
    def _host(op, a, b):
        return _i64(op(gd.from_i64(a), gd.from_i64(b)))

    def add(self, a, b):
        if isinstance(a, int) and isinstance(b, int):
            return self._host(lambda x, y: x + y, a, b)
        return gd.add(a, b) if isinstance(a, torch.Tensor) else gd.add(b, a)

    def sub(self, a, b):
        if isinstance(a, int) and isinstance(b, int):
            return self._host(lambda x, y: x - y, a, b)
        return gd.sub(a, b)

    def mul(self, a, b):
        if isinstance(a, int) and isinstance(b, int):
            return self._host(lambda x, y: x * y, a, b)
        return gd.mul(a, b) if isinstance(a, torch.Tensor) else gd.mul(b, a)

    def neg(self, a):
        return self.sub(0, a)

    def _tensor(self, v):
        return torch.as_tensor(v, dtype=torch.int64,
                               device=self.alpha_pows.device)

    def _fold(self, term):
        self.acc = term if self.acc is None else gd.add(self.acc, term)

    def emit(self, c):
        ap = self.alpha_pows[self.idx]
        self.idx += 1
        self._fold(gd.mul(self._tensor(c)[..., None], ap))

    def emit_ext(self, comps):
        ap = self.alpha_pows[self.idx]
        self.idx += 1
        comps = torch.stack(torch.broadcast_tensors(
            *[self._tensor(c) for c in comps]), dim=-1)
        self._fold(ext_mul(comps, ap))

    def stack(self, vals):
        return torch.stack(torch.broadcast_tensors(
            *[self._tensor(v) for v in vals]))

    def emit_block(self, v, count):
        """v (..., B) whose leading axes flatten to `count` constraints,
        constraint k with alpha power idx + k."""
        flat = self._tensor(v)
        flat = flat.reshape(count, flat.shape[-1])
        ap = self.alpha_pows[self.idx:self.idx + count]
        self.idx += count
        self._fold(torch.stack([gd.sum_mod(gd.mul(flat, ap[:, d, None]), 0)
                                for d in range(2)], dim=-1))

    def finalize(self, shape):
        if self.acc is None:
            return torch.zeros(tuple(shape) + (2,), dtype=torch.int64,
                               device=self.alpha_pows.device)
        return self.acc.expand(tuple(shape) + (2,)).contiguous()


def gl_selectors_on_coset(trace_domain, coset, device):
    """The selectors over the quotient coset in natural order, int64
    tensors (commit/domain.py selectors_on_coset semantics; the trace
    domain's shift is 1)."""
    n, nq = trace_domain.size, coset.size
    rate_bits = coset.log_n - trace_domain.log_n
    xs = powers_device(coset.gen, nq, device, scale=coset.shift)
    zh_per = gd.sub(powers_device(
        Goldilocks.two_adic_generator_h(rate_bits), 1 << rate_bits, device,
        scale=Goldilocks.exp_h(coset.shift, n)), 1)
    zh = zh_per.repeat(n)
    last_den = gd.sub(xs, _i64(Goldilocks.inv_h(trace_domain.gen)))
    return dict(
        is_first_row=gd.mul(zh, gd.inv(gd.sub(xs, 1))),
        is_last_row=gd.mul(zh, gd.inv(last_den)),
        is_transition=last_den,
        inv_vanishing=gd.inv(zh_per).repeat(n),
    )


# what one quotient row costs in int64 values: two copies of the AIR's
# width (its transposed rows) and _STACK_COPIES of its widest stacked
# value (a Goldilocks product holds some twenty temporaries of its
# operands' size, against the 31-bit fields' few)
_ROW_COPIES = 2
_STACK_COPIES = 24
_MEMORY_SHARE = 0.6


def gl_fold_block_rows(air: BaseAir, nq: int, device) -> int:
    """The largest power of two, at most nq, of rows whose temporaries
    fit in _MEMORY_SHARE of the device's free memory."""
    per_row = 8 * (_ROW_COPIES * air.width
                   + _STACK_COPIES * get_widest_stack(air))
    rows = max(1, int(_free_bytes(device) * _MEMORY_SHARE) // per_row)
    return min(nq, 1 << (rows.bit_length() - 1))


def gl_quotient(air: BaseAir, trace_domain, quotient_domain, lde_prefix,
                public_values, alpha_pows, block_rows=None):
    """The quotient in natural order, (Nq, 2), from the committed
    bit-reversed LDE rows of the quotient domain (natural row i is row
    bitrev(i) of `lde_prefix`)."""
    if air.periodic_columns():
        raise ValueError("the Goldilocks prover takes no periodic columns")
    nq, device = quotient_domain.size, lde_prefix.device
    log_nq = quotient_domain.log_n
    if lde_prefix.shape[0] != nq:
        raise ValueError(f"{lde_prefix.shape[0]} rows for a domain of {nq}")
    sels = gl_selectors_on_coset(trace_domain, quotient_domain, device)
    bitrev_fold = air.main_next_row_columns() == []
    if bitrev_fold:
        sels = {k: bitrev_permute_axis0(v, log_nq) for k, v in sels.items()}
        step, src = 0, None
    else:
        step = nq // trace_domain.size
        src = torch.from_numpy(bitrev_indices(log_nq)).to(device)

    def columns(a, b):
        if src is None:
            return lde_prefix[a:b].t().contiguous()
        idx = src[torch.arange(a, b, device=device) % nq]
        return torch.index_select(lde_prefix.t(), 1, idx).contiguous()

    if block_rows is None:
        block_rows = gl_fold_block_rows(air, nq, device)
    publics = [_i64(v) for v in public_values]
    folded = _fold_blocks(GLF, GLE, air, nq, step, columns, sels, None,
                          publics, alpha_pows, block_rows,
                          backend=GLProverBackend)
    q = ext_base_mul(sels["inv_vanishing"], folded)
    return bitrev_permute_axis0(q, log_nq) if bitrev_fold else q


def gl_alpha_powers(air, alpha, device):
    """[alpha^(K-1), ..., 1] for the K constraints of `air`: (K, 2)."""
    num_constraints, _ = get_symbolic_layout(air)
    return to_tensor(np.ascontiguousarray(
        GLE.powers_np(alpha, num_constraints)[::-1]), device)


# ---------------------------------------------------------------------------
# prove
# ---------------------------------------------------------------------------
def prove_gl(config: StarkConfig, air: BaseAir, trace, public_values,
             spans=None) -> Proof:
    """trace: (n, width) int64 tensor of Goldilocks elements on the
    config's device (or a uint64 numpy array, copied there); public
    values canonical ints. spans: optional dict of seconds per stage (the
    device is synchronized at each stage end)."""
    pcs = config.pcs
    if isinstance(trace, np.ndarray):
        trace = to_tensor(trace, config.device)
    if trace.device.type != config.device.type:
        raise ValueError(f"trace on {trace.device}, config on "
                         f"{config.device}")
    device = trace.device
    mark = stage_timer(spans, device)
    n = trace.shape[0]
    log_n = log2_strict(n)
    num_chunks = 1 << get_log_num_quotient_chunks(air)

    trace_domain = pcs.natural_domain_for_degree(n)
    trace_data = pcs.commit([(trace_domain, trace)])
    mark("commit trace")

    ch = config.initialise_challenger()
    ch.observe(log_n)
    ch.observe(log_n)
    ch.observe(0)
    ch.observe_digest(trace_data.commitment)
    ch.observe_many(public_values)
    alpha = ch.sample_ext(2)

    quotient_domain = trace_domain.create_disjoint_domain(n * num_chunks)
    rows = pcs.get_evaluations_on_domain(trace_data, 0, quotient_domain,
                                         order="bitrev")
    q = gl_quotient(air, trace_domain, quotient_domain, rows, public_values,
                    gl_alpha_powers(air, alpha, device))
    del rows
    mark("quotient eval")

    sub_evals = quotient_domain.split_evals(num_chunks, q)
    sub_domains = quotient_domain.split_domains(num_chunks)
    quotient_data = pcs.commit(list(zip(sub_domains, sub_evals)))
    del q, sub_evals
    ch.observe_digest(quotient_data.commitment)
    mark("commit quotient")

    zeta = ch.sample_ext(2)
    zeta_next = trace_domain.next_point_ext(GLE, zeta)
    uses_next = air.main_next_row_columns() != []
    trace_points = [zeta, zeta_next] if uses_next else [zeta]
    opened, fri_proof = pcs.open(
        [(trace_data, [trace_points]),
         (quotient_data, [[zeta]] * num_chunks)], ch, spans=spans)
    mark("open (pcs + fri)")
    return Proof(
        commitments=Commitments(trace=trace_data.commitment,
                                quotient_chunks=quotient_data.commitment),
        opened_values=OpenedValues(
            trace_local=opened[0][0][0],
            trace_next=opened[0][0][1] if uses_next else None,
            quotient_chunks=[opened[1][i][0] for i in range(num_chunks)]),
        opening_proof=fri_proof,
        degree_bits=log_n,
    )
