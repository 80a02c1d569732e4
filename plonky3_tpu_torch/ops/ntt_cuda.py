"""The four-step DIF NTT kernels (csrc/ntt.cu): launch plan, wrapper,
tables and plain version.

Port of `plonky3_tpu/ops/ntt_pallas.py::dif_fused`. The (n, w) matrix is
viewed as x[(a, b), c] with n = A·B: k1 runs a size-A DIF along a and
multiplies by the correction w_n^{rev_A(a)·b}; k2 runs a size-B DIF along
b. The output is bit for bit the radix-2 network `ops.ntt._dif_plain`
(bit-reversed rows).

A kernel runs sub-transforms of at most 2^MAX_LOG_HALF rows. `plan` turns
a transform of any size up to the field's two-adicity into launches: the
pair (k1, k2) while log_n ≤ 2·MAX_LOG_HALF; above that, as in the JAX
`dif_fused`, k1 runs with log_a = MAX_LOG_HALF and the A contiguous
(B, w) slabs of its output are then transformed by a batched four-step
of size B, planned the same way.

Tables are built on the host and cached per (field, log_n, log_a,
direction, device): the stage twiddles of each sub-transform (standard
form, then their Shoup quotients floor(w·2^32/P)) and the (A, B)
correction table (standard form, then Shoup).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import kernels
from ..utils.bits import bitrev_indices
from .ntt import _dif_plain, powers_std_np

MAX_LOG_HALF = 10  # largest sub-transform: 2^10 rows, 128 KB shared memory

_TABLES: dict = {}


class Launch(NamedTuple):
    """One kernel launch of a plan: `kernel` ("k1" or "k2") runs the
    four-step split (log_a, log_b) of a size-2^log_n transform, whose
    tables it reads, on `batch` contiguous slabs of 2^log_n rows."""

    kernel: str
    log_n: int
    log_a: int
    log_b: int
    batch: int
    zero_top: bool


def split(log_n: int, max_log_half: int = MAX_LOG_HALF):
    """(log_a, log_b) of the four-step split; log_a is capped at
    max_log_half, as in the JAX `dif_fused`."""
    log_a = min(log_n - log_n // 2, max_log_half)
    return log_a, log_n - log_a


def plan(log_n: int, zero_top: bool = False,
         max_log_half: int = MAX_LOG_HALF) -> list:
    """The launches of one DIF of size 2^log_n. Each level runs k1; a
    level whose size-B transforms fit one kernel ends with k2, a larger
    one hands its A·batch slabs of B rows to the next level."""
    steps = []
    batch = 1
    while True:
        log_a, log_b = split(log_n, max_log_half)
        steps.append(Launch("k1", log_n, log_a, log_b, batch, zero_top))
        if log_b <= max_log_half:
            steps.append(Launch("k2", log_n, log_a, log_b, batch, False))
            return steps
        log_n, batch, zero_top = log_b, batch << log_a, False


def tables_np(F, log_n: int, inverse: bool, log_a: int):
    """Host tables (tw_a, tw_b, corr) as uint32 arrays for the split
    (log_a, log_n − log_a).

    tw_a: 2·(A/2) words — std twiddles w_A^j then their Shoup quotients;
    tw_b: the same for w_B; corr: 2·A·B words — corr[a·B + b] =
    w_n^{rev_A(a)·b} (standard form), then the Shoup quotients."""
    log_b = log_n - log_a
    A, B, n = 1 << log_a, 1 << log_b, 1 << log_n
    g = F.two_adic_generator_h(log_n)
    if inverse:
        g = F.inv_h(g)
    tw_full = powers_std_np(F, g, max(n >> 1, 1))

    def shoup_pair(t):
        return np.concatenate([t, F.shoup_np(t)])

    tw_a = shoup_pair(tw_full[::B][: A >> 1])
    tw_b = shoup_pair(tw_full[::A][: B >> 1])
    pw = powers_std_np(F, g, n)
    rev_a = bitrev_indices(log_a)
    expo = (rev_a[:, None] * np.arange(B, dtype=np.int64)[None, :]) % n
    corr = shoup_pair(pw[expo].reshape(-1))
    return tw_a, tw_b, corr


def _tables(F, log_n: int, log_a: int, inverse: bool, device):
    key = (F.name, log_n, log_a, inverse, str(device))
    hit = _TABLES.get(key)
    if hit is None:
        hit = tuple(
            torch.from_numpy(t.view(np.int32).copy()).to(device)
            for t in tables_np(F, log_n, inverse, log_a)
        )
        _TABLES[key] = hit
    return hit


def dif_fused_plain(F, x, log_n: int, inverse: bool, zero_top: bool = False):
    """The kernels' contract in plain PyTorch: int32 (rows, w) u32 words
    in, (2^log_n, w) out, via the radix-2 network."""
    v = x.to(torch.int64)
    if zero_top:
        v = torch.cat([v, torch.zeros_like(v)], dim=0)
    return _dif_plain(F, v, log_n, inverse).to(torch.int32)


def dif_fused(F, x, log_n: int, inverse: bool, zero_top: bool = False):
    """DIF along axis 0 of an int32 (n, w) matrix of Montgomery words
    (n = 2^log_n, or n/2 rows with zero_top); bit-reversed rows out.

    A CPU tensor takes the plain version; a CUDA tensor runs `plan`."""
    if x.dim() != 2:
        raise ValueError(f"dif_fused: expected a 2-D matrix, got {x.shape}")
    n = 1 << log_n
    rows = n >> 1 if zero_top else n
    if x.shape[0] != rows or x.shape[1] == 0:
        raise ValueError(
            f"dif_fused: shape {tuple(x.shape)} does not match log_n "
            f"{log_n} (zero_top={zero_top})")
    if x.device.type == "cpu":
        return dif_fused_plain(F, x, log_n, inverse, zero_top)
    kernels.require_cuda_tensor(x, "dif_fused", torch.int32)
    if not 1 <= log_n <= F.TWO_ADICITY:
        raise ValueError(
            f"dif_fused: log_n {log_n} outside [1, {F.TWO_ADICITY}]")
    steps = plan(log_n, zero_top)
    bufs = [torch.empty((n, x.shape[1]), dtype=torch.int32, device=x.device)
            for _ in range(min(len(steps), 2))]
    src = x
    for i, step in enumerate(steps):
        launch(F, step, src, bufs[i % 2], inverse)
        src = bufs[i % 2]
    return src


def launch(F, step: Launch, src, dst, inverse: bool):
    """One launch of a plan, from src into dst (checked CUDA int32
    matrices of `step.batch` slabs; src has half the rows with
    zero_top)."""
    log_a, log_b = step.log_a, step.log_b
    tw_a, tw_b, corr = _tables(F, step.log_n, log_a, inverse, src.device)
    ntt = kernels.lib("ntt")
    stride = 1 << step.log_n
    if step.kernel == "k1":
        kernels.check(ntt.ntt_k1(
            src.data_ptr(), dst.data_ptr(), tw_a.data_ptr(), corr.data_ptr(),
            log_a, log_b, src.shape[1], int(step.zero_top), step.batch,
            stride, F.P, kernels.stream_of(src)), "ntt_k1")
        kernels.LAUNCHES["ntt_k1"] += 1
    else:
        kernels.check(ntt.ntt_k2(
            src.data_ptr(), dst.data_ptr(), tw_b.data_ptr(), log_a, log_b,
            src.shape[1], step.batch, stride, F.P,
            kernels.stream_of(src)), "ntt_k2")
        kernels.LAUNCHES["ntt_k2"] += 1
