"""The four-step DIF NTT kernels (csrc/ntt.cu): wrapper, tables and plain
version.

Port of `plonky3_tpu/ops/ntt_pallas.py::dif_fused`. The (n, w) matrix is
viewed as x[(a, b), c] with n = A·B, A = 2^ceil(log_n/2): k1 runs a size-A
DIF along a and multiplies by the correction w_n^{rev_A(a)·b}; k2 runs a
size-B DIF along b. The output is bit for bit the radix-2 network
`ops.ntt._dif_plain` (bit-reversed rows).

Tables are built on the host and cached per (field, log_n, direction,
device): the stage twiddles of each sub-transform (standard form, then
their Shoup quotients floor(w·2^32/P)) and the (A, B) correction table
(standard form, then Shoup).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from ..utils.bits import bitrev_indices
from .ntt import _dif_plain, powers_std_np

MAX_LOG_N = 20  # sub-transforms of up to 2^10 rows (128 KB shared memory)

_TABLES: dict = {}


def split(log_n: int):
    """(log_a, log_b) of the four-step split."""
    log_a = log_n - log_n // 2
    return log_a, log_n - log_a


def tables_np(F, log_n: int, inverse: bool):
    """Host tables (tw_a, tw_b, corr) as uint32 arrays.

    tw_a: 2·(A/2) words — std twiddles w_A^j then their Shoup quotients;
    tw_b: the same for w_B; corr: 2·A·B words — corr[a·B + b] =
    w_n^{rev_A(a)·b} (standard form), then the Shoup quotients."""
    log_a, log_b = split(log_n)
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


def _tables(F, log_n: int, inverse: bool, device):
    key = (F.name, log_n, inverse, str(device))
    hit = _TABLES.get(key)
    if hit is None:
        hit = tuple(
            torch.from_numpy(t.view(np.int32).copy()).to(device)
            for t in tables_np(F, log_n, inverse)
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

    A CPU tensor takes the plain version; a CUDA tensor launches k1 and
    k2."""
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
    if not 1 <= log_n <= MAX_LOG_N:
        raise ValueError(f"dif_fused: log_n {log_n} outside [1, {MAX_LOG_N}]")
    out = torch.empty((n, x.shape[1]), dtype=torch.int32, device=x.device)
    y1 = launch_k1(F, x, log_n, inverse, zero_top)
    launch_k2(F, y1, out, log_n, inverse)
    return out


def launch_k1(F, x, log_n: int, inverse: bool, zero_top: bool):
    """Step 1 on a checked CUDA int32 matrix; returns the (n, w) result."""
    log_a, log_b = split(log_n)
    tw_a, _, corr = _tables(F, log_n, inverse, x.device)
    y1 = torch.empty((1 << log_n, x.shape[1]), dtype=torch.int32,
                     device=x.device)
    kernels.check(kernels.lib("ntt").ntt_k1(
        x.data_ptr(), y1.data_ptr(), tw_a.data_ptr(), corr.data_ptr(),
        log_a, log_b, x.shape[1], int(zero_top), F.P,
        kernels.stream_of(x)), "ntt_k1")
    kernels.LAUNCHES["ntt_k1"] += 1
    return y1


def launch_k2(F, y1, out, log_n: int, inverse: bool):
    """Step 2: the size-B transforms of y1 into out (both (n, w))."""
    log_a, log_b = split(log_n)
    _, tw_b, _ = _tables(F, log_n, inverse, y1.device)
    kernels.check(kernels.lib("ntt").ntt_k2(
        y1.data_ptr(), out.data_ptr(), tw_b.data_ptr(), log_a, log_b,
        y1.shape[1], F.P, kernels.stream_of(y1)), "ntt_k2")
    kernels.LAUNCHES["ntt_k2"] += 1
