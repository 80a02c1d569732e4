"""Multilinear (MLE) tables: the `multilinear-util` crate analog.

Port of `plonky3_tpu/multilinear/mle.py`. A multilinear over n variables
is its 2^n evaluations in natural index order, variable 0 the LOW index
bit (bound first by the sumcheck). eq(r, x) = prod_i (r_i x_i +
(1-r_i)(1-x_i)). The eq table builds as n outer products on the device.
"""

from __future__ import annotations

import torch


def eq_table_device(E, r_ext, device):
    """eq(r, x) for all x in {0,1}^n as a (2^n, D) Montgomery tensor on
    `device`. r_ext: host ext tuples; index bit i of x is variable i."""
    table = E.const(E.one_h(), device)[None, :]
    # each step makes the current r the low index bit and shifts the
    # earlier ones up, so go from the last to the first: afterwards bit i
    # of the index belongs to r_ext[i]
    for r in reversed(r_ext):
        lo = E.mul(table, E.const(E.sub_h(E.one_h(), r), device))
        hi = E.mul(table, E.const(r, device))
        table = torch.stack([lo, hi], dim=1).reshape(-1, E.D)
    return table


def eval_mle_host(E, evals_std, r_ext):
    """The MLE of `evals_std` (base ints, 2^n of them) at the ext point r
    (host, exact)."""
    cur = [E.from_base_h(int(v)) for v in evals_std]
    for r in r_ext:
        one_minus = E.sub_h(E.one_h(), r)
        cur = [E.add_h(E.mul_h(cur[i], one_minus), E.mul_h(cur[i + 1], r))
               for i in range(0, len(cur), 2)]
    if len(cur) != 1:
        raise ValueError("the point's length does not match the table")
    return cur[0]
