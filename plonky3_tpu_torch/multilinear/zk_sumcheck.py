"""The masked (HVZK) zerocheck: the `sumcheck/src/zk` analog
(Construction 6.3 of eprint 2026/391; sumcheck/src/zk/{mod,verifier}.rs).

Port of `plonky3_tpu/multilinear/zk_sumcheck.py`. The plain zerocheck's
round polynomials are affine in the witness. This variant blinds every
wire with one full-degree univariate mask a round:

  1. The prover samples n univariate masks s_j of degree deg_round (ext
     coefficients), stacks their coefficient components into one base
     multilinear and commits it under the hiding WHIR (the mask oracle).
  2. It sends mu = Σ_x M(x) = Σ_j 2^{n-1}(s_j(0)+s_j(1)), where
     M(x) = Σ_j s_j(x_j); the verifier samples the combiner eps.
  3. The sumcheck runs on G = eps·eq(r,x)·C(x) + M(x); wire j:
        h_j(X) = eps·f_j(X) + 2^{n-j-1}·(A_j + s_j(X))
                 + 2^{n-j-2}·Σ_{l>j}(s_l(0)+s_l(1))
     (0-based j; A_j = Σ_{l<j} s_l(γ_l)): every wire coefficient is
     masked by the one-time s_j.
  4. The final anchor: target = eps·eq(r,γ)·C(openings) + Σ_l s_l(γ_l);
     the mask values are authenticated by one batched hiding-WHIR
     opening: the components of s_l(γ_l) are MLE evaluations of the mask
     multilinear at (power_point(γ_l), bits(d), bits(l)).

The f_j part is the port's zerocheck round (`sumcheck.py`): the trace is
the port's (n, w) Montgomery tensor, and every table is one slice of the
(N, 2w+3, D) stacked tensor on its device. The masks and their algebra are
host values, tiny beside the trace; the mask oracle commits on the
trace's device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..air.api import _make_builder
from ..air.builder import VerifierBackend
from ..utils.bits import log2_ceil
from ..utils.timing import stage_timer
from .device_kernels import pull_ext
from .mle import eq_table_device
from .sumcheck import (
    _fold_cols,
    _lagrange_at,
    _zerocheck_round,
    boundary_evals_at,
    get_ml_layout,
    selector_tables_device,
)


@dataclass
class MaskedZerocheckProof:
    mask_commit: tuple
    mu: tuple  # the claimed hypercube sum of the mask polynomial
    rounds: list  # [n] -> [deg_round+1] wire evaluations at t = 0..deg
    final_local: list
    final_next: list
    mask_values: list  # [n][D] ext: s_l(gamma)'s component d a round
    mask_opening: object  # the HidingWhirProof (batched multi-point)


def _power_point(E, gamma, log_ell):
    out, g = [], gamma
    for _ in range(log_ell):
        out.append(g)
        g = E.mul_h(g, g)
    return out


def _bits_point(E, v, nbits):
    return [E.from_base_h((v >> b) & 1) for b in range(nbits)]


def _eval_univariate(E, coeffs, x):
    acc = E.zero_h()
    for c in reversed(coeffs):
        acc = E.add_h(E.mul_h(acc, x), c)
    return acc


def _mask_layout(E, n, ell):
    """(log_ell, d_bits, j_bits, flat_len) of the stacked mask vector:
    flat[k + ell_pad·(d + D·j)] = s_j's coefficient k, component d."""
    log_ell = log2_ceil(max(ell, 2))
    d_bits = log2_ceil(max(E.D, 2))
    j_bits = log2_ceil(max(n, 2))
    flat_len = 1 << (log_ell + d_bits + j_bits)
    return log_ell, d_bits, j_bits, flat_len


def _mask_point(E, gamma, l, d, log_ell, d_bits, j_bits):
    return (_power_point(E, gamma, log_ell) + _bits_point(E, d, d_bits)
            + _bits_point(E, l, j_bits))


def _mask_flat(F, masks, E, log_ell, d_bits, j_bits, flat_len):
    """The committed coefficient vector of the masks (standard form,
    uint32): the low log_ell coordinates hold monomial coefficients (power
    points evaluate the univariate); the (d, j) selector coordinates hold
    evaluation-basis values, whose Möbius transform is committed, so an
    evaluation at bits(d), bits(j) isolates one slot."""
    ell_pad = 1 << log_ell
    sel_bits = d_bits + j_bits
    cube = np.zeros((ell_pad, 1 << sel_bits), np.uint64)
    for j, coeffs in enumerate(masks):
        for k, c in enumerate(coeffs):
            for d in range(E.D):
                cube[k, d + (1 << d_bits) * j] = c[d]
    P64 = np.uint64(F.P)
    for bit in range(sel_bits):
        m = 1 << bit
        for t in range(1 << sel_bits):
            if t & m:
                cube[:, t] = (cube[:, t] + P64 - cube[:, t ^ m]) % P64
    flat = np.zeros(flat_len, np.uint32)
    for t in range(1 << sel_bits):
        flat[t * ell_pad:(t + 1) * ell_pad] = cube[:, t]
    return flat


def _mask_statement(E, chs, values, log_ell, d_bits, j_bits, lam):
    """The batched opening's points, scales and claim: Σ_l,d
    λ^(l·D+d)·mask(point(γ_l, l, d)) = Σ λ^(l·D+d)·values[l][d]."""
    lp = E.one_h()
    points_scales, claim = [], E.zero_h()
    for l, ch in enumerate(chs):
        for d in range(E.D):
            pt = _mask_point(E, ch, l, d, log_ell, d_bits, j_bits)
            points_scales.append((pt, lp))
            claim = E.add_h(claim, E.mul_h(lp, values[l][d]))
            lp = E.mul_h(lp, lam)
    return points_scales, claim


def prove_masked_zerocheck(E, air, trace, publics, challenger, mask_pcs,
                           rng, spans=None):
    """trace: (n, w) int64 Montgomery tensor, n = 2^num_vars rows; the
    proof runs on its device. mask_pcs: a HidingWhirPcs sized by
    `_mask_layout`; rng: the numpy Generator of the masks and the hiding
    WHIR's draws; spans: a dict of stage seconds. Returns the
    MaskedZerocheckProof."""
    F = E.base
    n, w = trace.shape
    dev = trace.device
    mark = stage_timer(spans, dev)
    num_vars = n.bit_length() - 1
    n_cons, max_deg = get_ml_layout(air)
    deg_round = max_deg + 1
    ell = deg_round + 1
    log_ell, d_bits, j_bits, flat_len = _mask_layout(E, num_vars, ell)

    # 1. the masks and their hiding commitment
    masks = [[tuple(int(v) for v in F.rand_np(rng, (E.D,), monty=False))
              for _ in range(ell)] for _ in range(num_vars)]
    flat = _mask_flat(F, masks, E, log_ell, d_bits, j_bits, flat_len)
    mask_commit, mask_data = mask_pcs.commit_hiding_coeffs(
        torch.from_numpy(flat.astype(np.int64)).to(dev), rng)
    challenger.observe_digest(mask_commit)
    mark("masked: masks and their commit")

    # 2. mu, the mask's sum over the cube
    two_pow = pow(2, num_vars - 1, F.P)
    mu = E.zero_h()
    for coeffs in masks:
        s1 = E.zero_h()
        for c in coeffs:
            s1 = E.add_h(s1, c)
        mu = E.add_h(mu, E.base_mul_h(two_pow, E.add_h(coeffs[0], s1)))
    challenger.observe_ext(mu)
    eps = challenger.sample_ext(E.D)

    # 3. the sumcheck on eps·(eq·C) + M; the eq·C part on the device
    r = [challenger.sample_ext(E.D) for _ in range(num_vars)]
    alpha = challenger.sample_ext(E.D)
    alpha_pows = [E.one_h()]
    for _ in range(n_cons - 1):
        alpha_pows.append(E.mul_h(alpha_pows[-1], alpha))
    ap_m = torch.stack([E.const(a, dev) for a in reversed(alpha_pows)])
    T = torch.zeros((n, 2 * w + 3, E.D), dtype=torch.int64, device=dev)
    T[:, :w, 0] = trace
    T[:, w:2 * w, 0] = torch.roll(trace, -1, dims=0)
    sel_first, sel_last = selector_tables_device(E, num_vars, dev)
    T[:, 2 * w] = eq_table_device(E, r, dev)
    T[:, 2 * w + 1] = sel_first
    T[:, 2 * w + 2] = sel_last

    sums01 = [E.add_h(c[0], _eval_univariate(E, c, E.one_h()))
              for c in masks]  # s_l(0) + s_l(1)
    rounds, chs = [], []
    acc_masks = E.zero_h()  # A_j
    for rnd in range(num_vars):
        suffix = E.zero_h()
        for l in range(rnd + 1, num_vars):
            suffix = E.add_h(suffix, sums01[l])
        w_free = num_vars - rnd - 1  # the free variables after this one
        f = pull_ext(E, _zerocheck_round(E, air, T, ap_m, deg_round, w,
                                         tuple(publics)))
        evals_t = []
        for t, f_t in enumerate(f):
            s_t = _eval_univariate(E, masks[rnd], E.from_base_h(t))
            m_t = E.base_mul_h(pow(2, w_free, F.P), E.add_h(acc_masks, s_t))
            if w_free >= 1:
                m_t = E.add_h(m_t, E.base_mul_h(pow(2, w_free - 1, F.P),
                                                suffix))
            evals_t.append(E.add_h(E.mul_h(eps, f_t), m_t))
        rounds.append(evals_t)
        for y in evals_t:
            challenger.observe_ext(y)
        ch = challenger.sample_ext(E.D)
        chs.append(ch)
        T = _fold_cols(E, T, E.const(ch, dev))
        acc_masks = E.add_h(acc_masks, _eval_univariate(E, masks[rnd], ch))

    mark("masked: zerocheck rounds")
    final = pull_ext(E, T[0])
    final_local, final_next = final[:w], final[w:2 * w]
    for v in final_local + final_next:
        challenger.observe_ext(v)

    # 4. the batched mask opening at the bound points; the claimed values
    # are observed before lambda, so the combiner binds them
    mask_values = []
    for l in range(num_vars):
        comps = [_eval_univariate(E, [E.from_base_h(c[d]) for c in masks[l]],
                                  chs[l]) for d in range(E.D)]
        mask_values.append(comps)
        for v in comps:
            challenger.observe_ext(v)
    lam = challenger.sample_ext(E.D)
    points_scales, claim = _mask_statement(E, chs, mask_values, log_ell,
                                           d_bits, j_bits, lam)
    mask_opening = mask_pcs.open_hiding_multi(mask_data, points_scales,
                                              claim, challenger, rng)
    mark("masked: mask opening")
    return MaskedZerocheckProof(
        mask_commit=mask_commit, mu=mu, rounds=rounds,
        final_local=final_local, final_next=final_next,
        mask_values=mask_values, mask_opening=mask_opening)


def verify_masked_zerocheck(E, air, num_vars, publics,
                            proof: MaskedZerocheckProof, challenger,
                            mask_pcs):
    """Replays the transcript; returns the bound point once the wires, the
    mask opening and the final anchor check. Raises ValueError (or the
    hiding WHIR's WhirError) on failure."""
    n_cons, max_deg = get_ml_layout(air)
    deg_round = max_deg + 1
    ell = deg_round + 1
    log_ell, d_bits, j_bits, flat_len = _mask_layout(E, num_vars, ell)

    challenger.observe_digest(proof.mask_commit)
    challenger.observe_ext(proof.mu)
    eps = challenger.sample_ext(E.D)
    r = [challenger.sample_ext(E.D) for _ in range(num_vars)]
    alpha = challenger.sample_ext(E.D)

    if len(proof.rounds) != num_vars:
        raise ValueError("RoundCountMismatch")
    claim = proof.mu  # eps·0 + mu
    chs = []
    for rnd, evals_t in enumerate(proof.rounds):
        if len(evals_t) != deg_round + 1:
            raise ValueError("RoundPolyDegreeMismatch")
        if E.add_h(evals_t[0], evals_t[1]) != claim:
            raise ValueError(f"MaskedRoundMismatch round {rnd}")
        for y in evals_t:
            challenger.observe_ext(y)
        ch = challenger.sample_ext(E.D)
        chs.append(ch)
        claim = _lagrange_at(E, evals_t, ch)

    for v in list(proof.final_local) + list(proof.final_next):
        challenger.observe_ext(v)

    # the mask openings: the claimed values observed first, then the
    # combiner
    if len(proof.mask_values) != num_vars:
        raise ValueError("MaskValueCountMismatch")
    for comps in proof.mask_values:
        if len(comps) != E.D:
            raise ValueError("MaskValueShapeMismatch")
        for v in comps:
            challenger.observe_ext(v)
    lam = challenger.sample_ext(E.D)
    points_scales, open_claim = _mask_statement(
        E, chs, proof.mask_values, log_ell, d_bits, j_bits, lam)
    n1 = flat_len.bit_length() - 1
    mask_pcs.verify_hiding_multi(proof.mask_commit, n1, points_scales,
                                 open_claim, proof.mask_opening, challenger)

    # the final anchor: eps·eq(r, chs)·C(openings) + Σ_l s_l(chs_l) == claim
    eq_val = E.one_h()
    for ri, ci in zip(r, chs):
        eq_val = E.mul_h(eq_val, E.add_h(
            E.mul_h(ri, ci),
            E.mul_h(E.sub_h(E.one_h(), ri), E.sub_h(E.one_h(), ci))))
    backend = VerifierBackend(E, alpha)
    sel_first, sel_last, sel_trans = boundary_evals_at(E, chs)

    def entry(kind, j):
        if kind == "local":
            return proof.final_local[j]
        if kind == "next":
            return proof.final_next[j]
        if kind == "is_transition":
            return sel_trans
        if kind == "is_first_row":
            return sel_first
        return sel_last

    b = _make_builder(backend, air.width, air.num_public_values, entry,
                      lambda j: E.from_base_h(int(publics[j])))
    air.eval(b)
    mask_sum = E.zero_h()
    for comps in proof.mask_values:
        for d in range(E.D):
            basis = tuple(1 if i == d else 0 for i in range(E.D))
            mask_sum = E.add_h(mask_sum, E.mul_h(comps[d], basis))
    final = E.add_h(E.mul_h(eps, E.mul_h(eq_val, backend.acc)), mask_sum)
    if final != claim:
        raise ValueError("MaskedFinalEvaluationMismatch")
    return chs
