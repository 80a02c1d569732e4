"""TrivialPcs, the test PCS (commit/src/testing.rs:18).

Port of `plonky3_tpu/commit/trivial_pcs.py`. The "commitment" is the
polynomial itself: the coefficients in the clear, observed into the
transcript. An opening is the coefficients' evaluation, which the
verifier recomputes exactly. It isolates the STARK layers from FRI in
tests, as the reference's does.

As in the reference, its prover data has no `commitment`, so the
uni-stark `prove` cannot take it: it raises the reference's
AttributeError (ROADMAP §3).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..commit.domain import TwoAdicCoset
from ..fri.verifier import FriError
from ..ops.ntt import coset_lde_batch, idft, powers_device
from ..utils.bits import log2_strict


@dataclass
class TrivialProverData:
    domains: list
    mats: list  # the committed natural-order evaluations (tensors)
    coeffs_std: list  # [matrix] -> (n, w) numpy standard coefficients
    root_std: tuple  # the flat coefficient list stands in for a digest


def _eval_columns(E, coeffs, z):
    """Each column's polynomial at the ext point z: [ext tuple]."""
    n, w = coeffs.shape
    zp, acc = [], E.one_h()
    for _ in range(n):
        zp.append(acc)
        acc = E.mul_h(acc, z)
    out = []
    for j in range(w):
        y = E.zero_h()
        for i in range(n):
            y = E.add_h(y, E.base_mul_h(int(coeffs[i, j]), zp[i]))
        out.append(y)
    return out


@dataclass(frozen=True)
class TrivialPcs:
    F: object
    E: object
    fri: object  # FriParameters (log_blowup sizes the domains only)

    def natural_domain_for_degree(self, degree: int) -> TwoAdicCoset:
        return TwoAdicCoset(self.F, 1, log2_strict(degree))

    def commit(self, evaluations):
        """evaluations: [(TwoAdicCoset, (n, w) natural-order Montgomery
        tensor)] -> their coefficients over each domain, in the clear."""
        F = self.F
        domains, mats, coeffs, flat = [], [], [], []
        for domain, evals in evaluations:
            if evals.shape[0] != domain.size:
                raise ValueError("evaluations do not match their domain")
            c = idft(F, evals)
            if domain.shift != 1:
                # coefficient i over shift·H carries shift^-i
                sp = powers_device(F, F.inv_h(domain.shift), domain.size,
                                   evals.device)
                c = F.mul(c, sp[:, None])
            c_std = F.from_monty_np(c.cpu().numpy().astype(np.uint32))
            domains.append(domain)
            mats.append(evals)
            coeffs.append(c_std)
            flat.extend(int(x) for x in c_std.reshape(-1))
        return TrivialProverData(domains=domains, mats=mats,
                                 coeffs_std=coeffs, root_std=tuple(flat))

    def get_evaluations_on_domain(self, data, idx, domain):
        """Matrix idx over `domain` (natural order), by a coset LDE from
        its own domain."""
        F = self.F
        src = data.domains[idx]
        return coset_lde_batch(F, data.mats[idx], domain.log_n - src.log_n,
                               F.mul_h(domain.shift, F.inv_h(src.shift)),
                               out_order="natural")

    def open(self, data_with_points, challenger, spans=None):
        """Every matrix at its points, each value observed; no opening
        proof."""
        opened = []
        for data, points in data_with_points:
            round_vals = []
            for c_std, pts in zip(data.coeffs_std, points):
                mat_vals = []
                for z in pts:
                    ys = _eval_columns(self.E, c_std, z)
                    for y in ys:
                        challenger.observe_ext(y)
                    mat_vals.append(ys)
                round_vals.append(mat_vals)
            opened.append(round_vals)
        return opened, None

    def verify(self, commitments_with_opening_points, proof, challenger):
        """Recompute every claimed value from the coefficients in the
        clear (the commitment). Raises FriError."""
        for root, mats in commitments_with_opening_points:
            shapes = [(dom.size, len(pv[0][1])) for dom, pv in mats]
            if len(root) != sum(n * w for n, w in shapes):
                raise FriError("TrivialPcs: commitment size mismatch")
            off = 0
            for (dom, pv), (n, w) in zip(mats, shapes):
                c = np.array(root[off:off + n * w],
                             dtype=np.uint64).reshape(n, w)
                off += n * w
                for z, ys in pv:
                    for y in ys:
                        challenger.observe_ext(y)
                    if _eval_columns(self.E, c, z) != [tuple(y) for y in ys]:
                        raise FriError("TrivialPcs: evaluation mismatch")
