"""TwoAdicFriPcs: the univariate PCS over FRI (fri/src/two_adic_pcs.rs:50).

Port of `plonky3_tpu/fri/two_adic_pcs.py`.

commit (:300): per matrix, the coset LDE onto gK (shift GENERATOR/domain
shift) in bit-reversed row order, then one Merkle commitment over all of
them. The scaled interpolant coefficients are kept for the openings.

open (:412): for every (matrix, point z) the column values p_j(z) =
Σ_i a_i·(z/g)^i from the kept coefficients; observe them; sample alpha;
accumulate per height

    reduced[log_h][x] += alpha^offset · (Mred(z) - Mred(x)) / (z - x),
    Mred(x) = Σ_j alpha^j · M[x, j]

and run FRI on the reduced codewords, tallest first. Every sum here is an
exact modular sum of products reduced mod P.

verify (:683): observe every opened value, then `fri.verifier.verify_fri`
on the host.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..commit.domain import TwoAdicCoset
from ..ops.ntt import coset_lde_batch, dot_rows, powers_device
from ..utils.bits import bitrev_permute_axis0, log2_strict
from ..utils.timing import stage_timer
from .config import FriParameters
from .proof import BatchMultiOpening
from .prover import prove_fri
from .verifier import verify_fri

_MRED_CHUNK = 1 << 15  # rows per Mred step (bounds the temporaries)


def _ext_powers_device(E, z_m, log_n: int):
    """(2^log_n, D) table [1, z, z^2, ...] by doubling: p · z^L."""
    one = E.const(E.one_h(), z_m.device)
    if log_n == 0:
        return one[None, :]
    p = torch.stack([one, z_m], dim=0)
    for _ in range(1, log_n):
        p = torch.cat([p, E.mul(p, E.mul(p[-1:], z_m[None, :]))], dim=0)
    return p


def _eval_coeffs(E, coeffs, zpow):
    """p(z) = Σ_i a_i·(z/g)^i for every column: (w, D)."""
    return dot_rows(E.base, coeffs, zpow[:coeffs.shape[0]])


def _inv_denom_kernel(E, zc, xs):
    """1/(z - x) for every row x: (h, D)."""
    diff = E.sub(zc.expand(xs.shape[0], E.D), E.from_base(xs))
    return E.inv(diff)


def _mred(E, mat, ap):
    """Mred(x) = Σ_j alpha^j·M[x, j] for every row: (h, D)."""
    F = E.base
    out = []
    for r0 in range(0, mat.shape[0], _MRED_CHUNK):
        m = mat[r0:r0 + _MRED_CHUNK]
        out.append(torch.stack(
            [(m * ap[:, d] % F.P).sum(dim=1) for d in range(E.D)], dim=-1))
    return torch.cat(out, dim=0) % F.P * F.RINV % F.P


def _accum_kernel(E, acc, mred_z_m, mat_compressed, inv_denom, alpha_off_m):
    """acc + alpha_off · (Mred(z) - Mred(x)) / (z - x)."""
    diff = E.sub(mred_z_m.expand_as(mat_compressed), mat_compressed)
    return E.add(acc, E.mul(E.mul(diff, inv_denom), alpha_off_m))


@dataclass(frozen=True)
class TwoAdicFriPcs:
    F: object
    E: object
    fri: FriParameters
    mmcs: object  # base-field input commitments
    fri_mmcs: object  # extension commit-phase commitments

    # the committed LDE is kept in bit-reversed row order, so the quotient
    # domain's rows are its prefix (`get_evaluations_on_domain` 'bitrev')
    supports_bitrev_evals = True

    def natural_domain_for_degree(self, degree: int) -> TwoAdicCoset:
        return TwoAdicCoset(self.F, 1, log2_strict(degree))

    def log_max_lde_height(self) -> int:
        """The largest LDE: the field's two-adicity."""
        return self.F.TWO_ADICITY

    def commit(self, evaluations):
        """evaluations: an iterable of (TwoAdicCoset, (n, w) natural-order
        tensor); each is let go once its LDE is taken."""
        ldes, coeffs = zip(*[self._lde(domain, evals)
                             for domain, evals in evaluations])
        data = self.mmcs.commit(list(ldes))
        data.coeffs = list(coeffs)
        return data

    def _lde(self, domain, evals):
        """(the bit-reversed LDE over gK, the scaled coefficients)."""
        if evals.shape[0] != domain.size:
            raise ValueError("evaluations do not match their domain")
        shift = self.F.mul_h(self.F.GENERATOR, self.F.inv_h(domain.shift))
        return coset_lde_batch(self.F, evals, self.fri.log_blowup, shift,
                               with_coeffs=True)

    def get_evaluations_on_domain(self, data, mat_index: int,
                                  domain: TwoAdicCoset,
                                  order: str = "natural"):
        """Evaluations of a committed matrix over a sub-coset of its LDE
        coset with the same shift: a prefix of the bit-reversed rows
        ('bitrev'), permuted to natural order unless asked otherwise."""
        lde = data.matrices[mat_index]
        if domain.shift != self.F.GENERATOR:
            raise ValueError("the domain must share the shift gK")
        if domain.size > lde.shape[0]:
            raise ValueError(f"a domain of {domain.size} rows exceeds the "
                             f"committed LDE's {lde.shape[0]}: the "
                             f"quotient needs a larger blowup")
        prefix = lde[:domain.size]
        if order == "bitrev":
            return prefix
        return bitrev_permute_axis0(prefix, domain.log_n)

    def open(self, data_with_points, challenger, spans=None):
        """data_with_points: [(MerkleProverData, [[z per matrix]])].
        Returns (opened_values, FriProof); opened_values[round][mat][point]
        is the list of column values (ext tuples). spans: see
        stark.prover.prove."""
        F, E = self.F, self.E
        lb = self.fri.log_blowup
        mats = [m for data, _ in data_with_points for m in data.matrices]
        device = mats[0].device
        mark = stage_timer(spans, device)
        log_max = max(log2_strict(m.shape[0]) for m in mats)
        xs_br = bitrev_permute_axis0(
            powers_device(F, F.two_adic_generator_h(log_max), 1 << log_max,
                          device, scale_std=F.GENERATOR), log_max)

        max_h_for_point = {}
        for data, points in data_with_points:
            for mat, pts in zip(data.matrices, points):
                for z in pts:
                    max_h_for_point[z] = max(max_h_for_point.get(z, 0),
                                             mat.shape[0])

        # column values from the kept coefficients: p(z) = Σ a_i (z/g)^i
        g_inv = F.inv_h(F.GENERATOR)
        zpows = {
            z: _ext_powers_device(
                E, E.const(E.base_mul_h(g_inv, z), device),
                log2_strict(h) - lb)
            for z, h in max_h_for_point.items()
        }
        ys_dev = [_eval_coeffs(E, cf, zpows[z])
                  for data, points in data_with_points
                  for cf, pts in zip(data.coeffs, points) for z in pts]
        # one device-to-host transfer for all of them
        flat = torch.cat([y.reshape(-1) for y in ys_dev]).cpu().numpy()
        ends = np.cumsum([y.numel() for y in ys_dev])[:-1]
        ys_all = iter(part.reshape(-1, E.D)
                      for part in np.split(flat, ends))
        inv_denoms = {
            z: _inv_denom_kernel(E, E.const(z, device), xs_br[:h])
            for z, h in max_h_for_point.items()
        }

        opened_values = []
        for data, points in data_with_points:
            round_vals = []
            for _, pts in zip(data.matrices, points):
                mat_vals = []
                for _ in pts:
                    ys_np = F.from_monty_np(next(ys_all))
                    challenger.observe_base_array(ys_np)
                    mat_vals.append([tuple(r) for r in ys_np.tolist()])
                round_vals.append(mat_vals)
            opened_values.append(round_vals)
        mark("open: ys + observe")

        alpha = challenger.sample_ext(E.D)
        reduced, num_reduced = {}, {}
        for (data, points), round_vals in zip(data_with_points,
                                              opened_values):
            for mat, pts, mat_vals in zip(data.poly_matrices(), points,
                                          round_vals):
                h, w = mat.shape
                log_h = log2_strict(h)
                alpha_pows = E.powers_np(alpha, w)  # (w, D)
                mat_compressed = _mred(E, mat, torch.from_numpy(
                    alpha_pows.astype(np.int64)).to(device))
                for z, ys in zip(pts, mat_vals):
                    acc = reduced.get(log_h)
                    if acc is None:
                        acc = torch.zeros((h, E.D), dtype=torch.int64,
                                          device=device)
                    nr = num_reduced.get(log_h, 0)
                    # Mred(z) = Σ_j alpha^j·ys_j on the host
                    ys_m = F.to_monty_np(np.asarray(ys, dtype=np.uint32))
                    prods = E.mul_np(alpha_pows[:len(ys)], ys_m)
                    mred_z = F.from_monty_np(
                        prods.astype(np.uint64).sum(axis=0) % np.uint64(F.P))
                    reduced[log_h] = _accum_kernel(
                        E, acc, E.const(tuple(int(v) for v in mred_z),
                                        device),
                        mat_compressed, inv_denoms[z][:h],
                        E.const(E.exp_h(alpha, nr), device))
                    num_reduced[log_h] = nr + w
        fri_input = [reduced[lh] for lh in sorted(reduced, reverse=True)]
        mark("open: reduced accumulation")

        def open_input_fn(indices, batcher):
            futs = []
            for data, _ in data_with_points:
                log_batch_max = log2_strict(
                    max(m.shape[0] for m in data.matrices))
                bits_reduced = log_max - log_batch_max
                futs.append(batcher.add(
                    self.mmcs, data, [i >> bits_reduced for i in indices]))

            def finish():
                return [BatchMultiOpening(opened_values=f.value[0],
                                          opening_proof=f.value[1])
                        for f in futs]

            return finish

        fri_proof = prove_fri(E, self.fri, self.fri_mmcs, fri_input,
                              challenger, log_max, open_input_fn,
                              spans=spans)
        return opened_values, fri_proof

    def verify(self, commitments_with_opening_points, proof, challenger):
        """commitments_with_opening_points: [(commitment, [(TwoAdicCoset,
        [(z, ys)])])]. Raises FriError."""
        for _, mats in commitments_with_opening_points:
            for _, points_and_values in mats:
                for _, ys in points_and_values:
                    for y in ys:
                        challenger.observe_ext(y)
        verify_fri(self.E, self.fri, proof, challenger,
                   commitments_with_opening_points, self.mmcs,
                   self.fri_mmcs)
