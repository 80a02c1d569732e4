"""HidingFriPcs: the zero-knowledge wrapper around TwoAdicFriPcs.

Port of `plonky3_tpu/fri/hiding_pcs.py` (fri/src/hiding_pcs.rs:30,
110-136). `commit` interleaves every matrix with random rows (doubling
its height to match the caller's doubled domain) and appends
`num_random_codewords` random columns; `open` returns the random
codewords' openings apart from the others (the reference's "first
item"). With the hiding MMCS (salted leaves), the masked quotient
(`commit_quotient`) and the random polynomial R that blinds the FRI batch
(`get_opt_randomization_poly_commitment`), this is the reference's whole
zero-knowledge scheme.

Randomness comes from the caller's numpy Generator, drawn as the
reference draws it: one `rng.integers(0, P, shape, uint64)` call of the
reference's shape for each matrix, in its order, so the same seed gives
the same proof. The draws are moved to the device and put in Montgomery
form there.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..merkle.hiding_mmcs import draw_std, draw_words, monty_words
from ..ops.ntt import coset_evals_from_coeffs, coset_lde_batch, powers_std_np
from .two_adic_pcs import TwoAdicFriPcs


@dataclass(frozen=True)
class HidingFriPcs:
    inner: TwoAdicFriPcs
    num_random_codewords: int
    rng: np.random.Generator = field(
        default_factory=lambda: np.random.default_rng())

    ZK = True
    # the quotient folds straight from the committed bit-reversed rows
    # (`get_evaluations_on_domain` 'bitrev'), with no natural-order copy:
    # 22 GB for KeccakAir's ZK trace at 2^17 rows and a blowup of 4. The
    # reference's HidingFriPcs does not set the flag; the bits are the same
    supports_bitrev_evals = True

    @property
    def F(self):
        return self.inner.F

    @property
    def E(self):
        return self.inner.E

    @property
    def fri(self):
        return self.inner.fri

    @property
    def mmcs(self):
        return self.inner.mmcs

    def log_max_lde_height(self) -> int:
        return self.inner.log_max_lde_height()

    def natural_domain_for_degree(self, degree: int):
        return self.inner.natural_domain_for_degree(degree)

    def commit(self, evaluations, mark=None):
        """[(domain, (h, w) tensor)] with domain.size == 2·h: random rows
        interleaved, random columns appended (hiding_pcs.rs:114-133): the
        (h, 2w + 2·nrc) rows [mat | random] read as (2h, w + nrc). mark:
        the caller's `stage_timer` mark, which closes a span after the
        host's draw and after the device's conversion."""
        data = self.inner.commit(self._randomized(
            evaluations, mark or (lambda name: None)))
        data.zk_randomized = True
        return data

    def _randomized(self, evaluations, mark):
        """The randomized matrices, one at a time (each is let go once the
        inner PCS has its LDE)."""
        nrc = self.num_random_codewords
        for domain, mat in evaluations:
            h, w = mat.shape
            if domain.size != 2 * h:
                raise ValueError("a ZK commit needs the doubled domain")
            x = draw_std(self.F, self.rng, (h, w + 2 * nrc))
            mark("zk: random rows, host draw")
            wide = torch.cat([mat, monty_words(self.F, x, mat.device)],
                             dim=1)
            del x
            mark("zk: random rows, to_monty and interleave")
            yield domain, wide.reshape(2 * h, w + nrc)

    def commit_preprocessing(self, evaluations):
        """Zero rows in place of random ones (hiding_pcs.rs:138-153)."""
        padded = []
        for domain, mat in evaluations:
            h, w = mat.shape
            wide = torch.cat([mat, torch.zeros_like(mat)], dim=1)
            padded.append((domain, wide.reshape(2 * h, w)))
        return self.inner.commit(padded)

    def get_evaluations_on_domain(self, data, mat_index: int, domain,
                                  order: str = "natural"):
        """The inner evaluations (natural or 'bitrev' order, as the inner
        PCS's) less their last `num_random_codewords` columns
        (HorizontallyTruncated in the reference). The reference cuts the
        trailing columns, which under the hiding MMCS are salts: the
        random codeword columns and the other salts stay, after the
        polynomial's columns."""
        full = self.inner.get_evaluations_on_domain(data, mat_index, domain,
                                                    order=order)
        if self.num_random_codewords:
            return full[:, :full.shape[1] - self.num_random_codewords]
        return full

    def get_opt_randomization_poly_commitment(self, ext_domain, device):
        """D random base-field polynomials over the doubled domain, the
        FRI batch's blinding R (prover.rs:259-274): (commitment, data)."""
        vals = draw_words(self.F, self.rng, (ext_domain.size, self.E.D),
                          device)
        data = self.inner.commit([(ext_domain, vals)])
        return data.commitment, data

    def open(self, data_with_points, challenger, spans=None):
        """((random codeword openings, opened values), FriProof):
        random_codeword_openings[round][mat][point] holds the trailing
        `num_random_codewords` values of a randomized round's columns,
        [] elsewhere."""
        opened, proof = self.inner.open(data_with_points, challenger,
                                        spans=spans)
        nrc = self.num_random_codewords
        rand_out, real_out = [], []
        for rnd, (data, _) in zip(opened, data_with_points):
            split = nrc and data.zk_randomized
            rand_out.append([[ys[len(ys) - nrc:] if split else []
                              for ys in mat_vals] for mat_vals in rnd])
            real_out.append([[ys[:len(ys) - nrc] if split else ys
                              for ys in mat_vals] for mat_vals in rnd])
        return (rand_out, real_out), proof

    def verify(self, commitments_with_opening_points, rand_openings, proof,
               challenger):
        """The claimed rows with their random codewords put back, through
        the inner verification. Raises FriError."""
        full = []
        for (commit, mats), rand_round in zip(
                commitments_with_opening_points, rand_openings):
            full.append((commit, [
                (dom, [(z, list(ys) + list(rand_ys))
                       for (z, ys), rand_ys in zip(pv, rand_mat)])
                for (dom, pv), rand_mat in zip(mats, rand_round)]))
        return self.inner.verify(full, proof, challenger)

    def commit_quotient(self, quotient_domain, q_flat, num_chunks: int):
        """The masked quotient commitment (hiding_pcs.rs get_quotient_ldes
        :173, eprint 2024/1037 §4.2): each chunk's LDE at blowup + 1 plus
        v_{H_i}(X)·t_i(X), the t_i random but the last, chosen so that
        Σ_i cis_i·t_i = 0, cis_i = 1/Π_{j≠i} Z_j(first_i): the recomposed
        quotient at zeta does not change. The mask's coefficients are
        -g^i·t[i] and p·g^i·t[i] at rows i and h + i (g the generator,
        p = shift^h), one vectorised pass over the powers g^i. The kept
        coefficients (the chunk's and the mask's) give the openings."""
        F = self.F
        if num_chunks < 2:
            raise ValueError("a hiding quotient needs more than one chunk")
        P = np.uint64(F.P)
        sub_evals = quotient_domain.split_evals(num_chunks, q_flat)
        sub_domains = quotient_domain.split_domains(num_chunks)
        h, w = sub_evals[0].shape
        lb = self.fri.log_blowup + 1  # the ZK quotient doubles the blowup
        device = q_flat.device

        dens = []
        for i, dom in enumerate(sub_domains):
            acc = 1
            for j, other in enumerate(sub_domains):
                if j != i:
                    acc = F.mul_h(acc, other.vanishing_poly_at_point_h(
                        dom.first_point()))
            dens.append(acc)
        cis = [F.inv_h(d) for d in dens]
        mul_coeffs = [F.mul_h(c, F.inv_h(cis[-1])) for c in cis[:-1]]
        rvs = [draw_std(F, self.rng, (h, w)) for _ in range(num_chunks - 1)]
        last = np.zeros((h, w), dtype=np.uint64)
        for t, mc in zip(rvs, mul_coeffs):
            last = (last + np.uint64(F.P - mc) * t) % P
        rvs.append(last)

        g_pows = powers_std_np(F, F.GENERATOR, h).astype(np.uint64)[:, None]
        ldes, coeffs = [], []
        for dom, evals, rv in zip(sub_domains, sub_evals, rvs):
            shift = F.mul_h(F.GENERATOR, F.inv_h(dom.shift))
            lde, cf = coset_lde_batch(F, evals, lb, shift, with_coeffs=True)
            row = g_pows * rv % P
            mask_std = np.zeros((h << lb, w), dtype=np.uint64)
            mask_std[:h] = (P - row) % P
            mask_std[h:2 * h] = np.uint64(F.exp_h(shift, h)) * row % P
            mask = monty_words(F, mask_std, device)
            # the mask's coefficients scaled already: a plain subgroup DFT
            ldes.append(F.add(lde, coset_evals_from_coeffs(F, mask, 0, 1)))
            kept = mask[:2 * h].clone()
            kept[:h] = F.add(kept[:h], cf)
            coeffs.append(kept)
        data = self.mmcs.commit(ldes)
        data.coeffs = coeffs
        return data
