"""TwoAdicStirPcs: the univariate PCS over STIR (stir/src/pcs.rs).

Port of `plonky3_tpu/stir/pcs.py`.

Commit: the coset LDE of each matrix onto gK in bit-reversed row order
(K1/K2 on a CUDA tensor), reshaped into fiber-grouped form (each
committed row holds the 2^log_folding_factor LDE rows one first-round
STIR query reads; a pure reshape, pcs.rs:90-98) and committed with the
base-field MMCS. The scaled interpolant coefficients are kept.

Open: the column values p_j(z) from the kept coefficients (the
reference evaluates them barycentrically over the LDE; the values are
the same), then the alpha-batched reduced openings per LDE height, and
per height bucket STIR on the reduced opening as an EXTERNAL codeword
(never re-committed: the input commitments, the claimed values and
alpha pin it), and the input matrices opened at STIR's first-round
query fibers (pcs.rs:291-470). Every table as large as an LDE stays on
its device.

Verify (host): replay the alpha batching from the claimed values; each
bucket's initial fibers are rebuilt from the input MMCS openings inside
a closure handed to verify_stir_with_external_initial (pcs.rs:476-735).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..commit.domain import TwoAdicCoset
from ..fri.two_adic_pcs import (
    _eval_coeffs,
    _ext_powers_device,
    _inv_denom_kernel,
    _mred,
)
from ..ops.ntt import coset_lde_batch, powers_device
from ..utils.bits import bitrev_permute_axis0, log2_strict, reverse_bits_len
from ..utils.timing import stage_timer
from .config import StirConfig, StirParameters
from .prover import prove_stir_from_external_codeword
from .verifier import (
    InvalidProofShape,
    StirError,
    verify_stir_with_external_initial,
)


@dataclass
class StirProverData:
    """Committed fiber-grouped LDEs and the ungrouped views (pcs.rs:76)."""

    data: object  # MerkleProverData over the grouped matrices
    ldes: list  # ungrouped bit-reversed (h, w) LDE tensors
    domains: list
    root_std: tuple = None
    coeffs: list = None  # scaled interpolant coefficients per matrix

    @property
    def matrices(self):
        return self.ldes


@dataclass
class BucketProof:
    stir_proof: object
    input_openings: list  # per commitment: (rows_pq, pruned) or None


def _accum_stir_kernel(E, acc, mred_z_m, mat_compressed, inv_denom,
                       alpha_off_m):
    """acc + alpha_off · (Mred(x) - Mred(z)) / (z - x): the reference
    STIR orientation (pcs.rs:395: (p_x - y_combined) * inv_denom)."""
    diff = E.sub(mat_compressed, mred_z_m.expand_as(mat_compressed))
    return E.add(acc, E.mul(E.mul(diff, inv_denom), alpha_off_m))


@dataclass(frozen=True)
class TwoAdicStirPcs:
    F: object
    E: object
    params: StirParameters
    mmcs: object  # base-field MerkleTreeMmcs (input commitments)
    stir_mmcs: object  # ExtensionMmcs (STIR round commitments)

    ZK = False

    def natural_domain_for_degree(self, degree: int) -> TwoAdicCoset:
        return TwoAdicCoset(self.F, 1, log2_strict(degree))

    def _stir_config(self, log_h):
        log_deg = max(log_h - self.params.log_blowup, 1)
        return StirConfig.new(self.F, self.E, self.stir_mmcs, log_deg,
                              self.params)

    def commit(self, evaluations):
        """evaluations: (TwoAdicCoset, (n, w) natural-order Montgomery
        tensor) pairs."""
        F = self.F
        arity = 1 << self.params.log_folding_factor
        ldes, coeffs, grouped, domains = [], [], [], []
        for domain, evals in evaluations:
            if evals.shape[0] != domain.size:
                raise ValueError("evaluations do not match their domain")
            if evals.shape[0] < arity:
                raise ValueError("STIR PCS: matrix height below "
                                 "2^log_folding_factor")
            shift = F.mul_h(F.GENERATOR, F.inv_h(domain.shift))
            lde, cf = coset_lde_batch(F, evals, self.params.log_blowup,
                                      shift, with_coeffs=True)
            h, w = lde.shape
            ldes.append(lde)
            coeffs.append(cf)
            grouped.append(lde.reshape(h // arity, w * arity))
            domains.append(domain)
        data = self.mmcs.commit(grouped)
        return StirProverData(data=data, ldes=ldes, domains=domains,
                              root_std=data.root_std, coeffs=coeffs)

    def get_evaluations_on_domain(self, pd, mat_index, domain):
        lde = pd.ldes[mat_index]
        if domain.shift != self.F.GENERATOR:
            raise ValueError("the domain must share the shift gK")
        return bitrev_permute_axis0(lde[:domain.size], domain.log_n)

    # ------------------------------------------------------------------
    def open(self, data_with_points, challenger, spans=None):
        """data_with_points: [(StirProverData, [[z per matrix]])]. Returns
        (opened_values, [BucketProof], tallest bucket first). spans: a
        dict of stage seconds, as `stark.prover.prove` takes."""
        F, E = self.F, self.E
        lff = self.params.log_folding_factor
        lb = self.params.log_blowup
        mats = [m for pd, _ in data_with_points for m in pd.ldes]
        device = mats[0].device
        mark = stage_timer(spans, device)
        log_gmax = max(log2_strict(m.shape[0]) for m in mats)
        xs_br = bitrev_permute_axis0(
            powers_device(F, F.two_adic_generator_h(log_gmax), 1 << log_gmax,
                          device, scale_std=F.GENERATOR), log_gmax)

        max_h_for_point = {}
        for pd, points in data_with_points:
            for mat, pts in zip(pd.ldes, points):
                for z in pts:
                    max_h_for_point[z] = max(max_h_for_point.get(z, 0),
                                             mat.shape[0])

        # column values from the kept coefficients: p(z) = Σ a_i (z/g)^i
        g_inv = F.inv_h(F.GENERATOR)
        zpows = {z: _ext_powers_device(E, E.const(E.base_mul_h(g_inv, z),
                                                  device),
                                       log2_strict(h) - lb)
                 for z, h in max_h_for_point.items()}
        ys_dev = [_eval_coeffs(E, cf, zpows[z])
                  for pd, points in data_with_points
                  for cf, pts in zip(pd.coeffs, points) for z in pts]
        flat = torch.cat([y.reshape(-1) for y in ys_dev]).cpu().numpy()
        ends = np.cumsum([y.numel() for y in ys_dev])[:-1]
        ys_all = iter(part.reshape(-1, E.D) for part in np.split(flat, ends))
        inv_denoms = {z: _inv_denom_kernel(E, E.const(z, device), xs_br[:h])
                      for z, h in max_h_for_point.items()}

        opened_values = []
        for pd, points in data_with_points:
            round_vals = []
            for _, pts in zip(pd.ldes, points):
                mat_vals = []
                for _ in pts:
                    ys_np = F.from_monty_np(next(ys_all))
                    challenger.observe_base_array(ys_np)
                    mat_vals.append([tuple(r) for r in ys_np.tolist()])
                round_vals.append(mat_vals)
            opened_values.append(round_vals)
        mark("open: ys + observe")

        alpha = challenger.sample_ext(E.D)

        # the alpha-batched reduced openings per height bucket
        reduced, num_reduced = {}, {}
        for (pd, points), round_vals in zip(data_with_points, opened_values):
            for mat, pts, mat_vals in zip(pd.ldes, points, round_vals):
                h, w = mat.shape
                log_h = log2_strict(h)
                alpha_pows = E.powers_np(alpha, w)
                mat_compressed = _mred(E, mat, torch.from_numpy(
                    alpha_pows.astype(np.int64)).to(device))
                for z, ys in zip(pts, mat_vals):
                    acc = reduced.get(log_h)
                    if acc is None:
                        acc = torch.zeros((h, E.D), dtype=torch.int64,
                                          device=device)
                    nr = num_reduced.get(log_h, 0)
                    mred_z = E.zero_h()
                    ap = E.one_h()
                    for y in ys:
                        mred_z = E.add_h(mred_z, E.mul_h(ap, y))
                        ap = E.mul_h(ap, alpha)
                    reduced[log_h] = _accum_stir_kernel(
                        E, acc, E.const(mred_z, device), mat_compressed,
                        inv_denoms[z][:h],
                        E.const(E.exp_h(alpha, nr), device))
                    num_reduced[log_h] = nr + w
        mark("open: reduced accumulation")

        # per height bucket (descending): STIR, then the input binding
        bucket_proofs = []
        for log_h in sorted(reduced, reverse=True):
            ro_natural = bitrev_permute_axis0(reduced[log_h], log_h)
            stir_proof, first_js = prove_stir_from_external_codeword(
                self._stir_config(log_h), ro_natural, challenger, spans)
            mark("open: stir (total)")

            input_openings = []
            for pd, _ in data_with_points:
                heights = [m.shape[0] for m in pd.ldes]
                if (1 << log_h) not in heights:
                    input_openings.append(None)
                    continue
                log_commit_max = log2_strict(max(heights))
                q_globals = [reverse_bits_len(j, log_h - lff)
                             << (log_commit_max - log_h) for j in first_js]
                input_openings.append(
                    self.mmcs.open_multi_batch(pd.data, q_globals))
            bucket_proofs.append(BucketProof(stir_proof=stir_proof,
                                             input_openings=input_openings))
            mark("open: input openings")
        return opened_values, bucket_proofs

    # ------------------------------------------------------------------
    def verify(self, commitments_with_opening_points, proof, challenger):
        """commitments_with_opening_points: [(root, [(TwoAdicCoset,
        [(z, ys)])])]. Raises StirError."""
        F, E = self.F, self.E
        lff = self.params.log_folding_factor
        arity = 1 << lff
        lb = self.params.log_blowup

        for _, mats in commitments_with_opening_points:
            for _, points_and_values in mats:
                for _, ys in points_and_values:
                    for y in ys:
                        challenger.observe_ext(y)
        alpha = challenger.sample_ext(E.D)

        bucket_log_heights = sorted(
            {domain.log_n + lb
             for _, mats in commitments_with_opening_points
             for domain, _ in mats},
            reverse=True)
        if len(proof) != len(bucket_log_heights):
            raise InvalidProofShape()

        # alpha_pow_offset per (commit, mat, point), in the prover's order
        height_num_reduced = {}
        alpha_offsets = []
        for _, mats in commitments_with_opening_points:
            per_commit = []
            for domain, point_claims in mats:
                log_h = domain.log_n + lb
                per_mat = []
                for _, vals in point_claims:
                    nr = height_num_reduced.get(log_h, 0)
                    per_mat.append(E.exp_h(alpha, nr))
                    height_num_reduced[log_h] = nr + len(vals)
                per_commit.append(per_mat)
            alpha_offsets.append(per_commit)

        for bucket_idx, log_h in enumerate(bucket_log_heights):
            bp = proof[bucket_idx]
            if len(bp.input_openings) != len(commitments_with_opening_points):
                raise InvalidProofShape()
            cfg = self._stir_config(log_h)
            domain_gen = F.two_adic_generator_h(log_h)
            fiber_step = F.exp_h(domain_gen, 1 << (log_h - lff))

            def reconstruct(query_indices, _log_h=log_h, _bp=bp,
                            _gen=domain_gen, _step=fiber_step):
                unique_js = sorted(set(query_indices))
                expected = [[E.zero_h() for _ in range(arity)]
                            for _ in unique_js]
                for commit_idx, ((root, mats), opening) in enumerate(
                        zip(commitments_with_opening_points,
                            _bp.input_openings)):
                    lde_heights = [1 << (domain.log_n + lb)
                                   for domain, _ in mats]
                    has = (1 << _log_h) in lde_heights
                    if opening is None:
                        if has:
                            raise InvalidProofShape()
                        continue
                    if not has:
                        raise InvalidProofShape()
                    rows_pq, pruned = opening
                    log_commit_max = log2_strict(max(lde_heights))
                    mat_widths = [len(mats[i][1][0][1]) if mats[i][1] else 0
                                  for i in range(len(mats))]
                    dims = [(h >> lff, w * arity)
                            for h, w in zip(lde_heights, mat_widths)]
                    q_globals = [reverse_bits_len(j, _log_h - lff)
                                 << (log_commit_max - _log_h)
                                 for j in unique_js]
                    if len(rows_pq) != len(q_globals):
                        raise InvalidProofShape()
                    if not self.mmcs.verify_multi_batch(
                            root, dims, q_globals, rows_pq, list(pruned)):
                        raise StirError("input opening rejected")
                    for q_idx, j in enumerate(unique_js):
                        row_by_mat = rows_pq[q_idx]
                        fiber_point = F.mul_h(F.GENERATOR, F.exp_h(_gen, j))
                        for l in range(arity):
                            slot = reverse_bits_len(l, lff)
                            for mat_idx, (domain, point_claims) in (
                                    enumerate(mats)):
                                if lde_heights[mat_idx] != (1 << _log_h):
                                    continue
                                w = mat_widths[mat_idx]
                                row = row_by_mat[mat_idx][slot * w:
                                                          (slot + 1) * w]
                                p_x = E.zero_h()
                                ap = E.one_h()
                                for v in row:
                                    p_x = E.add_h(p_x,
                                                  E.base_mul_h(int(v), ap))
                                    ap = E.mul_h(ap, alpha)
                                for point_idx, (z, vals) in enumerate(
                                        point_claims):
                                    off = alpha_offsets[commit_idx][
                                        mat_idx][point_idx]
                                    y_comb = E.zero_h()
                                    ap2 = E.one_h()
                                    for y in vals:
                                        y_comb = E.add_h(y_comb,
                                                         E.mul_h(y, ap2))
                                        ap2 = E.mul_h(ap2, alpha)
                                    inv_d = E.inv_h(E.sub_h(
                                        z, E.from_base_h(fiber_point)))
                                    expected[q_idx][l] = E.add_h(
                                        expected[q_idx][l],
                                        E.mul_h(E.mul_h(
                                            off, E.sub_h(p_x, y_comb)),
                                            inv_d))
                            fiber_point = F.mul_h(fiber_point, _step)
                # back to the draw order (duplicates share the fiber)
                by_j = dict(zip(unique_js, expected))
                return [list(by_j[j]) for j in query_indices]

            verify_stir_with_external_initial(cfg, bp.stir_proof, challenger,
                                              reconstruct)
