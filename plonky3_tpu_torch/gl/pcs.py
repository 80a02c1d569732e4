"""The Goldilocks TwoAdicFriPcs: LDE, commit and open on int64 tensors.

Port of `plonky3_tpu/gl/pcs.py` (fri/src/two_adic_pcs.rs; see
`fri/two_adic_pcs.py` for the algebra). commit: the coset LDE of each
matrix (bit-reversed rows, `gl/ntt.py`) and one Poseidon2-GL Merkle tree
over them; the scaled coefficients are kept. open: every column's value
at each point, p(z) = Σ_i a_i·(z/g)^i from the coefficients; observe
them; sample alpha; per height accumulate

    reduced[log_h][x] += alpha^offset·(Mred(z) - Mred(x)) / (z - x),
    Mred(x) = Σ_j alpha^j·M[x, j];

then FRI over GL2 = GL[X]/(X^2 - 7) (`fri/prover.py::prove_fri` with
`GLFriFolding`). Every sum is an exact sum mod P (`sum_mod`), taken over
blocks of columns or rows so that no temporary spans a whole LDE.

verify: observe the opened values, sample alpha, and run
`fri/verifier.py::verify_fri` with the Goldilocks reduction of the input
openings (`_gl_open_inputs`: exact numpy products, where the generic
reduction's uint64 products hold for 31-bit fields only).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..commit.domain import TwoAdicCoset
from ..fields import goldilocks_device as gd
from ..fields.goldilocks import Goldilocks
from ..fri.config import FriParameters
from ..fri.proof import BatchMultiOpening
from ..fri.prover import prove_fri
from ..fri.verifier import FriError, verify_fri
from ..merkle.extension_mmcs import ExtensionMmcs
from ..utils.bits import bitrev_permute_axis0, log2_strict, reverse_bits_len
from ..utils.timing import stage_timer
from .field import (
    GLE,
    GLF,
    ext_base_mul,
    ext_inv,
    ext_mul,
    halve,
    powers_device,
    to_numpy,
)
from .ntt import gl_coset_lde_batch, gl_idft

# the int64 elements of one block of a product-and-sum (its temporaries
# are some ten times this)
_BLOCK_ELEMS = 1 << 25


# ---------------------------------------------------------------------------
# host helpers (the verifier)
# ---------------------------------------------------------------------------
def _gl_dot_np(rows64, w64):
    """Σ_j rows[., j]·w[j] mod P, exact."""
    prod = Goldilocks.mul_np(rows64, w64[None, :])
    acc = prod[:, 0]
    for j in range(1, prod.shape[1]):
        acc = Goldilocks.add_np(acc, prod[:, j])
    return acc


# ---------------------------------------------------------------------------
# device helpers (the prover)
# ---------------------------------------------------------------------------
def _ext_powers(z, log_n: int, device):
    """(2^log_n, 2) table [1, z, z^2, ...] of a host extension point z,
    by doubling."""
    p = GLE.const(GLE.one_h(), device)[None, :]
    zk = GLE.const(z, device)
    for _ in range(log_n):
        p = torch.cat([p, ext_mul(p, zk)], dim=0)
        zk = ext_mul(zk, zk)
    return p


def _col_dots(mat, zp):
    """Σ_i mat[i, j]·zp[i] for every column j: (w, 2). mat (n, w), zp
    (n, 2)."""
    n, w = mat.shape
    step = max(1, _BLOCK_ELEMS // n)
    out = []
    for c in range(0, w, step):
        blk = mat[:, c:c + step]
        out.append(torch.stack([gd.sum_mod(gd.mul(blk, zp[:, d, None]), 0)
                                for d in range(2)], dim=-1))
    return torch.cat(out, dim=0)


def _row_dots(mat, ap):
    """Mred(x) = Σ_j ap[j]·mat[x, j] for every row x: (h, 2)."""
    h, w = mat.shape
    step = max(1, _BLOCK_ELEMS // max(w, 1))
    out = []
    for r in range(0, h, step):
        blk = mat[r:r + step]
        out.append(torch.stack([gd.sum_mod(gd.mul(blk, ap[None, :, d]), 1)
                                for d in range(2)], dim=-1))
    return torch.cat(out, dim=0)


def _xs_bitrev(log_h: int, device):
    """GENERATOR·g^rev(i), i < 2^log_h: the LDE's points in its row
    order."""
    return bitrev_permute_axis0(
        powers_device(Goldilocks.two_adic_generator_h(log_h), 1 << log_h,
                      device, scale=GLF.GENERATOR), log_h)


# ---------------------------------------------------------------------------
# FRI folding over GL2
# ---------------------------------------------------------------------------
class GLFriFolding:
    """Arity-2^k folds of bit-reversed (h, 2) GL2 codewords (fri/prover.py
    TwoAdicFriFolding): new[i] = (lo + hi)/2 + (lo - hi)·beta·hip[i],
    hip = bitrev(g^-i / 2)."""

    extra_query_index_bits = 0
    observe_arity_schedule = True
    scale_roll_in = True

    def fold_matrix(self, folded, beta, log_arity):
        b = beta
        for _ in range(log_arity):
            folded = self._fold_step(folded, b)
            b = GLE.mul_h(b, b)
        return folded

    @staticmethod
    def _fold_step(folded, beta):
        h = folded.shape[0] // 2
        log_h = log2_strict(h)
        m = folded.reshape(h, 2, 2)
        lo, hi = m[:, 0], m[:, 1]
        g_inv = Goldilocks.inv_h(Goldilocks.two_adic_generator_h(log_h + 1))
        hip = bitrev_permute_axis0(powers_device(
            g_inv, h, folded.device, scale=Goldilocks.inv_h(2)), log_h)
        even = halve(gd.add(lo, hi))
        odd = ext_mul(gd.sub(lo, hi), GLE.const(beta, folded.device))
        return gd.add(even, ext_base_mul(hip, odd))

    @staticmethod
    def idft_final(final_evals):
        """(L, 2) evaluations -> coefficients, each coordinate apart."""
        return gl_idft(final_evals)


# ---------------------------------------------------------------------------
# the PCS
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class GlTwoAdicFriPcs:
    fri: FriParameters
    mmcs: object  # GLMerkleTreeMmcs
    fri_mmcs: ExtensionMmcs  # ExtensionMmcs(inner=the GL mmcs, D=2)
    F: object = GLF
    E: object = GLE

    supports_bitrev_evals = True

    def natural_domain_for_degree(self, degree: int) -> TwoAdicCoset:
        return TwoAdicCoset(GLF, 1, log2_strict(degree))

    def log_max_lde_height(self) -> int:
        return GLF.TWO_ADICITY

    def commit(self, evaluations):
        """evaluations: [(TwoAdicCoset, (n, w) natural-order int64)]."""
        ldes, coeffs = [], []
        for domain, evals in evaluations:
            if evals.shape[0] != domain.size:
                raise ValueError("evaluations do not match their domain")
            shift = Goldilocks.mul_h(GLF.GENERATOR,
                                     Goldilocks.inv_h(domain.shift))
            lde, cf = gl_coset_lde_batch(evals, self.fri.log_blowup, shift,
                                         with_coeffs=True)
            ldes.append(lde)
            coeffs.append(cf)
        data = self.mmcs.commit(ldes)
        data.coeffs = coeffs
        return data

    def get_evaluations_on_domain(self, data, mat_index: int,
                                  domain: TwoAdicCoset,
                                  order: str = "natural"):
        """A prefix of the bit-reversed LDE rows ('bitrev'), in natural
        order unless asked otherwise."""
        lde = data.matrices[mat_index]
        if domain.size > lde.shape[0]:
            raise ValueError(f"a domain of {domain.size} rows exceeds the "
                             f"committed LDE's {lde.shape[0]}")
        prefix = lde[:domain.size]
        if order == "bitrev":
            return prefix
        return bitrev_permute_axis0(prefix, domain.log_n)

    def open(self, data_with_points, challenger, spans=None):
        """data_with_points: [(prover data, [[z per matrix]])]. Returns
        (opened_values, FriProof)."""
        mats = [m for data, _ in data_with_points for m in data.matrices]
        device = mats[0].device
        mark = stage_timer(spans, device)
        log_max = max(log2_strict(m.shape[0]) for m in mats)

        # column values from the kept coefficients: p(z) = Σ a_i (z/g)^i
        g_inv = Goldilocks.inv_h(GLF.GENERATOR)
        zpows, ys_dev = {}, []
        for data, points in data_with_points:
            for cf, pts in zip(data.coeffs, points):
                log_n = log2_strict(cf.shape[0])
                for z in pts:
                    key = (z, log_n)
                    if key not in zpows:
                        zpows[key] = _ext_powers(GLE.base_mul_h(g_inv, z),
                                                 log_n, device)
                    ys_dev.append(_col_dots(cf, zpows[key]))
        flat = to_numpy(torch.cat([y.reshape(-1) for y in ys_dev]))
        ends = np.cumsum([y.numel() for y in ys_dev])[:-1]
        ys_all = iter(part.reshape(-1, 2) for part in np.split(flat, ends))
        opened_values = []
        for data, points in data_with_points:
            round_vals = []
            for _, pts in zip(data.matrices, points):
                mat_vals = []
                for _ in pts:
                    ys = [tuple(int(c) for c in row) for row in next(ys_all)]
                    for y in ys:
                        challenger.observe_ext(y)
                    mat_vals.append(ys)
                round_vals.append(mat_vals)
            opened_values.append(round_vals)
        mark("open: ys + observe")

        alpha = challenger.sample_ext(2)
        inv_denoms, reduced, num_reduced = {}, {}, {}
        for (data, points), round_vals in zip(data_with_points,
                                              opened_values):
            for mat, pts, mat_vals in zip(data.matrices, points,
                                          round_vals):
                h, w = mat.shape
                log_h = log2_strict(h)
                ap_host = GLE.powers_np(alpha, w)
                mred_x = _row_dots(mat, torch.from_numpy(
                    ap_host.view(np.int64)).to(device))
                for z, ys in zip(pts, mat_vals):
                    key = (z, log_h)
                    if key not in inv_denoms:
                        xs = _xs_bitrev(log_h, device)
                        inv_denoms[key] = ext_inv(gd.sub(
                            GLE.const(z, device), GLE.from_base(xs)))
                    acc = reduced.get(log_h)
                    if acc is None:
                        acc = torch.zeros((h, 2), dtype=torch.int64,
                                          device=device)
                    nr = num_reduced.get(log_h, 0)
                    mred_z = GLE.zero_h()  # Σ_j alpha^j·ys_j, host-exact
                    for j, y in enumerate(ys):
                        mred_z = GLE.add_h(mred_z, GLE.mul_h(
                            tuple(int(v) for v in ap_host[j]), y))
                    quot = ext_mul(gd.sub(GLE.const(mred_z, device),
                                          mred_x), inv_denoms[key])
                    reduced[log_h] = gd.add(acc, ext_mul(
                        quot, GLE.const(GLE.exp_h(alpha, nr), device)))
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

        fri_proof = prove_fri(GLE, self.fri, self.fri_mmcs, fri_input,
                              challenger, log_max, open_input_fn,
                              spans=spans, folding=GLFriFolding())
        return opened_values, fri_proof

    def verify(self, commitments_with_opening_points, proof, challenger):
        """Raises FriError."""
        cwop = commitments_with_opening_points
        for _, mats in cwop:
            for _, points_and_values in mats:
                for _, ys in points_and_values:
                    for y in ys:
                        challenger.observe_ext(y)
        # alpha here, where verify_fri would sample it: the same transcript
        # position, and the reduction below needs it
        alpha = challenger.sample_ext(2)
        log_gmh = max(dom.log_n + self.fri.log_blowup
                      for _, mats in cwop for dom, _ in mats)
        verify_fri(GLE, self.fri, proof, challenger, cwop, self.mmcs,
                   self.fri_mmcs, alpha=alpha,
                   open_inputs_fn=lambda indices: _gl_open_inputs(
                       self.fri, log_gmh, indices, proof.input_openings,
                       alpha, self.mmcs, cwop))


def _gl_open_inputs(params, log_global_max_height, indices, input_openings,
                    alpha, input_mmcs, cwop):
    """`fri/verifier.py::_open_inputs` for Goldilocks: authenticate the
    input openings, then per query [(log_height, Σ alpha^k·(p_k(z) -
    p_k(x)) / (z - x))], tallest first, with exact products."""
    E, G = GLE, Goldilocks
    Q = len(indices)
    if len(input_openings) != len(cwop):
        raise FriError("InputProofBatchCountMismatch")

    for batch, (opening, (commit, mats)) in enumerate(
            zip(input_openings, cwop)):
        if len(opening.opened_values) != Q:
            raise FriError(f"InputOpeningsQueryCountMismatch batch {batch}")
        for q in range(Q):
            if len(opening.opened_values[q]) != len(mats):
                raise FriError(
                    f"BatchOpenedValuesCountMismatch batch {batch}")
        heights = [dom.size << params.log_blowup for (dom, _) in mats]
        dims = []
        for m, (dom, points_and_values) in enumerate(mats):
            if not points_and_values:
                raise FriError(f"MatrixWithoutOpeningPoints {batch},{m}")
            dims.append((heights[m], len(points_and_values[0][1])))
        bits_reduced = log_global_max_height - max(heights).bit_length() + 1
        if not input_mmcs.verify_multi_batch(
                commit, dims, [index >> bits_reduced for index in indices],
                opening.opened_values, opening.opening_proof):
            raise FriError(f"InputError batch {batch}")

    max_k = sum(len(pv) * len(pv[0][1]) for _, mats in cwop
                for _, pv in mats)
    alpha_pows = [E.one_h()]
    for _ in range(max(max_k, 1) - 1):
        alpha_pows.append(E.mul_h(alpha_pows[-1], alpha))

    accs = [dict() for _ in range(Q)]
    offsets = {}
    for opening, (_, mats) in zip(input_openings, cwop):
        for m, (dom, points_and_values) in enumerate(mats):
            log_height = dom.log_n + params.log_blowup
            bits_reduced = log_global_max_height - log_height
            w = len(points_and_values[0][1])
            rows = np.array([opening.opened_values[q][m] for q in range(Q)],
                            dtype=np.uint64)
            if rows.shape[1] < w:
                raise FriError("PointEvaluationCountMismatch")
            rows = rows[:, :w]
            g = G.two_adic_generator_h(log_height)
            xs = [G.mul_h(GLF.GENERATOR, G.exp_h(g, reverse_bits_len(
                index >> bits_reduced, log_height))) for index in indices]
            k0 = offsets.setdefault(log_height, 0)
            ap = np.array(alpha_pows[k0:k0 + w], dtype=np.uint64)
            mred0 = list(zip(*(_gl_dot_np(rows, ap[:, d]).tolist()
                               for d in range(2))))
            for p_i, (z, ps_at_z) in enumerate(points_and_values):
                if len(ps_at_z) != w:
                    raise FriError("PointEvaluationCountMismatch")
                scale = E.exp_h(alpha, p_i * w)
                c_z = E.zero_h()
                for j, pz in enumerate(ps_at_z):
                    c_z = E.add_h(c_z, E.mul_h(alpha_pows[k0 + j], pz))
                c_z = E.mul_h(scale, c_z)
                for q in range(Q):
                    denom = E.sub_h(z, E.from_base_h(xs[q]))
                    if denom == E.zero_h():
                        raise FriError("OpeningPointMatchesQueryPoint")
                    quot = E.mul_h(E.sub_h(c_z, E.mul_h(scale, mred0[q])),
                                   E.inv_h(denom))
                    accs[q][log_height] = E.add_h(
                        accs[q].get(log_height, E.zero_h()), quot)
            offsets[log_height] = k0 + len(points_and_values) * w

    out = []
    for acc in accs:
        if acc.get(params.log_blowup, E.zero_h()) != E.zero_h():
            raise FriError("FinalPolyMismatch (height-1 quotient nonzero)")
        out.append(sorted(acc.items(), key=lambda t: -t[0]))
    return out


def gl_pcs(fri: FriParameters, mmcs) -> GlTwoAdicFriPcs:
    """The PCS over `mmcs` with its extension tree for FRI's rounds."""
    return GlTwoAdicFriPcs(fri=fri, mmcs=mmcs,
                           fri_mmcs=ExtensionMmcs(inner=mmcs, D=2))
