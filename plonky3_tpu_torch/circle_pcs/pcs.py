"""CirclePcs: the univariate PCS of Mersenne-31 over the circle group.

Port of `plonky3_tpu/circle_pcs/pcs.py` (circle/src/pcs.rs:39, with
deep_quotient.rs and folding.rs):

  commit: natural-order evaluations -> cfft order -> interpolate ->
    evaluate on standard(log_n + log_blowup) -> one multi-matrix Merkle
    commitment over the cfft-order rows.
  open: per (matrix, zeta) the claimed values, by Lagrange weights over
    the height-2^log_sub prefix (pcs.rs:255-268); observe them; sample
    alpha; reduce every height's matrices into one DEEP quotient
    (accumulate_deep_quotient); extract lambda, the CFFT dimension-gap
    component (deep_quotient.rs:228); commit every (h/2, 2) first-layer
    matrix in one tree; sample the bivariate beta; fold in y; run FRI
    with the circle folding (fold in x, arity 2, one extra query index
    bit).
  verify: exact host arithmetic per query (the DEEP quotient's row, the
    lambda correction, the y-fold, then `verify_fri`'s x-fold chain).

The reference's jitted helpers are jnp, not Pallas: here they are plain
torch on canonical int64 tensors, with the same canonical values.
Everything of the LDE's size runs on the device; the query phase runs on
the host. The transforms go through the matrix in blocks of columns
(`ops/circle.py`), so the LDE is the one whole copy a commit makes.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..fields.mersenne31 import Mersenne31 as F
from ..fields.qm31 import QM31
from ..fri.config import FriParameters
from ..fri.proof import BatchMultiOpening, FriProof
from ..fri.prover import prove_fri
from ..fri.two_adic_pcs import _mred
from ..fri.verifier import FriError, verify_fri
from ..ops.circle import (
    CircleDomain,
    _col_block,
    _pow_np,
    cfft_evaluate,
    cfft_interpolate,
    cfft_perm_device,
    cfft_perm_indices,
    cfft_permute_index,
    ept_from_projective_line,
    ept_v_n,
    pt_add,
    pt_mul,
    pt_v_n,
)
from ..ops.ntt import dot_rows
from ..utils.bits import bitrev_indices, log2_strict, reverse_bits_len
from ..utils.timing import stage_timer

_P = F.P
_P64 = np.uint64(_P)
_INV2 = pow(2, _P - 2, _P)


def _t(arr, device):
    return torch.from_numpy(np.asarray(arr).astype(np.int64)).to(device)


# ---------------------------------------------------------------------------
# host tables, kept per height and device
# ---------------------------------------------------------------------------
_TABLES: dict = {}


def _kept(key, make):
    v = _TABLES.get(key)
    if v is None:
        v = _TABLES[key] = make()
    return v


def _domain_np(log_h: int):
    """The cfft-ordered points of standard(log_h): (px, py) uint64."""
    def make():
        xs, ys = CircleDomain.standard(log_h).points_natural_np()
        perm = cfft_perm_indices(log_h)
        return xs[perm], ys[perm]

    return _kept(("domain", log_h), make)


def _domain_data(log_h: int, device):
    """`_domain_np` as int64 tensors on `device`."""
    return _kept(("domain", log_h, str(device)), lambda: tuple(
        _t(a, device) for a in _domain_np(log_h)))


def _s_p_values(log_h: int, log_sub: int) -> np.ndarray:
    """s_p_at_p(log_sub) for the first 2^log_sub cfft points of
    standard(log_h): -(v_n_prod(log_sub)·2^(2·log_sub - 1))·y
    (point.rs:110), the Lagrange normalisation at the sub-domain's size
    (pcs.rs:295)."""
    def make():
        px, py = _domain_np(log_h)
        n = 1 << log_sub
        x = px[:n].copy()
        if log_sub >= 2:
            out = x.copy()
            for _ in range(log_sub - 2):
                x = (2 * x * x % _P64 + _P64 - 1) % _P64
                out = out * x % _P64
        else:
            out = np.ones_like(x)
        s_p = (_P64 - out * np.uint64(pow(2, 2 * log_sub - 1, _P))
               % _P64) % _P64
        return s_p * py[:n] % _P64

    return _kept(("s_p", log_h, log_sub), make)


def _v_d_array(log_h: int, log_blowup: int) -> np.ndarray:
    """The vanishing polynomial's values v_d(i) over cfft-ordered indices
    (deep_quotient.rs:236-250)."""
    def make():
        b = 1 << log_blowup
        xs, _ = CircleDomain.standard(log_h).points_natural_np()
        v_init = np.array([pt_v_n(int(x), log_h - log_blowup)
                           for x in xs[:b]], dtype=np.uint64)
        m = cfft_perm_indices(log_h) & (2 * b - 1)
        return v_init[np.where(m < b, m, 2 * b - 1 - m)]

    return _kept(("v_d", log_h, log_blowup), make)


def _y_twiddles_inv(log_h: int) -> np.ndarray:
    """Inverted bit-reversed y-coordinates of standard(log_h)'s coset0
    (cfft.rs:532)."""
    def make():
        _, ys = CircleDomain.standard(log_h).coset0_np()
        return _pow_np(ys[bitrev_indices(log_h - 1)], _P - 2)

    return _kept(("y_tw", log_h), make)


def _x_twiddles_inv(log_n_plus1: int) -> np.ndarray:
    """Inverted bit-reversed layer-0 x twiddles of standard(log_n_plus1)
    (cfft.rs:538, folding.rs fold_x)."""
    def make():
        xs, _ = CircleDomain.standard(log_n_plus1).coset0_np()
        xs = xs[:1 << (log_n_plus1 - 2)]
        return _pow_np(xs[bitrev_indices(log_n_plus1 - 2)], _P - 2)

    return _kept(("x_tw", log_n_plus1), make)


def _device_table(name, make_np, key, device):
    return _kept((name,) + key + (str(device),),
                 lambda: _t(make_np(*key), device))


# ---------------------------------------------------------------------------
# the reference's jitted helpers, as torch functions
# ---------------------------------------------------------------------------
def _lagrange_dens(E, px, py, s_p, zx, zy):
    """(ṽ_P(zeta)·s_p)^-1·(diff.x + 1) per cfft point (point.rs:128),
    diff = zeta - p: diff.x = zx·px + zy·py, diff.y = zy·px - zx·py."""
    dx = E.add(E.base_mul(px, zx), E.base_mul(py, zy))
    dy = E.sub(E.base_mul(px, zy), E.base_mul(py, zx))
    numer = E.add(dx, E.from_base(torch.ones_like(px)))
    return E.mul(numer, E.inv(E.mul(dy, E.from_base(s_p))))


def _vanishing_parts(E, px, py, zx, zy):
    """v_p(zeta) = (1 - diff.x, -diff.y) with diff = p - zeta (point.rs:119),
    and the inverse of its squared magnitude."""
    dx = E.add(E.base_mul(px, zx), E.base_mul(py, zy))
    dy = E.sub(E.base_mul(py, zx), E.base_mul(px, zy))
    re = E.sub(E.from_base(torch.ones_like(px)), dx)
    im = E.neg(dy)
    return re, im, E.inv(E.add(E.mul(re, re), E.mul(im, im)))


def _accumulate(E, ro, alpha_off, alpha_pw, vp, reduced_rows, c):
    """ro + alpha_off·(re - α^W·im)·denom_inv·(r - c)."""
    re, im, denom_inv = vp
    term = E.mul(E.mul(E.sub(re, E.mul(im, alpha_pw)), denom_inv),
                 E.sub(reduced_rows, c))
    return E.add(ro, E.mul(term, alpha_off))


def _extract_lambda(E, ro, v_d):
    """deep_quotient.rs:228: lambda = <ro, v_d> / 2^(log_h - 1);
    ro - lambda·v_d."""
    log_h = log2_strict(ro.shape[0])
    lam = torch.stack([(ro[:, d] * v_d % _P).sum() % _P
                       for d in range(E.D)])
    lam = lam * pow(1 << (log_h - 1), _P - 2, _P) % _P
    return E.sub(ro, E.base_mul(v_d, lam)), lam


def _fold(E, mat2, beta_m, inv_tw):
    """((lo + hi) + beta·(lo - hi)·t) / 2 row by row (folding.rs:54-85)."""
    lo, hi = mat2[:, 0], mat2[:, 1]
    d = E.mul(E.base_mul(inv_tw, E.sub(lo, hi)), beta_m)
    return E.add(E.add(lo, hi), d) * _INV2 % _P


class CircleFriFolding:
    """The circle group's FRI folding (folding.rs:28-52): arity 2, one
    extra query index bit, no arity schedule in the transcript
    (circle/src/prover.rs), the roll-in added unscaled (prover.rs:162,
    `*c += x`)."""

    extra_query_index_bits = 1
    observe_arity_schedule = False
    scale_roll_in = False

    def __init__(self, E):
        self.E = E

    def fold_matrix(self, folded, beta, log_arity):
        E = self.E
        if log_arity != 1:
            raise ValueError("circle FRI folds by 2 only")
        h = folded.shape[0]
        inv_tw = _device_table("x_tw", _x_twiddles_inv,
                               (log2_strict(h) + 1,), folded.device)
        return _fold(E, folded.reshape(h // 2, 2, E.D),
                     E.const(beta, folded.device), inv_tw)

    def fold_row(self, E, index, log_folded, log_arity, beta, group):
        """Verifier-side x-fold (folding.rs fold_x_row)."""
        if log_arity != 1:
            raise FriError("InvalidLogArity (circle folds by 2)")
        dom = CircleDomain.standard(log_folded + 2)
        k = reverse_bits_len(index, log_folded)
        t = pt_add(dom.shift, pt_mul(dom.subgroup_generator(), k))[0]
        e0, e1 = group
        d = E.mul_h(E.base_mul_h(pow(t, _P - 2, _P), E.sub_h(e0, e1)), beta)
        return E.base_mul_h(_INV2, E.add_h(E.add_h(e0, e1), d))


@dataclass
class CircleInputProof:
    input_openings: list  # [BatchMultiOpening] per input commitment
    first_layer_siblings: list  # [query][height ascending] ext tuples
    first_layer_proofs: list  # pruned: a flat list of digests


@dataclass
class CirclePcsProof:
    first_layer_commitment: tuple
    lambdas: list  # ext tuples, ascending log height
    fri_proof: FriProof


@dataclass(frozen=True)
class CirclePcs:
    fri: FriParameters
    mmcs: object  # base-field input commitments
    fri_mmcs: object  # ExtensionMmcs: the first layer and the FRI rounds
    ext: object = QM31  # the challenge field (QM31, or M31Ext3)

    @property
    def F(self):
        return F

    @property
    def E(self):
        return self.ext

    def natural_domain_for_degree(self, degree: int) -> CircleDomain:
        return CircleDomain.standard(log2_strict(degree))

    def log_max_lde_height(self) -> int:
        return 30  # CIRCLE_TWO_ADICITY - 1 (pcs.rs:139)

    def _lde(self, domain, evals):
        """The cfft-order LDE of natural-order `evals` onto
        standard(log_n + log_blowup), by blocks of columns."""
        n, w = evals.shape
        if n != domain.size:
            raise ValueError("evaluations do not match their domain")
        if domain.log_n < 2:
            raise ValueError("the circle PCS needs at least 4 rows")
        big = CircleDomain.standard(domain.log_n + self.fri.log_blowup)
        perm = cfft_perm_device(domain.log_n, evals.device)
        out = torch.empty((big.size, w), dtype=torch.int64,
                          device=evals.device)
        step = _col_block(big.size)
        for c in range(0, w, step):
            coeffs = cfft_interpolate(
                domain, evals[:, c:c + step].index_select(0, perm))
            out[:, c:c + step] = cfft_evaluate(big, coeffs)
            del coeffs
        return out

    def commit(self, evaluations):
        """evaluations: [(CircleDomain, (n, w) natural-order tensor)]
        (pcs.rs:142-163)."""
        domains, ldes = [], []
        for domain, evals in evaluations:
            ldes.append(self._lde(domain, evals))
            domains.append(domain)
        data = self.mmcs.commit(ldes)
        data.domains = domains
        return data

    def get_evaluations_on_domain(self, data, mat_index: int, domain):
        """Natural-order evaluations of a committed matrix over `domain`
        (pcs.rs:191-220): interpolate the LDE's prefix over its
        sub-domain and evaluate on `domain`, by blocks of columns."""
        mat = data.matrices[mat_index]
        log_lde = log2_strict(mat.shape[0])
        log_sub = log_lde - self.fri.log_blowup
        sub = CircleDomain(log_sub, CircleDomain.standard(log_lde).shift)
        perm = cfft_perm_device(domain.log_n, mat.device)
        w = mat.shape[1]
        out = torch.empty((domain.size, w), dtype=torch.int64,
                          device=mat.device)
        step = _col_block(domain.size)
        for c in range(0, w, step):
            coeffs = cfft_interpolate(sub, mat[:1 << log_sub, c:c + step])
            out[:, c:c + step] = cfft_evaluate(domain, coeffs).index_select(
                0, perm)
            del coeffs
        return out

    # ------------------------------------------------------------------
    def open(self, data_with_points, challenger, spans=None):
        """data_with_points: [(data, [[zeta per matrix]])], each zeta a
        projective-line extension tuple. Returns (opened_values,
        CirclePcsProof)."""
        E = self.ext
        lb = self.fri.log_blowup
        device = data_with_points[0][0].matrices[0].device
        mark = stage_timer(spans, device)

        def ext_t(v):
            return E.const(v, device)

        # the claimed values: Lagrange weights over the sub prefix
        dens, opened_values = {}, []
        for data, points in data_with_points:
            round_vals = []
            for mat, pts in zip(data.matrices, points):
                log_h = log2_strict(mat.shape[0])
                log_sub = log_h - lb
                sub_h = 1 << log_sub
                px, py = _domain_data(log_h, device)
                sub_shift = CircleDomain.standard(log_h).shift
                mat_vals = []
                for zeta_uni in pts:
                    zeta = ept_from_projective_line(E, zeta_uni)
                    key = (log_h, zeta_uni)
                    if key not in dens:
                        dens[key] = _lagrange_dens(
                            E, px[:sub_h], py[:sub_h],
                            _device_table("s_p", _s_p_values,
                                          (log_h, log_sub), device),
                            ext_t(zeta[0]), ext_t(zeta[1]))
                    num = E.sub_h(ept_v_n(E, zeta[0], log_sub),
                                  E.from_base_h(pt_v_n(sub_shift[0],
                                                       log_sub)))
                    ys = E.mul(dot_rows(F, mat[:sub_h], dens[key]),
                               ext_t(num)).cpu().numpy()
                    challenger.observe_base_array(ys)
                    mat_vals.append([tuple(int(c) for c in r) for r in ys])
                round_vals.append(mat_vals)
            opened_values.append(round_vals)
        mark("open: ys + observe")

        alpha = challenger.sample_ext(E.D)

        # the DEEP quotient of each height (pcs.rs:330-440)
        reduced, vparts = {}, {}
        for (data, points), round_vals in zip(data_with_points,
                                              opened_values):
            for mat, pts, mat_vals in zip(data.matrices, points, round_vals):
                h, w = mat.shape
                log_h = log2_strict(h)
                off, ro = reduced.setdefault(log_h, (E.one_h(), torch.zeros(
                    (h, E.D), dtype=torch.int64, device=device)))
                reduced_rows = _mred(E, mat, _t(E.powers_np(alpha, w),
                                                device))
                alpha_pw = E.exp_h(alpha, w)
                for zeta_uni, ys in zip(pts, mat_vals):
                    key = (log_h, zeta_uni)
                    if key not in vparts:
                        zeta = ept_from_projective_line(E, zeta_uni)
                        px, py = _domain_data(log_h, device)
                        vparts[key] = _vanishing_parts(
                            E, px, py, ext_t(zeta[0]), ext_t(zeta[1]))
                    c, ap = E.zero_h(), E.one_h()
                    for y in ys:
                        c = E.add_h(c, E.mul_h(ap, y))
                        ap = E.mul_h(ap, alpha)
                    ro = _accumulate(E, ro, ext_t(off), ext_t(alpha_pw),
                                     vparts[key], reduced_rows, ext_t(c))
                    off = E.mul_h(off, E.mul_h(alpha_pw, alpha_pw))
                reduced[log_h] = (off, ro)
                del reduced_rows
        del vparts
        mark("open: reduced accumulation")

        # lambda extraction and the first layer (pcs.rs:443-480)
        lambdas, log_heights, fl_mats = [], [], []
        for log_h in sorted(reduced):
            ro, lam = _extract_lambda(E, reduced[log_h][1], _device_table(
                "v_d", _v_d_array, (log_h, lb), device))
            lambdas.append(tuple(int(x) for x in lam.cpu().numpy()))
            log_heights.append(log_h)
            fl_mats.append(ro.reshape(1 << (log_h - 1), 2, E.D))
        log_max = max(log_heights)
        fl_data = self.fri_mmcs.commit_ext_matrices(fl_mats)
        challenger.observe_digest(fl_data.commitment)
        beta_m = ext_t(challenger.sample_ext(E.D))
        fri_input = [
            _fold(E, m, beta_m, _device_table("y_tw", _y_twiddles_inv,
                                               (log_h,), device))
            for log_h, m in sorted(zip(log_heights, fl_mats),
                                   key=lambda t: -t[0])]
        mark("open: first layer")

        def open_input_fn(indices, batcher):
            futs = []
            for data, _ in data_with_points:
                log_batch_max = max(log2_strict(m.shape[0])
                                    for m in data.matrices)
                # the indices carry log_max bits (one extra)
                bits_reduced = log_max - log_batch_max
                futs.append(batcher.add(self.mmcs, data,
                                        [i >> bits_reduced for i in indices]))
            fl_fut = batcher.add(self.fri_mmcs, fl_data,
                                 [i >> 1 for i in indices])

            def finish():
                ext_pq, fl_proofs = fl_fut.value
                fl_sibs = []
                for index, ext_rows in zip(indices, ext_pq):
                    # a row a matrix, ascending height; the sibling is the
                    # other member of the pair
                    fl_sibs.append([
                        row[((index >> (log_max - log_h)) & 1) ^ 1]
                        for log_h, row in zip(log_heights, ext_rows)])
                return CircleInputProof(
                    input_openings=[
                        BatchMultiOpening(opened_values=f.value[0],
                                          opening_proof=f.value[1])
                        for f in futs],
                    first_layer_siblings=fl_sibs,
                    first_layer_proofs=fl_proofs)

            return finish

        fri_proof = prove_fri(E, self.fri, self.fri_mmcs, fri_input,
                              challenger, log_max - 1, open_input_fn,
                              spans=spans, folding=CircleFriFolding(E))
        return opened_values, CirclePcsProof(
            first_layer_commitment=fl_data.commitment, lambdas=lambdas,
            fri_proof=fri_proof)

    # ------------------------------------------------------------------
    def verify(self, commitments_with_opening_points, proof, challenger):
        """[(root, [(CircleDomain, [(zeta_uni, ys)])])] (pcs.rs:550).
        Raises FriError."""
        E = self.ext
        lb = self.fri.log_blowup
        for _, mats in commitments_with_opening_points:
            for _, pv in mats:
                for _, ys in pv:
                    for y in ys:
                        challenger.observe_ext(y)
        alpha = challenger.sample_ext(E.D)
        challenger.observe_digest(proof.first_layer_commitment)
        bivariate_beta = challenger.sample_ext(E.D)

        log_heights = sorted({dom.log_n + lb
                              for _, mats in commitments_with_opening_points
                              for dom, _ in mats})
        log_max = max(log_heights)
        if len(proof.lambdas) != len(log_heights):
            raise FriError("LambdaCountMismatch")
        fri_proof = proof.fri_proof
        log_global = (sum(s.log_arity for s in fri_proof.commit_phase_steps)
                      + lb + self.fri.log_final_poly_len)
        if log_global != log_max - 1:
            raise FriError("GlobalMaxHeightMismatch")

        def open_inputs_fn(indices):
            return self._reduced_openings(
                commitments_with_opening_points, fri_proof.input_openings,
                proof.lambdas, indices, alpha, bivariate_beta, log_heights,
                proof.first_layer_commitment)

        verify_fri(E, self.fri, fri_proof, challenger, None, self.mmcs,
                   self.fri_mmcs, folding=CircleFriFolding(E),
                   open_inputs_fn=open_inputs_fn, alpha=alpha,
                   check_global_height=False)

    def _reduced_openings(self, commitments_with_opening_points, ip, lambdas,
                          indices, alpha, bivariate_beta, log_heights,
                          fl_commitment):
        """Authenticate the input openings and the first layer, and give
        each query's y-folded reduced openings [(log_h - 1, ext)],
        tallest first. The sums over a matrix's columns are numpy sums of
        products reduced mod P, over every query at once: exactly the
        reference's per-element host arithmetic."""
        E = self.ext
        lb = self.fri.log_blowup
        log_max = max(log_heights)
        Q = len(indices)
        if not isinstance(ip, CircleInputProof):
            raise FriError("InputProofShapeMismatch")
        if len(ip.first_layer_siblings) != Q:
            raise FriError("FirstLayerSiblingCountMismatch")
        if len(ip.input_openings) != len(commitments_with_opening_points):
            raise FriError("InputProofBatchCountMismatch")

        for opening, (commit, mats) in zip(ip.input_openings,
                                           commitments_with_opening_points):
            heights = [dom.size << lb for dom, _ in mats]
            dims = []
            for h, (_, pv) in zip(heights, mats):
                if not pv:
                    raise FriError("MatrixWithoutOpeningPoints")
                dims.append((h, len(pv[0][1])))
            bits_reduced = log_max - log2_strict(max(heights))
            if not self.mmcs.verify_multi_batch(
                    commit, dims, [i >> bits_reduced for i in indices],
                    opening.opened_values, opening.opening_proof):
                raise FriError("InputMmcsError")

        # ros[log_h][q]: each query's reduced opening; offs[log_h]: the
        # alpha offset, which advances the same way for every query
        ros, offs = {}, {}
        for opening, (_, mats) in zip(ip.input_openings,
                                      commitments_with_opening_points):
            for m, (dom, pv) in enumerate(mats):
                log_h = dom.log_n + lb
                bits_reduced = log_max - log_h
                w = len(opening.opened_values[0][m])
                rows = np.array([opening.opened_values[q][m]
                                 for q in range(Q)], dtype=np.uint64)
                alpha_pows = E.powers_np(alpha, w).astype(np.uint64)
                # Σ_j alpha^j·p_j(x) for every query: (Q, D)
                mred_x = [tuple(int(v) for v in r) for r in np.stack(
                    [(rows * alpha_pows[None, :, d] % _P64).sum(axis=1)
                     % _P64 for d in range(E.D)], axis=-1)]
                xs = []
                for index in indices:
                    orig = cfft_permute_index(index >> bits_reduced, log_h)
                    xs.append(CircleDomain.standard(log_h).nth_point(orig))
                alpha_pw = E.exp_h(alpha, w)
                acc = ros.setdefault(log_h, [E.zero_h()] * Q)
                off = offs.get(log_h, E.one_h())
                for zeta_uni, ps_at_zeta in pv:
                    if len(ps_at_zeta) != w:
                        raise FriError("InputShapeError")
                    zeta = ept_from_projective_line(E, zeta_uni)
                    # Σ_j alpha^j·p_j(zeta), the same for every query
                    mred_z, ap = E.zero_h(), E.one_h()
                    for pz in ps_at_zeta:
                        mred_z = E.add_h(mred_z, E.mul_h(ap, pz))
                        ap = E.mul_h(ap, alpha)
                    for q, x in enumerate(xs):
                        # v_p(zeta) at x: diff = x - zeta
                        dx = E.add_h(E.base_mul_h(x[0], zeta[0]),
                                     E.base_mul_h(x[1], zeta[1]))
                        dy = E.sub_h(E.base_mul_h(x[1], zeta[0]),
                                     E.base_mul_h(x[0], zeta[1]))
                        re = E.sub_h(E.one_h(), dx)
                        im = E.neg_h(dy)
                        denom = E.add_h(E.mul_h(re, re), E.mul_h(im, im))
                        if denom == E.zero_h():
                            raise FriError("OpeningPointMatchesQueryPoint")
                        vp_num = E.sub_h(re, E.mul_h(alpha_pw, im))
                        q_row = E.mul_h(E.mul_h(vp_num, E.inv_h(denom)),
                                        E.sub_h(mred_x[q], mred_z))
                        acc[q] = E.add_h(acc[q], E.mul_h(off, q_row))
                    off = E.mul_h(off, E.mul_h(alpha_pw, alpha_pw))
                offs[log_h] = off

        # the lambda correction and the y-fold of each height
        all_inputs, fl_rows = [], []
        for q, index in enumerate(indices):
            sibs = ip.first_layer_siblings[q]
            if len(sibs) != len(log_heights):
                raise FriError("FirstLayerSiblingCountMismatch")
            fri_input, row_values = [], []
            for log_h, lam, fl_sib in zip(log_heights, lambdas, sibs):
                if log_h not in ros:
                    raise FriError("MissingReducedOpening")
                bits_reduced = log_max - log_h
                b = (index >> bits_reduced) & 1
                orig = cfft_permute_index(index >> bits_reduced, log_h)
                p = CircleDomain.standard(log_h).nth_point(orig)
                corrected = E.sub_h(ros[log_h][q], E.base_mul_h(
                    pt_v_n(p[0], log_h - lb), lam))
                values = [corrected, corrected]
                values[b ^ 1] = tuple(fl_sib)
                y_tw = p[1] if b == 0 else (_P - p[1]) % _P
                e0, e1 = values
                d = E.mul_h(E.base_mul_h(pow(y_tw, _P - 2, _P),
                                         E.sub_h(e0, e1)), bivariate_beta)
                fri_input.append((log_h - 1, E.base_mul_h(
                    _INV2, E.add_h(E.add_h(e0, e1), d))))
                row_values.append([c for v in values for c in v])
            fri_input.sort(key=lambda t: -t[0])
            all_inputs.append(fri_input)
            fl_rows.append(row_values)
        # every query's first-layer pair rows at once
        if not self.fri_mmcs.inner.verify_multi_batch(
                fl_commitment,
                [(1 << (log_h - 1), 2 * E.D) for log_h in log_heights],
                [i >> 1 for i in indices], fl_rows, ip.first_layer_proofs):
            raise FriError("FirstLayerMmcsError")
        return all_inputs
