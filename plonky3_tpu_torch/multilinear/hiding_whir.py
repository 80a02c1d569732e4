"""HVZK WHIR: the hiding multilinear PCS (whir/src/pcs/zk/mod.rs).

Port of `plonky3_tpu/multilinear/hiding_whir.py`, the HVZK-WHIR
composition of eprint 2026/391:

  commit : the zero-knowledge Reed–Solomon encoding of the witness. The
           MLE coefficient vector grows by one variable whose set branch
           holds `t` uniformly random coefficients (the `zk_codes.py`
           layout [g || r_t || 0] over a doubled cube), so any `t`
           codeword positions reveal nothing about g. The extended MLE at
           (point, 0) kills every random coefficient (their top index bit
           is 1) and is g(point).
  open   : the one-time code switch (whir/src/pcs/zk/code_switch.rs,
           Construction 9.7): commit a fully random mask polynomial M over
           the extended cube, reveal v_m = M(point, 0), sample rho, and run
           the plain WHIR rounds on h = G + rho·M with the claim
           value + rho·v_m. Round 0's queries open both commitments (at
           most t positions of G's codeword) and the verifier recombines
           g + rho·m itself.

The verifier's view is (com_G, com_M, v_m, rho, the WHIR transcript of
h); h is uniform given the one-time mask.

Every table as large as the polynomial (the extended coefficients, the
mask, h) is an (N, D) int64 Montgomery tensor on the device of the
committed evaluations, and both codewords go through K1/K2 on a CUDA
tensor; the reference builds them as host tuples. The random draws are
the reference's `F.rand_np` calls in its order, so the proofs are the
same bits.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops.ntt import coset_evals_from_coeffs
from ..utils.bits import log2_strict
from ..utils.timing import stage_timer
from .device_kernels import coeffs_to_evals_device, pull_ext
from .whir import WhirPcs, evals_to_coeffs
from .zk_codes import ReedSolomonZkEncoding


@dataclass
class _PairedTrees:
    """The round-0 oracle of the code-switched WHIR run."""

    tree_g: object
    tree_m: object
    rho: tuple


@dataclass
class _PairedCommit:
    commit_g: tuple
    commit_m: tuple
    rho: tuple


@dataclass
class HidingWhirData:
    coeffs_zk: object  # (2^{n+1},) int64 Montgomery base coefficients
    tree: object
    n_vars: int  # of the witness g (the committed object has n_vars + 1)


@dataclass
class HidingWhirProof:
    mask_commit: tuple
    v_mask: tuple
    inner: object  # the WhirProof over h = G + rho·M


def eval_coeffs_at(E, cd, points):
    """The multilinear with (N, D) Montgomery coefficients `cd` at each
    host point (point[0] binds the coefficient index's low bit): host
    tuples, one a point, from one batched fold."""
    if not points:
        return []
    pts = torch.stack([torch.stack([E.const(p, cd.device) for p in pt])
                       for pt in points])  # (C, n, D)
    x = cd[None]
    for i in range(pts.shape[1]):
        v = x.reshape(x.shape[0], -1, 2, E.D)
        x = E.add(v[:, :, 0], E.mul(v[:, :, 1], pts[:, i, None, :]))
    if x.shape[1] != 1:
        raise ValueError("the point's length does not match the table")
    return pull_ext(E, x[:, 0])


class HidingWhirPcs(WhirPcs):
    """The hiding wrapper; `config` applies to the extended (n+1)-variable
    polynomial: config.num_rounds(n_vars + 1) must be integral."""

    ZK = True

    def commit_hiding_coeffs(self, coeffs_std, rng, t: int = None):
        """Commit a multilinear given its coefficient vector (an integer
        tensor, standard form; the masked sumcheck's mask oracle stores
        each round's univariate mask coefficients, whose evaluations at
        power points are MLE evaluations)."""
        # the inverse Möbius transform is linear: standard form in, out
        evals = coeffs_to_evals_device(self.E, self.E.from_base(
            coeffs_std.to(torch.int64)))[:, 0]
        return self.commit_hiding(evals, rng, t=t)

    def _mask(self, rng, n1: int, device):
        """The one-time mask: D draws of 2^n1 standard-form words (the
        reference's calls, in its order) as an (N, D) Montgomery tensor."""
        F, E = self.F, self.E
        m_std = np.stack([F.rand_np(rng, (1 << n1,), monty=False)
                          for _ in range(E.D)], axis=1)
        return torch.from_numpy(F.to_monty_np(m_std).astype(np.int64)).to(
            device)

    def _commit_mask(self, m):
        """The mask's ext codeword over the coset (bit-reversed rows) and
        its tree."""
        F, cfg = self.F, self.config
        cw = coset_evals_from_coeffs(F, m, cfg.log_blowup, F.GENERATOR)
        tree = self.fri_mmcs.commit_ext_matrices(
            [cw.reshape(-1, 1 << cfg.folding_factor, self.E.D)])
        return tree

    def commit_hiding(self, evals_std, rng, t: int = None, spans=None):
        """Commit to the hypercube evaluations `evals_std` (standard form,
        an integer tensor; the work stays on its device) under the zk
        encoding. Returns (root, HidingWhirData)."""
        F, cfg = self.F, self.config
        dev = evals_std.device
        mark = stage_timer(spans, dev)
        n = log2_strict(evals_std.shape[0])
        if t is None:
            # the query budget: round 0's spot checks hit t distinct coset
            # groups of 2^k positions each
            t = (1 << cfg.folding_factor) * (
                cfg.queries_at(0) + cfg.ood_at(0) + 2)
        if t > (1 << n):
            raise ValueError("randomness budget exceeds the spare cube")
        coeffs_g = evals_to_coeffs(F, F.to_monty_tensor(
            evals_std.to(torch.int64)))
        # the zk-codes component defines the randomized layout
        # [msg || r_t || 0] and its codeword (zk_codes.py)
        enc = ReedSolomonZkEncoding(
            F=F, t=t, msg_len=1 << n, log_m=n + 1 + cfg.log_blowup,
            shift_std=F.GENERATOR, device=dev)
        r = enc.sample_randomness(rng)
        r_m = torch.from_numpy(F.to_monty_np(r).astype(np.int64)).to(dev)
        zk = enc.coefficients(coeffs_g, r_m)
        mark("hiding: zk coefficients")
        codeword = enc.codeword_bitrev(zk)
        tree = self.mmcs.commit([codeword.reshape(-1,
                                                  1 << cfg.folding_factor)])
        del codeword
        mark("hiding: commit G")
        return tree.root_std, HidingWhirData(coeffs_zk=zk, tree=tree,
                                             n_vars=n)

    # ------------------------------------------------------------------
    def _switch(self, data, challenger, rng, mask_claim, mark):
        """The code switch shared by both openings: draw and commit the
        mask, observe its root and its claim `mask_claim(m)`, sample rho.
        Returns (h = G + rho·M, rho, v_m, the paired oracle, the mask's
        root)."""
        E = self.E
        cz = E.from_base(data.coeffs_zk)
        n1 = data.n_vars + 1
        m = self._mask(rng, n1, cz.device)
        mark("hiding: mask draw")
        tree_m = self._commit_mask(m)
        challenger.observe_digest(tree_m.root_std)
        mark("hiding: commit M")
        v_mask = mask_claim(m)
        challenger.observe_ext(v_mask)
        rho = challenger.sample_ext(E.D)
        h = E.add(cz, E.mul(m, E.const(rho, cz.device)))
        del m
        paired = _PairedTrees(tree_g=data.tree, tree_m=tree_m, rho=rho)
        mark("hiding: h = g + rho·m")
        return h, rho, v_mask, paired, tree_m.root_std

    def open_hiding(self, data: HidingWhirData, point: list, challenger,
                    rng, spans=None):
        """Prove g(point) in HVZK. The caller observes the commitment, the
        point and the claimed value first. Returns (value,
        HidingWhirProof). spans: a dict of stage seconds."""
        E, cfg = self.E, self.config
        n1 = data.n_vars + 1
        point_p = list(point) + [E.zero_h()]
        mark = stage_timer(spans, data.coeffs_zk.device)
        value = eval_coeffs_at(E, E.from_base(data.coeffs_zk), [point_p])[0]
        h, rho, v_mask, paired, mask_root = self._switch(
            data, challenger, rng,
            lambda m: eval_coeffs_at(E, m, [point_p])[0], mark)
        h_value = E.add_h(value, E.mul_h(rho, v_mask))
        inner = self._open_core(h, point_p, h_value, challenger, paired,
                                n1 + cfg.log_blowup, "paired", spans=spans)
        return value, HidingWhirProof(mask_commit=mask_root, v_mask=v_mask,
                                      inner=inner)

    def open_hiding_multi(self, data: HidingWhirData, points_scales, claim,
                          challenger, rng, spans=None):
        """The HVZK batched opening of a weighted multi-point statement
        Σ_i scale_i·g(p_i) = claim (the masked sumcheck's mask oracle).
        Returns the HidingWhirProof; the claim itself is the caller's."""
        E, cfg = self.E, self.config
        n1 = data.n_vars + 1
        cons_p = [(list(p) + [E.zero_h()], sc) for p, sc in points_scales]
        mark = stage_timer(spans, data.coeffs_zk.device)

        def mask_claim(m):
            v = E.zero_h()
            for (_, sc), mv in zip(cons_p, eval_coeffs_at(
                    E, m, [p for p, _ in cons_p])):
                v = E.add_h(v, E.mul_h(sc, mv))
            return v

        h, rho, v_mask, paired, mask_root = self._switch(
            data, challenger, rng, mask_claim, mark)
        h_claim = E.add_h(claim, E.mul_h(rho, v_mask))
        inner = self._open_core(h, None, h_claim, challenger, paired,
                                n1 + cfg.log_blowup, "paired",
                                init_constraints=cons_p, spans=spans)
        return HidingWhirProof(mask_commit=mask_root, v_mask=v_mask,
                               inner=inner)

    def verify_hiding_multi(self, commitment, n_vars: int, points_scales,
                            claim, proof: HidingWhirProof, challenger):
        E, cfg = self.E, self.config
        n1 = n_vars + 1
        cons_p = [(list(p) + [E.zero_h()], sc) for p, sc in points_scales]
        challenger.observe_digest(proof.mask_commit)
        challenger.observe_ext(proof.v_mask)
        rho = challenger.sample_ext(E.D)
        h_claim = E.add_h(claim, E.mul_h(rho, proof.v_mask))
        paired = _PairedCommit(commit_g=commitment,
                               commit_m=proof.mask_commit, rho=rho)
        self._verify_core(paired, n1, None, h_claim, proof.inner, challenger,
                          n1 + cfg.log_blowup, "paired",
                          init_constraints=cons_p)

    # ------------------------------------------------------------------
    def verify_hiding(self, commitment, n_vars: int, point: list, value,
                      proof: HidingWhirProof, challenger):
        E, cfg = self.E, self.config
        n1 = n_vars + 1
        point_p = list(point) + [E.zero_h()]
        challenger.observe_digest(proof.mask_commit)
        challenger.observe_ext(proof.v_mask)
        rho = challenger.sample_ext(E.D)
        h_value = E.add_h(value, E.mul_h(rho, proof.v_mask))
        paired = _PairedCommit(commit_g=commitment,
                               commit_m=proof.mask_commit, rho=rho)
        self._verify_core(paired, n1, point_p, h_value, proof.inner,
                          challenger, n1 + cfg.log_blowup, "paired")
