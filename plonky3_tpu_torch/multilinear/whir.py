"""WHIR: the multilinear PCS over constrained Reed–Solomon codes.

Port of `plonky3_tpu/multilinear/whir.py` (the `whir/` crate:
`whir/src/parameters/whir.rs:142` WhirConfig; `whir/src/pcs/prover/
mod.rs:73,146,197` the prover's rounds; the verifier under
`pcs/verifier/`). Each round couples k sumcheck rounds over
Σ_x g(x)·W(x) (W a weighted sum of eq polynomials, the reference's
EqStatement) with an RS-code fold:

  round i:  k sumcheck rounds (quadratic round polys, challenges r)
            → commit RS(g' = g(r,·)) on a domain half the size
            → OOD samples z: the prover answers ĝ'(z)
            → proof-of-work grind
            → STIR queries into the previous codeword: opened coset
              groups fold (with r) to evaluations of ĝ' at domain points
            → a fresh γ batches the new constraints into the statement.
  final:    g_M is sent in the clear; queries into the last committed
            codeword fold-check against ĝ_M; the running claim is checked
            against Σ_j scale_j·g_M(p_j).

ĝ(X) = Σ_c coeff_c X^c and ĝ(y) = g(y, y², y⁴, …); variable 1 is the
low bit of the coefficient index. Codewords live on g·K bit-reversed.
Round 0 commits the base-field codeword (the whole polynomial as one
column, leaves of 2^k values); later rounds commit extension codewords.

On the prover every table as large as the polynomial or the codeword is
an (N, D) int64 Montgomery tensor on the device of the committed
evaluations: the Möbius transform, the coefficients, the sumcheck's
evaluation and eq tables, each encoding (K1/K2 through `ops.ntt` on a
CUDA tensor) and the Merkle commits. The host holds the transcript-sized
values: round polynomials, OOD answers, the queried groups and the
final polynomial. The verifier is host Python, as the reference's.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops.ntt import coset_evals_from_coeffs
from ..utils.bits import log2_strict, reverse_bits_len
from ..utils.timing import stage_timer
from .device_kernels import (
    coeffs_to_evals_device,
    eval_univariate_device,
    ext_tensor,
    fold_at,
    horner_fold_pair,
    pull_ext,
    round_poly_012,
    weighted_eq_table,
)


class WhirError(Exception):
    pass


@dataclass(frozen=True)
class WhirConfig:
    """Protocol knobs (WhirConfig, whir/src/parameters/whir.rs:142).

    The flat num_queries/ood_samples/pow_bits apply to every round
    unless the per-round schedules (round_*) are set — from_security
    derives those from a SecurityAssumption exactly as the reference's
    WhirConfig::new round loop does (whir.rs:382-470; error calculators
    security/src/{assumption,whir}.rs)."""

    log_blowup: int
    folding_factor: int  # k
    final_vars: int
    num_queries: int
    ood_samples: int = 1
    pow_bits: int = 4
    # per-round schedules (index = round, last entry = final round)
    round_queries: tuple = None
    round_ood: tuple = None
    round_pow_bits: tuple = None
    security_assumption: str = None  # "unique"|"johnson"|"capacity"
    security_bits: int = None

    def num_rounds(self, n_vars: int) -> int:
        if (n_vars - self.final_vars) % self.folding_factor:
            raise ValueError("n_vars - final_vars must be a multiple of "
                             "the folding factor")
        return (n_vars - self.final_vars) // self.folding_factor

    def queries_at(self, rnd: int) -> int:
        if self.round_queries is not None:
            return self.round_queries[min(rnd, len(self.round_queries) - 1)]
        return self.num_queries

    def ood_at(self, rnd: int) -> int:
        if self.round_ood is not None:
            return self.round_ood[min(rnd, len(self.round_ood) - 1)]
        return self.ood_samples

    def pow_at(self, rnd: int) -> int:
        if self.round_pow_bits is not None:
            return self.round_pow_bits[
                min(rnd, len(self.round_pow_bits) - 1)
            ]
        return self.pow_bits

    @staticmethod
    def from_security(security_bits: int, assumption: str, n_vars: int,
                      field_bits: int, log_blowup: int = 1,
                      folding_factor: int = 2, final_vars: int = None,
                      max_pow_bits: int = 16) -> "WhirConfig":
        """Derive the per-round query/OOD/PoW schedule from a security
        assumption (whir/src/parameters/whir.rs:220 WhirConfig::new).

        Per round: STIR queries priced at the CURRENT rate, OOD samples
        and folding at the NEXT rate (the domain halves per round while
        k variables fold, so log_inv_rate grows by k-1); PoW closes the
        gap between the target and the weaker of the query / combination
        errors."""
        from . import whir_security as sec

        k = folding_factor
        if final_vars is None:
            final_vars = n_vars % k if n_vars % k else k
        m = (n_vars - final_vars) // k
        if m < 1:
            raise ValueError("need at least one WHIR round")
        protocol_level = max(0, security_bits - max_pow_bits)

        queries, oods, pows = [], [], []
        rate = log_blowup
        nv = n_vars
        for rnd in range(m):
            next_rate = rate + (k - 1)
            nq = sec.queries(assumption, protocol_level, rate)
            ood = sec.determine_ood_samples(
                assumption, security_bits, nv, next_rate, field_bits
            )
            q_err = sec.queries_error(assumption, rate, nq)
            c_err = sec.queries_combination_error(
                assumption, field_bits, nv, next_rate, ood, nq
            )
            pow_b = max(0.0, security_bits - min(q_err, c_err))
            queries.append(nq)
            oods.append(ood)
            pows.append(int(pow_b + 0.999999))
            rate = next_rate
            nv -= k
        # final round: queries at the last rate, no OOD
        nq = sec.queries(assumption, protocol_level, rate)
        q_err = sec.queries_error(assumption, rate, nq)
        queries.append(nq)
        oods.append(0)
        pows.append(int(max(0.0, security_bits - q_err) + 0.999999))
        return WhirConfig(
            log_blowup=log_blowup,
            folding_factor=k,
            final_vars=final_vars,
            num_queries=queries[0],
            ood_samples=oods[0] if oods else 1,
            pow_bits=pows[0] if pows else 0,
            round_queries=tuple(queries),
            round_ood=tuple(oods),
            round_pow_bits=tuple(pows),
            security_assumption=assumption,
            security_bits=security_bits,
        )

    def soundness_report(self, n_vars: int, field_bits: int) -> dict:
        """Achieved soundness bits per error source (security/src/whir.rs
        composition; reported by the CLI after verification)."""
        from . import whir_security as sec

        if self.security_assumption is None:
            return {}
        a = self.security_assumption
        k = self.folding_factor
        m = self.num_rounds(n_vars)
        rate = self.log_blowup
        nv = n_vars
        worst = float("inf")
        terms = {}
        for rnd in range(m + 1):
            nq = self.queries_at(rnd)
            pow_b = self.pow_at(rnd)
            q = sec.queries_error(a, rate, nq) + pow_b
            terms[f"round{rnd}_queries"] = round(q, 1)
            worst = min(worst, q)
            if rnd < m:
                next_rate = rate + (k - 1)
                ood = self.ood_at(rnd)
                if ood:
                    o = sec.ood_error(a, nv, next_rate, field_bits, ood)
                    terms[f"round{rnd}_ood"] = round(o, 1)
                    worst = min(worst, o)
                rate = next_rate
                nv -= k
        terms["conjectured_bits"] = round(worst, 1)
        return terms


@dataclass
class WhirRoundProof:
    sumcheck_polys: list  # [k] -> [3] ext tuples (s(0), s(1), s(2))
    commitment: tuple | None  # None in the final round (poly in clear)
    ood_values: list  # [ood_samples] ext tuples
    pow_witness: int
    query_rows: list  # sampled leaf rows (bound by the transcript; kept
    # in the proof only for shape checks — verifier re-derives them)
    query_values: list  # [query] -> list of 2^k ext tuples (coset group)
    query_proof: list  # pruned sibling digests (one shared proof)


@dataclass
class WhirProof:
    rounds: list  # [WhirRoundProof], the last one is the final round
    final_poly: list  # 2^final_vars ext coefficient tuples


@dataclass
class WhirProverData:
    coeffs: object  # (2^n,) int64 Montgomery coefficients on the device
    tree: object


# ---------------------------------------------------------------------------
# multilinear helpers (host exact)
# ---------------------------------------------------------------------------
def evals_to_coeffs(F, evals):
    """Hypercube evaluations -> multilinear coefficients (the Möbius
    transform) of a 1-D int64 tensor, in either form (it is linear), on
    the tensor's device."""
    c = evals
    n = c.shape[0]
    step = 1
    while step < n:
        v = c.reshape(-1, 2, step)
        c = torch.stack([v[:, 0], F.sub(v[:, 1], v[:, 0])],
                        dim=1).reshape(n)
        step <<= 1
    return c


def coeffs_to_evals_ext(E, coeffs: list) -> list:
    c = list(coeffs)
    n = log2_strict(len(c))
    for i in range(n):
        step = 1 << i
        for base in range(0, len(c), 2 * step):
            for j in range(base + step, base + 2 * step):
                c[j] = E.add_h(c[j], c[j - step])
    return c


def eval_multilinear_coeffs(E, coeffs: list, point: list):
    """g(point) from coefficients; point[0] = variable 1 (index LSB)."""
    c = list(coeffs)
    for p in point:
        c = [
            E.add_h(c[2 * j], E.mul_h(p, c[2 * j + 1]))
            for j in range(len(c) // 2)
        ]
    if len(c) != 1:
        raise ValueError("the point's length does not match the table")
    return c[0]


def eval_univariate(E, coeffs: list, z):
    acc = E.zero_h()
    for c in reversed(coeffs):
        acc = E.add_h(E.mul_h(acc, z), c)
    return acc


def power_point(E, y, n_vars: int) -> list:
    out = []
    cur = y
    for _ in range(n_vars):
        out.append(cur)
        cur = E.mul_h(cur, cur)
    return out


def eq_factor(E, p: list, r: list):
    acc = E.one_h()
    for pi, ri in zip(p, r):
        term = E.add_h(
            E.mul_h(E.sub_h(E.one_h(), pi), E.sub_h(E.one_h(), ri)),
            E.mul_h(pi, ri),
        )
        acc = E.mul_h(acc, term)
    return acc


def eq_table(E, p: list) -> list:
    """[eq(p, x)]_x, x's bit i-1 = variable i (p[0] ↔ index LSB)."""
    table = [E.one_h()]
    for pi in p:
        one_m = E.sub_h(E.one_h(), pi)
        lo = [E.mul_h(t, one_m) for t in table]
        hi = [E.mul_h(t, pi) for t in table]
        # new variable owns the TOP bit of the grown index
        table = lo + hi
    return table


def _bind_var(E, table: list, r):
    return [
        E.add_h(
            table[2 * j],
            E.mul_h(r, E.sub_h(table[2 * j + 1], table[2 * j])),
        )
        for j in range(len(table) // 2)
    ]


def _lagrange_012(E, s, r):
    """Interpolate the quadratic s from (s(0), s(1), s(2)) at r."""
    two_inv = E.inv_h(E.from_base_h(2))
    r1 = E.sub_h(r, E.one_h())
    r2 = E.sub_h(r, E.from_base_h(2))
    t0 = E.mul_h(E.mul_h(s[0], E.mul_h(r1, r2)), two_inv)
    t1 = E.neg_h(E.mul_h(s[1], E.mul_h(r, r2)))
    t2 = E.mul_h(E.mul_h(s[2], E.mul_h(r, r1)), two_inv)
    return E.add_h(E.add_h(t0, t1), t2)


def fold_group(E, F, group: list, row: int, log_h: int, rs: list):
    """Fold a 2^k coset group of a bitrev codeword over g·K (size
    2^log_h) with challenges rs; returns ĝ_folded(y), y = x_row^{2^k}.

    Level l pairs fold with x = g^{2^l}·ω_{2^{log_h-l}}^{rev(parent)}
    (the shift squares per level)."""
    k = len(rs)
    vals = list(group)
    for l, r in enumerate(rs):
        log_cur = log_h - l
        shift = F.exp_h(F.GENERATOR, 1 << l)
        g_cur = F.two_adic_generator_h(log_cur)
        nxt = []
        for j in range(len(vals) // 2):
            parent = (row << (k - l - 1)) + j
            x = F.mul_h(
                shift, F.exp_h(g_cur, reverse_bits_len(parent, log_cur - 1))
            )
            v0, v1 = vals[2 * j], vals[2 * j + 1]
            s = E.base_mul_h(F.inv_h(2), E.add_h(v0, v1))
            d = E.base_mul_h(
                F.inv_h(F.mul_h(2, x)), E.mul_h(E.sub_h(v0, v1), r)
            )
            nxt.append(E.add_h(s, d))
        vals = nxt
    if len(vals) != 1:
        raise ValueError("a group of 2^k values for k challenges")
    return vals[0]


def _group_base_point(F, row: int, log_h: int, k: int) -> int:
    """y = x^{2^k} for the coset group at leaf `row` (bitrev layout)."""
    x = F.mul_h(
        F.GENERATOR,
        F.exp_h(
            F.two_adic_generator_h(log_h),
            reverse_bits_len(row << k, log_h),
        ),
    )
    return F.exp_h(x, 1 << k)


# ---------------------------------------------------------------------------
# the PCS
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class WhirPcs:
    """The MultilinearPcs contract (commit/src/pcs/multilinear.rs:20):
    commit, open at a point, verify."""

    F: object
    E: object
    config: WhirConfig
    mmcs: object  # base-field MerkleTreeMmcs
    fri_mmcs: object  # ExtensionMmcs

    # -- commit ---------------------------------------------------------
    def commit(self, evals_std):
        """Commit to the hypercube evaluations `evals_std` (standard form,
        an integer tensor; the work stays on its device). Returns (root,
        WhirProverData)."""
        F, cfg = self.F, self.config
        k = cfg.folding_factor
        coeffs = evals_to_coeffs(F, F.to_monty_tensor(evals_std.to(
            torch.int64)))
        codeword = coset_evals_from_coeffs(F, coeffs.reshape(-1, 1),
                                           cfg.log_blowup, F.GENERATOR)
        tree = self.mmcs.commit([codeword.reshape(-1, 1 << k)])
        return tree.root_std, WhirProverData(coeffs=coeffs, tree=tree)

    # -- open -----------------------------------------------------------
    def open(self, data: WhirProverData, point: list, challenger,
             spans=None):
        """Prove g(point); the caller observes the commitment, point and
        value first. Returns (value, WhirProof). spans: a dict of stage
        seconds (`utils.timing.stage_timer`)."""
        from ..challenger.schema import SchemaChallenger, whir_schema

        E = self.E
        n = log2_strict(data.coeffs.shape[0])
        # the base coefficients lifted to the extension once; g(point) is
        # n multilinear folds on the device
        cd = E.from_base(data.coeffs)
        vd = cd
        for p in point:
            vd = horner_fold_pair(E, vd, E.const(p, vd.device))
        value = pull_ext(E, vd[0])
        wrapped = not isinstance(challenger, SchemaChallenger)
        if wrapped:
            challenger = SchemaChallenger(challenger,
                                          whir_schema(self.config, n))
        proof = self._open_core(cd, point, value, challenger, data.tree,
                                n + self.config.log_blowup, False,
                                spans=spans)
        if wrapped:
            challenger.finish()
        return value, proof

    @staticmethod
    def _weighted_table(E, constraints, n_cur: int, device):
        """Σ sc·eq(p, ·) over the batched constraints
        (device_kernels.weighted_eq_table, the packed split-eq analog,
        multilinear-util/src/split_eq/packed_kernel.rs:1)."""
        pts = ext_tensor(E, [p for p, _ in constraints], device).reshape(
            len(constraints), n_cur, E.D)
        scs = ext_tensor(E, [sc for _, sc in constraints], device)
        return weighted_eq_table(E, pts, scs, n_cur)

    def _open_core(self, cd, point, value, challenger, tree0, log_h0, ext0,
                   init_constraints=None, spans=None):
        """The WHIR round loop from (N, D) ext coefficients `cd` and a
        round-0 oracle (tree0, ext0; "paired" with a `_PairedTrees` for
        the hiding code-switch, hiding_whir.py). init_constraints: an optional
        [(point, scale)] weighted statement that replaces the single
        point (the claim `value` is the sum of the scaled evaluations):
        the multi-point batching of the reference's EqStatement."""
        F, E, cfg = self.F, self.E, self.config
        dev = cd.device
        mark = stage_timer(spans, dev)
        n = log2_strict(cd.shape[0])
        k = cfg.folding_factor
        M = cfg.num_rounds(n)
        if M < 1:
            raise ValueError("need at least one WHIR round")

        evals = coeffs_to_evals_device(E, cd)
        if init_constraints is None:
            constraints = [(list(point), E.one_h())]
        else:
            constraints = [(list(p), sc) for p, sc in init_constraints]
        w_table = self._weighted_table(E, constraints, n, dev)
        claim = value
        mark("whir: eq tables")

        prev_tree, prev_log_h, prev_ext = tree0, log_h0, ext0
        rounds = []
        n_cur = n

        for rnd in range(M):
            sc_polys, rs = [], []
            for _ in range(k):
                s = pull_ext(E, round_poly_012(E, evals, w_table))
                if E.add_h(s[0], s[1]) != claim:
                    raise RuntimeError("sumcheck drift")
                for v in s:
                    challenger.observe_ext(v)
                r = challenger.sample_ext(E.D)
                rs.append(r)
                sc_polys.append(s)
                r_m = E.const(r, dev)
                evals = fold_at(E, evals, r_m)
                w_table = fold_at(E, w_table, r_m)
                cd = horner_fold_pair(E, cd, r_m)
                claim = _lagrange_012(E, s, r)
            n_cur -= k
            constraints = [(p[k:], E.mul_h(sc, eq_factor(E, p[:k], rs)))
                           for (p, sc) in constraints]
            mark("whir: sumcheck")

            if rnd == M - 1:
                final_poly = pull_ext(E, cd)
                for c in final_poly:
                    challenger.observe_ext(c)
                mark("whir: sumcheck")
                pow_witness = challenger.grind(cfg.pow_at(rnd))
                mark("whir: grinds")
                rows, qvals, qproof = self._answer_queries(
                    prev_tree, prev_log_h, k, challenger, prev_ext,
                    cfg.queries_at(rnd))
                mark("whir: queries")
                rounds.append(WhirRoundProof(
                    sumcheck_polys=sc_polys, commitment=None, ood_values=[],
                    pow_witness=pow_witness, query_rows=rows,
                    query_values=qvals, query_proof=qproof))
                return WhirProof(rounds=rounds, final_poly=final_poly)

            log_h = prev_log_h - 1
            # commit the folded codeword straight from the live
            # coefficients
            cw = coset_evals_from_coeffs(
                F, cd, log_h - log2_strict(cd.shape[0]), F.GENERATOR)
            tree = self.fri_mmcs.commit_ext_matrices(
                [cw.reshape(-1, 1 << k, E.D)])
            del cw
            challenger.observe_digest(tree.root_std)
            mark("whir: round commits")

            ood_values, new_pts = [], []
            for _ in range(cfg.ood_at(rnd)):
                z = challenger.sample_ext(E.D)
                v = eval_univariate_device(E, cd, z)
                challenger.observe_ext(v)
                ood_values.append(v)
                new_pts.append((power_point(E, z, n_cur), v))

            mark("whir: ood")
            pow_witness = challenger.grind(cfg.pow_at(rnd))
            mark("whir: grinds")
            rows, qvals, qproof = self._answer_queries(
                prev_tree, prev_log_h, k, challenger, prev_ext,
                cfg.queries_at(rnd))
            for row, group in zip(rows, qvals):
                y = _group_base_point(F, row, prev_log_h, k)
                fold = fold_group(E, F, group, row, prev_log_h, rs)
                new_pts.append((power_point(E, E.from_base_h(y), n_cur),
                                fold))

            gamma = challenger.sample_ext(E.D)
            gp = gamma
            for p, v in new_pts:
                constraints.append((p, gp))
                claim = E.add_h(claim, E.mul_h(gp, v))
                gp = E.mul_h(gp, gamma)
            mark("whir: queries")

            w_table = self._weighted_table(E, constraints, n_cur, dev)
            mark("whir: eq tables")

            rounds.append(WhirRoundProof(
                sumcheck_polys=sc_polys, commitment=tree.root_std,
                ood_values=ood_values, pow_witness=pow_witness,
                query_rows=rows, query_values=qvals, query_proof=qproof))
            prev_tree, prev_log_h, prev_ext = tree, log_h, True

    def _answer_queries(self, tree, log_h, k, challenger, is_ext,
                        n_queries=None):
        E, cfg = self.E, self.config
        rows = [challenger.sample_bits(log_h - k)
                for _ in range(n_queries if n_queries is not None
                               else cfg.num_queries)]
        if is_ext == "paired":
            # the hiding code-switch's round 0 (hiding_whir.py): open the
            # zk-encoded witness tree and the ext mask tree at the same
            # rows; the combined values are g + rho·m
            g_pq, g_proof = self.mmcs.open_multi_batch(tree.tree_g, rows)
            m_pq, m_proof = self.fri_mmcs.open_multi_batch(tree.tree_m,
                                                           rows)
            qvals = [[E.add_h(E.from_base_h(gv), E.mul_h(tree.rho, mv))
                      for gv, mv in zip(gq[0], mq[0])]
                     for gq, mq in zip(g_pq, m_pq)]
            proof = ("paired", [gq[0] for gq in g_pq], g_proof,
                     [mq[0] for mq in m_pq], m_proof)
        elif is_ext:
            vals_pq, proof = self.fri_mmcs.open_multi_batch(tree, rows)
            qvals = [q[0] for q in vals_pq]
        else:
            vals_pq, proof = self.mmcs.open_multi_batch(tree, rows)
            qvals = [[E.from_base_h(v) for v in q[0]] for q in vals_pq]
        return rows, qvals, proof

    # -- verify ---------------------------------------------------------
    def verify(self, commitment, n_vars: int, point: list, value,
               proof: WhirProof, challenger):
        from ..challenger.schema import SchemaChallenger, whir_schema

        wrapped = not isinstance(challenger, SchemaChallenger)
        if wrapped:
            challenger = SchemaChallenger(challenger,
                                          whir_schema(self.config, n_vars))
        self._verify_core(commitment, n_vars, point, value, proof,
                          challenger, n_vars + self.config.log_blowup, False)
        if wrapped:
            challenger.finish()

    def _verify_core(self, commitment, n_vars: int, point: list, value,
                     proof: WhirProof, challenger, log_h0: int, ext0,
                     init_constraints=None):
        F, E, cfg = self.F, self.E, self.config
        k = cfg.folding_factor
        M = cfg.num_rounds(n_vars)
        if len(proof.rounds) != M:
            raise WhirError("RoundCountMismatch")
        if len(proof.final_poly) != 1 << cfg.final_vars:
            raise WhirError("FinalPolyLengthMismatch")

        if init_constraints is None:
            constraints = [(list(point), E.one_h())]
        else:
            constraints = [(list(p), sc) for p, sc in init_constraints]
        claim = value
        prev_commit, prev_log_h, prev_ext = commitment, log_h0, ext0
        n_cur = n_vars

        for rnd, rp in enumerate(proof.rounds):
            final = rnd == M - 1
            if len(rp.sumcheck_polys) != k:
                raise WhirError("SumcheckPolyCountMismatch")
            rs = []
            for s in rp.sumcheck_polys:
                if len(s) != 3:
                    raise WhirError("RoundPolyShapeMismatch")
                if E.add_h(s[0], s[1]) != claim:
                    raise WhirError("SumcheckClaimMismatch")
                for v in s:
                    challenger.observe_ext(v)
                r = challenger.sample_ext(E.D)
                rs.append(r)
                claim = _lagrange_012(E, s, r)
            n_cur -= k
            constraints = [
                (p[k:], E.mul_h(sc, eq_factor(E, p[:k], rs)))
                for (p, sc) in constraints
            ]

            if final:
                for c in proof.final_poly:
                    challenger.observe_ext(c)
                if not challenger.check_witness(
                    cfg.pow_at(rnd), rp.pow_witness
                ):
                    raise WhirError("InvalidPowWitness")
                rows = [
                    challenger.sample_bits(prev_log_h - k)
                    for _ in range(cfg.queries_at(rnd))
                ]
                self._verify_openings(
                    prev_commit, prev_log_h, k, rows, rp, prev_ext
                )
                for row, group in zip(rows, rp.query_values):
                    y = _group_base_point(F, row, prev_log_h, k)
                    fold = fold_group(E, F, group, row, prev_log_h, rs)
                    direct = eval_univariate(
                        E, proof.final_poly, E.from_base_h(y)
                    )
                    if fold != direct:
                        raise WhirError("FinalQueryMismatch")
                total = E.zero_h()
                for p, sc in constraints:
                    total = E.add_h(
                        total,
                        E.mul_h(
                            sc,
                            eval_multilinear_coeffs(
                                E, proof.final_poly, p
                            ),
                        ),
                    )
                if total != claim:
                    raise WhirError("FinalClaimMismatch")
                return

            if rp.commitment is None:
                raise WhirError("MissingRoundCommitment")
            challenger.observe_digest(rp.commitment)
            if len(rp.ood_values) != cfg.ood_at(rnd):
                raise WhirError("OodCountMismatch")
            new_pts = []
            for v in rp.ood_values:
                z = challenger.sample_ext(E.D)
                challenger.observe_ext(v)
                new_pts.append((power_point(E, z, n_cur), v))
            if not challenger.check_witness(
                cfg.pow_at(rnd), rp.pow_witness
            ):
                raise WhirError("InvalidPowWitness")
            rows = [
                challenger.sample_bits(prev_log_h - k)
                for _ in range(cfg.queries_at(rnd))
            ]
            self._verify_openings(
                prev_commit, prev_log_h, k, rows, rp, prev_ext
            )
            for row, group in zip(rows, rp.query_values):
                y = _group_base_point(F, row, prev_log_h, k)
                fold = fold_group(E, F, group, row, prev_log_h, rs)
                new_pts.append(
                    (power_point(E, E.from_base_h(y), n_cur), fold)
                )
            gamma = challenger.sample_ext(E.D)
            gp = gamma
            for p, v in new_pts:
                constraints.append((p, gp))
                claim = E.add_h(claim, E.mul_h(gp, v))
                gp = E.mul_h(gp, gamma)
            prev_commit, prev_log_h, prev_ext = (
                rp.commitment,
                prev_log_h - 1,
                True,
            )

    def _verify_openings(self, commit, log_h, k, rows, rp, is_ext):
        E = self.E
        if len(rp.query_values) != len(rows):
            raise WhirError("QueryCountMismatch")
        for g in rp.query_values:
            if len(g) != (1 << k):
                raise WhirError("QueryGroupShapeMismatch")
        if is_ext == "paired":
            # the hiding round 0: authenticate both trees, recombine, and
            # pin the combined values that the fold checks consume
            if not (isinstance(rp.query_proof, tuple)
                    and rp.query_proof[0] == "paired"):
                raise WhirError("MissingPairedProof")
            _, g_rows, g_proof, m_rows, m_proof = rp.query_proof
            dims = [(1 << (log_h - k), 1 << k)]
            if not self.mmcs.verify_multi_batch(
                    commit.commit_g, dims, rows, [[g] for g in g_rows],
                    g_proof):
                raise WhirError("MmcsError")
            if not self.fri_mmcs.verify_multi_batch(
                    commit.commit_m, dims, rows, [[m] for m in m_rows],
                    m_proof):
                raise WhirError("MmcsError")
            for qv, gq, mq in zip(rp.query_values, g_rows, m_rows):
                comb = [E.add_h(E.from_base_h(gv), E.mul_h(commit.rho, mv))
                        for gv, mv in zip(gq, mq)]
                if list(qv) != comb:
                    raise WhirError("PairedCombineMismatch")
            return
        if is_ext:
            ok = self.fri_mmcs.verify_multi_batch(
                commit,
                [(1 << (log_h - k), 1 << k)],
                rows,
                [[g] for g in rp.query_values],
                rp.query_proof,
            )
        else:
            base_rows = []
            for g in rp.query_values:
                row_vals = []
                for v in g:
                    if any(c != 0 for c in v[1:]):
                        raise WhirError("NonBaseOpening")
                    row_vals.append(int(v[0]))
                base_rows.append([row_vals])
            ok = self.mmcs.verify_multi_batch(
                commit,
                [(1 << (log_h - k), 1 << k)],
                rows,
                base_rows,
                rp.query_proof,
            )
        if not ok:
            raise WhirError("MmcsError")
