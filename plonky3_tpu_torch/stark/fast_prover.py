"""uni-stark prover with the Fiat-Shamir transcript on the device.

Port of `plonky3_tpu/stark/fast_prover.py`. It gives the same Proof as
`prover.prove`, bit for bit, but every challenge is sampled by the
config's device transcript on the device of the trace and feeds the next
stage there, and the host copies the results once, at the end. The
transcript is `DeviceSerializingChallenger32` (keccak config, word
digests) or `DeviceDuplexChallenger` (Poseidon2 config, field digests):

  _device_body_p1: trace commit -> alpha -> quotient eval and commit ->
    zeta -> the opened values (ys) by coefficient dots -> the ys absorbed
    and alpha2 sampled (one `keccak256_chain` or `poseidon2_duplex_chain`
    launch)
  _device_body_p2: reduced-opening accumulation -> every FRI round (lazy
    commit, root observed and beta sampled on the device, device fold) ->
    final polynomial -> proof-of-work grind and query indices (one
    `keccak_grind` or `poseidon2_grind` launch) -> query gathers
  _prove_device_fs: one device-to-host copy of every output (`_pull`),
    the transcript's flags checked, and the pruned multiproofs rebuilt on
    the host from non-pruned per-level gathers (`_pruned_wire`)

Against the reference: eager PyTorch has nothing to compile, so there is
no program cache, no `jax.jit` and no profiling probe (`stop=`), and the
static structure (`meta`) is found on every call. Alpha2 is sampled on the
device, the reference's branch for configs without a fast host hash: the
JAX package replays the transcript with a host C keccak or Poseidon2
that the port does not have (its host hashes are Python and numpy). With
no host replay between the two bodies, one copy at the end serves both.

`_prove_device_fs` raises `_Unsupported` where the reference does: a ZK
PCS, a matrix shorter than the Merkle cap, and the (cryptographically
negligible) event that a device flag trips. `prove_fast` then falls back
to `prove` for a CPU trace only: on the card the error reaches the
caller, so the transcript never moves to the host unseen.

Reference spec: uni-stark/src/prover.rs:379, fri/src/prover.rs:43,
merkle-tree/src/pruning.rs (wire order of the pruned multiproof).
"""

from __future__ import annotations

import numpy as np
import torch

from ..air.api import get_log_num_quotient_chunks, get_symbolic_layout
from ..challenger.device_duplex import DeviceDuplexChallenger
from ..challenger.device_serializing import DeviceSerializingChallenger32
from ..fri.config import compute_log_arity_for_round
from ..fri.proof import BatchMultiOpening, CommitPhaseStep, FriProof
from ..fri.prover import fold_step_device
from ..fri.two_adic_pcs import (
    _accum_kernel,
    _eval_coeffs,
    _ext_powers_device,
    _inv_denom_kernel,
    _mred,
)
from ..hashes.poseidon2 import default_poseidon2
from ..merkle.mmcs import MerkleProverData, _build_layers
from ..ops.ntt import coset_lde_batch, idft, powers_device
from ..utils.bits import bitrev_permute_axis0, log2_strict
from ..utils.timing import stage_timer
from .proof import Commitments, OpenedValues, Proof
from .prover import prove, quotient_of_commitment

# device-to-host copies made by `_pull`, for the tests and chip_smoke.py
PULLS = {"count": 0}


class _Unsupported(Exception):
    """Config outside the fast path; the caller falls back to prove()."""


def _pull(tensors):
    """Copy device tensors to the host in one transfer: numpy int64 arrays
    of the same shapes. Every copy of `_prove_device_fs` goes through
    here and is counted in PULLS."""
    flat = torch.cat([t.reshape(-1).to(torch.int64) for t in tensors])
    flat = flat.cpu().numpy()
    PULLS["count"] += 1
    out, off = [], 0
    for t in tensors:
        out.append(flat[off:off + t.numel()].reshape(tuple(t.shape)))
        off += t.numel()
    return out


def _mmcs_commit_lazy(mmcs, mats):
    """mmcs.commit without the root copy: `commit_dev` is the commitment
    on the device ((8,) root words, or the (2^cap, 8) cap layer) and
    `eff_cap` the cap height clamped to the tree (merkle_tree.rs:182-198)."""
    for m in mats:
        log2_strict(m.shape[0])
    log_max = log2_strict(max(m.shape[0] for m in mats))
    eff_cap = mmcs._eff_cap(log_max)
    if eff_cap > 0 and min(m.shape[0] for m in mats) < (1 << eff_cap):
        raise _Unsupported("matrix shorter than the Merkle cap layer")
    layers = _build_layers(mmcs, mats)
    data = MerkleProverData(matrices=list(mats), layers=layers,
                            root_std=None)
    data.eff_cap = eff_cap
    data.commit_dev = (layers[-1][0] if eff_cap == 0
                       else layers[log_max - eff_cap])
    return data


def _pcs_commit_lazy(pcs, evaluations):
    """pcs.commit with a lazy root (the same LDEs and kept coefficients)."""
    F = pcs.F
    ldes, coeffs = [], []
    for domain, evals in evaluations:
        if evals.shape[0] != domain.size:
            raise ValueError("evaluations do not match their domain")
        shift = F.mul_h(F.GENERATOR, F.inv_h(domain.shift))
        lde, cf = coset_lde_batch(F, evals, pcs.fri.log_blowup, shift,
                                  with_coeffs=True)
        ldes.append(lde)
        coeffs.append(cf)
    data = _mmcs_commit_lazy(pcs.mmcs, ldes)
    data.coeffs = coeffs
    return data


def _pruned_wire(indices, levels: int, sib_levels):
    """Pruned-multiproof sibling list (pruning.rs wire order: level 0
    first; within a level ascending node order) selected from non-pruned
    per-level gathers sib_levels[lvl] (Q, 8) at nodes (idx >> lvl) ^ 1."""
    frontier = sorted(set(indices))
    want = []
    for lvl in range(levels):
        present = set(frontier)
        for node in frontier:
            if node ^ 1 not in present:
                want.append((lvl, node ^ 1))
        frontier = sorted({n >> 1 for n in frontier})
    pm = {}
    for lvl in range(levels):
        arr = sib_levels[lvl]
        for q, idx in enumerate(indices):
            pm[(lvl, (idx >> lvl) ^ 1)] = tuple(int(x) for x in arr[q])
    return [pm[k] for k in want]


def _tree_gathers(data, tree_idx):
    """Device gathers that open a tree at device indices: every matrix row
    (index >> height shift), then every level's sibling digest (proof
    paths stop `eff_cap` levels below the root, mmcs/mod.rs:96)."""
    log_max = log2_strict(data.layers[0].shape[0])
    out = []
    for m in data.matrices:
        shift = log_max - log2_strict(m.shape[0])
        out.append(m.index_select(0, tree_idx >> shift))
    for lvl in range(log_max - data.eff_cap):
        out.append(data.layers[lvl].index_select(0, (tree_idx >> lvl) ^ 1))
    return out


def _max_heights(data_with_points):
    """{id(z): (z, the tallest matrix opened at z)} over the openings."""
    out = {}
    for data, points in data_with_points:
        for mat, pts in zip(data.matrices, points):
            for z in pts:
                out[id(z)] = (z, max(out.get(id(z), (z, 0))[1],
                                     mat.shape[0]))
    return out


def _device_challenger(config, device):
    """The config's transcript on `device`; each needs its digest kind."""
    field_digests = config.pcs.mmcs.digest_is_field
    if config.challenger_factory is not None:
        raise _Unsupported("a config's own transcript has no device twin")
    if config.challenger_kind == "keccak":
        if field_digests:
            raise _Unsupported("the keccak transcript needs word digests")
        return DeviceSerializingChallenger32(config.F, device)
    if not field_digests:
        raise _Unsupported("the duplex transcript needs field digests")
    return DeviceDuplexChallenger(config.F, default_poseidon2(config.F, 24),
                                  device)


class _CarriedTree:
    """What the second body needs of a commitment: its matrices, digest
    layers and cap height (the kept coefficients are dropped)."""

    def __init__(self, data):
        self.matrices = list(data.matrices)
        self.layers = list(data.layers)
        self.eff_cap = data.eff_cap


def prove_fast(config, air, trace, public_values, spans=None) -> Proof:
    """prove() with the device transcript. Outside its scope a CPU trace
    falls back to prove(); a CUDA trace raises _Unsupported (prove() is
    the caller's choice there, never a silent one)."""
    try:
        return _prove_device_fs(config, air, trace, public_values, spans)
    except _Unsupported:
        if trace.device.type != "cpu":
            raise
        return prove(config, air, trace, public_values, spans=spans)


def _device_body_p1(config, air, trace, publics_m, meta, mark):
    """Trace commit -> alpha -> quotient -> zeta -> ys -> alpha2.

    Returns (small, carry): `small`, the device tensors the host needs of
    this part (the two commitments, the ys); `carry`, what the second body
    reads (the trees with their opening points, the ys, alpha2, the
    transcript). Static structure goes into `meta`."""
    F, E, pcs = config.F, config.E, config.pcs
    n = trace.shape[0]
    log_n = log2_strict(n)
    num_chunks = 1 << get_log_num_quotient_chunks(air)

    # ---- commit trace ----
    trace_domain = pcs.natural_domain_for_degree(n)
    trace_data = _pcs_commit_lazy(pcs, [(trace_domain, trace)])
    mark("commit trace")
    ch = _device_challenger(config, trace.device)
    ch.observe_host_ints([log_n, log_n, 0])
    ch.observe_words(trace_data.commit_dev)
    ch.observe_words(publics_m)  # already Montgomery form, the wire words
    alpha_m = ch.sample_fields_m(E.D)

    # ---- quotient ----
    quotient_domain = trace_domain.create_disjoint_domain(n * num_chunks)
    uses_next = air.main_next_row_columns() != []
    num_constraints, _ = get_symbolic_layout(air)
    ap_log = max(1, (num_constraints - 1).bit_length())
    alpha_pows = _ext_powers_device(E, alpha_m, ap_log)[
        :num_constraints].flip(0)
    q_vals = quotient_of_commitment(config, air, [(trace_data, 0)],
                                    trace_domain,
                                    quotient_domain, publics_m, alpha_pows)
    mark("quotient eval")
    sub_evals = quotient_domain.split_evals(num_chunks, q_vals)
    sub_domains = quotient_domain.split_domains(num_chunks)
    quotient_data = _pcs_commit_lazy(pcs, list(zip(sub_domains, sub_evals)))
    ch.observe_words(quotient_data.commit_dev)
    mark("commit quotient")

    zeta_m = ch.sample_fields_m(E.D)
    zeta_next_m = F.mul(zeta_m, F.to_monty_h(trace_domain.gen))

    # ---- open: ys by coefficient dots ----
    trace_points = [zeta_m, zeta_next_m] if uses_next else [zeta_m]
    data_with_points = [
        (trace_data, [trace_points]),
        (quotient_data, [[zeta_m]] * num_chunks),
    ]
    g_inv_m = F.to_monty_h(F.inv_h(F.GENERATOR))
    lb = pcs.fri.log_blowup
    zpows = {
        zid: _ext_powers_device(E, F.mul(z, g_inv_m), log2_strict(h) - lb)
        for zid, (z, h) in _max_heights(data_with_points).items()
    }
    ys_devs = [_eval_coeffs(E, cf, zpows[id(z)])
               for data, points in data_with_points
               for cf, pts in zip(data.coeffs, points) for z in pts]
    mark("open: ys")

    # ---- alpha2 on the device (one chain over the ~10k ys words) ----
    for ys in ys_devs:
        ch.observe_words(ys)  # row-major (w, D) == per-element observe
    alpha2_m = ch.sample_fields_m(E.D)
    mark("open: observe ys + alpha2")

    meta.update(
        uses_next=uses_next,
        num_chunks=num_chunks,
        log_n=log_n,
        log_global_max_height=max(log2_strict(m.shape[0])
                                  for data, _ in data_with_points
                                  for m in data.matrices),
    )
    small = [trace_data.commit_dev, quotient_data.commit_dev, *ys_devs]
    carry = ([(_CarriedTree(data), points)
              for data, points in data_with_points], ys_devs, alpha2_m, ch)
    return small, carry


def _device_body_p2(config, carry, meta, mark):
    """Reduced-opening accumulation -> FRI commit phase -> final poly ->
    grind and query indices -> query gathers. Returns the device tensors
    the host needs of this part; extends `meta` with the FRI structure."""
    F, E, pcs = config.F, config.E, config.pcs
    params = pcs.fri
    data_with_points, ys_devs, alpha2_m, ch = carry
    log_global_max_height = meta["log_global_max_height"]
    device = alpha2_m.device

    xs_br = bitrev_permute_axis0(
        powers_device(F, F.two_adic_generator_h(log_global_max_height),
                      1 << log_global_max_height, device,
                      scale_std=F.GENERATOR),
        log_global_max_height)
    inv_denoms = {zid: _inv_denom_kernel(E, z, xs_br[:h])
                  for zid, (z, h) in _max_heights(data_with_points).items()}

    total_w = sum(m.shape[1] * len(pts)
                  for data, points in data_with_points
                  for m, pts in zip(data.matrices, points))
    a2_pows = _ext_powers_device(E, alpha2_m,
                                 max(1, (total_w - 1).bit_length()))

    reduced, num_reduced = {}, {}
    ys_iter = iter(ys_devs)
    for data, points in data_with_points:
        for mat, pts in zip(data.matrices, points):
            h, w = mat.shape
            log_h = log2_strict(h)
            mat_compressed = _mred(E, mat, a2_pows[:w])
            for z in pts:
                ys_dev = next(ys_iter)
                acc = reduced.get(log_h)
                if acc is None:
                    acc = torch.zeros((h, E.D), dtype=torch.int64,
                                      device=device)
                nr = num_reduced.get(log_h, 0)
                mred_z = F.sum(E.mul(a2_pows[:w], ys_dev), dim=0)  # (D,)
                reduced[log_h] = _accum_kernel(
                    E, acc, mred_z, mat_compressed, inv_denoms[id(z)][:h],
                    a2_pows[nr])
                num_reduced[log_h] = nr + w
    fri_input = [reduced[lh] for lh in sorted(reduced, reverse=True)]
    mark("open: reduced accumulation")

    # ---- FRI commit phase: every round on the device ----
    if params.num_queries <= 0 or params.max_log_arity <= 0:
        raise ValueError("FRI needs queries and a positive arity")
    folded = fri_input[0]
    rest = list(fri_input[1:])
    log_final_height = params.log_blowup + params.log_final_poly_len
    datas, log_arities, commit_pows = [], [], []
    while folded.shape[0] > params.blowup * params.final_poly_len:
        log_h = log2_strict(folded.shape[0])
        next_log_h = log2_strict(rest[0].shape[0]) if rest else None
        log_arity = compute_log_arity_for_round(
            log_h, next_log_h, log_final_height, params.max_log_arity)
        log_arities.append(log_arity)
        data = _mmcs_commit_lazy(
            pcs.fri_mmcs.inner, [folded.reshape(-1, (1 << log_arity) * E.D)])
        ch.observe_words(data.commit_dev)
        datas.append(data)
        if params.commit_proof_of_work_bits:
            w_dev, beta_m = ch.grind_then_sample_fields(
                params.commit_proof_of_work_bits, E.D)
            commit_pows.append(w_dev)
        else:
            beta_m = ch.sample_fields_m(E.D)
        b = beta_m
        for _ in range(log_arity):
            folded = fold_step_device(E, folded, b)
            b = E.mul(b, b)
        if rest and rest[0].shape[0] == folded.shape[0]:
            folded = F.add(folded, E.mul(rest.pop(0), b))
    mark("fri: commit phase")

    # ---- final polynomial (prover.rs:271) ----
    L = params.final_poly_len
    final_coeffs = folded[:L]
    if L > 1:
        final_coeffs = idft(F, bitrev_permute_axis0(final_coeffs,
                                                    log2_strict(L)))
    ch.observe_words(final_coeffs)
    ch.observe_host_ints(log_arities)  # the arity schedule (prover.rs:103)
    mark("fri: final poly")

    # ---- grind + query indices, then the gathers ----
    witness, idx = ch.grind_and_sample_indices(
        params.query_proof_of_work_bits, params.num_queries,
        log_global_max_height)  # extra_query_index_bits == 0 (two-adic)
    mark("fri: grind + indices")
    gathers, input_tree_meta = [], []
    for data, _ in data_with_points:
        log_batch_max = log2_strict(data.layers[0].shape[0])
        gathers.extend(_tree_gathers(
            data, idx >> (log_global_max_height - log_batch_max)))
        input_tree_meta.append((log_batch_max, len(data.matrices),
                                log_batch_max - data.eff_cap))
    ridx, fri_tree_levels = idx, []
    for log_arity, data in zip(log_arities, datas):
        ridx = ridx >> log_arity
        gathers.extend(_tree_gathers(data, ridx))
        fri_tree_levels.append(
            log2_strict(data.layers[0].shape[0]) - data.eff_cap)
    mark("fri: query gathers")

    flags = (torch.stack(ch.flags) if ch.flags
             else torch.zeros((0,), dtype=torch.bool, device=device))
    meta.update(log_arities=log_arities, input_tree_meta=input_tree_meta,
                fri_tree_levels=fri_tree_levels,
                n_commit_pow=len(commit_pows))
    pows = [torch.cat(commit_pows)] if commit_pows else []
    return [flags, *[d.commit_dev for d in datas], *pows, final_coeffs,
            witness, idx, *gathers]


def _prove_device_fs(config, air, trace, public_values, spans=None):
    """The device-transcript prover; raises _Unsupported outside its
    scope (see prove_fast). spans: as in prover.prove."""
    F, E, pcs = config.F, config.E, config.pcs
    if getattr(pcs, "ZK", False):
        # as the reference's (stark/fast_prover.py:593-594)
        raise _Unsupported("the fast path covers the non-ZK TwoAdicFriPcs")
    params = pcs.fri
    if trace.device.type != config.device.type:
        raise ValueError(f"trace on {trace.device}, config on "
                         f"{config.device}")
    mark = stage_timer(spans, trace.device)

    meta = {}
    publics_m = torch.from_numpy(F.to_monty_np(np.asarray(
        public_values, dtype=np.uint32)).astype(np.int64)).to(trace.device)
    small, carry = _device_body_p1(config, air, trace, publics_m, meta, mark)
    outs = _device_body_p2(config, carry, meta, mark)
    del carry
    pulled = _pull(small + outs)
    mark("pull")

    it = iter(pulled)
    mmcs = pcs.mmcs
    trace_root = _digest_wire(mmcs, next(it))
    quotient_root = _digest_wire(mmcs, next(it))
    uses_next = meta["uses_next"]
    num_chunks = meta["num_chunks"]
    n_ys = (2 if uses_next else 1) + num_chunks
    ys_np = [F.from_monty_np(next(it)) for _ in range(n_ys)]
    if not next(it).all():
        # a sampling supply ran short or a PoW replay failed: no valid
        # proof comes from this transcript (prove_fast redoes a CPU
        # trace's on the host)
        raise _Unsupported("device transcript flag tripped")
    log_arities = meta["log_arities"]
    log_global_max_height = meta["log_global_max_height"]
    num_queries = params.num_queries
    fri_mmcs = pcs.fri_mmcs.inner
    fri_commits = [_digest_wire(fri_mmcs, next(it)) for _ in log_arities]
    if meta["n_commit_pow"]:
        commit_pows = [int(x) for x in next(it)]
    else:
        commit_pows = [0] * len(log_arities)
    final_poly = [tuple(int(c) for c in row)
                  for row in F.from_monty_np(next(it))]
    witness = int(next(it)[0])
    indices = [int(x) for x in next(it)]

    # opened values: round 0 is the trace (1-2 points), round 1 the
    # quotient chunks (one point each)
    ys_it = iter(ys_np)
    trace_vals = [[tuple(r) for r in next(ys_it).tolist()]
                  for _ in range(2 if uses_next else 1)]
    chunk_vals = [[tuple(r) for r in next(ys_it).tolist()]
                  for _ in range(num_chunks)]

    input_openings = []
    for log_batch_max, n_mats, levels in meta["input_tree_meta"]:
        tree_indices = [i >> (log_global_max_height - log_batch_max)
                        for i in indices]
        mat_lists = [F.from_monty_np(next(it)).reshape(num_queries, -1)
                     .tolist() for _ in range(n_mats)]
        sib_levels = [mmcs.digests_std(next(it)) for _ in range(levels)]
        input_openings.append(BatchMultiOpening(
            opened_values=[[mat_lists[k][q] for k in range(n_mats)]
                           for q in range(num_queries)],
            opening_proof=_pruned_wire(tree_indices, levels, sib_levels)))

    commit_phase_steps = []
    qidx = list(indices)
    for log_arity, levels in zip(log_arities, meta["fri_tree_levels"]):
        arity = 1 << log_arity
        row_indices = [i >> log_arity for i in qidx]
        rows = F.from_monty_np(next(it)).reshape(
            num_queries, arity, E.D).tolist()
        sib_levels = [fri_mmcs.digests_std(next(it)) for _ in range(levels)]
        sibs = [[tuple(g) for j, g in enumerate(grp) if j != idx % arity]
                for idx, grp in zip(qidx, rows)]
        commit_phase_steps.append(CommitPhaseStep(
            log_arity=log_arity, sibling_values=sibs,
            opening_proof=_pruned_wire(row_indices, levels, sib_levels)))
        qidx = row_indices

    fri_proof = FriProof(
        commit_phase_commits=fri_commits,
        commit_pow_witnesses=commit_pows,
        input_openings=input_openings,
        commit_phase_steps=commit_phase_steps,
        final_poly=final_poly,
        query_pow_witness=witness,
    )
    mark("proof assembly")
    return Proof(
        commitments=Commitments(trace=trace_root,
                                quotient_chunks=quotient_root),
        opened_values=OpenedValues(
            trace_local=trace_vals[0],
            trace_next=trace_vals[1] if uses_next else None,
            quotient_chunks=chunk_vals),
        opening_proof=fri_proof,
        degree_bits=meta["log_n"],
    )


def _digest_wire(mmcs, a):
    """A pulled commitment -> wire form: a root's 8 ints, or a cap's
    digests as nested tuples."""
    a = mmcs.digests_std(a)
    if a.ndim == 1:
        return tuple(int(x) for x in a)
    return tuple(tuple(int(x) for x in row) for row in a)
