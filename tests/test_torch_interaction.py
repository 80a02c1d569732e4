"""Lookup buses across batch instances in plonky3_tpu_torch against
plonky3_tpu's (`stark/interaction.py`), with the reference test's AIRs
(`tests/torch_bus_airs.py`) under the Poseidon2 config at 16 rows: the
range lookup (queries into a table with multiplicities) and the
permutation check (sends against receives), the two buses in one batch
of four instances (one cold JAX prove). The device-built auxiliary trace
equals the reference's host build word for word; the proof equals the
JAX package's and each verifier accepts the other's; an unbalanced bus,
shifted terminals and a changed opened permutation value are rejected by
both verifiers with the same error class and message."""

import copy
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plonky3_tpu.air.api import BaseAir as JBaseAir
from plonky3_tpu.fields import KoalaBear as JF
from plonky3_tpu.fields import KoalaBearExt4 as JE
from plonky3_tpu.fri.config import FriParameters as JFriParameters
from plonky3_tpu.stark import batch as j_batch
from plonky3_tpu.stark import interaction as j_inter
from plonky3_tpu.stark.config import poseidon2_stark_config as j_config
from plonky3_tpu_torch.air.api import BaseAir
from plonky3_tpu_torch.compat import fri_params_from
from plonky3_tpu_torch.fields import KoalaBear as F
from plonky3_tpu_torch.fields import KoalaBearExt4 as E
from plonky3_tpu_torch.stark import batch, interaction
from plonky3_tpu_torch.stark.config import poseidon2_stark_config
from test_torch_batch import batch_to_reference
from test_torch_prove import _raised, as_plain, to_port
from torch_bus_airs import bus_airs, lookup_traces, permutation_traces

PARAMS = JFriParameters.new_testing()
AIRS = bus_airs(BaseAir, interaction.LookupBus,
                interaction.PermutationCheckBus)
J_AIRS = bus_airs(JBaseAir, j_inter.LookupBus, j_inter.PermutationCheckBus)
CASES = {
    "lookup": (("QueryAir", "TableAir"),
               lambda bad: lookup_traces(11, 4, unbalanced=bad)),
    "permutation": (("SendAir", "RecvAir"),
                    lambda bad: permutation_traces(12, 4, F.P, bad)),
}
NAMES = CASES["lookup"][0] + CASES["permutation"][0]


def _traces(unbalanced):
    """The four instances' traces; `unbalanced` breaks the pipe bus."""
    return (CASES["lookup"][1](False)
            + CASES["permutation"][1](unbalanced))


def _instances(port, unbalanced=False):
    out = []
    for name, t in zip(NAMES, _traces(unbalanced)):
        if port:
            out.append(batch.BatchInstance(
                AIRS[name](F), torch.from_numpy(
                    F.to_monty_np(t).astype(np.int64)), []))
        else:
            out.append(j_batch.BatchInstance(
                J_AIRS[name](JF), jnp.asarray(JF.to_monty_np(t)), []))
    return out


def to_reference_proof(proof):
    return j_inter.BatchLookupProof(
        base=batch_to_reference(proof.base), perm_commit=proof.perm_commit,
        opened_perm=proof.opened_perm, terminals=list(proof.terminals))


def to_port_proof(proof):
    base = batch.BatchProof(**{
        f.name: (to_port(getattr(proof.base, f.name))
                 if f.name == "opening_proof"
                 else getattr(proof.base, f.name))
        for f in dataclasses.fields(proof.base)})
    return interaction.BatchLookupProof(
        base=base, perm_commit=proof.perm_commit,
        opened_perm=proof.opened_perm, terminals=list(proof.terminals))


@pytest.fixture(scope="module")
def configs():
    return (j_config(JF, JE, PARAMS),
            poseidon2_stark_config(F, E, fri_params_from(PARAMS),
                                   device="cpu"))


@pytest.fixture(scope="module")
def proofs(configs):
    """The reference's proof and the port's of the balanced batch, and
    the port's of the unbalanced one."""
    j_cfg, cfg = configs
    return dict(
        ref=j_inter.prove_batch_with_lookups(j_cfg, _instances(False)),
        ours=interaction.prove_batch_with_lookups(cfg, _instances(True)),
        unbalanced=interaction.prove_batch_with_lookups(
            cfg, _instances(True, unbalanced=True)))


PUBLICS = [[], [], [], []]


def test_proof_equals_reference(proofs):
    assert as_plain(proofs["ours"]) == as_plain(proofs["ref"])
    assert proofs["ours"].base.degree_bits == [4, 4, 4, 4]


@pytest.mark.parametrize("which", ["port", "reference"])
def test_each_verifier_accepts_the_other(configs, proofs, which):
    j_cfg, cfg = configs
    if which == "port":
        interaction.verify_batch_with_lookups(
            cfg, [AIRS[n](F) for n in NAMES], to_port_proof(proofs["ref"]),
            PUBLICS)
    else:
        j_inter.verify_batch_with_lookups(
            j_cfg, [J_AIRS[n](JF) for n in NAMES],
            to_reference_proof(proofs["ours"]), PUBLICS)


@pytest.mark.parametrize("case", ["lookup", "permutation"])
def test_interaction_trace_equals_reference(case):
    """The auxiliary trace of every instance, for one set of challenges,
    word for word (the reference's is standard form on the host); the
    terminals sum to zero (the lookup's with one count raised: its
    table's entry 0 counts one query more, and they do not)."""
    names, traces = CASES[case]
    airs = [AIRS[n](F) for n in names]
    j_airs = [J_AIRS[n](JF) for n in names]
    bus_index = interaction.bus_index_map(airs)
    assert bus_index == j_inter.bus_index_map(j_airs)
    ch = interaction.Challenges.new(E, (1, 2, 3, 4), (5, 6, 7, 8), 8,
                                    len(bus_index))
    j_ch = j_inter.Challenges.new(JE, (1, 2, 3, 4), (5, 6, 7, 8), 8,
                                  len(bus_index))
    total = E.zero_h()
    for air, j_air, t in zip(airs, j_airs, traces(case == "lookup")):
        aux, term = interaction.generate_interaction_trace(
            E, air, torch.from_numpy(F.to_monty_np(t).astype(np.int64)),
            [], ch, bus_index)
        j_aux, j_term = j_inter.generate_interaction_trace(
            JE, j_air, t, [], j_ch, bus_index)
        assert np.array_equal(F.from_monty_np(aux.numpy()), j_aux)
        assert term == j_term
        total = E.add_h(total, term)
    assert (total == E.zero_h()) == (case == "permutation")


def _tampered(proofs, tamper):
    if tamper == "unbalanced":
        return proofs["unbalanced"]
    bad = copy.deepcopy(proofs["ours"])
    if tamper == "shifted_terminals":
        # the sum stays zero, the committed values no longer match
        t0, t1 = bad.terminals[:2]
        bad.terminals[0] = tuple((x + 1) % F.P for x in t0)
        bad.terminals[1] = tuple((y - 1) % F.P for y in t1)
    else:
        lo, nx = bad.opened_perm[1]
        lo = list(lo)
        lo[0] = tuple((x + 1) % F.P for x in lo[0])
        bad.opened_perm[1] = (lo, nx)
    return bad


@pytest.mark.parametrize("tamper", ["unbalanced", "shifted_terminals",
                                    "opened_perm"])
def test_rejected_as_reference(configs, proofs, tamper):
    j_cfg, cfg = configs
    bad = _tampered(proofs, tamper)
    got = _raised(lambda: interaction.verify_batch_with_lookups(
        cfg, [AIRS[n](F) for n in NAMES], bad, PUBLICS))
    want = _raised(lambda: j_inter.verify_batch_with_lookups(
        j_cfg, [J_AIRS[n](JF) for n in NAMES], to_reference_proof(bad),
        PUBLICS))
    assert got == want
    assert got[0] == "VerificationError"
