"""The canonical batch STARK of plonky3_tpu_torch against plonky3_tpu's
(`stark/batch_ref.py`), on the batch golden fixture's case
(`tests/test_batch_fixture.py::_case`: MulAirLookups and FibAirLookups at
32 rows on the shared "MulFib" bus, FibAirLookups' preprocessed index
column, `batch_two_adic_fixture_config`), with MulAirLookups' local
lookup off and on: keygen's plans, chunk counts and preprocessed
commitment, the permutation trace's words and the proof equal the JAX
package's, and each verifier accepts the other's proof and rejects the
same tampers alike. A JoinedAir whose sub-builder carries the bus
(MulAirLookups beside a FibonacciAir) is proven by the port and accepted
by both verifiers."""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plonky3_tpu.air.composition import JoinedAir as JJoinedAir
from plonky3_tpu.compat import batch_fixture_airs as j_airs
from plonky3_tpu.compat.fixture_configs import (
    batch_two_adic_fixture_config as j_fixture_config)
from plonky3_tpu.fields import BabyBear as JF
from plonky3_tpu.fields import BabyBearExt4 as JE
from plonky3_tpu.models.fibonacci import FibonacciAir as JFibonacciAir
from plonky3_tpu.models.fibonacci import (
    generate_fibonacci_trace as j_fibonacci_trace)
from plonky3_tpu.stark import batch as j_batch
from plonky3_tpu.stark import batch_ref as j_br
from plonky3_tpu_torch.air.composition import JoinedAir
from plonky3_tpu_torch.compat import batch_fixture_airs as airs_mod
from plonky3_tpu_torch.compat.fixture_configs import (
    batch_two_adic_fixture_config)
from plonky3_tpu_torch.fields import BabyBear as F
from plonky3_tpu_torch.fields import BabyBearExt4 as E
from plonky3_tpu_torch.models.fibonacci import FibonacciAir
from plonky3_tpu_torch.stark import batch
from plonky3_tpu_torch.stark import batch_ref as br
from test_torch_prove import _raised, as_plain, to_port, to_reference

LOG_N = 5


def _airs(port, is_local, joined=False):
    mod, field = (airs_mod, F) if port else (j_airs, JF)
    mul = mod.MulAirLookups(field, reps=2, is_local=is_local,
                            is_global=True)
    if joined:
        fib = FibonacciAir(field) if port else JFibonacciAir(field)
        mul = (JoinedAir if port else JJoinedAir)(mul, fib)
    return [mul, mod.FibAirLookups(field, log_height=LOG_N)]


def _traces(joined=False):
    """Standard-form uint32 traces and public values of the two
    instances (the reference's own trace builders)."""
    mt = j_airs.mul_trace(JF, 1 << LOG_N, 2)
    ft, fpis = j_fibonacci_trace(JF, LOG_N)
    if joined:
        mt = np.concatenate([mt, ft], axis=1)
        return [mt, ft], [fpis, fpis]
    return [mt, ft], [[], fpis]


def _instances(port, is_local, joined=False):
    traces, pvs = _traces(joined)
    out = []
    for air, t, pv in zip(_airs(port, is_local, joined), traces, pvs):
        if port:
            out.append(batch.BatchInstance(air, torch.from_numpy(
                F.to_monty_np(t).astype(np.int64)), pv))
        else:
            out.append(j_batch.BatchInstance(
                air, jnp.asarray(JF.to_monty_np(t)), pv))
    return out


def _to_reference(proof):
    bad = copy.copy(proof)
    return j_br.BatchRefProof(
        main_commit=bad.main_commit,
        permutation_commit=bad.permutation_commit,
        quotient_commit=bad.quotient_commit,
        instances=[j_br.BatchRefOpened(**vars(i)) for i in bad.instances],
        opening_proof=to_reference(bad.opening_proof),
        lookup_terminals=list(bad.lookup_terminals),
        degree_bits=list(bad.degree_bits))


def _to_port(proof):
    return br.BatchRefProof(
        main_commit=proof.main_commit,
        permutation_commit=proof.permutation_commit,
        quotient_commit=proof.quotient_commit,
        instances=[br.BatchRefOpened(**vars(i)) for i in proof.instances],
        opening_proof=to_port(proof.opening_proof),
        lookup_terminals=list(proof.lookup_terminals),
        degree_bits=list(proof.degree_bits))


@pytest.fixture(scope="module")
def setups():
    """Per case: both configs, keygens and proofs (the joined case: the
    port's proof only)."""
    out = {}
    for case in ("global", "local", "joined"):
        is_local, joined = case == "local", case == "joined"
        j_cfg = j_fixture_config()
        cfg = batch_two_adic_fixture_config(device="cpu")
        j_common = j_br.keygen(j_cfg, _airs(False, is_local, joined),
                               [LOG_N, LOG_N])
        common = br.keygen(cfg, _airs(True, is_local, joined),
                           [LOG_N, LOG_N])
        ref = (None if joined else j_br.prove_batch_ref(
            j_cfg, _instances(False, is_local), j_common))
        ours = br.prove_batch_ref(cfg, _instances(True, is_local, joined),
                                  common)
        out[case] = dict(j_cfg=j_cfg, cfg=cfg, j_common=j_common,
                         common=common, ref=ref, ours=ours,
                         is_local=is_local, joined=joined,
                         publics=_traces(joined)[1])
    return out


CASES = ["global", "local", "joined"]


@pytest.mark.parametrize("case", CASES)
def test_keygen_equals_reference(setups, case):
    s = setups[case]
    ours, ref = s["common"], s["j_common"]
    assert ours.plans == ref.plans
    assert ours.log_chunks == ref.log_chunks
    assert ours.prep_meta == ref.prep_meta
    assert ours.matrix_to_instance == ref.matrix_to_instance == [1]
    assert ours.prep_data.commitment == ref.prep_data.commitment


@pytest.mark.parametrize("budget", [2, 3, 5, 9])
@pytest.mark.parametrize("is_local", [False, True])
def test_pack_plan_equals_reference(budget, is_local):
    air = _airs(True, is_local)[0]
    j_air = _airs(False, is_local)[0]
    got = br.pack_plan(br._collect_sym(air)[1], budget)
    want = j_br.pack_plan(j_br._collect_sym(j_air)[1], budget)
    assert got == want
    assert (br.layout_with_lookups(air, E, got)
            == j_br.layout_with_lookups(j_air, JE, want))


@pytest.mark.parametrize("case", CASES)
def test_perm_trace_equals_reference(setups, case):
    """Every instance's permutation trace for one set of challenges, on
    the device against the reference's host build."""
    s = setups[case]
    traces, pvs = _traces(s["joined"])
    airs = _airs(True, s["is_local"], s["joined"])
    j_airs_ = _airs(False, s["is_local"], s["joined"])
    bus_ids, num_buses, max_w = br.assign_buses(
        [br._collect_sym(a)[1] for a in airs], s["common"].plans)
    assert (bus_ids, num_buses, max_w) == j_br.assign_buses(
        [j_br._collect_sym(a)[1] for a in j_airs_], s["j_common"].plans)
    prefixes = br.bus_prefixes(E, (1, 2, 3, 4), (5, 6, 7, 8), max_w,
                               num_buses)
    assert prefixes == j_br.bus_prefixes(JE, (1, 2, 3, 4), (5, 6, 7, 8),
                                         max_w, num_buses)
    for i, (air, j_air, t, pv) in enumerate(zip(airs, j_airs_, traces,
                                               pvs)):
        chal = [(prefixes[b], (5, 6, 7, 8)) for b in bus_ids[i]]
        aux, term = br.generate_perm_trace(
            E, air, torch.from_numpy(F.to_monty_np(t).astype(np.int64)),
            pv, s["common"].plans[i], chal)
        j_aux, j_term = j_br.generate_perm_trace(
            JE, j_air, t, pv, s["j_common"].plans[i], chal)
        assert np.array_equal(F.from_monty_np(aux.numpy()), j_aux)
        assert term == j_term


@pytest.mark.parametrize("case", ["global", "local"])
def test_proof_equals_reference(setups, case):
    s = setups[case]
    assert as_plain(s["ours"]) == as_plain(s["ref"])
    assert s["ours"].degree_bits == [LOG_N, LOG_N]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("which", ["port", "reference"])
def test_each_verifier_accepts(setups, case, which):
    s = setups[case]
    if which == "port":
        proof = s["ours"] if s["ref"] is None else _to_port(s["ref"])
        br.verify_batch_ref(s["cfg"], _airs(True, s["is_local"],
                                            s["joined"]),
                            proof, s["publics"], s["common"])
    else:
        j_br.verify_batch_ref(s["j_cfg"], _airs(False, s["is_local"],
                                                s["joined"]),
                              _to_reference(s["ours"]), s["publics"],
                              s["j_common"])


def _bump(v):
    return tuple((x + 1) % F.P for x in v)


def _tampered(proof, name):
    bad = copy.deepcopy(proof)
    inst = bad.instances[0]
    if name == "terminal":
        bad.lookup_terminals[0] = _bump(bad.lookup_terminals[0])
    elif name == "shifted_terminals":
        t0, t1 = bad.lookup_terminals
        bad.lookup_terminals = [_bump(t0), tuple((y - 1) % F.P for y in t1)]
    elif name == "permutation_local":
        inst.permutation_local = list(inst.permutation_local)
        inst.permutation_local[0] = _bump(inst.permutation_local[0])
    elif name == "trace_local":
        inst.trace_local = list(inst.trace_local)
        inst.trace_local[0] = _bump(inst.trace_local[0])
    elif name == "preprocessed_local":
        inst = bad.instances[1]
        inst.preprocessed_local = [_bump(inst.preprocessed_local[0])]
    return bad


@pytest.mark.parametrize("name", ["terminal", "shifted_terminals",
                                  "permutation_local", "trace_local",
                                  "preprocessed_local"])
def test_tampered_proof_rejected_as_reference(setups, name):
    s = setups["global"]
    bad = _tampered(s["ours"], name)
    got = _raised(lambda: br.verify_batch_ref(
        s["cfg"], _airs(True, False), bad, s["publics"], s["common"]))
    want = _raised(lambda: j_br.verify_batch_ref(
        s["j_cfg"], _airs(False, False), _to_reference(bad), s["publics"],
        s["j_common"]))
    assert got == want
    assert got[0] == "VerificationError"
