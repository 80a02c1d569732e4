"""plonky3_tpu_torch on the card: each CUDA kernel against its plain
version, and proofs of both configs on CUDA against the same proofs on
the CPU.

These need an NVIDIA GPU and skip without one. On the card, where JAX is
not installed, run them without the JAX test configuration:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from plonky3_tpu_torch.fields import KoalaBear as F
from plonky3_tpu_torch.fields import KoalaBearExt4 as E

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _words(rng, shape, bound, device):
    x = rng.integers(0, bound, size=shape, dtype=np.uint64).astype(np.int64)
    return torch.from_numpy(x).to(torch.int32).to(device)


@pytest.mark.parametrize("log_n,w,inverse,zero_top", [
    (1, 3, False, False), (2, 1, True, False), (7, 33, False, True),
    (10, 64, True, False), (11, 5, False, True), (21, 2, False, True),
    (13, 2633, True, False), (14, 2633, False, True)])
def test_ntt_kernels_match_plain(cuda, log_n, w, inverse, zero_top):
    from plonky3_tpu_torch.ops.ntt_cuda import dif_fused, dif_fused_plain

    rows = (1 << log_n) >> 1 if zero_top else 1 << log_n
    x = _words(np.random.default_rng(log_n), (rows, w), F.P, cuda)
    got = dif_fused(F, x, log_n, inverse, zero_top)
    want = dif_fused_plain(F, x, log_n, inverse, zero_top)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("h,w", [(1, 1), (33, 34), (100, 35), (64, 1312),
                                 (300, 2633)])
def test_keccak_kernels_match_plain(cuda, h, w):
    from plonky3_tpu_torch.hashes import keccak_cuda as kc

    rng = np.random.default_rng(w)
    flat = _words(rng, (h, w), F.P, cuda)
    assert torch.equal(kc.keccak_sponge_rows(flat),
                       kc.keccak_sponge_rows_plain(flat))
    left = _words(rng, (h, 8), 1 << 32, cuda)
    right = _words(rng, (h, 8), 1 << 32, cuda)
    got = kc.keccak_compress(left, right)
    torch.cuda.synchronize()
    assert torch.equal(got, kc.keccak_compress_plain(left, right))


@pytest.mark.parametrize("log_n", [1, 5, 11])
def test_merkle_ladder_matches_plain(cuda, log_n):
    from plonky3_tpu_torch import kernels
    from plonky3_tpu_torch.hashes import keccak_cuda as kc

    d = _words(np.random.default_rng(log_n), (1 << log_n, 8), 1 << 32, cuda)
    before = kernels.LAUNCHES["keccak_ladder"]
    got = kc.keccak_merkle_ladder(d)
    torch.cuda.synchronize()
    assert (kernels.LAUNCHES["keccak_ladder"] - before
            == len(kc.ladder_plan(1 << log_n)))
    assert torch.equal(got, kc.keccak_merkle_ladder_plain(d))


def test_mixed_height_commit_equals_cpu(cuda):
    from plonky3_tpu_torch import kernels
    from plonky3_tpu_torch.hashes.keccak_sponge import (
        KeccakCompressor,
        KeccakFieldSponge,
    )
    from plonky3_tpu_torch.merkle.mmcs import MerkleTreeMmcs

    rng = np.random.default_rng(40)
    mats = [F.rand_np(rng, s).astype(np.int64)
            for s in [(32, 3), (32, 4), (8, 7), (2, 1)]]
    mmcs = MerkleTreeMmcs(KeccakFieldSponge(F), KeccakCompressor())
    before = kernels.LAUNCHES["keccak_compress"]
    got = mmcs.commit([torch.from_numpy(m).to(cuda) for m in mats])
    assert kernels.LAUNCHES["keccak_compress"] - before == 2
    want = mmcs.commit([torch.from_numpy(m) for m in mats])
    assert got.commitment == want.commitment
    assert all(torch.equal(g.cpu(), w)
               for g, w in zip(got.layers, want.layers))


def test_cuda_proof_equals_cpu_proof(cuda):
    import dataclasses

    from plonky3_tpu_torch.fri.config import FriParameters
    from plonky3_tpu_torch.models.poseidon2_air import (
        Poseidon2VectorAir,
        generate_vectorized_trace,
    )
    from plonky3_tpu_torch.stark.config import keccak_stark_config
    from plonky3_tpu_torch.stark.prover import prove

    params = FriParameters(log_blowup=1, log_final_poly_len=0,
                           max_log_arity=3, num_queries=10,
                           commit_proof_of_work_bits=0,
                           query_proof_of_work_bits=8)
    air = Poseidon2VectorAir(F, 16, vector_len=1)
    inputs = F.rand_np(np.random.default_rng(3), (64, 16))
    out = []
    for dev in (cuda, torch.device("cpu")):
        trace, _ = generate_vectorized_trace(air, inputs, device=dev)
        cfg = keccak_stark_config(F, E, params, device=dev)
        out.append(dataclasses.astuple(prove(cfg, air, trace, [])))
    assert out[0] == out[1]


@pytest.mark.parametrize("n,k", [(0, 1), (1, 2), (33, 1), (34, 13),
                                 (35, 2), (10536, 2)])
def test_keccak256_chain_matches_plain(cuda, n, k):
    from plonky3_tpu_torch import kernels
    from plonky3_tpu_torch.hashes import keccak_cuda as kc

    words = _words(np.random.default_rng(n), (n,), 1 << 32, cuda)
    before = kernels.LAUNCHES["keccak256_chain"]
    got = kc.keccak256_chain(words, k)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["keccak256_chain"] - before == 1
    assert torch.equal(got, kc.keccak256_chain_plain(words, k))


# a grind's witness past the first round of the persistent grid: above
# 2^16, more threads than SMs x resident blocks x 128 hold on an H100
PAST_FIRST_ROUND = 1 << 16


@pytest.mark.parametrize("m,pow_bits", [(18, 1), (18, 2), (18, 16),
                                        (33, 4), (40, 8), (40, 12),
                                        (18, 17), (33, 16)])
def test_keccak_grind_matches_plain(cuda, m, pow_bits):
    """pow_bits 1 and 2: many candidates of the first round pass, and the
    smallest must win whatever the order of the blocks; (18, 17): a
    witness past the first round; m = 33: the padding opens a block. Each
    case runs two grinds back to back on one stream, one launch each."""
    from plonky3_tpu_torch import kernels
    from plonky3_tpu_torch.hashes import keccak_cuda as kc

    rng = np.random.default_rng(m + pow_bits)
    words, other = (_words(rng, (m,), 1 << 32, cuda) for _ in range(2))
    before = kernels.LAUNCHES["keccak_grind"]
    got = kc.keccak_grind(words, pow_bits, F.P)
    assert kernels.LAUNCHES["keccak_grind"] - before == 1
    again = kc.keccak_grind(other, pow_bits, F.P)
    assert kernels.LAUNCHES["keccak_grind"] - before == 2
    torch.cuda.synchronize()
    assert torch.equal(got, kc.keccak_grind_plain(words, pow_bits, F.P))
    assert torch.equal(again, kc.keccak_grind_plain(other, pow_bits, F.P))
    if (m, pow_bits) == (18, 17):
        assert int(got[0]) > PAST_FIRST_ROUND


@pytest.mark.parametrize("n", [0, 1, 15, 16, 17, 10528])
def test_poseidon2_duplex_chain_matches_plain(cuda, n):
    from plonky3_tpu_torch import kernels
    from plonky3_tpu_torch.hashes import poseidon2_cuda as pc
    from plonky3_tpu_torch.hashes.poseidon2 import default_poseidon2

    perm = default_poseidon2(F, 24)
    rng = np.random.default_rng(n)
    state, words = _words(rng, (24,), F.P, cuda), _words(rng, (n,), F.P, cuda)
    before = kernels.LAUNCHES["poseidon2_duplex_chain"]
    got = pc.poseidon2_duplex_chain(perm, state, words)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["poseidon2_duplex_chain"] - before == 1
    assert torch.equal(got, pc.poseidon2_duplex_chain_plain(perm, state,
                                                            words))


@pytest.mark.parametrize("n1,n2", [(17, 15), (10528, 16), (0, 33)])
def test_poseidon2_duplex_chain_twice_on_one_state(cuda, n1, n2):
    """Two chains one after the other, the second absorbing into the state
    the first left, as the transcript calls them."""
    from plonky3_tpu_torch.hashes import poseidon2_cuda as pc
    from plonky3_tpu_torch.hashes.poseidon2 import default_poseidon2

    perm = default_poseidon2(F, 24)
    rng = np.random.default_rng(n1 + n2)
    state = _words(rng, (24,), F.P, cuda)
    w1, w2 = _words(rng, (n1,), F.P, cuda), _words(rng, (n2,), F.P, cuda)
    got = pc.poseidon2_duplex_chain(
        perm, pc.poseidon2_duplex_chain(perm, state, w1), w2)
    torch.cuda.synchronize()
    want = pc.poseidon2_duplex_chain_plain(
        perm, pc.poseidon2_duplex_chain_plain(perm, state, w1), w2)
    assert torch.equal(got, want)


@pytest.mark.parametrize("lane,pow_bits", [(0, 1), (5, 2), (15, 12),
                                           (3, 16), (15, 1), (10, 17)])
def test_poseidon2_grind_matches_plain(cuda, lane, pow_bits):
    """(10, 17): a witness past the first round of the grid. Each case runs
    two grinds back to back on one stream, one launch each."""
    from plonky3_tpu_torch import kernels
    from plonky3_tpu_torch.hashes import poseidon2_cuda as pc
    from plonky3_tpu_torch.hashes.poseidon2 import default_poseidon2

    perm = default_poseidon2(F, 24)
    rng = np.random.default_rng(lane)
    base, other = (_words(rng, (24,), F.P, cuda) for _ in range(2))
    before = kernels.LAUNCHES["poseidon2_grind"]
    got = pc.poseidon2_grind(perm, base, lane, pow_bits)
    assert kernels.LAUNCHES["poseidon2_grind"] - before == 1
    again = pc.poseidon2_grind(perm, other, lane, pow_bits)
    assert kernels.LAUNCHES["poseidon2_grind"] - before == 2
    torch.cuda.synchronize()
    assert torch.equal(got, pc.poseidon2_grind_plain(perm, base, lane,
                                                     pow_bits))
    assert torch.equal(again, pc.poseidon2_grind_plain(perm, other, lane,
                                                       pow_bits))
    if (lane, pow_bits) == (10, 17):
        assert int(got[0]) > PAST_FIRST_ROUND


def _configs():
    from plonky3_tpu_torch.stark import config

    return {"keccak": (config.keccak_stark_config, "keccak_grind"),
            "poseidon2": (config.poseidon2_stark_config, "poseidon2_grind")}


@pytest.mark.parametrize("kind", ["keccak", "poseidon2"])
def test_cuda_fast_proof_equals_cpu(cuda, kind):
    """The device-transcript prover on CUDA gives the CPU's proof, which
    equals prove()'s, with one device-to-host copy and one grind."""
    from plonky3_tpu_torch import kernels
    from plonky3_tpu_torch.fri.config import FriParameters
    from plonky3_tpu_torch.models.poseidon2_air import (
        Poseidon2VectorAir,
        generate_vectorized_trace,
    )
    from plonky3_tpu_torch.stark import fast_prover
    from plonky3_tpu_torch.stark.prover import prove

    make_config, grind = _configs()[kind]

    params = FriParameters(log_blowup=1, log_final_poly_len=0,
                           max_log_arity=3, num_queries=10,
                           commit_proof_of_work_bits=0,
                           query_proof_of_work_bits=8)
    air = Poseidon2VectorAir(F, 16, vector_len=1)
    inputs = F.rand_np(np.random.default_rng(3), (64, 16))
    out = {}
    for dev in (cuda, torch.device("cpu")):
        trace, _ = generate_vectorized_trace(air, inputs, device=dev)
        cfg = make_config(F, E, params, device=dev)
        before = (fast_prover.PULLS["count"], kernels.LAUNCHES[grind])
        out[dev.type] = fast_prover._prove_device_fs(cfg, air, trace, [])
        if dev.type == "cuda":
            assert fast_prover.PULLS["count"] - before[0] == 1
            assert kernels.LAUNCHES[grind] - before[1] == 1
        out[dev.type + "_prove"] = prove(cfg, air, trace, [])
    assert out["cuda"] == out["cpu"] == out["cpu_prove"] == out["cuda_prove"]


@pytest.mark.parametrize("kind", ["keccak", "poseidon2"])
def test_prove_fast_on_cuda_never_falls_back(cuda, monkeypatch, kind):
    """Out of the device path's scope, prove_fast on a CUDA trace raises
    instead of proving with the host transcript."""
    from plonky3_tpu_torch.fri.config import FriParameters
    from plonky3_tpu_torch.models.poseidon2_air import (
        Poseidon2VectorAir,
        generate_vectorized_trace,
    )
    from plonky3_tpu_torch.stark import fast_prover

    def unsupported(*args, **kw):
        raise fast_prover._Unsupported("out of scope")

    params = FriParameters(log_blowup=1, log_final_poly_len=0,
                           max_log_arity=3, num_queries=10,
                           commit_proof_of_work_bits=0,
                           query_proof_of_work_bits=8)
    air = Poseidon2VectorAir(F, 16, vector_len=1)
    inputs = F.rand_np(np.random.default_rng(3), (64, 16))
    trace, _ = generate_vectorized_trace(air, inputs, device=cuda)
    cfg = _configs()[kind][0](F, E, params, device=cuda)
    monkeypatch.setattr(fast_prover, "_prove_device_fs", unsupported)
    with pytest.raises(fast_prover._Unsupported):
        fast_prover.prove_fast(cfg, air, trace, [])


@pytest.mark.parametrize("name", ["fibonacci", "keccak"])
def test_cuda_generic_air_proofs_equal_cpu(cuda, name):
    """The generic quotient path on the card: both provers' proofs of
    FibonacciAir (2^8 rows) and KeccakAir (10 permutations, 256 rows) on
    CUDA equal both on the CPU, and the port's verifier accepts them."""
    from plonky3_tpu_torch.fri.config import FriParameters
    from plonky3_tpu_torch.models.fibonacci import (
        FibonacciAir,
        generate_fibonacci_trace,
    )
    from plonky3_tpu_torch.models.keccak_air import (
        KeccakAir,
        generate_keccak_trace,
    )
    from plonky3_tpu_torch.stark import fast_prover
    from plonky3_tpu_torch.stark.config import keccak_stark_config
    from plonky3_tpu_torch.stark.prover import prove
    from plonky3_tpu_torch.stark.verifier import verify

    params = FriParameters(log_blowup=1, log_final_poly_len=0,
                           max_log_arity=3, num_queries=10,
                           commit_proof_of_work_bits=0,
                           query_proof_of_work_bits=8)
    inputs = np.random.default_rng(5).integers(
        0, 1 << 64, size=(10, 25), dtype=np.uint64)
    out = []
    for dev in (cuda, torch.device("cpu")):
        if name == "fibonacci":
            air = FibonacciAir(F)
            trace, publics = generate_fibonacci_trace(F, 8, device=dev)
        else:
            air, publics = KeccakAir(F), []
            trace = generate_keccak_trace(F, inputs, device=dev)
        cfg = keccak_stark_config(F, E, params, device=dev)
        for fn in (prove, fast_prover._prove_device_fs):
            proof = fn(cfg, air, trace, publics)
            verify(cfg, air, proof, publics)
            out.append(proof)
    assert all(p == out[0] for p in out)


def _small_params():
    from plonky3_tpu_torch.fri.config import FriParameters

    return FriParameters(log_blowup=1, log_final_poly_len=0,
                         max_log_arity=3, num_queries=10,
                         commit_proof_of_work_bits=0,
                         query_proof_of_work_bits=8)


@pytest.mark.parametrize("name", ["blake3", "periodic", "no_next_row"])
def test_cuda_blake3_and_periodic_proofs_equal_cpu(cuda, name):
    """Blake3Air (8 rows, 9,168 columns) and the periodic AIRs (32 rows;
    NoNextRowAir folds in the bit-reversed order): both provers' proofs
    on CUDA equal both on the CPU, and the port's verifier accepts
    them."""
    from plonky3_tpu_torch.models.blake3_air import (
        Blake3Air,
        generate_blake3_trace,
    )
    from plonky3_tpu_torch.stark import fast_prover
    from plonky3_tpu_torch.stark.config import keccak_stark_config
    from plonky3_tpu_torch.stark.prover import prove
    from plonky3_tpu_torch.stark.verifier import verify
    from torch_periodic_airs import NoNextRowAir, PeriodicAir, periodic_trace

    out = []
    for dev in (cuda, torch.device("cpu")):
        if name == "blake3":
            air = Blake3Air(F)
            inputs = np.random.default_rng(3).integers(
                0, 1 << 32, size=(8, 24), dtype=np.uint64).astype(np.uint32)
            trace = generate_blake3_trace(F, inputs, device=dev,
                                          block_rows=2)
        else:
            air = PeriodicAir(F) if name == "periodic" else NoNextRowAir(F)
            rows = F.to_monty_np(periodic_trace(F.P, 32))
            trace = torch.from_numpy(rows.astype(np.int64)).to(dev)
        cfg = keccak_stark_config(F, E, _small_params(), device=dev)
        for fn in (prove, fast_prover._prove_device_fs):
            proof = fn(cfg, air, trace, [])
            verify(cfg, air, proof, [])
            out.append(proof)
    assert all(p == out[0] for p in out)


@pytest.mark.parametrize("name", ["keccak", "no_next_row"])
def test_cuda_blocked_fold_equals_cpu(cuda, name):
    """The quotient from the committed LDE on CUDA, in one block, two and
    eight, equals the CPU's whole-domain fold."""
    from plonky3_tpu_torch.air.api import (
        get_log_num_quotient_chunks,
        get_symbolic_layout,
    )
    from plonky3_tpu_torch.models.keccak_air import (
        KeccakAir,
        generate_keccak_trace,
    )
    from plonky3_tpu_torch.stark import prover
    from plonky3_tpu_torch.stark.config import keccak_stark_config
    from torch_periodic_airs import NoNextRowAir, periodic_trace

    rng = np.random.default_rng(8)
    if name == "keccak":
        air = KeccakAir(F)
        inputs = rng.integers(0, 1 << 64, size=(2, 25), dtype=np.uint64)
        trace = generate_keccak_trace(F, inputs, device="cpu")
    else:
        air = NoNextRowAir(F)
        trace = torch.from_numpy(F.to_monty_np(
            periodic_trace(F.P, 32)).astype(np.int64))
    k, _ = get_symbolic_layout(air)
    pows = torch.from_numpy(F.rand_np(rng, (k, E.D)).astype(np.int64))
    got = {}
    for dev in (torch.device("cpu"), cuda):
        cfg = keccak_stark_config(F, E, _small_params(), device=dev)
        n = trace.shape[0]
        domain = cfg.pcs.natural_domain_for_degree(n)
        qd = domain.create_disjoint_domain(
            n << get_log_num_quotient_chunks(air))
        data = cfg.pcs.commit([(domain, trace.to(dev))])
        prefix = cfg.pcs.get_evaluations_on_domain(data, 0, qd, "bitrev")
        sizes = [qd.size] if dev.type == "cpu" else [qd.size, qd.size // 2,
                                                     qd.size // 8]
        for rows in sizes:
            q = prover.committed_quotient(
                cfg, air, domain, qd, prefix,
                torch.zeros(0, dtype=torch.int64, device=dev),
                pows.to(dev), block_rows=rows)
            got[dev.type, rows] = q.cpu()
    want = got["cpu", qd.size]
    assert all(torch.equal(q, want) for q in got.values())


# BabyBear: the duplex kernels' <21, 7> instantiation (21 internal rounds,
# s-box x^7); 19,104 words is the alpha2 absorb of Poseidon2VectorAir
# (BabyBear, 16, 8), 2 · 2,384 · 4 + 2 · 4 · 4.
@pytest.mark.parametrize("n", [0, 1, 15, 16, 17, 32, 19104])
def test_babybear_duplex_chain_matches_plain(cuda, n):
    from plonky3_tpu_torch import kernels
    from plonky3_tpu_torch.fields import BabyBear
    from plonky3_tpu_torch.hashes import poseidon2_cuda as pc
    from plonky3_tpu_torch.hashes.poseidon2 import default_poseidon2

    perm = default_poseidon2(BabyBear, 24)
    rng = np.random.default_rng(n)
    state = _words(rng, (24,), BabyBear.P, cuda)
    words = _words(rng, (n,), BabyBear.P, cuda)
    before = dict(kernels.LAUNCHES)
    got = pc.poseidon2_duplex_chain(perm, state, words)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["poseidon2_duplex_chain_babybear"] - before[
        "poseidon2_duplex_chain_babybear"] == 1
    assert kernels.LAUNCHES["poseidon2_duplex_chain"] == before[
        "poseidon2_duplex_chain"]
    assert torch.equal(got, pc.poseidon2_duplex_chain_plain(perm, state,
                                                            words))


@pytest.mark.parametrize("lane,pow_bits", [(0, 1), (5, 2), (15, 12),
                                           (10, 16), (10, 17)])
def test_babybear_grind_matches_plain(cuda, lane, pow_bits):
    from plonky3_tpu_torch import kernels
    from plonky3_tpu_torch.fields import BabyBear
    from plonky3_tpu_torch.hashes import poseidon2_cuda as pc
    from plonky3_tpu_torch.hashes.poseidon2 import default_poseidon2

    perm = default_poseidon2(BabyBear, 24)
    base = _words(np.random.default_rng(lane + 100), (24,), BabyBear.P, cuda)
    before = kernels.LAUNCHES["poseidon2_grind_babybear"]
    got = pc.poseidon2_grind(perm, base, lane, pow_bits)
    assert kernels.LAUNCHES["poseidon2_grind_babybear"] - before == 1
    torch.cuda.synchronize()
    assert torch.equal(got, pc.poseidon2_grind_plain(perm, base, lane,
                                                     pow_bits))


@pytest.mark.parametrize("kind", ["keccak", "poseidon2"])
def test_babybear_commit_and_proof_equal_cpu(cuda, kind):
    """Over BabyBear (Poseidon2VectorAir at V = 8, 2,384 columns, 16 rows):
    the trace commit on CUDA equals the CPU's, and both provers on CUDA
    give the CPU's proof."""
    from plonky3_tpu_torch.fields import BabyBear, BabyBearExt4
    from plonky3_tpu_torch.fri.config import FriParameters
    from plonky3_tpu_torch.models.poseidon2_air import (
        Poseidon2VectorAir,
        generate_vectorized_trace,
    )
    from plonky3_tpu_torch.stark import fast_prover
    from plonky3_tpu_torch.stark.prover import prove

    make_config = _configs()[kind][0]
    params = FriParameters(log_blowup=1, log_final_poly_len=0,
                           max_log_arity=3, num_queries=10,
                           commit_proof_of_work_bits=0,
                           query_proof_of_work_bits=8)
    air = Poseidon2VectorAir(BabyBear, 16, vector_len=8)
    inputs = BabyBear.rand_np(np.random.default_rng(4), (128, 16))
    out = {}
    for dev in (cuda, torch.device("cpu")):
        trace, _ = generate_vectorized_trace(air, inputs, device=dev)
        cfg = make_config(BabyBear, BabyBearExt4, params, device=dev)
        out[dev.type + "_commit"] = cfg.pcs.mmcs.commit([trace]).commitment
        out[dev.type] = fast_prover._prove_device_fs(cfg, air, trace, [])
        out[dev.type + "_prove"] = prove(cfg, air, trace, [])
    assert out["cuda_commit"] == out["cpu_commit"]
    assert out["cuda"] == out["cpu"] == out["cpu_prove"] == out["cuda_prove"]


def _m15_air(name, dev):
    """(air, trace, publics) at small size on `dev`: Sha256Air (8 rows,
    7,728 columns), Poseidon1VectorAir(KoalaBear, 16, 8) (16 rows, 1,312
    columns) or two named FibonacciAirs joined (16 rows)."""
    from plonky3_tpu_torch.air.composition import JoinedAir, NamedAir
    from plonky3_tpu_torch.models import fibonacci, poseidon1_air
    from plonky3_tpu_torch.models.sha256_air import (Sha256Air,
                                                     generate_sha256_trace)

    rng = np.random.default_rng(8)
    if name == "sha256":
        inputs = rng.integers(0, 1 << 32, size=(8, 24),
                              dtype=np.uint64).astype(np.uint32)
        return Sha256Air(F), generate_sha256_trace(F, inputs, device=dev), []
    if name == "poseidon1":
        air = poseidon1_air.Poseidon1VectorAir(F, 16, vector_len=8)
        inputs = rng.integers(0, F.P, size=(128, 16), dtype=np.uint32)
        trace, _ = poseidon1_air.generate_vectorized_trace_p1(air, inputs,
                                                              device=dev)
        return air, trace, []
    t1, p1 = fibonacci.generate_fibonacci_trace(F, 4, device=dev)
    t2, p2 = fibonacci.generate_fibonacci_trace(F, 4, a=2, b=3, device=dev)
    air = JoinedAir(NamedAir("fib_a", fibonacci.FibonacciAir(F)),
                    NamedAir("fib_b", fibonacci.FibonacciAir(F)))
    return air, torch.cat([t1, t2], dim=1), p1 + p2


@pytest.mark.parametrize("kind", ["keccak", "poseidon2"])
@pytest.mark.parametrize("name", ["sha256", "poseidon1", "joined"])
def test_m15_proofs_equal_cpu(cuda, name, kind):
    """Sha256Air, Poseidon1VectorAir and a JoinedAir: the trace on CUDA
    equals the CPU's, both provers on CUDA give the CPU's proof, and the
    port's verifier accepts it."""
    from plonky3_tpu_torch.stark import fast_prover
    from plonky3_tpu_torch.stark.prover import prove
    from plonky3_tpu_torch.stark.verifier import verify

    out, traces = [], []
    for dev in (cuda, torch.device("cpu")):
        air, trace, publics = _m15_air(name, dev)
        traces.append(trace.cpu())
        cfg = _configs()[kind][0](F, E, _small_params(), device=dev)
        for fn in (prove, fast_prover._prove_device_fs):
            proof = fn(cfg, air, trace, publics)
            verify(cfg, air, proof, publics)
            out.append(proof)
    assert torch.equal(traces[0], traces[1])
    assert all(p == out[0] for p in out)


def test_batch_inv_and_ext8_equal_cpu(cuda):
    """batch_inv on 2^16 words with zeros equals the Fermat inverse on the
    card; the Ext8 products and inverses on the card equal the CPU's."""
    from plonky3_tpu_torch.fields import (BabyBear, BabyBearExt8, KoalaBear,
                                          KoalaBearExt8)

    rng = np.random.default_rng(13)
    for Fb, E8 in ((KoalaBear, KoalaBearExt8), (BabyBear, BabyBearExt8)):
        a = torch.from_numpy(Fb.rand_np(rng, (1 << 16,)).astype(np.int64))
        a[::9] = 0
        got = Fb.batch_inv(a.to(cuda))
        assert torch.equal(got, Fb.inv(a.to(cuda)))
        assert torch.equal(got.cpu(), Fb.batch_inv(a))
        x = torch.from_numpy(Fb.rand_np(rng, (257, 8)).astype(np.int64))
        y = torch.from_numpy(Fb.rand_np(rng, (257, 8)).astype(np.int64))
        assert torch.equal(E8.mul(x.to(cuda), y.to(cuda)).cpu(),
                           E8.mul(x, y))
        assert torch.equal(E8.inv(x.to(cuda)).cpu(), E8.inv(x))


def test_poseidon1_and_mds_equal_cpu(cuda):
    """Poseidon1's tensor permutation and the coset MDS on the card equal
    the CPU's."""
    from plonky3_tpu_torch.hashes.mds import CosetMds
    from plonky3_tpu_torch.hashes.poseidon1 import default_poseidon1

    rng = np.random.default_rng(14)
    for width in (16, 24):
        perm = default_poseidon1(F, width)
        x = torch.from_numpy(F.rand_np(rng, (1000, width)).astype(np.int64))
        assert torch.equal(perm.permute_device(x.to(cuda)).cpu(),
                           perm.permute_device(x))
    coset = CosetMds(F, 16)
    x = torch.from_numpy(F.rand_np(rng, (64, 16)).astype(np.int64))
    assert torch.equal(coset.permute_device(x.to(cuda)).cpu(),
                       coset.permute_device(x))


def test_zk_commit_and_proof_equal_cpu(cuda):
    """Under zk_stark_config, HidingFriPcs.commit (random rows and
    codewords, salts) and a FibonacciAir proof on the card equal the
    CPU's from the same seed, and the port's verifier accepts it."""
    from plonky3_tpu_torch.models.fibonacci import (FibonacciAir,
                                                    generate_fibonacci_trace)
    from plonky3_tpu_torch.stark.config import zk_stark_config
    from plonky3_tpu_torch.stark.prover import prove
    from plonky3_tpu_torch.stark.verifier import verify

    mat = F.rand_np(np.random.default_rng(15), (64, 5)).astype(np.int64)
    roots, proofs = [], []
    for dev in (cuda, torch.device("cpu")):
        pcs = zk_stark_config(F, E, _small_params(), seed=3,
                              device=dev).pcs
        data = pcs.commit([(pcs.natural_domain_for_degree(128),
                            torch.from_numpy(mat).to(dev))])
        roots.append((data.commitment,
                      [m.cpu() for m in data.matrices]))
        cfg = zk_stark_config(F, E, _small_params(), seed=4, device=dev)
        trace, publics = generate_fibonacci_trace(F, 6, device=dev)
        proof = prove(cfg, FibonacciAir(F), trace, publics)
        verify(cfg, FibonacciAir(F), proof, publics)
        proofs.append(proof)
    assert roots[0][0] == roots[1][0]
    assert all(torch.equal(a, b) for a, b in zip(roots[0][1], roots[1][1]))
    assert proofs[0] == proofs[1]


@pytest.mark.parametrize("kind", ["keccak", "poseidon2"])
def test_batch_commit_and_proof_equal_cpu(cuda, kind):
    """prove_batch over FibonacciAir at 16 and 64 rows and
    Poseidon2VectorAir(KoalaBear, 16, 1) at 8 rows (one mixed-height
    commitment; under keccak the tree injects the shorter matrices
    through compress_kernel) on the card equals the CPU's, and the port's
    verifier accepts it."""
    from plonky3_tpu_torch import kernels
    from plonky3_tpu_torch.compat import trace_inputs_from_numpy
    from plonky3_tpu_torch.models.fibonacci import (FibonacciAir,
                                                    generate_fibonacci_trace)
    from plonky3_tpu_torch.models.poseidon2_air import (
        Poseidon2VectorAir, generate_vectorized_trace)
    from plonky3_tpu_torch.stark.batch import (BatchInstance, prove_batch,
                                               verify_batch)

    inputs = F.rand_np(np.random.default_rng(16), (8, 16))
    proofs = []
    for dev in (cuda, torch.device("cpu")):
        p2 = Poseidon2VectorAir(F, 16, vector_len=1)
        p2_trace, _ = generate_vectorized_trace(
            p2, trace_inputs_from_numpy(inputs, dev), device=dev)
        instances = [BatchInstance(p2, p2_trace, [])]
        for log_n in (4, 6):
            trace, publics = generate_fibonacci_trace(F, log_n, device=dev)
            instances.append(BatchInstance(FibonacciAir(F), trace, publics))
        cfg = _configs()[kind][0](F, E, _small_params(), device=dev)
        kernels.reset_launches()
        proof = prove_batch(cfg, instances)
        if dev.type == "cuda" and kind == "keccak":
            assert kernels.LAUNCHES["keccak_compress"] > 0
        verify_batch(cfg, [i.air for i in instances], proof,
                     [i.public_values for i in instances])
        proofs.append(proof)
    assert proofs[0] == proofs[1]


def test_interaction_proof_equals_cpu(cuda):
    """prove_batch_with_lookups over the reference test's bus AIRs (a
    range lookup of 2^8 queries into a 2^6-row table, 2^8 pairs each way
    on a permutation-check bus; mixed heights, so the keccak trees inject
    through compress_kernel) on the card equals the CPU's, and the port's
    verifier accepts it."""
    from plonky3_tpu_torch import kernels
    from plonky3_tpu_torch.air.api import BaseAir
    from plonky3_tpu_torch.stark import interaction
    from plonky3_tpu_torch.stark.batch import BatchInstance
    from torch_bus_airs import bus_airs, lookup_traces, permutation_traces

    airs = bus_airs(BaseAir, interaction.LookupBus,
                    interaction.PermutationCheckBus)
    traces = (lookup_traces(5, 8, 6)
              + permutation_traces(6, 8, F.P))
    names = ("QueryAir", "TableAir", "SendAir", "RecvAir")
    proofs = []
    for dev in (cuda, torch.device("cpu")):
        instances = [BatchInstance(airs[n](F), torch.from_numpy(
            F.to_monty_np(t).astype(np.int64)).to(dev), [])
            for n, t in zip(names, traces)]
        cfg = _configs()["keccak"][0](F, E, _small_params(), device=dev)
        kernels.reset_launches()
        proof = interaction.prove_batch_with_lookups(cfg, instances)
        if dev.type == "cuda":
            assert kernels.LAUNCHES["keccak_compress"] > 0
        interaction.verify_batch_with_lookups(
            cfg, [i.air for i in instances], proof, [[]] * 4)
        proofs.append(proof)
    assert proofs[0] == proofs[1]


@pytest.mark.parametrize("is_local", [False, True])
def test_batch_ref_proof_equals_cpu(cuda, is_local):
    """prove_batch_ref over the batch fixture's AIRs at 2^8 rows
    (MulAirLookups and FibAirLookups on the MulFib bus, the preprocessed
    index column; MulAirLookups' local lookup off and on) under the
    Poseidon2 config over BabyBear on the card equals the CPU's, and the
    port's verifier accepts it."""
    from plonky3_tpu_torch.compat import batch_fixture_airs as fx
    from plonky3_tpu_torch.fields import BabyBear as BF
    from plonky3_tpu_torch.fields import BabyBearExt4 as BE
    from plonky3_tpu_torch.stark import batch_ref
    from plonky3_tpu_torch.stark.batch import BatchInstance
    from plonky3_tpu_torch.stark.config import poseidon2_stark_config

    ft, fpis = fx.fibonacci_trace(BF, 8)
    traces, publics = [fx.mul_trace(BF, 256, 2), ft], [[], fpis]
    proofs = []
    for dev in (cuda, torch.device("cpu")):
        airs = [fx.MulAirLookups(BF, reps=2, is_local=is_local),
                fx.FibAirLookups(BF, log_height=8)]
        cfg = poseidon2_stark_config(BF, BE, _small_params(), device=dev)
        common = batch_ref.keygen(cfg, airs, [8, 8])
        instances = [BatchInstance(a, torch.from_numpy(BF.to_monty_np(t)
                                                       .astype(np.int64))
                                   .to(dev), pv)
                     for a, t, pv in zip(airs, traces, publics)]
        proof = batch_ref.prove_batch_ref(cfg, instances, common)
        batch_ref.verify_batch_ref(cfg, airs, proof, publics, common)
        proofs.append(proof)
    assert proofs[0] == proofs[1]


@pytest.mark.parametrize("h,w", [(5, 1), (64, 2633), (300, 3520)])
def test_sponge_on_m31_words_matches_plain(cuda, h, w):
    """Canonical Mersenne-31 rows (one all P - 1, one all 0) through the
    leaf sponge kernel and its plain version."""
    from plonky3_tpu_torch.fields.mersenne31 import Mersenne31
    from plonky3_tpu_torch.hashes import keccak_cuda as kc

    flat = _words(np.random.default_rng(h), (h, w), Mersenne31.P, cuda)
    flat[0] = Mersenne31.P - 1
    flat[-1] = 0
    got = kc.keccak_sponge_rows(flat)
    torch.cuda.synchronize()
    assert torch.equal(got, kc.keccak_sponge_rows_plain(flat))


@pytest.mark.parametrize("name", ["fibonacci", "monolith"])
def test_circle_proof_equals_cpu(cuda, name):
    """circle_stark_config (FRI by 2, 10 queries): FibonacciAir at 64
    rows and MonolithAir at 8, the CUDA proof equal to the CPU's and
    accepted by the port's verifier."""
    from plonky3_tpu_torch.fields.mersenne31 import Mersenne31 as M31
    from plonky3_tpu_torch.fri.config import FriParameters
    from plonky3_tpu_torch.models.fibonacci import (
        FibonacciAir, generate_fibonacci_trace)
    from plonky3_tpu_torch.models.monolith_air import (
        MonolithAir, generate_monolith_trace)
    from plonky3_tpu_torch.stark.config import circle_stark_config
    from plonky3_tpu_torch.stark.prover import prove
    from plonky3_tpu_torch.stark.verifier import verify

    params = FriParameters(log_blowup=1, log_final_poly_len=0,
                           max_log_arity=1, num_queries=10,
                           commit_proof_of_work_bits=0,
                           query_proof_of_work_bits=8)
    inputs = np.random.default_rng(3).integers(
        0, M31.P, size=(8, 16), dtype=np.uint64).astype(np.uint32)
    proofs = []
    for dev in (cuda, torch.device("cpu")):
        if name == "fibonacci":
            air = FibonacciAir(M31)
            trace, publics = generate_fibonacci_trace(M31, 6, device=dev)
        else:
            air, publics = MonolithAir(M31), []
            trace = generate_monolith_trace(M31, inputs, device=dev)
        config = circle_stark_config(params, device=dev)
        proof = prove(config, air, trace, publics)
        verify(config, air, proof, publics)
        proofs.append(proof)
    assert proofs[0] == proofs[1]


def _gl_words(rng, shape, device):
    from plonky3_tpu_torch.gl.field import GLF, to_tensor

    x = rng.integers(0, GLF.P, size=shape, dtype=np.uint64)
    if x.size:
        x.reshape(-1)[0] = GLF.P - 1
    return to_tensor(x, device)


@pytest.mark.parametrize("h,w", [(1, 1), (3, 2), (33, 3), (100, 4),
                                 (130, 7), (64, 64), (4, 3536)])
def test_gl_sponge_matches_plain(cuda, h, w):
    from plonky3_tpu_torch.hashes import poseidon2_goldilocks_cuda as pgc
    from plonky3_tpu_torch.fields import goldilocks_device as gd

    mat = _gl_words(np.random.default_rng(w), (h, w), cuda)
    got = pgc.gl_sponge_rows(mat)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), gd.gl_sponge_rows_plain(mat.cpu()))


@pytest.mark.parametrize("n", [1, 5, 257, 4096])
def test_gl_compress_and_permute_match_plain(cuda, n):
    from plonky3_tpu_torch.hashes import poseidon2_goldilocks_cuda as pgc
    from plonky3_tpu_torch.fields import goldilocks_device as gd

    rng = np.random.default_rng(n)
    level = _gl_words(rng, (2 * n, 4), cuda)
    pairs = level.reshape(n, 2, 4)
    got = pgc.gl_compress(pairs[:, 0], pairs[:, 1])
    want = gd.gl_compress_plain(pairs[:, 0], pairs[:, 1])
    states = _gl_words(rng, (n, 8), cuda)
    got_p = pgc.gl_permute(states)
    want_p = gd.poseidon2_goldilocks_plain(states)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(got_p, want_p)


@pytest.mark.parametrize("name", ["fibonacci", "monolith"])
def test_gl_proof_equals_cpu(cuda, name):
    """Goldilocks proofs (Poseidon2-GL trees and transcript, a 6-bit
    query grind) on CUDA equal the CPU's; the port's verifier accepts
    them."""
    from plonky3_tpu_torch.fri.config import FriParameters
    from plonky3_tpu_torch.gl.field import GLF
    from plonky3_tpu_torch.gl.stark import goldilocks_stark_config, prove_gl
    from plonky3_tpu_torch.models.fibonacci import (FibonacciAir,
                                                    generate_fibonacci_trace)
    from plonky3_tpu_torch.models.monolith_gl_air import (
        MonolithGoldilocksAir, generate_monolith_gl_trace)
    from plonky3_tpu_torch.stark.verifier import verify

    params = FriParameters(log_blowup=1, log_final_poly_len=0,
                           max_log_arity=1, num_queries=6,
                           commit_proof_of_work_bits=0,
                           query_proof_of_work_bits=6)
    proofs = []
    for dev in ("cuda", "cpu"):
        if name == "fibonacci":
            air = FibonacciAir(GLF)
            trace, publics = generate_fibonacci_trace(GLF, 8, device=dev)
        else:
            air, publics = MonolithGoldilocksAir(), []
            trace = generate_monolith_gl_trace(_gl_words(
                np.random.default_rng(3), (8, 8), "cpu").numpy().view(
                np.uint64), device=dev)
        config = goldilocks_stark_config(params, device=dev)
        proof = prove_gl(config, air, trace, publics)
        torch.cuda.synchronize()
        if name == "fibonacci" or dev == "cuda":
            verify(config, air, proof, publics)
        proofs.append(proof)
    assert proofs[0] == proofs[1]


def _m21_proof(name, device):
    """A small STIR PCS, WHIR or multilinear-STARK proof made on
    `device` from seeded inputs (the sizes of chip_smoke.py's
    m21_small)."""
    from plonky3_tpu_torch.challenger.duplex import DuplexChallenger
    from plonky3_tpu_torch.hashes.poseidon2 import default_poseidon2
    from plonky3_tpu_torch.hashes.sponge import (PaddingFreeSponge,
                                                 TruncatedPermutation)
    from plonky3_tpu_torch.merkle.extension_mmcs import ExtensionMmcs
    from plonky3_tpu_torch.merkle.mmcs import MerkleTreeMmcs
    from plonky3_tpu_torch.models.fibonacci import (FibonacciAir,
                                                    generate_fibonacci_trace)
    from plonky3_tpu_torch.multilinear.multi_stark import prove_multi_stark
    from plonky3_tpu_torch.multilinear.whir import WhirConfig, WhirPcs
    from plonky3_tpu_torch.stir import StirParameters
    from plonky3_tpu_torch.stir.pcs import TwoAdicStirPcs

    mmcs = MerkleTreeMmcs(
        sponge=PaddingFreeSponge(default_poseidon2(F, 24), rate=16, out=8),
        compressor=TruncatedPermutation(default_poseidon2(F, 16), chunk=8))
    ext = ExtensionMmcs(inner=mmcs, D=E.D)

    def ch():
        return DuplexChallenger(default_poseidon2(F, 24), device=device,
                                rate=16)

    rng = np.random.default_rng(21)
    if name == "stir":
        pcs = TwoAdicStirPcs(F=F, E=E, params=StirParameters(
            log_blowup=2, log_folding_factor=2, security_level=60,
            max_pow_bits=12), mmcs=mmcs, stir_mmcs=ext)
        evals = torch.from_numpy(F.rand_np(rng, (256, 8)).astype(
            np.int64)).to(device)
        z = E.rand_h(rng)
        data = pcs.commit([(pcs.natural_domain_for_degree(256), evals)])
        c = ch()
        c.observe_many(data.root_std)
        return data.root_std, pcs.open([(data, [[z]])], c)
    # n_vars 10, or 9 for the 2^8 x 2 trace's stacked MLE
    cfg = WhirConfig(log_blowup=2, folding_factor=2,
                     final_vars=2 if name == "whir" else 3,
                     num_queries=8, ood_samples=1, pow_bits=8)
    pcs = WhirPcs(F=F, E=E, config=cfg, mmcs=mmcs, fri_mmcs=ext)
    if name == "whir":
        evals = torch.from_numpy(F.rand_np(rng, (1 << 10,), monty=False)
                                 .astype(np.int64)).to(device)
        point = [E.rand_h(rng) for _ in range(10)]
        commit, data = pcs.commit(evals)
        c = ch()
        c.observe_digest(commit)
        return commit, pcs.open(data, point, c)
    trace, publics = generate_fibonacci_trace(F, 8, device=device)
    return prove_multi_stark(pcs, FibonacciAir(F), trace, publics, ch())


@pytest.mark.parametrize("name", ["stir", "whir", "multi_stark"])
def test_m21_proof_equals_cpu(cuda, name):
    """STIR, WHIR and the multilinear STARK on the card give the CPU's
    proof (their transforms launch K1/K2, their grinds the Poseidon2
    grind kernel)."""
    import dataclasses

    from plonky3_tpu_torch import kernels

    def plain(x):
        if dataclasses.is_dataclass(x):
            return tuple((f.name, plain(getattr(x, f.name)))
                         for f in dataclasses.fields(x))
        if isinstance(x, (list, tuple)):
            return tuple(plain(v) for v in x)
        return int(x) if isinstance(x, np.integer) else x

    before = kernels.LAUNCHES["ntt_k1"]
    got = _m21_proof(name, cuda)
    assert kernels.LAUNCHES["ntt_k1"] > before
    assert plain(got) == plain(_m21_proof(name, "cpu"))


def _m22_result(name, device):
    """A small hiding WHIR opening (n_vars 6), masked zerocheck
    (FibonacciAir at 2^4 rows) or sharded LDE and keccak tree (256 x 5
    in a one-rank gloo group: CUDA tensors staged through the host) on
    `device`, from seeded inputs."""
    import torch.distributed as dist

    from plonky3_tpu_torch.challenger.duplex import DuplexChallenger
    from plonky3_tpu_torch.hashes.poseidon2 import default_poseidon2
    from plonky3_tpu_torch.hashes.sponge import (PaddingFreeSponge,
                                                 TruncatedPermutation)
    from plonky3_tpu_torch.merkle.extension_mmcs import ExtensionMmcs
    from plonky3_tpu_torch.merkle.mmcs import MerkleTreeMmcs
    from plonky3_tpu_torch.multilinear.hiding_whir import HidingWhirPcs
    from plonky3_tpu_torch.multilinear.whir import WhirConfig

    mmcs = MerkleTreeMmcs(
        sponge=PaddingFreeSponge(default_poseidon2(F, 24), rate=16, out=8),
        compressor=TruncatedPermutation(default_poseidon2(F, 16), chunk=8))

    def pcs(n1, queries, pow_bits):
        cfg = WhirConfig(log_blowup=2, folding_factor=2,
                         final_vars=n1 % 2 if n1 % 2 else 2,
                         num_queries=queries, ood_samples=1,
                         pow_bits=pow_bits)
        return HidingWhirPcs(F=F, E=E, config=cfg, mmcs=mmcs,
                             fri_mmcs=ExtensionMmcs(inner=mmcs, D=E.D))

    def ch():
        return DuplexChallenger(default_poseidon2(F, 24), device=device,
                                rate=16)

    if name == "hiding_whir":
        rng = np.random.default_rng(3)
        evals = torch.from_numpy(F.rand_np(rng, (1 << 6,), monty=False)
                                 .astype(np.int64)).to(device)
        p = pcs(7, 8, 2)
        commit, data = p.commit_hiding(evals, rng)
        point = [E.rand_h(rng) for _ in range(6)]
        return commit, p.open_hiding(data, point, ch(), rng)
    if name == "masked_zerocheck":
        from plonky3_tpu_torch.models.fibonacci import (
            FibonacciAir, generate_fibonacci_trace)
        from plonky3_tpu_torch.multilinear import prove_masked_zerocheck

        trace, publics = generate_fibonacci_trace(F, 4, device=device)
        return prove_masked_zerocheck(E, FibonacciAir(F), trace, publics,
                                      ch(), pcs(7, 6, 1),
                                      np.random.default_rng(11))
    from plonky3_tpu_torch.hashes.keccak_sponge import (KeccakCompressor,
                                                        KeccakFieldSponge)
    from plonky3_tpu_torch.parallel.merkle import sharded_tree_layers
    from plonky3_tpu_torch.parallel.ntt import coset_lde_batch_sharded

    mat = torch.from_numpy(F.rand_np(np.random.default_rng(0), (256, 5))
                           .astype(np.int64)).to(device)
    dist.init_process_group("gloo", init_method="tcp://127.0.0.1:29571",
                            rank=0, world_size=1)
    try:
        lde = coset_lde_batch_sharded(F, mat, 1, F.GENERATOR)
        layers = sharded_tree_layers(MerkleTreeMmcs(
            sponge=KeccakFieldSponge(F), compressor=KeccakCompressor()), lde)
        return lde.cpu().tolist(), [x.cpu().tolist() for x in layers]
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("name", ["hiding_whir", "masked_zerocheck",
                                  "sharded"])
def test_m22_equals_cpu(cuda, name):
    """Hiding WHIR, the masked zerocheck and the sharded LDE and tree on
    the card give the CPU's results (K1/K2 launched)."""
    import dataclasses

    from plonky3_tpu_torch import kernels

    def plain(x):
        if dataclasses.is_dataclass(x):
            return tuple((f.name, plain(getattr(x, f.name)))
                         for f in dataclasses.fields(x))
        if isinstance(x, (list, tuple)):
            return tuple(plain(v) for v in x)
        return int(x) if isinstance(x, np.integer) else x

    before = kernels.LAUNCHES["ntt_k1"]
    got = _m22_result(name, cuda)
    assert kernels.LAUNCHES["ntt_k1"] > before
    assert plain(got) == plain(_m22_result(name, "cpu"))
