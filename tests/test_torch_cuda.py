"""plonky3_tpu_torch on the card: each CUDA kernel against its plain
version, and a proof on CUDA against the same proof on the CPU.

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
    (10, 64, True, False), (11, 5, False, True), (21, 2, False, True)])
def test_ntt_kernels_match_plain(cuda, log_n, w, inverse, zero_top):
    from plonky3_tpu_torch.ops.ntt_cuda import dif_fused, dif_fused_plain

    rows = (1 << log_n) >> 1 if zero_top else 1 << log_n
    x = _words(np.random.default_rng(log_n), (rows, w), F.P, cuda)
    got = dif_fused(F, x, log_n, inverse, zero_top)
    want = dif_fused_plain(F, x, log_n, inverse, zero_top)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("h,w", [(1, 1), (33, 34), (100, 35), (64, 1312)])
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
