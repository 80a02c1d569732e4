"""The reference's golden-fixture STARK configs, reproduced exactly.

Port of `plonky3_tpu/compat/fixture_configs.py`. The two-adic configs
mirror `uni-stark/tests/fib_air.rs:118-153` (`make_two_adic_config`) and
`batch-stark/tests/simple.rs:580` (`make_two_adic_compat_config(777)`):
BabyBear, Poseidon2BabyBear<16> drawn from `SmallRng::seed_from_u64`,
PaddingFreeSponge<Perm, 16, 8, 8>, TruncatedPermutation<Perm, 2, 8, 16>,
DuplexChallenger<BB, Perm, 16, 8> (grinding on the host: the grind
kernel takes the width-24 transcript only) and FRI {log_blowup 2,
max_log_arity 1, 2 queries, commit and query PoW 1 bit}. Their proofs
are the golden fixtures.

`FIXTURE_*` are the fixture files' paths inside a checkout of the
reference (Plonky3). The files are not in this repository.

The circle configs mirror `fib_air.rs:200-233` and `make_circle_config`
(simple.rs): Mersenne31 with its cubic extension, Keccak256 byte digests
(`hashes/keccak256_mmcs.py`, hashed on the host as the reference does),
SerializingChallenger32 observing a digest's raw bytes, and FRI
{log_blowup 1, final polynomial 1, arity 2, 40 queries}.
"""

from __future__ import annotations

from .. import default_device
from ..challenger.duplex import DuplexChallenger
from ..fields import BabyBear, BabyBearExt4
from ..fri.config import FriParameters
from ..fri.two_adic_pcs import TwoAdicFriPcs
from ..hashes.poseidon2 import Poseidon2
from ..hashes.sponge import PaddingFreeSponge, TruncatedPermutation
from ..merkle.extension_mmcs import ExtensionMmcs
from ..merkle.mmcs import MerkleTreeMmcs
from ..stark.config import StarkConfig
from .smallrng import poseidon2_constants_from_rng

FIXTURE_TWO_ADIC = "uni-stark/tests/fixtures/uni_stark_two_adic_v1.postcard"
FIXTURE_CIRCLE = "uni-stark/tests/fixtures/uni_stark_circle_v1.postcard"
FIXTURE_BATCH_TWO_ADIC = (
    "batch-stark/tests/fixtures/batch_stark_two_adic_v1.postcard")
FIXTURE_BATCH_CIRCLE = (
    "batch-stark/tests/fixtures/batch_stark_circle_v1.postcard")


def poseidon2_baby_bear_16(seed: int = 1) -> Poseidon2:
    """Poseidon2BabyBear<16> with rng-drawn constants (fib_air.rs:134-135)."""
    ei, ef, internal = poseidon2_constants_from_rng(
        BabyBear, 16, rounds_f=8, rounds_p=13, seed=seed)
    return Poseidon2(
        F=BabyBear, width=16, d=7,
        rc_external_initial=tuple(tuple(r) for r in ei),
        rc_external_final=tuple(tuple(r) for r in ef),
        rc_internal=tuple(internal))


def _fixture_config(seed, log_final_poly_len, cap_height, device):
    F, E = BabyBear, BabyBearExt4
    perm = poseidon2_baby_bear_16(seed)
    mmcs = MerkleTreeMmcs(
        sponge=PaddingFreeSponge(perm, rate=8, out=8),
        compressor=TruncatedPermutation(perm, chunk=8),
        cap_height=cap_height)
    fri = FriParameters(
        log_blowup=2, log_final_poly_len=log_final_poly_len,
        max_log_arity=1, num_queries=2, commit_proof_of_work_bits=1,
        query_proof_of_work_bits=1)
    pcs = TwoAdicFriPcs(F=F, E=E, fri=fri, mmcs=mmcs,
                        fri_mmcs=ExtensionMmcs(inner=mmcs, D=E.D))
    return StarkConfig(
        pcs=pcs, device=default_device(device),
        challenger_factory=lambda: DuplexChallenger(perm, rate=8))


def two_adic_fixture_config(log_final_poly_len: int = 2,
                            device=None) -> StarkConfig:
    """make_two_adic_config (fib_air.rs:118-153), on `device` (default
    cuda)."""
    return _fixture_config(1, log_final_poly_len, 0, device)


def batch_two_adic_fixture_config(device=None) -> StarkConfig:
    """make_two_adic_compat_config(777) (simple.rs:580): Poseidon2BabyBear
    <16> from SmallRng(777), a Merkle cap of height 1, FRI final
    polynomial length 2^2; on `device` (default cuda)."""
    return _fixture_config(777, 2, 1, device)


def _circle_config(cap_height, commit_pow_bits, device):
    from ..challenger.serializing import SerializingChallenger32
    from ..circle_pcs import CirclePcs
    from ..fields.mersenne31 import M31Ext3, Mersenne31
    from ..hashes.keccak256_mmcs import (Keccak256Compressor,
                                         Keccak256FieldHasher)

    mmcs = MerkleTreeMmcs(sponge=Keccak256FieldHasher(Mersenne31),
                          compressor=Keccak256Compressor(),
                          cap_height=cap_height)
    fri = FriParameters(
        log_blowup=1, log_final_poly_len=0, max_log_arity=1,
        num_queries=40, commit_proof_of_work_bits=commit_pow_bits,
        query_proof_of_work_bits=8)
    pcs = CirclePcs(fri=fri, mmcs=mmcs,
                    fri_mmcs=ExtensionMmcs(inner=mmcs, D=M31Ext3.D),
                    ext=M31Ext3)
    return StarkConfig(
        pcs=pcs, device=default_device(device), challenger_kind="keccak",
        challenger_factory=lambda: SerializingChallenger32(
            Mersenne31, digest_bytes=True))


def circle_fixture_config(device=None) -> StarkConfig:
    """The circle golden-fixture config (fib_air.rs:200-233): commit PoW
    0 bits, query PoW 8; on `device` (default cuda)."""
    return _circle_config(0, 0, device)


def batch_circle_fixture_config(device=None) -> StarkConfig:
    """make_circle_config (batch-stark/tests/simple.rs): a Merkle cap of
    height 3, commit and query PoW 8 bits; on `device` (default cuda)."""
    return _circle_config(3, 8, device)
