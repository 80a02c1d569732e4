"""StarkConfig (uni-stark/src/config.rs:24,49), the two benchmark
configs of the reference (examples/src/types.rs:19-62), its ZK config and
its Mersenne-31 circle config, ported from `plonky3_tpu/stark/config.py`."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .. import default_device
from ..fri.config import FriParameters
from ..fri.hiding_pcs import HidingFriPcs
from ..fri.two_adic_pcs import TwoAdicFriPcs
from ..hashes.keccak_sponge import KeccakCompressor, KeccakFieldSponge
from ..hashes.poseidon2 import default_poseidon2
from ..hashes.sponge import PaddingFreeSponge, TruncatedPermutation
from ..merkle.extension_mmcs import ExtensionMmcs
from ..merkle.hiding_mmcs import MerkleTreeHidingMmcs
from ..merkle.mmcs import MerkleTreeMmcs


@dataclass(frozen=True)
class StarkConfig:
    pcs: TwoAdicFriPcs  # or HidingFriPcs, or CirclePcs
    device: object  # torch.device the config proves on
    # the Fiat-Shamir transcript: "duplex" (DuplexChallenger over
    # Poseidon2-24, field digests) or "keccak" (SerializingChallenger32
    # over keccak-256, word digests)
    challenger_kind: str = "duplex"
    # a () -> challenger that replaces the kind's transcript (the golden
    # fixtures' DuplexChallenger over Poseidon2-16 at rate 8)
    challenger_factory: object = None

    @property
    def F(self):
        return self.pcs.F

    @property
    def E(self):
        return self.pcs.E

    def initialise_challenger(self):
        """The host transcript; a duplex grind searches on the config's
        device."""
        if self.challenger_factory is not None:
            return self.challenger_factory()
        if self.challenger_kind == "keccak":
            from ..challenger.serializing import SerializingChallenger32

            return SerializingChallenger32(self.F)
        from ..challenger.duplex import DuplexChallenger

        return DuplexChallenger(default_poseidon2(self.F, 24),
                                device=self.device)


def _config(F, E, fri_params, mmcs, device, challenger_kind):
    pcs = TwoAdicFriPcs(F=F, E=E, fri=fri_params, mmcs=mmcs,
                        fri_mmcs=ExtensionMmcs(inner=mmcs, D=E.D))
    return StarkConfig(pcs=pcs, device=default_device(device),
                       challenger_kind=challenger_kind)


def poseidon2_stark_config(F, E, fri_params: FriParameters,
                           cap_height: int = 0, device=None) -> StarkConfig:
    """The Poseidon2 Merkle and transcript config of the reference
    benchmarks (examples/src/types.rs:44-62: sponge 24/16/8, compression
    of width 16, DuplexChallenger 24/16; field digests), on `device`
    (default cuda)."""
    mmcs = MerkleTreeMmcs(
        sponge=PaddingFreeSponge(default_poseidon2(F, 24), rate=16, out=8),
        compressor=TruncatedPermutation(default_poseidon2(F, 16), chunk=8),
        cap_height=cap_height)
    return _config(F, E, fri_params, mmcs, device, "duplex")


def keccak_stark_config(F, E, fri_params: FriParameters,
                        cap_height: int = 0, device=None) -> StarkConfig:
    """The KeccakF Merkle and transcript config of the reference
    benchmarks (examples/src/types.rs:19-42: keccak sponge 25/17/4 over
    u64 lanes, SerializingChallenger32 over Keccak256), on `device`
    (default cuda)."""
    mmcs = MerkleTreeMmcs(sponge=KeccakFieldSponge(F),
                          compressor=KeccakCompressor(),
                          cap_height=cap_height)
    return _config(F, E, fri_params, mmcs, device, "keccak")


def zk_stark_config(F, E, fri_params: FriParameters, seed: int = 0,
                    salt_elems: int = 4, num_random_codewords: int = 1,
                    device=None) -> StarkConfig:
    """The ZK config (fib_air.rs make_zk_config): the Poseidon2 Merkle
    config's hashes and transcript, a hiding MMCS (salted leaves) for the
    committed matrices and HidingFriPcs (random rows and codewords, the
    masked quotient, the batch's blinding R), on `device` (default cuda).
    The FRI rounds commit through the plain MMCS. One Generator, seeded
    by `seed`, serves the MMCS and the PCS, so a config's proofs follow
    one random stream: two proofs from one seed need two configs."""
    rng = np.random.default_rng(seed)
    base = MerkleTreeMmcs(
        sponge=PaddingFreeSponge(default_poseidon2(F, 24), rate=16, out=8),
        compressor=TruncatedPermutation(default_poseidon2(F, 16), chunk=8))
    inner = TwoAdicFriPcs(
        F=F, E=E, fri=fri_params,
        mmcs=MerkleTreeHidingMmcs(inner=base, salt_elems=salt_elems,
                                  rng=rng),
        fri_mmcs=ExtensionMmcs(inner=base, D=E.D))
    pcs = HidingFriPcs(inner=inner,
                       num_random_codewords=num_random_codewords, rng=rng)
    return StarkConfig(pcs=pcs, device=default_device(device))


def circle_stark_config(fri_params: FriParameters,
                        device=None) -> StarkConfig:
    """The Mersenne-31 circle STARK config (the reference CLI's
    `--field mersenne-31`): CirclePcs over QM31 with the KeccakF Merkle
    tree of `keccak_stark_config` and SerializingChallenger32, on
    `device` (default cuda). Circle FRI folds by 2 and ends in a constant
    (fri/src/config.rs:12): max_log_arity 1, log_final_poly_len 0."""
    from ..circle_pcs import CirclePcs
    from ..fields.mersenne31 import Mersenne31
    from ..fields.qm31 import QM31

    if fri_params.max_log_arity != 1 or fri_params.log_final_poly_len != 0:
        raise ValueError("circle FRI needs max_log_arity 1 and "
                         "log_final_poly_len 0")
    mmcs = MerkleTreeMmcs(sponge=KeccakFieldSponge(Mersenne31),
                          compressor=KeccakCompressor())
    pcs = CirclePcs(fri=fri_params, mmcs=mmcs,
                    fri_mmcs=ExtensionMmcs(inner=mmcs, D=QM31.D))
    return StarkConfig(pcs=pcs, device=default_device(device),
                       challenger_kind="keccak")
