"""StarkConfig (uni-stark/src/config.rs:24,49) and the keccak benchmark
config, ported from `plonky3_tpu/stark/config.py`."""

from __future__ import annotations

from dataclasses import dataclass

from .. import default_device
from ..fri.config import FriParameters
from ..fri.two_adic_pcs import TwoAdicFriPcs
from ..hashes.keccak_sponge import KeccakCompressor, KeccakFieldSponge
from ..merkle.extension_mmcs import ExtensionMmcs
from ..merkle.mmcs import MerkleTreeMmcs


@dataclass(frozen=True)
class StarkConfig:
    pcs: TwoAdicFriPcs
    device: object  # torch.device the config proves on

    @property
    def F(self):
        return self.pcs.F

    @property
    def E(self):
        return self.pcs.E

    def initialise_challenger(self):
        from ..challenger.serializing import SerializingChallenger32

        return SerializingChallenger32(self.F)


def keccak_stark_config(F, E, fri_params: FriParameters,
                        cap_height: int = 0, device=None) -> StarkConfig:
    """The KeccakF Merkle and transcript config of the reference
    benchmarks (examples/src/types.rs:19-42: keccak sponge 25/17/4 over
    u64 lanes, SerializingChallenger32 over Keccak256), on `device`
    (default cuda)."""
    dev = default_device(device)
    mmcs = MerkleTreeMmcs(sponge=KeccakFieldSponge(F),
                          compressor=KeccakCompressor(),
                          cap_height=cap_height)
    pcs = TwoAdicFriPcs(F=F, E=E, fri=fri_params, mmcs=mmcs,
                        fri_mmcs=ExtensionMmcs(inner=mmcs, D=E.D))
    return StarkConfig(pcs=pcs, device=dev)
