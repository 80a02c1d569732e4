"""The ranks of tests/test_torch_parallel.py: spawned CPU processes over
gloo that run the port's sharded LDE and Merkle tree and save what each
rank holds. No JAX here: each rank imports the port alone."""

import os

import numpy as np
import torch
import torch.distributed as dist

# (rows, columns, added bits) of each sharded LDE case; seeds as below
LDE_CASES = {"lde": (256, 5, 1), "lde_ab2": (64, 3, 2)}
TREE_ROWS, TREE_COLS = 128, 9


def mmcs(kind):
    from plonky3_tpu_torch.fields import KoalaBear as F
    from plonky3_tpu_torch.hashes.keccak_sponge import (KeccakCompressor,
                                                        KeccakFieldSponge)
    from plonky3_tpu_torch.hashes.poseidon2 import default_poseidon2
    from plonky3_tpu_torch.hashes.sponge import (PaddingFreeSponge,
                                                 TruncatedPermutation)
    from plonky3_tpu_torch.merkle.mmcs import MerkleTreeMmcs

    if kind == "keccak":
        return MerkleTreeMmcs(sponge=KeccakFieldSponge(F),
                              compressor=KeccakCompressor())
    return MerkleTreeMmcs(
        sponge=PaddingFreeSponge(default_poseidon2(F, 24), rate=16, out=8),
        compressor=TruncatedPermutation(default_poseidon2(F, 16), chunk=8))


def inputs(world):
    """Every case's full input matrix (Montgomery u32 words), from seeds."""
    from plonky3_tpu_torch.fields import KoalaBear as F

    out = {name: F.rand_np(np.random.default_rng(seed), shape[:2])
           for seed, (name, shape) in enumerate(LDE_CASES.items())}
    # the reference's small case: one row a rank (log_a <= 0)
    out["replicated"] = F.rand_np(np.random.default_rng(7), (world, 4))
    out["tree"] = F.rand_np(np.random.default_rng(8),
                            (TREE_ROWS, TREE_COLS))
    return out


def run_rank(rank, world, port, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    from plonky3_tpu_torch.fields import KoalaBear as F
    from plonky3_tpu_torch.parallel.merkle import sharded_tree_layers
    from plonky3_tpu_torch.parallel.ntt import coset_lde_batch_sharded

    def block(mat):
        t = torch.from_numpy(mat.astype(np.int64))
        m = t.shape[0] // world
        return t[rank * m:(rank + 1) * m]

    mats = inputs(world)
    got = {}
    for name, (_, _, ab) in LDE_CASES.items():
        got[name] = coset_lde_batch_sharded(F, block(mats[name]), ab,
                                            F.GENERATOR)
    got["replicated"] = coset_lde_batch_sharded(F, block(mats["replicated"]),
                                                1, F.GENERATOR)
    for kind in ("poseidon2", "keccak"):
        got[f"tree_{kind}"] = sharded_tree_layers(mmcs(kind),
                                                  block(mats["tree"]))
        # the commit pipeline: the sharded LDE's blocks straight into the
        # sharded tree
        got[f"commit_{kind}"] = sharded_tree_layers(mmcs(kind),
                                                    got["lde"])[-1]
    torch.save(got, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()
