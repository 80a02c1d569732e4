"""The port's sharded LDE and Merkle tree (plonky3_tpu_torch/parallel/)
against the reference's (plonky3_tpu/parallel/) and the single device.

World sizes 2 and 4, each as spawned CPU processes over gloo
(`torch_parallel_ranks.py`; each rank imports the port alone). Every rank
holds a contiguous block of the matrix's rows; the blocks it returns,
gathered in rank order, must be the same u32 words (tolerance zero) as:
- the sharded LDE (256 x 5, added_bits 1 as in tests/test_parallel.py;
  64 x 3, added_bits 2): the JAX `coset_lde_batch`, the JAX
  `coset_lde_batch_sharded` on the 8-device mesh, and the port's own
  `coset_lde_batch`;
- the reference's small case (one row a rank, log_a <= 0), run
  replicated;
- the sharded tree's layers under the Poseidon2 MMCS and the keccak MMCS
  (128 x 9): the JAX `sharded_tree_layers` on the mesh and the port's
  `_build_layers`;
- the sharded commit of the sharded LDE: the single-device root.
"""

import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import torch_parallel_ranks as ranks_mod
from plonky3_tpu.fields import KoalaBear as JF
from plonky3_tpu.hashes.keccak_sponge import KeccakCompressor as JKCompress
from plonky3_tpu.hashes.keccak_sponge import KeccakFieldSponge as JKSponge
from plonky3_tpu.hashes.poseidon2 import default_poseidon2 as j_poseidon2
from plonky3_tpu.hashes.sponge import PaddingFreeSponge as JSponge
from plonky3_tpu.hashes.sponge import TruncatedPermutation as JCompress
from plonky3_tpu.merkle.mmcs import MerkleTreeMmcs as JMmcs
from plonky3_tpu.ops.ntt import coset_lde_batch as j_lde
from plonky3_tpu.parallel.merkle import sharded_tree_layers as j_tree
from plonky3_tpu.parallel.ntt import coset_lde_batch_sharded as j_lde_sharded
from plonky3_tpu_torch.fields import KoalaBear as F
from plonky3_tpu_torch.merkle.mmcs import _build_layers
from plonky3_tpu_torch.ops.ntt import coset_lde_batch
from plonky3_tpu_torch.parallel.ntt import split

WORLDS = (2, 4)
KINDS = ("poseidon2", "keccak")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module", params=WORLDS)
def run(request, tmp_path_factory):
    """(world, every rank's saved results) of one spawn."""
    world = request.param
    out = tmp_path_factory.mktemp(f"world{world}")
    mp.spawn(ranks_mod.run_rank, args=(world, _free_port(), str(out)),
             nprocs=world)
    return world, [torch.load(out / f"rank{r}.pt") for r in range(world)]


def _jmmcs(kind):
    if kind == "keccak":
        return JMmcs(sponge=JKSponge(JF), compressor=JKCompress())
    return JMmcs(sponge=JSponge(j_poseidon2(JF, 24), rate=16, out=8),
                 compressor=JCompress(j_poseidon2(JF, 16), chunk=8))


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.array(jax.devices()[:8]), ("sp",))


@pytest.fixture(scope="module")
def ref(mesh):
    """The JAX package's results, once."""
    mats = ranks_mod.inputs(8)
    out = {name: np.asarray(j_lde(JF, jnp.asarray(mats[name]), ab,
                                  JF.GENERATOR))
           for name, (_, _, ab) in ranks_mod.LDE_CASES.items()}
    sharding = NamedSharding(mesh, P("sp", None))
    out["lde_mesh"] = np.asarray(j_lde_sharded(
        JF, jax.device_put(jnp.asarray(mats["lde"]), sharding), 1,
        JF.GENERATOR, mesh))
    tree = jax.device_put(jnp.asarray(mats["tree"]), sharding)
    for kind in KINDS:
        out[f"tree_{kind}"] = [np.asarray(x) for x in
                               j_tree(_jmmcs(kind), tree, mesh)]
    return out


def _gathered(results, key, world):
    return torch.cat([r[key] for r in results]).numpy()


@pytest.mark.parametrize("name", list(ranks_mod.LDE_CASES))
def test_sharded_lde_equals_jax(run, ref, name):
    world, results = run
    np.testing.assert_array_equal(_gathered(results, name, world),
                                  ref[name].astype(np.int64))


def test_sharded_lde_equals_jax_on_the_mesh(run, ref):
    world, results = run
    np.testing.assert_array_equal(_gathered(results, "lde", world),
                                  ref["lde_mesh"].astype(np.int64))


@pytest.mark.parametrize("name", list(ranks_mod.LDE_CASES) + ["replicated"])
def test_sharded_lde_equals_single_device(run, name):
    world, results = run
    mat = torch.from_numpy(ranks_mod.inputs(world)[name].astype(np.int64))
    ab = ranks_mod.LDE_CASES.get(name, (0, 0, 1))[2]
    want = coset_lde_batch(F, mat, ab, F.GENERATOR)
    np.testing.assert_array_equal(_gathered(results, name, world),
                                  want.numpy())


def test_replicated_small_case(run):
    """One row a rank: the reference's log_a <= 0 case runs replicated."""
    world, results = run
    assert split(1 if world == 2 else 2, world.bit_length() - 1) is None
    mat = ranks_mod.inputs(world)["replicated"]
    want = np.asarray(j_lde(JF, jnp.asarray(mat), 1, JF.GENERATOR))
    np.testing.assert_array_equal(
        _gathered(results, "replicated", world), want.astype(np.int64))


def _tree_check(results, world, want, kind):
    got = [r[f"tree_{kind}"] for r in results]
    assert len(got[0]) == len(want)
    for lvl, layer in enumerate(want):
        if layer.shape[0] >= world:
            mine = torch.cat([g[lvl] for g in got]).numpy()
        else:  # the top log(world) levels: the same on every rank
            for g in got[1:]:
                assert torch.equal(g[lvl], got[0][lvl])
            mine = got[0][lvl].numpy()
        np.testing.assert_array_equal(mine, np.asarray(layer).astype(
            np.int64))


@pytest.mark.parametrize("kind", KINDS)
def test_sharded_tree_equals_jax(run, ref, kind):
    world, results = run
    _tree_check(results, world, ref[f"tree_{kind}"], kind)


@pytest.mark.parametrize("kind", KINDS)
def test_sharded_tree_equals_single_device(run, kind):
    world, results = run
    mat = torch.from_numpy(ranks_mod.inputs(world)["tree"].astype(np.int64))
    want = [x.numpy() for x in _build_layers(ranks_mod.mmcs(kind), [mat])]
    _tree_check(results, world, want, kind)


@pytest.mark.parametrize("kind", KINDS)
def test_sharded_commit_root_equals_single_device(run, kind):
    """The sharded LDE's blocks committed by the sharded tree give the
    root of the single-device commit of the whole LDE."""
    world, results = run
    mat = torch.from_numpy(ranks_mod.inputs(world)["lde"].astype(np.int64))
    lde = coset_lde_batch(F, mat, 1, F.GENERATOR)
    root = _build_layers(ranks_mod.mmcs(kind), [lde])[-1]
    for r in results:
        assert torch.equal(r[f"commit_{kind}"], root)


@pytest.mark.parametrize("log_n,log_w,want", [
    (8, 1, 4), (8, 2, 4), (9, 2, 4), (4, 2, 2), (3, 2, None), (2, 2, None),
    (1, 1, None), (17, 1, 8), (18, 3, 9), (5, 0, 2)])
def test_split_is_the_references_choice(log_n, log_w, want):
    """log A as the reference's `_dif_sharded` picks it, None where it
    runs replicated (log_a <= 0) or a rank would hold part of a row or
    column."""
    assert split(log_n, log_w) == want
