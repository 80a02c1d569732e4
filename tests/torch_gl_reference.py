"""The JAX package's Goldilocks prover as the Goldilocks tests run it on
the CPU, and the proof plumbing between the two packages.

The reference's Goldilocks pair arithmetic is slow to compile here: one
jitted Poseidon2-GL permutation takes minutes of XLA compile on the CPU,
and `tests/test_goldilocks_stark.py::test_gl_fibonacci_e2e` did not
finish in 15 minutes. So the reference prover runs under
`jax.disable_jit()` (op by op, the same functions), with the reference's
own host-exact hashing: its MMCS builds a tree with the sponge's and the
compressor's `*_np` functions when the sponge says `host_only`
(`plonky3_tpu/merkle/mmcs.py::MerkleTreeMmcs.commit`, `_build_layers_np`),
and its grind is the smallest witness by `check_witness` on copies of the
transcript, as `plonky3_tpu/challenger/hash_challenger.py::grind` does.
The reference's own tests hold those host paths equal to its device
kernels (`tests/test_goldilocks_device.py`, `tests/test_goldilocks_stark.py`
::test_gl_merkle_device_vs_host)."""

import copy
import dataclasses

import jax
import numpy as np

from plonky3_tpu.fields.goldilocks import Goldilocks as JG
from plonky3_tpu.fri import proof as jfri_proof
from plonky3_tpu.gl import merkle as jmerkle
from plonky3_tpu.gl import stark as jstark
from plonky3_tpu.gl.pcs import GlTwoAdicFriPcs
from plonky3_tpu.merkle.extension_mmcs import ExtensionMmcs
from plonky3_tpu.stark import proof as jstark_proof
from plonky3_tpu.stark.config import StarkConfig
from plonky3_tpu_torch.fri import proof as fri_proof
from plonky3_tpu_torch.stark import proof as stark_proof

P = JG.P


class HostSponge(jmerkle.GLPoseidonSponge):
    host_only = True


class HostGrindChallenger(jstark.GLDuplexChallenger):
    def grind(self, bits, batch=None):
        if bits == 0:
            return 0
        w = 0
        while not copy.deepcopy(self).check_witness(bits, w):
            w += 1
        if not self.check_witness(bits, w):
            raise AssertionError("the witness failed its replay")
        return w


def reference_config(params, cap_height=0):
    """The reference's goldilocks_stark_config with host hashing."""
    mmcs = jmerkle.GLMerkleTreeMmcs(sponge=HostSponge(),
                                    compressor=jmerkle.GLCompressor(),
                                    cap_height=cap_height)
    pcs = GlTwoAdicFriPcs(fri=params, mmcs=mmcs,
                          fri_mmcs=ExtensionMmcs(inner=mmcs, D=2,
                                                 wire_cols=4))
    return StarkConfig(pcs=pcs, challenger_factory=HostGrindChallenger)


def reference_prove(config, air, trace_u64, publics):
    with jax.disable_jit():
        return jstark.prove_gl(config, air, trace_u64, publics)


def fib_trace(log_n, a=0, b=1):
    """tests/test_goldilocks_stark.py::_fib_trace_gl: (n, 2) uint64 rows
    and the public values."""
    n = 1 << log_n
    rows = np.zeros((n, 2), dtype=np.uint64)
    x, y = a % P, b % P
    for i in range(n):
        rows[i] = (x, y)
        x, y = y, (x + y) % P
    return rows, [a % P, b % P, int(rows[-1, 1])]


def as_plain(x):
    """Nested tuples of ints (a dataclass == would also compare classes)."""
    if dataclasses.is_dataclass(x):
        return tuple((f.name, as_plain(getattr(x, f.name)))
                     for f in dataclasses.fields(x))
    if isinstance(x, (list, tuple)):
        return tuple(as_plain(v) for v in x)
    return int(x) if isinstance(x, (int, np.integer)) else x


def _classes(*mods):
    return {cls.__name__: cls for mod in mods for cls in vars(mod).values()
            if dataclasses.is_dataclass(cls)}


_REF = _classes(jstark_proof, jfri_proof)
_PORT = _classes(stark_proof, fri_proof)


def _rebuild(x, classes):
    if dataclasses.is_dataclass(x):
        return classes[type(x).__name__](**{
            f.name: _rebuild(getattr(x, f.name), classes)
            for f in dataclasses.fields(x)})
    if isinstance(x, list):
        return [_rebuild(v, classes) for v in x]
    if isinstance(x, tuple):
        return tuple(_rebuild(v, classes) for v in x)
    return int(x) if isinstance(x, np.integer) else x


def to_reference(proof):
    return _rebuild(proof, _REF)


def to_port(proof):
    return _rebuild(proof, _PORT)
