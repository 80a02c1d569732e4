"""The generic quotient of plonky3_tpu_torch folded by row blocks: for
FibonacciAir, KeccakAir (64 rows), Poseidon2VectorAir through the generic
path, Blake3Air (8 rows) and the two periodic AIRs, the quotient straight
from the committed bit-reversed LDE (`committed_quotient`) and from
natural rows (`quotient_values`) is bit-identical for one block, two and
many, and equal to one fold of the whole domain over the natural rows,
the form the JAX package's `quotient_values` takes. In the periodic AIRs
a block is shorter than the period's repeat over the quotient domain.
Also the block size that free memory gives, and the block counter."""

import numpy as np
import pytest
import torch

from plonky3_tpu_torch.air.api import (
    get_log_num_quotient_chunks,
    get_symbolic_layout,
)
from plonky3_tpu_torch.fields import KoalaBear as F
from plonky3_tpu_torch.fields import KoalaBearExt4 as E
from plonky3_tpu_torch.fri.config import FriParameters
from plonky3_tpu_torch.models.blake3_air import (
    Blake3Air,
    generate_blake3_trace,
)
from plonky3_tpu_torch.models.fibonacci import (
    FibonacciAir,
    generate_fibonacci_trace,
)
from plonky3_tpu_torch.models.keccak_air import (
    KeccakAir,
    generate_keccak_trace,
)
from plonky3_tpu_torch.models.poseidon2_air import (
    Poseidon2VectorAir,
    generate_vectorized_trace,
)
from plonky3_tpu_torch.stark import prover
from plonky3_tpu_torch.stark.config import keccak_stark_config
from torch_periodic_airs import NoNextRowAir, PeriodicAir, periodic_trace

PARAMS = FriParameters(log_blowup=1, log_final_poly_len=0, max_log_arity=3,
                       num_queries=10, commit_proof_of_work_bits=0,
                       query_proof_of_work_bits=8)


class _GenericPoseidon2(Poseidon2VectorAir):
    """Poseidon2VectorAir without its own fold: its `eval` runs over the
    prover backend."""

    def __getattribute__(self, name):
        if name == "fold_constraints_device":
            raise AttributeError(name)
        return super().__getattribute__(name)


def _case(name):
    """(air, (n, w) Montgomery trace, public values)."""
    rng = np.random.default_rng(11)
    if name == "fibonacci":
        trace, publics = generate_fibonacci_trace(F, 4, device="cpu")
        return FibonacciAir(F), trace, publics
    if name == "keccak":
        inputs = rng.integers(0, 1 << 64, size=(2, 25), dtype=np.uint64)
        return KeccakAir(F), generate_keccak_trace(F, inputs, "cpu"), []
    if name == "poseidon2":
        air = _GenericPoseidon2(F, 16, vector_len=1)
        trace, _ = generate_vectorized_trace(
            air, F.rand_np(rng, (16, 16)), device="cpu")
        return air, trace, []
    if name == "blake3":
        inputs = rng.integers(0, 1 << 32, size=(8, 24),
                              dtype=np.uint64).astype(np.uint32)
        return Blake3Air(F), generate_blake3_trace(F, inputs, "cpu"), []
    air = PeriodicAir(F) if name == "periodic" else NoNextRowAir(F)
    rows = periodic_trace(F.P, 32)
    return air, torch.from_numpy(F.to_monty_np(rows).astype(np.int64)), []


# block sizes beside the whole domain: half of it, and the smallest
# block each case runs in reasonable time
MANY = {"fibonacci": 1, "keccak": 8, "poseidon2": 2, "blake3": 2,
        "periodic": 2, "no_next_row": 2}


@pytest.mark.parametrize("name", sorted(MANY))
def test_blocks_give_the_whole_domain_fold(name):
    air, trace, publics = _case(name)
    cfg = keccak_stark_config(F, E, PARAMS, device="cpu")
    pcs = cfg.pcs
    n = trace.shape[0]
    domain = pcs.natural_domain_for_degree(n)
    qd = domain.create_disjoint_domain(n << get_log_num_quotient_chunks(air))
    data = pcs.commit([(domain, trace)])
    k, _ = get_symbolic_layout(air)
    rng = np.random.default_rng(7)
    pows = torch.from_numpy(F.rand_np(rng, (k, E.D)).astype(np.int64))
    publics_m = torch.from_numpy(F.to_monty_np(np.asarray(
        publics, dtype=np.uint32)).astype(np.int64))
    natural = pcs.get_evaluations_on_domain(data, 0, qd)
    prefix = pcs.get_evaluations_on_domain(data, 0, qd, order="bitrev")
    args = (cfg, air, domain, qd)
    want = prover.quotient_values(*args, natural, publics_m, pows,
                                  block_rows=qd.size)
    assert want.shape == (qd.size, E.D)
    if name in ("periodic", "no_next_row"):
        # the periodic values repeat every qd.size / r = 4 rows
        assert MANY[name] < 4 and qd.size == 32
    for rows in (qd.size, qd.size // 2, MANY[name]):
        before = prover.FOLD_BLOCKS["count"]
        got = prover.committed_quotient(*args, prefix, publics_m, pows,
                                        block_rows=rows)
        assert prover.FOLD_BLOCKS["count"] - before == qd.size // rows
        assert prover.FOLD_BLOCKS["rows"] == rows
        assert torch.equal(got, want)
        assert torch.equal(prover.quotient_values(
            *args, natural, publics_m, pows, block_rows=rows), want)


def test_block_rows_from_free_memory(monkeypatch):
    """A power of two dividing Nq, from the width and the widest stack:
    Blake3Air (9,168 columns, stacks of 1,792) gets smaller blocks than
    KeccakAir (2,633, 100) in the same memory, and at least one row."""
    monkeypatch.setattr(prover, "_free_bytes", lambda device: 1 << 30)
    cpu = torch.device("cpu")
    blake3 = prover.fold_block_rows(Blake3Air(F), 1 << 18, cpu)
    keccak = prover.fold_block_rows(KeccakAir(F), 1 << 18, cpu)
    per_row = 8 * (prover._ROW_COPIES * 9168
                   + prover._STACK_COPIES * 1792)
    budget = int((1 << 30) * prover._MEMORY_SHARE)
    assert blake3 == 1 << (budget // per_row).bit_length() - 1
    assert 1 <= blake3 < keccak <= 1 << 18
    for rows in (blake3, keccak):
        assert rows & (rows - 1) == 0
    assert prover.fold_block_rows(KeccakAir(F), 64, cpu) == 64
    monkeypatch.setattr(prover, "_free_bytes", lambda device: 0)
    assert prover.fold_block_rows(Blake3Air(F), 1 << 18, cpu) == 1


@pytest.mark.parametrize("rows", [0, 3, 64])
def test_block_rows_must_divide_the_domain(rows):
    air, trace, publics = _case("fibonacci")
    cfg = keccak_stark_config(F, E, PARAMS, device="cpu")
    domain = cfg.pcs.natural_domain_for_degree(trace.shape[0])
    qd = domain.create_disjoint_domain(trace.shape[0])
    k, _ = get_symbolic_layout(air)
    with pytest.raises(ValueError, match="fold block"):
        prover.quotient_values(
            cfg, air, domain, qd, torch.zeros((qd.size, 2),
                                              dtype=torch.int64),
            torch.zeros(3, dtype=torch.int64),
            torch.zeros((k, E.D), dtype=torch.int64), block_rows=rows)
