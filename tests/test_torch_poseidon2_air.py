"""plonky3_tpu_torch Poseidon2 and Poseidon2VectorAir against plonky3_tpu:
the permutation, the trace words, the constraint layout and the alpha fold
of the quotient, plus the device defaults of the entry points."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from plonky3_tpu.air.api import get_symbolic_layout
from plonky3_tpu.fields import KoalaBear as JF
from plonky3_tpu.fields import KoalaBearExt4 as JE
from plonky3_tpu.hashes.poseidon2 import default_poseidon2 as j_poseidon2
from plonky3_tpu.models.poseidon2_air import (
    Poseidon2VectorAir as JAir,
    generate_vectorized_trace as j_generate,
)
from plonky3_tpu_torch.air.api import (
    get_symbolic_layout as port_symbolic_layout,
)
from plonky3_tpu_torch.fields import KoalaBear as F
from plonky3_tpu_torch.fields import KoalaBearExt4 as E
from plonky3_tpu_torch.fri.config import FriParameters
from plonky3_tpu_torch.hashes.poseidon2 import default_poseidon2
from plonky3_tpu_torch.models.poseidon2_air import (
    Poseidon2VectorAir,
    generate_vectorized_trace,
)
from plonky3_tpu_torch.stark.config import keccak_stark_config


def test_permutation_matches_reference():
    x = JF.rand_np(np.random.default_rng(0), (20, 16))
    got = default_poseidon2(F, 16).permute(torch.from_numpy(
        x.astype(np.int64)))
    assert np.array_equal(got.numpy(), j_poseidon2(JF, 16).permute_np(x))


@pytest.mark.parametrize("vector_len", [1, 8])
def test_constraint_layout_matches_symbolic_pass(vector_len):
    """The port's symbolic pass gives the layout the AIR used to state
    itself (one constraint per post column: 8 full rounds of V·W and PR
    partial rounds of V, degree 3) and the reference's symbolic layout."""
    ours = Poseidon2VectorAir(F, 16, vector_len=vector_len)
    ref = JAir(JF, 16, vector_len=vector_len)
    assert ours.width == ref.width
    stated = (2 * 4 * vector_len * 16 + ours.PR * vector_len, 3)
    assert port_symbolic_layout(ours) == stated == get_symbolic_layout(ref)


@pytest.mark.parametrize("vector_len", [1, 8])
def test_trace_matches_reference(vector_len):
    inputs = JF.rand_np(np.random.default_rng(vector_len), (8 * vector_len,
                                                            16))
    want, want_out = j_generate(JAir(JF, 16, vector_len=vector_len),
                                jnp.asarray(inputs))
    got, got_out = generate_vectorized_trace(
        Poseidon2VectorAir(F, 16, vector_len=vector_len), inputs,
        device="cpu")
    assert got.device.type == "cpu"
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(got_out.numpy(), np.asarray(want_out))


@pytest.mark.parametrize("vector_len", [1, 8])
def test_fold_matches_reference(vector_len):
    """Random (non-trace) rows, so every constraint is nonzero."""
    ref = JAir(JF, 16, vector_len=vector_len)
    ours = Poseidon2VectorAir(F, 16, vector_len=vector_len)
    rng = np.random.default_rng(10 + vector_len)
    local = JF.rand_np(rng, (8, ref.width))
    k, _ = get_symbolic_layout(ref)
    alpha_pows = JF.rand_np(rng, (k, 4))
    want = ref.fold_constraints_device(JF, JE, jnp.asarray(local), None,
                                       None, None, jnp.asarray(alpha_pows))
    got = ours.fold_constraints_device(
        F, E, torch.from_numpy(local.astype(np.int64)), None, None, None,
        torch.from_numpy(alpha_pows.astype(np.int64)))
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_entry_points_default_to_cuda():
    """Without a card the default device raises; device='cpu' runs."""
    air = Poseidon2VectorAir(F, 16, vector_len=1)
    inputs = F.rand_np(np.random.default_rng(0), (4, 16))
    params = FriParameters.new_testing()
    if torch.cuda.is_available():
        assert keccak_stark_config(F, E, params).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        generate_vectorized_trace(air, inputs)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        keccak_stark_config(F, E, params)
    assert keccak_stark_config(F, E, params, device="cpu").device.type \
        == "cpu"
