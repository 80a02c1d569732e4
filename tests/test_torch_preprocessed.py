"""Preprocessed traces in plonky3_tpu_torch against plonky3_tpu's
(`stark/preprocessed.py`): EvenZeroAir (a main column that must be zero
where a fixed selector column is one), the reference's test AIR, under
the Poseidon2 config. The setup's root and the proofs equal the JAX
package's at log_n 4 and 5; each verifier accepts the other's honest
proof, and a trace that breaks the constraint is proven by both and
rejected by both verifiers with the same error class and message."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plonky3_tpu.air.api import BaseAir as JBaseAir
from plonky3_tpu.fields import KoalaBear as JF
from plonky3_tpu.fields import KoalaBearExt4 as JE
from plonky3_tpu.fri.config import FriParameters as JFriParameters
from plonky3_tpu.stark import preprocessed as j_pre
from plonky3_tpu.stark.config import poseidon2_stark_config as j_config
from plonky3_tpu_torch.air.api import BaseAir
from plonky3_tpu_torch.compat import fri_params_from
from plonky3_tpu_torch.fields import KoalaBear as F
from plonky3_tpu_torch.fields import KoalaBearExt4 as E
from plonky3_tpu_torch.stark import preprocessed as pre
from plonky3_tpu_torch.stark.config import poseidon2_stark_config
from plonky3_tpu_torch.stark.verifier import VerificationError
from test_torch_prove import _raised, as_plain, to_port, to_reference

PARAMS = JFriParameters.new_testing()


def _even_zero(base):
    class EvenZeroAir(base):
        """The main column is zero wherever the fixed selector (even
        rows) is one."""

        width = 1
        num_public_values = 0

        def __init__(self, field):
            self.field = field

        def preprocessed_trace(self, log_n):
            sel = np.zeros((1 << log_n, 1), dtype=np.uint32)
            sel[::2, 0] = 1
            return sel

        def eval(self, b):
            b.assert_zero(b.preprocessed.local[0] * b.main.local[0])

    return EvenZeroAir


EvenZeroAir = _even_zero(BaseAir)
JEvenZeroAir = _even_zero(JBaseAir)


def _trace(log_n, seed, bad):
    t = np.random.default_rng(seed).integers(1, F.P, size=(1 << log_n, 1),
                                             dtype=np.uint32)
    t[::2, 0] = 0
    if bad:
        t[2, 0] = 7  # breaks the selector's constraint
    return JF.to_monty_np(t)


@pytest.fixture(scope="module", params=[(5, 2, False), (4, 3, True)],
                ids=["log_n5", "log_n4_bad"])
def case(request):
    log_n, seed, bad = request.param
    mat = _trace(log_n, seed, bad)
    j_cfg = j_config(JF, JE, PARAMS)
    j_air = JEvenZeroAir(JF)
    j_setup = j_pre.setup_preprocessed(j_cfg, j_air, log_n)
    ref = j_pre.prove_with_preprocessed(j_cfg, j_air, jnp.asarray(mat), [],
                                        j_setup)
    cfg = poseidon2_stark_config(F, E, fri_params_from(PARAMS),
                                 device="cpu")
    air = EvenZeroAir(F)
    setup = pre.setup_preprocessed(cfg, air, log_n)
    ours = pre.prove_with_preprocessed(
        cfg, air, torch.from_numpy(mat.astype(np.int64)), [], setup)
    return dict(bad=bad, ref=ref, ours=ours, j_cfg=j_cfg, j_air=j_air,
                j_setup=j_setup, cfg=cfg, air=air, setup=setup)


def test_proof_equals_reference(case):
    assert case["setup"].root == case["j_setup"].root
    assert case["setup"].width == case["j_setup"].width == 1
    assert as_plain(case["ours"]) == as_plain(case["ref"])


def test_verifiers_agree(case):
    def ours():
        pre.verify_with_preprocessed(case["cfg"], case["air"],
                                     to_port(case["ref"]), [],
                                     case["setup"].root, 1)

    def theirs():
        j_pre.verify_with_preprocessed(case["j_cfg"], case["j_air"],
                                       to_reference(case["ours"]), [],
                                       case["j_setup"].root, 1)

    if not case["bad"]:
        ours()
        theirs()
        return
    got, want = _raised(ours), _raised(theirs)
    assert got == want == ("VerificationError", "OodEvaluationMismatch")
    with pytest.raises(VerificationError):
        ours()
