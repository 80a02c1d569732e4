"""Carry inputs and parameters from other code into the port, and the
reference's golden-fixture compatibility layer.

A STARK has no weights: what two provers must share is the constants, the
FRI parameters and the trace inputs (this module). The submodules port
`plonky3_tpu/compat/`: `smallrng` (rand's SmallRng, the fixtures'
Poseidon2 constants), `fixture_configs` (the fixtures' STARK configs),
`batch_fixture_airs` (the batch fixture's AIRs and trace), and the
conversions of the port's proofs to the postcard wire records and back
(`uni_stark_wire`, `batch_wire`; `serde/` writes the bytes).
"""

from __future__ import annotations

import numpy as np
import torch

from ..fri.config import FriParameters

_FRI_FIELDS = ("log_blowup", "log_final_poly_len", "max_log_arity",
               "num_queries", "commit_proof_of_work_bits",
               "query_proof_of_work_bits")


def trace_inputs_from_numpy(arr_u32: np.ndarray, device,
                            F=None) -> torch.Tensor:
    """uint32 field words -> an int64 tensor on `device`: a Monty31
    field's Montgomery form (as `rand_np` makes them), or Mersenne-31's
    canonical words, its wire form (a trace or permutation inputs).
    With `F`, every word must be below F.P."""
    arr = np.asarray(arr_u32)
    if arr.dtype != np.uint32:
        raise ValueError(f"expected uint32 words, got {arr.dtype}")
    if F is not None and arr.size and int(arr.max()) >= F.P:
        raise ValueError(f"a word >= {F.name}'s P: not a canonical word")
    return torch.from_numpy(arr.astype(np.int64)).to(device)


def fri_params_from(obj) -> FriParameters:
    """Copy the fields of any FriParameters-like object."""
    return FriParameters(**{k: int(getattr(obj, k)) for k in _FRI_FIELDS})


def _ints(x):
    """Nested sequences of integers (numpy included) -> tuples of ints."""
    if isinstance(x, (int, np.integer)):
        return int(x)
    return tuple(_ints(v) for v in x)


def field_from(obj):
    """The port's field (or its degree-4 or degree-8 extension) with the
    constants of another package's field object: matched by name, and
    every normative constant must agree (ValueError otherwise)."""
    from .. import fields
    from ..fields.mersenne31 import M31Ext3, Mersenne31
    from ..fields.qm31 import QM31

    base = getattr(obj, "base", None)
    if getattr(obj, "name", None) == "QM31":  # CM31[u], no binomial data
        port, keys = QM31, ("D",)
    elif base is not None:  # a binomial extension
        port = {("KoalaBear", 4): fields.KoalaBearExt4,
                ("KoalaBear", 8): fields.KoalaBearExt8,
                ("BabyBear", 4): fields.BabyBearExt4,
                ("BabyBear", 8): fields.BabyBearExt8,
                ("Mersenne31", 3): M31Ext3}.get((base.name, obj.D))
        keys = ("D", "W", "DTH_ROOT", "EXT_GENERATOR", "EXT_TWO_ADICITY")
    elif getattr(obj, "name", None) == "Mersenne31":
        port, keys = Mersenne31, ("P", "TWO_ADICITY", "GENERATOR")
    else:
        port = {"KoalaBear": fields.KoalaBear,
                "BabyBear": fields.BabyBear}.get(getattr(obj, "name", None))
        keys = ("P", "MU", "TWO_ADICITY", "GENERATOR", "TWO_ADIC_GENERATORS")
    if port is None:
        raise ValueError(f"no port field for {obj!r}")
    for k in keys:
        got, want = _ints(getattr(obj, k)), _ints(getattr(port, k))
        if got != want:
            raise ValueError(f"{k} differs: {got} against the port's {want}")
    if base is not None:
        field_from(base)
    return port


def poseidon2_from(perm):
    """A port `Poseidon2` with another package's permutation's field (by
    `field_from`), width, s-box degree and round constants."""
    from ..hashes.poseidon2 import Poseidon2

    return Poseidon2(
        F=field_from(perm.F), width=int(perm.width), d=int(perm.d),
        rc_external_initial=_ints(perm.rc_external_initial),
        rc_external_final=_ints(perm.rc_external_final),
        rc_internal=_ints(perm.rc_internal))


def poseidon1_from(perm):
    """A port `Poseidon1` with another package's permutation's field (by
    `field_from`), width, s-box degree, half the full rounds, round
    constants and MDS first row."""
    from ..hashes.poseidon1 import Poseidon1

    return Poseidon1(
        F=field_from(perm.F), width=int(perm.width), d=int(perm.d),
        half_full=int(perm.half_full), rc=_ints(perm.rc),
        mds_first_row=_ints(perm.mds_first_row))
