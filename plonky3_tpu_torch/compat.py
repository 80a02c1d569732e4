"""Carry inputs and parameters from other code into the port.

A STARK has no weights: what two provers must share is the constants, the
FRI parameters and the trace inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from .fri.config import FriParameters

_FRI_FIELDS = ("log_blowup", "log_final_poly_len", "max_log_arity",
               "num_queries", "commit_proof_of_work_bits",
               "query_proof_of_work_bits")


def trace_inputs_from_numpy(arr_u32: np.ndarray, device) -> torch.Tensor:
    """Montgomery-form uint32 permutation inputs (as `rand_np` makes them)
    -> an int64 tensor on `device`."""
    arr = np.asarray(arr_u32)
    if arr.dtype != np.uint32:
        raise ValueError(f"expected uint32 words, got {arr.dtype}")
    return torch.from_numpy(arr.astype(np.int64)).to(device)


def fri_params_from(obj) -> FriParameters:
    """Copy the fields of any FriParameters-like object."""
    return FriParameters(**{k: int(getattr(obj, k)) for k in _FRI_FIELDS})
