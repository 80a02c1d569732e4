"""test_torch_batch.py's cases under the keccak config: the three
instances' heights (16, 8 and 64 rows) differ, so the keccak tree
injects the shorter matrices as it climbs, through the compression
entry (on the card `compress_kernel`); the proof equals the JAX
`prove_batch`'s, both verifiers accept it, and the tampered copies are
rejected by both alike."""

import pytest

from test_torch_batch import (  # noqa: F401 (collected here too)
    batch_proofs,
    test_proof_equals_reference,
    test_tampered_proof_rejected_as_reference,
)


@pytest.fixture(scope="module")
def proofs():
    return batch_proofs("keccak")
