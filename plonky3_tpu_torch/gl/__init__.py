"""The Goldilocks STARK stack: field adapters, Poseidon2-GL Merkle trees,
the NTT, the FRI PCS and the prover (port of `plonky3_tpu/gl/`)."""
