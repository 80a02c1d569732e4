"""plonky3_tpu_torch — the PyTorch/CUDA port of plonky3_tpu.

The package mirrors `plonky3_tpu/` module for module and produces the same
proofs bit for bit. It imports torch and numpy only: no JAX, nothing of
`plonky3_tpu`, and no CUDA toolchain at import time. The hand-written
kernels (`csrc/*.cu`) are compiled with nvcc and loaded with ctypes the
first time a wrapper sees a CUDA tensor (`kernels.py`).

Word type. Plain tensor code keeps field elements as int64 tensors holding
the canonical Montgomery-form value in [0, P), and 32-bit digest words as
int64 in [0, 2^32). Every reference field op returns the canonical value,
so an exact int64 formula (`a*b % P * R^-1 % P` for the Montgomery
product) gives the same bits as the u32 REDC. Products of two canonical
values are < 2^62, so sums reduce each product mod P first. The kernels
take and return 32-bit words in int32 tensors (the u32 bits); their
wrappers convert at the boundary.

Devices. Entry points (`generate_vectorized_trace`, the config builders)
run on `cuda` unless the caller passes `device="cpu"`, and raise when no
card is present. `prove` runs on the device of the trace it is given. On a
CPU tensor each kernel wrapper runs the kernel's plain PyTorch version; on
a CUDA tensor it launches the kernel or raises.
"""

__all__ = ["default_device"]


def default_device(device=None):
    """Resolve an entry point's device: `cuda` unless the caller names
    one. Raises when CUDA is asked for and no card is present."""
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU"
        )
    return dev
