"""Per-stage wall-clock spans for the prover (the reference's `spans`
option of `stark/prover.py::prove`)."""

from __future__ import annotations

import time

import torch


def stage_timer(spans, device):
    """A mark(name) function that adds the seconds since the previous mark
    to spans[name]. On a CUDA device it first waits for the device, so a
    stage holds its own device work. A no-op when spans is None."""
    if spans is None:
        return lambda name: None
    last = [time.perf_counter()]

    def mark(name):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        now = time.perf_counter()
        spans[name] = spans.get(name, 0.0) + now - last[0]
        last[0] = now

    return mark
