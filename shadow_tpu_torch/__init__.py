"""PyTorch/CUDA port of the shadow_tpu device network plane.

The JAX package `shadow_tpu` stays the reference; this package computes
the same plane bitwise with PyTorch tensors, runs the JAX package's four
Pallas kernels as hand-written CUDA kernels for Hopper (`csrc/`), and
runs the whole scenario corpus (`workloads/`), its lossy and serving
entries through the flow and compute planes (`tpu/flows.py`,
`tpu/compute.py`).
`python -m shadow_tpu_torch CONFIG` (`cli.py`, `core/manager.py`) runs a
Shadow config as the JAX package's CLI does, over the port's copy of the
object plane (hosts, the simulated TCP/UDP stack, the built-in apps),
its cross-host packets on the CPU routing, the device transport
(`tpu/transport.py`) or the flow engine (`tpu/floweng.py`).
It imports nothing of `shadow_tpu` and no JAX.

Every entry point takes `device=None`, which means the CUDA card. With
no card the call raises unless the caller asks for the CPU explicitly
(`device="cpu"`), where each kernel wrapper runs its plain PyTorch
version.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`None` means the CUDA card; raise rather than run quietly on the
    CPU when there is none. Anything else is passed to `torch.device`."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "shadow_tpu_torch: no CUDA device is available; pass "
                "device='cpu' to run the plain PyTorch versions on the CPU")
        return torch.device("cuda")
    return torch.device(device)
