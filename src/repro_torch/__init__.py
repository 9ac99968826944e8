"""PyTorch port of ``repro`` for NVIDIA Hopper (H100).

A package of its own beside the JAX one: it imports ``torch`` and never
``jax`` or anything of ``repro``, and keeps ``repro``'s module names so that
each function's counterpart is easy to find.  Kernels that the JAX package
wrote in Pallas for the TPU are written here by hand in CUDA C++
(``kernels/csrc``), with a plain PyTorch version beside each.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with
no card they raise rather than carry on on the CPU (``resolve_device``).
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on; raises when CUDA is asked for and
    there is no card, so that nothing quietly falls back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but no CUDA device is available; "
            "pass device='cpu' to run on the CPU")
    return dev
