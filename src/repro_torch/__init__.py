"""repro_torch — the PyTorch/CUDA port of the `repro` JAX package.

The layout mirrors `repro` (`configs`, `core`, `kernels`, `models`,
`launch`) so each module's counterpart is easy to find. The port imports
torch, numpy and the standard library only — never JAX and never a `repro.*`
module. Every kernel on the serve path is a hand-written CUDA kernel for
Hopper (`kernels/csrc/`), built with `nvcc` at first use and bound through
ctypes; each has a plain PyTorch version beside it that runs for CPU tensors.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU. A missing card raises instead of carrying on on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (--device cpu) "
            "to run the plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
