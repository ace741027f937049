"""PyTorch + CUDA port of `distributed_pytorch_tpu` for NVIDIA Hopper.

The JAX package beside this one is the reference; this package mirrors its
module paths and names (`models/gpt.py` <-> `models/gpt.py`, ...) so every
counterpart is easy to find, and shares no code with it. Every TPU kernel
on a ported path is a hand-written CUDA kernel here (`csrc/`), built at
first use by `ops/cuda_build.py`, with a plain PyTorch version beside it
that the CPU runs.

Entry points run on the card unless the caller names the CPU
(`device="cpu"`, the serve CLI's `--cpu`); with no CUDA device and no
explicit request they raise (`resolve_device`).
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `cuda` by default, the CPU only
    when asked for. Never falls back to the CPU quietly."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible; pass device='cpu' (or the "
                "CLI's --cpu) to run on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but no CUDA "
                           "device is visible")
    return dev
