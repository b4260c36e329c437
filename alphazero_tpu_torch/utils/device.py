"""Device resolution shared by the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on.  The default is the GPU, and a
    request for it raises when there is none: the port never moves to the
    CPU unless the caller asks for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU")
    return dev


def full_fp32():
    """Float32 matmuls and convolutions in full float32 on the GPU (TF32
    off), as the JAX package computes them; set where a net is built, for
    inference and training alike."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
