"""Device resolution for every entry point of the port.

The port runs on the card unless the caller asks for the CPU: a request for
CUDA on a machine without one raises, it never falls back silently.

f32 parity: cuDNN convolutions default to TF32 on Ampere and later, which
keeps about three decimal digits; the JAX reference computes them in full
f32.  Resolving a CUDA device turns TF32 off for both matmuls and cuDNN.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``device`` → ``torch.device``; raises when CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but torch.cuda.is_available() "
                "is False; pass device='cpu' to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r} (cuda or cpu)")
    return dev
