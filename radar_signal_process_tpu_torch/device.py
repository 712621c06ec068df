"""Device and float policy of the port.

Every tensor of the chain is complex64 or float32, as in the JAX package.
Float32 matrix products run in full float32: TF32 keeps about three decimal
digits, which the RDM parity tolerance does not allow.
"""

from __future__ import annotations

import torch

COMPLEX = torch.complex64
REAL = torch.float32


def resolve_device(name: str | torch.device = "cuda") -> torch.device:
    """``name`` as a ``torch.device``, with TF32 switched off.

    Raises when a CUDA device is asked for and none is available: nothing
    on the port's path moves to the CPU silently.
    """
    dev = torch.device(name)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {name!r} (cpu or cuda)")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(name)!r} requested but torch.cuda.is_available() "
            "is False"
        )
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev
