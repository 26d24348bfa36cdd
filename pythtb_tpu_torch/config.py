"""Device and precision policy for pythtb_tpu_torch.

Host-side model construction works in NumPy float64/complex128, as in
pythtb_tpu.  Device tensors are float64/complex128 on every device: the
H100 runs float64 natively, so reference parity can be checked on the
card itself.  Every function passes these dtypes explicitly; torch's
global default dtype is never changed.

Every matrix product on the slice feeds a phase exp(i*...), so TF32 is
switched off for both matmuls and cuDNN at import, and float32 matmuls
are pinned to full precision.
"""

from __future__ import annotations

import torch

__all__ = ["FLOAT", "COMPLEX", "set_device", "device"]

FLOAT = torch.float64
COMPLEX = torch.complex128

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

_device = torch.device("cpu")


def set_device(dev) -> torch.device:
    """Choose the device that models finalize onto and grids are built
    on ("cpu", "cuda", "cuda:1", or a ``torch.device``).  Returns it."""
    global _device
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev.type not in ("cpu", "cuda"):
        raise ValueError("unsupported device %s (expected cpu or cuda)" % dev)
    _device = dev
    return dev


def device() -> torch.device:
    """The device chosen by :func:`set_device` (CPU until then)."""
    return _device
