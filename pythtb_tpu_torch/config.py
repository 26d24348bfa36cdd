"""Device and precision policy for pythtb_tpu_torch.

Host-side model construction works in NumPy float64/complex128, as in
pythtb_tpu.  Device tensors are float64/complex128 on every device: the
H100 runs float64 natively, so reference parity can be checked on the
card itself.  Every function passes these dtypes explicitly; torch's
global default dtype is never changed.

The card is the default device: until :func:`set_device` is called,
:func:`device` is the current CUDA device, resolved lazily so that the
package imports on a CPU-only torch.  Nothing falls back to the CPU; a
run without a card fails at its first upload with an error naming
``set_device("cpu")``.

Every matrix product on the slice feeds a phase exp(i*...), so TF32 is
switched off for both matmuls and cuDNN at import, and float32 matmuls
are pinned to full precision.
"""

from __future__ import annotations

import torch

__all__ = ["FLOAT", "COMPLEX", "set_device", "device", "checked_device", "require_no_mesh"]

FLOAT = torch.float64
COMPLEX = torch.complex128

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

# None until set_device: the card, resolved at each call to device()
_device = None


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
    """The device chosen by :func:`set_device`; the current CUDA device
    until then (``cuda`` without an index where torch sees no card)."""
    if _device is not None:
        return _device
    if torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cuda")


def checked_device(dev=None) -> torch.device:
    """``dev`` (default :func:`device`), after checking that a CUDA
    device is really there: raises a RuntimeError that names
    ``set_device("cpu")`` otherwise."""
    dev = device() if dev is None else torch.device(dev)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "pythtb_tpu_torch runs on the CUDA device by default, but torch "
            "sees none (torch.cuda.is_available() is false). Call "
            'pythtb_tpu_torch.config.set_device("cpu") to run on the CPU.'
        )
    return dev


def require_no_mesh(mesh):
    """The ``mesh=`` argument of the JAX package's public calls: accepted
    as None (one device); any mesh raises, since sharding over several
    cards is not ported (ROADMAP.md queue 1 item 10)."""
    if mesh is not None:
        raise NotImplementedError(
            "mesh= sharding is not ported: pythtb_tpu_torch runs on one device "
            "(multi-GPU sharding is ROADMAP.md queue 1 item 10); pass mesh=None"
        )
