"""pythtb_tpu_torch -- the PyTorch/CUDA port of pythtb_tpu.

A second package beside the JAX one, with the same PythTB 1.8.0 API for
the slice ported so far: build a :class:`tb_model`, solve bands on
k-lists (``solve_all``), fill a :class:`wf_array` on a device-built grid
(``solve_on_grid``), and read Berry phases, Wilson-loop eigenphases,
Berry fluxes and Chern numbers (``berry_phase``, ``berry_flux``,
:func:`flows.chern_number`).

Tensors live on the device chosen with :func:`config.set_device` (the
CPU until then) in float64/complex128.  On an NVIDIA Hopper card the
hot path runs through four hand-written CUDA kernels (``csrc/``, built
with nvcc at first use); on the CPU the same functions run their plain
PyTorch versions.  This package never imports JAX.
"""

from . import config, flows
from .model import PythtbError, tb_model
from .utils.continuity import no_2pi
from .wf_array import wf_array

__version__ = "0.1.0"

__all__ = ["tb_model", "wf_array", "PythtbError", "no_2pi", "flows", "config", "__version__"]
