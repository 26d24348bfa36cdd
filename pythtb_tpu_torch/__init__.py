"""pythtb_tpu_torch -- the PyTorch/CUDA port of pythtb_tpu.

A second package beside the JAX one, with the same PythTB 1.8.0 API for
the slice ported so far: build a :class:`tb_model` (or import one from
Wannier90 with :class:`w90`) and cut, reduce or enlarge it
(``cut_piece``, ``reduce_dim``, ``make_supercell``, ``remove_orb``,
``change_nonperiodic_vector``); solve bands on k-lists (``solve_all``);
fill a :class:`wf_array` on a device-built grid (``solve_on_grid``); and
read Berry phases, Wilson loops, Berry fluxes, Chern and Z2 invariants,
polarization and hybrid Wannier centres (``berry_phase``,
``berry_flux``, ``position_hwf``, :func:`flows.chern_number`,
:func:`flows.wilson_flow`, :func:`flows.z2_invariant`,
:func:`flows.polarization`).  Matrix-free, for large finite or
disordered samples: the kernel-polynomial DOS (:func:`flows.kpm_dos`),
LDOS and Kubo-Bastin conductivity (:mod:`realspace`), Chebyshev time
evolution and quench echoes (:mod:`dynamics`), Peierls fields
(:mod:`magnetic`), interior and lowest eigenpairs
(:func:`flows.solve_window`, :func:`flows.solve_lowest`) with windowed
Wilson loops and Chern numbers, real-space Chern, spin-Chern and Bott
markers (:mod:`realspace`), semi-infinite surface spectra
(:mod:`surface`), and the model zoo with moire and quasicrystal models
(:mod:`models`).  Response, on the velocity operators dH/dk and d2H/dk dk:
the anomalous Hall, Nernst and thermal Hall sweeps, the Berry dipole,
spin Hall conductivity and orbital magnetization (:mod:`flows`), the
Kubo optical tensor, shift and injection currents and the joint DOS
(:mod:`optical`), Boltzmann transport and the Edelstein tensor
(:mod:`boltzmann`, with the Chambers magnetotransport), the quantum
geometric tensor family with the Drude weight, effective masses and k.p
models (:mod:`geometry`), Fermi surfaces, the linear-tetrahedron DOS and
dHvA orbits (:mod:`fermisurface`), and the Lindhard / RPA susceptibility
with the Stoner analysis (:mod:`response`).  Green's functions and disorder: NEGF
transport through two- and multi-terminal devices (:mod:`negf`),
Lyapunov spectra and localization measures (:mod:`localization`),
impurity T-matrices and bound states (:mod:`impurity`), and the
coherent-potential approximation (:mod:`disorder`).  Topology beyond the
Chern number: nested Wilson loops, sector, spin and valley Chern
numbers, parity indicators, Weyl nodes and their charges, the second
Chern number and the axion angle (:mod:`flows`), with densities of
states, band velocities and spin textures; the Hofstadter butterfly and
its Streda labels (:mod:`magnetic`); and padded families of models with
different graphs solved together (:func:`family`).  Gauges and Wannier
functions: parameter families on one grid (``solve_on_grid_models``),
the smooth parallel-transport gauge and adiabatic following
(``smooth_gauge``, ``adiabatic_evolve``), Wannier interpolation with
maximal localization and disentanglement (:mod:`wannier`), band
unfolding (:mod:`unfold`), entanglement spectra (:mod:`entanglement`)
and point-group tools with the Chern indicator (:mod:`symmetry`);
PythTB's host API: ``display``, ``hamiltonian_string``, ``visualize``,
and ``save``/``load`` of models and wf_arrays in the JAX package's
``.npz`` layout; and the interacting stack: exact diagonalization of
clusters with many-body topology (:mod:`ed`), single-site DMFT with an ED
impurity solver (:mod:`dmft`), Hartree-Fock and BCS mean fields
(:mod:`meanfield`), BdG models and Majorana numbers (:mod:`bdg`), and
Pade continuation (:mod:`continuation`); and bosons: phonon bands,
heat capacity and thermal conductivity of force-constant models
(:mod:`phonon`), electron-phonon linewidths and the Eliashberg function
(:mod:`eph`), and linear spin waves with magnon Berry curvature, thermal
Hall conductivity and the neutron structure factor (:mod:`magnon`); and
excitons from the Bethe-Salpeter equation with their absorption
(:mod:`exciton`), and band energies and Chern numbers as functions of
the model parameters, differentiable (:func:`flows.energy_fn`) or over a
member axis (:func:`flows.chern_fn`).

Tensors live on the CUDA device unless :func:`config.set_device` chooses
another (``set_device("cpu")`` for the CPU), in float64/complex128.  On
an NVIDIA Hopper card the hot paths run through 30 hand-written CUDA
kernels (kernels 1-29 and 11b, with the extra modes of kernels 1, 12, 14,
16, 20, 22, 23 and 28; ``csrc/``, built with nvcc at first use); on the CPU
the same functions run their plain PyTorch versions.  This package
never imports JAX.
"""

from . import (bdg, boltzmann, config, continuation, disorder, dmft, dynamics, ed, entanglement, eph, exciton,
               fermisurface, flows, floquet, geometry, impurity, localization, magnetic, magnon, meanfield, models,
               negf, optical, phonon, realspace, response, surface, symmetry, unfold, wannier)
from .family import ModelFamily, family
from .model import PythtbError, tb_model
from .utils.continuity import no_2pi
from .w90 import w90
from .wf_array import wf_array

__version__ = "0.2.0"
# feature parity target (the reference release this framework mirrors)
PYTHTB_COMPAT_VERSION = "1.8.0"

__all__ = [
    "tb_model", "wf_array", "w90", "PythtbError", "no_2pi", "flows", "config", "dynamics",
    "magnetic", "models", "realspace", "surface", "optical", "boltzmann", "geometry", "negf", "localization",
    "impurity", "disorder", "family", "ModelFamily", "wannier", "unfold", "entanglement", "symmetry",
    "ed", "dmft", "meanfield", "bdg", "continuation", "fermisurface", "response", "floquet", "phonon", "eph",
    "magnon", "exciton",
    "__version__", "PYTHTB_COMPAT_VERSION",
]
