"""Fused end-to-end device pipelines (counterpart of ``pythtb_tpu.flows``).

These compute the same objects as the ``wf_array`` route (solve_on_grid
+ impose_pbc + berry_flux) with everything on the device: the k-grid is
built there, assembled (kernel 1), diagonalized (kernel 2 at two
bands), extended by the periodic gauge, reduced to link determinants
(kernel 3) and summed over plaquettes (kernel 4); only the flux comes
back.  The other flows of the JAX package are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from . import config
from .core import BlochData
from .ops.berry import _plane_link_dets, plaquette_flux
from .ops.eigh import eigh_batched
from .ops.hamiltonian import assemble
from .ops.solver import device_uniform_grid, extend_pbc_seq

__all__ = ["gauge_phases", "berry_flux_grid", "chern_number"]


def gauge_phases(model, dims, flatten=True):
    """Periodic-gauge boundary phases exp(-2j*pi*orb[:, per[d]]) for the
    given mesh dimensions, as NumPy arrays.  With ``flatten`` the spin
    axis is merged into the orbital axis; otherwise shape (norb, 2)."""
    out = []
    for d in dims:
        ffac = np.exp(-2.0j * np.pi * model._orb[:, model._per[d]])
        if model._nspin == 2:
            ffac = np.repeat(ffac, 2) if flatten else np.repeat(ffac[:, None], 2, axis=1)
        out.append(ffac)
    return out


def _solve_grid_states(data: BlochData, kpts, occ, n0, n1):
    """Solve the interior grid and return occ states (n0-1, n1-1, nocc, F)."""
    _, v = eigh_batched(assemble(data, kpts))  # rows are states
    v = v[:, list(occ), :]
    return v.reshape(n0 - 1, n1 - 1, len(occ), data.nsta)


def _total_flux(w):
    """Sum of plaquette Berry phases of an extended (n0, n1, nocc, F)
    grid, and the smallest link |det|."""
    return plaquette_flux(*_plane_link_dets(w.contiguous()))


def berry_flux_grid(model, occ, nk=(101, 101), start_k=(-0.5, -0.5)):
    """Total Berry flux of ``occ`` bands over the BZ on an (n0 x n1)
    grid, computed on the device.  Equals
    ``wf_array(model, nk).solve_on_grid(start_k); wf.berry_flux(occ)``.
    """
    n0, n1 = int(nk[0]), int(nk[1])
    data = model._get_finalized()
    if data.dim_k != 2:
        raise ValueError("chern_number requires a model with dim_k == 2")
    occ = tuple(int(o) for o in occ)
    if occ and (min(occ) < 0 or max(occ) >= data.nsta):
        raise IndexError(
            "occ indices %s out of range for %d states" % (sorted(set(occ)), data.nsta)
        )
    kpts = device_uniform_grid((n0 - 1, n1 - 1), np.asarray(start_k, dtype=np.float64), data.device)
    w = _solve_grid_states(data, kpts, occ, n0, n1)
    phases = [
        torch.as_tensor(p, dtype=config.COMPLEX).to(data.device)
        for p in gauge_phases(model, (0, 1))
    ]
    w = extend_pbc_seq(w, phases)
    return float(_total_flux(w)[0])


def chern_number(model, occ, nk=(101, 101), start_k=(-0.5, -0.5)):
    """Chern number of the ``occ`` bands (flux / 2 pi)."""
    return berry_flux_grid(model, occ, nk, start_k) / (2.0 * np.pi)
