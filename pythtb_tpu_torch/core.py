"""Core data model: the finalized, device-resident form of a tight-binding model.

Counterpart of ``pythtb_tpu.core``.  The model's ragged hopping list
is frozen once into :class:`BlochData`, a set of dense tensors on one
device that the batched operators in :mod:`pythtb_tpu_torch.ops`
consume.  Complex data stays complex128: CUDA moves it as it is, so the
ri-packing of the JAX package is gone.

Physics convention (as in pythtb_tpu and PythTB 1.8.0): "Convention I"
Bloch basis, ``H_ij(k) = sum_R exp(2j*pi*k.(R + t_j - t_i)|_per) H_ij(R)``
with k in reduced coordinates.  The per-hopping phase vector
``rv = (-t_i + t_j + R)[per]`` is precomputed here.

Assembly on the GPU reads H(k) element by element, so finalize also
builds a CSR *gather index by output element*: for orbital pair (a, b),
``ent[ptr[a*norb+b]:ptr[a*norb+b+1]]`` lists every hopping landing there,
coded ``2*h`` where it lands directly ((i_h, j_h) = (a, b)) and
``2*h + 1`` where its Hermitian partner lands ((j_h, i_h) = (a, b)).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import config

__all__ = ["BlochData", "bloch_data", "finalize"]


@dataclasses.dataclass(frozen=True)
class BlochData:
    """A finalized model on one device."""

    dim_k: int
    norb: int
    nspin: int
    nhop: int
    # (nsta, nsta) complex: the k-independent on-site matrix
    diag: torch.Tensor
    # (nhop,) complex for nspin 1, (nhop, 2, 2) complex for nspin 2
    amps: torch.Tensor
    # (nhop, dim_k) float: rv = (-t_i + t_j + R)[per]
    rv: torch.Tensor
    # (nhop,) int64 orbital indices of each hopping <i|H|j+R>
    ii: torch.Tensor
    jj: torch.Tensor
    # gather index (see module docstring): (norb*norb + 1,) and (2*nhop,) int32
    ptr: torch.Tensor
    ent: torch.Tensor

    @property
    def nsta(self) -> int:
        return self.norb * self.nspin

    @property
    def device(self) -> torch.device:
        return self.diag.device


def _gather_index(norb: int, ii: np.ndarray, jj: np.ndarray):
    """CSR lists of the hoppings that land on each output (a, b)."""
    nhop = ii.shape[0]
    slots = np.concatenate([ii * norb + jj, jj * norb + ii])
    codes = np.concatenate([2 * np.arange(nhop), 2 * np.arange(nhop) + 1])
    order = np.argsort(slots, kind="stable")
    counts = np.bincount(slots, minlength=norb * norb)
    ptr = np.concatenate([[0], np.cumsum(counts)])
    return ptr.astype(np.int32), codes[order].astype(np.int32)


def bloch_data(dim_k, norb, nspin, diag, amps, rv, ii, jj, device=None) -> BlochData:
    """Move finalized host arrays onto ``device`` (default
    :func:`config.device`) and build the gather index."""
    dev = config.checked_device(device)
    ii = np.asarray(ii, dtype=np.int64)
    jj = np.asarray(jj, dtype=np.int64)
    nhop = ii.shape[0]
    ptr, ent = _gather_index(norb, ii, jj)

    def put(x, dtype):
        # a fresh C-ordered copy: the kernels read these tensors raw, and
        # NumPy fancy indexing (rv) can return Fortran-ordered arrays
        return torch.from_numpy(np.array(x, order="C")).to(device=dev, dtype=dtype)

    return BlochData(
        dim_k=int(dim_k),
        norb=int(norb),
        nspin=int(nspin),
        nhop=int(nhop),
        diag=put(diag, config.COMPLEX),
        amps=put(amps, config.COMPLEX),
        rv=put(np.asarray(rv, dtype=np.float64).reshape(nhop, dim_k), config.FLOAT),
        ii=put(ii, torch.int64),
        jj=put(jj, torch.int64),
        ptr=put(ptr, torch.int32),
        ent=put(ent, torch.int32),
    )


def finalize(dim_k, dim_r, per, nspin, norb, orb, site_energies, hop_amps, hop_i, hop_j, hop_R, device=None):
    """Freeze host model state into :class:`BlochData`.

    Parameters mirror the internal state of
    :class:`pythtb_tpu_torch.tb_model` (and of ``pythtb_tpu.core.finalize``).
    """
    per = [int(p) for p in per]
    nhop = len(hop_amps)
    orb = np.asarray(orb, dtype=np.float64)
    nsta = norb * nspin

    diag = np.zeros((nsta, nsta), dtype=np.complex128)
    if nspin == 1:
        np.fill_diagonal(diag, np.asarray(site_energies, dtype=np.float64))
    else:
        blk = np.asarray(site_energies, dtype=np.complex128)  # (norb, 2, 2)
        for i in range(norb):
            diag[2 * i : 2 * i + 2, 2 * i : 2 * i + 2] = blk[i]

    if nspin == 1:
        amps = np.asarray(hop_amps, dtype=np.complex128).reshape(nhop)
    else:
        amps = np.asarray(hop_amps, dtype=np.complex128).reshape(nhop, 2, 2)
    ii = np.asarray(hop_i, dtype=np.int64).reshape(nhop)
    jj = np.asarray(hop_j, dtype=np.int64).reshape(nhop)

    if dim_k > 0:
        Rm = np.asarray(hop_R, dtype=np.float64).reshape(nhop, dim_r)
        rv = (-orb[ii, :] + orb[jj, :] + Rm)[:, per]
    else:
        rv = np.zeros((nhop, 0), dtype=np.float64)
    return bloch_data(dim_k, norb, nspin, diag, amps, rv, ii, jj, device)
