"""Batched Bloch-Hamiltonian assembly (counterpart of
``pythtb_tpu.ops.hamiltonian.assemble``).

H(k) = diag + sum_h amp_h e^{2 pi i k.rv_h} at (i_h, j_h), plus its
Hermitian partner at (j_h, i_h), for a whole (B, dim_k) k-batch.  On a
CUDA tensor this launches kernel 1 (``csrc/assemble.cu``), which walks
the gather index of :class:`pythtb_tpu_torch.core.BlochData`; on a CPU
tensor it runs the plain scatter version below, the scatter path of the
JAX package.  ``assemble_dk``/``assemble_d2k`` are not ported yet.
"""

from __future__ import annotations

import math

import torch

from .. import config
from ..core import BlochData
from . import _kernels

__all__ = ["assemble"]


def _phases(data: BlochData, kpts):
    """Bloch phase factors exp(2j*pi*k.rv), (B, nhop)."""
    ang = (2.0 * math.pi) * (kpts @ data.rv.T)
    return torch.polar(torch.ones_like(ang), ang)


def _assemble_plain(data: BlochData, kpts):
    """Plain PyTorch assembly by scatter-add (``index_put_`` with
    ``accumulate=True``): the oracle of kernel 1."""
    B = kpts.shape[0]
    n = data.norb
    ph = _phases(data, kpts)
    rows = torch.arange(B, device=kpts.device)[:, None]
    ii, jj = data.ii[None, :], data.jj[None, :]
    if data.nspin == 1:
        vals = ph * data.amps[None, :]  # (B, nhop)
        H = torch.zeros((B, n, n), dtype=config.COMPLEX, device=kpts.device)
        H.index_put_((rows, ii, jj), vals, accumulate=True)
        H.index_put_((rows, jj, ii), torch.conj_physical(vals), accumulate=True)
        return H + data.diag[None]
    vals = ph[:, :, None, None] * data.amps[None]  # (B, nhop, 2, 2)
    Hblk = torch.zeros((B, n, n, 2, 2), dtype=config.COMPLEX, device=kpts.device)
    Hblk.index_put_((rows, ii, jj), vals, accumulate=True)
    Hblk.index_put_((rows, jj, ii), torch.conj_physical(vals.transpose(-1, -2)), accumulate=True)
    # (B, i, j, s, t) -> (B, i, s, j, t) -> (B, 2n, 2n)
    H = Hblk.permute(0, 1, 3, 2, 4).reshape(B, data.nsta, data.nsta)
    return H + data.diag[None]


def assemble(data: BlochData, kpts):
    """H(k) for a k-batch.

    :param kpts: (B, dim_k) float64 tensor of reduced k-points, on the
      device of ``data``
    :returns: (B, nsta, nsta) complex128, Hermitian; at nspin 2 the basis
      is (orb0_up, orb0_dn, orb1_up, ...)
    """
    B = kpts.shape[0]
    nsta = data.nsta
    if data.nhop == 0:
        return data.diag.expand(B, nsta, nsta).clone()
    if kpts.device.type == "cpu":
        return _assemble_plain(data, kpts)
    dev = data.device
    _kernels.require(kpts, "kpts", config.FLOAT, (B, data.dim_k), dev)
    _kernels.require(data.rv, "rv", config.FLOAT, (data.nhop, data.dim_k), dev)
    _kernels.require(data.amps, "amps", config.COMPLEX, (data.nhop,) + (2, 2)[: 2 * (data.nspin - 1)], dev)
    _kernels.require(data.diag, "diag", config.COMPLEX, (nsta, nsta), dev)
    _kernels.require(data.ptr, "ptr", torch.int32, (data.norb**2 + 1,), dev)
    _kernels.require(data.ent, "ent", torch.int32, (2 * data.nhop,), dev)
    H = torch.empty((B, nsta, nsta), dtype=config.COMPLEX, device=dev)
    _kernels.launch(
        "assemble", dev, kpts, data.rv, data.amps, data.diag, data.ptr, data.ent, H,
        B, data.dim_k, data.norb, data.nspin,
    )
    return H
