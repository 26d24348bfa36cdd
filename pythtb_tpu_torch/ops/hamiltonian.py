"""Batched Bloch-Hamiltonian assembly (counterpart of
``pythtb_tpu.ops.hamiltonian.assemble``).

H(k) = diag + sum_h amp_h e^{2 pi i k.rv_h} at (i_h, j_h), plus its
Hermitian partner at (j_h, i_h), for a whole (B, dim_k) k-batch.  On a
CUDA tensor this launches kernel 1 (``csrc/assemble.cu``), which walks
the gather index of :class:`pythtb_tpu_torch.core.BlochData`; on a CPU
tensor it runs the plain scatter version below, the scatter path of the
JAX package.  :func:`assemble_one_sided` is kernel 1's one-sided mode:
the direct terms only, no partner and no diagonal (the inter-layer block
of ``pythtb_tpu.surface._one_sided``).  ``assemble_dk``/``assemble_d2k``
are not ported yet.
"""

from __future__ import annotations

import math

import torch

from .. import config
from ..core import BlochData
from . import _kernels

__all__ = ["assemble", "assemble_one_sided"]


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


def _one_sided_plain(data: BlochData, kpts):
    """Plain PyTorch one-sided assembly (the scatter of
    ``pythtb_tpu.surface._one_sided``): the oracle of kernel 1's one-sided
    mode."""
    B = kpts.shape[0]
    n = data.norb
    ph = _phases(data, kpts)
    rows = torch.arange(B, device=kpts.device)[:, None]
    ii, jj = data.ii[None, :], data.jj[None, :]
    if data.nspin == 1:
        H = torch.zeros((B, n, n), dtype=config.COMPLEX, device=kpts.device)
        H.index_put_((rows, ii, jj), ph * data.amps[None, :], accumulate=True)
        return H
    Hblk = torch.zeros((B, n, n, 2, 2), dtype=config.COMPLEX, device=kpts.device)
    Hblk.index_put_((rows, ii, jj), ph[:, :, None, None] * data.amps[None], accumulate=True)
    return Hblk.permute(0, 1, 3, 2, 4).reshape(B, data.nsta, data.nsta)


def _launch(data: BlochData, kpts, one_sided):
    B = kpts.shape[0]
    nsta = data.nsta
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
        B, data.dim_k, data.norb, data.nspin, int(one_sided),
        counter="assemble_one_sided" if one_sided else None,
    )
    return H


def assemble(data: BlochData, kpts):
    """H(k) for a k-batch.

    :param kpts: (B, dim_k) float64 tensor of reduced k-points, on the
      device of ``data``
    :returns: (B, nsta, nsta) complex128, Hermitian; at nspin 2 the basis
      is (orb0_up, orb0_dn, orb1_up, ...)
    """
    B = kpts.shape[0]
    if data.nhop == 0:
        return data.diag.expand(B, data.nsta, data.nsta).clone()
    if kpts.device.type == "cpu":
        return _assemble_plain(data, kpts)
    return _launch(data, kpts, False)


def assemble_one_sided(data: BlochData, kpts):
    """The one-sided block sum_h amp_h e^{2 pi i k.rv_h} at (i_h, j_h):
    no Hermitian partner, no diagonal.  Same arguments and layout as
    :func:`assemble`; the result is not Hermitian."""
    B = kpts.shape[0]
    if data.nhop == 0:
        return torch.zeros((B, data.nsta, data.nsta), dtype=config.COMPLEX, device=kpts.device)
    if kpts.device.type == "cpu":
        return _one_sided_plain(data, kpts)
    return _launch(data, kpts, True)
