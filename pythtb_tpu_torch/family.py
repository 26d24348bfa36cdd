"""Structural parameter sweeps (counterpart of ``pythtb_tpu.family``).

A list of models that share ``dim_k``/``dim_r``/``per``/``nspin`` but
whose orbital counts and hopping graphs differ is embedded into one
common state count: each member's orbitals are padded to the family
maximum with decoupled sites pinned at ``pad_energy`` (a Gershgorin
bound above every member's spectrum, so padded states sort strictly
above all physical bands), and each member carries its own periodic-gauge
phases (1 on the padded orbitals).

Members' graphs differ, so assembly is one launch of kernel 1 per member
(the JAX package pads every hop table to one length instead, with
zero-amplitude rows, so that ``vmap`` sees one shape); after assembly
comes ONE eigensolve over every member's stacked matrices.  Chern
numbers then take one pass of kernels 3-4 over the stacked grids of all
members that share an occupied-band count: one link-determinant launch
per axis and one plaquette launch per distinct ``nocc``, on that many
states.  That replaces the JAX package's masked determinants
(``det(m M m + (I - diag(m)))``), which pad the overlap with an identity
block: the determinant over the occupied block is the same.

Example::

    fam = family([haldane_supercell(n) for n in (1, 2, 3)])
    cherns = fam.chern(nocc=[1, 4, 9], nk=(31, 31))
"""

from __future__ import annotations

import numpy as np
import torch

from . import config
from .core import bloch_data
from .model import PythtbError
from .ops.berry import _plane_link_dets, plaquette_flux
from .ops.eigh import eigh_batched, eigvalsh_batched
from .ops.hamiltonian import assemble
from .ops.solver import device_uniform_grid

__all__ = ["family", "ModelFamily"]


def _gershgorin_bound(data):
    """Upper bound on every |eigenvalue| of H(k) for all k: the largest
    row sum of |diag| plus, for each hopping, |amp| (at nspin 2 the spin
    block's largest row sum) added to both incident rows."""
    row = data.diag.abs().sum(dim=1).cpu().numpy()
    amps = data.amps.cpu().numpy()
    ii, jj = data.ii.cpu().numpy(), data.jj.cpu().numpy()
    for t in range(data.nhop):
        if data.nspin == 1:
            a = abs(amps[t])
            row[ii[t]] += a
            row[jj[t]] += a
        else:
            a = np.abs(amps[t]).sum(axis=1).max()
            row[2 * ii[t] : 2 * ii[t] + 2] += a
            row[2 * jj[t] : 2 * jj[t] + 2] += a
    return float(row.max()) if row.size else 1.0


def _pad_member(model, data, nmax, pad_energy):
    """One member on ``nmax`` orbitals: its hop table as it is, the padded
    diagonal entries at ``pad_energy``; and its periodic-gauge phases
    (dim_k, nsta_max)."""
    nspin = data.nspin
    nsta_max = nmax * nspin
    diag = np.zeros((nsta_max, nsta_max), dtype=np.complex128)
    diag[: data.nsta, : data.nsta] = data.diag.cpu().numpy()
    idx = np.arange(data.nsta, nsta_max)
    diag[idx, idx] = pad_energy
    padded = bloch_data(data.dim_k, nmax, nspin, diag, data.amps.cpu().numpy(), data.rv.cpu().numpy(),
                        data.ii.cpu().numpy(), data.jj.cpu().numpy(), data.device)
    phases = np.ones((data.dim_k, nsta_max), dtype=np.complex128)
    for d in range(data.dim_k):
        ffac = np.exp(-2.0j * np.pi * model._orb[:, model._per[d]])
        phases[d, : data.nsta] = np.repeat(ffac, 2) if nspin == 2 else ffac
    return padded, phases


class ModelFamily:
    """A stack of padded models solved together.

    Build with :func:`family`.  Attributes: ``members`` (one BlochData per
    member on the common orbital count), ``nsta_arr`` (per-member true
    state counts), ``nsta`` (the common padded count), ``pad_energy``,
    ``P``.
    """

    def __init__(self, models, pad_energy=None):
        if not models:
            raise PythtbError("family() needs at least one model")
        dims = {(m._dim_k, m._dim_r, tuple(m._per), m._nspin) for m in models}
        if len(dims) != 1:
            raise PythtbError("family members must share dim_k, dim_r, per and nspin; got %s" % sorted(dims))
        datas = [m._get_finalized() for m in models]
        nmax = max(d.norb for d in datas)
        if pad_energy is None:
            pad_energy = 1.0 + 2.0 * max(_gershgorin_bound(d) for d in datas)
        self.pad_energy = float(pad_energy)
        self.P = len(models)
        padded = [_pad_member(m, d, nmax, self.pad_energy) for m, d in zip(models, datas)]
        self.members = [d for d, _ in padded]
        self.dim_k = datas[0].dim_k
        self.nsta = self.members[0].nsta
        self.device = self.members[0].device
        self._phases = torch.as_tensor(np.stack([p for _, p in padded])).to(self.device)  # (P, dim_k, nsta)
        self.nsta_arr = np.array([d.nsta for d in datas], dtype=np.int64)

    def _stacked(self, kpts):
        """H of every member at its k-points, stacked member-major: one
        kernel-1 launch per member.  ``kpts`` is one (B, dim_k) tensor
        shared by all, or a list of one per member."""
        per = kpts if isinstance(kpts, list) else [kpts] * self.P
        return torch.cat([assemble(d, k) for d, k in zip(self.members, per)])

    def energies(self, k_list):
        """Band energies of every member at the given reduced k-points,
        from one eigensolve over all members' matrices.

        :param k_list: (B, dim_k) shared across members, or (P, B, dim_k)
          per member (each member's reduced coordinates refer to its own
          reciprocal cell)
        :returns: (P, B, nsta_max) float64, ascending per point; entries
          at band index >= a member's ``nsta`` are padding, near
          ``pad_energy``
        """
        kpts = np.asarray(k_list, dtype=np.float64)
        if kpts.ndim == 2:
            k = torch.as_tensor(np.ascontiguousarray(kpts)).to(self.device)
        elif kpts.ndim == 3 and kpts.shape[0] == self.P:
            k = [torch.as_tensor(np.ascontiguousarray(x)).to(self.device) for x in kpts]
        else:
            raise PythtbError("k_list must be (B, dim_k) or (P, B, dim_k); got %s" % (kpts.shape,))
        B = kpts.shape[-2]
        evals = eigvalsh_batched(self._stacked(k))
        return evals.reshape(self.P, B, self.nsta).cpu().numpy().astype(np.float64)

    def chern(self, nocc, nk=(31, 31), start_k=(-0.5, -0.5)):
        """Chern number of the lowest ``nocc[p]`` bands of every member over
        its own BZ on an ``nk`` grid: one assembly launch per member, one
        eigensolve over the stacked grids, then link determinants (kernel
        3, up to 64 bands on the card) and plaquette sums (kernel 4) for
        each group of members with the same ``nocc``.

        :param nocc: per-member occupied-band counts, length P
        :returns: (P,) float64 Chern numbers
        """
        if self.dim_k != 2:
            raise PythtbError("chern requires dim_k == 2 families")
        nocc = np.asarray(nocc, dtype=np.int64).reshape(self.P)
        if (nocc < 1).any() or (nocc > self.nsta_arr).any():
            raise PythtbError("nocc must be in [1, member nsta]; got %s for nsta %s"
                              % (nocc.tolist(), self.nsta_arr.tolist()))
        K = int(nocc.max())
        n0, n1 = int(nk[0]), int(nk[1])
        kpts = device_uniform_grid((n0 - 1, n1 - 1), np.asarray(start_k, dtype=np.float64), self.device)
        _, v = eigh_batched(self._stacked(kpts))  # rows are states
        w = v[:, :K, :].reshape(self.P, n0 - 1, n1 - 1, K, self.nsta)
        ph = self._phases
        w = torch.cat([w, w[:, :1] * ph[:, 0, None, None, None, :]], dim=1)
        w = torch.cat([w, w[:, :, :1] * ph[:, 1, None, None, None, :]], dim=2)  # (P, n0, n1, K, F)
        out = np.empty(self.P, dtype=np.float64)
        for g in np.unique(nocc):
            idx = np.nonzero(nocc == g)[0]
            ws = w[torch.as_tensor(idx, device=self.device), :, :, : int(g)].contiguous()
            flux = plaquette_flux(*_plane_link_dets(ws))[0]
            out[idx] = flux.cpu().numpy() / (2.0 * np.pi)
        return out


def family(models, pad_energy=None) -> ModelFamily:
    """Stack models with possibly different orbital counts / hopping
    graphs into a padded :class:`ModelFamily` (see the module
    docstring)."""
    return ModelFamily(models, pad_energy)
