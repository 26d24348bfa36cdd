"""Linear response: the orbital-resolved Lindhard susceptibility, RPA and
the Stoner analysis (counterpart of ``pythtb_tpu.response``).

``chi0_ab(q, w) = -(1/Nk) sum_{k,n,m} (f_nk - f_mk+q) M_a(k,n,m)
conj(M_b(k,n,m)) / (w + e_nk - e_mk+q + i eta)``, ``M_a = <u_nk| P_a
|u_mk+q>`` in Convention I, in the positive convention of the JAX package
(``chi0(q, 0)`` a positive-semidefinite Hermitian orbital matrix), per spin
for nspin == 1 models.

Device work: H(k) and H(k+q) for the k-grid and every q in one launch of
kernel 1 and one ``eigh_batched`` (kernel 2 at two states, kernel 7 at
33-64, the library otherwise); the matrix elements M and the weights
W = (f_k - f_k+q) M_a conj(M_b) by einsum; the frequency sum of every q in
one launch of kernel 16's q-batch Lorentzian mode
(:func:`pythtb_tpu_torch.optical.spectral_sum_qbatch`) with transition
energies e_{m,k+q} - e_{n,k}.  RPA and the Stoner analysis are host NumPy,
as in the JAX package.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from . import config
from .model import PythtbError
from .ops.eigh import eigh_batched
from .ops.hamiltonian import assemble
from .optical import spectral_sum_qbatch

__all__ = ["lindhard", "rpa_susceptibility", "stoner_analysis"]


def _fermi(x):
    return 0.5 * (1.0 - torch.tanh(0.5 * x))


def _lindhard_weights(data, kpts, qpts, nocc, mu, kt, wts):
    """The inputs of the frequency sum for the k-grid ``kpts`` (Nk, d) and
    the wavevectors ``qpts`` (nq, d), host arrays: W (nq, nops^2, T)
    complex, W[q, (a, b), (k, n, m)] = (f_nk - f_mk+q) M_a conj(M_b), and
    the transition energies de (nq, T) = e_{m,k+q} - e_{n,k}, on the
    device."""
    dev = data.device
    Nk, nq = kpts.shape[0], qpts.shape[0]
    k_all = np.concatenate([kpts[None], kpts[None] + qpts[:, None, :]]).reshape(-1, kpts.shape[1])
    w, v = eigh_batched(assemble(data, torch.as_tensor(np.ascontiguousarray(k_all), dtype=config.FLOAT).to(dev)))
    nsta = w.shape[-1]
    w, v = w.reshape(nq + 1, Nk, nsta), v.reshape(nq + 1, Nk, nsta, nsta)
    if nocc is not None:
        f = (torch.arange(nsta, device=dev) < nocc).to(config.FLOAT).expand_as(w)
    else:
        f = _fermi((w - mu) / kt)
    wk, vk, fk = w[0], v[0], f[0]
    wq, vq, fq = w[1:], v[1:], f[1:]
    wt = torch.as_tensor(wts, dtype=config.COMPLEX).to(dev)
    nops = wt.shape[0]
    # M[q, k, n, m, o] = <u_nk| P_o |u_mk+q>
    M = torch.einsum("kns,os,qkms->qknmo", vk.conj(), wt, vq)
    num = (fk[None, :, :, None] - fq[:, :, None, :]).to(config.COMPLEX)  # (nq, Nk, n, m)
    W = torch.einsum("qknm,qknmo,qknmp->qopknm", num, M, M.conj()).reshape(nq, nops * nops, -1)
    de = (wq[:, :, None, :] - wk[None, :, :, None]).reshape(nq, -1)
    return W.contiguous(), de.contiguous()


def _lindhard(data, kpts, qpts, omegas, nocc, mu, kt, eta, wts):
    """chi0 (nq, nomega, nops, nops) complex on the device: the weights of
    :func:`_lindhard_weights` and one q-batch frequency sum (kernel 16),
    times -1/Nk."""
    W, de = _lindhard_weights(data, kpts, qpts, nocc, mu, kt, wts)
    nq, nops = qpts.shape[0], np.shape(wts)[0]
    om = torch.as_tensor(omegas, dtype=config.FLOAT).to(data.device)
    acc = spectral_sum_qbatch(W, de, om, float(eta))  # (nq, nops^2, nw)
    return (-acc / kpts.shape[0]).permute(0, 2, 1).reshape(nq, om.shape[0], nops, nops)


def _setup(model, nk):
    data = model._get_finalized()
    if model._dim_k < 1:
        raise PythtbError("response: model must be periodic (dim_k >= 1)")
    if np.ndim(nk) == 0:
        nk = [int(nk)] * model._dim_k
    nk = [int(n) for n in nk]
    if len(nk) != model._dim_k:
        raise PythtbError("response: nk must have dim_k entries")
    grids = np.meshgrid(
        *[np.arange(n) / n for n in nk], indexing="ij"
    )
    kpts = np.stack([g.reshape(-1) for g in grids], axis=-1)
    return data, kpts


def _default_ops(model):
    """Orbital-density operator weights (norb, nsta)."""
    norb, ns = model._norb, model._nspin
    wts = np.zeros((norb, norb * ns))
    for i in range(norb):
        for s in range(ns):
            wts[i, ns * i + s] = 1.0
    return wts


def _default_ops(model):
    """Orbital-density operator weights (norb, nsta)."""
    norb, ns = model._norb, model._nspin
    wts = np.zeros((norb, norb * ns))
    for i in range(norb):
        for s in range(ns):
            wts[i, ns * i + s] = 1.0
    return wts


def lindhard(model, qpts, omegas, nk, nocc=None, mu=None,
             temperature=None, eta=1e-2, ops=None):
    """Bare susceptibility ``chi0(q, omega)`` on a uniform k-grid.

    :param qpts: (nq, dim_k) reduced wavevectors (or a single vector)
    :param omegas: frequencies (real axis; broadened by ``eta``)
    :param nk: k-grid size (int or per-direction list)
    :param nocc: T = 0 band-filling occupations (insulator mode); the
      lowest ``nocc`` bands are filled at every k.  Mutually exclusive
      with ``mu``.
    :param mu: chemical potential for Fermi occupations at
      ``temperature`` (metal mode)
    :param eta: Lorentzian broadening of the poles
    :param ops: optional (nops, nsta) array of *diagonal* one-body
      operator weights replacing the default per-orbital densities
      (e.g. S^z patterns for explicit-spin models)
    :returns: complex array (nq, nomega, nops, nops); positive
      convention (see module docstring).  Per-spin for nspin == 1
      models -- multiply by 2 for the physical charge response.

    For nspin == 1 models this is the **per-spin** susceptibility.  In
    ``nocc`` mode the k-grid occupations are by band index; if the
    model is metallic on that grid (occupied and empty bands overlap
    in energy) a warning is issued -- use the ``mu`` mode there.
    """
    data, kpts = _setup(model, nk)
    qpts = np.atleast_2d(np.asarray(qpts, dtype=float))
    if qpts.shape[1] != model._dim_k:
        raise PythtbError("lindhard: qpts must have dim_k columns")
    omegas = np.atleast_1d(np.asarray(omegas, dtype=float))
    if (nocc is None) == (mu is None):
        raise PythtbError("lindhard: give exactly one of nocc / mu")
    if ops is None:
        wts = _default_ops(model)
    else:
        wts = np.asarray(ops, dtype=float)
        if wts.ndim != 2 or wts.shape[1] != model._nsta:
            raise PythtbError("lindhard: ops must be (nops, nsta)")
    kt = 0.0 if temperature is None else float(temperature)
    if mu is not None and kt <= 0.0:
        raise PythtbError("lindhard: mu mode needs temperature > 0")
    if nocc is not None:
        if not 0 < nocc <= model._nsta:
            raise PythtbError("lindhard: nocc must be in 1..nsta")
        # diagnose metallicity of the band-index filling
        ev = np.asarray(model.solve_all(kpts))
        if nocc < model._nsta and (
            np.max(ev[:nocc]) >= np.min(ev[nocc:]) - 1e-12
        ):
            warnings.warn(
                "lindhard: occupied and empty bands overlap on this "
                "k-grid (metallic); band-index occupations are "
                "ill-defined -- use mu/temperature mode",
                stacklevel=2,
            )
    out = _lindhard(
        data,
        kpts,
        qpts,
        omegas,
        int(nocc) if nocc is not None else None,
        0.0 if mu is None else float(mu),
        max(kt, 1e-30),
        float(eta),
        wts,
    )
    return out.cpu().numpy().astype(np.complex128)


def rpa_susceptibility(model, qpts, omegas, nk, U, channel="spin",
                       **kwargs):
    """RPA-dressed susceptibility of the Hubbard model
    (spinless-basis models; per-spin chi0):

    ``chi_spin = chi0 (1 - U chi0)^-1``,
    ``chi_charge = chi0 (1 + U chi0)^-1``

    with ``U`` a scalar or per-orbital vector (diagonal vertex).
    Returns (chi_rpa, chi0), each (nq, nomega, norb, norb).
    """
    if model._nspin != 1:
        raise PythtbError(
            "rpa_susceptibility: Hubbard factorization needs a "
            "spinless-basis model"
        )
    if channel not in ("spin", "charge"):
        raise PythtbError("rpa_susceptibility: channel must be spin/charge")
    chi0 = lindhard(model, qpts, omegas, nk, **kwargs)
    norb = chi0.shape[-1]
    Uvec = np.asarray(U, dtype=float)
    if Uvec.ndim == 0:
        Uvec = np.full(norb, float(Uvec))
    sgn = -1.0 if channel == "spin" else 1.0
    eye = np.eye(norb)
    # chi0 @ diag(U): scale columns; (1 - chi0 U)^-1 chi0 ==
    # chi0 (1 - U chi0)^-1 by the standard resummation identity
    denom = eye + sgn * chi0 * Uvec[None, None, None, :]
    chi = np.linalg.solve(denom, chi0)
    return chi, chi0


def stoner_analysis(model, qpts, nk, U=1.0, eta=1e-4, **kwargs):
    """Stoner instability analysis of the paramagnetic state.

    Computes the static per-spin ``chi0(q, 0)``, symmetrizes the RPA
    kernel ``U^1/2 chi0 U^1/2`` and returns per q: its largest
    eigenvalue ``lambda(q)`` (instability at 1), the critical coupling
    ``U_c(q) = U / lambda(q)``, and the critical orbital eigenvector.
    The minimum of ``U_c`` over q is the RPA phase boundary and
    coincides with the self-consistent HF onset on the same k-grid /
    temperature (tested).
    """
    qpts = np.atleast_2d(np.asarray(qpts, dtype=float))
    chi0 = lindhard(model, qpts, [0.0], nk, eta=eta, **kwargs)[:, 0]
    chi0 = 0.5 * (chi0 + np.conj(np.swapaxes(chi0, -1, -2)))
    norb = chi0.shape[-1]
    Uvec = np.asarray(U, dtype=float)
    if Uvec.ndim == 0:
        Uvec = np.full(norb, float(Uvec))
    root = np.sqrt(Uvec)
    kern = root[None, :, None] * chi0 * root[None, None, :]
    lam, vec = np.linalg.eigh(kern)
    lam_max = lam[:, -1].real
    with np.errstate(divide="ignore"):
        uc = np.where(lam_max > 0, Uvec.max() / np.maximum(lam_max, 1e-300),
                      np.inf)
    best = int(np.argmax(lam_max))
    return {
        "lambda": lam_max,
        "U_c": uc,
        "vector": vec[:, :, -1],
        "q_best": qpts[best],
        "U_c_min": float(uc[best]),
    }
