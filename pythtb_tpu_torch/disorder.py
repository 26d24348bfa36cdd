"""Disorder: coherent-potential approximation (CPA) and ensemble tools
(counterpart of ``pythtb_tpu.disorder``).

Single-site CPA for substitutional disorder on any periodic model: the
disordered orbitals carry a frequency-dependent self-energy
``Sigma_i(w)`` fixed by the CPA condition that the ensemble-averaged
single-site T-matrix vanish in the effective medium,

``<t_i(w)> = sum_c p_c (eps_c - Sigma_i) /
             (1 - (eps_c - Sigma_i) G_ii(w)) = 0``,

with ``G(w) = (1/Nk) sum_k [(w + i eta) - H(k) - Sigma]^{-1}`` the
medium Green's function.  The fixed point is iterated as
``Sigma <- Sigma + <t> / (1 + G_ii <t>)``, batched over all frequencies.
H(k) is assembled once per call by kernel 1; the local Green's function
of each iteration is kernel 13 (``csrc/cpa.cu``, through
:func:`local_green`; on a CPU tensor its plain PyTorch version, the JAX
program's batched inverse and k-mean), the t-matrix update a few (W, S)
torch operations, and the host reads the largest change once per
iteration.  As in the JAX package, every frequency iterates until the
largest change over all frequencies is at most ``tol``, so the iteration
count, and with it Sigma, is the JAX package's.

Disorder models:

* ``("binary", probs, values)`` -- substitutional alloy with discrete
  onsite levels (any number of species);
* ``("lorentzian", gamma)`` -- Cauchy-distributed onsite disorder, whose
  exact average is ``Sigma = -i gamma`` (Lloyd 1969), which CPA
  reproduces.

:func:`ensemble_realization` draws one disorder realization of a finite
model with ``numpy.random.default_rng(seed)``, draw for draw as the JAX
package does.
"""

from __future__ import annotations

import copy as _copy
import warnings

import numpy as np
import torch

from . import config
from .model import PythtbError
from .ops import _kernels
from .ops.hamiltonian import assemble

__all__ = ["cpa", "cpa_dos", "ensemble_realization"]

# largest unit cell (states) kernel 13 takes: csrc/cpa.cu's kMaxS
CPA_MAX_S = 40


def _local_green_plain(H, z, sigma):
    """(W, S) k-means of diag((z_w - H(k) - diag(Sigma_w))^{-1}): the
    batched inverse and mean of ``disorder._cpa_jit``'s gdiag, the oracle
    of kernel 13."""
    S = H.shape[-1]
    eye = torch.eye(S, dtype=config.COMPLEX, device=H.device)
    A = z[:, None, None, None] * eye - H[None] - sigma[:, None, :, None] * eye  # (W, B, S, S)
    return torch.diagonal(torch.linalg.inv(A), dim1=-2, dim2=-1).mean(dim=1)


def local_green(H, z, sigma):
    """The CPA medium's local Green's function G[w, i] = (1/B) sum_k
    [(z_w - H(k) - diag(Sigma[w]))^{-1}]_ii.

    :param H: (B, S, S) complex128 Bloch Hamiltonians
    :param z: (W,) complex128 frequencies ``omega + i eta``
    :param sigma: (W, S) complex128 self-energies
    :returns: (W, S) complex128
    """
    if H.device.type == "cpu":
        return _local_green_plain(H, z, sigma)
    B, S = H.shape[0], H.shape[-1]
    if S > CPA_MAX_S:
        raise ValueError("kernel 13 takes unit cells of at most %d states, got %d; run this CPA on the CPU "
                         "(config.set_device(\"cpu\"))" % (CPA_MAX_S, S))
    W = z.shape[0]
    dev = H.device
    _kernels.require(H, "H", config.COMPLEX, (B, S, S), dev)
    _kernels.require(z, "z", config.COMPLEX, (W,), dev)
    _kernels.require(sigma, "sigma", config.COMPLEX, (W, S), dev)
    G = torch.empty((W, S), dtype=config.COMPLEX, device=dev)
    _kernels.launch("cpa", dev, H, z, sigma, G, W, B, S)
    return G


def _cpa_loop(H, z, probs, vals, mask, max_iters, use_lloyd, gamma, tol):
    """The CPA fixed point (``_cpa_jit``'s while loop): returns (sigma,
    G, dn, iters)."""
    dev = H.device
    W, S = z.shape[0], H.shape[-1]
    probs_t = torch.as_tensor(probs, dtype=config.FLOAT).to(dev)
    vals_t = torch.as_tensor(vals, dtype=config.FLOAT).to(dev)
    mask_t = torch.as_tensor(mask, dtype=config.FLOAT).to(dev)

    def t_avg(sigma, G):
        if use_lloyd:
            # Cauchy average: analytic continuation eps -> -i gamma
            de = complex(0.0, -gamma) - sigma
            return de / (1.0 - de * G)
        de = vals_t[None, None, :] - sigma[:, :, None]  # (W, S, nc)
        t = de / (1.0 - de * G[:, :, None])
        return torch.sum(probs_t[None, None, :] * t, dim=-1)

    sigma = torch.zeros((W, S), dtype=config.COMPLEX, device=dev)
    if not use_lloyd:
        # virtual-crystal start: <eps>
        sigma = sigma + (torch.sum(probs_t * vals_t) * mask_t)[None, :]
    dn, iters = np.inf, 0
    while iters < max_iters and dn > tol:
        G = local_green(H, z, sigma)
        ta = t_avg(sigma, G) * mask_t[None, :]
        new = sigma + ta / (1.0 + G * ta)
        dn = float((new - sigma).abs().max())
        sigma = new
        iters += 1
    return sigma, local_green(H, z, sigma), dn, iters


def _norm_disorder(model, disorder):
    """-> (probs, vals, use_lloyd, gamma, mask over states)."""
    kind = disorder[0]
    norb, ns = model._norb, model._nspin
    orbs = None
    if kind == "binary":
        probs = np.asarray(disorder[1], dtype=float)
        vals = np.asarray(disorder[2], dtype=float)
        if len(disorder) > 3:
            orbs = disorder[3]
        if probs.shape != vals.shape or probs.ndim != 1:
            raise PythtbError("disorder: probs/values must match 1-D")
        if abs(probs.sum() - 1.0) > 1e-10 or np.any(probs < 0):
            raise PythtbError("disorder: probs must be a distribution")
        use_lloyd, gamma = False, 0.0
    elif kind == "lorentzian":
        gamma = float(disorder[1])
        if gamma <= 0:
            raise PythtbError("disorder: gamma must be positive")
        if len(disorder) > 2:
            orbs = disorder[2]
        probs = np.ones(1)
        vals = np.zeros(1)
        use_lloyd = True
    else:
        raise PythtbError("disorder: kind must be binary/lorentzian")
    mask = np.zeros(norb * ns)
    sel = range(norb) if orbs is None else orbs
    for i in sel:
        for s in range(ns):
            mask[ns * int(i) + s] = 1.0
    return probs, vals, use_lloyd, gamma, mask


def cpa(model, omegas, nk, disorder, eta=1e-3, max_iters=200, tol=None):
    """CPA self-energy and local Green's function.

    :param omegas: real frequencies
    :param nk: k-grid (int or per-direction)
    :param disorder: ``("binary", probs, values[, orbitals])`` or
      ``("lorentzian", gamma[, orbitals])``; the optional orbital list
      restricts disorder to those orbitals (all by default)
    :param eta: positive spectral broadening
    :returns: dict with ``sigma`` (W, nsta) complex self-energies,
      ``gloc`` (W, nsta) local Green's functions, ``dos`` (W,) total
      DOS ``-Im Tr G / pi``, ``converged``, ``iters``
    """
    if model._dim_k < 1:
        raise PythtbError("cpa: model must be periodic")
    data = model._get_finalized()
    if np.ndim(nk) == 0:
        nk = [int(nk)] * model._dim_k
    grids = np.meshgrid(*[np.arange(n) / n for n in nk], indexing="ij")
    kpts = np.stack([g.reshape(-1) for g in grids], axis=-1)
    probs, vals, use_lloyd, gamma, mask = _norm_disorder(model, disorder)
    omegas = np.atleast_1d(np.asarray(omegas, dtype=float))
    if tol is None:
        tol = float(np.finfo(np.float64).eps ** (2.0 / 3.0))
    dev = data.device
    H = assemble(data, torch.as_tensor(kpts, dtype=config.FLOAT).to(dev))
    z = torch.as_tensor(omegas + 1j * float(eta), dtype=config.COMPLEX).to(dev)
    sigma, gloc, dn, iters = _cpa_loop(H, z, probs, vals, mask, int(max_iters), bool(use_lloyd),
                                       float(gamma), float(tol))
    sigma = sigma.cpu().numpy().astype(np.complex128)
    gloc = gloc.cpu().numpy().astype(np.complex128)
    converged = bool(dn <= tol)
    if not converged:
        warnings.warn(
            "cpa: fixed point not converged to %.1e in %d iterations "
            "(residual %.2e)" % (tol, max_iters, float(dn)),
            stacklevel=2,
        )
    if np.max(np.imag(sigma)) > 10 * eta:
        warnings.warn("cpa: non-causal self-energy (Im Sigma > 0) -- "
                      "increase eta or nk", stacklevel=2)
    dos = -np.imag(np.sum(gloc, axis=1)) / np.pi
    return {
        "sigma": sigma,
        "gloc": gloc,
        "dos": dos,
        "omegas": omegas,
        "converged": converged,
        "iters": int(iters),
    }


def cpa_dos(model, omegas, nk, disorder, **kwargs):
    """Total CPA density of states (per cell)."""
    return cpa(model, omegas, nk, disorder, **kwargs)["dos"]


def ensemble_realization(model, disorder, seed=0):
    """One random onsite-disorder realization of a FINITE model
    (for brute-force ensemble averages against CPA): returns a copy
    with the disordered orbitals' onsite energies shifted by draws
    from the given distribution (``numpy.random.default_rng(seed)``, the
    JAX package's draws)."""
    if model._dim_k != 0:
        raise PythtbError(
            "ensemble_realization: finite models (cut_piece a supercell)"
        )
    probs, vals, use_lloyd, gamma, mask = _norm_disorder(model, disorder)
    rng = np.random.default_rng(seed)
    out = _copy.deepcopy(model)
    norb, ns = model._norb, model._nspin
    draws = np.zeros(norb)
    for i in range(norb):
        if mask[ns * i] == 0:
            continue
        if use_lloyd:
            draws[i] = gamma * np.tan(np.pi * (rng.uniform() - 0.5))
        else:
            draws[i] = vals[rng.choice(len(vals), p=probs)]
    if ns == 1:
        cur = np.asarray(out._site_energies, dtype=float)
        out.set_onsite(list(cur + draws), mode="reset")
    else:
        for i in range(norb):
            out.set_onsite(
                np.asarray(out._site_energies[i]) + draws[i] * np.eye(2),
                ind_i=i, mode="reset")
    return out
