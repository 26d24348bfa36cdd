"""Impurity embedding: lattice Green's functions and the T-matrix
(counterpart of ``pythtb_tpu.impurity``).

    G(E) = G0(E) + G0(E) T(E) G0(E),
    T(E) = V [1 - G0(E) V]^{-1},

where ``V`` is any Hermitian perturbation supported on a finite cluster
of sites (cells R, orbitals) and ``G0`` is the pristine-host lattice
Green's function between those sites,

    G0_{ab}(E) = (1/N_k) sum_{k n}
        phi_a(k,n) conj(phi_b(k,n)) / (E + i eta - eps_{k n}),
    phi_a(k,n) = e^{2 pi i k.(R_a + t_a)} c_n(k)_{orb_a}.

One grid eigendecomposition serves every energy: the k-grid is built on
the device, H(k) by kernel 1, the eigenpairs by kernel 2 at two bands
(``torch.linalg.eigh`` above), and the site-basis amplitudes phi by one
broadcast product.  G0 is then one spectral sum of kernel 16's
Lorentzian mode (:func:`pythtb_tpu_torch.optical.spectral_sum`): the
frequencies are the energies E, the transition energies the band
energies eps_{kn}, the weights W[(a, c), (k, n)] = phi_a conj(phi_c) / N_k
(nc^2 columns) and the width eta.

* :func:`host_greens_function` -- G0(E) on a cluster, (nE, nc, nc).
* :func:`t_matrix` -- (G, T) with the impurity embedded; the diagonal
  of ``-Im G / pi`` is the LDOS at the cluster sites.
* :func:`bound_states` -- in-gap impurity levels as the zeros of
  ``det[1 - G0(E) V]`` on the real axis: a scan for changes of the count
  of negative eigenvalues of the Hermitian pencil ``V^{-1} - G0(E)``,
  bisected on the host, each energy one small spectral sum.

The small dense algebra of ``t_matrix`` and ``bound_states`` stays on
the host, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from . import config
from .model import PythtbError
from .ops.eigh import eigh_batched
from .ops.hamiltonian import assemble
from .ops.solver import device_uniform_grid
from .optical import spectral_sum

__all__ = ["host_greens_function", "t_matrix", "bound_states"]


def _cluster_arrays(model, cluster):
    """Normalize a cluster spec into (t+R reduced positions (nc, dim_r) for
    the phase, state index (nc,)).  Cluster entries are either orbital
    indices (home cell) or ``(R_vector, orbital)`` pairs; for spinful
    models each orbital contributes its two spin states CONSECUTIVELY in
    the returned ordering."""
    data = model._get_finalized()
    dim_r = model._dim_r
    Rs, orbs = [], []
    for entry in cluster:
        if isinstance(entry, (int, np.integer)):
            Rs.append(np.zeros(dim_r))
            orbs.append(int(entry))
        else:
            R, o = entry
            Rs.append(np.asarray(R, dtype=np.float64))
            orbs.append(int(o))
    orbs = np.asarray(orbs)
    if orbs.min() < 0 or orbs.max() >= model._norb:
        raise PythtbError("cluster orbital out of range")
    Rs = np.asarray(Rs, dtype=np.float64)
    if Rs.shape[1] != dim_r:
        raise PythtbError("cluster R vectors must have dim_r components")
    nonper = [d for d in range(dim_r) if d not in model._per]
    if nonper and np.abs(Rs[:, nonper]).max() > 1e-9:
        raise PythtbError(
            "cluster R vectors must vanish along non-periodic "
            "directions (there are no repeated cells there)"
        )
    orb_red = np.asarray(model._orb, dtype=np.float64)
    pos_red = Rs + orb_red[orbs]  # (nc, dim_r) reduced positions
    if data.nspin == 2:
        pos_red = np.repeat(pos_red, 2, axis=0)
        states = np.stack([2 * orbs, 2 * orbs + 1], axis=1).reshape(-1)
    else:
        states = orbs
    return pos_red, np.asarray(states, dtype=np.int64)


def _spectrum(model, data, pos_red, states, nk):
    """The grid eigendecomposition, once: the band energies (T,) and the
    kernel-16 weights W (nc^2, T), T = N_k * nsta flattened over (k, n)
    (only the periodic components of the positions enter the Bloch
    phase)."""
    dev = data.device
    kpts = device_uniform_grid(nk, np.zeros(data.dim_k), dev)
    evals, vecs = eigh_batched(assemble(data, kpts))
    pos = torch.as_tensor(np.ascontiguousarray(pos_red[:, list(model._per)]), dtype=config.FLOAT).to(dev)
    ang = 2.0 * np.pi * (kpts @ pos.T)  # (B, nc)
    ph = torch.polar(torch.ones_like(ang), ang)
    # site-basis amplitudes phi[k, n, a] = e^{2 pi i k.(R_a + t_a)} c_a (rows of vecs are states)
    phi = vecs[:, :, torch.as_tensor(states).to(dev)] * ph[:, None, :]
    B, S, nc = phi.shape
    W = (phi[..., :, None] * phi.conj()[..., None, :]).reshape(B * S, nc * nc).T / B
    return evals.reshape(-1).contiguous(), W.contiguous(), nc


def _g0(spec, energies, eta):
    """G0 (nE, nc, nc) complex128 NumPy at the real energies, from the
    spectrum of :func:`_spectrum`: one launch of kernel 16."""
    E, W, nc = spec
    om = torch.as_tensor(np.asarray(energies, dtype=np.float64)).to(E.device)
    acc = spectral_sum(W, E, om, float(eta), "lorentz")  # (nc^2, nE)
    return acc.T.reshape(-1, nc, nc).cpu().numpy().astype(np.complex128)


def _prep_host(model, nk, caller):
    data = model._get_finalized()
    if data.dim_k < 1:
        raise PythtbError("%s needs a periodic host model" % caller)
    nk = tuple(int(x) for x in np.atleast_1d(nk))
    if len(nk) != data.dim_k or min(nk) < 2:
        raise PythtbError("nk must give %d sizes >= 2" % data.dim_k)
    return data, nk


def host_greens_function(model, energies, cluster, nk=(64, 64), eta=1e-3):
    """Pristine-host lattice Green's function between cluster sites.

    :param energies: (nE,) real energies (complex shift ``i eta`` is
      added internally)
    :param cluster: site list -- orbital indices (home cell) or
      ``(R, orbital)`` pairs; spinful orbitals expand to their two
      spin states consecutively
    :param nk: BZ grid for the k-integral
    :param eta: positive imaginary part (retarded)
    :returns: (nE, nc, nc) complex G0
    """
    data, nk = _prep_host(model, nk, "host_greens_function")
    pos_red, states = _cluster_arrays(model, cluster)
    energies = np.atleast_1d(np.asarray(energies, dtype=np.float64))
    return _g0(_spectrum(model, data, pos_red, states, nk), energies, eta)


def t_matrix(model, V, energies, cluster, nk=(64, 64), eta=1e-3):
    """Exact embedding of a local perturbation: returns ``(G, T)`` on
    the cluster, each (nE, nc, nc) complex, with ``G = G0 + G0 T G0``
    the FULL Green's function of the infinite crystal plus impurity.
    The cluster-site LDOS is ``-Im diag(G) / pi``.

    :param V: (nc, nc) Hermitian perturbation in the cluster state
      basis (spinful: the spin-expanded ordering of ``cluster``)
    """
    G0 = host_greens_function(model, energies, cluster, nk=nk, eta=eta)
    V = np.asarray(V, dtype=np.complex128)
    nc = G0.shape[-1]
    if V.shape != (nc, nc):
        raise PythtbError("V must be (%d, %d) in the cluster state basis"
                          % (nc, nc))
    if np.abs(V - V.conj().T).max() > 1e-12:
        raise PythtbError("V must be Hermitian")
    eye = np.eye(nc)
    T = np.stack([V @ np.linalg.inv(eye - g @ V) for g in G0])
    G = G0 + np.einsum("eab,ebc,ecd->ead", G0, T, G0)
    return G, T


def bound_states(model, V, cluster, window, nk=(64, 64), n_scan=201,
                 tol=1e-9):
    """In-gap impurity levels: real zeros of ``det[1 - G0(E) V]``.

    Inside a spectral gap G0(E) is Hermitian on the real axis (eta ->
    0), so for invertible V the condition ``det[1 - G0 V] = 0`` is the
    zero crossing of an eigenvalue of the HERMITIAN pencil ``A(E) =
    V^{-1} - G0(E)``: the scan tracks the count of negative
    eigenvalues of A and recursively bisects every change, so two
    DISTINCT levels inside one scan interval are still separated (an
    exact degeneracy converges to one energy reported with its
    multiplicity).  A singular V falls back to sign changes of the
    real determinant of ``1 - G0 V`` (which misses even-multiplicity
    roots -- prefer invertible V).  The host spectrum is diagonalized
    ONCE; every scan/bisection energy costs one small spectral sum
    (kernel 16).

    :param window: (E_lo, E_hi) inside a host gap (states inside bands
      are resonances, not bound states -- they will not be found)
    :param n_scan: initial scan resolution (recursion refines each
      bracket to ``tol``)
    :returns: (nb,) array of bound-state energies (possibly empty)
    """
    E_lo, E_hi = float(window[0]), float(window[1])
    if not E_hi > E_lo:
        raise PythtbError("window must be (E_lo, E_hi) with E_hi > E_lo")
    V = np.asarray(V, dtype=np.complex128)

    data, nk = _prep_host(model, nk, "bound_states")
    pos_red, states = _cluster_arrays(model, cluster)
    nc = len(states)
    if V.shape != (nc, nc):
        raise PythtbError("V must be (%d, %d) in the cluster state basis"
                          % (nc, nc))
    if np.abs(V - V.conj().T).max() > 1e-12:
        raise PythtbError("V must be Hermitian")
    spec = _spectrum(model, data, pos_red, states, nk)

    # real-axis G0 from the precomputed spectrum: tiny eta, Hermitian
    # part (in a gap the anti-Hermitian part ~ eta -> 0)
    def g0_herm(Es):
        G0 = _g0(spec, np.atleast_1d(Es), 1e-7)
        return 0.5 * (G0 + np.conj(np.swapaxes(G0, -1, -2)))

    invertible = (np.linalg.cond(V) < 1e12
                  if np.abs(V).max() > 0 else False)
    if invertible:
        Vinv = np.linalg.inv(V)

        def count(Es):
            A = Vinv[None] - g0_herm(Es)
            return (np.linalg.eigvalsh(A) < 0.0).sum(axis=-1)
    else:
        def count(Es):
            M = np.eye(nc)[None] - g0_herm(Es) @ V[None]
            return (np.real(np.linalg.det(M)) < 0.0).astype(int)

    roots = []

    def refine(lo, hi, clo, chi):
        mult = abs(int(chi) - int(clo))
        if mult == 0:
            return
        if hi - lo <= tol:
            roots.extend([0.5 * (lo + hi)] * mult)
            return
        mid = 0.5 * (lo + hi)
        cm = int(count(np.array([mid]))[0])
        refine(lo, mid, clo, cm)
        refine(mid, hi, cm, chi)

    Es = np.linspace(E_lo, E_hi, int(n_scan))
    c = count(Es)
    for i in range(len(Es) - 1):
        refine(Es[i], Es[i + 1], int(c[i]), int(c[i + 1]))
    return np.asarray(sorted(roots), dtype=np.float64)
