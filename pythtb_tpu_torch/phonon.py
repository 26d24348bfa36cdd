"""Lattice dynamics: force-constant models, phonon bands, thermodynamics
(counterpart of ``pythtb_tpu.phonon``).

A :class:`force_model` carries Born force-constant blocks on a lattice
-- raw ``(dim_r, dim_r)`` matrices (:meth:`force_model.set_fc`) or
longitudinal/transverse springs along the equilibrium bond
(:meth:`force_model.set_spring`) -- with the acoustic sum rule enforced
by construction: ``Phi_ii(0) = -sum_{(j,R) != (i,0)} Phi_ij(R)`` (+ any
substrate pinning).  The model and its tables are the JAX package's host
NumPy code.

The dynamical matrix ``D(k)_{ia,jb} = (M_i M_j)^{-1/2} sum_R
Phi_ij(R)_{ab} e^{2 pi i k . R}`` is kernel 1 as it stands
(``pythtb_tpu.phonon._dynmat_jit``): each force block expands on the host
into scalar hops (i d + a, j d + c, rv = R[:dim_k], amp = w P_ac, w the
mass weight), the block-diagonal ``selfb / M`` is the on-site matrix, and
kernel 1's conjugated partner at e^{-2 pi i k.R} is the reference's
transposed block, the blocks being real.  ``eigh_batched`` then gives
``omega = sqrt(eig(D))`` (rows are modes) with the instability check.

:func:`thermal_conductivity` is ``_kappa_jit``: D by kernel 1, its
eigenpairs, dD/dk_a by kernel 15 on the same tables (its factor
2 pi i rv_a is the reference's 2 pi R_a), and the Hellmann-Feynman
velocities with the Bose c_v sweep over the temperatures by kernel 25
(:func:`pythtb_tpu_torch.ops.phonon_kappa.phonon_kappa`).
:func:`dos`, :func:`heat_capacity` and :func:`dynamical_cluster` keep
the reference's host NumPy after the solve.
"""

from __future__ import annotations

import numpy as np
import torch

from . import config, core
from .model import PythtbError
from .ops.eigh import eigh_batched, eigvalsh_batched
from .ops.hamiltonian import assemble, assemble_dk
from .ops.phonon_kappa import phonon_kappa

__all__ = [
    "force_model",
    "bands",
    "dos",
    "heat_capacity",
    "thermal_conductivity",
    "dynamical_cluster",
]


class force_model:
    """Harmonic force-constant model on a lattice.

    :param lat: (dim_r, dim_r) lattice vectors (rows)
    :param pos: (natom, dim_r) reduced atom positions
    :param masses: atomic masses, scalar or per-atom
    :param dim_k: number of periodic directions (default all)
    """

    def __init__(self, lat, pos, masses=1.0, dim_k=None):
        self._lat = np.asarray(lat, dtype=float)
        self._pos = np.atleast_2d(np.asarray(pos, dtype=float))
        self._dim_r = self._lat.shape[0]
        if self._lat.shape != (self._dim_r, self._dim_r):
            raise PythtbError("force_model: lat must be square")
        if self._pos.shape[1] != self._dim_r:
            raise PythtbError("force_model: pos must have dim_r columns")
        self._natom = self._pos.shape[0]
        m = np.asarray(masses, dtype=float)
        self._mass = np.full(self._natom, float(m)) if m.ndim == 0 else m
        if self._mass.shape != (self._natom,) or np.any(self._mass <= 0):
            raise PythtbError("force_model: bad masses")
        self._dim_k = self._dim_r if dim_k is None else int(dim_k)
        if not 0 <= self._dim_k <= self._dim_r:
            raise PythtbError("force_model: bad dim_k")
        self._fcs = []  # (Phi (d, d), i, j, R (dim_r,))
        self._pin = [np.zeros((self._dim_r, self._dim_r)) for _ in range(self._natom)]

    def _check_bond(self, i, j, R):
        if not (0 <= i < self._natom and 0 <= j < self._natom):
            raise PythtbError("force_model: atom index out of range")
        R = np.zeros(self._dim_r) if R is None else np.asarray(R, dtype=float)
        if R.shape != (self._dim_r,):
            raise PythtbError("force_model: R must have dim_r entries")
        if self._dim_k < self._dim_r and np.any(np.abs(R[self._dim_k:]) > 1e-12):
            raise PythtbError("force_model: R nonzero along a non-periodic direction")
        if i == j and np.max(np.abs(R)) < 1e-12:
            raise PythtbError(
                "force_model: the on-site block is fixed by the acoustic "
                "sum rule; use set_pin for substrate pinning")
        return R

    def set_fc(self, phi, i, j, R=None):
        """Add the force-constant block ``Phi_ij(R)`` coupling the
        displacement of atom i in the home cell to atom j in cell R
        (list each bond once; the partner ``Phi_ji(-R) = Phi_ij(R)^T`` is
        implied).  ``phi`` scalar (isotropic) or (dim_r, dim_r).  The
        potential energy is ``(1/2) sum u_i Phi_ij u_j``, so an attractive
        spring contributes a NEGATIVE off-site block (see set_spring)."""
        R = self._check_bond(i, j, R)
        d = self._dim_r
        P = np.asarray(phi, dtype=float)
        P = np.eye(d) * float(P) if P.ndim == 0 else P
        if P.shape != (d, d):
            raise PythtbError("set_fc: phi must be scalar or (d, d)")
        self._fcs.append((P.copy(), int(i), int(j), R))

    def set_spring(self, kl, i, j, R=None, kt=0.0):
        """Add a two-body spring along the equilibrium bond i(0)->j(R):
        longitudinal stiffness ``kl`` and transverse stiffness ``kt``,
        the off-site block ``Phi_ij(R) = -(kl n n^T + kt (1 - n n^T))``
        with n the unit bond vector (the Born model)."""
        R = self._check_bond(i, j, R)
        dvec = (R + self._pos[j] - self._pos[i]) @ self._lat
        dn = np.linalg.norm(dvec)
        if dn < 1e-12:
            raise PythtbError("set_spring: coincident atoms (zero bond)")
        n = dvec / dn
        P = -(float(kl) * np.outer(n, n) + float(kt) * (np.eye(self._dim_r) - np.outer(n, n)))
        self._fcs.append((P, int(i), int(j), R))

    def set_pin(self, k, i=None):
        """External harmonic pinning ``(1/2) k |u_i|^2`` (breaks the
        acoustic sum rule).  ``k`` scalar or (d, d); all atoms when i is
        None."""
        d = self._dim_r
        K = np.asarray(k, dtype=float)
        K = np.eye(d) * float(K) if K.ndim == 0 else K
        if K.shape != (d, d):
            raise PythtbError("set_pin: k must be scalar or (d, d)")
        for a in (range(self._natom) if i is None else [int(i)]):
            self._pin[a] = self._pin[a] + K

    def _tables(self, masses=None):
        """Host tables: (iidx, jidx, R (nb, dim_r), blocks (nb, d, d),
        self-blocks (natom, d, d), minv_sqrt (natom,)).  Each listed bond
        appears once; the assembly adds the transpose partner.  The self
        term enforces the acoustic sum rule."""
        d = self._dim_r
        mass = self._mass if masses is None else np.asarray(masses, float)
        if mass.shape != (self._natom,) or np.any(mass <= 0):
            raise PythtbError("force_model: bad mass override")
        selfb = [self._pin[a].copy() for a in range(self._natom)]
        for P, i, j, R in self._fcs:
            # ASR: rigid translation u_i = u_j = const gives zero force
            selfb[i] -= P
            selfb[j] -= P.T
        if self._fcs:
            iidx = np.array([b[1] for b in self._fcs], dtype=np.int32)
            jidx = np.array([b[2] for b in self._fcs], dtype=np.int32)
            Rs = np.array([b[3] for b in self._fcs], dtype=float)
            blocks = np.array([b[0] for b in self._fcs], dtype=float)
        else:
            iidx = np.zeros(0, dtype=np.int32)
            jidx = np.zeros(0, dtype=np.int32)
            Rs = np.zeros((0, self._dim_r))
            blocks = np.zeros((0, d, d))
        return iidx, jidx, Rs, blocks, np.array(selfb), 1.0 / np.sqrt(mass)


def _bloch(model, device=None):
    """The mass-weighted dynamical matrix as kernel 1's tables: every
    force block expanded into its d x d scalar hops (hop b d^2 + a d + c
    is ``w_b P_b[a, c]`` from row i_b d + a to column j_b d + c, rv the
    periodic part of R_b), the on-site matrix block-diagonal selfb / M."""
    iidx, jidx, Rs, blocks, selfb, misq = model._tables()
    n, d, dk = model._natom, model._dim_r, model._dim_k
    w = misq[iidx] * misq[jidx]
    a = np.repeat(np.arange(d), d)
    c = np.tile(np.arange(d), d)
    ii = (iidx[:, None].astype(np.int64) * d + a[None]).reshape(-1)
    jj = (jidx[:, None].astype(np.int64) * d + c[None]).reshape(-1)
    amps = (blocks * w[:, None, None]).reshape(-1)
    rv = np.repeat(Rs[:, :dk], d * d, axis=0)
    diag = np.zeros((n * d, n * d))
    for at in range(n):
        # a raw block that is not symmetric, on a bond between two atoms,
        # leaves a self block that is not: D is then not Hermitian, and the
        # reference's jnp.linalg.eigh takes (D + D^H) / 2, which is this
        # (at natom d = 2, where JAX takes its closed form, the self blocks
        # are always symmetric)
        sb = 0.5 * (selfb[at] + selfb[at].T)
        diag[at * d:(at + 1) * d, at * d:(at + 1) * d] = sb * misq[at] ** 2
    return core.bloch_data(dk, n * d, 1, diag, amps, rv, ii, jj, device)


def _kpts(model, kpts, device):
    kpts = np.atleast_2d(np.asarray(kpts, dtype=float))
    if kpts.shape[1] != model._dim_k:
        raise PythtbError("k-points must have dim_k components")
    return torch.as_tensor(np.ascontiguousarray(kpts), dtype=config.FLOAT).to(device)


def _solve_device(model, kpts, want_vectors=False):
    """(w2 (B, nmode), vecs (B, nmode, nmode) rows = modes, or None) as
    tensors on the model's device."""
    if not isinstance(model, force_model):
        raise PythtbError("expected a force_model")
    data = _bloch(model)
    D = assemble(data, _kpts(model, kpts, data.device))
    if want_vectors:
        return eigh_batched(D)
    return eigvalsh_batched(D), None


def _check_stable(w2, instability_tol=None):
    if instability_tol is None:
        instability_tol = 1e3 * np.finfo(np.float64).eps * max(1.0, np.abs(w2).max())
    if w2.min() < -instability_tol:
        raise PythtbError(
            "phonon: negative eigenvalue %.3e of the dynamical matrix "
            "-- the configuration is not a stable equilibrium" % float(w2.min()))


def _solve(model, kpts, want_vectors=False, instability_tol=None):
    """Host wrapper: (omega (B, nmode), vecs or None), NumPy.  Raises on
    a genuinely unstable configuration (w2 < -tol)."""
    w2, vecs = _solve_device(model, kpts, want_vectors)
    w2 = w2.cpu().numpy().astype(np.float64)
    _check_stable(w2, instability_tol)
    omega = np.sqrt(np.clip(w2, 0.0, None))
    if not want_vectors:
        return omega, None
    return omega, np.array(vecs.cpu().numpy(), copy=True)


def bands(model, kpts, return_vectors=False):
    """Phonon frequencies (and optionally mass-weighted polarization
    vectors, rows = modes) at the given reduced k-points.

    :returns: omega (nk, nmode) [, vecs (nk, nmode, nmode) complex]
    """
    omega, vecs = _solve(model, kpts, want_vectors=return_vectors)
    return (omega, vecs) if return_vectors else omega


def dynamical_cluster(model, sizes, masses=None):
    """Dense mass-weighted Hessian of the glued (periodic) supercell with
    ``sizes[a]`` cells along each periodic direction: its spectrum equals
    the union of ``omega(k)`` over the uniform ``sizes`` grid.  Host
    NumPy, as in the reference.

    :param masses: optional (ncells * natom,) per-atom mass override
      (cells ordered C-style by cell index, atoms fastest)
    :returns: (H, omega) -- the dense Hessian (N d, N d) and its mode
      frequencies (clipped at 0; raises on instability)
    """
    if not isinstance(model, force_model):
        raise PythtbError("expected a force_model")
    if model._dim_k == 0:
        sizes = []
    else:
        if np.ndim(sizes) == 0:
            sizes = [int(sizes)] * model._dim_k
        sizes = [int(s) for s in sizes]
        if len(sizes) != model._dim_k or min(sizes) < 1:
            raise PythtbError("dynamical_cluster: bad sizes")
    ncell = int(np.prod(sizes)) if sizes else 1
    na, d = model._natom, model._dim_r
    N = ncell * na
    mass = np.tile(model._mass, ncell) if masses is None else np.asarray(masses, dtype=float)
    if mass.shape != (N,) or np.any(mass <= 0):
        raise PythtbError("dynamical_cluster: mass override must have ncells * natom positive entries")
    if sizes:
        grids = np.meshgrid(*[np.arange(s) for s in sizes], indexing="ij")
        cells = np.stack([g.reshape(-1) for g in grids], axis=-1)
    else:
        cells = np.zeros((1, 0), dtype=int)
    H = np.zeros((N * d, N * d))
    iidx, jidx, Rs, blocks, selfb, _ = model._tables()

    def flat(cell, atom):
        idx = 0
        for a in range(len(sizes)):
            idx = idx * sizes[a] + int(cell[a]) % sizes[a]
        return idx * na + atom

    for c in range(ncell):
        for b in range(len(iidx)):
            p = flat(cells[c], iidx[b])
            q = flat(cells[c] + np.rint(Rs[b][: len(sizes)]).astype(int), jidx[b])
            H[p * d:(p + 1) * d, q * d:(q + 1) * d] += blocks[b]
            H[q * d:(q + 1) * d, p * d:(p + 1) * d] += blocks[b].T
        for a in range(na):
            p = flat(cells[c], a)
            H[p * d:(p + 1) * d, p * d:(p + 1) * d] += selfb[a]
    w = np.repeat(1.0 / np.sqrt(mass), d)
    Hm = H * np.outer(w, w)
    w2 = np.linalg.eigvalsh(Hm)
    tol = 1e3 * np.finfo(float).eps * max(1.0, np.abs(w2).max()) * N
    if w2.min() < -tol:
        raise PythtbError("dynamical_cluster: negative eigenvalue %.3e -- unstable configuration" % float(w2.min()))
    return Hm, np.sqrt(np.clip(w2, 0.0, None))


def _grid(model, nk, shift=0.0):
    if model._dim_k == 0:
        return np.zeros((1, 0))
    if np.ndim(nk) == 0:
        nk = [int(nk)] * model._dim_k
    nk = [int(n) for n in nk]
    if len(nk) != model._dim_k or min(nk) < 1:
        raise PythtbError("nk must give %d sizes >= 1" % model._dim_k)
    grids = np.meshgrid(*[(np.arange(n) + shift) / n for n in nk], indexing="ij")
    return np.stack([g.reshape(-1) for g in grids], axis=-1)


def dos(model, energies, nk, smearing=0.05):
    """Gaussian-smeared phonon density of states per cell."""
    if float(smearing) <= 0:
        raise PythtbError("smearing must be positive")
    energies = np.atleast_1d(np.asarray(energies, dtype=float))
    omega, _ = _solve(model, _grid(model, nk))
    x = (energies[:, None, None] - omega[None]) / float(smearing)
    g = np.exp(-0.5 * x * x) / (float(smearing) * np.sqrt(2 * np.pi))
    return g.sum(axis=(1, 2)) / omega.shape[0]


def heat_capacity(model, temperatures, nk):
    """Harmonic phonon heat capacity per cell, ``C_v(T) = sum_modes
    x^2 e^x / (e^x - 1)^2`` with ``x = omega / T`` (k_B = 1); zero modes
    contribute their classical limit 1.

    :returns: (nT,) float array
    """
    Ts = np.atleast_1d(np.asarray(temperatures, dtype=float))
    if np.any(Ts <= 0):
        raise PythtbError("temperatures must be positive")
    omega, _ = _solve(model, _grid(model, nk))
    x = omega[None, :, :] / Ts[:, None, None]  # (nT, B, nmode)
    # x^2 e^x/(e^x-1)^2 = (x / (2 sinh(x/2)))^2, -> 1 as x -> 0
    small = x < 1e-8
    xs = np.where(small, 1.0, x)
    c = np.where(small, 1.0, (xs / (2.0 * np.sinh(np.minimum(xs, 350.0) / 2.0))) ** 2)
    return c.sum(axis=(1, 2)) / omega.shape[0]


def _kappa_reduced(model, kpts, Ts):
    """RTA kappa integrand sums (nT, dim_k, dim_k) in reduced coordinates
    (``_kappa_jit``): kernel 1, ``eigh_batched``, kernel 15 and kernel
    25, all on the model's device."""
    data = _bloch(model)
    k = _kpts(model, kpts, data.device)
    w2, vecs = eigh_batched(assemble(data, k))
    omega = torch.sqrt(torch.clamp(w2, min=0.0))
    return phonon_kappa(vecs, assemble_dk(data, k), omega, torch.as_tensor(Ts, dtype=config.FLOAT).to(data.device))


def thermal_conductivity(model, temperatures, nk, tau=1.0):
    """RTA lattice thermal conductivity per cell volume,
    ``kappa_ab(T) = (tau / V_c) <C(omega_kn) v_a v_b>_grid`` with
    Hellmann-Feynman group velocities (reduced k converted to Cartesian
    via the lattice), on the grid shifted by half a step.

    :returns: (nT, dim_k, dim_k) float array
    """
    if not isinstance(model, force_model):
        raise PythtbError("expected a force_model")
    if model._dim_k == 0:
        raise PythtbError("thermal_conductivity needs a periodic model")
    if model._dim_k != model._dim_r:
        raise PythtbError("thermal_conductivity requires dim_k == dim_r")
    Ts = np.atleast_1d(np.asarray(temperatures, dtype=float))
    if np.any(Ts <= 0):
        raise PythtbError("temperatures must be positive")
    kap_red = _kappa_reduced(model, _grid(model, nk, shift=0.5), Ts).cpu().numpy().astype(np.float64)
    # reduced -> Cartesian velocities: v_cart_a = sum_r J_ra v_red_r,
    # J = lat / (2 pi)
    J = np.asarray(model._lat, dtype=float) / (2.0 * np.pi)
    kap = np.einsum("ra,sc,trs->tac", J, J, kap_red)
    vol = abs(np.linalg.det(model._lat))
    return float(tau) * kap / vol
