"""Linear spin-wave theory: magnon bands, Berry curvature, thermal Hall
and the neutron structure factor (counterpart of ``pythtb_tpu.magnon``).

A :class:`spin_model` describes localized moments with bilinear exchange
``H = sum_bonds S_i^T J_b S_j + sum_i S_i^T A_i S_i - sum_i h . S_i``
(each bond listed once; DM vectors are the antisymmetric part of J),
Holstein-Primakoff bosonized to quadratic order about a classical moment
configuration; the model, its local frames and its directed bond tables
are the JAX package's host NumPy code, conventions and all (standard HP
frame, Toth-Lake symmetrized-and-halved bond entries, normal-ordered
single-ion terms, displacement phases d = R + t_j - t_i).

The batched solve (``pythtb_tpu.magnon._lswt_solve_jit``) is kernel 27
(:func:`pythtb_tpu_torch.ops.colpa.colpa`: h(k) from the directed bond
entries, Hermitized and shifted, its Cholesky factor L and
T = L^H sigma3 L), then ``eigh_batched`` of T (the positive branch is
the upper half of its ascending spectrum; with vectors on the CPU's route,
the library's basis inside a degenerate pair) and, for vectors, one
triangular solve X = L^{-H} W |lambda|^{1/2}: the para-unitary
eigenvectors with COLUMNS as modes, as the reference returns them (the
eigenvectors of ``eigh_batched`` are rows; they are transposed here).

The sigma3-metric link products of :func:`berry_curvature` and
:func:`thermal_hall` and the F / S^ab contractions of
:func:`structure_factor` run in torch on the same device; the
Matsumoto-Murakami c2 weight is SciPy's dilogarithm on the host, as in
the reference.  The broadened neutron map is kernel 16's q-batch
Lorentzian mode (:func:`pythtb_tpu_torch.optical.spectral_sum_qbatch`)
with the map read as -Im(acc) / pi: the projected weights times the Bose
factor at the magnon energies, and at T > 0 the gain terms at -w_n(-q).
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import torch

from . import config
from .model import PythtbError
from .ops.colpa import ColpaTables, colpa
from .ops.eigh import eigh_batched, eigvalsh_batched
from .optical import spectral_sum_qbatch

__all__ = ["spin_model", "bands", "chern", "thermal_hall", "berry_curvature", "structure_factor"]


class spin_model:
    """Localized-moment model on a lattice.

    :param lat: (dim_r, dim_r) lattice vectors (rows)
    :param pos: (nsite, dim_r) reduced site positions
    :param spin: spin length S, scalar or per-site
    :param dim_k: number of periodic directions (default all)
    """

    def __init__(self, lat, pos, spin=0.5, dim_k=None):
        self._lat = np.asarray(lat, dtype=float)
        self._pos = np.atleast_2d(np.asarray(pos, dtype=float))
        self._dim_r = self._lat.shape[0]
        if self._lat.shape != (self._dim_r, self._dim_r):
            raise PythtbError("spin_model: lat must be square")
        if self._pos.shape[1] != self._dim_r:
            raise PythtbError("spin_model: pos must have dim_r columns")
        self._nsite = self._pos.shape[0]
        s = np.asarray(spin, dtype=float)
        self._S = np.full(self._nsite, float(s)) if s.ndim == 0 else s
        if self._S.shape != (self._nsite,) or np.any(self._S <= 0):
            raise PythtbError("spin_model: bad spin lengths")
        self._dim_k = self._dim_r if dim_k is None else int(dim_k)
        self._bonds = []  # (J 3x3, i, j, R)
        self._single_ion = [np.zeros((3, 3)) for _ in range(self._nsite)]
        self._field = np.zeros((self._nsite, 3))
        self._moments = np.tile([0.0, 0.0, 1.0], (self._nsite, 1))

    # -- construction ---------------------------------------------------

    def set_coupling(self, J, i, j, R=None, dm=None):
        """Add a bond ``S_i^T J S_j`` (listed once).  ``J`` scalar
        (Heisenberg) or 3x3; ``dm`` an optional Dzyaloshinskii-Moriya
        vector D with ``D . (S_i x S_j)`` added to the coupling."""
        if not (0 <= i < self._nsite and 0 <= j < self._nsite):
            raise PythtbError("set_coupling: site index out of range")
        R = np.zeros(self._dim_r) if R is None else np.asarray(R, float)
        if R.shape != (self._dim_r,):
            raise PythtbError("set_coupling: R must have dim_r entries")
        if self._dim_k < self._dim_r and np.any(
            np.abs(R[self._dim_k:]) > 1e-12
        ):
            raise PythtbError(
                "set_coupling: R nonzero along a non-periodic direction"
            )
        Jm = np.asarray(J, dtype=float)
        Jm = np.eye(3) * float(Jm) if Jm.ndim == 0 else Jm
        if Jm.shape != (3, 3):
            raise PythtbError("set_coupling: J must be scalar or 3x3")
        Jm = Jm.copy()
        if dm is not None:
            D = np.asarray(dm, dtype=float)
            if D.shape != (3,):
                raise PythtbError("set_coupling: dm must be a 3-vector")
            # D . (S_i x S_j) = S_i^T M S_j with M_ab = sum_c eps_abc D_c
            Jm += np.array([
                [0.0, D[2], -D[1]],
                [-D[2], 0.0, D[0]],
                [D[1], -D[0], 0.0],
            ])
        if i == j and np.max(np.abs(R)) < 1e-12:
            raise PythtbError(
                "set_coupling: same-site R=0 term is single-ion "
                "anisotropy; use set_single_ion"
            )
        self._bonds.append((Jm, int(i), int(j), R))

    def set_single_ion(self, A, i):
        """Single-ion term ``S_i^T A S_i`` (A symmetrized; the
        antisymmetric part is a constant for a single spin)."""
        Am = np.asarray(A, dtype=float)
        Am = np.eye(3) * float(Am) if Am.ndim == 0 else Am
        if Am.shape != (3, 3):
            raise PythtbError("set_single_ion: A must be scalar or 3x3")
        self._single_ion[i] = self._single_ion[i] + 0.5 * (Am + Am.T)

    def set_field(self, h, i=None):
        """Zeeman term ``-h . S_i`` (all sites when i is None)."""
        h = np.asarray(h, dtype=float)
        if h.shape != (3,):
            raise PythtbError("set_field: h must be a 3-vector")
        if i is None:
            self._field[:] = h
        else:
            self._field[i] = h

    def set_moments(self, directions):
        """Classical ground-state moment directions (unit 3-vectors,
        one per site).  LSWT is an expansion about this configuration;
        it is the caller's responsibility that it is the classical
        minimum (a non-positive-definite dynamical matrix raises at
        solve time)."""
        d = np.atleast_2d(np.asarray(directions, dtype=float))
        if d.shape != (self._nsite, 3):
            raise PythtbError("set_moments: need (nsite, 3) directions")
        n = np.linalg.norm(d, axis=1)
        if np.any(n < 1e-12):
            raise PythtbError("set_moments: zero direction")
        self._moments = d / n[:, None]

    def classical_energy(self):
        """Energy per cell of the classical moment configuration."""
        e = 0.0
        for Jm, i, j, R in self._bonds:
            e += self._S[i] * self._S[j] * (
                self._moments[i] @ Jm @ self._moments[j]
            )
        for i in range(self._nsite):
            e += self._S[i] ** 2 * (
                self._moments[i] @ self._single_ion[i] @ self._moments[i]
            )
            e -= self._S[i] * (self._field[i] @ self._moments[i])
        return float(e)

    # -- LSWT assembly tables --------------------------------------------

    def _frames(self):
        """(u, v): transverse complex frames and moment directions."""
        v = self._moments
        u = np.zeros((self._nsite, 3), dtype=complex)
        for i in range(self._nsite):
            ref = np.array([0.0, 0.0, 1.0])
            if abs(v[i] @ ref) > 0.9:
                ref = np.array([1.0, 0.0, 0.0])
            e1 = np.cross(ref, v[i])
            e1 /= np.linalg.norm(e1)
            e2 = np.cross(v[i], e1)
            u[i] = e1 + 1j * e2
        return u, v

    def _tables(self):
        """Host-side LSWT bond tables.

        Returns (iidx, jidx, d, a_amp, b_amp, Cdiag, nsite) where the
        per-bond amplitudes follow the symmetrized-and-halved
        convention in the module docstring, and Cdiag collects the
        k-independent diagonal (vv exchange, single-ion, Zeeman).
        """
        u, v = self._frames()
        S = self._S
        # symmetrize: every user bond contributes itself and its
        # transpose-reversed partner, each at half weight
        sym = []
        for Jm, i, j, R in self._bonds:
            sym.append((0.5 * Jm, i, j, R))
            sym.append((0.5 * Jm.T, j, i, -R))
        iidx, jidx, dvec, a_amp, b_amp = [], [], [], [], []
        Cdiag = np.zeros(self._nsite)
        for Jm, i, j, R in sym:
            d = R + self._pos[j] - self._pos[i]
            # per-directed-entry factor sqrt(SiSj) on the HALVED Jm:
            # the a_i a^dag_j reordering terms double the naive
            # sqrt(SiSj)/2 coefficient of each ordered expansion (see
            # module docstring; pinned by the FM-chain analytic and
            # the exact one-magnon oracle)
            pref = np.sqrt(S[i] * S[j])
            iidx.append(i)
            jidx.append(j)
            dvec.append(d[: self._dim_k])
            # standard HP frame (S^+_local ~ a): the a^dag_i a_j
            # coefficient is u_i^T J conj(u_j); the conjugated frame
            # relabels omega(k) -> omega(-k) (caught by the exact
            # translation-eigenvalue oracle in test_magnon_sf.py)
            a_amp.append(pref * (u[i] @ Jm @ np.conj(u[j])))
            b_amp.append(pref * (u[i] @ Jm @ u[j]))
            # n_i coefficient -S_j v_i J v_j (full J); each directed
            # entry carries J/2 and only touches its own i slot
            Cdiag[i] += 2.0 * S[j] * (v[i] @ Jm @ v[j])
        for i in range(self._nsite):
            Am = self._single_ion[i]
            if np.max(np.abs(Am)) > 0:
                # normal-ordered HP: (v.S)^2 -> -(2S-1) n (so S = 1/2
                # single-ion terms drop out exactly); transverse parts
                # (standard frame) give n coeff S Re[u^T A conj(u)]
                # and a^dag a^dag coeff (S/2) u^T A u (single slot,
                # halved vs the bond-pair splitting)
                iidx.append(i)
                jidx.append(i)
                dvec.append(np.zeros(self._dim_k))
                a_amp.append(S[i] * np.real(u[i] @ Am @ np.conj(u[i])))
                b_amp.append(0.5 * S[i] * (u[i] @ Am @ u[i]))
                Cdiag[i] += (2.0 * S[i] - 1.0) * (v[i] @ Am @ v[i])
            Cdiag[i] -= self._field[i] @ v[i]
        if not iidx:
            raise PythtbError("spin_model: no couplings set")
        return (
            np.asarray(iidx, np.int32),
            np.asarray(jidx, np.int32),
            np.asarray(dvec, float).reshape(len(iidx), self._dim_k),
            np.asarray(a_amp, complex),
            np.asarray(b_amp, complex),
            # h(k) diagonal gets A_ii - C_ii with C as defined; fold
            # the standard minus sign here: diag contribution = -Cdiag
            Cdiag,
        )



_COLPA_FAILED = (
    "magnon: Colpa decomposition failed (dynamical matrix not "
    "positive definite) -- the moment configuration is not a "
    "classical minimum, or a Goldstone mode needs a larger "
    "shift")


def _solve_device(model, kpts, shift, want_vectors):
    """(omega (B, nsite) ascending positive branch, X (B, 2n, 2n) with
    COLUMNS as modes, or None) as tensors on the current device."""
    iidx, jidx, dvec, a_amp, b_amp, cdiag = model._tables()
    kpts = np.atleast_2d(np.asarray(kpts, dtype=float))
    if kpts.shape[1] != model._dim_k:
        raise PythtbError("magnon: kpts must have dim_k columns")
    dev = config.checked_device()
    tab = ColpaTables(iidx, jidx, dvec, a_amp, b_amp, cdiag, dev)
    k = torch.as_tensor(np.ascontiguousarray(kpts), dtype=config.FLOAT).to(dev)
    T, L = colpa(tab, float(shift), k)
    if not bool(torch.isfinite(T).all()):
        raise PythtbError(_COLPA_FAILED)
    n = model._nsite
    if not want_vectors:
        lam = eigvalsh_batched(T)  # ascending: n negative, n positive
        W = None
    else:
        # the library's basis inside a degenerate pair: the per-band
        # plaquette fluxes of thermal_hall and berry_curvature depend on it
        # where bands touch (the kagome magnet at Gamma), and kernel 7's
        # Jacobi picks another one
        lam, W = eigh_batched(T, cpu_route=True)
    omega = lam[:, n:]
    if not bool(torch.isfinite(omega).all()):
        raise PythtbError(_COLPA_FAILED)
    if W is None:
        return omega, None
    # para-unitary eigenvectors X = K^-1 W |Lambda|^{1/2} (Colpa), K = L^H:
    # X^H sigma3 X = sigma3 and sigma3 h X = X sigma3 Lambda
    X = torch.linalg.solve_triangular(L.mH, W.transpose(-1, -2), upper=True)
    return omega, X * torch.sqrt(lam.abs())[:, None, :]


def _solve(model, kpts, shift, want_vectors):
    """Host wrapper: (omega (B, nsite), X (B, 2n, 2n) columns = modes, or
    None) as NumPy."""
    w, X = _solve_device(model, kpts, shift, want_vectors)
    w = w.cpu().numpy().astype(np.float64)
    return w, (None if X is None else np.array(X.cpu().numpy(), copy=True))


def bands(model, kpts, shift=1e-9):
    """Magnon energies on a k-list: (nk, nsite), ascending.

    ``shift`` regularizes Goldstone zeros (added to the dynamical matrix
    diagonal before the Cholesky factorization)."""
    w, _ = _solve(model, kpts, shift, False)
    return w


def _grid_modes(model, nk, shift):
    """Energies (nk^2, n) and positive-branch columns X[:, :, n:] as
    (nk, nk, 2n, n) tensors on the device, for an nk x nk grid."""
    n = model._nsite
    ks = np.arange(nk) / nk
    kx, ky = np.meshgrid(ks, ks, indexing="ij")
    kpts = np.stack([kx.reshape(-1), ky.reshape(-1)], axis=-1)
    w, X = _solve_device(model, kpts, shift, True)
    return w, X[:, :, n:].reshape(nk, nk, 2 * n, n)


def _plaquette_links(Xp, n):
    """Per band the product of the four sigma3-metric links of each
    plaquette, (nk, nk, nband): L = X_n(k)^H sigma3 X_n(k')."""
    sg = torch.cat([torch.ones(n), -torch.ones(n)]).to(device=Xp.device, dtype=config.COMPLEX)

    def link(a, b):
        return torch.einsum("xymb,m,xymb->xyb", a.conj(), sg, b)

    Xr = torch.roll(Xp, -1, dims=0)
    Xu = torch.roll(Xp, -1, dims=1)
    Xru = torch.roll(Xr, -1, dims=1)
    return link(Xp, Xr) * link(Xr, Xru) * link(Xru, Xu) * link(Xu, Xp)


def berry_curvature(model, nk, band, shift=1e-8):
    """Plaquette Berry fluxes of one magnon band on an nk x nk grid (2-D
    models): (nk, nk) array summing to 2 pi C.  Links use the bosonic
    para-unitary metric ``L = X_n(k)^H sigma3 X_n(k')``."""
    if model._dim_k != 2:
        raise PythtbError("berry_curvature: dim_k == 2 required")
    _, Xp = _grid_modes(model, nk, shift)
    prod = _plaquette_links(Xp[..., band:band + 1], model._nsite)[..., 0].cpu().numpy()
    if np.min(np.abs(prod)) < 1e-8:
        warnings.warn("magnon.berry_curvature: near-singular plaquette link (band crossing on the grid?)",
                      stacklevel=2)
    # minus sign: the package-wide flux orientation (flows.chern_number)
    return -np.angle(prod)


def chern(model, band, nk=31, shift=1e-8):
    """Chern number of one magnon band (positive branch, ascending)."""
    return float(np.round(np.sum(berry_curvature(model, nk, band, shift)) / (2 * np.pi)))


def _c2(x):
    """Matsumoto-Murakami c2 weight of the Bose function value x > 0:
    ``c2(x) = (1+x) ln^2((1+x)/x) - ln^2 x - 2 Li2(-x)``."""
    from scipy.special import spence

    x = np.asarray(x, dtype=np.float64)
    li2 = spence(1.0 + x)  # Li2(-x) = spence(1 - (-x))
    return (1.0 + x) * np.log((1.0 + x) / x) ** 2 - np.log(x) ** 2 \
        - 2.0 * li2



def thermal_hall(model, temperatures, nk=41, shift=1e-8):
    """Magnon thermal Hall conductivity kappa_xy(T) (2-D models),

    ``kappa_xy = -(k_B^2 T / hbar) sum_n int d^2k/(2 pi)^2
        [c2(g(omega_nk)) - pi^2/3] Omega_nk``

    in units of ``k_B^2 / hbar`` (k_B = 1), the Matsumoto-Murakami form;
    the BZ integral is the sum of plaquette fluxes over (2 pi)^2.
    """
    if model._dim_k != 2:
        raise PythtbError("thermal_hall: dim_k == 2 required")
    n = model._nsite
    w, Xp = _grid_modes(model, nk, shift)
    # package-orientation plaquette flux F = Omega_cart dk^2, every band
    flux_all = -np.angle(_plaquette_links(Xp, n).cpu().numpy())
    w = w.cpu().numpy().astype(np.float64)
    temperatures = np.atleast_1d(np.asarray(temperatures, dtype=float))
    kap = np.zeros(len(temperatures))
    for bnd in range(n):
        flux = flux_all[:, :, bnd]
        wn = w[:, bnd].reshape(nk, nk)
        for ti, T in enumerate(temperatures):
            if T <= 0:
                continue
            # clip the exponent: overflow in expm1 just means g = 0
            g = 1.0 / np.expm1(np.minimum(np.maximum(wn, 1e-12) / T, 500.0))
            wt = _c2(np.maximum(g, 1e-300)) - np.pi ** 2 / 3.0
            # kappa_xy = -T sum_plaq wt * F / (2 pi)^2
            kap[ti] += -T * np.sum(wt * flux) / (2.0 * np.pi) ** 2
    return kap if len(kap) > 1 else float(kap[0])


def _bose(w, T):
    return 1.0 / torch.expm1(torch.clamp(torch.clamp(w, min=1e-12) / T, max=500.0))


def _project(model, Sab, qred, polarization):
    """Neutron weights (Q, n) of the mode weights Sab (Q, n, 3, 3) at the
    reduced transfers ``qred`` (Q, dim_k): the unpolarized projector
    sum_ab (delta_ab - qhat_a qhat_b) S^ab (the isotropic (2/3) tr S at
    q = 0), or the trace."""
    tr = torch.einsum("qnaa->qn", Sab).real
    if not polarization:
        return tr
    rec = np.linalg.inv(model._lat).T[: model._dim_k]
    qc = qred @ torch.as_tensor(rec, dtype=config.FLOAT).to(qred.device)  # (Q, dim_r)
    qn = torch.linalg.norm(qc, dim=-1)
    qh = torch.zeros((qc.shape[0], 3), dtype=config.FLOAT, device=qc.device)
    qh[:, : qc.shape[1]] = qc / torch.where(qn < 1e-12, torch.ones_like(qn), qn)[:, None]
    proj = torch.eye(3, dtype=config.FLOAT, device=qc.device)[None] - qh[:, :, None] * qh[:, None, :]
    wt = torch.einsum("qnab,qab->qn", Sab, proj.to(config.COMPLEX)).real
    return torch.where((qn < 1e-12)[:, None], (2.0 / 3.0) * tr, wt)


def structure_factor(model, qpts, omegas=None, eta=0.02, temperature=0.0, shift=1e-9, polarization=True):
    """One-magnon dynamical spin structure factor ``S(q, omega)``, the
    inelastic-neutron-scattering observable at LSWT level:

    ``S^{ab}(q, w) = sum_n conj(F^a_n(q)) F^b_n(q) delta(w - w_n(q))``,
    ``F^a_n(q) = sum_i sqrt(S_i/2) [conj(u_i^a) conj(X(q)_{N+i, N+n})
    + u_i^a conj(X(q)_{i, N+n})]``; the longitudinal part is not
    included.

    :param model: :class:`spin_model`
    :param qpts: (nq, dim_k) reduced momentum transfers
    :param omegas: optional (nw,) energy-transfer grid; when given the
        return value is the broadened intensity map
    :param eta: Lorentzian HWHM for the broadened map
    :param temperature: when > 0, the map includes the detailed-balance
        Bose factors: ``(1 + g(w_n(q)))`` on the loss side and the
        anti-Stokes gain peak at ``-w_n(-q)`` with weight ``g``
    :param shift: Goldstone regularization (see :func:`bands`)
    :param polarization: apply the unpolarized-neutron projector
        ``sum_ab (delta_ab - qhat_a qhat_b) S^{ab}`` (at q = 0 the
        isotropic average ``(2/3) tr S``); ``False`` sums the trace.
    :returns: ``(w, Sab)`` when ``omegas`` is None -- magnon energies
        (nq, nsite) and complex mode weights (nq, nsite, 3, 3) -- else the
        real intensity map (nq, nw).
    """
    qpts = np.atleast_2d(np.asarray(qpts, dtype=float))
    if qpts.shape[1] != model._dim_k:
        raise PythtbError("structure_factor: qpts must have dim_k columns")
    nq = qpts.shape[0]
    want_gain = omegas is not None and temperature > 0
    qs = np.concatenate([qpts, -qpts], axis=0) if want_gain else qpts
    w, X = _solve_device(model, qs, shift, True)
    dev = w.device
    n = model._nsite
    u, _ = model._frames()
    pref = torch.as_tensor(np.sqrt(model._S / 2.0), dtype=config.COMPLEX).to(dev)
    ut = torch.as_tensor(u, dtype=config.COMPLEX).to(dev)
    # creation amplitudes from the positive branch of X(q)
    Xp = X[:, :, n:].conj()  # (nQ, 2n, n)
    F = (torch.einsum("i,ia,qin->qna", pref, ut.conj(), Xp[:, n:, :])
         + torch.einsum("i,ia,qin->qna", pref, ut, Xp[:, :n, :]))
    Sab = torch.einsum("qna,qnb->qnab", F.conj(), F)  # (nQ, n, 3, 3)
    if omegas is None:
        return w.cpu().numpy().astype(np.float64), Sab.cpu().numpy()
    omegas = np.asarray(omegas, dtype=float)
    qt = torch.as_tensor(qpts, dtype=config.FLOAT).to(dev)
    wt = _project(model, Sab[:nq], qt, polarization)  # (nq, n)
    wn = w[:nq]
    if temperature > 0:
        wt = wt * (1.0 + _bose(wn, float(temperature)))
    W, de = wt, wn
    if want_gain:
        wng = w[nq:]
        W = torch.cat([wt, _project(model, Sab[nq:], -qt, polarization) * _bose(wng, float(temperature))], dim=1)
        de = torch.cat([wn, -wng], dim=1)
    om = torch.as_tensor(omegas, dtype=config.FLOAT).to(dev)
    acc = spectral_sum_qbatch(W[:, None, :].to(config.COMPLEX).contiguous(), de.contiguous(), om, float(eta))
    return (-acc[:, 0].imag / math.pi).cpu().numpy().astype(np.float64)
