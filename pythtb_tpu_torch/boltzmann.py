"""Semiclassical Boltzmann transport in the relaxation-time approximation
(counterpart of ``pythtb_tpu.boltzmann``): the RTA coefficients of a
chemical-potential batch, the transport distribution and the Edelstein
tensor.

Band velocities are the diagonal of the band-basis velocity matrices and
the inverse-mass tensors come from the exact second-order sum rule, all
from the analytic derivatives dH/dk and d2H/dk dk (kernel 15).  Every
chemical-potential (or energy) sweep is one launch of kernel 17
(:func:`pythtb_tpu_torch.ops.fermi_sweep.fermi_sweep`): the per-(k, band)
products v_a v_b, v_a eps v_e Minv and <s_a> v_c are its columns, and the
(M, B, S) arrays of the JAX programs are never formed.  Formalism, units
and the insulator guard are those of the JAX package (hbar = 1, q = -1).
``magnetotransport`` walks the Fermi-surface orbits of
:func:`pythtb_tpu_torch.fermisurface.fermi_surface` on the host, as the JAX
package does, with the velocities of every orbit of a band from one
``fermi_velocity`` call (kernel 15), and repairs the reference's
exponential integrator where a segment is short beside tau (see
:func:`_chambers_orbit`).
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import torch

from . import config
from .geometry import _prep
from .model import PythtbError
from .ops.fermi_sweep import fermi_sweep
from .ops.solver import device_uniform_grid
from .optical import _inverse_mass, _velocity_tensors

__all__ = ["transport_coefficients", "transport_distribution", "edelstein", "magnetotransport"]


def _band_v_minv(data, kpts, lat, need_minv=True):
    """evals (B, S), vecs, diagonal velocities vd (B, d, S) and band
    inverse-mass tensors minv (B, d, d, S) from the exact sum rule."""
    evals, vecs, V, W2 = _velocity_tensors(data, kpts, lat, need_d2=need_minv)
    vd = torch.diagonal(V, dim1=-2, dim2=-1).real
    return evals, vecs, vd, (_inverse_mass(evals, V, W2) if need_minv else None)


def _grid(model, caller, nk):
    data, lat, _ = _prep(model, caller)
    if np.ndim(nk) == 0:
        nk = [int(nk)] * data.dim_k
    nk = tuple(int(n) for n in nk)
    if len(nk) != data.dim_k or min(nk) < 2:
        raise PythtbError("nk must give %d sizes >= 2" % data.dim_k)
    return data, lat, device_uniform_grid(nk, np.zeros(data.dim_k), data.device)


def _columns(x):
    """(B, *idx, S) per-(k, band) factors -> (prod(idx), B*S) columns of
    kernel 17, t = (k, band)."""
    B, S = x.shape[0], x.shape[-1]
    return torch.movedim(x.reshape(B, -1, S), 1, 0).reshape(-1, B * S)


def _levi_civita(d, device):
    if d == 2:  # B along z: eps_{dez} = [[0, 1], [-1, 0]][d, e]
        return torch.tensor([[0.0, 1.0], [-1.0, 0.0]], dtype=config.FLOAT, device=device)
    eps = torch.zeros((3, 3, 3), dtype=config.FLOAT, device=device)
    for i, j, k, s in ((0, 1, 2, 1.0), (1, 2, 0, 1.0), (2, 0, 1, 1.0),
                       (0, 2, 1, -1.0), (2, 1, 0, -1.0), (1, 0, 2, -1.0)):
        eps[i, j, k] = s
    return eps


def _bt_columns(data, kpts, lat):
    """Kernel 17's inputs of the RTA sums: E (T,), G (P, T) and the powers
    of E - mu -- the columns v_a v_c / B at powers 0, 1, 2 (L0, L1, L2)
    and, in 2-D and 3-D, v_a eps v_e Minv / B at power 0 (the Hall tensor
    of shape ``hall_shape``)."""
    evals, _, vd, minv = _band_v_minv(data, kpts, lat)
    B = evals.shape[0]
    d = data.dim_k
    vvc = _columns(vd[:, :, None] * vd[:, None, :])
    blocks, jpow, hall_shape = [vvc, vvc, vvc], [0] * d * d + [1] * d * d + [2] * d * d, None
    if d > 1:
        eps = _levi_civita(d, vd.device)
        if d == 2:
            hall = torch.einsum("ban,de,ben,bdcn->bacn", vd, eps, vd, minv)
        else:
            hall = torch.einsum("ban,dec,ben,bdfn->bafcn", vd, eps, vd, minv)
        hall_shape = tuple(hall.shape[1:-1])
        blocks.append(_columns(hall))
        jpow += [0] * math.prod(hall_shape)
    return evals.reshape(-1).contiguous(), (torch.cat(blocks, dim=0) / B).contiguous(), jpow, hall_shape


def _bt(data, kpts, lat, mus, kt):
    """Raw grid means (L0, L1, L2 (M, d, d), hall (M, d, d[, d]), n_e (M,)),
    before volume, spin and tau factors: one launch of kernel 17 for the
    -df/de sums, one for the Fermi sum."""
    E, G, jpow, hall_shape = _bt_columns(data, kpts, lat)
    d, M = data.dim_k, mus.shape[0]
    out = fermi_sweep(E, G, mus, kt, "dfde", jpow)
    L0, L1, L2 = (out[:, i * d * d : (i + 1) * d * d].reshape(M, d, d) for i in range(3))
    if hall_shape is None:
        hall = torch.zeros((M, 1, 1), dtype=config.FLOAT, device=E.device)
    else:
        hall = out[:, 3 * d * d :].reshape((M,) + hall_shape)
    ones = torch.full((1, E.shape[0]), 1.0 / kpts.shape[0], dtype=config.FLOAT, device=E.device)
    n_e = fermi_sweep(E, ones, mus, kt, "fermi")[:, 0]
    return L0, L1, L2, hall, n_e


def transport_coefficients(model, mus, temperature, nk, tau=1.0):
    """RTA transport coefficients for a chemical-potential batch
    (counterpart of ``pythtb_tpu.boltzmann.transport_coefficients``): a
    dict of ``sigma``, ``seebeck``, ``kappa_e`` (M, d, d), ``lorenz``
    (M,), ``sigma_hall`` ((M,) in 2-D, (M, d, d, d) in 3-D),
    ``hall_coefficient`` (2-D), ``n`` and ``mus``.  Gapped chemical
    potentials give NaN ratios and a warning."""
    data, lat, kpts = _grid(model, "transport_coefficients", nk)
    kt = float(temperature)
    if kt <= 0:
        raise PythtbError("temperature must be positive")
    tau = float(tau)
    mus = np.atleast_1d(np.asarray(mus, dtype=float))
    res = _bt(data, kpts, lat, torch.as_tensor(mus).to(data.device), kt)
    L0, L1, L2, hall, n_e = (x.cpu().numpy().astype(np.float64) for x in res)

    vol = abs(np.linalg.det(lat))
    spin = 2.0 if data.nspin == 1 else 1.0
    norm = spin / vol
    L0, L1, L2, hall = (norm * L0, norm * L1, norm * L2, norm * hall)
    n_e = spin * n_e / vol

    q = -1.0  # electron charge in units of e
    d = data.dim_k
    M = mus.shape[0]
    sigma = tau * L0
    # insulator guard: L0 exponentially small -> ratios are 0/0
    floor = max(np.max(np.trace(L0, axis1=1, axis2=2)), 0.0) * 1e-10 + 1e-300
    dead = np.trace(L0, axis1=1, axis2=2) < floor
    if np.any(dead):
        warnings.warn(
            "transport_coefficients: %d of %d chemical potentials sit "
            "in a gap (sigma below the resolution floor); their "
            "Seebeck / Lorenz / Hall-coefficient entries are NaN" % (int(dead.sum()), M), stacklevel=2)
    seebeck = np.full((M, d, d), np.nan)
    kappa = np.full((M, d, d), np.nan)
    lorenz = np.full(M, np.nan)
    for i in range(M):
        if dead[i]:
            continue
        inv0 = np.linalg.inv(L0[i])
        seebeck[i] = inv0 @ L1[i] / (q * kt)
        kappa[i] = (tau / kt) * (L2[i] - L1[i] @ inv0 @ L1[i])
        lorenz[i] = kappa[i][0, 0] / (sigma[i][0, 0] * kt)
    out = {"mus": mus, "sigma": sigma, "seebeck": seebeck, "kappa_e": kappa, "lorenz": lorenz, "n": n_e}
    if d == 2:
        sig_h = -(q**3) * tau**2 * hall
        out["sigma_hall"] = sig_h[:, 0, 1]
        rh = np.full(M, np.nan)
        for i in range(M):
            if dead[i]:
                continue
            inv0 = np.linalg.inv(sigma[i])
            rh[i] = -(inv0 @ sig_h[i] @ inv0)[1, 0]
        out["hall_coefficient"] = rh
    elif d == 3:
        out["sigma_hall"] = -(q**3) * tau**2 * hall
    return out


def transport_distribution(model, energies, nk, smearing=0.05):
    """Transport distribution Sigma_ab(eps) = (spin/(N_k V_c)) sum_kn v_a
    v_b delta(eps - eps_kn), Gaussian delta of width ``smearing``
    (counterpart of ``pythtb_tpu.boltzmann.transport_distribution``):
    (nE, d, d), the energy sweep one launch of kernel 17."""
    data, lat, kpts = _grid(model, "transport_distribution", nk)
    if float(smearing) <= 0:
        raise PythtbError("smearing must be positive")
    energies = np.atleast_1d(np.asarray(energies, dtype=float))
    evals, _, vd, _ = _band_v_minv(data, kpts, lat, need_minv=False)
    B, d = evals.shape[0], data.dim_k
    G = (_columns(vd[:, :, None] * vd[:, None, :]) / B).contiguous()
    td = fermi_sweep(evals.reshape(-1).contiguous(), G, torch.as_tensor(energies).to(data.device),
                     float(smearing), "gauss")
    spin = 2.0 if data.nspin == 1 else 1.0
    return spin * td.reshape(-1, d, d).cpu().numpy() / abs(np.linalg.det(lat))


# bands within this energy of each other form one degenerate group of the
# Edelstein sum
_DEGENERATE_TOL = 1e-9


def _spin_velocity(evals, vecs, V):
    """(B, 3, d, S) per-band Edelstein factors Re sum_{m in g(n)} <n|s_x|m>
    <m|v_c|n> over the degenerate group g(n) of band n (|e_n - e_m| <=
    1e-9).  Summed over a group with one weight they give
    Tr(P_g s_x P_g v_c), which does not depend on the basis chosen inside
    the group (a Kramers pair's, say), where <n|s_x|n> v_c^n does.  V (B,
    d, S, S) are the band-basis velocity matrices of ``vecs``."""
    B, S = evals.shape
    vc = vecs.reshape(B, S, S // 2, 2)  # spin-fastest components
    sig = torch.as_tensor(np.stack([[[0, 1], [1, 0]], [[0, -1j], [1j, 0]], [[1, 0], [0, -1]]]) / 2.0,
                          dtype=config.COMPLEX).to(evals.device)
    snm = torch.einsum("bnor,xrs,bmos->bxnm", vc.conj(), sig, vc)  # (B, 3, S, S)
    group = ((evals[:, :, None] - evals[:, None, :]).abs() <= _DEGENERATE_TOL).to(snm.dtype)
    return torch.einsum("bxnm,bnm,bcmn->bxcn", snm, group, V).real


def _edelstein_columns(data, kpts, lat):
    """Kernel 17's inputs of the Edelstein sum: E (T,) and the columns of
    :func:`_spin_velocity` / B, x the spin axis (3), c the field axis."""
    evals, vecs, V, _ = _velocity_tensors(data, kpts, lat, need_d2=False)
    B = evals.shape[0]
    return evals.reshape(-1).contiguous(), (_columns(_spin_velocity(evals, vecs, V)) / B).contiguous()


def edelstein(model, mus, temperature, nk, tau=1.0):
    """Edelstein (inverse spin-galvanic) tensor of a spinful model,
    alpha[mu, spin_axis, field_axis] = q tau / (N_k V_c) sum_kn (-df/de)
    <nk|s_a|nk> v_b^{nk} (counterpart of ``pythtb_tpu.boltzmann.edelstein``):
    (M, 3, dim_k), the mu sweep one launch of kernel 17.  Within each
    degenerate group of bands the sum is the basis-free trace of
    :func:`_spin_velocity` (the JAX package takes <n|s_a|n> v_b^n band by
    band, which depends on the basis at Kramers-degenerate points)."""
    data, lat, _ = _prep(model, "edelstein")
    if data.nspin != 2:
        raise PythtbError("edelstein requires a spinful model (nspin == 2)")
    data, lat, kpts = _grid(model, "edelstein", nk)
    kt = float(temperature)
    if kt <= 0:
        raise PythtbError("temperature must be positive")
    mus = np.atleast_1d(np.asarray(mus, dtype=float))
    E, G = _edelstein_columns(data, kpts, lat)
    K = fermi_sweep(E, G, torch.as_tensor(mus).to(data.device), kt, "dfde")
    q = -1.0
    return q * float(tau) * K.reshape(-1, 3, data.dim_k).cpu().numpy() / abs(np.linalg.det(lat))


# below this x = dt / tau the segment weights come from their series
_SERIES_X = 0.5
# terms of the series f(x) = (1 - (1 - e^-x) / x) = x/2 - x^2/6 + x^3/24 - ...
_SERIES_TERMS = 18


def _one_minus_mean_decay(x):
    """f(x) = 1 - (1 - e^{-x}) / x, accurate to a few eps at every x > 0:
    its alternating series below ``_SERIES_X`` (where the closed form loses
    eps / x to cancellation), the closed form above."""
    x = np.asarray(x, dtype=np.float64)
    small = x < _SERIES_X
    xs = np.where(small, x, 0.0)
    # Horner on sum_{n >= 1} (-1)^(n+1) x^n / (n + 1)!
    acc = np.zeros_like(xs)
    for n in range(_SERIES_TERMS, 0, -1):
        acc = xs * (1.0 / math.factorial(n + 1) - acc)
    xl = np.where(small, 1.0, x)
    return np.where(small, acc, 1.0 + np.expm1(-xl) / xl)


def _chambers_orbit(v, dt, tau):
    """One periodic orbit's contribution ``oint dt v_a(t) J_b(t)`` to the
    Chambers tensor, ``J(t) = integral_0^inf e^{-s/tau} v(t - s) ds``, by
    the exact exponential integrator of the JAX package on the native orbit
    time grid: v linear on each segment, so ``J_{i+1} = E_i J_i + A_i v_i +
    C_i v_{i+1}`` with E = e^{-x}, x = dt/tau, and the periodic fixed point
    J_0 = b / (1 - P) of one pass.

    Repaired against the reference (``boltzmann.py:390``): there C = tau -
    tau^2 (1 - e^{-x}) / dt loses eps / x of its relative accuracy as
    x -> 0, and 1 - P, P the running product of the E_i, loses eps / sum(x).
    Here C = tau f(x) with f from :func:`_one_minus_mean_decay` (its series
    at small x) and 1 - P = -expm1(-sum x).

    v: (m, 2) velocities at the orbit nodes in traversal order;
    dt: (m,) time from node i to node i+1 (wrapping at m-1).
    """
    m = v.shape[0]
    x = dt / tau
    one_m_E = -np.expm1(-x)
    E = 1.0 - one_m_E
    C = tau * _one_minus_mean_decay(x)
    A = tau * one_m_E - C
    b = np.zeros(2)
    vn = np.roll(v, -1, axis=0)
    for i in range(m):
        b = E[i] * b + A[i] * v[i] + C[i] * vn[i]
    J0 = b / max(-np.expm1(-np.sum(x)), 1e-300)
    out = np.zeros((2, 2))
    J = J0
    for i in range(m):
        Jn = E[i] * J + A[i] * v[i] + C[i] * vn[i]
        out += 0.5 * dt[i] * (np.outer(v[i], J) + np.outer(vn[i], Jn))
        J = Jn
    return out


def magnetotransport(model, ef, bfields, tau=1.0, nk=301, bands=None):
    """Finite-field RTA conductivity tensor ``sigma_ab(B)`` of a 2-D metal
    by the Chambers path-integral solution of the Boltzmann equation (T = 0,
    B along z, hbar = 1, q = -1; counterpart of
    ``pythtb_tpu.boltzmann.magnetotransport``):

    ``sigma_ab(B) = spin q^2 / (2 pi)^2 sum_orbits oint (dl/|v|) v_a(k)
    integral_0^inf ds e^{-s/tau} v_b(k(-s))``

    over the closed and open (zone-traversing) orbits of
    :func:`pythtb_tpu_torch.fermisurface.fermi_surface`.  The velocities
    of every orbit of a band come from one ``fermi_velocity`` call (the
    same numbers as one call per orbit); the memory integral is the exact
    exponential integrator of :func:`_chambers_orbit`, repaired for
    segments short beside tau.

    :param model: fully periodic 2-D :class:`tb_model`
    :param ef: Fermi energy (T = 0 contour level)
    :param bfields: magnetic fields B_z (scalar or 1-D array; sign
        respected)
    :param tau: relaxation time
    :param nk: marching-squares grid resolution
    :param bands: band indices to include (default: all bands crossing
        ``ef``)
    :returns: dict with ``Bs`` (nB,), ``sigma`` (nB, 2, 2) in the units of
        :func:`transport_coefficients`, ``tau`` and ``orbits`` (count of
        (closed, open) contours used)
    """
    from .fermisurface import fermi_surface, fermi_velocity

    data, lat, _ = _prep(model, "magnetotransport")
    if data.dim_k != 2:
        raise PythtbError("magnetotransport: dim_k == 2 required")
    tau = float(tau)
    if tau <= 0:
        raise PythtbError("tau must be positive")
    Bs = np.atleast_1d(np.asarray(bfields, dtype=float))
    if np.any(Bs == 0.0):
        raise PythtbError(
            "magnetotransport: B = 0 is singular in the orbit "
            "parametrization; use transport_coefficients for the "
            "zero-field tensor (the B -> 0 limit is smooth)")
    G = 2.0 * np.pi * np.linalg.inv(np.asarray(lat, dtype=float)).T

    conts = fermi_surface(model, ef, nk=nk, bands=bands)
    spin = 2.0 if data.nspin == 1 else 1.0
    sigma = np.zeros((Bs.shape[0], 2, 2))
    n_closed = n_open = 0
    for b, lines in conts.items():
        orbits = []  # (pts, closed, W) of the band, before its velocities
        for pts, closed in lines:
            if pts.shape[0] < 8:
                continue  # marching artifact: too short to integrate
            W = None
            if closed:
                n_closed += 1
            else:
                # genuinely open orbits end one winding away from the
                # start; anything else is a truncated chain
                W = np.round(pts[-1] - pts[0])
                if not np.all(np.abs(pts[-1] - pts[0] - W) < 0.25) or np.all(W == 0):
                    warnings.warn(
                        "magnetotransport: skipping a non-periodic "
                        "open chain on band %d (raise nk)" % b, stacklevel=2)
                    continue
                n_open += 1
                pts = pts[:-1] if np.all(np.abs(pts[-1] - W - pts[0]) < 1e-9) else pts
            # drop zero-length segments (duplicate nodes at cell corners)
            step = np.linalg.norm(np.diff(pts, axis=0), axis=1)
            pts = pts[np.concatenate([[True], step > 1e-10])]
            if closed and np.linalg.norm(pts[-1] - pts[0]) < 1e-10:
                pts = pts[:-1]  # explicit closing node: wrap handles it
            if pts.shape[0] < 8:
                continue
            orbits.append((pts, closed, W))
        if not orbits:
            continue
        # one device call for the velocities of every orbit of the band
        vall = fermi_velocity(model, np.concatenate([o[0] for o in orbits]) % 1.0, bands=[b])[:, :, 0]
        splits = np.cumsum([o[0].shape[0] for o in orbits])[:-1]
        for (pts, closed, W), v in zip(orbits, np.split(vall, splits)):
            kc = pts @ G  # Cartesian contour points
            speed = np.linalg.norm(v, axis=1)
            if np.any(speed < 1e-12):
                warnings.warn(
                    "magnetotransport: orbit touches a van Hove "
                    "point (|v| = 0); its contribution is skipped", stacklevel=2)
                continue
            # segment from point i to i+1 (wrap: closed -> start; open ->
            # start shifted by the winding vector)
            nxt = np.roll(kc, -1, axis=0)
            if not closed:
                nxt[-1] = kc[0] + W @ G
            dl = np.linalg.norm(nxt - kc, axis=1)
            # traversal orientation for B > 0: dk/dt = (-v_y, v_x) B
            tang = nxt - kc
            kdot = np.stack([-v[:, 1], v[:, 0]], axis=1)
            if np.sum(np.einsum("ia,ia->i", tang, kdot)) < 0.0:
                # reversed point order: segment j runs q_j -> q_{j+1} =
                # old segment m-2-j, and the wrap segment is shared
                v = v[::-1]
                speed = speed[::-1]
                dl = np.roll(dl[::-1], -1)
            dt1 = dl / speed  # time along the orbit at |B| = 1
            for iB, Bz in enumerate(Bs):
                if Bz < 0.0:
                    # field reversal runs the same contour backwards
                    v_s = v[::-1]
                    dt_s = np.roll(dt1[::-1], -1) / abs(Bz)
                else:
                    v_s = v
                    dt_s = dt1 / abs(Bz)
                sigma[iB] += spin * abs(Bz) * _chambers_orbit(v_s, dt_s, tau) / (2.0 * np.pi) ** 2
    if n_closed + n_open == 0:
        warnings.warn("magnetotransport: no Fermi-surface orbit at "
                      "ef = %g (insulator or ef outside bands); sigma "
                      "is zero" % ef, stacklevel=2)
    return {"Bs": Bs, "sigma": sigma, "tau": tau, "orbits": (n_closed, n_open)}
