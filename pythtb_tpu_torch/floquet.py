"""Time-periodic (Floquet) driving of tight-binding models (counterpart of
``pythtb_tpu.floquet``).

The drive enters through the Peierls substitution (every hop times
exp(i A(t) . d_h), d_h its Cartesian displacement), through per-hop
amplitude factors (``{"hop_factors": fn}``, piecewise-switched lattices
such as the Rudner-Lindner-Berg-Levin drive) and through time-periodic
on-site energies (``"onsite"``).  Its per-hop samples and harmonics are
host NumPy in float64, copied from the JAX package (``_drive_at``,
``_hop_displacements``, ``_phase_samples``, ``_onsite_samples``,
``_hop_fourier``), and so is the van Vleck hop-table algebra of
:func:`effective_model`.

Device work:

* :func:`quasienergies`: the truncated extended-zone Floquet matrix
  ((2M + 1) S)^2 per k in one launch of kernel 1's Floquet-block mode
  (:func:`pythtb_tpu_torch.ops.hamiltonian.assemble_floquet`), then one
  ``eigh_batched``; the m = 0 weights of the eigenvectors.
* :func:`propagator`, :func:`quasienergies_exact`, :func:`chern`,
  :func:`winding_number`: the one-period evolution U(T, k) by the midpoint
  product of nt factors exp(-i H(t_s) dt).  Per chunk of steps, every
  step's H(t_s) comes from one launch of kernel 1's flux-batch mode
  (member s: amplitudes amp * c_h(t_s), on-site matrix diag + ons(t_s)),
  one ``eigh_batched`` solves them, and kernel 22's full mode
  (:func:`pythtb_tpu_torch.ops.propagate.propagate_full`) multiplies the
  chain, writing the history for :func:`winding_number`.  Eigenphases by
  ``unitary_eig``; :func:`chern` sums plaquette phases on kernels 3-4;
  :func:`winding_number` is kernel 24 (``ops/winding.py``).

The JAX package's ri-packing of complex arrays is not needed: complex
tensors move directly.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import config
from .flows import gauge_phases
from .model import PythtbError, tb_model
from .ops.berry import plaquette_phases, unitary_eig, unitary_eigenphases
from .ops.eigh import eigh_batched
from .ops.hamiltonian import assemble_floquet, assemble_members
from .ops.propagate import chunk_steps, propagate_full
from .ops.solver import device_uniform_grid, extend_pbc_seq
from .ops.winding import winding

__all__ = [
    "quasienergies",
    "quasienergies_exact",
    "propagator",
    "chern",
    "winding_number",
    "effective_model",
]


# ---------------------------------------------------------------------------
# Host-side drive geometry and harmonics (float64)
# ---------------------------------------------------------------------------


def _drive_at(drive, omega, times, dim_r):
    """Sample the vector potential A(t) at host times, (nt, dim_r)."""
    times = np.asarray(times, dtype=np.float64)
    if callable(drive):
        out = np.array([np.asarray(drive(t), dtype=np.float64) for t in times])
        if out.shape != (len(times), dim_r):
            raise PythtbError(
                "drive callable must return a length-%d vector" % dim_r
            )
        return out
    amp = np.asarray(drive["A"], dtype=np.float64).reshape(-1)
    ph = np.asarray(drive.get("phase", np.zeros_like(amp)),
                    dtype=np.float64).reshape(-1)
    if amp.shape != (dim_r,) or ph.shape != (dim_r,):
        raise PythtbError('drive["A"]/"phase" must have length dim_r=%d'
                          % dim_r)
    return amp[None, :] * np.cos(omega * times[:, None] - ph[None, :])


def _hop_displacements(model):
    """Full Cartesian hop displacements d = (R + t_j - t_i) @ lat,
    (nhop, dim_r) -- includes the non-periodic directions (a finite
    ribbon can be driven across its finite width)."""
    from .magnetic import _hop_arrays

    ii, jj, R = _hop_arrays(model)
    orb = np.asarray(model._orb, dtype=np.float64)
    red = -orb[ii, :] + orb[jj, :] + R
    return red @ np.asarray(model._lat, dtype=np.float64)


def _phase_samples(model, drive, omega, nt, midpoint):
    """Per-hop drive factors c_h(t_s) over one period, (nt, nhop)
    complex128.  ``midpoint`` shifts samples to (s + 1/2) T / nt
    (propagator rule); otherwise s T / nt (DFT rule).

    Two drive families share every downstream code path (the Hermitian
    partner always carries the conjugate factor):
    - Peierls (``{"A": ..., "phase": ...}`` or a callable t -> A):
      c_h(t) = exp(i A(t) . d_h);
    - amplitude modulation (``{"hop_factors": fn}``): fn(t) returns a
      (nhop,) array multiplying the stored amplitudes, indexed in
      ``set_hop`` insertion order (piecewise drives like the
      Rudner-Lindner-Berg-Levin model)."""
    nhop = len(model._hoppings)
    T = 2.0 * np.pi / omega
    s = np.arange(nt, dtype=np.float64) + (0.5 if midpoint else 0.0)
    times = s * (T / nt)
    if isinstance(drive, dict) and not (
        "A" in drive or "hop_factors" in drive or "onsite" in drive
    ):
        raise PythtbError(
            'drive dict must contain "A", "hop_factors", and/or "onsite"'
        )
    if isinstance(drive, dict) and "onsite" in drive and not (
        "A" in drive or "hop_factors" in drive
    ):
        # pure onsite modulation: hops are undriven
        return np.ones((nt, nhop), dtype=np.complex128)
    if isinstance(drive, dict) and "hop_factors" in drive:
        fn = drive["hop_factors"]
        out = np.array(
            [np.asarray(fn(t), dtype=np.complex128).reshape(-1)
             for t in times]
        )
        if out.shape != (nt, nhop):
            raise PythtbError(
                'drive["hop_factors"] must return a length-%d array '
                "per time" % nhop
            )
        return out
    d = _hop_displacements(model)  # (nhop, dim_r)
    A = _drive_at(drive, omega, times, model._dim_r)  # (nt, dim_r)
    return np.exp(1j * (A @ d.T))  # (nt, nhop)


def _onsite_samples(model, drive, omega, nt, midpoint):
    """Optional time-periodic onsite modulation: ``drive["onsite"]`` is
    a callable t -> (norb,) REAL energies ADDED to the static site
    energies.  Returns (nt, nsta) float64 (spin-replicated) or None."""
    if not (isinstance(drive, dict) and "onsite" in drive):
        return None
    fn = drive["onsite"]
    T = 2.0 * np.pi / omega
    s = np.arange(nt, dtype=np.float64) + (0.5 if midpoint else 0.0)
    out = np.array(
        [np.asarray(fn(t), dtype=np.float64).reshape(-1)
         for t in s * (T / nt)]
    )
    if out.shape != (nt, model._norb):
        raise PythtbError(
            'drive["onsite"] must return a length-%d real array per time'
            % model._norb
        )
    if model._nspin == 2:
        out = np.repeat(out, 2, axis=1)
    return out


def _hop_fourier(model, drive, omega, mmax, nt):
    """Harmonics c_m of exp(i theta_h(t)) = sum_m c_m e^{i m Omega t},
    returned as (2*mmax+1, nhop) complex128 with m = -mmax..mmax.

    A plain DFT over one period: exact to aliasing, which decays
    spectrally for the smooth phase factors at hand (nt >= 4*mmax + 4
    enforced by callers)."""
    ph = _phase_samples(model, drive, omega, nt, midpoint=False)
    # c_m = (1/nt) sum_s x_s e^{-2 pi i m s / nt}  == fft(x)/nt at m
    c = np.fft.fft(ph, axis=0) / nt  # rows m = 0..nt-1
    rows = [c[m % nt] for m in range(-mmax, mmax + 1)]
    return np.stack(rows, axis=0)


# ---------------------------------------------------------------------------
# Device parts
# ---------------------------------------------------------------------------


def _spectrum(data, nharm, cm, om_h, kpts, omega):
    """Eigen-decompose the truncated Floquet matrix for a k-batch
    (counterpart of ``pythtb_tpu.floquet._spectrum_jit``).  Returns
    (evals (B, NM S), m = 0 weights (B, NM S)) as tensors, eigenvalues
    ascending."""
    dev = data.device
    fac = torch.as_tensor(np.ascontiguousarray(cm, dtype=np.complex128)).to(dev)
    ons = torch.as_tensor(np.ascontiguousarray(om_h, dtype=np.complex128)).to(dev)
    K = assemble_floquet(data, kpts, fac, ons, omega, nharm)
    evals, vecs = eigh_batched(K)  # rows of vecs are states
    S = data.nsta
    central = vecs[:, :, nharm * S:(nharm + 1) * S]
    return evals, (central.abs() ** 2).sum(dim=-1)


def _propagation_scan(data, dphase, ons, kpts, dt, collect_history):
    """Midpoint-product evolution over one period (counterpart of
    ``pythtb_tpu.floquet._propagation_scan``): ``dphase`` (nt, nhop) and
    ``ons`` (nt, nsta) are the drive's samples at the step midpoints.
    Returns U (B, S, S) and, with ``collect_history``, the (nt + 1, B, S,
    S) history with U(0) = 1 first."""
    dev = data.device
    B, S = kpts.shape[0], data.nsta
    nt = dphase.shape[0]
    dph = torch.as_tensor(np.ascontiguousarray(dphase, dtype=np.complex128)).to(dev)
    onsd = torch.as_tensor(np.ascontiguousarray(ons, dtype=np.float64)).to(dev)
    U = torch.eye(S, dtype=config.COMPLEX, device=dev).expand(B, S, S).contiguous()
    hist = None
    if collect_history:
        hist = torch.empty((nt + 1, B, S, S), dtype=config.COMPLEX, device=dev)
        hist[0] = U
    dt_rows = torch.full((B,), float(dt), dtype=config.FLOAT, device=dev)
    idx = torch.arange(S, device=dev)
    # a step's rows hold H and V (16 S^2 each) and w
    Tc = chunk_steps(nt, B * (32 * S * S + 8 * S))
    for t0 in range(0, nt, Tc):
        n = min(Tc, nt - t0)
        amps = data.amps[None] * (dph[t0:t0 + n] if data.nspin == 1 else dph[t0:t0 + n, :, None, None])
        diag = data.diag[None].repeat(n, 1, 1)
        diag[:, idx, idx] += onsd[t0:t0 + n].to(config.COMPLEX)
        w, V = eigh_batched(assemble_members(data, amps.contiguous(), diag, kpts))
        U = propagate_full(w.reshape(n, B, S), V.reshape(n, B, S, S), U, dt_rows,
                           None if hist is None else hist[1 + t0:1 + t0 + n])
    return U, hist


def _drive_samples(model, data, drive, omega, nt):
    """The midpoint samples of the drive: (dphase (nt, nhop), ons (nt,
    nsta), dt)."""
    dph = _phase_samples(model, drive, omega, nt, midpoint=True)
    ons = _onsite_samples(model, drive, omega, nt, midpoint=True)
    if ons is None:
        ons = np.zeros((nt, data.nsta))
    return dph, ons, 2.0 * np.pi / (omega * nt)


def _prep(model, omega, k_list):
    if float(omega) <= 0.0:
        raise PythtbError("drive frequency omega must be positive")
    data = model._get_finalized()
    if model._dim_k == 0:
        kpts = np.zeros((1, 0), dtype=np.float64)
    else:
        if k_list is None:
            raise PythtbError("k_list is required for periodic models")
        kpts = np.asarray(k_list, dtype=np.float64)
        if kpts.ndim == 1:
            kpts = kpts[:, None] if model._dim_k == 1 else kpts[None, :]
        if kpts.ndim != 2 or kpts.shape[1] != model._dim_k:
            raise PythtbError(
                "k_list must be (nk, %d) for this model" % model._dim_k
            )
    return data, torch.as_tensor(np.ascontiguousarray(kpts)).to(data.device)


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


def quasienergies(model, omega, drive, k_list=None, nharm=6, nt=None):
    """Floquet quasienergy spectrum from the truncated extended-zone
    Hamiltonian (counterpart of ``pythtb_tpu.floquet.quasienergies``):
    ``(quasi, weight)``, eigenvalues (nk, (2M+1) nsta) ascending and their
    m = 0-sector weights.

    :param drive: ``{"A": amps, "phase": phases}``, a callable t -> A, or
      ``{"hop_factors": fn}``, optionally with ``"onsite": fn``
    :param nharm: harmonic cutoff M (blocks up to |m| = 2M kept)
    :param nt: drive samples per period for the harmonic DFT (default
      max(64, 8 nharm + 8))
    """
    omega = float(omega)
    data, kpts = _prep(model, omega, k_list)
    nharm = int(nharm)
    if nharm < 1:
        raise PythtbError("nharm must be >= 1")
    if nt is None:
        nt = max(64, 8 * nharm + 8)
    nt = int(nt)
    if nt < 4 * nharm + 4:
        raise PythtbError("nt must be >= 4*nharm + 4 for unaliased harmonics")
    cm = _hop_fourier(model, drive, omega, 2 * nharm, nt)
    ons = _onsite_samples(model, drive, omega, nt, midpoint=False)
    nm_tot = 4 * nharm + 1
    if ons is None:
        om_h = np.zeros((nm_tot, data.nsta), dtype=np.complex128)
    else:
        c = np.fft.fft(ons, axis=0) / nt
        om_h = np.stack([c[mi % nt] for mi in range(-2 * nharm, 2 * nharm + 1)], axis=0)
    evals, weights = _spectrum(data, nharm, cm, om_h, kpts, omega)
    return evals.cpu().numpy().astype(np.float64), weights.cpu().numpy().astype(np.float64)


def _propagator_device(model, omega, drive, k_list, nt):
    """U(T, k) as a tensor on the model's device."""
    data, kpts = _prep(model, omega, k_list)
    nt = int(nt)
    if nt < 4:
        raise PythtbError("nt must be >= 4")
    dph, ons, dt = _drive_samples(model, data, drive, omega, nt)
    U, _ = _propagation_scan(data, dph, ons, kpts, dt, collect_history=False)
    return U


def propagator(model, omega, drive, k_list=None, nt=256):
    """Exact one-period evolution operator U(T, k), (nk, S, S) complex, by
    a midpoint product of ``nt`` exponential factors (counterpart of
    ``pythtb_tpu.floquet.propagator``)."""
    U = _propagator_device(model, float(omega), drive, k_list, nt)
    return U.cpu().numpy()


def quasienergies_exact(model, omega, drive, k_list=None, nt=256, ezero=0.0):
    """Truncation-free quasienergies from the eigenphases of
    :func:`propagator`, folded into (ezero - Omega/2, ezero + Omega/2] and
    sorted ascending, (nk, nsta)."""
    omega = float(omega)
    U = _propagator_device(model, omega, drive, k_list, nt)
    theta = unitary_eigenphases(U).cpu().numpy().astype(np.float64)
    eps = -theta * omega / (2.0 * np.pi)
    eps = eps - omega * np.round((eps - float(ezero)) / omega)
    return np.sort(eps, axis=-1)


def _floquet_states_flux(data, band, n0, n1, U, omega, ezero, phases):
    """Total Berry flux of the selected quasienergy bands of U(T) on the
    interior (n0 - 1, n1 - 1) grid, the torus closed with the periodic
    gauge (counterpart of ``pythtb_tpu.floquet._floquet_states_jit``)."""
    theta, P = unitary_eig(U)  # U = P diag(e^{i theta}) P^H, columns
    eps = -theta * omega / (2.0 * math.pi)
    eps = eps - omega * torch.round((eps - ezero) / omega)
    order = torch.argsort(eps, dim=-1)
    w = P.transpose(-1, -2)  # rows are eigenvectors
    w = torch.take_along_dim(w, order[..., None], dim=-2)
    w = w[:, torch.as_tensor(band, dtype=torch.int64, device=w.device), :]
    w = w.reshape(n0 - 1, n1 - 1, len(band), data.nsta)
    w = extend_pbc_seq(w, phases).contiguous()
    return plaquette_phases(w).sum()


def chern(model, omega, drive, band, nk=(31, 31), nt=256, ezero=0.0, mesh=None):
    """Chern number of Floquet quasienergy bands (counterpart of
    ``pythtb_tpu.floquet.chern``): the t = 0 Floquet states of the exact
    propagator on a BZ grid, ordered by quasienergy folded around
    ``ezero``, and the plaquette Berry phases of the ``band`` selection.
    ``mesh`` must be None."""
    config.require_no_mesh(mesh)
    if model._dim_k != 2:
        raise PythtbError("floquet.chern requires dim_k == 2")
    omega = float(omega)
    data, _ = _prep(model, omega, np.zeros((1, 2)))
    band = tuple(int(b) for b in np.atleast_1d(band))
    if any(not (0 <= b < data.nsta) for b in band):
        raise PythtbError("band indices out of range")
    n0, n1 = int(nk[0]), int(nk[1])
    nt = int(nt)
    dph, ons, dt = _drive_samples(model, data, drive, omega, nt)
    kpts = device_uniform_grid((n0 - 1, n1 - 1), (-0.5, -0.5), data.device)
    U, _ = _propagation_scan(data, dph, ons, kpts, dt, collect_history=False)
    phases = [torch.as_tensor(p, dtype=config.COMPLEX).to(data.device) for p in gauge_phases(model, (0, 1))]
    flux = _floquet_states_flux(data, band, n0, n1, U, omega, float(ezero), phases)
    return float(flux) / (2.0 * np.pi)


def winding_number(model, omega, drive, egap, nk=(21, 21), nt=128):
    """Rudner winding number W(egap) of a driven 2-D lattice (counterpart
    of ``pythtb_tpu.floquet.winding_number``): the evolution history over
    one period (kernel 22's full mode), periodized through the gap at
    ``egap`` (or each of several) and the degree integral by periodic
    central differences (kernel 24).  Returns a float, or an array for an
    egap batch."""
    if model._dim_k != 2:
        raise PythtbError("winding_number requires dim_k == 2")
    omega = float(omega)
    data, _ = _prep(model, omega, np.zeros((1, 2)))
    n0, n1 = int(nk[0]) - 1, int(nk[1]) - 1
    if n0 < 2 or n1 < 2:
        raise PythtbError("nk must be at least (3, 3)")
    nt = int(nt)
    dph, ons, dt = _drive_samples(model, data, drive, omega, nt)
    kpts = device_uniform_grid((n0, n1), (0.0, 0.0), data.device)
    _, hist = _propagation_scan(data, dph, ons, kpts, dt, collect_history=True)
    theta, P = unitary_eig(hist[-1])  # P: eigenvectors as columns
    eps0 = -theta * omega / (2.0 * math.pi)
    egaps = np.atleast_1d(np.asarray(egap, dtype=np.float64))
    eg = torch.as_tensor(egaps).to(data.device)[:, None, None]
    # branch the quasienergies into (egap, egap + omega]
    eps = eps0[None] - omega * torch.floor((eps0[None] - eg) / omega) - omega
    eps = torch.where(eps <= eg, eps + omega, eps)
    p0, p1 = (torch.as_tensor(p, dtype=config.COMPLEX).to(data.device) for p in gauge_phases(model, (0, 1)))
    out = winding(hist, P, eps, p0, p1, n0, n1, 2.0 * np.pi / omega).cpu().numpy().astype(np.float64)
    return float(out[0]) if np.ndim(egap) == 0 else out


# ---------------------------------------------------------------------------
# van Vleck effective model (host-side hop-table algebra)
# ---------------------------------------------------------------------------


def _as_block(amp, nspin):
    a = np.asarray(amp, dtype=np.complex128)
    if nspin == 1:
        return complex(a)
    if a.shape == (2, 2):
        return a
    if a.ndim == 0:
        return np.eye(2, dtype=np.complex128) * complex(a)
    raise PythtbError("unexpected hopping block shape %s" % (a.shape,))


def _dagger(amp, nspin):
    return np.conj(amp) if nspin == 1 else np.conj(amp.T)


def _table_for_m(model, cm_row, cmneg_row, nspin):
    """Real-space matrix elements of H^{(m)}: dict (i, j, R) -> block.
    Direct hops carry c_m, the Hermitian partners conj(c_{-m})."""
    from .magnetic import _hop_arrays

    ii, jj, R = _hop_arrays(model)
    tab = {}
    for h, hop in enumerate(model._hoppings):
        amp = _as_block(hop[0], nspin)
        Rt = tuple(int(round(r)) for r in R[h])
        Rn = tuple(-r for r in Rt)
        key = (int(ii[h]), int(jj[h]), Rt)
        tab[key] = tab.get(key, 0.0) + amp * cm_row[h]
        keyp = (int(jj[h]), int(ii[h]), Rn)
        tab[keyp] = tab.get(keyp, 0.0) + _dagger(amp, nspin) * np.conj(
            cmneg_row[h]
        )
    return tab


def _table_product(A, B, nspin):
    """Hop-table convolution (A B)_{ij}(R) = sum_{p, R1+R2=R}
    A_{ip}(R1) B_{pj}(R2); spin blocks compose by matrix product."""
    byfirst = {}
    for (p, j, R2), b in B.items():
        byfirst.setdefault(p, []).append((j, R2, b))
    out = {}
    for (i, p, R1), a in A.items():
        for j, R2, b in byfirst.get(p, ()):
            R = tuple(r1 + r2 for r1, r2 in zip(R1, R2))
            term = a * b if nspin == 1 else a @ b
            prev = out.get((i, j, R))
            out[(i, j, R)] = term if prev is None else prev + term
    return out


def effective_model(model, omega, drive, nharm=6, nt=None, tol=1e-10):
    """Leading van Vleck high-frequency effective Hamiltonian as a new
    :class:`tb_model`:

    ``H_eff = H^{(0)} + (1/Omega) sum_{m=1}^{M} [H^{(m)}, H^{(-m)}] / m
    + O(1/Omega^2)``

    The zeroth harmonic renormalizes every hop by its ``c_0``
    (dynamical localization); the commutators generate new
    longer-range, generally complex hops -- for circularly driven
    graphene the Haldane imaginary second-neighbor terms, so
    ``flows.chern_number(effective_model(...))`` reproduces the full
    Floquet Chern number at high frequency (tested against
    :func:`chern`).  Hops with magnitude below ``tol`` (relative to
    the largest) are dropped.

    Undriven limit: returns a model with the original hop table
    (c_0 = 1, all other harmonics 0)."""
    omega = float(omega)
    if omega <= 0.0:
        raise PythtbError("drive frequency omega must be positive")
    nharm = int(nharm)
    if nt is None:
        nt = max(64, 8 * nharm + 8)
    if nt < 4 * nharm + 4:
        raise PythtbError("nt must be >= 4*nharm + 4 for unaliased harmonics")
    cm = _hop_fourier(model, drive, omega, nharm, nt)  # (2M+1, nhop)
    ons_s = _onsite_samples(model, drive, omega, int(nt), midpoint=False)
    if ons_s is None:
        om_h = np.zeros((2 * nharm + 1, model._norb), dtype=np.complex128)
    else:
        c = np.fft.fft(ons_s[:, :: model._nspin], axis=0) / int(nt)
        om_h = np.stack([c[mi % int(nt)]
                         for mi in range(-nharm, nharm + 1)], axis=0)
    nspin = model._nspin

    def row(m):
        return cm[m + nharm]

    def _acc(tab, key, val):
        prev = tab.get(key)
        tab[key] = val if prev is None else prev + val

    R0 = (0,) * model._dim_r

    def _with_onsite(tab, m):
        hrow = om_h[m + nharm]
        for i in range(model._norb):
            blk = (hrow[i] if nspin == 1
                   else hrow[i] * np.eye(2, dtype=np.complex128))
            _acc(tab, (i, i, R0), blk)
        return tab

    heff = _with_onsite(_table_for_m(model, row(0), row(0), nspin), 0)
    for m in range(1, nharm + 1):
        Am = _with_onsite(_table_for_m(model, row(m), row(-m), nspin), m)
        Amn = _with_onsite(_table_for_m(model, row(-m), row(m), nspin), -m)
        for key, val in _table_product(Am, Amn, nspin).items():
            _acc(heff, key, val / (m * omega))
        for key, val in _table_product(Amn, Am, nspin).items():
            _acc(heff, key, -val / (m * omega))

    out = tb_model(
        model._dim_k,
        model._dim_r,
        lat=np.array(model._lat),
        orb=np.array(model._orb),
        per=list(model._per),
        nspin=nspin,
    )
    if nspin == 1:
        out.set_onsite(np.array(model._site_energies, dtype=float))
    else:
        out.set_onsite([np.array(b) for b in model._site_energies])

    scale = max(
        (np.max(np.abs(np.asarray(v))) for v in heff.values()), default=0.0
    )
    cut = tol * max(scale, 1.0)
    done = set()
    for key in sorted(heff.keys()):
        if key in done:
            continue
        i, j, R = key
        pkey = (j, i, tuple(-r for r in R))
        amp = heff[key]
        partner = heff.get(pkey)
        if pkey == key:  # onsite: i == j, R == 0
            blk = _as_block(amp, nspin) if nspin == 2 else amp
            if nspin == 1:
                if abs(blk.imag) > 1e-8 * max(abs(blk), 1.0):
                    raise PythtbError("effective onsite term not real")
                out.set_onsite(blk.real, i, mode="add")
            else:
                blk = 0.5 * (blk + np.conj(blk.T))
                out.set_onsite(blk, i, mode="add")
            done.add(key)
            continue
        done.add(key)
        done.add(pkey)
        # Hermiticity: average the pair (they agree analytically)
        sym = amp if partner is None else 0.5 * (amp + _dagger(partner, nspin))
        if np.max(np.abs(np.asarray(sym))) <= cut:
            continue
        if model._dim_k != 0:
            out.set_hop(sym, i, j, ind_R=list(R), mode="add",
                        allow_conjugate_pair=True)
        else:
            out.set_hop(sym, i, j, mode="add", allow_conjugate_pair=True)
    return out
