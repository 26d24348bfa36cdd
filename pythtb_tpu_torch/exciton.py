"""Excitons from the Bethe-Salpeter equation on tight-binding models
(counterpart of ``pythtb_tpu.exciton``).

The Tamm-Dancoff BSE for electron-hole pairs with a static
density-density interaction, ``H_int = (1/2) sum V_ab(R'-R) n_{aR}
n_{bR'}``, whose periodic kernel ``W_ab(q) = sum_d V_ab(d) e^{2 pi i
q.d}`` pairs with Convention-II eigenvector components
(``u^{II}_{nk,a} = e^{2 pi i k.t_a} u^{I}_{nk,a}``), so that W(k - k')
is read from one table on the k-difference grid.  On pair states
``|t> = b+_{c,k+Q} b_{v,k} |FS>``

    ``H[t',t] = (eps^QP_c(k+Q) - eps^QP_v(k)) delta_{t't} - D + s_x X``

with the direct term D (W(k' - k)), the exchange term X (W(Q)) and the
exchange factor ``s_x`` = 1 (spinless), 0 (triplet) or 2 (singlet); the
quasiparticle energies are the bare bands (``qp='none'``) or carry the
one-shot diagonal Hartree-Fock self-energy of the filled sea
(``qp='hf'``).  The JAX package's module docstring states the physics.

The device path of :func:`bse`, on the model's device:

* the table W(q) on the grid, W(0), W(Q) and, with ``qp='hf'``, W on the
  grid + Q: kernel 1's one-sided mode
  (:func:`~pythtb_tpu_torch.ops.hamiltonian.assemble_one_sided`) on a
  :class:`~pythtb_tpu_torch.core.BlochData` of the interaction (amps V,
  rv the integer R, no orbital embedding: Convention II);
* both k-sheets: kernel 1 at k and at k + Q, then ``eigh_batched``, and
  the Convention-II rephasing;
* the Hartree shifts (an einsum) and the Fock shifts: kernel 28's Fock
  mode (:func:`~pythtb_tpu_torch.ops.bse.fock_shifts`);
* the M x M pair matrix, M = B nc nv: kernel 28's pair mode
  (:func:`~pythtb_tpu_torch.ops.bse.pair_matrix`), which never forms the
  (B, B, S, S) gather of W;
* its eigenpairs: ``eigh_batched`` (``torch.linalg.eigh`` above 64),
  states as rows;
* velocity-gauge dipoles from dH/dk (kernel 15) and one GEMM.

:func:`absorption` sums the resonant and antiresonant exciton poles with
kernel 16's Lorentzian mode (:func:`~pythtb_tpu_torch.optical.spectral_sum`)
in one call over 2M transitions.  Units and tensor conventions are those
of :func:`~pythtb_tpu_torch.optical.optical_conductivity`.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import config
from .core import bloch_data
from .model import PythtbError
from .ops.bse import fock_shifts, pair_matrix
from .ops.eigh import eigh_batched
from .ops.hamiltonian import assemble, assemble_dk, assemble_one_sided
from .ops.solver import _to_host, device_uniform_grid
from .optical import spectral_sum

__all__ = ["bse", "absorption", "dispersion", "radial_interaction", "ExcitonResult"]

_SPIN_FACTORS = {"spinless": 1.0, "triplet": 0.0, "singlet": 2.0}


# ---------------------------------------------------------------------------
# interaction specification
# ---------------------------------------------------------------------------


def radial_interaction(model, func, rcut):
    """Build a density-density coupling list from a radial potential.

    Enumerates every orbital pair ``(a, 0) -- (b, R)`` with Cartesian
    distance ``0 < dist <= rcut`` (cells ``R`` along the periodic
    directions) and assigns ``V = func(dist)``.  Each unordered
    physical pair appears exactly once: same-cell pairs with ``a < b``,
    inter-cell pairs only for ``R`` whose first nonzero component is
    positive (the mirrored ``(b, a, -R)`` view is implied --
    :func:`bse` Hermitizes).  Returns a list of ``(V, a, b, R)``
    tuples for the ``V=`` argument of :func:`bse` / :func:`absorption`.

    :param model: tb_model supplying the geometry
    :param func: callable ``V(dist)`` on Cartesian distance (model
      length units)
    :param rcut: cutoff distance (> 0)
    """
    if rcut <= 0:
        raise PythtbError("radial_interaction: rcut must be positive")
    lat = np.asarray(model._lat, dtype=np.float64)
    orb_cart = np.asarray(model._orb, dtype=np.float64) @ lat
    per = list(model._per)
    dim_k = model._dim_k
    norb = model._norb
    if dim_k > 0:
        per_lat = lat[per]
        nmax = []
        for d in range(dim_k):
            others = [per_lat[x] for x in range(dim_k) if x != d]
            v = per_lat[d]
            if others:
                A = np.array(others).T
                proj = A @ np.linalg.lstsq(A, v, rcond=None)[0]
                h = np.linalg.norm(v - proj)  # height orthogonal to rest
            else:
                h = np.linalg.norm(v)
            nmax.append(int(np.ceil(rcut / max(h, 1e-12))) + 1)
        grids = np.meshgrid(*[np.arange(-n, n + 1) for n in nmax], indexing="ij")
        cells = np.stack([g.reshape(-1) for g in grids], axis=-1)
    else:
        cells = np.zeros((1, 0), dtype=int)
    out = []
    for R in cells:
        nz = np.nonzero(R)[0]
        is_home = nz.size == 0
        if not is_home and R[nz[0]] < 0:
            continue  # the mirrored cell covers this pair
        Rcart = R.astype(np.float64) @ lat[per] if dim_k > 0 else 0.0
        for a in range(norb):
            for b in range(norb):
                if is_home and b <= a:
                    continue
                dist = float(np.linalg.norm(orb_cart[b] + Rcart - orb_cart[a]))
                if dist <= 1e-12 or dist > rcut:
                    continue
                out.append((float(func(dist)), a, b, tuple(int(x) for x in R)))
    return out


def _prep_interaction(model, V):
    """Validate + symmetrize the coupling list into flat arrays.

    Each listed term ``(V, a, b, R)`` means ``V n_{a,0} n_{b,R}`` (one
    physical term).  The symmetrized table gets both (a, b, R) and
    (b, a, -R) entries, so ``W_ba(-q) == W_ab(q)`` holds exactly.

    Returns (vals (2T,), rvecs (2T, dim_k) integer lattice displacements,
    a (2T,), b (2T,) orbital indices).
    """
    dim_k = model._dim_k
    norb = model._norb
    vals, rvecs, ia, ib = [], [], [], []
    for term in V:
        if len(term) != 4:
            raise PythtbError("interaction terms must be (V, a, b, R)")
        v, a, b, R = float(term[0]), int(term[1]), int(term[2]), term[3]
        R = np.asarray(R, dtype=int).reshape(-1)
        if R.shape[0] != dim_k:
            raise PythtbError(
                "interaction R must have one integer per periodic direction (dim_k = %d)" % dim_k)
        if not (0 <= a < norb and 0 <= b < norb):
            raise PythtbError("interaction orbital index out of range")
        if a == b and np.all(R == 0):
            raise PythtbError(
                "same-orbital same-cell density-density terms are one-body (n^2 = n); fold them into set_onsite")
        for (aa, bb, RR) in ((a, b, R), (b, a, -R)):
            vals.append(v)
            rvecs.append(RR.astype(np.float64))
            ia.append(aa)
            ib.append(bb)
    return (np.asarray(vals, dtype=np.float64), np.asarray(rvecs, dtype=np.float64).reshape(len(vals), dim_k),
            np.asarray(ia, dtype=np.int64), np.asarray(ib, dtype=np.int64))


def _interaction_data(model, vals, rvecs, ia, ib, device):
    """The interaction as a BlochData whose one-sided assembly (kernel 1's
    one-sided mode) is the table W(q)[a, b] = sum_t V_t e^{2 pi i q.R_t}
    over the terms landing on (a, b): amps V, rv R (Convention II: no
    orbital embedding)."""
    norb = model._norb
    return bloch_data(model._dim_k, norb, 1, np.zeros((norb, norb)), vals.astype(np.complex128), rvecs, ia, ib,
                      device)


# ---------------------------------------------------------------------------
# the BSE program
# ---------------------------------------------------------------------------


def _conv2_phase(kpts, torb):
    """Convention I -> II rephasing factors e^{2 pi i k.t_a}, (B, S)."""
    ang = (2.0 * math.pi) * (kpts @ torb.T)
    return torch.polar(torch.ones_like(ang), ang)


def _hf_shifts(W0, Wtab, u, occ_u, nk):
    """Diagonal one-shot HF self-energy (B, nb) of the Convention-II states
    ``u`` (B, nb, S) in the filled sea ``occ_u`` (B, no, S): the Hartree
    term as einsums, the Fock term on kernel 28's Fock mode with the table
    ``Wtab`` (W(k_n - k') read at the grid difference)."""
    N = float(u.shape[0])
    rho = torch.einsum("kvb,kvb->b", occ_u.conj(), occ_u).real / N  # (S,)
    vh = W0.real @ rho
    sig_h = torch.einsum("kna,a->kn", (u.conj() * u).real, vh)
    return sig_h + fock_shifts(Wtab, occ_u, u, nk)


def _bse_device(data, wdata, nk, vb, cb, occ, qp, sx, Q, scissor, torb, lat):
    """The device program of :func:`bse`.  Returns (omega (M,), A (M, M)
    rows are excitons, Ds (M, ncart), de (M,)) tensors."""
    dev = data.device
    dim = data.dim_k
    B = math.prod(nk)
    kpts = device_uniform_grid(nk, np.zeros(dim), dev)
    Qt = torch.as_tensor(Q, dtype=config.FLOAT).to(dev)
    kQ = (kpts + Qt[None, :]).contiguous()
    ev, vec = eigh_batched(assemble(data, kpts))
    evQ, vecQ = eigh_batched(assemble(data, kQ))
    torb_t = torch.as_tensor(torb, dtype=config.FLOAT).to(dev)
    vec2 = vec * _conv2_phase(kpts, torb_t)[:, None, :]
    vec2Q = vecQ * _conv2_phase(kQ, torb_t)[:, None, :]

    vbi = torch.as_tensor(vb, dtype=torch.int64, device=dev)
    cbi = torch.as_tensor(cb, dtype=torch.int64, device=dev)
    u_h = vec2[:, vbi, :]  # (B, nv, S) hole states at k
    u_e = vec2Q[:, cbi, :]  # (B, nc, S) electron states at k + Q
    e_h = ev[:, vbi]
    e_e = evQ[:, cbi]

    Wtab = assemble_one_sided(wdata, kpts)  # (B, S, S): W on the grid
    W0 = Wtab[0]
    WQ = assemble_one_sided(wdata, Qt[None, :].contiguous())[0]
    if qp == "hf":
        occ_u = vec2[:, torch.as_tensor(occ, dtype=torch.int64, device=dev), :]
        e_h = e_h + _hf_shifts(W0, Wtab, u_h, occ_u, nk)
        # the electron sheet sits at k + Q: W((k + Q) - k') from the table
        # on grid + Q (W is periodic)
        e_e = e_e + _hf_shifts(W0, assemble_one_sided(wdata, kQ), u_e, occ_u, nk)

    nc, nv = len(cb), len(vb)
    de = (e_e[:, :, None] - e_h[:, None, :] + float(scissor)).reshape(-1)  # (M,)
    H = pair_matrix(u_e, u_h, Wtab, WQ, de, nk, sx)
    omega, A = eigh_batched(H[None])
    omega, A = omega[0], A[0]  # rows are excitons
    M = B * nc * nv

    # velocity-gauge pair dipoles d^a_t = v^a_cv(k) / de_bare with the
    # Convention-I vectors and dH/dk (representation-independent scalars)
    latc = torch.as_tensor(lat, dtype=config.COMPLEX).to(dev)
    dHc = torch.einsum("ra,brij->baij", latc, assemble_dk(data, kpts)) / (2.0 * math.pi)
    ncart = dHc.shape[1]
    vcv = torch.einsum("bcs,bast,bvt->bacv", vecQ[:, cbi, :].conj(), dHc, vec[:, vbi, :])
    de_bare = evQ[:, cbi][:, :, None] - ev[:, vbi][:, None, :]
    tiny = 1e-9
    small = de_bare.abs() < tiny
    safe = torch.where(small, torch.ones_like(de_bare), de_bare)
    d_t = torch.where(small[:, None], torch.zeros_like(vcv), vcv / safe[:, None].to(vcv.dtype))
    d_flat = d_t.permute(1, 0, 2, 3).reshape(ncart, M)
    Ds = torch.matmul(A.conj(), d_flat.T)  # D^a_S = sum_t conj(A[S, t]) d^a_t
    return omega, A, Ds, de


class ExcitonResult:
    """Output of :func:`bse`: exciton energies, amplitudes, dipoles.

    Attributes: ``energies`` (M,) ascending; ``amplitudes`` (M, M)
    complex, row S = A_S over pairs t = (k, c, v) flattened k-major;
    ``dipoles`` (M, ncart) velocity-gauge exciton dipole vectors
    D^a_S; ``pair_energies`` (M,) the diagonal quasiparticle pair
    energies; ``nk``, ``cbands``, ``vbands``, ``Q``.
    """

    def __init__(self, energies, amplitudes, dipoles, pair_energies, nk, cbands, vbands, Q):
        self.energies = energies
        self.amplitudes = amplitudes
        self.dipoles = dipoles
        self.pair_energies = pair_energies
        self.nk = nk
        self.cbands = cbands
        self.vbands = vbands
        self.Q = Q

    def oscillator_strengths(self, direction=0):
        """``Omega_S |D^a_S|^2`` along a Cartesian direction -- the
        velocity-gauge dipole weights that enter :func:`absorption`."""
        return self.energies * np.abs(self.dipoles[:, direction]) ** 2

    def wavefunction(self, S):
        """Pair-space weight of exciton ``S``: ``|A_S(k; c, v)|^2``
        reshaped to (*nk, nc, nv), plus the normalized real-space
        electron-hole envelope |psi(R)|^2 over separation cells
        (band-summed k -> R Fourier transform).

        Returns ``(weight_k, weight_R)``.
        """
        nc, nv = len(self.cbands), len(self.vbands)
        A = self.amplitudes[S].reshape(*self.nk, nc, nv)
        wk = np.abs(A) ** 2
        ax = tuple(range(len(self.nk)))
        psiR = np.fft.ifftn(A, axes=ax)
        wR = np.sum(np.abs(psiR) ** 2, axis=(-2, -1))
        return wk, wR / max(float(np.sum(wR)), 1e-300)


def _prep_bse(model, V, occ, vbands, cbands, nk, spin, qp):
    if model._nspin != 1:
        raise PythtbError(
            "bse: explicit-spin (nspin=2) models are not supported; model the spin channels via "
            "spin='singlet'/'triplet' on a spin-degenerate nspin=1 model")
    if model._dim_k < 1:
        raise PythtbError("bse needs at least one periodic direction")
    if spin not in _SPIN_FACTORS:
        raise PythtbError("spin must be one of %s" % sorted(_SPIN_FACTORS))
    if qp not in ("none", "hf"):
        raise PythtbError("qp must be 'none' or 'hf'")
    nk = tuple(int(x) for x in np.atleast_1d(nk))
    if len(nk) != model._dim_k or any(n < 1 for n in nk):
        raise PythtbError("nk must give one grid size per k-direction")
    nsta = model._norb
    occ_t = tuple(int(x) for x in np.atleast_1d(occ))
    if len(set(occ_t)) != len(occ_t) or any(not (0 <= o < nsta) for o in occ_t):
        raise PythtbError("occ must be distinct band indices")
    vb = occ_t if vbands is None else tuple(int(x) for x in np.atleast_1d(vbands))
    cb = tuple(sorted(set(range(nsta)) - set(occ_t))) if cbands is None else tuple(
        int(x) for x in np.atleast_1d(cbands))
    if not vb or not cb:
        raise PythtbError("need at least one valence and one conduction band")
    if not set(vb) <= set(occ_t):
        raise PythtbError("vbands must be occupied (subset of occ)")
    if set(cb) & set(occ_t):
        raise PythtbError("cbands must be empty (disjoint from occ)")
    inter = _prep_interaction(model, V if V is not None else [])
    return nk, occ_t, vb, cb, inter


def bse(model, V, occ, nk, vbands=None, cbands=None, Q=None, spin="spinless", qp="hf", scissor=0.0):
    """Solve the Tamm-Dancoff BSE on a uniform k-grid.

    :param model: spinless periodic model (nspin == 1)
    :param V: density-density coupling list ``[(V, a, b, R), ...]``
      (``V n_{a,0} n_{b,R}``; each unordered physical pair ONCE --
      Hermitization is automatic), e.g. from
      :func:`radial_interaction`; ``None`` / ``[]`` gives the
      independent-particle limit
    :param occ: occupied (ground-state) band indices
    :param nk: k-grid, one size per periodic direction (at most three)
    :param vbands: hole bands (default: all of ``occ``)
    :param cbands: electron bands (default: all unoccupied)
    :param Q: exciton center-of-mass momentum, reduced coordinates
      (default zero -- the optical sector)
    :param spin: 'spinless' (exchange factor 1), 'triplet' (0) or
      'singlet' (2) for spin-degenerate models
    :param qp: 'hf' (default) adds the one-shot diagonal Hartree-Fock
      self-energy of the occupied sea to the band energies; 'none' uses
      bare bands
    :param scissor: rigid gap correction added to every pair energy
    :returns: :class:`ExcitonResult` (NumPy arrays)

    Example::

        V = exciton.radial_interaction(bn, lambda r: 2.0 / (r + 0.5), 3.0)
        res = exciton.bse(bn, V, occ=[0], nk=(24, 24))
        binding = min_gap - res.energies[0]
    """
    (omega, A, Ds, de), nk, cb, vb, Qv = _solve(model, V, occ, nk, vbands, cbands, Q, spin, qp, scissor)
    return ExcitonResult(_to_host(omega), _to_host(A), _to_host(Ds), _to_host(de), nk, cb, vb, Qv)


def _solve(model, V, occ, nk, vbands=None, cbands=None, Q=None, spin="spinless", qp="hf", scissor=0.0):
    """:func:`bse`'s checks and device program: ((omega, A, Ds, de) on the
    device, nk, cbands, vbands, Q)."""
    nk, occ_t, vb, cb, inter = _prep_bse(model, V, occ, vbands, cbands, nk, spin, qp)
    data = model._get_finalized()
    dim = model._dim_k
    Qv = np.zeros((dim,)) if Q is None else np.asarray(Q, dtype=np.float64).reshape(-1)
    if Qv.shape[0] != dim:
        raise PythtbError("Q must have one component per k-direction")
    lat = np.asarray(model._lat, dtype=np.float64)
    per = list(model._per)
    torb = np.asarray(model._orb, dtype=np.float64)[:, per]
    wdata = _interaction_data(model, *inter, data.device)
    out = _bse_device(data, wdata, nk, vb, cb, occ_t, qp, _SPIN_FACTORS[spin], Qv, scissor, torb, lat[per])
    return out, nk, cb, vb, Qv


def dispersion(model, V, occ, nk, Q_list, **kwargs):
    """Exciton band structure: :func:`bse` eigenvalues along a list of
    center-of-mass momenta ``Q_list`` (reduced coordinates).  Returns
    (nQ, M) energies."""
    Qs = np.asarray(Q_list, dtype=np.float64)
    if Qs.ndim != 2:
        raise PythtbError("Q_list must be a 2-D array of momenta")
    return np.stack([bse(model, V, occ, nk, Q=q, **kwargs).energies for q in Qs])


def _pole_weights(omega, Ds):
    """Kernel 16's inputs for the exciton poles: W (ncart^2, 2M) and de
    (2M,).  Row (a, b) holds conj(D_{S,b}) Omega_S D_{S,a} at de = +Omega_S
    (resonant) and conj(D_{S,a}) Omega_S D_{S,b} at de = -Omega_S
    (antiresonant: 1 / (w + Omega + i eta))."""
    ncart = Ds.shape[1]
    WD = Ds * omega[:, None].to(Ds.dtype)  # Omega_S D_S
    res = torch.einsum("sb,sa->abs", Ds.conj(), WD)
    ares = torch.einsum("sa,sb->abs", Ds.conj(), WD)
    W = torch.cat([res, ares], dim=-1).reshape(ncart * ncart, -1).contiguous()
    return W, torch.cat([omega, -omega]).contiguous()


def absorption(model, V, omegas, occ, nk, eta=0.05, **kwargs):
    """Optical conductivity with excitonic effects.

    Diagonalizes the Q = 0 BSE and evaluates the velocity-gauge Kubo
    conductivity from the exciton poles (resonant + antiresonant), one
    launch of kernel 16's Lorentzian mode over the 2M poles.  Units and
    tensor conventions match :func:`optical.optical_conductivity` exactly
    -- with ``V=None`` and ``qp='none'`` the two agree to machine
    precision.

    :returns: complex (dim, dim, nw) tensor, e^2/h units (2-D),
      e^2/(h length) in 3-D
    """
    if model._dim_k != model._dim_r or model._dim_k not in (2, 3):
        raise PythtbError("absorption requires a fully periodic 2-D or 3-D model")
    if "Q" in kwargs:
        raise PythtbError("absorption is the Q = 0 optical sector")
    (omega, _, Ds, _), nk, _, _, _ = _solve(model, V, occ, nk, **kwargs)
    dev = model._get_finalized().device
    N = float(np.prod(nk))
    vol = abs(np.linalg.det(np.asarray(model._lat, dtype=np.float64)))
    om = torch.as_tensor(np.asarray(omegas, dtype=np.float64).reshape(-1)).to(dev)
    W, de = _pole_weights(omega, Ds)
    ncart = Ds.shape[1]
    sig = 1j * _to_host(spectral_sum(W, de, om, float(eta), "lorentz")).reshape(ncart, ncart, -1)
    # package orientation: mirror the Kubo tensor (optical.py)
    return np.swapaxes(sig, 0, 1) * (2.0 * np.pi) / (N * vol)
