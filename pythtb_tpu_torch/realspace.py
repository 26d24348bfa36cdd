"""Real-space transport and spectra for large (disordered) samples: the
kernel-polynomial part of ``pythtb_tpu.realspace``.

* :func:`torus_sample` -- tile a fully periodic model onto an
  ``L1 x ... x Ld`` torus as a matrix-free ELL hop table
  (:class:`pythtb_tpu_torch.ops.matvec.SparseH`), with exact per-hop
  displacement vectors ``(orb_j + R - orb_i) . lat``, so the velocity
  operators ``v_a = -i [X_a, H]`` are exact on the torus.  Optional
  Anderson on-site disorder.
* :func:`kpm_conductivity` -- Kubo-Bastin conductivity by the kernel
  polynomial method (Garcia, Covaci, Rappoport, PRL 114, 116602 (2015)):
  stochastic moments ``mu_nm = Tr[T_n(Ht) v_a T_m(Ht) v_b]``.  The two
  Chebyshev blocks of all random vectors are built in place by kernel 9
  (recursion-only mode), the velocity applications are kernel 8, and the
  moment matrix is one complex matrix product.
* :func:`kpm_ldos` -- deterministic site-resolved LDOS by kernel 9
  (moments mode) on a block of unit vectors.

* :func:`chern_marker`, :func:`sector_marker`, :func:`spin_chern_marker`
  -- Bianco-Resta local Chern markers (and their Prodan sector split) of
  finite 2-D models: H by kernel 1, one dense ``torch.linalg.eigh``, the
  occupied-basis position matrices X, Y and XY by three launches of
  kernel 6, the rest ``torch.matmul``.
* :func:`bott_index` -- the Loring-Hastings Bott index of a torus
  sample: the dense H is one kernel-8 launch on the identity block, the
  eigensolve ``torch.linalg.eigh`` on the device, the projections host
  float64.

Conventions: ``hbar = e = 1``; 2-D conductivities in units of e^2/h.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from . import config
from .model import PythtbError
from .ops import chebyshev
from .ops.matvec import SparseH, _ell_tables, _upload, apply_rows

__all__ = [
    "TorusSample", "torus_sample", "kpm_conductivity", "kpm_ldos", "chern_marker", "bott_index",
    "sector_marker", "spin_chern_marker",
]

# Bytes of the three Kubo blocks (two Chebyshev blocks and the velocity
# block) that one batch of random vectors may take on the device; the
# vectors run in batches below it, as the JAX program runs them one by one.
KUBO_BLOCK_BYTES = 2**32


@dataclasses.dataclass(frozen=True)
class TorusSample:
    """A periodic model tiled onto a finite torus (host container).

    ``h`` is the matrix-free Hamiltonian; ``velocity[a]`` the Cartesian
    velocity operator ``-i [X_a, H]`` built from exact per-hop
    displacements (correct across the periodic wrap); ``theta`` the
    reduced orbital positions in supercell units (in [0, 1)); ``pos``
    Cartesian orbital positions; ``volume`` the torus area/volume
    (|det lat| * ncells).
    """

    h: SparseH
    velocity: tuple
    theta: np.ndarray
    pos: np.ndarray
    volume: float
    supercell: tuple

    @property
    def norb(self):
        return self.h.norb

    @property
    def nspin(self):
        return self.h.nspin

    @property
    def nsta(self):
        return self.h.nsta


def _window_from_tables(tcols, tvals, norb, nspin):
    """Gershgorin spectral bounds from ELL tables (host)."""
    diag_idx = np.arange(norb, dtype=tcols.dtype)
    isdiag = tcols == diag_idx[:, None]
    if nspin == 1:
        center = np.real(np.sum(np.where(isdiag, tvals, 0.0), axis=1))
        radius = np.sum(np.where(~isdiag, np.abs(tvals), 0.0), axis=1)
    else:
        dblk = np.sum(np.where(isdiag[..., None, None], tvals, 0.0), axis=1)
        ev = np.linalg.eigvalsh(dblk)
        center = ev.mean(axis=-1)
        radius = (ev[:, 1] - ev[:, 0]) / 2.0
        bnorm = np.linalg.norm(tvals, ord=2, axis=(-2, -1))
        radius = radius + np.sum(np.where(~isdiag, bnorm, 0.0), axis=1)
    return (float((center - radius).min()), float((center + radius).max()))


def _sparse_from_coo(rows, cols, vals, norb, nspin):
    tcols, tvals = _ell_tables(rows, cols, vals, norb)
    return _upload(tcols, tvals, norb, nspin, _window_from_tables(tcols, tvals, norb, nspin))


def torus_sample(model, supercell, onsite_disorder=0.0, seed=0):
    """Tile a fully periodic model onto a finite torus.

    Each hop ``(amp, i, j, R)`` of the periodic model maps, for every
    cell ``c`` of the ``L1 x ... x Ld`` torus, to a matrix element
    between site ``(c, i)`` and site ``((c + R) mod L, j)`` carrying the
    exact Cartesian displacement ``d = (orb_j + R - orb_i) . lat`` -- the
    wrap changes the site index, never the displacement.

    :param model: a ``tb_model`` with ``dim_k == dim_r`` (fully periodic)
    :param supercell: ints ``(L1, ..., Ld)``, cells per direction
    :param onsite_disorder: Anderson disorder: a float ``W`` draws
      uniform on-site energies in ``[-W/2, W/2]`` per site (added to both
      spin components when nspin=2) with ``np.random.default_rng(seed)``,
      or an explicit per-site array of length ``norb * ncells``
    :param seed: RNG seed for the disorder draw
    :returns: :class:`TorusSample`
    """
    if model._dim_k != model._dim_r or model._dim_k < 1:
        raise PythtbError("torus_sample requires a fully periodic model (dim_k == dim_r >= 1)")
    dim = model._dim_r
    L = tuple(int(x) for x in np.atleast_1d(supercell))
    if len(L) != dim or any(x < 1 for x in L):
        raise PythtbError(
            "supercell must give a positive cell count per periodic "
            "direction (got %r for dim %d)" % (supercell, dim)
        )
    norb = model._norb
    nspin = model._nspin
    lat = np.asarray(model._lat, dtype=np.float64)
    orb = np.asarray(model._orb, dtype=np.float64)
    ncells = int(np.prod(L))
    nsites = norb * ncells

    # cell grid, cell-major site index: site = cell_idx * norb + orbital
    cells = np.indices(L).reshape(dim, ncells).T  # (ncells, dim)
    cell_idx = np.arange(ncells)

    nhop = len(model._hoppings)
    if nhop:
        amps = np.array([np.asarray(h[0], dtype=np.complex128) for h in model._hoppings])
        ii = np.array([h[1] for h in model._hoppings], dtype=np.int64)
        jj = np.array([h[2] for h in model._hoppings], dtype=np.int64)
        RR = np.array([h[3] for h in model._hoppings], dtype=np.int64).reshape(nhop, dim)
        # target cell of each (hop, cell) pair, with periodic wrap
        tcell = np.mod(cells[None, :, :] + RR[:, None, :], np.array(L))
        tidx = np.ravel_multi_index(tuple(tcell[..., d] for d in range(dim)), L)  # (nhop, ncells)
        rows_f = (cell_idx[None, :] * norb + ii[:, None]).ravel()
        cols_f = (tidx * norb + jj[:, None]).ravel()
        amps_f = np.repeat(amps, ncells, axis=0)
        disp = (orb[jj] + RR - orb[ii]) @ lat  # exact Cartesian displacement per hop
        disp_f = np.repeat(disp, ncells, axis=0)
    else:
        rows_f = np.zeros(0, dtype=np.int64)
        cols_f = np.zeros(0, dtype=np.int64)
        amps_f = np.zeros((0,) if nspin == 1 else (0, 2, 2), np.complex128)
        disp_f = np.zeros((0, dim))

    # on-site energies tiled over cells + Anderson disorder
    ons = np.asarray(model._site_energies, dtype=np.complex128)
    ons_f = np.tile(ons, (ncells,) + (1,) * (ons.ndim - 1))
    if np.ndim(onsite_disorder) == 0:
        W = float(onsite_disorder)
        delta = np.random.default_rng(seed).uniform(-W / 2, W / 2, nsites) if W != 0.0 else None
    else:
        delta = np.asarray(onsite_disorder, dtype=np.float64)
        if delta.shape != (nsites,):
            raise PythtbError(
                "per-site disorder array must have length norb * ncells "
                "= %d (got shape %r)" % (nsites, delta.shape)
            )
    if delta is not None:
        ons_f = ons_f + (delta if nspin == 1 else delta[:, None, None] * np.eye(2))

    diag_idx = np.arange(nsites, dtype=np.int64)
    conj_amps = np.conj(np.swapaxes(amps_f, -1, -2)) if nspin == 2 else np.conj(amps_f)
    rows = np.concatenate([rows_f, cols_f, diag_idx])
    cols = np.concatenate([cols_f, rows_f, diag_idx])
    hvals = np.concatenate([amps_f, conj_amps, ons_f], axis=0)
    h = _sparse_from_coo(rows, cols, hvals, nsites, nspin)

    # velocity operators v_a = -i [X_a, H]: matrix element -i d_a H_ij
    # (Hermitian partner is the elementwise conjugate; the diagonal drops)
    vel = []
    rows_v = np.concatenate([rows_f, cols_f])
    cols_v = np.concatenate([cols_f, rows_f])
    for a in range(dim):
        d = disp_f[:, a] if nspin == 1 else disp_f[:, a, None, None]
        fwd = -1j * d * amps_f
        vvals = np.concatenate([fwd, np.conj(fwd)], axis=0)
        vel.append(_sparse_from_coo(rows_v, cols_v, vvals, nsites, nspin))

    theta = ((cells[:, None, :] + orb[None, :, :]) / np.array(L)).reshape(nsites, dim) % 1.0
    pos = ((cells[:, None, :] + orb[None, :, :]) @ lat).reshape(nsites, dim)
    volume = float(abs(np.linalg.det(lat))) * ncells
    return TorusSample(h=h, velocity=tuple(vel), theta=theta, pos=pos, volume=volume, supercell=L)


# --------------------------------------------------------------------
# KPM Kubo-Bastin conductivity
# --------------------------------------------------------------------


def _kubo_moments(h, va, vb, ab, M, x0):
    """Stochastic Kubo-Bastin moment matrix ``C[n, m] = E<x| T_n(Ht) v_a
    T_m(Ht) v_b |x>`` (M, M) complex, averaged over the random-phase
    columns of ``x0`` (nsta, R) (counterpart of ``_kubo_moments_jit``,
    which draws one vector per key).

    Per batch of Rb vectors: the right block Phi (M, nsta, Rb), Phi[m] =
    T_m(Ht) v_b x, and the left block P (nsta, M, Rb), P[:, n] = T_n(Ht) x,
    are each one kernel-9 recursion; W = v_a P is one kernel-8 launch with
    M * Rb columns; C accumulates conj(W)^T Phi^T as one matrix product
    over (site, vector) pairs."""
    N, R = x0.shape
    M = int(M)
    Rb = max(1, min(R, KUBO_BLOCK_BYTES // (3 * M * N * 16)))
    C = torch.zeros((M, M), dtype=config.COMPLEX, device=h.device)
    for r0 in range(0, R, Rb):
        x = x0[:, r0:r0 + Rb].contiguous()
        nb = x.shape[1]
        phi = torch.empty((M, N, nb), dtype=config.COMPLEX, device=h.device)
        apply_rows(vb, x, phi[0])
        chebyshev.recursion(h, ab, phi)
        left = torch.empty((N, M, nb), dtype=config.COMPLEX, device=h.device)
        left[:, 0] = x
        chebyshev.recursion(h, ab, left.permute(1, 0, 2))
        w = torch.empty_like(left)
        apply_rows(va, left.view(N, M * nb), w.view(N, M * nb))
        # C[n, m] += sum_{i, r} conj(W[i, n, r]) Phi[m, i, r]
        wt = w.permute(1, 0, 2).reshape(M, N * nb)
        C += wt.conj() @ phi.reshape(M, N * nb).transpose(0, 1)
    return C / R


def _fermi(e, mu, kt):
    if kt <= 0.0:
        return (e <= mu).astype(np.float64)
    x = np.clip((e - mu) / kt, -700, 700)
    return 1.0 / (np.exp(x) + 1.0)


def kpm_conductivity(sample, dirs=(0, 1), fermi_levels=None, num_moments=256, num_vectors=8,
                     temperature=0.0, seed=0, n_energies=2048):
    """Kubo-Bastin conductivity ``sigma_{ab}(mu)`` by KPM (Garcia, Covaci &
    Rappoport, PRL 114, 116602 (2015)): with ``Ht = (H - b)/a`` and the
    Jackson-damped moment matrix ``mu_nm = g_n g_m / ((1+d_n0)(1+d_m0))
    Tr[v_a T_n(Ht) v_b T_m(Ht)]``,

    ``sigma_ab(mu, T) = (8 / (Omega a^2)) int de f(e; mu, T)
    Re[Gamma(e)] / (1 - e^2)^2``   [units of e^2/h]

    where ``Gamma(e) = sum_nm Gamma_nm(e) mu_nm`` with ``Gamma_nm(e) =
    (e - i n sqrt(1-e^2)) e^{i n acos e} T_m(e) + (e + i m sqrt(1-e^2))
    e^{-i m acos e} T_n(e)``.  The moment matrix is computed on the
    device (:func:`_kubo_moments`); the energy post-processing runs on
    the host in float64.

    :param sample: :class:`TorusSample`
    :param dirs: Cartesian direction pair (a, b): (0, 0) for sigma_xx,
      (0, 1) for sigma_xy
    :param fermi_levels: chemical potentials (default: 201 points across
      the spectral window)
    :param num_moments: Chebyshev order M
    :param num_vectors: random-phase vectors for the stochastic trace,
      drawn by :func:`pythtb_tpu_torch.ops.chebyshev.phase_vectors`
    :param temperature: k_B T in model energy units (0 = ground state)
    :param n_energies: internal energy-integration grid size
    :returns: ``(fermi_levels, sigma)``, sigma in units of e^2/h for 2-D
      samples (e^2/(h * length) in 3-D, length in lattice units)
    """
    from .flows import _jackson

    h = sample.h
    lo, hi = h.window
    a = 0.5 * (hi - lo) / 0.98 + 1e-12
    b = 0.5 * (hi + lo)
    M = int(num_moments)
    va = sample.velocity[int(dirs[0])]
    vb = sample.velocity[int(dirs[1])]
    ab = torch.tensor([a, b], dtype=config.FLOAT, device=h.device)
    x0 = chebyshev.phase_vectors(h.nsta, num_vectors, seed, h.device)
    # C[n, m] = Tr[T_n v_a T_m v_b]: the mu_nm of the Gamma_nm
    # post-processing below (transposing it flips the Hall sign)
    mu = _kubo_moments(h, va, vb, ab, M, x0).cpu().numpy()
    if dirs[0] == dirs[1]:
        # exact symmetry mu_nm = conj(mu_mn) for a == b halves the noise
        mu = 0.5 * (mu + np.conj(mu.T))

    g = _jackson(M)
    w = np.ones(M)
    w[0] = 0.5
    mu = mu * np.outer(g * w, g * w)

    # host energy grid, open interval (the spectrum lives inside +-0.98)
    ne = int(n_energies)
    et = np.linspace(-0.99, 0.99, ne)
    acos = np.arccos(et)
    s = np.sqrt(1.0 - et * et)
    narr = np.arange(M)
    E = np.exp(1j * np.outer(acos, narr))  # (nE, M)
    A = (et[:, None] - 1j * np.outer(s, narr)) * E
    T = np.cos(np.outer(acos, narr))
    gam = np.sum(T * (A @ mu.T), axis=1) + np.sum(T * (np.conj(A) @ mu), axis=1)
    integrand = np.real(gam) / (1.0 - et * et) ** 2
    pref = 8.0 / (sample.volume * a * a)

    if fermi_levels is None:
        fermi_levels = np.linspace(lo, hi, 201)
    fermi_levels = np.asarray(fermi_levels, dtype=np.float64)
    mut = (fermi_levels - b) / a

    de = et[1] - et[0]
    if temperature <= 0.0:
        cum = np.concatenate([[0.0], np.cumsum(0.5 * (integrand[1:] + integrand[:-1]) * de)])
        sig = pref * np.interp(mut, et, cum)
    else:
        kt = float(temperature) / a  # rescaled temperature
        f = _fermi(et[None, :], mut[:, None], kt)  # (nmu, nE)
        wtrap = np.full(ne, de)
        wtrap[0] = wtrap[-1] = de / 2
        sig = pref * (f * (integrand * wtrap)[None, :]).sum(axis=1)
    return fermi_levels, sig


# --------------------------------------------------------------------
# local density of states by KPM (deterministic, per state)
# --------------------------------------------------------------------


def _ldos_moments(h, ab, states, M):
    """Deterministic Chebyshev LDOS moments ``mu_m(i) = <e_i| T_m(Ht)
    |e_i>`` for unit vectors at the flat state indices ``states`` (a
    host int array): kernel 9 on the one-hot block, mu_0 = 1.
    Returns (M, B) float64."""
    B = len(states)
    x0 = torch.zeros((h.nsta, B), dtype=config.COMPLEX, device=h.device)
    x0[torch.as_tensor(states, dtype=torch.int64).to(h.device), torch.arange(B, device=h.device)] = 1.0
    return chebyshev.moments(h, ab, x0, M, 1.0)


def kpm_ldos(sample, sites, energies=None, num_moments=512, n_energies=401):
    """Site-resolved local density of states by the kernel polynomial
    method -- deterministic (unit-vector moments, no stochastic trace),
    one kernel-9 call for the whole site block.

    ``rho_i(E) = sum_n |<i|psi_n>|^2 delta(E - E_n)``, Jackson-smeared to
    resolution ~ bandwidth * pi / num_moments.  For a spinful sample each
    site's two spin states are expanded and summed, so ``sum(rho_i) dE =
    nspin`` per site.

    :param sample: :class:`TorusSample` or a finite (dim_k == 0)
      :class:`pythtb_tpu_torch.tb_model`
    :param sites: orbital indices to resolve (iterable of int)
    :param energies: energy grid (default: Gershgorin window,
      ``n_energies`` points)
    :param num_moments: Chebyshev order
    :returns: ``(energies, ldos)`` with ``ldos`` shaped (nsites, nE)
    """
    from .flows import _chebyshev_density
    from .ops.matvec import gershgorin_window, sparse_h

    h = sample.h if isinstance(sample, TorusSample) else sparse_h(sample)
    sites = np.asarray(sites, dtype=np.int64).reshape(-1)
    if sites.size == 0:
        raise PythtbError("kpm_ldos needs at least one site")
    if sites.min() < 0 or sites.max() >= h.norb:
        raise PythtbError("site indices out of range for %d orbitals" % h.norb)
    # states are spin-fastest: orbital i -> (2i, 2i+1)
    states = np.stack([2 * sites, 2 * sites + 1], axis=1).reshape(-1) if h.nspin == 2 else sites
    lo, hi = gershgorin_window(h)
    a = 0.5 * (hi - lo) / 0.98 + 1e-12
    b = 0.5 * (hi + lo)
    M = int(num_moments)
    ab = torch.tensor([a, b], dtype=config.FLOAT, device=h.device)
    mu = _ldos_moments(h, ab, states, M).cpu().numpy()  # (M, nstates)
    if h.nspin == 2:
        mu = mu.reshape(M, -1, 2).sum(axis=2)
    return _chebyshev_density(mu, a, b, lo, hi, energies, n_energies)


# --------------------------------------------------------------------
# local Chern marker (Bianco-Resta)
# --------------------------------------------------------------------


def _marker_core(W, X, Y):
    """Occupied-basis Bianco-Resta contraction (W (nocc, S) rows = states,
    X, Y (S,) float64 positions): ``Im diag_s`` of ``psi^H X Q Y psi``,
    ``K = <n|XY|m> - <n|X|p><p|Y|m>``.  A, B and XY are three launches of
    kernel 6 on the card; K and the per-site quadratic form are matmuls."""
    from .ops.position import xmat

    w = W.contiguous()[None]
    A = xmat(w, X)[0]
    B = xmat(w, Y)[0]
    Cm = xmat(w, X * Y)[0]
    K = Cm - A @ B
    # diag_s = sum_nm W[n, s] K[n, m] conj(W[m, s])
    return torch.sum(W * (K @ W.conj()), dim=0).imag


def _check_eigensolver(eigensolver, caller):
    """Validate the marker ``eigensolver`` knob.  All three values take the
    device eigensolve: the JAX package's "host" path exists for its float32
    devices, and the port is float64 on every device."""
    if eigensolver not in ("auto", "host", "device"):
        raise PythtbError('%s: eigensolver must be "auto", "host" or "device"' % caller)


def _device_states(model, nocc):
    """H by kernel 1 (dim_k 0), one dense eigensolve on the device; the
    nocc lowest states as rows (nocc, S)."""
    from .ops.eigh import eigh_batched
    from .ops.hamiltonian import assemble

    data = model._get_finalized()
    H = assemble(data, torch.zeros((1, 0), dtype=config.FLOAT, device=data.device))
    evals, vecs = eigh_batched(H)
    return evals[0], vecs[0, :nocc]


def _positions(model, dev):
    """Cartesian x and y of every state (spin-repeated) as device tensors,
    and the cell area."""
    lat = np.asarray(model._lat, dtype=np.float64)
    pos = np.asarray(model._orb, dtype=np.float64) @ lat
    if model._nspin == 2:
        pos = np.repeat(pos, 2, axis=0)
    X = torch.as_tensor(np.ascontiguousarray(pos[:, 0])).to(dev)
    Y = torch.as_tensor(np.ascontiguousarray(pos[:, 1])).to(dev)
    return X, Y, abs(np.linalg.det(lat))


def chern_marker(model, nocc=None, fermi=None, eigensolver="auto"):
    """Bianco-Resta local Chern marker of a finite 2-D flake.

    ``c(r) = -(4 pi / A_c) Im <r| P X Q Y P |r>`` summed over the orbitals
    (and spins) at site r (Bianco & Resta, PRB 84, 241106 (2011)).  In the
    bulk of a topological flake the marker plateaus at the Chern number;
    its sum over the whole sample is exactly zero.

    :param model: finite model (``dim_k == 0``) with 2-D positions
      (``dim_r == 2``)
    :param nocc: number of occupied states, or
    :param fermi: Fermi energy used to count nocc (an extra eigensolve)
    :param eigensolver: ``"auto"``, ``"device"`` or ``"host"``, all the
      device path (H by kernel 1, float64 eigh on the device); kept for
      the JAX package's signature
    :returns: ``(norb,)`` marker per orbital site
    """
    if model._dim_k != 0:
        raise PythtbError("chern_marker requires a finite model (dim_k == 0)")
    if model._dim_r != 2:
        raise PythtbError("chern_marker requires 2-D positions (dim_r == 2)")
    if (nocc is None) == (fermi is None):
        raise PythtbError("give exactly one of nocc / fermi")
    if fermi is None:
        nocc = int(nocc)
        if not (0 < nocc < model._norb * model._nspin):
            raise PythtbError("nocc must be in 1..nsta-1")
    else:
        evals = model.solve_all()
        nocc = int(np.count_nonzero(evals < fermi))
        if nocc == 0 or nocc == evals.size:
            raise PythtbError("fermi = %g leaves no occupied/empty states" % fermi)
    _check_eigensolver(eigensolver, "chern_marker")
    dev = config.checked_device()
    X, Y, cell_area = _positions(model, dev)
    W = _device_states(model, nocc)[1]
    imdiag = _marker_core(W, X, Y).cpu().numpy().astype(np.float64)
    c = -4.0 * np.pi / cell_area * imdiag
    if model._nspin == 2:
        c = c.reshape(-1, 2).sum(axis=1)
    return c


# --------------------------------------------------------------------
# Bott index
# --------------------------------------------------------------------


def _dense_from_ell(h):
    """The dense (nsta, nsta) H of an ELL sample: one kernel-8 launch on
    the identity block.  Exact: column b of the product sums the slots of
    each row that land on b, and padding slots add 0."""
    eye = torch.eye(h.nsta, dtype=config.COMPLEX, device=h.device)
    return apply_rows(h, eye, torch.empty_like(eye))


def bott_index(sample, nocc=None, fermi=None, eigensolver="auto"):
    """Loring-Hastings Bott index of a 2-D torus sample.

    With ``U = exp(2 pi i Theta_x)``, ``V = exp(2 pi i Theta_y)`` (Theta
    the reduced positions on the torus) projected into the occupied
    subspace, ``Bott = (1/2 pi) Im tr log(Vp Up Vp^H Up^H)`` (Loring &
    Hastings, EPL 92, 67004 (2010)).  The dense H is one kernel-8 launch
    and its eigensolve runs on the device; the occupied projections and
    the final non-Hermitian eigenvalue sum run on the host in float64
    (they are (nocc, nocc) sized).

    :param sample: 2-D :class:`TorusSample`
    :param nocc: occupied state count, or
    :param fermi: Fermi energy used to count occupied states
    :param eigensolver: "auto", "device" or "host", all the device eigh
      (as :func:`chern_marker`)
    :returns: the Bott index (float; near-integer when gapped)
    """
    if sample.theta.shape[1] != 2:
        raise PythtbError("bott_index requires a 2-D torus sample")
    _check_eigensolver(eigensolver, "bott_index")
    h = sample.h
    w, V = torch.linalg.eigh(_dense_from_ell(h))
    evals = w.cpu().numpy().astype(np.float64)
    W = V.T.cpu().numpy()  # rows are states
    if (nocc is None) == (fermi is None):
        raise PythtbError("give exactly one of nocc / fermi")
    if nocc is None:
        nocc = int(np.count_nonzero(evals < fermi))
    nocc = int(nocc)
    if not (0 < nocc < h.nsta):
        raise PythtbError("nocc must leave both occupied and empty states")
    theta = sample.theta
    if h.nspin == 2:
        theta = np.repeat(theta, 2, axis=0)
    Wocc = W[:nocc]
    px = np.exp(2j * np.pi * theta[:, 0])
    py = np.exp(2j * np.pi * theta[:, 1])
    U = (np.conj(Wocc) * px) @ Wocc.T
    V = (np.conj(Wocc) * py) @ Wocc.T
    Mb = V @ U @ np.conj(V.T) @ np.conj(U.T)
    lam = np.linalg.eigvals(Mb)
    return float(np.sum(np.angle(lam)) / (2.0 * np.pi))


# --------------------------------------------------------------------
# sector (spin) Chern markers -- real-space QSH diagnostics
# --------------------------------------------------------------------


def sector_marker(model, op, nocc=None, fermi=None, split=None, eigensolver="auto"):
    """Per-site local Chern markers of the Prodan eigensectors of a grading
    operator ``op`` projected into the occupied space of a FINITE 2-D
    model.

    Splits the occupied space by the spectrum of ``P O P`` (``split``
    lowest eigenstates -> the minus sector, the rest -> plus) and computes
    the Bianco-Resta marker of each sector projector (``Q_s = 1 - P_s``:
    the complement holds the empty space and the other sector).

    :param model: finite model (``dim_k == 0``, ``dim_r == 2``)
    :param op: (nsta, nsta) Hermitian grading, or a length-nsta diagonal,
      in the flattened (orb x spin, spin fastest) space
    :param nocc: occupied state count, or
    :param fermi: Fermi energy used to count occupied states
    :param split: minus-sector size (default ``nocc // 2``); a warning
      reports when the projected spectrum does not straddle zero there
    :param eigensolver: "auto", "device" or "host", all the device path
      (as :func:`chern_marker`)
    :returns: dict with ``c_minus`` / ``c_plus`` ((norb,) per-site
      markers, spin-summed), ``sector_marker`` (their half-difference),
      ``total_marker`` (their sum), ``gap`` (P O P spectral gap at the
      split)
    """
    if model._dim_k != 0:
        raise PythtbError("sector_marker requires a finite model (dim_k == 0)")
    if model._dim_r != 2:
        raise PythtbError("sector_marker requires 2-D positions (dim_r == 2)")
    if (nocc is None) == (fermi is None):
        raise PythtbError("give exactly one of nocc / fermi")
    nsta = model._norb * model._nspin
    if fermi is not None:
        evals = model.solve_all()
        nocc = int(np.count_nonzero(evals < fermi))
    nocc = int(nocc)
    if not (1 < nocc < nsta):
        raise PythtbError("nocc must be in 2..nsta-1")
    split = nocc // 2 if split is None else int(split)
    if not (1 <= split <= nocc - 1):
        raise PythtbError("split must be in [1, %d]" % (nocc - 1))
    op = np.asarray(op, dtype=np.complex128)
    if op.ndim == 1:
        op = np.diag(op)
    if op.shape != (nsta, nsta):
        raise PythtbError("op must be (%d, %d) (or a length-%d diagonal)" % (nsta, nsta, nsta))
    if np.abs(op - op.conj().T).max() > 1e-12:
        raise PythtbError("op must be Hermitian (for a spinful mirror M with M^2 = -1, pass 1j * M)")
    _check_eigensolver(eigensolver, "sector_marker")
    dev = config.checked_device()
    X, Y, cell_area = _positions(model, dev)
    W = _device_states(model, nocc)[1]
    opd = torch.as_tensor(op).to(dev)
    M = W.conj() @ opd @ W.T
    sig, U = torch.linalg.eigh(0.5 * (M + M.conj().T))  # ascending
    V_minus = U[:, :split].T @ W
    V_plus = U[:, split:].T @ W
    sig = sig.cpu().numpy()
    im_m = _marker_core(V_minus, X, Y).cpu().numpy()
    im_p = _marker_core(V_plus, X, Y).cpu().numpy()
    sig = np.asarray(sig, dtype=np.float64)
    gap = float(sig[split] - sig[split - 1])
    if gap < 1e-3:
        warnings.warn(
            "sector_marker: the P O P spectrum is (nearly) gapless at the "
            "split (min gap %.2e) -- the sector markers are ill-defined "
            "for this model/operator/filling." % gap,
            UserWarning, stacklevel=2)
    elif not (sig[split - 1] < 0.0 < sig[split]):
        warnings.warn(
            "sector_marker: the P O P spectrum does not straddle zero at "
            "the requested split (eigenvalues around it in [%.3f, %.3f]) "
            "-- the +- sector labels are arbitrary; check `split`."
            % (float(sig[split - 1]), float(sig[split])),
            UserWarning, stacklevel=2)
    cm = -4.0 * np.pi / cell_area * np.asarray(im_m, dtype=np.float64)
    cp = -4.0 * np.pi / cell_area * np.asarray(im_p, dtype=np.float64)
    if model._nspin == 2:
        cm = cm.reshape(-1, 2).sum(axis=1)
        cp = cp.reshape(-1, 2).sum(axis=1)
    return {"c_minus": cm, "c_plus": cp, "sector_marker": 0.5 * (cp - cm), "total_marker": cp + cm,
            "gap": gap}


def spin_chern_marker(model, nocc=None, fermi=None, eigensolver="auto"):
    """Per-site SPIN Chern marker of a finite spinful 2-D model: the
    Prodan P Sz P sector split of :func:`sector_marker` with the spin
    grading ``diag(+1, -1)`` per orbital -- the real-space Z2 / QSH
    diagnostic.

    :returns: dict as :func:`sector_marker` (``sector_marker`` is the
      per-site spin Chern marker)
    """
    if model._nspin != 2:
        raise PythtbError("spin_chern_marker requires a spinful model (nspin = 2)")
    sz = np.tile([1.0, -1.0], model._norb)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = sector_marker(model, sz, nocc=nocc, fermi=fermi, eigensolver=eigensolver)
    for w in caught:
        msg = str(w.message).replace("sector_marker", "spin_chern_marker").replace("P O P", "P Sz P")
        warnings.warn(msg, w.category, stacklevel=2)
    return out
