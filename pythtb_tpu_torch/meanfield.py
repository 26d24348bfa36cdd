"""Self-consistent mean-field theory: Hubbard Hartree-Fock and BCS/BdG
(counterpart of ``pythtb_tpu.meanfield``).

The reference is strictly single-particle; this module adds the two
canonical mean-field decouplings on top of the package's assemble ->
batched-eigh engines.  Each fixed-point iteration runs on the device:
H(k) once by kernel 1 (BCS: at +k and -k), the batched eigensolve by
``eigh_batched`` (kernel 2 at two states, kernel 7 at 33-64, the library
otherwise), the Fermi occupation, the chemical-potential bisection, the
density or anomalous-average update and the linear mixing as torch
operations.  The JAX package's ``lax.while_loop`` becomes chunks of
iterations queued on the device without a host read: inside a chunk
every iterate is frozen once the reference's stopping rule (``i <
max_iters and change > tol``) says stop (``torch.where(done, old,
new)``), and the host reads one flag per chunk, so the returned values
and the iteration count are those of the reference's loop.

The bisection for mu splits its 80 halvings into rounds that evaluate
the electron count at every dyadic point of the current bracket at once
(one batched Fermi sum a round instead of one a halving); it ends on the
same bracket as the JAX package's fixed-length bisection, up to the
rounding of the points.

* :func:`hartree_fock` -- collinear Hubbard-U decoupling
  ``U n_up n_dn -> U (<n_up> n_dn + n_up <n_dn> - <n_up><n_dn>)`` on a
  spinless (spin-degenerate) model treated as two spin species sharing
  one chemical potential; full-matrix (noncollinear) for explicit-spin
  models.  The converged fields come back as effective ``tb_model``
  objects, so every downstream observable composes with the interacting
  state.
* :func:`bcs_gap` -- s-wave singlet pairing ``Delta_i = g <c_idn
  c_iup>`` solved in the Bogoliubov-de Gennes form (hole block
  ``-conj(H(-k)) + mu``).
"""

from __future__ import annotations

import copy
import math
import warnings

import numpy as np
import torch

from . import config
from .model import PythtbError
from .ops.eigh import eigh_batched
from .ops.hamiltonian import assemble

__all__ = ["hartree_fock", "bcs_gap"]

# iterations queued on the device between two host reads of the stop flag
_CHUNK = 32
# halvings of the mu bisection (the JAX package's fixed count) and the most
# count evaluations one round of it may hold at once
_BISECT_HALVINGS = 80
_BISECT_ELEMENTS = 1 << 22


def _fermi(x):
    """Fermi function 1/(e^x + 1), overflow-stable."""
    return 0.5 * (1.0 - torch.tanh(0.5 * torch.clamp(x, -80.0, 80.0)))


def _bisect_mu(w, kt, n_target, norm):
    """Chemical potential with sum_all f((e - mu)/kt) / norm == n_target,
    on the device: the bracket [min(w) - 30 kt, max(w) + 30 kt] halved
    80 times, r halvings a round by counting at all 2^r - 1 interior
    dyadic points at once (the count is non-decreasing in mu, so the
    points below the target fix the new bracket)."""
    w = w.reshape(-1)
    lo = torch.min(w) - 30.0 * kt
    hi = torch.max(w) + 30.0 * kt
    r_max = max(1, min(10, int(math.log2(max(_BISECT_ELEMENTS // max(w.numel(), 1), 2)))))
    left = _BISECT_HALVINGS
    while left > 0:
        r = min(r_max, left)
        n = 1 << r
        frac = torch.arange(n + 1, dtype=config.FLOAT, device=w.device) / n
        pts = lo + (hi - lo) * frac  # pts[0] = lo, pts[n] = hi
        pts[0], pts[n] = lo, hi
        count = torch.sum(_fermi((w[None, :] - pts[1:n, None]) / kt), dim=1) / norm
        j = torch.sum(count < n_target)  # interior points still too few
        lo, hi = pts[j], pts[j + 1]
        left -= r
    return 0.5 * (lo + hi)


def _fixed_point(body, x0, tol, max_iters):
    """Iterate ``x, change = body(x)`` under the reference's while-loop
    rule (continue while ``i < max_iters and change > tol``), in chunks
    of up to ``_CHUNK`` iterations queued on the device with one host read
    of the stop flag a chunk; iterates after the stop are computed and
    discarded.  Returns ``(x, change, iterations)`` with the change of the
    last iteration taken (inf if none)."""
    dev = x0.device
    x = x0
    change = torch.full((), math.inf, dtype=config.FLOAT, device=dev)
    i = torch.zeros((), dtype=torch.int64, device=dev)
    done = torch.tensor(max_iters <= 0, device=dev)
    queued = 0
    while queued < max_iters and not bool(done):
        for _ in range(min(_CHUNK, max_iters - queued)):
            new_x, new_change = body(x)
            live = ~done
            x = torch.where(live, new_x, x)
            change = torch.where(live, new_change, change)
            i = i + live.to(torch.int64)
            done = (i >= max_iters) | ~(change > tol)
        queued += min(_CHUNK, max_iters - queued)
    return x, change, int(i)


def _gap_at(w, mu):
    below = torch.where(w < mu, w, torch.full_like(w, -math.inf))
    above = torch.where(w > mu, w, torch.full_like(w, math.inf))
    return float(torch.min(above) - torch.max(below))


def _kpts_on(data, kpts):
    return torch.as_tensor(np.ascontiguousarray(kpts, dtype=np.float64)).to(data.device)


def _hf_scf(data, kpts, Uvec, n_init, kt, max_iters, mix, tol, n_elec):
    """Collinear Hubbard-HF fixed point on the device.  Returns host
    per-spin densities (2, norb), mu, energy, gap, iteration count and
    the last density change."""
    H0 = assemble(data, _kpts_on(data, kpts))  # (B, n, n)
    B, n = H0.shape[0], H0.shape[-1]
    dev = H0.device
    U = torch.as_tensor(np.array(Uvec, dtype=np.float64)).to(dev)

    def spectra(n_ud):
        # spin-up sees U n_dn, spin-dn sees U n_up
        pot = torch.stack([U * n_ud[1], U * n_ud[0]])  # (2, n)
        H = (H0[None] + torch.diag_embed(pot).to(config.COMPLEX)[:, None]).reshape(2 * B, n, n)
        w, v = eigh_batched(H.contiguous())
        return w.reshape(2, B, n), v.reshape(2, B, n, n)

    def body(n_ud):
        w, v = spectra(n_ud)
        mu = _bisect_mu(w, kt, n_elec, B)  # n_elec per cell, both spins
        f = _fermi((w - mu) / kt)
        new = torch.einsum("sbn,sbni->si", f, v.abs() ** 2) / B
        mixed = (1.0 - mix) * n_ud + mix * new
        return mixed, torch.max(torch.abs(mixed - n_ud))

    n0 = torch.as_tensor(np.array(n_init, dtype=np.float64)).to(dev)
    n_ud, dn, iters = _fixed_point(body, n0, tol, max_iters)
    # converged observables, one more diagonalization
    w, v = spectra(n_ud)
    mu = _bisect_mu(w, kt, n_elec, B)
    f = _fermi((w - mu) / kt)
    e_band = torch.sum(f * w) / B
    e_dc = torch.sum(U * n_ud[0] * n_ud[1])  # double-counting correction
    return (n_ud.cpu().numpy(), float(mu), float(e_band - e_dc), _gap_at(w, mu), iters, float(dn))


def _hf2_scf(data, kpts, Uvec, rho_init, kt, max_iters, mix, tol, n_elec):
    """Full-matrix (noncollinear) Hubbard-HF fixed point on the device for
    explicit-spin models: the order parameter is the on-site 2x2 spin
    density matrix rho_i = <c_{i alpha}^dag c_{i beta}>, the mean field
    ``V_i = U_i (Tr(rho_i) I - rho_i^T)``, the double counting ``E_dc =
    U det(rho_i)``."""
    H0 = assemble(data, _kpts_on(data, kpts))  # (B, nsta, nsta), nsta = 2 norb
    B, nsta = H0.shape[0], H0.shape[-1]
    norb = nsta // 2
    dev = H0.device
    U = torch.as_tensor(np.array(Uvec, dtype=np.float64)).to(dev)
    eye_orb = torch.eye(norb, dtype=config.COMPLEX, device=dev)
    eye2 = torch.eye(2, dtype=config.COMPLEX, device=dev)

    def spectra(rho):
        tr = rho.diagonal(dim1=-2, dim2=-1).sum(-1)
        V = U[:, None, None] * (tr[:, None, None] * eye2 - rho.transpose(-1, -2))  # (norb, 2, 2)
        D = torch.einsum("ij,iab->iajb", eye_orb, V).reshape(nsta, nsta)
        return eigh_batched((H0 + D[None]).contiguous())

    def body(rho):
        w, v = spectra(rho)
        mu = _bisect_mu(w, kt, n_elec, B)
        f = _fermi((w - mu) / kt).to(config.COMPLEX)  # (B, nsta)
        vb = v.reshape(B, nsta, norb, 2)  # state components per (orb, spin)
        new = torch.einsum("kn,knia,knib->iab", f, vb.conj(), vb) / B
        mixed = (1.0 - mix) * rho + mix * new
        # keep the iterate exactly Hermitian (drift compounds over hundreds
        # of iterations)
        mixed = (mixed + mixed.transpose(-1, -2).conj()) / 2.0
        return mixed, torch.max(torch.abs(mixed - rho))

    rho0 = torch.as_tensor(np.array(rho_init, dtype=np.complex128)).to(dev)
    rho, dr, iters = _fixed_point(body, rho0, tol, max_iters)
    w, v = spectra(rho)
    mu = _bisect_mu(w, kt, n_elec, B)
    f = _fermi((w - mu) / kt)
    e_band = torch.sum(f * w) / B
    dets = rho[:, 0, 0] * rho[:, 1, 1] - rho[:, 0, 1] * rho[:, 1, 0]
    energy = e_band - torch.sum(U * dets.real)
    return (rho.cpu().numpy().astype(np.complex128), float(mu), float(energy), _gap_at(w, mu), iters,
            float(dr))


def _bcs_scf(data, kpts, gcpl, d_init, kt, max_iters, mix, tol, mu):
    """BCS gap fixed point on the device.  Nambu basis (c_{k up},
    c_{-k dn}^dag): particle block H(k) - mu, hole block -conj(H(-k)) + mu,
    pairing block diag(Delta_i); Delta stays real in the loop."""
    k = _kpts_on(data, kpts)
    Hp = assemble(data, k)  # (B, n, n) at +k
    Hm = assemble(data, -k)  # (B, n, n) at -k
    B, n = Hp.shape[0], Hp.shape[-1]
    dev = Hp.device
    eye = torch.eye(n, dtype=config.COMPLEX, device=dev)
    top = Hp - mu * eye
    bot = -Hm.conj() + mu * eye

    def spectra(delta):
        D = (delta.to(config.COMPLEX)[:, None] * eye).expand(B, n, n)
        H = torch.cat([torch.cat([top, D], dim=-1), torch.cat([D.transpose(-1, -2).conj(), bot], dim=-1)],
                      dim=-2)  # (B, 2n, 2n)
        return eigh_batched(H.contiguous())

    def body(delta):
        w, v = spectra(delta)
        # <Psi Psi^dag> = sum_a (1 - f(E_a)) w_a w_a^dag; the (up, dn-dag)
        # off-diagonal block gives <c_{i up} c_{i dn}> = -F_i
        f = _fermi(w / kt)  # (B, 2n)
        u = v[..., :n]  # (B, 2n states, n) particle components
        h = v[..., n:]  # hole components
        G12 = torch.einsum("bai,ba,bai->i", u, (1.0 - f).to(config.COMPLEX), h.conj()) / B
        mixed = (1.0 - mix) * delta + mix * (gcpl * G12.real)
        return mixed, torch.max(torch.abs(mixed - delta))

    d0 = torch.as_tensor(np.array(d_init, dtype=np.float64)).to(dev)
    delta, dd, iters = _fixed_point(body, d0, tol, max_iters)
    w, _ = spectra(delta)
    return delta.cpu().numpy().astype(np.float64), float(torch.min(torch.abs(w))), iters, float(dd)


def _kgrid(model, nk):
    """Uniform closed k-grid (B, dim_k) for the mean-field BZ sums (or
    the single empty point for finite models)."""
    if model._dim_k == 0:
        return np.zeros((1, 0), dtype=np.float64)
    if nk is None:
        raise PythtbError("nk is required for a periodic model")
    nk = tuple(int(x) for x in np.atleast_1d(nk))
    if len(nk) != model._dim_k or min(nk) < 2:
        raise PythtbError("nk must give %d sizes >= 2" % model._dim_k)
    axes = [np.arange(m) / float(m) for m in nk]
    grid = np.meshgrid(*axes, indexing="ij")
    return np.stack([g.ravel() for g in grid], axis=-1)


def hartree_fock(model, U, n_elec, nk=None, temperature=None, init=None,
                 stagger=0.1, mix=0.5, tol=None, max_iters=500, seed=0):
    """Self-consistent Hubbard Hartree-Fock.

    A spinless model (``nspin == 1``) is treated as two degenerate spin
    species coupled only through the collinear mean field ``H_sigma =
    H_0 + U diag(<n_{-sigma}>)`` at a shared chemical potential.  An
    explicit-spin model (``nspin == 2``) dispatches to the FULL-MATRIX
    (noncollinear) decoupling on the on-site 2x2 spin density matrix
    ``rho_i``, mean field ``U_i (Tr(rho_i) I - rho_i^T)`` -- see the
    return-dict differences below.  Either way the whole fixed-point
    loop (assemble + batched eigh + Fermi filling + linear mixing) runs
    on the device, read back once a chunk of iterations.

    :param U: Hubbard repulsion, scalar or per-orbital (norb,)
    :param n_elec: total electrons per cell, both spins
      (0 < n_elec < 2 norb); half filling = norb
    :param nk: BZ grid sizes (periodic models; finite models omit it)
    :param temperature: Fermi smearing k_B T (default: 1e-3 of the
      spectral span -- effectively T = 0 for gapped solutions)
    :param init: optional (2, norb) starting densities; default is the
      uniform paramagnet plus a symmetry-breaking perturbation
    :param stagger: amplitude of the default perturbation (a seeded
      random +-stagger between the spin species; set 0 to lock the
      paramagnetic sector)
    :param mix: linear mixing weight of the new densities
    :param tol: fixed-point tolerance on max |density change| (default
      ``eps(float64)^(2/3)``, ~3.7e-11)
    :param max_iters: iteration cap (a ``UserWarning`` reports
      non-convergence)
    :returns: dict with ``n_up``/``n_dn`` (norb,), ``magnetization``
      (n_up - n_dn), ``mu``, ``energy`` (HF total energy per cell,
      double counting removed), ``gap`` (single-particle gap at mu),
      ``iters``, ``converged``, and ``model_up``/``model_dn`` --
      effective single-particle ``tb_model`` copies with the converged
      mean field added to the onsite energies (every downstream
      observable composes with them).  For ``nspin == 2`` the dict
      instead carries ``rho`` (norb, 2, 2), ``magnetization``
      (norb, 3) Pauli vectors, ``density`` (norb,), and a single
      spinful ``model_mf``.
    """
    if model._nspin == 2:
        return _hartree_fock_matrix(
            model, U, n_elec, nk=nk, temperature=temperature, init=init,
            stagger=stagger, mix=mix, tol=tol, max_iters=max_iters,
            seed=seed)
    norb = int(model._norb)
    Uvec = np.broadcast_to(np.asarray(U, dtype=np.float64).ravel(), (norb,))
    n_elec = float(n_elec)
    if not 0.0 < n_elec < 2.0 * norb:
        raise PythtbError("n_elec must be in (0, %d)" % (2 * norb))
    kpts = _kgrid(model, nk)

    span = float(np.abs(np.asarray(model._site_energies)).max() + 2.0 * sum(
        np.abs(np.asarray(h[0])).max() for h in model._hoppings
    ) + np.abs(Uvec).max() + 1e-9)
    kt = float(temperature) if temperature is not None else 1e-3 * span
    if kt <= 0.0:
        raise PythtbError("temperature must be > 0")

    if init is not None:
        n0 = np.asarray(init, dtype=np.float64)
        if n0.shape != (2, norb):
            raise PythtbError("init must be (2, norb) densities")
    else:
        base = n_elec / (2.0 * norb)
        rng = np.random.default_rng(seed)
        pert = float(stagger) * (rng.random(norb) - 0.5)
        n0 = np.stack([base + pert, base - pert])
        n0 = np.clip(n0, 0.0, 1.0)

    if tol is None:
        tol = float(np.finfo(np.float64).eps) ** (2.0 / 3.0)
    n_ud, mu, energy, gap, iters, dn = _hf_scf(
        model._get_finalized(), kpts, Uvec, n0, kt, int(max_iters), float(mix), float(tol), n_elec)
    converged = bool(dn <= tol)
    if not converged:
        warnings.warn(
            "hartree_fock: not converged after %d iterations (last "
            "density change %.2e > tol %.1e) -- reduce mix or raise "
            "max_iters" % (int(iters), float(dn), tol),
            UserWarning, stacklevel=2,
        )

    def _effective(n_other):
        eff = copy.deepcopy(model)
        eff.set_onsite((Uvec * n_other).tolist(), mode="add")
        return eff

    return {
        "n_up": n_ud[0],
        "n_dn": n_ud[1],
        "magnetization": n_ud[0] - n_ud[1],
        "mu": mu,
        "energy": energy,
        "gap": gap,
        "iters": iters,
        "converged": converged,
        "model_up": _effective(n_ud[1]),
        "model_dn": _effective(n_ud[0]),
    }



def _hartree_fock_matrix(model, U, n_elec, nk=None, temperature=None,
                         init=None, stagger=0.1, mix=0.5, tol=None,
                         max_iters=500, seed=0):
    """Full-matrix (noncollinear) Hubbard HF for explicit-spin models;
    dispatched automatically by :func:`hartree_fock` when
    ``nspin == 2``.  The order parameter is the on-site 2x2 spin
    density matrix, so spin-orbit-coupled interacting states with
    ARBITRARY magnetization directions are representable -- e.g. the
    Kane-Mele-Hubbard easy-plane antiferromagnet (committed test: at
    large U the Neel vector lies in the xy-plane, m_z = 0, because the
    SOC term penalizes out-of-plane order).

    Returns a dict with ``rho`` (norb, 2, 2), ``magnetization``
    (norb, 3) Pauli vectors Tr(rho sigma), ``density`` (norb,), ``mu``,
    ``energy``, ``gap``, ``iters``, ``converged``, and ``model_mf`` --
    ONE effective spinful ``tb_model`` with the converged 2x2 mean
    field added on-site.
    """
    norb = int(model._norb)
    Uvec = np.broadcast_to(np.asarray(U, dtype=np.float64).ravel(), (norb,))
    n_elec = float(n_elec)
    if not 0.0 < n_elec < 2.0 * norb:
        raise PythtbError("n_elec must be in (0, %d)" % (2 * norb))
    kpts = _kgrid(model, nk)

    span = float(np.abs(np.asarray(model._site_energies)).max() + 2.0 * sum(
        np.abs(np.asarray(h[0])).max() for h in model._hoppings
    ) + np.abs(Uvec).max() + 1e-9)
    kt = float(temperature) if temperature is not None else 1e-3 * span
    if kt <= 0.0:
        raise PythtbError("temperature must be > 0")

    if init is not None:
        rho0 = np.asarray(init, dtype=np.complex128)
        if rho0.shape != (norb, 2, 2):
            raise PythtbError("init must be (norb, 2, 2) density matrices")
        if np.abs(rho0 - np.conj(np.swapaxes(rho0, -1, -2))).max() > 1e-10:
            raise PythtbError("init density matrices must be Hermitian")
    else:
        base = n_elec / (2.0 * norb)
        rng = np.random.default_rng(seed)
        rho0 = np.broadcast_to(
            base * np.eye(2), (norb, 2, 2)).astype(complex).copy()
        # random Hermitian perturbation: seeds collinear AND
        # noncollinear order on an equal footing
        pz = float(stagger) * (rng.random(norb) - 0.5)
        pxy = float(stagger) * (rng.random(norb) - 0.5) + 1j * float(
            stagger) * (rng.random(norb) - 0.5)
        rho0[:, 0, 0] += pz
        rho0[:, 1, 1] -= pz
        rho0[:, 0, 1] += pxy
        rho0[:, 1, 0] += np.conj(pxy)

    if tol is None:
        tol = float(np.finfo(np.float64).eps) ** (2.0 / 3.0)
    rho, mu, energy, gap, iters, dr = _hf2_scf(
        model._get_finalized(), kpts, Uvec, rho0, kt, int(max_iters), float(mix), float(tol), n_elec)
    converged = bool(dr <= tol)
    if not converged:
        warnings.warn(
            "hartree_fock: not converged after %d iterations (last "
            "density change %.2e > tol %.1e) -- reduce mix or raise "
            "max_iters" % (int(iters), float(dr), tol),
            UserWarning, stacklevel=3,
        )

    sig = np.array([[[0, 1], [1, 0]], [[0, -1j], [1j, 0]],
                    [[1, 0], [0, -1]]])
    mag = np.real(np.einsum("iab,sba->is", rho, sig))

    eff = copy.deepcopy(model)
    V = Uvec[:, None, None] * (
        np.trace(rho, axis1=-2, axis2=-1)[:, None, None] * np.eye(2)
        - np.swapaxes(rho, -1, -2))
    eff.set_onsite([V[i] for i in range(norb)], mode="add")

    return {
        "rho": rho,
        "magnetization": mag,
        "density": np.real(np.trace(rho, axis1=-2, axis2=-1)),
        "mu": mu,
        "energy": energy,
        "gap": gap,
        "iters": iters,
        "converged": converged,
        "model_mf": eff,
    }



def bcs_gap(model, g, mu, nk=None, temperature=None, init=None, mix=0.5,
            tol=None, max_iters=500):
    """Self-consistent s-wave BCS/BdG pairing ``Delta_i = g <c_{i dn}
    c_{i up}>`` (per-orbital, attractive ``g > 0``) at fixed chemical
    potential, the gap-equation fixed point iterated on the device.

    The Nambu convention matches
    ``pythtb_tpu.geometry.superfluid_weight`` (hole block
    ``-conj(H(-k)) + mu``), so a converged uniform ``Delta`` can be
    passed straight to the superfluid-weight stencil.  Multi-orbital
    cells return orbital-resolved gaps (e.g. the Lieb flat band
    concentrates ``Delta`` on the flat-band sublattices).

    Committed oracle: on the square lattice the converged gap solves
    the classic equation ``1/g = (1/N) sum_k tanh(E_k / 2T) / (2
    E_k)``, ``E_k = sqrt((eps_k - mu)^2 + Delta^2)``, root-found
    independently in NumPy.

    :param g: pairing attraction (energy units, > 0)
    :param mu: chemical potential
    :param nk: BZ grid sizes (periodic; finite models omit it)
    :param temperature: k_B T (default: spectral span * 1e-4)
    :param init: starting ``Delta`` (scalar or (norb,); default 10% of
      the span -- start LARGE: Delta = 0 is always a fixed point)
    :param mix: linear mixing weight
    :param tol: fixed-point tolerance on max |Delta change| (default
      ``eps(float64)^(2/3)``, as :func:`hartree_fock`)
    :param max_iters: iteration cap (``UserWarning`` on
      non-convergence)
    :returns: dict with ``delta`` (norb,), ``qp_gap`` (smallest
      quasiparticle energy), ``iters``, ``converged``
    """
    if model._nspin != 1:
        raise PythtbError(
            "bcs_gap supports spinless (spin-degenerate) models only")
    if float(g) <= 0.0:
        raise PythtbError("bcs_gap requires attraction g > 0")
    norb = int(model._norb)
    kpts = _kgrid(model, nk)
    span = float(np.abs(np.asarray(model._site_energies)).max() + 2.0 * sum(
        np.abs(np.asarray(h[0])).max() for h in model._hoppings) + 1e-9)
    kt = float(temperature) if temperature is not None else 1e-4 * span
    if kt <= 0.0:
        raise PythtbError("temperature must be > 0")
    if init is None:
        d0 = np.full(norb, 0.1 * span)
    else:
        d0 = np.broadcast_to(
            np.asarray(init, dtype=np.float64).ravel(), (norb,)).copy()

    if tol is None:
        tol = float(np.finfo(np.float64).eps) ** (2.0 / 3.0)
    delta, egap, iters, dd = _bcs_scf(
        model._get_finalized(), kpts, float(g), d0, kt, int(max_iters), float(mix), float(tol), float(mu))
    converged = bool(dd <= tol)
    if not converged:
        warnings.warn(
            "bcs_gap: not converged after %d iterations (last Delta "
            "change %.2e > tol %.1e)" % (int(iters), float(dd), tol),
            UserWarning, stacklevel=2,
        )
    return {
        "delta": delta,
        "qp_gap": egap,
        "iters": iters,
        "converged": converged,
    }
