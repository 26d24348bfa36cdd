"""Exact diagonalization of small interacting clusters (counterpart of
``pythtb_tpu.ed``).

Any *finite* ``tb_model`` (``dim_k == 0``, e.g. a ``cut_piece`` flake)
becomes a many-body Fock-space problem with Hubbard-U and general
density-density interactions, and number-conserving sectors are
diagonalized exactly: ground states, gaps, double occupancy, spin
correlations, one-particle spectral functions, dynamical
susceptibilities, and many-body topology by twisted boundary conditions.

Layout, as in the JAX package:

* Fock states are bit-masks (``uint64``); sector bases, fermionic signs
  and hop maps are built on the host with vectorized NumPy bit
  arithmetic -- cheap O(D * nnz) index work, a copy of the JAX package's.
* The dense sector eigensolve runs on the device: the full spectrum by
  :func:`pythtb_tpu_torch.ops.eigh.eigh_batched` (kernel 7 at 33-64
  states, ``torch.linalg.eigh`` otherwise -- the JAX program is one
  eigh), followed by the reference's Krylov refinement in float64 torch
  on the same device; the ``lowest=k`` path is Chebyshev-filtered
  subspace iteration whose filter is kernel 11b
  (:func:`pythtb_tpu_torch.ops.chebyshev.dense_filter`), with the
  Rayleigh-Ritz, QR and residual in float64 ``torch.linalg`` beside it
  and H uploaded once.  Start and re-pad blocks are drawn with
  ``np.random.default_rng(seed)`` on the host in the reference's order,
  so the cut schedule and round count follow the JAX package's.
* The omega sweeps of spectral functions and susceptibilities,
  ``sum_n a_n / (omega - p_n + i eta)``, are kernel 16's Lorentzian mode
  (:func:`pythtb_tpu_torch.optical.spectral_sum`, one column).
* Twisted Hamiltonians ``H(theta) = H_0 + sum_w [cos(theta.w) A_w +
  sin(theta.w) B_w]`` are formed on the device row by row of the twist
  grid and solved by ``eigh_batched``; the twist links are kernel 3's
  link determinants and kernel 4's plaquette sum
  (:mod:`pythtb_tpu_torch.ops.berry`).  At theta = 2 pi the twisted H
  equals H(0), so appending the theta = 0 row and column closes the
  torus in the same gauge.

Two layouts: the **product layout** (``hubbard``: ``nspin == 1`` models
with Hubbard U, the ``(N_up, N_dn)`` sector as the tensor product of an
up- and a dn-chain basis, all up modes first) and the **general
layout** (``solve``: one global mode set, mode ``2*orb + spin`` for
spinful models, one total-N sector, any Hermitian one-body matrix plus
symmetric density-density interactions).
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from . import config
from .model import PythtbError
from .ops.berry import link_dets, plaquette_flux
from .ops.chebyshev import dense_filter
from .ops.eigh import eigh_batched
from .ops.solver import _to_host as _host
from .optical import spectral_sum

__all__ = [
    "dense_h",
    "sector_basis",
    "build_sector",
    "solve_sector",
    "hubbard",
    "solve",
    "ground_state",
    "spectral_function",
    "dynamic_susceptibility",
    "many_body_chern",
    "twist_berry_phase",
    "resta_polarization",
]

# dense D x D complex128 sector Hamiltonians: keep the footprint sane
# (8192^2 * 16 B = 1 GiB).  Larger clusters belong to matvec/KPM land.
_MAX_DIM = 8192

_ONE = np.uint64(1)


# ---------------------------------------------------------------------------
# bit-mask basis machinery


def _popcount(x):
    return np.bitwise_count(x).astype(np.int64)


def sector_basis(nmodes, nelec):
    """All ``nmodes``-bit masks with ``nelec`` bits set, ascending.

    Uses the standard "next lexicographic bit permutation" enumeration,
    vectorized is not needed here (the basis is enumerated once and is
    at most ``_MAX_DIM`` long).
    """
    if not 0 <= nelec <= nmodes:
        raise PythtbError("sector_basis: need 0 <= nelec <= nmodes")
    if nmodes > 63:
        raise PythtbError("sector_basis: at most 63 modes supported")
    from math import comb

    dim = comb(nmodes, nelec)
    if dim > _MAX_DIM:
        raise PythtbError(
            "ED sector dimension %d exceeds %d; use a smaller cluster "
            "(or the single-particle matvec/KPM machinery for large "
            "non-interacting systems)" % (dim, _MAX_DIM)
        )
    out = np.empty(dim, dtype=np.uint64)
    if nelec == 0:
        out[0] = 0
        return out
    v = int((1 << nelec) - 1)
    top = 1 << nmodes
    for i in range(dim):
        out[i] = v
        # Gosper's hack: next integer with the same popcount
        c = v & -v
        r = v + c
        v = r | (((v ^ r) >> 2) // c)
        if v >= top and i + 1 < dim:  # pragma: no cover - defensive
            raise PythtbError("sector_basis enumeration overflow")
    return out


def _apply_cdc(basis, a, b):
    """Vectorized ``c^dag_a c_b`` on every basis mask.

    Returns ``(valid, new, sign)``: boolean mask of states where the
    operator does not annihilate, the resulting masks, and the
    fermionic signs (Jordan-Wigner strings in mode order).
    """
    if a == b:
        occ = ((basis >> np.uint64(a)) & _ONE).astype(bool)
        return occ, basis.copy(), np.ones(len(basis), dtype=np.int8)
    occ_b = ((basis >> np.uint64(b)) & _ONE).astype(bool)
    occ_a = ((basis >> np.uint64(a)) & _ONE).astype(bool)
    valid = occ_b & ~occ_a
    s1 = _popcount(basis & ((_ONE << np.uint64(b)) - _ONE))
    mid = basis ^ (_ONE << np.uint64(b))
    s2 = _popcount(mid & ((_ONE << np.uint64(a)) - _ONE))
    new = mid | (_ONE << np.uint64(a))
    sign = np.where(((s1 + s2) % 2).astype(bool), -1, 1).astype(np.int8)
    return valid, new, sign


def _apply_c(basis, m):
    """Vectorized annihilation ``c_m``: (valid, new, sign)."""
    occ = ((basis >> np.uint64(m)) & _ONE).astype(bool)
    sign = np.where(
        (_popcount(basis & ((_ONE << np.uint64(m)) - _ONE)) % 2).astype(bool),
        -1,
        1,
    ).astype(np.int8)
    return occ, basis ^ np.where(occ, _ONE << np.uint64(m), np.uint64(0)), sign


def _apply_cdag(basis, m):
    """Vectorized creation ``c^dag_m``: (valid, new, sign)."""
    occ = ((basis >> np.uint64(m)) & _ONE).astype(bool)
    valid = ~occ
    sign = np.where(
        (_popcount(basis & ((_ONE << np.uint64(m)) - _ONE)) % 2).astype(bool),
        -1,
        1,
    ).astype(np.int8)
    return valid, basis | np.where(valid, _ONE << np.uint64(m), np.uint64(0)), sign


def _occupations(basis, nmodes):
    """(D, nmodes) float occupation-number table."""
    shifts = np.arange(nmodes, dtype=np.uint64)
    return ((basis[:, None] >> shifts[None, :]) & _ONE).astype(np.float64)


def build_sector(h, basis, vmat=None):
    """Dense many-body Hamiltonian of ``H = sum h_ab c^dag_a c_b +
    (1/2) sum_{a != b} V_ab n_a n_b`` on a sector basis.

    ``h`` is the Hermitian one-body matrix (nmodes x nmodes); ``vmat``
    a real symmetric density-density matrix with zero diagonal
    (``n_a n_a = n_a`` belongs in ``h``'s diagonal -- a nonzero
    diagonal raises rather than silently shifting onsite energies).
    """
    h = np.asarray(h, dtype=complex)
    nmodes = h.shape[0]
    if h.shape != (nmodes, nmodes) or not np.allclose(h, h.conj().T, atol=1e-12):
        raise PythtbError("build_sector: h must be a Hermitian square matrix")
    D = len(basis)
    occ = _occupations(basis, nmodes)
    diag = occ @ np.real(np.diag(h))
    if vmat is not None:
        V = np.asarray(vmat, dtype=float)
        if V.shape != (nmodes, nmodes) or not np.allclose(V, V.T, atol=1e-12):
            raise PythtbError("build_sector: vmat must be real symmetric")
        if np.max(np.abs(np.diag(V))) > 1e-12:
            raise PythtbError(
                "build_sector: vmat diagonal must be zero (n_a n_a = n_a "
                "is a one-body term; put it in h)"
            )
        diag = diag + 0.5 * np.einsum("da,ab,db->d", occ, V, occ)
    H = np.zeros((D, D), dtype=complex)
    H[np.diag_indices(D)] = diag
    offd = np.array(np.nonzero(h)).T
    for a, b in offd:
        if a == b:
            continue
        valid, new, sign = _apply_cdc(basis, int(a), int(b))
        src = np.nonzero(valid)[0]
        if len(src) == 0:
            continue
        dst = np.searchsorted(basis, new[src])
        # within one (a, b) pair the map src -> dst is injective, so
        # fancy-indexed += cannot collide
        H[dst, src] += sign[src] * h[a, b]
    return H


def _upload(a):
    """A C-contiguous complex128 copy of host ``a`` on the device."""
    return torch.as_tensor(np.ascontiguousarray(a, dtype=complex)).to(config.checked_device())


def solve_sector(H, refine=24, lowest=None, max_iters=12, seed=0):
    """Eigendecomposition of a dense sector Hamiltonian on the device.

    Returns host ``(evals, evecs)`` with evecs ROWS as states
    (ascending), matching the package eigensolver convention.

    ``lowest``: when set to an integer k, skip the full dense eigh and
    compute only the k lowest eigenpairs by Chebyshev-filtered subspace
    iteration -- kernel 11b filter rounds alternating with float64
    Rayleigh-Ritz on the same device, at most ``max_iters`` rounds
    (early exit on the residual).  The returned spectrum is PARTIAL
    (length k): ``EDResult.energy``, ``gap`` (k >= 2) and all
    ground-state observables are exact, but thermal traces over the
    full sector are not available.

    ``refine``: the lowest ``refine`` eigenpairs are re-extracted in
    float64 by a Rayleigh-Ritz pass over the Krylov-enriched subspace
    ``[V, H V, H^2 V]`` of the solver's states, as the JAX package does
    (there it repairs float32 eigenpairs of the TPU; in float64 it moves
    them by rounding only).  Set ``refine=0`` to skip."""
    if lowest is not None:
        return _solve_sector_lowest(H, int(lowest), int(max_iters), seed)
    Hd = _upload(H)
    w, v = eigh_batched(Hd[None])
    w, v = w[0], v[0]
    m = min(int(refine), w.shape[0])
    if m > 0:
        V = v[:m]  # rows are states
        HV = V @ Hd.T.conj()
        # span{V, HV, H^2 V} (the reference's order of products)
        S = torch.cat([V, HV, HV @ Hd.T.conj()], dim=0)
        # orthonormalize rows (QR on the transpose), drop rank-deficient
        q, r = torch.linalg.qr(S.T)
        dr = r.diagonal().abs()
        keep = dr > 1e-10 * max(float(dr.max()), 1e-300)
        Q = q[:, keep]  # (N, <=3m) columns orthonormal
        Hs = Q.conj().T @ Hd @ Q
        ws, vs = torch.linalg.eigh(0.5 * (Hs + Hs.conj().T))
        take = min(m, ws.shape[0])
        w = w.clone()
        v = v.clone()
        w[:take] = ws[:take]
        v[:take] = (Q @ vs[:, :take]).T
        # re-sort jointly where the splice broke the ascending order
        order = torch.argsort(w, stable=True)
        if not torch.equal(order, torch.arange(w.shape[0], device=w.device)):
            w = w[order]
            v = v[order]
    return _host(w).astype(np.float64), _host(v)


def _solve_sector_lowest(H, k, rounds, seed, p=30, tol=None):
    """k lowest eigenpairs of a dense sector H by Chebyshev-filtered
    subspace iteration: the filter is kernel 11b, the Rayleigh-Ritz
    re-diagonalization, QR and residual are float64 torch.linalg on the
    same device, so the filtered subspace only has to CONTAIN the states.

    Filter schedule (the reference's): round 1 suppresses everything
    above a guess ``lo + 10%`` of the Gershgorin range; later rounds move
    the cut to the (k + buf/2)-th Ritz value.  Rank lost to filter
    collapse is re-padded with fresh random vectors orthogonal to the
    kept span, drawn from the same host generator as the start block."""
    Hn = np.asarray(H, dtype=complex)
    D = Hn.shape[0]
    if k < 1:
        raise PythtbError("ed: lowest must be >= 1")
    buf = max(k, 6)
    nb = k + buf
    if nb >= D:
        raise PythtbError(
            "ed: lowest=%d needs a sector dimension > %d; use the "
            "full eigh (lowest=None)" % (k, nb)
        )
    radii = np.sum(np.abs(Hn), axis=1) - np.abs(np.diag(Hn))
    hi = float(np.max(np.real(np.diag(Hn)) + radii))
    lo = float(np.min(np.real(np.diag(Hn)) - radii))
    rng = np.random.default_rng(seed)
    X = _upload(rng.standard_normal((D, nb)) + 1j * rng.standard_normal((D, nb)))
    cut = lo + 0.1 * (hi - lo)
    Hd = _upload(Hn)  # once
    w = None
    tol = float(np.finfo(np.float64).eps ** 0.5) if tol is None else tol
    scale = max(abs(hi), abs(lo), 1.0)
    for _ in range(max(int(rounds), 1)):
        c = 0.5 * (cut + hi)
        hw = 0.5 * (hi - cut)
        X = dense_filter(Hd, X, p, c, hw)
        X = X / torch.linalg.vector_norm(X, dim=0, keepdim=True)
        q, r = torch.linalg.qr(X)
        dr = r.diagonal().abs()
        keep = dr > 1e-12 * max(float(dr.max()), 1e-300)
        Q = q[:, keep]
        if Q.shape[1] < nb:
            extra = _upload(rng.standard_normal((D, nb - Q.shape[1]))
                            + 1j * rng.standard_normal((D, nb - Q.shape[1])))
            extra = extra - Q @ (Q.conj().T @ extra)
            qe, _ = torch.linalg.qr(extra)
            Q = torch.cat([Q, qe], dim=1)
        Hs = Q.conj().T @ Hd @ Q
        ws, vs = torch.linalg.eigh(0.5 * (Hs + Hs.conj().T))
        X = (Q @ vs).contiguous()
        w = ws
        cut = float(w[min(k + buf // 2, w.shape[0] - 1)])
        res = float(torch.linalg.vector_norm(Hd @ X[:, :k] - X[:, :k] * w[:k], dim=0).max())
        if res < tol * scale:
            break
    if res > 1e-6 * scale:
        warnings.warn(
            "ed: spectrum-slice solver residual %.1e after %d rounds; "
            "increase rounds (max_iters) or use the full eigh"
            % (res, rounds), stacklevel=3)
    return _host(w[:k]).astype(np.float64), np.ascontiguousarray(_host(X[:, :k]).T)  # rows are states



# ---------------------------------------------------------------------------
# model -> one-body data


def dense_h(model):
    """Dense one-body Hamiltonian of a finite model, host-side.

    For ``nspin == 2`` the flattened index is ``2*orb + spin`` --
    exactly the orb-major flattening of ``ops/hamiltonian.assemble``
    (verified against ``solve_all`` in the tests).
    """
    if model._dim_k != 0:
        raise PythtbError(
            "ed: model must be finite (dim_k == 0); cut_piece a "
            "periodic model first"
        )
    norb = model._norb
    if model._nspin == 1:
        h = np.zeros((norb, norb), dtype=complex)
        h[np.diag_indices(norb)] = model._site_energies
        for hop in model._hoppings:
            amp, i, j = hop[0], hop[1], hop[2]
            h[i, j] += amp
            h[j, i] += np.conj(amp)
        return h
    h = np.zeros((norb, 2, norb, 2), dtype=complex)
    for i in range(norb):
        h[i, :, i, :] = model._site_energies[i]
    for hop in model._hoppings:
        amp, i, j = np.asarray(hop[0], dtype=complex), hop[1], hop[2]
        h[i, :, j, :] += amp
        h[j, :, i, :] += amp.conj().T
    return h.reshape(2 * norb, 2 * norb)


def _uvec(U, norb):
    Uvec = np.asarray(U, dtype=float)
    if Uvec.ndim == 0:
        Uvec = np.full(norb, float(Uvec))
    if Uvec.shape != (norb,):
        raise PythtbError("ed: U must be a scalar or a length-norb vector")
    return Uvec


class EDResult:
    """Sector eigendecomposition plus enough basis machinery for
    observables.  ``evals``/``evecs`` follow the package convention
    (ascending, rows are states); ``energy`` / ``gap`` are the usual
    scalars; observables act on the ground state by default."""

    def __init__(self, kind, evals, evecs, norb, meta):
        self.kind = kind
        self.evals = evals
        self.evecs = evecs
        self.norb = norb
        self._meta = meta

    @property
    def energy(self):
        return float(self.evals[0])

    @property
    def gap(self):
        return float(self.evals[1] - self.evals[0]) if len(self.evals) > 1 else np.inf

    @property
    def ground(self):
        return self.evecs[0]

    @property
    def dim(self):
        return len(self.evals)

    # -- product-layout helpers -----------------------------------------

    def _prod_shapes(self):
        bu, bd = self._meta["basis_up"], self._meta["basis_dn"]
        return bu, bd, len(bu), len(bd)

    def _rdm_species(self, psi, up):
        """(norb, norb) <c^dag_i c_j> for one species, product layout."""
        bu, bd, Du, Dd = self._prod_shapes()
        psi2 = psi.reshape(Du, Dd)
        n = self.norb
        rdm = np.zeros((n, n), dtype=complex)
        basis = bu if up else bd
        for i in range(n):
            for j in range(n):
                valid, new, sign = _apply_cdc(basis, i, j)
                src = np.nonzero(valid)[0]
                if len(src) == 0:
                    continue
                dst = np.searchsorted(basis, new[src])
                if up:
                    rdm[i, j] = np.sum(
                        sign[src, None]
                        * np.conj(psi2[dst, :])
                        * psi2[src, :]
                    )
                else:
                    rdm[i, j] = np.sum(
                        sign[None, src]
                        * np.conj(psi2[:, dst])
                        * psi2[:, src]
                    )
        return rdm

    # -- observables ----------------------------------------------------

    def one_body_rdm(self, state=0):
        """One-body reduced density matrix ``<c^dag_a c_b>``.

        Product layout: returns ``(2, norb, norb)`` (up, dn).  General
        layout: ``(nmodes, nmodes)``.
        """
        psi = self.evecs[state]
        if self.kind == "product":
            return np.stack(
                [self._rdm_species(psi, True), self._rdm_species(psi, False)]
            )
        basis = self._meta["basis"]
        M = self._meta["nmodes"]
        rdm = np.zeros((M, M), dtype=complex)
        for a in range(M):
            for b in range(M):
                valid, new, sign = _apply_cdc(basis, a, b)
                src = np.nonzero(valid)[0]
                if len(src) == 0:
                    continue
                dst = np.searchsorted(basis, new[src])
                rdm[a, b] = np.sum(sign[src] * np.conj(psi[dst]) * psi[src])
        return rdm

    def densities(self, state=0):
        """Per-orbital per-spin densities.  Product layout and spinful
        general layout: (2, norb) [up, dn]; spinless general: (norb,)."""
        psi = np.abs(self.evecs[state]) ** 2
        if self.kind == "product":
            bu, bd, Du, Dd = self._prod_shapes()
            p2 = psi.reshape(Du, Dd)
            nu = _occupations(bu, self.norb)
            nd = _occupations(bd, self.norb)
            return np.stack(
                [p2.sum(axis=1) @ nu, p2.sum(axis=0) @ nd]
            )
        occ = _occupations(self._meta["basis"], self._meta["nmodes"])
        dens = psi @ occ
        if self._meta.get("spinful"):
            return np.stack([dens[0::2], dens[1::2]])
        return dens

    def double_occupancy(self, state=0):
        """Per-site ``<n_up n_dn>`` (interaction-basis pairing)."""
        psi = np.abs(self.evecs[state]) ** 2
        if self.kind == "product":
            bu, bd, Du, Dd = self._prod_shapes()
            p2 = psi.reshape(Du, Dd)
            nu = _occupations(bu, self.norb)
            nd = _occupations(bd, self.norb)
            return np.einsum("ud,ui,di->i", p2, nu, nd)
        if not self._meta.get("spinful"):
            raise PythtbError("double_occupancy needs a spinful layout")
        occ = _occupations(self._meta["basis"], self._meta["nmodes"])
        return psi @ (occ[:, 0::2] * occ[:, 1::2])

    def szsz(self, state=0):
        """(norb, norb) matrix of ``<S^z_i S^z_j>``."""
        psi = np.abs(self.evecs[state]) ** 2
        if self.kind == "product":
            bu, bd, Du, Dd = self._prod_shapes()
            p2 = psi.reshape(Du, Dd)
            nu = _occupations(bu, self.norb)  # (Du, n)
            nd = _occupations(bd, self.norb)
            # S^z_i = (n_iu - n_id) / 2; the up/dn parts live on
            # different tensor factors so the expectation splits
            uu = np.einsum("ud,ui,uj->ij", p2, nu, nu)
            dd = np.einsum("ud,di,dj->ij", p2, nd, nd)
            ud = np.einsum("ud,ui,dj->ij", p2, nu, nd)
            return 0.25 * (uu + dd - ud - ud.T)
        if not self._meta.get("spinful"):
            raise PythtbError("szsz needs a spinful layout")
        occ = _occupations(self._meta["basis"], self._meta["nmodes"])
        sz = 0.5 * (occ[:, 0::2] - occ[:, 1::2])  # (D, norb)
        return np.einsum("d,di,dj->ij", psi, sz, sz)

    def total_spin(self, state=0):
        """Total-spin quantum number s with <S^2> = s (s + 1).

        Product layout only (uses ``S^2 = S^- S^+ + S^z (S^z + 1)``:
        apply ``S^+`` into the (nup+1, ndn-1) sector and take the
        norm)."""
        if self.kind != "product":
            raise PythtbError("total_spin: product layout only")
        bu, bd, Du, Dd = self._prod_shapes()
        nup, ndn = self._meta["nup"], self._meta["ndn"]
        psi = self.evecs[state].reshape(Du, Dd)
        sz = 0.5 * (nup - ndn)
        if ndn == 0 or nup == self.norb:
            s2 = sz * (sz + 1.0)
        else:
            bu2 = sector_basis(self.norb, nup + 1)
            bd2 = sector_basis(self.norb, ndn - 1)
            out = np.zeros((len(bu2), len(bd2)), dtype=complex)
            for i in range(self.norb):
                # S^+ = sum_i c^dag_iu c_id ; the dn annihilation sees
                # the full up block earlier in mode order -> (-1)^nup
                vd, newd, sd = _apply_c(bd, i)
                vu, newu, su = _apply_cdag(bu, i)
                if not (vd.any() and vu.any()):
                    continue
                srcd = np.nonzero(vd)[0]
                srcu = np.nonzero(vu)[0]
                dstd = np.searchsorted(bd2, newd[srcd])
                dstu = np.searchsorted(bu2, newu[srcu])
                amp = (
                    (su[srcu, None] * sd[None, srcd])
                    * psi[np.ix_(srcu, srcd)]
                )
                np.add.at(out, np.ix_(dstu, dstd), amp)
            if nup % 2:
                out = -out
            s2 = float(np.sum(np.abs(out) ** 2)) + sz * (sz + 1.0)
        return 0.5 * (-1.0 + np.sqrt(1.0 + 4.0 * s2))


def hubbard(model, U, nup, ndn, lowest=None):
    """ED of a finite ``nspin == 1`` model with Hubbard U in the
    ``(N_up, N_dn)`` sector (product layout).

    Returns an :class:`EDResult`.  The tests pin this against the
    general layout (:func:`solve`), the analytic Hubbard dimer, and
    the U = 0 free-fermion filling identity.

    ``lowest``: compute only the k lowest eigenpairs by the
    Chebyshev-filtered subspace iteration instead of the full dense
    eigh (see :func:`solve_sector`) -- the large-sector path.  The result's spectrum is
    then partial (ground-state observables exact, thermal traces
    unavailable).
    """
    if model._nspin != 1:
        raise PythtbError(
            "ed.hubbard: product layout needs an nspin == 1 model; "
            "use ed.solve for explicit-spin models"
        )
    h = dense_h(model)
    norb = h.shape[0]
    Uvec = _uvec(U, norb)
    bu = sector_basis(norb, nup)
    bd = sector_basis(norb, ndn)
    Du, Dd = len(bu), len(bd)
    if Du * Dd > _MAX_DIM:
        raise PythtbError(
            "ED sector dimension %d exceeds %d" % (Du * Dd, _MAX_DIM)
        )
    Tu = build_sector(h, bu)
    Td = build_sector(h, bd)
    H = np.kron(Tu, np.eye(Dd)) + np.kron(np.eye(Du), Td)
    nu = _occupations(bu, norb)
    nd = _occupations(bd, norb)
    H[np.diag_indices(Du * Dd)] += np.einsum(
        "ui,i,di->ud", nu, Uvec, nd
    ).reshape(-1)
    evals, evecs = solve_sector(H, lowest=lowest)
    return EDResult(
        "product",
        evals,
        evecs,
        norb,
        {"basis_up": bu, "basis_dn": bd, "nup": nup, "ndn": ndn, "h": h,
         "Uvec": Uvec},
    )


def _general_setup(model, U, interactions, spinful):
    """(h_modes, vmat, nmodes, spinful_flag) for the general layout."""
    h = dense_h(model)
    norb = model._norb
    if model._nspin == 2:
        spinful = True
        nmodes = 2 * norb
        hm = h
    elif spinful or (np.max(np.abs(np.asarray(U))) > 0):
        spinful = True
        nmodes = 2 * norb
        hm = np.zeros((nmodes, nmodes), dtype=complex)
        hm[0::2, 0::2] = h
        hm[1::2, 1::2] = h
    else:
        nmodes = norb
        hm = h
    vmat = np.zeros((nmodes, nmodes))
    if np.max(np.abs(np.asarray(U))) > 0:
        Uvec = _uvec(U, norb)
        for i in range(norb):
            vmat[2 * i, 2 * i + 1] += Uvec[i]
            vmat[2 * i + 1, 2 * i] += Uvec[i]
    if interactions is not None:
        for V, i, j in interactions:
            if i == j:
                raise PythtbError(
                    "ed: diagonal density-density terms are one-body "
                    "(n^2 = n); use set_onsite"
                )
            if spinful:
                # orbital densities n_i = n_iu + n_id
                for si in (0, 1):
                    for sj in (0, 1):
                        vmat[2 * i + si, 2 * j + sj] += V
                        vmat[2 * j + sj, 2 * i + si] += V
            else:
                vmat[i, j] += V
                vmat[j, i] += V
    return hm, vmat, nmodes, spinful


def solve(model, nelec, U=0.0, interactions=None, spinful=False,
          lowest=None):
    """ED of a finite model in the total-``nelec`` sector (general
    layout: one global mode set, arbitrary spin structure).

    ``interactions``: iterable of ``(V, i, j)`` density-density terms
    between *orbital* densities (summed over spin when spinful).
    ``spinful=True`` forces the spin-doubled mode set for nspin == 1
    models even at U = 0 (for cross-sector consistency).
    ``lowest``: k-lowest-only filtered subspace iteration (see
    :func:`solve_sector`).
    """
    hm, vmat, nmodes, spinful = _general_setup(model, U, interactions, spinful)
    basis = sector_basis(nmodes, nelec)
    H = build_sector(hm, basis, vmat if np.any(vmat) else None)
    evals, evecs = solve_sector(H, lowest=lowest)
    return EDResult(
        "general",
        evals,
        evecs,
        model._norb,
        {"basis": basis, "nmodes": nmodes, "spinful": spinful, "h": hm,
         "vmat": vmat, "nelec": nelec},
    )


def ground_state(model, nelec, U=0.0, interactions=None):
    """Lowest state over all sectors with ``nelec`` electrons.

    For nspin == 1 models this scans the ``(nup, ndn)`` splits in the
    product layout (using the h_up == h_dn symmetry to skip mirrored
    splits); for nspin == 2 models the general total-N sector already
    contains every split.  Returns the winning :class:`EDResult`.
    """
    if model._nspin == 2:
        return solve(model, nelec, U=U, interactions=interactions)
    if interactions is not None:
        raise PythtbError(
            "ground_state: density-density interactions need the "
            "general layout; call ed.solve per sector"
        )
    norb = model._norb
    best = None
    for nup in range((nelec + 1) // 2, min(nelec, norb) + 1):
        ndn = nelec - nup
        if ndn < 0 or ndn > norb or nup > norb:
            continue
        r = hubbard(model, U, nup, ndn)
        if best is None or r.energy < best.energy - 1e-12:
            best = r
    if best is None:
        raise PythtbError("ground_state: no valid (nup, ndn) split")
    return best


# ---------------------------------------------------------------------------
# dynamical responses (general layout)


def _lorentz_sum(amps, poles, omegas, eta):
    """sum_n amps_n / (omega - poles_n + i eta), batched over omega: kernel
    16's Lorentzian mode with one column (W = amps, de = poles); host
    complex (nomega,)."""
    dev = config.checked_device()
    W = torch.as_tensor(np.ascontiguousarray(np.asarray(amps, dtype=complex)[None, :])).to(dev)
    de = torch.as_tensor(np.ascontiguousarray(poles, dtype=np.float64)).to(dev)
    om = torch.as_tensor(np.ascontiguousarray(omegas, dtype=np.float64)).to(dev)
    return _host(spectral_sum(W, de, om, float(eta), "lorentz")[0])


def _apply_one_body(psi, basis_from, basis_to, A):
    """(A psi) for a one-body operator matrix A on the general layout;
    ``basis_to`` may differ (it must equal ``basis_from`` here -- the
    split argument exists for clarity at call sites)."""
    out = np.zeros(len(basis_to), dtype=complex)
    for a, b in np.array(np.nonzero(A)).T:
        valid, new, sign = _apply_cdc(basis_from, int(a), int(b))
        src = np.nonzero(valid)[0]
        if len(src) == 0:
            continue
        dst = np.searchsorted(basis_to, new[src])
        np.add.at(out, dst, A[a, b] * sign[src] * psi[src])
    return out


def spectral_function(model, nelec, omegas, U=0.0, eta=0.05,
                      interactions=None, modes=None):
    """Local one-particle spectral functions ``A_m(omega)`` of the
    interacting ground state (Lehmann representation over the N +- 1
    sectors; general layout).

    Returns ``(A, info)`` with ``A`` of shape (nmodes_kept, nomega);
    ``modes`` selects which fermionic modes to compute (default: all).
    Energies are measured from the N-particle ground state, i.e. the
    particle poles sit at ``E_n(N+1) - E_0(N)`` and the hole poles at
    ``E_0(N) - E_n(N-1)`` (no chemical-potential shift is applied).
    """
    base = solve(model, nelec, U=U, interactions=interactions, spinful=True)
    basis = base._meta["basis"]
    M = base._meta["nmodes"]
    hm, vmat = base._meta["h"], base._meta["vmat"]
    vuse = vmat if np.any(vmat) else None
    psi0 = base.ground
    e0 = base.energy
    if modes is None:
        modes = list(range(M))
    omegas = np.asarray(omegas, dtype=float)
    A = np.zeros((len(modes), len(omegas)))

    for side in (+1, -1):
        n2 = nelec + side
        if n2 < 0 or n2 > M:
            continue
        b2 = sector_basis(M, n2)
        w2, v2 = solve_sector(build_sector(hm, b2, vuse))
        for mi, m in enumerate(modes):
            if side == +1:
                valid, new, sign = _apply_cdag(basis, m)
            else:
                valid, new, sign = _apply_c(basis, m)
            src = np.nonzero(valid)[0]
            phi = np.zeros(len(b2), dtype=complex)
            if len(src):
                dst = np.searchsorted(b2, new[src])
                phi[dst] = sign[src] * psi0[src]
            amps = np.abs(v2.conj() @ phi) ** 2  # |<n|c(dag)_m|0>|^2
            poles = side * (w2 - e0)
            g = _lorentz_sum(amps.astype(complex), poles, omegas, eta)
            A[mi] += -np.imag(g) / np.pi
    return A, {"e0": e0, "nelec": nelec}


def dynamic_susceptibility(model, nelec, A, B, omegas, U=0.0, eta=0.05,
                           interactions=None, spinful=True):
    """Retarded correlation function ``chi_AB(omega) =
    <<A; B>>_omega`` of one-body operators in the interacting ground
    state (general layout, full Lehmann sum):

    ``chi(omega) = sum_n [ <0|A|n><n|B|0> / (omega - w_n + i eta)
                         - <0|B|n><n|A|0> / (omega + w_n + i eta) ]``

    with ``w_n = E_n - E_0``.  ``A`` and ``B`` are nmodes x nmodes
    one-body matrices (mode ordering ``2*orb + spin`` when spinful).

    The U = 0 case is the package's finite-cluster Lindhard oracle --
    see ``tests/test_response.py``.
    """
    base = solve(model, nelec, U=U, interactions=interactions,
                 spinful=spinful)
    basis = base._meta["basis"]
    psi0 = base.ground
    wn = base.evals - base.energy
    V = base.evecs  # rows are states
    A = np.asarray(A, dtype=complex)
    B = np.asarray(B, dtype=complex)
    an = V.conj() @ _apply_one_body(psi0, basis, basis, A)   # <n|A|0>
    bn = V.conj() @ _apply_one_body(psi0, basis, basis, B)   # <n|B|0>
    adn = V.conj() @ _apply_one_body(psi0, basis, basis, A.conj().T)
    bdn = V.conj() @ _apply_one_body(psi0, basis, basis, B.conj().T)
    omegas = np.asarray(omegas, dtype=float)
    # <0|A|n> = conj(<n|A^dag|0>)
    chi = _lorentz_sum(np.conj(adn) * bn, wn, omegas, eta)
    chi -= _lorentz_sum(np.conj(bdn) * an, -wn, omegas, eta)
    return chi

# ---------------------------------------------------------------------------
# twisted boundary conditions: many-body topology (Niu-Thouless-Wu)
#
# Threading a twist angle theta_d through handle d of a glued torus
# multiplies every hop that wraps the boundary (wrap vector w, the
# integer number of times the hop crosses each handle) by
# e^{+i theta . w} (the sign that makes the U = 0 twist-torus Chern
# number equal the package band Chern number -- pinned by test).
# Because the twist enters ONLY through those
# phases, the twisted many-body Hamiltonian is a trigonometric
# polynomial in theta,
#
#   H(theta) = H_0 + sum_w [ cos(theta.w) A_w + sin(theta.w) B_w ],
#
# with H_0 (untwisted + interactions; density-density terms are
# twist-neutral), A_w = M_w + M_w^dag and B_w = -i (M_w - M_w^dag)
# fixed Hermitian many-body matrices built once per wrap class.  The
# whole twist grid is formed on the device from them (the same
# phases-linear-in-parameter trick as magnetic.hofstadter_fn), one row of
# the grid at a time so peak memory is grid * D^2, not grid^2 * D^2.
#
# The reference has no many-body machinery at all; this section is the
# interacting bridge to its Berry-phase suite (pythtb.py:2863-3068):
# at U = 0 the twist-torus plaquette Chern number equals the filled
# single-particle band Chern number exactly (tested), and it stays
# quantized under interactions as long as the ground multiplet stays
# gapped (Niu, Thouless & Wu, PRB 31, 3372 (1985)).



def _torus_onebody(model, supercell):
    """Glued-torus one-body Hamiltonian grouped by boundary wrap class.

    Returns ``(m0, wraps, mats, fracpos, nsites)``: ``m0`` the
    (nsites[, 2, 2]-blocked -> flattened) Hermitian untwisted matrix,
    ``wraps`` a list of canonical nonzero wrap vectors (tuples),
    ``mats`` the raw (non-Hermitian) hop matrix per wrap class (its
    Hermitian partner carries wrap ``-w`` and is NOT stored), and
    ``fracpos`` the (nsites, dim) site positions in supercell-fraction
    units (for Resta polarization).  Site index = cell*norb + orb,
    cell-major like :func:`pythtb_tpu.realspace.torus_sample`; spinful
    models are flattened to mode = 2*site + spin afterwards by the
    caller.
    """
    if model._dim_k != model._dim_r or model._dim_k < 1:
        raise PythtbError(
            "ed twists need a fully periodic model (dim_k == dim_r >= 1)"
        )
    dim = model._dim_r
    L = tuple(int(x) for x in np.atleast_1d(supercell))
    if len(L) != dim or any(x < 1 for x in L):
        raise PythtbError(
            "supercell must give a positive cell count per periodic "
            "direction (got %r for dim %d)" % (supercell, dim)
        )
    norb = model._norb
    nspin = model._nspin
    ncells = int(np.prod(L))
    nsites = norb * ncells
    cells = np.indices(L).reshape(dim, ncells).T  # (ncells, dim)
    Larr = np.array(L)

    blk = (2, 2) if nspin == 2 else ()

    def zeros():
        return np.zeros((nsites, nsites) + blk, dtype=complex)

    m0 = zeros()
    for i in range(norb):
        ons = np.asarray(model._site_energies[i], dtype=complex)
        for c in range(ncells):
            s = c * norb + i
            m0[s, s] += ons if nspin == 1 else ons * np.eye(2) if np.ndim(ons) == 0 else ons

    wrap_mats = {}
    for hop in model._hoppings:
        amp = np.asarray(hop[0], dtype=complex)
        i, j, R = hop[1], hop[2], np.asarray(hop[3], dtype=np.int64)
        tgt = cells + R  # (ncells, dim)
        w_all = np.floor_divide(tgt, Larr)
        tcell = np.mod(tgt, Larr)
        tidx = np.ravel_multi_index(tuple(tcell.T), L)
        for c in range(ncells):
            row = c * norb + i
            col = tidx[c] * norb + j
            w = tuple(int(x) for x in w_all[c])
            if all(x == 0 for x in w):
                m0[row, col] += amp
                m0[col, row] += amp.conj().T if nspin == 2 else np.conj(amp)
                continue
            # canonical representative: first nonzero component > 0;
            # the flipped entry is the Hermitian partner under -w
            if next(x for x in w if x != 0) < 0:
                w = tuple(-x for x in w)
                r2, c2 = col, row
                a2 = amp.conj().T if nspin == 2 else np.conj(amp)
            else:
                r2, c2, a2 = row, col, amp
            if w not in wrap_mats:
                wrap_mats[w] = zeros()
            wrap_mats[w][r2, c2] += a2

    def flatten(M):
        if nspin == 1:
            return M
        return np.transpose(M, (0, 2, 1, 3)).reshape(2 * nsites, 2 * nsites)

    wraps = sorted(wrap_mats.keys())
    mats = [flatten(wrap_mats[w]) for w in wraps]
    orb = np.asarray(model._orb, dtype=np.float64)
    fracpos = ((cells[:, None, :] + orb[None, :, :]) / Larr).reshape(
        nsites, dim
    )
    return flatten(m0), wraps, mats, fracpos, nsites


def _torus_vmat(interactions, u, L, norb, nspin, spinful):
    """Density-density matrix on the glued torus in MODE space.

    ``interactions``: iterable of ``(V, i, j, R)`` -- V n_i(c) n_j(c+R)
    tiled over every cell c with periodic wrap (density-density terms
    are twist-neutral, so wraps carry no phase here).  ``u``: Hubbard U
    per site between up/dn modes (needs a spinful mode set).
    """
    dim = len(L)
    ncells = int(np.prod(L))
    nsites = norb * ncells
    nmodes = 2 * nsites if (nspin == 2 or spinful) else nsites
    vmat = np.zeros((nmodes, nmodes))
    uarr = np.max(np.abs(np.asarray(u)))
    if uarr > 0:
        if nmodes == nsites:
            raise PythtbError("ed twists: Hubbard u needs spinful=True")
        Uvec = _uvec(u, norb)
        for c in range(ncells):
            for i in range(norb):
                s = c * norb + i
                vmat[2 * s, 2 * s + 1] += Uvec[i]
                vmat[2 * s + 1, 2 * s] += Uvec[i]
    if interactions is None:
        return vmat if np.any(vmat) else None
    cells = np.indices(L).reshape(dim, ncells).T
    Larr = np.array(L)
    for term in interactions:
        V, i, j = float(term[0]), int(term[1]), int(term[2])
        R = np.asarray(term[3], dtype=np.int64)
        tcell = np.mod(cells + R, Larr)
        tidx = np.ravel_multi_index(tuple(tcell.T), L)
        for c in range(ncells):
            sa = c * norb + i
            sb = tidx[c] * norb + j
            if sa == sb:
                raise PythtbError(
                    "ed twists: interaction (%g, %d, %d, %r) maps a site "
                    "onto itself on this supercell (n^2 = n is one-body)"
                    % (V, i, j, tuple(R))
                )
            if nmodes == nsites:
                vmat[sa, sb] += V
                vmat[sb, sa] += V
            else:
                for si in (0, 1):
                    for sj in (0, 1):
                        vmat[2 * sa + si, 2 * sb + sj] += V
                        vmat[2 * sb + sj, 2 * sa + si] += V
    return vmat if np.any(vmat) else None


def _twist_setup(model, supercell, nelec, u, interactions, spinful):
    """Shared builder: many-body H_0 and per-wrap (A_w, B_w) matrices.

    Returns ``(H0, wraps, A_mb, B_mb, basis, fracpos_modes)``.
    """
    m0, wraps, mats, fracpos, nsites = _torus_onebody(model, supercell)
    L = tuple(int(x) for x in np.atleast_1d(supercell))
    spinful = bool(spinful) or model._nspin == 2 or (
        np.max(np.abs(np.asarray(u))) > 0
    )
    if model._nspin == 1 and spinful:
        def double(M):
            out = np.zeros((2 * nsites, 2 * nsites), dtype=complex)
            out[0::2, 0::2] = M
            out[1::2, 1::2] = M
            return out

        m0 = double(m0)
        mats = [double(M) for M in mats]
        fracpos = np.repeat(fracpos, 2, axis=0)
    elif model._nspin == 2:
        fracpos = np.repeat(fracpos, 2, axis=0)
    nmodes = m0.shape[0]
    if nmodes > 63:
        raise PythtbError(
            "ed twists: %d fermionic modes exceed the 63-bit basis "
            "limit; use a smaller supercell" % nmodes
        )
    vmat = _torus_vmat(interactions, u, L, model._norb, model._nspin,
                       spinful)
    basis = sector_basis(nmodes, nelec)
    H0 = build_sector(m0, basis, vmat)
    A_mb, B_mb = [], []
    for M in mats:
        # e^{+i phi} M + e^{-i phi} M^dag = cos(phi) A + sin(phi) B
        A_mb.append(build_sector(M + M.conj().T, basis))
        B_mb.append(build_sector(1j * (M - M.conj().T), basis))
    return H0, wraps, A_mb, B_mb, basis, fracpos


def _twist_operators(H0, A_mb, B_mb):
    """The twist operators on the device: H0 (D, D), A and B (nw, D, D)."""
    return _upload(H0), _upload(np.stack(A_mb)), _upload(np.stack(B_mb))


def _twisted(H0, A, B, phi):
    """H(phi) = H0 + sum_w [cos(phi_w) A_w + sin(phi_w) B_w] for a batch of
    phases phi (G, nw): (G, D, D)."""
    cw = torch.cos(phi).to(config.COMPLEX)
    sw = torch.sin(phi).to(config.COMPLEX)
    return (H0[None] + torch.einsum("bw,wij->bij", cw, A)
            + torch.einsum("bw,wij->bij", sw, B))


def _closed(states, axes):
    """Append the first slice of each grid axis in ``axes`` after the last:
    the theta = 2 pi points, which equal theta = 0 (same matrix, same
    gauge)."""
    for ax in axes:
        states = torch.cat([states, states.narrow(ax, 0, 1)], dim=ax)
    return states.contiguous()


def _twist_chern(H0, A, B, wvecs, grid, q):
    """Plaquette many-body Chern number over a (grid x grid) twist torus:
    rows of the grid solved by ``eigh_batched`` one theta_x at a time (peak
    memory grid * D^2, as the JAX program's lax.map), the lowest-``q``
    multiplet's link determinants by kernel 3 and the plaquette sum by
    kernel 4 on the closed grid.  Returns ``(chern, min_gap)``."""
    th = torch.as_tensor((2.0 * np.pi / grid) * np.arange(grid, dtype=np.float64)).to(H0.device)
    ws, vs = [], []
    for tx in th:
        phi = tx * wvecs[None, :, 0] + th[:, None] * wvecs[None, :, 1]
        w, v = eigh_batched(_twisted(H0, A, B, phi))
        ws.append(w[:, : q + 1])
        vs.append(v[:, :q, :])
    ws = torch.stack(ws)  # (g, g, q+1)
    vs = _closed(torch.stack(vs), (0, 1))  # (g+1, g+1, q, D)
    min_gap = float(torch.min(ws[..., q] - ws[..., q - 1]))
    # plaquette_flux's orientation is the package convention, which the
    # JAX program reaches by negating its raw sum (ed.py:1170-1173)
    flux, _ = plaquette_flux(link_dets(vs, 0), link_dets(vs, 1))
    return float(flux) / (2.0 * np.pi), min_gap


def _twist_phase(H0, A, B, wvec, grid):
    """Many-body Berry phase of the ground state around one twist handle:
    the grid points solved by ``eigh_batched``, the links of the closed
    loop by kernel 3.  Returns ``(phase, min_gap)``."""
    th = torch.as_tensor((2.0 * np.pi / grid) * np.arange(grid, dtype=np.float64)).to(H0.device)
    w, v = eigh_batched(_twisted(H0, A, B, th[:, None] * wvec[None, :]))
    links = link_dets(_closed(v[:, :1, :], (0,)), 0)  # (grid,)
    phase = -float(torch.sum(torch.angle(links)))
    return phase, float(torch.min(w[:, 1] - w[:, 0]))


def many_body_chern(model, supercell, nelec, u=0.0, interactions=None,
                    spinful=False, grid=6, multiplet=1, gap_tol=1e-8):
    """Many-body Chern number of an interacting ground multiplet by
    twisted boundary conditions (Niu-Thouless-Wu).

    The model is glued onto an ``L1 x L2`` torus (``supercell``) and
    the ``nelec``-particle ground multiplet (lowest ``multiplet``
    states; use > 1 for topologically degenerate phases) is tracked
    over a ``grid x grid`` mesh of twist angles; the result is the
    lattice-gauge plaquette Chern number of that rank-``multiplet``
    bundle -- exactly integer by construction, and exactly the filled
    single-particle band Chern number at ``u = 0`` (tested against
    :func:`pythtb_tpu.flows.chern_number`).

    ``interactions``: iterable of ``(V, i, j, R)`` density-density
    terms ``V n_i(c) n_j(c+R)`` tiled over the torus.  ``u``: Hubbard U
    (forces the spin-doubled mode set for nspin == 1 models).

    Emits a warning when the multiplet is not gapped everywhere on the
    twist torus (splitting to state ``multiplet`` below ``gap_tol``):
    the invariant is then undefined.

    Beyond-reference capability (the reference is single-particle
    only); the twist machinery itself mirrors its flux-insertion
    discussion for Berry phases (pythtb.py:2863-3068).
    """
    if model._dim_r != 2 or model._dim_k != 2:
        raise PythtbError("many_body_chern: needs a 2-D periodic model")
    q = int(multiplet)
    if q < 1:
        raise PythtbError("many_body_chern: multiplet must be >= 1")
    H0, wraps, A_mb, B_mb, basis, _ = _twist_setup(
        model, supercell, nelec, u, interactions, spinful
    )
    D = len(basis)
    if q + 1 > D:
        raise PythtbError("many_body_chern: multiplet+1 exceeds sector dim")
    if not wraps:
        raise PythtbError(
            "many_body_chern: no boundary-wrapping hops on this "
            "supercell (model has no hoppings?)"
        )
    H0d, A, B = _twist_operators(H0, A_mb, B_mb)
    wv = torch.as_tensor(np.asarray(wraps, dtype=np.float64)).to(H0d.device)
    c, gap = _twist_chern(H0d, A, B, wv, int(grid), q)
    if float(gap) < gap_tol:
        warnings.warn(
            "many_body_chern: ground multiplet not gapped on the twist "
            "torus (min splitting %.2e); the invariant is undefined -- "
            "increase multiplet or move away from the transition"
            % float(gap), stacklevel=2)
    return float(c)


def twist_berry_phase(model, supercell, nelec, direction=0, u=0.0,
                      interactions=None, spinful=False, grid=12,
                      gap_tol=1e-8):
    """Many-body Berry phase of the interacting ground state as one
    twist angle winds 0 -> 2 pi (flux insertion through handle
    ``direction`` of the glued torus).

    This is the interacting generalization of the reference's
    Berry-phase polarization (pythtb.py:2863-3067): at ``u = 0`` on an
    ``(L,)`` ring it reproduces the occupied-band Wilson loop on the
    L-point k-grid, and with inversion symmetry it stays quantized to
    {0, pi} under interactions (tested on interacting SSH).  Returned
    in (-pi, pi] like ``wf_array.berry_phase``.
    """
    d = int(direction)
    H0, wraps, A_mb, B_mb, basis, _ = _twist_setup(
        model, supercell, nelec, u, interactions, spinful
    )
    if len(basis) < 2:
        raise PythtbError("twist_berry_phase: sector dimension < 2")
    if not wraps:
        raise PythtbError("twist_berry_phase: no boundary-wrapping hops")
    H0d, A, B = _twist_operators(H0, A_mb, B_mb)
    wv = torch.as_tensor(np.asarray(wraps, dtype=np.float64)[:, d]).to(H0d.device)
    phase, gap = _twist_phase(H0d, A, B, wv, int(grid))
    if float(gap) < gap_tol:
        warnings.warn(
            "twist_berry_phase: ground state not gapped along the twist "
            "loop (min gap %.2e); the phase is undefined" % float(gap),
            stacklevel=2)
    return float((phase + np.pi) % (2.0 * np.pi) - np.pi)


def resta_polarization(model, supercell, nelec, direction=0, u=0.0,
                       interactions=None, spinful=False):
    """Many-body electronic polarization by Resta's twist-free formula
    ``P = (1 / 2 pi) Im log <e^{2 pi i X / L}>`` on the glued torus
    (X = position operator along ``direction`` in cell units).

    The expectation is diagonal in the Fock basis, so this costs one
    untwisted ground-state solve.  At ``u = 0`` the Slater-determinant
    identity ``<e^{2 pi i X / L}> = det(U_occ^dag D U_occ)`` (D the
    single-particle phase operator) makes this EXACTLY the discrete
    position-convention (Convention-II) Wilson loop on the L-point
    grid -- an algebraic identity, tested at 1e-12.  Note the orbital
    embedding enters (unlike :func:`twist_berry_phase`): inversion
    quantizes P only up to the embedding offset (SSH with orbitals at
    0 and 1/2 reads +-1/4, and the topological-trivial DIFFERENCE is
    the quantized 1/2).  Returned in [-1/2, 1/2) cell units.
    """
    H0, wraps, A_mb, B_mb, basis, fracpos = _twist_setup(
        model, supercell, nelec, u, interactions, spinful
    )
    evals, evecs = solve_sector(H0)
    psi2 = np.abs(evecs[0]) ** 2
    occ = _occupations(basis, len(fracpos))
    X = occ @ fracpos[:, int(direction)]  # per-Fock-state total position
    z = np.sum(psi2 * np.exp(2j * np.pi * X))
    if abs(z) < 1e-12:
        warnings.warn(
            "resta_polarization: |<e^{2 pi i X/L}>| ~ 0 (metallic or "
            "too-small torus); the phase is undefined", stacklevel=2)
    p = np.angle(z) / (2.0 * np.pi)
    return float((p + 0.5) % 1.0 - 0.5)
