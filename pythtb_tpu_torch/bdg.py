"""Bogoliubov-de Gennes superconductors: Nambu models, Majorana
numbers, BdG topology (counterpart of ``pythtb_tpu.bdg``: host code that
builds this package's :class:`tb_model`).

Beyond-reference capability: :func:`bdg_model` doubles any
``nspin == 1`` tight-binding model into its Nambu (particle-hole)
form as a plain :class:`tb_model` -- so the ENTIRE existing machinery
composes with superconductivity for free: ``flows.chern_number``
gives the BdG Chern number, ``cut_piece`` exposes Majorana edge/end
modes, ``surface.spectral_function`` resolves chiral Majorana edge
dispersions, ``negf`` transports through superconducting regions.

Basis and conventions (pinned by the oracle tier in
``tests/test_bdg.py``):

* Nambu spinor ``Psi = (c_1..c_n, c^dag_1..c^dag_n)`` ("spinless" /
  triplet case) or ``(c_up, c^dag_dn)`` (singlet reduction); orbitals
  ``0..n-1`` are particles, ``n..2n-1`` holes at the same positions;
* ``H_BdG(k) = [[h(k) - mu, Delta(k)], [Delta(k)^H, -conj(h(-k)) + mu]]``
  -- the hole block is realized through the hop table as
  ``-conj(amp)`` per hop, which the Convention-I phase machinery turns
  into exactly ``-conj(h(-k))``;
* pairing bonds ``Delta_ij(R)`` are supplied once;
  ``pairing="triplet"`` auto-adds the antisymmetric partner
  ``Delta_ji(-R) = -Delta_ij(R)`` (spinless superconductor; onsite
  pairing forbidden), ``pairing="singlet"`` adds the symmetric
  partner (s-wave/extended-s in the (up, dn) reduction);
* particle-hole symmetry is verified BY CONSTRUCTION at build time:
  ``tau_x H(-k)^* tau_x = -H(k)`` for triplet pairing (checked at
  random k; a violation raises immediately rather than producing
  silently wrong invariants).

1-D topology: the Kitaev Z2 invariant (Majorana number) is computed
from Pfaffians of the Majorana-basis Hamiltonian at the
particle-hole-symmetric momenta,

``M = sign( Pf[A(0)] Pf[A(pi)] )``,   ``H(k) = (i/4) Gamma^T A Gamma``

with A real antisymmetric (Kitaev 2001).  The Pfaffian is evaluated
via the real Schur form (product of the 2x2 block superdiagonals
times det Q) -- and tested against an independent identity
``Pf(A)^2 = det(A)`` plus the analytic Kitaev phase diagram
(``M = -1`` iff ``|mu| < 2|t|``) and the exponential end-mode
splitting of open chains.
"""

from __future__ import annotations

import numpy as np

from .model import PythtbError, tb_model

__all__ = ["bdg_model", "majorana_number", "pfaffian", "kitaev_chain"]


def bdg_model(model, mu=0.0, delta=None, pairing="triplet", verify=True):
    """Nambu-doubled BdG model.

    :param model: ``nspin == 1`` tb_model (the normal-state h)
    :param mu: chemical potential (scalar or per-orbital)
    :param delta: pairing bonds, iterable of ``(amp, i, j, R)`` (R
      omitted or None for finite models / onsite); each physical bond
      once -- the symmetry partner is added per ``pairing``
    :param pairing: "triplet" (spinless antisymmetric; onsite raises)
      or "singlet" (symmetric, (c_up, c^dag_dn) reduction)
    :param verify: check particle-hole symmetry of the assembled
      Bloch matrix at random k (raises on violation)
    :returns: tb_model with ``2 norb`` orbitals (particles first)

    The BdG energy double-counts ``H = (1/2) Psi^H H_BdG Psi``;
    eigenvalues come in ``+-E`` pairs and the physical quasiparticle
    spectrum is the non-negative half.
    """
    if model._nspin != 1:
        raise PythtbError(
            "bdg_model: nspin == 1 base models only (build explicit "
            "spin structure into the orbital set first)"
        )
    if pairing not in ("triplet", "singlet"):
        raise PythtbError("bdg_model: pairing must be triplet/singlet")
    n = model._norb
    muvec = np.asarray(mu, dtype=float)
    muvec = np.full(n, float(muvec)) if muvec.ndim == 0 else muvec
    if muvec.shape != (n,):
        raise PythtbError("bdg_model: mu must be scalar or per-orbital")

    pos = np.concatenate([model._orb, model._orb], axis=0)
    out = tb_model(model._dim_k, model._dim_r, model._lat.tolist(),
                   pos.tolist(), per=list(model._per))
    ons = np.asarray(model._site_energies, dtype=float)
    out.set_onsite(list(ons - muvec) + list(-(ons - muvec)), mode="reset")
    for hop in model._hoppings:
        amp, i, j = hop[0], hop[1], hop[2]
        R = list(hop[3]) if model._dim_k != 0 else None
        out.set_hop(amp, i, j, R, mode="add")
        out.set_hop(-np.conj(amp), n + i, n + j, R, mode="add")

    for term in (delta or []):
        if len(term) == 3:
            d, i, j = term
            R = None
        else:
            d, i, j, R = term
        d = complex(d)
        Rv = (np.zeros(model._dim_r, dtype=int) if R is None
              else np.asarray(R, dtype=int))
        onsite_same = (i == j and not np.any(Rv))
        if pairing == "triplet":
            if onsite_same:
                raise PythtbError(
                    "bdg_model: onsite same-orbital triplet pairing "
                    "vanishes by Fermi statistics"
                )
            out.set_hop(d, i, n + j, list(Rv) if model._dim_k else None,
                        mode="add")
            out.set_hop(-d, j, n + i, list(-Rv) if model._dim_k else None,
                        mode="add")
        else:
            out.set_hop(d, i, n + j, list(Rv) if model._dim_k else None,
                        mode="add")
            if not onsite_same:
                out.set_hop(d, j, n + i, list(-Rv) if model._dim_k else None,
                            mode="add")

    if verify and pairing == "triplet":
        _verify_ph(out, model, n)
    return out


def _assemble_dense(model, k):
    """Host-side Bloch matrix at one reduced k (Convention I)."""
    n = model._norb
    H = np.zeros((n, n), dtype=complex)
    H[np.diag_indices(n)] = model._site_energies
    for hop in model._hoppings:
        amp, i, j = hop[0], hop[1], hop[2]
        if model._dim_k == 0:
            ph = 1.0
        else:
            R = np.asarray(hop[3], dtype=float)
            d = (R + model._orb[j] - model._orb[i])[model._per]
            ph = np.exp(2j * np.pi * np.dot(np.asarray(k), d))
        H[i, j] += amp * ph
        H[j, i] += np.conj(amp * ph)
    return H


def _verify_ph(bdg, base, n):
    """tau_x H(-k)^* tau_x == -H(k) at random k (triplet basis)."""
    rng = np.random.default_rng(0)
    taux = np.zeros((2 * n, 2 * n))
    taux[:n, n:] = np.eye(n)
    taux[n:, :n] = np.eye(n)
    for _ in range(3):
        k = rng.uniform(size=max(base._dim_k, 1))[: base._dim_k]
        Hp = _assemble_dense(bdg, k)
        Hm = _assemble_dense(bdg, -k)
        dev = np.max(np.abs(taux @ np.conj(Hm) @ taux + Hp))
        if dev > 1e-9:
            raise PythtbError(
                "bdg_model: particle-hole symmetry violated (dev %.1e) "
                "-- the pairing list breaks Delta_ij(R) = -Delta_ji(-R)"
                % dev
            )


def pfaffian(A, atol=1e-8):
    """Pfaffian of a real antisymmetric matrix via the real Schur
    form: A = Q S Q^T with S block-tridiagonal (2x2 blocks
    [[0, b], [-b, 0]]), Pf(A) = det(Q) prod b_i."""
    from scipy.linalg import schur

    A = np.asarray(A, dtype=float)
    m = A.shape[0]
    if A.shape != (m, m) or m % 2:
        raise PythtbError("pfaffian: need an even-dimensional matrix")
    if np.max(np.abs(A + A.T)) > atol * max(1.0, np.max(np.abs(A))):
        raise PythtbError("pfaffian: matrix is not antisymmetric")
    S, Q = schur(A, output="real")
    pf = np.linalg.det(Q)
    for i in range(0, m, 2):
        pf *= S[i, i + 1]
    return float(pf)


def majorana_number(bdg, atol=1e-7):
    """Kitaev Z2 invariant of a 1-D triplet BdG model: ``M = sign(
    Pf[A(0)] Pf[A(pi)])`` -- ``-1`` is topological (unpaired Majorana
    end modes on open chains).

    The Majorana rotation ``c = (g_A + i g_B)/2`` maps
    ``H = (1/2) Psi^H H_BdG Psi`` to ``(i/4) Gamma^T A Gamma``; at the
    PH-symmetric momenta A is real antisymmetric (checked; a residual
    imaginary part raises).
    """
    if bdg._dim_k != 1:
        raise PythtbError("majorana_number: dim_k == 1 required")
    if bdg._norb % 2:
        raise PythtbError("majorana_number: expected a Nambu-doubled model")
    n = bdg._norb // 2
    # W maps Psi = W Gamma with Gamma = (g_A, g_B)
    W = np.zeros((2 * n, 2 * n), dtype=complex)
    W[:n, :n] = 0.5 * np.eye(n)
    W[:n, n:] = 0.5j * np.eye(n)
    W[n:, :n] = 0.5 * np.eye(n)
    W[n:, n:] = -0.5j * np.eye(n)
    pfs = []
    tpar = np.concatenate([bdg._orb[:, bdg._per[0]]] * 1)
    for k in (0.0, 0.5):
        H = _assemble_dense(bdg, [k])
        # periodic (Convention II) gauge so A is real at the zone
        # boundary for fractional orbital positions too: H_II =
        # V^H H_I V with V = diag(e^{2 pi i k t_a}); particle and hole
        # copies share positions, so V commutes with the Nambu tau_x
        V = np.exp(2j * np.pi * k * tpar)
        H = np.conj(V)[:, None] * H * V[None, :]
        # H = (1/2) Psi^H H Psi = (1/2) Gamma^T (W^H H W) Gamma
        # = (i/4) Gamma^T A Gamma with A = -2 i W^H H W
        Amat = -2j * (W.conj().T @ H @ W)
        if np.max(np.abs(np.imag(Amat))) > atol * max(
            1.0, np.max(np.abs(Amat))
        ):
            raise PythtbError(
                "majorana_number: Majorana matrix not real at k=%g "
                "(model not particle-hole symmetric?)" % k
            )
        pfs.append(pfaffian(np.real(Amat)))
    m = np.sign(pfs[0] * pfs[1])
    if m == 0:
        raise PythtbError("majorana_number: gap closes at a TRIM")
    return float(m)


def kitaev_chain(t=1.0, delta=0.3, mu=0.0):
    """The Kitaev p-wave chain as a BdG model: topological (M = -1)
    for |mu| < 2|t| (Kitaev, Phys.-Usp. 44, 131 (2001))."""
    m = tb_model(1, 1, [[1.0]], [[0.0]])
    m.set_hop(-t, 0, 0, [1])
    return bdg_model(m, mu=mu, delta=[(delta, 0, 0, [1])],
                     pairing="triplet")
