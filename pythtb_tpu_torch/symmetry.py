"""Point-group / space-group analysis of tight-binding models
(counterpart of ``pythtb_tpu.symmetry``, a host NumPy copy on this
package's :class:`tb_model`).

The reference (PythTB 1.8.0) has no symmetry tooling at
all: users check invariance by hand and there is no way to extract band
representations or use symmetry shortcuts for topology.  This module
supplies three things, all built on the package's exact Bloch machinery
and vetted *numerically* against the assembled Hamiltonian (the same
construction-verified philosophy as :func:`pythtb_tpu_torch.flows.parity_z2`):

* :func:`find_symmetries` -- enumerate the crystallographic operations
  ``g = (W, tau)`` (integer rotation part acting on reduced coordinates,
  fractional translation) that leave the model invariant, with the
  orbital permutation and the verified Bloch representation for each.
* :func:`symmetry_eigenvalues` -- little-group eigenvalues of the
  occupied bands at a symmetry-invariant k-point (the band
  representation data).
* :func:`chern_indicator` -- the rotation-eigenvalue symmetry indicator
  of the Chern number (Fang, Gilbert & Bernevig, PRB 86, 115112 (2012)):
  ``C mod n`` from a handful of high-symmetry diagonalizations instead
  of a full BZ integration.  Committed tests pin it against
  :func:`pythtb_tpu_torch.flows.chern_number` across phase diagrams.
* :func:`symmetrize` -- group-average a model's hoppings over a set of
  operations (exact orbit sums on the hop table), the generator used by
  the random-model differential fuzz tier.

Conventions.  Lattice vectors are the rows of ``lat``; a reduced point
``r`` sits at Cartesian ``r @ lat``.  An operation acts as ``r -> r @ W
+ tau`` with integer ``W`` preserving the Gram matrix ``lat @ lat.T``
(so the Cartesian action is orthogonal).  Orbital ``a`` maps to orbital
``p(a)`` with ``t_a @ W + tau = t_{p(a)} + R_a`` (integer ``R_a``).  In
the cell-periodic Bloch basis ``|chi_a(k)> = sum_R e^{2 pi i k.R}
|R,a>`` the representation is

    U(k')_{p(a), a} = xi_a * e^{-2 pi i k'.R_a},     k' = k @ W^{-T},

with ``xi_a`` the intrinsic orbital character (``e^{i l_a theta}`` for a
proper rotation by ``theta`` when orbital angular momenta ``l`` are
given; 1 otherwise), satisfying ``U(k') H_II(k) U(k')^+ = H_II(k')``.
Every returned operation has this identity verified at random k to
``tol`` -- an operation that fails is simply not a symmetry of the
model and is dropped (or raises, in the explicit-op APIs).

Spinful models (``nspin == 2``): proper rotations about z carry the
spin factor ``diag(e^{-i theta/2}, e^{+i theta/2})``; in-plane mirrors
carry ``-i n.sigma`` with ``n`` the mirror normal.  The indicator
formulas below are the spinless ones, so :func:`chern_indicator`
rejects ``nspin == 2`` models (their eigenvalues are still available
through :func:`symmetry_eigenvalues`).  Spinful search beyond 2-D
raises (the SU(2) factors are only built for the 2-D crystal classes).

Host/serial by design: the candidate enumeration is a combinatorial
search over integer matrices and orbital permutations -- tiny,
branchy, and O(candidates * norb) -- with nothing to shard; only the
per-candidate verification touches the device solver (the model's
``gen_ham`` and ``solve_one``).
"""

from __future__ import annotations

import warnings
from itertools import product as _iproduct

import numpy as np

from .model import PythtbError

__all__ = [
    "SymmetryOp",
    "find_symmetries",
    "symmetry_eigenvalues",
    "chern_indicator",
    "symmetrize",
    "point_group",
]

_MATCH_TOL = 1e-8


class SymmetryOp:
    """A verified crystal symmetry of a model.

    Attributes: ``W`` (integer (d, d), reduced-coordinate rotation
    part, acting as ``r -> r @ W``), ``tau`` (fractional translation,
    (d,)), ``perm`` (orbital permutation, ``a -> perm[a]``), ``Ra``
    ((norb, d) integer lattice shifts of the orbital images), ``det``
    (+1 proper / -1 improper), ``angle`` (Cartesian rotation angle in
    radians, 2-D proper ops; mirror-line angle for improper),
    ``order`` (smallest m with g^m = identity translation class),
    ``xi`` (orbital characters used), ``spin_u`` (2x2 spin factor or
    None)."""

    def __init__(self, W, tau, perm, Ra, lat, xi, spin_u=None):
        self.W = np.asarray(W, dtype=np.int64)
        self.tau = np.asarray(tau, dtype=np.float64)
        self.perm = np.asarray(perm, dtype=np.int64)
        self.Ra = np.asarray(Ra, dtype=np.int64)
        self.xi = np.asarray(xi, dtype=complex)
        self.spin_u = None if spin_u is None else np.asarray(spin_u)
        lat = np.asarray(lat, dtype=np.float64)
        # Cartesian matrix g with x -> x @ g_rc for row vectors:
        # r' = r W  =>  x' = r W lat = x lat^{-1} W lat
        self.cart = np.linalg.inv(lat) @ self.W @ lat
        self.det = int(round(np.linalg.det(self.W)))
        d = self.W.shape[0]
        if d == 2:
            if self.det > 0:
                self.angle = float(np.arctan2(self.cart[0, 1],
                                              self.cart[0, 0]))
            else:
                # mirror across a line at angle phi: cart = R(2 phi) . M_x
                self.angle = float(0.5 * np.arctan2(self.cart[0, 1],
                                                    self.cart[0, 0]))
        else:
            self.angle = None
        self.order = self._order()

    def _order(self):
        d = self.W.shape[0]
        W = np.eye(d, dtype=np.int64)
        t = np.zeros(d)
        for m in range(1, 13):
            t = t @ self.W + self.tau
            W = W @ self.W
            if np.array_equal(W, np.eye(d, dtype=np.int64)) and \
               np.abs(t - np.round(t)).max() < 1e-9:
                return m
        return 0  # not a finite-order op within 12 (should not happen)

    def is_point(self, center=None):
        """True when the op is a pure point operation about some center
        (always true for 2-D rotations; glides/screws return False)."""
        d = self.W.shape[0]
        M = np.eye(d) - self.W
        # solve c M = tau mod 1 for some center c
        try:
            sol = np.linalg.lstsq(M.T.astype(float), self.tau, rcond=None)
        except np.linalg.LinAlgError:
            return False
        res = sol[0] @ M - self.tau
        return bool(np.abs(res - np.round(res)).max() < 1e-9)

    def matrix(self, k_target, nspin=1):
        """The Bloch representation U(k') at reduced target momentum
        ``k'`` (see module docstring).  ``nspin == 2`` appends the spin
        factor (orb-major flattening, matching ``assemble``)."""
        norb = len(self.perm)
        U = np.zeros((norb, norb), dtype=complex)
        ph = self.xi * np.exp(-2.0j * np.pi *
                              (self.Ra @ np.asarray(k_target, float)))
        U[self.perm, np.arange(norb)] = ph
        if nspin == 2:
            if self.spin_u is None:
                raise PythtbError(
                    "symmetry op has no spin factor; rebuild with "
                    "find_symmetries on the spinful model"
                )
            U = np.kron(U, self.spin_u)
        return U

    def kmap(self, k):
        """Momentum map k -> k' = k @ W^{-T} (reduced coordinates)."""
        Winv = np.linalg.inv(self.W.astype(float))
        return np.asarray(k, float) @ Winv.T

    def __repr__(self):
        kind = "C" if self.det > 0 else ("m" if self.order == 2 and
                                         self.W.shape[0] == 2 else "S")
        tau = "" if np.abs(self.tau).max() < 1e-12 else \
            " + tau=%s" % np.round(self.tau, 6).tolist()
        if self.angle is not None and self.det > 0:
            return "<SymmetryOp %s(%.1f deg)%s order=%d>" % (
                kind, np.degrees(self.angle), tau, self.order)
        return "<SymmetryOp det=%+d order=%d%s>" % (
            self.det, self.order, tau)


# ---------------------------------------------------------------------------
# lattice point group


def _lattice_ops(lat, tol=1e-6):
    """All integer matrices W with W G W^T = G (G the Gram matrix) --
    the holohedry of the Bravais lattice, acting on reduced row
    vectors.  Entries are bounded by norm matching, searched in
    [-3, 3] (sufficient for any cell with sane aspect ratio; a
    pathological sliver would need re-reduction, which tb lattices in
    practice never do)."""
    lat = np.asarray(lat, dtype=np.float64)
    d = lat.shape[0]
    G = lat @ lat.T
    scale = np.abs(G).max()
    rng = range(-3, 4)
    cands = [[] for _ in range(d)]
    for v in _iproduct(rng, repeat=d):
        v = np.asarray(v, dtype=np.int64)
        n2 = v @ G @ v
        for i in range(d):
            if abs(n2 - G[i, i]) < tol * scale:
                cands[i].append(v)
    out = []
    for rows in _iproduct(*cands):
        W = np.stack(rows)
        if abs(round(np.linalg.det(W))) != 1:
            continue
        if np.abs(W @ G @ W.T - G).max() < tol * scale:
            out.append(W.astype(np.int64))
    return out


def _orbit_map(orb, W, tau):
    """Match every orbital image t_a W + tau to an orbital (mod
    lattice); returns (perm, Ra) or None.  Coincident positions pair
    through an availability pool (same policy as the inversion
    machinery in flows.py -- greedy first-hit can send two orbitals to
    one partner)."""
    norb, d = orb.shape
    perm = np.full(norb, -1, dtype=np.int64)
    Ra = np.zeros((norb, d), dtype=np.int64)
    available = set(range(norb))
    for a in range(norb):
        target = orb[a] @ W + tau
        diff = target[None, :] - orb  # (norb, d)
        Rc = np.round(diff)
        hits = [int(b) for b in
                np.where(np.abs(diff - Rc).max(axis=1) < _MATCH_TOL)[0]
                if b in available]
        if not hits:
            return None
        use = a if a in hits else hits[0]
        perm[a] = use
        Ra[a] = Rc[use].astype(np.int64)
        available.discard(use)
    return perm, Ra


def _spin_factor(op_cart, det):
    """SU(2) factor of a 2-D crystal operation: rotations about z get
    exp(-i theta sigma_z / 2); mirrors (det < 0) act as a pi rotation
    about the in-plane normal, -i n.sigma.  (The overall sign of a
    spin-1/2 rep is projective and cancels in U H U^+.)"""
    if det > 0:
        th = np.arctan2(op_cart[0, 1], op_cart[0, 0])
        return np.diag([np.exp(-0.5j * th), np.exp(+0.5j * th)])
    # mirror line at angle phi (cart = R(2 phi) M_x); normal at phi+90
    phi = 0.5 * np.arctan2(op_cart[0, 1], op_cart[0, 0])
    nx, ny = -np.sin(phi), np.cos(phi)
    sx = np.array([[0.0, 1.0], [1.0, 0.0]], complex)
    sy = np.array([[0.0, -1.0j], [1.0j, 0.0]], complex)
    return -1.0j * (nx * sx + ny * sy)


def _h_conv2(model, k):
    """Cell-periodic (true Convention-II) Bloch Hamiltonian at reduced
    k, host complex128: H_II = D H_I D^+ with D = diag(e^{2 pi i
    k.t_a}) (spin repeats the orbital phase)."""
    H = np.asarray(model.gen_ham([list(k)])[0], dtype=complex)
    ph = np.exp(2.0j * np.pi * (model._orb[:, model._per] @
                                np.asarray(k, float)))
    if model._nspin == 2:
        ph = np.repeat(ph, 2)
    return ph[:, None] * H * np.conj(ph)[None, :]


def _verify_op(model, op, tol, nrand=3, seed=0):
    """Max deviation of U(k') H_II(k) U(k')^+ - H_II(k') over random
    k."""
    rng = np.random.default_rng(seed)
    dev = 0.0
    for _ in range(nrand):
        k = rng.random(model._dim_k)
        kp = op.kmap(k)
        U = op.matrix(kp, nspin=model._nspin)
        lhs = U @ _h_conv2(model, k) @ U.conj().T
        dev = max(dev, float(np.abs(lhs - _h_conv2(model, kp)).max()))
    return dev


def find_symmetries(model, l=None, tol=1e-6, include_identity=False):
    """Enumerate the verified space-group operations of a model.

    Searches every lattice point operation ``W`` (holohedry of the
    Bravais lattice) against every fractional-translation candidate
    read off the orbital cloud, keeps the ``(W, tau)`` pairs whose
    Bloch representation commutes with the Hamiltonian at random k to
    ``tol``, and returns them as :class:`SymmetryOp` objects.

    :param l: per-orbital angular momentum about its own site (length
      norb, integers); proper rotations by ``theta`` then carry the
      character ``e^{i l theta}`` (e.g. the Qi-Wu-Zhang model's
      ``(s, p_x + i p_y)`` doublet needs ``l=[0, 1]``).  Default all
      zero (s-like).
    :param tol: numeric verification tolerance on ``U H U^+ - H``.
    :param include_identity: also return the identity (handy for
      group-theoretic bookkeeping).
    :returns: list of :class:`SymmetryOp`, proper rotations first,
      sorted by descending order.
    """
    if model._dim_k != model._dim_r:
        raise PythtbError(
            "find_symmetries requires a fully periodic model "
            "(dim_k == dim_r); cut_piece models have open boundaries"
        )
    d = model._dim_k
    if model._nspin == 2 and d != 2:
        # the spin-rotation factors are only constructed for the 2-D
        # crystal classes (rotations about z, in-plane mirrors); a
        # silent empty result would read as "no symmetries"
        raise PythtbError(
            "find_symmetries: spinful (nspin == 2) symmetry search is "
            "implemented for 2-D models only (SU(2) factors for the "
            "2-D crystal classes); got dim_k == %d" % d
        )
    orb = np.asarray(model._orb, dtype=np.float64)
    lvec = np.zeros(model._norb, dtype=np.int64) if l is None else \
        np.asarray(l, dtype=np.int64)
    if lvec.shape != (model._norb,):
        raise PythtbError("l must have one entry per orbital")
    lat = np.asarray(model._lat, dtype=np.float64)
    found = []
    for W in _lattice_ops(lat):
        is_id = np.array_equal(W, np.eye(d, dtype=np.int64))
        # tau candidates: orbital 0 must land on SOME orbital
        taus = np.mod(orb - orb[0] @ W, 1.0)
        taus[np.abs(taus - 1.0) < _MATCH_TOL] = 0.0
        seen = []

        def _same_mod1(a, b):
            diff = a - b
            return np.abs(diff - np.round(diff)).max() < _MATCH_TOL

        for tau in taus:
            if any(_same_mod1(tau, t0) for t0 in seen):
                continue
            seen.append(tau.copy())
            if is_id and np.abs(tau).max() < _MATCH_TOL \
                    and not include_identity:
                continue
            m = _orbit_map(orb, W, tau)
            if m is None:
                continue
            perm, Ra = m
            cart = np.linalg.inv(lat) @ W @ lat
            det = int(round(np.linalg.det(W)))
            if det > 0 and d == 2:
                th = np.arctan2(cart[0, 1], cart[0, 0])
                xi = np.exp(1.0j * lvec * th)
            elif np.allclose(cart, -np.eye(d), atol=1e-9):
                xi = (-1.0) ** lvec  # inversion parity of Y_l
            else:
                xi = np.ones(model._norb, dtype=complex)
            spin_u = None
            if model._nspin == 2:
                if d != 2:
                    continue  # spinful symmetry search is 2-D only
                spin_u = _spin_factor(cart, det)
            op = SymmetryOp(W, tau, perm, Ra, lat, xi, spin_u)
            if _verify_op(model, op, tol) < tol:
                found.append(op)
    found.sort(key=lambda o: (-o.det, -o.order))
    return found


def point_group(model, l=None, tol=1e-6):
    """Human-readable point-group summary: (name, ops).  The name is
    assembled from the maximal proper-rotation order and the mirror
    count (Schoenflies-style: C1/Cn/Cnv/Cs for the 2-D crystal
    classes; chiral vs achiral is decided by the presence of
    improper operations)."""
    ops = find_symmetries(model, l=l, tol=tol)
    proper = [o for o in ops if o.det > 0]
    improper = [o for o in ops if o.det < 0]
    n = max([o.order for o in proper], default=1)
    if n == 1:
        name = "Cs" if improper else "C1"
    else:
        name = "C%d%s" % (n, "v" if improper else "")
    return name, ops


# ---------------------------------------------------------------------------
# band representations at high-symmetry points


def _fixed_points(op):
    """All reduced k in [0,1)^d with k @ W^{-T} = k + integer -- the
    momenta whose little group contains the op."""
    d = op.W.shape[0]
    Winvt = np.linalg.inv(op.W.astype(float)).T
    M = np.eye(d) - Winvt
    Mi = np.round(M).astype(np.int64)
    if np.abs(M - Mi).max() > 1e-9:
        raise PythtbError("internal: I - W^{-T} is not integer")
    q = abs(int(round(np.linalg.det(Mi))))
    if q == 0:
        # degenerate (e.g. a mirror fixes a line); sample the zone
        # corners only
        pts = [np.zeros(d)]
        return pts
    out = []
    for idx in _iproduct(range(q), repeat=d):
        k = np.asarray(idx, float) / q
        v = k @ Mi
        if np.abs(v - np.round(v)).max() < 1e-9:
            out.append(k)
    return out


def symmetry_eigenvalues(model, op, kpt, occ=None, tol=1e-6):
    """Little-group eigenvalues of ``op`` on the occupied bands at
    ``kpt`` (which must satisfy ``k @ W^{-T} = k mod 1``).

    Diagonalizes the Hamiltonian at ``kpt`` on host (float64), projects
    the verified Bloch representation into the occupied subspace, and
    returns its eigenvalues (n-th roots of unity times the orbital /
    spin characters).  Raises when the subspace is not symmetry-
    invariant (occupied/empty degeneracy at the point) -- the
    projected matrix would not be unitary.

    :param occ: occupied band indices (default: lower half)
    :returns: (eigvals, det) -- the little-group eigenvalues and their
      product (the determinant used by :func:`chern_indicator`).
    """
    k = np.asarray(kpt, dtype=np.float64)
    kp = op.kmap(k)
    if np.abs(kp - k - np.round(kp - k)).max() > 1e-8:
        raise PythtbError(
            "symmetry_eigenvalues: %s is not invariant under the op "
            "(maps to %s)" % (k.tolist(), np.round(kp, 6).tolist())
        )
    H = _h_conv2(model, k)
    w, v = np.linalg.eigh(H)
    nsta = H.shape[0]
    if occ is None:
        occ = list(range(nsta // 2))
    occ = list(occ)
    emp = [s for s in range(nsta) if s not in occ]
    if emp and occ:
        gap = min(w[e] for e in emp) - max(w[o] for o in occ)
        if gap < 1e-7:
            raise PythtbError(
                "symmetry_eigenvalues: occupied/empty degeneracy at "
                "k = %s (gap %.2e) -- the occupied subspace is not "
                "well-defined there" % (k.tolist(), gap)
            )
    V = v[:, occ]  # columns are occupied states
    U = op.matrix(kp, nspin=model._nspin)
    S = V.conj().T @ U @ V
    uni = np.abs(S @ S.conj().T - np.eye(len(occ))).max()
    if uni > max(tol, 1e-6):
        raise PythtbError(
            "symmetry_eigenvalues: projected representation is not "
            "unitary (dev %.2e) -- the occupied subspace at %s is not "
            "invariant under this op" % (uni, k.tolist())
        )
    return np.linalg.eigvals(S), complex(np.linalg.det(S))


def _op_power(op, m, lat):
    """The m-th power of an op as a fresh SymmetryOp, composed exactly:
    applying (W1, tau1) then (W2, tau2) gives W = W1 W2, tau = tau1 W2
    + tau2, perm = p2 . p1, Ra_total[a] = R2[p1(a)] + R1[a] @ W2, and
    characters xi_total[a] = xi2[p1(a)] xi1[a]."""
    d = op.W.shape[0]
    norb = len(op.perm)
    W = np.eye(d, dtype=np.int64)
    tau = np.zeros(d)
    perm = np.arange(norb)
    Ra = np.zeros((norb, d), dtype=np.int64)
    xi = np.ones(norb, dtype=complex)
    su = None if op.spin_u is None else np.eye(2, dtype=complex)
    for _ in range(m):
        Ra = op.Ra[perm] + Ra @ op.W
        xi = op.xi[perm] * xi
        perm = op.perm[perm]
        tau = tau @ op.W + op.tau
        W = W @ op.W
        if su is not None:
            su = op.spin_u @ su
    return SymmetryOp(W, tau, perm, Ra, lat, xi, su)


def chern_indicator(model, occ=None, l=None, tol=1e-6, ops=None, n=None):
    """Chern number mod n from rotation eigenvalues at high-symmetry
    points (Fang-Gilbert-Bernevig, PRB 86, 115112 (2012)).

    Uses the maximal proper rotation C_n found in the model (n in
    {2, 3, 4, 6}) and the products of little-group eigenvalue
    determinants over its fixed-point classes:

    * n = 2:  (-1)^C    = det(Gamma) det(X) det(Y) det(M)   [C2]
    * n = 3:  e^{2piC/3} i.e. omega^C = prod over the three C3 points
    * n = 4:  i^C       = det_{C4}(Gamma) det_{C4}(M) det_{C2}(X)
    * n = 6:  e^{piC/3} = det_{C6}(Gamma) det_{C3}(K) det_{C2}(M)

    The result is exact (a symmetry identity), needs only O(4)
    diagonalizations, and is pinned against the BZ-integrated
    :func:`pythtb_tpu_torch.flows.chern_number` by the committed tests
    (Haldane across its phase diagram, Qi-Wu-Zhang with orbital
    characters ``l=[0, 1]``, and symmetrized random models in the fuzz
    tier).

    :returns: dict with ``"n"``, ``"c_mod_n"``, ``"phase"`` (the raw
      eigenvalue-product phase), ``"op"`` (the rotation used), and
      ``"points"`` (the HSP -> det map).
    """
    if model._nspin != 1:
        raise PythtbError(
            "chern_indicator implements the spinless (integer-l) "
            "formulas; for spinful models use symmetry_eigenvalues "
            "directly"
        )
    if model._dim_k != 2:
        raise PythtbError("chern_indicator is a 2-D invariant")
    lat = np.asarray(model._lat, dtype=np.float64)
    if ops is None:
        ops = find_symmetries(model, l=l, tol=tol)
    rots = [o for o in ops if o.det > 0 and o.order in (2, 3, 4, 6)
            and o.angle is not None]
    if n is not None:
        # force a lower-order subgroup formula (e.g. the C2 parity of
        # a C4 model); compose powers of a higher generator if the
        # subgroup element was not enumerated directly
        if not any(o.order == n for o in rots):
            for o in list(rots):
                if o.order % n == 0:
                    rots.append(_op_power(o, o.order // n, lat))
        rots = [o for o in rots if o.order == n]
    if not rots:
        raise PythtbError(
            "chern_indicator: no proper rotation symmetry found "
            "(checked C2/C3/C4/C6 against the Hamiltonian at tol=%g)"
            % tol
        )
    n = max(o.order for o in rots)
    # use the counterclockwise generator (angle ~ +2 pi / n) so the
    # eigenvalue products share one orientation with chern_number
    gen = min((o for o in rots if o.order == n),
              key=lambda o: abs(o.angle - 2.0 * np.pi / n))
    points = {}
    if n == 2:
        for kpt in ([0, 0], [0.5, 0], [0, 0.5], [0.5, 0.5]):
            _, det = symmetry_eigenvalues(model, gen, kpt, occ, tol)
            points[tuple(kpt)] = det
        phase = np.prod(list(points.values()))
    elif n == 3:
        for kpt in _fixed_points(gen):
            _, det = symmetry_eigenvalues(model, gen, kpt, occ, tol)
            points[tuple(np.round(kpt, 9))] = det
        phase = np.prod(list(points.values()))
    elif n == 4:
        c2 = _op_power(gen, 2, lat)
        for kpt, op_use in (([0, 0], gen), ([0.5, 0.5], gen),
                            ([0.5, 0], c2)):
            _, det = symmetry_eigenvalues(model, op_use, kpt, occ, tol)
            points[tuple(kpt)] = det
        phase = np.prod(list(points.values()))
    else:  # n == 6
        c3 = _op_power(gen, 2, lat)
        c2 = _op_power(gen, 3, lat)
        kK = [f for f in _fixed_points(c3)
              if np.abs(np.asarray(f)).max() > 1e-9][0]
        _, dG = symmetry_eigenvalues(model, gen, [0, 0], occ, tol)
        _, dK = symmetry_eigenvalues(model, c3, kK, occ, tol)
        _, dM = symmetry_eigenvalues(model, c2, [0.5, 0], occ, tol)
        points = {(0.0, 0.0): dG, tuple(np.round(kK, 9)): dK,
                  (0.5, 0.0): dM}
        phase = dG * dK * dM
    c_mod = int(np.round(np.angle(phase) * n / (2.0 * np.pi))) % n
    resid = abs(phase - np.exp(2.0j * np.pi * c_mod / n))
    if resid > 1e-3:
        warnings.warn(
            "chern_indicator: eigenvalue product %.6f%+.6fj is not an "
            "n-th root of unity (residual %.1e) -- characters l may be "
            "wrong for this model" % (phase.real, phase.imag, resid),
            UserWarning, stacklevel=2,
        )
    return {"n": n, "c_mod_n": c_mod, "phase": complex(phase),
            "op": gen, "points": points}


# ---------------------------------------------------------------------------
# group-averaging (the fuzz-tier generator)


def _transform_hops(model, op):
    """The hop table of g H g^+ (host): hop (i, j, R, amp) maps to
    (p(i), p(j), R @ W + R_j - R_i) with amplitude xi_i conj(xi_j) amp
    (spin blocks conjugated by the spin factor)."""
    out = []
    per = model._per
    for hop in model._hoppings:
        amp, i, j = hop[0], hop[1], hop[2]
        R = np.zeros(model._dim_r, dtype=np.int64)
        if model._dim_k > 0:
            Rfull = np.asarray(hop[3], dtype=np.int64)
            R = Rfull
        Rp = R @ op.W + op.Ra[j] - op.Ra[i]
        a = op.xi[i] * np.conj(op.xi[j]) * np.asarray(amp)
        if model._nspin == 2 and op.spin_u is not None:
            amp_m = np.asarray(amp, dtype=complex)
            if amp_m.shape != (2, 2):
                amp_m = amp_m * np.eye(2) if amp_m.ndim == 0 else amp_m
            a = (op.xi[i] * np.conj(op.xi[j]) *
                 (op.spin_u @ amp_m @ op.spin_u.conj().T))
        out.append((a, int(op.perm[i]), int(op.perm[j]), Rp.tolist()))
    return out


def symmetrize(model, ops):
    """Group-average the model over ``ops`` (which should include the
    identity implicitly -- it is always added): returns a new model
    whose Hamiltonian is ``(1/|G|) sum_g g H g^+``.  Exact orbit sums
    on the hop table; onsite energies are averaged over the orbital
    permutation orbits.  The result is invariant under every op (the
    fuzz tests re-run :func:`find_symmetries` on it)."""
    from .model import tb_model

    norb = model._norb
    new = tb_model(model._dim_k, model._dim_r,
                   np.asarray(model._lat).tolist(),
                   np.asarray(model._orb).tolist(),
                   per=list(model._per), nspin=model._nspin)
    ngroup = len(ops) + 1
    # onsite
    if model._nspin == 1:
        es = np.asarray(model._site_energies, dtype=complex)
        acc = es.copy()
        for op in ops:
            mapped = np.zeros_like(es)
            mapped[op.perm] = es  # |xi|^2 = 1 on the diagonal
            acc = acc + mapped
        new.set_onsite(list(np.real(acc / ngroup)))
    else:
        accm = np.asarray(model._site_energies, dtype=complex).copy()
        for op in ops:
            mapped = np.zeros_like(accm)
            for a in range(norb):
                blk = np.asarray(model._site_energies[a], dtype=complex)
                u = op.spin_u if op.spin_u is not None else np.eye(2)
                mapped[op.perm[a]] = u @ blk @ u.conj().T
            accm = accm + mapped
        for a in range(norb):
            new.set_onsite((accm[a] / ngroup), a, mode="set")
    # hops: accumulate orbit sums in a dict keyed by canonical (i,j,R)
    table = {}

    def add(amp, i, j, R):
        key = (i, j, tuple(int(x) for x in R))
        ck = (j, i, tuple(-int(x) for x in R))
        if ck in table or (ck == key and False):
            # accumulate on the hermitian partner
            a = np.asarray(amp)
            table[ck] = table[ck] + (np.conj(a.T) if a.ndim == 2
                                     else np.conj(a))
            return
        if key in table:
            table[key] = table[key] + np.asarray(amp)
        else:
            table[key] = np.asarray(amp, dtype=complex) * 1.0

    for hop in model._hoppings:
        amp, i, j = hop[0], hop[1], hop[2]
        R = np.asarray(hop[3], dtype=np.int64) if model._dim_k > 0 \
            else np.zeros(model._dim_r, dtype=np.int64)
        add(np.asarray(amp), i, j, R)
    for op in ops:
        for (a, i, j, R) in _transform_hops(model, op):
            add(a, i, j, R)
    for (i, j, R), amp in table.items():
        amp = np.asarray(amp) / ngroup
        if i == j and all(x == 0 for x in R):
            continue  # diagonal home-cell terms belong to onsite
        val = amp if amp.ndim == 2 else complex(amp)
        if model._dim_k > 0:
            new.set_hop(val, i, j, list(R), mode="set")
        else:
            new.set_hop(val, i, j, mode="set")
    return new
