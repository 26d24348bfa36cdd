"""Quasicrystal and quasiperiodic model generators (counterpart of
``pythtb_tpu.models.quasicrystal``; host NumPy, line for line).

Beyond-reference capability (PythTB builds periodic crystals only).  Three
families, each returning a plain finite :class:`~pythtb_tpu_torch.tb_model`
so every existing engine (dense solve, ELL matvec / KPM to 10^6 sites,
LDOS, entanglement, dynamics) applies unchanged:

* :func:`penrose` / :func:`ammann_beenker` -- 2-D quasicrystal vertex
  models from ONE de Bruijn multigrid engine (:func:`multigrid_tiling`):
  the P3 rhombus tiling from a pentagrid (n = 5) and the octagonal
  square-rhombus tiling from a tetragrid (n = 4).  Every tile corner
  is an exact INTEGER index vector K in Z^n (position = K @ E with E
  the star of unit vectors), so vertex dedup and edge building are
  exact -- no floating-point point-matching anywhere.
* :func:`aubry_andre` -- the 1-D quasiperiodic chain
  ``H = t sum (c+_i c_{i+1} + h.c.) + lam sum cos(2 pi beta i + phi) n_i``
  with its self-dual localization transition at ``lam = 2|t|``.  With
  a rational approximant ``beta = F_{m-1}/F_m``, ``L = F_m`` sites and
  periodic gluing, the Aubry duality is EXACT on the sorted spectrum:
  ``spec(lam) = (lam/2) spec(4 t^2/lam)`` for ``t > 0``, negated and
  order-reversed for ``t < 0`` (committed oracles at ~4e-14).
* :func:`fibonacci_chain` -- the substitution chain (A -> AB, B -> A)
  with hopping t_A/t_B following the Fibonacci word; bipartite, so the
  spectrum is exactly particle-hole symmetric (committed oracle).

Geometry oracles for the tilings (``tests/test_quasicrystal.py``):
every edge has exactly unit length, rhombus shapes are the expected
36/72-degree (Penrose) or 45-degree + square (Ammann-Beenker) set,
the fat/thin tile ratio approaches the golden ratio, vertex
coordinations stay in 3..7, and the vertex tight-binding models are
exactly bipartite-symmetric with the famous macroscopically
degenerate E = 0 confined states on Penrose.
"""

from __future__ import annotations

import numpy as np

from ..model import PythtbError, tb_model

__all__ = ["multigrid_tiling", "penrose", "ammann_beenker",
           "aubry_andre", "fibonacci_chain", "fibonacci_word",
           "vertex_areas"]


def multigrid_tiling(ngrid, radius, offsets=None, seed=None):
    """De Bruijn multigrid tiling with ``ngrid`` line families.

    Grid family ``j`` is the set of lines ``x . e_j + gamma_j = k``
    (integer k) with ``e_j = (cos(pi j / n), sin(pi j / n))`` for even
    symmetries and ``2 pi j / n`` for odd ones; every intersection of
    two grid lines maps to one rhombus whose four corners are the
    integer index vectors ``K``, ``K+u_j``, ``K+u_j+u_l``, ``K+u_l``
    with ``K_m = ceil(x . e_m + gamma_m)`` at the intersection.
    ``ngrid = 5`` gives the Penrose P3 tiling, ``ngrid = 4`` the
    octagonal Ammann-Beenker tiling.

    :param ngrid: number of grid families (>= 4)
    :param radius: keep tiles whose center is within this distance of
        the origin
    :param offsets: per-family line offsets gamma (generic values;
        default pseudo-random in (0.05, 0.95) summing to an integer
        for Penrose regularity when ngrid == 5)
    :param seed: RNG seed for the default offsets
    :returns: dict with ``verts`` (nv, 2) positions, ``edges``
        (ne, 2) vertex indices (unit length each), ``tiles``
        (nt, 4) vertex indices (corner order around the rhombus),
        ``index`` (nv, ngrid) integer de Bruijn indices
    """
    n = int(ngrid)
    if n < 4:
        raise PythtbError("multigrid_tiling: ngrid >= 4 required")
    # star directions: for odd n use the full circle / n (Penrose
    # convention); for even n half-turn / n (Ammann-Beenker)
    ang = (2.0 * np.pi / n) if n % 2 else (np.pi / n)
    E = np.stack([[np.cos(ang * j), np.sin(ang * j)]
                  for j in range(n)])  # (n, 2)
    if offsets is None:
        rng = np.random.default_rng(11 if seed is None else seed)
        offsets = rng.uniform(0.05, 0.95, size=n)
        if n == 5:
            # sum gamma in Z gives the "true" Penrose local rules
            offsets[-1] = np.round(offsets.sum()) - offsets[:-1].sum()
            if not (0.01 < offsets[-1] < 0.99):
                offsets[-1] = offsets[-1] % 1.0
    gamma = np.asarray(offsets, dtype=float)
    if gamma.shape != (n,):
        raise PythtbError("multigrid_tiling: need ngrid offsets")

    kmax = int(np.ceil(radius)) + 2
    ks = np.arange(-kmax, kmax + 1)
    verts = {}     # integer index tuple -> vertex id
    index_rows = []
    tiles = []
    edges = set()

    def vid(Kt):
        key = tuple(int(v) for v in Kt)
        i = verts.get(key)
        if i is None:
            i = len(index_rows)
            verts[key] = i
            index_rows.append(key)
        return i

    for j in range(n):
        for l in range(j + 1, n):
            # intersections of family j line k1 with family l line k2:
            # x . e_j = k1 - gamma_j, x . e_l = k2 - gamma_l
            A = np.stack([E[j], E[l]])  # (2, 2)
            det = np.linalg.det(A)
            if abs(det) < 1e-12:
                continue
            Ainv = np.linalg.inv(A)
            K1, K2 = np.meshgrid(ks, ks, indexing="ij")
            rhs = np.stack([K1.reshape(-1) - gamma[j],
                            K2.reshape(-1) - gamma[l]], axis=-1)
            X = rhs @ Ainv.T  # (m, 2) intersection points
            keep = np.linalg.norm(X, axis=1) <= radius + 1.5
            X = X[keep]
            k1s = K1.reshape(-1)[keep]
            k2s = K2.reshape(-1)[keep]
            # de Bruijn index vector at the intersection
            proj = X @ E.T + gamma[None, :]  # (m, n)
            K = np.ceil(proj - 1e-9).astype(np.int64)
            # on the two defining families the index is pinned exactly
            K[:, j] = k1s
            K[:, l] = k2s
            uj = np.zeros(n, np.int64)
            uj[j] = 1
            ul = np.zeros(n, np.int64)
            ul[l] = 1
            for m in range(len(X)):
                c0 = K[m]
                corners = [c0, c0 + uj, c0 + uj + ul, c0 + ul]
                pos = np.stack(corners).astype(float) @ E
                cen = pos.mean(axis=0)
                if np.linalg.norm(cen) > radius:
                    continue
                ids = [vid(c) for c in corners]
                tiles.append(ids)
                for a in range(4):
                    p, q = ids[a], ids[(a + 1) % 4]
                    edges.add((p, q) if p < q else (q, p))

    index = np.asarray(index_rows, dtype=np.int64)
    pos = index.astype(float) @ E
    return {
        "verts": pos,
        "edges": np.asarray(sorted(edges), dtype=np.int64),
        "tiles": np.asarray(tiles, dtype=np.int64),
        "index": index,
        "star": E,
    }


def vertex_areas(til):
    """Exact per-vertex tessellation area of a multigrid tiling: each
    vertex owns 1/4 of every rhombus it is a corner of (the four
    quarter-tiles around an interior vertex tile the plane exactly).

    This is the measure that makes real-space densities quantize on a
    quasicrystal: e.g. the Bianco-Resta local Chern marker
    (:func:`pythtb_tpu_torch.realspace.chern_marker`, normalized per unit
    cell area = 1 for these ``lat = I`` models) summed over a bulk
    region and divided by ``vertex_areas(til)`` summed over the same
    region reads the Chern number directly (0.2%-level on a
    600-vertex Penrose patch; committed oracle in
    ``tests/test_quasicrystal.py``).

    :param til: tiling dict from :func:`multigrid_tiling`
    :returns: ``(nv,)`` owned areas (boundary vertices own less than
        the bulk average, exactly accounting for the patch edge)
    """
    pos, tiles = til["verts"], til["tiles"]
    v1 = pos[tiles[:, 1]] - pos[tiles[:, 0]]
    v2 = pos[tiles[:, 3]] - pos[tiles[:, 0]]
    t_area = np.abs(v1[:, 0] * v2[:, 1] - v1[:, 1] * v2[:, 0])
    owned = np.zeros(len(pos))
    np.add.at(owned, tiles.reshape(-1),
              np.repeat(t_area / 4.0, 4))
    return owned


def _tiling_model(til, t):
    """Finite vertex tight-binding model on a tiling dict."""
    pos = til["verts"]
    # tb_model positions are reduced coordinates; with lat = I and a
    # bounding shift they coincide with Cartesian ones
    m = tb_model(0, 2, np.eye(2), pos)
    for (i, j) in til["edges"]:
        m.set_hop(t, int(i), int(j), mode="set")
    return m


def penrose(radius, t=-1.0, offsets=None, seed=None, return_tiling=False):
    """Penrose P3 vertex model: nearest-neighbour hopping ``t`` on the
    vertices of the rhombic Penrose tiling (all rhombus edges have
    unit length; fat 72/108 and thin 36/144 rhombi in a golden-ratio
    count).  The bipartite vertex model carries the famous
    macroscopically degenerate strictly-localized E = 0 states.

    :returns: the finite :class:`tb_model` (and the tiling dict when
        ``return_tiling``)"""
    til = multigrid_tiling(5, radius, offsets=offsets, seed=seed)
    m = _tiling_model(til, t)
    return (m, til) if return_tiling else m


def ammann_beenker(radius, t=-1.0, offsets=None, seed=None,
                   return_tiling=False):
    """Octagonal Ammann-Beenker vertex model (45-degree rhombi +
    squares from the de Bruijn tetragrid)."""
    til = multigrid_tiling(4, radius, offsets=offsets, seed=seed)
    m = _tiling_model(til, t)
    return (m, til) if return_tiling else m


def aubry_andre(L, lam, t=-1.0, beta=None, phi=0.0, pbc=True):
    """Aubry-Andre quasiperiodic chain of ``L`` sites:

    ``H = t sum_i (|i><i+1| + h.c.) + lam sum_i cos(2 pi beta i + phi)``

    Default ``beta`` is the rational approximant ``F_{m-1}/F_m`` with
    ``F_m`` the largest Fibonacci number <= L (exact Aubry duality on
    the periodic ring when ``L == F_m``); pass
    ``beta=(np.sqrt(5)-1)/2`` for the irrational limit.  All states
    are extended for ``lam < 2|t|`` and localized for ``lam > 2|t|``
    (committed IPR oracle); at ``beta = F_{m-1}/F_m`` and ``L = F_m``
    the duality is exact on the sorted spectrum.  Derivation: the
    unitary ``c_k = L^{-1/2} sum_n e^{2 pi i beta n k} c_n`` (a true
    permutation-Fourier because ``gcd(F_{m-1}, F_m) = 1``) maps hops
    to onsites and back, giving ``spec H(t, lam) = spec H(lam/2, 2t)``
    as an operator identity; rescaling yields
    ``spec(lam) = (lam/2) spec(4 t^2/lam)`` for ``t > 0`` and the
    negated, order-reversed version for ``t < 0`` (the sign of ``t``
    rides into the dual onsite amplitude, and ``-cos`` is not a
    lattice translation of ``cos`` on an odd-length ring).
    """
    L = int(L)
    if L < 3:
        raise PythtbError("aubry_andre: L >= 3 required")
    if beta is None:
        a, b = 1, 1
        while b <= L:
            a, b = b, a + b
        f_m = a
        # largest Fibonacci <= L; approximant uses its predecessor
        c, d = 1, 1
        while d < f_m:
            c, d = d, c + d
        beta = c / d
    m = tb_model(0, 1, [[float(L)]],
                 [[i / L] for i in range(L)])
    ons = lam * np.cos(2.0 * np.pi * float(beta) * np.arange(L) + phi)
    m.set_onsite(ons.tolist())
    for i in range(L - 1):
        m.set_hop(t, i, i + 1)
    if pbc:
        m.set_hop(t, L - 1, 0)
    return m


def fibonacci_word(n):
    """The length-F_{n+2} Fibonacci word over {'A', 'B'} from the
    substitution A -> AB, B -> A, starting from 'A'."""
    a, b = "A", ""
    w = "A"
    for _ in range(int(n)):
        w = "".join("AB" if c == "A" else "A" for c in w)
    return w


def fibonacci_chain(n, ta=-1.0, tb=-0.6, pbc=False):
    """Fibonacci hopping chain: the bond sequence follows the
    Fibonacci word of generation ``n`` (hops ``ta`` for A, ``tb`` for
    B); sites = bonds + 1 (open) or bonds (periodic).  Bipartite, so
    the spectrum is exactly particle-hole symmetric."""
    w = fibonacci_word(n)
    nb = len(w)
    L = nb if pbc else nb + 1
    m = tb_model(0, 1, [[float(L)]], [[i / L] for i in range(L)])
    for i, c in enumerate(w):
        tt = ta if c == "A" else tb
        m.set_hop(tt, i, (i + 1) % L)
    return m
