"""Fermi-surface tools: contours, linear-interpolation DOS, dHvA orbits
(counterpart of ``pythtb_tpu.fermisurface``).

* :func:`fermi_surface` -- iso-energy contours of a 2-D periodic model by
  marching squares with linear edge interpolation: one device grid solve
  (kernel 1 and ``eigh_batched``), the marching and the chaining on the
  host in NumPy, as in the JAX package.
* :func:`dos_linear` -- the analytic linear-interpolation DOS (segments,
  triangles, tetrahedra in 1-3 dimensions): the grid solve, then the
  simplex sum on kernel 21 (:func:`pythtb_tpu_torch.ops.tetra.tetra_dos`).
* :func:`fermi_velocity` -- Cartesian band velocities at arbitrary
  k-points: the diagonal of the band-basis dH/dk (kernel 15), through
  :func:`pythtb_tpu_torch.boltzmann._band_v_minv`.
* :func:`orbit_areas`, :func:`cyclotron_mass`, :func:`extremal_orbits` --
  shoelace areas of the closed contours, the cyclotron mass by central
  differences, and the extremal cross sections of a 3-D Fermi surface
  (the largest closed orbit per slice, the JAX package's documented rule)
  from one device solve of every slice.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from . import config
from .geometry import _prep
from .model import PythtbError
from .ops.eigh import eigh_batched
from .ops.hamiltonian import assemble
from .ops.solver import device_uniform_grid
from .ops.tetra import tetra_dos

__all__ = ["fermi_surface", "dos_linear", "fermi_velocity",
           "orbit_areas", "cyclotron_mass", "extremal_orbits"]


# -- shared grid solve -------------------------------------------------


def _grid_evals_dev(data, nk):
    """(nk^d, nsta) energies on the uniform reduced grid from the origin,
    on the device: kernel 1 and one ``eigh_batched``."""
    kpts = device_uniform_grid((nk,) * data.dim_k, np.zeros(data.dim_k), data.device)
    return eigh_batched(assemble(data, kpts))[0].contiguous()


def _grid_evals(model, nk):
    """(nk^d, nsta) energies on the uniform reduced grid, as host float64."""
    data, _, _ = _prep(model, "fermisurface")
    return _grid_evals_dev(data, int(nk)).cpu().numpy().astype(np.float64)


# -- marching squares --------------------------------------------------

def _march_cell_segments(e, level):
    """Segments of the level set on an (n, n) PERIODIC grid.

    Returns a list of ((edge_id_a, pt_a), (edge_id_b, pt_b)) with
    points in reduced coordinates and edge ids hashable MODULAR
    grid-edge keys, so orbits crossing the zone boundary chain up
    (coordinates are unwrapped during chaining)."""
    n = e.shape[0]
    s = e >= level
    segs = []
    # modular edge keys: ('h', i, j) = horizontal edge from node (i,j)
    # to (i+1,j) with i, j taken mod n; ('v', i, j) likewise vertical
    def E(i, j):
        return e[i % n, j % n]

    def interp_h(i, j):
        t = (level - E(i, j)) / (E(i + 1, j) - E(i, j))
        return ("h", i % n, j % n), np.array([(i + t) / n, j / n])

    def interp_v(i, j):
        t = (level - E(i, j)) / (E(i, j + 1) - E(i, j))
        return ("v", i % n, j % n), np.array([i / n, (j + t) / n])

    for i in range(n):
        for j in range(n):
            idx = (int(s[i, j]) | int(s[(i + 1) % n, j]) << 1
                   | int(s[(i + 1) % n, (j + 1) % n]) << 2
                   | int(s[i, (j + 1) % n]) << 3)
            if idx in (0, 15):
                continue
            bottom = lambda: interp_h(i, j)
            top = lambda: interp_h(i, j + 1)
            left = lambda: interp_v(i, j)
            right = lambda: interp_v(i + 1, j)
            table = {
                1: [(bottom, left)], 2: [(bottom, right)],
                3: [(right, left)], 4: [(right, top)],
                6: [(bottom, top)], 7: [(top, left)],
                8: [(top, left)], 9: [(bottom, top)],
                11: [(right, top)], 12: [(right, left)],
                13: [(bottom, right)], 14: [(bottom, left)],
            }
            if idx in (5, 10):
                # saddle: disambiguate with the cell-center average
                cen = 0.25 * (E(i, j) + E(i + 1, j) + E(i, j + 1)
                              + E(i + 1, j + 1)) >= level
                if idx == 5:
                    pairs = ([(bottom, right), (top, left)] if cen
                             else [(bottom, left), (right, top)])
                else:
                    pairs = ([(bottom, left), (right, top)] if cen
                             else [(bottom, right), (top, left)])
            else:
                pairs = table[idx]
            for pa, pb in pairs:
                segs.append((pa(), pb()))
    return segs


def _chain_segments(segs):
    """Chain marching segments into polylines by shared modular edge
    ids, unwrapping coordinates for periodic continuity.  Returns
    (list of (m, 2) arrays, list of closed flags); closed means the
    chain returned to its starting edge with ZERO winding -- a chain
    that returns to the same edge after winding the zone is a
    topologically open (traversing) orbit and is flagged open."""
    adj = {}
    for si, ((ka, _), (kb, _)) in enumerate(segs):
        adj.setdefault(ka, []).append(si)
        adj.setdefault(kb, []).append(si)

    def unwrap(prev, pt):
        return pt + np.round(prev - pt)

    used = [False] * len(segs)
    lines, closed = [], []
    for start in range(len(segs)):
        if used[start]:
            continue
        used[start] = True
        (ka, pa), (kb, pb) = segs[start]
        keys = [ka, kb]
        pts = [pa, unwrap(pa, pb)]
        for tail in (True, False):
            while True:
                key = keys[-1] if tail else keys[0]
                nxt = [si for si in adj.get(key, []) if not used[si]]
                if not nxt:
                    break
                si = nxt[0]
                used[si] = True
                (k1, p1), (k2, p2) = segs[si]
                knew, pnew = (k2, p2) if k1 == key else (k1, p1)
                if tail:
                    pts.append(unwrap(pts[-1], pnew))
                    keys.append(knew)
                else:
                    pts.insert(0, unwrap(pts[0], pnew))
                    keys.insert(0, knew)
        ring = keys[0] == keys[-1]
        wind = np.round(pts[-1] - pts[0]) if ring else None
        lines.append(np.asarray(pts))
        closed.append(bool(ring and np.all(wind == 0)))
    return lines, closed


def fermi_surface(model, ef, nk=201, bands=None):
    """Iso-energy contours ``eps_n(k) = ef`` of a 2-D periodic model.

    One batched device solve on an ``nk x nk`` reduced grid, then
    marching squares with linear edge interpolation on the host.
    Edge identities are periodic, so orbits crossing the zone boundary
    chain up and their coordinates are unwrapped (a closed pocket
    centered on Gamma comes back as ONE ring even though it crosses
    all four zone edges); a chain that returns to its starting edge
    with nonzero winding is a traversing (open) orbit.

    :param model: fully periodic 2-D :class:`tb_model`
    :param ef: energy level
    :param nk: grid resolution
    :param bands: band indices to contour (default: every band whose
        range brackets ``ef``)
    :returns: dict ``{band: [(contour (m, 2) reduced coords, closed
        bool), ...]}``
    """
    data, _, _ = _prep(model, "fermi_surface")
    if data.dim_k != 2:
        raise PythtbError("fermi_surface: dim_k == 2 required")
    ev = _grid_evals(model, nk)  # (nk*nk, nsta)
    nsta = ev.shape[1]
    ev = ev.reshape(nk, nk, nsta)
    if bands is None:
        bands = [b for b in range(nsta)
                 if ev[:, :, b].min() < ef < ev[:, :, b].max()]
    out = {}
    for b in bands:
        if not (0 <= b < nsta):
            raise PythtbError("fermi_surface: band index out of range")
        e = ev[:, :, b]
        if np.any(e == ef):
            # exact grid hits make marching degenerate; nudge by one ulp
            e = np.where(e == ef, np.nextafter(ef, np.inf), e)
        lines, closed = _chain_segments(_march_cell_segments(e, ef))
        out[b] = list(zip(lines, closed))
    return out


def dos_linear(model, energies, nk=64):
    """Density of states per unit cell by the analytic
    linear-interpolation method (segment / triangle / tetrahedron for
    dim_k = 1 / 2 / 3), no smearing parameter (counterpart of
    ``pythtb_tpu.fermisurface.dos_linear``): one device solve of the
    ``nk^d`` grid, then the simplex sum on kernel 21.  Flat bands carry no
    linear-interpolation weight, as there.

    :param model: fully periodic :class:`tb_model` (dim_k in 1..3)
    :param energies: (nE,) energy batch
    :param nk: grid resolution per direction
    :returns: (nE,) DOS array (states per cell per energy; spin
        multiplicity follows the model's nspin)
    """
    data, _, _ = _prep(model, "dos_linear")
    if data.dim_k not in (1, 2, 3):
        raise PythtbError("dos_linear: dim_k must be 1, 2, or 3")
    nk = int(nk)
    E = torch.as_tensor(np.atleast_1d(np.asarray(energies, np.float64)), dtype=config.FLOAT).to(data.device)
    dos = tetra_dos(_grid_evals_dev(data, nk), nk, data.dim_k, E.contiguous())
    return dos.cpu().numpy().astype(np.float64)


# -- velocities, areas, masses -----------------------------------------

def fermi_velocity(model, kpts, bands=None):
    """Cartesian band velocities ``v_n(k) = <n|dH/dk|n>`` (analytic
    Convention-I derivative, orbital embedding included) at arbitrary
    k-points: (nk, dim_k, nsta) or (nk, dim_k, len(bands))."""
    from .boltzmann import _band_v_minv

    data, lat, _ = _prep(model, "fermi_velocity")
    kpts = np.atleast_2d(np.asarray(kpts, dtype=float))
    if kpts.shape[1] != data.dim_k:
        raise PythtbError("fermi_velocity: kpts must have dim_k columns")
    k = torch.as_tensor(np.ascontiguousarray(kpts), dtype=config.FLOAT).to(data.device)
    _, _, vd, _ = _band_v_minv(data, k, lat, need_minv=False)
    vd = vd.cpu().numpy().astype(np.float64)
    if bands is not None:
        vd = vd[:, :, np.atleast_1d(bands)]
    return vd


def orbit_areas(model, ef, band, nk=201):
    """Cartesian k-space areas of the CLOSED Fermi-surface orbits of
    one band (2-D models).  Shoelace on the marching contours times
    ``|det B|`` with ``B = 2 pi lat^{-T}`` the reciprocal lattice;
    open orbits (crossing the zone without closing) are skipped with a
    warning.  The Onsager dHvA frequency is ``F = (hbar / 2 pi e) A``
    in physical units once ``A`` is scaled by the physical lattice
    constant."""
    conts = fermi_surface(model, ef, nk=nk, bands=[band])[band]
    lat = np.asarray(model._lat, dtype=float)
    detB = abs(np.linalg.det(2.0 * np.pi * np.linalg.inv(lat).T))
    areas = []
    nopen = 0
    for pts, closed in conts:
        if not closed:
            # orbits that wrap the zone come back through the padded
            # edge; a genuinely open trajectory stays open
            nopen += 1
            continue
        x, y = pts[:, 0], pts[:, 1]
        a = 0.5 * np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y)
        areas.append(abs(a) * detB)
    if nopen:
        warnings.warn("orbit_areas: skipped %d open orbit(s)" % nopen,
                      stacklevel=2)
    return np.asarray(sorted(areas, reverse=True))


def cyclotron_mass(model, ef, band, nk=201, de=None):
    """Cyclotron effective mass ``m* = (1/2 pi) dA/dE`` of the LARGEST
    closed orbit of one band (hbar = 1, lattice units), by central
    differencing of :func:`orbit_areas`.  ``de`` defaults to 1e-3 of
    the band width."""
    ev = _grid_evals(model, max(nk // 4, 32))[:, band]
    if de is None:
        de = 1e-3 * (ev.max() - ev.min())
    a_p = orbit_areas(model, ef + de, band, nk=nk)
    a_m = orbit_areas(model, ef - de, band, nk=nk)
    if len(a_p) == 0 or len(a_m) == 0:
        raise PythtbError("cyclotron_mass: no closed orbit at ef +- de")
    return float((a_p[0] - a_m[0]) / (2.0 * de) / (2.0 * np.pi))


def extremal_orbits(model, ef, band, slice_dir=2, n_slices=48, nk=151,
                    assume_orthogonal=False):
    """Extremal cyclotron-orbit cross sections of a 3-D Fermi surface
    -- the quantities quantum-oscillation (dHvA / SdH) experiments
    measure: ``F = (hbar / 2 pi e) A_extremal`` per extremum of the
    orbit area ``A(k_slice)`` along the field direction.

    The field is taken along lattice direction ``slice_dir``, which
    must be orthogonal to the other two lattice vectors (cubic /
    tetragonal / orthorhombic, or hexagonal with the c-axis field) --
    then every constant-``k_slice`` plane is a semiclassical orbit
    plane and in-plane areas follow from the 2-D reciprocal sublattice.
    ONE batched device solve covers the full ``n_slices x nk x nk``
    grid; each slice is contoured by the marching-squares engine and
    the largest closed orbit's shoelace area is tracked.  Extrema of
    the periodic ``A(k_slice)`` curve (belly maxima, neck minima --
    the corrugated-cylinder pair) are refined by a parabolic fit.

    :param model: 3-D periodic :class:`tb_model`
    :param ef: Fermi energy
    :param band: band index
    :param slice_dir: lattice direction of B (reduced axis to freeze)
    :param n_slices: slices along the field direction
    :param nk: in-plane marching grid
    :param assume_orthogonal: skip the orthogonality validation
    :returns: list of dicts ``{"k_slice", "area", "kind"}`` with kind
      "max" (belly) or "min" (neck), sorted by area descending; empty
      when no slice carries a closed orbit.  Areas are Cartesian
      (lattice-constant units); multiply by ``(hbar/2 pi e) (2 pi /
      a)^2`` for physical dHvA frequencies.
    """
    data, lat, _ = _prep(model, "extremal_orbits")
    if data.dim_k != 3:
        raise PythtbError("extremal_orbits: dim_k == 3 required")
    slice_dir = int(slice_dir)
    others = [d for d in range(3) if d != slice_dir]
    lat = np.asarray(lat, dtype=float)
    if not assume_orthogonal:
        for o in others:
            c = abs(np.dot(lat[slice_dir], lat[o]))
            if c > 1e-8 * np.linalg.norm(lat[slice_dir]) * \
                    np.linalg.norm(lat[o]):
                raise PythtbError(
                    "extremal_orbits: lattice vector %d (field "
                    "direction) must be orthogonal to vector %d so "
                    "that fixed-k planes are orbit planes" %
                    (slice_dir, o))
    # in-plane reciprocal area per unit reduced square: express the two
    # in-plane lattice vectors in an orthonormal basis of their plane
    a1, a2 = lat[others[0]], lat[others[1]]
    e1 = a1 / np.linalg.norm(a1)
    e2p = a2 - np.dot(a2, e1) * e1
    e2 = e2p / np.linalg.norm(e2p)
    L2 = np.array([[np.dot(a1, e1), np.dot(a1, e2)],
                   [np.dot(a2, e1), np.dot(a2, e2)]])
    detB = abs(np.linalg.det(2.0 * np.pi * np.linalg.inv(L2).T))

    # one batched solve over the full (n_slices, nk, nk) grid
    fr = [None] * 3
    gs, g1, g2 = (np.arange(n_slices) / n_slices,
                  np.arange(nk) / nk, np.arange(nk) / nk)
    fr[slice_dir], fr[others[0]], fr[others[1]] = np.meshgrid(
        gs, g1, g2, indexing="ij")
    kpts = np.stack([f.ravel() for f in fr], axis=-1)
    ev = np.asarray(model.solve_all(kpts), dtype=float)  # (nsta, B)
    if not (0 <= band < ev.shape[0]):
        raise PythtbError("extremal_orbits: band index out of range")
    e3 = ev[band].reshape(n_slices, nk, nk)

    areas = np.full(n_slices, np.nan)
    for s in range(n_slices):
        e = e3[s]
        if not (e.min() < ef < e.max()):
            continue
        if np.any(e == ef):
            e = np.where(e == ef, np.nextafter(ef, np.inf), e)
        lines, closed = _chain_segments(_march_cell_segments(e, ef))
        best = 0.0
        for pts, cl in zip(lines, closed):
            if not cl or pts.shape[0] < 3:
                continue
            x, y = pts[:, 0], pts[:, 1]
            a = 0.5 * abs(np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y))
            best = max(best, a * detB)
        if best > 0.0:
            areas[s] = best

    out = []
    for s in range(n_slices):
        if np.isnan(areas[s]):
            continue
        am = areas[(s - 1) % n_slices]
        ap = areas[(s + 1) % n_slices]
        if np.isnan(am) or np.isnan(ap):
            continue  # pocket edge: the boundary slice is never extremal
        if areas[s] >= am and areas[s] >= ap and (areas[s] > am or
                                                  areas[s] > ap):
            kind = "max"
        elif areas[s] <= am and areas[s] <= ap and (areas[s] < am or
                                                    areas[s] < ap):
            kind = "min"
        else:
            continue
        # parabolic refinement of the extremum position and value
        denom = am - 2.0 * areas[s] + ap
        if abs(denom) > 1e-300:
            d = 0.5 * (am - ap) / denom
            d = float(np.clip(d, -0.5, 0.5))
        else:
            d = 0.0
        kz = (gs[s] + d / n_slices * 1.0) % 1.0
        a_ref = areas[s] - 0.25 * (am - ap) * d
        out.append({"k_slice": float(kz), "area": float(a_ref),
                    "kind": kind})
    out.sort(key=lambda r: -r["area"])
    return out
