"""Moire superlattices: commensurate twisted bilayer graphene
(counterpart of ``pythtb_tpu.models.moire``; host NumPy, line for line).

The reference's model-building story ends at hand-written hop lists;
moire systems -- the central platform of flat-band physics since 2018 --
need *generated* models: thousands of orbitals placed by a
commensuration construction with distance-dependent Slater-Koster
hoppings.  This module builds them as ordinary
:class:`pythtb_tpu_torch.tb_model` objects (dim_k=2, dim_r=3: the stacking
direction is a genuine non-periodic third dimension), so every package
tool -- band solves, Berry flows, KPM DOS/LDOS at 10^4+ orbitals,
unfolding, entanglement -- applies unchanged.

Construction (Lopes dos Santos, Peres & Castro Neto, PRL 99, 256802
(2007); Trambly de Laissardiere, Mayou & Magaud, Nano Lett. 10, 804
(2010)):

* commensurate twist family ``i = m``: ``cos theta_m = (3 m^2 + 3 m +
  1/2) / (3 m^2 + 3 m + 1)`` with moire cell of ``N_c = 3 m^2 + 3 m +
  1`` graphene cells per layer (``4 N_c`` orbitals); the magic angle
  1.08 deg is ``m = 30`` (11,164 orbitals).
* layers rotated by -theta/2 / +theta/2 about a common AA site at the
  origin; superlattice vectors ``L1 = m a1 + (m+1) a2`` (layer-1
  frame) == ``(m+1) a1 + m a2`` (layer-2 frame) -- the builder asserts
  this identity numerically rather than trusting the algebra.
* Slater-Koster pz-pz hopping with exponential distance scaling,

  ``t(r) = Vpp_pi exp((a0 - r)/r0) (1 - (z/r)^2)
         + Vpp_sigma exp((d - r)/r0) (z/r)^2``

  (``a0 = a/sqrt(3)`` the C-C bond, ``d`` the interlayer spacing,
  ``r0 = 0.184 a`` the standard decay), truncated at ``cutoff``.
  All pairs within the cutoff are found with a cKDTree over the
  periodically tiled positions -- O(N log N), builds the magic-angle
  cell in seconds.

Oracles (tests/test_moire.py, tests/test_torch_moire.py): with the interlayer terms switched off
the moire spectrum must equal the band-folded union of the SAME
Slater-Koster monolayer over the exact commensurate k-set (pure
geometry + tiling check, 1e-10); the coupled model keeps C3 and
time-reversal degeneracies and shows the hallmark twist-angle
renormalization of the Dirac velocity.
"""

from __future__ import annotations

import numpy as np

from ..model import PythtbError, tb_model

__all__ = ["tbg", "tbg_angle", "sk_graphene"]


def tbg_angle(m):
    """Commensurate twist angle theta_m in DEGREES for the (m, m+1)
    family: cos theta = (3m^2 + 3m + 1/2)/(3m^2 + 3m + 1)."""
    m = int(m)
    if m < 1:
        raise PythtbError("tbg_angle requires m >= 1")
    c = (3.0 * m * m + 3.0 * m + 0.5) / (3.0 * m * m + 3.0 * m + 1.0)
    return float(np.degrees(np.arccos(c)))


def _rot(deg):
    t = np.radians(deg)
    return np.array([[np.cos(t), -np.sin(t)], [np.sin(t), np.cos(t)]])


def _sk_amplitude(dvec, a0, d, vpp_pi, vpp_sigma, r0):
    """Slater-Koster pz-pz amplitude for displacement rows (n, 3)."""
    r = np.linalg.norm(dvec, axis=-1)
    cz2 = (dvec[..., 2] / np.where(r > 0, r, 1.0)) ** 2
    return (vpp_pi * np.exp((a0 - r) / r0) * (1.0 - cz2)
            + vpp_sigma * np.exp((d - r) / r0) * cz2)


def _layer_positions(Mint, lat2d, rot_deg, a_mono, z):
    """Cartesian positions of one twisted layer's atoms inside the
    moire cell: enumerate monolayer cells, fold by the integer
    superlattice matrix ``Mint`` (frac coords are multiples of
    1/det M, so folding + dedup at 1e-6 is exact), and verify the
    count.  Returns (2 N_c, 3) with the A sublattice first."""
    Nc = int(round(abs(np.linalg.det(Mint))))
    Minv = np.linalg.inv(Mint)
    rng = int(np.ceil(np.abs(Mint).max())) + 2
    p, q = np.meshgrid(np.arange(-rng, rng + 1),
                       np.arange(-rng, rng + 1), indexing="ij")
    cells = np.stack([p.ravel(), q.ravel()], axis=-1)  # (n, 2) ints
    # frac coords of cell origins in the moire cell: origin = c @ A and
    # L = M @ A (rows), so origin = f @ L gives f = c @ M^{-1} -- row-
    # vector convention, NO transpose
    f = cells @ Minv
    f -= np.floor(f + 1e-9)
    # dedup residues (exact multiples of 1/Nc)
    keys = np.round(f * Nc).astype(np.int64)
    _, first = np.unique(keys[:, 0] * (4 * Nc) + keys[:, 1],
                         return_index=True)
    cells = cells[np.sort(first)]
    if len(cells) != Nc:
        raise PythtbError(
            "moire cell enumeration found %d residues, expected %d"
            % (len(cells), Nc)
        )
    R = _rot(rot_deg)
    a1 = R @ (a_mono * np.array([1.0, 0.0]))
    a2 = R @ (a_mono * np.array([0.5, np.sqrt(3.0) / 2.0]))
    basis = [np.zeros(2), (a1 + a2) / 3.0]
    out = []
    for b in basis:
        xy = cells @ np.stack([a1, a2]) + b[None, :]
        # fold into the moire cell (exact-rational frac coords)
        fr = xy @ np.linalg.inv(lat2d)
        fr -= np.floor(fr + 1e-9)
        xy = fr @ lat2d
        out.append(np.concatenate([xy, np.full((Nc, 1), z)], axis=1))
    return np.concatenate(out, axis=0)


def tbg(m=8, a=2.46, d=3.35, vpp_pi=-2.7, vpp_sigma=0.48, r0=None,
        cutoff=5.0, interlayer=True, vacuum=20.0):
    """Commensurate twisted bilayer graphene as a tb_model.

    :param m: commensuration index (twist ``tbg_angle(m)`` degrees;
      orbital count ``4 (3 m^2 + 3 m + 1)``) -- m=30 is the 1.08-deg
      magic angle (11,164 orbitals)
    :param a: graphene lattice constant (Angstrom)
    :param d: interlayer spacing (Angstrom)
    :param vpp_pi: in-plane pz-pz Slater-Koster scale at the C-C bond
      length (eV)
    :param vpp_sigma: vertical pz-pz scale at spacing ``d`` (eV)
    :param r0: hopping decay length (default ``0.184 a``)
    :param cutoff: hopping truncation radius (Angstrom)
    :param interlayer: False builds the DECOUPLED bilayer (hops with
      any vertical component dropped) -- the geometry/tiling oracle
    :param vacuum: length of the non-periodic stacking vector
    :returns: tb_model with dim_k=2, dim_r=3 (layer 1 at -d/2 with its
      A sublattice first, then layer 2 at +d/2)
    """
    try:
        from scipy.spatial import cKDTree
    except Exception as exc:  # pragma: no cover
        raise PythtbError("tbg requires scipy for the neighbor search"
                          ) from exc

    m = int(m)
    theta = tbg_angle(m)
    a0 = a / np.sqrt(3.0)
    r0 = 0.184 * a if r0 is None else float(r0)
    if cutoff <= a0:
        raise PythtbError("cutoff must exceed the C-C bond length")

    a1 = a * np.array([1.0, 0.0])
    a2 = a * np.array([0.5, np.sqrt(3.0) / 2.0])
    M1 = np.array([[m, m + 1], [-(m + 1), 2 * m + 1]])
    M2 = np.array([[m + 1, m], [-m, 2 * m + 1]])
    A1 = _rot(-theta / 2.0) @ np.stack([a1, a2]).T  # columns a_i
    A2 = _rot(+theta / 2.0) @ np.stack([a1, a2]).T
    lat1 = (M1 @ A1.T)  # rows L1, L2 from layer-1 frame
    lat2 = (M2 @ A2.T)
    if np.abs(lat1 - lat2).max() > 1e-9 * a:
        raise PythtbError("commensuration identity failed -- layer "
                          "superlattices disagree (internal error)")
    lat2d = lat1

    pos1 = _layer_positions(M1, lat2d, -theta / 2.0, a, -d / 2.0)
    pos2 = _layer_positions(M2, lat2d, +theta / 2.0, a, +d / 2.0)
    pos = np.concatenate([pos1, pos2], axis=0)
    norb = pos.shape[0]

    lat3d = np.array([
        [lat2d[0, 0], lat2d[0, 1], 0.0],
        [lat2d[1, 0], lat2d[1, 1], 0.0],
        [0.0, 0.0, float(vacuum)],
    ])
    orb = pos @ np.linalg.inv(lat3d)
    model = tb_model(2, 3, lat=lat3d, orb=orb, per=[0, 1])
    model.set_onsite(np.zeros(norb))

    # neighbor range: enough image cells that every point within
    # `cutoff` of the home cell is covered
    area = abs(lat2d[0, 0] * lat2d[1, 1] - lat2d[0, 1] * lat2d[1, 0])
    heights = [area / np.linalg.norm(lat2d[1]),
               area / np.linalg.norm(lat2d[0])]
    nr = int(np.ceil(cutoff / min(heights))) + 1
    tree0 = cKDTree(pos)
    amps_all, ii_all, jj_all, R_all = [], [], [], []
    for Rx in range(-nr, nr + 1):
        for Ry in range(-nr, nr + 1):
            R2 = (Rx, Ry)
            if R2 < (0, 0):
                continue  # half space: conjugates are implicit
            shift = Rx * lat3d[0] + Ry * lat3d[1]
            pairs = tree0.query_ball_point(pos - shift[None, :], cutoff,
                                           workers=-1)
            ii = np.repeat(np.arange(norb),
                           [len(pl) for pl in pairs])
            jj = np.concatenate([np.asarray(pl, dtype=np.int64)
                                 for pl in pairs]) if len(ii) else \
                np.zeros(0, dtype=np.int64)
            if R2 == (0, 0):
                keep = ii < jj
            else:
                keep = np.ones(ii.shape, dtype=bool)
            ii, jj = ii[keep], jj[keep]
            if ii.size == 0:
                continue
            dvec = pos[jj] + shift[None, :] - pos[ii]
            amp = _sk_amplitude(dvec, a0, d, vpp_pi, vpp_sigma, r0)
            sel = np.abs(amp) > 1e-12
            if not interlayer:
                sel &= np.abs(dvec[:, 2]) < 1e-9
            ii, jj, amp = ii[sel], jj[sel], amp[sel]
            if ii.size == 0:
                continue
            Rs = np.zeros((ii.size, 3), dtype=int)
            Rs[:, 0], Rs[:, 1] = Rx, Ry
            amps_all.append(amp.astype(np.complex128))
            ii_all.append(ii)
            jj_all.append(jj)
            R_all.append(Rs)
    model._append_scalar_hops(
        np.concatenate(amps_all), np.concatenate(ii_all),
        np.concatenate(jj_all), np.concatenate(R_all),
    )
    return model


def sk_graphene(a=2.46, vpp_pi=-2.7, r0=None, cutoff=5.0, vacuum=20.0):
    """Single-layer graphene with the SAME distance-scaled
    Slater-Koster hops and cutoff as :func:`tbg` (beyond nearest
    neighbor!), for folding/unfolding oracles and velocity baselines.
    dim_k=2, dim_r=3 like the bilayer."""
    try:
        from scipy.spatial import cKDTree
    except Exception as exc:  # pragma: no cover
        raise PythtbError("sk_graphene requires scipy") from exc

    a0 = a / np.sqrt(3.0)
    r0 = 0.184 * a if r0 is None else float(r0)
    a1 = a * np.array([1.0, 0.0])
    a2 = a * np.array([0.5, np.sqrt(3.0) / 2.0])
    lat3d = np.array([[a1[0], a1[1], 0.0], [a2[0], a2[1], 0.0],
                      [0.0, 0.0, float(vacuum)]])
    pos = np.array([[0.0, 0.0, 0.0],
                    [(a1[0] + a2[0]) / 3.0, (a1[1] + a2[1]) / 3.0, 0.0]])
    model = tb_model(2, 3, lat=lat3d, orb=pos @ np.linalg.inv(lat3d),
                     per=[0, 1])
    model.set_onsite([0.0, 0.0])
    nr = int(np.ceil(cutoff / (a * np.sqrt(3.0) / 2.0))) + 1
    amps_all, ii_all, jj_all, R_all = [], [], [], []
    for Rx in range(-nr, nr + 1):
        for Ry in range(-nr, nr + 1):
            if (Rx, Ry) < (0, 0):
                continue
            shift = Rx * lat3d[0] + Ry * lat3d[1]
            for i in range(2):
                for j in range(2):
                    dvec = pos[j] + shift - pos[i]
                    r = np.linalg.norm(dvec)
                    if r < 1e-9 or r > cutoff:
                        continue
                    if (Rx, Ry) == (0, 0) and not (i < j):
                        continue
                    amp = _sk_amplitude(dvec[None, :], a0, 0.0,
                                        vpp_pi, 0.0, r0)[0]
                    amps_all.append(complex(amp))
                    ii_all.append(i)
                    jj_all.append(j)
                    R_all.append([Rx, Ry, 0])
    model._append_scalar_hops(
        np.asarray(amps_all), np.asarray(ii_all), np.asarray(jj_all),
        np.asarray(R_all, dtype=int),
    )
    return model
