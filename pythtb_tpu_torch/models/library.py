"""Model constructors (see package docstring)."""

from __future__ import annotations

import numpy as np

from ..model import tb_model

_HONEYCOMB_LAT = [[1.0, 0.0], [0.5, np.sqrt(3.0) / 2.0]]
_HONEYCOMB_ORB = [[1.0 / 3.0, 1.0 / 3.0], [2.0 / 3.0, 2.0 / 3.0]]


def chain(t=-1.0, onsite=0.0):
    """1-D monatomic chain with nearest-neighbor hopping."""
    m = tb_model(1, 1, [[1.0]], [[0.0]])
    m.set_onsite([onsite])
    m.set_hop(t, 0, 0, [1])
    return m


def molecule_nh3(delta=0.5, t=1.0):
    """Zero-dimensional NH3-like molecule (dim_k=0, four orbitals)."""
    sq32 = np.sqrt(3.0) / 2.0
    orb = [
        [(2.0 / 3.0) * sq32, 0.0, 0.0],
        [(-1.0 / 3.0) * sq32, 0.5, 0.0],
        [(-1.0 / 3.0) * sq32, -0.5, 0.0],
        [0.0, 0.0, 1.0],
    ]
    m = tb_model(0, 3, np.eye(3).tolist(), orb)
    m.set_onsite([-delta, -delta, -delta, delta])
    for i in range(4):
        for j in range(i + 1, 4):
            m.set_hop(t, i, j)
    return m


def trestle(t1=0.8 + 0.6j, t2=2.0):
    """Trestle ladder: 1-D periodicity embedded in 2-D space with a
    complex rung hopping."""
    m = tb_model(1, 2, [[2.0, 0.0], [0.0, 1.0]], [[0.0, 0.0], [0.5, 1.0]], per=[0])
    m.set_hop(t2, 0, 0, [1, 0])
    m.set_hop(t2, 1, 1, [1, 0])
    m.set_hop(t1, 0, 1, [0, 0])
    m.set_hop(t1, 1, 0, [1, 0])
    return m


def checkerboard(delta=1.1, t=0.6):
    """Two-band checkerboard lattice."""
    m = tb_model(2, 2, [[1.0, 0.0], [0.0, 1.0]], [[0.0, 0.0], [0.5, 0.5]])
    m.set_onsite([-delta, delta])
    for lv in ([0, 0], [1, 0], [0, 1], [1, 1]):
        m.set_hop(t, 1, 0, lv)
    return m


def graphene(t=-1.0, delta=0.0):
    """Honeycomb lattice with nearest-neighbor hopping; ``delta``
    staggers the sublattice energies (gapped graphene / h-BN-like)."""
    m = tb_model(2, 2, _HONEYCOMB_LAT, _HONEYCOMB_ORB)
    m.set_onsite([-delta, delta])
    m.set_hop(t, 0, 1, [0, 0])
    m.set_hop(t, 1, 0, [1, 0])
    m.set_hop(t, 1, 0, [0, 1])
    return m


def bn(t=-1.0, delta=0.4):
    """Boron nitride: gapped honeycomb (an alias of graphene(delta>0))."""
    return graphene(t=t, delta=delta)


def haldane(delta=0.2, t=-1.0, t2=0.15 * np.exp(1.0j * np.pi / 2.0)):
    """Haldane Chern insulator (PRL 61, 2015 (1988)): honeycomb with a
    complex second-neighbor hopping, wired exactly as the original
    (and the reference example): with the defaults the lower band
    carries Chern number -1."""
    m = tb_model(2, 2, _HONEYCOMB_LAT, _HONEYCOMB_ORB)
    m.set_onsite([-delta, delta])
    m.set_hop(t, 0, 1, [0, 0])
    m.set_hop(t, 1, 0, [1, 0])
    m.set_hop(t, 1, 0, [0, 1])
    for lv in ([1, 0], [-1, 1], [0, -1]):
        m.set_hop(t2, 0, 0, lv)
    for lv in ([1, 0], [-1, 1], [0, -1]):
        m.set_hop(np.conj(t2), 1, 1, lv)
    return m


def kane_mele(esite=1.0, thop=1.0, spin_orb=0.3, rashba=0.25):
    """Kane-Mele quantum spin Hall model (PRL 95, 146802 (2005)).

    ``esite=1.0`` (default) is the topological ("odd" Z2) phase for the
    default couplings; ``esite=2.5`` is trivial."""
    m = tb_model(2, 2, _HONEYCOMB_LAT, _HONEYCOMB_ORB, nspin=2)
    sx = np.array([0.0, 1.0, 0.0, 0.0])
    sy = np.array([0.0, 0.0, 1.0, 0.0])
    sz = np.array([0.0, 0.0, 0.0, 1.0])
    m.set_onsite([esite, -esite])
    for lv in ([0, 0], [0, -1], [-1, 0]):
        m.set_hop(thop, 0, 1, lv)
    # intrinsic SOC: second-neighbor +- i lambda sigma_z
    m.set_hop(-1.0j * spin_orb * sz, 0, 0, [0, 1])
    m.set_hop(1.0j * spin_orb * sz, 0, 0, [1, 0])
    m.set_hop(-1.0j * spin_orb * sz, 0, 0, [1, -1])
    m.set_hop(1.0j * spin_orb * sz, 1, 1, [0, 1])
    m.set_hop(-1.0j * spin_orb * sz, 1, 1, [1, 0])
    m.set_hop(1.0j * spin_orb * sz, 1, 1, [1, -1])
    # Rashba term along the three nearest-neighbor bonds
    r3h = np.sqrt(3.0) / 2.0
    m.set_hop(1.0j * rashba * (0.5 * sx - r3h * sy), 0, 1, [0, 0], mode="add")
    m.set_hop(1.0j * rashba * (-1.0 * sx), 0, 1, [0, -1], mode="add")
    m.set_hop(1.0j * rashba * (0.5 * sx + r3h * sy), 0, 1, [-1, 0], mode="add")
    return m


def three_site_chain(lmbd, t=-1.3, delta=2.0):
    """Three-site chain at pumping parameter ``lmbd`` in [0, 1): cycling
    lmbd adiabatically pumps one unit of charge (Chern number 1 in
    (k, lambda) space) through the lowest band."""
    m = tb_model(1, 1, [[1.0]], [[0.0], [1.0 / 3.0], [2.0 / 3.0]])
    m.set_hop(t, 0, 1, [0])
    m.set_hop(t, 1, 2, [0])
    m.set_hop(t, 2, 0, [1])
    m.set_onsite(
        [delta * (-1.0) * np.cos(2.0 * np.pi * (lmbd - i / 3.0)) for i in range(3)]
    )
    return m


def cscl(delta=1.0, ta=0.4, tb=0.7):
    """CsCl-structure (bcc motif) two-band model with two inequivalent
    nearest-neighbor hopping strengths; insulating for the defaults.
    The bulk of the cubic-slab hybrid-Wannier workloads."""
    m = tb_model(3, 3, np.eye(3).tolist(), [[0.0, 0.0, 0.0], [0.5, 0.5, 0.5]])
    m.set_onsite([-delta, delta])
    for lvec in ([-1, 0, 0], [0, 0, -1], [-1, -1, 0], [0, -1, -1]):
        m.set_hop(ta, 0, 1, lvec)
    for lvec in ([0, 0, 0], [0, -1, 0], [-1, -1, -1], [-1, 0, -1]):
        m.set_hop(tb, 0, 1, lvec)
    return m


def fu_kane_mele(t=1.0, soc=0.125, m=-0.5, beta=0.0):
    """Fu-Kane-Mele diamond-lattice model (PRL 98, 106803 (2007)): the
    canonical 3-D strong topological insulator.

    Diamond lattice (fcc cell), spin-independent nearest-neighbor
    hopping with the [000] bond strengthened to ``3 t + dt``
    (``dt = m cos(beta)``), plus spin-dependent second-neighbor
    hoppings ``i soc (S . d)`` with bond-dependent spin direction, and
    an optional staggered Zeeman field ``m sin(beta) (1,1,1)``.

    Phase diagram in the distortion ``dt`` (verified numerically via
    plane-resolved Z2): ``dt < 0`` is the STRONG topological phase
    (plane invariants nu(k3=0) = 0 != nu(k3=1/2) = 1), ``dt = 0`` is the
    critical point, ``dt > 0`` is trivial.  Defaults sit inside the
    strong-TI phase.
    """
    lat = [[0.0, 1.0, 1.0], [1.0, 0.0, 1.0], [1.0, 1.0, 0.0]]
    orb = [[0.0, 0.0, 0.0], [0.25, 0.25, 0.25]]
    model = tb_model(3, 3, lat, orb, nspin=2)

    h = m * np.sin(beta) * np.array([1.0, 1.0, 1.0])
    dt = m * np.cos(beta)
    model.set_onsite([0.0] + list(h), 0)
    model.set_onsite([0.0] + list(-h), 1)

    for lvec in ([-1, 0, 0], [0, -1, 0], [0, 0, -1]):
        model.set_hop(t, 0, 1, lvec)
    model.set_hop(3.0 * t + dt, 0, 1, [0, 0, 0], mode="add")

    lvec_list = ([1, 0, 0], [0, 1, 0], [0, 0, 1], [-1, 1, 0], [0, -1, 1], [1, 0, -1])
    dir_list = ([0, 1, -1], [-1, 0, 1], [1, -1, 0], [1, 1, 0], [0, 1, 1], [1, 0, 1])
    for lvec, sdir in zip(lvec_list, dir_list):
        spin = np.array([0.0] + list(sdir), dtype=float)
        model.set_hop(1.0j * soc * spin, 0, 0, lvec)
        model.set_hop(-1.0j * soc * spin, 1, 1, lvec)
    return model


def square(t=1.0):
    """Square lattice with nearest-neighbor hopping (one orbital): the
    canonical substrate for Hofstadter-butterfly and Landau-level
    physics (see :mod:`pythtb_tpu_torch.magnetic`)."""
    m = tb_model(2, 2, [[1.0, 0.0], [0.0, 1.0]], [[0.0, 0.0]])
    m.set_hop(t, 0, 0, [1, 0])
    m.set_hop(t, 0, 0, [0, 1])
    return m


def ssh(delta=0.3, t=1.0):
    """Su-Schrieffer-Heeger dimerized chain (PRL 42, 1698 (1979)):
    alternating hoppings ``t(1+delta)`` (intracell) and ``t(1-delta)``
    (intercell).  The two signs of ``delta`` are the two dimerization
    classes -- Zak phases of the lower band differ by pi (Wannier
    center on the intracell vs intercell bond center).  See also
    examples/peierls_ssh.py for the Peierls-instability derivation."""
    m = tb_model(1, 1, [[1.0]], [[0.0], [0.5]])
    m.set_hop(t * (1.0 + delta), 0, 1, [0])
    m.set_hop(t * (1.0 - delta), 1, 0, [1])
    return m


def lieb(t=-1.0):
    """Lieb lattice (corner + two edge-center sites per square cell):
    one exactly flat band pinned at E = 0 between two dispersive bands
    touching it at M."""
    m = tb_model(2, 2, [[1.0, 0.0], [0.0, 1.0]],
                 [[0.0, 0.0], [0.5, 0.0], [0.0, 0.5]])
    m.set_hop(t, 0, 1, [0, 0])
    m.set_hop(t, 1, 0, [1, 0])
    m.set_hop(t, 0, 2, [0, 0])
    m.set_hop(t, 2, 0, [0, 1])
    return m


def kagome(t=-1.0):
    """Kagome lattice (three corner-sharing-triangle sites): one exactly
    flat band at E = -2t plus two graphene-like dispersive bands."""
    m = tb_model(2, 2, _HONEYCOMB_LAT, [[0.0, 0.0], [0.5, 0.0], [0.0, 0.5]])
    m.set_hop(t, 0, 1, [0, 0])
    m.set_hop(t, 0, 1, [-1, 0])
    m.set_hop(t, 0, 2, [0, 0])
    m.set_hop(t, 0, 2, [0, -1])
    m.set_hop(t, 1, 2, [0, 0])
    m.set_hop(t, 1, 2, [1, -1])
    return m


def qwz(u=1.0):
    """Qi-Wu-Zhang Chern insulator (PRB 74, 085308 (2006)): two
    orbitals (s, p_x + i p_y) per square-lattice site,

        H(k) = sin kx sx + sin ky sy + (u + cos kx + cos ky) sz.

    Chern number of the lower band: -1 for -2 < u < 0, +1 for
    0 < u < 2, 0 for |u| > 2.  The C4 symmetry needs the orbital
    characters ``l=[0, 1]`` (see ``symmetry.find_symmetries`` of
    pythtb_tpu, not ported yet)."""
    m_ = tb_model(2, 2, [[1.0, 0.0], [0.0, 1.0]], [[0.0, 0.0], [0.0, 0.0]])
    m_.set_onsite([u, -u])
    tx = 0.5 * np.array([[1.0, -1.0j], [-1.0j, -1.0]])
    ty = 0.5 * np.array([[1.0, -1.0], [1.0, -1.0]])
    for tmat, lv in ((tx, [1, 0]), (ty, [0, 1])):
        for i in range(2):
            for j in range(2):
                m_.set_hop(tmat[i, j], i, j, lv)
    return m_


def bhz(a=1.0, b=1.0, c=0.0, d=0.0, m=-1.0):
    """Bernevig-Hughes-Zhang quantum spin Hall model (Science 314,
    1757 (2006)) regularized on the square lattice: two orbitals (s, p)
    x spin, upper spin block ``h(k) = eps(k) I + A sin(kx) sx +
    A sin(ky) sy + d3(k) sz`` with ``eps = C - 2D(2 - cos kx - cos ky)``
    and ``d3 = M + 2B(2 - cos kx - cos ky)``; lower block = h*(-k)
    (time-reversal partner).  Band inversion -- the Z2-nontrivial
    phase -- for ``-8 B < M < 0`` (with B > 0); defaults are
    topological."""
    mod = tb_model(2, 2, [[1.0, 0.0], [0.0, 1.0]], [[0.0, 0.0], [0.0, 0.0]], nspin=2)
    mod.set_onsite([c - 4.0 * d + m + 4.0 * b, c - 4.0 * d - (m + 4.0 * b)])
    for lv in ([1, 0], [0, 1]):
        mod.set_hop(d - b, 0, 0, lv)
        mod.set_hop(d + b, 1, 1, lv)
    # A sin(kx) sx sz-spin and A sin(ky) sy (see module tests): the s-p
    # entry of the spin-diagonal Hamiltonian is
    # A sin(kx) * s_z - 1j * A sin(ky) * s_0
    mod.set_hop([0.0, 0.0, 0.0, a / 2.0j], 0, 1, [1, 0])
    mod.set_hop([0.0, 0.0, 0.0, -a / 2.0j], 0, 1, [-1, 0])
    mod.set_hop([-a / 2.0, 0.0, 0.0, 0.0], 0, 1, [0, 1])
    mod.set_hop([a / 2.0, 0.0, 0.0, 0.0], 0, 1, [0, -1])
    return mod


def weyl(t=1.0, k0=0.5 * np.pi):
    """Minimal two-band Weyl semimetal on the cubic lattice:
    ``H = 2t sin(kx) sx + 2t sin(ky) sy + d3 sz`` with ``d3 =
    2t(cos kz - cos k0) + 2t(2 - cos kx - cos ky)``: a single pair of
    Weyl nodes at ``k = (0, 0, +-k0/2pi)`` (reduced).  kz-slices whose
    Gamma-point gap is inverted (``cos kz < cos k0``, i.e. the arc of
    slices through kz = 1/2) carry Chern number -1, the others 0 -- the
    hallmark of the Fermi-arc surface states."""
    mod = tb_model(3, 3, np.eye(3).tolist(), [[0.0, 0.0, 0.0], [0.0, 0.0, 0.0]])
    c0 = 2.0 * t * (2.0 - np.cos(k0))
    mod.set_onsite([c0, -c0])
    mod.set_hop(t, 0, 0, [0, 0, 1])
    mod.set_hop(-t, 1, 1, [0, 0, 1])
    for lv in ([1, 0, 0], [0, 1, 0]):
        mod.set_hop(-t, 0, 0, lv)
        mod.set_hop(t, 1, 1, lv)
    mod.set_hop(-1.0j * t, 0, 1, [1, 0, 0])
    mod.set_hop(1.0j * t, 0, 1, [-1, 0, 0])
    mod.set_hop(-t, 0, 1, [0, 1, 0])
    mod.set_hop(t, 0, 1, [0, -1, 0])
    return mod


def bbh(gamma=0.5, lam=1.0):
    """Benalcazar-Bernevig-Hughes quadrupole model (Science 357, 61
    (2017)): four orbitals on the square lattice threaded by pi flux
    (one negative intracell bond), intracell hopping ``gamma`` and
    intercell ``lam``.  For ``|gamma/lam| < 1`` the insulator is a
    quadrupole: Wannier-sector polarizations p_x = p_y = 1/2 (nested
    Wilson loops) and four +-corner-localized zero modes on a finite
    flake; ``|gamma/lam| > 1`` is trivial.

    All four orbitals sit at the cell origin -- the convention of the
    BBH paper (the Bloch Hamiltonian is defined without orbital-position
    embedding), which makes the sector polarizations read exactly 1/2
    (quadrupole phase) vs 0 (trivial)."""
    orb = [[0.0, 0.0], [0.0, 0.0], [0.0, 0.0], [0.0, 0.0]]
    m = tb_model(2, 2, [[1.0, 0.0], [0.0, 1.0]], orb)
    # intracell (pi flux: the 0-2 bond carries the minus sign)
    m.set_hop(gamma, 0, 1, [0, 0])
    m.set_hop(-gamma, 0, 2, [0, 0])
    m.set_hop(gamma, 1, 3, [0, 0])
    m.set_hop(gamma, 2, 3, [0, 0])
    # intercell along x
    m.set_hop(lam, 1, 0, [1, 0])
    m.set_hop(lam, 3, 2, [1, 0])
    # intercell along y (the 2->0 bond continues the pi-flux pattern)
    m.set_hop(-lam, 2, 0, [0, 1])
    m.set_hop(lam, 3, 1, [0, 1])
    return m


def apply_strain(model, displacement, beta, in_place=False):
    """Strain-engineer a FINITE model: displace every orbital by
    ``displacement(r_cart) -> u`` and rescale each hopping by the
    standard exponential bond-length rule

        t -> t * exp(-beta (|d'| / |d| - 1)),

    with ``d`` / ``d'`` the unstrained / strained bond vectors.  The
    workhorse of pseudo-magnetic-field engineering: a triaxial
    displacement on graphene produces a uniform valley-odd
    pseudo-field whose Landau levels (E_n ~ sqrt(n), sublattice-
    polarized n = 0) appear directly in
    :func:`pythtb_tpu_torch.realspace.kpm_ldos` -- see
    :func:`triaxial_graphene_flake` and the committed sqrt(n) oracle.

    :param model: finite (dim_k == 0) tb_model
    :param displacement: callable mapping an (n, dim_r) Cartesian
      position array to an (n, dim_r) displacement array
    :param beta: dimensionless bond-decay constant
      (d ln t / d ln r ~ -beta; graphene: ~3.37)
    :param in_place: mutate ``model`` instead of copying
    :returns: the strained model
    """
    from ..model import PythtbError

    if model._dim_k != 0:
        raise PythtbError("apply_strain requires a finite model "
                          "(strain fields break translation symmetry)")
    import copy

    m = model if in_place else copy.deepcopy(model)
    pos = np.asarray(m._orb, dtype=np.float64) @ np.asarray(
        m._lat, dtype=np.float64)
    u = np.asarray(displacement(pos), dtype=np.float64)
    if u.shape != pos.shape:
        raise PythtbError("displacement must return an (norb, dim_r) "
                          "array")
    new_pos = pos + u
    for h in m._hoppings:
        i, j = h[1], h[2]
        d0 = np.linalg.norm(pos[j] - pos[i])
        if d0 < 1e-12:
            # coincident orbitals displace together: the bond length is
            # unchanged, so the hop is too (0/0 guarded; review finding)
            continue
        d1 = np.linalg.norm(new_pos[j] - new_pos[i])
        h[0] = h[0] * np.exp(-float(beta) * (d1 / d0 - 1.0))
    m._invalidate()
    return m


def triaxial_graphene_flake(L, strain, t=-2.7, beta=3.37):
    """Triaxially strained graphene flake: the canonical uniform
    PSEUDO-magnetic field (Guinea, Katsnelson & Geim, Nat. Phys. 6,
    30 (2010)).  Displacement ``u = strain * (2xy, x^2 - y^2)`` about
    the flake center gives a valley-odd field with sqrt(n)-spaced
    Landau levels in the local DOS and a sublattice-polarized zero
    mode -- time-reversal stays UNBROKEN (the committed tests pin
    both).

    :param L: flake size (L x L cells, 2 L^2 orbitals, open edges)
    :param strain: displacement amplitude (lattice units; the
      pseudo-field grows linearly, E_1 ~ sqrt(strain))
    :returns: finite tb_model
    """
    flake = graphene(t=t).cut_piece(L, 0, glue_edgs=False).cut_piece(
        L, 1, glue_edgs=False)
    pos = np.asarray(flake._orb, dtype=np.float64) @ np.asarray(
        flake._lat, dtype=np.float64)
    center = pos.mean(axis=0)

    def u_fn(p):
        xy = p - center[None, :]
        return float(strain) * np.stack(
            [2.0 * xy[:, 0] * xy[:, 1], xy[:, 0] ** 2 - xy[:, 1] ** 2],
            axis=-1)

    return apply_strain(flake, u_fn, beta, in_place=True)
