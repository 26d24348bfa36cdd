"""The port's Fermi-surface tools (``dos_linear``, ``fermi_surface``,
``fermi_velocity``, ``orbit_areas``, ``cyclotron_mass``,
``extremal_orbits``) against pythtb_tpu's, on the CPU in float64, where
kernel 21 and kernel 15 run their plain versions: ``dos_linear`` at d 1, 2,
3 and nspin 2 to 1e-12 of its largest value, the contours, areas, masses
and extremal orbits to 1e-10, the velocities to 1e-12.
"""

import numpy as np
import pytest
import torch

import pythtb_tpu
from pythtb_tpu import fermisurface as jfs
from pythtb_tpu.models import library as jzoo
from pythtb_tpu_torch import fermisurface
from pythtb_tpu_torch.ops import tetra

from .test_torch_ops import carry, on_cpu, random_model  # noqa: F401  (autouse: the port on the CPU)


def _square(t=-1.0):
    m = pythtb_tpu.tb_model(2, 2, [[1.0, 0.0], [0.0, 1.0]], [[0.0, 0.0]])
    m.set_hop(t, 0, 0, [1, 0])
    m.set_hop(t, 0, 0, [0, 1])
    return m


def _cubic(tz=-1.0):
    m = pythtb_tpu.tb_model(3, 3, np.eye(3).tolist(), [[0.0, 0.0, 0.0]])
    m.set_hop(-1.0, 0, 0, [1, 0, 0])
    m.set_hop(-1.0, 0, 0, [0, 1, 0])
    m.set_hop(tz, 0, 0, [0, 0, 1])
    return m


def _chain():
    c = pythtb_tpu.tb_model(1, 1, [[1.0]], [[0.0]])
    c.set_hop(-1.0, 0, 0, [1])
    return c


@pytest.mark.parametrize("case,nk", [("chain d1", 64), ("graphene d2", 24), ("haldane d2", 12),
                                     ("cubic d3", 12), ("random d3 nspin 1", 5), ("random d2 nspin 2", 10)])
def test_dos_linear_matches_jax(case, nk):
    jm = {"chain d1": _chain(), "graphene d2": jzoo.graphene(t=-1.0), "haldane d2": jzoo.haldane(),
          "cubic d3": _cubic(-0.7), "random d3 nspin 1": random_model(31, 3, 1, norb=3, nhop=8),
          "random d2 nspin 2": random_model(32, 2, 2, norb=2, nhop=6)}[case]
    ev = np.asarray(jm.solve_all(np.zeros((1, jm._dim_k))))
    E = np.linspace(ev.min() - 8.0, ev.max() + 8.0, 301)
    got = fermisurface.dos_linear(carry(jm), E, nk=nk)
    want = jfs.dos_linear(jm, E, nk=nk)
    assert got.shape == want.shape == (301,)
    assert want.max() > 0.0
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


@pytest.mark.parametrize("d", [1, 2, 3])
def test_simplex_corners_are_the_reference_layout(d):
    """The plain corners of kernel 21 in the JAX program's simplex order
    (grid point, split, band), each row sorted."""
    rng = np.random.default_rng(40 + d)
    nk, S = 4, 2
    ev = torch.as_tensor(rng.normal(size=(nk**d, S)))
    cs = tetra.simplex_corners(ev, nk, d).numpy()
    g = ev.numpy().reshape((nk,) * d + (S,))
    splits = {1: [((0,), (1,))], 2: [((0, 0), (1, 0), (1, 1)), ((0, 0), (0, 1), (1, 1))],
              3: [tuple(map(tuple, t)) for t in [
                  ((0, 0, 0), (1, 0, 0), (1, 1, 0), (1, 1, 1)), ((0, 0, 0), (1, 0, 0), (1, 0, 1), (1, 1, 1)),
                  ((0, 0, 0), (0, 1, 0), (1, 1, 0), (1, 1, 1)), ((0, 0, 0), (0, 1, 0), (0, 1, 1), (1, 1, 1)),
                  ((0, 0, 0), (0, 0, 1), (1, 0, 1), (1, 1, 1)), ((0, 0, 0), (0, 0, 1), (0, 1, 1), (1, 1, 1))]]}[d]
    t = 0
    for idx in np.ndindex(*(nk,) * d):
        for split in splits:
            for s in range(S):
                want = sorted(g[tuple((i + o) % nk for i, o in zip(idx, off)) + (s,)] for off in split)
                np.testing.assert_array_equal(cs[t], want)
                t += 1
    assert t == cs.shape[0]


def _same_contours(got, want, tol=1e-10):
    assert sorted(got) == sorted(want)
    for b in want:
        assert len(got[b]) == len(want[b])
        for (gp, gc), (wp, wc) in zip(got[b], want[b]):
            assert gc == wc and gp.shape == wp.shape
            assert np.abs(gp - wp).max() <= tol


@pytest.mark.parametrize("case,ef,nk", [("square", -1.3, 41), ("graphene", -0.35, 45), ("haldane", 0.9, 33),
                                        ("anisotropic", 0.0, 31)])
def test_fermi_surface_matches_jax(case, ef, nk):
    if case == "anisotropic":
        jm = pythtb_tpu.tb_model(2, 2, [[1.0, 0.0], [0.0, 1.0]], [[0.0, 0.0]])
        jm.set_hop(-1.0, 0, 0, [1, 0])
        jm.set_hop(-0.05, 0, 0, [0, 1])
    else:
        jm = {"square": _square(), "graphene": jzoo.graphene(t=-1.0), "haldane": jzoo.haldane()}[case]
    _same_contours(fermisurface.fermi_surface(carry(jm), ef, nk=nk), jfs.fermi_surface(jm, ef, nk=nk))


def test_fermi_velocity_matches_jax():
    rng = np.random.default_rng(5)
    for jm in (jzoo.graphene(t=-1.0), jzoo.haldane(), random_model(33, 3, 2, norb=2, nhop=6)):
        k = rng.random((13, jm._dim_k))
        got = fermisurface.fermi_velocity(carry(jm), k)
        want = jfs.fermi_velocity(jm, k)
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1e-12 * max(1.0, np.abs(want).max())
        np.testing.assert_allclose(fermisurface.fermi_velocity(carry(jm), k, bands=[0]), want[:, :, [0]],
                                   rtol=0, atol=1e-12 * max(1.0, np.abs(want).max()))


def test_orbit_areas_and_cyclotron_mass_match_jax():
    sq, jsq = carry(_square()), _square()
    for ef in (-3.6, -1.0, 3.7):
        got, want = fermisurface.orbit_areas(sq, ef, 0, nk=61), jfs.orbit_areas(jsq, ef, 0, nk=61)
        assert got.shape == want.shape and len(want) >= 1
        assert np.abs(got - want).max() <= 1e-10 * np.abs(want).max()
    g, jg = carry(jzoo.graphene(t=-1.0)), jzoo.graphene(t=-1.0)
    got, want = fermisurface.orbit_areas(g, -0.4, 0, nk=45), jfs.orbit_areas(jg, -0.4, 0, nk=45)
    assert got.shape == want.shape and len(want) == 2
    assert np.abs(got - want).max() <= 1e-10 * np.abs(want).max()
    got, want = fermisurface.cyclotron_mass(sq, -3.5, 0, nk=61), jfs.cyclotron_mass(jsq, -3.5, 0, nk=61)
    assert abs(got - want) <= 1e-10 * abs(want)


def test_open_orbits_warn_as_in_jax():
    jm = pythtb_tpu.tb_model(2, 2, [[1.0, 0.0], [0.0, 1.0]], [[0.0, 0.0]])
    jm.set_hop(-1.0, 0, 0, [1, 0])
    jm.set_hop(-0.05, 0, 0, [0, 1])
    with pytest.warns(UserWarning, match="open orbit"):
        got = fermisurface.orbit_areas(carry(jm), 0.0, 0, nk=31)
    assert len(got) == 0


@pytest.mark.parametrize("tz,ef", [(-1.0, -5.7), (-0.15, -2.0)])
def test_extremal_orbits_match_jax(tz, ef):
    got = fermisurface.extremal_orbits(carry(_cubic(tz)), ef, 0, n_slices=12, nk=25)
    want = jfs.extremal_orbits(_cubic(tz), ef, 0, n_slices=12, nk=25)
    assert len(got) == len(want) >= 1
    for a, b in zip(got, want):
        assert a["kind"] == b["kind"]
        assert abs(a["k_slice"] - b["k_slice"]) <= 1e-10
        assert abs(a["area"] - b["area"]) <= 1e-10 * abs(b["area"])
