"""The port's effective masses and k.p models (``geometry.effective_mass``,
``geometry.kp_model``, ``geometry.KPModel``) against pythtb_tpu's, on the
CPU in float64, where kernels 1 and 15 run their plain versions: the
Hessians, principal masses, velocities and energies, and the k.p
eigenvalues at a spread of offsets, to 1e-12.
"""

import numpy as np
import pytest

import pythtb_tpu
from pythtb_tpu import geometry as jgeometry
from pythtb_tpu.models import library as jzoo
from pythtb_tpu_torch import geometry

from .test_torch_ops import carry, on_cpu, random_model  # noqa: F401  (autouse: the port on the CPU)

TOL = 1e-12


def _rand_model(seed):
    """The random 2-D model of tests/test_kp.py: skewed lattice, 3 orbitals."""
    rng = np.random.default_rng(seed)
    m = pythtb_tpu.tb_model(2, 2, np.eye(2) + 0.2 * rng.standard_normal((2, 2)), rng.uniform(0, 1, size=(3, 2)))
    m.set_onsite(list(rng.standard_normal(3)))
    for i in range(3):
        for j in range(3):
            for R in ([0, 0], [1, 0], [0, 1]):
                if i == j and R == [0, 0]:
                    continue
                amp = rng.standard_normal() + 1j * rng.standard_normal()
                try:
                    m.set_hop(0.5 * amp, i, j, R)
                except pythtb_tpu.PythtbError:
                    pass
    return m


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(1.0, np.abs(want).max())


@pytest.mark.parametrize("case,k0,band", [("random 2-D", [0.13, 0.41], 1), ("haldane", [0.11, 0.27], 0),
                                          ("cscl 3-D", [0.1, 0.2, 0.3], 0), ("chain", [0.0], 0),
                                          ("spinful", [0.3, 0.1], 2)])
def test_effective_mass_matches_jax(case, k0, band):
    jm = {"random 2-D": _rand_model(3), "haldane": jzoo.haldane(), "cscl 3-D": jzoo.cscl(), "chain": jzoo.chain(),
          "spinful": random_model(61, 2, 2, norb=2, nhop=6)}[case]
    got = geometry.effective_mass(carry(jm), k0, band)
    want = jgeometry.effective_mass(jm, k0, band)
    assert sorted(got) == sorted(want)
    _close(got["hessian"], want["hessian"])
    _close(got["velocity"], want["velocity"])
    assert abs(got["energy"] - want["energy"]) <= TOL * max(1.0, abs(want["energy"]))
    # principal masses 1/lambda: compared through the eigenvalues
    _close(np.linalg.eigvalsh(got["hessian"]), np.linalg.eigvalsh(want["hessian"]))


@pytest.mark.parametrize("case,k0,bands", [("graphene K", [1 / 3, 2 / 3], [0, 1]), ("random 2-D", [0.2, 0.7], [0, 2]),
                                           ("haldane", [0.11, 0.27], [0]), ("cscl 3-D", [0.25, 0.0, 0.5], [1])])
def test_kp_model_matches_jax(case, k0, bands):
    jm = {"graphene K": jzoo.graphene(t=-1.0), "random 2-D": _rand_model(4), "haldane": jzoo.haldane(),
          "cscl 3-D": jzoo.cscl()}[case]
    got = geometry.kp_model(carry(jm), k0, bands)
    want = jgeometry.kp_model(jm, k0, bands)
    assert isinstance(got, geometry.KPModel)
    assert got.bands == want.bands and got.k0.shape == want.k0.shape
    assert got.gap == want.gap or abs(got.gap - want.gap) <= TOL * abs(want.gap)
    d = len(k0)
    dk = np.random.default_rng(7).normal(size=(9, d)) * 0.05
    _close(got(dk), want(dk))
    # the k.p matrix up to the phases of the band basis: its diagonal and moduli
    h, hw = got.hamiltonian(dk[0]), want.hamiltonian(dk[0])
    _close(np.diagonal(h), np.diagonal(hw))
    _close(np.abs(h), np.abs(hw))


def test_graphene_dirac_velocity():
    """kp_model at graphene's K: the isotropic cone of v_F = sqrt(3)/2."""
    kp = geometry.kp_model(carry(jzoo.graphene(t=-1.0)), [1 / 3, 2 / 3], [0, 1])
    for th in (0.0, 0.7, 1.9):
        e = kp(1e-4 * np.array([np.cos(th), np.sin(th)]))
        assert abs((e[1] - e[0]) / 2e-4 - np.sqrt(3.0) / 2.0) < 1e-3
