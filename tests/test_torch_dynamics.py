"""The port's real-time dynamics (Chebyshev evolution, quench echoes)
against pythtb_tpu's, on the CPU in float64.

``evolve`` runs the same Bessel coefficients through the same recursion
in both packages (kernel 10's plain version here), so the states agree
to 1e-11 on both branches: a uniform grid starting at the step, and one
seeded by a fractional step of its own order.  ``quench_echo`` agrees to
1e-10.  The guards give the same outcome as JAX's.
"""

import io
from contextlib import redirect_stdout

import numpy as np
import pytest

import pythtb_tpu
import pythtb_tpu_torch
from pythtb_tpu import dynamics as jdynamics
from pythtb_tpu import realspace as jrealspace
from pythtb_tpu_torch import dynamics, realspace

from . import zoo
from .test_torch_matvec import _outcome
from .test_torch_ops import carry, on_cpu  # noqa: F401  (autouse: the port on the CPU)

SAMPLES = {
    "peierls flake nspin1": lambda mod: mod.magnetic.peierls_model(
        mod.models.square().cut_piece(6, 0), 1.0 / 9.0).cut_piece(6, 1),
    "kane_mele flake nspin2": lambda mod: zoo.kane_mele(mod, "odd").cut_piece(3, 0).cut_piece(3, 1),
}

TIMES = {
    "unseeded": np.linspace(0.5, 5.0, 10),  # times[0] == dt
    "seeded forward": np.linspace(1.3, 4.0, 10),
    "seeded backward": np.linspace(0.1, 2.8, 10),  # times[0] < dt
    "from zero": np.linspace(0.0, 3.0, 7),
    "single time": np.array([2.5]),
}


def _states(nsta, B, seed=0):
    rng = np.random.default_rng(seed)
    psi = rng.normal(size=(nsta, B)) + 1j * rng.normal(size=(nsta, B))
    return psi / np.linalg.norm(psi, axis=0)


@pytest.mark.parametrize("when", sorted(TIMES))
@pytest.mark.parametrize("name", sorted(SAMPLES))
def test_evolve_matches_jax(name, when):
    with redirect_stdout(io.StringIO()):
        jm, pm = SAMPLES[name](pythtb_tpu), SAMPLES[name](pythtb_tpu_torch)
    times = TIMES[when]
    p0 = np.zeros(jm._nsta, complex)
    p0[jm._nsta // 2] = 1.0
    want = jdynamics.evolve(jm, p0, times)
    got = dynamics.evolve(pm, p0, times)
    assert got.shape == want.shape == (len(times), jm._nsta)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-11)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, rtol=0, atol=1e-11)
    if when in ("unseeded", "seeded backward"):  # a block of states, and a fixed order
        psi = _states(jm._nsta, 3)
        np.testing.assert_allclose(dynamics.evolve(pm, psi, times, order=30),
                                   jdynamics.evolve(jm, psi, times, order=30), rtol=0, atol=1e-11)


def test_evolve_on_a_torus_matches_jax():
    with redirect_stdout(io.StringIO()):
        jm = zoo.haldane(pythtb_tpu)
    js = jrealspace.torus_sample(jm, (4, 3), onsite_disorder=0.5, seed=1)
    ps = realspace.torus_sample(carry(jm), (4, 3), onsite_disorder=0.5, seed=1)
    psi = _states(js.nsta, 2, seed=3)
    for times in (np.linspace(0.4, 4.0, 10), np.array([1.0])):
        np.testing.assert_allclose(dynamics.evolve(ps, psi, times), jdynamics.evolve(js, psi, times),
                                   rtol=0, atol=1e-11)


def test_cheb_order_matches_jax():
    for a, dt in ((4.0, 0.5), (2.7, -1.3), (100.0, 3.5), (1.0, 0.0)):
        assert dynamics._cheb_order(a, dt) == jdynamics._cheb_order(a, dt)


QUENCHES = {
    "ssh across": (lambda mod: mod.models.ssh(delta=0.6), lambda mod: mod.models.ssh(delta=-0.6), [0], (40,)),
    "ssh both bands": (lambda mod: mod.models.ssh(delta=0.5), lambda mod: mod.models.ssh(delta=-0.5), [0, 1], (16,)),
    "haldane 2d": (lambda mod: zoo.haldane(mod, delta=0.2), lambda mod: zoo.haldane(mod, delta=0.9), [0], (8, 7)),
    "kane_mele nsta4": (lambda mod: zoo.kane_mele(mod, "odd"), lambda mod: zoo.kane_mele(mod, "even"), [0, 1], (6, 6)),
}


@pytest.mark.parametrize("name", sorted(QUENCHES))
def test_quench_echo_matches_jax(name):
    mi, mf, occ, nk = QUENCHES[name]
    times = np.linspace(0.02, 3.0, 25)
    with redirect_stdout(io.StringIO()):
        want = jdynamics.quench_echo(mi(pythtb_tpu), mf(pythtb_tpu), occ, nk, times)
        got = dynamics.quench_echo(mi(pythtb_tpu_torch), mf(pythtb_tpu_torch), occ, nk, times)
    assert got.shape == want.shape == times.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)


def _flake3(mod):
    return zoo.haldane(mod).cut_piece(3, 0).cut_piece(3, 1)


def _shifted_ssh(mod):
    """An SSH-shaped chain whose second orbital sits at 0.3, not 0.5."""
    m = mod.tb_model(1, 1, [[1.0]], [[0.0], [0.3]])
    m.set_hop(1.2, 0, 1, [0])
    m.set_hop(0.8, 1, 0, [1])
    return m


GUARDS = {
    # tests/test_dynamics.py: test_evolve_errors
    "times not uniform": lambda mod: mod.dynamics.evolve(_flake3(mod), np.ones(18), np.array([1.0, 1.5, 2.5])),
    "psi0 length": lambda mod: mod.dynamics.evolve(_flake3(mod), np.ones(3), np.array([1.0])),
    "periodic model": lambda mod: mod.dynamics.evolve(zoo.haldane(mod), np.ones(2), np.array([1.0])),
    "times decreasing": lambda mod: mod.dynamics.evolve(_flake3(mod), np.ones(18), np.array([2.0, 1.0])),
    "times empty": lambda mod: mod.dynamics.evolve(_flake3(mod), np.ones(18), np.array([])),
    "single time zero": lambda mod: mod.dynamics.evolve(_flake3(mod), np.ones(18), np.array([0.0])),
    # test_review_guards
    "order 1": lambda mod: mod.dynamics.evolve(_flake3(mod), np.ones(18) / np.sqrt(18), np.array([1.0]), order=1),
    "occ repeated": lambda mod: mod.dynamics.quench_echo(
        mod.models.ssh(delta=0.5), mod.models.ssh(delta=-0.5), [0, 0], (8,), np.array([1.0])),
    # test_quench_echo_errors
    "quench other dims": lambda mod: mod.dynamics.quench_echo(
        mod.models.ssh(), mod.models.graphene(), [0], (8,), np.array([1.0])),
    "quench finite": lambda mod: mod.dynamics.quench_echo(
        mod.models.ssh().cut_piece(4, 0, glue_edgs=False), mod.models.ssh().cut_piece(4, 0, glue_edgs=False),
        [0], (8,), np.array([1.0])),
    "quench orbitals": lambda mod: mod.dynamics.quench_echo(
        mod.models.ssh(), _shifted_ssh(mod), [0], (8,), np.array([1.0])),
    "quench occ range": lambda mod: mod.dynamics.quench_echo(
        mod.models.ssh(), mod.models.ssh(delta=-0.3), [2], (8,), np.array([1.0])),
    "quench nk": lambda mod: mod.dynamics.quench_echo(
        mod.models.ssh(), mod.models.ssh(delta=-0.3), [0], (1,), np.array([1.0])),
}


@pytest.mark.parametrize("name", sorted(GUARDS))
def test_guards_match_jax(name):
    with redirect_stdout(io.StringIO()):
        want = _outcome(pythtb_tpu, GUARDS[name])
        got = _outcome(pythtb_tpu_torch, GUARDS[name])
    assert want != "ok"
    assert got == want
