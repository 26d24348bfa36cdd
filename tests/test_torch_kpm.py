"""The port's kernel-polynomial stack (kpm_dos, kpm_ldos, Kubo-Bastin
conductivity, torus samples) against pythtb_tpu's, on the CPU in float64.

JAX's threefry draws cannot be matched by torch's generator, so the
stochastic moment functions get JAX's own draws: the test makes them with
``jax.random`` exactly as the JAX programs do and hands them to the
port's moment function, which takes its start vectors as an argument.
Moments are sums of N terms of O(1), so they agree to 1e-10 * N; the
deterministic LDOS moments to 1e-12; the Kubo moment matrix to 1e-10
relative.  Sizes stay at or below 800 sites and 128 moments.
"""

import io
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pythtb_tpu
import pythtb_tpu_torch
from pythtb_tpu import flows as jflows
from pythtb_tpu import realspace as jrealspace
from pythtb_tpu.ops import matvec as jmatvec
from pythtb_tpu.utils.xfer import host_unpack
from pythtb_tpu_torch import flows, realspace
from pythtb_tpu_torch.ops import chebyshev, matvec

from . import zoo
from .test_torch_ops import carry, on_cpu  # noqa: F401  (autouse: the port on the CPU)


def _flake(mod, n=8, phi=1.0 / 9.0):
    """The bench-suite Peierls flake (square lattice, field along the cut)
    at n x n sites."""
    return mod.magnetic.peierls_model(mod.models.square().cut_piece(n, 0), phi, dirs=(0, 1)).cut_piece(n, 1)


FLAKES = {
    "peierls 10x10": lambda mod: _flake(mod, 10),
    "haldane 5x5": lambda mod: zoo.haldane(mod).cut_piece(5, 0).cut_piece(5, 1),
    "kane_mele 4x4": lambda mod: zoo.kane_mele(mod, "odd").cut_piece(4, 0).cut_piece(4, 1),
}


def _pair(name):
    with redirect_stdout(io.StringIO()):
        jm = FLAKES[name](pythtb_tpu)
        pm = FLAKES[name](pythtb_tpu_torch)
    return jm, pm


def _ab(h, margin=0.98):
    lo, hi = h.window
    return 0.5 * (hi - lo) / margin + 1e-12, 0.5 * (hi + lo)


def _jax_phases(key, N, R):
    """The random-phase block of ``_kpm_moments_jit``, (N, R)."""
    th = jax.random.uniform(key, (N, R), minval=0.0, maxval=2.0 * np.pi)
    return np.exp(1j * np.asarray(th))


def _jax_phases_per_key(key, N, R):
    """The random-phase vectors of ``_kubo_moments_jit``, one per split key, (N, R)."""
    keys = jax.random.split(key, R)
    return np.stack([np.exp(1j * np.asarray(jax.random.uniform(k, (N,), minval=0.0, maxval=2.0 * np.pi)))
                     for k in keys], axis=1)


@pytest.mark.parametrize("name", sorted(FLAKES))
@pytest.mark.parametrize("M", [2, 7, 96])
def test_kpm_moments_match_jax(name, M):
    jm, pm = _pair(name)
    jh, ph = jmatvec.sparse_h(jm), matvec.sparse_h(pm)
    a, b = _ab(jh)
    key = jax.random.PRNGKey(M)
    R = 3
    want = np.asarray(jflows._kpm_moments_jit(jh, a, b, key, M, R))
    got = flows._kpm_moments(ph, a, b, torch.as_tensor(_jax_phases(key, jh.nsta, R)), M).numpy()
    assert got.shape == (M,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10 * jh.nsta)


@pytest.mark.parametrize("name", sorted(FLAKES))
def test_ldos_moments_match_jax(name):
    jm, pm = _pair(name)
    jh, ph = jmatvec.sparse_h(jm), matvec.sparse_h(pm)
    a, b = _ab(jh)
    states = np.array([0, 3, jh.nsta - 1, jh.nsta // 2])
    M = 64
    want = np.asarray(jrealspace._ldos_moments_jit(jh, jnp.asarray([a, b]), jnp.asarray(states), M))
    got = realspace._ldos_moments(ph, torch.tensor([a, b], dtype=torch.float64), states, M).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


TORI = {
    "haldane": (lambda mod: zoo.haldane(mod), (5, 4), 1.0),
    "kane_mele": (lambda mod: zoo.kane_mele(mod, "odd"), (3, 3), 0.5),
    "chain": (lambda mod: mod.models.ssh(), (7,), 0.0),
}


def _tori(name, disorder=None):
    build, L, W = TORI[name]
    with redirect_stdout(io.StringIO()):
        jm = build(pythtb_tpu)
    W = W if disorder is None else disorder
    return (jrealspace.torus_sample(jm, L, onsite_disorder=W, seed=2),
            realspace.torus_sample(carry(jm), L, onsite_disorder=W, seed=2))


@pytest.mark.parametrize("name", sorted(TORI))
def test_torus_sample_matches_jax(name):
    js, ps = _tori(name)
    for jh, ph in [(js.h, ps.h)] + list(zip(js.velocity, ps.velocity)):
        np.testing.assert_array_equal(ph.cols.numpy(), np.asarray(jh.cols))
        np.testing.assert_allclose(ph.vals.numpy(), host_unpack(np.asarray(jh.vals)), rtol=0, atol=1e-15)
        np.testing.assert_allclose(ph.window, jh.window, rtol=0, atol=1e-15)
        assert (ph.norb, ph.nspin) == (jh.norb, jh.nspin)
    for attr in ("theta", "pos"):
        np.testing.assert_allclose(getattr(ps, attr), getattr(js, attr), rtol=0, atol=1e-15)
    assert ps.volume == pytest.approx(js.volume, rel=1e-15)
    assert ps.supercell == js.supercell
    assert (ps.norb, ps.nspin, ps.nsta) == (js.norb, js.nspin, js.nsta)
    # an explicit per-site disorder array
    delta = np.random.default_rng(1).uniform(-0.3, 0.3, js.norb)
    js2, ps2 = _tori(name, delta)
    np.testing.assert_allclose(ps2.h.vals.numpy(), host_unpack(np.asarray(js2.h.vals)), rtol=0, atol=1e-15)


@pytest.mark.parametrize("name,dirs", [("haldane", (0, 1)), ("haldane", (0, 0)), ("kane_mele", (1, 0))])
def test_kubo_moments_match_jax(name, dirs):
    js, ps = _tori(name)
    a, b = _ab(js.h)
    M, R = 40, 3
    key = jax.random.PRNGKey(11)
    want = host_unpack(np.asarray(jrealspace._kubo_moments_jit(
        js.h, js.velocity[dirs[0]], js.velocity[dirs[1]], jnp.array([a, b]), M, R, key)))
    x0 = torch.as_tensor(_jax_phases_per_key(key, js.nsta, R))
    ab = torch.tensor([a, b], dtype=torch.float64)
    got = realspace._kubo_moments(ps.h, ps.velocity[dirs[0]], ps.velocity[dirs[1]], ab, M, x0).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10 * np.abs(want).max())


def test_kubo_moments_in_vector_batches(monkeypatch):
    """Vectors run in batches under the block-memory cap with the same result."""
    _, ps = _tori("haldane")
    a, b = _ab(ps.h)
    ab = torch.tensor([a, b], dtype=torch.float64)
    x0 = chebyshev.phase_vectors(ps.nsta, 5, 3, "cpu")
    whole = realspace._kubo_moments(ps.h, ps.velocity[0], ps.velocity[1], ab, 24, x0)
    monkeypatch.setattr(realspace, "KUBO_BLOCK_BYTES", 3 * 24 * ps.nsta * 16 * 2)  # 2 vectors a batch
    batched = realspace._kubo_moments(ps.h, ps.velocity[0], ps.velocity[1], ab, 24, x0)
    np.testing.assert_allclose(batched.numpy(), whole.numpy(), rtol=0, atol=1e-12 * float(whole.abs().max()))


def _jax_draws_for_port(monkeypatch, per_key):
    """Make the port's public calls draw JAX's vectors for the seed."""

    def draws(nsta, R, seed, device):
        key = jax.random.PRNGKey(seed)
        x = _jax_phases_per_key(key, nsta, R) if per_key else _jax_phases(key, nsta, R)
        return torch.as_tensor(x).to(device)

    monkeypatch.setattr(chebyshev, "phase_vectors", draws)


@pytest.mark.parametrize("name", ["haldane", "kane_mele"])
def test_kpm_conductivity_matches_jax_on_its_draws(monkeypatch, name):
    js, ps = _tori(name)
    _jax_draws_for_port(monkeypatch, per_key=True)
    for kw in ({"dirs": (0, 1)}, {"dirs": (1, 1), "temperature": 0.05, "fermi_levels": np.linspace(-1, 1, 7)}):
        ej, sj = jrealspace.kpm_conductivity(js, num_moments=48, num_vectors=2, seed=4, **kw)
        ep, sp = realspace.kpm_conductivity(ps, num_moments=48, num_vectors=2, seed=4, **kw)
        np.testing.assert_array_equal(ep, ej)
        np.testing.assert_allclose(sp, sj, rtol=0, atol=1e-10 * max(1.0, np.abs(sj).max()))


@pytest.mark.parametrize("name", sorted(FLAKES))
def test_kpm_dos_matches_jax_on_its_draws(monkeypatch, name):
    jm, pm = _pair(name)
    _jax_draws_for_port(monkeypatch, per_key=False)
    ej, dj = jflows.kpm_dos(jm, num_moments=64, num_vectors=3, seed=5)
    ep, dp = flows.kpm_dos(pm, num_moments=64, num_vectors=3, seed=5)
    np.testing.assert_array_equal(ep, ej)
    np.testing.assert_allclose(dp, dj, rtol=0, atol=1e-10 * np.abs(dj).max())


def test_kpm_dos_uses_its_documented_draws():
    """kpm_dos = the Jackson reconstruction of _kpm_moments on
    phase_vectors(nsta, R, seed), and integrates to nsta."""
    with redirect_stdout(io.StringIO()):
        pm = _flake(pythtb_tpu_torch, 12)
    h = matvec.sparse_h(pm)
    a, b = _ab(h)
    e, dos = flows.kpm_dos(pm, num_moments=128, num_vectors=4, seed=9)
    x0 = chebyshev.phase_vectors(h.nsta, 4, 9, "cpu")
    np.testing.assert_allclose(x0.abs().numpy(), 1.0, rtol=0, atol=1e-15)
    mu = flows._kpm_moments(h, a, b, x0, 128).numpy()
    _, want = flows._chebyshev_density(mu, a, b, *h.window, None, 401)
    np.testing.assert_array_equal(dos, want)
    assert abs(dos.sum() * (e[1] - e[0]) - h.nsta) < 0.02 * h.nsta
    # another seed, other vectors
    assert not torch.equal(chebyshev.phase_vectors(h.nsta, 4, 10, "cpu"), x0)


@pytest.mark.parametrize("name", sorted(FLAKES))
def test_kpm_ldos_matches_jax(name):
    jm, pm = _pair(name)
    sites = [0, 7, jm._norb - 1]
    ej, lj = jrealspace.kpm_ldos(jm, sites, num_moments=96)
    ep, lp = realspace.kpm_ldos(pm, sites, num_moments=96)
    np.testing.assert_array_equal(ep, ej)
    np.testing.assert_allclose(lp, lj, rtol=0, atol=1e-10)
    assert lp.shape == (3, 401)
    de = ep[1] - ep[0]
    np.testing.assert_allclose(lp.sum(axis=1) * de, jm._nspin, atol=0.05)


def test_kpm_ldos_on_a_torus_matches_jax():
    js, ps = _tori("kane_mele")
    energies = np.linspace(-3.0, 3.0, 51)
    ej, lj = jrealspace.kpm_ldos(js, [0, 4], energies=energies, num_moments=64)
    ep, lp = realspace.kpm_ldos(ps, [0, 4], energies=energies, num_moments=64)
    np.testing.assert_allclose(lp, lj, rtol=0, atol=1e-10)


GUARDS = {
    "ldos no sites": lambda mod: mod.realspace.kpm_ldos(mod.models.chain().cut_piece(4, 0), []),
    "ldos site range": lambda mod: mod.realspace.kpm_ldos(mod.models.chain().cut_piece(4, 0), [4]),
    "ldos negative site": lambda mod: mod.realspace.kpm_ldos(mod.models.chain().cut_piece(4, 0), [-1]),
    "ldos periodic": lambda mod: mod.realspace.kpm_ldos(mod.models.chain(), [0]),
    "kpm_dos periodic": lambda mod: mod.flows.kpm_dos(mod.models.chain()),
    "torus finite": lambda mod: mod.realspace.torus_sample(mod.models.chain().cut_piece(3, 0), (2,)),
    "torus partly periodic": lambda mod: mod.realspace.torus_sample(mod.models.trestle(), (2,)),
    "torus supercell rank": lambda mod: mod.realspace.torus_sample(mod.models.haldane(), (2,)),
    "torus supercell zero": lambda mod: mod.realspace.torus_sample(mod.models.haldane(), (2, 0)),
    "torus disorder length": lambda mod: mod.realspace.torus_sample(mod.models.chain(), (3,), np.zeros(4)),
}


@pytest.mark.parametrize("name", sorted(GUARDS))
def test_guards_match_jax(name):
    from .test_torch_matvec import _outcome

    with redirect_stdout(io.StringIO()):
        want = _outcome(pythtb_tpu, GUARDS[name])
        got = _outcome(pythtb_tpu_torch, GUARDS[name])
    assert want != "ok"
    assert got == want
