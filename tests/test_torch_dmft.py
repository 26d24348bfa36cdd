"""The port's DMFT (``dmft``) against pythtb_tpu's, on the CPU in float64,
where kernel 20 (and kernels 1 and 16) run their plain versions.

* Kernel 20's four modes (plain) against the JAX programs they replace,
  on the same numpy-seeded inputs, at 1e-12 (relative to the largest
  entry).
* The ED impurity solver on the same bath: G_imp and the observables at
  1e-12.
* Whole self-consistent runs (Bethe at 32 frequencies and 2 bath sites,
  a three-orbital lattice at nk 4): same iteration count, Z and the
  double occupancy at 1e-8 where the bath fit lands on the same minimum;
  at U 3 the L-BFGS-B fit of the two runs stops at minima that part by
  ~1e-6 (two correct runs of the optimizer take different iterates from
  1e-15 differences), so that point is held at the bench pins'
  tolerance (Z 5e-3, docc 2e-3); a doped lattice run's mu and Sigma
  after three iterations (three fits) at 1e-8 and 1e-6.
* Real-axis observables (``band_spectral`` plain and resolved,
  ``local_spectral``, ``sigma_real``, ``spectral``) on the identical
  converged state carried across by ``convert.dmft_result_from_numpy``,
  at 1e-12.
"""

import warnings

import numpy as np
import pytest
import torch

import pythtb_tpu as jpt
from pythtb_tpu import dmft as jdmft
from pythtb_tpu.utils.xfer import host_pack, host_unpack
from pythtb_tpu_torch import PythtbError, convert, dmft
from pythtb_tpu_torch.ops import pole_sum

from .test_torch_ops import carry, on_cpu, state_of  # noqa: F401  (autouse: the port on the CPU)

TOL = 1e-12


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max()) / max(1.0, float(np.abs(want).max()))


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


def _schur_inputs(seed, Nk=48, nv=3, nw=40):
    rng = np.random.default_rng(seed)
    epso = rng.normal(size=Nk)
    lams = rng.normal(size=(Nk, nv)) * 2.0
    W = rng.normal(size=(Nk, nv, nv)) + 1j * rng.normal(size=(Nk, nv, nv))
    W, _ = np.linalg.qr(W)
    b = 0.5 * (rng.normal(size=(Nk, nv)) + 1j * rng.normal(size=(Nk, nv)))
    sig = 0.3 * rng.normal(size=nw) - 0.2j * np.abs(rng.normal(size=nw))
    om = np.linspace(-4.0, 4.0, nw)
    return epso, lams, W, b, sig, om


def test_pole_sum_modes_match_jax_programs():
    epso, lams, W, b, sig, om = _schur_inputs(0)
    amps = np.abs(b) ** 2
    mu, eta = 0.35, 0.07
    wn = (2.0 * np.arange(len(om)) + 1.0) * np.pi / 10.0
    zm = _t(mu + 1j * wn)
    zr = _t((om + mu) + 1j * eta)
    # k-mean mode, Matsubara and real axis
    want = host_unpack(np.asarray(jdmft._gloc_pole_jit(epso, amps, lams, wn, mu, host_pack(sig))))
    assert _rel(pole_sum.lattice_gloc(_t(epso), _t(amps), _t(lams), zm, _t(sig)).numpy(), want) <= TOL
    want = host_unpack(np.asarray(jdmft._gloc_real_pole_jit(epso, amps, lams, om, eta, mu, host_pack(sig))))
    assert _rel(pole_sum.lattice_gloc(_t(epso), _t(amps), _t(lams), zr, _t(sig)).numpy(), want) <= TOL
    # map and resolved modes
    want = np.asarray(jdmft._aspec_pole_jit(epso, amps, lams, om, eta, mu, host_pack(sig)))
    assert _rel(pole_sum.spectral_map(_t(epso), _t(amps), _t(lams), zr, _t(sig)).numpy(), want) <= TOL
    jo, jv = jdmft._aspec_full_jit(epso, lams, host_pack(W), host_pack(b), om, eta, mu, host_pack(sig))
    po, pv = pole_sum.spectral_resolved(_t(epso), _t(lams), _t(W), _t(b), zr, _t(sig))
    assert _rel(po.numpy(), np.asarray(jo)) <= TOL and _rel(pv.numpy(), np.asarray(jv)) <= TOL
    # pole mode: the Bethe quadrature on both axes and the Lehmann sum
    nodes, weights = np.cos(np.linspace(0.1, 3.0, 64)) * 2.0, np.full(64, 1.0 / 64)
    want = host_unpack(np.asarray(jdmft._gloc_bethe_jit(nodes, weights, wn, mu, host_pack(sig))))
    assert _rel(pole_sum.pole_sum(_t(weights), _t(nodes), zm - _t(sig)).numpy(), want) <= TOL
    want = host_unpack(np.asarray(jdmft._gloc_real_bethe_jit(nodes, weights, om, eta, mu, host_pack(sig))))
    assert _rel(pole_sum.pole_sum(_t(weights), _t(nodes), zr - _t(sig)).numpy(), want) <= TOL
    a, p = np.abs(np.random.default_rng(1).normal(size=300)), np.random.default_rng(2).normal(size=300)
    want = jdmft._lehmann_matsubara(a, p, wn)
    assert _rel(dmft._lehmann_matsubara(a, p, wn), want) <= TOL


def test_aim_solve_matches_jax():
    wn = dmft.matsubara(20.0, 32)
    assert np.array_equal(wn, jdmft.matsubara(20.0, 32))
    for U, eb, vb in ((3.0, [-1.0, 1.0], [0.6, 0.6]), (1.5, [-0.8, 0.1, 1.3], [0.5, 0.3, 0.7]), (2.0, [], [])):
        g, info = dmft._aim_solve(-0.5 * U, U, np.array(eb), np.array(vb), 20.0, wn)
        jg, jinfo = jdmft._aim_solve(-0.5 * U, U, np.array(eb), np.array(vb), 20.0, wn)
        assert _rel(g, jg) <= TOL
        for key in ("n_imp", "docc"):
            assert abs(info[key] - jinfo[key]) <= TOL
        assert np.array_equal(info["poles"], jinfo["poles"])


def _quiet(fn, *args, **kwargs):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn(*args, **kwargs)


@pytest.mark.parametrize("U,tol", [(1.0, 1e-8), (3.0, None), (5.0, 1e-8)])
def test_bethe_fixed_point_matches_jax(U, tol):
    kw = dict(beta=20.0, n_matsubara=32, n_bath=2, max_iter=40)
    a = _quiet(jdmft.bethe, U, **kw)
    b = _quiet(dmft.bethe, U, **kw)
    assert a.converged and b.converged
    if tol is None:  # the bench pins' tolerance (see the module docstring)
        assert abs(b.Z - a.Z) < 5e-3 and abs(b.docc - a.docc) < 2e-3
    else:
        assert b.iterations == a.iterations
        assert abs(b.Z - a.Z) <= tol and abs(b.docc - a.docc) <= tol


def _three_orbital():
    """One correlated square-lattice orbital and two spectators (the shape
    of the dmft_arpes row, cut to three orbitals)."""
    m = jpt.tb_model(2, 2, [[1.0, 0.0], [0.0, 1.0]], [[0.0, 0.0]] * 3)
    m.set_onsite([0.0, -2.0, 2.5])
    for o in range(3):
        m.set_hop(-1.0 if o == 0 else -0.4, o, o, [1, 0])
        m.set_hop(-1.0 if o == 0 else -0.4, o, o, [0, 1])
    m.set_hop(0.25, 0, 1, [0, 0])
    m.set_hop(0.3, 0, 2, [1, 0])
    return m


def test_lattice_fixed_point_matches_jax():
    jm = _three_orbital()
    kw = dict(beta=10.0, nk=[4, 4], n_matsubara=32, n_bath=2, max_iter=30)
    a = _quiet(jdmft.solve, jm, 2.0, **kw)
    b = _quiet(dmft.solve, carry(jm), 2.0, **kw)
    assert b.converged == a.converged and b.iterations == a.iterations
    assert abs(b.Z - a.Z) <= 1e-8 and abs(b.docc - a.docc) <= 1e-8
    # a doped run: mu re-bisected every iteration on the lattice filling
    kw = dict(beta=10.0, nk=[4, 4], n_matsubara=32, n_bath=2, max_iter=3, filling=0.9)
    a = _quiet(jdmft.solve, jm, 2.0, **kw)
    b = _quiet(dmft.solve, carry(jm), 2.0, **kw)
    assert abs(b.mu - a.mu) <= 1e-8 and _rel(b.sigma, a.sigma) <= 1e-6


def _carry_result(r):
    state = {key: getattr(r, key) for key in ("wn", "sigma", "g_loc", "g_imp", "g0_inv", "mu", "eps_d", "bath",
                                              "beta", "U", "n_imp", "docc", "iterations", "converged",
                                              "sc_residual", "fit_err", "history")}
    state.update(amps=r._amps, poles=r._poles, orb=r._orb, real_axis=r._real_axis)
    return convert.dmft_result_from_numpy(state, None if r._model is None else state_of(r._model))


def test_real_axis_observables_on_carried_state():
    jm = _three_orbital()
    a = _quiet(jdmft.solve, jm, 2.0, beta=10.0, nk=[4, 4], n_matsubara=32, n_bath=2, max_iter=30)
    b = _carry_result(a)
    assert b.Z == a.Z
    om = np.linspace(-6.0, 6.0, 81)
    kp = np.random.default_rng(3).random((11, 2))
    assert _rel(dmft.band_spectral(b, kp, om, eta=0.15), jdmft.band_spectral(a, kp, om, eta=0.15)) <= TOL
    got = dmft.band_spectral(b, kp, om, eta=0.15, eta_sigma=0.2, resolved=True)
    assert _rel(got, jdmft.band_spectral(a, kp, om, eta=0.15, eta_sigma=0.2, resolved=True)) <= TOL
    assert _rel(b.local_spectral(om, eta=0.1), a.local_spectral(om, eta=0.1)) <= TOL
    assert _rel(b.sigma_real(om), a.sigma_real(om)) <= TOL
    assert _rel(b.spectral(om), a.spectral(om)) <= TOL
    # the Bethe lattice's quadrature on the real axis
    a = _quiet(jdmft.bethe, 2.0, beta=20.0, n_matsubara=32, n_bath=2, max_iter=5, n_quad=128)
    b = _carry_result(a)
    assert _rel(b.local_spectral(om, eta=0.1), a.local_spectral(om, eta=0.1)) <= TOL
    with pytest.raises(PythtbError, match="lattice DMFTResult"):
        dmft.band_spectral(b, kp, om)
