"""Model construction in the port and its wf_array helpers, against pythtb_tpu's.

The same sequence of calls goes to both packages (set/reset/add modes,
spinor blocks given as scalars, Pauli 4-vectors and 2x2 matrices,
allowed conjugate pairs); the models must then give the same
Hamiltonians, bands and helpers, and refuse the same misuse with the
same message.  Eigenvalues and H(k) agree to 1e-12, phases to 1e-10
(modulo 2 pi).
"""

import numpy as np
import pytest

import pythtb_tpu
import pythtb_tpu_torch

from .test_torch_ops import on_cpu  # noqa: F401  (autouse: the port on the CPU)

ATOL = 1e-12
PHASE_TOL = 1e-10


def _build(mod, nspin):
    lat = [[1.0, 0.2], [0.0, 1.1]]
    orb = [[0.0, 0.0], [0.5, 0.3], [0.2, 0.7]]
    m = mod.tb_model(2, 2, lat, orb, nspin=nspin)
    if nspin == 1:
        m.set_onsite([0.3, -0.2, 0.1])
        m.set_onsite(0.5, 1, mode="reset")
        m.set_onsite(0.25, 2, mode="add")
        amp = 0.4 - 0.1j
    else:
        m.set_onsite([[0.3, 0.0, 0.0, 0.1], 0.2, np.array([[0.1, 0.05j], [-0.05j, -0.1]])])
        m.set_onsite([0.0, 0.2, 0.0, 0.0], 1, mode="add")
        amp = [0.4, 0.1, -0.2, 0.05]
    m.set_hop(amp, 0, 1, [0, 0])
    m.set_hop(-0.7, 1, 2, [1, 0])
    m.set_hop(0.3j, 0, 0, [0, 1])
    m.set_hop(0.2, 2, 0, [-1, 1])
    m.set_hop(0.5, 1, 2, [1, 0], mode="reset")
    m.set_hop(0.1 + 0.2j, 2, 0, [-1, 1], mode="add")
    m.set_hop(0.15, 1, 0, [0, 0], allow_conjugate_pair=True)
    return m


@pytest.mark.parametrize("nspin", [1, 2])
def test_model_construction_matches_jax(nspin):
    jm, pm = _build(pythtb_tpu, nspin), _build(pythtb_tpu_torch, nspin)
    k = np.random.default_rng(nspin).uniform(-1.0, 1.0, (7, 2))
    np.testing.assert_allclose(pm.gen_ham(k), jm.gen_ham(k), rtol=0, atol=ATOL)
    np.testing.assert_allclose(pm.solve_all(k), jm.solve_all(k), rtol=0, atol=ATOL)
    np.testing.assert_allclose(pm.solve_one(k[2]), jm.solve_one(k[2]), rtol=0, atol=ATOL)
    w, v = pm.solve_one(k[3], eig_vectors=True)
    assert v.shape == jm.solve_one(k[3], eig_vectors=True)[1].shape
    H = pm.gen_ham([k[3]])[0]
    vf = v.reshape(v.shape[0], -1)
    assert np.abs(vf @ H.T - w[:, None] * vf).max() < 10 * ATOL  # rows are states
    assert pm.get_num_orbitals() == jm.get_num_orbitals()
    np.testing.assert_array_equal(pm.get_orb(), jm.get_orb())
    np.testing.assert_array_equal(pm.get_lat(), jm.get_lat())
    np.testing.assert_array_equal(pm.k_uniform_mesh([3, 4]), jm.k_uniform_mesh([3, 4]))


MISUSE = {
    "onsite_via_set_hop": lambda m: m.set_hop(1.0, 0, 0, [0, 0]),
    "implied_conjugate": lambda m: m.set_hop(1.0, 1, 0, [0, 0]),
    "hop_set_twice": lambda m: m.set_hop(1.0, 0, 1, [0, 0]),
    "onsite_set_twice": lambda m: m.set_onsite(1.0, 0),
    "bad_mode": lambda m: m.set_hop(1.0, 0, 2, [0, 0], mode="replace"),
    "index_out_of_range": lambda m: m.set_hop(1.0, 0, 3, [0, 0]),
    "missing_R": lambda m: m.set_hop(1.0, 0, 2),
    "short_R": lambda m: m.set_hop(1.0, 0, 2, [0]),
    "complex_onsite": lambda m: m.set_onsite(1.0j, 0, mode="reset"),
    "solve_without_k": lambda m: m.solve_all(),
}


@pytest.mark.parametrize("case", sorted(MISUSE))
def test_model_refuses_misuse_like_jax(case):
    msgs = []
    for mod in (pythtb_tpu, pythtb_tpu_torch):
        with pytest.raises(mod.PythtbError) as err:
            MISUSE[case](_build(mod, 1))
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


def test_hand_filled_loop_and_energies():
    """A closed k-loop filled point by point (solve_on_one_point +
    impose_loop), hand-set energies and band_separation, in both."""
    out = []
    for mod in (pythtb_tpu, pythtb_tpu_torch):
        m = _build(mod, 1)
        n = 9
        wf = mod.wf_array(m, [n])
        for i in range(n - 1):
            theta = 2.0 * np.pi * i / (n - 1)
            wf.solve_on_one_point([0.2 * np.cos(theta), 0.2 * np.sin(theta)], i)
        wf.impose_loop(0)
        wf.energies = np.stack([m.solve_one([0.2 * np.cos(t), 0.2 * np.sin(t)])
                                for t in 2.0 * np.pi * np.arange(n) / (n - 1)])
        out.append((wf.berry_phase([0]), wf.berry_phase([0, 1], berry_evals=True),
                    wf.band_separation([0])))
    (pj, ej, sj), (pp, ep, sp) = out
    assert abs(np.angle(np.exp(1j * (pp - pj)))) < PHASE_TOL
    np.testing.assert_allclose(np.sort(np.angle(np.exp(1j * ep))),
                               np.sort(np.angle(np.exp(1j * ej))), rtol=0, atol=PHASE_TOL)
    assert sp == pytest.approx(sj, abs=ATOL)
