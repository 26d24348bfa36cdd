"""The port's spectrum-slice solver (``flows.solve_window``, its Wilson
and Chern windows) against pythtb_tpu's, on the CPU in float64.

``solve_window`` draws its start block with ``np.random.default_rng(seed)``
in both packages, so the same seed gives the same block: eigenvalues
agree to 1e-10 and the projectors onto the selected subspace to 1e-8
(eigenvectors of degenerate multiplets are compared only through
projectors).  Kernel 11's plain version runs the filter here.
"""

import io
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

import pythtb_tpu
import pythtb_tpu_torch
from pythtb_tpu import flows as jflows
from pythtb_tpu.models import library as jzoo
from pythtb_tpu.models import moire as jmoire
from pythtb_tpu_torch import PythtbError, flows
from pythtb_tpu_torch.ops import chebyshev, hamiltonian, matvec

from .test_torch_ops import carry, on_cpu  # noqa: F401  (autouse: the port on the CPU)


def _projector(vecs, kk):
    v = np.asarray(vecs).reshape(kk, -1)
    return v.T @ v.conj()


WINDOW_CASES = {
    "haldane flake, finite": (
        lambda: jzoo.haldane().cut_piece(6, 0, glue_edgs=False).cut_piece(6, 1, glue_edgs=False),
        dict(num_states=6, sigma=0.37, seed=1)),
    "kane_mele 3x3 cell at k": (
        lambda: jzoo.kane_mele(esite=0.7, rashba=0.3).make_supercell([[3, 0], [0, 3]]),
        dict(num_states=4, sigma=0.5, k_point=np.array([0.31, 0.17]), seed=2)),
    "kane_mele 2x2 cell, strong SOC, pinned width": (
        lambda: jzoo.kane_mele(esite=0.7, spin_orb=1.5, rashba=0.3).make_supercell([[2, 0], [0, 2]]),
        dict(num_states=4, sigma=0.5, k_point=np.array([0.31, 0.17]), width=0.8, seed=2)),
}


@pytest.mark.parametrize("name", sorted(WINDOW_CASES))
def test_solve_window_matches_jax(name):
    build, kw = WINDOW_CASES[name]
    jm = build()
    wj, vj = jflows.solve_window(jm, eig_vectors=True, **kw)
    wp, vp = flows.solve_window(carry(jm), eig_vectors=True, **kw)
    assert vp.shape == np.shape(vj)
    np.testing.assert_allclose(wp, wj, rtol=0, atol=1e-10)
    kk = kw["num_states"]
    np.testing.assert_allclose(_projector(vp, kk), _projector(vj, kk), rtol=0, atol=1e-8)


def test_sparse_h_k_matches_assemble():
    m = carry(jzoo.kane_mele(esite=0.7, rashba=0.3))
    k = np.array([0.31, 0.17])
    H = hamiltonian.assemble(m._get_finalized(), torch.as_tensor(k[None]))[0].numpy()
    np.testing.assert_allclose(matvec.to_dense(matvec.sparse_h_k(m, k)), H, rtol=0, atol=1e-14)


@pytest.mark.parametrize("mtbg", [2, 4])
def test_tbg_middle_four(mtbg):
    """The four states nearest mid-gap at the moire K point: the slice
    solver against the dense spectrum of the same cell (and against the
    JAX solver at m = 2)."""
    with redirect_stdout(io.StringIO()):
        t = pythtb_tpu_torch.models.tbg(mtbg)
    n = t._nsta
    K = np.array([1.0 / 3.0, 2.0 / 3.0])
    ev = t.solve_all(np.array([K]))[:, 0]
    sig = 0.5 * (ev[n // 2 - 1] + ev[n // 2])
    w = flows.solve_window(t, 4, sig, k_point=K, block=12, seed=0)
    exact = np.sort(ev[np.argsort(np.abs(ev - sig), kind="stable")[:4]])
    np.testing.assert_allclose(w, exact, rtol=0, atol=1e-9)
    if mtbg == 2:
        wj = jflows.solve_window(jmoire.tbg(2), 4, sig, k_point=K, block=12, seed=0)
        np.testing.assert_allclose(w, wj, rtol=0, atol=1e-10)


def test_filter_plain_matches_the_scan():
    """Kernel 11's plain version is the JAX scan: Y = sum c_m T_m(Ht) X,
    checked against T_m from the three-term recursion on a dense H."""
    m = carry(jzoo.haldane().cut_piece(3, 0).cut_piece(3, 1))
    h = matvec.sparse_h(m)
    lo, hi = h.window
    a, b = 0.5 * (hi - lo) / 0.98, 0.5 * (hi + lo)
    Ht = (matvec.to_dense(h) - b * np.eye(h.nsta)) / a
    rng = np.random.default_rng(5)
    X = rng.normal(size=(h.nsta, 3)) + 1j * rng.normal(size=(h.nsta, 3))
    coef = rng.normal(size=9)
    T = [X, Ht @ X]
    for _ in range(7):
        T.append(2 * Ht @ T[-1] - T[-2])
    want = sum(c * t for c, t in zip(coef, T))
    got = chebyshev.filter(h, torch.tensor([a, b], dtype=torch.float64), torch.as_tensor(coef),
                           torch.as_tensor(X))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)
    with pytest.raises(ValueError):
        chebyshev.filter(h, torch.tensor([a, b], dtype=torch.float64), torch.as_tensor(coef[:1]),
                         torch.as_tensor(X))


def test_wilson_window_on_folded_ssh():
    jm = jzoo.ssh(t=1.0, delta=0.4).make_supercell([[6]])
    loop = np.linspace(0, 1, 13)[:, None]
    evk = np.asarray(jm.solve_all(loop[:1]))[:, 0]
    sigma = float(evk[:6].mean())
    pm = carry(jm)
    ref = jflows.wilson_window(jm, sigma, 6, loop, block=8, seed=3)
    w = flows.wilson_window(pm, sigma, 6, loop, block=8, seed=3)
    assert abs(w - ref) < 1e-9
    we = flows.wilson_window(pm, sigma, 6, loop, block=8, berry_evals=True, seed=3)
    np.testing.assert_allclose(we, jflows.wilson_window(jm, sigma, 6, loop, block=8, berry_evals=True,
                                                        seed=3), rtol=0, atol=1e-9)
    # the folded chain's Zak ladder: 2 pi / 6 steps
    np.testing.assert_allclose(np.diff(we), 2 * np.pi / 6, atol=1e-9)


def test_chern_window_matches_chern_number():
    """Both manifolds against the JAX chern_window on the same model and
    seed (its host link loop and periodic-gauge rows), and against the
    port's own chern_number."""
    jm = jzoo.haldane().make_supercell([[2, 0], [0, 2]])
    m = carry(jm)
    evk = m.solve_all(np.array([[0.13, 0.21]]))[:, 0]
    ref = flows.chern_number(m, [0, 1, 2, 3], nk=(31, 31))
    for sigma, sign in ((float(evk[:4].mean()), 1.0), (float(evk[4:].mean()), -1.0)):
        cw = flows.chern_window(m, sigma, 4, nk=(6, 6), block=6, seed=1)
        assert abs(cw - jflows.chern_window(jm, sigma, 4, nk=(6, 6), block=6, seed=1)) < 1e-10
        assert abs(cw - sign * ref) < 1e-6


def test_guards():
    """The errors and warnings of tests/test_matvec_solvers.py's
    TestSolveWindow / TestWilsonWindow / chern_window, on the port."""
    m = carry(jzoo.haldane())
    flake = m.cut_piece(3, 0, glue_edgs=False).cut_piece(3, 1, glue_edgs=False)
    with pytest.raises(PythtbError):
        flows.solve_window(m, 2, 0.0)  # periodic without k_point
    with pytest.raises(PythtbError):
        matvec.sparse_h_k(flake, [0.0])  # finite model
    with pytest.raises(ValueError):
        flows.solve_window(flake, 2, 99.0)  # sigma outside the window
    with pytest.raises(ValueError):
        flows.solve_window(flake, 12, 0.0)  # block >= nsta
    with pytest.raises(ValueError):
        flows.solve_window(flake, 2, 0.0, block=2)  # block <= num_states
    with pytest.raises(ValueError):
        flows.solve_window(flake, 0, 0.0)
    km = carry(jzoo.kane_mele(esite=0.7, spin_orb=1.5, rashba=0.3).make_supercell([[2, 0], [0, 2]]))
    with pytest.raises(ValueError):
        flows.solve_window(km, 4, 0.5, k_point=np.array([0.31, 0.17]), max_rounds=0)
    with pytest.warns(UserWarning, match="residual"):
        flows.solve_window(flake, 2, 0.1, max_rounds=1, degree=32)
    # two decoupled crossing bands: the single state nearest sigma swaps
    # character at the crossing, so a link determinant vanishes
    c = pythtb_tpu_torch.tb_model(1, 1, [[1.0]], [[0.0], [0.25], [0.5], [0.75]])
    c.set_onsite([0.0, 0.1, 3.0, -3.0])
    c.set_hop(1.0, 0, 0, [1])
    c.set_hop(-1.0, 1, 1, [1])
    loop = np.linspace(0, 1, 13)[:, None]
    with pytest.warns(UserWarning, match="near-singular link"):
        flows.wilson_window(c, 1.0, 1, loop, block=3, seed=3)
    with pytest.raises(PythtbError):
        flows.wilson_window(c, 0.0, 2, loop[:2], block=3)  # L < 3
    with pytest.raises(PythtbError):
        flows.wilson_window(c, 0.0, 2, np.concatenate([loop[:-1], [[0.37]]], axis=0), block=3)
    with pytest.raises(PythtbError):
        flows.chern_window(carry(jzoo.ssh()), 0.0, 1, nk=(8, 8))  # dim_k != 2
    with pytest.raises(PythtbError):
        flows.chern_window(m, 0.0, 1, nk=(2, 8))
