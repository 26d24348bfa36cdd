"""The port's band unfolding (``unfold``) and entanglement spectra
(``entanglement``) against pythtb_tpu's, on the CPU in float64.

Unfolding weights and energies within 1e-12 of pythtb_tpu's on a
disordered supercell (no degenerate eigenspaces: a weight inside one is
basis dependent), correlation spectra and entanglement flows within
1e-12.  The oracles of tests/test_unfold.py and tests/test_entanglement.py
(pristine exactness, the Parseval sum rule, Peschel's formula against an
exact Fock-space partial trace, Fidkowski's spectral flow) run on the
port.
"""

import numpy as np
import pytest

from pythtb_tpu import entanglement as jent
from pythtb_tpu import unfold as junfold
from pythtb_tpu.models import library as jzoo
from pythtb_tpu_torch import PythtbError, entanglement, models, tb_model, unfold

from .test_entanglement import _exact_rdm_spectrum, _random_finite_chain
from .test_torch_ops import carry, on_cpu  # noqa: F401  (autouse: the port on the CPU)

TOL = 1e-12


@pytest.mark.parametrize("name,M,omap", [("graphene", np.diag([2, 3]), False),
                                         ("graphene_offdiag", np.array([[2, 1], [-1, 2]]), False),
                                         ("kane_mele", np.diag([2, 2]), False),
                                         ("graphene_map", np.diag([2, 2]), True)])
def test_unfold_matches_jax(name, M, omap):
    """Disordered supercells: energies and weights within 1e-12."""
    jm = jzoo.kane_mele() if name == "kane_mele" else jzoo.graphene(delta=0.3)
    sc = jm.make_supercell(M)
    rng = np.random.default_rng(7)
    if jm._nspin == 1:
        sc.set_onsite(0.2 * rng.standard_normal(sc._norb), mode="add")
    else:
        sc.set_onsite([0.2 * rng.standard_normal() * np.eye(2) for _ in range(sc._norb)], mode="add")
    kpts = rng.random((6, 2))
    kw = {"orbital_map": np.tile(np.arange(jm._norb), sc._norb // jm._norb)} if omap else {}
    e1, w1 = junfold.unfold_bands(sc, M, kpts, **kw)
    e2, w2 = unfold.unfold_bands(carry(sc), M, kpts, **kw)
    assert np.abs(e1 - e2).max() <= TOL and np.abs(w1 - w2).max() <= TOL
    np.testing.assert_allclose(w2.sum(axis=1), jm._norb * jm._nspin, atol=1e-9)


def _pristine_check(model, M, kpts, atol=1e-8):
    """A pristine supercell unfolds to the primitive bands with unit
    weight per distinct energy (summed over degenerate clusters) and zero
    elsewhere."""
    sc = model.make_supercell(M)
    evals, w = unfold.unfold_bands(sc, M, kpts)
    prim = model.solve_all(kpts).T
    for b in range(kpts.shape[0]):
        np.testing.assert_allclose(w[b].sum(), prim.shape[1], atol=1e-9)
        left = np.ones(evals.shape[1], dtype=bool)
        for e0 in np.unique(np.round(prim[b], 9)):
            mult = int(np.sum(np.abs(prim[b] - e0) < 1e-8))
            sel = np.abs(evals[b] - e0) < 1e-7
            assert sel.any()
            np.testing.assert_allclose(w[b][sel].sum(), mult, atol=atol)
            left &= ~sel
        if left.any():
            assert np.abs(w[b][left]).max() < atol


def test_pristine_supercells():
    _pristine_check(models.graphene(), np.diag([2, 3]), np.array([[0.1, 0.2], [0.31, 0.05], [0.45, 0.41]]))
    _pristine_check(models.graphene(delta=0.3), np.array([[2, 1], [-1, 2]]), np.array([[0.12, 0.07], [0.4, 0.33]]))
    _pristine_check(models.kane_mele(), np.diag([2, 2]), np.array([[0.15, 0.22], [0.4, 0.1]]))


def test_unfold_errors():
    sc = models.graphene().make_supercell(np.diag([2, 2]))
    for M, k, kw in [(np.diag([2, 2, 2]), np.zeros((1, 2)), {}), (np.diag([3, 3]), np.zeros((1, 2)), {}),
                     (np.diag([2, 2]), np.zeros((1, 3)), {}),
                     (np.diag([2, 2]), np.zeros((1, 2)), {"orbital_map": np.zeros(5, dtype=int)})]:
        with pytest.raises(PythtbError):
            unfold.unfold_bands(sc, M, k, **kw)


@pytest.mark.parametrize("n,nocc,sites", [(4, 2, [0, 1]), (6, 3, [0, 2, 4])])
def test_correlation_spectrum_matches_jax_and_peschel(n, nocc, sites):
    """The correlation spectrum within 1e-12 of pythtb_tpu's, and its
    Peschel products equal the exact Fock-space RDM spectrum."""
    jm = _random_finite_chain(n, seed=n)
    xi = entanglement.correlation_spectrum(carry(jm), nocc, sites)
    assert np.abs(xi - jent.correlation_spectrum(jm, nocc, sites)).max() <= TOL
    levels = [1.0]
    for x in xi:
        levels = [v * (1.0 - x) for v in levels] + [v * x for v in levels]
    pred = np.sort(np.array(levels))[::-1]
    exact = _exact_rdm_spectrum(jm, nocc, sites)
    m = max(len(pred), len(exact))
    pe, ex = np.zeros(m), np.zeros(m)
    pe[: len(pred)], ex[: len(exact)] = pred, exact
    np.testing.assert_allclose(pe, ex, atol=1e-10)


def test_complementary_cut_and_atomic_limit():
    m = carry(_random_finite_chain(8, seed=3))
    xa = entanglement.correlation_spectrum(m, 4, [0, 1, 2])
    xb = entanglement.correlation_spectrum(m, 4, [3, 4, 5, 6, 7])
    nta = np.sort(xa[(xa > 1e-9) & (xa < 1 - 1e-9)])
    ntb = np.sort(1.0 - xb[(xb > 1e-9) & (xb < 1 - 1e-9)])
    np.testing.assert_allclose(nta, ntb, atol=1e-9)
    np.testing.assert_allclose(entanglement.entanglement_entropy(xa), entanglement.entanglement_entropy(xb), atol=1e-9)
    a = tb_model(0, 1, lat=[[1.0]], orb=[[0.0], [0.3], [0.7]])
    a.set_onsite([-1.0, 0.5, 2.0])
    xi = entanglement.correlation_spectrum(a, 1, [0, 1])
    np.testing.assert_allclose(np.sort(xi), [0.0, 1.0], atol=1e-12)
    assert entanglement.entanglement_entropy(xi) < 1e-10


@pytest.mark.parametrize("name,occ,L", [("haldane", [0], 8), ("kane_mele", [0, 1], 4)])
def test_entanglement_flow_matches_jax(name, occ, L):
    """Entanglement flows within 1e-12 of pythtb_tpu's (nspin 1 and 2)."""
    jm = jzoo.haldane() if name == "haldane" else jzoo.kane_mele()
    k1, x1 = jent.entanglement_flow(jm, occ, 0, L=L, nk=9)
    k2, x2 = entanglement.entanglement_flow(carry(jm), occ, 0, L=L, nk=9)
    assert np.array_equal(k1, k2) and np.abs(x1 - x2).max() <= TOL


def test_chern_flow_gapless_trivial_gapped_and_kramers():
    _, xi_t = entanglement.entanglement_flow(models.haldane(), [0], 0, L=12, nk=31)
    assert np.abs(xi_t - 0.5).min() < 0.02
    _, xi_0 = entanglement.entanglement_flow(models.graphene(delta=1.5), [0], 0, L=12, nk=31)
    assert np.abs(xi_0 - 0.5).min() > 0.2
    kpar, xi = entanglement.entanglement_flow(models.kane_mele(), [0, 1], 0, L=6, nk=21)
    for ik in (0, 10, 20):
        nt = xi[ik][(xi[ik] > 1e-6) & (xi[ik] < 1 - 1e-6)]
        pairs = nt.reshape(-1, 2)
        np.testing.assert_allclose(pairs[:, 0], pairs[:, 1], atol=1e-8)


def test_entanglement_errors():
    m = models.haldane()
    fin = m.cut_piece(3, 0).cut_piece(3, 1)
    with pytest.raises(PythtbError):
        entanglement.correlation_spectrum(m, 1, [0])
    with pytest.raises(PythtbError):
        entanglement.correlation_spectrum(fin, 0, [0])
    with pytest.raises(PythtbError):
        entanglement.correlation_spectrum(fin, 1, [0, 0])
    with pytest.raises(PythtbError):
        entanglement.entanglement_flow(m, [0], 0, L=4, LA=4)
    with pytest.warns(UserWarning):
        entanglement.entanglement_flow(models.graphene(), [0], 0, L=6, nk=7)
