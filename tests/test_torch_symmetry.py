"""The port's symmetry tooling (``symmetry``: a host NumPy copy on the
port's tb_model, whose ``gen_ham`` and ``solve_one`` run on the device)
against pythtb_tpu's, on the CPU in float64.

The same operations (W, tau, permutation, order, determinant) are found,
little-group eigenvalues agree within 1e-10, Chern indicators are equal,
and symmetrized models give the same spectra within 1e-10.  The oracles
of tests/test_symmetry.py (point groups, roots of unity, the indicator
against the port's integrated Chern number) run on the port.
"""

import numpy as np
import pytest

from pythtb_tpu import symmetry as jsym
from pythtb_tpu.models import library as jzoo
from pythtb_tpu_torch import PythtbError, flows, models, symmetry, tb_model

from .test_torch_ops import carry, on_cpu  # noqa: F401  (autouse: the port on the CPU)


def _key(op):
    return (op.W.tolist(), np.round(op.tau, 9).tolist(), list(op.perm), op.order, op.det)


@pytest.mark.parametrize("name,kw", [("haldane", {}), ("haldane0", {}), ("graphene", {}),
                                     ("qwz", {"l": [0, 1]}), ("kane_mele", {})])
def test_find_symmetries_matches_jax(name, kw):
    jm = {"haldane": jzoo.haldane(), "haldane0": jzoo.haldane(delta=0.0), "graphene": jzoo.graphene(),
          "qwz": jzoo.qwz(1.0), "kane_mele": jzoo.kane_mele(esite=0.0, rashba=0.0)}[name]
    a = jsym.find_symmetries(jm, **kw)
    b = symmetry.find_symmetries(carry(jm), **kw)
    assert [_key(o) for o in a] == [_key(o) for o in b]
    assert jsym.point_group(jm, **kw)[0] == symmetry.point_group(carry(jm), **kw)[0]


@pytest.mark.parametrize("name,kpt,occ", [("haldane", [1 / 3.0, 2 / 3.0], [0]),
                                          ("kane_mele", [0.0, 0.0], [0, 1])])
def test_symmetry_eigenvalues_match_jax(name, kpt, occ):
    jm = jzoo.haldane() if name == "haldane" else jzoo.kane_mele(esite=0.0, rashba=0.0)
    jop = [o for o in jsym.find_symmetries(jm) if o.order == 3 and o.det > 0][0]
    op = [o for o in symmetry.find_symmetries(carry(jm)) if _key(o) == _key(jop)][0]
    ev1, d1 = jsym.symmetry_eigenvalues(jm, jop, kpt, occ=occ)
    ev2, d2 = symmetry.symmetry_eigenvalues(carry(jm), op, kpt, occ=occ)
    assert np.abs(np.sort_complex(ev1) - np.sort_complex(ev2)).max() <= 1e-10
    assert abs(d1 - d2) <= 1e-10


@pytest.mark.parametrize("name", ["haldane", "haldane_flip", "bn", "qwz", "qwz_trivial"])
def test_chern_indicator_matches_jax_and_the_integrated_chern(name):
    jm, kw = {"haldane": (jzoo.haldane(), {}),
              "haldane_flip": (jzoo.haldane(t2=0.15 * np.exp(-0.5j * np.pi)), {}),
              "bn": (jzoo.bn(delta=0.6), {}), "qwz": (jzoo.qwz(1.0), {"l": [0, 1]}),
              "qwz_trivial": (jzoo.qwz(2.5), {"l": [0, 1]})}[name]
    a = jsym.chern_indicator(jm, occ=[0], **kw)
    b = symmetry.chern_indicator(carry(jm), occ=[0], **kw)
    assert (a["n"], a["c_mod_n"]) == (b["n"], b["c_mod_n"])
    C = flows.chern_number(carry(jm), [0], nk=(31, 31))
    assert abs(C - round(C)) < 1e-6 and b["c_mod_n"] == int(round(C)) % b["n"]


def test_symmetrize_matches_jax_and_is_a_projection():
    jm = jzoo.haldane()
    ks = np.random.default_rng(3).random((16, 2))
    js = jsym.symmetrize(jm, jsym.find_symmetries(jm))
    ts = symmetry.symmetrize(carry(jm), symmetry.find_symmetries(carry(jm)))
    np.testing.assert_allclose(ts.solve_all(ks), js.solve_all(ks), atol=1e-10)
    np.testing.assert_allclose(ts.solve_all(ks), carry(jm).solve_all(ks), atol=1e-10)


def test_symmetrized_random_square_model():
    """A random square-lattice model averaged over C4: the rotation is
    found again and the indicator matches the integrated Chern number."""
    rng = np.random.default_rng(100)
    orb = [[0.0, 0.0], [0.5, 0.5]]
    m = tb_model(2, 2, [[1, 0], [0, 1]], orb)
    m.set_onsite(list(rng.normal(size=2)))
    for i, j, R in [(0, 1, [0, 0]), (0, 0, [1, 0]), (1, 1, [0, 1]), (0, 1, [1, -1])]:
        m.set_hop(rng.normal() + 1j * rng.normal(), i, j, R)
    W = np.array([[0, 1], [-1, 0]])
    pm = symmetry._orbit_map(np.asarray(orb), W, np.zeros(2))
    op = symmetry.SymmetryOp(W, np.zeros(2), pm[0], pm[1], np.asarray(m._lat), np.ones(2, complex))
    ms = symmetry.symmetrize(m, [symmetry._op_power(op, k, np.asarray(m._lat)) for k in range(1, 4)])
    assert any(o.order == 4 and o.det > 0 for o in symmetry.find_symmetries(ms))
    ev = ms.solve_all(np.random.default_rng(0).random((64, 2)))
    assert float((ev[1] - ev[0]).min()) > 0.05
    res = symmetry.chern_indicator(ms, occ=[0])
    C = flows.chern_number(ms, [0], nk=(41, 41))
    assert abs(C - round(C)) < 1e-6 and res["c_mod_n"] == int(round(C)) % res["n"]


def test_oracles_on_the_port():
    h = models.haldane()
    op = [o for o in symmetry.find_symmetries(h) if o.order == 3][0]
    for kpt in ([0, 0], [1 / 3.0, 2 / 3.0]):
        ev, det = symmetry.symmetry_eigenvalues(h, op, kpt, occ=[0])
        assert np.abs(np.abs(ev) - 1.0).max() < 1e-9 and abs(ev[0] ** 3 - 1.0) < 1e-8
    gen = [o for o in symmetry.find_symmetries(models.haldane(delta=0.0)) if o.order == 6][0]
    e = symmetry._op_power(gen, 6, np.asarray(h._lat))
    assert np.array_equal(e.W, np.eye(2, dtype=np.int64)) and np.array_equal(e.perm, np.arange(2))
    assert all(o.order < 4 for o in symmetry.find_symmetries(models.qwz(1.0)) if o.det > 0)


def test_symmetry_errors():
    with pytest.raises(PythtbError):
        symmetry.find_symmetries(models.haldane().cut_piece(3, 0, glue_edgs=False))
    h = models.haldane()
    op = [o for o in symmetry.find_symmetries(h) if o.order == 3][0]
    with pytest.raises(PythtbError):
        symmetry.symmetry_eigenvalues(h, op, [0.1, 0.2], occ=[0])
    with pytest.raises(PythtbError):
        symmetry.chern_indicator(models.kane_mele(), occ=[0, 1])
    m = tb_model(2, 2, [[1, 0], [0, 1]], [[0, 0], [0.3, 0.1]])
    m.set_onsite([0.4, -0.4])
    m.set_hop(0.7 + 0.2j, 0, 1, [0, 0])
    m.set_hop(0.3, 0, 1, [1, 0])
    with pytest.raises(PythtbError):
        symmetry.chern_indicator(m, occ=[0])
    m3 = tb_model(3, 3, np.eye(3), [[0.0, 0.0, 0.0]], nspin=2)
    m3.set_hop([0.5, 0.1, 0.0, 0.0], 0, 0, [1, 0, 0])
    with pytest.raises(PythtbError, match="2-D models only"):
        symmetry.find_symmetries(m3)
