"""The port's Hofstadter solver and Streda labels (``magnetic``) against
pythtb_tpu's, on the CPU in float64, where kernel 1's flux-batch mode,
kernel 2 and kernel 7 run their plain versions.

Hofstadter eigenvalues within 1e-10 (supercells of 3-40 states, so the
plain Jacobi solver takes the 40-state one), the butterfly's shapes and
symmetries, and Streda labels equal to the JAX package's (the cases of
tests/test_streda.py and the TKNN Chern numbers of tests/test_magnetic.py).
"""

import numpy as np
import pytest

import pythtb_tpu as ptt
from pythtb_tpu import magnetic as jmag
from pythtb_tpu.models import library as jzoo
from pythtb_tpu_torch import magnetic
from pythtb_tpu_torch.ops import _kernels

from .test_torch_ops import carry, on_cpu  # noqa: F401  (autouse: the port on the CPU)


def _square():
    m = ptt.tb_model(2, 2, np.eye(2).tolist(), [[0.0, 0.0]])
    m.set_hop(-1.0, 0, 0, [1, 0])
    m.set_hop(-1.0, 0, 0, [0, 1])
    return m


def _honeycomb():
    lat = [[1.0, 0.0], [0.5, np.sqrt(3.0) / 2.0]]
    m = ptt.tb_model(2, 2, lat, [[1.0 / 3.0, 1.0 / 3.0], [2.0 / 3.0, 2.0 / 3.0]])
    m.set_hop(-1.0, 0, 1, [0, 0])
    m.set_hop(-1.0, 1, 0, [1, 0])
    m.set_hop(-1.0, 1, 0, [0, 1])
    return m


@pytest.mark.parametrize("case,q", [("square", 3), ("haldane", 4), ("kane_mele spinful", 2), ("square", 40)])
def test_hofstadter_fn_matches_jax(case, q):
    jm = {"square": _square, "haldane": jzoo.haldane, "kane_mele spinful": jzoo.kane_mele}[case]()
    rng = np.random.default_rng(q)
    p_values = np.array([0.0, 1.0, 0.5 * q, q - 1.0]) if q < 40 else np.array([0.0, 1.0, 7.0])
    kpts = rng.random((5 if q < 40 else 2, 2))
    fn, sc = magnetic.hofstadter_fn(carry(jm), q)
    jfn, jsc = jmag.hofstadter_fn(jm, q)
    assert sc._nsta == jsc._nsta
    got = fn(p_values, kpts).numpy()
    want = np.asarray(jfn(p_values, kpts))
    assert got.shape == want.shape == (len(p_values), len(kpts), sc._nsta)
    assert np.abs(got - want).max() <= 1e-10


def test_hofstadter_is_one_flux_batch_assembly():
    """The whole sweep is one call of kernel 1's flux-batch wrapper (the
    counter counts card launches only, so it stays 0 on the CPU) and
    matches per-flux supercells."""
    sq = carry(_square())
    before = dict(_kernels.LAUNCHES)
    fn, _ = magnetic.hofstadter_fn(sq, 5)
    ev = fn(np.arange(6.0), np.array([[0.1, 0.2]])).numpy()
    assert _kernels.LAUNCHES == before
    for p in range(6):
        msc = magnetic.magnetic_supercell(sq, p, 5)
        assert np.abs(np.sort(ev[p, 0]) - msc.solve_all([[0.1, 0.2]])[:, 0]).max() <= 1e-10


def test_butterfly_matches_jax_and_its_symmetries():
    sq = _square()
    phis, evals = magnetic.hofstadter_butterfly(carry(sq), 8, nk=4)
    jphis, jevals = jmag.hofstadter_butterfly(sq, 8, nk=4)
    assert evals.shape == (9, 16, 8)
    assert np.array_equal(phis, jphis)
    assert np.abs(evals - jevals).max() <= 1e-10
    for i in range(9):
        np.testing.assert_allclose(np.sort(evals[i].ravel()), np.sort(evals[8 - i].ravel()), atol=1e-9)
    assert abs(evals[0].min() + 4.0) < 1e-9 and abs(evals[0].max() - 4.0) < 1e-9


def test_denominator_consistency():
    """Flux 1/2 built with q 2 and q 12: the same eigenvalue multisets."""
    sq = carry(_square())
    f12, _ = magnetic.hofstadter_fn(sq, 12)
    f2, _ = magnetic.hofstadter_fn(sq, 2)
    for k2 in (0.0, 0.17, 0.5):
        a = np.sort(f12(np.array([6.0]), np.array([[j / 2.0, k2] for j in range(2)])).numpy().ravel())
        b = np.sort(f2(np.array([1.0]), np.array([[j / 12.0, k2] for j in range(12)])).numpy().ravel())
        np.testing.assert_allclose(a, b, atol=1e-9)


# The honeycomb's central gap at 1/3 is taken at nk 41: on the symmetric
# meshes of nk 21-31 several plaquettes of the three-band set carry a
# phase of exactly +-pi, so the sign of a rounding-level imaginary part
# decides its label in either package (JAX: 0, 1, -1 at nk 21, 25, 31;
# the port: 1, -2, 1); at nk 41 both give 0, the particle-hole value.
@pytest.mark.parametrize("case,p,q,nk", [("square", 1, 3, 21), ("square", 1, 5, 21), ("square", 2, 5, 21),
                                         ("square", 4, 5, 21), ("honeycomb", 1, 3, 41)])
def test_streda_labels_match_jax(case, p, q, nk):
    jm = {"square": _square, "honeycomb": _honeycomb}[case]()
    got = magnetic.streda_labels(carry(jm), p, q, nk=nk)
    want = jmag.streda_labels(jm, p, q, nk=nk)
    assert got["labels"] == want["labels"]
    assert got["filling"] == want["filling"]
    assert got["phi"] == want["phi"]
    assert np.abs(np.asarray(got["gaps"]) - np.asarray(want["gaps"])).max() <= 1e-10
    assert all(isinstance(t, int) for t in got["labels"])
    if case == "honeycomb":  # mirrored gaps carry opposite labels
        lab = dict(zip(got["filling"], got["labels"]))
        assert all(lab[6 - r] == -t for r, t in lab.items() if 6 - r in lab)


def test_streda_tknn_square_one_third():
    """TKNN: the square lattice at 1/3 has band Chern numbers (1, -2, 1),
    so the gaps above one and two bands carry 1 and -1."""
    out = magnetic.streda_labels(carry(_square()), 1, 3, nk=21)
    assert out["filling"] == [1, 2] and out["labels"] == [1, -1]
