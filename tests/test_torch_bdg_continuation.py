"""The port's BdG tools (``bdg``) and Pade continuation (``continuation``)
against pythtb_tpu's, on the CPU in float64.

Both are host code in both packages: the Nambu models must hold the same
hop tables and give the same bands (1e-10; Chern numbers of the p+ip
model through the port's kernels 1-4), Pfaffians and Majorana numbers
agree at 1e-12, and the Thiele continuation (extended precision, host)
gives the same values and diagnostics at 1e-12.
"""

import numpy as np
import pytest

import pythtb_tpu as jpt
from pythtb_tpu import bdg as jbdg
from pythtb_tpu import continuation as jcont
from pythtb_tpu import dmft as jdmft
from pythtb_tpu import flows as jflows
from pythtb_tpu.models import library as jzoo
from pythtb_tpu_torch import bdg, continuation, flows

from .test_torch_ops import carry, on_cpu  # noqa: F401  (autouse: the port on the CPU)

TOL = 1e-12


def _hops(m):
    return [(complex(h[0]), h[1], h[2], tuple(np.asarray(h[3]).tolist()) if m._dim_k else None) for h in m._hoppings]


@pytest.mark.parametrize("case", ["kitaev", "s-wave square", "p+ip square"])
def test_bdg_model_matches_jax(case):
    base, kw = {
        "kitaev": (jpt.tb_model(1, 1, [[1.0]], [[0.0]]), dict(mu=0.5, delta=[(0.4, 0, 0, [1])])),
        "s-wave square": (jzoo.square(t=-1.0), dict(mu=-0.5, delta=[(0.3, 0, 0, [0, 0])], pairing="singlet")),
        "p+ip square": (jzoo.square(t=-1.0), dict(mu=-2.0, delta=[(0.4, 0, 0, [1, 0]), (0.4j, 0, 0, [0, 1])])),
    }[case]
    if case == "kitaev":
        base.set_hop(-1.0, 0, 0, [1])
    a = jbdg.bdg_model(base, **kw)
    b = bdg.bdg_model(carry(base), **kw)
    assert _hops(b) == _hops(a)
    assert np.array_equal(b._site_energies, a._site_energies)
    k = np.random.default_rng(0).random((9, a._dim_k))
    assert np.abs(b.solve_all(k) - a.solve_all(k)).max() <= 1e-10
    if case == "p+ip square":
        c = flows.chern_number(b, [0], nk=(21, 21))
        assert abs(c - jflows.chern_number(a, [0], nk=(21, 21))) <= 1e-10


def test_pfaffian_and_majorana_number_match_jax():
    rng = np.random.default_rng(3)
    for m in (2, 4, 8):
        A = rng.normal(size=(m, m))
        A = A - A.T
        assert abs(bdg.pfaffian(A) - jbdg.pfaffian(A)) <= TOL * max(1.0, abs(jbdg.pfaffian(A)))
    for mu in (0.0, 1.9, -1.5, 2.1, -2.5):
        assert bdg.majorana_number(bdg.kitaev_chain(1.0, 0.4, mu)) == jbdg.majorana_number(
            jbdg.kitaev_chain(1.0, 0.4, mu))
    # examples/majorana.py: the open chain's end-mode splitting
    for mu in (0.5, 2.5):
        e_p = np.abs(bdg.kitaev_chain(1.0, 0.4, mu).cut_piece(24, 0).solve_all()).min()
        e_j = np.abs(np.asarray(jbdg.kitaev_chain(1.0, 0.4, mu).cut_piece(24, 0).solve_all())).min()
        assert abs(e_p - e_j) <= 1e-10


def test_pade_matches_jax():
    wn = jdmft.matsubara(20.0, 48)
    poles, amps = np.array([-1.3, -0.2, 0.4, 2.1]), np.array([0.2, 0.3, 0.35, 0.15])
    g = np.sum(amps[None, :] / (1j * wn[:, None] - poles[None, :]), axis=1)
    om = np.linspace(-3.0, 3.0, 121)
    got, info = continuation.pade(wn, g, om, eta=0.05, diagnostics=True)
    want, jinfo = jcont.pade(wn, g, om, eta=0.05, diagnostics=True)
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()
    assert info["order"] == jinfo["order"] and abs(info["residual"] - jinfo["residual"]) <= TOL
    A = continuation.pade_spectral(wn, g, om, eta=0.05, n_points=20)
    assert np.abs(A - jcont.pade_spectral(wn, g, om, eta=0.05, n_points=20)).max() <= TOL
