"""The port's ``floquet`` module against pythtb_tpu's, on the CPU in
float64, where kernels 22 and 24 and kernel 1's Floquet-block mode run
their plain versions: the truncated Floquet spectrum (eigenvalues, and
the m = 0 weights where the spectrum is not degenerate) to 1e-12; U(T, k)
(nspin 1 and 2, Peierls, hop-factor and on-site drives, a finite model)
to 1e-12; the exact quasienergies (sorted, away from the zone edge) to
1e-12; Chern numbers with their flux and winding numbers in both gaps
(driven graphene and the Rudner-Lindner-Berg-Levin drive) to 1e-10; the
van Vleck effective model's eigenvalues on a k-path to 1e-12; the host
drive helpers to 1e-15.  The JAX results are built once per module;
sizes stay at <= 9^2 k-points, nt <= 64 and nharm <= 3.
"""

import numpy as np
import pytest

import pythtb_tpu
from pythtb_tpu import floquet as jfloquet
from pythtb_tpu import models as jmodels
from pythtb_tpu_torch import floquet

from .test_torch_ops import carry, on_cpu, random_model  # noqa: F401  (autouse: the port on the CPU)

CIRC = {"A": [0.8, 0.8], "phase": [0.0, np.pi / 2]}
KL = np.array([[0.1, 0.2], [1 / 3, 2 / 3], [0.4, 0.05]])
RUDNER_W = 1.0


def _rudner():
    T = 2 * np.pi / RUDNER_W
    J = 0.85 * (np.pi / 2) / (T / 5)
    m = pythtb_tpu.tb_model(2, 2, lat=[[1.0, 0.0], [0.0, 1.0]], orb=[[0.0, 0.0], [0.5, 0.5]])
    for R in ([0, 0], [-1, 0], [-1, -1], [0, -1]):
        m.set_hop(J, 0, 1, R)
    return m


def _rudner_drive():
    T = 2 * np.pi / RUDNER_W

    def hop_factors(t):
        f = np.zeros(4)
        step = int(t / (T / 5.0))
        if step < 4:
            f[step] = 1.0
        return f

    def onsite(t):
        return np.array([0.5, -0.5]) if int(t / (T / 5.0)) == 4 else np.zeros(2)

    return {"hop_factors": hop_factors, "onsite": onsite}


def _chain_onsite():
    m = jmodels.chain()
    return m, {"A": [0.6], "onsite": lambda t: np.array([0.4 * np.cos(3.0 * t)])}


def _spinful():
    return random_model(81, 2, 2, norb=2, nhop=5)


def _flake():
    return jmodels.graphene().cut_piece(2, 0, glue_edgs=False).cut_piece(2, 1, glue_edgs=False)


# name -> (the JAX call, the port's call): each takes (module, model builder's model)
CALLS = {
    "quasi graphene": (jmodels.graphene, lambda F, m: F.quasienergies(m, 10.0, CIRC, KL, nharm=3)),
    "quasi spinful": (_spinful, lambda F, m: F.quasienergies(m, 6.0, CIRC, KL[:2], nharm=2)),
    "quasi onsite chain": (lambda: _chain_onsite()[0],
                           lambda F, m: F.quasienergies(m, 4.0, _chain_onsite()[1], [[0.0], [0.3]], nharm=3)),
    "quasi finite flake": (_flake, lambda F, m: F.quasienergies(m, 8.0, CIRC, None, nharm=1)),
    "prop graphene": (jmodels.graphene, lambda F, m: F.propagator(m, 10.0, CIRC, KL, nt=64)),
    "prop spinful": (_spinful, lambda F, m: F.propagator(m, 6.0, CIRC, KL, nt=48)),
    "prop onsite chain": (lambda: _chain_onsite()[0],
                          lambda F, m: F.propagator(m, 4.0, _chain_onsite()[1], [[0.0], [0.3]], nt=40)),
    "prop rudner": (_rudner, lambda F, m: F.propagator(m, RUDNER_W, _rudner_drive(), KL, nt=60)),
    "prop finite flake": (_flake, lambda F, m: F.propagator(m, 8.0, CIRC, None, nt=32)),
    "exact ribbon": (lambda: jmodels.graphene().cut_piece(3, 1, glue_edgs=False),
                     lambda F, m: F.quasienergies_exact(m, 10.0, CIRC, np.linspace(0.0, 1.0, 7)[:, None], nt=48)),
    "chern graphene": (jmodels.graphene, lambda F, m: F.chern(m, 10.0, CIRC, band=0, nk=(9, 9), nt=32)),
    "chern graphene both bands": (jmodels.graphene,
                                  lambda F, m: F.chern(m, 10.0, CIRC, band=[0, 1], nk=(7, 9), nt=32)),
    "chern rudner": (_rudner, lambda F, m: F.chern(m, RUDNER_W, _rudner_drive(), band=0, nk=(9, 9), nt=60)),
    "winding graphene": (jmodels.graphene,
                         lambda F, m: F.winding_number(m, 10.0, CIRC, egap=[0.0, 5.0], nk=(7, 7), nt=32)),
    "winding rudner": (_rudner, lambda F, m: F.winding_number(m, RUDNER_W, _rudner_drive(), egap=[0.0, 0.5],
                                                              nk=(9, 9), nt=60)),
    "winding scalar gap": (jmodels.haldane,
                           lambda F, m: F.winding_number(m, 10.0, CIRC, egap=0.0, nk=(5, 6), nt=16)),
}
TOL = {"quasi": 1e-12, "prop": 1e-12, "exact": 1e-12, "chern": 1e-10, "winding": 1e-10}


@pytest.fixture(scope="module")
def jax_results():
    out = {}
    for name, (build, call) in CALLS.items():
        m = build()
        out[name] = (m, call(jfloquet, m))
    return out


@pytest.mark.parametrize("name", sorted(CALLS))
def test_floquet_call_matches_jax(jax_results, name):
    m, want = jax_results[name]
    got = CALLS[name][1](floquet, carry(m))
    tol = TOL[name.split()[0]]
    if name.startswith("quasi"):
        (e, wgt), (ew, wgtw) = got, want
        assert e.shape == ew.shape and np.abs(e - ew).max() <= tol
        gaps = np.diff(ew, axis=-1)
        ok = np.ones_like(ew, dtype=bool)
        ok[:, 1:] &= gaps > 1e-6
        ok[:, :-1] &= gaps > 1e-6
        assert ok.any()
        assert np.abs(wgt - wgtw)[ok].max() <= tol
        return
    if name.startswith("exact"):
        assert np.abs(want).max() < 5.0 - 1e-6  # away from the zone edge +-omega / 2
    if name.startswith("chern"):
        assert abs(got - want) <= tol and isinstance(got, float)
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol


def test_graphene_chern_and_winding_are_the_expected_integers(jax_results):
    """The port's own numbers for driven graphene: C(band 0) = -1 and the
    winding at the zone edge W(omega / 2) = 0 (the 0-gap's W reaches -1
    only on finer grids than these, as in the JAX package)."""
    m = carry(jax_results["winding graphene"][0])
    _, wz = floquet.winding_number(m, 10.0, CIRC, egap=[0.0, 5.0], nk=(7, 7), nt=32)
    c = floquet.chern(m, 10.0, CIRC, band=0, nk=(9, 9), nt=32)
    assert abs(c + 1.0) < 1e-6 and abs(wz) < 0.05


def test_effective_model_matches_jax():
    k = [[0.1, 0.2], [1 / 3, 2 / 3], [0.5, 0.0]]
    for build, drive, kw in ((jmodels.graphene, CIRC, dict(nharm=3)), (_spinful, CIRC, dict(nharm=2)),
                             (lambda: _chain_onsite()[0], _chain_onsite()[1], dict(nharm=3))):
        m = build()
        kk = [row[: m._dim_k] for row in k]
        want = jfloquet.effective_model(m, 9.0, drive, **kw).solve_all(kk)
        got = floquet.effective_model(carry(m), 9.0, drive, **kw).solve_all(kk)
        assert np.abs(got - want).max() <= 1e-12


def test_host_drive_helpers_match_jax():
    m = jmodels.graphene()
    pm = carry(m)
    np.testing.assert_allclose(floquet._hop_displacements(pm), jfloquet._hop_displacements(m), atol=1e-15)
    np.testing.assert_allclose(floquet._hop_fourier(pm, CIRC, 10.0, 4, 64),
                               jfloquet._hop_fourier(m, CIRC, 10.0, 4, 64), atol=1e-15)
    r, rd = _rudner(), _rudner_drive()
    np.testing.assert_array_equal(floquet._phase_samples(carry(r), rd, 1.0, 20, True),
                                  jfloquet._phase_samples(r, rd, 1.0, 20, True))
    np.testing.assert_array_equal(floquet._onsite_samples(carry(r), rd, 1.0, 20, True),
                                  jfloquet._onsite_samples(r, rd, 1.0, 20, True))
