"""The port's ``magnon`` module against pythtb_tpu's, on the CPU in
float64, where kernels 27 and 16 run their plain versions.

``bands`` to 1e-12 on an FM honeycomb with DM and field, a kagome FM
with DM and field, an AFM chain in a field and an S = 1 chain with
single-ion anisotropy; the para-unitarity of the port's eigenvectors to
1e-10 (X^H sigma3 X = sign(Lambda) = -sigma3: the columns hold T's
ascending spectrum, the negative branch first, as in the reference) and
their layout (COLUMNS are modes, as the reference returns them) by
sigma3 h X_n = w_n X_n on the positive branch;
``berry_curvature`` to 1e-10 and ``chern`` exactly; ``thermal_hall`` and
both return forms of ``structure_factor`` (mode weights; the broadened
map with the polarization projector on and off, at T = 0 and T > 0 with
the gain side) to 1e-10 relative; kernel 27's plain version gives NaN
for a matrix that is not positive definite.  The mode weights are
compared on non-degenerate modes (both packages' eigenvectors differ by a
phase per mode, which the weights do not see).  Sizes: nk <= 9^2, <= 64 q.
"""

import numpy as np
import pytest
import torch

from pythtb_tpu import magnon as jmagnon
from pythtb_tpu_torch import convert, magnon
from pythtb_tpu_torch.ops import colpa

from .test_torch_ops import on_cpu  # noqa: F401  (autouse: the port on the CPU)

HONEY_LAT = [[1.0, 0.0], [0.5, np.sqrt(3) / 2]]
HONEY_POS = [[1 / 3, 1 / 3], [2 / 3, 2 / 3]]


def sm_state(sm):
    """Host state of a pythtb_tpu spin_model, for convert.spin_model_from_state."""
    return {
        "lat": sm._lat, "pos": sm._pos, "spin": sm._S, "dim_k": sm._dim_k,
        "J": np.array([b[0] for b in sm._bonds]).reshape(-1, 3, 3),
        "i": np.array([b[1] for b in sm._bonds], dtype=int), "j": np.array([b[2] for b in sm._bonds], dtype=int),
        "R": np.array([b[3] for b in sm._bonds]).reshape(-1, sm._dim_r),
        "single_ion": np.array(sm._single_ion), "field": sm._field, "moments": sm._moments,
    }


def carry_sm(sm):
    return convert.spin_model_from_state(sm_state(sm))


def honeycomb_fm(D=0.2, field=0.05):
    """tools/bench_suite.py's magnon_thermal_hall_map model."""
    sm = jmagnon.spin_model(HONEY_LAT, HONEY_POS, spin=0.5)
    sm.set_coupling(-1.0, 0, 1, [0, 0])
    sm.set_coupling(-1.0, 1, 0, [1, 0])
    sm.set_coupling(-1.0, 1, 0, [0, 1])
    for dR in ((1, 0), (-1, 1), (0, -1)):
        sm.set_coupling(np.zeros((3, 3)), 0, 0, dR, dm=[0, 0, D])
        sm.set_coupling(np.zeros((3, 3)), 1, 1, dR, dm=[0, 0, -D])
    sm.set_field([0, 0, field])
    return sm


def kagome_fm():
    """tools/bench_suite.py's neutron_map_kagome_4096q model."""
    sm = jmagnon.spin_model(HONEY_LAT, [[0.0, 0.0], [0.5, 0.0], [0.0, 0.5]], spin=0.5)
    for i, j, R in ((0, 1, [0, 0]), (0, 2, [0, 0]), (1, 2, [0, 0]), (1, 0, [1, 0]), (2, 0, [0, 1]), (2, 1, [-1, 1])):
        sm.set_coupling(-1.0, i, j, R, dm=[0.0, 0.0, 0.15])
    sm.set_field([0, 0, 0.02])
    return sm


def afm_chain():
    """An S = 1 AFM chain with easy-axis anisotropy (a gap at Gamma) and a
    field along the axis, below the gap, that splits the two branches."""
    sm = jmagnon.spin_model([[2.0]], [[0.0], [0.5]], spin=1.0)
    sm.set_coupling(1.0, 0, 1, [0])
    sm.set_coupling(1.0, 1, 0, [1])
    for i in (0, 1):
        sm.set_single_ion(np.diag([0.0, 0.0, -0.2]), i)
    sm.set_moments([[0, 0, 1], [0, 0, -1]])
    sm.set_field([0.0, 0.0, 0.05])
    return sm


def single_ion_chain():
    sm = jmagnon.spin_model([[1.0]], [[0.0]], spin=1.0)
    sm.set_coupling(-1.0, 0, 0, [1])
    sm.set_single_ion(np.array([[0.1, 0.05, 0.0], [0.05, -0.2, 0.0], [0.0, 0.0, -0.4]]), 0)
    return sm


MODELS = {"honeycomb_fm": honeycomb_fm, "kagome_fm": kagome_fm, "afm_chain": afm_chain,
          "single_ion_chain": single_ion_chain}


def _kpts(sm, n=9, seed=27):
    rng = np.random.default_rng(seed)
    return np.concatenate([np.zeros((1, sm._dim_k)), rng.uniform(-0.5, 0.5, (n, sm._dim_k))])


@pytest.mark.parametrize("name", sorted(MODELS))
def test_bands_match_jax(name):
    sm = MODELS[name]()
    want = jmagnon.bands(sm, _kpts(sm))
    got = magnon.bands(carry_sm(sm), _kpts(sm))
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-12


@pytest.mark.parametrize("name", sorted(MODELS))
def test_eigenvectors_are_para_unitary_columns(name):
    pm = carry_sm(MODELS[name]())
    n = pm._nsite
    w, X = magnon._solve(pm, _kpts(pm), 1e-9, True)
    sg = np.diag(np.concatenate([np.ones(n), -np.ones(n)]))
    # X^H sigma3 X = sign(Lambda): the columns hold T's ascending spectrum,
    # the n negative (hole) branch first, as in the reference
    err = np.abs(np.einsum("kia,ij,kjb->kab", X.conj(), sg, X) + sg[None]).max()
    assert err <= 1e-10
    # columns n.. are the positive branch: sigma3 h X_n = w_n X_n
    iidx, jidx, dvec, a_amp, b_amp, cdiag = pm._tables()
    tab = colpa.ColpaTables(iidx, jidx, dvec, a_amp, b_amp, cdiag, "cpu")
    k = torch.as_tensor(_kpts(pm))
    T, L = colpa.colpa(tab, 1e-9, k)
    h = (L @ L.mH).numpy()
    lhs = np.einsum("ij,kjl,kla->kia", sg, h, X[:, :, n:])
    assert np.abs(lhs - X[:, :, n:] * w[:, None, :]).max() <= 1e-10 * max(1.0, np.abs(w).max())


@pytest.fixture(scope="module")
def honeycomb_ref():
    sm = honeycomb_fm()
    Ts = np.array([0.05, 0.3, 0.8])
    return {"F0": jmagnon.berry_curvature(sm, 9, 0), "F1": jmagnon.berry_curvature(sm, 9, 1),
            "C0": jmagnon.chern(sm, 0, nk=9), "C1": jmagnon.chern(sm, 1, nk=9),
            "kxy": jmagnon.thermal_hall(sm, Ts, nk=9), "kxy1": jmagnon.thermal_hall(sm, 0.5, nk=9), "Ts": Ts}


def test_berry_curvature_and_chern_match_jax(honeycomb_ref):
    pm = carry_sm(honeycomb_fm())
    for band in (0, 1):
        F = magnon.berry_curvature(pm, 9, band)
        assert np.abs(F - honeycomb_ref["F%d" % band]).max() <= 1e-10
        assert magnon.chern(pm, band, nk=9) == honeycomb_ref["C%d" % band]
    assert abs(honeycomb_ref["C0"]) == 1.0


def test_thermal_hall_matches_jax(honeycomb_ref):
    pm = carry_sm(honeycomb_fm())
    got = magnon.thermal_hall(pm, honeycomb_ref["Ts"], nk=9)
    want = honeycomb_ref["kxy"]
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-10 * np.abs(want).max()
    one = magnon.thermal_hall(pm, 0.5, nk=9)
    assert isinstance(one, float) and abs(one - honeycomb_ref["kxy1"]) <= 1e-10 * abs(honeycomb_ref["kxy1"])


def test_thermal_hall_at_the_band_touching_matches_jax(monkeypatch):
    """The kagome magnet's two upper bands touch at Gamma, where the
    per-band plaquette fluxes depend on the basis an eigensolver picks
    inside the pair.  With the card's eigensolver route on the CPU (the
    plain Jacobi, kernel 7's oracle, wherever the card runs kernel 7),
    ``thermal_hall`` and ``berry_curvature`` still give the JAX package's
    values to 1e-10 relative: the vector solve takes the CPU's route on
    every device.  Without it the Jacobi's basis moves kappa_xy by more
    than 10%."""
    from pythtb_tpu_torch.ops import eigh

    sm = kagome_fm()
    Ts = np.array([0.3, 0.6])
    want = jmagnon.thermal_hall(sm, Ts, nk=9)
    want_F = jmagnon.berry_curvature(sm, 9, 2)
    card_route = eigh._route
    pm = carry_sm(sm)
    monkeypatch.setattr(eigh, "_route", lambda m, B, device_type, cpu_route=False: card_route(m, B, "cuda", cpu_route))
    got = magnon.thermal_hall(pm, Ts, nk=9)
    assert np.abs(got - want).max() <= 1e-10 * np.abs(want).max()
    assert np.abs(magnon.berry_curvature(pm, 9, 2) - want_F).max() <= 1e-10 * np.pi
    monkeypatch.setattr(eigh, "_route", lambda m, B, device_type, cpu_route=False: card_route(m, B, "cuda"))
    assert np.abs(magnon.thermal_hall(pm, Ts, nk=9) - want).max() > 0.1 * np.abs(want).max()


def _qpts(n=40, seed=45):
    return np.random.default_rng(seed).random((n, 2))


@pytest.mark.parametrize("name", ["kagome_fm", "honeycomb_fm"])
def test_structure_factor_weights_match_jax(name):
    sm = MODELS[name]()
    q = _qpts()
    w_ref, S_ref = jmagnon.structure_factor(sm, q)
    w, S = magnon.structure_factor(carry_sm(sm), q)
    assert np.abs(w - w_ref).max() <= 1e-12
    gaps = np.diff(w_ref, axis=1)
    single = np.ones(w_ref.shape, dtype=bool)
    single[:, 1:] &= gaps > 1e-6
    single[:, :-1] &= gaps > 1e-6
    assert single.sum() >= single.size - 4
    assert np.abs(S - S_ref)[single].max() <= 1e-10 * np.abs(S_ref).max()


@pytest.mark.parametrize("polarization,T", [(True, 0.0), (False, 0.0), (True, 0.3), (False, 0.8)])
def test_structure_factor_map_matches_jax(polarization, T):
    sm = kagome_fm()
    q = np.concatenate([[[0.0, 0.0]], _qpts(23, 8)])
    om = np.linspace(-2.0, 4.5, 61)
    want = jmagnon.structure_factor(sm, q, omegas=om, eta=0.05, temperature=T, polarization=polarization)
    got = magnon.structure_factor(carry_sm(sm), q, omegas=om, eta=0.05, temperature=T, polarization=polarization)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-10 * np.abs(want).max()


def test_colpa_plain_gives_nan_where_not_positive_definite():
    """An AFM coupling about FM moments: h(k) is not positive definite, so
    kernel 27's plain version writes NaN into that k's T and L."""
    bad = magnon.spin_model([[2.0]], [[0.0], [0.5]], spin=0.5)
    bad.set_coupling(1.0, 0, 1, [0])
    bad.set_coupling(1.0, 1, 0, [1])
    tab = colpa.ColpaTables(*bad._tables(), "cpu")
    T, L = colpa.colpa(tab, 0.0, torch.tensor([[0.25], [0.0]], dtype=torch.float64))
    assert bool(torch.isnan(T[0]).all()) and bool(torch.isnan(L[0]).all())
