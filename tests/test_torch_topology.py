"""The port's spectra, band-resolved calls and invariants (``flows``)
against pythtb_tpu's, on the CPU in float64, where every kernel runs its
plain version: the DOS and PDOS (kernel 16's Gaussian mode), band
velocities (kernel 15), spin textures, the nested-Wilson quadrupole
(kernel 5), sector, spin and valley Chern numbers (kernels 3-4), and the
parity indicators.

Continuous outputs within 1e-10 (relative to the largest entry for the
DOS); invariants exactly, or to 1e-10 where they are floats; errors and
warnings with the same messages.  Cases follow tests/test_sector_chern.py,
test_parity_z2.py, test_spin_texture.py, test_valley.py and test_ahc.py.
"""

import warnings

import numpy as np
import pytest

import pythtb_tpu as ptt
from pythtb_tpu import flows as jflows
from pythtb_tpu.model import PythtbError as JPythtbError
from pythtb_tpu.models import library as jzoo
from pythtb_tpu_torch import PythtbError, flows

from .test_sector_chern import LAYER_GRADING, _haldane_bilayer
from .test_torch_ops import carry, on_cpu  # noqa: F401  (autouse: the port on the CPU)

TOL = 1e-10


def _both(fn_name, jm, *args, **kwargs):
    """Run flows.<fn_name> in both packages, warnings silenced."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return (getattr(flows, fn_name)(carry(jm), *args, **kwargs),
                getattr(jflows, fn_name)(jm, *args, **kwargs))


@pytest.mark.parametrize("case", ["haldane", "kane_mele spinful", "ssh 1d"])
def test_dos_and_pdos_match_jax(case):
    jm, mesh = {"haldane": (jzoo.haldane(), (12, 12)), "kane_mele spinful": (jzoo.kane_mele(), (10, 10)),
                "ssh 1d": (jzoo.ssh(delta=0.3), (40,))}[case]
    (e, dos), (je, jdos) = _both("density_of_states", jm, mesh, sigma=0.15, n_energies=121)
    assert np.abs(e - je).max() <= 1e-12
    assert np.abs(dos - jdos).max() <= TOL * np.abs(jdos).max()
    (e, pdos), (je, jpdos) = _both("projected_dos", jm, mesh, energies=(-4.0, 4.0), sigma=0.1, n_energies=81)
    assert pdos.shape == jpdos.shape == (81, jm._norb)
    assert np.abs(pdos - jpdos).max() <= TOL * np.abs(jpdos).max()
    # the orbital sum recovers the total DOS on the same window
    _, dos2 = flows.density_of_states(carry(jm), mesh, energies=(-4.0, 4.0), sigma=0.1, n_energies=81)
    assert np.abs(pdos.sum(axis=1) - dos2).max() <= 1e-12 * np.abs(dos2).max()


@pytest.mark.parametrize("case", ["haldane", "kane_mele spinful", "weyl 3d", "ssh 1d"])
def test_band_velocities_match_jax(case):
    """Hellmann-Feynman velocities against JAX's autodiff, at random
    k-points (band crossings, where neither is defined, are measure zero)."""
    jm, dim = {"haldane": (jzoo.haldane(), 2), "kane_mele spinful": (jzoo.kane_mele(rashba=0.0), 2),
               "weyl 3d": (jzoo.weyl(), 3), "ssh 1d": (jzoo.ssh(delta=0.3), 1)}[case]
    k = np.random.default_rng(7).random((9, dim))
    (v, e), (jv, je) = _both("band_velocities", jm, k)
    assert v.shape == jv.shape == (jm._nsta, 9, dim)
    assert np.abs(e - je).max() <= TOL
    if case == "kane_mele spinful":  # Kramers-degenerate pairs: compare the pair sums
        v, jv = v.reshape(2, 2, 9, dim).sum(1), jv.reshape(2, 2, 9, dim).sum(1)
    assert np.abs(v - jv).max() <= TOL * max(1.0, np.abs(jv).max())


def test_spin_texture_matches_jax_and_oracles():
    km = jzoo.kane_mele(esite=1.0, rashba=0.35)
    th = np.linspace(0.0, 2.0 * np.pi, 121)[:-1]
    circle = 0.08 * np.stack([np.cos(th), np.sin(th)], axis=-1)
    got, want = _both("spin_texture", km, [0], circle)
    assert np.abs(got - want).max() <= TOL
    assert np.linalg.norm(got, axis=-1).max() < 1.0 + 1e-9
    sz_km = jzoo.kane_mele(esite=1.0, rashba=0.0)
    got = flows.spin_texture(carry(sz_km), [0, 1, 2, 3], np.random.default_rng(0).random((12, 2)))
    assert np.abs(np.abs(got[..., 2]) - 1.0).max() < 1e-10 and np.abs(got[..., :2]).max() < 1e-10
    with pytest.warns(UserWarning, match="basis-arbitrary"):
        flows.spin_texture(carry(km), [0], np.zeros((1, 2)))
    for bad in ((carry(jzoo.haldane()), [0], np.zeros((1, 2))), (carry(km), [9], np.zeros((1, 2))),
                (carry(km), [0], np.zeros((1, 3)))):
        with pytest.raises(PythtbError):
            flows.spin_texture(*bad)


@pytest.mark.parametrize("gamma,nk", [(0.5, 15), (1.5, 15), (0.7, 11)])
def test_quadrupole_matches_jax(gamma, nk):
    got, want = _both("quadrupole", jzoo.bbh(gamma, 1.0), nk=(nk, nk))
    assert set(got) == set(want)
    for key in want:
        d = np.asarray(got[key]) - np.asarray(want[key])
        if key in ("px", "py", "qxy"):  # polarizations live on the circle [0, 1)
            d = np.angle(np.exp(2j * np.pi * d)) / (2.0 * np.pi)
        assert np.abs(d).max() <= TOL, key
    if gamma == 0.5:
        assert abs(got["qxy"] - 0.5) < 1e-6


@pytest.mark.parametrize("case", ["decoupled", "tperp 0.35", "mirror"])
def test_sector_chern_matches_jax(case):
    m, op = {"decoupled": (_haldane_bilayer(tperp=0.0), LAYER_GRADING),
             "tperp 0.35": (_haldane_bilayer(tperp=0.35), LAYER_GRADING),
             "mirror": (_haldane_bilayer(t2_sign=(1.0, 1.0), tperp=0.2),
                        np.array([[0, 0, 1, 0], [0, 0, 0, 1], [1, 0, 0, 0], [0, 1, 0, 0]], float))}[case]
    got, want = _both("sector_chern", m, (0, 1), op, nk=(15, 15))
    for key in want:
        assert abs(got[key] - want[key]) <= TOL, key


def test_spin_chern_matches_jax_and_delegates():
    km = jzoo.kane_mele(esite=1.0, rashba=0.25)  # Rashba: S_z not conserved, P Sz P gapped
    got, want = _both("spin_chern", km, (0, 1), nk=(13, 13))
    for key in want:
        assert abs(got[key] - want[key]) <= TOL, key
    assert abs(abs(got["spin_chern"]) - 1.0) < 1e-6
    r = flows.sector_chern(carry(km), (0, 1), np.tile([1.0, -1.0], 2), nk=(13, 13))
    assert r["sector_chern"] == got["spin_chern"] and r["gap"] == got["sz_gap"]


def test_sector_chern_guards_and_warnings():
    m = carry(_haldane_bilayer())
    with pytest.raises(ValueError, match="Hermitian"):
        flows.sector_chern(m, (0, 1), np.diag([1.0, 1j, 1.0, 1.0]))
    with pytest.raises(ValueError, match="split"):
        flows.sector_chern(m, (0, 1), LAYER_GRADING, split=2)
    with pytest.raises(ValueError, match="op must be"):
        flows.sector_chern(m, (0, 1), np.eye(3))
    with pytest.raises(ValueError, match="at least two"):
        flows.sector_chern(m, (0,), LAYER_GRADING)
    with pytest.raises(IndexError):
        flows.sector_chern(m, (0, 9), LAYER_GRADING)
    with pytest.warns(UserWarning, match="gapless"):
        flows.sector_chern(m, (0, 1), np.ones(4), nk=(9, 9))
    with pytest.warns(UserWarning, match="straddle"):
        flows.sector_chern(m, (0, 1), LAYER_GRADING + 5.0, nk=(9, 9))
    with pytest.raises(ValueError, match="spinful"):
        flows.spin_chern(m)


K_PTS = [[1.0 / 3.0, 2.0 / 3.0], [2.0 / 3.0, 1.0 / 3.0]]


@pytest.mark.parametrize("case", ["bn", "haldane"])
def test_valley_chern_matches_jax(case):
    jm = jzoo.bn(delta=0.3) if case == "bn" else jzoo.haldane()
    got, want = _both("valley_chern", jm, [0], K_PTS, nk=(31, 31))
    assert np.abs(got - want).max() <= TOL
    assert abs(got.sum() - flows.chern_number(carry(jm), [0], nk=(31, 31))) < 1e-9


@pytest.mark.parametrize("case", ["kane_mele", "bhz -1", "bhz 1", "fkm 3d", "coincident 1d"])
def test_parity_z2_matches_jax(case):
    if case == "coincident 1d":
        jm = ptt.tb_model(1, 1, lat=[[1.0]], orb=[[0.25], [0.25], [0.75], [0.75]], nspin=2)
        jm.set_onsite([0.3, -0.3, 0.3, -0.3])
        jm.set_hop(1.0, 0, 2, [0])
        jm.set_hop(1.0, 1, 3, [0])
        jm.set_hop(0.7, 2, 0, [1])
        jm.set_hop(0.7, 3, 1, [1])
        args = ((0, 1, 2, 3),), {"center": [0.5]}
    else:
        jm = {"kane_mele": jzoo.kane_mele(esite=0.0, rashba=0.0), "bhz -1": jzoo.bhz(m=-1.0),
              "bhz 1": jzoo.bhz(m=1.0), "fkm 3d": jzoo.fu_kane_mele()}[case]
        kw = {"kane_mele": {"center": [0.5, 0.5]}, "bhz -1": {"parity": [1, -1]}, "bhz 1": {"parity": [1, -1]},
              "fkm 3d": {"center": np.asarray(jm._orb).sum(axis=0) / 2.0}}[case]
        args = ((0, 1),), kw
    got = flows.parity_z2(carry(jm), *args[0], **args[1])
    assert got == jflows.parity_z2(jm, *args[0], **args[1])


@pytest.mark.parametrize("case", ["ssh +", "ssh -", "ssh spinful", "rice_mele centred"])
def test_parity_polarization_matches_jax(case):
    if case == "ssh spinful":
        jm = ptt.tb_model(1, 1, [[1.0]], [[0.0], [0.5]], nspin=2)
        jm.set_hop(1.2, 0, 1, [0])
        jm.set_hop(0.8, 1, 0, [1])
        occ, center = [0, 1], 0.25
    else:
        jm = {"ssh +": jzoo.ssh(delta=0.3), "ssh -": jzoo.ssh(delta=-0.3),
              "rice_mele centred": jzoo.ssh(delta=0.5)}[case]
        occ, center = [0], 0.25
    got = flows.parity_polarization(carry(jm), occ, center=center)
    assert got == jflows.parity_polarization(jm, occ, center=center)


PARITY_MISUSE = [
    ("parity_z2", lambda M: M.models.kane_mele(esite=1.0, rashba=0.0), ((0, 1),), {"center": [0.5, 0.5]},
     "not inversion symmetric"),
    ("parity_z2", lambda M: M.models.kane_mele(esite=0.0, rashba=0.0), ((0, 1),), {"center": [0.25, 0.0]},
     "partner"),
    ("parity_z2", lambda M: M.models.bhz(), ((0, 1),), {"parity": [1, 1]}, "not inversion symmetric"),
    ("parity_z2", lambda M: M.models.haldane(), ((0,),), {}, "spinful"),
    ("parity_z2", lambda M: M.models.bhz(), ((0,),), {"parity": [1, -1]}, "even"),
    ("parity_z2", lambda M: M.models.bhz(), ((-2, -1),), {"parity": [1, -1]}, "range"),
    ("parity_polarization", lambda M: M.models.haldane(), ([0],), {}, "1-D"),
    ("parity_polarization", lambda M: M.models.ssh(), ([0],), {"parity": [1, 2]}, "parity must"),
]


@pytest.mark.parametrize("i", range(len(PARITY_MISUSE)))
def test_parity_misuse_raises_like_jax(i):
    import pythtb_tpu_torch

    name, build, args, kwargs, msg = PARITY_MISUSE[i]
    with pytest.raises(JPythtbError, match=msg):
        getattr(jflows, name)(build(ptt), *args, **kwargs)
    with pytest.raises(PythtbError, match=msg):
        getattr(flows, name)(build(pythtb_tpu_torch), *args, **kwargs)


def test_the_slice_completes_flows_magnetic_and_family():
    """flows holds every public name of pythtb_tpu.flows (energy_fn and
    chern_fn since their backward kernel); magnetic and family hold all of
    theirs, and the package exports ``family`` and ``ModelFamily`` as
    pythtb_tpu does."""
    import importlib

    import pythtb_tpu_torch

    assert set(jflows.__all__) - set(flows.__all__) == set()
    for mod in ("magnetic", "family"):
        ref = importlib.import_module("pythtb_tpu." + mod)
        port = importlib.import_module("pythtb_tpu_torch." + mod)
        assert set(ref.__all__) <= set(port.__all__), mod
        assert all(callable(getattr(port, name)) for name in ref.__all__)
    assert all(callable(getattr(flows, name)) for name in flows.__all__)
    assert pythtb_tpu_torch.family is importlib.import_module("pythtb_tpu_torch.family").family
    assert isinstance(pythtb_tpu_torch.ModelFamily, type)
