"""The port's model families (``family``) and the second Chern number /
axion angle (``flows.second_chern``, ``flows.axion_theta``) against
pythtb_tpu's, on the CPU in float64, where every kernel runs its plain
version.  Members and model paths are built in pythtb_tpu and carried
across with ``convert.tb_model_from_state``.

Family energies within 1e-10, the family's Chern series within 1e-10 of
the JAX package's (and of the per-member wf_array flux); second Chern
numbers and axion angles within 1e-10 of JAX's at the same (small) grids.
Cases follow tests/test_family.py and tests/test_ahc.py.
"""

import io
from contextlib import redirect_stdout

import numpy as np
import pytest

import pythtb_tpu as ptt
from pythtb_tpu import flows as jflows
from pythtb_tpu.family import family as jfamily
from pythtb_tpu.models import library as jzoo
from pythtb_tpu_torch import ModelFamily, PythtbError, family, flows

from . import zoo
from .test_torch_ops import carry, on_cpu  # noqa: F401  (autouse: the port on the CPU)

TOL = 1e-10


def _quiet(fn, *args, **kwargs):
    with redirect_stdout(io.StringIO()):
        return fn(*args, **kwargs)


def _haldane_series():
    hal = _quiet(zoo.haldane, ptt)
    m2 = _quiet(hal.make_supercell, [[2, 0], [0, 1]], to_home=False)
    m3 = _quiet(hal.make_supercell, [[2, 1], [-1, 1]], to_home=False)
    return [hal, m2, m3]


def test_family_chern_series_matches_jax():
    members = _haldane_series()
    fam = family([carry(m) for m in members])
    assert isinstance(fam, ModelFamily) and fam.P == 3
    assert list(fam.nsta_arr) == [2, 4, 6]
    c = fam.chern(nocc=[1, 2, 3], nk=(15, 15))
    want = jfamily(members).chern(nocc=[1, 2, 3], nk=(15, 15))
    assert np.abs(c - want).max() <= TOL
    np.testing.assert_allclose(c, -1.0, atol=1e-9)
    # a repeated occupation: one group per distinct nocc
    members = [members[0], jzoo.haldane(), members[1]]
    c = family([carry(m) for m in members]).chern(nocc=[1, 1, 2], nk=(11, 11), start_k=(0.0, 0.0))
    assert np.abs(c - jfamily(members).chern(nocc=[1, 1, 2], nk=(11, 11), start_k=(0.0, 0.0))).max() <= TOL


def test_family_chern_equals_the_member_flux():
    members = _haldane_series()[:2]
    c = family([carry(m) for m in members]).chern(nocc=[1, 2], nk=(13, 13))
    for m, no, ci in zip(members, (1, 2), c):
        assert abs(ci - flows.chern_number(carry(m), list(range(no)), nk=(13, 13))) <= 1e-12


@pytest.mark.parametrize("case", ["haldane supercells", "ribbons", "kane_mele spinful"])
def test_family_energies_match_jax(case):
    if case == "haldane supercells":
        members, ks = _haldane_series(), np.random.default_rng(0).random((5, 2))
    elif case == "ribbons":
        members = [_quiet(_quiet(zoo.haldane, ptt).cut_piece, w, 1, glue_edgs=False) for w in (2, 3, 5)]
        ks = np.linspace(0.0, 1.0, 7)[:, None]
    else:
        km = zoo.kane_mele(ptt, "odd")
        members = [km, _quiet(km.make_supercell, [[2, 0], [0, 1]], to_home=False)]
        ks = np.array([[0.1, 0.2], [0.35, 0.6]])
    fam = family([carry(m) for m in members])
    jfam = jfamily(members)
    got = fam.energies(ks)
    want = jfam.energies(ks)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= TOL * max(1.0, np.abs(want).max())
    assert fam.pad_energy == pytest.approx(jfam.pad_energy, abs=1e-12)
    per = np.stack([ks + 0.01 * p for p in range(len(members))])  # per-member k-points
    assert np.abs(fam.energies(per) - jfam.energies(per)).max() <= TOL * max(1.0, np.abs(want).max())
    if case == "kane_mele spinful":
        np.testing.assert_allclose(fam.chern(nocc=[2, 4], nk=(11, 11)), [0.0, 0.0], atol=1e-9)


def test_family_validation():
    hal = carry(_quiet(zoo.haldane, ptt))
    with pytest.raises(PythtbError):
        family([])
    with pytest.raises(PythtbError):
        family([hal, carry(jzoo.chain())])
    with pytest.raises(PythtbError):
        family([hal]).chern(nocc=[5])
    with pytest.raises(PythtbError, match="k_list"):
        family([hal]).energies(np.zeros((2, 2, 2, 2)))


def _fkm_loop(L):
    return [jzoo.fu_kane_mele(beta=2 * np.pi * i / L) for i in range(L)]


@pytest.mark.parametrize("refine", [False, True])
def test_second_chern_matches_jax(refine):
    loop = _fkm_loop(6)
    got = flows.second_chern([carry(m) for m in loop], (0, 1), nk=(5, 5, 5), refine=refine)
    want = jflows.second_chern(loop, (0, 1), nk=(5, 5, 5), refine=refine)
    assert abs(got - want) <= TOL


def test_axion_theta_matches_jax():
    path = [jzoo.fu_kane_mele(beta=np.pi * i / 5) for i in range(6)]
    got = flows.axion_theta([carry(m) for m in path], (0, 1), nk=(5, 5, 5), refine=False)
    want = jflows.axion_theta(path, (0, 1), nk=(5, 5, 5), refine=False)
    assert abs(got - want) <= TOL


def test_second_chern_orientation_and_guards():
    loop = [carry(m) for m in _fkm_loop(6)]
    a = flows.second_chern(loop, (0, 1), nk=(4, 4, 4), refine=False)
    b = flows.second_chern(loop[::-1], (0, 1), nk=(4, 4, 4), refine=False)
    assert abs(a + b) <= 1e-10
    with pytest.raises(ValueError, match="dim_k"):
        flows.second_chern([carry(jzoo.haldane())] * 6, (0,), nk=(4, 4, 4))
    with pytest.raises(ValueError, match="slices"):
        flows.second_chern(loop[:3], (0, 1))
    with pytest.raises(ValueError, match="path slices"):
        flows.axion_theta(loop[:3], (0, 1))
