"""The port's real-space markers (``chern_marker``, ``bott_index``,
``sector_marker``, ``spin_chern_marker``) against pythtb_tpu's, on the
CPU in float64: both eigensolver paths, the ``fermi`` counting, the
warnings and the errors.  The device path's kernels (1, 6 and 8) run
their plain versions here; markers agree to 1e-10.
"""

import warnings

import numpy as np
import pytest

import pythtb_tpu
from pythtb_tpu import realspace as jrs
from pythtb_tpu.models import library as jzoo
from pythtb_tpu.models import quasicrystal as jqc
from pythtb_tpu_torch import PythtbError, realspace
from pythtb_tpu_torch.models import library as zoo

from .test_torch_ops import carry, on_cpu  # noqa: F401  (autouse: the port on the CPU)

TOL = 1e-10


def _penrose_flux():
    return pythtb_tpu.magnetic.peierls_model(jqc.penrose(4.5), 0.1, dirs=(0, 1))


def _km_flake(n=4, **kw):
    return jzoo.kane_mele(rashba=0.25, **kw).cut_piece(n, 0).cut_piece(n, 1)


@pytest.mark.parametrize("eigensolver", ["auto", "device", "host"])
def test_chern_marker_matches_jax(eigensolver):
    jm = _penrose_flux()
    pm = carry(jm)
    want = jrs.chern_marker(jm, nocc=20, eigensolver=eigensolver)
    got = realspace.chern_marker(pm, nocc=20, eigensolver=eigensolver)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    # the spinful flake, nocc from a Fermi level in the gap
    jk = _km_flake(3)
    want = jrs.chern_marker(jk, fermi=0.0, eigensolver=eigensolver)
    np.testing.assert_allclose(realspace.chern_marker(carry(jk), fermi=0.0, eigensolver=eigensolver), want,
                               rtol=0, atol=TOL)
    # the trace identity: the marker sums to zero over the sample
    assert abs(got.sum()) < 1e-9


@pytest.mark.parametrize("eigensolver", ["device", "host"])
def test_spin_chern_marker_matches_jax(eigensolver):
    jm = _km_flake(4)
    pm = carry(jm)
    nocc = jm._norb
    want = jrs.spin_chern_marker(jm, nocc=nocc, eigensolver=eigensolver)
    got = realspace.spin_chern_marker(pm, nocc=nocc, eigensolver=eigensolver)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(np.asarray(got[key]), np.asarray(want[key]), rtol=0, atol=TOL, err_msg=key)


def test_sector_marker_options_match_jax():
    """A full Hermitian grading, an explicit split and the fermi count;
    the warnings of both packages name the same problem."""
    jm = _km_flake(3)
    pm = carry(jm)
    rng = np.random.default_rng(4)
    a = rng.normal(size=(jm._nsta, jm._nsta)) + 1j * rng.normal(size=(jm._nsta, jm._nsta))
    op = a + a.conj().T
    for kw in (dict(nocc=jm._norb), dict(nocc=jm._norb, split=3), dict(fermi=0.0)):
        with warnings.catch_warnings(record=True) as wj:
            warnings.simplefilter("always")
            want = jrs.sector_marker(jm, op, **kw)
        with warnings.catch_warnings(record=True) as wp:
            warnings.simplefilter("always")
            got = realspace.sector_marker(pm, op, **kw)
        assert [str(w.message).split(" (")[0] for w in wp] == [str(w.message).split(" (")[0] for w in wj]
        for key in want:
            np.testing.assert_allclose(np.asarray(got[key]), np.asarray(want[key]), rtol=0, atol=TOL)


@pytest.mark.parametrize("eigensolver", ["auto", "host"])
def test_bott_index_matches_jax(eigensolver):
    js = jrs.torus_sample(jzoo.haldane(), (6, 6), onsite_disorder=2.0, seed=1)
    ps = realspace.torus_sample(zoo.haldane(), (6, 6), onsite_disorder=2.0, seed=1)
    for kw in (dict(nocc=36), dict(fermi=0.0)):
        want = jrs.bott_index(js, eigensolver=eigensolver, **kw)
        got = realspace.bott_index(ps, eigensolver=eigensolver, **kw)
        assert abs(got - want) < TOL
    assert abs(got + 1.0) < 1e-6
    # a spinful sample: the densify of the 2 x 2 blocks
    jk = jrs.torus_sample(jzoo.kane_mele(), (3, 3), onsite_disorder=0.5, seed=3)
    pk = realspace.torus_sample(zoo.kane_mele(), (3, 3), onsite_disorder=0.5, seed=3)
    assert abs(realspace.bott_index(pk, nocc=18, eigensolver=eigensolver)
               - jrs.bott_index(jk, nocc=18, eigensolver=eigensolver)) < TOL


def test_dense_from_ell_is_exact():
    ps = realspace.torus_sample(zoo.kane_mele(), (3, 2), onsite_disorder=0.5, seed=3)
    from pythtb_tpu_torch.ops import matvec

    np.testing.assert_array_equal(realspace._dense_from_ell(ps.h).numpy(), matvec.to_dense(ps.h))


def test_marker_errors():
    pm = carry(_km_flake(3))
    hal = carry(jzoo.haldane())
    for fn in (realspace.chern_marker, lambda m, **kw: realspace.sector_marker(m, np.ones(m._nsta), **kw)):
        with pytest.raises(PythtbError):
            fn(hal, nocc=1)  # periodic
        with pytest.raises(PythtbError):
            fn(pm)  # neither nocc nor fermi
        with pytest.raises(PythtbError):
            fn(pm, nocc=2, fermi=0.0)  # both
        with pytest.raises(PythtbError):
            fn(pm, nocc=pm._nsta)
        with pytest.raises(PythtbError):
            fn(pm, nocc=4, eigensolver="gpu")
    with pytest.raises(PythtbError):
        realspace.chern_marker(pm, fermi=-99.0)
    with pytest.raises(PythtbError):
        realspace.sector_marker(pm, np.ones(5), nocc=4)
    with pytest.raises(PythtbError):
        realspace.sector_marker(pm, np.triu(np.ones((pm._nsta, pm._nsta))), nocc=4)
    with pytest.raises(PythtbError):
        realspace.sector_marker(pm, np.ones(pm._nsta), nocc=4, split=4)
    with pytest.raises(PythtbError):
        realspace.spin_chern_marker(carry(jzoo.haldane().cut_piece(3, 0).cut_piece(3, 1)), nocc=9)
    ps = realspace.torus_sample(zoo.haldane(), (3, 3))
    with pytest.raises(PythtbError):
        realspace.bott_index(ps)
    with pytest.raises(PythtbError):
        realspace.bott_index(ps, nocc=0)
    with pytest.raises(PythtbError):
        realspace.bott_index(realspace.torus_sample(zoo.chain(), (5,)), nocc=2)
