"""The port's ELL Hamiltonian, Peierls fields and model zoo against
pythtb_tpu's, on the CPU in float64.

The ELL tables (``sparse_h``, ``sparse_h_k``) and their Gershgorin
windows are built by the same host NumPy code in both packages and must
agree to 1e-15; ``matvec`` (kernel 8's plain version here) agrees with
the JAX einsum to 1e-13 on the same vectors.  Peierls-phased models and
every constructor of ``models.library`` must give the same hop tables
and bands (1e-12).
"""

import io
from contextlib import redirect_stdout

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pythtb_tpu
import pythtb_tpu_torch
from pythtb_tpu.ops import matvec as jmatvec
from pythtb_tpu.utils.xfer import host_unpack
from pythtb_tpu_torch import magnetic
from pythtb_tpu_torch.ops import matvec

from . import zoo
from .test_torch_ops import carry, on_cpu, random_model  # noqa: F401  (autouse: the port on the CPU)
from .test_torch_surgery import _bands, _hop_table


def _same_sparse(ph, jh, tol=1e-15):
    assert (ph.norb, ph.nspin, ph.nsta) == (jh.norb, jh.nspin, jh.nsta)
    np.testing.assert_array_equal(ph.cols.numpy(), np.asarray(jh.cols))
    assert ph.cols.dtype == torch.int32
    np.testing.assert_allclose(ph.vals.numpy(), host_unpack(np.asarray(jh.vals)), rtol=0, atol=tol)
    np.testing.assert_allclose(ph.window, jh.window, rtol=0, atol=tol)


def _same_matvec(ph, jh, seed):
    rng = np.random.default_rng(seed)
    for B in (1, 5):
        shape = (ph.norb, 2, B) if ph.nspin == 2 else (ph.norb, B)
        x = rng.normal(size=shape) + 1j * rng.normal(size=shape)
        want = np.asarray(jmatvec.matvec(jh, jnp.asarray(x)))
        got = matvec.matvec(ph, torch.as_tensor(x)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-13)


FINITE = {
    "random nspin1": lambda: random_model(3, 0, 1, norb=9, nhop=20),
    "random nspin2": lambda: random_model(4, 0, 2, norb=7, nhop=15),
    "haldane flake": lambda: zoo.haldane(pythtb_tpu).cut_piece(4, 0).cut_piece(3, 1),
    "kane_mele flake": lambda: zoo.kane_mele(pythtb_tpu, "odd").cut_piece(3, 0).cut_piece(3, 1),
}


@pytest.mark.parametrize("name", sorted(FINITE))
def test_sparse_h_matches_jax(name):
    jm = FINITE[name]()
    with redirect_stdout(io.StringIO()):
        pm = carry(jm)
    jh, ph = jmatvec.sparse_h(jm), matvec.sparse_h(pm)
    _same_sparse(ph, jh)
    assert matvec.gershgorin_window(ph) == ph.window
    _same_matvec(ph, jh, len(name))
    np.testing.assert_array_equal(matvec.to_dense(ph), jmatvec.to_dense(jh))
    # Gershgorin: the window holds the spectrum
    ev = np.linalg.eigvalsh(matvec.to_dense(ph))
    assert ph.window[0] <= ev.min() + 1e-12 and ev.max() <= ph.window[1] + 1e-12


PERIODIC = {
    "random dim_k 2 nspin1": lambda: random_model(5, 2, 1, norb=5, nhop=14),
    "random dim_k 2 nspin2": lambda: random_model(6, 2, 2, norb=4, nhop=12),
    # same-orbital (i == j, R != 0) spin hops land in diagonal ELL slots:
    # the nspin-2 window must sum every one of them
    "kane_mele": lambda: zoo.kane_mele(pythtb_tpu, "odd"),
    "haldane": lambda: zoo.haldane(pythtb_tpu),
}


@pytest.mark.parametrize("name", sorted(PERIODIC))
def test_sparse_h_k_matches_jax(name):
    jm = PERIODIC[name]()
    pm = carry(jm)
    for kpt in ([0.0, 0.0], [0.17, -0.41]):
        jh, ph = jmatvec.sparse_h_k(jm, kpt), matvec.sparse_h_k(pm, kpt)
        _same_sparse(ph, jh)
        _same_matvec(ph, jh, 7)
        # the ELL form is H(k) itself
        np.testing.assert_allclose(matvec.to_dense(ph), pm.gen_ham(np.array([kpt]))[0], rtol=0, atol=1e-13)
        ev = np.linalg.eigvalsh(matvec.to_dense(ph))
        assert ph.window[0] <= ev.min() + 1e-12 and ev.max() <= ph.window[1] + 1e-12


def _outcome(mod, fn):
    try:
        fn(mod)
    except Exception as exc:  # noqa: BLE001 - the outcome is what is compared
        return type(exc).__name__, str(exc)
    return "ok"


GUARDS = {
    "sparse_h periodic": lambda mod: mod.ops.matvec.sparse_h(zoo.haldane(mod)),
    "sparse_h_k finite": lambda mod: mod.ops.matvec.sparse_h_k(zoo.haldane(mod).cut_piece(2, 0).cut_piece(2, 1), []),
    "sparse_h_k kpt length": lambda mod: mod.ops.matvec.sparse_h_k(zoo.haldane(mod), [0.1]),
    "peierls periodic dir": lambda mod: mod.magnetic.peierls_model(zoo.haldane(mod), 0.1),
    "peierls same dirs": lambda mod: mod.magnetic.peierls_model(zoo.haldane(mod).cut_piece(2, 0), 0.1, dirs=(0, 0)),
    "peierls dir range": lambda mod: mod.magnetic.peierls_model(zoo.haldane(mod).cut_piece(2, 0), 0.1, dirs=(0, 2)),
    "supercell finite dir": lambda mod: mod.magnetic.magnetic_supercell(zoo.haldane(mod).cut_piece(2, 0), 1, 3),
    "supercell irrational": lambda mod: mod.magnetic.magnetic_supercell(zoo.haldane(mod), 0.5, 3),
    "supercell q": lambda mod: mod.magnetic.magnetic_supercell(zoo.haldane(mod), 1, 0),
}


@pytest.mark.parametrize("name", sorted(GUARDS))
def test_guards_match_jax(name):
    import pythtb_tpu.ops.matvec  # noqa: F401  (mod.ops.matvec below)
    import pythtb_tpu_torch.ops.matvec  # noqa: F401

    with redirect_stdout(io.StringIO()):
        want = _outcome(pythtb_tpu, GUARDS[name])
        got = _outcome(pythtb_tpu_torch, GUARDS[name])
    assert want != "ok"
    assert got == want


def _same_model(pm, jm):
    for attr in ("_dim_k", "_dim_r", "_per", "_nspin", "_norb", "_nsta"):
        assert getattr(pm, attr) == getattr(jm, attr), attr
    np.testing.assert_allclose(pm._lat, jm._lat, rtol=0, atol=1e-12)
    np.testing.assert_allclose(pm._orb, jm._orb, rtol=0, atol=1e-12)
    np.testing.assert_allclose(pm._site_energies, jm._site_energies, rtol=0, atol=1e-12)
    (pa, pij, pR), (ja, jij, jR) = _hop_table(pm), _hop_table(jm)
    np.testing.assert_array_equal(pij, jij)
    np.testing.assert_allclose(pa, ja, rtol=0, atol=1e-12)
    if jR is not None:
        np.testing.assert_allclose(pR, jR, rtol=0, atol=1e-12)
    np.testing.assert_allclose(_bands(pm), _bands(jm), rtol=0, atol=1e-12)


@pytest.mark.parametrize("phi", [1.0 / 9.0, 0.37])
def test_peierls_model_matches_jax(phi):
    """The flake of the KPM workloads (square lattice, cut, Peierls field,
    cut again) and a Haldane ribbon with fractional orbital positions."""
    with redirect_stdout(io.StringIO()):
        for build in (
            lambda mod: mod.magnetic.peierls_model(mod.models.square().cut_piece(5, 0), phi).cut_piece(4, 1),
            lambda mod: mod.magnetic.peierls_model(zoo.haldane(mod).cut_piece(3, 1), phi, dirs=(1, 0)),
            lambda mod: mod.magnetic.peierls_model(zoo.kane_mele(mod, "odd").cut_piece(3, 0), phi),
        ):
            _same_model(build(pythtb_tpu_torch), build(pythtb_tpu))


@pytest.mark.parametrize("p,q", [(1, 3), (-2, 5)])
def test_magnetic_supercell_matches_jax(p, q):
    with redirect_stdout(io.StringIO()):
        for build in (
            lambda mod: mod.magnetic.magnetic_supercell(mod.models.square(), p, q),
            lambda mod: mod.magnetic.magnetic_supercell(zoo.haldane(mod), p, q, dirs=(1, 0)),
        ):
            _same_model(build(pythtb_tpu_torch), build(pythtb_tpu))
    # TKNN: the lowest Landau subband of the square lattice at flux 1/3
    if (p, q) == (1, 3):
        sc = magnetic.magnetic_supercell(pythtb_tpu_torch.models.square(), p, q)
        assert abs(pythtb_tpu_torch.flows.chern_number(sc, [0], nk=(21, 21)) - 1.0) < 1e-8


LIBRARY = {
    "chain": lambda mod: mod.models.chain(),
    "molecule_nh3": lambda mod: mod.models.molecule_nh3(),
    "trestle": lambda mod: mod.models.trestle(),
    "checkerboard": lambda mod: mod.models.checkerboard(),
    "graphene": lambda mod: mod.models.graphene(delta=0.1),
    "bn": lambda mod: mod.models.bn(),
    "haldane": lambda mod: mod.models.haldane(),
    "kane_mele": lambda mod: mod.models.kane_mele(),
    "three_site_chain": lambda mod: mod.models.three_site_chain(0.3),
    "cscl": lambda mod: mod.models.cscl(),
    "fu_kane_mele": lambda mod: mod.models.fu_kane_mele(beta=0.3),
    "square": lambda mod: mod.models.square(),
    "ssh": lambda mod: mod.models.ssh(),
    "lieb": lambda mod: mod.models.lieb(),
    "kagome": lambda mod: mod.models.kagome(),
    "qwz": lambda mod: mod.models.qwz(),
    "bhz": lambda mod: mod.models.bhz(),
    "bbh": lambda mod: mod.models.bbh(),
    "weyl": lambda mod: mod.models.weyl(),
    "triaxial_graphene_flake": lambda mod: mod.models.triaxial_graphene_flake(4, 0.01),
}


@pytest.mark.parametrize("name", sorted(LIBRARY))
def test_model_library_matches_jax(name):
    with redirect_stdout(io.StringIO()):
        jm, pm = LIBRARY[name](pythtb_tpu), LIBRARY[name](pythtb_tpu_torch)
    assert isinstance(pm, pythtb_tpu_torch.tb_model)
    _same_model(pm, jm)


def test_every_library_constructor_is_covered():
    from pythtb_tpu_torch.models import library, moire, quasicrystal

    names = {n for n in pythtb_tpu_torch.models.__all__ if n != "apply_strain"}
    # the moire and quasicrystal constructors have their own test files
    names -= set(moire.__all__) | set(quasicrystal.__all__)
    assert names == set(LIBRARY)
    assert all(getattr(pythtb_tpu_torch.models, n) is getattr(library, n) for n in names)
