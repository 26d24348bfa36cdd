"""The port's ``phonon`` module against pythtb_tpu's, on the CPU in
float64, where kernels 1, 15 and 25 run their plain versions.

omega^2 from ``bands`` to 1e-12 (absolute; the values are O(1)) on the
spring honeycomb, a raw non-symmetric ``set_fc`` block, a pinned chain
and a slab with dim_k < dim_r; omega itself to 1e-12 away from the zero
modes and to 1e-7 at acoustic Gamma, where omega = sqrt(clip(w^2)) turns
a 1e-16 difference in w^2 into ~1e-8; the mode vectors up to a phase
each; ``dos`` and ``heat_capacity`` to 1e-12 relative;
``thermal_conductivity`` to 1e-10 relative (the honeycomb, a diatomic
chain at two modes and a monatomic one); ``dynamical_cluster`` with a
mass override to 1e-12; kernel 25's plain version against a NumPy
transcription of the reference's einsums.  The models cross over by
``convert.force_model_from_state``; JAX results are built once per
module.
"""

import numpy as np
import pytest

from pythtb_tpu import phonon as jphonon
from pythtb_tpu_torch import convert, phonon
from pythtb_tpu_torch.ops import phonon_kappa

from .test_torch_ops import on_cpu  # noqa: F401  (autouse: the port on the CPU)

HONEY_LAT = [[1.0, 0.0], [0.5, np.sqrt(3) / 2]]
HONEY_POS = [[1 / 3, 1 / 3], [2 / 3, 2 / 3]]


def fm_state(fm):
    """Host state of a pythtb_tpu force_model, for convert.force_model_from_state."""
    d = fm._dim_r
    return {
        "lat": fm._lat, "pos": fm._pos, "masses": fm._mass, "dim_k": fm._dim_k,
        "fc_blocks": np.array([b[0] for b in fm._fcs]).reshape(-1, d, d),
        "fc_i": np.array([b[1] for b in fm._fcs], dtype=int), "fc_j": np.array([b[2] for b in fm._fcs], dtype=int),
        "fc_R": np.array([b[3] for b in fm._fcs]).reshape(-1, d), "pins": np.array(fm._pin),
    }


def carry_fm(fm):
    return convert.force_model_from_state(fm_state(fm))


def honeycomb(M=jphonon, masses=(1.0, 1.4)):
    fm = M.force_model(HONEY_LAT, HONEY_POS, masses=list(masses))
    fm.set_spring(1.0, 0, 1, [0, 0], kt=0.25)
    fm.set_spring(1.0, 1, 0, [1, 0], kt=0.25)
    fm.set_spring(1.0, 1, 0, [0, 1], kt=0.25)
    return fm


def raw_block():
    """Non-symmetric raw blocks on second-neighbour bonds (their
    antisymmetric parts enter D as i sin(2 pi k.R) terms), pinned so that
    those terms cannot turn the acoustic branches negative near Gamma."""
    fm = honeycomb()
    fm.set_pin(0.15)
    fm.set_fc(-0.05 * np.array([[1.0, 0.3], [-0.2, 0.6]]), 0, 0, [1, 0])
    fm.set_fc(-0.04 * np.array([[0.7, -0.25], [0.1, 1.0]]), 1, 1, [0, 1])
    return fm


def pinned_chain():
    fm = jphonon.force_model([[1.0]], [[0.0], [0.5]], masses=[1.0, 2.5])
    fm.set_spring(1.3, 0, 1, [0])
    fm.set_spring(0.8, 1, 0, [1])
    fm.set_pin(0.2)
    return fm


def slab():
    fm = jphonon.force_model(np.eye(2), [[0.0, 0.0], [0.3, 0.6]], masses=[1.0, 1.8], dim_k=1)
    fm.set_spring(1.0, 0, 0, [1, 0], kt=0.3)
    fm.set_spring(0.7, 1, 1, [1, 0], kt=0.2)
    fm.set_spring(0.9, 0, 1, [0, 0], kt=0.4)
    fm.set_spring(0.5, 1, 0, [1, 0], kt=0.1)
    return fm


def diatomic():
    fm = jphonon.force_model([[1.0]], [[0.0], [0.5]], masses=[1.0, 3.0])
    fm.set_spring(1.0, 0, 1, [0])
    fm.set_spring(1.0, 1, 0, [1])
    return fm


def monatomic():
    fm = jphonon.force_model([[1.0]], [[0.0]], masses=1.3)
    fm.set_spring(0.9, 0, 0, [1])
    return fm


MODELS = {"honeycomb": honeycomb, "raw_block": raw_block, "pinned_chain": pinned_chain, "slab": slab}


def _kpts(fm, n=7, seed=3):
    rng = np.random.default_rng(seed)
    return np.concatenate([np.zeros((1, fm._dim_k)), rng.uniform(-0.5, 0.5, (n, fm._dim_k))])


@pytest.fixture(scope="module")
def jax_bands():
    out = {}
    for name, build in MODELS.items():
        fm = build()
        out[name] = jphonon.bands(fm, _kpts(fm), return_vectors=True)
    return out


@pytest.mark.parametrize("name", sorted(MODELS))
def test_bands_match_jax(name, jax_bands):
    fm = MODELS[name]()
    w_ref, v_ref = jax_bands[name]
    w, v = phonon.bands(carry_fm(fm), _kpts(fm), return_vectors=True)
    assert np.abs(w**2 - w_ref**2).max() <= 1e-12
    away = w_ref > 1e-3
    assert np.abs(w - w_ref)[away].max() <= 1e-12
    assert np.abs(w - w_ref)[~away].max(initial=0.0) <= 1e-7
    # the mode vectors (rows), each up to a phase, where the frequencies are apart
    gaps = np.diff(w_ref**2, axis=1)
    single = np.ones(w_ref.shape, dtype=bool)
    single[:, 1:] &= gaps > 1e-6
    single[:, :-1] &= gaps > 1e-6
    overlap = np.abs(np.einsum("kns,kns->kn", v_ref.conj(), v))
    assert np.abs(overlap - 1.0)[single].max() <= 1e-10


def test_bands_zero_modes_at_gamma():
    """The acoustic sum rule: dim_r exact zero modes at Gamma, as in JAX."""
    fm = honeycomb()
    w = phonon.bands(carry_fm(fm), [[0.0, 0.0]])[0]
    w_ref = jphonon.bands(fm, [[0.0, 0.0]])[0]
    assert np.abs(w[:2]).max() < 1e-7 and np.abs(w[:2] - w_ref[:2]).max() <= 1e-7
    assert np.abs(w[2:] ** 2 - w_ref[2:] ** 2).max() <= 1e-12


def _pinned_honeycomb():
    fm = honeycomb()
    fm.set_pin(0.15)
    return fm


@pytest.mark.parametrize("build,dos_tol", [(_pinned_honeycomb, 1e-12), (honeycomb, 1e-7)])
def test_dos_and_heat_capacity_match_jax(build, dos_tol):
    """1e-12 relative, but the DOS of a model with acoustic zero modes:
    the grid holds Gamma, where omega = sqrt(clip(w^2)) is 0 or ~1e-8 from
    a 1e-16 w^2 in either package, and the Gaussian's slope at E ~ 0.05
    turns that into ~1e-8 of the DOS (the heat capacity's weight is flat
    there)."""
    fm = build()
    es = np.linspace(0.0, 2.1, 41)
    Ts = np.array([0.02, 0.1, 0.5, 3.0, 200.0])
    pm = carry_fm(fm)
    got, want = phonon.dos(pm, es, 8, smearing=0.05), jphonon.dos(fm, es, 8, smearing=0.05)
    assert np.abs(got - want).max() <= dos_tol * np.abs(want).max()
    got, want = phonon.heat_capacity(pm, Ts, 8), jphonon.heat_capacity(fm, Ts, 8)
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


@pytest.mark.parametrize("build,nk", [(honeycomb, 8), (diatomic, 16), (monatomic, 12), (pinned_chain, 10)])
def test_thermal_conductivity_matches_jax(build, nk):
    fm = build()
    Ts = np.array([0.01, 0.3, 1.0, 40.0])
    got = phonon.thermal_conductivity(carry_fm(fm), Ts, nk, tau=2.0)
    want = jphonon.thermal_conductivity(fm, Ts, nk, tau=2.0)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-10 * np.abs(want).max()


def test_dynamical_cluster_matches_jax():
    fm = honeycomb()
    masses = np.tile([1.0, 1.4], 6)
    masses[4] = 0.45
    H, w = phonon.dynamical_cluster(carry_fm(fm), (2, 3), masses=masses)
    H_ref, w_ref = jphonon.dynamical_cluster(fm, (2, 3), masses=masses)
    assert np.abs(H - H_ref).max() <= 1e-12
    assert np.abs(w**2 - w_ref**2).max() <= 1e-12


def _kappa_reference(vecs, dD, omega, Ts):
    """pythtb_tpu.phonon._kappa_jit's lines after the eigensolve, in NumPy."""
    B = vecs.shape[0]
    dw2 = np.real(np.einsum("bns,bast,bnt->ban", np.conj(vecs), dD, vecs))
    safe = omega > 1e-9
    v = np.where(safe[:, None, :], dw2 / np.where(safe[:, None, :], 2.0 * omega[:, None, :], 1.0), 0.0)
    x = omega[None] / Ts[:, None, None]
    xs = np.where(x < 1e-8, 1.0, x)
    cv = np.where(x < 1e-8, 1.0, (xs / (2.0 * np.sinh(np.minimum(xs, 80.0) / 2.0))) ** 2)
    return np.einsum("tbn,ban,bcn->tac", cv, v, v) / B


@pytest.mark.parametrize("dk,N", [(1, 1), (2, 4), (3, 6)])
def test_kappa_plain_matches_the_reference_einsums(dk, N):
    import torch

    rng = np.random.default_rng(25 + dk)
    B = 33
    vecs = np.linalg.qr(rng.normal(size=(B, N, N)) + 1j * rng.normal(size=(B, N, N)))[0]
    a = rng.normal(size=(B, dk, N, N)) + 1j * rng.normal(size=(B, dk, N, N))
    dD = a + np.conj(np.swapaxes(a, -1, -2))
    omega = rng.uniform(0.0, 3.0, (B, N))
    omega[0, 0] = 0.0
    omega[1, 0] = 5e-10  # below the velocity guard
    Ts = np.array([0.02, 0.3, 1.0, 50.0])  # x past the clamp at 80 and below 1e-8
    got = phonon_kappa._phonon_kappa_plain(*(torch.as_tensor(x) for x in (vecs, dD, omega, Ts))).numpy()
    want = _kappa_reference(vecs, dD, omega, Ts)
    assert np.abs(got - want).max() <= 1e-13 * np.abs(want).max()
