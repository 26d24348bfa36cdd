"""The port's kernel modules against the JAX functions they replace.

Each test makes its inputs with numpy.random.default_rng(seed), runs
them through pythtb_tpu on the CPU (float64, as the JAX package's own
tests run it) and through pythtb_tpu_torch on the CPU, where every
kernel wrapper runs its plain PyTorch version, and compares at the
stated tolerance.  Models are built in pythtb_tpu and carried across
with pythtb_tpu_torch.convert.  The port runs on the CPU here because
the module's autouse fixture ``on_cpu`` asks for it.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pythtb_tpu
from pythtb_tpu.ops import berry as jberry
from pythtb_tpu.ops.eigh import _eig2_analytic
from pythtb_tpu.ops.solver import hamiltonian_kpts
from pythtb_tpu.utils.xfer import host_pack
from pythtb_tpu_torch import config, convert
from pythtb_tpu_torch.ops import berry, eigh, hamiltonian

ATOL = 1e-12


@pytest.fixture(autouse=True, scope="module")
def on_cpu():
    """The port defaults to the CUDA device; its CPU tests ask for the CPU
    (and put back whatever was chosen before)."""
    prev = config._device
    config.set_device("cpu")
    yield
    config._device = prev


def state_of(m):
    """Host state of a PythTB-style model, for convert.tb_model_from_state."""
    hops = m._hoppings
    return {
        "dim_k": m._dim_k, "dim_r": m._dim_r, "lat": m._lat, "orb": m._orb,
        "per": m._per, "nspin": m._nspin, "site_energies": m._site_energies,
        "amps": np.array([h[0] for h in hops], dtype=complex).reshape(
            (len(hops),) + ((2, 2) if m._nspin == 2 else ())
        ),
        "i": np.array([h[1] for h in hops], dtype=int),
        "j": np.array([h[2] for h in hops], dtype=int),
        "R": np.array([h[3] if m._dim_k else np.zeros(m._dim_r) for h in hops]).reshape(
            len(hops), m._dim_r
        ),
    }


def carry(m):
    """The pythtb_tpu model ``m`` as a pythtb_tpu_torch model."""
    return convert.tb_model_from_state(state_of(m))


def random_model(seed, dim_k, nspin, norb=4, nhop=10):
    """A random pythtb_tpu model (dim_r = max(dim_k, 1))."""
    rng = np.random.default_rng(seed)
    dim_r = max(dim_k, 1)
    m = pythtb_tpu.tb_model(dim_k, dim_r, np.eye(dim_r) + 0.1 * np.triu(rng.random((dim_r, dim_r)), 1),
                            rng.random((norb, dim_r)), nspin=nspin)
    if nspin == 1:
        m.set_onsite(list(rng.normal(size=norb)))
    else:
        ons = []
        for _ in range(norb):
            a = rng.normal(size=(2, 2)) + 1j * rng.normal(size=(2, 2))
            ons.append(a + a.conj().T)
        m.set_onsite(ons)
    placed = 0
    while placed < nhop:
        i, j = (int(x) for x in rng.integers(0, norb, 2))
        R = list(rng.integers(-2, 3, dim_r)) if dim_k else None
        amp = complex(rng.normal(), rng.normal())
        if nspin == 2:
            amp = rng.normal(size=(2, 2)) + 1j * rng.normal(size=(2, 2))
        try:
            m.set_hop(amp, i, j, R)
        except pythtb_tpu.PythtbError:
            continue  # on-site term or an implied conjugate: draw again
        placed += 1
    return m


def bloch_pair(m):
    """(static, data) of the JAX model and the port's BlochData from them."""
    static, data = m._get_finalized()
    port = convert.bloch_from_numpy(
        dataclasses.asdict(static), {k: np.asarray(v) for k, v in data._asdict().items()}
    )
    return static, data, port


@pytest.mark.parametrize(
    "dim_k,nspin,nhop",
    [(0, 1, 6), (1, 1, 10), (2, 1, 10), (3, 1, 12), (0, 2, 6), (1, 2, 10), (2, 2, 10),
     (3, 2, 12), (2, 1, 0), (2, 2, 0)],
)
def test_assemble_matches_jax(dim_k, nspin, nhop):
    m = random_model(10 * dim_k + nspin + nhop, dim_k, nspin, nhop=nhop)
    static, data, port = bloch_pair(m)
    rng = np.random.default_rng(7)
    k = rng.uniform(-1.0, 1.0, (9, dim_k)) if dim_k else None
    want = hamiltonian_kpts(static, data, k)
    kt = torch.as_tensor(k if dim_k else np.zeros((1, 0)), dtype=torch.float64)
    got = hamiltonian.assemble(port, kt).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    # the same model carried across as host model state
    np.testing.assert_allclose(carry(m).gen_ham(k), want if dim_k else want[0], rtol=0, atol=ATOL)


def _hermitian_2x2_cases():
    rng = np.random.default_rng(3)
    H = rng.normal(size=(40, 2, 2)) + 1j * rng.normal(size=(40, 2, 2))
    H = H + np.conj(np.swapaxes(H, -1, -2))
    H[:10, 0, 0] = H[:10, 1, 1] - 0.7  # delta < 0
    H[10:15, 0, 0] = H[10:15, 1, 1]  # delta == 0
    H[15:20, 0, 1] = 0.0  # diagonal
    H[15:20, 1, 0] = 0.0
    H[20:25] = np.eye(2) * rng.normal(size=(5, 1, 1))  # exactly degenerate
    return H


def test_eig2_matches_jax():
    H = _hermitian_2x2_cases()
    wj, _ = _eig2_analytic(jnp.asarray(H), True)
    w, v = eigh.eig2(torch.as_tensor(H))
    w, v = w.numpy(), v.numpy()
    np.testing.assert_allclose(w, np.asarray(wj), rtol=0, atol=ATOL)
    np.testing.assert_allclose(w, np.linalg.eigvalsh(H), rtol=0, atol=ATOL)
    # rows are states: orthonormal, eigenvectors, same projectors as numpy
    eye = np.einsum("bsf,btf->bst", v.conj(), v)
    np.testing.assert_allclose(eye, np.broadcast_to(np.eye(2), eye.shape), atol=ATOL)
    resid = np.einsum("bij,bsj->bsi", H, v) - w[:, :, None] * v
    assert np.abs(resid).max() < ATOL * 10
    _, vn = np.linalg.eigh(H[25:])  # non-degenerate rows: projectors agree
    Pn = np.einsum("bfs,bgs->bsfg", vn, vn.conj())
    P = np.einsum("bsf,bsg->bsfg", v[25:], v[25:].conj())
    np.testing.assert_allclose(P, Pn, rtol=0, atol=1e-10)


def _random_states(seed, grid, S, F):
    rng = np.random.default_rng(seed)
    shape = tuple(grid) + (S, F)
    return rng.normal(size=shape) + 1j * rng.normal(size=shape)


def _wrapped(a, b):
    """Max |a - b| of phases modulo 2 pi (random plaquettes may sit at +-pi)."""
    return np.abs(np.angle(np.exp(1j * (np.asarray(a) - np.asarray(b))))).max()


@pytest.mark.parametrize("S", [1, 2, 3, 9])
def test_link_dets_and_plaquette_flux_match_jax(S):
    F = S + 2
    w = _random_states(S, (6, 5), S, F)
    wt = torch.as_tensor(w)
    want_plaq = np.asarray(jberry.plaquette_phases(jnp.asarray(w)))
    assert _wrapped(berry.plaquette_phases(wt).numpy(), want_plaq) < ATOL
    # full flux-plane route on a 3-D grid of states: planes (0, 2), sums and per plaquette
    w3 = _random_states(10 + S, (5, 3, 4), S, F)
    occ = list(range(S))
    for individual in (False, True):
        want, want_min = jberry.berry_flux_planes(host_pack(w3), occ, 0, 2, 1, 3, individual)
        got, got_min = berry.berry_flux_planes(torch.as_tensor(w3), occ, 0, 2, 1, 3, individual)
        assert got.shape == want.shape
        assert _wrapped(got, want) < ATOL
        assert abs(got_min - want_min) < ATOL * max(1.0, want_min)
    for axis in (0, 1, 2):
        want, want_min = jberry.berry_phase_traced(host_pack(w3), occ, axis, 1, 3)
        got, got_min = berry.berry_phase_traced(torch.as_tensor(w3), occ, axis, 1, 3)
        assert _wrapped(got, want) < ATOL
        assert abs(got_min - want_min) < ATOL * max(1.0, want_min)


def test_library_eigh_runs_in_slices(monkeypatch):
    """Batches beyond eigh.LIBRARY_BATCH go to torch.linalg.eigh in
    slices, with the same result as one call."""
    rng = np.random.default_rng(11)
    H = rng.normal(size=(50, 4, 4)) + 1j * rng.normal(size=(50, 4, 4))
    Ht = torch.as_tensor(H + np.conj(np.swapaxes(H, -1, -2)))
    w1, v1 = eigh.eigh_batched(Ht)
    monkeypatch.setattr(eigh, "LIBRARY_BATCH", 7)
    w2, v2 = eigh.eigh_batched(Ht)
    assert torch.equal(w1, w2) and torch.equal(v1, v2)
    assert torch.equal(eigh.eigvalsh_batched(Ht), torch.linalg.eigvalsh(Ht))
