"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: every test skips where torch sees no GPU.  On an H100
run them with

    python -m pytest tests/test_torch_kernels.py -q -m cuda --noconftest

(``tests/conftest.py`` imports JAX, which a GPU machine need not have).

Inputs are made with numpy.random.default_rng(seed); each kernel and its
plain version get the same CUDA tensors, and agree to 1e-12 in float64
(unit-norm states, so determinants and phases are O(1)).
"""

import math

import numpy as np
import pytest
import torch

from pythtb_tpu_torch import config, core, flows
from pythtb_tpu_torch.ops import _kernels, berry, eigh, hamiltonian, position

from . import zoo

pytestmark = pytest.mark.cuda

TOL = 1e-12


@pytest.fixture(autouse=True, scope="module")
def on_cpu():
    """Models of these tests finalize where they are told; the package's
    own default stays the CPU here, as in every test file of the port."""
    prev = config._device
    config.set_device("cpu")
    yield
    config._device = prev


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda", torch.cuda.current_device())


def _random_data(seed, dim_k, nspin, dev, norb=6, nhop=40):
    rng = np.random.default_rng(seed)
    dim_r = max(dim_k, 1)
    if nspin == 1:
        ons = rng.normal(size=norb)
        amps = rng.normal(size=nhop) + 1j * rng.normal(size=nhop)
    else:
        a = rng.normal(size=(norb, 2, 2)) + 1j * rng.normal(size=(norb, 2, 2))
        ons = a + np.conj(np.swapaxes(a, -1, -2))
        amps = rng.normal(size=(nhop, 2, 2)) + 1j * rng.normal(size=(nhop, 2, 2))
    data = core.finalize(
        dim_k, dim_r, list(range(dim_k)), nspin, norb, rng.random((norb, dim_r)), ons,
        amps, rng.integers(0, norb, nhop), rng.integers(0, norb, nhop),
        rng.integers(-2, 3, (nhop, dim_r)), dev,
    )
    k = torch.as_tensor(rng.uniform(-1, 1, (257, dim_k)), dtype=torch.float64).to(dev)
    return data, k


def _unit_states(seed, grid, S, F, dev):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=tuple(grid) + (S, F)) + 1j * rng.normal(size=tuple(grid) + (S, F))
    z /= np.linalg.norm(z, axis=-1, keepdims=True)
    return torch.as_tensor(z).to(dev)


def _max_diff(a, b):
    torch.cuda.synchronize()
    assert a.shape == b.shape
    return float((a - b).abs().max())


@pytest.mark.parametrize("dim_k,nspin", [(0, 1), (1, 1), (2, 1), (3, 1), (0, 2), (2, 2), (3, 2)])
def test_assemble_kernel(dev, dim_k, nspin):
    data, k = _random_data(dim_k + 5 * nspin, dim_k, nspin, dev)
    before = _kernels.LAUNCHES["assemble"]
    H = hamiltonian.assemble(data, k)
    assert _kernels.LAUNCHES["assemble"] == before + 1
    assert _max_diff(H, hamiltonian._assemble_plain(data, k)) < TOL


def test_assemble_rejects_bad_input(dev):
    data, k = _random_data(0, 2, 1, dev)
    with pytest.raises(TypeError):
        hamiltonian.assemble(data, k.float())
    with pytest.raises(ValueError):
        hamiltonian.assemble(data, torch.cat([k, k], dim=1)[:, ::2])


def test_eig2_kernel(dev):
    rng = np.random.default_rng(4)
    H = rng.normal(size=(300, 2, 2)) + 1j * rng.normal(size=(300, 2, 2))
    H = H + np.conj(np.swapaxes(H, -1, -2))
    H[:50, 0, 0] = H[:50, 1, 1] - 0.3  # delta < 0
    H[50:60, 0, 0] = H[50:60, 1, 1]  # delta == 0
    H[60:70] = np.eye(2) * rng.normal(size=(10, 1, 1))  # exactly degenerate
    Ht = torch.as_tensor(H).to(dev)
    w, v = eigh.eig2(Ht)
    wp, vp = eigh._eig2_plain(Ht)
    assert _max_diff(w, wp) < TOL
    assert _max_diff(v, vp) < TOL


@pytest.mark.parametrize("S", [1, 2, 3, 5, 8, 9])
def test_link_dets_kernel(dev, S):
    w = _unit_states(S, (5, 4, 6), S, S + 3, dev)
    launched = _kernels.LAUNCHES["link_dets"]
    library = _kernels.LAUNCHES["link_dets_library"]
    for axis in range(3):
        assert _max_diff(berry.link_dets(w, axis), berry._link_dets_plain(w, axis)) < TOL
    if S > 8:  # the explicit shape rule, not a kernel launch
        assert _kernels.LAUNCHES["link_dets_library"] == library + 3
        assert _kernels.LAUNCHES["link_dets"] == launched
    else:
        assert _kernels.LAUNCHES["link_dets"] == launched + 3


@pytest.mark.parametrize("grid", [(7, 9), (3, 5, 6), (2, 3, 4, 5)])
def test_plaquette_flux_kernel(dev, grid):
    w = _unit_states(len(grid), grid, 2, 4, dev)
    Dr, Du = berry._plane_link_dets(w)
    for individual in (False, True):
        got, gmin = berry.plaquette_flux(Dr, Du, individual)
        want, wmin = berry._plaquette_flux_plain(Dr, Du, individual)
        torch.cuda.synchronize()
        diff = torch.remainder(got - want + math.pi, 2 * math.pi) - math.pi
        assert float(diff.abs().max()) < TOL
        assert _max_diff(gmin, wmin) < TOL


@pytest.mark.parametrize("S", [1, 2, 3, 4, 8, 9])
def test_wilson_loop_kernel(dev, S):
    """Every string orientation: axis 0 (outer 1, inner 24), axis 1
    (outer 5, inner 6), axis 2 (outer 20, inner 1)."""
    w = _unit_states(20 + S, (5, 4, 6), S, 2 * S, dev)
    launched = _kernels.LAUNCHES["wilson_loop"]
    library = _kernels.LAUNCHES["wilson_loop_library"]
    for axis in range(3):
        prod, smin = berry.wilson_loop(w, axis)
        want, want_min = berry._wilson_loop_plain(w, axis)
        assert _max_diff(prod, want) < TOL
        assert _max_diff(smin, want_min) < TOL
        # products of unitaries stay unitary
        eye = torch.eye(S, dtype=prod.dtype, device=dev)
        assert _max_diff(prod @ prod.conj().transpose(-1, -2), eye.expand_as(prod)) < TOL
    if S > 8:  # the explicit shape rule, not a kernel launch
        assert _kernels.LAUNCHES["wilson_loop_library"] == library + 3
        assert _kernels.LAUNCHES["wilson_loop"] == launched
    else:
        assert _kernels.LAUNCHES["wilson_loop"] == launched + 3


@pytest.mark.parametrize("S,F", [(1, 3), (2, 4), (3, 5), (8, 16), (20, 39)])
def test_position_kernel(dev, S, F):
    rng = np.random.default_rng(S + F)
    B, nsta = 11, S + 3
    z = rng.normal(size=(B, nsta, F)) + 1j * rng.normal(size=(B, nsta, F))
    z /= np.linalg.norm(z, axis=-1, keepdims=True)  # unit states, as eigenvectors are
    w = torch.as_tensor(z).to(dev)
    pos = torch.as_tensor(rng.uniform(0.0, 1.0, F) + rng.integers(0, 20, F)).to(dev)  # slab coordinates
    occ = torch.as_tensor(rng.permutation(nsta)[:S]).to(dev)
    before = _kernels.LAUNCHES["position"]
    X = position.xmat(w, pos, occ)
    assert _max_diff(X, position._xmat_plain(w, pos, occ)) < TOL
    assert float((X - X.conj().transpose(-1, -2)).abs().max()) == 0.0  # exactly Hermitian
    d = position.xmat(w, pos, occ, diagonal=True)
    assert _max_diff(d, position._xdiag_plain(w, pos, occ)) < TOL
    Xall = position.xmat(w, pos)
    assert _max_diff(Xall, position._xmat_plain(w, pos)) < TOL
    assert _kernels.LAUNCHES["position"] == before + 3


@pytest.mark.parametrize("n", [3, 4, 8])
def test_library_eigh_takes_large_batches(dev, n):
    """eigh_batched hands torch.linalg.eigh slices of eigh.LIBRARY_BATCH
    matrices; one cuSOLVER call on the whole batch is refused."""
    rng = np.random.default_rng(n)
    B = 2 * eigh.LIBRARY_BATCH + 5
    z = rng.normal(size=(B, n, n)) + 1j * rng.normal(size=(B, n, n))
    H = torch.as_tensor(z + np.conj(np.swapaxes(z, -1, -2))).to(dev)
    w, v = eigh.eigh_batched(H)
    want = torch.linalg.eigvalsh(H.cpu())
    assert _max_diff(w.cpu(), want) < TOL * 10
    assert _max_diff(eigh.eigvalsh_batched(H).cpu(), want) < TOL * 10
    # rows are states: H v_s = w_s v_s
    resid = torch.einsum("bij,bsj->bsi", H, v) - w[..., None] * v
    assert float(resid.abs().max()) < TOL * 10


def test_main_path_goes_through_kernels(dev):
    import pythtb_tpu_torch as pt

    prev = config.device()
    config.set_device(dev)
    try:
        _kernels.reset_launches()
        m = zoo.haldane(pt)
        c = flows.chern_number(m, [0], nk=(31, 31))
        wf = pt.wf_array(m, [31, 31])
        wf.solve_on_grid([-0.5, -0.5])
        c_wf = wf.berry_flux([0]) / (2.0 * np.pi)
        km = zoo.kane_mele(pt, "odd")
        z2 = flows.z2_invariant(km, nk=(11, 11))
        ribbon = m.cut_piece(6, 1)
        wr = pt.wf_array(ribbon, [9])
        wr.solve_on_grid([0.0])
        hwfc = wr.position_hwf_all(list(range(6)), 1)
        for name in ("assemble", "eig2", "link_dets", "plaquette_flux", "wilson_loop", "position"):
            assert _kernels.LAUNCHES[name] > 0, name
        config.set_device("cpu")
        wr_cpu = pt.wf_array(ribbon, [9])
        wr_cpu.solve_on_grid([0.0])
        hwfc_cpu = wr_cpu.position_hwf_all(list(range(6)), 1)
    finally:
        config.set_device(prev)
    assert abs(c + 1.0) < 1e-9
    assert abs(c_wf - c) < 1e-10
    assert z2 == 1.0
    assert np.abs(hwfc - hwfc_cpu).max() < 1e-10
