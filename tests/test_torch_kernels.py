"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: every test skips where torch sees no GPU.  On an H100
run them with

    python -m pytest tests/test_torch_kernels.py -q -m cuda --noconftest

(``tests/conftest.py`` imports JAX, which a GPU machine need not have).

Inputs are made with numpy.random.default_rng(seed); each kernel and its
plain version get the same CUDA tensors, and agree to 1e-12 in float64
(unit-norm states, so determinants and phases are O(1)).
"""

import contextlib
import dataclasses
import io
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


@pytest.mark.parametrize("S", [1, 2, 3, 5, 8, 9, 12, 16, 32, 64])
def test_link_dets_kernel(dev, S):
    """Registers up to S 8, a block's shared-memory LU from 9 to 64: every
    S launches the kernel, once per call."""
    w = _unit_states(S, (5, 4, 6), S, S + 3, dev)
    launched = _kernels.LAUNCHES["link_dets"]
    for axis in range(3):
        assert _max_diff(berry.link_dets(w, axis), berry._link_dets_plain(w, axis)) < TOL
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


@pytest.mark.parametrize("S", [1, 2, 3, 4, 8, 9, 12, 16, 32, 64])
def test_wilson_loop_kernel(dev, S):
    """Every string orientation: axis 0 (outer 1, inner 24), axis 1
    (outer 5, inner 6), axis 2 (outer 20, inner 1); two launches a call
    (the links' polar factors, then the chains), every S through the
    kernel."""
    w = _unit_states(20 + S, (5, 4, 6), S, 2 * S, dev)
    launched = _kernels.LAUNCHES["wilson_loop"]
    for axis in range(3):
        prod, smin = berry.wilson_loop(w, axis)
        want, want_min = berry._wilson_loop_plain(w, axis)
        assert _max_diff(prod, want) < TOL
        assert _max_diff(smin, want_min) < TOL
        # products of unitaries stay unitary
        eye = torch.eye(S, dtype=prod.dtype, device=dev)
        assert _max_diff(prod @ prod.conj().transpose(-1, -2), eye.expand_as(prod)) < TOL
    assert _kernels.LAUNCHES["wilson_loop"] == launched + 3 * 2


def _paths(S):
    """Kernel 5's designs that take S states."""
    return [p for p, (_, most) in berry._WILSON_MODES.items() if S <= most]


@pytest.mark.parametrize("S,F", [(9, 12), (12, 15), (16, 20), (20, 39), (32, 40), (64, 72)])
def test_wilson_loop_link_path(dev, S, F):
    """Both designs, a warp and a block a link, on 41-link strings (the
    slab's axis: S 20, F 39) and across the strings (41 of 3 links)."""
    w = _unit_states(100 + S, (41, 3), S, F, dev)
    for path in _paths(S):
        for axis in (0, 1):
            launched = _kernels.LAUNCHES["wilson_loop"]
            prod, smin = berry._wilson_loop(w, axis, path)
            assert _kernels.LAUNCHES["wilson_loop"] == launched + 2
            want, want_min = berry._wilson_loop_plain(w, axis)
            assert _max_diff(prod, want) < TOL
            assert _max_diff(smin, want_min) < TOL


@pytest.mark.parametrize("S", [1, 2, 3, 4, 5, 6, 7, 8])
def test_wilson_loop_paths_at_small_S(dev, S):
    """Both of kernel 5's designs (a warp and a block a link) agree with
    the plain version at S 1-8."""
    w = _unit_states(200 + S, (33, 17), S, S + 8, dev)
    want, want_min = berry._wilson_loop_plain(w, 0)
    for path in _paths(S):
        prod, smin = berry._wilson_loop(w, 0, path)
        assert _max_diff(prod, want) < TOL
        assert _max_diff(smin, want_min) < TOL


def _near_singular_string(S, F, L, eps, seed):
    """One string of L unit-row frames whose link 3 has singular values 1
    (S - 1 times) and ``eps``: the second frame of the link keeps S - 1
    rows of the first and turns the last almost orthogonal, then mixes
    its rows by a random unitary."""
    rng = np.random.default_rng(seed)
    frames = []
    for _ in range(L):
        z = rng.normal(size=(F, S)) + 1j * rng.normal(size=(F, S))
        frames.append(np.linalg.qr(z)[0].T)
    a = frames[3]
    z = rng.normal(size=F) + 1j * rng.normal(size=F)
    u = z - a.T @ (a.conj() @ z)
    u /= np.linalg.norm(u)
    b = a.copy()
    b[-1] = math.sqrt(1.0 - eps * eps) * u + eps * a[-1]
    q = np.linalg.qr(rng.normal(size=(S, S)) + 1j * rng.normal(size=(S, S)))[0]
    frames[4] = q @ b
    return np.stack(frames)


@pytest.mark.parametrize("S", [4, 12, 40])
def test_wilson_loop_near_singular_link(dev, S):
    """A link with smallest singular value ~1e-9: every path gives the
    plain path's s_min, and a unitary product."""
    w = torch.as_tensor(_near_singular_string(S, S + 6, 9, 1e-9, S)[None]).to(dev)
    want, want_min = berry._wilson_loop_plain(w, 1)
    assert abs(float(want_min[0]) - 1e-9) < 1e-12
    eye = torch.eye(S, dtype=want.dtype, device=dev)
    for path in _paths(S):
        prod, smin = berry._wilson_loop(w, 1, path)
        assert _max_diff(smin, want_min) < TOL
        assert _max_diff(prod @ prod.conj().transpose(-1, -2), eye.expand_as(prod)) < TOL


def test_wilson_loop_refuses_a_path_beyond_its_states(dev):
    w = _unit_states(5, (3, 4), 33, 40, dev)
    with pytest.raises(ValueError, match="'warp' path does not take 33"):
        berry._wilson_loop(w, 0, "warp")
    with pytest.raises(ValueError, match="no 'registers' path"):
        berry._wilson_loop(w, 0, "registers")


def test_berry_kernels_refuse_more_than_64_bands(dev):
    w = _unit_states(3, (3, 4), 65, 66, dev)
    for fn in (berry.link_dets, berry.wilson_loop):
        with pytest.raises(ValueError, match="at most 64 bands.*set_device"):
            fn(w, 0)


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


@pytest.mark.parametrize("B,S,nsta,F,permuted", [
    (1, 800, 800, 800, False),  # the 800-orbital flake's position_matrix
    (1, 392, 784, 784, True),  # the Kane-Mele marker's occupied half
    (3, 33, 40, 97, True),  # ragged tiles
    (2, 333, 340, 797, True),
    (5, 64, 64, 64, False),
])
def test_position_tiles(dev, B, S, nsta, F, permuted):
    """Kernel 6's tiled path on the FP64 tensor cores against the plain
    einsum and the thread-an-element path: 1e-12, X exactly Hermitian,
    one launch a call."""
    rng = np.random.default_rng(S)
    z = rng.normal(size=(B, nsta, F)) + 1j * rng.normal(size=(B, nsta, F))
    z /= np.linalg.norm(z, axis=-1, keepdims=True)
    w = torch.as_tensor(z).to(dev)
    pos = torch.as_tensor(rng.uniform(-15.0, 15.0, F)).to(dev)
    order = rng.permutation(nsta) if permuted else np.arange(nsta)
    occ = torch.as_tensor(order[:S]).to(dev)
    want = position._xmat_plain(w, pos, occ)
    for path in ("tiles", "threads"):
        before = _kernels.LAUNCHES["position"]
        X = position._xmat(w, pos, occ, False, path)
        assert _kernels.LAUNCHES["position"] == before + 1
        assert _max_diff(X, want) < TOL
        assert float((X - X.conj().transpose(-1, -2)).abs().max()) == 0.0  # exactly Hermitian
        assert float(torch.diagonal(X, dim1=-2, dim2=-1).imag.abs().max()) == 0.0
    assert position._position_path(S) == "tiles"


@pytest.mark.parametrize("n", [3, 4, 8])
def test_library_eigh_takes_large_batches(dev, n):
    """The library solve hands torch.linalg.eigh slices of
    eigh.LIBRARY_BATCH matrices (one cuSOLVER call on the whole batch is
    refused); eigh_batched, which sends these sizes to kernel 7 on the
    card, takes the same batch in one launch."""
    rng = np.random.default_rng(n)
    B = 2 * eigh.LIBRARY_BATCH + 5
    z = rng.normal(size=(B, n, n)) + 1j * rng.normal(size=(B, n, n))
    H = torch.as_tensor(z + np.conj(np.swapaxes(z, -1, -2))).to(dev)
    want = torch.linalg.eigvalsh(H.cpu())
    for solve, solve_w in ((eigh._library_eigh, eigh._library_eigvalsh), (eigh.eigh_batched, eigh.eigvalsh_batched)):
        w, v = solve(H)
        assert _max_diff(w.cpu(), want) < TOL * 10
        assert _max_diff(solve_w(H).cpu(), want) < TOL * 10
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


# -- the matrix-free stack: kernels 8, 9 and 10 ------------------------------


def _sparse_on(h, dev):
    """A SparseH built on the CPU, moved to ``dev``."""
    return dataclasses.replace(h, cols=h.cols.to(dev), vals=h.vals.to(dev))


def _ell_cases(dev):
    """ELL tables with padded rows: a random finite model of uneven row
    degree at nspin 1 and 2, and a periodic spinful model at one k-point,
    whose same-orbital hops land in diagonal slots."""
    import pythtb_tpu_torch as pt
    from pythtb_tpu_torch.ops import matvec

    cases = {}
    for nspin in (1, 2):
        rng = np.random.default_rng(40 + nspin)
        norb = 37
        with contextlib.redirect_stdout(io.StringIO()):
            m = pt.tb_model(0, 2, np.eye(2), rng.random((norb, 2)), nspin=nspin)
        if nspin == 1:
            m.set_onsite(list(rng.normal(size=norb)))
        placed = 0
        while placed < 90:
            i, j = (int(x) for x in rng.integers(0, norb, 2))
            amp = complex(rng.normal(), rng.normal())
            if nspin == 2:
                amp = rng.normal(size=(2, 2)) + 1j * rng.normal(size=(2, 2))
            try:
                m.set_hop(amp, i, j)
            except pt.PythtbError:
                continue
            placed += 1
        cases["random nspin%d" % nspin] = _sparse_on(matvec.sparse_h(m), dev)
    km = zoo.kane_mele(pt, "odd").make_supercell([[3, 0], [0, 2]])
    cases["kane_mele supercell at k"] = _sparse_on(matvec.sparse_h_k(km, [0.13, -0.31]), dev)
    return cases


def _block(seed, nsta, B, dev):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.normal(size=(nsta, B)) + 1j * rng.normal(size=(nsta, B))).to(dev)


def _ab(h, dev, margin=0.98):
    lo, hi = h.window
    return torch.tensor([0.5 * (hi - lo) / margin + 1e-12, 0.5 * (hi + lo)],
                        dtype=torch.float64, device=dev)


@pytest.mark.parametrize("B", [1, 8, 64])
def test_ell_matvec_kernel(dev, B):
    from pythtb_tpu_torch.ops import matvec

    for name, h in _ell_cases(dev).items():
        x = _block(B, h.nsta, B, dev)
        shape = (h.norb, 2, B) if h.nspin == 2 else (h.norb, B)
        before = _kernels.LAUNCHES["ell_matvec"]
        y = matvec.matvec(h, x.view(shape))
        assert _kernels.LAUNCHES["ell_matvec"] == before + 1
        assert _max_diff(y, matvec._matvec_plain(h, x.view(shape))) < TOL, name
        # rows written into a slot of a wider block (row stride 3 B)
        wide = torch.zeros((h.nsta, 3, B), dtype=torch.complex128, device=dev)
        matvec.apply_rows(h, x, wide[:, 1])
        assert _max_diff(wide[:, 1], y.reshape(h.nsta, B)) < TOL, name
        assert float(wide[:, 0].abs().max()) == 0.0 and float(wide[:, 2].abs().max()) == 0.0


def _grid_cases(dev):
    """ELL tables that kernels 9 and 11 split over many blocks: a ragged
    Haldane flake (1,798 orbitals, nspin 1) and a 20 x 20 Kane-Mele
    supercell at one k-point (800 orbitals, nspin 2)."""
    import pythtb_tpu_torch as pt
    from pythtb_tpu_torch.ops import matvec

    flake = pt.models.haldane().cut_piece(31, 0).cut_piece(29, 1)
    km = pt.models.kane_mele().make_supercell([[20, 0], [0, 20]])
    return {"haldane flake 31x29": _sparse_on(matvec.sparse_h(flake), dev),
            "kane_mele 20x20 at k": _sparse_on(matvec.sparse_h_k(km, [0.13, -0.31]), dev)}


@pytest.mark.parametrize("B,M", [(1, 2), (1, 3), (1, 65), (8, 64), (64, 33)])
def test_cheb_moments_kernel(dev, B, M):
    """One launch a call (the whole recursion, its sums reduced in it), the
    same bits from two calls."""
    from pythtb_tpu_torch.ops import chebyshev

    for name, h in _ell_cases(dev).items():
        x = _block(M, h.nsta, B, dev)
        x = x / x.abs()  # random-phase vectors
        ab = _ab(h, dev)
        before = _kernels.LAUNCHES["cheb_moments"]
        mu = chebyshev.moments(h, ab, x, M, float(h.nsta))
        assert _kernels.LAUNCHES["cheb_moments"] == before + 1
        want = chebyshev._moments_plain(h, ab, x, M, float(h.nsta))
        assert _max_diff(mu, want) < TOL * h.nsta, name
        assert torch.equal(mu, chebyshev.moments(h, ab, x, M, float(h.nsta))), name


@pytest.mark.parametrize("B", [1, 8, 64])
def test_cheb_moments_grid(dev, B):
    """Many blocks (ragged rows, nspin 2), the tables in shared or device
    memory (the plan's shared-memory argument): the same bits either way,
    the plain version's moments to 1e-10 relative."""
    from pythtb_tpu_torch.ops import chebyshev

    for name, h in _grid_cases(dev).items():
        x = _block(B, h.nsta, B, dev)
        x = x / x.abs()
        ab = _ab(h, dev)
        sms, smem = _kernels.card(dev)
        plan = chebyshev._grid_plan(h.norb, h.nspin, B, h.cols.shape[1], sms, smem, "moments")
        assert plan.blocks > 1 and plan.tables == "shared", (name, plan)
        mu = chebyshev.moments(h, ab, x, 128, float(h.nsta))
        want = chebyshev._moments_plain(h, ab, x, 128, float(h.nsta))
        assert _max_diff(mu, want) < 1e-10 * float(want.abs().max()), name
        assert torch.equal(mu, chebyshev._moments(h, ab, x, 128, float(h.nsta), 0)), name


def test_cheb_recursion_kernel(dev):
    from pythtb_tpu_torch.ops import chebyshev

    grid = _grid_cases(dev)
    for name, h in {**_ell_cases(dev), **grid}.items():
        ab = _ab(h, dev)
        x = _block(5, h.nsta, 3, dev)
        x = x / x.abs()
        block = torch.empty((20, h.nsta, 3), dtype=torch.complex128, device=dev)
        block[0] = x
        before = _kernels.LAUNCHES["cheb_moments"]
        got = chebyshev.recursion(h, ab, block.clone())
        assert _kernels.LAUNCHES["cheb_moments"] == before + 1
        want = chebyshev._recursion_plain(h, ab, block.clone())
        assert _max_diff(got, want) < (1e-10 * float(want.abs().max()) if name in grid else TOL), name
        # the same recursion in the Kubo left layout (nsta, count, B), and
        # with the tables read from device memory: the same bits
        left = torch.empty((h.nsta, 20, 3), dtype=torch.complex128, device=dev)
        left[:, 0] = x
        chebyshev.recursion(h, ab, left.permute(1, 0, 2))
        assert torch.equal(left.permute(1, 0, 2), got), name
        assert torch.equal(chebyshev._recursion(h, ab, block.clone(), 0), got), name
        # two slots: T_1 alone
        two = block[:2].clone()
        assert torch.equal(chebyshev.recursion(h, ab, two)[1], got[1]), name


@pytest.mark.parametrize("B,M", [(1, 2), (1, 3), (8, 30)])
def test_cheb_evolve_kernel(dev, B, M):
    from scipy.special import jv

    from pythtb_tpu_torch import dynamics
    from pythtb_tpu_torch.ops import chebyshev

    for name, h in _ell_cases(dev).items():
        ab = _ab(h, dev, margin=1.0)
        a, b = float(ab[0]), float(ab[1])

        def coef(step, order):
            nn = np.arange(order)
            c = (2.0 - (nn == 0)) * (-1.0j) ** nn * jv(nn, a * step) * np.exp(-1.0j * b * step)
            return torch.as_tensor(c).to(dev)

        psi = _block(B + M, h.nsta, B, dev)
        psi = psi / torch.linalg.vector_norm(psi, dim=0)
        c = coef(0.2, M)
        before = _kernels.LAUNCHES["cheb_evolve"]
        got = chebyshev.evolve(h, ab, c, psi, 3)
        assert _kernels.LAUNCHES["cheb_evolve"] == before + 3 * (M - 1)
        assert _max_diff(got, chebyshev._evolve_plain(h, ab, c, psi, 3)) < TOL, name
        # the seeded branch: one step of its own order first
        cs = coef(-0.35, 40)
        got = dynamics._cheb_evolve(h, ab, c, psi, 2, cs)
        want = chebyshev._evolve_plain(h, ab, c, chebyshev._evolve_plain(h, ab, cs, psi, 1)[0], 2)
        assert _max_diff(got, want) < TOL, name


def test_matrix_free_stack_goes_through_kernels(dev):
    """kpm_dos, evolve (both branches), kpm_ldos and kpm_conductivity on
    the card launch kernels 8-10 and agree with the CPU run of the same
    calls and seeds."""
    import pythtb_tpu_torch as pt

    flake = pt.magnetic.peierls_model(pt.models.square().cut_piece(12, 0), 1.0 / 9.0).cut_piece(12, 1)
    p0 = np.zeros(flake._nsta, complex)
    p0[flake._nsta // 2] = 1.0

    def run():
        e, dos = pt.flows.kpm_dos(flake, num_moments=128, num_vectors=4)
        psi = pt.dynamics.evolve(flake, p0, np.linspace(0.5, 5.0, 10))
        psi_s = pt.dynamics.evolve(flake, p0, np.linspace(0.3, 3.0, 10))
        el, ld = pt.realspace.kpm_ldos(flake, [0, 50, 77], num_moments=128)
        torus = pt.realspace.torus_sample(pt.models.haldane(), (6, 6), onsite_disorder=1.0, seed=2)
        ef, sxy = pt.realspace.kpm_conductivity(torus, num_moments=96, num_vectors=3)
        return dos, psi, psi_s, ld, sxy

    prev = config.device()
    config.set_device(dev)
    try:
        _kernels.reset_launches()
        card = run()
        for name in ("ell_matvec", "cheb_moments", "cheb_evolve"):
            assert _kernels.LAUNCHES[name] > 0, name
        config.set_device("cpu")
        cpu = run()
    finally:
        config.set_device(prev)
    for got, want in zip(card, cpu):
        assert np.abs(got - want).max() < 1e-10 * max(1.0, np.abs(want).max())


# -- kernel 11, kernel 12 and kernel 1's one-sided mode ---------------------


@pytest.mark.parametrize("B,M", [(1, 2), (1, 3), (3, 3), (12, 70), (64, 6)])
def test_cheb_filter_kernel(dev, B, M):
    """One launch a filter call, the same bits from two calls."""
    from pythtb_tpu_torch.ops import chebyshev

    for name, h in _ell_cases(dev).items():
        ab = _ab(h, dev)
        X = _block(B + M, h.nsta, B, dev)
        coef = torch.as_tensor(np.random.default_rng(M).normal(size=M)).to(dev)
        before = _kernels.LAUNCHES["cheb_filter"]
        got = chebyshev.filter(h, ab, coef, X)
        assert _kernels.LAUNCHES["cheb_filter"] == before + 1
        want = chebyshev._filter_plain(h, ab, coef, X)
        assert _max_diff(got, want) < TOL * max(1.0, float(want.abs().max())), name
        assert torch.equal(got, chebyshev.filter(h, ab, coef, X)), name


@pytest.mark.parametrize("B,M", [(1, 40), (12, 40), (13, 40), (64, 40), (12, 6144)])
def test_cheb_filter_grid(dev, B, M):
    """Many blocks (ragged rows, nspin 2) up to the 6,144 cap; the tables
    and the on-chip state moved to device memory by the plan's
    shared-memory argument give the same bits."""
    from pythtb_tpu_torch.ops import chebyshev

    rng = np.random.default_rng(B + M)
    for name, h in _grid_cases(dev).items():
        ab = _ab(h, dev)
        X = _block(B, h.nsta, B, dev)
        coef = torch.as_tensor(rng.normal(size=M) / np.arange(1, M + 1)).to(dev)
        sms, smem = _kernels.card(dev)
        D = h.cols.shape[1]
        plan = chebyshev._grid_plan(h.norb, h.nspin, B, D, sms, smem, "filter")
        assert plan.blocks > 1 and (plan.tables, plan.state) == ("shared", "shared"), (name, plan)
        got = chebyshev.filter(h, ab, coef, X)
        want = chebyshev._filter_plain(h, ab, coef, X)
        assert _max_diff(got, want) < 1e-10 * max(1.0, float(want.abs().max())), name
        if M > 40:
            continue
        st = 2 * -(-h.norb // plan.blocks) * h.nspin * B * 16
        for room, where in ((st, ("device", "shared")), (0, ("device", "device"))):
            p = chebyshev._grid_plan(h.norb, h.nspin, B, D, sms, room, "filter")
            assert (p.tables, p.state) == where, (name, p)
            assert torch.equal(chebyshev._filter(h, ab, coef, X, room), got), (name, where)


@pytest.mark.parametrize("dim_k,nspin", [(0, 1), (1, 1), (2, 1), (1, 2), (2, 2)])
def test_assemble_one_sided_kernel(dev, dim_k, nspin):
    data, k = _random_data(30 + dim_k + 5 * nspin, dim_k, nspin, dev)
    before = (_kernels.LAUNCHES["assemble_one_sided"], _kernels.LAUNCHES["assemble"])
    H = hamiltonian.assemble_one_sided(data, k)
    assert (_kernels.LAUNCHES["assemble_one_sided"], _kernels.LAUNCHES["assemble"]) == (before[0] + 1, before[1])
    assert _max_diff(H, hamiltonian._one_sided_plain(data, k)) < TOL


@pytest.mark.parametrize("S", [1, 2, 3, 4, 8, 16, 17, 33, 40])
def test_decimation_kernel(dev, S):
    """Random layer blocks (|H01| < |H00| spread, so the decimation
    converges) at every kernel path: one thread a pixel at S <= 2, one
    block a pixel above, up to the shared-memory limit S 40."""
    from pythtb_tpu_torch import surface

    rng = np.random.default_rng(60 + S)
    K, nE = 23, 3
    a = rng.normal(size=(K, S, S)) + 1j * rng.normal(size=(K, S, S))
    H00 = torch.as_tensor(np.ascontiguousarray(a + np.conj(np.swapaxes(a, -1, -2)))).to(dev)
    H01 = torch.as_tensor(0.3 * (rng.normal(size=(K, S, S)) + 1j * rng.normal(size=(K, S, S)))).to(dev)
    w = torch.as_tensor(rng.uniform(-2, 2, nE) + 0.05j).to(dev)
    before = _kernels.LAUNCHES["decimation"]
    got = surface.decimate(H00, H01, w, 12)
    assert _kernels.LAUNCHES["decimation"] == before + 1
    want = surface._decimate_plain(H00, H01, w, 12)
    for g, p in zip(got, want):
        assert g.shape == p.shape
        assert _max_diff(g, p) < TOL * max(1.0, float(p.abs().max()))


def test_decimation_kernel_refuses_above_its_limit(dev):
    """A CUDA tensor never reaches the plain version: above S 40 the
    wrapper raises, naming the limit, and launches nothing."""
    from pythtb_tpu_torch import surface

    S = surface.DECIMATION_MAX_S + 1
    H = torch.zeros((2, S, S), dtype=torch.complex128, device=dev)
    w = torch.tensor([0.1 + 0.05j], device=dev)
    before = _kernels.LAUNCHES["decimation"]
    with pytest.raises(ValueError, match="at most %d states" % surface.DECIMATION_MAX_S):
        surface.decimate(H, H, w, 5)
    assert _kernels.LAUNCHES["decimation"] == before


def test_slice_four_goes_through_kernels(dev):
    """solve_window, solve_lowest, the markers and spectral_function on
    the card launch kernels 1 (both modes), 6, 8, 11 and 12 and agree with
    the CPU run of the same calls and seeds."""
    import pythtb_tpu_torch as pt

    def run():
        e_dirac = float(pt.models.sk_graphene().solve_all(np.array([[2 / 3, 1 / 3]])).mean())
        win = pt.flows.solve_window(pt.models.tbg(2), 4, e_dirac, k_point=np.array([1 / 3, 2 / 3]), block=12,
                                    seed=0)
        low = pt.flows.solve_lowest(pt.models.haldane().cut_piece(8, 0).cut_piece(8, 1), 4, max_iters=600)
        pen = pt.magnetic.peierls_model(pt.models.penrose(4.0), 0.1, dirs=(0, 1))
        cm = pt.realspace.chern_marker(pen, nocc=20)
        sm = pt.realspace.spin_chern_marker(pt.models.kane_mele().cut_piece(3, 0).cut_piece(3, 1), nocc=18)
        bott = pt.realspace.bott_index(pt.realspace.torus_sample(pt.models.haldane(), (5, 5), 2.0, seed=1),
                                       nocc=25)
        kgrid = np.stack([np.linspace(-0.2, 0.2, 9), np.full(9, 0.5)], -1)
        arc = pt.surface.spectral_function(pt.models.weyl(), 0, k_par=kgrid, energies=np.array([0.0]),
                                           eta=0.03)
        edge = pt.surface.spectral_function(pt.models.kane_mele(), 1, k_par=np.linspace(0, 1, 7)[:, None],
                                            energies=np.array([0.1]), eta=0.03, side="top")
        return win, low, cm, sm["c_plus"], sm["c_minus"], np.array([bott]), arc, edge

    prev = config.device()
    config.set_device(dev)
    try:
        _kernels.reset_launches()
        card = run()
        for name in ("assemble", "assemble_one_sided", "position", "ell_matvec", "cheb_filter", "decimation"):
            assert _kernels.LAUNCHES[name] > 0, name
        config.set_device("cpu")
        cpu = run()
    finally:
        config.set_device(prev)
    for got, want in zip(card, cpu):
        assert np.abs(got - want).max() < 1e-10 * max(1.0, np.abs(want).max())


@pytest.mark.parametrize("dim_k,nspin", [(1, 1), (2, 1), (3, 1), (1, 2), (2, 2), (3, 2)])
def test_assemble_deriv_kernel(dev, dim_k, nspin):
    """Kernel 15 in both modes (dH/dk, d2H/dk dk) against the plain
    scatters, at every dim_k it takes and at both spin layouts."""
    data, k = _random_data(70 + dim_k + 5 * nspin, dim_k, nspin, dev)
    for fn, plain in ((hamiltonian.assemble_dk, hamiltonian._assemble_dk_plain),
                      (hamiltonian.assemble_d2k, hamiltonian._assemble_d2k_plain)):
        before = _kernels.LAUNCHES["assemble_dk"]
        got = fn(data, k)
        assert _kernels.LAUNCHES["assemble_dk"] == before + 1
        want = plain(data, k)
        assert _max_diff(got, want) < TOL * max(1.0, float(want.abs().max()))


def test_assemble_deriv_kernel_refuses_dim_k_above_three(dev):
    data, k = _random_data(80, 4, 1, dev)
    before = _kernels.LAUNCHES["assemble_dk"]
    with pytest.raises(ValueError, match="dim_k <= 3"):
        hamiltonian.assemble_dk(data, k)
    assert _kernels.LAUNCHES["assemble_dk"] == before


@pytest.mark.parametrize("mode,P,T,nw", [("lorentz", 4, 1000, 121), ("lorentz", 4, 40001, 121),
                                         ("lorentz", 9, 513, 3), ("gauss", 8, 2001, 121), ("gauss", 27, 700, 130),
                                         ("gauss", 1, 1, 1)])
def test_spectral_sum_kernel(dev, mode, P, T, nw):
    """Kernel 16 in both modes against the plain chunked einsum: column
    groups of 8 (P 9, 27), T off every chunk length (32 and 76 here), nw
    over one tile."""
    from pythtb_tpu_torch import optical

    rng = np.random.default_rng(P * T + nw)
    W = rng.normal(size=(P, T)) + (1j * rng.normal(size=(P, T)) if mode == "lorentz" else 0.0)
    W = torch.as_tensor(W).to(dev)
    de = torch.as_tensor(rng.uniform(0.0, 5.0, T)).to(dev)
    om = torch.as_tensor(np.linspace(0.0, 6.0, nw)).to(dev)
    before = _kernels.LAUNCHES["spectral_sum"]
    got = optical.spectral_sum(W, de, om, 0.07, mode)
    assert _kernels.LAUNCHES["spectral_sum"] == before + 1
    want = optical._spectral_sum_plain(W, de, om, 0.07, mode)
    assert _max_diff(got, want) < 1e-10 * float(want.abs().max())


@pytest.mark.parametrize("kind", ["step", "fermi", "entropy", "c2", "dfde", "dfde_cosh", "gauss"])
@pytest.mark.parametrize("M,P,T", [(1, 1, 1000), (7, 16, 3001), (3, 11, 1)])
def test_fermi_sweep_kernel(dev, kind, M, P, T):
    """Kernel 17 at every weight kind (both -df/de forms), powers 0-2,
    column groups of 8, T off the block size, M 1."""
    from pythtb_tpu_torch.ops import fermi_sweep

    rng = np.random.default_rng(M * 1000 + P + T)
    E = torch.as_tensor(rng.uniform(-4.0, 4.0, T)).to(dev)
    E[: T // 3] = torch.round(E[: T // 3])  # energies equal to some mu
    G = torch.as_tensor(rng.normal(size=(P, T))).to(dev)
    mus = torch.as_tensor(np.round(np.linspace(-3.0, 3.0, M))).to(dev)
    jpow = [p % 3 for p in range(P)]
    before = _kernels.LAUNCHES["fermi_sweep"]
    got = fermi_sweep.fermi_sweep(E, G, mus, 0.3, kind, jpow)
    assert _kernels.LAUNCHES["fermi_sweep"] == before + 2  # the chunks' sums, then their reduction
    want = fermi_sweep._fermi_sweep_plain(E, G, mus, 0.3, kind, jpow)
    assert _max_diff(got, want) < 1e-10 * max(1.0, float(want.abs().max()))


def test_fermi_sweep_kernel_two_calls_give_the_same_bits(dev):
    """Kernel 17 at the Boltzmann row's M 201 and P 16 (powers 0, 1, 2 and
    the Hall columns' 0): within 1e-10 relative of the plain version, and
    two calls bit for bit (the chunks' sums are added in a fixed order)."""
    from pythtb_tpu_torch.ops import fermi_sweep

    rng = np.random.default_rng(201)
    T = 70001
    E = torch.as_tensor(rng.uniform(-4.0, 4.0, T)).to(dev)
    G = torch.as_tensor(rng.normal(size=(16, T))).to(dev)
    mus = torch.as_tensor(np.linspace(-4.0, 4.0, 201)).to(dev)
    jpow = [0] * 4 + [1] * 4 + [2] * 4 + [0] * 4
    got = fermi_sweep.fermi_sweep(E, G, mus, 0.05, "dfde", jpow)
    again = fermi_sweep.fermi_sweep(E, G, mus, 0.05, "dfde", jpow)
    want = fermi_sweep._fermi_sweep_plain(E, G, mus, 0.05, "dfde", jpow)
    assert _max_diff(got, want) < 1e-10 * float(want.abs().max())
    assert torch.equal(got, again)


def test_slice_five_goes_through_kernels(dev):
    """The response calls on the card launch kernels 15, 16 and 17 and
    agree with the CPU run of the same calls to 1e-10 relative."""
    import pythtb_tpu_torch as pt

    def rashba():
        sy = np.array([[0, -1j], [1j, 0]]) / 2
        sx = np.array([[0, 1], [1, 0]], dtype=complex) / 2
        m = pt.tb_model(2, 2, np.eye(2), [[0.0, 0.0]], nspin=2)
        m.set_hop(-1.0 * np.eye(2) - 1j * 0.6 * sy, 0, 0, [1, 0])
        m.set_hop(-1.0 * np.eye(2) + 1j * 0.6 * sx, 0, 0, [0, 1])
        return m

    def run():
        hal = pt.models.haldane()
        mus = np.linspace(-3.0, 3.0, 5)
        bt = pt.boltzmann.transport_coefficients(hal, [-2.0, 1.0], 0.1, 12)
        return [
            pt.flows.anomalous_hall(hal, mus, nk=(13, 13)),
            pt.flows.thermal_hall(hal, mus, 0.15, nk=(13, 13)),
            np.array([pt.flows.orbital_magnetization(pt.models.haldane(t2=0.15 * np.exp(0.7j)), [0], nk=(11, 11))]),
            pt.optical.optical_conductivity(hal, np.linspace(0.0, 5.0, 7), occ=[0], nk=(11, 11), eta=0.1),
            pt.optical.shift_current(pt.models.bn(), np.linspace(0.5, 4.0, 7), [0], nk=(11, 11), sigma=0.1),
            pt.geometry.integrated_metric(hal, [0], nk=(10, 10))["metric"],
            bt["sigma"], bt["seebeck"], bt["sigma_hall"],
            pt.boltzmann.edelstein(rashba(), [-2.2, 2.0], 0.05, 12),
        ]

    prev = config.device()
    config.set_device(dev)
    try:
        _kernels.reset_launches()
        card = run()
        for name in ("assemble", "eig2", "link_dets", "plaquette_flux", "assemble_dk", "spectral_sum",
                     "fermi_sweep"):
            assert _kernels.LAUNCHES[name] > 0, name
        config.set_device("cpu")
        cpu = run()
    finally:
        config.set_device(prev)
    for got, want in zip(card, cpu):
        assert np.abs(got - want).max() <= 1e-10 * np.abs(want).max()


@pytest.mark.parametrize("S", [1, 2, 3, 8, 16, 40])
def test_decimation_green_kernel(dev, S):
    """Kernel 12's Green's-function mode: the whole surface G at every
    path (one thread a pixel at S <= 2, one block above, up to S 40)."""
    from pythtb_tpu_torch import surface

    rng = np.random.default_rng(160 + S)
    K, nE = 5, 4
    a = rng.normal(size=(K, S, S)) + 1j * rng.normal(size=(K, S, S))
    H00 = torch.as_tensor(np.ascontiguousarray(a + np.conj(np.swapaxes(a, -1, -2)))).to(dev)
    H01 = torch.as_tensor(0.3 * (rng.normal(size=(K, S, S)) + 1j * rng.normal(size=(K, S, S)))).to(dev)
    w = torch.as_tensor(rng.uniform(-2, 2, nE) + 0.05j).to(dev)
    before = (_kernels.LAUNCHES["decimation_green"], _kernels.LAUNCHES["decimation"])
    got = surface.decimate(H00, H01, w, 12, green=True)
    assert (_kernels.LAUNCHES["decimation_green"], _kernels.LAUNCHES["decimation"]) == (before[0] + 1, before[1])
    want = surface._decimate_plain(H00, H01, w, 12, green=True)
    assert got[0].shape == (nE, K, S, S)
    for g, p in zip(got, want):
        assert _max_diff(g, p) < TOL * max(1.0, float(p.abs().max()))
    with pytest.raises(ValueError, match="at most"):
        surface.decimate(torch.zeros((1, 41, 41), dtype=torch.complex128, device=dev),
                         torch.zeros((1, 41, 41), dtype=torch.complex128, device=dev), w, 3, green=True)


@pytest.mark.parametrize("S", [1, 2, 3, 4, 5, 12, 40])
def test_cpa_kernel(dev, S):
    """Kernel 13 at the register path (S <= 4) and the warp path (5-40),
    on random Hermitian H(k) and causal self-energies."""
    from pythtb_tpu_torch import disorder

    rng = np.random.default_rng(170 + S)
    B, W = 37, 6
    a = rng.normal(size=(B, S, S)) + 1j * rng.normal(size=(B, S, S))
    H = torch.as_tensor(np.ascontiguousarray(a + np.conj(np.swapaxes(a, -1, -2)))).to(dev)
    z = torch.as_tensor(rng.uniform(-3, 3, W) + 0.05j).to(dev)
    sigma = torch.as_tensor(rng.normal(size=(W, S)) - 1j * rng.uniform(0.0, 0.5, (W, S))).to(dev)
    before = _kernels.LAUNCHES["cpa"]
    got = disorder.local_green(H, z, sigma)
    assert _kernels.LAUNCHES["cpa"] == before + 1
    want = disorder._local_green_plain(H, z, sigma)
    assert _max_diff(got, want) < TOL * max(1.0, float(want.abs().max()))
    with pytest.raises(ValueError, match="at most"):
        disorder.local_green(torch.zeros((2, 41, 41), dtype=torch.complex128, device=dev), z,
                             torch.zeros((W, 41), dtype=torch.complex128, device=dev))


@pytest.mark.parametrize("S,ndis", [(1, 1), (3, 2), (8, 1), (40, 1)])
def test_lyapunov_kernel(dev, S, ndis):
    """Kernel 18 against its plain version on a disordered square strip of
    width S over 64 steps, QR every step (the whole spectrum at 1e-10
    relative) and every 8 steps (the largest exponent at 1e-10 relative,
    all finite: at S 40 a stride's product has a condition number far
    beyond 1 / eps, where the smaller exponents of any two QRs part)."""
    from pythtb_tpu_torch import localization

    rng = np.random.default_rng(180 + S)
    h00 = -(np.eye(S, k=1) + np.eye(S, k=-1)).astype(complex)
    h01 = -np.eye(S, dtype=complex) + 0.1 * (rng.normal(size=(S, S)) + 1j * rng.normal(size=(S, S)))
    hinv = np.linalg.inv(h01)
    E = np.linspace(-3.0, 3.0, 5)
    A = torch.as_tensor(np.ascontiguousarray(E[:, None, None] * hinv - hinv @ h00)).to(dev)
    hinv_t = torch.as_tensor(hinv).to(dev)
    Bm = torch.as_tensor(np.ascontiguousarray(-hinv @ h01.conj().T)).to(dev)
    for stride in (8, 1):
        w = torch.as_tensor(rng.uniform(-1.0, 1.0, (64, ndis, S))).to(dev)
        Q0 = torch.eye(2 * S, dtype=torch.complex128, device=dev).expand(ndis, 5, 2 * S, 2 * S).contiguous()
        l0 = torch.zeros((ndis, 5, 2 * S), dtype=torch.float64, device=dev)
        before = _kernels.LAUNCHES["lyapunov"]
        _, got = localization.lyapunov_chunk(A, hinv_t, Bm, w, Q0.clone(), l0.clone(), stride)
        assert _kernels.LAUNCHES["lyapunov"] == before + 1
        _, want = localization._lyapunov_plain(A, hinv_t, Bm, w, Q0, l0, stride)
        assert bool(torch.isfinite(got).all())
        got, want = torch.sort(got, -1, descending=True)[0], torch.sort(want, -1, descending=True)[0]
        held = slice(None) if stride == 1 else slice(0, 1)
        assert _max_diff(got[..., held], want[..., held]) < 1e-10 * float(want.abs().max())


def _lyapunov_case(S, ndis, dev, seed, emax=3.0, wmax=1.0):
    """A disordered strip of width S with a random inter-layer block, 5
    energies in [-emax, emax] x 64 steps of onsite values in [-wmax, wmax]:
    (A, Hinv, Bm, w, Q0, lyap0)."""
    rng = np.random.default_rng(seed)
    h00 = -(np.eye(S, k=1) + np.eye(S, k=-1)).astype(complex)
    h01 = -np.eye(S, dtype=complex) + 0.1 * (rng.normal(size=(S, S)) + 1j * rng.normal(size=(S, S)))
    hinv = np.linalg.inv(h01)
    E = np.linspace(-emax, emax, 5)
    A = torch.as_tensor(np.ascontiguousarray(E[:, None, None] * hinv - hinv @ h00)).to(dev)
    Bm = torch.as_tensor(np.ascontiguousarray(-hinv @ h01.conj().T)).to(dev)
    w = torch.as_tensor(rng.uniform(-wmax, wmax, (64, ndis, S))).to(dev)
    Q0 = torch.eye(2 * S, dtype=torch.complex128, device=dev).expand(ndis, 5, 2 * S, 2 * S).contiguous()
    return A, torch.as_tensor(hinv).to(dev), Bm, w, Q0, torch.zeros((ndis, 5, 2 * S), dtype=torch.float64, device=dev)


def _lyapunov_held(design, stride, case, whole_tol=None):
    """Kernel 18 on ``design`` against the plain version: the largest
    exponent at 1e-10 relative, every exponent at ``whole_tol`` where
    given; the frames stay unitary."""
    from pythtb_tpu_torch import localization

    A, hinv, Bm, w, Q0, l0 = case
    S = A.shape[-1]
    Qk, got = localization.lyapunov_chunk(A, hinv, Bm, w, Q0.clone(), l0.clone(), stride, design)
    _, want = localization._lyapunov_plain(A, hinv, Bm, w, Q0, l0, stride)
    got, want = torch.sort(got, -1, descending=True)[0], torch.sort(want, -1, descending=True)[0]
    scale = float(want.abs().max())
    assert _max_diff(got[..., 0], want[..., 0]) < 1e-10 * scale
    if whole_tol is not None:
        assert _max_diff(got, want) < whole_tol * scale
    eye = torch.eye(2 * S, dtype=torch.complex128, device=Qk.device)
    assert _max_diff(Qk.conj().transpose(-1, -2) @ Qk, eye.expand_as(Qk)) < 1e-13


@pytest.mark.parametrize("S,design", [(1, "warp"), (3, "warp"), (8, "warp"), (1, "block"), (8, "block"),
                                      (9, "block"), (16, "block")])
def test_lyapunov_designs(dev, S, design):
    """Kernel 18 on each design at both sides of the design line (the warp
    to 8 states, the block above), ndis 2.  Energies in [-3, 3] close
    channels (a stride's product reaches a condition number of 1e11, where
    any two correct QRs part at ~1e-7 on the smallest exponents): every
    exponent at 1e-10 relative at stride 1, the largest at stride 8.  In
    the band (energies in [-0.5, 0.5], onsite values in [-0.2, 0.2], a
    condition number to 1e5) every exponent at 1e-8 at stride 8 too."""
    _lyapunov_held(design, 1, _lyapunov_case(S, 2, dev, 190 + S), 1e-10)
    _lyapunov_held(design, 8, _lyapunov_case(S, 2, dev, 190 + S))
    _lyapunov_held(design, 8, _lyapunov_case(S, 2, dev, 190 + S, 0.5, 0.2), 1e-8 if S <= 8 else None)


def test_lyapunov_design_line_on_the_card(dev):
    """The wrapper takes the warp design to 8 states and the block above,
    and the warp design refuses 9 states."""
    from pythtb_tpu_torch import localization

    sms = _kernels.card(dev)[0]
    assert [localization._lyapunov_design(S, 512, 1, sms) for S in (8, 9)] == ["warp", "block"]
    A, hinv, Bm, w, Q0, l0 = _lyapunov_case(9, 1, dev, 199)
    with pytest.raises(ValueError, match="at most 8 states"):
        localization.lyapunov_chunk(A, hinv, Bm, w, Q0, l0, 8, "warp")


def test_lyapunov_chunks_match_one_launch(dev):
    """The warp design carries its frames across launches: 64 steps in two
    chunks of 32 give one launch's bits."""
    from pythtb_tpu_torch import localization

    A, hinv, Bm, w, Q0, l0 = _lyapunov_case(8, 2, dev, 198)
    _, one = localization.lyapunov_chunk(A, hinv, Bm, w, Q0.clone(), l0.clone(), 8)
    Q1, l1 = localization.lyapunov_chunk(A, hinv, Bm, w[:32].contiguous(), Q0.clone(), l0.clone(), 8)
    _, two = localization.lyapunov_chunk(A, hinv, Bm, w[32:].contiguous(), Q1, l1, 8)
    assert torch.equal(one, two)


def test_green_function_slice_goes_through_kernels(dev):
    """landauer_transmission, multi_terminal, lyapunov_spectrum, t_matrix
    and cpa on the card launch kernels 12G, 18, 16 and 13 and agree with
    the CPU run of the same calls (Lyapunov: its non-negative half)."""
    import pythtb_tpu_torch as pt

    def run():
        rib = pt.models.graphene(t=-1.0).cut_piece(4, 1, glue_edgs=False)
        Hd, leads, _ = pt.negf.hall_bar(pt.models.qwz(), (3, 3), disorder=0.3, seed=1)
        sq = pt.tb_model(2, 2, np.eye(2), [[0.0, 0.0]])
        sq.set_hop(-1.0, 0, 0, [1, 0])
        sq.set_hop(-1.0, 0, 0, [0, 1])
        ly = pt.localization.lyapunov_spectrum(sq.cut_piece(3, 1), [-2.0, 0.5], 96, disorder=1.0, seed=2)
        G, T = pt.impurity.t_matrix(pt.models.bn(delta=1.0), np.array([[2.0]]), np.linspace(-3, 3, 9), [0],
                                    nk=(12, 12), eta=0.05)
        c = pt.disorder.cpa(pt.models.kagome(t=-1.0), np.linspace(-4, 4, 9), 6, ("binary", [0.3, 0.7], [1.2, -0.3]),
                            eta=0.05)
        return [pt.negf.landauer_transmission(rib, np.linspace(-2, 2, 7)),
                pt.negf.multi_terminal(Hd, leads, np.linspace(-0.5, 0.5, 3)), ly[..., :3], G, T, c["sigma"]]

    prev = config.device()
    config.set_device(dev)
    try:
        _kernels.reset_launches()
        card = run()
        for name in ("assemble", "assemble_one_sided", "decimation_green", "lyapunov", "spectral_sum", "cpa"):
            assert _kernels.LAUNCHES[name] > 0, name
        config.set_device("cpu")
        cpu = run()
    finally:
        config.set_device(prev)
    for got, want in zip(card, cpu):
        assert np.abs(got - want).max() <= 1e-10 * np.abs(want).max()


def _hermitian_batch(seed, B, m, dev, degenerate=False):
    rng = np.random.default_rng(seed)
    if degenerate:  # exact multiplicities: unitary conjugates of repeated levels
        out = []
        for _ in range(B):
            Q, _r = np.linalg.qr(rng.normal(size=(m, m)) + 1j * rng.normal(size=(m, m)))
            d = np.sort(np.repeat(rng.normal(size=m), 4)[:m])
            out.append((Q * d) @ Q.conj().T)
        H = np.array(out)
    else:
        X = rng.normal(size=(B, m, m)) + 1j * rng.normal(size=(B, m, m))
        H = 0.5 * (X + np.conj(np.swapaxes(X, -1, -2)))
    return torch.as_tensor(np.ascontiguousarray(H)).to(dev)


def _projector_diff(w, v, v_ref, gap=1e-8):
    """Largest difference of the projectors onto groups of eigenvalues
    split by more than ``gap`` (v, v_ref row eigenvectors)."""
    worst = 0.0
    for b in range(w.shape[0]):
        wb = w[b].cpu().numpy()
        cuts = np.nonzero(np.diff(wb) > gap)[0] + 1
        for g in np.split(np.arange(len(wb)), cuts):
            g = torch.as_tensor(g, device=v.device)
            P = v[b, g].T @ v[b, g].conj()
            Q = v_ref[b, g].T @ v_ref[b, g].conj()
            worst = max(worst, float((P - Q).abs().max()))
    return worst


@pytest.mark.parametrize("m,degenerate", [(1, False), (3, False), (17, False), (33, False), (39, False),
                                          (40, False), (48, False), (63, False), (64, False), (40, True)])
def test_eigh_jacobi_kernel(dev, m, degenerate):
    """Kernel 7 against its plain version and torch.linalg.eigh: scaled
    eigenvalues within 1e-12, projectors of split groups within 1e-10, the
    residual and orthonormality within 1e-12; eigenvalues-only mode gives
    the same eigenvalues."""
    H = _hermitian_batch(190 + m, 9, m, dev, degenerate)
    scale = max(1.0, float(torch.linalg.matrix_norm(H).max()))
    before = _kernels.LAUNCHES["eigh_jacobi"]
    w, v = eigh.eigh_jacobi(H)
    assert _kernels.LAUNCHES["eigh_jacobi"] == before + 1
    wp, vp = eigh._eigh_jacobi_plain(H)
    wl, vl = torch.linalg.eigh(H)
    assert _max_diff(w, wp) < 1e-12 * scale and _max_diff(w, wl) < 1e-12 * scale
    assert _projector_diff(wp, v, vp) < 1e-10
    assert _projector_diff(wl, v, vl.transpose(-1, -2)) < 1e-10
    resid = H @ v.transpose(-1, -2) - v.transpose(-1, -2) * w[:, None, :]
    assert float(resid.abs().max()) < 1e-12 * scale
    eye = torch.eye(m, dtype=torch.complex128, device=dev)
    assert float((v @ v.conj().transpose(-1, -2) - eye).abs().max()) < 1e-12
    assert _max_diff(eigh.eigh_jacobi(H, vectors=False), w) < 1e-12 * scale


@pytest.mark.parametrize("m,degenerate", [(3, False), (4, False), (5, False), (7, False), (8, False), (16, False),
                                          (22, False), (31, False), (32, False), (4, True), (8, True), (16, True),
                                          (32, True), (39, False), (64, False), (40, True)])
def test_eigh_jacobi_designs(dev, m, degenerate):
    """Every design of kernel 7 that takes m (a block a matrix to 64, a
    team of lanes a matrix to 16) against the plain Jacobi at m 3-64, odd m
    and exact degeneracies: scaled eigenvalues within 1e-12, projectors of
    split groups within 1e-10, the residual and orthonormality within
    1e-12, one launch a call; the eigenvalues-only mode gives the same
    eigenvalues.  A batch that does not fill the last block's teams (B
    37); the team design refuses m above 16."""
    H = _hermitian_batch(170 + m, 37, m, dev, degenerate)
    scale = max(1.0, float(torch.linalg.matrix_norm(H).max()))
    wp, vp = eigh._eigh_jacobi_plain(H)
    eye = torch.eye(m, dtype=torch.complex128, device=dev)
    for design, (_, most) in eigh._JACOBI_DESIGNS.items():
        if m > most:
            with pytest.raises(ValueError, match="'team' design takes matrices up to 16"):
                eigh._eigh_jacobi(H, True, design)
            continue
        before = _kernels.LAUNCHES["eigh_jacobi"]
        w, v = eigh._eigh_jacobi(H, True, design)
        assert _kernels.LAUNCHES["eigh_jacobi"] == before + 1
        assert _max_diff(w, wp) < 1e-12 * scale, design
        assert _projector_diff(wp, v, vp) < 1e-10, design
        resid = H @ v.transpose(-1, -2) - v.transpose(-1, -2) * w[:, None, :]
        assert float(resid.abs().max()) < 1e-12 * scale, design
        assert float((v @ v.conj().transpose(-1, -2) - eye).abs().max()) < 1e-12, design
        assert _max_diff(eigh._eigh_jacobi(H, False, design), w) < 1e-12 * scale, design


def test_eigh_batched_routes_33_to_64_through_kernel_7(dev):
    """Every shape that eigh._route sends to kernel 7 on the card (3-8 at
    every batch, 9-26 from 1,024 matrices, 33-64) never reaches
    torch.linalg.eigh: both entry points launch kernel 7 once; m 2, 16 and
    22 at 4 matrices, 27-32 and 65 do not."""
    for m, B in ((2, 4), (3, 4), (4, 4), (6, 4), (8, 4), (16, 4), (16, 1024), (22, 4), (22, 1024), (27, 1024),
                 (32, 4), (33, 4), (64, 4), (65, 4)):
        launched = int(eigh._route(m, B, "cuda") == "jacobi")
        assert launched == int(3 <= m <= 8 or (m in (16, 22) and B == 1024) or 33 <= m <= 64), (m, B)
        H = _hermitian_batch(200 + m, B, m, dev)
        before = _kernels.LAUNCHES["eigh_jacobi"]
        w, v = eigh.eigh_batched(H)
        w2 = eigh.eigvalsh_batched(H)
        assert _kernels.LAUNCHES["eigh_jacobi"] == before + 2 * launched
        assert _max_diff(w, w2) < 1e-12 * max(1.0, float(w.abs().max()))
        assert w.shape == (B, m) and v.shape == (B, m, m)


def test_eigh_jacobi_kernel_raises_unconverged_and_refuses_m_above_64(dev, monkeypatch):
    for m, designs in ((40, ("block",)), (8, ("block", "team"))):
        H = _hermitian_batch(210, 3, m, dev)
        monkeypatch.setattr(eigh, "JACOBI_SWEEPS", 1)
        for design in designs:
            with pytest.raises(RuntimeError, match="not converged in 1 sweeps"):
                eigh._eigh_jacobi(H, True, design)
        monkeypatch.undo()
    with pytest.raises(ValueError, match="up to 64"):
        eigh.eigh_jacobi(_hermitian_batch(211, 2, 65, dev))
    with pytest.raises(ValueError, match="no 'warp' design"):
        eigh._eigh_jacobi(_hermitian_batch(212, 2, 8, dev), True, "warp")


@pytest.mark.parametrize("dim_k,nspin", [(1, 1), (2, 1), (3, 1), (2, 2)])
def test_assemble_members_kernel(dev, dim_k, nspin):
    """Kernel 1's flux-batch mode against its plain version (1e-14)."""
    data, k = _random_data(220 + dim_k + nspin, dim_k, nspin, dev)
    rng = np.random.default_rng(230 + dim_k + nspin)
    P = 5
    shape = (P,) + tuple(data.amps.shape)
    amps = torch.as_tensor(rng.normal(size=shape) + 1j * rng.normal(size=shape)).to(dev)
    diag = torch.as_tensor(rng.normal(size=(P, data.nsta, data.nsta)) + 0j).to(dev)
    before = _kernels.LAUNCHES["assemble_members"]
    got = hamiltonian.assemble_members(data, amps, diag, k)
    assert _kernels.LAUNCHES["assemble_members"] == before + 1
    want = hamiltonian._assemble_members_plain(data, amps, diag, k)
    assert got.shape == (P * k.shape[0], data.nsta, data.nsta)
    assert _max_diff(got, want) < 1e-14 * max(1.0, float(want.abs().max()))


def test_slice_seven_goes_through_kernels(dev):
    """The Hofstadter butterfly (flux batch + kernel 7), Streda labels,
    the slab solve (kernel 7), the quadrupole, sector Chern, nodes, DOS
    and a family on the card launch their kernels and agree with the CPU
    run of the same calls."""
    import pythtb_tpu_torch as pt

    def run():
        sq = pt.tb_model(2, 2, np.eye(2), [[0.0, 0.0]])
        sq.set_hop(-1.0, 0, 0, [1, 0])
        sq.set_hop(-1.0, 0, 0, [0, 1])
        _, ev = pt.magnetic.hofstadter_butterfly(sq, 40, nk=2, p_values=[0, 1, 7])
        lab = pt.magnetic.streda_labels(sq, 1, 5, nk=11)["labels"]
        q = pt.flows.quadrupole(pt.models.bbh(0.5, 1.0), nk=(9, 9))
        s = pt.flows.spin_chern(pt.models.kane_mele(), nk=(9, 9))
        k, _ = pt.flows.find_nodes(pt.models.weyl(), band=0, nk=8, gap_tol=1e-4)
        _, dos = pt.flows.density_of_states(pt.models.haldane(), (8, 8), n_energies=31)
        fam = pt.family([pt.models.haldane(), pt.models.haldane().make_supercell([[2, 0], [0, 1]])])
        return [ev, np.array(lab, float), np.array([q["qxy"], s["spin_chern"]]), dos, fam.chern(nocc=[1, 2], nk=(9, 9)),
                k[np.argsort(k[:, 2])]]

    prev = config.device()
    config.set_device(dev)
    try:
        _kernels.reset_launches()
        card = run()
        for name in ("assemble", "assemble_members", "eigh_jacobi", "eig2", "link_dets", "plaquette_flux",
                     "wilson_loop", "assemble_dk", "spectral_sum"):
            assert _kernels.LAUNCHES[name] > 0, name
        config.set_device("cpu")
        cpu = run()
    finally:
        config.set_device(prev)
    for got, want in zip(card[:-1], cpu[:-1]):
        assert np.abs(got - want).max() <= 1e-10 * max(1.0, np.abs(want).max())
    # the refined nodes agree to the descent's resolution (tests/test_torch_nodes.py),
    # as points of the torus (a node at k_x = 0 may come back as 1 - 1e-9)
    assert card[-1].shape == cpu[-1].shape
    d = card[-1] - cpu[-1]
    assert np.abs(d - np.round(d)).max() <= 5e-6


def _random_frames(seed, grid, NS, F, dev):
    """Orthonormal rows at every grid point (random complex QR)."""
    rng = np.random.default_rng(seed)
    z = rng.normal(size=tuple(grid) + (F, NS)) + 1j * rng.normal(size=tuple(grid) + (F, NS))
    q = np.linalg.qr(z)[0]  # (..., F, NS) orthonormal columns
    return torch.as_tensor(np.ascontiguousarray(np.swapaxes(q, -1, -2))).to(dev)


@pytest.mark.parametrize("grid,axis,occ,F", [((41, 31), 1, [0], 3), ((41, 31), 0, [0], 3),
                                             ((41, 41), 0, [0, 1], 4), ((9, 7), 1, [1, 2, 3], 6),
                                             ((6, 5, 4), 1, list(range(8)), 10),
                                             ((7, 5), 1, list(range(9)), 11), ((6, 4), 0, list(range(1, 13)), 15),
                                             ((5, 4), 1, list(range(16)), 18), ((4, 3), 0, list(range(32)), 34),
                                             ((3, 4), 1, list(range(64)), 66)])
def test_transport_chain_and_rotate_kernels(dev, grid, axis, occ, F):
    """Kernel 14's chain and rotate modes against their plain versions
    (1e-12), closed and open."""
    from pythtb_tpu_torch.ops import transport

    w = _random_frames(240 + len(grid) + len(occ), grid, max(occ) + 2 if max(occ) + 2 <= F else F, F, dev)
    w5, _ = transport._strings(w, 1, len(grid), axis)
    w5 = w5.contiguous()
    occ_t = torch.as_tensor(occ, dtype=torch.int64, device=dev)
    before = dict(_kernels.LAUNCHES)
    C, smin = transport._chain(w5, occ_t)
    Cp, sp = transport._chain_plain(w5, occ_t)
    assert _max_diff(C, Cp) < TOL and _max_diff(smin, sp) < TOL
    theta, P = (t.contiguous() for t in berry.unitary_eig(Cp[:, -1].contiguous()))
    for closed in (True, False):
        got = transport._rotate(w5, occ_t, Cp, theta, P, closed)
        want = transport._rotate_plain(w5, occ_t, Cp, theta, P, closed)
        assert _max_diff(got, want) < TOL
    path = transport._chain_path(len(occ), w5.shape[0] * w5.shape[2], w5.shape[1],
                                 torch.cuda.get_device_properties(dev).multi_processor_count)
    assert _kernels.LAUNCHES["transport_chain"] == before["transport_chain"] + transport._CHAIN_MODES[path][2]
    assert _kernels.LAUNCHES["transport_rotate"] == before["transport_rotate"] + 2


@pytest.mark.parametrize("grid,axis,S,F", [((301, 5), 1, 2, 4), ((9, 7), 0, 28, 32), ((9, 7), 0, 29, 32),
                                           ((41, 31), 1, 1, 3), ((6, 5), 1, 4, 6), ((5, 6), 0, 8, 10),
                                           ((6, 2), 1, 5, 14)])
def test_transport_chain_paths(dev, grid, axis, S, F):
    """Every design of kernel 14's chain that takes S (the register path at
    S 1, a warp a link to 32, a block a link to 64) against the plain version
    at 1e-12, C and the smallest singular value: 301 strings at S 2, S 28
    and 29 on either side of the warp / block line, the occ rows scattered
    (every other state), a 2-point axis."""
    from pythtb_tpu_torch.ops import transport

    NS = min(2 * S + 1, F)
    w5, _ = transport._strings(_random_frames(260 + S, grid, NS, F, dev), 1, len(grid), axis)
    w5 = w5.contiguous()
    occ = list(range(0, 2 * S, 2)) if 2 * S - 1 < NS else list(range(S))
    occ_t = torch.as_tensor(occ, dtype=torch.int64, device=dev)
    Cp, sp = transport._chain_plain(w5, occ_t)
    for path, (_, most, launches) in transport._CHAIN_MODES.items():
        if S > most:
            continue
        before = _kernels.LAUNCHES["transport_chain"]
        C, smin = transport._chain(w5, occ_t, path)
        assert _kernels.LAUNCHES["transport_chain"] == before + launches
        assert _max_diff(C, Cp) < TOL and _max_diff(smin, sp) < TOL, path


@pytest.mark.parametrize("grid,axis,S,NS,F", [((41, 41), 0, 2, 4, 4), ((7, 5), 1, 9, 19, 21), ((9, 7), 0, 16, 33, 36),
                                            ((5, 4), 1, 20, 41, 41), ((9, 7), 0, 64, 66, 68), ((3, 2), 1, 64, 64, 64),
                                            ((3, 2), 0, 64, 130, 200), ((4, 3), 1, 12, 25, 1000)])
def test_transport_rotate_paths(dev, grid, axis, S, NS, F):
    """Every design of kernel 14's rotate that takes S (the register path
    to S 3, the team path on a warp or a block, the tensor-core tiles a
    block each 16 rows) against the plain version at 1e-12, closed and
    open, the occ rows scattered (every other state, or all of them), the
    rows outside occ bit for bit, one launch a call; at F 200 and 1,000 the
    blocks take the occ rows a chunk of columns at a time."""
    from pythtb_tpu_torch.ops import transport

    w5, _ = transport._strings(_random_frames(270 + S, grid, NS, F, dev), 1, len(grid), axis)
    w5 = w5.contiguous()
    occ = list(range(1, 2 * S, 2)) if 2 * S <= NS else list(range(S))
    occ_t = torch.as_tensor(occ, dtype=torch.int64, device=dev)
    rest = torch.as_tensor([r for r in range(NS) if r not in occ], dtype=torch.int64, device=dev)
    Cp, _ = transport._chain_plain(w5, occ_t)
    theta, P = (t.contiguous() for t in berry.unitary_eig(Cp[:, -1].contiguous()))
    for closed in (True, False):
        want = transport._rotate_plain(w5, occ_t, Cp, theta, P, closed)
        for path, (_, most) in transport._ROTATE_MODES.items():
            if S > most:
                continue
            before = _kernels.LAUNCHES["transport_rotate"]
            got = transport._rotate(w5, occ_t, Cp, theta, P, closed, path)
            assert _kernels.LAUNCHES["transport_rotate"] == before + 1
            assert _max_diff(got, want) < TOL, (path, closed)
            assert torch.equal(got.index_select(3, rest), w5.index_select(3, rest)), (path, closed)


@pytest.mark.parametrize("grid,axis,NS,nocc,F", [((41, 31), 0, 3, 1, 3), ((13, 5), 0, 4, 2, 4),
                                                 ((7, 6), 1, 8, 3, 8), ((9,), 0, 2, 2, 2),
                                                 ((7, 6), 1, 9, 4, 10), ((6, 5), 0, 12, 12, 12),
                                                 ((5, 4), 1, 16, 9, 20), ((4, 3), 0, 32, 20, 40),
                                                 ((3, 3), 1, 64, 64, 64)])
def test_transport_follow_kernel(dev, grid, axis, NS, nocc, F):
    """Kernel 14's follow mode against its plain version: identical
    indices, fidelity and states within 1e-12."""
    from pythtb_tpu_torch.ops import transport

    w5, _ = transport._strings(_random_frames(250 + NS, grid, NS, F, dev), 1, len(grid), axis)
    w5 = w5.contiguous()
    occ_t = torch.arange(nocc, dtype=torch.int64, device=dev)
    idx, fid, st = transport._follow(w5, occ_t)
    idx_p, fid_p, st_p = transport._follow_plain(w5, occ_t)
    assert torch.equal(idx.cpu(), idx_p.cpu())
    assert _max_diff(fid, fid_p) < TOL and _max_diff(st, st_p) < TOL


@pytest.mark.parametrize("grid,L,NS,nocc,F", [((41,), 41, 39, 20, 39), ((6,), 1, 12, 5, 14), ((1,), 41, 20, 10, 22),
                                              ((7,), 9, 16, 16, 16), ((6,), 7, 6, 2, 8), ((5,), 9, 3, 1, 4),
                                              ((2,), 3, 8, 4, 8)])
def test_transport_follow_designs(dev, grid, L, NS, nocc, F):
    """Kernel 14's follow against the plain version -- identical indices,
    fidelity and states within 1e-12 -- with the launches it makes (five,
    three at L 1), at the slab's shape (41 strings of 41 points, 20 of 39),
    a one-point axis, a single string, nocc = NS and a few stored states."""
    from pythtb_tpu_torch.ops import transport

    w = _random_frames(290 + NS + L, (L,) + grid, NS, F, dev)
    w5 = w.reshape((1, L, math.prod(grid), NS, F)).contiguous()
    occ_t = torch.arange(nocc, dtype=torch.int64, device=dev)
    idx_p, fid_p, st_p = transport._follow_plain(w5, occ_t)
    before = _kernels.LAUNCHES["transport_follow"]
    idx, fid, st = transport._follow(w5, occ_t)
    assert _kernels.LAUNCHES["transport_follow"] == before + (5 if L > 1 else 3)
    assert torch.equal(idx.cpu(), idx_p.cpu())
    assert fid.shape == fid_p.shape and (L == 1 or _max_diff(fid, fid_p) < TOL)
    assert _max_diff(st, st_p) < TOL


def test_transport_follow_kernel_breaks_ties_to_the_lower_index(dev):
    """Exactly degenerate weights: kernel and plain version both take the
    lower index (the rule of jax.lax.top_k)."""
    from pythtb_tpu_torch.ops import transport

    e = np.eye(4, dtype=complex)
    w = np.stack([e, e[[0, 1, 2, 3]]])  # step 1 sees the start state ...
    w[1, 0] = (e[0] + e[1]) / np.sqrt(2)  # ... split evenly over rows 0 and 1
    w[1, 1] = (e[0] - e[1]) / np.sqrt(2)
    w5 = torch.as_tensor(w[None, :, None]).to(dev).contiguous()
    occ_t = torch.tensor([0], dtype=torch.int64, device=dev)
    idx, _, _ = transport._follow(w5, occ_t)
    idx_p, _, _ = transport._follow_plain(w5, occ_t)
    assert idx[1, 0, 0].item() == idx_p[1, 0, 0].item() == 0


def test_transport_kernels_on_the_wf_array_path(dev):
    """smooth_gauge and adiabatic_evolve on the card launch kernel 14 and
    agree with the CPU run of the same calls (nspin 1 and 2)."""
    import pythtb_tpu_torch as pt
    from pythtb_tpu_torch import convert

    def run():
        out = []
        for m, occ in ((pt.models.haldane(), [0]), (pt.models.kane_mele(), [0, 1])):
            wf = pt.wf_array(m, [9, 7])
            wf.solve_on_grid([0.0, 0.0])
            wf.impose_pbc(0, 0)
            st = np.array(wf._wfs)
            for closed in (True, False):
                w2 = convert.wf_array_from_numpy(wf._model, st)
                w2.smooth_gauge(occ, dir=0, closed=closed)
                out.append(np.array(w2._wfs))
            w2 = convert.wf_array_from_numpy(wf._model, st)
            idx, fid, fol = w2.adiabatic_evolve(occ, dir=0, return_states=True)
            out += [idx.astype(float), fid, np.array(fol._wfs)]
        return out, st

    prev = config.device()
    config.set_device(dev)
    try:
        _kernels.reset_launches()
        card, _ = run()
        for name in ("transport_chain", "transport_rotate", "transport_follow"):
            assert _kernels.LAUNCHES[name] > 0, name
        config.set_device("cpu")
        cpu, _ = run()
    finally:
        config.set_device(prev)
    # the grid solves differ in gauge between card and CPU: compare what the
    # gauge cannot change (projectors onto the stored states, indices,
    # fidelity)
    for got, want in zip(card, cpu):
        if got.dtype.kind == "c":
            got, want = got.reshape(got.shape[:3] + (-1,)), want.reshape(want.shape[:3] + (-1,))
            pg = np.einsum("...nf,...ng->...fg", got.conj(), got)
            pw = np.einsum("...nf,...ng->...fg", want.conj(), want)
            assert np.abs(pg - pw).max() < 1e-10
        else:
            assert np.abs(got - want).max() < 1e-10


def _mv_inputs(seed, B, nb, n, dev, dc=3):
    """Near-identity overlaps (|M_nn| ~ 1: the MV gradient divides by M_nn
    and takes its phase, so small diagonals amplify rounding)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(B, nb, n, n)) + 1j * rng.normal(size=(B, nb, n, n))
    u, _, vh = np.linalg.svd(np.eye(n) + 0.05 * X)
    M0 = (u @ vh) * 0.98  # a polar factor near the identity
    nbr = rng.integers(0, B, (B, nb))
    w_b = rng.uniform(0.5, 2.0, nb)
    b_cart = rng.normal(size=(nb, dc)) * 0.3
    t = lambda x, dt: torch.as_tensor(np.ascontiguousarray(x), dtype=dt).to(dev)
    return t(M0, torch.complex128), t(nbr, torch.int64), t(w_b, torch.float64), t(b_cart, torch.float64)


def _near_identity(rng, B, n, scale):
    """Unitaries exp(scale * A) with A random anti-Hermitian, and scale * A."""
    from pythtb_tpu_torch import wannier

    H = rng.normal(size=(B, n, n)) + 1j * rng.normal(size=(B, n, n))
    A = torch.as_tensor(scale * (H - np.conj(np.swapaxes(H, -1, -2))))
    return wannier._expm_antiherm(A), A


@pytest.mark.parametrize("B,nb,n,dc", [(512, 8, 4, 3), (36, 6, 1, 2), (27, 6, 3, 3), (64, 12, 8, 3),
                                        (64, 8, 9, 3), (27, 6, 12, 3), (36, 8, 16, 2), (8, 6, 32, 3),
                                        (16, 4, 20, 1)])
def test_mv_step_kernel(dev, B, nb, n, dc):
    """Kernel 19: single steps (from the start, and from a state after an
    overshoot) against the plain step at 1e-12."""
    from pythtb_tpu_torch import wannier

    M0, nbr, w_b, b_cart = _mv_inputs(260 + n, B, nb, n, dev, dc)
    U, A = _near_identity(np.random.default_rng(270 + n), B, n, 0.02)
    U, dW = U.to(dev).contiguous(), (0.01 * A).to(dev).contiguous()
    eps0 = 0.5 / (4.0 * float(w_b.sum()))
    for om_prev in (math.inf, -1.0):
        before = _kernels.LAUNCHES["mv_step"]
        got = wannier.mv_step(M0, nbr, w_b, b_cart, U, dW, 1.3 * eps0, om_prev, eps0)
        assert _kernels.LAUNCHES["mv_step"] == before + 1
        want = wannier._mv_step_plain(M0, nbr, w_b, b_cart, U, dW,
                                      torch.tensor(1.3 * eps0, dtype=torch.float64, device=dev),
                                      torch.tensor(om_prev, dtype=torch.float64, device=dev), 20.0 * eps0)
        for what, a, b in zip(("U", "dW", "eps", "Omega"), got, want):
            err = _max_diff(a, b)
            assert err < TOL * max(1.0, float(b.abs().max())), (what, om_prev, err)


def _silicon_overlaps(nk, dev):
    """The silicon MLWF row's coarse-grid overlaps in the projected gauge,
    built on ``dev`` by the port's helpers."""
    import pathlib

    import pythtb_tpu_torch as pt
    from pythtb_tpu_torch import wannier

    d = str(pathlib.Path(__file__).resolve().parent / "data" / "w90_silicon")
    si = pt.w90(d, "silicon").model(min_hopping_norm=0.01)
    data = si._get_finalized()
    t = torch.as_tensor(wannier.WannierInterpolator._t_orb(si)).to(dev)
    _, _, u = wannier._grid_solve(data, nk, t)
    u = u[:, :4]
    V0, _ = wannier._project_gauge(u, torch.eye(8, dtype=torch.complex128, device=dev)[:4], False)
    nbr, w_b, b_cart = wannier._shells_on(si, nk, dev)
    return wannier._rotated_overlaps(u, V0, nbr), nbr, w_b, b_cart


@pytest.mark.parametrize("steps", [0, 1, 2])
def test_mv_run_kernel_short_runs(dev, steps):
    """The run kernel at 0, 1 and 2 steps against the plain run at 1e-12:
    one launch carries the steps (none at 0), one more the closing pair."""
    from pythtb_tpu_torch import wannier

    M0, nbr, w_b, b_cart = _mv_inputs(280 + steps, 64, 8, 4, dev)
    before = dict(_kernels.LAUNCHES)
    U, hist, (rbar, oi, ot) = wannier.mv_localize(M0, nbr, w_b, b_cart, steps, 0.5)
    assert _kernels.LAUNCHES["mv_step"] - before["mv_step"] == int(steps > 0)
    assert _kernels.LAUNCHES["mv_final"] - before["mv_final"] == 1
    Up, hp, (rp, oip, otp) = wannier._mv_run_plain(M0, nbr, w_b, b_cart, steps, 0.5 / (4.0 * float(w_b.sum())))
    assert hist.shape == hp.shape
    for a, b in ((U, Up), (hist, hp), (rbar, rp), (oi, oip), (ot, otp)):
        if b.numel():
            assert _max_diff(a, b) < TOL * max(1.0, float(b.abs().max()))


def test_mv_run_kernel_history_step_by_step(dev):
    """A 60-step run at 10 times the default step size: the bold driver
    takes both branches (13 rises of the spread on the plain run), and
    each step's spread meets the plain run's at 1e-10 relative (the
    trajectory's own sensitivity, measured on the plain run, is 6e-14)
    and the spread of chained single steps (``mv_step``) at 1e-12."""
    from pythtb_tpu_torch import wannier

    M0, nbr, w_b, b_cart = _mv_inputs(290, 64, 8, 4, dev)
    alpha = 5.0
    eps0 = alpha / (4.0 * float(w_b.sum()))
    _, hist, _ = wannier.mv_localize(M0, nbr, w_b, b_cart, 60, alpha)
    _, hp, _ = wannier._mv_run_plain(M0, nbr, w_b, b_cart, 60, eps0)
    torch.cuda.synchronize()
    assert 0 < int((hp[1:] > hp[:-1]).sum()) < 59  # both branches of the rule
    U = torch.eye(4, dtype=torch.complex128, device=dev).expand(64, 4, 4).contiguous()
    dW, eps, om = torch.zeros_like(U), eps0, math.inf
    for i in range(60):
        assert abs(float(hist[i]) - float(hp[i])) <= 1e-10 * abs(float(hp[i])), i
        U, dW, eps, om = wannier.mv_step(M0, nbr, w_b, b_cart, U, dW, float(eps), float(om), eps0)
        assert abs(float(om) - float(hist[i])) <= 1e-12 * abs(float(hist[i])), i


def test_mv_localize_kernel_whole_run(dev):
    """Kernel 19 over the silicon row's 4^3 overlaps, 100 steps, against
    the plain run: Omega_I and Omega at 1e-10, the history at 1e-8
    (relative: PERF.md section 2)."""
    from pythtb_tpu_torch import wannier

    prev = config.device()
    config.set_device(dev)
    try:
        M0, nbr, w_b, b_cart = _silicon_overlaps((4, 4, 4), dev)
    finally:
        config.set_device(prev)
    U, hist, (rbar, oi, ot) = wannier.mv_localize(M0, nbr, w_b, b_cart, 100, 0.5)
    Up, hp, (rp, oip, otp) = wannier._mv_run_plain(M0, nbr, w_b, b_cart, 100, 0.5 / (4.0 * float(w_b.sum())))
    assert abs(float(oi) - float(oip)) <= 1e-10 * abs(float(oip))
    assert abs(float(oi + ot) - float(oip + otp)) <= 1e-10 * abs(float(oip + otp))
    assert _max_diff(hist, hp) <= 1e-8 * float(hp.abs().max())


# -- kernel 11b (dense Chebyshev filter) and kernel 20 (Schur pole sums) ------


def _dense_case(seed, D, nb, dev):
    """A random Hermitian H with its Gershgorin window and the cut of the ED
    solver's first round, and a random block X."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(D, D)) + 1j * rng.normal(size=(D, D))
    H = (A + A.conj().T) / np.sqrt(D)
    radii = np.sum(np.abs(H), axis=1) - np.abs(np.diag(H))
    hi, lo = float(np.max(np.diag(H).real + radii)), float(np.min(np.diag(H).real - radii))
    cut = lo + 0.1 * (hi - lo)
    X = rng.normal(size=(D, nb)) + 1j * rng.normal(size=(D, nb))
    return torch.as_tensor(H).to(dev), torch.as_tensor(X).to(dev), 0.5 * (cut + hi), 0.5 * (hi - cut)


@pytest.mark.parametrize("D,nb,p", [(37, 3, 0), (37, 3, 1), (200, 10, 2), (333, 10, 30), (130, 20, 5), (70, 17, 2)])
def test_dense_filter_kernel(dev, D, nb, p):
    """Kernel 11b against its plain version: one or two steps at 1e-12 of
    each column's largest entry, whole filters at 1e-10 (sums in another
    order); both column-group widths (nb <= 8 and above, several groups)."""
    from pythtb_tpu_torch.ops import chebyshev

    H, X, c, hw = _dense_case(D + nb + p, D, nb, dev)
    before = _kernels.LAUNCHES["dense_filter"]
    got = chebyshev.dense_filter(H, X, p, c, hw)
    assert _kernels.LAUNCHES["dense_filter"] == before + max(p, 1)
    want = chebyshev._dense_filter_plain(H, X, p, c, hw)
    torch.cuda.synchronize()
    tol = TOL if p <= 2 else 1e-10
    err = (got - want).abs().amax(dim=0)
    assert bool((err <= tol * want.abs().amax(dim=0)).all()), float((err / want.abs().amax(dim=0)).max())


@pytest.mark.parametrize("D,nb,p", [(4901, 10, 2), (999, 1, 2), (999, 16, 2), (999, 17, 2), (999, 32, 30),
                                    (130, 20, 5)])
def test_dense_filter_designs(dev, D, nb, p):
    """Both designs of kernel 11b (tensor cores, CUDA cores) against the
    plain version, D past every tile and nb 1 / 16 / 17 / 32 (one to four
    n-tiles of 8, a ragged group): 1e-12 of each column's largest entry
    for one or two steps, 1e-10 for whole filters; a repeated call gives
    the same bits (the slices are added in a fixed order)."""
    from pythtb_tpu_torch.ops import chebyshev

    H, X, c, hw = _dense_case(D * nb + p, D, nb, dev)
    want = chebyshev._dense_filter_plain(H, X, p, c, hw)
    tol = TOL if p <= 2 else 1e-10
    for design in chebyshev._DENSE_DESIGNS:
        before = _kernels.LAUNCHES["dense_filter"]
        got = chebyshev._dense_filter(H, X, p, c, hw, design)
        assert _kernels.LAUNCHES["dense_filter"] == before + max(p, 1)
        torch.cuda.synchronize()
        err = (got - want).abs().amax(dim=0)
        assert bool((err <= tol * want.abs().amax(dim=0)).all()), (design, float((err / want.abs().amax(dim=0)).max()))
        assert torch.equal(got, chebyshev._dense_filter(H, X, p, c, hw, design)), design


def _pole_inputs(seed, Nk, nv, nw, dev):
    rng = np.random.default_rng(seed)
    W, _ = np.linalg.qr(rng.normal(size=(Nk, nv, nv)) + 1j * rng.normal(size=(Nk, nv, nv)))
    t = lambda x: torch.as_tensor(np.ascontiguousarray(x)).to(dev)
    z = (rng.uniform(-4.0, 4.0, nw) + 0.3) + 1j * rng.uniform(0.02, 2.0, nw)
    return dict(epso=t(rng.normal(size=Nk)), lams=t(2.0 * rng.normal(size=(Nk, nv))), W=t(W),
                b=t(0.5 * (rng.normal(size=(Nk, nv)) + 1j * rng.normal(size=(Nk, nv)))),
                z=t(z), sigma=t(0.3 * rng.normal(size=nw) - 0.2j * np.abs(rng.normal(size=nw))))


def _rel_err(a, b):
    torch.cuda.synchronize()
    assert a.shape == b.shape
    return float((a - b).abs().max()) / max(1.0, float(b.abs().max()))


@pytest.mark.parametrize("Nk,nv,nw", [(1, 1, 5), (64, 3, 130), (300, 7, 257), (40, 8, 64), (2000, 2, 33),
                                     (70000, 2, 3), (16, 9, 20), (30, 12, 70), (7, 16, 129)])
def test_pole_sum_kernel_modes(dev, Nk, nv, nw):
    """Kernel 20's k-mean, pole, map and resolved modes against their plain
    versions at 1e-12 (relative to the largest entry); 70,000 k-points go
    past the 65,535 blocks a grid's y dimension takes, and nv 9-16 past the
    8 states whose R_m the resolved mode keeps in registers."""
    from pythtb_tpu_torch.ops import pole_sum

    d = _pole_inputs(Nk + nv + nw, Nk, nv, nw, dev)
    amps = (d["b"].abs() ** 2).contiguous()
    before = _kernels.LAUNCHES["pole_sum"]
    args = (d["epso"], amps, d["lams"], d["z"], d["sigma"])
    assert _rel_err(pole_sum.lattice_gloc(*args), pole_sum._lattice_gloc_plain(*args)) <= TOL
    assert _rel_err(pole_sum.spectral_map(*args), pole_sum._spectral_map_plain(*args)) <= TOL
    a, p = amps.reshape(-1).contiguous(), d["lams"].reshape(-1).contiguous()
    assert _rel_err(pole_sum.pole_sum(a, p, d["z"]), pole_sum._pole_sum_plain(a, p, d["z"])) <= TOL
    args = (d["epso"], d["lams"], d["W"], d["b"], d["z"], d["sigma"])
    for got, want in zip(pole_sum.spectral_resolved(*args), pole_sum._spectral_resolved_plain(*args)):
        assert _rel_err(got, want) <= TOL
    assert _kernels.LAUNCHES["pole_sum"] == before + 4


def test_interacting_slice_goes_through_kernels(dev):
    """ED (full and filtered sector solves, spectral function, twist Chern
    number), DMFT (Bethe and lattice, the ARPES map resolved) and the mean
    fields on the card launch kernels 11b, 20, 16, 3-4, 1 and 2, and agree
    with the CPU run of the same calls at 1e-10 (relative).  The DMFT
    fixed points pass through L-BFGS-B bath fits, whose iterates part at
    the fit's resolution between any two runs, so they are held at the
    bench pins' tolerance (Z 5e-3), and their real-axis maps on the card's
    state carried to the CPU at 1e-10."""
    import warnings

    import pythtb_tpu_torch as pt
    from pythtb_tpu_torch import convert

    om = np.linspace(-4, 4, 51)
    kp = np.random.default_rng(0).random((9, 2))
    sq = pt.tb_model(2, 2, np.eye(2), [[0.0, 0.0], [0.0, 0.0]])
    sq.set_onsite([0.0, 1.5])
    sq.set_hop(-1.0, 0, 0, [1, 0])
    sq.set_hop(-1.0, 0, 0, [0, 1])
    sq.set_hop(0.3, 0, 1, [0, 0])

    def run():
        ring = pt.models.chain().cut_piece(6, 0, glue_edgs=True)
        r = pt.ed.hubbard(ring, 4.0, 3, 3, lowest=4)
        rf = pt.ed.hubbard(ring, 4.0, 3, 3)
        A, _ = pt.ed.spectral_function(pt.models.chain().cut_piece(4, 0, glue_edgs=True), 4,
                                       np.linspace(-5, 7, 41), U=2.0, eta=0.15, modes=[0])
        c = pt.ed.many_body_chern(pt.models.haldane(), (1, 1), nelec=1, spinful=True, multiplet=2, grid=6)
        hf = pt.meanfield.hartree_fock(pt.models.graphene(), 3.0, 2.0, nk=(4, 4), seed=3)
        bcs = pt.meanfield.bcs_gap(pt.models.square(t=-1.0), 2.0, -0.4, nk=(6, 6), temperature=0.01)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            rb = pt.dmft.bethe(2.0, n_matsubara=32, n_bath=2, max_iter=3)
            rl = pt.dmft.solve(sq, 2.0, nk=[4, 4], n_matsubara=32, n_bath=2, max_iter=3)
        exact = [r.evals, rf.evals[:4], A, np.array([c, hf["energy"], bcs["delta"][0], bcs["iters"]])]
        return exact, rb, rl

    def maps(rb, rl):
        return [rb.local_spectral(om), rl.local_spectral(om), pt.dmft.band_spectral(rl, kp, om, resolved=True)]

    def carried(r, model):
        state = {key: getattr(r, key) for key in ("wn", "sigma", "g_loc", "g_imp", "g0_inv", "mu", "eps_d", "bath")}
        kind, dat = r._real_axis
        state.update(amps=r._amps, poles=r._poles, orb=r._orb,
                     real_axis=(kind, tuple(np.asarray(d.cpu() if torch.is_tensor(d) else d) for d in dat)))
        ms = None if model is None else {
            "dim_k": model._dim_k, "dim_r": model._dim_r, "lat": model._lat, "orb": model._orb, "per": model._per,
            "nspin": model._nspin, "site_energies": model._site_energies,
            "amps": np.array([h[0] for h in model._hoppings], dtype=complex),
            "i": [h[1] for h in model._hoppings], "j": [h[2] for h in model._hoppings],
            "R": np.array([h[3] for h in model._hoppings])}
        return convert.dmft_result_from_numpy(state, ms, device="cpu")

    prev = config.device()
    config.set_device(dev)
    try:
        _kernels.reset_launches()
        card, rb, rl = run()
        card_maps = maps(rb, rl)
        for name in ("dense_filter", "pole_sum", "spectral_sum", "link_dets", "plaquette_flux", "assemble", "eig2"):
            assert _kernels.LAUNCHES[name] > 0, name
        config.set_device("cpu")
        cpu, cb, cl = run()
        cpu_maps = maps(carried(rb, None), carried(rl, sq))
    finally:
        config.set_device(prev)
    for got, want in zip(card + card_maps, cpu + cpu_maps):
        assert np.abs(got - want).max() <= 1e-10 * max(1.0, np.abs(want).max())
    assert abs(rb.Z - cb.Z) < 5e-3 and abs(rl.Z - cl.Z) < 5e-3


def test_transport_and_mv_kernels_refuse_above_their_limits(dev):
    from pythtb_tpu_torch import wannier
    from pythtb_tpu_torch.ops import transport

    w = _random_frames(300, (3, 2), 65, 66, dev)
    with pytest.raises(ValueError, match="at most 64 states.*set_device"):
        transport.smooth_gauge(w, list(range(65)), 0, 1, 2, True)
    with pytest.raises(ValueError, match="at most 64 states.*set_device"):
        transport.follow_states(w, [0], 0, 1, 2)
    M0, nbr, w_b, b_cart = _mv_inputs(301, 4, 2, 33, dev)
    with pytest.raises(ValueError, match="at most 32 Wannier functions.*set_device"):
        wannier.mv_localize(M0, nbr, w_b, b_cart, 1, 0.5)


# -- kernel 21 (linear-tetrahedron DOS) and kernel 16's q-batch mode ------------


@pytest.mark.parametrize("d,nk,S,nE", [(1, 4096, 1, 201), (1, 37, 3, 1), (2, 64, 2, 513), (2, 7, 5, 130),
                                       (3, 24, 1, 1601), (3, 9, 4, 64)])
def test_tetra_dos_kernel(dev, d, nk, S, nE):
    """Kernel 21 against the plain corners and branches: 1e-10 relative
    (sums of many simplices in another order), chunks of 512 simplices
    and tiles of 128 energies cut off."""
    from pythtb_tpu_torch.ops import tetra

    rng = np.random.default_rng(d * 100 + nk + S)
    ev = np.sort(rng.normal(size=(nk**d, S)), axis=-1) + np.arange(S)
    evt = torch.as_tensor(ev).to(dev)
    E = torch.as_tensor(np.linspace(ev.min() - 0.5, ev.max() + 0.5, nE)).to(dev)
    before = _kernels.LAUNCHES["tetra_dos"]
    got = tetra.tetra_dos(evt, nk, d, E)
    assert _kernels.LAUNCHES["tetra_dos"] == before + 1
    want = tetra._tetra_dos_plain(evt, nk, d, E)
    assert _max_diff(got, want) <= 1e-10 * float(want.abs().max())


@pytest.mark.parametrize("Q,P,T,nw", [(64, 4, 2304, 16), (1, 9, 700, 130), (5, 17, 33, 3), (3, 1, 1, 1)])
def test_spectral_sum_qbatch_kernel(dev, Q, P, T, nw):
    """Kernel 16's q-batch Lorentzian mode against the plain sum per q at
    1e-10 relative: the Lindhard row's shape (64 q, 4 operator pairs,
    2,304 transitions, 16 w), column groups of 8 and T off the chunks."""
    from pythtb_tpu_torch import optical

    rng = np.random.default_rng(Q + P + T + nw)
    W = torch.as_tensor(rng.normal(size=(Q, P, T)) + 1j * rng.normal(size=(Q, P, T))).to(dev)
    de = torch.as_tensor(rng.uniform(-3.0, 3.0, (Q, T))).to(dev)
    om = torch.as_tensor(np.linspace(0.0, 2.0, nw)).to(dev)
    before = dict(_kernels.LAUNCHES)
    got = optical.spectral_sum_qbatch(W, de, om, 0.05)
    assert _kernels.LAUNCHES["spectral_sum_qbatch"] == before["spectral_sum_qbatch"] + 1
    assert _kernels.LAUNCHES["spectral_sum"] == before["spectral_sum"]
    want = optical._spectral_sum_qbatch_plain(W, de, om, 0.05)
    assert _max_diff(got, want) <= 1e-10 * float(want.abs().max())


def test_fermi_surface_and_response_slice_goes_through_kernels(dev):
    """dos_linear (d 2 and 3), lindhard, the Stoner analysis, kp_model and
    magnetotransport on the card launch kernels 21, 16's q-batch mode, 15
    and 1, and agree with the CPU run of the same calls at 1e-10
    (relative)."""
    import pythtb_tpu_torch as pt

    def run():
        g = pt.models.graphene()
        cub = pt.tb_model(3, 3, np.eye(3), [[0.0, 0.0, 0.0]])
        for R in ([1, 0, 0], [0, 1, 0], [0, 0, 1]):
            cub.set_hop(-1.0, 0, 0, R)
        sq = pt.models.square(t=-1.0)
        return [pt.fermisurface.dos_linear(g, np.linspace(-3.2, 3.2, 101), nk=32),
                pt.fermisurface.dos_linear(cub, np.linspace(-6.5, 6.5, 101), nk=12),
                pt.response.lindhard(g, [[i / 8, 0.0] for i in range(8)], [0.0, 0.5], nk=12, mu=0.1,
                                     temperature=0.05, eta=0.02),
                pt.response.stoner_analysis(g, [[0.0, 0.0]], nk=9, mu=0.0, temperature=0.02)["lambda"],
                pt.geometry.kp_model(g, [1 / 3, 2 / 3], [0, 1])(np.array([[1e-3, 2e-3]])),
                pt.boltzmann.magnetotransport(sq, -3.2, [0.1, 0.5], tau=2.0, nk=41)["sigma"]]

    prev = config.device()
    config.set_device(dev)
    try:
        _kernels.reset_launches()
        card = run()
        for name in ("tetra_dos", "spectral_sum_qbatch", "assemble_dk", "assemble"):
            assert _kernels.LAUNCHES[name] > 0, name
        config.set_device("cpu")
        cpu = run()
    finally:
        config.set_device(prev)
    for got, want in zip(card, cpu):
        assert np.abs(got - want).max() <= 1e-10 * max(1.0, np.abs(want).max())


# -- slice 11: kernel 22 (propagator chain), kernel 23 (BdG Hessian and grand
# potential), kernel 24 (winding stencil), kernel 1's Floquet-block mode ------


def _hermitian(rng, shape, n):
    a = rng.normal(size=tuple(shape) + (n, n)) + 1j * rng.normal(size=tuple(shape) + (n, n))
    return (a + np.conj(np.swapaxes(a, -1, -2))) / 2


def _eig_rows(H):
    """Eigenpairs of a numpy Hermitian batch, eigenvectors as rows."""
    w, v = np.linalg.eigh(H)
    return w, np.ascontiguousarray(np.swapaxes(v, -1, -2))


@pytest.mark.parametrize("S", [2, 4, 8, 9, 24, 32, 64])
def test_propagate_kernel_modes(dev, S):
    from pythtb_tpu_torch.ops import propagate

    rng = np.random.default_rng(2200 + S)
    Tc, groups, Rg, d = 7, 2, (300 if S <= 8 else 5), 2
    R = groups * Rg
    w, V = _eig_rows(_hermitian(rng, (Tc, R), S))
    dH = _hermitian(rng, (Tc, R, d), S)
    nocc = max(1, S // 2)
    psi0 = np.linalg.qr(rng.normal(size=(R, S, S)) + 1j * rng.normal(size=(R, S, S)))[0][:, :nocc, :]
    dt = rng.uniform(0.05, 0.3, R)
    t = {k: torch.as_tensor(np.ascontiguousarray(v)).to(dev) for k, v in
         dict(w=w, V=V, dH=dH, psi=psi0, dt=dt).items()}
    before = _kernels.LAUNCHES["propagate_state"]
    psi_k, j_k = propagate.propagate_state(t["w"], t["V"], t["dH"], t["psi"].clone(), t["dt"], groups)
    assert _kernels.LAUNCHES["propagate_state"] == before + 1
    psi_p, j_p = propagate._propagate_state_plain(t["w"], t["V"], t["dH"], t["psi"], t["dt"], groups)
    assert _rel_err(psi_k, psi_p) <= TOL and _rel_err(j_k, j_p) <= TOL
    U0 = torch.as_tensor(np.linalg.qr(rng.normal(size=(R, S, S)) + 1j * rng.normal(size=(R, S, S)))[0]).to(dev)
    hist_k = torch.empty((Tc, R, S, S), dtype=torch.complex128, device=dev)
    hist_p = torch.empty_like(hist_k)
    U_k = propagate.propagate_full(t["w"], t["V"], U0.clone(), t["dt"], hist_k)
    U_p = propagate._propagate_full_plain(t["w"], t["V"], U0, t["dt"], hist_p)
    assert _rel_err(U_k, U_p) <= TOL and _rel_err(hist_k, hist_p) <= TOL
    U_n = propagate.propagate_full(t["w"], t["V"], U0.clone(), t["dt"])
    assert _rel_err(U_n, U_p) <= TOL


_FULL_CACHE = """
import sys
import numpy as np
import torch
from pythtb_tpu_torch.ops import _kernels, propagate

if sys.argv[1] == "off":
    _kernels.GROWS_LOCAL_MEMORY = frozenset()
dev = torch.device("cuda", 0)
_kernels.library()
rng = np.random.default_rng(7)
S, Tc, R = 8, 3, 64
a = rng.normal(size=(Tc, R, S, S)) + 1j * rng.normal(size=(Tc, R, S, S))
w, V = np.linalg.eigh(a + np.conj(np.swapaxes(a, -1, -2)))
V = np.ascontiguousarray(np.swapaxes(V, -1, -2))
dH = np.ascontiguousarray(np.repeat(V[:, :, None], 2, axis=2))
psi = np.ascontiguousarray(V[0, :, :4])
t = [torch.as_tensor(x).to(dev) for x in (w, V, dH, psi, rng.uniform(0.05, 0.3, R))]
free, _ = torch.cuda.mem_get_info(dev)
block = torch.empty(free - (128 << 20), dtype=torch.uint8, device=dev)
del block  # torch's cache holds all but 128 MB of the card
try:
    propagate.propagate_state(t[0], t[1], t[2], t[3], t[4], 2)
    torch.cuda.synchronize()
    print("launched after %d release(s), torch holds %d bytes"
          % (_kernels.cache_releases, torch.cuda.memory_reserved(dev)))
except RuntimeError as err:
    print("refused:", err)
"""


def test_propagate_launches_while_torch_caches_the_card(dev):
    """Kernel 22's first launch reserves local memory for its large stack
    frames outside torch's caching allocator: with torch's cache holding
    all but 128 MB of the card it is refused (cudaError 2), and the launch
    releases the cache once and succeeds.  A fresh process each, since the
    card keeps the reservation."""
    import subprocess
    import sys
    from pathlib import Path

    _kernels.library()  # built once here; the children load it
    root = Path(__file__).resolve().parents[1]

    def child(retry):
        out = subprocess.run([sys.executable, "-c", _FULL_CACHE, retry], cwd=root, capture_output=True, text=True,
                             timeout=300)
        assert out.returncode == 0, out.stderr[-2000:]
        return out.stdout.strip().splitlines()[-1]

    assert child("off") == "refused: CUDA kernel propagate_state failed to launch: cudaError 2"
    got = child("on")
    assert got.startswith("launched after 1 release(s), torch holds ") and int(got.split()[-2]) < (1 << 30), got


def _bdg_inputs(seed, B, S, d, dev):
    rng = np.random.default_rng(seed)
    lam, U = _eig_rows(_hermitian(rng, (B,), 2 * S))
    lam[0, 1] = lam[0, 0]  # an exact degeneracy takes the f' branch
    mats = [_hermitian(rng, (B, d), S), _hermitian(rng, (B, d), S)]
    d2 = [_hermitian(rng, (B, d, d), S) for _ in range(2)]
    d2 = [(x + np.swapaxes(x, 1, 2)) / 2 for x in d2]
    lat = rng.normal(size=(d, d)) + 2.0 * np.eye(d)
    t = [torch.as_tensor(np.ascontiguousarray(x)).to(dev) for x in (lam, U, *mats, *d2)]
    return t, lat


@pytest.mark.parametrize("N,d", [(2, 2), (6, 2), (8, 3), (12, 2), (64, 2), (6, 1)])
def test_bdg_hessian_kernel_modes(dev, N, d):
    from pythtb_tpu_torch.ops import bdg_hessian as bh

    B = 300 if N <= 8 else 7
    (lam, U, dHp, dHm, d2p, d2m), lat = _bdg_inputs(2300 + N, B, N // 2, d, dev)
    kt, tol = 0.05, 1e-13
    got = bh.bdg_hessian(lam, U, dHp, dHm, d2p, d2m, lat, kt, tol)
    want = bh._bdg_hessian_plain(lam, U, dHp, dHm, d2p, d2m, lat, kt, tol)
    assert _rel_err(got, want) <= 1e-10
    nq = 5
    lamq = torch.as_tensor(np.random.default_rng(N).normal(size=(nq * B, N)) * 3.0).to(dev)
    tr = torch.as_tensor(np.random.default_rng(N + 1).normal(size=nq * B)).to(dev)
    for kt in (1e-3, 0.3):
        got = bh.bdg_grand_potential(lamq, tr, nq, kt, 0.7)
        want = bh._bdg_grand_potential_plain(lamq, tr, nq, kt, 0.7)
        assert float((got - want).abs().max()) <= 1e-10 * float(want.abs().max())


@pytest.mark.parametrize("S", [2, 4, 16])
def test_winding_kernel(dev, S):
    from pythtb_tpu_torch.ops import propagate, winding

    rng = np.random.default_rng(2400 + S)
    n0, n1, nt, G = 4, 3, 6, 2
    B = n0 * n1
    w, V = _eig_rows(_hermitian(rng, (nt, B), S))
    U = torch.eye(S, dtype=torch.complex128, device=dev).expand(B, S, S).contiguous()
    hist = torch.empty((nt + 1, B, S, S), dtype=torch.complex128, device=dev)
    hist[0] = U
    propagate._propagate_full_plain(torch.as_tensor(w).to(dev), torch.as_tensor(V).to(dev), U,
                                    torch.full((B,), 0.2, dtype=torch.float64, device=dev), hist[1:])
    theta, P = berry.unitary_eig(hist[-1])
    eps = torch.as_tensor(rng.uniform(-1.0, 1.0, (G, B, S))).to(dev)
    p0, p1 = (torch.as_tensor(np.exp(2j * np.pi * rng.random(S))).to(dev) for _ in range(2))
    got = winding.winding(hist, P.contiguous(), eps, p0, p1, n0, n1, 1.3)
    want = winding._winding_plain(hist, P, eps, p0, p1, n0, n1, 1.3)
    assert float((got - want).abs().max()) <= 1e-10 * max(1.0, float(want.abs().max()))


@pytest.mark.parametrize("nspin,nharm", [(1, 1), (1, 3), (2, 2)])
def test_assemble_floquet_kernel(dev, nspin, nharm):
    data, k = _random_data(2500 + nspin, 2, nspin, dev, norb=3, nhop=9)
    rng = np.random.default_rng(nharm)
    nm = 4 * nharm + 1
    fac = torch.as_tensor(rng.normal(size=(nm, data.nhop)) + 1j * rng.normal(size=(nm, data.nhop))).to(dev)
    ons = torch.as_tensor(rng.normal(size=(nm, data.nsta)) + 1j * rng.normal(size=(nm, data.nsta))).to(dev)
    got = hamiltonian.assemble_floquet(data, k, fac, ons, 2.5, nharm)
    want = hamiltonian._assemble_floquet_plain(data, k, fac, ons, 2.5, nharm)
    assert _max_diff(got, want) <= TOL


def test_slice_eleven_kernels_refuse_above_their_limits(dev):
    from pythtb_tpu_torch.ops import bdg_hessian as bh
    from pythtb_tpu_torch.ops import propagate, winding

    S = 65
    w = torch.zeros((1, 2, S), dtype=torch.float64, device=dev)
    V = torch.zeros((1, 2, S, S), dtype=torch.complex128, device=dev)
    dt = torch.zeros((2,), dtype=torch.float64, device=dev)
    with pytest.raises(ValueError, match="at most 64 states.*set_device"):
        propagate.propagate_full(w, V, V[0].clone(), dt)
    with pytest.raises(ValueError, match="at most 64 states.*set_device"):
        propagate.propagate_state(w, V, V[:, :, None], V[0, :, :1].clone(), dt)
    lam = torch.zeros((2, 66), dtype=torch.float64, device=dev)
    with pytest.raises(ValueError, match="at most 64 BdG states.*set_device"):
        bh.bdg_grand_potential(lam, lam[:, 0], 1, 0.1, 0.0)
    z = torch.zeros((2, 1, 33, 33), dtype=torch.complex128, device=dev)
    with pytest.raises(ValueError, match="at most 64 BdG states.*set_device"):
        bh.bdg_hessian(lam, torch.zeros((2, 66, 66), dtype=torch.complex128, device=dev), z, z, z[:, :, None],
                       z[:, :, None], np.eye(1), 0.1, 1e-13)
    h = torch.zeros((3, 4, 17, 17), dtype=torch.complex128, device=dev)
    with pytest.raises(ValueError, match="at most 16 states.*set_device"):
        winding.winding(h, h[0], torch.zeros((1, 4, 17), dtype=torch.float64, device=dev), h[0, 0, 0], h[0, 0, 0],
                        2, 2, 1.0)


def test_floquet_and_superfluid_slice_goes_through_kernels(dev):
    """harmonic_spectrum, superfluid_weight (both methods) and the Floquet
    calls on the card launch kernels 22, 23, 24 and kernel 1's Floquet-block
    mode, and agree with the CPU run of the same calls (1e-10 relative)."""
    import pythtb_tpu_torch as pt

    circ = {"A": [0.8, 0.8], "phase": [0.0, np.pi / 2]}
    kl = np.array([[0.1, 0.2], [1 / 3, 2 / 3]])

    def run():
        g = pt.models.graphene()
        h = pt.optical.harmonic_spectrum(pt.models.bn(delta=1.0), np.array([0.5, 0.7]), 0.05, occ=[0], nk=(8, 8),
                                         cycles=5, ramp_cycles=1, steps_per_cycle=16, n_harmonics=3)
        return [h["current"], h["harmonics"],
                pt.geometry.superfluid_weight(pt.models.lieb(), 0.0, 0.3, nk=(8, 8)),
                pt.geometry.superfluid_weight(pt.models.lieb(), 0.0, 0.3, nk=(8, 8), method="fd", step=1e-2),
                pt.floquet.quasienergies(g, 10.0, circ, kl, nharm=3)[0],
                pt.floquet.propagator(g, 10.0, circ, kl, nt=32),
                np.array([pt.floquet.chern(g, 10.0, circ, band=0, nk=(9, 9), nt=32)]),
                pt.floquet.winding_number(g, 10.0, circ, egap=[0.0, 5.0], nk=(7, 7), nt=32)]

    prev = config.device()
    config.set_device(dev)
    try:
        _kernels.reset_launches()
        card = run()
        for name in ("propagate_state", "propagate_full", "bdg_hessian", "bdg_grand_potential", "assemble_floquet",
                     "winding"):
            assert _kernels.LAUNCHES[name] > 0, name
        config.set_device("cpu")
        cpu = run()
    finally:
        config.set_device(prev)
    for got, want in zip(card, cpu):
        assert np.abs(got - want).max() <= 1e-10 * max(1.0, np.abs(want).max())


def test_chains_split_into_chunks_hand_over_the_state(dev, monkeypatch):
    """With a chunk budget of one step, harmonic_spectrum (an omega batch
    of 2), propagator and winding_number on the card make one kernel-22
    launch a step, the state or U passing from launch to launch, and
    agree with the CPU run in one chunk (1e-10 relative)."""
    import pythtb_tpu_torch as pt
    from pythtb_tpu_torch.ops import propagate

    circ = {"A": [0.8, 0.8], "phase": [0.0, np.pi / 2]}
    kl = np.array([[0.1, 0.2], [1 / 3, 2 / 3]])
    nt_h = 5 * 16

    def run():
        g = pt.models.graphene()
        h = pt.optical.harmonic_spectrum(pt.models.bn(delta=1.0), np.array([0.5, 0.7]), 0.05, occ=[0], nk=(6, 6),
                                         cycles=5, ramp_cycles=1, steps_per_cycle=16, n_harmonics=3)
        return [h["current"], h["harmonics"], pt.floquet.propagator(g, 10.0, circ, kl, nt=24),
                pt.floquet.winding_number(g, 10.0, circ, egap=[0.0, 5.0], nk=(5, 5), nt=24)]

    prev = config.device()
    try:
        config.set_device("cpu")
        cpu = run()
        config.set_device(dev)
        monkeypatch.setattr(propagate, "CHUNK_BYTES", 1)
        _kernels.reset_launches()
        card = run()
        assert _kernels.LAUNCHES["propagate_state"] == nt_h
        assert _kernels.LAUNCHES["propagate_full"] == 2 * 24
    finally:
        config.set_device(prev)
    for got, want in zip(card, cpu):
        assert np.abs(got - want).max() <= 1e-10 * max(1.0, np.abs(want).max())


def _honeycomb_fc(pt):
    fm = pt.phonon.force_model([[1, 0], [0.5, np.sqrt(3) / 2]], [[1 / 3, 1 / 3], [2 / 3, 2 / 3]])
    fm.set_spring(1.0, 0, 1, [0, 0], kt=0.25)
    fm.set_spring(1.0, 1, 0, [1, 0], kt=0.25)
    fm.set_spring(1.0, 1, 0, [0, 1], kt=0.25)
    return fm


def _honeycomb_tb(pt):
    m = pt.tb_model(2, 2, [[1, 0], [0.5, np.sqrt(3) / 2]], [[1 / 3, 1 / 3], [2 / 3, 2 / 3]])
    for i, j, R in ((0, 1, [0, 0]), (1, 0, [1, 0]), (1, 0, [0, 1])):
        m.set_hop(-1.0, i, j, R)
    return m


def _kagome_magnet(pt):
    sm = pt.magnon.spin_model([[1.0, 0.0], [0.5, np.sqrt(3) / 2]], [[0.0, 0.0], [0.5, 0.0], [0.0, 0.5]], spin=0.5)
    for i, j, R in ((0, 1, [0, 0]), (0, 2, [0, 0]), (1, 2, [0, 0]), (1, 0, [1, 0]), (2, 0, [0, 1]), (2, 1, [-1, 1])):
        sm.set_coupling(-1.0, i, j, R, dm=[0.0, 0.0, 0.15])
    sm.set_field([0, 0, 0.02])
    return sm


@pytest.mark.parametrize("B,N,dk,nT", [(1, 1, 1, 1), (4096, 4, 2, 40), (333, 6, 3, 17), (1000, 2, 1, 33)])
def test_phonon_kappa_kernel(dev, B, N, dk, nT):
    from pythtb_tpu_torch.ops import phonon_kappa

    rng = np.random.default_rng(B + N)
    vecs = torch.as_tensor(np.linalg.qr(rng.normal(size=(B, N, N)) + 1j * rng.normal(size=(B, N, N)))[0]).to(dev)
    a = rng.normal(size=(B, dk, N, N)) + 1j * rng.normal(size=(B, dk, N, N))
    dD = torch.as_tensor(a + np.conj(np.swapaxes(a, -1, -2))).to(dev)
    om = rng.uniform(0.0, 3.0, (B, N))
    om[0, 0] = 0.0
    omega = torch.as_tensor(om).to(dev)
    Ts = torch.as_tensor(np.geomspace(0.01, 60.0, nT)).to(dev)
    got = phonon_kappa.phonon_kappa(vecs, dD, omega, Ts)
    want = phonon_kappa._phonon_kappa_plain(vecs, dD, omega, Ts)
    assert _max_diff(got, want) <= 1e-10 * float(want.abs().max())


@pytest.mark.parametrize("Kc,Q,S,nmode,nh", [(1, 324, 2, 4, 6), (3, 36, 4, 6, 40), (2, 9, 17, 3, 700), (1, 4, 64, 2, 30)])
def test_eph_vertex_kernel(dev, Kc, Q, S, nmode, nh):
    from pythtb_tpu_torch.ops import eph_vertex

    rng = np.random.default_rng(Kc * Q + S)
    d, natom = 2, max(1, nmode // 2)
    geom = {"i": rng.integers(0, S, nh), "j": rng.integers(0, S, nh), "R": rng.integers(-2, 3, (nh, d)).astype(float),
            "tp": rng.normal(size=nh) + 1j * rng.normal(size=nh), "dhat": rng.normal(size=(nh, d)),
            "atom_of": rng.integers(0, natom, S)}
    tab = eph_vertex.VertexTables(geom, dev)

    def unit(shape):
        return torch.as_tensor(np.linalg.qr(rng.normal(size=shape) + 1j * rng.normal(size=shape))[0]).to(dev)

    vk, vkq = unit((Kc, S, S)), unit((Kc, Q, S, S))
    A = torch.as_tensor(rng.normal(size=(Q, nmode, natom, d)) + 1j * rng.normal(size=(Q, nmode, natom, d))).to(dev)
    k = torch.as_tensor(rng.random((Kc, d))).to(dev)
    qg = torch.as_tensor(rng.random((Q, d))).to(dev)
    got = eph_vertex.eph_vertex(vk, vkq, A, tab, k, qg)
    want = eph_vertex._eph_vertex_plain(vk, vkq, A, tab, k, qg)
    assert _max_diff(got, want) <= 1e-12 * float(want.abs().max())


@pytest.mark.parametrize("B,n,nb", [(1681, 2, 12), (4096, 3, 12), (64, 8, 40), (16, 32, 200)])
def test_colpa_kernel(dev, B, n, nb):
    """Random directed tables with a diagonal large enough for h(k) to be
    positive definite."""
    from pythtb_tpu_torch.ops import colpa

    rng = np.random.default_rng(B + n)
    amp = lambda: (rng.normal(size=nb) + 1j * rng.normal(size=nb)) * 0.3  # noqa: E731
    tab = colpa.ColpaTables(rng.integers(0, n, nb), rng.integers(0, n, nb), rng.normal(size=(nb, 2)), amp(), amp(),
                            -(3.0 + 0.3 * nb / n) * np.ones(n), dev)
    k = torch.as_tensor(rng.random((B, 2))).to(dev)
    T, L = colpa.colpa(tab, 1e-9, k)
    Tp, Lp = colpa._colpa_plain(tab, 1e-9, k)
    scale = float(Tp.abs().max())
    assert _max_diff(T, Tp) <= 1e-12 * scale and _max_diff(L, Lp) <= 1e-12 * float(Lp.abs().max())


def test_colpa_kernel_gives_nan_and_the_error_where_not_positive_definite(dev):
    import pythtb_tpu_torch as pt
    from pythtb_tpu_torch.ops import colpa

    bad = pt.magnon.spin_model([[2.0]], [[0.0], [0.5]], spin=0.5)
    bad.set_coupling(1.0, 0, 1, [0])
    bad.set_coupling(1.0, 1, 0, [1])
    tab = colpa.ColpaTables(*bad._tables(), dev)
    T, L = colpa.colpa(tab, 0.0, torch.tensor([[0.25], [0.1]], dtype=torch.float64, device=dev))
    torch.cuda.synchronize()
    assert bool(torch.isnan(T).all()) and bool(torch.isnan(L).all())
    prev = config.device()
    config.set_device(dev)
    try:
        with pytest.raises(pt.PythtbError, match="Colpa decomposition failed"):
            pt.magnon.bands(bad, [[0.25]], shift=0.0)
    finally:
        config.set_device(prev)


def test_slice_twelve_kernels_refuse_above_their_limits(dev):
    from pythtb_tpu_torch.ops import colpa, eph_vertex, phonon_kappa

    z = torch.zeros((2, 4, 3, 3), dtype=torch.complex128, device=dev)
    with pytest.raises(ValueError, match="dim_k <= 3"):
        phonon_kappa.phonon_kappa(z[:, 0], z, torch.ones((2, 3), dtype=torch.float64, device=dev),
                                  torch.ones((1,), dtype=torch.float64, device=dev))
    n = 33
    tab = colpa.ColpaTables(np.zeros(1), np.zeros(1), np.zeros((1, 1)), np.ones(1), np.ones(1), np.ones(n), dev)
    with pytest.raises(ValueError, match="2n <= 64.*set_device"):
        colpa.colpa(tab, 0.0, torch.zeros((1, 1), dtype=torch.float64, device=dev))
    S = 65
    geom = {"i": np.zeros(1, int), "j": np.zeros(1, int), "R": np.zeros((1, 1)), "tp": np.ones(1, complex),
            "dhat": np.ones((1, 1)), "atom_of": np.zeros(S, int)}
    v = torch.zeros((1, S, S), dtype=torch.complex128, device=dev)
    with pytest.raises(ValueError, match="at most 64 states.*set_device"):
        eph_vertex.eph_vertex(v, v[:, None], torch.zeros((1, 1, 1, 1), dtype=torch.complex128, device=dev),
                              eph_vertex.VertexTables(geom, dev), torch.zeros((1, 1), dtype=torch.float64, device=dev),
                              torch.zeros((1, 1), dtype=torch.float64, device=dev))


def test_bosons_slice_goes_through_kernels(dev, monkeypatch):
    """thermal_conductivity, linewidths, eliashberg (one chunk, and a chunk
    a k-point), magnon bands, thermal_hall and the neutron map on the card
    launch kernels 25, 26, 27 and 16's q-batch mode, and agree with the
    CPU run of the same calls (1e-10 relative)."""
    import pythtb_tpu_torch as pt
    from pythtb_tpu_torch.ops import propagate

    qs = np.random.default_rng(4).random((32, 2))

    def run():
        fm, m, sm = _honeycomb_fc(pt), _honeycomb_tb(pt), _kagome_magnet(pt)
        out = [pt.phonon.thermal_conductivity(fm, np.linspace(0.05, 1.0, 7), 12),
               pt.eph.linewidths(m, fm, 2.0, [[0.1, 0.2], [0.3, 0.05]], mu=-0.8, temperature=0.08, nkq=(6, 6),
                                 sigma=0.08)]
        r = pt.eph.eliashberg(m, fm, 2.0, -0.8, nk=(4, 4), nkq=(4, 4), sigma_e=0.2)
        out += [r["a2f"], np.array([r["lambda"], r["dos_ef"]]), pt.magnon.bands(sm, qs),
                np.atleast_1d(pt.magnon.thermal_hall(sm, [0.3, 0.6], nk=9)),
                pt.magnon.structure_factor(sm, qs, omegas=np.linspace(-1.0, 4.5, 41), eta=0.05, temperature=0.3)]
        return out

    prev = config.device()
    try:
        config.set_device("cpu")
        cpu = run()
        config.set_device(dev)
        _kernels.reset_launches()
        card = run()
        assert _kernels.LAUNCHES["eigh_jacobi"] > 0  # the 4 x 4 phonon solves, the magnon bands
        for name in ("phonon_kappa", "eph_vertex", "colpa", "spectral_sum_qbatch", "assemble", "assemble_dk"):
            assert _kernels.LAUNCHES[name] > 0, name
        assert _kernels.LAUNCHES["eph_vertex"] == 2  # one chunk a call
        monkeypatch.setattr(propagate, "CHUNK_BYTES", 1)
        r = pt.eph.eliashberg(_honeycomb_tb(pt), _honeycomb_fc(pt), 2.0, -0.8, nk=(4, 4), nkq=(4, 4), sigma_e=0.2)
        assert _kernels.LAUNCHES["eph_vertex"] == 2 + 16
        card.append(r["a2f"])
        cpu.append(cpu[2])
    finally:
        config.set_device(prev)
    for got, want in zip(card, cpu):
        assert np.abs(got - want).max() <= 1e-10 * max(1e-300, np.abs(want).max())


@pytest.mark.parametrize("nk,S,nc,nv,sx", [((30, 30), 2, 1, 1, 1.0), ((16, 16), 4, 2, 2, 0.0),
                                            ((4, 4, 4), 8, 3, 4, 2.0), ((7,), 3, 1, 2, 1.0)])
def test_bse_kernel_modes(dev, nk, S, nc, nv, sx):
    """Kernel 28's pair and Fock modes against their plain einsum chains,
    1e-12 of the largest entry."""
    from pythtb_tpu_torch.ops import bse

    rng = np.random.default_rng(28)
    B = math.prod(nk)

    def cplx(*shape):
        return torch.as_tensor(rng.normal(size=shape) + 1j * rng.normal(size=shape)).to(dev)

    ue, uh, occ, wtab, wq = cplx(B, nc, S), cplx(B, nv, S), cplx(B, 2, S), cplx(B, S, S), cplx(S, S)
    de = torch.as_tensor(rng.normal(size=B * nc * nv)).to(dev)
    want = bse._pair_matrix_plain(ue, uh, wtab, wq, de, nk, sx)
    assert _max_diff(bse.pair_matrix(ue, uh, wtab, wq, de, nk, sx), want) <= TOL * float(want.abs().max())
    want = bse._fock_shifts_plain(wtab, occ, ue, nk)
    assert _max_diff(bse.fock_shifts(wtab, occ, ue, nk), want) <= TOL * float(want.abs().max())


@pytest.mark.parametrize("nspin,S,P,NK", [(1, 2, 1, 900), (1, 4, 3, 257), (2, 8, 2, 64), (1, 16, 1, 40), (1, 40, 2, 9)])
def test_energy_vjp_kernel(dev, nspin, S, P, NK):
    """Kernel 29 against torch autograd through the plain assembly and
    eigensolver (random, non-degenerate spectra), 1e-10 relative."""
    rng = np.random.default_rng(29)
    data, _ = _random_data(29 + S, 2, nspin, dev, norb=S // nspin, nhop=4 * S)
    amps = torch.as_tensor(rng.normal(size=(P,) + tuple(data.amps.shape))
                           + 1j * rng.normal(size=(P,) + tuple(data.amps.shape))).to(dev)
    diag = hamiltonian._hermitian_part(data.diag[None].expand(P, data.nsta, data.nsta)).contiguous()
    k = torch.as_tensor(rng.random((NK, 2))).to(dev)
    _, U = eigh.eigh_batched(hamiltonian.assemble_members(data, amps, diag, k))
    gbar = torch.as_tensor(rng.normal(size=(P * NK, data.nsta))).to(dev)
    got = hamiltonian.energy_vjp(data, amps, diag, k, U, gbar)
    want = hamiltonian._energy_vjp_plain(data, amps, diag, k, gbar)
    for g, w in zip(got, want):
        assert _max_diff(g, w) <= 1e-10 * float(w.abs().max())


@pytest.mark.parametrize("case", ["graphene_K", "spin_pairs"])
def test_energy_gradient_at_a_degeneracy_matches_the_cpu(dev, case):
    """energy_fn's gradient where levels are exactly degenerate, with a
    cotangent that differs inside each group: graphene at K (S 2, eig2)
    and a spinful chain with no spin-orbit term (S 4, the library solver),
    on-site and amplitude gradients on the card (kernel 29) against the
    CPU run, 1e-10 of the largest entry.  Both take the cotangent's mean over each
    group, so the basis the solvers return there does not matter."""
    import pythtb_tpu_torch as pt

    def run():
        if case == "graphene_K":
            m = pt.models.graphene()
            k = np.array([[1.0 / 3.0, 2.0 / 3.0], [2.0 / 3.0, 1.0 / 3.0]])
        else:
            m = pt.tb_model(1, 1, [[1.0]], [[0.0], [0.5]], nspin=2)
            m.set_onsite([0.3, -0.2])
            m.set_hop(0.7, 0, 1, [0])
            m.set_hop(0.4 - 0.1j, 1, 0, [1])
            k = np.array([[0.13], [0.61]])
        fn, p0 = pt.flows.energy_fn(m)
        p = {key: v.clone().requires_grad_() for key, v in p0.items()}
        ev = fn(p, k)
        (ev * torch.arange(1.0, ev.shape[-1] + 1.0, dtype=torch.float64, device=ev.device)).sum().backward()
        return [p["amps"].grad.cpu().numpy(), p["diag"].grad.cpu().numpy()]

    prev = config.device()
    try:
        config.set_device("cpu")
        cpu = run()
        config.set_device(dev)
        _kernels.reset_launches()
        card = run()
        assert _kernels.LAUNCHES["energy_vjp"] > 0
    finally:
        config.set_device(prev)
    scale = max(np.abs(w).max() for w in cpu)  # at K the amplitude gradient is 0 up to rounding
    for got, want in zip(card, cpu):
        assert np.abs(got - want).max() <= 1e-10 * scale, (got, want)


def test_excitons_and_autodiff_slice_goes_through_kernels(dev):
    """bse (qp "hf") and absorption, energy_fn's forward and backward (one
    member and a member axis) and chern_fn's member form on the card launch
    kernels 28 and 29, and agree with the CPU run of the same calls (1e-10;
    energies absolute, the rest relative)."""
    import pythtb_tpu_torch as pt

    def run():
        m = pt.tb_model(2, 2, [[1.0, 0.0], [0.5, np.sqrt(3.0) / 2.0]], [[1 / 3, 1 / 3], [2 / 3, 2 / 3]])
        m.set_onsite([-0.9, 0.9])
        for ij in ((0, 1, [0, 0]), (1, 0, [1, 0]), (1, 0, [0, 1])):
            m.set_hop(-1.0, *ij)
        V = pt.exciton.radial_interaction(m, lambda x: 1.6 / (x + 0.5), 3.0)
        r = pt.exciton.bse(m, V, occ=[0], nk=(6, 6), qp="hf", Q=[1 / 6, 0.0])
        out = [r.energies, r.pair_energies,
               pt.exciton.absorption(m, V, np.linspace(0.0, 5.0, 21), occ=[0], nk=(5, 5), spin="singlet")]
        fn, p0 = pt.flows.energy_fn(pt.models.haldane())
        k = np.random.default_rng(3).random((33, 2))
        p = {key: v.clone().requires_grad_() for key, v in p0.items()}
        (fn(p, k) ** 2).sum().backward()
        out += [p["amps"].grad.cpu().numpy(), p["diag"].grad.cpu().numpy()]
        amps = torch.stack([p0["amps"] * s for s in (1.0, 0.8, 1.3)]).requires_grad_()
        (fn({"amps": amps, "diag": p0["diag"]}, k)[:, :, 0].sum()).backward()
        out.append(amps.grad.cpu().numpy())
        cfn, _ = pt.flows.chern_fn(pt.models.haldane(), [0], nk=(11, 11))
        out.append(cfn({"amps": amps.detach(), "diag": p0["diag"]}).cpu().numpy())
        return out

    prev = config.device()
    try:
        config.set_device("cpu")
        cpu = run()
        config.set_device(dev)
        _kernels.reset_launches()
        card = run()
        for name in ("bse_pair", "bse_fock", "energy_vjp", "assemble_one_sided", "assemble_members", "spectral_sum"):
            assert _kernels.LAUNCHES[name] > 0, name
    finally:
        config.set_device(prev)
    for i, (got, want) in enumerate(zip(card, cpu)):
        scale = 1.0 if i < 2 else max(1e-300, np.abs(want).max())
        assert np.abs(got - want).max() <= 1e-10 * scale, i
