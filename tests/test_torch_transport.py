"""The port's smooth gauge, adiabatic following and family fill
(``wf_array.smooth_gauge``, ``adiabatic_evolve``, ``solve_on_grid_models``)
against pythtb_tpu's, on the CPU in float64, where kernel 14 runs its
plain versions.

Both packages get the same states (``convert.wf_array_from_numpy``): the
algorithms are gauge dependent.  Tolerances: smoothed states, followed
states, fidelities and family energies within 1e-12 of pythtb_tpu's,
followed indices identical.  The oracles of tests/test_transport.py (the
mathematical definitions) run on the port at small grids.
"""

import numpy as np
import pytest
import torch

from pythtb_tpu import wf_array as jwf_array
from pythtb_tpu.models import library as jzoo
from pythtb_tpu.ops import transport as jtransport
from pythtb_tpu.utils.xfer import pack_cplx
from pythtb_tpu_torch import convert, models, tb_model, wf_array
from pythtb_tpu_torch.ops import transport

from .test_torch_ops import carry, on_cpu  # noqa: F401  (autouse: the port on the CPU)

TOL = 1e-12


def _solved(jmodel, mesh, pbc=True):
    """A pythtb_tpu grid solve and its states (periodic gauge on axis 0)."""
    jw = jwf_array(jmodel, mesh)
    jw.solve_on_grid([0.0] * len(mesh))
    if pbc:
        jw.impose_pbc(0, 0)
    return np.array(jw._wfs)


def _pair(jmodel, states):
    a = jwf_array(jmodel, list(states.shape[: jmodel._dim_k]))
    a._wfs = states.copy()
    return a, convert.wf_array_from_numpy(carry(jmodel), states)


@pytest.mark.parametrize("closed", [True, False])
@pytest.mark.parametrize("name,occ", [("haldane", [0]), ("kane_mele", [0, 1]), ("kane_mele_all", "All")])
def test_smooth_gauge_matches_jax(name, occ, closed):
    """Smoothed states along both axes within 1e-12 of pythtb_tpu's,
    nspin 1 and 2, open and closed."""
    jm = jzoo.haldane() if name == "haldane" else jzoo.kane_mele()
    st = _solved(jm, [9, 7])
    for d in (0, 1):
        a, b = _pair(jm, st)
        a.smooth_gauge(occ, dir=d, closed=closed)
        b.smooth_gauge(occ, dir=d, closed=closed)
        assert np.abs(np.asarray(a._wfs) - b._wfs).max() <= TOL


@pytest.mark.parametrize("name,occ,d", [("haldane", [0], 0), ("kane_mele", [0, 1], 0),
                                        ("kane_mele", [1, 2], 1)])
def test_follow_states_matches_jax(name, occ, d):
    """Followed indices identical, fidelity and followed states within
    1e-12 of pythtb_tpu's (nspin 1 and 2)."""
    jm = jzoo.haldane() if name == "haldane" else jzoo.kane_mele()
    a, b = _pair(jm, _solved(jm, [9, 7]))
    ia, fa, wa = a.adiabatic_evolve(occ, dir=d, return_states=True)
    ib, fb, wb = b.adiabatic_evolve(occ, dir=d, return_states=True)
    assert ia.shape == ib.shape and np.array_equal(ia, ib)
    assert np.abs(fa - fb).max() <= TOL
    assert np.abs(np.asarray(wa._wfs) - wb._wfs).max() <= TOL


def test_follow_ties_go_to_the_lower_index():
    """Exactly degenerate weights: the port takes the lower index, as
    jax.lax.top_k does in pythtb_tpu."""
    m = tb_model(0, 1, lat=[[1.0]], orb=[[0.0], [0.0], [0.0], [0.0]])
    e = np.eye(4, dtype=complex)
    st = np.stack([e, e])
    st[1, 0] = (e[0] + e[1]) / np.sqrt(2)  # the start state splits evenly
    st[1, 1] = (e[0] - e[1]) / np.sqrt(2)  # over rows 0 and 1
    jm = jzoo.molecule_nh3()
    jw = jwf_array(jm, [2])  # 4 orbitals as well
    jw._wfs = st.copy()
    wf = convert.wf_array_from_numpy(m, st)
    ia, _ = jw.adiabatic_evolve([0], dir=0)
    ib, fb = wf.adiabatic_evolve([0], dir=0)
    assert ib[1, 0] == ia[1, 0] == 0
    np.testing.assert_allclose(fb, 0.5, atol=1e-15)


@pytest.mark.parametrize("same_graph", [True, False])
def test_solve_on_grid_models_matches_jax(same_graph):
    """Family fill (one graph: kernel 1's member mode; mixed graphs: one
    solve per model) within 1e-12 of pythtb_tpu's energies and gaps, and
    its states' projectors."""
    lams = np.linspace(0.0, 1.0, 7)
    fam = [jzoo.three_site_chain(lam) for lam in lams]
    if not same_graph:
        fam[3].set_hop(0.05, 0, 2, [0], mode="add")  # a new bond
    jw = jwf_array(fam[0], [7, 6])
    g1 = jw.solve_on_grid_models(fam, param_dir=0)
    tw = wf_array(carry(fam[0]), [7, 6])
    g2 = tw.solve_on_grid_models([carry(m) for m in fam], param_dir=0)
    assert np.abs(g1 - g2).max() <= TOL
    assert np.abs(jw.energies - tw.energies).max() <= TOL
    pa = np.einsum("...nf,...ng->...nfg", np.asarray(jw._wfs).conj(), np.asarray(jw._wfs))
    pb = np.einsum("...nf,...ng->...nfg", tw._wfs.conj(), tw._wfs)
    assert np.abs(pa - pb).max() <= 1e-10
    # the parameter axis may come second
    tw2 = wf_array(carry(fam[0]), [6, 7])
    tw2.solve_on_grid_models([carry(m) for m in fam], param_dir=1)
    assert np.abs(np.swapaxes(tw2.energies, 0, 1) - tw.energies).max() <= TOL


def _haldane_loop(nk=13):
    wf = wf_array(models.haldane(), [nk, nk])
    wf.solve_on_grid([-0.5, -0.5])
    return wf


def test_parallel_transport_links_hermitian_positive():
    wf = _haldane_loop()
    wf.smooth_gauge([0], dir=0, closed=False)
    w = np.asarray(wf._wfs)[:, :, 0, :]
    ovr = np.einsum("kjf,kjf->kj", w[:-1].conj(), w[1:])
    assert np.all(ovr.real > 0)
    np.testing.assert_allclose(ovr.imag, 0.0, atol=1e-12)


def test_twisted_links_share_the_loop_phase():
    wf = _haldane_loop()
    wf.impose_pbc(0, 0)
    wf.impose_pbc(1, 1)
    before = wf.berry_phase([0], dir=0, contin=False)
    wf.smooth_gauge([0], dir=0, closed=True)
    w = np.asarray(wf._wfs)[:, :, 0, :]
    ang = np.angle(np.einsum("kjf,kjf->kj", w[:-1].conj(), w[1:]))
    assert np.abs(ang - ang[0][None, :]).max() < 1e-10
    total = -np.angle(np.exp(1j * (w.shape[0] - 1) * ang[0]))
    np.testing.assert_allclose(np.angle(np.exp(1j * (total - before))), 0.0, atol=1e-8)


def test_gauge_invariants_unchanged_and_endpoints_kept():
    wf = _haldane_loop()
    wf.impose_pbc(0, 0)
    wf.impose_pbc(1, 1)
    flux = wf.berry_flux([0])
    w0 = np.array(wf._wfs)
    wf.smooth_gauge([0], dir=1, closed=True)
    w1 = np.asarray(wf._wfs)
    np.testing.assert_allclose(wf.berry_flux([0]), flux, atol=1e-10)
    p = lambda w: np.einsum("kjf,kjg->kjfg", w[:, :, 0].conj(), w[:, :, 0])
    np.testing.assert_allclose(p(w1), p(w0), atol=1e-10)
    np.testing.assert_allclose(w1[:, 0], w0[:, 0], atol=1e-12)
    np.testing.assert_allclose(w1[:, -1], w0[:, -1], atol=1e-10)


def test_multiband_spinful_partial_products_grow_linearly():
    km = models.kane_mele()
    wf = wf_array(km, [9, 9])
    wf.solve_on_grid([0.0, 0.0])
    wf.impose_pbc(0, 0)
    before = wf.berry_phase([0, 1], dir=0, contin=False, berry_evals=True)
    wf.smooth_gauge([0, 1], dir=0, closed=True)
    np.testing.assert_allclose(wf.berry_phase([0, 1], dir=0, contin=False, berry_evals=True), before, atol=1e-9)
    w = wf._wfs[:, :, :2].reshape(9, 9, 2, -1)
    U, _, Vh = np.linalg.svd(np.einsum("kjnf,kjmf->kjnm", w[:-1].conj(), w[1:]))
    prod = np.broadcast_to(np.eye(2), (9, 2, 2)).copy()
    partial = []
    for m in range(8):
        prod = prod @ (U @ Vh)[m]
        partial.append(np.sort(np.angle(np.linalg.eigvals(prod)), axis=-1))
    for m in range(8):
        np.testing.assert_allclose(partial[m], np.sort((m + 1) / 8.0 * partial[-1], axis=-1), atol=1e-8)


def test_holonomy_at_the_branch_cut_keeps_endpoints():
    """A holonomy eigenphase at pi (a band with Berry phase pi: the SSH
    chain's topological phase): the fractional powers pick one side of
    the cut, yet the closed gauge keeps both endpoints of impose_pbc."""
    ssh = tb_model(1, 1, [[1.0]], [[0.0], [0.0]])
    ssh.set_hop(0.4, 0, 1, [0])
    ssh.set_hop(1.0, 1, 0, [1])
    wf = wf_array(ssh, [21])
    wf.solve_on_grid([0.0])
    np.testing.assert_allclose(abs(wf.berry_phase([0])), np.pi, atol=1e-9)
    w0 = np.array(wf._wfs)
    wf.smooth_gauge([0], dir=0, closed=True)
    w1 = np.asarray(wf._wfs)
    np.testing.assert_allclose(w1[0], w0[0], atol=1e-12)
    np.testing.assert_allclose(w1[-1], w0[-1], atol=1e-10)
    np.testing.assert_allclose(abs(wf.berry_phase([0])), np.pi, atol=1e-9)


def _crossing_array(eps, nl=21):
    wf = None
    for i, lam in enumerate(np.linspace(0.0, 1.0, nl)):
        m = tb_model(0, 1, lat=[[1.0]], orb=[[0.0], [0.0]])
        m.set_onsite([lam - 0.5, 0.5 - lam])
        if eps != 0.0:
            m.set_hop(eps, 0, 1, mode="set", allow_conjugate_pair=True)
        if wf is None:
            wf = wf_array(m, [nl])
        wf[i] = m.solve_all(eig_vectors=True)[1]
    return wf


def test_adiabatic_crossings():
    idx, fid = _crossing_array(0.0).adiabatic_evolve([0], dir=0)
    assert idx.shape == (21, 1) and idx[0, 0] == 0 and idx[-1, 0] == 1
    np.testing.assert_allclose(fid, 1.0, atol=1e-12)
    idx, fid = _crossing_array(0.4).adiabatic_evolve([0], dir=0)
    assert np.all(idx[:, 0] == 0) and fid.min() > 0.99
    _, fid = _crossing_array(1e-3, nl=5).adiabatic_evolve([0], dir=0)
    assert fid.min() < 0.9


def test_charge_pump_returns_home_and_two_band_following():
    nl = 31
    lams = np.linspace(0.0, 1.0, nl)
    wf = wf_array(models.three_site_chain(0.0), [nl, 9])
    wf.solve_on_grid_models([models.three_site_chain(lam) for lam in lams], param_dir=0)
    wf.impose_loop(0)
    idx, fid, followed = wf.adiabatic_evolve([0], dir=0, return_states=True)
    assert np.all(idx[0] == idx[-1]) and fid.min() > 0.95
    w = followed._wfs
    p = lambda v: np.einsum("jf,jg->fg", v.reshape(1, -1).conj(), v.reshape(1, -1))
    np.testing.assert_allclose(p(w[0, 0]), p(w[-1, 0]), atol=1e-9)
    km = wf_array(models.kane_mele(), [13, 5])
    km.solve_on_grid([0.0, 0.0])
    idx, fid = km.adiabatic_evolve([0, 1], dir=0)
    assert idx.shape == (13, 5, 2) and fid.min() > 0.85
    assert np.all(np.sort(idx, axis=-1) == idx)


@pytest.mark.parametrize("seed", range(3))
def test_fuzz_smooth_gauge_random_frames(seed):
    """Random orthonormal frames: subspaces, orthonormality and the Berry
    phase kept, endpoints fixed, unchosen states untouched, open links
    Hermitian positive."""
    rng = np.random.RandomState(40 + seed)
    norb = rng.randint(2, 5)
    nocc = rng.randint(1, norb + 1)
    L = rng.randint(4, 9)
    m = tb_model(1, 1, lat=[[1.0]], orb=[[i / norb] for i in range(norb)])
    states = rng.randn(L, norb, norb) + 1j * rng.randn(L, norb, norb)
    st = np.stack([np.linalg.qr(s.T)[0].T for s in states])
    st[-1] = st[0]
    wf = convert.wf_array_from_numpy(m, st)
    occ = list(range(nocc))
    ph = wf.berry_phase(occ, dir=0, contin=False)
    wf.smooth_gauge(occ, dir=0, closed=True)
    after = np.asarray(wf._wfs)
    np.testing.assert_allclose(after[0], st[0], atol=1e-12)
    np.testing.assert_allclose(after[-1], st[-1], atol=1e-10)
    np.testing.assert_allclose(after[:, nocc:], st[:, nocc:], atol=0)
    pp = lambda w: np.einsum("lnf,lng->lfg", w[:, :nocc].conj(), w[:, :nocc])
    np.testing.assert_allclose(pp(after), pp(st), atol=1e-10)
    assert abs(np.angle(np.exp(1j * (wf.berry_phase(occ, dir=0, contin=False) - ph)))) < 1e-8
    wf2 = convert.wf_array_from_numpy(m, st)
    wf2.smooth_gauge(occ, dir=0, closed=False)
    w2 = np.asarray(wf2._wfs)[:, :nocc]
    ovr = np.einsum("lnf,lmf->lnm", w2[:-1].conj(), w2[1:])
    assert np.abs(ovr - np.swapaxes(ovr.conj(), -1, -2)).max() < 1e-10
    assert np.linalg.eigvalsh((ovr + np.swapaxes(ovr.conj(), -1, -2)) / 2).min() > 0.0


def test_plain_versions_shapes():
    """The plain chain starts at the identity and ends at the Wilson loop."""
    from pythtb_tpu_torch.ops import berry

    wf = _haldane_loop(7)
    w = wf._device_states()
    w5, grid = transport._strings(w, 1, 2, 1)
    occ = transport._occ_tensor([0], w.device)
    C, smin = transport._chain_plain(w5, occ)
    assert C.shape == (7, 7, 1, 1, 1) and smin.shape == (7,)
    np.testing.assert_allclose(C[:, 0].numpy(), 1.0)
    prod, _ = berry.wilson_loop(berry.prep_states(w, [0], 1, 2), 1)
    np.testing.assert_allclose(C[:, -1, 0].numpy(), prod.numpy(), atol=1e-12)


def _orthonormal_frames(seed, grid, NS, F):
    """Orthonormal rows at every grid point (random complex QR)."""
    rng = np.random.default_rng(seed)
    z = rng.normal(size=tuple(grid) + (F, NS)) + 1j * rng.normal(size=tuple(grid) + (F, NS))
    return np.ascontiguousarray(np.swapaxes(np.linalg.qr(z)[0], -1, -2))


def _unit_rows(seed, shape):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=shape) + 1j * rng.normal(size=shape)
    return z / np.linalg.norm(z, axis=-1, keepdims=True)


# kernel 14's chain past its register path: random orthonormal frames at S
# 9 and 32, and the slab's shape (S 20 of 39 states, F 39, 41-point
# strings along axis 0) with unit rows, as test_torch_wilson.py's S20_F39
LARGE_S = {
    "S9": lambda: (_orthonormal_frames(9, (7, 5), 11, 12), list(range(9))),
    "S20_F39": lambda: (_unit_rows(6, (41, 3, 39, 39)), list(range(20))),
    "S32": lambda: (_orthonormal_frames(32, (5, 4), 34, 36), list(range(32))),
}


@pytest.mark.parametrize("closed", [True, False])
@pytest.mark.parametrize("case", list(LARGE_S))
def test_smooth_gauge_large_s_matches_jax(case, closed):
    """The port's smooth gauge (the plain chain of kernel 14's link path, on
    the CPU) within 1e-10 of pythtb_tpu.ops.transport.smooth_gauge at S 9,
    20 and 32, along both axes: the JAX program's tree scan of the chain
    agrees with the in-order prefixes to about L eps."""
    st, occ = LARGE_S[case]()
    packed = np.asarray(pack_cplx(st))
    for d in (0, 1):
        want, want_s = jtransport.smooth_gauge(packed, occ, d, 1, 2, closed)
        want = np.asarray(want)
        got, got_s = transport.smooth_gauge(torch.as_tensor(st), occ, d, 1, 2, closed)
        assert np.abs(got.numpy() - (want[..., 0] + 1j * want[..., 1])).max() <= 1e-10
        assert abs(got_s - want_s) <= 1e-10


def test_chain_path_dispatch():
    """Kernel 14's chain design at the shapes PERF.md records (the H100's
    132 SMs): the register path at S 1; the link path above it, a warp a
    link to S 28 and a block a link past it, or where the links are too few
    to fill the SMs with warps (56 links of the random 9 x 7 frames from
    S 9, 264 from S 20);
    designs that do not take S, and unknown designs, are refused before
    any launch."""
    assert [transport._chain_path(S, 41, 31, 132) for S in (1, 2)] == ["registers", "warp"]
    assert [transport._chain_path(S, 301, 300, 132) for S in (1, 2, 4, 8)] == ["registers", "warp", "warp", "warp"]
    assert transport._chain_path(20, 41, 41, 132) == "warp"  # the slab: 1,640 links
    assert [transport._chain_path(S, 7, 9, 132) for S in (8, 9, 16, 28, 32, 64)] == ["warp"] + ["block"] * 5
    assert [transport._chain_path(S, 33, 9, 132) for S in (9, 16, 19, 20, 28)] == ["warp"] * 3 + ["block"] * 2
    assert [transport._chain_path(S, 17, 33, 132) for S in (9, 20, 28, 29)] == ["warp"] * 3 + ["block"]
    assert {k: v[1] for k, v in transport._CHAIN_MODES.items()} == {"registers": 1, "warp": 32, "block": 64}
    w5 = torch.as_tensor(_orthonormal_frames(1, (3, 4), 12, 12))[None]
    occ = transport._occ_tensor(list(range(2)), w5.device)
    with pytest.raises(ValueError, match="'registers' path does not take 2"):
        transport._chain(w5, occ, "registers")
    with pytest.raises(ValueError, match="no 'tree' path"):
        transport._chain(w5, occ, "tree")


def test_rotate_path_dispatch():
    """Kernel 14's rotate design at the shapes PERF.md records (the H100's
    132 SMs and 232,448 bytes of shared memory a block): the register path
    to S 3 (the pump, Kane-Mele 41^2), a warp a point at S 4-8 where the
    points fill the SMs, a block of four warps a point on the CUDA cores
    at S 4-11 elsewhere (the random 9 x 7 frames' 63 points), the
    tensor-core tiles, a block each 16 rows of a point, from S 12 (the
    slab) and where a point's occ rows would not fit a team block whole;
    designs that do not take S, and unknown designs, are refused before
    any launch."""
    H100 = (132, 232448)
    assert [transport._rotate_path(S, 1271, 3, *H100) for S in (1, 2, 3)] == ["registers"] * 3
    assert [transport._rotate_path(S, 1681, 2 * S, *H100) for S in (2, 3, 4, 8)] == ["registers"] * 2 + ["warp"] * 2
    assert [transport._rotate_path(S, 63, S + 6, *H100) for S in (4, 8)] == ["team"] * 2
    assert [transport._rotate_path(S, 9331, S + 6, *H100) for S in (9, 11, 12, 15)] == ["team"] * 2 + ["split"] * 2
    assert [transport._rotate_path(S, 63, S + 6, *H100) for S in (9, 11, 12, 16, 32, 64)] == ["team"] * 2 + ["split"] * 4
    assert [transport._rotate_path(S, 1681, 39, *H100) for S in (12, 16, 20, 32, 39)] == ["split"] * 5
    assert transport._rotate_path(9, 1681, 1000, *H100) == "split"  # its occ rows would not fit a team block
    assert transport._rotate_smem(20, 39, "split") == 42824  # the slab's block, the occ rows whole
    assert {k: v[1] for k, v in transport._ROTATE_MODES.items()} == {"registers": 3, "warp": 64, "team": 64, "split": 64}
    w5 = torch.as_tensor(_orthonormal_frames(2, (3, 4), 12, 12))[None]
    occ = transport._occ_tensor(list(range(4)), w5.device)
    C = torch.zeros((1, 3, 4, 4, 4), dtype=torch.complex128)
    with pytest.raises(ValueError, match="'registers' path does not take 4"):
        transport._rotate(w5, occ, C, None, None, False, "registers")
    with pytest.raises(ValueError, match="no 'wgmma' path"):
        transport._rotate(w5, occ, C, None, None, False, "wgmma")


@pytest.mark.parametrize("closed", [True, False])
def test_rotate_plain_copies_the_rows_outside_occ(closed):
    """The plain rotation (kernel 14's oracle) returns the rows outside
    ``occ`` bit for bit, and the rotated rows as conj(B_m) w_m of a
    scattered occ list."""
    w5 = torch.as_tensor(_orthonormal_frames(5, (7, 3), 10, 12)).reshape(1, 7, 3, 10, 12)
    occ = transport._occ_tensor([1, 4, 5, 8], w5.device)
    C, _ = transport._chain_plain(w5, occ)
    theta = P = None
    if closed:
        from pythtb_tpu_torch.ops import berry

        theta, P = (t.contiguous() for t in berry.unitary_eig(C[:, -1].contiguous()))
    out = transport._rotate_plain(w5, occ, C, theta, P, closed)
    rest = [r for r in range(10) if r not in (1, 4, 5, 8)]
    assert torch.equal(out[:, :, :, rest], w5[:, :, :, rest])
    if not closed:
        want = C.conj() @ w5[:, :, :, occ]
        assert float((out[:, :, :, occ] - want).abs().max()) <= 1e-14
    # the first point of each string keeps its rows (C_0 = I, t_0 = 0)
    assert float((out[:, 0] - w5[:, 0]).abs().max()) <= 1e-14


def _follow_split_order(w5, occ):
    """Kernel 14's follow in the scan design's order, in plain PyTorch: the
    selection from the raw overlaps of the stored states (rows sel_{l-1} of
    <w_{l-1} | w_l>), SVD polar factors W_l of the selected blocks A_l,
    their prefix products C_l = C_{l-1} W_l, then conj(C_l) w_{sel_l}.
    Returns what ``transport._follow_plain`` returns."""
    from pythtb_tpu_torch.ops import berry

    outer, L, inner, NS, F = w5.shape
    nocc = len(occ)
    sel = torch.as_tensor(occ, dtype=torch.int64).expand(outer, inner, nocc)
    idx, fid, W = [sel], [], []
    for l in range(1, L):
        O = torch.gather(berry._overlap(w5[:, l - 1], w5[:, l]), 2, sel[..., None].expand(outer, inner, nocc, NS))
        sel, topw = transport._top_sorted((O.abs() ** 2).sum(dim=-2), nocc)
        W.append(transport._polar(torch.gather(O, 3, sel[:, :, None, :].expand(outer, inner, nocc, nocc)))[0])
        idx.append(sel)
        fid.append(topw.sum(dim=-1) / nocc)
    C = [torch.eye(nocc, dtype=w5.dtype).expand(outer, inner, nocc, nocc)]
    for w in W:
        C.append(C[-1] @ w)
    states = [C[l].conj() @ torch.gather(w5[:, l], 2, idx[l][..., None].expand(outer, inner, nocc, F))
              for l in range(L)]
    fid = torch.stack(fid).reshape(L - 1, outer * inner) if fid else torch.zeros((0, outer * inner),
                                                                                  dtype=torch.float64)
    return torch.stack(idx).reshape(L, outer * inner, nocc), fid, torch.stack(states, dim=1)


def _tie_frames():
    """Two points of four orthonormal states where the start state splits
    evenly over stored states 0 and 1 of the second point."""
    e = np.eye(4, dtype=complex)
    st = np.stack([e, e])
    st[1, 0] = (e[0] + e[1]) / np.sqrt(2)
    st[1, 1] = (e[0] - e[1]) / np.sqrt(2)
    return st


# (states, nspin, dim_arr, occ, axis) of each case
SPLIT_ORDER = {
    "haldane": lambda: (_solved(jzoo.haldane(), [9, 7]), 1, 2, [0], 0),
    "kane_mele": lambda: (_solved(jzoo.kane_mele(), [9, 7]), 2, 2, [0, 1], 0),
    "frames_12_6": lambda: (_orthonormal_frames(12, (9, 7), 12, 14), 1, 2, list(range(6)), 0),
    "frames_20_10": lambda: (_orthonormal_frames(20, (9, 7), 20, 22), 1, 2, list(range(10)), 1),
    "ties": lambda: (_tie_frames(), 1, 1, [0], 0),
}


@pytest.mark.parametrize("case", list(SPLIT_ORDER))
def test_follow_in_the_scan_designs_order_matches_plain_and_jax(case):
    """The identity kernel 14's scan design rests on: the selection from
    the raw overlaps of the stored states, the polar factors of the
    selected blocks and their prefixes give the plain scan's indices
    exactly, and its fidelity and states within 1e-12; and pythtb_tpu's
    (an exact tie stays exact in the raw basis)."""
    st, nspin, dim_arr, occ, axis = SPLIT_ORDER[case]()
    w5, grid = transport._strings(torch.as_tensor(st), nspin, dim_arr, axis)
    idx, fid, states = _follow_split_order(w5, occ)
    ip, fp, sp = transport._follow_plain(w5, transport._occ_tensor(occ, w5.device))
    assert torch.equal(idx, ip)
    assert float((fid - fp).abs().max()) <= TOL and float((states - sp).abs().max()) <= TOL
    ji, jf, js = jtransport.follow_states(np.asarray(pack_cplx(st)), occ, axis, nspin, dim_arr)
    js = np.asarray(js)
    rest = grid[:axis] + grid[axis + 1:]
    assert np.array_equal(idx.reshape((grid[axis],) + rest + (len(occ),)).numpy(), np.asarray(ji))
    assert np.abs(fid.reshape((grid[axis] - 1,) + rest).numpy() - np.asarray(jf)).max() <= TOL
    want = (js[..., 0] + 1j * js[..., 1]).reshape(grid + (len(occ), -1))
    assert np.abs(states.reshape(want.shape).numpy() - want).max() <= TOL
    if case == "ties":
        assert idx[1, 0, 0] == 0 and abs(float(fid[0, 0]) - 0.5) <= 1e-15


def test_follow_path_dispatch():
    """The designs of kernel 14's follow phases on the H100 (132 SMs,
    232,448 bytes of shared memory a block): a pair for every NS 1-64 and
    nocc 1-NS -- the polar factors on the chain's line, the states on the
    rotate's past its register path -- at the slab, the pump and Kane-Mele
    as PERF.md records them; more than 64 states, nocc 0 or nocc above NS
    are refused before any launch."""
    for NS in range(1, 65):
        for nocc in range(1, NS + 1):
            polar, states = transport._follow_path(NS, nocc, NS + 2, 41, 41, 132, 232448)
            assert polar == ("block" if transport._chain_path(nocc, 41, 41, 132) == "block" else "warp")
            assert states in ("warp", "team", "split")
    assert transport._follow_path(39, 20, 39, 41, 41, 132, 232448) == ("warp", "split")  # the slab
    # the pump along lambda and k, Kane-Mele 41^2 (nspin 2), random 9 x 7 frames at NS 64
    assert [transport._follow_path(NS, nocc, F, s, L, 132, 232448) for NS, nocc, F, s, L in
            ((3, 1, 3, 31, 41), (3, 1, 3, 41, 31), (4, 2, 4, 41, 41), (64, 62, 68, 7, 9))] == \
        [("warp", "warp")] * 3 + [("block", "split")]
    for NS, nocc in ((65, 1), (4, 0), (4, 5)):
        with pytest.raises(ValueError, match="1 <= nocc <= NS <= 64"):
            transport._follow_path(NS, nocc, NS, 41, 41, 132, 232448)
