"""The port's exact diagonalization (``ed``) against pythtb_tpu's, on the
CPU in float64, where kernel 11b, kernels 3-4, kernel 7 and kernel 16
run their plain versions.

Same models and inputs through both packages; gauge-invariant outputs
only: the sector machinery exactly, eigenvalues, energies, densities,
double occupancies, spin correlations, S^2, spectral functions and
susceptibilities at 1e-10 (relative to the largest entry where they are
functions of omega), one step of kernel 11b's plain filter against the
JAX program at 1e-12 of each column's largest entry and the whole p = 30
filter at 1e-10, many-body Chern numbers and twist Berry phases at
1e-10 (and the U = 0 Chern number against flows.chern_number).
"""

import numpy as np
import pytest
import torch

import pythtb_tpu as jpt
from pythtb_tpu import ed as jed
from pythtb_tpu import flows as jflows
from pythtb_tpu.models import library as jzoo
from pythtb_tpu.utils.xfer import host_pack
from pythtb_tpu_torch import ed
from pythtb_tpu_torch.ops import chebyshev

from .test_torch_ops import carry, on_cpu  # noqa: F401  (autouse: the port on the CPU)

TOL = 1e-10


def _ring(L, glue=True):
    ch = jpt.tb_model(1, 1, [[1.0]], [[0.0]])
    ch.set_hop(-1.0, 0, 0, [1])
    return ch.cut_piece(L, 0, glue_edgs=glue)


def _close(got, want, tol=TOL, rel=False):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max())) if rel else 1.0
    assert float(np.abs(got - want).max()) <= tol * scale


def test_sector_machinery_matches_jax():
    rng = np.random.default_rng(0)
    n = 6
    h = rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n))
    h = h + h.conj().T
    V = rng.normal(size=(n, n))
    V = V + V.T
    np.fill_diagonal(V, 0.0)
    for ne in (0, 2, 3):
        basis = ed.sector_basis(n, ne)
        assert np.array_equal(basis, jed.sector_basis(n, ne))
        assert np.array_equal(ed.build_sector(h, basis, V), jed.build_sector(h, basis, V))
    for jm in (_ring(5), jzoo.kane_mele().cut_piece(2, 0).cut_piece(1, 1)):
        assert np.array_equal(ed.dense_h(carry(jm)), jed.dense_h(jm))


@pytest.mark.parametrize("L,U,nup,ndn", [(4, 2.0, 2, 2), (6, 4.0, 3, 3), (5, 3.0, 3, 2)])
def test_hubbard_matches_jax(L, U, nup, ndn):
    jm = _ring(L)
    a = jed.hubbard(jm, U, nup, ndn)
    b = ed.hubbard(carry(jm), U, nup, ndn)
    _close(b.evals, a.evals)
    assert abs(b.gap - a.gap) <= TOL
    for obs in ("densities", "double_occupancy", "szsz"):
        _close(getattr(b, obs)(), getattr(a, obs)())
    _close(np.real(b.one_body_rdm()), np.real(a.one_body_rdm()))
    assert abs(b.total_spin() - a.total_spin()) <= TOL


def test_general_layout_and_ground_state_match_jax():
    jm = _ring(4)
    inter = [(0.7, 0, 1), (0.3, 1, 3)]
    a = jed.solve(jm, 3, U=2.0, interactions=inter)
    b = ed.solve(carry(jm), 3, U=2.0, interactions=inter)
    _close(b.evals, a.evals)
    _close(b.densities(), a.densities())
    _close(b.double_occupancy(), a.double_occupancy())
    # an explicit-spin model: spin-orbit hopping, no Sz conservation
    km = jzoo.kane_mele().cut_piece(2, 0).cut_piece(1, 1)
    a = jed.solve(km, 4, U=1.5)
    b = ed.solve(carry(km), 4, U=1.5)
    _close(b.evals, a.evals)
    _close(b.szsz(), a.szsz())
    a = jed.ground_state(jm, 4, U=3.0)
    b = ed.ground_state(carry(jm), 4, U=3.0)
    assert (b._meta["nup"], b._meta["ndn"]) == (a._meta["nup"], a._meta["ndn"])
    assert abs(b.energy - a.energy) <= TOL


def _sector_h(L=6, U=4.0):
    """The half-filled Hubbard sector of an L-ring (D = C(L, L/2)^2), the
    matrix ed.hubbard builds."""
    h = jed.dense_h(_ring(L))
    bu = jed.sector_basis(L, L // 2)
    T = jed.build_sector(h, bu)
    D1 = len(bu)
    H = np.kron(T, np.eye(D1)) + np.kron(np.eye(D1), T)
    occ = jed._occupations(bu, L)
    H[np.diag_indices(D1 * D1)] += U * np.einsum("ui,di->ud", occ, occ).reshape(-1)
    return H


@pytest.mark.parametrize("p", [1, 2, 30])
def test_dense_filter_plain_matches_jax_program(p):
    """Kernel 11b's plain version against ed._chebfilter_dev on the
    6-ring's D 400 sector: one step (p 1, 2) at 1e-12 of each column's
    largest entry, the whole p = 30 filter at 1e-10."""
    H = _sector_h()
    rng = np.random.default_rng(p)
    X = rng.standard_normal((H.shape[0], 10)) + 1j * rng.standard_normal((H.shape[0], 10))
    radii = np.sum(np.abs(H), axis=1) - np.abs(np.diag(H))
    hi, lo = float(np.max(np.diag(H).real + radii)), float(np.min(np.diag(H).real - radii))
    cut = lo + 0.1 * (hi - lo)
    c, hw = 0.5 * (cut + hi), 0.5 * (hi - cut)
    want = np.asarray(jed._chebfilter_dev(host_pack(H), host_pack(X), p, c, hw))
    want = want[..., 0] + 1j * want[..., 1]
    got = chebyshev.dense_filter(torch.as_tensor(H), torch.as_tensor(X), p, c, hw).numpy()
    tol = 1e-12 if p <= 2 else 1e-10
    assert np.all(np.abs(got - want).max(axis=0) <= tol * np.abs(want).max(axis=0))


def test_dense_filter_dispatch():
    """Kernel 11b's design and its split of H's columns at the shapes
    PERF.md records (the H100's 132 SMs, 227 kB of shared memory a block):
    the CUDA cores below D 1,024 (the 6-ring's sectors), the tensor design
    from there, 8 / 16 / 32 columns a block, one block an SM, slices that
    fill the SMs in one wave (117 blocks at the Hubbard row); a CPU tensor
    runs the plain version whatever design is asked, and an unknown design
    is refused."""
    assert [chebyshev._dense_design(D, 10) for D in (400, 924, 1023, 1024, 1400, 4900)] == [
        "cores", "cores", "cores", "tensor", "tensor", "tensor"]
    assert [chebyshev._dense_tc_columns(nb) for nb in (1, 8, 10, 16, 17, 32)] == [8, 8, 16, 16, 32, 32]
    assert [chebyshev._dense_tc_fit(nb, 232448) for nb in (1, 10, 32)] == [1, 1, 1]
    assert chebyshev._dense_tc_slices(4900, 10, 132, 232448) == (3, 1664)
    assert chebyshev._dense_tc_slices(4901, 32, 132, 232448) == (3, 1664)
    assert chebyshev._dense_tc_slices(400, 10, 132, 232448) == (3, 160)
    assert chebyshev._dense_tc_slices(924, 10, 132, 232448) == (6, 160)
    assert chebyshev._dense_slices(4900, 10, 132) == (14, 352)
    rng = np.random.default_rng(3)
    A = rng.standard_normal((12, 12)) + 1j * rng.standard_normal((12, 12))
    H = torch.as_tensor(A + A.conj().T)
    X = torch.as_tensor(rng.standard_normal((12, 3)) + 1j * rng.standard_normal((12, 3)))
    want = chebyshev._dense_filter_plain(H, X, 4, 0.5, 9.0)
    for design in (None,) + chebyshev._DENSE_DESIGNS:
        assert torch.equal(chebyshev._dense_filter(H, X, 4, 0.5, 9.0, design), want)
    with pytest.raises(ValueError, match="no 'warp' design"):
        chebyshev._dense_filter(H, X, 4, 0.5, 9.0, "warp")


def test_solve_sector_lowest_matches_jax():
    """The spectrum-slice path: the same start block and re-pads (host
    generator), so the same Ritz values; product and spinful general
    layouts."""
    jm = _ring(6)
    a = jed.hubbard(jm, 4.0, 3, 3, lowest=4)
    b = ed.hubbard(carry(jm), 4.0, 3, 3, lowest=4)
    _close(b.evals, a.evals)
    _close(b.double_occupancy(), a.double_occupancy())
    _close(b.evals, ed.hubbard(carry(jm), 4.0, 3, 3).evals[:4])
    a = jed.solve(jm, 4, U=2.0, lowest=3)
    b = ed.solve(carry(jm), 4, U=2.0, lowest=3)
    _close(b.evals, a.evals)


def test_spectral_function_and_susceptibility_match_jax():
    jm = _ring(4)
    om = np.linspace(-5.0, 7.0, 61)
    A, info = ed.spectral_function(carry(jm), 4, om, U=2.0, eta=0.15, modes=[0, 1])
    JA, jinfo = jed.spectral_function(jm, 4, om, U=2.0, eta=0.15, modes=[0, 1])
    _close(A, JA, rel=True)
    assert abs(info["e0"] - jinfo["e0"]) <= TOL
    n0 = np.zeros((8, 8))
    n0[0, 0] = n0[1, 1] = 1.0
    sz1 = np.zeros((8, 8))
    sz1[2, 2], sz1[3, 3] = 0.5, -0.5
    chi = ed.dynamic_susceptibility(carry(jm), 4, n0, sz1 + n0, om, U=2.0, eta=0.1)
    jchi = jed.dynamic_susceptibility(jm, 4, n0, sz1 + n0, om, U=2.0, eta=0.1)
    _close(chi, jchi, rel=True)


def test_many_body_chern_matches_jax_and_band_chern():
    jm = jzoo.haldane()
    pm = carry(jm)
    c = ed.many_body_chern(pm, (2, 2), nelec=4, grid=4)
    assert abs(c - jed.many_body_chern(jm, (2, 2), nelec=4, grid=4)) <= TOL
    # U = 0: the filled band's Chern number (orientation check)
    assert abs(c - jflows.chern_number(jm, occ=[0], nk=(31, 31))) < 1e-8
    assert abs(ed.many_body_chern(pm, (1, 1), nelec=1, grid=6)
               - jed.many_body_chern(jm, (1, 1), nelec=1, grid=6)) <= TOL
    v = [(0.5, 0, 1, (0, 0)), (0.5, 1, 0, (1, 0)), (0.5, 1, 0, (0, 1))]
    c = ed.many_body_chern(pm, (2, 2), nelec=4, interactions=v, grid=4)
    assert abs(c - jed.many_body_chern(jm, (2, 2), nelec=4, interactions=v, grid=4)) <= TOL
    # the spin doublet (q = 2, kernels 3-4 on two states): twice the band
    # Chern number; Hubbard u on the one-cell torus
    c = ed.many_body_chern(pm, (1, 1), nelec=1, spinful=True, multiplet=2, grid=6)
    assert abs(c - jed.many_body_chern(jm, (1, 1), nelec=1, spinful=True, multiplet=2, grid=6)) <= TOL
    assert abs(c + 2.0) < 1e-10
    c = ed.many_body_chern(pm, (1, 1), nelec=2, u=0.5, grid=6)
    assert abs(c - jed.many_body_chern(jm, (1, 1), nelec=2, u=0.5, grid=6)) <= TOL
    # Kane-Mele (nspin 2 amplitudes), the Kramers pair
    km = jzoo.kane_mele()
    assert abs(ed.many_body_chern(carry(km), (1, 1), nelec=2, grid=6)
               - jed.many_body_chern(km, (1, 1), nelec=2, grid=6)) <= TOL


def test_twist_berry_phase_and_resta_match_jax():
    inter = [(0.8, 0, 1, (0,)), (0.8, 1, 0, (1,))]
    for jm, ne, kw in ((jzoo.ssh(delta=-0.3), 3, {}), (jzoo.ssh(delta=0.3), 3, dict(interactions=inter)),
                       (jzoo.ssh(delta=0.3), 6, dict(u=1.0))):
        pm = carry(jm)
        a = jed.twist_berry_phase(jm, (3,), ne, grid=8, **kw)
        b = ed.twist_berry_phase(pm, (3,), ne, grid=8, **kw)
        assert abs(np.angle(np.exp(1j * (a - b)))) <= TOL
        # polarization is defined modulo 1 (+-1/2 are one value)
        a = jed.resta_polarization(jm, (3,), ne, **kw)
        b = ed.resta_polarization(pm, (3,), ne, **kw)
        assert abs((a - b + 0.5) % 1.0 - 0.5) <= TOL
