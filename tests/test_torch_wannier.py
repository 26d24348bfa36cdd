"""The port's Wannier interpolation (``wannier``) against pythtb_tpu's, on
the CPU in float64, where kernel 19 runs its plain version.

Models are built in pythtb_tpu and carried across with
``convert.tb_model_from_state``; raw overlaps are built once in NumPy and
fed to both packages' Marzari-Vanderbilt code, since the MV trajectory
depends on its inputs' gauge.  Tolerances: b-shells identical; one MV
step 1e-12; gauge-invariant build outputs (bands, grid energies,
projection singular values, one-shot hoppings) 1e-10; whole MV runs
Omega_I, Omega and the spread history 1e-10 relative, the centres 1e-8
(PERF.md section 2).  The oracles of
tests/test_wannier.py run on the port at small grids (nk <= 8, <= 50 MV
steps).
"""

import pathlib
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pythtb_tpu import w90 as jw90
from pythtb_tpu import wannier as jwannier
from pythtb_tpu.models import library as jzoo
from pythtb_tpu_torch import PythtbError, convert, models, tb_model, w90, wannier

from .test_torch_ops import carry, on_cpu  # noqa: F401  (autouse: the port on the CPU)

W90_DIR = str(pathlib.Path(__file__).resolve().parent / "data" / "w90_silicon")
TOL = 1e-10


def _t(x, dtype=None):
    return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype)


def _both(fn_j, fn_t, model, *args, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn_j(model, *args, **kw), fn_t(carry(model), *args, **kw)


def _silicon():
    return jw90(W90_DIR, "silicon").model(min_hopping_norm=0.01)


SHELL_CASES = [
    (np.eye(3), [0, 1, 2], (4, 4, 4)),
    ([[0.0, 2.7, 2.7], [2.7, 0.0, 2.7], [2.7, 2.7, 0.0]], [0, 1, 2], (6, 6, 6)),
    ([[1.0, 0.0], [0.5, np.sqrt(3) / 2]], [0, 1], (6, 6)),
    ([[1.0]], [0], (8,)),
    ([[1.0, 0.0], [0.0, 2.3]], [0, 1], (6, 4)),
    (np.eye(3), [0, 1], (5, 5)),
]


@pytest.mark.parametrize("case", range(len(SHELL_CASES)))
def test_bshells_identical_and_complete(case):
    """The b-shells and neighbour tables equal the JAX package's exactly,
    and satisfy the B1 completeness condition."""
    lat, per, nk = SHELL_CASES[case]
    got = wannier._bshells(lat, per, nk)
    want = jwannier._bshells(lat, per, nk)
    for a, b in zip(got, want):
        assert np.array_equal(a, b)
    b_int, b_cart, w_b = got
    assert np.array_equal(wannier._neighbor_index(nk, b_int), jwannier._neighbor_index(nk, b_int))
    A = np.asarray(lat, dtype=float)[per, :]
    G = 2 * np.pi * np.linalg.solve(A @ A.T, A)
    Q = np.linalg.svd(G, full_matrices=False)[2]
    bq = b_cart @ Q.T
    np.testing.assert_allclose(np.einsum("b,bi,bj->ij", w_b, bq, bq), np.eye(len(per)), atol=1e-8)


def _overlaps(model, occ, nk, trial=None):
    """Rotated raw overlaps M0 of a band group, built with pythtb_tpu
    (NumPy), and the shells: the common input of both MV codes."""
    data = carry(model)._get_finalized()
    t = _t(wannier.WannierInterpolator._t_orb(model), torch.float64)
    _, _, u = wannier._grid_solve(data, nk, t)
    u = u[:, occ]
    g = _t(np.eye(data.nsta)[occ] if trial is None else trial, torch.complex128)
    V0, _ = wannier._project_gauge(u, g, False)
    nbr, w_b, b_cart = wannier._shells_on(model, nk, torch.device("cpu"))
    return wannier._rotated_overlaps(u, V0, nbr).numpy(), nbr.numpy(), w_b.numpy(), b_cart.numpy()


def _random_overlaps(seed, B, nb, n, dc):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(B, nb, n, n)) + 1j * rng.normal(size=(B, nb, n, n))
    u, _, vh = np.linalg.svd(np.eye(n) + 0.2 * X)
    M0 = (u @ vh) * 0.97  # a polar factor near the identity
    return M0, rng.integers(0, B, (B, nb)), rng.uniform(0.5, 2.0, nb), rng.normal(size=(nb, dc)) * 0.3


def _jax_mv(M0, nbr, w_b, b_cart, steps):
    U, hist, (rbar, oi, ot) = jwannier._mv_localize(
        jnp.asarray(M0), jnp.asarray(nbr), jnp.asarray(w_b), jnp.asarray(b_cart), steps, 0.5)
    return np.asarray(U), np.asarray(hist), np.asarray(rbar), float(oi), float(ot)


def _port_mv(M0, nbr, w_b, b_cart, steps):
    U, hist, (rbar, oi, ot) = wannier.mv_localize(*convert.wannier_inputs_from_numpy(M0, nbr, w_b, b_cart), steps, 0.5)
    return U.numpy(), hist.numpy(), rbar.numpy(), float(oi), float(ot)


@pytest.mark.parametrize("case", ["silicon4", "bn6", "random_n1_dc2", "random_n3_dc3", "random_n8_dc3"])
def test_mv_single_step_matches_jax(case):
    """One MV step (gauge overlaps, spreads, bold driver, gradient,
    exp(dW), U update) and the closing spreads against pythtb_tpu's
    _mv_localize(steps=1): 1e-12."""
    if case == "silicon4":
        args = _overlaps(_silicon(), [0, 1, 2, 3], (4, 4, 4), np.eye(8)[:4])
    elif case == "bn6":
        args = _overlaps(jzoo.bn(), [0], (6, 6))
    else:
        n, dc = int(case[8]), int(case[-1])
        args = _random_overlaps(300 + n, 36, 6, n, dc)
    got, want = _port_mv(*args, 1), _jax_mv(*args, 1)
    for a, b in zip(got, want):
        assert np.abs(np.asarray(a) - np.asarray(b)).max() <= 1e-12 * max(1.0, np.abs(b).max())


def test_mv_step_unit_matches_plain_run():
    """``mv_step`` (the unit the card checks) equals the first step of the
    plain run, from the start and after an overshoot."""
    M0, nbr, w_b, b_cart = (_t(x) for x in _random_overlaps(310, 27, 6, 3, 3))
    nbr = nbr.to(torch.int64)
    eps0 = 0.5 / (4.0 * float(w_b.sum()))
    U = torch.eye(3, dtype=torch.complex128).expand(27, 3, 3)
    dW = torch.zeros_like(U)
    U1, dW1, eps1, om1 = wannier.mv_step(M0, nbr, w_b, b_cart, U, dW, eps0, float("inf"), eps0)
    Ur, hist, _ = wannier._mv_run_plain(M0, nbr, w_b, b_cart, 1, eps0)
    assert torch.equal(U1, Ur) and float(om1) == float(hist[0])
    assert abs(float(eps1) - 1.1 * eps0) <= 1e-15
    # overshoot: eps halves and the momentum resets
    _, dW2, eps2, _ = wannier.mv_step(M0, nbr, w_b, b_cart, U1, dW1, float(eps1), -1.0, eps0)
    assert abs(float(eps2) - 0.5 * float(eps1)) <= 1e-15
    G = dW2 / float(eps2)
    assert torch.allclose(G, -G.conj().transpose(-1, -2), atol=1e-12)


@pytest.mark.parametrize("case,steps", [("bn6", 20), ("silicon4", 50)])
def test_mv_whole_run_matches_jax(case, steps):
    """Whole MV runs on identical overlaps: Omega_I (gauge invariant),
    the final Omega and the history at 1e-10 relative, the centres at
    1e-8 (measured: 3e-15 relative on silicon 4^3 over 50 steps, the
    centres 6e-10 apart after 200)."""
    if case == "bn6":
        args = _overlaps(jzoo.bn(), [0], (6, 6))
    else:
        args = _overlaps(_silicon(), [0, 1, 2, 3], (4, 4, 4), np.eye(8)[:4])
    _, hist, rbar, oi, ot = _port_mv(*args, steps)
    _, jhist, jrbar, joi, jot = _jax_mv(*args, steps)
    assert abs(oi - joi) <= 1e-10 * abs(joi)
    assert abs((oi + ot) - (joi + jot)) <= 1e-10 * abs(joi + jot)
    assert np.abs(hist - jhist).max() <= 1e-10 * np.abs(jhist).max()
    assert np.abs(rbar - jrbar).max() <= 1e-8 * max(1.0, np.abs(jrbar).max())
    assert hist[-1] < hist[0]


def test_gradient_is_descent_direction():
    """The MV update direction +G decreases the spread (BBH, 6 x 6)."""
    M0, nbr, w_b, b_cart = (_t(x) for x in _overlaps(jzoo.bbh(), [0, 1], (6, 6)))
    nbr = nbr.to(torch.int64)
    U = torch.eye(2, dtype=torch.complex128).expand(M0.shape[0], 2, 2)

    def omega(U):
        rbar, oi, ot = wannier._spread_terms(wannier._gauge_overlaps(M0, U, nbr), w_b, b_cart)
        return float(oi + ot), rbar

    om0, rbar = omega(U)
    G = wannier._mv_gradient(wannier._gauge_overlaps(M0, U, nbr), w_b, b_cart, rbar)
    for eps in (1e-3, 1e-2):
        assert omega(U @ wannier._expm_antiherm(eps * G))[0] < om0


KP = np.random.default_rng(5).random((9, 2))


@pytest.mark.parametrize("name,model,occ,kw", [
    ("one_shot_auto", jzoo.bn, [0], dict(nk=6)),
    ("one_shot_trial", jzoo.bn, [0], dict(nk=6, trial=np.array([[0.0, 1.0]]))),
    ("full_space", lambda: jzoo.graphene(delta=0.3), [0, 1], dict(nk=6, trial=np.eye(2))),
    ("spinful", lambda: jzoo.kane_mele(esite=2.5), [0, 1], dict(nk=6)),
    ("localize", jzoo.bn, [0], dict(nk=6, localize=20)),
    ("multigrid", jzoo.bn, [0], dict(nk=8, localize=20, coarse_nk=4, polish=5)),
])
def test_interpolator_matches_jax(name, model, occ, kw):
    """Interpolated bands, grid energies and projection singular values
    within 1e-10 of pythtb_tpu's (one-shot hoppings too: the polar
    projection fixes the gauge)."""
    a, b = _both(jwannier.interpolator, wannier.interpolator, model(), occ, **kw)
    assert np.abs(a.bands(KP) - b.bands(KP)).max() <= TOL
    assert np.abs(a.grid_energies - b.grid_energies).max() <= TOL
    assert abs(a.min_projection_sv - b.min_projection_sv) <= TOL
    assert np.array_equal(a.r_vectors(), b.r_vectors())
    if "localize" not in kw:
        # (auto trials of a Kramers pair are a degenerate eigenbasis: the
        # hoppings then differ by a rotation, the bands do not)
        if "trial" in kw or len(occ) == 1:
            assert np.abs(a.hoppings - b.hoppings).max() <= TOL
    else:
        assert abs(a.omega_i - b.omega_i) <= TOL * abs(a.omega_i)
        assert np.abs(a.spread_history - b.spread_history).max() <= TOL * np.abs(a.spread_history).max()
        assert abs(a.final_projection_sv - b.final_projection_sv) <= TOL


def _union(mod, coupled):
    m = mod.tb_model(2, 2, [[1.0, 0.0], [0.0, 1.0]], [[0.0, 0.0], [0.5, 0.5], [0.25, 0.75]])
    m.set_onsite([-1.2, 1.2, 0.0])
    for amp, i, j, R in [(0.4, 0, 1, [0, 0]), (0.35, 0, 1, [1, 0]), (0.27, 0, 1, [0, 1]),
                         (-0.15, 0, 0, [1, 0]), (0.12, 1, 1, [0, 1]), (1.3, 2, 2, [1, 0]), (1.1, 2, 2, [0, 1])]:
        m.set_hop(amp, i, j, R)
    if coupled:
        m.set_hop(0.2, 1, 2, [0, 0])
        m.set_hop(0.15, 0, 2, [1, 0])
    return m


def test_disentangled_matches_jax_and_recovers_the_block():
    """SMV disentanglement of a decoupled union: the port matches
    pythtb_tpu within 1e-10 and reproduces block A's bands exactly."""
    import pythtb_tpu

    trial = np.zeros((2, 3), complex)
    trial[0, 0] = trial[1, 1] = 1.0
    kw = dict(nw=2, nk=6, window=(-10, 10), trial=trial, dis_steps=30, localize=30)
    a, b = _both(jwannier.disentangled_interpolator, wannier.disentangled_interpolator,
                 _union(pythtb_tpu, False), **kw)
    assert np.abs(a.bands(KP) - b.bands(KP)).max() <= TOL
    assert abs(a.omega_i - b.omega_i) <= TOL * max(1.0, abs(a.omega_i))
    mA = tb_model(2, 2, [[1.0, 0.0], [0.0, 1.0]], [[0.0, 0.0], [0.5, 0.5]])
    mA.set_onsite([-1.2, 1.2])
    for amp, i, j, R in [(0.4, 0, 1, [0, 0]), (0.35, 0, 1, [1, 0]), (0.27, 0, 1, [0, 1]),
                         (-0.15, 0, 0, [1, 0]), (0.12, 1, 1, [0, 1])]:
        mA.set_hop(amp, i, j, R)
    assert np.abs(b.bands(KP) - mA.solve_all(KP)).max() < 1e-10


def test_disentangled_frozen_window_matches_jax():
    """A frozen window with genuine hybridization: the port's bands within
    1e-10 of pythtb_tpu's."""
    import pythtb_tpu

    trial = np.zeros((2, 3), complex)
    trial[0, 0] = trial[1, 1] = 1.0
    kw = dict(nw=2, nk=6, window=(-6, 6), frozen=(-2.2, -0.6), trial=trial, dis_steps=20, localize=20)
    a, b = _both(jwannier.disentangled_interpolator, wannier.disentangled_interpolator,
                 _union(pythtb_tpu, True), **kw)
    assert np.abs(a.bands(KP) - b.bands(KP)).max() <= TOL


def test_full_space_is_exact_and_recovers_hoppings():
    """Projecting onto the full state space reproduces H'(k): exact bands
    at any k and hoppings only on the actual bonds."""
    for m, nk in ((models.graphene(delta=0.3), 6), (models.trestle(), 8)):
        itp = wannier.interpolator(m, list(range(m._nsta)), nk=nk)
        assert np.abs(itp.bands(KP[:, :m._dim_k]) - m.solve_all(KP[:, :m._dim_k])).max() < 1e-12
        assert itp.min_projection_sv > 0.99
    itp = wannier.interpolator(models.graphene(delta=0.3), [0, 1], nk=6, trial=np.eye(2))
    hr, Rs = itp.hoppings, itp.r_vectors()
    assert np.abs(hr[np.abs(Rs).max(axis=1) > 1]).max() < 1e-12
    i0 = np.nonzero((Rs == 0).all(axis=1))[0][0]
    np.testing.assert_allclose(np.diag(hr[i0]).real, [-0.3, 0.3], atol=1e-12)


def test_exact_at_grid_points_and_downfold():
    """Bands exact at the coarse-grid points (one-shot and localized), and
    the downfolded model reproduces the interpolation."""
    m = models.checkerboard()
    kg = m.k_uniform_mesh((6, 6))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        itp = wannier.interpolator(m, [0, 1], nk=6, localize=40)
    np.testing.assert_allclose(itp.bands(kg), m.solve_all(kg), atol=1e-10)
    assert itp.spread_history[-1] <= itp.spread_history[0] + 1e-12
    for nk in (7, 8):  # odd (paired R grid) and even (boundary rows)
        eff = wannier.interpolator(models.graphene(delta=0.3), [0, 1], nk=nk).model()
        np.testing.assert_allclose(eff.solve_all(KP), models.graphene(delta=0.3).solve_all(KP), atol=1e-10)


def test_silicon_localize_reduces_spread_and_error():
    """Valence-only silicon at nk 4: 50 MV steps cut the spread and the
    interpolation error of the one-shot projection."""
    si = w90(W90_DIR, "silicon").model(min_hopping_norm=0.01)
    kp = si.k_path([[0.5, 0.5, 0.5], [0, 0, 0], [0.5, -0.5, 0.0]], 21, report=False)[0]
    direct = si.solve_all(kp)[:4]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        one = wannier.interpolator(si, [0, 1, 2, 3], nk=4, trial=np.eye(8)[:4])
        loc = wannier.interpolator(si, [0, 1, 2, 3], nk=4, trial=np.eye(8)[:4], localize=50)
    assert loc.spread_history[-1] < loc.spread_history[0]
    assert np.abs(loc.bands(kp) - direct).max() < np.abs(one.bands(kp) - direct).max()


def test_auto_trial_fallback_matches_jax():
    """Default trials on silicon valence degenerate; both packages fall
    back to the same greedy orbital anchors (min sv within 1e-10)."""
    a, b = _both(jwannier.interpolator, wannier.interpolator, _silicon(), [0, 1, 2, 3], nk=4)
    assert b.min_projection_sv > 0.3
    assert abs(a.min_projection_sv - b.min_projection_sv) <= TOL
    assert np.abs(a.hoppings - b.hoppings).max() <= TOL


def test_validation():
    with pytest.raises(PythtbError):
        wannier.interpolator(models.molecule_nh3(), [0], nk=4)
    with pytest.raises(IndexError):
        wannier.interpolator(models.bn(), [7], nk=4)
    with pytest.raises(PythtbError):
        wannier.interpolator(models.bn(), [0], nk=(4, 4, 4))
    import pythtb_tpu_torch

    m = _union(pythtb_tpu_torch, True)
    with pytest.raises(PythtbError, match="window"):
        wannier.disentangled_interpolator(m, nw=2, nk=4, window=(-1.4, -1.2))
    with pytest.raises(PythtbError, match="frozen"):
        wannier.disentangled_interpolator(m, nw=2, nk=4, window=(-6, 6), frozen=(-7, 0))


def _csrc_constant(name):
    """An ``int`` constexpr of csrc/mv_step.cu."""
    import re

    text = (pathlib.Path(wannier.__file__).resolve().parent / "csrc" / "mv_step.cu").read_text()
    return int(re.search(r"constexpr int %s = (\d+);" % name, text).group(1))


@pytest.mark.parametrize("B,nb,n,sms,want", [
    (512, 8, 4, 132, "grid"),   # the silicon row
    (512, 8, 1, 132, "grid"),
    (64, 12, 8, 132, "grid"),
    (36, 6, 3, 8, "grid"),
    (36, 6, 9, 132, "block"),   # the BN 3x3 supercell, nw 9
    (8, 6, 32, 132, "block"),
])
def test_mv_design_line(B, nb, n, sms, want):
    """Kernel 19's design as a function of (B, nb, nw, SM count): the run
    kernel to 8 Wannier functions, three block launches a step above."""
    assert wannier._mv_design(B, nb, n, sms) == want
    assert n <= wannier._MV_DESIGNS[want]


@pytest.mark.parametrize("B,want", [(1, 1), (4, 1), (5, 2), (64, 16), (512, 128), (4096, 1024)])
def test_mv_partial_sums_hold_every_block(B, want):
    """The run kernel's partial sums are sized for its largest grid: a
    k-point a warp, four warps a block, so B / 4 blocks at most."""
    assert wannier._mv_red_blocks(B) == want


def test_mv_run_sizes_match_the_kernel_source():
    """The wrapper's sizes are csrc/mv_step.cu's: warps a block of the run
    kernel, its largest nw, the partial sums a block, every phase, the
    block path's largest nw."""
    assert wannier._MV_GRID_WARPS == _csrc_constant("kMVGridWarps")
    assert wannier._MV_DESIGNS["grid"] == _csrc_constant("kMVRunMaxN")
    assert wannier._MV_RED_STRIDE == 3 * _csrc_constant("kMVRunMaxN") + 2 + 1
    assert wannier._MV_PHASES == _csrc_constant("kMVPhases")
    assert wannier._MV_DESIGNS["block"] == wannier._KERNEL_MAX_NW == _csrc_constant("kMVBlockMaxN")
