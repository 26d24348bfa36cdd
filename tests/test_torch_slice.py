"""The ported slice end to end against pythtb_tpu.

Models are built in pythtb_tpu (tests/zoo.py) and carried across with
pythtb_tpu_torch.convert; both packages then solve bands, fill wf_arrays
on device-built grids and compute Berry phases, Wilson-loop phases,
Berry fluxes and Chern numbers from the same numbers, on the CPU in
float64.  Eigenvalues agree to 1e-12; phases and fluxes, which sum
many link angles, to 1e-10 (phases modulo 2 pi).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import pythtb_tpu
import pythtb_tpu_torch
from pythtb_tpu import flows as jflows

from . import zoo
from .test_torch_ops import carry, on_cpu  # noqa: F401  (autouse: the port on the CPU)

PHASE_TOL = 1e-10
PATH = [[0.0, 0.0], [2.0 / 3.0, 1.0 / 3.0], [0.5, 0.5], [0.0, 0.0]]


def _wrapped(a, b):
    return np.abs(np.angle(np.exp(1j * (np.asarray(a) - np.asarray(b))))).max()


MODELS = {
    "haldane": lambda: zoo.haldane(pythtb_tpu),
    "kane_mele_odd": lambda: zoo.kane_mele(pythtb_tpu, "odd"),
    "kane_mele_bilayer": lambda: zoo.kane_mele_bilayer(pythtb_tpu, "odd", "even"),
}


@pytest.mark.parametrize("name", ["haldane", "kane_mele_odd"])
def test_solve_all_on_k_path(name):
    jm = MODELS[name]()
    pm = carry(jm)
    k_vec = jm.k_path(PATH, 41, report=False)[0]
    np.testing.assert_allclose(pm.solve_all(k_vec), jm.solve_all(k_vec), rtol=0, atol=1e-12)
    w, v = pm.solve_all(k_vec, eig_vectors=True)
    wj, vj = jm.solve_all(k_vec, eig_vectors=True)
    np.testing.assert_allclose(w, wj, rtol=0, atol=1e-12)
    flat = lambda x: x.reshape(x.shape[0], x.shape[1], -1)
    if jm._nspin == 1:
        # eigenvector gauges differ: compare the projector onto each
        # (non-degenerate) band; Kane-Mele bands are Kramers pairs
        proj = lambda x: np.einsum("bkf,bkg->bkfg", flat(x), flat(x).conj())
        np.testing.assert_allclose(proj(v), proj(vj), rtol=0, atol=1e-10)
    # states are rows: H v = w v at every k-point
    H = pm.gen_ham(k_vec)
    vf = flat(v)
    resid = np.einsum("kij,bkj->bki", H, vf) - w[:, :, None] * vf
    assert np.abs(resid).max() < 1e-11


@pytest.mark.parametrize("name", ["haldane", "kane_mele_odd", "kane_mele_bilayer"])
def test_wf_array_berry_slice(name):
    jm = MODELS[name]()
    pm = carry(jm)
    nk = 15
    jw, pw = pythtb_tpu.wf_array(jm, [nk, nk]), pythtb_tpu_torch.wf_array(pm, [nk, nk])
    gj, gp = jw.solve_on_grid([-0.5, -0.5]), pw.solve_on_grid([-0.5, -0.5])
    np.testing.assert_allclose(gp, gj, rtol=0, atol=1e-12)
    np.testing.assert_allclose(pw.energies, jw.energies, rtol=0, atol=1e-12)
    nocc = jm._nsta // 2
    occ = list(range(nocc))
    for d in (0, 1):
        for contin in (True, False):
            got = pw.berry_phase(occ, d, contin=contin)
            assert _wrapped(got, jw.berry_phase(occ, d, contin=contin)) < PHASE_TOL
        got = pw.berry_phase(occ, d, contin=False, berry_evals=True)
        want = jw.berry_phase(occ, d, contin=False, berry_evals=True)
        assert got.shape == want.shape == (nk, nocc)
        # compare as sets per string (degenerate phases may swap)
        for g, wv in zip(got, want):
            for x in wv:
                assert np.min(np.abs(np.angle(np.exp(1j * (g - x))))) < PHASE_TOL
    assert abs(pw.berry_flux(occ) - jw.berry_flux(occ)) < PHASE_TOL
    plaq = pw.berry_flux(occ, individual_phases=True)
    assert _wrapped(plaq, jw.berry_flux(occ, individual_phases=True)) < PHASE_TOL
    assert pw.band_separation(occ) == pytest.approx(jw.band_separation(occ), abs=1e-12)


def test_berry_flux_3d_planes():
    """A 3-D grid: fluxes over every plane orientation and traced phases
    along each axis (the rank-3 loops of the reference)."""
    lat = np.eye(3)
    orb = [[0.0, 0.0, 0.0], [0.5, 0.5, 0.5]]
    jm = pythtb_tpu.tb_model(3, 3, lat, orb)
    jm.set_onsite([-0.7, 0.7])
    jm.set_hop(-1.0, 0, 1, [0, 0, 0])
    jm.set_hop(-0.3, 0, 1, [-1, 0, 0])
    jm.set_hop(-0.25, 0, 1, [0, -1, 0])
    jm.set_hop(0.1j, 0, 0, [1, 0, 0])
    jm.set_hop(-0.1j, 1, 1, [0, 0, 1])
    pm = carry(jm)
    jw, pw = pythtb_tpu.wf_array(jm, [5, 6, 4]), pythtb_tpu_torch.wf_array(pm, [5, 6, 4])
    jw.solve_on_grid([0.0, 0.0, 0.0])
    pw.solve_on_grid([0.0, 0.0, 0.0])
    for dirs in ([0, 1], [1, 2], [0, 2], [2, 0]):
        assert _wrapped(pw.berry_flux([0], dirs=dirs), jw.berry_flux([0], dirs=dirs)) < PHASE_TOL
    for d in range(3):
        assert _wrapped(pw.berry_phase([0], d), jw.berry_phase([0], d)) < PHASE_TOL


def test_chern_number_31x31():
    jm = zoo.haldane(pythtb_tpu)
    pm = carry(jm)
    c = pythtb_tpu_torch.flows.chern_number(pm, [0], nk=(31, 31))
    assert abs(c - jflows.chern_number(jm, [0], nk=(31, 31))) < 1e-10
    assert abs(c + 1.0) < 1e-9
    # the fused flow equals the wf_array route
    wf = pythtb_tpu_torch.wf_array(pm, [31, 31])
    wf.solve_on_grid([-0.5, -0.5])
    assert abs(wf.berry_flux([0]) / (2.0 * np.pi) - c) < 1e-10


def test_host_view_aliasing():
    """wf[key] hands out a live NumPy view: writes through it after a
    device solve must reach the next Berry computation, in both packages."""
    jm = zoo.haldane(pythtb_tpu)
    pm = carry(jm)
    jw, pw = pythtb_tpu.wf_array(jm, [11, 11]), pythtb_tpu_torch.wf_array(pm, [11, 11])
    jw.solve_on_grid([-0.5, -0.5])
    pw.solve_on_grid([-0.5, -0.5])
    # per-plaquette phases: the total over the torus stays quantized
    flux = lambda w: w.berry_flux([0], individual_phases=True)
    before = flux(pw)
    jv, pv = jw[3, 4], pw[3, 4]
    rot = np.exp(0.7j) * np.array([[0.6, 0.8], [-0.8, 0.6]])  # mixes bands 0 and 1
    jv[:] = rot @ jv
    pv[:] = rot @ pv
    after = flux(pw)
    assert _wrapped(after, before) > 1e-3
    assert _wrapped(after, flux(jw)) < PHASE_TOL
    # a fresh solve writes into the same buffer the view aliases
    pw.solve_on_grid([-0.5, -0.5])
    assert _wrapped(flux(pw), before) < PHASE_TOL
    assert np.shares_memory(pv, pw._host)


def _peierls_flake(mod, n=12):
    """The bench-suite KPM flake (square lattice, flux 1/9 along the cut) at n x n."""
    return mod.magnetic.peierls_model(mod.models.square().cut_piece(n, 0), 1.0 / 9.0).cut_piece(n, 1)


def _chebyshev_gauss_integral(fn, a, b, K=256):
    """Integral of a KPM density over its whole window by Chebyshev-Gauss
    quadrature on K nodes: exact for the degree-M polynomials of KPM
    (M < 2K), so it returns mu_0 to round-off."""
    et = np.cos(np.pi * (np.arange(K) + 0.5) / K)
    e, dens = fn(a * et + b)
    return a * np.pi / K * np.sum(dens * np.sqrt(1.0 - et**2), axis=-1)


def test_matrix_free_slice_matches_jax(monkeypatch):
    """The slice's public calls on a 12 x 12 Peierls flake (kpm_dos,
    evolve, kpm_ldos) and a 6 x 6 Haldane torus (kpm_conductivity).
    Deterministic outputs agree with pythtb_tpu's; the stochastic DOS of
    each package (its own draws) integrates to N exactly, and on JAX's
    draws the port's moments and conductivity equal JAX's."""
    import jax

    from pythtb_tpu import dynamics as jdynamics
    from pythtb_tpu import realspace as jrealspace
    from pythtb_tpu.ops import matvec as jmatvec
    from pythtb_tpu_torch import dynamics, realspace
    from pythtb_tpu_torch.ops import chebyshev, matvec

    jf, pf = _peierls_flake(pythtb_tpu), _peierls_flake(pythtb_tpu_torch)
    N = jf._nsta
    h = matvec.sparse_h(pf)
    lo, hi = h.window
    a, b = 0.5 * (hi - lo) / 0.98 + 1e-12, 0.5 * (hi + lo)
    for kpm, model in ((jflows.kpm_dos, jf), (pythtb_tpu_torch.flows.kpm_dos, pf)):
        total = _chebyshev_gauss_integral(
            lambda e: kpm(model, energies=e, num_moments=128, num_vectors=4), a, b)
        assert abs(total - N) < 1e-8 * N
    key = jax.random.PRNGKey(0)
    x0 = np.exp(1j * np.asarray(jax.random.uniform(key, (N, 4), minval=0.0, maxval=2.0 * np.pi)))
    want = np.asarray(jflows._kpm_moments_jit(jmatvec.sparse_h(jf), a, b, key, 128, 4))
    got = pythtb_tpu_torch.flows._kpm_moments(h, a, b, torch.as_tensor(x0), 128).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10 * N)

    p0 = np.zeros(N, complex)
    p0[N // 2] = 1.0
    for times in (np.linspace(0.5, 10.0, 20), np.linspace(0.2, 4.0, 20)):
        np.testing.assert_allclose(dynamics.evolve(pf, p0, times), jdynamics.evolve(jf, p0, times),
                                   rtol=0, atol=1e-11)
    sites = np.concatenate([np.arange(4), 70 + np.arange(4)])
    np.testing.assert_allclose(realspace.kpm_ldos(pf, sites, num_moments=128)[1],
                               jrealspace.kpm_ldos(jf, sites, num_moments=128)[1], rtol=0, atol=1e-10)

    jm = zoo.haldane(pythtb_tpu)
    js = jrealspace.torus_sample(jm, (6, 6), onsite_disorder=1.0, seed=2)
    ps = realspace.torus_sample(carry(jm), (6, 6), onsite_disorder=1.0, seed=2)

    def jax_draws(nsta, R, seed, device):
        keys = jax.random.split(jax.random.PRNGKey(seed), R)
        x = np.stack([np.exp(1j * np.asarray(jax.random.uniform(k, (nsta,), minval=0.0, maxval=2.0 * np.pi)))
                      for k in keys], axis=1)
        return torch.as_tensor(x).to(device)

    monkeypatch.setattr(chebyshev, "phase_vectors", jax_draws)
    ej, sj = jrealspace.kpm_conductivity(js, dirs=(0, 1), num_moments=128, num_vectors=4)
    ep, sp = realspace.kpm_conductivity(ps, dirs=(0, 1), num_moments=128, num_vectors=4)
    np.testing.assert_allclose(sp, sj, rtol=0, atol=1e-10 * np.abs(sj).max())


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code):
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_import_pulls_in_no_jax():
    _run("import sys, pythtb_tpu_torch; assert 'jax' not in sys.modules, sorted(sys.modules)")


def test_no_module_of_the_port_needs_jax():
    """Every module of the port, and chip_smoke.py, imports with jax and
    pythtb_tpu blocked (a None entry in sys.modules makes import raise)."""
    _run(
        "import importlib, pkgutil, sys\n"
        "for name in ('jax', 'jaxlib', 'pythtb_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import pythtb_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(pythtb_tpu_torch.__path__, 'pythtb_tpu_torch.')]\n"
        "assert len(names) >= 24 and 'pythtb_tpu_torch.models.library' in names, names\n"
        "for name in names + ['chip_smoke']:\n"
        "    importlib.import_module(name)\n"
    )


def test_the_card_is_the_default_device():
    """With nothing chosen the port targets the CUDA device; without one,
    the first upload raises an error naming set_device("cpu") instead of
    computing on the CPU."""
    _run(
        "import io, contextlib, torch\n"
        "import pythtb_tpu_torch as pt\n"
        "from pythtb_tpu_torch import config\n"
        "assert config.device().type == 'cuda', config.device()\n"
        "with contextlib.redirect_stdout(io.StringIO()):\n"
        "    m = pt.tb_model(1, 1, [[1.0]], [[0.0]])\n"
        "m.set_hop(-1.0, 0, 0, [1])\n"
        "if not torch.cuda.is_available():\n"
        "    try:\n"
        "        m.solve_all([[0.1]])\n"
        "    except RuntimeError as exc:\n"
        "        assert 'set_device(\"cpu\")' in str(exc), exc\n"
        "    else:\n"
        "        raise AssertionError('solve_all ran without a card')\n"
        "config.set_device('cpu')\n"
        "assert abs(m.solve_all([[0.1]])[0, 0] + 2 * __import__('math').cos(0.2 * __import__('math').pi)) < 1e-12\n"
    )
