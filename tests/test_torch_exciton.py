"""The port's exciton module (pythtb_tpu_torch.exciton) against
pythtb_tpu.exciton on the CPU, in float64.

Energies and pair energies are held at 1e-10, absorption at 1e-10
relative.  Amplitudes and dipoles carry a phase per exciton and a basis
in each degenerate group (the valley doublets), so they are compared
through what is basis-free: oscillator strengths and |A|^2 summed over
each group of levels within 1e-8.  The W table (kernel 1's one-sided
mode), the pole weights fed to kernel 16, the plain versions of kernel
28's two modes and its element loop (emulated in NumPy) are held against
the JAX package's own functions; the BSE is held against the port's
exact diagonalization where the Tamm-Dancoff closure is exact.
"""

import numpy as np
import pytest
import torch

import pythtb_tpu
import pythtb_tpu_torch
from pythtb_tpu import exciton as jexciton
from pythtb_tpu_torch import exciton, optical
from pythtb_tpu_torch.ops import bse as kbse
from pythtb_tpu_torch.ops.hamiltonian import assemble_one_sided

from .test_torch_ops import on_cpu  # noqa: F401  (autouse: the port on the CPU)


def chain_ab(M, D=8.0, tB=0.7, tA=0.0, g=0.0, pos=(0.1, 0.4)):
    m = M.tb_model(1, 1, [[1.0]], [[pos[0]], [pos[1]]])
    m.set_onsite([0.0, D])
    if tB != 0.0:
        m.set_hop(tB, 1, 1, [1])
    if tA != 0.0:
        m.set_hop(tA, 0, 0, [1])
    if g != 0.0:
        m.set_hop(g, 0, 1, [0])
    return m


def bn_model(M, delta=0.7, t=-1.0):
    m = M.tb_model(2, 2, [[1.0, 0.0], [0.5, np.sqrt(3.0) / 2.0]], [[1.0 / 3.0, 1.0 / 3.0], [2.0 / 3.0, 2.0 / 3.0]])
    m.set_onsite([-delta, delta])
    m.set_hop(t, 0, 1, [0, 0])
    m.set_hop(t, 1, 0, [1, 0])
    m.set_hop(t, 1, 0, [0, 1])
    return m


def three_band(M):
    """A 3-orbital chain with two conduction bands and offset orbitals."""
    m = M.tb_model(1, 1, [[1.0]], [[0.0], [0.3], [0.55]])
    m.set_onsite([0.0, 5.0, 6.5])
    m.set_hop(0.4, 0, 0, [1])
    m.set_hop(0.6, 1, 2, [0])
    m.set_hop(-0.5, 1, 1, [1])
    m.set_hop(0.3 + 0.2j, 2, 2, [1])
    m.set_hop(0.2, 0, 1, [1])
    return m


def _bn_v(M, m):
    return M.exciton.radial_interaction(m, lambda r: 1.6 / (r + 0.5), 3.0)


CHAIN_V = [(0.8, 0, 1, (0,)), (0.3, 0, 1, (1,)), (0.3, 0, 1, (-1,)), (0.4, 0, 0, (1,)), (0.2, 1, 1, (2,))]
THREE_V = [(0.9, 0, 1, (0,)), (0.5, 0, 2, (0,)), (0.3, 1, 2, (1,)), (0.25, 0, 0, (1,))]

# (label, model, interaction, bse keywords)
CASES = {
    "bn_hf": (bn_model, _bn_v, dict(occ=[0], nk=(6, 6), qp="hf")),
    "bn_none": (bn_model, _bn_v, dict(occ=[0], nk=(6, 6), qp="none")),
    "bn_singlet_q": (bn_model, _bn_v, dict(occ=[0], nk=(6, 6), spin="singlet", Q=[1 / 6, 1 / 3])),
    "bn_triplet_scissor": (bn_model, _bn_v, dict(occ=[0], nk=(5, 4), spin="triplet", scissor=0.3)),
    "chain_hf_q": (chain_ab, lambda M, m: CHAIN_V, dict(occ=[0], nk=(8,), Q=[0.375])),
    "three_band_two_c": (three_band, lambda M, m: THREE_V, dict(occ=[0], nk=(7,), spin="singlet", Q=[2 / 7])),
    "three_band_cbands": (three_band, lambda M, m: THREE_V, dict(occ=[0], nk=(6,), cbands=[2], qp="none")),
}


def _run(name, M):
    build, inter, kw = CASES[name]
    m = build(M)
    return M.exciton.bse(m, inter(M, m), **kw)


def _groups(E, tol=1e-7):
    """Index groups of (near-)degenerate levels of an ascending E."""
    cuts = np.nonzero(np.diff(E) > tol)[0] + 1
    return np.split(np.arange(E.size), cuts)


@pytest.mark.parametrize("name", sorted(CASES))
def test_bse_matches_jax(name):
    """Energies and pair energies at 1e-10; oscillator strengths (every
    direction) and |A|^2 summed over each degenerate group at 1e-8."""
    rj, rt = _run(name, pythtb_tpu), _run(name, pythtb_tpu_torch)
    assert rt.energies.shape == rj.energies.shape
    np.testing.assert_allclose(rt.energies, rj.energies, rtol=0, atol=1e-10)
    np.testing.assert_allclose(rt.pair_energies, rj.pair_energies, rtol=0, atol=1e-10)
    assert rt.nk == rj.nk and rt.cbands == rj.cbands and rt.vbands == rj.vbands
    np.testing.assert_array_equal(rt.Q, rj.Q)
    np.testing.assert_allclose(np.abs(rt.amplitudes @ rt.amplitudes.conj().T), np.eye(rt.energies.size), atol=1e-10)
    for g in _groups(rj.energies):
        for d in range(rj.dipoles.shape[1]):
            np.testing.assert_allclose(rt.oscillator_strengths(d)[g].sum(), rj.oscillator_strengths(d)[g].sum(),
                                       rtol=0, atol=1e-8)
        np.testing.assert_allclose((np.abs(rt.amplitudes[g]) ** 2).sum(0), (np.abs(rj.amplitudes[g]) ** 2).sum(0),
                                   rtol=0, atol=1e-8)


def test_wavefunction_of_a_nondegenerate_exciton_matches_jax():
    """The chain's exciton levels are simple: |A_S|^2 and the envelope
    agree exciton by exciton."""
    rj, rt = _run("chain_hf_q", pythtb_tpu), _run("chain_hf_q", pythtb_tpu_torch)
    assert np.diff(rj.energies).min() > 1e-6
    for S in (0, 3):
        for a, b in zip(rt.wavefunction(S), rj.wavefunction(S)):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-8)


@pytest.mark.parametrize("kw", [dict(qp="hf"), dict(qp="none", spin="singlet", eta=0.08)])
def test_absorption_matches_jax(kw):
    w = np.linspace(0.0, 5.0, 31)
    args = dict(occ=[0], nk=(5, 5), **kw)
    mj, mt = bn_model(pythtb_tpu), bn_model(pythtb_tpu_torch)
    want = jexciton.absorption(mj, _bn_v(pythtb_tpu, mj), w, **args)
    got = exciton.absorption(mt, _bn_v(pythtb_tpu_torch, mt), w, **args)
    assert got.shape == want.shape == (2, 2, 31)
    assert np.abs(got - want).max() <= 1e-10 * np.abs(want).max()


def test_dispersion_matches_jax():
    qs = [[0.0], [0.125], [-0.25], [0.5]]
    want = jexciton.dispersion(chain_ab(pythtb_tpu, D=4.0, tA=0.2, g=0.3), CHAIN_V, [0], (8,), qs)
    got = exciton.dispersion(chain_ab(pythtb_tpu_torch, D=4.0, tA=0.2, g=0.3), CHAIN_V, [0], (8,), qs)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)


@pytest.mark.parametrize("rcut", [1.2, 3.0])
def test_radial_interaction_identical(rcut):
    assert (exciton.radial_interaction(bn_model(pythtb_tpu_torch), lambda r: 1.0 / r, rcut)
            == jexciton.radial_interaction(bn_model(pythtb_tpu), lambda r: 1.0 / r, rcut))
    cubic = [np.eye(3), [[0.0, 0.0, 0.0], [0.5, 0.5, 0.5]]]
    assert (exciton.radial_interaction(pythtb_tpu_torch.tb_model(3, 3, *cubic), lambda r: r, 1.5)
            == jexciton.radial_interaction(pythtb_tpu.tb_model(3, 3, *cubic), lambda r: r, 1.5))


def test_v_none_matches_the_ports_optical_conductivity():
    """Independent-particle limit: absorption == optical_conductivity on the
    same grid and broadening (the full complex tensor)."""
    bn = bn_model(pythtb_tpu_torch)
    w = np.linspace(0.0, 5.0, 41)
    sig_ip = optical.optical_conductivity(bn, w, occ=[0], nk=(9, 9), eta=0.08)
    sig_bse = exciton.absorption(bn, None, w, occ=[0], nk=(9, 9), eta=0.08, qp="none")
    np.testing.assert_allclose(sig_bse, sig_ip, rtol=0, atol=1e-12)


@pytest.mark.parametrize("which", ["bn", "three_band"])
def test_w_table_on_kernel_one_matches_jax(which):
    """W(q)[a, b] = sum_t V_t e^{2 pi i q.R_t}: kernel 1's one-sided mode on
    the interaction's BlochData against jexciton._w_table (sign, phase and
    orientation)."""
    import jax.numpy as jnp

    if which == "bn":
        mj, mt = bn_model(pythtb_tpu), bn_model(pythtb_tpu_torch)
        V = _bn_v(pythtb_tpu, mj)
    else:
        mj, mt = three_band(pythtb_tpu), three_band(pythtb_tpu_torch)
        V = THREE_V
    q = np.random.default_rng(3).uniform(-1.0, 1.0, (17, mj._dim_k))
    vals, rvecs, pattern = jexciton._prep_interaction(mj, V)
    want = np.asarray(jexciton._w_table(jnp.asarray(q), jnp.asarray(vals), jnp.asarray(rvecs), jnp.asarray(pattern),
                                        mj._norb))
    wdata = exciton._interaction_data(mt, *exciton._prep_interaction(mt, V), torch.device("cpu"))
    got = assemble_one_sided(wdata, torch.as_tensor(q)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_pole_weights_on_kernel_sixteen_match_abs_jit():
    """The resonant (+Omega) and antiresonant (-Omega) poles as one
    Lorentzian spectral sum over 2M transitions equal _abs_jit."""
    import jax.numpy as jnp

    rng = np.random.default_rng(8)
    M, ncart = 37, 2
    omega = np.sort(rng.uniform(0.5, 4.0, M))
    Ds = rng.normal(size=(M, ncart)) + 1j * rng.normal(size=(M, ncart))
    w = np.linspace(0.0, 5.0, 23)
    want = np.asarray(jexciton._abs_jit(jnp.asarray(omega), jnp.asarray(np.stack([Ds.real, Ds.imag], -1)),
                                        jnp.asarray(w), jnp.asarray(0.07)))
    want = want[..., 0] + 1j * want[..., 1]
    W, de = exciton._pole_weights(torch.as_tensor(omega), torch.as_tensor(Ds))
    got = 1j * optical.spectral_sum(W, de, torch.as_tensor(w), 0.07, "lorentz").numpy().reshape(ncart, ncart, -1)
    assert np.abs(got - want).max() <= 1e-10 * np.abs(want).max()


def _kernel28_pair_loop(ue, uh, wtab, wq, de, nk, sx):
    """Kernel 28's pair mode element by element, in the CUDA loop's order
    and index arithmetic (row-major grid padded to three directions)."""
    B, nc, S = ue.shape
    nv = uh.shape[1]
    M = B * nc * nv
    n0, n1, n2 = list(nk) + [1] * (3 - len(nk))

    def diff(x, y):
        x2, y2 = x % n2, y % n2
        x, y = x // n2, y // n2
        x1, y1, x0, y0 = x % n1, y % n1, x // n1, y // n1
        return (((x0 - y0) % n0) * n1 + (x1 - y1) % n1) * n2 + (x2 - y2) % n2

    H = np.zeros((M, M), dtype=complex)
    for r in range(M):
        x, cp, vp = r // (nc * nv), (r % (nc * nv)) // nv, r % nv
        for s in range(M):
            y, c, v = s // (nc * nv), (s % (nc * nv)) // nv, s % nv
            W = wtab[diff(x, y)]
            D = sum(np.conj(ue[x, cp, a]) * ue[y, c, a] * sum(W[a, b] * np.conj(uh[y, v, b]) * uh[x, vp, b]
                                                              for b in range(S)) for a in range(S))
            X = sum(np.conj(ue[x, cp, a]) * uh[x, vp, a] * sum(wq[a, b] * np.conj(uh[y, v, b]) * ue[y, c, b]
                                                               for b in range(S)) for a in range(S))
            H[r, s] = (-D + sx * X) / B + (de[r] if r == s else 0.0)
    return H


def _kernel28_fock_loop(wtab, occ_u, u, nk):
    """Kernel 28's Fock mode: the convolution G then the contraction."""
    B, nb, S = u.shape
    idx = kbse.diff_index(nk, torch.device("cpu")).numpy()
    rho = np.einsum("yva,yvb->yab", occ_u, occ_u.conj())
    G = np.stack([sum(wtab[idx[x, y]] * rho[y] for y in range(B)) for x in range(B)])
    return -np.einsum("xab,xna,xnb->xn", G, u.conj(), u).real / B


@pytest.mark.parametrize("nk, S, nc, nv, sx", [((3, 2, 2), 3, 2, 2, 2.0), ((4, 3), 2, 1, 3, 1.0), ((5,), 4, 3, 1, 0.0)])
def test_kernel28_arithmetic_matches_its_plain_modes(nk, S, nc, nv, sx):
    """The CUDA kernel's per-element sums (emulated) against the plain
    einsum chains, on random states and tables, 1e-12 of the largest
    entry."""
    rng = np.random.default_rng(28)
    B = int(np.prod(nk))

    def cplx(*shape):
        return rng.normal(size=shape) + 1j * rng.normal(size=shape)

    ue, uh, occ = cplx(B, nc, S), cplx(B, nv, S), cplx(B, 2, S)
    wtab, wq, de = cplx(B, S, S), cplx(S, S), rng.normal(size=B * nc * nv)
    want = _kernel28_pair_loop(ue, uh, wtab, wq, de, nk, sx)
    got = kbse.pair_matrix(*(torch.as_tensor(a) for a in (ue, uh, wtab, wq, de)), nk, sx).numpy()
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    want = _kernel28_fock_loop(wtab, occ, ue, nk)
    got = kbse.fock_shifts(*(torch.as_tensor(a) for a in (wtab, occ, ue)), nk).numpy()
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


def test_diff_index_matches_jax():
    for nk in ((5,), (3, 4), (2, 3, 2)):
        np.testing.assert_array_equal(kbse.diff_index(nk, torch.device("cpu")).numpy(),
                                      np.asarray(jexciton._diff_index(nk)))


def test_frozen_valence_closure_against_the_ports_ed():
    """Frozen-valence closure: the 36 one-pair levels of the port's ED on
    the glued 6-cell ring equal the union over Q of the port's BSE with
    Hartree and Fock shifts at 1e-10 (tests/test_exciton.py:79)."""
    M = pythtb_tpu_torch
    L, D, tB = 6, 8.0, 0.7
    U0, U1, VAA, VBB = 2.0, 0.8, 0.6, 0.5
    m = chain_ab(M, D=D, tB=tB)
    V = [(U0, 0, 1, (0,)), (U1, 0, 1, (1,)), (U1, 0, 1, (-1,)), (VAA, 0, 0, (1,)), (VBB, 1, 1, (1,))]
    inter = []
    for c in range(L):
        A, B = 2 * c, 2 * c + 1
        inter += [(U0, A, B), (U1, A, 2 * ((c + 1) % L) + 1), (U1, A, 2 * ((c - 1) % L) + 1),
                  (VAA, A, 2 * ((c + 1) % L)), (VBB, B, 2 * ((c + 1) % L) + 1)]
    r = M.ed.solve(m.cut_piece(L, 0, glue_edgs=True), nelec=L, interactions=inter)
    exc_ed = np.sort(r.evals - r.evals[0])[1:L * L + 1]
    exc_bse = np.sort(np.concatenate([exciton.bse(m, V, occ=[0], nk=(L,), Q=[q / L]).energies for q in range(L)]))
    np.testing.assert_allclose(exc_bse, exc_ed, rtol=0, atol=1e-10)
