"""The port's differentiable flows (energy_fn, chern_fn) against
pythtb_tpu.flows on the CPU, in float64, with the CLI self-check and the
profiling helpers.

``energy_fn`` values are held at 1e-12 and gradients against ``jax.grad``
at 1e-10 relative.  The JAX gradient of a ri-packed parameter arrives as
g[..., 0] + 1j g[..., 1] (``convert.grad_from_jax``), which is torch's
dL/dRe + i dL/dIm.  The on-site gradient is compared on its Hermitian
part: the energies are those of the on-site matrix's Hermitian part in
both packages, but the JAX package's closed-form 2 x 2 solver reads only
the upper triangle, so its raw gradient puts the off-diagonal weight on
(0, 1) alone.  Kernel 29's arithmetic (emulated in NumPy from the
eigenvectors) is held against the same gradients.
"""

import functools
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pythtb_tpu
import pythtb_tpu_torch
from pythtb_tpu import flows as jflows
from pythtb_tpu_torch import convert, flows
from pythtb_tpu_torch.ops import hamiltonian
from pythtb_tpu_torch.utils import profiling

from . import zoo
from .test_torch_ops import on_cpu  # noqa: F401  (autouse: the port on the CPU)

ROOT = Path(__file__).resolve().parents[1]


def _supercell36(M):
    """A 36-state graphene supercell with random on-site energies (no
    degenerate levels): its eigensolve is the plain Jacobi, kernel 7's
    oracle."""
    m = M.models.graphene().make_supercell([[3, 0], [0, 6]])
    m.set_onsite(np.random.default_rng(5).normal(size=m._norb), mode="add")
    return m


MODELS = {
    "haldane": zoo.haldane,
    "checkerboard": zoo.checkerboard,
    "kane_mele": lambda M: zoo.kane_mele(M, "odd"),
    "kagome": lambda M: M.models.kagome(),
    "ssh": lambda M: M.models.ssh(0.2),
    "supercell36": _supercell36,
}


def _kpts(name):
    m = MODELS[name](pythtb_tpu_torch)
    n = 3 if name == "supercell36" else 7
    return np.random.default_rng(11).random((n, m._dim_k))


def _herm(g):
    return 0.5 * (g + np.conj(np.swapaxes(g, -1, -2)))


@functools.lru_cache(maxsize=None)
def _weighted_grads(name):
    """(values and gradients of sum W * E) for both packages (computed once
    a model: two tests read them)."""
    kpts = _kpts(name)
    fj, pj = jflows.energy_fn(MODELS[name](pythtb_tpu))
    ft, pt = flows.energy_fn(MODELS[name](pythtb_tpu_torch))
    ej = np.asarray(fj(pj, kpts))
    W = np.random.default_rng(2).normal(size=ej.shape)
    gj = convert.grad_from_jax(jax.device_get(jax.grad(lambda q: jnp.sum(fj(q, kpts) * W))(pj)))
    p = {k: v.clone().requires_grad_() for k, v in pt.items()}
    et = ft(p, kpts)
    (et * torch.as_tensor(W)).sum().backward()
    return ej, et.detach().numpy(), gj, p, W, kpts


@pytest.mark.parametrize("name", sorted(MODELS))
def test_energy_fn_values_and_gradients_match_jax(name):
    ej, et, gj, p, _, _ = _weighted_grads(name)
    np.testing.assert_allclose(et, ej, rtol=0, atol=1e-12)
    ga, gd = gj["amps"].numpy(), gj["diag"].numpy()
    assert p["amps"].grad.shape == ga.shape
    assert np.abs(p["amps"].grad.numpy() - ga).max() <= 1e-10 * np.abs(ga).max()
    assert np.abs(p["diag"].grad.numpy() - _herm(gd)).max() <= 1e-10 * np.abs(gd).max()


def _kernel29_loop(data, U, gbar, kpts, P):
    """Kernel 29's sums from the eigenvectors, in NumPy: G_k = sum_n gbar
    u_n u_n^H, g_amps = 2 sum_k G_k[i, j] e^{-2 pi i k.rv}, g_diag = sum_k
    G_k, per member."""
    ns = data.nspin
    ii, jj, rv = data.ii.numpy(), data.jj.numpy(), data.rv.numpy()
    NK, S = kpts.shape[0], data.nsta
    G = np.einsum("rn,rnp,rnq->rpq", gbar, U, U.conj()).reshape(P, NK, S, S)
    ph = np.exp(-2j * np.pi * kpts @ rv.T)  # (NK, nhop)
    blk = G.reshape(P, NK, data.norb, ns, data.norb, ns)[:, :, ii, :, jj, :]  # (nhop, P, NK, s, u)
    ga = 2.0 * np.einsum("hmksu,kh->mhsu", blk, ph)
    return ga.reshape((P, data.nhop) + tuple(data.amps.shape[1:])), G.sum(1)


@pytest.mark.parametrize("name", ["haldane", "kane_mele", "kagome", "supercell36"])
def test_kernel29_arithmetic_matches_jax_gradient(name):
    """The sums kernel 29 computes, and the wrapper's plain version (torch
    autograd through the plain assembly and eigensolver), against jax.grad."""
    _, _, gj, _, W, kpts = _weighted_grads(name)
    m = MODELS[name](pythtb_tpu_torch)
    data = m._get_finalized()
    k = torch.as_tensor(kpts)
    _, U = np.linalg.eigh(np.asarray(hamiltonian.assemble(data, k)))
    U = np.swapaxes(U, -1, -2)  # rows are states
    ga, gd = _kernel29_loop(data, U, W, kpts, 1)
    want_a, want_d = gj["amps"].numpy(), _herm(gj["diag"].numpy())
    assert np.abs(ga[0] - want_a).max() <= 1e-10 * np.abs(want_a).max()
    assert np.abs(gd[0] - want_d).max() <= 1e-10 * np.abs(want_d).max()
    pa, pd = hamiltonian.energy_vjp(data, data.amps[None], data.diag[None], k, torch.as_tensor(U),
                                    torch.as_tensor(W))
    assert np.abs(pa[0].numpy() - want_a).max() <= 1e-10 * np.abs(want_a).max()
    assert np.abs(pd[0].numpy() - want_d).max() <= 1e-10 * np.abs(want_d).max()


def _ssh_sweep(nd=9):
    deltas = np.linspace(-0.6, 0.6, nd)
    amps = np.zeros((nd, 2, 2))
    amps[:, 0, 0] = 1.0 + deltas
    amps[:, 1, 0] = 1.0 - deltas
    return amps


def test_member_form_matches_vmap_peierls_sweep():
    """examples/peierls_ssh.py's distortion sweep: amplitudes with a member
    axis, the on-site matrix shared; filled-band energies and their
    gradients against jax.vmap.  The undistorted member closes its gap at
    k = 1/2, where the port takes the symmetric subgradient (the cotangent
    averaged over the degenerate pair: G = I / 2, no amplitude gradient)
    and the JAX package follows the phase of a rounding-sized coupling;
    that member's gradient is held against JAX's over the other k-points."""
    fj, pj = jflows.energy_fn(pythtb_tpu.models.ssh(0.0))
    ft, pt = flows.energy_fn(pythtb_tpu_torch.models.ssh(0.0))
    kpts = (np.arange(32) / 32)[:, None]
    amps = _ssh_sweep()
    gapless = 4  # delta 0

    def e_el(a, k=kpts):
        return jnp.sum(jnp.minimum(fj({"amps": a, "diag": pj["diag"]}, k), 0.0))

    want = np.asarray(jax.vmap(e_el)(jnp.asarray(amps)))
    gwant = convert.grad_from_jax(np.asarray(jax.vmap(jax.grad(e_el))(jnp.asarray(amps)))).numpy()
    gwant[gapless] = convert.grad_from_jax(np.asarray(jax.grad(e_el)(jnp.asarray(amps[gapless]),
                                                                     np.delete(kpts, 16, axis=0)))).numpy()
    a = convert.params_from_jax({"amps": amps, "diag": np.asarray(pj["diag"])})
    a["amps"].requires_grad_()
    ev = ft(a, kpts)
    assert ev.shape == (9, 32, 2)
    got = torch.clamp(ev, max=0.0).sum(dim=(1, 2))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-12)
    got.sum().backward()
    assert np.abs(a["amps"].grad.numpy() - gwant).max() <= 1e-10 * np.abs(gwant).max()


@pytest.mark.parametrize("case", ["graphene_K", "spin_pairs"])
def test_gradient_at_a_degeneracy_is_the_symmetric_subgradient(case):
    """At an exact degeneracy the gradient sums projectors onto the
    degenerate groups, with the cotangent averaged over each: graphene at
    K (S 2, the closed form) and a spinful chain with no spin-orbit term,
    every level a spin pair (S 4, the library eigensolver).  Any unitary rotation of
    the returned eigenvectors inside a group leaves it unchanged, so the
    card's kernel 29 and the CPU's autograd agree whatever basis their
    solvers return."""
    if case == "graphene_K":
        m = pythtb_tpu_torch.models.graphene()
        kpts = np.array([[1.0 / 3.0, 2.0 / 3.0]])
    else:
        m = pythtb_tpu_torch.tb_model(1, 1, [[1.0]], [[0.0], [0.5]], nspin=2)
        m.set_onsite([0.3, -0.2])
        m.set_hop(0.7, 0, 1, [0])
        m.set_hop(0.4 - 0.1j, 1, 0, [1])
        kpts = np.array([[0.13], [0.61]])
    fn, p0 = flows.energy_fn(m)
    p = {k: v.clone().requires_grad_() for k, v in p0.items()}
    ev = fn(p, kpts)
    S = ev.shape[-1]
    weights = torch.arange(1.0, S + 1.0, dtype=torch.float64)  # unequal inside every group
    (ev * weights).sum().backward()
    # the same gradient from the projectors: sum over groups of mean(weight) P_group
    data = m._get_finalized()
    H = hamiltonian.assemble(data, torch.as_tensor(kpts, dtype=torch.float64))
    w, U = torch.linalg.eigh(H)
    gd = torch.zeros((S, S), dtype=torch.complex128)
    for b in range(kpts.shape[0]):
        groups = np.split(np.arange(S), np.nonzero(np.diff(w[b].numpy()) > 1e-9)[0] + 1)
        assert len(groups) < S  # there is a degeneracy at every k-point
        for g in groups:
            proj = U[b][:, g] @ U[b][:, g].conj().T
            gd += float(weights[g].mean()) * proj
    assert np.abs(p["diag"].grad.numpy() - gd.numpy()).max() <= 1e-10
    if case == "graphene_K":
        assert np.abs(p["diag"].grad.numpy() - 1.5 * np.eye(2)).max() <= 1e-12


def test_member_form_matches_vmap_with_both_axes():
    """Haldane members with their own amplitudes and on-site matrices:
    values at 1e-12, gradients of a weighted sum at 1e-10 relative, and
    kernel 29's member sums (emulated) against the same."""
    pts = ((0.2, 0.3), (0.9, -1.2), (0.0, 2.0))
    ps = [pythtb_tpu.models.haldane(delta=d, t2=0.15 * np.exp(1j * f)) for d, f in pts]
    fins = [m._get_finalized()[1] for m in ps]
    amps, diags = np.stack([np.asarray(f.amps) for f in fins]), np.stack([np.asarray(f.diag) for f in fins])
    fj, _ = jflows.energy_fn(pythtb_tpu.models.haldane())
    ft, _ = flows.energy_fn(pythtb_tpu_torch.models.haldane())
    kpts = np.random.default_rng(4).random((6, 2))
    W = np.random.default_rng(5).normal(size=(3, 6, 2))

    def loss(a, d, w):
        return jnp.sum(fj({"amps": a, "diag": d}, kpts) * w)

    want = np.asarray(jax.vmap(lambda a, d: fj({"amps": a, "diag": d}, kpts))(amps, diags))
    gj = jax.vmap(jax.grad(loss, argnums=(0, 1)))(jnp.asarray(amps), jnp.asarray(diags), jnp.asarray(W))
    ga, gd = (convert.grad_from_jax(np.asarray(g)).numpy() for g in gj)
    p = convert.params_from_jax({"amps": amps, "diag": diags})
    for v in p.values():
        v.requires_grad_()
    ev = ft(p, kpts)
    np.testing.assert_allclose(ev.detach().numpy(), want, rtol=0, atol=1e-12)
    (ev * torch.as_tensor(W)).sum().backward()
    assert np.abs(p["amps"].grad.numpy() - ga).max() <= 1e-10 * np.abs(ga).max()
    assert np.abs(p["diag"].grad.numpy() - _herm(gd)).max() <= 1e-10 * np.abs(gd).max()
    data = pythtb_tpu_torch.models.haldane()._get_finalized()
    H = hamiltonian.assemble_members(data, p["amps"].detach(), p["diag"].detach(), torch.as_tensor(kpts))
    U = np.swapaxes(np.linalg.eigh(H.numpy())[1], -1, -2)
    ka, kd = _kernel29_loop(data, U, W.reshape(-1, 2), kpts, 3)
    assert np.abs(ka - ga).max() <= 1e-10 * np.abs(ga).max()
    assert np.abs(kd - _herm(gd)).max() <= 1e-10 * np.abs(gd).max()


def test_fit_hopping_by_gradient_descent():
    """tests/test_autodiff.py:60: recover t = -1.3 from target bands."""
    M = pythtb_tpu_torch
    m_target = zoo.graphene(M, delta=0.0, t=-1.3)
    kpts = m_target.k_uniform_mesh([5, 5])
    target = torch.as_tensor(m_target.solve_all(kpts).T)
    fn, p = flows.energy_fn(zoo.graphene(M, delta=0.0, t=-1.0))
    amps = p["amps"].clone().requires_grad_()
    for _ in range(200):
        loss = ((fn({"amps": amps, "diag": p["diag"]}, kpts) - target) ** 2).mean()
        (g,) = torch.autograd.grad(loss, amps)
        amps = (amps - 0.5 * g).detach().requires_grad_()
    np.testing.assert_allclose(amps.detach().real.numpy(), -1.3, atol=1e-3)


def test_chern_fn_single_and_members_match_jax():
    """chern_fn on the reference's fn and on jax.vmap over a Haldane sweep
    (both phases and the trivial one), at 1e-10; the port's tensor carries
    no graph."""
    base_j, base_t = pythtb_tpu.models.haldane(), pythtb_tpu_torch.models.haldane()
    fj, pj = jflows.chern_fn(base_j, [0], nk=(13, 13))
    ft, pt = flows.chern_fn(base_t, [0], nk=(13, 13))
    want = float(jax.jit(fj)(pj))
    got = ft(pt)
    assert got.dim() == 0 and not got.requires_grad
    np.testing.assert_allclose(float(got), want, rtol=0, atol=1e-10)
    np.testing.assert_allclose(float(got), flows.chern_number(base_t, [0], nk=(13, 13)), rtol=0, atol=1e-10)
    pts = [(0.2, np.pi / 2), (0.2, -np.pi / 2), (1.5, np.pi / 2), (0.6, 0.4)]
    fins = [pythtb_tpu.models.haldane(delta=d, t2=0.15 * np.exp(1j * f))._get_finalized()[1] for d, f in pts]
    amps, diags = np.stack([np.asarray(f.amps) for f in fins]), np.stack([np.asarray(f.diag) for f in fins])
    want = np.asarray(jax.jit(jax.vmap(lambda a, g: fj({"amps": a, "diag": g})))(amps, diags))
    got = ft(convert.params_from_jax({"amps": amps, "diag": diags}))
    assert got.shape == (4,)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-10)
    np.testing.assert_allclose(np.round(got.numpy()), [-1.0, 1.0, 0.0, 0.0], atol=0)


def test_chern_fn_spinful_sector_matches_jax():
    """nspin 2: the two lower Kane-Mele bands (C = 0) and a member axis on
    the amplitudes only."""
    fj, pj = jflows.chern_fn(zoo.kane_mele(pythtb_tpu, "odd"), [0, 1], nk=(9, 9))
    ft, pt = flows.chern_fn(zoo.kane_mele(pythtb_tpu_torch, "odd"), [0, 1], nk=(9, 9))
    np.testing.assert_allclose(float(ft(pt)), float(jax.jit(fj)(pj)), rtol=0, atol=1e-10)
    amps = np.stack([np.asarray(pj["amps"]) * s for s in (1.0, 0.7)])
    want = np.asarray(jax.jit(jax.vmap(lambda a: fj({"amps": a, "diag": pj["diag"]})))(amps))
    got = ft({"amps": convert.params_from_jax({"amps": amps, "diag": np.asarray(pj["diag"])})["amps"],
              "diag": pt["diag"]})
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-10)


def test_params_and_grads_carry_across():
    _, pj = jflows.energy_fn(zoo.kane_mele(pythtb_tpu, "odd"))
    _, pt = flows.energy_fn(zoo.kane_mele(pythtb_tpu_torch, "odd"))
    got = convert.params_from_jax(jax.device_get(pj))
    for key in ("amps", "diag"):
        assert got[key].dtype == torch.complex128 and torch.equal(got[key], pt[key])
    g = np.random.default_rng(0).normal(size=(3, 4, 2))
    np.testing.assert_array_equal(convert.grad_from_jax(g).numpy(), g[..., 0] + 1j * g[..., 1])


def test_cli_self_check_on_the_cpu():
    proc = subprocess.run([sys.executable, "-m", "pythtb_tpu_torch", "--cpu"], capture_output=True, text=True,
                          cwd=str(ROOT), timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "self-check: Haldane Chern = -1.000000" in proc.stdout and "-> OK" in proc.stdout
    assert "device: cpu" in proc.stdout


def test_profiling_helpers_on_the_cpu(tmp_path):
    out = []
    with profiling.timed("solve", out=out):
        pythtb_tpu_torch.models.haldane().solve_all([[0.1, 0.2]])
    assert len(out) == 1 and out[0] > 0.0
    best, res = profiling.benchmark(lambda a: a + 1, 2, warmup=1, iters=3)
    assert res == 3 and 0.0 <= best < 1.0
    with profiling.trace(str(tmp_path)):
        torch.ones(4).sum()
    assert (tmp_path / "trace.json").stat().st_size > 0
