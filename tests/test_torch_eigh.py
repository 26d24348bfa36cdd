"""Kernel 7's plain version (the batched Jacobi eigensolver of
``ops/eigh.py``) and kernel 1's flux-batch plain version, on the CPU.

The Jacobi solver runs every CPU batch of 33-64 states (on the card,
kernel 7 takes 3-64, and the plain Jacobi is its oracle there).  It is held
against numpy.linalg.eigh and the JAX package's ``eigh_batched`` on the
same numpy-seeded Hermitian batches: eigenvalues within
1e-12 * max(1, ||H||_F); the projector of every group of eigenvalues split
from its neighbours by more than 1e-8 within 1e-10; the residual
||H v - lambda v|| and ||V V^H - I|| within 1e-12.  The flux-batch assembly is held against a loop of the
plain one-member assembly within 1e-14.
"""

import dataclasses

import numpy as np
import pytest
import torch

from pythtb_tpu.ops.eigh import eigh_batched as jax_eigh_batched
from pythtb_tpu_torch import core
from pythtb_tpu_torch.ops import eigh, hamiltonian

from .test_torch_ops import on_cpu  # noqa: F401  (autouse: the port on the CPU)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The plain Jacobi is thousands of tiny torch ops: one intra-op thread
    runs them several times faster (0.18 against 1.25 s at m 32 on an
    8-core host) and keeps them out of OpenMP's spin-waits when the suite's
    workers share the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _hermitian(rng, B, m):
    X = rng.normal(size=(B, m, m)) + 1j * rng.normal(size=(B, m, m))
    return 0.5 * (X + np.conj(np.swapaxes(X, -1, -2)))


def _degenerate(rng, B, m):
    """Random unitary conjugates of a spectrum with exact multiplicities 1-4
    (and an m-fold one in the first matrix)."""
    out = []
    for b in range(B):
        Q, _ = np.linalg.qr(rng.normal(size=(m, m)) + 1j * rng.normal(size=(m, m)))
        d = np.zeros(m) if b == 0 else np.sort(np.repeat(rng.normal(size=m), rng.integers(1, 5, m))[:m])
        out.append((Q * d) @ Q.conj().T)
    return np.array(out)


def _groups(w, gap=1e-8):
    """Index groups of sorted eigenvalues split by more than ``gap``."""
    cuts = np.nonzero(np.diff(w) > gap)[0] + 1
    return np.split(np.arange(len(w)), cuts)


def _check_against(H, w, v, w_ref, v_ref):
    """v, v_ref: row eigenvectors."""
    for b in range(H.shape[0]):
        scale = max(1.0, np.linalg.norm(H[b]))
        assert np.abs(w[b] - w_ref[b]).max() <= 1e-12 * scale
        for g in _groups(w_ref[b]):
            P = v[b, g].T @ v[b, g].conj()
            P_ref = v_ref[b, g].T @ v_ref[b, g].conj()
            assert np.abs(P - P_ref).max() <= 1e-10
        resid = H[b] @ v[b].T - v[b].T * w[b][None, :]
        assert np.abs(resid).max() <= 1e-12
        assert np.abs(v[b] @ v[b].conj().T - np.eye(H.shape[-1])).max() <= 1e-12


@pytest.mark.parametrize("m,case", [(33, "random"), (39, "random"), (40, "random"), (64, "random"),
                                    (47, "random"), (40, "degenerate"), (63, "degenerate"),
                                    (3, "random"), (4, "random"), (8, "random"), (16, "random"), (32, "random"),
                                    (3, "degenerate"), (4, "degenerate"), (8, "degenerate"), (16, "degenerate"),
                                    (32, "degenerate")])
def test_plain_jacobi_matches_numpy_and_jax(m, case):
    """The plain Jacobi (kernel 7's oracle at every m it takes on the card;
    ``eigh_batched``'s own route on the CPU at 33-64)."""
    rng = np.random.default_rng(m + (100 if case == "degenerate" and m < 33 else 0))
    H = (_hermitian if case == "random" else _degenerate)(rng, 6, m)
    w, v = (x.numpy() for x in eigh.eigh_jacobi(torch.as_tensor(H)))
    if eigh._route(m, 6, "cpu") == "jacobi":
        wb, vb = (x.numpy() for x in eigh.eigh_batched(torch.as_tensor(H)))
        assert np.array_equal(wb, w) and np.array_equal(vb, v)
    wn, vn = np.linalg.eigh(H)
    _check_against(H, w, v, wn, np.swapaxes(vn, -1, -2))
    wj, vj = (np.asarray(x) for x in jax_eigh_batched(H))
    _check_against(H, w, v, wj, vj)
    wo = eigh.eigh_jacobi(torch.as_tensor(H), vectors=False).numpy()
    assert np.abs(wo - w).max() == 0.0  # the same rotations without V


def test_plain_jacobi_symmetrizes_and_keeps_batch_shape():
    """Only the Hermitian part counts, as jnp.linalg.eigh's symmetrized
    input; leading batch axes are kept."""
    rng = np.random.default_rng(3)
    H = _hermitian(rng, 4, 36)
    skew = 1e-9 * (rng.normal(size=H.shape) + 1j * rng.normal(size=H.shape))
    skew = skew - np.conj(np.swapaxes(skew, -1, -2))
    w, v = eigh.eigh_batched(torch.as_tensor((H + skew).reshape(2, 2, 36, 36)))
    assert w.shape == (2, 2, 36) and v.shape == (2, 2, 36, 36)
    wn, vn = np.linalg.eigh(H)
    _check_against(H, w.reshape(4, 36).numpy(), v.reshape(4, 36, 36).numpy(), wn, np.swapaxes(vn, -1, -2))


def test_plain_jacobi_raises_when_not_converged(monkeypatch):
    H = torch.as_tensor(_hermitian(np.random.default_rng(4), 2, 40))
    monkeypatch.setattr(eigh, "JACOBI_SWEEPS", 1)
    with pytest.raises(RuntimeError, match="not converged in 1 sweeps"):
        eigh.eigh_jacobi(H)


def test_jacobi_schedule_covers_every_pair_once():
    for m in (33, 40):
        seen = set()
        for p, q in eigh._jacobi_schedule(m, torch.device("cpu")):
            idx = p.tolist() + q.tolist()
            assert len(set(idx)) == len(idx)  # disjoint pairs in a step
            seen.update(zip(p.tolist(), q.tolist()))
        assert seen == {(p, q) for p in range(m) for q in range(p + 1, m)}


def test_route():
    """eigh_batched's lines (PERF.md section 6, the H100): the closed form
    at 2; on the card kernel 7 at 3-8 at every batch, at 9-26 from 1,024
    matrices, the library at 27-32 and kernel 7 at 33-64; on the CPU the
    library to 32 and the plain Jacobi from 33 to 64; the library above 64
    on both; ``cpu_route`` gives the CPU's lines on the card.  Kernel 7's
    team design to 12 states from 16,384 matrices."""
    for m in range(1, 71):
        for B in (121, 1023, 1024, 589824):
            cpu, cuda = eigh._route(m, B, "cpu"), eigh._route(m, B, "cuda")
            if m <= 2:
                assert cpu == cuda == ("trivial" if m == 1 else "eig2")
                continue
            assert cpu == ("jacobi" if 33 <= m <= 64 else "library"), m
            kernel = m <= 8 or (m <= 26 and B >= 1024) or 33 <= m <= 64
            assert cuda == ("jacobi" if kernel else "library"), (m, B)
            assert eigh._route(m, B, "cuda", cpu_route=True) == cpu, (m, B)
    assert [eigh._jacobi_design(m, 589824) for m in (1, 4, 12, 13, 32, 64)] == ["team"] * 3 + ["block"] * 3
    assert [eigh._jacobi_design(4, B) for B in (1600, 16383, 16384)] == ["block", "block", "team"]


@pytest.mark.parametrize("nspin,dim_k", [(1, 2), (2, 2), (1, 3)])
def test_flux_batch_assembly_matches_a_loop(nspin, dim_k):
    rng = np.random.default_rng(10 + nspin + dim_k)
    norb, nhop, P = 5, 30, 4
    shape = (nhop,) if nspin == 1 else (nhop, 2, 2)
    ons = rng.normal(size=norb) if nspin == 1 else np.tile(np.eye(2), (norb, 1, 1)) * rng.normal(size=(norb, 1, 1))
    data = core.finalize(dim_k, dim_k, list(range(dim_k)), nspin, norb, rng.random((norb, dim_k)), ons,
                         rng.normal(size=shape) + 1j * rng.normal(size=shape), rng.integers(0, norb, nhop),
                         rng.integers(0, norb, nhop), rng.integers(-2, 3, (nhop, dim_k)), "cpu")
    amps = torch.as_tensor(rng.normal(size=(P,) + shape) + 1j * rng.normal(size=(P,) + shape))
    diag = torch.as_tensor(rng.normal(size=(P, data.nsta, data.nsta)) + 0j)
    k = torch.as_tensor(rng.uniform(-1, 1, (9, dim_k)))
    got = hamiltonian.assemble_members(data, amps, diag, k)
    want = torch.cat([hamiltonian._assemble_plain(dataclasses.replace(data, amps=amps[p], diag=diag[p]), k)
                      for p in range(P)])
    assert got.shape == (P * 9, data.nsta, data.nsta)
    assert float((got - want).abs().max()) <= 1e-14
