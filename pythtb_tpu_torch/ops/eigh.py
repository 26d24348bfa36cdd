"""Batched Hermitian eigensolvers (counterpart of ``pythtb_tpu.ops.eigh``).

* ``nsta == 1``: trivial.
* ``nsta == 2``: closed form; on a CUDA tensor this launches kernel 2
  (``csrc/eig2.cu``), on a CPU tensor it runs the plain version below.
* ``3 <= nsta <= 32`` and ``nsta > 64``: ``torch.linalg.eigh`` over the
  batch, in slices of at most ``LIBRARY_BATCH`` matrices: cuSOLVER's
  batched ``syev``, which torch calls for complex matrices up to 32 x 32,
  refuses batches of 32,768 and more (CUSOLVER_STATUS_INVALID_VALUE;
  torch 2.11, CUDA 12.8, H100).
* ``33 <= nsta <= 64``: cyclic complex Jacobi (:func:`eigh_jacobi`); on a
  CUDA tensor this launches kernel 7 (``csrc/eigh_jacobi.cu``), one block
  per matrix, on a CPU tensor it runs the plain version below with the
  same rotation schedule.  A CUDA tensor in this range never reaches
  ``torch.linalg.eigh``, which runs matrix by matrix above 32 x 32 there.
  That is a shape rule, not a fallback: a failed build, launch or
  convergence raises.

Eigenvalues are ascending and eigenvectors are *rows* (``v[b, s, :]`` is
state s), matching pythtb_tpu and the reference's ``_nicefy_eig``
layout.  ``torch.linalg.eigh`` returns columns, so its result is
transposed here.
"""

from __future__ import annotations

import torch

from .. import config
from . import _kernels

__all__ = ["eig2", "eigh_jacobi", "eigh_batched", "eigvalsh_batched"]

# largest batch handed to one torch.linalg.eigh / eigvalsh call
LIBRARY_BATCH = 16384
# the matrix sizes that go to the Jacobi solver (kernel 7 takes 1..64)
JACOBI_MIN, JACOBI_MAX = 33, 64
# convergence: off(A)^2 <= (JACOBI_TOL ||A||_F)^2, within JACOBI_SWEEPS sweeps
JACOBI_TOL = 1e-14
JACOBI_SWEEPS = 30


def _eig2_plain(H):
    """Plain PyTorch closed form of (B, 2, 2) Hermitian eigenpairs (the
    formulas of pythtb_tpu.ops.eigh._eig2_analytic): the oracle of
    kernel 2."""
    a = H[..., 0, 0].real
    b = H[..., 1, 1].real
    c = H[..., 0, 1]
    mid = 0.5 * (a + b)
    delta = 0.5 * (a - b)
    r = torch.hypot(delta, c.abs())
    w = torch.stack([mid - r, mid + r], dim=-1)
    # + state, numerically stable branch by the sign of delta:
    #   delta >= 0:  [delta + r, conj(c)];  delta < 0:  [c, r - delta]
    pos = delta >= 0
    p = torch.where(pos, (delta + r).to(config.COMPLEX), c)
    q = torch.where(pos, c.conj(), (r - delta).to(config.COMPLEX))
    nrm = torch.sqrt(p.abs() ** 2 + q.abs() ** 2)
    # exactly degenerate (r == 0): any orthonormal basis; use identity
    degen = nrm == 0
    safe = torch.where(degen, torch.ones_like(nrm), nrm)
    p = torch.where(degen, torch.ones_like(p), p / safe)
    q = torch.where(degen, torch.zeros_like(q), q / safe)
    v_minus = torch.stack([-q.conj(), p.conj()], dim=-1)
    v_plus = torch.stack([p, q], dim=-1)
    return w, torch.stack([v_minus, v_plus], dim=-2)


def eig2(H):
    """(w, v) of a (B, 2, 2) complex128 batch: w (B, 2) ascending, v
    (B, 2, 2) with rows as states."""
    if H.device.type == "cpu":
        return _eig2_plain(H)
    B = H.shape[0]
    _kernels.require(H, "H", config.COMPLEX, (B, 2, 2))
    w = torch.empty((B, 2), dtype=config.FLOAT, device=H.device)
    v = torch.empty((B, 2, 2), dtype=config.COMPLEX, device=H.device)
    _kernels.launch("eig2", H.device, H, w, v, B)
    return w, v


def _jacobi_schedule(m, device):
    """Round-robin (Brent-Luk) pairs of the Jacobi sweep, as kernel 7
    walks them: for each of the n - 1 steps (n = m rounded up to even), the
    (p, q) index tensors of its pairs with p < q, pairs holding the dummy
    index m dropped."""
    n = m + (m % 2)
    steps = []
    for r in range(n - 1):
        pos = [0] + [1 + (i - 1 + r) % (n - 1) for i in range(1, n)]
        pairs = [(min(pos[k], pos[n - 1 - k]), max(pos[k], pos[n - 1 - k])) for k in range(n // 2)]
        pairs = [pq for pq in pairs if pq[1] < m]
        steps.append(tuple(torch.tensor(x, dtype=torch.int64, device=device) for x in zip(*pairs)))
    return steps


def _eigh_jacobi_plain(H, vectors=True):
    """Plain PyTorch cyclic complex Jacobi, vectorized over the batch: the
    rotations, order, exact 2 x 2 blocks, stopping rule and stable sort of
    kernel 7 (``csrc/eigh_jacobi.cu`` states them), each matrix stopping at
    its own sweep.  The oracle of kernel 7.  Raises where a matrix is not
    converged after ``JACOBI_SWEEPS`` sweeps."""
    B, m = H.shape[0], H.shape[-1]
    tol, max_sweeps = JACOBI_TOL, JACOBI_SWEEPS
    A = 0.5 * (H + H.conj().transpose(-1, -2))
    A.diagonal(dim1=-2, dim2=-1).imag.zero_()
    V = torch.eye(m, dtype=config.COMPLEX, device=H.device).expand(B, m, m).clone() if vectors else None
    fro2 = (A.abs() ** 2).sum(dim=(-2, -1))
    offmask = ~torch.eye(m, dtype=torch.bool, device=H.device)
    schedule = _jacobi_schedule(m, H.device)
    for sweep in range(max_sweeps + 1):
        off2 = ((A.abs() ** 2) * offmask).sum(dim=(-2, -1))
        active = off2 > tol * tol * fro2
        if not bool(active.any()):
            break
        if sweep == max_sweeps:
            raise RuntimeError("Jacobi eigensolver: %d of %d matrices not converged in %d sweeps"
                               % (int(active.sum()), B, max_sweeps))
        for p, q in schedule:
            app = A[:, p, p].real
            aqq = A[:, q, q].real
            apq = A[:, p, q]
            absb = apq.abs()
            rot = (absb > 0) & active[:, None]  # (B, npairs)
            # negligible beside both diagonal entries: zeroed, not rotated
            nb = 100.0 * absb
            turn = rot & ~((nb + app.abs() == app.abs()) & (nb + aqq.abs() == aqq.abs()))
            safe = torch.where(turn, absb, torch.ones_like(absb))
            ph = torch.where(turn, torch.complex(apq.real / safe, apq.imag / safe), torch.ones_like(apq))
            tau = (aqq - app) / (2.0 * safe)
            sgn = torch.where(tau >= 0, torch.ones_like(tau), -torch.ones_like(tau))
            t = torch.where(turn, sgn / (tau.abs() + torch.hypot(torch.ones_like(tau), tau)), torch.zeros_like(tau))
            c = 1.0 / torch.sqrt(1.0 + t * t)
            s = t * c
            dp, dq = app - t * absb, aqq + t * absb
            c_, s_, ph_ = c[..., None], s[..., None], ph[..., None]
            # rows: G^H A
            ap, aq = A[:, p, :], A[:, q, :]
            u = ph_ * aq
            A[:, p, :] = c_ * ap - s_ * u
            A[:, q, :] = s_ * ap + c_ * u
            # columns: (G^H A) G, then the pair's block set exactly
            cc, sc_, phc = c[:, None, :], s[:, None, :], ph.conj()[:, None, :]
            ap, aq = A[:, :, p], A[:, :, q]
            u = phc * aq
            A[:, :, p] = cc * ap - sc_ * u
            A[:, :, q] = sc_ * ap + cc * u
            zero = torch.zeros_like(apq)
            A[:, p, p] = torch.where(rot, dp.to(config.COMPLEX), A[:, p, p])
            A[:, q, q] = torch.where(rot, dq.to(config.COMPLEX), A[:, q, q])
            A[:, p, q] = torch.where(rot, zero, A[:, p, q])
            A[:, q, p] = torch.where(rot, zero, A[:, q, p])
            if vectors:
                vp, vq = V[:, :, p], V[:, :, q]
                u = phc * vq
                V[:, :, p] = cc * vp - sc_ * u
                V[:, :, q] = sc_ * vp + cc * u
    d = A.diagonal(dim1=-2, dim2=-1).real
    order = torch.argsort(d, dim=-1, stable=True)
    w = torch.take_along_dim(d, order, dim=-1)
    if not vectors:
        return w
    rows = V.transpose(-1, -2)  # row i is column i of V
    return w, torch.take_along_dim(rows, order[..., None], dim=-2)


def eigh_jacobi(H, vectors=True):
    """Eigenpairs of a (B, m, m) Hermitian complex128 batch, m <= 64, by
    cyclic complex Jacobi: kernel 7 on a CUDA tensor, the plain version on
    a CPU tensor.  Returns (w (B, m) ascending, v (B, m, m) rows as
    states), or w alone without ``vectors``.  Raises where a matrix does
    not converge within ``JACOBI_SWEEPS`` sweeps."""
    if H.device.type == "cpu":
        return _eigh_jacobi_plain(H, vectors)
    B, m = H.shape[0], H.shape[-1]
    if m > JACOBI_MAX:
        raise ValueError("kernel 7 takes matrices up to %d x %d, got %d x %d" % (JACOBI_MAX, JACOBI_MAX, m, m))
    _kernels.require(H, "H", config.COMPLEX, (B, m, m))
    w = torch.empty((B, m), dtype=config.FLOAT, device=H.device)
    v = torch.empty((B, m, m), dtype=config.COMPLEX, device=H.device) if vectors else None
    flag = torch.zeros((B,), dtype=torch.int32, device=H.device)
    _kernels.launch("eigh_jacobi", H.device, H, w, v, flag, B, m, int(vectors), JACOBI_TOL, JACOBI_SWEEPS)
    bad = int(flag.sum())
    if bad:
        raise RuntimeError("kernel 7: %d of %d matrices not converged in %d sweeps" % (bad, B, JACOBI_SWEEPS))
    return (w, v) if vectors else w


def _jacobi_input(H):
    """(B, m, m) complex128, C-contiguous view of a (..., m, m) batch."""
    m = H.shape[-1]
    return H.reshape(-1, m, m).to(config.COMPLEX).contiguous()


def eigh_batched(H):
    """(w, v): ascending eigenvalues and row-eigenvectors of (B, m, m)."""
    m = H.shape[-1]
    if m == 1:
        return H[..., 0, 0].real[..., None].to(config.FLOAT), torch.ones_like(H)
    if m == 2:
        return eig2(H)
    if JACOBI_MIN <= m <= JACOBI_MAX:
        w, v = eigh_jacobi(_jacobi_input(H))
        return w.reshape(H.shape[:-1]), v.reshape(H.shape)
    parts = [torch.linalg.eigh(h) for h in H.split(LIBRARY_BATCH)]
    w = torch.cat([p[0] for p in parts])
    v = torch.cat([p[1] for p in parts])
    return w, v.transpose(-1, -2)


def _eigvalsh_plain(H):
    """Ascending eigenvalues of (B, m, m) by the plain versions on any
    device: the closed form at m 2, the plain Jacobi at 33-64,
    ``torch.linalg.eigvalsh`` elsewhere.  Differentiable by torch
    autograd (the oracle of kernel 29 takes its gradient): at m 2 the
    splitting is sqrt(delta^2 + |c|^2), set to 0 with a zero gradient where
    it vanishes (hypot's gradient is NaN there, at graphene's K points),
    as the JAX package's closed form differentiates."""
    m = H.shape[-1]
    if m == 1:
        return H[..., 0, 0].real[..., None].to(config.FLOAT)
    if m == 2:
        a, b, c = H[..., 0, 0].real, H[..., 1, 1].real, H[..., 0, 1]
        mid, delta = 0.5 * (a + b), 0.5 * (a - b)
        r2 = delta * delta + c.real * c.real + c.imag * c.imag
        split = r2 > 0
        r = torch.where(split, torch.sqrt(torch.where(split, r2, torch.ones_like(r2))), torch.zeros_like(r2))
        return torch.stack([mid - r, mid + r], dim=-1)
    if JACOBI_MIN <= m <= JACOBI_MAX:
        return _eigh_jacobi_plain(H, vectors=False)
    return torch.linalg.eigvalsh(H)


def eigvalsh_batched(H):
    """Ascending eigenvalues of (B, m, m)."""
    m = H.shape[-1]
    if m == 1:
        return H[..., 0, 0].real[..., None].to(config.FLOAT)
    if m == 2:
        return eig2(H)[0]
    if JACOBI_MIN <= m <= JACOBI_MAX:
        return eigh_jacobi(_jacobi_input(H), vectors=False).reshape(H.shape[:-1])
    return torch.cat([torch.linalg.eigvalsh(h) for h in H.split(LIBRARY_BATCH)])
