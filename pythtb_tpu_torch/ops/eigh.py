"""Batched Hermitian eigensolvers (counterpart of ``pythtb_tpu.ops.eigh``).

:func:`_route` draws the lines, by m, by the batch B and by the tensor's
device:

* ``nsta == 1``: trivial.
* ``nsta == 2``: closed form; on a CUDA tensor this launches kernel 2
  (``csrc/eig2.cu``), on a CPU tensor it runs the plain version below.
* on a CUDA tensor, ``3 <= nsta <= 8`` at every batch, ``9 <= nsta <=
  26`` from 1,024 matrices and ``33 <= nsta <= 64``: cyclic complex
  Jacobi (:func:`eigh_jacobi`), kernel 7 (``csrc/eigh_jacobi.cu``): a team
  of lanes a matrix, teams packed into warps, where the batch fills the
  card with them, a block a matrix elsewhere (:func:`_jacobi_design`).
  PERF.md section 6 has the measurements on the H100 that draw both lines:
  ``torch.linalg.eigh`` runs matrix by matrix above 32 x 32 there and
  trails kernel 7 below except at small batches from 9 states and at
  27-32.  That is a shape rule, not a fallback: a failed build, launch or
  convergence raises.
* ``3 <= nsta <= 32`` on a CPU tensor, the rest of 3-32 on a CUDA tensor,
  and ``nsta > 64`` on either: ``torch.linalg.eigh`` over the batch, in
  slices of at most ``LIBRARY_BATCH`` matrices: cuSOLVER's batched
  ``syev``, which torch calls for complex matrices up to 32 x 32, refuses
  batches of 32,768 and more (CUSOLVER_STATUS_INVALID_VALUE; torch 2.11,
  CUDA 12.8, H100).  The
  plain Jacobi is kernel 7's oracle in the tests and in ``chip_smoke.py``;
  over the CPU suite's many small batches it would be slower than LAPACK,
  so the CPU keeps the library there.
* ``33 <= nsta <= 64`` on a CPU tensor: the plain Jacobi below, the same
  rotation schedule as kernel 7.

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
# the most states kernel 7 takes
JACOBI_MAX = 64
# the matrix sizes that go to the plain Jacobi on a CPU tensor
_CPU_JACOBI = (33, JACOBI_MAX)
# the lines of kernel 7 against torch.linalg.eigh on a CUDA tensor
# (PERF.md section 6, measured on the H100): kernel 7 at every batch to
# _JACOBI_ANY_M states, from _JACOBI_MID_B matrices to _JACOBI_MID_M (the
# library wins smaller batches there: its time grows with the batch, kernel
# 7's latency-bound sweeps do not), never from _JACOBI_MID_M + 1 to 32, at
# every batch from 33 to 64
_JACOBI_ANY_M = 8
_JACOBI_MID_M, _JACOBI_MID_B = 26, 1024
# kernel 7's designs: the C entry's design argument and the most states
# each takes (a block a matrix; a team of lanes a matrix), the team where
# the batch fills the card with its warps: to _TEAM_MAX_M states from
# _TEAM_MIN_B matrices
_JACOBI_DESIGNS = {"block": (0, JACOBI_MAX), "team": (1, 16)}
_TEAM_MAX_M, _TEAM_MIN_B = 12, 16384
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


def _route(m, B, device_type, cpu_route=False):
    """Where ``eigh_batched`` / ``eigvalsh_batched`` send B matrices of m
    states on a tensor of ``device_type``: "trivial" (m 1), "eig2" (m 2),
    "jacobi" (kernel 7 on the card, the plain Jacobi on the CPU) or
    "library" (``torch.linalg.eigh``).  The line is drawn by m, and on the
    card by B from 9 to 26 states; ``cpu_route`` draws the CPU's lines on
    any device."""
    if m == 1:
        return "trivial"
    if m == 2:
        return "eig2"
    if device_type == "cpu" or cpu_route:
        jacobi = _CPU_JACOBI[0] <= m <= _CPU_JACOBI[1]
    else:
        jacobi = m <= _JACOBI_ANY_M or (m <= _JACOBI_MID_M and B >= _JACOBI_MID_B) or 32 < m <= JACOBI_MAX
    return "jacobi" if jacobi else "library"


def _jacobi_design(m, B):
    """Kernel 7's design for B matrices of m states: a team of lanes a
    matrix to ``_TEAM_MAX_M`` states from ``_TEAM_MIN_B`` matrices, a
    block a matrix elsewhere."""
    return "team" if m <= _TEAM_MAX_M and B >= _TEAM_MIN_B else "block"


def eigh_jacobi(H, vectors=True):
    """Eigenpairs of a (B, m, m) Hermitian complex128 batch, m <= 64, by
    cyclic complex Jacobi: kernel 7 on a CUDA tensor, the plain version on
    a CPU tensor.  Returns (w (B, m) ascending, v (B, m, m) rows as
    states), or w alone without ``vectors``.  Raises where a matrix does
    not converge within ``JACOBI_SWEEPS`` sweeps."""
    if H.device.type == "cpu":
        return _eigh_jacobi_plain(H, vectors)
    return _eigh_jacobi(H, vectors)


def _eigh_jacobi(H, vectors=True, design=None):
    """Kernel 7 on design ``design`` (a key of ``_JACOBI_DESIGNS``;
    :func:`_jacobi_design`'s choice if None)."""
    B, m = H.shape[0], H.shape[-1]
    if m > JACOBI_MAX:
        raise ValueError("kernel 7 takes matrices up to %d x %d, got %d x %d" % (JACOBI_MAX, JACOBI_MAX, m, m))
    if design is None:
        design = _jacobi_design(m, B)
    if design not in _JACOBI_DESIGNS:
        raise ValueError("kernel 7 has no %r design; it has %s" % (design, ", ".join(_JACOBI_DESIGNS)))
    code, most = _JACOBI_DESIGNS[design]
    if m > most:
        raise ValueError("kernel 7's %r design takes matrices up to %d x %d, got %d x %d" % (design, most, most, m, m))
    _kernels.require(H, "H", config.COMPLEX, (B, m, m))
    w = torch.empty((B, m), dtype=config.FLOAT, device=H.device)
    v = torch.empty((B, m, m), dtype=config.COMPLEX, device=H.device) if vectors else None
    flag = torch.zeros((B,), dtype=torch.int32, device=H.device)
    _kernels.launch("eigh_jacobi", H.device, H, w, v, flag, B, m, int(vectors), JACOBI_TOL, JACOBI_SWEEPS, code)
    bad = int(flag.sum())
    if bad:
        raise RuntimeError("kernel 7: %d of %d matrices not converged in %d sweeps" % (bad, B, JACOBI_SWEEPS))
    return (w, v) if vectors else w


def _jacobi_input(H):
    """(B, m, m) complex128, C-contiguous view of a (..., m, m) batch."""
    m = H.shape[-1]
    return H.reshape(-1, m, m).to(config.COMPLEX).contiguous()


def _library_eigh(H):
    """``torch.linalg.eigh`` in slices of ``LIBRARY_BATCH``, eigenvectors
    as rows."""
    parts = [torch.linalg.eigh(h) for h in H.split(LIBRARY_BATCH)]
    w = torch.cat([p[0] for p in parts])
    v = torch.cat([p[1] for p in parts])
    return w, v.transpose(-1, -2)


def _library_eigvalsh(H):
    return torch.cat([torch.linalg.eigvalsh(h) for h in H.split(LIBRARY_BATCH)])


def eigh_batched(H, cpu_route=False):
    """(w, v): ascending eigenvalues and row-eigenvectors of (B, m, m).

    ``cpu_route`` takes the CPU's route on any device (``torch.linalg.eigh``
    from 3 to 32 states, kernel 7 from 33 to 64 on the card): for callers
    whose results depend on the basis an eigensolver picks inside a
    degenerate group, so that the card picks the library's basis there, as
    the CPU and the JAX package do, and not kernel 7's."""
    m = H.shape[-1]
    route = _route(m, H.numel() // max(m * m, 1), H.device.type, cpu_route)
    if route == "trivial":
        return H[..., 0, 0].real[..., None].to(config.FLOAT), torch.ones_like(H)
    if route == "eig2":
        return eig2(H)
    if route == "jacobi":
        w, v = eigh_jacobi(_jacobi_input(H))
        return w.reshape(H.shape[:-1]), v.reshape(H.shape)
    return _library_eigh(H)


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
    if _CPU_JACOBI[0] <= m <= _CPU_JACOBI[1]:
        return _eigh_jacobi_plain(H, vectors=False)
    return torch.linalg.eigvalsh(H)


def eigvalsh_batched(H):
    """Ascending eigenvalues of (B, m, m)."""
    m = H.shape[-1]
    route = _route(m, H.numel() // max(m * m, 1), H.device.type)
    if route == "trivial":
        return H[..., 0, 0].real[..., None].to(config.FLOAT)
    if route == "eig2":
        return eig2(H)[0]
    if route == "jacobi":
        return eigh_jacobi(_jacobi_input(H), vectors=False).reshape(H.shape[:-1])
    return _library_eigvalsh(H)
