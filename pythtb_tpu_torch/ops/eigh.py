"""Batched Hermitian eigensolvers (counterpart of ``pythtb_tpu.ops.eigh``).

* ``nsta == 1``: trivial.
* ``nsta == 2``: closed form; on a CUDA tensor this launches kernel 2
  (``csrc/eig2.cu``), on a CPU tensor it runs the plain version below.
* otherwise: ``torch.linalg.eigh`` over the batch, in slices of at most
  ``LIBRARY_BATCH`` matrices: cuSOLVER's batched ``syev``, which torch
  calls for complex matrices up to 32 x 32, refuses batches of 32,768
  and more (CUSOLVER_STATUS_INVALID_VALUE; torch 2.11, CUDA 12.8, H100).

Eigenvalues are ascending and eigenvectors are *rows* (``v[b, s, :]`` is
state s), matching pythtb_tpu and the reference's ``_nicefy_eig``
layout.  ``torch.linalg.eigh`` returns columns, so its result is
transposed here.
"""

from __future__ import annotations

import torch

from .. import config
from . import _kernels

__all__ = ["eig2", "eigh_batched", "eigvalsh_batched"]

# largest batch handed to one torch.linalg.eigh / eigvalsh call
LIBRARY_BATCH = 16384


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


def eigh_batched(H):
    """(w, v): ascending eigenvalues and row-eigenvectors of (B, m, m)."""
    m = H.shape[-1]
    if m == 1:
        return H[..., 0, 0].real[..., None].to(config.FLOAT), torch.ones_like(H)
    if m == 2:
        return eig2(H)
    parts = [torch.linalg.eigh(h) for h in H.split(LIBRARY_BATCH)]
    w = torch.cat([p[0] for p in parts])
    v = torch.cat([p[1] for p in parts])
    return w, v.transpose(-1, -2)


def eigvalsh_batched(H):
    """Ascending eigenvalues of (B, m, m)."""
    m = H.shape[-1]
    if m == 1:
        return H[..., 0, 0].real[..., None].to(config.FLOAT)
    if m == 2:
        return eig2(H)[0]
    return torch.cat([torch.linalg.eigvalsh(h) for h in H.split(LIBRARY_BATCH)])
