"""The Rudner winding stencil: kernel 24 (``csrc/winding.cu``), the
counterpart of ``pythtb_tpu.floquet._winding_jit``.

From the evolution history U (nt + 1, B, S, S) over one period on an
(n0, n1) k-grid (kernel 22's full mode with its history write), the
eigenvectors P (B, S, S) of U(T) as COLUMNS (``unitary_eig``) and the
quasienergies eps (G, B, S) branched through each of G gaps, it forms
the periodized map U_e(t) = U(t) P diag(e^{i eps t}) P^H (the duplicated
t = T slice dropped), takes periodic central differences in t, k1 and k2
(a k-wrap conjugated by the embedding phases, D_su = p_s conj(p_u)), and
sums Re tr A_t (A_1 A_2 - A_2 A_1) with A_mu = U_e^H dU_e/dmu over the
grid: W = -(T / nt)(1 / n0)(1 / n1) / (8 pi^2) times that sum, (G,).

On a CUDA tensor :func:`winding` launches kernel 24 (S <= 16; above, it
raises); on a CPU tensor it runs :func:`_winding_plain`, the reference's
rolls and einsums.
"""

from __future__ import annotations

import math

import torch

from .. import config
from . import _kernels

__all__ = ["winding", "KERNEL_MAX_S"]

# most states kernel 24 takes (registers up to 4, a block's shared memory
# from 5 to 16)
KERNEL_MAX_S = 16


def _scale(T, nt, n0, n1):
    return -(T / nt) * (1.0 / n0) * (1.0 / n1) / (8.0 * math.pi**2)


def _periodized(hist, P, eps, T):
    """U_e (G, nt, B, S, S): U(t) P diag(e^{i eps t}) P^H at t = s T / nt,
    s < nt."""
    nt = hist.shape[0] - 1
    ts = torch.arange(nt + 1, dtype=config.FLOAT, device=hist.device) * (T / nt)
    ph = torch.polar(torch.ones((), dtype=config.FLOAT, device=hist.device).expand(
        (eps.shape[0], nt + 1) + tuple(eps.shape[1:])), ts[None, :, None, None] * eps[:, None])
    expH = torch.einsum("bsn,gtbn,bun->gtbsu", P, ph, P.conj())
    return torch.einsum("tbsu,gtbuv->gtbsv", hist, expH)[:, :-1]


def _winding_plain(hist, P, eps, p0, p1, n0, n1, T):
    """Plain stencil: the rolls and einsums of the reference.  The oracle
    of kernel 24.  Returns the (G,) winding numbers."""
    nt = hist.shape[0] - 1
    S = hist.shape[-1]
    Ue = _periodized(hist, P, eps, T).reshape(eps.shape[0], nt, n0, n1, S, S)

    def a_mu(dU):
        return torch.einsum("gtijsu,gtijsv->gtijuv", Ue.conj(), dU)

    def d_k(axis, p, n):
        up = torch.roll(Ue, -1, dims=axis)
        dn = torch.roll(Ue, 1, dims=axis)
        D = p[:, None] * p.conj()[None, :]
        last = [slice(None)] * 6
        last[axis] = -1
        first = [slice(None)] * 6
        first[axis] = 0
        up[tuple(last)] = up[tuple(last)] * D
        dn[tuple(first)] = dn[tuple(first)] * D.conj()
        h = 1.0 / n
        return (up - dn) / (2.0 * h)

    dU_t = (torch.roll(Ue, -1, dims=1) - torch.roll(Ue, 1, dims=1)) / (2.0 * T / nt)
    A_t = a_mu(dU_t)
    A_1 = a_mu(d_k(2, p0, n0))
    A_2 = a_mu(d_k(3, p1, n1))
    comm = A_1 @ A_2 - A_2 @ A_1
    tr = torch.einsum("gtijsu,gtijus->g", A_t, comm)
    return tr.real * _scale(T, nt, n0, n1)


def winding(hist, P, eps, p0, p1, n0, n1, T):
    """Winding numbers (G,) float64 of the periodized evolution.

    :param hist: (nt + 1, n0 n1, S, S) complex128 history, hist[0] = 1
    :param P: (n0 n1, S, S) complex128 eigenvectors of hist[-1] as columns
    :param eps: (G, n0 n1, S) float64 quasienergies branched per gap
    :param p0: (S,) complex128 embedding phases along k1, ``p1`` along k2
    :param T: the drive period
    """
    nt = hist.shape[0] - 1
    B, S = hist.shape[1], hist.shape[-1]
    G = eps.shape[0]
    if hist.device.type == "cpu":
        return _winding_plain(hist, P, eps, p0, p1, n0, n1, T)
    dev = hist.device
    if S > KERNEL_MAX_S:
        raise ValueError(
            "kernel 24 (the winding stencil) takes at most %d states on a CUDA tensor, got %d; "
            'call pythtb_tpu_torch.config.set_device("cpu") to run this model on the CPU' % (KERNEL_MAX_S, S))
    hist, P, eps, p0, p1 = (t.contiguous() for t in (hist, P, eps, p0, p1))
    _kernels.require(hist, "hist", config.COMPLEX, (nt + 1, B, S, S), dev)
    _kernels.require(P, "P", config.COMPLEX, (B, S, S), dev)
    _kernels.require(eps, "eps", config.FLOAT, (G, B, S), dev)
    _kernels.require(p0, "p0", config.COMPLEX, (S,), dev)
    _kernels.require(p1, "p1", config.COMPLEX, (S,), dev)
    if B != n0 * n1:
        raise ValueError("the history has %d k-points, not %d x %d" % (B, n0, n1))
    Ue = torch.empty((G, nt, B, S, S), dtype=config.COMPLEX, device=dev)
    vals = torch.empty((G, nt * B), dtype=config.FLOAT, device=dev)
    out = torch.empty((G,), dtype=config.FLOAT, device=dev)
    _kernels.launch("winding", dev, hist, P, eps, p0, p1, Ue, vals, out, G, nt, n0, n1, S, float(T))
    return out * _scale(T, nt, n0, n1)
