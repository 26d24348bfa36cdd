"""The Bethe-Salpeter pair matrix and its Fock shifts: kernel 28
(``csrc/bse_kernel.cu``), the kernel contractions of
``pythtb_tpu.exciton._bse_jit``.

Pairs t = (k, c, v) flattened k-major, M = B nc nv; with Convention-II
electron states ``ue`` (B, nc, S) at k + Q, hole states ``uh`` (B, nv, S)
at k, the interaction table ``wtab`` (B, S, S), W(g / nk) at grid point
g, and ``wq`` = W(Q),

    H[(x,c',v'), (y,c,v)] = -D + sx X + de delta,
    D = (1/N) sum_ab W_ab(k_x - k_y) conj(ue[x,c',a]) ue[y,c,a] conj(uh[y,v,b]) uh[x,v',b],
    X = (1/N) sum_ab conj(ue[x,c',a]) uh[x,v',a] wq[a,b] conj(uh[y,v,b]) ue[y,c,b],

W(k_x - k_y) being the table at the grid index ((g_x - g_y) mod nk).
:func:`fock_shifts` is the exchange self-energy of the filled sea,
sig[x, n] = -(1/N) Re sum_{y,v,ab} W_ab(k_x - k_y) conj(u[x,n,a])
occ[y,v,a] conj(occ[y,v,b]) u[x,n,b].

On a CUDA tensor :func:`pair_matrix` and :func:`fock_shifts` launch
kernel 28's two modes; on a CPU tensor they run the einsum chains of the
JAX program over the (B, B, S, S) gather (:func:`_pair_matrix_plain`,
:func:`_fock_shifts_plain`).
"""

from __future__ import annotations

import math

import torch

from .. import config
from . import _kernels

__all__ = ["pair_matrix", "fock_shifts", "diff_index"]


def diff_index(nk, device):
    """(B, B) int64 table idx[x, y] = flat((g_x - g_y) mod nk) on the
    row-major grid ``nk`` (``pythtb_tpu.exciton._diff_index``)."""
    B = math.prod(nk)
    coords = torch.meshgrid(*[torch.arange(n, device=device) for n in nk], indexing="ij")
    idx = torch.zeros((B, B), dtype=torch.int64, device=device)
    stride = B
    for d, n in enumerate(nk):
        stride //= n
        c = coords[d].reshape(-1)
        idx += torch.remainder(c[:, None] - c[None, :], n) * stride
    return idx


def _grid3(nk):
    """The grid padded to three directions, as kernel 28 reads it."""
    if not 1 <= len(nk) <= 3:
        raise ValueError("kernel 28 takes 1-3 grid directions, got %d" % len(nk))
    return [int(n) for n in nk] + [1] * (3 - len(nk))


def _pair_matrix_plain(ue, uh, wtab, wq, de, nk, sx):
    """Plain PyTorch pair matrix: the einsum chain of
    ``pythtb_tpu.exciton._bse_jit`` (:339-355) over the gather
    Wg = wtab[idx].  The oracle of kernel 28's pair mode."""
    B, nc, _ = ue.shape
    nv = uh.shape[1]
    M = B * nc * nv
    Wg = wtab[diff_index(nk, ue.device)]  # (B, B, S, S): W(k_x - k_y) at [x, y]
    T1 = torch.einsum("xyab,xca,yda->xybcd", Wg, ue.conj(), ue)
    H = -torch.einsum("xybcd,yvb,xwb->xcwydv", T1, uh.conj(), uh) / B
    if sx != 0.0:
        P = torch.einsum("xca,xwa->xcwa", ue.conj(), uh)
        Pc = torch.einsum("yvb,ydb->ydvb", uh.conj(), ue)
        PW = torch.einsum("xcwa,ab->xcwb", P, wq)
        H = H + sx * torch.einsum("xcwb,ydvb->xcwydv", PW, Pc) / B
    H = H.reshape(M, M)
    return H + torch.diag(de.to(H.dtype))


def pair_matrix(ue, uh, wtab, wq, de, nk, sx):
    """The BSE pair matrix H (M, M) complex128 (see the module docstring).

    :param ue: (B, nc, S) complex128 electron states (rows)
    :param uh: (B, nv, S) complex128 hole states
    :param wtab: (B, S, S) complex128 W on the grid ``nk``
    :param wq: (S, S) complex128 W(Q)
    :param de: (M,) float64 pair energies
    :param nk: grid sizes, B = prod(nk)
    :param sx: exchange factor
    """
    if ue.device.type == "cpu":
        return _pair_matrix_plain(ue, uh, wtab, wq, de, nk, sx)
    B, nc, S = ue.shape
    nv = uh.shape[1]
    M = B * nc * nv
    dev = ue.device
    g = _grid3(nk)
    if math.prod(g) != B:
        raise ValueError("grid %s does not hold the %d k-points" % (tuple(nk), B))
    ue, uh, wtab, wq, de = (t.contiguous() for t in (ue, uh, wtab, wq, de))
    _kernels.require(ue, "ue", config.COMPLEX, (B, nc, S), dev)
    _kernels.require(uh, "uh", config.COMPLEX, (B, nv, S), dev)
    _kernels.require(wtab, "wtab", config.COMPLEX, (B, S, S), dev)
    _kernels.require(wq, "wq", config.COMPLEX, (S, S), dev)
    _kernels.require(de, "de", config.FLOAT, (M,), dev)
    H = torch.empty((M, M), dtype=config.COMPLEX, device=dev)
    _kernels.launch("bse_pair", dev, ue, uh, wtab, wq, de, H, B, nc, nv, S, *g, float(sx))
    return H


def _fock_shifts_plain(wtab, occ_u, u, nk):
    """Plain PyTorch Fock shifts: the exchange part of
    ``pythtb_tpu.exciton._hf_shifts`` (:271-276) over the gather
    Wg = wtab[idx].  The oracle of kernel 28's Fock mode."""
    B = u.shape[0]
    Wg = wtab[diff_index(nk, u.device)]
    t1 = torch.einsum("xyab,xna,yva->xynvb", Wg, u.conj(), occ_u)
    return -torch.einsum("xynvb,yvb,xnb->xn", t1, occ_u.conj(), u).real / B


def fock_shifts(wtab, occ_u, u, nk):
    """Exchange self-energy sig (B, nb) float64 of the states ``u`` (B, nb,
    S) in the filled sea ``occ_u`` (B, no, S), with the table ``wtab`` (B,
    S, S) on the grid ``nk`` (see the module docstring).  On the card the
    occupied density matrix rho[y] = sum_v occ_v occ_v^H is formed first
    (an einsum), then kernel 28's Fock mode runs its two launches."""
    if u.device.type == "cpu":
        return _fock_shifts_plain(wtab, occ_u, u, nk)
    B, nb, S = u.shape
    dev = u.device
    g = _grid3(nk)
    if math.prod(g) != B:
        raise ValueError("grid %s does not hold the %d k-points" % (tuple(nk), B))
    rho = torch.einsum("yva,yvb->yab", occ_u, occ_u.conj()).contiguous()
    wtab, u = wtab.contiguous(), u.contiguous()
    _kernels.require(wtab, "wtab", config.COMPLEX, (B, S, S), dev)
    _kernels.require(u, "u", config.COMPLEX, (B, nb, S), dev)
    G = torch.empty((B, S, S), dtype=config.COMPLEX, device=dev)
    sig = torch.empty((B, nb), dtype=config.FLOAT, device=dev)
    _kernels.launch("bse_fock", dev, wtab, rho, u, G, sig, B, nb, S, *g)
    return sig
