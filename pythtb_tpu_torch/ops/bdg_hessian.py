"""The BdG phase-twist response of the superfluid weight: kernel 23
(``csrc/bdg_hessian.cu``), counterpart of the band-basis sums of
``pythtb_tpu.geometry._sfw_analytic_jit`` (Hessian mode) and
``_sfw_free_energy_jit`` (grand-potential mode).

:func:`bdg_hessian` takes the BdG eigenpairs (lam (B, N), U (B, N, N),
states as rows, N = 2 S) and the reduced derivatives of H at +k and -k,
and returns sum_k [sum_n f_n Re <n|M''_ab|n> + Re sum_ij f[l_i, l_j]
A_a[i, j] A_b[j, i]] (d, d) with M', M'' the block-diagonal BdG
derivatives in Cartesian axes (particle block dH(+k), hole block
-conj(dH(-k))) and f[., .] the Fermi divided difference, which switches
to (f'_i + f'_j) / 2 where |l_i - l_j| <= ``tol`` (the caller's
batch-global tolerance).  :func:`bdg_grand_potential` returns, per twist
q, sum_k [-kT sum_i softplus(-l_i / kT) + tr_k] - B mu S.

On a CUDA tensor each launches kernel 23 (N <= 64; above, they raise);
on a CPU tensor they run the plain versions below, the reference's
einsums.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import config
from . import _kernels
from .fermi_sweep import _softplus

__all__ = ["bdg_hessian", "bdg_grand_potential", "KERNEL_MAX_N"]

# most BdG states (2 S) kernel 23 takes (registers up to 8, a block's
# shared memory from 9 to 64)
KERNEL_MAX_N = 64
_THREADS = 256


def _check(N, dev):
    if dev.type == "cuda" and N > KERNEL_MAX_N:
        raise ValueError(
            "kernel 23 (the BdG Hessian) takes at most %d BdG states (2 x %d orbitals) on a CUDA tensor, got %d; "
            'call pythtb_tpu_torch.config.set_device("cpu") to run this model on the CPU'
            % (KERNEL_MAX_N, KERNEL_MAX_N // 2, N))


def _bdg_blocks(P, Q):
    """blockdiag(P, -conj(Q)) of (..., S, S) blocks: (..., 2S, 2S)."""
    zero = torch.zeros_like(P)
    return torch.cat([torch.cat([P, zero], dim=-1), torch.cat([zero, -Q.conj()], dim=-1)], dim=-2)


def _bdg_hessian_plain(lam, U, dHp, dHm, d2p, d2m, lat, kt, tol):
    """Plain Hessian mode: the einsums of the reference (Cartesian
    rotation, the padded BdG derivative blocks, the band-basis elements,
    the divided differences).  The oracle of kernel 23's Hessian mode."""
    latc = torch.as_tensor(lat, dtype=config.COMPLEX).to(lam.device)
    dHpc = torch.einsum("ra,brij->baij", latc, dHp) / (2.0 * math.pi)
    dHmc = torch.einsum("ra,brij->baij", latc, dHm) / (2.0 * math.pi)
    d2pc = torch.einsum("ra,sc,brsij->bacij", latc, latc, d2p) / ((2.0 * math.pi) ** 2)
    d2mc = torch.einsum("ra,sc,brsij->bacij", latc, latc, d2m) / ((2.0 * math.pi) ** 2)
    Mp = _bdg_blocks(dHpc, dHmc)  # (B, d, 2S, 2S)
    M2 = _bdg_blocks(d2pc, d2mc)  # (B, d, d, 2S, 2S)
    A = torch.einsum("bns,bast,bmt->banm", U.conj(), Mp, U)
    d2diag = torch.einsum("bns,bacst,bnt->bacn", U.conj(), M2, U)
    f = torch.sigmoid(-lam / kt)
    fp = -f * (1.0 - f) / kt
    dl = lam[:, :, None] - lam[:, None, :]
    big = dl.abs() > tol
    quot = (f[:, :, None] - f[:, None, :]) / torch.where(big, dl, torch.ones_like(dl))
    DD = torch.where(big, quot, 0.5 * (fp[:, :, None] + fp[:, None, :]))
    term1 = torch.einsum("bacn,bn->ac", d2diag.real, f)
    term2 = torch.einsum("bij,baij,bcji->ac", DD.to(A.dtype), A, A).real
    return term1 + term2


def bdg_hessian(lam, U, dHp, dHm, d2p, d2m, lat, kt, tol):
    """Sum over k of the Daleckii-Krein Hessian terms, (d, d) float64.

    :param lam: (B, N) float64 BdG eigenvalues; :param U: (B, N, N)
      complex128 eigenvectors as rows
    :param dHp: (B, d, S, S) complex128 reduced dH/dk at +k, ``dHm`` at
      -k; :param d2p: (B, d, d, S, S) reduced d2H at +k, ``d2m`` at -k
    :param lat: (d, d) lattice vectors (rows), reduced -> Cartesian
    :param kt: temperature; :param tol: degeneracy tolerance of the
      divided differences (batch-global)
    """
    B, N = lam.shape
    d = dHp.shape[1]
    if lam.device.type == "cpu":
        return _bdg_hessian_plain(lam, U, dHp, dHm, d2p, d2m, lat, kt, tol)
    dev = lam.device
    _check(N, dev)
    if not 1 <= d <= 3:
        raise ValueError("kernel 23 takes 1 to 3 periodic directions, got %d" % d)
    S = N // 2
    lam, U, dHp, dHm, d2p, d2m = (t.contiguous() for t in (lam, U, dHp, dHm, d2p, d2m))
    _kernels.require(lam, "lam", config.FLOAT, (B, N), dev)
    _kernels.require(U, "U", config.COMPLEX, (B, N, N), dev)
    for t, name in ((dHp, "dHp"), (dHm, "dHm")):
        _kernels.require(t, name, config.COMPLEX, (B, d, S, S), dev)
    for t, name in ((d2p, "d2p"), (d2m, "d2m")):
        _kernels.require(t, name, config.COMPLEX, (B, d, d, S, S), dev)
    L = np.zeros((3, 3))
    L[:d, :d] = np.asarray(lat, dtype=np.float64)
    slots = -(-B // _THREADS) if N <= 8 else B
    scratch = None if N <= 8 else torch.empty((B, d, N, N), dtype=config.COMPLEX, device=dev)
    part = torch.empty((slots, d, d), dtype=config.FLOAT, device=dev)
    out = torch.empty((d, d), dtype=config.FLOAT, device=dev)
    _kernels.launch("bdg_hessian", dev, lam, U, dHp, dHm, d2p, d2m, scratch, part, out, B, N, d, float(kt),
                    float(tol), *(float(x) for x in L.reshape(-1)))
    return out


def _bdg_grand_potential_plain(lam, tr, nq, kt, muS):
    """Plain grand-potential mode: the oracle of kernel 23's second mode."""
    fe = -kt * _softplus(-lam / kt).sum(dim=-1)
    return (fe + tr - muS).reshape(nq, -1).sum(dim=1)


def bdg_grand_potential(lam, tr, nq, kt, muS):
    """Per twist q, sum over k of -kT sum_i softplus(-lam_i / kT) + tr_k -
    mu S: (nq,) float64 from lam (nq * B, N) and tr (nq * B,) float64,
    q-major."""
    if lam.device.type == "cpu":
        return _bdg_grand_potential_plain(lam, tr, nq, kt, muS)
    dev = lam.device
    M, N = lam.shape
    _check(N, dev)
    lam, tr = lam.contiguous(), tr.contiguous()
    _kernels.require(lam, "lam", config.FLOAT, (M, N), dev)
    _kernels.require(tr, "tr", config.FLOAT, (M,), dev)
    out = torch.empty((nq,), dtype=config.FLOAT, device=dev)
    _kernels.launch("bdg_grand_potential", dev, lam, tr, out, nq, M // nq, N, float(kt), float(muS))
    return out
