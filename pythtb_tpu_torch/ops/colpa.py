"""The Colpa factorization of linear spin waves: kernel 27
(``csrc/colpa.cu``), the assembly and Cholesky of
``pythtb_tpu.magnon._lswt_solve_jit``.

Per k it builds the bosonic BdG matrix from the DIRECTED bond entries of
``magnon.spin_model._tables`` (no implicit partner),

    h(k) = [[A(k) - C, B(k)], [B(k)^H, conj(A(-k)) - C]],
    A(k)_ij = sum_b a_b e^{2 pi i k.d_b},  B(k)_ij = sum_b b_b e^{2 pi i k.d_b},

Hermitizes it as 0.5 (h + h^H), adds shift 1, factors h = L L^H (lower
Cholesky) and returns (T, L) with T = L^H sigma3 L, the reference's
K sigma3 K^H with K = L^H.  A matrix that is not positive definite gives
NaN in its T and L (the reference's jnp.linalg.cholesky NaN), which the
caller turns into the "Colpa decomposition failed" error.

On a CUDA tensor :func:`colpa` launches kernel 27 (2n <= 64; above, it
raises); on a CPU tensor it runs :func:`_colpa_plain`: ``index_put_``
accumulation, ``torch.linalg.cholesky_ex`` with NaN on failure, and the
product.
"""

from __future__ import annotations

import math

import torch

from .. import config
from . import _kernels

__all__ = ["colpa", "ColpaTables", "KERNEL_MAX_M"]

# largest 2n kernel 27 takes (h in at most 65 kB of shared memory)
KERNEL_MAX_M = 64


class ColpaTables:
    """``spin_model._tables`` on a device: site indices ``ii``/``jj``
    (int32), ``dvec`` (nb, dim_k) float64, ``a_amp``/``b_amp`` (nb,)
    complex128 and ``cdiag`` (n,) float64."""

    def __init__(self, iidx, jidx, dvec, a_amp, b_amp, cdiag, device):
        def put(x, dtype):
            return torch.as_tensor(x).to(device=device, dtype=dtype).contiguous()

        self.ii = put(iidx, torch.int32)
        self.jj = put(jidx, torch.int32)
        self.dvec = put(dvec, config.FLOAT)
        self.a_amp = put(a_amp, config.COMPLEX)
        self.b_amp = put(b_amp, config.COMPLEX)
        self.cdiag = put(cdiag, config.FLOAT)

    @property
    def n(self):
        return self.cdiag.shape[0]

    @property
    def nb(self):
        return self.ii.shape[0]


def _colpa_plain(tab, shift, kpts):
    """Plain PyTorch: the reference's three scatter-adds, the block matrix,
    ``torch.linalg.cholesky_ex`` (NaN where it fails) and the product.
    The oracle of kernel 27."""
    B, n = kpts.shape[0], tab.n
    ang = (2.0 * math.pi) * (kpts @ tab.dvec.T)
    ph = torch.polar(torch.ones_like(ang), ang)  # (B, nb)
    rows = torch.arange(B, device=kpts.device)[:, None]
    ii, jj = tab.ii.long()[None], tab.jj.long()[None]

    def scatter(vals):
        out = torch.zeros((B, n, n), dtype=config.COMPLEX, device=kpts.device)
        out.index_put_((rows, ii, jj), vals, accumulate=True)
        return out

    A_k = scatter(tab.a_amp[None] * ph)
    B_k = scatter(tab.b_amp[None] * ph)
    A_mk = scatter(tab.a_amp[None] * ph.conj())
    cmat = torch.diag(tab.cdiag.to(config.COMPLEX))[None]
    h = torch.cat([torch.cat([A_k - cmat, B_k], dim=2), torch.cat([B_k.mH, A_mk.conj() - cmat], dim=2)], dim=1)
    h = 0.5 * (h + h.mH) + shift * torch.eye(2 * n, dtype=config.COMPLEX, device=kpts.device)
    L, info = torch.linalg.cholesky_ex(h)
    bad = (info != 0)[:, None, None]
    L = torch.where(bad, torch.full_like(L, complex(math.nan, math.nan)), L)
    sg = torch.cat([torch.ones(n), -torch.ones(n)]).to(device=kpts.device, dtype=config.COMPLEX)
    K = L.mH
    T = (K * sg[None, None, :]) @ K.mH
    return T, L


def colpa(tab, shift, kpts):
    """(T, L): T = L^H sigma3 L and the lower Cholesky factor L of the
    shifted, Hermitized h(k), each (B, 2n, 2n) complex128; NaN for a k
    whose h(k) is not positive definite.

    :param tab: :class:`ColpaTables` on the device of ``kpts``
    :param shift: the Goldstone regularization added to the diagonal
    :param kpts: (B, dim_k) float64 reduced k-points
    """
    if kpts.device.type == "cpu":
        return _colpa_plain(tab, float(shift), kpts)
    B, dk = kpts.shape
    n, nb, m = tab.n, tab.nb, 2 * tab.n
    dev = kpts.device
    if m > KERNEL_MAX_M:
        raise ValueError(
            "kernel 27 (the Colpa factorization) takes 2n <= %d on a CUDA tensor, got %d; "
            'call pythtb_tpu_torch.config.set_device("cpu") to run this model on the CPU' % (KERNEL_MAX_M, m))
    kpts = kpts.contiguous()
    _kernels.require(kpts, "kpts", config.FLOAT, (B, dk), dev)
    _kernels.require(tab.ii, "ii", torch.int32, (nb,), dev)
    _kernels.require(tab.jj, "jj", torch.int32, (nb,), dev)
    _kernels.require(tab.dvec, "dvec", config.FLOAT, (nb, dk), dev)
    _kernels.require(tab.a_amp, "a_amp", config.COMPLEX, (nb,), dev)
    _kernels.require(tab.b_amp, "b_amp", config.COMPLEX, (nb,), dev)
    _kernels.require(tab.cdiag, "cdiag", config.FLOAT, (n,), dev)
    T = torch.empty((B, m, m), dtype=config.COMPLEX, device=dev)
    L = torch.empty((B, m, m), dtype=config.COMPLEX, device=dev)
    _kernels.launch("colpa", dev, kpts, tab.ii, tab.jj, tab.dvec, tab.a_amp, tab.b_amp, tab.cdiag, T, L, B, n, nb, dk,
                    float(shift))
    return T, L
