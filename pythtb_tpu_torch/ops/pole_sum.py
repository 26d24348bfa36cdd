"""Schur pole sums of the DMFT lattice and impurity: kernel 20
(``csrc/pole_sum.cu``).

With ``R_m(k, z) = 1 / (z - lam_m(k))`` and the Schur form of the
correlated-orbital Green's function

    G_oo(k, z) = 1 / (z - eps_o(k) - Sigma(z) - sum_m amps[k, m] R_m(k, z)),

the four modes are

* :func:`lattice_gloc` -- k-mean: ``mean_k G_oo(k, z_w)`` (``dmft._gloc_pole_jit``,
  ``_gloc_real_pole_jit``);
* :func:`pole_sum` -- ``sum_t a_t / (z_w - p_t)`` with a complex ``z_w`` per
  frequency (``_gloc_bethe_jit`` and ``_gloc_real_bethe_jit`` with
  ``z_w - Sigma(w)`` as z, ``_lehmann_matsubara_jit`` with ``z = i w_n``);
* :func:`spectral_map` -- ``-Im G_oo(k, z_w) / pi`` (``_aspec_pole_jit``);
* :func:`spectral_resolved` -- that and the spectator diagonal
  ``-Im G_vv,jj / pi`` by the Schur identity in the H_vv eigenbasis
  (``_aspec_full_jit``).

The frequencies arrive as the complex points ``z`` themselves (``mu + i
w_n`` on the Matsubara axis, ``w + mu + i eta`` on the real axis), built
by the caller as the JAX programs build them.  CPU tensors run the plain
PyTorch versions (``_*_plain``), the JAX programs written out; a CUDA
tensor launches the kernel or raises.
"""

from __future__ import annotations

import math

import torch

from .. import config
from . import _kernels

__all__ = ["lattice_gloc", "pole_sum", "spectral_map", "spectral_resolved"]

# k-points or poles per block of the k-mean and pole modes (partial sums
# in a fixed order; the chunk keeps some 500 blocks in flight where T allows)
_KERNEL_BLOCKS = 528
# k-points a pass of the plain resolved map (bounds its (nw, k, nv) temporaries)
_PLAIN_K_CHUNK = 128


def _chunk(T):
    return min(512, max(32, -(-T // _KERNEL_BLOCKS)))


def _schur_plain(epso, amps, lams, z, sigma):
    """G_oo (nw, Nk) of the JAX programs: F = sum_m amps / (z - lam), then
    1 / (z - eps_o - Sigma - F)."""
    den = z[:, None, None] - lams[None, :, :]
    F = torch.sum(amps[None, :, :] / den, dim=-1)
    return 1.0 / (z[:, None] - epso[None, :] - sigma[:, None] - F)


def _lattice_gloc_plain(epso, amps, lams, z, sigma):
    return torch.mean(_schur_plain(epso, amps, lams, z, sigma), dim=1)


def _pole_sum_plain(amps, poles, z):
    return torch.sum(amps[None, :] / (z[:, None] - poles[None, :]), dim=1)


def _spectral_map_plain(epso, amps, lams, z, sigma):
    return -torch.imag(_schur_plain(epso, amps, lams, z, sigma)).T / math.pi


def _spectral_resolved_plain(epso, lams, W, b, z, sigma):
    """The einsums of ``_aspec_full_jit``, in passes over k."""
    Nk, nv = lams.shape
    aoo = torch.empty((Nk, z.shape[0]), dtype=config.FLOAT, device=z.device)
    avv = torch.empty((Nk, z.shape[0], nv), dtype=config.FLOAT, device=z.device)
    for k0 in range(0, Nk, _PLAIN_K_CHUNK):
        sl = slice(k0, k0 + _PLAIN_K_CHUNK)
        Wk, bk = W[sl], b[sl]
        R = 1.0 / (z[:, None, None] - lams[None, sl, :])  # (nw, k, nv)
        F = torch.sum((bk.abs() ** 2)[None, :, :] * R, dim=-1)
        goo = 1.0 / (z[:, None] - epso[None, sl] - sigma[:, None] - F)
        c = torch.einsum("kjm,km,wkm->wkj", Wk, bk, R)
        d = torch.einsum("kjm,km,wkm->wkj", Wk.conj(), bk.conj(), R)
        gvv = torch.einsum("kjm,wkm->wkj", (Wk.abs() ** 2).to(config.COMPLEX), R) + c * goo[:, :, None] * d
        aoo[sl] = -torch.imag(goo).T / math.pi
        avv[sl] = -torch.imag(gvv).transpose(0, 1) / math.pi
    return aoo, avv


def _check_schur(epso, amps, lams, z, sigma):
    Nk, nv = lams.shape
    nw = z.shape[0]
    dev = z.device
    _kernels.require(epso, "epso", config.FLOAT, (Nk,), dev)
    if amps is not None:
        _kernels.require(amps, "amps", config.FLOAT, (Nk, nv), dev)
    _kernels.require(lams, "lams", config.FLOAT, (Nk, nv), dev)
    _kernels.require(z, "z", config.COMPLEX, (nw,), dev)
    _kernels.require(sigma, "sigma", config.COMPLEX, (nw,), dev)
    return Nk, nv, nw, dev


def lattice_gloc(epso, amps, lams, z, sigma):
    """``G(w) = mean_k G_oo(k, z_w)``.

    :param epso: (Nk,) float64 correlated-orbital energies eps_o(k)
    :param amps: (Nk, nv) float64 hybridization weights |(H_ov W)_m|^2
    :param lams: (Nk, nv) float64 eigenvalues of H_vv(k)
    :param z: (nw,) complex128 frequency points; ``sigma``: (nw,) complex128
    :returns: (nw,) complex128
    """
    if z.device.type == "cpu":
        return _lattice_gloc_plain(epso, amps, lams, z, sigma)
    Nk, nv, nw, dev = _check_schur(epso, amps, lams, z, sigma)
    chunk = _chunk(Nk)
    partial = torch.empty((max(-(-Nk // chunk), 1), nw), dtype=config.COMPLEX, device=dev)
    out = torch.empty((nw,), dtype=config.COMPLEX, device=dev)
    _kernels.launch("pole_sum", dev, epso, amps, lams, z, sigma, partial, out, Nk, nv, nw, chunk, 1,
                    1.0 / Nk if Nk else 0.0)
    return out


def pole_sum(amps, poles, z):
    """``G(w) = sum_t amps_t / (z_w - poles_t)``.

    :param amps: (T,) float64 weights; ``poles``: (T,) float64
    :param z: (nw,) complex128 frequency points
    :returns: (nw,) complex128
    """
    if z.device.type == "cpu":
        return _pole_sum_plain(amps, poles, z)
    T, nw, dev = amps.shape[0], z.shape[0], z.device
    _kernels.require(amps, "amps", config.FLOAT, (T,), dev)
    _kernels.require(poles, "poles", config.FLOAT, (T,), dev)
    _kernels.require(z, "z", config.COMPLEX, (nw,), dev)
    chunk = _chunk(T)
    partial = torch.empty((max(-(-T // chunk), 1), nw), dtype=config.COMPLEX, device=dev)
    out = torch.empty((nw,), dtype=config.COMPLEX, device=dev)
    _kernels.launch("pole_sum", dev, None, amps, poles, z, None, partial, out, T, 1, nw, chunk, 0, 1.0)
    return out


def spectral_map(epso, amps, lams, z, sigma):
    """``A(k, w) = -Im G_oo(k, z_w) / pi``: (Nk, nw) float64 (arguments as
    :func:`lattice_gloc`)."""
    if z.device.type == "cpu":
        return _spectral_map_plain(epso, amps, lams, z, sigma)
    Nk, nv, nw, dev = _check_schur(epso, amps, lams, z, sigma)
    out = torch.empty((Nk, nw), dtype=config.FLOAT, device=dev)
    _kernels.launch("pole_map", dev, epso, amps, lams, z, sigma, out, Nk, nv, nw, counter="pole_sum")
    return out


def spectral_resolved(epso, lams, W, b, z, sigma):
    """``(A_oo (Nk, nw), A_vv (Nk, nw, nv))``: the correlated orbital and
    the spectator diagonal in the order of H_vv's rows.

    :param W: (Nk, nv, nv) complex128, columns the eigenvectors of H_vv(k)
    :param b: (Nk, nv) complex128, ``W^H H_vo``
    """
    if z.device.type == "cpu":
        return _spectral_resolved_plain(epso, lams, W, b, z, sigma)
    Nk, nv, nw, dev = _check_schur(epso, None, lams, z, sigma)
    _kernels.require(W, "W", config.COMPLEX, (Nk, nv, nv), dev)
    _kernels.require(b, "b", config.COMPLEX, (Nk, nv), dev)
    aoo = torch.empty((Nk, nw), dtype=config.FLOAT, device=dev)
    avv = torch.empty((Nk, nw, nv), dtype=config.FLOAT, device=dev)
    _kernels.launch("pole_resolved", dev, epso, lams, W, b, z, sigma, aoo, avv, Nk, nv, nw, counter="pole_sum")
    return aoo, avv
