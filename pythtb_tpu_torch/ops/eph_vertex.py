"""The electron-phonon vertex |g|^2: kernel 26 (``csrc/eph_vertex.cu``),
the vertex of ``pythtb_tpu.eph._gsq_qbatch_jit``.

For a chunk of electron k-points, every q of a grid and every phonon mode
nu,

    g_mn = sum_h coef_h conj(v_{k+q}[m, i_h]) v_k[n, j_h],
    coef_h = tp_h e^{2 pi i k.R_h} (dhat_h . (A[q, nu, atom(j_h)] e^{2 pi i q.R_h}
                                             - A[q, nu, atom(i_h)])),

over the directed hop list of ``eph._prep`` (states as rows, in
convention II; A the phonon amplitudes with the zero-point factor), and
the result is |g_mn|^2, (Kc, Q, nmode, S, S).

On a CUDA tensor :func:`eph_vertex` launches kernel 26 (S <= 64; above,
it raises); on a CPU tensor it runs :func:`_eph_vertex_plain`, the
reference's formula: the hop coefficients, their scatter into dH (Kc, Q,
nmode, S, S) and the band sandwich.
"""

from __future__ import annotations

import math

import torch

from .. import config
from . import _kernels

__all__ = ["eph_vertex", "VertexTables", "KERNEL_MAX_S"]

# most states kernel 26 takes (16 elements a thread of 256)
KERNEL_MAX_S = 64


class VertexTables:
    """The directed hop list of ``eph._prep`` on a device: orbitals
    ``hi``/``hj`` and their atoms ``ai``/``aj`` (int32), R (nh, d) and
    dhat (nh, d) float64, tp (nh,) complex128."""

    def __init__(self, geom, device):
        def put(x, dtype):
            return torch.as_tensor(x).to(device=device, dtype=dtype).contiguous()

        atom = geom["atom_of"]
        self.hi = put(geom["i"], torch.int32)
        self.hj = put(geom["j"], torch.int32)
        self.ai = put(atom[geom["i"]], torch.int32)
        self.aj = put(atom[geom["j"]], torch.int32)
        self.R = put(geom["R"], config.FLOAT)
        self.dhat = put(geom["dhat"], config.FLOAT)
        self.tp = put(geom["tp"], config.COMPLEX)

    @property
    def nh(self):
        return self.hi.shape[0]


def _eph_vertex_plain(vk, vkq, A, tab, kpts, qg):
    """Plain PyTorch vertex: the coefficients (Kc, Q, nmode, nh), their
    scatter into dH by ``index_put_`` (accumulating duplicates) and
    ``einsum("kqmp,kqvpr,knr->kqvmn")``.  The oracle of kernel 26."""
    Kc, Q, S = vkq.shape[0], vkq.shape[1], vkq.shape[-1]
    nmode = A.shape[1]
    two_pi = 2.0 * math.pi
    phk = torch.polar(torch.ones((Kc, tab.nh), dtype=config.FLOAT, device=vk.device), two_pi * (kpts @ tab.R.T))
    phq = torch.polar(torch.ones((Q, tab.nh), dtype=config.FLOAT, device=vk.device), two_pi * (qg @ tab.R.T))
    Ai = A[:, :, tab.ai.long()]  # (Q, nmode, nh, d)
    Aj = A[:, :, tab.aj.long()]
    bond = torch.einsum("hd,quhd->quh", tab.dhat.to(config.COMPLEX), Aj * phq[:, None, :, None] - Ai)
    coef = (tab.tp[None] * phk)[:, None, None, :] * bond[None]  # (Kc, Q, nmode, nh)
    dH = torch.zeros((Kc * Q * nmode, S * S), dtype=config.COMPLEX, device=vk.device)
    dH.index_add_(1, tab.hi.long() * S + tab.hj.long(), coef.reshape(Kc * Q * nmode, tab.nh))
    g = torch.einsum("kqmp,kqvpr,knr->kqvmn", vkq.conj(), dH.reshape(Kc, Q, nmode, S, S), vk)
    return g.real**2 + g.imag**2


def eph_vertex(vk, vkq, A, tab, kpts, qg):
    """|g|^2 (Kc, Q, nmode, S, S) float64.

    :param vk: (Kc, S, S) complex128 states of k, rows, convention II
    :param vkq: (Kc, Q, S, S) complex128 states of k + q
    :param A: (Q, nmode, natom, d) complex128 phonon amplitudes
    :param tab: :class:`VertexTables`
    :param kpts: (Kc, d) float64 electron k-points; ``qg`` (Q, d) the q-grid
    """
    if vk.device.type == "cpu":
        return _eph_vertex_plain(vk, vkq, A, tab, kpts, qg)
    Kc, Q, S = vkq.shape[0], vkq.shape[1], vkq.shape[-1]
    nmode, natom, d = A.shape[1], A.shape[2], A.shape[3]
    dev = vk.device
    if S > KERNEL_MAX_S:
        raise ValueError(
            "kernel 26 (the e-ph vertex) takes at most %d states on a CUDA tensor, got %d; "
            'call pythtb_tpu_torch.config.set_device("cpu") to run this model on the CPU' % (KERNEL_MAX_S, S))
    vk, vkq, A, kpts, qg = (t.contiguous() for t in (vk, vkq, A, kpts, qg))
    nh = tab.nh
    _kernels.require(vk, "vk", config.COMPLEX, (Kc, S, S), dev)
    _kernels.require(vkq, "vkq", config.COMPLEX, (Kc, Q, S, S), dev)
    _kernels.require(A, "A", config.COMPLEX, (Q, nmode, natom, d), dev)
    for name in ("hi", "hj", "ai", "aj"):
        _kernels.require(getattr(tab, name), name, torch.int32, (nh,), dev)
    _kernels.require(tab.R, "R", config.FLOAT, (nh, d), dev)
    _kernels.require(tab.dhat, "dhat", config.FLOAT, (nh, d), dev)
    _kernels.require(tab.tp, "tp", config.COMPLEX, (nh,), dev)
    _kernels.require(kpts, "kpts", config.FLOAT, (Kc, d), dev)
    _kernels.require(qg, "qg", config.FLOAT, (Q, d), dev)
    if Kc * Q * nmode >= 2**31:
        raise ValueError("kernel 26 takes fewer than 2^31 (k, q, mode) blocks, got %d" % (Kc * Q * nmode))
    threads = min(256, max(32, -(-S * S // 32) * 32))
    gsq = torch.empty((Kc, Q, nmode, S, S), dtype=config.FLOAT, device=dev)
    _kernels.launch("eph_vertex", dev, vk, vkq, A, tab.hi, tab.hj, tab.ai, tab.aj, tab.R, tab.tp, tab.dhat, kpts, qg,
                    gsq, Kc, Q, nmode, natom, S, d, nh, threads)
    return gsq
