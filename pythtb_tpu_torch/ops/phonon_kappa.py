"""The phonon kappa sweep: kernel 25 (``csrc/phonon_kappa.cu``), the
velocity and heat-capacity part of ``pythtb_tpu.phonon._kappa_jit``.

From the eigenvectors of D(k) (rows are modes), dD/dk_a (kernel 15), the
frequencies omega and the temperatures T it returns the RTA sums in
reduced coordinates

    kappa_red[t, a, c] = (1 / B) sum_{b, n} c_v(omega_bn / T_t) v_a v_c,
    v_a = Re(e_n^H dD_a e_n) / (2 omega_bn)   (0 where omega <= 1e-9),
    c_v(x) = (x / (2 sinh(min(x, 80) / 2)))^2 (1 where x < 1e-8),

the clamp at 80 being the reference's (``heat_capacity`` clamps at 350 on
the host, and keeps it).  On a CUDA tensor :func:`phonon_kappa` launches
kernel 25; on a CPU tensor it runs :func:`_phonon_kappa_plain`, the
reference's einsums.
"""

from __future__ import annotations

import torch

from .. import config
from . import _kernels

__all__ = ["phonon_kappa", "KERNEL_MAX_DIM"]

# most periodic directions kernel 25 takes (velocities in registers)
KERNEL_MAX_DIM = 3
_THREADS = 256  # kernel 25's block: one (k, mode) pair a thread


def _cv(x):
    xs = torch.where(x < 1e-8, torch.ones_like(x), x)
    return torch.where(x < 1e-8, torch.ones_like(x), (xs / (2.0 * torch.sinh(torch.clamp(xs, max=80.0) / 2.0))) ** 2)


def _phonon_kappa_plain(vecs, dD, omega, Ts):
    """Plain PyTorch sweep: the reference's Hellmann-Feynman einsum, the
    guarded velocities and the c_v-weighted outer product.  The oracle of
    kernel 25."""
    B = vecs.shape[0]
    dw2 = torch.einsum("bns,bast,bnt->ban", vecs.conj(), dD, vecs).real
    safe = (omega > 1e-9)[:, None, :]
    v = torch.where(safe, dw2 / torch.where(safe, 2.0 * omega[:, None, :], torch.ones_like(dw2)),
                    torch.zeros_like(dw2))
    cv = _cv(omega[None] / Ts[:, None, None])
    return torch.einsum("tbn,ban,bcn->tac", cv, v, v) / B


def phonon_kappa(vecs, dD, omega, Ts):
    """kappa_red (nT, dim_k, dim_k) float64.

    :param vecs: (B, N, N) complex128 eigenvectors of D(k), rows = modes
    :param dD: (B, dim_k, N, N) complex128 dD/dk_a (reduced k)
    :param omega: (B, N) float64 frequencies sqrt(max(w2, 0))
    :param Ts: (nT,) float64 temperatures, positive
    """
    if vecs.device.type == "cpu":
        return _phonon_kappa_plain(vecs, dD, omega, Ts)
    B, N = omega.shape
    dk, nT = dD.shape[1], Ts.shape[0]
    dev = vecs.device
    if dk > KERNEL_MAX_DIM:
        raise ValueError("kernel 25 takes dim_k <= %d, got %d" % (KERNEL_MAX_DIM, dk))
    vecs, dD, omega, Ts = (t.contiguous() for t in (vecs, dD, omega, Ts))
    _kernels.require(vecs, "vecs", config.COMPLEX, (B, N, N), dev)
    _kernels.require(dD, "dD", config.COMPLEX, (B, dk, N, N), dev)
    _kernels.require(omega, "omega", config.FLOAT, (B, N), dev)
    _kernels.require(Ts, "Ts", config.FLOAT, (nT,), dev)
    blocks = -(-(B * N) // _THREADS)
    partial = torch.empty((blocks, nT, dk, dk), dtype=config.FLOAT, device=dev)
    out = torch.empty((nT, dk, dk), dtype=config.FLOAT, device=dev)
    _kernels.launch("phonon_kappa", dev, vecs, dD, omega, Ts, partial, out, B, N, dk, nT)
    return out
