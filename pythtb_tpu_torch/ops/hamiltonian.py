"""Batched Bloch-Hamiltonian assembly (counterpart of
``pythtb_tpu.ops.hamiltonian.assemble``).

H(k) = diag + sum_h amp_h e^{2 pi i k.rv_h} at (i_h, j_h), plus its
Hermitian partner at (j_h, i_h), for a whole (B, dim_k) k-batch.  On a
CUDA tensor this launches kernel 1 (``csrc/assemble.cu``), which walks
the gather index of :class:`pythtb_tpu_torch.core.BlochData`; on a CPU
tensor it runs the plain scatter version below, the scatter path of the
JAX package.  :func:`assemble_members` is kernel 1's flux-batch mode:
one hopping graph, P members of it with their own amplitudes and on-site
matrices, at shared k-points, in one launch (``magnetic.hofstadter_fn``).
:func:`assemble_one_sided` is kernel 1's one-sided mode:
the direct terms only, no partner and no diagonal (the inter-layer block
of ``pythtb_tpu.surface._one_sided``).  :func:`assemble_dk` and
:func:`assemble_d2k` are kernel 15, the analytic k-derivatives.
:func:`assemble_floquet` is kernel 1's Floquet-block mode: the truncated
extended-zone Floquet matrix of ``pythtb_tpu.floquet._spectrum_jit``,
written in one launch.  :func:`energy_vjp` is kernel 29, the backward of
band energies: the gradient of sum gbar E with respect to the amplitudes
and the on-site matrix, from the eigenvectors, without forming dL/dH.
"""

from __future__ import annotations

import math

import torch

from .. import config
from ..core import BlochData
from . import _kernels

__all__ = ["assemble", "assemble_members", "assemble_one_sided", "assemble_dk", "assemble_d2k", "assemble_floquet",
           "energy_vjp"]

# kernel 29 splits each member's k-points into chunks, aiming at this many
# blocks in all (eight per SM of an H100)
_VJP_BLOCKS = 1056


def _phases(data: BlochData, kpts):
    """Bloch phase factors exp(2j*pi*k.rv), (B, nhop)."""
    ang = (2.0 * math.pi) * (kpts @ data.rv.T)
    return torch.polar(torch.ones_like(ang), ang)


def _scatter_plain(data: BlochData, vals, diag):
    """Scatter-add the direct terms ``vals`` (B, nhop[, 2, 2]) and their
    Hermitian partners into (B, nsta, nsta), plus ``diag`` (B or 1, nsta,
    nsta)."""
    B = vals.shape[0]
    n = data.norb
    rows = torch.arange(B, device=vals.device)[:, None]
    ii, jj = data.ii[None, :], data.jj[None, :]
    if data.nspin == 1:
        H = torch.zeros((B, n, n), dtype=config.COMPLEX, device=vals.device)
        H.index_put_((rows, ii, jj), vals, accumulate=True)
        H.index_put_((rows, jj, ii), torch.conj_physical(vals), accumulate=True)
        return H + diag
    Hblk = torch.zeros((B, n, n, 2, 2), dtype=config.COMPLEX, device=vals.device)
    Hblk.index_put_((rows, ii, jj), vals, accumulate=True)
    Hblk.index_put_((rows, jj, ii), torch.conj_physical(vals.transpose(-1, -2)), accumulate=True)
    # (B, i, j, s, t) -> (B, i, s, j, t) -> (B, 2n, 2n)
    H = Hblk.permute(0, 1, 3, 2, 4).reshape(B, data.nsta, data.nsta)
    return H + diag


def _direct_terms(ph, amps):
    """amp_h e^{2 pi i k.rv_h}: phases (B, nhop) times amps (nhop[, 2, 2])."""
    return ph * amps[None] if amps.dim() == 1 else ph[:, :, None, None] * amps[None]


def _assemble_plain(data: BlochData, kpts):
    """Plain PyTorch assembly by scatter-add (``index_put_`` with
    ``accumulate=True``): the oracle of kernel 1."""
    return _scatter_plain(data, _direct_terms(_phases(data, kpts), data.amps), data.diag[None])


def _assemble_members_plain(data: BlochData, amps, diag, kpts):
    """Plain PyTorch flux-batch assembly: the scatter of
    :func:`_assemble_plain` with member p's amplitudes ``amps[p]`` and
    on-site matrix ``diag[p]`` at every k-point.  The oracle of kernel 1's
    flux-batch mode."""
    P, NK = amps.shape[0], kpts.shape[0]
    ph = _phases(data, kpts)
    vals = torch.cat([_direct_terms(ph, a) for a in amps]) if P else ph.new_zeros((0,) + tuple(amps.shape[1:]))
    return _scatter_plain(data, vals, diag.repeat_interleave(NK, dim=0))


def _one_sided_plain(data: BlochData, kpts):
    """Plain PyTorch one-sided assembly (the scatter of
    ``pythtb_tpu.surface._one_sided``): the oracle of kernel 1's one-sided
    mode."""
    B = kpts.shape[0]
    n = data.norb
    ph = _phases(data, kpts)
    rows = torch.arange(B, device=kpts.device)[:, None]
    ii, jj = data.ii[None, :], data.jj[None, :]
    if data.nspin == 1:
        H = torch.zeros((B, n, n), dtype=config.COMPLEX, device=kpts.device)
        H.index_put_((rows, ii, jj), ph * data.amps[None, :], accumulate=True)
        return H
    Hblk = torch.zeros((B, n, n, 2, 2), dtype=config.COMPLEX, device=kpts.device)
    Hblk.index_put_((rows, ii, jj), ph[:, :, None, None] * data.amps[None], accumulate=True)
    return Hblk.permute(0, 1, 3, 2, 4).reshape(B, data.nsta, data.nsta)


def _launch(data: BlochData, kpts, one_sided):
    B = kpts.shape[0]
    nsta = data.nsta
    dev = data.device
    _kernels.require(kpts, "kpts", config.FLOAT, (B, data.dim_k), dev)
    _kernels.require(data.rv, "rv", config.FLOAT, (data.nhop, data.dim_k), dev)
    _kernels.require(data.amps, "amps", config.COMPLEX, (data.nhop,) + (2, 2)[: 2 * (data.nspin - 1)], dev)
    _kernels.require(data.diag, "diag", config.COMPLEX, (nsta, nsta), dev)
    _kernels.require(data.ptr, "ptr", torch.int32, (data.norb**2 + 1,), dev)
    _kernels.require(data.ent, "ent", torch.int32, (2 * data.nhop,), dev)
    H = torch.empty((B, nsta, nsta), dtype=config.COMPLEX, device=dev)
    _kernels.launch(
        "assemble", dev, kpts, data.rv, data.amps, data.diag, data.ptr, data.ent, H,
        B, data.dim_k, data.norb, data.nspin, int(one_sided),
        counter="assemble_one_sided" if one_sided else None,
    )
    return H


def assemble(data: BlochData, kpts):
    """H(k) for a k-batch.

    :param kpts: (B, dim_k) float64 tensor of reduced k-points, on the
      device of ``data``
    :returns: (B, nsta, nsta) complex128, Hermitian; at nspin 2 the basis
      is (orb0_up, orb0_dn, orb1_up, ...)
    """
    B = kpts.shape[0]
    if data.nhop == 0:
        return data.diag.expand(B, data.nsta, data.nsta).clone()
    if kpts.device.type == "cpu":
        return _assemble_plain(data, kpts)
    return _launch(data, kpts, False)


def assemble_members(data: BlochData, amps, diag, kpts):
    """H(k) of P members of one hopping graph at shared k-points: member
    p has amplitudes ``amps[p]`` (P, nhop) complex128 ((P, nhop, 2, 2) at
    nspin 2, in ``data``'s hopping order) and on-site matrix ``diag[p]``
    (P, nsta, nsta); ``data`` gives the graph (rv and the gather index).
    Returns (P * NK, nsta, nsta), member-major: row p * NK + i is member
    p at k-point i.  One launch of kernel 1's flux-batch mode on the
    card."""
    P, NK = amps.shape[0], kpts.shape[0]
    if data.nhop == 0:
        return diag.repeat_interleave(NK, dim=0)
    if kpts.device.type == "cpu":
        return _assemble_members_plain(data, amps, diag, kpts)
    dev = data.device
    _kernels.require(kpts, "kpts", config.FLOAT, (NK, data.dim_k), dev)
    _kernels.require(data.rv, "rv", config.FLOAT, (data.nhop, data.dim_k), dev)
    _kernels.require(amps, "amps", config.COMPLEX, (P, data.nhop) + (2, 2)[: 2 * (data.nspin - 1)], dev)
    _kernels.require(diag, "diag", config.COMPLEX, (P, data.nsta, data.nsta), dev)
    _kernels.require(data.ptr, "ptr", torch.int32, (data.norb**2 + 1,), dev)
    _kernels.require(data.ent, "ent", torch.int32, (2 * data.nhop,), dev)
    H = torch.empty((P * NK, data.nsta, data.nsta), dtype=config.COMPLEX, device=dev)
    _kernels.launch("assemble_members", dev, kpts, data.rv, amps, diag, data.ptr, data.ent, H,
                    P, NK, data.dim_k, data.norb, data.nspin, data.nhop)
    return H


def assemble_one_sided(data: BlochData, kpts):
    """The one-sided block sum_h amp_h e^{2 pi i k.rv_h} at (i_h, j_h):
    no Hermitian partner, no diagonal.  Same arguments and layout as
    :func:`assemble`; the result is not Hermitian."""
    B = kpts.shape[0]
    if data.nhop == 0:
        return torch.zeros((B, data.nsta, data.nsta), dtype=config.COMPLEX, device=kpts.device)
    if kpts.device.type == "cpu":
        return _one_sided_plain(data, kpts)
    return _launch(data, kpts, True)


def _deriv_plain(data: BlochData, kpts, fac):
    """Scatter of the direct terms times ``fac`` (nhop, *dirs) and of
    their conjugates at the partner sites: the shared body of the plain
    derivatives (``pythtb_tpu.ops.hamiltonian.assemble_dk`` :146-165 and
    ``assemble_d2k`` :199-213).  Returns (B, *dirs, nsta, nsta)."""
    B = kpts.shape[0]
    n = data.norb
    dirs = tuple(fac.shape[1:])
    nd = len(dirs)
    ph = _phases(data, kpts)
    rows = torch.arange(B, device=kpts.device).reshape((B,) + (1,) * (nd + 1))
    didx = torch.meshgrid(*[torch.arange(d, device=kpts.device) for d in dirs], indexing="ij")
    didx = [g[None, ..., None] for g in didx]
    ii = data.ii.reshape((1,) * (nd + 1) + (-1,))
    jj = data.jj.reshape((1,) * (nd + 1) + (-1,))
    # dv[b, *dirs, h]: the direct term's derivative
    fac_h = torch.movedim(fac, 0, -1)[None]
    if data.nspin == 1:
        dv = (ph * data.amps[None, :]).reshape((B,) + (1,) * nd + (-1,)) * fac_h
        out = torch.zeros((B,) + dirs + (n, n), dtype=config.COMPLEX, device=kpts.device)
        out.index_put_((rows, *didx, ii, jj), dv, accumulate=True)
        out.index_put_((rows, *didx, jj, ii), torch.conj_physical(dv), accumulate=True)
        return out
    vals = ph[:, :, None, None] * data.amps[None]  # (B, nhop, 2, 2)
    dv = vals.reshape((B,) + (1,) * nd + tuple(vals.shape[1:])) * fac_h[..., None, None]
    blk = torch.zeros((B,) + dirs + (n, n, 2, 2), dtype=config.COMPLEX, device=kpts.device)
    blk.index_put_((rows, *didx, ii, jj), dv, accumulate=True)
    blk.index_put_((rows, *didx, jj, ii), torch.conj_physical(dv.transpose(-1, -2)), accumulate=True)
    # (B, *dirs, i, j, s, t) -> (B, *dirs, i, s, j, t)
    blk = blk.permute(*range(nd + 1), nd + 1, nd + 3, nd + 2, nd + 4)
    return blk.reshape((B,) + dirs + (data.nsta, data.nsta))


def _assemble_dk_plain(data: BlochData, kpts):
    """Plain PyTorch dH/dk_a: each direct term times 2 pi i rv_a, the
    partner its conjugate, no diagonal.  The oracle of kernel 15."""
    fac = torch.complex(torch.zeros_like(data.rv), (2.0 * math.pi) * data.rv)
    return _deriv_plain(data, kpts, fac)


def _assemble_d2k_plain(data: BlochData, kpts):
    """Plain PyTorch d2H/dk_a dk_b: each direct term times
    -(2 pi)^2 rv_a rv_b (real), the partner its conjugate.  The oracle
    of kernel 15's second-order mode."""
    rv = data.rv
    fac2 = -((2.0 * math.pi) ** 2) * rv[:, :, None] * rv[:, None, :]
    return _deriv_plain(data, kpts, fac2.to(config.COMPLEX))


def _launch_deriv(data: BlochData, kpts, order):
    B, dim = kpts.shape[0], data.dim_k
    if dim > 3:
        raise ValueError("kernel 15 takes dim_k <= 3, got %d" % dim)
    dev = data.device
    _kernels.require(kpts, "kpts", config.FLOAT, (B, dim), dev)
    _kernels.require(data.rv, "rv", config.FLOAT, (data.nhop, dim), dev)
    _kernels.require(data.amps, "amps", config.COMPLEX, (data.nhop,) + (2, 2)[: 2 * (data.nspin - 1)], dev)
    _kernels.require(data.ptr, "ptr", torch.int32, (data.norb**2 + 1,), dev)
    _kernels.require(data.ent, "ent", torch.int32, (2 * data.nhop,), dev)
    out = torch.empty((B,) + (dim,) * order + (data.nsta, data.nsta), dtype=config.COMPLEX, device=dev)
    _kernels.launch(
        "assemble_deriv", dev, kpts, data.rv, data.amps, data.ptr, data.ent, out,
        B, dim, data.norb, data.nspin, order, counter="assemble_dk",
    )
    return out


def _derivative(data: BlochData, kpts, order):
    B, dim = kpts.shape[0], data.dim_k
    if data.nhop == 0 or dim == 0:
        return torch.zeros((B,) + (dim,) * order + (data.nsta, data.nsta), dtype=config.COMPLEX,
                           device=kpts.device)
    if kpts.device.type == "cpu":
        return (_assemble_dk_plain if order == 1 else _assemble_d2k_plain)(data, kpts)
    return _launch_deriv(data, kpts, order)


def assemble_dk(data: BlochData, kpts):
    """Analytic k-gradient of H: dH/dk_a for a k-batch, (B, dim_k, nsta,
    nsta) complex128, each slice Hermitian.

    Derivatives are with respect to REDUCED k-coordinates.  Because
    :func:`assemble` uses Convention I (phases carry the full r-vector
    rv = R + t_j - t_i along the periodic directions), this is the
    velocity operator including the orbital-position embedding.  Zeros
    when the model has no hoppings or no periodic direction."""
    return _derivative(data, kpts, 1)


def assemble_d2k(data: BlochData, kpts):
    """Analytic second k-derivative of H: d2H/dk_a dk_b for a k-batch,
    (B, dim_k, dim_k, nsta, nsta) complex128, each slice Hermitian and
    symmetric in (a, b); same conventions as :func:`assemble_dk`."""
    return _derivative(data, kpts, 2)


def _assemble_hm_plain(data: BlochData, kpts, fac, fac_partner):
    """sum_h amp_h e^{2 pi i k.rv_h} fac[m, h] at (i_h, j_h) plus
    conj(amp_h e^{2 pi i k.rv_h}) fac_partner[m, h] at (j_h, i_h), (B, nm,
    nsta, nsta), no diagonal: the scatter of
    ``pythtb_tpu.floquet._assemble_hm``."""
    B = kpts.shape[0]
    n = data.norb
    nm = fac.shape[0]
    if data.nhop == 0:
        return torch.zeros((B, nm, data.nsta, data.nsta), dtype=config.COMPLEX, device=kpts.device)
    ph = _phases(data, kpts)
    ii, jj = data.ii, data.jj
    if data.nspin == 1:
        direct = ph[:, None, :] * (data.amps[None, None, :] * fac[None])
        partner = torch.conj_physical(ph[:, None, :] * data.amps[None, None, :]) * fac_partner[None]
        H = torch.zeros((B, nm, n, n), dtype=config.COMPLEX, device=kpts.device)
        rows = torch.arange(B, device=kpts.device)[:, None, None]
        ms = torch.arange(nm, device=kpts.device)[None, :, None]
        H.index_put_((rows, ms, ii[None, None], jj[None, None]), direct, accumulate=True)
        H.index_put_((rows, ms, jj[None, None], ii[None, None]), partner, accumulate=True)
        return H
    vals = ph[:, None, :, None, None] * (data.amps[None, None] * fac[None, :, :, None, None])
    pvals = torch.conj_physical(ph[:, None, :, None, None] * data.amps.transpose(-1, -2)[None, None]) * \
        fac_partner[None, :, :, None, None]
    Hblk = torch.zeros((B, nm, n, n, 2, 2), dtype=config.COMPLEX, device=kpts.device)
    rows = torch.arange(B, device=kpts.device)[:, None, None]
    ms = torch.arange(nm, device=kpts.device)[None, :, None]
    Hblk.index_put_((rows, ms, ii[None, None], jj[None, None]), vals, accumulate=True)
    Hblk.index_put_((rows, ms, jj[None, None], ii[None, None]), pvals, accumulate=True)
    return Hblk.permute(0, 1, 2, 4, 3, 5).reshape(B, nm, data.nsta, data.nsta)


def _assemble_floquet_plain(data: BlochData, kpts, fac, ons, omega, nharm):
    """Plain Floquet matrix: :func:`_assemble_hm_plain` with the partner
    factors conj(fac[::-1]), the static diagonal on H_0, the on-site
    harmonics on every H_m's diagonal, then the block gather K[p, q] =
    H_{p - q} plus (p - M) omega on the diagonal blocks (the steps of
    ``pythtb_tpu.floquet._spectrum_jit``).  The oracle of kernel 1's
    Floquet-block mode."""
    B, S = kpts.shape[0], data.nsta
    mmax = 2 * nharm
    Hm = _assemble_hm_plain(data, kpts, fac, torch.conj_physical(fac.flip(0)))
    Hm[:, mmax] += data.diag[None]
    idx = torch.arange(S, device=kpts.device)
    Hm[:, :, idx, idx] += ons[None]
    NM = 2 * nharm + 1
    p = torch.arange(NM, device=kpts.device)
    K = Hm[:, p[:, None] - p[None, :] + mmax]  # (B, NM, NM, S, S)
    shift = (p - nharm).to(config.FLOAT) * float(omega)
    K[:, p[:, None], p[:, None], idx[None, :], idx[None, :]] += shift[:, None].to(config.COMPLEX)
    return K.permute(0, 1, 3, 2, 4).reshape(B, NM * S, NM * S)


def assemble_floquet(data: BlochData, kpts, fac, ons, omega, nharm):
    """The truncated Floquet matrix K (B, NM nsta, NM nsta), NM = 2 nharm +
    1: block (p, q) is H_{p-q} + (p - nharm) omega delta_pq, where H_m
    carries the direct hops times ``fac[m]`` and their partners times
    conj(fac[-m]), the static diagonal at m = 0 and ``ons[m]`` on its
    diagonal.

    :param fac: (4 nharm + 1, nhop) complex128 hop harmonics, m = -2
      nharm..2 nharm
    :param ons: (4 nharm + 1, nsta) complex128 on-site harmonics
    """
    B = kpts.shape[0]
    if kpts.device.type == "cpu":
        return _assemble_floquet_plain(data, kpts, fac, ons, omega, nharm)
    dev = data.device
    nm, S = 4 * nharm + 1, data.nsta
    _kernels.require(kpts, "kpts", config.FLOAT, (B, data.dim_k), dev)
    _kernels.require(data.rv, "rv", config.FLOAT, (data.nhop, data.dim_k), dev)
    _kernels.require(data.amps, "amps", config.COMPLEX, (data.nhop,) + (2, 2)[: 2 * (data.nspin - 1)], dev)
    _kernels.require(data.diag, "diag", config.COMPLEX, (S, S), dev)
    _kernels.require(fac, "fac", config.COMPLEX, (nm, data.nhop), dev)
    _kernels.require(ons, "ons", config.COMPLEX, (nm, S), dev)
    _kernels.require(data.ptr, "ptr", torch.int32, (data.norb**2 + 1,), dev)
    _kernels.require(data.ent, "ent", torch.int32, (2 * data.nhop,), dev)
    dimK = (2 * nharm + 1) * S
    K = torch.empty((B, dimK, dimK), dtype=config.COMPLEX, device=dev)
    _kernels.launch("assemble_floquet", dev, kpts, data.rv, data.amps, data.diag, fac, ons, data.ptr, data.ent, K,
                    B, data.dim_k, data.norb, data.nspin, data.nhop, nharm, float(omega))
    return K


def _hermitian_part(diag):
    """(D + D^H) / 2 over the last two axes: the on-site matrix whose band
    energies :func:`energy_vjp` differentiates (the JAX package's eigh
    symmetrizes its input the same way)."""
    return 0.5 * (diag + diag.conj().transpose(-1, -2))


def _band_energies_plain(data: BlochData, amps, diag, kpts):
    """Band energies (P * NK, nsta) of P members (``amps`` (P, nhop[, 2,
    2]), ``diag`` (P, nsta, nsta)) at ``kpts``: the plain flux-batch
    assembly of the on-site matrices' Hermitian parts, then the plain
    eigensolver.  Differentiable by torch autograd."""
    from .eigh import _eigvalsh_plain

    return _eigvalsh_plain(_assemble_members_plain(data, amps, _hermitian_part(diag), kpts))


def _energy_vjp_plain(data: BlochData, amps, diag, kpts, gbar):
    """Torch autograd of sum(gbar * E) through :func:`_band_energies_plain`:
    the oracle of kernel 29.  Returns (g_amps, g_diag) in torch's
    convention for complex leaves (dL/dRe + i dL/dIm)."""
    with torch.enable_grad():
        a = amps.detach().requires_grad_(True)
        d = diag.detach().requires_grad_(True)
        E = _band_energies_plain(data, a, d, kpts)
        ga, gd = torch.autograd.grad(E, (a, d), grad_outputs=gbar.to(E.dtype), allow_unused=True)
    return (torch.zeros_like(a) if ga is None else ga), (torch.zeros_like(d) if gd is None else gd)


def energy_vjp(data: BlochData, amps, diag, kpts, U, gbar):
    """Gradient of L = sum gbar * E, E the band energies of P members of
    ``data``'s hopping graph (``amps`` (P, nhop[, 2, 2]), ``diag`` (P,
    nsta, nsta) complex128) at the NK points ``kpts``, with respect to
    the amplitudes and the on-site matrix.

    :param U: (P * NK, nsta, nsta) complex128 eigenvectors (rows are
      states) of the members' H(k), member-major (kernel 1's flux-batch
      layout)
    :param gbar: (P * NK, nsta) float64 cotangent of the energies
    :returns: (g_amps (P, nhop[, 2, 2]), g_diag (P, nsta, nsta)) complex128,
      torch's gradient of a complex leaf (dL/dRe + i dL/dIm): with
      G_k = sum_n gbar_kn u_n u_n^H, g_amps[h] = 2 sum_k G_k[i_h, j_h]
      e^{-2 pi i k.rv_h} and g_diag = sum_k G_k, the energies being
      those of the on-site matrix's Hermitian part

    On a CUDA tensor this launches kernel 29 (``csrc/energy_vjp.cu``),
    which reads U and never forms dL/dH; on a CPU tensor it runs
    :func:`_energy_vjp_plain`, torch autograd through the plain assembly
    and eigensolver (``U`` unused).
    """
    if U.device.type == "cpu":
        return _energy_vjp_plain(data, amps, diag, kpts, gbar)
    P, NK, S = amps.shape[0], kpts.shape[0], data.nsta
    if P > 65535:
        raise ValueError("kernel 29 takes at most 65,535 members, got %d" % P)
    dev = data.device
    blk = (2, 2)[: 2 * (data.nspin - 1)]
    U, gbar, kpts = U.contiguous(), gbar.contiguous(), kpts.contiguous()
    _kernels.require(U, "U", config.COMPLEX, (P * NK, S, S), dev)
    _kernels.require(gbar, "gbar", config.FLOAT, (P * NK, S), dev)
    _kernels.require(kpts, "kpts", config.FLOAT, (NK, data.dim_k), dev)
    _kernels.require(data.rv, "rv", config.FLOAT, (data.nhop, data.dim_k), dev)
    _kernels.require(data.ii, "ii", torch.int64, (data.nhop,), dev)
    _kernels.require(data.jj, "jj", torch.int64, (data.nhop,), dev)
    chunks = max(1, min(-(-NK // 8), -(-_VJP_BLOCKS // P)))
    kchunk = -(-NK // chunks)
    nout = data.nhop * data.nspin**2 + S * S
    partial = torch.empty((P, -(-NK // kchunk), nout), dtype=config.COMPLEX, device=dev)
    g_amps = torch.empty((P, data.nhop) + blk, dtype=config.COMPLEX, device=dev)
    g_diag = torch.empty((P, S, S), dtype=config.COMPLEX, device=dev)
    _kernels.launch("energy_vjp", dev, U, gbar, kpts, data.rv, data.ii, data.jj, partial, g_amps, g_diag,
                    P, NK, kchunk, data.dim_k, S, data.nspin, data.nhop)
    return g_amps, g_diag
