"""Optical response of periodic models: Kubo interband conductivity,
shift and injection currents, joint density of states (counterpart of
``pythtb_tpu.optical``).

The k-grid is built on the device, solved by one batched eigh (kernel 2
at two bands), and the velocity matrices come from the analytic
k-gradient (kernel 15, :func:`pythtb_tpu_torch.ops.hamiltonian.assemble_dk`,
Convention I) rotated to Cartesian axes; the band-basis products
``U^H dH U`` and the lattice contractions are ``torch.einsum``, as the
JAX package leaves them to XLA.  The frequency contraction

    acc[p, w] = sum_t W[p, t] K(omega_w - de_t)

with a Lorentzian K (the Kubo tensor) or a Gaussian K (shift and
injection currents, joint DOS) is kernel 16 (``csrc/spectral_sum.cu``)
through :func:`spectral_sum` on a CUDA tensor, and the chunked einsum of
the JAX package (:func:`_spectral_sum_plain`) on a CPU tensor.

Physics, units and the Hall orientation are those of the JAX package:
``sigma_ab(w) = (i / (N_k V_c)) sum_{k, n != m} (f_n - f_m) / (e_m - e_n)
v^b_nm v^a_mn / (w - (e_m - e_n) + i eta)`` reported as the MIRRORED
tensor, so that ``sigma_xy(w -> 0) == chern_number(...)`` in e^2/h, plus
the intraband Drude term at ``temperature > 0``.

:func:`harmonic_spectrum` evolves the filled bands under the exact
Peierls Hamiltonian H(k + A(t)).  Per chunk of steps, with the frequency
batch folded into the rows, it assembles every step's H(k + A_mid) in
one kernel-1 launch, solves them in one ``eigh_batched``, assembles dH at
the step ends in one kernel-15 launch, and lets kernel 22
(:func:`pythtb_tpu_torch.ops.propagate.propagate_state`) walk the chain
and read the current; the field A(t) and the Fourier analysis of the
final periods are the JAX package's host code.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import config
from .model import PythtbError
from .ops import _kernels
from .ops.eigh import eigh_batched, eigvalsh_batched
from .ops.hamiltonian import assemble, assemble_d2k, assemble_dk
from .ops.propagate import chunk_steps, propagate_state
from .ops.solver import device_uniform_grid

__all__ = ["optical_conductivity", "joint_dos", "shift_current", "injection_current", "harmonic_spectrum",
           "spectral_sum", "spectral_sum_qbatch"]

# transitions per chunk of the plain contraction (the JAX package's _CHUNK)
_CHUNK = 4096
# kernel 16 splits T into chunks of 32-512 transitions, one block each,
# aiming at this many blocks (four per SM of an H100) for a frequency tile
_KERNEL_BLOCKS = 528


def _kernel_chunk(T):
    """Transitions per block of kernel 16 at T transitions."""
    return min(512, max(32, -(-T // _KERNEL_BLOCKS)))


def _kernel_matrix(de, omegas, width, mode):
    x = omegas[None, :] - de[:, None]
    if mode == "lorentz":
        return 1.0 / (x + 1j * width)
    y = x / width
    return torch.exp(-0.5 * y * y) / (width * math.sqrt(2.0 * math.pi))


def _spectral_sum_plain(W, de, omegas, width, mode):
    """Plain PyTorch spectral sum: the (C, nw) kernel matrix of each chunk
    of 4,096 transitions, contracted with W's columns and accumulated in
    chunk order (the lax.scan of the JAX package).  The oracle of kernel
    16."""
    acc = torch.zeros((W.shape[0], omegas.shape[0]), dtype=W.dtype, device=W.device)
    for t0 in range(0, de.shape[0], _CHUNK):
        acc = acc + W[:, t0 : t0 + _CHUNK] @ _kernel_matrix(de[t0 : t0 + _CHUNK], omegas, width, mode).to(W.dtype)
    return acc


def spectral_sum(W, de, omegas, width, mode):
    """acc (P, nw) = sum_t W[p, t] K(omegas[w] - de[t]).

    :param W: (P, T) weights, complex128 for ``mode="lorentz"`` (K = 1 /
      (x + i width)), float64 for ``mode="gauss"`` (K = exp(-x^2 / (2
      width^2)) / (width sqrt(2 pi)))
    :param de: (T,) float64 transition energies
    :param omegas: (nw,) float64 frequencies
    """
    if mode not in ("lorentz", "gauss"):
        raise ValueError("mode must be 'lorentz' or 'gauss', got %r" % (mode,))
    if W.device.type == "cpu":
        return _spectral_sum_plain(W, de, omegas, width, mode)
    P, T = W.shape
    nw = omegas.shape[0]
    dev = W.device
    dtype = config.COMPLEX if mode == "lorentz" else config.FLOAT
    _kernels.require(W, "W", dtype, (P, T), dev)
    _kernels.require(de, "de", config.FLOAT, (T,), dev)
    _kernels.require(omegas, "omegas", config.FLOAT, (nw,), dev)
    if not float(width) > 0.0:
        raise ValueError("width must be positive, got %g" % float(width))
    chunk = _kernel_chunk(T)
    buf = torch.empty((max(-(-T // chunk), 1), P, nw), dtype=dtype, device=dev)
    out = torch.empty((P, nw), dtype=dtype, device=dev)
    _kernels.launch("spectral_sum", dev, de, W, omegas, buf, out, T, P, nw, chunk, int(mode == "lorentz"),
                    float(width))
    return out


def _spectral_sum_qbatch_plain(W, de, omegas, width):
    """Plain PyTorch q-batch Lorentzian sum: :func:`_spectral_sum_plain`
    for each q.  The oracle of kernel 16's q-batch mode."""
    return torch.stack([_spectral_sum_plain(W[q], de[q], omegas, width, "lorentz") for q in range(W.shape[0])])


def spectral_sum_qbatch(W, de, omegas, width):
    """acc (Q, P, nw) = sum_t W[q, p, t] / (omegas[w] - de[q, t] + i width):
    the Lorentzian :func:`spectral_sum` of Q independent transition sets
    against one frequency grid, one launch of kernel 16's q-batch mode on
    a CUDA tensor.

    :param W: (Q, P, T) complex128 weights
    :param de: (Q, T) float64 transition energies
    :param omegas: (nw,) float64 frequencies
    """
    if W.device.type == "cpu":
        return _spectral_sum_qbatch_plain(W, de, omegas, width)
    Q, P, T = W.shape
    nw = omegas.shape[0]
    dev = W.device
    _kernels.require(W, "W", config.COMPLEX, (Q, P, T), dev)
    _kernels.require(de, "de", config.FLOAT, (Q, T), dev)
    _kernels.require(omegas, "omegas", config.FLOAT, (nw,), dev)
    if not float(width) > 0.0:
        raise ValueError("width must be positive, got %g" % float(width))
    if Q * -(-P // 8) > 65535:
        raise ValueError("kernel 16's q-batch mode takes at most 65,535 (q, column group) pairs, got %d"
                         % (Q * -(-P // 8)))
    chunk = _kernel_chunk(T)
    buf = torch.empty((Q, max(-(-T // chunk), 1), P, nw), dtype=config.COMPLEX, device=dev)
    out = torch.empty((Q, P, nw), dtype=config.COMPLEX, device=dev)
    _kernels.launch("spectral_sum_qbatch", dev, de, W, omegas, buf, out, Q, T, P, nw, chunk, float(width))
    return out


def _velocity_tensors(data, kpts, lat, need_d2=True):
    """Solve at ``kpts``: (evals, vecs, V, W2) -- eigenvectors (rows are
    states), the band-basis Cartesian velocities V[b, a, n, m] = <n| dH/dk_a
    |m> (B, d, S, S) from kernel 15's reduced gradient, and, with
    ``need_d2``, the second-derivative matrix elements W2 (B, d, d, S, S)."""
    evals, vecs = eigh_batched(assemble(data, kpts))
    latc = torch.as_tensor(lat, dtype=config.COMPLEX).to(data.device)
    dHc = torch.einsum("ra,brij->baij", latc, assemble_dk(data, kpts)) / (2.0 * math.pi)
    V = torch.einsum("bns,bast,bmt->banm", vecs.conj(), dHc, vecs)
    if not need_d2:
        return evals, vecs, V, None
    d2c = torch.einsum("ra,sc,brsij->bacij", latc, latc, assemble_d2k(data, kpts)) / ((2.0 * math.pi) ** 2)
    W2 = torch.einsum("bns,bacst,bmt->bacnm", vecs.conj(), d2c, vecs)
    return evals, vecs, V, W2


def _band_tensors(data, nk, lat, need_d2=True):
    """:func:`_velocity_tensors` on the uniform grid ``nk`` from the origin."""
    kpts = device_uniform_grid(nk, np.zeros(data.dim_k), data.device)
    return _velocity_tensors(data, kpts, lat, need_d2)


def _inv_gaps(evals, tiny):
    """(mask, 1/D) with D[n, m] = e_n - e_m, zero where |D| <= tiny."""
    D = evals[:, :, None] - evals[:, None, :]
    mask = D.abs() > tiny
    inv = torch.where(mask, 1.0 / torch.where(mask, D, torch.ones_like(D)), torch.zeros_like(D))
    return mask, inv


def _inverse_mass(evals, V, W2):
    """Band second derivatives d2e_n / dk_a dk_c (B, d, d, S) by the exact
    sum rule W2_nn + 2 Re sum_m V^a_nm V^c_mn / (e_n - e_m), pairs within
    1e-7 of degeneracy left out."""
    _, invD = _inv_gaps(evals, 1e-7)
    inter = 2.0 * torch.einsum("banm,bcmn,bnm->bacn", V, V, invD.to(V.dtype)).real
    return torch.diagonal(W2, dim1=-2, dim2=-1).real + inter


def _gen_derivative(evals, V, W2, tiny):
    """Sum-rule generalized derivative of the interband position matrix
    (Sipe-Shkrebtii PRB 61, 5337 (2000)), as
    ``pythtb_tpu.optical._gen_derivative``:
    r^{c;a}_nm = (i/D_nm)[(V^a_nm Dl^c_nm + V^c_nm Dl^a_nm)/D_nm - W2^{ac}_nm + S3^{ac}_nm].
    Returns (r (B, d, S, S), rgen (B, d, d, S, S)), rgen[:, a, c] = r^{c;a}."""
    mask, inv = _inv_gaps(evals, tiny)
    invc = inv.to(V.dtype)
    r = -1j * V * invc[:, None]
    Vd = torch.diagonal(V, dim1=-2, dim2=-1)  # (B, d, S)
    Dl = Vd[:, :, :, None] - Vd[:, :, None, :]
    full1 = torch.einsum("banp,bcpm->bacnm", V, V * invc[:, None])
    c1 = Vd[:, :, None, :, None] * V[:, None, :] * invc[:, None, None]
    full2 = torch.einsum("bcnp,bapm->bacnm", V * invc[:, None], V)
    c2 = V[:, None, :] * Vd[:, :, None, None, :] * invc[:, None, None]
    S3 = (full1 - c1) - (full2 - c2)
    bracket = ((V[:, :, None] * Dl[:, None, :] + V[:, None, :] * Dl[:, :, None]) * invc[:, None, None]
               - W2 + S3)
    zero = torch.zeros((), dtype=V.dtype, device=V.device)
    rgen = torch.where(mask[:, None, None], 1j * bracket * invc[:, None, None], zero)
    r = torch.where(mask[:, None], r, zero)
    return r, rgen


def _band_velocity_weights(data, nk, occ, mu_t, lat):
    """Transition energies de = e_m - e_n and pair weights W[b, a, c, n*S+m]
    = (f_n - f_m)/(e_m - e_n) v^a_nm v^c_mn / N_k over (k, n, m), and the
    Drude weights (d, d)."""
    evals, _vecs, V, _ = _band_tensors(data, nk, lat, need_d2=False)
    if occ is not None:
        f = torch.zeros(data.nsta, dtype=config.FLOAT, device=data.device)
        f[list(occ)] = 1.0
        f = f.expand_as(evals)
        dfde = torch.zeros_like(evals)
    else:
        mu, kt = mu_t
        if kt > 0:
            x = (evals - mu) / kt
            f = 1.0 / (torch.exp(torch.clamp(x, -80.0, 80.0)) + 1.0)
            dfde = 0.25 / (kt * torch.cosh(torch.clamp(x / 2.0, -40.0, 40.0)) ** 2)
        else:
            f = (evals <= mu).to(evals.dtype)
            dfde = torch.zeros_like(evals)
    de = evals[:, None, :] - evals[:, :, None]  # de[n, m] = e_m - e_n
    df = f[:, :, None] - f[:, None, :]
    tiny = 1e-9
    small = de.abs() < tiny
    ratio = torch.where(small, torch.zeros_like(de), df / torch.where(small, torch.ones_like(de), de))
    W = V[:, :, None] * V.transpose(-1, -2)[:, None, :]  # [b, a, c, n, m] = v^a_nm v^c_mn
    norm = 1.0 / float(np.prod(nk))
    W = W * ratio[:, None, None] * norm
    drude = torch.einsum("bann,bcnn,bn->ac", V, V.conj(), dfde.to(V.dtype)) * norm
    return de.reshape(-1), W.reshape(W.shape[0], data.dim_k, data.dim_k, -1), drude


def optical_conductivity(model, omegas, occ=None, fermi=None, nk=(101, 101), eta=0.05, temperature=0.0):
    """Kubo optical conductivity tensor sigma_ab(omega) (counterpart of
    ``pythtb_tpu.optical.optical_conductivity``): complex (dim, dim, nw),
    e^2/h in 2-D (e^2/(h length) in 3-D), divided by the cell volume.
    Give exactly one of ``occ`` (insulator filling) or ``fermi`` (with
    ``temperature`` > 0 the Drude term is included)."""
    if model._dim_k != model._dim_r or model._dim_k not in (2, 3):
        raise PythtbError("optical_conductivity requires a fully periodic 2-D or 3-D model (dim_k == dim_r)")
    if (occ is None) == (fermi is None):
        raise PythtbError("give exactly one of occ / fermi")
    nk = tuple(int(x) for x in np.atleast_1d(nk))
    if len(nk) != model._dim_k:
        raise PythtbError("nk must give one grid size per k-direction")
    data = model._get_finalized()
    occ_t = None
    mu_t = (0.0, 0.0)
    if occ is not None:
        occ_t = tuple(int(x) for x in np.atleast_1d(occ))
        if len(set(occ_t)) != len(occ_t) or any(not (0 <= o < data.nsta) for o in occ_t):
            raise PythtbError("occ must be distinct state indices")
    else:
        mu_t = (float(fermi), float(temperature))
    lat = np.asarray(model._lat, dtype=np.float64)
    vol = abs(np.linalg.det(lat))
    om = torch.as_tensor(np.asarray(omegas, dtype=np.float64).reshape(-1)).to(data.device)
    de, W, drude = _band_velocity_weights(data, nk, occ_t, mu_t, lat)
    dim = data.dim_k
    Wf = W.permute(1, 2, 0, 3).reshape(dim * dim, -1).contiguous()  # (dim^2, T)
    acc = spectral_sum(Wf, de.contiguous(), om, float(eta), "lorentz")
    # the mirrored tensor (package orientation), plus the intraband Drude term
    sigma = 1j * acc.reshape(dim, dim, -1).transpose(0, 1)
    sigma = sigma + 1j * drude[:, :, None] / (om[None, None, :] + 1j * float(eta))
    return (sigma * (2.0 * math.pi)).cpu().numpy() / vol


def _check_transitions(model, occ, nk, caller, dim_ok):
    if not dim_ok:
        raise PythtbError("%s requires a fully periodic model (dim_k == dim_r)" % caller)
    nk = tuple(int(x) for x in np.atleast_1d(nk))
    if len(nk) != model._dim_k:
        raise PythtbError("nk must give one grid size per k-direction")
    data = model._get_finalized()
    occ_t = tuple(int(x) for x in np.atleast_1d(occ))
    if len(set(occ_t)) != len(occ_t) or any(not (0 <= o < data.nsta) for o in occ_t):
        raise PythtbError("occ must be distinct state indices")
    if len(occ_t) == data.nsta:
        raise PythtbError("occ fills every state; no interband transitions")
    unocc = [s for s in range(data.nsta) if s not in occ_t]
    return data, nk, list(occ_t), unocc


def _flat_columns(W, de, dim):
    """(B, a, b, c, no, nu) real weights and (B, no, nu) transition
    energies -> kernel 16's (dim^3, T) columns and (T,) energies."""
    Wf = W.reshape(W.shape[0], dim**3, -1).transpose(0, 1).reshape(dim**3, -1).contiguous()
    return Wf, de.reshape(-1).contiguous()


def _shift_weights(data, nk, occ, unocc, lat):
    """Kernel 16's inputs of the shift current: Im[r^b_mn r^{c;a}_nm +
    r^c_mn r^{b;a}_nm] over (k, n occ, m unocc) as (dim^3, T), and e_m - e_n."""
    evals, _vecs, V, W2 = _band_tensors(data, nk, lat)
    r, rgen = _gen_derivative(evals, V, W2, 1e-7)
    r_mn = r[:, :, unocc][:, :, :, occ].transpose(-1, -2)  # (B, d, no, nu)
    rg_nm = rgen[:, :, :, occ][..., unocc]  # (B, a, c, no, nu)
    t1 = torch.einsum("bdnm,bacnm->badcnm", r_mn, rg_nm)
    W = (t1 + t1.transpose(2, 3)).imag  # (B, a, b, c, no, nu)
    return _flat_columns(W, evals[:, None, unocc] - evals[:, occ, None], data.dim_k)


def _injection_weights(data, nk, occ, unocc, lat):
    """Kernel 16's inputs of the injection current: Delta^a_mn Im[r^b_nm
    r^c_mn] over (k, n occ, m unocc) as (dim^3, T), and e_m - e_n."""
    evals, _vecs, V, _ = _band_tensors(data, nk, lat, need_d2=False)
    mask, inv = _inv_gaps(evals, 1e-7)
    r = torch.where(mask[:, None], -1j * V * inv.to(V.dtype)[:, None],
                    torch.zeros((), dtype=V.dtype, device=V.device))
    Vd = torch.diagonal(V, dim1=-2, dim2=-1).real  # (B, d, S)
    r_nm = r[:, :, occ][..., unocc]  # (B, b, no, nu)
    dV = Vd[:, :, unocc][:, :, None, :] - Vd[:, :, occ][:, :, :, None]  # (B, a, no, nu)
    rr = torch.einsum("bdnm,bcnm->bdcnm", r_nm, r_nm.conj())
    W = dV[:, :, None, None] * rr.imag[:, None]
    return _flat_columns(W, evals[:, None, unocc] - evals[:, occ, None], data.dim_k)


def _gaussian_response(model, omegas, occ, nk, sigma, caller, weights, norm):
    data, nk, occ, unocc = _check_transitions(model, occ, nk, caller,
                                              model._dim_k == model._dim_r and model._dim_k >= 1)
    lat = np.asarray(model._lat, dtype=np.float64)
    om = torch.as_tensor(np.asarray(omegas, dtype=np.float64).reshape(-1)).to(data.device)
    Wf, de = weights(data, nk, occ, unocc, lat)
    acc = spectral_sum(Wf, de, om, float(sigma), "gauss").reshape((data.dim_k,) * 3 + (-1,))
    return (acc * (norm / float(np.prod(nk)))).cpu().numpy() / abs(np.linalg.det(lat))


def shift_current(model, omegas, occ, nk=(101, 101), sigma=0.05):
    """Shift-current conductivity tensor sigma^{abc}(omega), real (dim,
    dim, dim, nw), the Sipe-Shkrebtii form with the sum-rule generalized
    derivative (counterpart of ``pythtb_tpu.optical.shift_current``)."""
    return _gaussian_response(model, omegas, occ, nk, sigma, "shift_current", _shift_weights, -math.pi / 2.0)


def injection_current(model, omegas, occ, nk=(101, 101), sigma=0.05):
    """Injection-current tensor eta^{abc}(omega), real (dim, dim, dim, nw)
    (counterpart of ``pythtb_tpu.optical.injection_current``)."""
    return _gaussian_response(model, omegas, occ, nk, sigma, "injection_current", _injection_weights,
                              2.0 * math.pi)


def joint_dos(model, omegas, occ, nk=(101, 101), sigma=0.05):
    """Joint density of states J(w) = (1/N_k) sum_{k, n occ, m unocc}
    delta_sigma(w - (e_m - e_n)), Gaussian-broadened, (nw,) (counterpart
    of ``pythtb_tpu.optical.joint_dos``)."""
    if model._dim_k < 1:
        raise PythtbError("joint_dos requires a periodic model")
    data, nk, occ, unocc = _check_transitions(model, occ, nk, "joint_dos", True)
    om = torch.as_tensor(np.asarray(omegas, dtype=np.float64).reshape(-1)).to(data.device)
    kpts = device_uniform_grid(nk, np.zeros(data.dim_k), data.device)
    evals = eigvalsh_batched(assemble(data, kpts))
    de = (evals[:, None, unocc] - evals[:, occ, None]).reshape(-1).contiguous()
    ones = torch.ones((1, de.shape[0]), dtype=config.FLOAT, device=data.device)
    acc = spectral_sum(ones, de, om, float(sigma), "gauss")[0]
    return (acc / float(np.prod(nk))).cpu().numpy()


# ---------------------------------------------------------------------------
# time-domain nonlinear response (exact Peierls gauge)
# ---------------------------------------------------------------------------


def _td_current_batch(data, nk, occ, dks_mid, dks_out, dts, lat):
    """Exact evolution of the filled bands under uniform vector potentials
    and the resulting currents (counterpart of
    ``pythtb_tpu.optical._td_current_batch_jit``): ``dks_mid`` /
    ``dks_out`` (nw, nt, d) are the REDUCED A at the step midpoints / ends
    of each drive frequency, ``dts`` (nw,) its step.  Returns the (nw, nt,
    d_cart) currents per unit cell as a tensor.

    The frequencies share the k-grid, so their rows are stacked (row g * B
    + b is frequency g at k-point b); each chunk of steps is one kernel-1
    launch, one ``eigh_batched``, one kernel-15 launch and one kernel-22
    launch."""
    dev = data.device
    d, S = data.dim_k, data.nsta
    nw, nt = dks_mid.shape[:2]
    kg = device_uniform_grid(nk, np.zeros(d), dev)
    B = kg.shape[0]
    R = nw * B
    _, v0 = eigh_batched(assemble(data, kg))
    occ_idx = torch.as_tensor(occ, dtype=torch.int64, device=dev)
    psi = v0[:, occ_idx, :].repeat(nw, 1, 1).contiguous()  # (nw * B, nocc, S), rows are states
    dt_rows = torch.as_tensor(np.repeat(np.asarray(dts, dtype=np.float64), B)).to(dev)
    mid = torch.as_tensor(np.asarray(dks_mid, dtype=np.float64)).to(dev)
    end = torch.as_tensor(np.asarray(dks_out, dtype=np.float64)).to(dev)
    # a row-step holds H and V (16 S^2 each), w, dH and both k-points
    Tc = chunk_steps(nt, R * (8 * S + 16 * S * S * (2 + d) + 16 * d))
    js = []
    for t0 in range(0, nt, Tc):
        n = min(Tc, nt - t0)
        kmid = (kg[None, None] + mid[:, t0:t0 + n].transpose(0, 1)[:, :, None, :]).reshape(-1, d)
        w, V = eigh_batched(assemble(data, kmid))
        del kmid
        kend = (kg[None, None] + end[:, t0:t0 + n].transpose(0, 1)[:, :, None, :]).reshape(-1, d)
        dH = assemble_dk(data, kend)
        del kend
        psi, j = propagate_state(w.reshape(n, R, S), V.reshape(n, R, S, S), dH.reshape(n, R, d, S, S), psi,
                                 dt_rows, nw)
        del w, V, dH
        js.append(j)
    j = torch.cat(js)  # (nt, nw, d) reduced
    latt = torch.as_tensor(lat, dtype=config.FLOAT).to(dev)
    return torch.einsum("tgr,ra->gta", j, latt) / (2.0 * math.pi * B)


def harmonic_spectrum(model, omega, efield, occ, nk=(48, 48), cycles=24, ramp_cycles=8, steps_per_cycle=96,
                      n_harmonics=5, pol=None):
    """Nonlinear optical response by exact time evolution (counterpart of
    ``pythtb_tpu.optical.harmonic_spectrum``): drive the filled bands with
    E(t) = E0 cos(omega t), sin^2-ramped over ``ramp_cycles``, evolve with
    H(k + A(t)), and Fourier-analyze the current over the final integer
    periods.

    :param omega: drive frequency, scalar or (nw,) array (a batch runs
      every frequency's evolution together, its rows stacked)
    :param efield: field amplitude E0; :param occ: filled bands
    :param pol: Cartesian polarization (default x)
    :returns: dict with ``harmonics`` ((n_harmonics + 1, d) complex
      amplitudes C_n), ``sigma1``, ``sigma2``, ``current`` and ``dt``; an
      omega batch prepends an (nw,) axis to each
    """
    data = model._get_finalized()
    if data.dim_k != model._dim_r:
        raise PythtbError("harmonic_spectrum requires a fully periodic model")
    d = data.dim_k
    nk = tuple(int(x) for x in np.atleast_1d(nk))
    if len(nk) != d:
        raise PythtbError("nk must give %d sizes" % d)
    occ_t = tuple(int(o) for o in np.atleast_1d(occ))
    if len(occ_t) == 0 or len(set(occ_t)) != len(occ_t) or min(occ_t) < 0 or max(occ_t) >= data.nsta:
        raise PythtbError("occ must be distinct bands in range")
    omegas_in = np.atleast_1d(np.asarray(omega, dtype=np.float64))
    scalar_w = np.ndim(omega) == 0
    E0 = float(efield)
    pol_v = np.zeros(d)
    pol_v[0] = 1.0
    if pol is not None:
        pol_v = np.asarray(pol, dtype=np.float64)
        if pol_v.shape != (d,):
            raise PythtbError("pol must have %d components" % d)
        pol_v = pol_v / np.linalg.norm(pol_v)
    cycles = int(cycles)
    ramp_cycles = int(ramp_cycles)
    spc = int(steps_per_cycle)
    if cycles - ramp_cycles < 3:
        raise PythtbError("need at least 3 cycles after the ramp")
    nt = cycles * spc
    lat = np.asarray(model._lat, dtype=np.float64)
    nw = len(omegas_in)
    dks_mid = np.zeros((nw, nt, d))
    dks_out = np.zeros((nw, nt, d))
    dts = np.zeros(nw)
    for iw, om in enumerate(omegas_in):
        T = 2.0 * np.pi / om
        dt = T / spc
        dts[iw] = dt
        # E(t) = E0 r(t) cos(w t); A = -int E dt (fine host trapezoid)
        tfine = np.arange(2 * nt + 1) * (dt / 2.0)
        tr = ramp_cycles * T
        env = np.where(tfine < tr, np.sin(0.5 * np.pi * tfine / max(tr, 1e-300)) ** 2, 1.0)
        Efine = E0 * env * np.cos(om * tfine)
        Afine = -np.concatenate([[0.0], np.cumsum(0.5 * (Efine[1:] + Efine[:-1]) * (dt / 2.0))])
        A_mid = Afine[1::2][:nt]  # midpoints t_s + dt/2
        A_out = Afine[2::2][:nt]  # step ends
        # reduced shift: dk_red = lat @ A_cart / (2 pi)
        dks_mid[iw] = (A_mid[:, None] * pol_v[None, :]) @ lat.T / (2.0 * np.pi)
        dks_out[iw] = (A_out[:, None] * pol_v[None, :]) @ lat.T / (2.0 * np.pi)
    js = _td_current_batch(data, nk, occ_t, dks_mid, dks_out, dts, lat).cpu().numpy()  # (nw, nt, d)
    # analysis window: final integer periods, skipping 2 settle cycles
    nwin = max(1, cycles - ramp_cycles - 2)
    sl = slice(nt - nwin * spc, nt)
    nH = int(n_harmonics)
    vol = abs(np.linalg.det(lat))
    C = np.zeros((nw, nH + 1, d), dtype=complex)
    for iw, om in enumerate(omegas_in):
        twin = (np.arange(nt) * dts[iw] + dts[iw])[sl]
        jwin = js[iw, sl]
        for n in range(nH + 1):
            w_ = np.exp(1.0j * n * om * twin)
            C[iw, n] = (2.0 if n else 1.0) * (w_[:, None] * jwin).mean(axis=0)
    # -2 pi: the e^2/h units and phase convention of optical_conductivity
    out = {
        "harmonics": C / vol,
        "sigma1": -2.0 * np.pi * C[:, 1] / E0 / vol,
        "sigma2": -2.0 * np.pi * C[:, 2] / E0**2 / vol,
        "current": js / vol,
        "dt": dts,
    }
    if scalar_w:
        out = {k: (v[0] if k != "dt" else float(v[0])) for k, v in out.items()}
    return out
