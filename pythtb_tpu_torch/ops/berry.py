"""Berry phases, Berry fluxes and Wilson loops on grids of states
(counterpart of ``pythtb_tpu.ops.berry``).

* Link determinants det<u_k|u_{k+e_d}> along one grid axis: kernel 3
  (``csrc/link_dets.cu``) on a CUDA tensor, :func:`_link_dets_plain` on
  a CPU tensor.  Kernels 3 and 5 take up to 64 bands on the card and
  raise above.  Each link det is computed once and shared by its two
  plaquettes (det(M1 M2 M3 M4) = det(M1) det(M2) det(M3) det(M4)).
* Plaquette phases -arg(D_r D_u D_r* D_u*), their per-plane sums and the
  smallest |det|: kernel 4 (``csrc/plaquette_flux.cu``) on CUDA,
  :func:`_plaquette_flux_plain` on CPU.
* Traced Berry phases: the wrapped sum of link-det angles.
* Wilson loops (the ``berry_evals`` path): the polar factor of every
  link overlap, chained in link order, and the smallest singular value:
  kernel 5 (``csrc/wilson_loop.cu``) on CUDA, :func:`_wilson_loop_plain`
  (``torch.linalg.svd`` and a pairwise product) on CPU.  Kernel 5 gives
  every link's polar factor a team of its own, a warp up to 28 states and
  a block above (:func:`_wilson_path`), then a block a string for the
  chain.  The eigenphases of the S x S products stay plain PyTorch
  (closed forms at S <= 2, ``torch.linalg.eigh`` above), as the JAX
  package leaves them to ``jnp.linalg``.

States arrive as (grid..., S, norb[, 2]) complex tensors on the device;
band selection and axis arrangement happen on the device, and only the
results cross to the host.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import config
from . import _kernels

__all__ = [
    "link_dets",
    "plaquette_flux",
    "plaquette_phases",
    "prep_states",
    "berry_phase_traced",
    "berry_flux_planes",
    "berry_evals",
    "berry_evals_device",
    "berry_loop_products",
    "wilson_loop",
    "unitary_eig",
    "unitary_eigenphases",
    "wilson_eigenphases",
]

# most bands S that kernels 3 and 5 take
_KERNEL_MAX_S = 64
# kernel 5's dispatch line: a warp a link up to _WARP_MAX_S states, a
# block a link above (PERF.md section 6 has both designs' times at S 20-32)
_WARP_MAX_S = 28
# C modes of kernel 5's designs, and the most states each takes
_WILSON_MODES = {"warp": (0, 32), "block": (1, _KERNEL_MAX_S)}
# most planes kernel 4 takes in one launch (CUDA's grid y-dimension limit)
_MAX_PLANES = 65535


def _wrap(x):
    """Wrap angle(s) to (-pi, pi] the way torch.angle would."""
    return torch.atan2(torch.sin(x), torch.cos(x))


def _dets(M):
    """Determinants of (..., S, S); closed forms for S <= 2."""
    S = M.shape[-1]
    if S == 1:
        return M[..., 0, 0]
    if S == 2:
        return M[..., 0, 0] * M[..., 1, 1] - M[..., 0, 1] * M[..., 1, 0]
    return torch.linalg.det(M)


def _overlap(wa, wb):
    """ovr[..., n, m] = <wa[..., n, :] | wb[..., m, :]>."""
    return torch.einsum("...nf,...mf->...nm", wa.conj(), wb)


def _link_dets_plain(w, axis):
    """Plain PyTorch link determinants (einsum + det): the oracle of
    kernel 3."""
    L = w.shape[axis]
    return _dets(_overlap(w.narrow(axis, 0, L - 1), w.narrow(axis, 1, L - 1))).contiguous()


def _strings(w, axis):
    """Check CUDA states ``w`` (grid..., S, F) and view grid ``axis`` as
    the L of (outer, L, inner), the layout kernels 3 and 5 read without
    a copy: returns (grid, S, F, outer, L, inner)."""
    grid = tuple(w.shape[:-2])
    if not 0 <= axis < len(grid) or grid[axis] < 2:
        raise ValueError("axis %d needs length >= 2 in grid %s" % (axis, grid))
    _kernels.require(w, "w", config.COMPLEX)
    S = w.shape[-2]
    if S > _KERNEL_MAX_S:
        raise ValueError(
            "kernels 3 and 5 take at most %d bands on a CUDA tensor, got %d; run the call on the CPU "
            '(config.set_device("cpu")) for more' % (_KERNEL_MAX_S, S))
    return (grid, S, w.shape[-1], math.prod(grid[:axis]), grid[axis], math.prod(grid[axis + 1 :]))


def link_dets(w, axis):
    """Overlap determinants of the nearest-neighbour links of states
    ``w`` (grid..., S, F) along grid ``axis``: (grid...) with that axis
    one shorter."""
    if w.device.type == "cpu":
        return _link_dets_plain(w, axis)
    grid, S, F, outer, L, inner = _strings(w, axis)
    out_shape = grid[:axis] + (L - 1,) + grid[axis + 1 :]
    out = torch.empty(out_shape, dtype=config.COMPLEX, device=w.device)
    _kernels.launch("link_dets", w.device, w, out, outer, L, inner, S, F)
    return out


def _plaquette_flux_plain(Dr, Du, individual):
    """Plain PyTorch plaquette phases (angle of the link-det product),
    their sum over the last two axes unless ``individual``, and the
    smallest |det|: the oracle of kernel 4."""
    plaq = -torch.angle(
        Dr[..., :, :-1] * Du[..., 1:, :] * Dr[..., :, 1:].conj() * Du[..., :-1, :].conj()
    )
    mdet = torch.minimum(Dr.abs().amin(), Du.abs().amin())
    return (plaq if individual else plaq.sum(dim=(-2, -1))), mdet


def plaquette_flux(Dr, Du, individual=False):
    """Plaquette Berry phases from link dets Dr (..., n0-1, n1) and Du
    (..., n0, n1-1): returns ``(flux, min_abs_det)`` with flux the
    (..., n0-1, n1-1) phases if ``individual``, else their sums (...)."""
    if Dr.device.type == "cpu":
        return _plaquette_flux_plain(Dr, Du, individual)
    rest = tuple(Dr.shape[:-2])
    n0, n1 = Dr.shape[-2] + 1, Dr.shape[-1]
    if n0 < 2 or n1 < 2:
        raise ValueError("plaquettes need a grid of at least 2 x 2, got %d x %d" % (n0, n1))
    P = math.prod(rest)
    if P > _MAX_PLANES:
        raise ValueError("at most %d planes per call, got %d" % (_MAX_PLANES, P))
    dev = Dr.device
    _kernels.require(Dr, "Dr", config.COMPLEX, rest + (n0 - 1, n1))
    _kernels.require(Du, "Du", config.COMPLEX, rest + (n0, n1 - 1), dev)
    nblk = min(-(-max(n0 * n1, 1) // 256), 1024)
    plaq = (
        torch.empty(rest + (n0 - 1, n1 - 1), dtype=config.FLOAT, device=dev)
        if individual
        else None
    )
    psum = torch.empty((P, nblk), dtype=config.FLOAT, device=dev)
    pmin = torch.empty((P, nblk), dtype=config.FLOAT, device=dev)
    sums = torch.empty(rest, dtype=config.FLOAT, device=dev)
    mdet = torch.empty((), dtype=config.FLOAT, device=dev)
    _kernels.launch(
        "plaquette_flux", dev, Dr, Du, plaq, psum, pmin, sums, mdet, P, n0, n1, nblk
    )
    return (plaq if individual else sums), mdet


def plaquette_phases(w):
    """Plaquette Berry phases of (..., n0, n1, S, F) states, from link
    determinants: (..., n0-1, n1-1).  The single home of the flux
    orientation convention, with :func:`plaquette_flux`."""
    return plaquette_flux(*_plane_link_dets(w), individual=True)[0]


def _plane_link_dets(w):
    """(Dr, Du): link dets along the last two grid axes of (..., n0, n1,
    S, F) states."""
    ngrid = w.dim() - 2
    return link_dets(w, ngrid - 2), link_dets(w, ngrid - 1)


def prep_states(wfs, occ, nspin, dim_arr):
    """Select states ``occ`` and flatten orbital/spin:
    (grid..., S, norb[, 2]) -> (grid..., nocc, F), contiguous."""
    w = wfs
    if nspin == 2:
        w = w.reshape(w.shape[: dim_arr + 1] + (-1,))
    idx = torch.as_tensor(np.asarray(occ, dtype=np.int64), device=w.device)
    return w.index_select(dim_arr, idx).contiguous()


# ---------------------------------------------------------------------------
# Traced Berry phase along strings
# ---------------------------------------------------------------------------


def berry_phase_traced(wfs, occ, dir, nspin, dim_arr):
    """Traced Berry phase of states ``occ`` along grid axis ``dir``.

    Returns ``(phases, min_abs_det)``: a float64 NumPy array over the
    remaining grid axes, and the smallest link |det| (near zero the
    discretized phase is undefined and the caller warns).
    """
    dets = link_dets(prep_states(wfs, occ, nspin, dim_arr), int(dir))
    out = -_wrap(torch.angle(dets).sum(dim=int(dir)))
    return out.cpu().numpy().astype(np.float64), float(dets.abs().amin())


# ---------------------------------------------------------------------------
# Wilson loops and their eigenphases
# ---------------------------------------------------------------------------


def unitary_eig(U):
    """Spectral decomposition ``(theta, P)`` of (..., S, S) unitary
    matrices, ``U = P diag(e^{i theta}) P^H``, by the simultaneous
    diagonalization of A = (U + U^H)/2 and B = (U - U^H)/2i that
    pythtb_tpu.ops.berry.unitary_eig documents: eigh of A, B rotated into
    A's eigenbasis and masked to A's near-degenerate clusters, then eigh
    of that with a per-cluster shift.  Angles in (-pi, pi], unsorted."""
    S = U.shape[-1]
    if S == 1:
        return torch.angle(U[..., 0, 0])[..., None], torch.ones_like(U)
    Uh = U.conj().transpose(-1, -2)
    A = (U + Uh) / 2
    Bm = (U - Uh) / 2j
    c, V = torch.linalg.eigh(A)  # c ascending
    Bp = V.conj().transpose(-1, -2) @ Bm @ V
    tol = 100.0 * math.sqrt(torch.finfo(config.FLOAT).eps)
    bound = (c[..., 1:] - c[..., :-1] >= tol).to(config.FLOAT)
    label = torch.cat([torch.zeros_like(c[..., :1]), torch.cumsum(bound, dim=-1)], dim=-1)
    mask = label[..., :, None] == label[..., None, :]
    Bp = torch.where(mask, Bp, torch.zeros_like(Bp))
    Bp = (Bp + Bp.conj().transpose(-1, -2)) / 2
    shift = 2.5 * label
    s2, W = torch.linalg.eigh(Bp + torch.diag_embed(shift).to(config.COMPLEX))
    absW2 = W.abs() ** 2
    cdiag = torch.einsum("...ij,...i->...j", absW2, c)
    sdiag = s2 - torch.einsum("...ij,...i->...j", absW2, shift)
    return torch.atan2(sdiag, cdiag), V @ W


def unitary_eigenphases(U):
    """Eigenphases (..., S) of (..., S, S) unitary matrices, in
    (-pi, pi], unsorted: the angles of :func:`unitary_eig`."""
    return unitary_eig(U)[0]


def wilson_eigenphases(prod):
    """Eigenphases of (..., S, S) unitary Wilson-loop products: closed
    forms for S <= 2 (the S = 2 one through the SU(2) part, free of
    cancellation at degenerate phases), :func:`unitary_eig` beyond."""
    S = prod.shape[-1]
    if S == 1:
        return torch.angle(prod[..., 0, 0])[..., None]
    if S == 2:
        phi = 0.5 * torch.angle(_dets(prod))
        Up = prod * torch.polar(torch.ones_like(phi), -phi)[..., None, None]
        a = 0.5 * (Up[..., 0, 0] + Up[..., 1, 1].conj())
        b = 0.5 * (Up[..., 0, 1] - Up[..., 1, 0].conj())
        sind = torch.sqrt(a.imag**2 + b.abs() ** 2)
        delta = torch.atan2(sind, a.real)
        return torch.stack([_wrap(phi + delta), _wrap(phi - delta)], dim=-1)
    return unitary_eig(prod)[0]


def _chain_product(Wl):
    """Ordered product Wl[0] @ Wl[1] @ ... over axis 0, pairwise
    (log-depth)."""
    while Wl.shape[0] > 1:
        even = Wl.shape[0] - Wl.shape[0] % 2
        paired = Wl[0:even:2] @ Wl[1:even:2]
        Wl = torch.cat([paired, Wl[even:]], dim=0)
    return Wl[0]


def _wilson_loop_plain(w, axis):
    """Plain PyTorch Wilson loops (einsum overlaps, ``torch.linalg.svd``
    polar factors U V^H, pairwise chain product): the oracle of kernel 5.
    Returns (prod (rest..., S, S), smallest singular value per string
    (rest...))."""
    w = torch.movedim(w, axis, 0)
    U, s, Vh = torch.linalg.svd(_overlap(w[:-1], w[1:]), full_matrices=False)
    return _chain_product(U @ Vh), s.amin(dim=0).amin(dim=-1)


def _wilson_path(S):
    """Kernel 5's design for S states: "warp" or "block" a link."""
    return "warp" if S <= _WARP_MAX_S else "block"


def wilson_loop(w, axis):
    """Wilson loops of states ``w`` (grid..., S, F) along grid ``axis``:
    the ordered product of the polar factors of the link overlaps, per
    string, as (rest..., S, S) with ``rest`` the grid without ``axis``,
    and the smallest link singular value per string (rest...).  On the
    card it takes strings x (L - 1) x S x S complex scratch for the link
    factors (92 MB at 301 x 301, S 8), as the plain version's SVD takes
    several such arrays."""
    return _wilson_loop(w, axis, None)


def _wilson_loop(w, axis, path):
    """:func:`wilson_loop` on kernel 5's design ``path`` ("warp" or
    "block"; :func:`_wilson_path`'s choice if None)."""
    if path is not None and path not in _WILSON_MODES:
        raise ValueError("kernel 5 has no %r path; it has %s" % (path, ", ".join(_WILSON_MODES)))
    if w.device.type == "cpu":
        return _wilson_loop_plain(w, axis)
    grid, S, F, outer, L, inner = _strings(w, axis)
    path = _wilson_path(S) if path is None else path
    if S > _WILSON_MODES[path][1]:
        raise ValueError("kernel 5's %r path does not take %d bands" % (path, S))
    rest = grid[:axis] + grid[axis + 1 :]
    dev = w.device
    prod = torch.empty(rest + (S, S), dtype=config.COMPLEX, device=dev)
    smin = torch.empty(rest, dtype=config.FLOAT, device=dev)
    links = torch.empty((outer * inner * (L - 1), S, S), dtype=config.COMPLEX, device=dev)
    link_smin = torch.empty(outer * inner * (L - 1), dtype=config.FLOAT, device=dev)
    _kernels.launch("wilson_loop", dev, w, prod, smin, links, link_smin, outer, L, inner, S, F,
                    _WILSON_MODES[path][0], count=2)
    return prod, smin


def _loop_products(wfs, occ, dir, nspin, dim_arr):
    return wilson_loop(prep_states(wfs, occ, nspin, dim_arr), int(dir))


def berry_loop_products(wfs, occ, dir, nspin, dim_arr):
    """Ordered product of the polar factors of the link overlaps along
    ``dir`` (PythTB's ``prd``), one (nocc, nocc) matrix per string,
    shaped (rest..., nocc, nocc) as NumPy, and the smallest link singular
    value (a singular link makes the polar factor arbitrary, so the
    caller warns on it)."""
    prod, smin = _loop_products(wfs, occ, dir, nspin, dim_arr)
    return prod.cpu().numpy().astype(np.complex128), float(smin.amin())


def berry_evals(wfs, occ, dir, nspin, dim_arr):
    """Wilson-loop eigenphases along grid axis ``dir``: link overlaps,
    polar factors and their ordered product (kernel 5), eigenphases.
    Returns ``(phases (rest..., nocc) ascending, min_singular_value)``."""
    prod, smin = _loop_products(wfs, occ, dir, nspin, dim_arr)
    out = torch.sort(-wilson_eigenphases(prod), dim=-1).values
    return out.cpu().numpy().astype(np.float64), float(smin.amin())


# the JAX package's name for the same call (its device-resident variant)
berry_evals_device = berry_evals


# ---------------------------------------------------------------------------
# Berry flux over planes
# ---------------------------------------------------------------------------


def berry_flux_planes(wfs, occ, d0, d1, nspin, dim_arr, individual):
    """Plaquette Berry phases (or their plane sums) over the (d0, d1)
    planes of a grid of states.  Returns ``(flux, min_abs_det)`` as a
    float64 NumPy array and a float."""
    w = prep_states(wfs, occ, nspin, dim_arr)
    # grid axes as (rest..., d0, d1), as the reference's transposes
    w = torch.movedim(w, (int(d0), int(d1)), (dim_arr - 2, dim_arr - 1)).contiguous()
    flux, mdet = plaquette_flux(*_plane_link_dets(w), individual=bool(individual))
    return flux.cpu().numpy().astype(np.float64), float(mdet)
