"""Parallel transport, smooth gauges and adiabatic state following
(counterpart of ``pythtb_tpu.ops.transport``).

* :func:`smooth_gauge` -- the twisted parallel-transport gauge of
  Marzari & Vanderbilt 1997 along one grid axis.  With ``W_m`` the polar
  factor of the link overlap <w_m|w_{m+1}> in the original gauge and
  ``C_m = W_0 ... W_{m-1}`` its running product, the transported states
  are ``conj(C_m) w_m``; with ``closed`` the holonomy ``Lambda = C_{L-1}``
  is spread evenly along the axis, ``conj(C_m Lambda^{-m/(L-1)}) w_m``.
  On a CUDA tensor kernel 14 (``csrc/transport.cu``) runs the chain of
  prefixes (mode ``chain``) and the rotation (mode ``rotate``, one launch
  that writes the whole new grid: the rows outside ``occ`` are copied in
  the same pass), with one batched :func:`..ops.berry.unitary_eig` of the
  holonomies between them; on a CPU tensor :func:`_chain_plain` and
  :func:`_rotate_plain` do.
* :func:`follow_states` -- adiabatic following of a subspace along one
  grid axis: at each step the ``nocc`` stored states with the largest
  squared overlap with the transported subspace are selected (ties to
  the lower index, as ``jax.lax.top_k``; indices sorted ascending) and
  the subspace is carried into them by a polar projection.  Kernel 14's
  ``follow`` mode on CUDA -- the selection scan on the weights of the
  stored states' overlaps, split from the polar factors, which then run
  over the whole grid as the chain's do (:func:`_follow_path` picks the
  designs of its phases) -- and :func:`_follow_plain` on CPU.

Both read the stored grid (grid..., NS, norb[, 2]) as (outer, L, inner,
NS, F) strings along the axis, without a copy.  Kernel 14 takes up to 64
states (S of chain and rotate, NS of follow) on the card and raises above.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .. import config
from . import _kernels
from .berry import _overlap, unitary_eig

__all__ = ["smooth_gauge", "follow_states"]

# most states kernel 14 takes (rotate: registers up to 3, the team path
# and the tiles to 64; follow to 64; the chain: its link path): S of
# chain / rotate, NS of follow
_KERNEL_MAX_STATES = 64
# kernel 14's chain designs: C mode, the most states each takes, and its
# launches a call ("registers": a thread a string, S 1; "warp" / "block":
# the link path, a warp or a block a link over the grid, then a team a
# string)
_CHAIN_MODES = {"registers": (0, 1, 1), "warp": (1, 32, 2), "block": (2, _KERNEL_MAX_STATES, 2)}
# the link path's dispatch line (PERF.md section 6, measured on the H100's
# 132 SMs): a warp a link up to _CHAIN_WARP_MAX_S states, except where the
# links are too few to fill the SMs with warps -- at most one link an SM
# from 9 states, at most two from 20 -- where a block a link runs each
# link's Jacobi rounds on more lanes
_CHAIN_WARP_MAX_S = 28
# kernel 14's rotate designs: C path and the most states each takes
# ("registers": a thread a point; "warp" / "team": a warp or a block of
# four warps a point on the CUDA cores; "split": a block each 16 rows of a
# point on the FP64 tensor cores).  Every design writes the whole grid,
# the rows outside occ copied.
_ROTATE_MODES = {"registers": (0, 3), "warp": (1, _KERNEL_MAX_STATES), "team": (2, _KERNEL_MAX_STATES),
                 "split": (3, _KERNEL_MAX_STATES)}
# the rotate's dispatch line (PERF.md section 6, measured on the H100): a
# thread a point to 3 states (from 4 its registers spill), a warp a point
# to _ROTATE_WARP_MAX_S where the points fill the SMs, a block of four
# warps a point on the CUDA cores below _ROTATE_TILE_MIN_S, the tensor
# cores from there, a block each 16 rows of a point
_ROTATE_WARP_MAX_S = 8
_ROTATE_TILE_MIN_S = 12
def _rotate_smem(S, F, path):
    """Shared memory (bytes) a block of rotate design ``path`` takes at S
    states and F components, closed, with the occ rows whole (the layout
    of ``csrc/transport.cu``'s RotateLayout; F bounds the number of stored
    states NS)."""
    mode = _ROTATE_MODES[path][0]
    if mode == 0:
        return 0
    rows = S if mode <= 2 else 16
    Sp, Fp = -(-S // 8) * 8, -(-F // 8) * 8
    entries = 2 * rows * (Sp + 4) + Sp * (Sp + 4) + Sp * (Fp + 2) + (Sp + 1) // 2 + Sp
    # the occ flags beside them, and the static occ list with the block's reserve
    return 16 * entries + 4 * (-(-F // 32)) + 1024


def _strings(w, nspin, dim_arr, axis):
    """View stored states (grid..., NS, norb[, 2]) as (outer, L, inner,
    NS, F) strings along grid ``axis``: returns (view, grid)."""
    grid = tuple(w.shape[:dim_arr])
    if not 0 <= axis < dim_arr or grid[axis] < 2:
        raise ValueError("axis %d needs length >= 2 in grid %s" % (axis, grid))
    NS = w.shape[dim_arr]
    F = math.prod(w.shape[dim_arr + 1 :])
    outer, L, inner = math.prod(grid[:axis]), grid[axis], math.prod(grid[axis + 1 :])
    return w.reshape(outer, L, inner, NS, F), grid


def _polar(M):
    """U V^H of M = U s V^H, and s (the JAX package's ``_unitarize``)."""
    U, s, Vh = torch.linalg.svd(M, full_matrices=False)
    return U @ Vh, s


def _chain_plain(w5, occ):
    """Plain PyTorch prefixes of the polar link chain (SVD polar factors,
    one matmul a link): the oracle of kernel 14's ``chain`` mode.  Returns
    C (outer, L, inner, S, S) with C[:, 0] = I, and the smallest link
    singular value per string (outer * inner,)."""
    ws = w5[:, :, :, occ]
    W, s = _polar(_overlap(ws[:, :-1], ws[:, 1:]))  # (outer, L-1, inner, S, S)
    C = [torch.eye(len(occ), dtype=config.COMPLEX, device=w5.device).expand(W[:, 0].shape)]
    for l in range(W.shape[1]):
        C.append(C[-1] @ W[:, l])
    return torch.stack(C, dim=1), s.amin(dim=(1, 3)).reshape(-1)


def _rotate_plain(w5, occ, C, theta, P, closed):
    """Plain PyTorch rotation conj(C_m Lambda^{-t_m}) w_m of the ``occ``
    rows (conj(C_m) w_m when not ``closed``), into a copy of the whole
    grid: the oracle of kernel 14's ``rotate`` mode."""
    L = w5.shape[1]
    B = C
    if closed:
        t = (torch.arange(L, dtype=config.FLOAT, device=w5.device) / (L - 1))[None, :, None, None]
        ph = torch.polar(torch.ones_like(theta[:, None] * t), -theta[:, None] * t)
        lam_t = (P[:, None] * ph[..., None, :]) @ P.conj().transpose(-1, -2)[:, None]
        B = C @ lam_t
    out = w5.clone()
    out[:, :, :, occ] = B.conj() @ w5[:, :, :, occ]
    return out


def _occ_tensor(occ, device):
    return torch.as_tensor(np.asarray(occ, dtype=np.int64), device=device)


def _plain(w, nstates):
    """True where the plain version runs: a CPU tensor.  On the card more
    than ``_KERNEL_MAX_STATES`` states raise."""
    if w.device.type == "cpu":
        return True
    if nstates > _KERNEL_MAX_STATES:
        raise ValueError(
            "kernel 14 takes at most %d states on a CUDA tensor, got %d; run the call on the CPU "
            '(config.set_device("cpu")) for more' % (_KERNEL_MAX_STATES, nstates))
    return False


def _chain_path(S, strings, L, sms):
    """Kernel 14's chain design for S states on ``strings`` strings of L
    points on a card of ``sms`` SMs: the register path at S 1; the link
    path above, a warp a link up to ``_CHAIN_WARP_MAX_S`` states unless the
    links are few for the SMs."""
    links = strings * (L - 1)
    if S == 1:
        return "registers"
    few = (S >= 9 and links <= sms) or (S >= 20 and links <= 2 * sms)
    return "block" if S > _CHAIN_WARP_MAX_S or few else "warp"


def _chain(w5, occ_t, path=None):
    """Kernel 14's chain on design ``path`` (a key of ``_CHAIN_MODES``;
    :func:`_chain_path`'s choice if None).  The link path takes strings x
    (L - 1) doubles of scratch for the links' singular values; the link
    factors go into C itself."""
    outer, L, inner, NS, F = w5.shape
    S = occ_t.shape[0]
    if path is None:
        path = _chain_path(S, outer * inner, L, torch.cuda.get_device_properties(w5.device).multi_processor_count)
    if path not in _CHAIN_MODES:
        raise ValueError("kernel 14's chain has no %r path; it has %s" % (path, ", ".join(_CHAIN_MODES)))
    mode, most, launches = _CHAIN_MODES[path]
    if S > most:
        raise ValueError("kernel 14's %r path does not take %d states" % (path, S))
    _kernels.require(w5, "w", config.COMPLEX)
    _kernels.require(occ_t, "occ", torch.int64, (S,), w5.device)
    C = torch.empty((outer, L, inner, S, S), dtype=config.COMPLEX, device=w5.device)
    smin = torch.empty((outer * inner,), dtype=config.FLOAT, device=w5.device)
    link_smin = torch.empty((outer * inner * (L - 1) if mode else 0,), dtype=config.FLOAT, device=w5.device)
    _kernels.launch("transport_chain", w5.device, w5, occ_t, C, smin, link_smin, outer, L, inner, S, NS, F, mode,
                    count=launches)
    return C, smin


def _rotate_path(S, points, F, sms, smem):
    """Kernel 14's rotate design for S states at ``points`` grid points of
    F components on a card of ``sms`` SMs whose blocks may take ``smem``
    bytes of shared memory: the register path to 3 states; to
    ``_ROTATE_WARP_MAX_S`` a warp a point where the points fill the SMs;
    below ``_ROTATE_TILE_MIN_S`` a block a point on the CUDA cores where a
    point's occ rows fit it whole; the tensor-core tiles, a block each 16
    rows of a point, elsewhere."""
    if S <= _ROTATE_MODES["registers"][1]:
        return "registers"
    if S <= _ROTATE_WARP_MAX_S and points >= sms and _rotate_smem(S, F, "warp") <= smem:
        return "warp"
    if S < _ROTATE_TILE_MIN_S and _rotate_smem(S, F, "team") <= smem:
        return "team"
    return "split"


@functools.lru_cache(maxsize=None)
def _rotate_mode(S, points, F, sms, smem, path):
    """The C entry's mode for design ``path`` (:func:`_rotate_path`'s choice
    if None), once a shape: the rotate's wrapper runs in the smooth gauge's
    hot path."""
    if path is None:
        path = _rotate_path(S, points, F, sms, smem)
    if path not in _ROTATE_MODES:
        raise ValueError("kernel 14's rotate has no %r path; it has %s" % (path, ", ".join(_ROTATE_MODES)))
    mode, most = _ROTATE_MODES[path]
    if S > most:
        raise ValueError("kernel 14's rotate %r path does not take %d states" % (path, S))
    return mode


def _rotate(w5, occ_t, C, theta, P, closed, path=None):
    """Kernel 14's rotation on design ``path`` (a key of ``_ROTATE_MODES``;
    :func:`_rotate_path`'s choice if None): one launch writes the whole new
    grid.  A block that cannot hold a point's occ rows whole forms them a
    chunk of columns at a time."""
    outer, L, inner, NS, F = w5.shape
    S = occ_t.shape[0]
    dev = w5.device
    card = _kernels.card(dev) if path is None else (None, None)  # a named design needs no line
    mode = _rotate_mode(S, outer * L * inner, F, *card, path)
    _kernels.require(w5, "w", config.COMPLEX)
    _kernels.require(occ_t, "occ", torch.int64, (S,), dev)
    _kernels.require(C, "C", config.COMPLEX, (outer, L, inner, S, S), dev)
    if closed:
        _kernels.require(theta, "theta", config.FLOAT, (outer, inner, S), dev)
        _kernels.require(P, "P", config.COMPLEX, (outer, inner, S, S), dev)
    else:
        theta, P = C, C  # not read
    out = torch.empty_like(w5)
    _kernels.launch("transport_rotate", dev, w5, occ_t, C, theta, P, out,
                    outer, L, inner, S, NS, F, int(bool(closed)), mode)
    return out


def _smooth(w5, occ_t, closed, plain):
    """Smooth gauge of the ``occ`` rows of strings ``w5``: the new grid and
    the smallest link singular value (a tensor)."""
    C, smin = (_chain_plain if plain else _chain)(w5, occ_t)
    theta = P = None
    if closed:
        theta, P = (t.contiguous() for t in unitary_eig(C[:, -1].contiguous()))
    rotate = _rotate_plain if plain else _rotate
    return rotate(w5, occ_t, C, theta, P, closed), smin.amin()


def smooth_gauge(wfs, occ, dir, nspin, dim_arr, closed):
    """Impose the (twisted) parallel-transport gauge on stored states
    ``occ`` of ``wfs`` (grid..., NS, norb[, 2]) along grid axis ``dir``.
    Returns the whole updated state grid (a new tensor on the device of
    ``wfs``) and the smallest link singular value (a float, for the
    singular-overlap warning)."""
    w5, _ = _strings(wfs, nspin, dim_arr, int(dir))
    occ_t = _occ_tensor(occ, wfs.device)
    out, smin = _smooth(w5.contiguous(), occ_t, closed, _plain(wfs, occ_t.shape[0]))
    return out.reshape(wfs.shape), float(smin)


def _top_sorted(weight, nocc):
    """Indices (sorted ascending) and values of the ``nocc`` largest
    entries of the last axis, ties to the lower index."""
    vals, order = torch.sort(weight, dim=-1, descending=True, stable=True)
    topi, _ = torch.sort(order[..., :nocc], dim=-1)
    return topi, vals[..., :nocc]


def _follow_plain(w5, occ_t):
    """Plain PyTorch adiabatic following (the scan of the JAX package's
    ``_follow_states_jit``, one step at a time): the oracle of kernel 14's
    ``follow`` mode.  Returns indices (L, outer * inner, nocc), fidelity
    (L - 1, outer * inner) and states (outer, L, inner, nocc, F)."""
    outer, L, inner, NS, F = w5.shape
    nocc = occ_t.shape[0]
    f = w5[:, 0][:, :, occ_t]  # (outer, inner, nocc, F)
    idx = [occ_t.expand(outer, inner, nocc)]
    fid, states = [], [f]
    for l in range(1, L):
        wl = w5[:, l]
        ovr = _overlap(f, wl)  # (outer, inner, nocc, NS)
        weight = (ovr.abs() ** 2).sum(dim=-2)
        topi, topw = _top_sorted(weight, nocc)
        wsel = torch.gather(wl, 2, topi[..., None].expand(outer, inner, nocc, F))
        M = torch.gather(ovr, 3, topi[:, :, None, :].expand(outer, inner, nocc, nocc))
        f = _polar(M)[0].conj() @ wsel
        idx.append(topi)
        fid.append(topw.sum(dim=-1) / nocc)
        states.append(f)
    idx = torch.stack(idx).reshape(L, outer * inner, nocc)
    fid = torch.stack(fid).reshape(L - 1, outer * inner) if fid else w5.new_zeros((0, outer * inner), dtype=config.FLOAT)
    return idx, fid, torch.stack(states, dim=1)


def _follow_path(NS, nocc, F, strings, L, sms, smem):
    """The designs of kernel 14's follow phases for nocc of NS stored
    states of F components on ``strings`` strings of L points, on a card of
    ``sms`` SMs whose blocks may take ``smem`` bytes of shared memory:
    ``(polar, states)``, the polar factors' team ("warp" or "block", the
    chain's line, :func:`_chain_path`) and the states' rotate design (a key
    of ``_ROTATE_MODES`` past "registers", :func:`_rotate_path`'s line).
    More than 64 states, nocc 0 or nocc above NS raise."""
    if not 1 <= nocc <= NS <= _KERNEL_MAX_STATES:
        raise ValueError("kernel 14's follow takes 1 <= nocc <= NS <= %d states, got nocc %d of %d"
                         % (_KERNEL_MAX_STATES, nocc, NS))
    polar = "block" if _chain_path(nocc, strings, L, sms) == "block" else "warp"
    return polar, _rotate_path(max(nocc, _ROTATE_MODES["registers"][1] + 1), strings * L, F, sms, smem)


def _follow(w5, occ_t):
    """Kernel 14's following: five launches (three where the axis has one
    point), on strings x (L - 1) x NS^2 doubles and the grid's nocc^2
    complex values of scratch."""
    outer, L, inner, NS, F = w5.shape
    nocc = occ_t.shape[0]
    dev = w5.device
    strings = outer * inner
    polar, states_path = _follow_path(NS, nocc, F, strings, L, *_kernels.card(dev))
    _kernels.require(w5, "w", config.COMPLEX)
    _kernels.require(occ_t, "occ", torch.int64, (nocc,), dev)
    idx = torch.empty((L, strings, nocc), dtype=torch.int64, device=dev)
    fid = torch.empty((L - 1, strings), dtype=config.FLOAT, device=dev)
    states = torch.empty((outer, L, inner, nocc, F), dtype=config.COMPLEX, device=dev)
    Wt = torch.empty((strings * (L - 1) * (NS * NS + NS % 2),), dtype=config.FLOAT, device=dev)
    C = torch.empty((outer, L, inner, nocc, nocc), dtype=config.COMPLEX, device=dev)
    _kernels.launch("transport_follow", dev, w5, occ_t, idx, fid, states, Wt, C, outer, L, inner, nocc, NS, F,
                    int(polar == "block"), _ROTATE_MODES[states_path][0], count=5 if L > 1 else 3)
    return idx, fid, states


def follow_states(wfs, occ, dir, nspin, dim_arr):
    """Adiabatically follow the subspace of stored states ``occ`` of
    ``wfs`` (grid..., NS, norb[, 2]) along grid axis ``dir``.

    Returns ``(indices, fidelity, states)``: the followed state indices
    (L, rest..., nocc) with the axis moved to the front and the
    per-step captured fraction (L-1, rest...), both NumPy, and the
    followed states (grid..., nocc, norb[, 2]) on the device of ``wfs``.
    """
    dir = int(dir)
    w5, grid = _strings(wfs, nspin, dim_arr, dir)
    occ_t = _occ_tensor(occ, wfs.device)
    follow = _follow_plain if _plain(wfs, w5.shape[3]) else _follow
    idx, fid, states = follow(w5.contiguous(), occ_t)
    rest = grid[:dir] + grid[dir + 1 :]
    nocc = occ_t.shape[0]
    idx = idx.reshape((grid[dir],) + rest + (nocc,)).cpu().numpy()
    fid = fid.reshape((grid[dir] - 1,) + rest).cpu().numpy().astype(np.float64)
    states = states.reshape(grid + (nocc,) + tuple(wfs.shape[dim_arr + 1 :]))
    return np.array(idx, copy=True), fid, states
