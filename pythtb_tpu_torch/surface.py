"""Semi-infinite surfaces: spectral functions by Sancho-Rubio decimation
(counterpart of ``pythtb_tpu.surface``).

The surface Green's function of a SEMI-INFINITE crystal comes from the
Sancho-Rubio decimation (J. Phys. F 15, 851 (1985)): each iteration
doubles the effective depth, so ~30 iterations resolve 2^30 layers,
giving clean surface spectral functions A(E, k_par) -- edge flat bands,
Fermi arcs, Dirac surface cones -- with no finite-size artifacts.

A principal layer is the unit cell enlarged along the surface direction
until all hops couple only adjacent layers (``m = max |R_surf|``).  The
intra-layer Bloch block H00(k_par) is assembled by kernel 1, the
inter-layer block H01(k_par) by kernel 1's one-sided mode
(:func:`pythtb_tpu_torch.ops.hamiltonian.assemble_one_sided`; stored hops
with R_surf = -1 enter transposed-conjugated).  Orbital-position phases
along the surface direction drop out; parallel directions keep the
Convention-I phases.

* :func:`decimate` -- kernel 12 (``csrc/decimation.cu``): the whole
  decimation of every (E, k) pixel on chip, one launch; on a CPU tensor
  the plain PyTorch version (the JAX scan body, batched
  ``torch.linalg.solve_ex``).  Its Green's-function mode
  (``green=True``) returns the whole surface Green's function, which
  :mod:`pythtb_tpu_torch.negf` turns into lead self-energies.  The
  kernel takes principal layers of up to ``DECIMATION_MAX_S`` = 40
  states (its eight S x S matrices in shared memory); above that a CUDA
  tensor raises.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from . import config
from .core import bloch_data, finalize
from .model import PythtbError
from .ops import _kernels
from .ops.hamiltonian import assemble, assemble_one_sided

__all__ = ["spectral_function", "decimate"]

# largest principal layer (states) kernel 12 takes: csrc/decimation.cu's kMaxS
DECIMATION_MAX_S = 40
# peak coupling relative to the bare one beyond which a pixel counts as
# blown up (eta -> 0); the JAX package's float64 value
_BLOW = 1e50


def _layer_blocks(model, surf_dir):
    """(data00, data01, m): finalized sub-tables for the intra-layer
    (Hermitian) and inter-layer (one-sided) blocks of the principal-layer
    chain along ``surf_dir``."""
    if surf_dir not in model._per:
        raise PythtbError("surf_dir must be a periodic direction of the model.")
    for h in model._hoppings:
        r = float(h[3][surf_dir])
        if abs(r - round(r)) > 1e-9:
            raise PythtbError(
                "Layer construction needs integer lattice vectors along "
                "surf_dir; found R[%d] = %s (fractional R is legal for "
                "Bloch phases but has no layer decomposition)." % (surf_dir, r)
            )
    m = max([abs(int(np.round(h[3][surf_dir]))) for h in model._hoppings] or [0])
    work = model
    if m > 1:
        sc = np.identity(model._dim_r, dtype=int)
        sc[surf_dir, surf_dir] = m
        work = model.make_supercell(sc, to_home_suppress_warning=True)

    par_dirs = [p for p in work._per if p != surf_dir]
    hops0, hops1 = [], []  # (amp, i, j, R)
    for h in work._hoppings:
        amp, i, j = h[0], h[1], h[2]
        R = np.asarray(h[3], dtype=np.float64)
        rs = int(np.round(R[surf_dir]))
        if rs == 0:
            hops0.append((amp, i, j, R))
        elif rs == 1:
            hops1.append((amp, i, j, R))
        elif rs == -1:
            # fold into the +1 block as the conjugate-transposed hop
            camp = np.conj(np.asarray(amp, dtype=complex)).T if work._nspin == 2 else np.conj(amp)
            hops1.append((camp, j, i, -R))
        else:  # pragma: no cover - the supercell guarantees |rs| <= 1
            raise PythtbError("principal layer construction failed")

    def _fin(hops):
        if hops:
            amps, ii, jj, RR = zip(*hops)
        else:
            amps = np.zeros((0, 2, 2) if work._nspin == 2 else (0,), dtype=complex)
            ii = jj = np.zeros(0, dtype=int)
            RR = np.zeros((0, work._dim_r))
        return finalize(len(par_dirs), work._dim_r, par_dirs, work._nspin, work._norb, work._orb,
                        work._site_energies, amps, ii, jj, RR)

    return _fin(hops0), _fin(hops1), m


def _flip_side(data01):
    """The inter-layer table of the opposite surface: ``ii``/``jj``
    swapped, ``rv`` negated, amplitudes conjugate-transposed (a fresh
    gather index and C-ordered copies, as kernel 1 reads them)."""
    amps = data01.amps.cpu().numpy()
    camps = np.conj(np.swapaxes(amps, -1, -2)) if data01.nspin == 2 else np.conj(amps)
    return bloch_data(data01.dim_k, data01.norb, data01.nspin, data01.diag.cpu().numpy(), camps,
                      -data01.rv.cpu().numpy(), data01.jj.cpu().numpy(), data01.ii.cpu().numpy(),
                      data01.device)


def _decimate_plain(H00, H01, w, iters, green=False):
    """The JAX decimation scan in torch, batched over (E, K): the oracle
    of kernel 12.  Returns (gs, gb, afin, peak), or with ``green`` (G,
    afin, peak), as :func:`decimate`."""
    E = w.shape[0]
    K, S = H00.shape[0], H00.shape[-1]
    eye = torch.eye(S, dtype=config.COMPLEX, device=H00.device)
    wI = w[:, None, None, None] * eye  # (E, 1, S, S)
    eyes = eye.expand(E, K, S, S)

    def inv(x):
        return torch.linalg.solve_ex(x, eyes)[0]

    es = H00[None].expand(E, K, S, S)
    e = es
    a = H01[None].expand(E, K, S, S)
    b = a.conj().transpose(-1, -2)
    peak = a.abs().amax(dim=(-2, -1))
    for _ in range(int(iters)):
        g = inv(wI - e)
        t1, t2 = g @ b, g @ a
        agb = a @ t1
        bga = b @ t2
        a, b = a @ t2, b @ t1
        peak = torch.maximum(peak, a.abs().amax(dim=(-2, -1)))
        es = es + agb
        e = e + agb + bga

    afin = a.abs().amax(dim=(-2, -1))
    if green:
        return inv(wI - es), afin, peak

    def weights(x):
        return -torch.diagonal(inv(wI - x), dim1=-2, dim2=-1).imag / np.pi

    return weights(es), weights(e), afin, peak


def decimate(H00, H01, w, iters: int, green=False):
    """Sancho-Rubio decimation of every (energy, k) pixel.

    :param H00: (K, S, S) complex128 intra-layer blocks (Hermitian)
    :param H01: (K, S, S) complex128 inter-layer blocks
    :param w: (nE,) complex128 energies ``E + i eta``
    :param iters: decimation iterations (depth 2^iters layers)
    :param green: kernel 12's Green's-function mode: return the whole
      surface Green's function in place of the weights
    :returns: ``(gs, gb, afin, peak)``: the surface and bulk spectral
      weights ``-Im diag(G) / pi`` as (nE, K, S) float64, and per pixel
      max |a| after the last iteration and the running peak of max |a|,
      (nE, K) float64; with ``green``, ``(G, afin, peak)``, G the (nE, K,
      S, S) complex128 surface Green's function (w - es)^{-1}
    """
    if H00.device.type == "cpu":
        return _decimate_plain(H00, H01, w, iters, green)
    K, S = H00.shape[0], H00.shape[-1]
    if S > DECIMATION_MAX_S:
        raise ValueError("kernel 12 takes principal layers of at most %d states, got %d; run this surface "
                         "on the CPU (config.set_device(\"cpu\"))" % (DECIMATION_MAX_S, S))
    dev = H00.device
    nE = w.shape[0]
    _kernels.require(H00, "H00", config.COMPLEX, (K, S, S), dev)
    _kernels.require(H01, "H01", config.COMPLEX, (K, S, S), dev)
    _kernels.require(w, "w", config.COMPLEX, (nE,), dev)
    afin = torch.empty((nE, K), dtype=config.FLOAT, device=dev)
    peak = torch.empty_like(afin)
    if green:
        G = torch.empty((nE, K, S, S), dtype=config.COMPLEX, device=dev)
        _kernels.launch("decimation_green", dev, H00, H01, w, G, afin, peak, nE, K, S, int(iters))
        return G, afin, peak
    gs = torch.empty((nE, K, S), dtype=config.FLOAT, device=dev)
    gb = torch.empty_like(gs)
    _kernels.launch("decimation", dev, H00, H01, w, gs, gb, afin, peak, nE, K, S, int(iters))
    return gs, gb, afin, peak


def _spectral(data00, data01, kpar, w, iters):
    """Surface and bulk weights (nE, K, S) and the convergence residual
    of one decimation depth (``_spectral_jit``)."""
    H00 = assemble(data00, kpar)
    H01 = assemble_one_sided(data01, kpar)
    gs, gb, afin, peak = decimate(H00, H01, w, iters)
    return gs, gb, _residual(H01, afin, peak)


def _residual(H01, afin, peak):
    """The convergence residual of a decimation: (1) the worst remaining
    effective coupling relative to the bare one; (2) inf where a huge peak
    intermediate coupling marks an overflowed recursion (eta -> 0) as
    garbage even where the final coupling collapsed to 0."""
    scale = max(float(H01.abs().max()) if H01.numel() else 0.0, 1e-30)
    res = float(afin.max()) / scale
    if float(peak.max()) / scale > _BLOW:
        res = np.inf
    return res


def spectral_function(model, surf_dir, k_par=None, energies=None, eta=0.05, iters=35, side="bottom",
                      return_bulk=False, resolved=False, conv_tol=1e-6, max_iters=95):
    """Surface spectral function A(E, k_par) of the SEMI-INFINITE crystal
    terminated perpendicular to ``surf_dir``; see the module docstring.

    :param surf_dir: periodic direction to terminate (the model keeps its
      other periodic directions as surface momenta)
    :param k_par: (K, dim_k - 1) reduced surface momenta, ordered like the
      model's remaining periodic directions (None for a 1-D model)
    :param energies: (nE,) energy grid (default: span of a quick bulk
      solve, 201 points)
    :param eta: positive broadening
    :param iters: decimation steps (effective depth 2^iters layers);
      escalated in steps of 30, up to ``max_iters``, while the final
      effective inter-layer coupling has not fallen below ``conv_tol``
      relative to the bare one.  A warning is issued if even
      ``max_iters`` leaves a residual (or the recursion overflowed).
    :param side: "bottom" or "top" -- which of the two inequivalent
      surfaces to expose (swaps the roles of H01 and H01^dagger)
    :param return_bulk: also return the bulk-projected spectral function
    :param resolved: keep the per-state weights: output gains a trailing
      S axis
    :returns: A (nE, K) float array -- (nE, K, S) with ``resolved`` --
      (and A_bulk alike with ``return_bulk``); the integral of A over E is
      ~ S (states per principal layer)
    """
    data00, data01, _ = _layer_blocks(model, int(surf_dir))
    dpar = data00.dim_k
    if k_par is None:
        if dpar != 0:
            raise PythtbError("k_par required: model keeps %d surface momenta" % dpar)
        kpar = np.zeros((1, 0))
    else:
        kpar = np.asarray(k_par, dtype=np.float64)
        if kpar.ndim == 1:
            kpar = kpar[:, None] if dpar == 1 else kpar[None, :]
        if kpar.shape[1] != dpar:
            raise PythtbError(
                "k_par must have %d components (the non-terminated periodic directions)" % dpar)
    if energies is None:
        probe = model.solve_all(model.k_uniform_mesh([5] * model._dim_k))
        lo, hi = float(probe.min()), float(probe.max())
        pad = 0.05 * (hi - lo) + 2.0 * eta
        energies = np.linspace(lo - pad, hi + pad, 201)
    energies = np.asarray(energies, dtype=np.float64)
    if side == "top":
        # expose the opposite surface: relabel the layer order
        data01 = _flip_side(data01)
    elif side != "bottom":
        raise PythtbError('side must be "bottom" or "top"')

    dev = data00.device
    kt = torch.as_tensor(np.ascontiguousarray(kpar), dtype=config.FLOAT).to(dev)
    w = torch.as_tensor(energies + 1j * float(eta), dtype=config.COMPLEX).to(dev)
    it = int(iters)
    while True:
        gs, gb, res = _spectral(data00, data01, kt, w, it)
        if res <= conv_tol or it >= int(max_iters):
            break
        if not np.isfinite(res):
            break  # numerical blow-up (eta ~ 0): more depth cannot help
        it = min(int(max_iters), it + 30)
    # negated form: res can be NaN (inf * 0 in the blow-up regime), and the
    # warning must fire for NaN too
    if not res <= conv_tol:
        warnings.warn(
            "surface.spectral_function: decimation not converged "
            "(relative coupling residual %.2e after %d iterations); the "
            "broadening eta=%g is too small for this spectrum -- "
            "increase eta (or max_iters)" % (res, it, eta)
        )
    A_s = gs.cpu().numpy().astype(np.float64)
    A_b = gb.cpu().numpy().astype(np.float64)
    if not resolved:
        A_s, A_b = A_s.sum(axis=-1), A_b.sum(axis=-1)
    if return_bulk:
        return A_s, A_b
    return A_s
