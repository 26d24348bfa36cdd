"""Anderson / quasiperiodic localization toolkit (counterpart of
``pythtb_tpu.localization``) for 1-D chains and quasi-1-D strips built
from any :class:`~pythtb_tpu_torch.tb_model` with one periodic
direction.

* :func:`lyapunov_spectrum` / :func:`localization_length` -- the full
  Lyapunov spectrum of the transfer-matrix product over ``length``
  principal layers, re-orthonormalized every ``stride`` steps.  The
  principal-layer blocks come from kernel 1 and its one-sided mode at
  k = 0; the product itself is kernel 18 (``csrc/lyapunov.cu``), a warp
  (to 8 states a layer) or a block (to 40) per (realization, energy)
  carrying its frame through a whole chunk of steps, through
  :func:`lyapunov_chunk` (on a CPU tensor its plain PyTorch version, the
  JAX scan body).  The localization length is
  ``1 / gamma_min`` with ``gamma_min`` the smallest positive exponent.
* :func:`participation_ratio` -- (generalized) participation ratios of
  eigenstates of finite samples.
* :func:`level_spacing_ratio` -- the Oganesyan-Huse consecutive-gap
  ratio (Poisson 0.386294, GOE 0.53070, GUE 0.59975).

Disorder draws: the JAX package draws with ``jax.random`` (threefry),
which has no counterpart here.  This package draws the onsite disorder
with ``numpy.random.default_rng(seed)``, step by step and realization by
realization, on the host, and uploads it a chunk of whole macro steps at
a time: a seed gives the same exponents on the card and on the CPU, but
not the JAX package's.

The transfer-matrix construction needs an INVERTIBLE inter-layer block
``H01``: :func:`lyapunov_spectrum` raises with the measured condition
number otherwise.
"""

from __future__ import annotations

import numpy as np
import torch

from . import config
from .model import PythtbError
from .negf import _lead_tensors
from .ops import _kernels
from .surface import _layer_blocks

__all__ = [
    "lyapunov_spectrum",
    "localization_length",
    "participation_ratio",
    "level_spacing_ratio",
]

# largest principal layer (states) kernel 18 takes: csrc/lyapunov.cu's kMaxS
LYAPUNOV_MAX_S = 40
# kernel 18's designs: the C entry's code and the most states a layer each takes
_LYAPUNOV_DESIGNS = {"block": (0, LYAPUNOV_MAX_S), "warp": (1, 8)}
# onsite values (steps x realizations x states) drawn and uploaded at once
_CHUNK_VALUES = 1 << 22
_TINY = float(np.finfo(np.float64).tiny)


def _lyapunov_plain(A, hinv, Bm, w, Q, lyap, stride):
    """The JAX scan body in torch: the oracle of kernel 18.  Advances the
    frames Q (ndis, nE, 2S, 2S) through the (nsteps, ndis, S) onsite
    values w, a QR every ``stride`` steps adding log max(|R_jj|, tiny) to
    lyap (ndis, nE, 2S).  Returns the new (Q, lyap)."""
    S = A.shape[-1]
    for il in range(w.shape[0]):
        # H01^-1 diag(w): columns of H01^-1 scaled by w
        dcol = hinv[None] * w[il].to(config.COMPLEX)[:, None, :]  # (ndis, S, S)
        Qt, Qb = Q[..., :S, :], Q[..., S:, :]
        top = torch.einsum("est,detq->desq", A, Qt)
        top = top - torch.einsum("dst,detq->desq", dcol, Qt)
        top = top + torch.einsum("st,detq->desq", Bm, Qb)
        Q = torch.cat([top, Qt], dim=-2)
        if (il + 1) % stride == 0:
            Q, R = torch.linalg.qr(Q)
            diag = torch.diagonal(R, dim1=-2, dim2=-1).abs()
            lyap = lyap + torch.log(torch.clamp(diag, min=_TINY))
    return Q, lyap


def _lyapunov_design(S, nE, ndis, sms):
    """Kernel 18's design for layers of S states and nE x ndis chains on a
    card of ``sms`` SMs: a warp a chain wherever it takes S (to 8 states),
    a block a chain above.  On the H100 the warp won at every S 1-8 and
    every chain count measured, one chain to 512 on 132 SMs (PERF.md
    section 6), so the line does not move with the chains or the SMs."""
    return "warp" if S <= _LYAPUNOV_DESIGNS["warp"][1] else "block"


def lyapunov_chunk(A, hinv, Bm, w, Q, lyap, stride, design=None):
    """One chunk of the QR-stabilized transfer-matrix product.

    :param A: (nE, S, S) complex128, E H01^-1 - H01^-1 H00 per energy
    :param hinv: (S, S) complex128, H01^-1
    :param Bm: (S, S) complex128, -H01^-1 H01^dag
    :param w: (nsteps, ndis, S) float64 onsite values of the chunk's
      layers, nsteps a multiple of ``stride``
    :param Q: (ndis, nE, 2S, 2S) complex128 frames at the chunk's start
    :param lyap: (ndis, nE, 2S) float64 log sums so far
    :param design: kernel 18's design on a CUDA tensor, ``"warp"`` or
      ``"block"`` (:func:`_lyapunov_design`'s choice if None)
    :returns: ``(Q, lyap)`` after the chunk (kernel 18 updates the
      tensors it was given in place and returns them)
    """
    if w.shape[0] % stride:
        raise ValueError("a chunk must hold whole macro steps: %d steps, stride %d" % (w.shape[0], stride))
    if A.device.type == "cpu":
        return _lyapunov_plain(A, hinv, Bm, w, Q, lyap, stride)
    nE, S = A.shape[0], A.shape[-1]
    if S > LYAPUNOV_MAX_S:
        raise ValueError("kernel 18 takes principal layers of at most %d states, got %d; run this strip "
                         "on the CPU (config.set_device(\"cpu\"))" % (LYAPUNOV_MAX_S, S))
    dev = A.device
    nsteps, ndis = w.shape[0], w.shape[1]
    if design is None:
        design = _lyapunov_design(S, nE, ndis, _kernels.card(dev)[0])
    if design not in _LYAPUNOV_DESIGNS:
        raise ValueError("kernel 18 has no %r design; it has %s" % (design, ", ".join(_LYAPUNOV_DESIGNS)))
    code, most = _LYAPUNOV_DESIGNS[design]
    if S > most:
        raise ValueError("kernel 18's %r design takes at most %d states, got %d" % (design, most, S))
    _kernels.require(A, "A", config.COMPLEX, (nE, S, S), dev)
    _kernels.require(hinv, "hinv", config.COMPLEX, (S, S), dev)
    _kernels.require(Bm, "Bm", config.COMPLEX, (S, S), dev)
    _kernels.require(w, "w", config.FLOAT, (nsteps, ndis, S), dev)
    _kernels.require(Q, "Q", config.COMPLEX, (ndis, nE, 2 * S, 2 * S), dev)
    _kernels.require(lyap, "lyap", config.FLOAT, (ndis, nE, 2 * S), dev)
    _kernels.launch("lyapunov", dev, A, hinv, Bm, w, Q, lyap, nE, ndis, S, nsteps, int(stride), code)
    return Q, lyap


def _blocks_dense(model):
    """Dense (H00, H01, m) principal-layer blocks of a dim_k == 1
    model (m = supercell factor used to reach nearest-layer form)."""
    if model._dim_k != 1:
        raise PythtbError(
            "lyapunov_spectrum needs a model with exactly one periodic "
            "direction (dim_k == 1); got dim_k = %d.  Cut or reduce "
            "the model to a chain / strip first." % model._dim_k)
    data00, data01, m = _layer_blocks(model, model._per[0])
    H00, H01 = _lead_tensors(data00, data01)
    return H00.cpu().numpy().astype(np.complex128), H01.cpu().numpy().astype(np.complex128), m


def _onsite(pot, disorder, rng, start, nsteps, ndis):
    """(nsteps, ndis, S) onsite values of layers start .. start + nsteps:
    the potential, tiled, plus W * (u - 1/2) with u drawn step-major from
    ``rng``, so that consecutive chunks continue one stream."""
    S = pot.shape[1]
    w = np.broadcast_to(pot[np.arange(start, start + nsteps) % pot.shape[0]][:, None, :], (nsteps, ndis, S))
    if rng is None:
        return np.array(w)
    return w + disorder * (rng.uniform(size=(nsteps, ndis, S)) - 0.5)


def lyapunov_spectrum(model, energies, length, disorder=0.0,
                      potential=None, realizations=1, seed=0,
                      stride=8):
    """Full Lyapunov spectrum of the principal-layer transfer-matrix
    product of a ``dim_k == 1`` model.

    The model's one periodic direction defines the chain of principal
    layers (hops of range > 1 are blocked into enlarged layers exactly
    as in :func:`pythtb_tpu_torch.surface.spectral_function`); ``length``
    counts principal layers.  Exponents are per principal-layer step.

    :param model: :class:`tb_model` with dim_k == 1 (any dim_r, nspin)
    :param energies: scalar or 1-D array of probe energies
    :param length: number of transfer steps (principal layers)
    :param disorder: uniform onsite disorder full width W (each state
      in each layer draws from ``[-W/2, W/2]`` independently per
      layer; all energies share the draw, realizations differ)
    :param potential: optional deterministic per-layer onsite sequence
      added on top: ``(L, S)``, or ``(L,)`` when S == 1, or ``(S,)`` for
      a layer-independent profile; L is tiled periodically if shorter
      than ``length``
    :param realizations: independent disorder samples
    :param seed: seed of ``numpy.random.default_rng`` for the disorder
      draws (the same exponents on every device; not the JAX package's
      draws, which come from ``jax.random``)
    :param stride: steps between re-orthonormalizations
    :returns: ``(realizations, nE, 2S)`` exponents per layer step,
      sorted descending along the last axis (``+-gamma`` pairs)
    """
    energies = np.atleast_1d(np.asarray(energies, dtype=float))
    if energies.ndim != 1:
        raise PythtbError("energies must be a scalar or 1-D array")
    H00, H01, _m = _blocks_dense(model)
    S = H00.shape[0]
    cond = np.linalg.cond(H01)
    if not np.isfinite(cond) or cond > 1e12:
        raise PythtbError(
            "the inter-layer block H01 is numerically singular "
            "(cond = %.2e): this model has no transfer-matrix "
            "formulation.  Orbitals that do not couple to the next "
            "layer must be eliminated (or grouped) first." % cond)
    length = int(length)
    stride = max(1, min(int(stride), length))
    length -= length % stride
    if length <= 0:
        raise PythtbError("length must be >= 1 step")
    disorder = float(disorder)
    if disorder < 0:
        raise PythtbError("disorder width must be >= 0")
    if potential is None:
        pot = np.zeros((1, S))
    else:
        pot = np.asarray(potential, dtype=float)
        if pot.ndim == 1:
            if S == 1:
                pot = pot[:, None]
            elif pot.shape[0] == S:
                pot = pot[None, :]
            else:
                raise PythtbError(
                    "1-D potential must have length S = %d (per-state "
                    "profile) for this strip; give (L, S) for a "
                    "layer-dependent sequence" % S)
        if pot.ndim != 2 or pot.shape[1] != S:
            raise PythtbError(
                "potential must be (L,), (S,) or (L, S) with S = %d "
                "states per principal layer" % S)
    ndis = int(realizations)
    dev = config.checked_device()
    h00 = torch.as_tensor(H00).to(dev)
    h01 = torch.as_tensor(H01).to(dev)
    eye = torch.eye(S, dtype=config.COMPLEX, device=dev)
    hinv = torch.linalg.solve(h01, eye).contiguous()  # the card's solve returns column-major
    # psi_{l+1} = H01^-1 (E - H00 - diag(w_l)) psi_l - H01^-1 H01^dag psi_{l-1}
    E = torch.as_tensor(energies, dtype=config.COMPLEX).to(dev)
    A = (E[:, None, None] * hinv[None] - (hinv @ h00)[None]).contiguous()
    Bm = (-hinv @ h01.conj().T).contiguous()
    Q = torch.eye(2 * S, dtype=config.COMPLEX, device=dev).expand(ndis, len(energies), 2 * S, 2 * S).contiguous()
    lyap = torch.zeros((ndis, len(energies), 2 * S), dtype=config.FLOAT, device=dev)
    rng = np.random.default_rng(int(seed)) if disorder != 0.0 else None
    chunk = max(stride, _CHUNK_VALUES // max(ndis * S, 1) // stride * stride)
    for start in range(0, length, chunk):
        n = min(chunk, length - start)
        w = torch.as_tensor(_onsite(pot, disorder, rng, start, n, ndis), dtype=config.FLOAT).to(dev)
        Q, lyap = lyapunov_chunk(A, hinv, Bm, w, Q, lyap, stride)
    out = lyap.cpu().numpy().astype(np.float64)
    return -np.sort(-out / float(length), axis=-1)


def localization_length(model, energies, length, disorder=0.0,
                        potential=None, realizations=1, seed=0,
                        stride=8):
    """Localization length ``xi(E) = 1 / gamma_min(E)`` (in principal
    layers) from :func:`lyapunov_spectrum`.

    ``gamma_min`` is the smallest positive Lyapunov exponent -- rank
    S of the descending spectrum (the lower half mirrors it with a
    minus sign) -- averaged over realizations.  Returns ``(nE,)``
    lengths (``inf`` where ``gamma_min <= 0`` within roundoff, i.e.
    extended at this sample length).
    """
    lyap = lyapunov_spectrum(model, energies, length, disorder,
                             potential, realizations, seed, stride)
    S = lyap.shape[-1] // 2
    gmin = lyap[..., S - 1].mean(axis=0)
    with np.errstate(divide="ignore"):
        return np.where(gmin > 0.0, 1.0 / np.maximum(gmin, 1e-300),
                        np.inf)


def participation_ratio(states, q=2, spinful=False):
    """(Generalized) participation ratios of a batch of states.

    ``PR_q = (sum_i p_i)^q / sum_i p_i^q`` with ``p_i = |psi_i|^2``
    per site; for q = 2 this is the standard participation ratio (the
    number of sites a state effectively occupies: L for a plane wave
    on an L-site ring, 2L/3 for an open-chain standing wave, 1 for a
    single-site state).  States need not be normalized.

    :param states: (..., norb) amplitudes, or (..., norb, 2) with
      ``spinful=True`` (the layout :meth:`tb_model.solve_all` returns
      with ``eig_vectors=True``); spin is summed into the site weight
    :param q: moment order (q > 1; fractional is fine)
    :param spinful: collapse a trailing spin axis of length 2
    :returns: (...,) participation ratios
    """
    if float(q) <= 1:
        raise PythtbError("participation_ratio needs q > 1")
    p = np.abs(np.asarray(states)) ** 2
    if spinful:
        if p.shape[-1] != 2:
            raise PythtbError("spinful=True needs a trailing spin "
                              "axis of length 2")
        p = p.sum(axis=-1)
    norm = p.sum(axis=-1)
    return norm ** float(q) / (p ** float(q)).sum(axis=-1)


def level_spacing_ratio(evals, mean=True):
    """Oganesyan-Huse consecutive-gap ratio of a spectrum.

    ``r_n = min(s_n, s_{n+1}) / max(s_n, s_{n+1})`` with
    ``s_n = E_{n+1} - E_n``; unfolding-free.  Reference values:
    Poisson ``2 ln 2 - 1 = 0.386294``, GOE ``0.53070``, GUE
    ``0.59975`` (pinned by the committed random-matrix oracles).

    :param evals: (..., N) spectra (sorted along the last axis
      internally; leading axes = independent samples)
    :param mean: return the grand mean (default) or the (..., N-2)
      per-gap ratios
    """
    ev = np.sort(np.asarray(evals, dtype=np.float64), axis=-1)
    s = np.diff(ev, axis=-1)
    lo = np.minimum(s[..., :-1], s[..., 1:])
    hi = np.maximum(s[..., :-1], s[..., 1:])
    r = lo / np.maximum(hi, 1e-300)
    return float(r.mean()) if mean else r
