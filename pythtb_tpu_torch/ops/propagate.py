"""The midpoint-propagator chain: kernel 22 (``csrc/propagate.cu``).

One step of exact time evolution applies exp(-i H dt) =
sum_n V[n, s] e^{-i w_n dt} conj(V[n, t]) (eigenvectors as rows, the
``eigh_batched`` layout) to the state.  The JAX package runs the step
inside ``lax.scan`` twice: ``pythtb_tpu.optical._td_current_jit`` evolves
the occupied rows psi (R, nocc, S) and reads the current
Re <psi| dH_a |psi> after every step (:func:`propagate_state`), and
``pythtb_tpu.floquet._propagation_scan`` multiplies the full evolution
operator U (R, S, S), optionally keeping every step's U
(:func:`propagate_full`).  The eigenpairs of every step (and dH) do not
depend on the state, so the callers build them for a chunk of steps in a
few launches (:func:`chunk_steps` sizes the chunk) and one kernel-22
launch walks the chunk's chain.

On a CUDA tensor the wrappers launch kernel 22 (S <= 64; above, they
raise); on a CPU tensor they run the plain versions below: the
reference's two einsums a step, in a Python loop.
"""

from __future__ import annotations

import torch

from .. import config
from . import _kernels

__all__ = ["propagate_state", "propagate_full", "chunk_steps", "KERNEL_MAX_S", "CHUNK_BYTES"]

# most states kernel 22 takes (registers up to 8, a block's shared memory
# from 9 to 64)
KERNEL_MAX_S = 64
# device bytes that one chunk's step tensors (H, its eigenpairs, dH, a
# history) may take together
CHUNK_BYTES = 2 * 1024**3
_WARP = 32  # rows a block on kernel 22's register path (S <= 8)


def chunk_steps(nt, step_bytes):
    """Steps per chunk: as many as keep ``step_bytes`` a step under
    :data:`CHUNK_BYTES`, at least one."""
    return int(max(1, min(nt, CHUNK_BYTES // max(int(step_bytes), 1))))


def _check(S, dev):
    if dev.type == "cuda" and S > KERNEL_MAX_S:
        raise ValueError(
            "kernel 22 (the propagator chain) takes at most %d states on a CUDA tensor, got %d; "
            'call pythtb_tpu_torch.config.set_device("cpu") to run this model on the CPU' % (KERNEL_MAX_S, S))


def _step_exp(w, V, dt):
    """exp(-i H dt) (R, S, S) of one step from its eigenpairs: the
    reference's einsum ``bns,bn,bnt->bst``."""
    phase = torch.polar(torch.ones_like(w), -w * dt[:, None])
    return torch.einsum("bns,bn,bnt->bst", V, phase, V.conj())


def _propagate_state_plain(w, V, dH, psi, dt, groups):
    """Plain state mode: the oracle of kernel 22's state mode.  Returns
    (psi after the chunk, j (Tc, groups, d))."""
    Tc, R = w.shape[:2]
    d = dH.shape[2]
    js = []
    for st in range(Tc):
        psi = torch.einsum("bst,bmt->bms", _step_exp(w[st], V[st], dt), psi)
        cur = torch.einsum("bms,bast,bmt->ba", psi.conj(), dH[st], psi).real
        js.append(cur.reshape(groups, R // groups, d).sum(dim=1))
    j = torch.stack(js) if js else w.new_zeros((0, groups, d))
    return psi, j


def _propagate_full_plain(w, V, U, dt, hist=None):
    """Plain full mode: the oracle of kernel 22's full mode.  Returns U
    after the chunk; writes every step's U into ``hist`` (Tc, R, S, S)
    where given."""
    for st in range(w.shape[0]):
        U = torch.einsum("bst,btu->bsu", _step_exp(w[st], V[st], dt), U)
        if hist is not None:
            hist[st] = U
    return U


def propagate_state(w, V, dH, psi, dt, groups=1):
    """Evolve the occupied rows through a chunk of steps and read the
    current after each.

    :param w: (Tc, R, S) float64 eigenvalues of each step's H
    :param V: (Tc, R, S, S) complex128 eigenvectors, states as rows
    :param dH: (Tc, R, d, S, S) complex128 dH/dk at each step's end
    :param psi: (R, nocc, S) complex128 state, rows are states; on a
      CUDA tensor it is updated in place (contiguous)
    :param dt: (R,) float64 step per row
    :param groups: the rows are ``groups`` blocks of R / groups (one
      drive frequency each); the current is summed within a block
    :returns: (psi, j) with j (Tc, groups, d) float64 = sum over a
      block's rows of Re <psi| dH_a |psi>
    """
    Tc, R, S = w.shape
    d = dH.shape[2]
    nocc = psi.shape[1]
    if R % groups:
        raise ValueError("%d rows do not split into %d groups" % (R, groups))
    if w.device.type == "cpu":
        return _propagate_state_plain(w, V, dH, psi, dt, groups)
    _check(S, w.device)
    dev = w.device
    w, V, dH = w.contiguous(), V.contiguous(), dH.contiguous()
    _kernels.require(w, "w", config.FLOAT, (Tc, R, S), dev)
    _kernels.require(V, "V", config.COMPLEX, (Tc, R, S, S), dev)
    _kernels.require(dH, "dH", config.COMPLEX, (Tc, R, d, S, S), dev)
    _kernels.require(psi, "psi", config.COMPLEX, (R, nocc, S), dev)
    _kernels.require(dt, "dt", config.FLOAT, (R,), dev)
    Rg = R // groups
    slots = -(-Rg // _WARP) if S <= 8 else Rg
    part = torch.empty((Tc, groups, slots, d), dtype=config.FLOAT, device=dev)
    j = torch.empty((Tc, groups, d), dtype=config.FLOAT, device=dev)
    _kernels.launch("propagate_state", dev, w, V, dH, psi, dt, part, j, Tc, R, Rg, S, nocc, d)
    return psi, j


def propagate_full(w, V, U, dt, hist=None):
    """Multiply a chunk of steps' exp(-i H dt) onto U.

    :param w: (Tc, R, S) float64, :param V: (Tc, R, S, S) complex128
      (states as rows), :param dt: (R,) float64, as in
      :func:`propagate_state`
    :param U: (R, S, S) complex128; on a CUDA tensor updated in place
      (contiguous)
    :param hist: optional (Tc, R, S, S) complex128 that receives U after
      every step
    :returns: U after the chunk
    """
    Tc, R, S = w.shape
    if w.device.type == "cpu":
        return _propagate_full_plain(w, V, U, dt, hist)
    _check(S, w.device)
    dev = w.device
    w, V = w.contiguous(), V.contiguous()
    _kernels.require(w, "w", config.FLOAT, (Tc, R, S), dev)
    _kernels.require(V, "V", config.COMPLEX, (Tc, R, S, S), dev)
    _kernels.require(U, "U", config.COMPLEX, (R, S, S), dev)
    _kernels.require(dt, "dt", config.FLOAT, (R,), dev)
    if hist is not None:
        _kernels.require(hist, "hist", config.COMPLEX, (Tc, R, S, S), dev)
    _kernels.launch("propagate_full", dev, w, V, U, dt, hist, Tc, R, S)
    return U
