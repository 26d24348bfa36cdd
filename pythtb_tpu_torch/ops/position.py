"""Position-operator matrix elements and hybrid Wannier functions
(counterpart of ``pythtb_tpu.ops.position``).

In the diagonal-position approximation
``X[n, m] = sum_f conj(u_n[f]) * pos[f] * u_m[f]``; its diagonal is the
position expectation, and its eigen-decomposition gives hybrid-Wannier
centres (eigenvalues) and functions (eigenvectors, rows).

* X and its diagonal: kernel 6 (``csrc/position.cu``) on a CUDA tensor,
  :func:`_xmat_plain` / :func:`_xdiag_plain` on a CPU tensor.  The kernel
  reads the chosen states through an index array, so the selection is
  never copied out of the state grid.  X takes a thread an element below
  ``_TILE_MIN_S`` states and tiles on the FP64 tensor cores from there
  (:func:`_position_path`).
* The eigen-decomposition goes through :func:`ops.eigh.eigh_batched`
  (kernel 2 at two states, ``torch.linalg.eigh`` above), as the JAX
  package leaves it to ``jnp.linalg.eigh``.  The back-transform of the
  functions to the orbital basis is one batched ``torch.matmul``.

States arrive as (batch..., nsta, F) complex tensors, F the flattened
orbital(/spin) axis.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import config
from . import _kernels
from .eigh import eigh_batched, eigvalsh_batched

__all__ = [
    "xmat",
    "position_matrix_host",
    "position_hwf_host",
    "position_expectation_states",
    "position_hwf_states",
]


# kernel 6's dispatch line: from this many chosen states X is formed in
# tiles on the FP64 tensor cores, below it a thread an element (PERF.md
# section 6 has both designs' times)
_TILE_MIN_S = 16
# C modes of kernel 6
_POSITION_MODES = {"threads": 0, "diagonal": 1, "tiles": 2}


def _position_path(S):
    """Kernel 6's design for X of S chosen states: "threads" or "tiles"."""
    return "tiles" if S >= _TILE_MIN_S else "threads"


def _select(w, occ):
    return w if occ is None else w.index_select(-2, occ)


def _xmat_plain(w, pos, occ=None):
    """Plain PyTorch X matrices (one einsum): the oracle of kernel 6."""
    w = _select(w, occ)
    return torch.einsum("...nf,f,...mf->...nm", w.conj(), pos.to(w.dtype), w)


def _xdiag_plain(w, pos, occ=None):
    """Plain PyTorch diagonal of X, float64: the oracle of kernel 6's
    diagonal mode."""
    w = _select(w, occ)
    return torch.einsum("...nf,f,...nf->...n", w.conj(), pos.to(w.dtype), w).real


def xmat(w, pos, occ=None, diagonal=False):
    """Position matrices of states ``occ`` (all if None) of ``w``
    (B, nsta, F), with orbital positions ``pos`` (F,): (B, S, S) complex,
    exactly Hermitian, or with ``diagonal`` only Re X_nn as (B, S) float."""
    return _xmat(w, pos, occ, diagonal, None)


def _xmat(w, pos, occ, diagonal, path):
    """:func:`xmat` with X on kernel 6's design ``path`` ("threads" or
    "tiles"; :func:`_position_path`'s choice if None)."""
    if path not in (None, "threads", "tiles"):
        raise ValueError("kernel 6 has no %r path; it has threads, tiles" % (path,))
    if w.device.type == "cpu":
        return _xdiag_plain(w, pos, occ) if diagonal else _xmat_plain(w, pos, occ)
    dev = w.device
    B, nsta, F = w.shape
    if occ is None:
        occ = torch.arange(nsta, dtype=torch.int64, device=dev)
    S = occ.shape[0]
    _kernels.require(w, "w", config.COMPLEX, (B, nsta, F))
    _kernels.require(pos, "pos", config.FLOAT, (F,), dev)
    _kernels.require(occ, "occ", torch.int64, (S,), dev)
    if diagonal:
        mode = _POSITION_MODES["diagonal"]
        out = torch.empty((B, S), dtype=config.FLOAT, device=dev)
    else:
        mode = _POSITION_MODES[_position_path(S) if path is None else path]
        out = torch.empty((B, S, S), dtype=config.COMPLEX, device=dev)
    _kernels.launch("position", dev, w, pos, occ, out, B, nsta, S, F, mode)
    return out


def _hwf(w, pos, occ, want_evec, orbital_basis):
    """Centres (and functions) of (B, nsta, F) states: X through the
    kernel, then eigh; the functions optionally on the orbital basis,
    hwf_orb[h] = sum_b hwf[h, b] u_b."""
    X = xmat(w, pos, occ)
    if not want_evec:
        return eigvalsh_batched(X)
    hwfc, hwf = eigh_batched(X)  # rows are states, centres ascending
    if orbital_basis:
        hwf = torch.matmul(hwf, _select(w, occ))
    return hwfc, hwf


def _to_host(t):
    return np.array(t.detach().cpu().numpy(), copy=True)


def _upload(wfs, pos):
    """Host states (..., nb, F) and weights (F,) -> a (B, nb, F) device
    tensor, the weights tensor and the leading shape."""
    wfs = np.asarray(wfs, dtype=np.complex128)
    dev = config.checked_device()
    lead = wfs.shape[:-2]
    w = torch.from_numpy(np.ascontiguousarray(wfs.reshape((-1,) + wfs.shape[-2:]))).to(dev)
    p = torch.from_numpy(np.ascontiguousarray(pos, dtype=np.float64)).to(dev)
    return w, p, lead


def position_matrix_host(wfs, pos):
    """wfs (..., nb, F) complex, pos (F,) -> X (..., nb, nb) NumPy."""
    w, p, lead = _upload(wfs, pos)
    X = xmat(w, p)
    return _to_host(X).reshape(lead + X.shape[-2:])


def position_hwf_host(wfs, pos, want_evec=False, orbital_basis=False):
    """Hybrid-Wannier centres (..., nb) (and functions) of host states."""
    w, p, lead = _upload(wfs, pos)
    out = _hwf(w, p, None, want_evec, orbital_basis)
    if not want_evec:
        return _to_host(out).reshape(lead + out.shape[-1:])
    hwfc, hwf = out
    return _to_host(hwfc).reshape(lead + hwfc.shape[-1:]), _to_host(hwf).reshape(lead + hwf.shape[-2:])


def _grid_states(wfs, pos, occ, dim_arr):
    """(grid..., nsta, norb[, 2]) device states -> the (B, nsta, F) view
    (spin merged into F), the weights and the occ index on the same
    device."""
    grid = tuple(wfs.shape[:dim_arr])
    nsta = wfs.shape[dim_arr]
    w = wfs.reshape((math.prod(grid), nsta, -1)).contiguous()
    p = torch.as_tensor(np.asarray(pos, dtype=np.float64)).to(w.device)
    idx = torch.as_tensor(np.asarray(occ, dtype=np.int64)).to(w.device)
    return w, p, idx, grid


def position_expectation_states(wfs, pos, occ, dim_arr):
    """Grid-batched position expectations (diagonal mode): (grid..., S)."""
    w, p, idx, grid = _grid_states(wfs, pos, occ, dim_arr)
    return _to_host(xmat(w, p, idx, diagonal=True)).reshape(grid + (len(occ),))


def position_hwf_states(wfs, pos, occ, dim_arr, want_evec, orbital_basis):
    """Grid-batched hybrid-Wannier centres (grid..., S), and with
    ``want_evec`` the functions (grid..., S, S) or, on the orbital
    basis, (grid..., S, F)."""
    w, p, idx, grid = _grid_states(wfs, pos, occ, dim_arr)
    out = _hwf(w, p, idx, bool(want_evec), bool(orbital_basis))
    if not want_evec:
        return _to_host(out).reshape(grid + out.shape[-1:])
    hwfc, hwf = out
    return _to_host(hwfc).reshape(grid + hwfc.shape[-1:]), _to_host(hwf).reshape(grid + hwf.shape[-2:])
