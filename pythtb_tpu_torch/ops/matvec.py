"""Matrix-free Hamiltonian application for large finite models
(counterpart of ``pythtb_tpu.ops.matvec``).

The Hamiltonian is stored in ELL (padded-row) form -- ``cols (norb, D)``
neighbour indices and ``vals (norb, D)`` amplitudes (``(norb, D, 2, 2)``
spin blocks at nspin 2), D the largest row degree -- so that
``y[n] = sum_d vals[n, d] x[cols[n, d]]`` is a gather and a short sum
with no scatter.  Both hop directions and the on-site diagonal are in
the table; padding slots hold column 0 and value 0.  The tables are
built on the host in NumPy, exactly as the JAX package builds them, and
uploaded once.

* :func:`matvec` runs kernel 8 (``csrc/ell_matvec.cu``) on a CUDA tensor
  and :func:`_matvec_plain` (one einsum) on a CPU tensor.
* Blocks of vectors are (norb, B), or (norb, 2, B) at nspin 2; the flat
  state index is spin-fastest, so the same memory is (nsta, B).

Everything here is for FINITE models (``dim_k == 0``), or one k-point of
a periodic one (:func:`sparse_h_k`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import config
from . import _kernels

__all__ = ["SparseH", "sparse_h", "sparse_h_k", "matvec", "gershgorin_window", "to_dense"]


@dataclasses.dataclass(frozen=True)
class SparseH:
    """ELL form of a finite Hamiltonian, on the device.

    ``cols``: (norb, D) int32 neighbour orbital indices (0 at padding);
    ``vals``: (norb, D) complex128 amplitudes, or (norb, D, 2, 2) spin
    blocks, zero at padding; ``y[n] = sum_d vals[n, d] @ x[cols[n, d]]``
    is the full H @ x.  ``window``: host-side Gershgorin spectral bounds
    (lo, hi).
    """

    cols: torch.Tensor
    vals: torch.Tensor
    norb: int
    nspin: int
    window: tuple

    @property
    def nsta(self):
        return self.norb * self.nspin

    @property
    def device(self):
        return self.cols.device


def _ell_tables(rows, cols, vals, norb):
    """Pack COO triplets into padded-row (ELL) tables on host."""
    order = np.argsort(rows, kind="stable")
    rows, cols, vals = rows[order], cols[order], vals[order]
    counts = np.bincount(rows, minlength=norb)
    D = max(int(counts.max()) if counts.size else 0, 1)
    offsets = np.concatenate([[0], np.cumsum(counts)])
    slot = np.arange(len(rows)) - offsets[rows]
    tcols = np.zeros((norb, D), dtype=np.int32)
    tvals = np.zeros((norb, D) + vals.shape[1:], dtype=np.complex128)
    tcols[rows, slot] = cols
    tvals[rows, slot] = vals
    return tcols, tvals


def _model_coo(model, phases=None):
    """COO triplets (rows, cols, vals) + onsite blocks from a builder
    model's hopping table, both hop directions included.  ``phases``
    (nhop,) complex multiplies the forward amplitudes (Bloch factors
    for :func:`sparse_h_k`); the reverse direction gets the conjugate,
    keeping H exactly Hermitian."""
    norb = int(model._norb)
    nspin = int(model._nspin)
    nhop = len(model._hoppings)
    ii = np.array([h[1] for h in model._hoppings], dtype=np.int64).reshape(nhop)
    jj = np.array([h[2] for h in model._hoppings], dtype=np.int64).reshape(nhop)
    diag_idx = np.arange(norb, dtype=np.int64)
    if nspin == 1:
        amps = np.array([h[0] for h in model._hoppings], dtype=np.complex128).reshape(nhop)
        if phases is not None:
            amps = amps * phases
        ons = np.asarray(model._site_energies, dtype=np.complex128)
        rows = np.concatenate([ii, jj, diag_idx])
        cols = np.concatenate([jj, ii, diag_idx])
        vals = np.concatenate([amps, np.conj(amps), ons])
    else:
        amps = np.array(
            [np.asarray(h[0], dtype=np.complex128) for h in model._hoppings]
        ).reshape(nhop, 2, 2)
        if phases is not None:
            amps = amps * phases[:, None, None]
        ons = np.asarray(model._site_energies, dtype=np.complex128)  # (norb,2,2)
        rows = np.concatenate([ii, jj, diag_idx])
        cols = np.concatenate([jj, ii, diag_idx])
        vals = np.concatenate([amps, np.conj(np.swapaxes(amps, -1, -2)), ons], axis=0)
    return rows, cols, vals, ons, norb, nspin


def _upload(tcols, tvals, norb, nspin, window):
    dev = config.checked_device()
    return SparseH(
        cols=torch.as_tensor(np.ascontiguousarray(tcols)).to(dev),
        vals=torch.as_tensor(np.ascontiguousarray(tvals), dtype=config.COMPLEX).to(dev),
        norb=norb,
        nspin=nspin,
        window=window,
    )


def _finish_sparse(rows, cols, vals, ons, norb, nspin):
    """Pack COO to ELL, compute the Gershgorin window, wrap a SparseH."""
    diag_idx = np.arange(norb, dtype=np.int64)
    tcols, tvals = _ell_tables(rows, cols, vals, norb)

    # Gershgorin window on host, from the same tables
    if nspin == 1:
        isdiag = tcols == diag_idx[:, None].astype(np.int32)
        center = np.real(np.sum(np.where(isdiag, tvals, 0.0), axis=1))
        radius = np.sum(np.where(isdiag, 0.0, np.abs(tvals)), axis=1)
    else:
        # the row's true diagonal block is the sum over ALL diagonal ELL
        # slots -- onsite plus any same-orbital (i == j, R != 0) hop
        # blocks (Kane-Mele SOC, Haldane t2); using only the onsite
        # blocks under-covers the spectrum
        isdiag = tcols == diag_idx[:, None].astype(np.int32)
        Dsum = np.sum(np.where(isdiag[..., None, None], tvals, 0.0), axis=1)
        Dsum = (Dsum + np.conj(np.swapaxes(Dsum, -1, -2))) / 2.0
        ev = np.linalg.eigvalsh(Dsum)
        center = ev.mean(axis=-1)
        radius = (ev[:, 1] - ev[:, 0]) / 2.0
        bnorm = np.linalg.norm(tvals, ord=2, axis=(-2, -1))
        radius = radius + np.sum(np.where(isdiag, 0.0, bnorm), axis=1)
    window = (float((center - radius).min()), float((center + radius).max()))
    return _upload(tcols, tvals, norb, nspin, window)


def sparse_h(model):
    """Build :class:`SparseH` from a finite (dim_k == 0) builder model
    without materializing anything dense."""
    from ..model import PythtbError

    if model._dim_k != 0:
        raise PythtbError(
            "sparse_h requires a finite model (dim_k == 0); cut_piece or "
            "reduce_dim the model first"
        )
    return _finish_sparse(*_model_coo(model))


def sparse_h_k(model, kpt):
    """ELL form of the Bloch Hamiltonian H(k) of a PERIODIC model at one
    reduced k-point, Convention I (phase ``exp(2j*pi*k.rv)`` with
    ``rv = -t_i + t_j + R`` restricted to the periodic directions, as
    :func:`pythtb_tpu_torch.ops.hamiltonian.assemble`), so eigenvectors
    match ``solve_all``'s gauge."""
    from ..model import PythtbError

    if model._dim_k == 0:
        raise PythtbError("sparse_h_k needs a periodic model; use sparse_h")
    kpt = np.asarray(kpt, dtype=np.float64).reshape(-1)
    if kpt.shape[0] != model._dim_k:
        raise PythtbError("kpt must have %d components" % model._dim_k)
    nhop = len(model._hoppings)
    per = list(model._per)
    rv = np.array(
        [(-model._orb[h[1], :] + model._orb[h[2], :] + np.asarray(h[3], dtype=np.float64))[per]
         for h in model._hoppings], dtype=np.float64,
    ).reshape(nhop, model._dim_k)
    phases = np.exp(2.0j * np.pi * (rv @ kpt))
    return _finish_sparse(*_model_coo(model, phases))


def _matvec_plain(h: SparseH, x):
    """Plain PyTorch H @ x (gather + einsum): the oracle of kernel 8."""
    if h.nspin == 1:
        return torch.einsum("nd,ndB->nB", h.vals, x[h.cols])
    return torch.einsum("ndab,ndbB->naB", h.vals, x[h.cols])


def _check_tables(h: SparseH):
    D = h.cols.shape[1]
    _kernels.require(h.cols, "cols", torch.int32, (h.norb, D))
    _kernels.require(h.vals, "vals", config.COMPLEX, (h.norb, D) + (2, 2)[: 2 * (h.nspin - 1)], h.device)
    return D


def apply_rows(h: SparseH, x, out):
    """``out = H @ x`` for (nsta, B) views whose rows are contiguous but
    need not be adjacent (slots of a larger block).  Kernel 8 on CUDA
    tensors; the plain version on CPU tensors."""
    nsta, B = x.shape
    if x.device.type == "cpu":
        shape = (h.norb, 2, B) if h.nspin == 2 else (h.norb, B)
        out.copy_(_matvec_plain(h, x.reshape(shape)).reshape(nsta, B))
        return out
    D = _check_tables(h)
    ldx = _kernels.require_rows(x, "x", config.COMPLEX, (h.nsta, B), h.device)
    ldy = _kernels.require_rows(out, "out", config.COMPLEX, (h.nsta, B), h.device)
    _kernels.launch("ell_matvec", h.device, h.cols, h.vals, x, out, h.norb, D, h.nspin, B, ldx, ldy)
    return out


def matvec(h: SparseH, x):
    """Apply H to a block of vectors.

    :param x: complex (norb, B) for nspin=1 or (norb, 2, B) for nspin=2
      (B = block size; B=1 for a single vector), on ``h``'s device
    :returns: H @ x, same shape
    """
    if x.device.type == "cpu":
        return _matvec_plain(h, x)
    B = x.shape[-1]
    _kernels.require(x, "x", config.COMPLEX, ((h.norb, 2, B) if h.nspin == 2 else (h.norb, B)), h.device)
    out = torch.empty_like(x)
    apply_rows(h, x.view(h.nsta, B), out.view(h.nsta, B))
    return out


def gershgorin_window(h: SparseH):
    """Spectral window ``(lo, hi)`` containing all eigenvalues
    (Gershgorin discs, computed on host at build time)."""
    return h.window


def to_dense(h: SparseH) -> np.ndarray:
    """Host-side dense ``(nsta, nsta)`` complex128 matrix from the ELL
    tables.  An oracle for small systems: O(nsta^2) memory."""
    cols = h.cols.cpu().numpy()
    vals = h.vals.cpu().numpy()
    norb = h.norb
    rows = np.repeat(np.arange(norb), cols.shape[1])
    if h.nspin == 1:
        dense = np.zeros((norb, norb), dtype=np.complex128)
        np.add.at(dense, (rows, cols.ravel()), vals.reshape(-1))
        return dense
    dense = np.zeros((norb, norb, 2, 2), dtype=np.complex128)
    np.add.at(dense, (rows, cols.ravel()), vals.reshape(-1, 2, 2))
    return dense.transpose(0, 2, 1, 3).reshape(2 * norb, 2 * norb)
