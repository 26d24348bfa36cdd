"""Band unfolding: supercell spectra projected onto the primitive BZ
(counterpart of ``pythtb_tpu.unfold``).

Supercell calculations (disorder, defects, magnetic cells, CDWs) fold
the primitive band structure into a small BZ where it is unreadable.
Unfolding (Ku-Berlijn-Lee PRL 104, 216401 (2010); Popescu-Zunger PRB
85, 085201 (2012)) assigns every supercell eigenstate a spectral
weight at each primitive wavevector k,

``W_n(k) = sum_o |(1/sqrt(N)) sum_c psi^n_{(c,o)}|^2``

-- the norm of the state's projection onto the primitive-translation
Bloch symmetry k.  The reference framework has no unfolding.

The key step: in Convention I (phases carry the full orbital
position, core.py:16) the projection becomes TRIVIAL.  Writing the
primitive k in UNREDUCED supercell coordinates ``K = k @ M^T`` (M the
supercell matrix), the physical wavevectors coincide exactly, so the
Bloch phases of the eigenvector cancel against the projector's and the
weight is a plain per-primitive-orbital sum over cells.  All the
folding bookkeeping lives in using the unreduced K: primitive k-points
that fold to the same supercell BZ point differ by integer vectors G,
and Convention-I eigenvectors at K + G differ by the embedding phases
``exp(-2 pi i G . t_orb)`` -- precisely the factor that redistributes
weight between the unfolded images.  No phase table is ever built.

Orbital bookkeeping: models built by ``tb_model.make_supercell`` order
orbitals as (cell, primitive orbital) -- ``j = c * norb_prim + o`` --
which is the default assumption; in-place perturbations (disorder,
defects) preserve it.  For hand-built supercells pass ``orbital_map``.

One device pass per k-batch: assemble at K (kernel 1), batched eigh
(kernel 7 for 33-64 states, so the 5 x 5 graphene supercell's 50 bands),
and the per-primitive-orbital sums as one torch product.  Exactness oracle: a pristine supercell unfolds to the
primitive bands with unit weight and everything else at zero; the
completeness sum rule ``sum_n W_n(k) = norb_prim * nspin`` holds at
every k (discrete Parseval).
"""

from __future__ import annotations

import numpy as np
import torch

from . import config
from .model import PythtbError
from .ops.eigh import eigh_batched
from .ops.hamiltonian import assemble

__all__ = ["unfold_bands"]


def _unfold(data, ncells, norb_prim, kpts_sc, omap):
    """Energies (B, S) and unfolding weights (B, S) at supercell k-points."""
    evals, vecs = eigh_batched(assemble(data, kpts_sc))  # rows are states
    B, S, _ = vecs.shape
    comp = vecs.reshape(B, S, data.norb, data.nspin)  # orbital-major layout
    onehot = torch.nn.functional.one_hot(omap, norb_prim).to(config.COMPLEX)
    csum = torch.einsum("bsjt,jo->bsot", comp, onehot)
    return evals, (csum.abs() ** 2).sum(dim=(-1, -2)) / ncells


def unfold_bands(sc_model, sc_red_lat, k_list, orbital_map=None):
    """Unfold a supercell model's bands onto primitive-BZ k-points.

    :param sc_model: the supercell model (built by ``make_supercell``
      with matrix ``sc_red_lat``, possibly perturbed in place by
      disorder/defects afterwards)
    :param sc_red_lat: the integer supercell matrix M (rows = supercell
      vectors in primitive reduced coordinates) that built the model
    :param k_list: (nk, dim_k) PRIMITIVE reduced k-points
    :param orbital_map: optional (norb_sc,) int array giving each
      supercell orbital's primitive-orbital index; default assumes the
      ``make_supercell`` ordering ``j = cell * norb_prim + orb``
    :returns: ``(evals, weights)`` -- both (nk, nsta_sc); plot
      ``scatter(k, evals, c=weights)`` for the unfolded structure.
      ``sum_n weights[k, n] == norb_prim * nspin`` exactly.

    Example::

        sc = model.make_supercell(np.diag([4, 4]))
        # ... add disorder via sc.set_onsite(..., mode="add") ...
        evals, w = unfold_bands(sc, np.diag([4, 4]), k_path_pts)
    """
    M = np.asarray(sc_red_lat, dtype=np.int64)
    dim = sc_model._dim_k
    if M.shape != (sc_model._dim_r, sc_model._dim_r):
        raise PythtbError("sc_red_lat must be (dim_r, dim_r)")
    ncells = int(round(abs(np.linalg.det(M))))
    if ncells < 1:
        raise PythtbError("sc_red_lat is singular")
    if sc_model._norb % ncells != 0:
        raise PythtbError(
            "supercell orbital count %d is not det(M)=%d times a "
            "primitive count" % (sc_model._norb, ncells)
        )
    norb_prim = sc_model._norb // ncells
    if orbital_map is None:
        omap = np.tile(np.arange(norb_prim), ncells)
    else:
        omap = np.asarray(orbital_map, dtype=np.int64).reshape(-1)
        if omap.shape != (sc_model._norb,) or omap.min() < 0 or (
            omap.max() >= norb_prim
        ):
            raise PythtbError(
                "orbital_map must give a primitive index in [0, %d) per "
                "supercell orbital" % norb_prim
            )
    kpts = np.asarray(k_list, dtype=np.float64)
    if kpts.ndim == 1:
        kpts = kpts[:, None] if dim == 1 else kpts[None, :]
    if kpts.ndim != 2 or kpts.shape[1] != dim:
        raise PythtbError("k_list must be (nk, %d)" % dim)
    if dim != sc_model._dim_r:
        raise PythtbError("unfold_bands requires a fully periodic model")
    data = sc_model._get_finalized()
    # primitive k in UNREDUCED supercell coordinates (module docstring)
    kpts_sc = np.ascontiguousarray(kpts @ M.T.astype(np.float64))
    evals, w = _unfold(data, ncells, norb_prim,
                       torch.as_tensor(kpts_sc, dtype=config.FLOAT).to(data.device),
                       torch.as_tensor(omap, dtype=torch.int64).to(data.device))
    return (np.asarray(evals.cpu().numpy(), np.float64), np.asarray(w.cpu().numpy(), np.float64))
