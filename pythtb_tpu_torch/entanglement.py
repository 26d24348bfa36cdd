"""Single-particle entanglement spectra of free-fermion states
(counterpart of ``pythtb_tpu.entanglement``).

For a Slater-determinant ground state the reduced density matrix of a
spatial region A is thermal in the one-body correlation matrix
``C_ij = <c_i^dag c_j>`` restricted to A (Peschel, J. Phys. A 36, L205
(2003)): the many-body entanglement spectrum is generated by the
eigenvalues ``xi in [0, 1]`` of ``C_A`` (each many-body level a
product of xi / (1 - xi) factors -- verified against an exact
Fock-space partial trace in the tests), and the entanglement entropy
is ``S = -sum xi ln xi + (1 - xi) ln(1 - xi)``.

Topology reads off the spectrum (Fidkowski, PRL 104, 130502 (2010)):
a Chern insulator's virtual cut carries the same spectral flow as a
physical edge -- entanglement eigenvalues flow through 1/2 as the
transverse momentum winds -- while a trivial insulator keeps an
"entanglement gap" around 1/2.  Kramers degeneracy shows up at TRIM
for time-reversal-symmetric (spinful) models.

:func:`entanglement_flow` builds the cylinder as a glued ring
(``cut_piece(L, dir, glue_edgs=True)`` -- no physical edges, so the cut
is purely virtual), solves every transverse momentum in one batched
device pass (kernel 1, and kernel 7 for 33-64 states: the 20-cell
Haldane ring has 40), forms the region-A correlation blocks and
diagonalizes them with one batched ``torch.linalg.eigvalsh``.  The reference framework has no
entanglement machinery at all.
"""

from __future__ import annotations

import numpy as np
import torch

from . import config
from .model import PythtbError
from .ops.eigh import eigh_batched
from .ops.hamiltonian import assemble

__all__ = ["correlation_spectrum", "entanglement_flow", "entanglement_entropy"]


def entanglement_entropy(xi):
    """von Neumann entanglement entropy from correlation eigenvalues,
    summed over the trailing axis."""
    # clip bounds must exceed float64 eps: 1.0 - 1e-30 rounds back to
    # exactly 1.0 and log(1 - xi) still blows up
    xi = np.clip(np.asarray(xi, dtype=np.float64), 1e-15, 1.0 - 1e-15)
    return -np.sum(xi * np.log(xi) + (1.0 - xi) * np.log(1.0 - xi), axis=-1)


def correlation_spectrum(model, nocc, sites):
    """Entanglement (correlation-matrix) spectrum of a finite model's
    ground state for the cut defined by ``sites``.

    :param model: finite model (``dim_k == 0``)
    :param nocc: number of occupied (lowest) one-particle states
    :param sites: orbital indices forming region A (for spinful models
      both spin components of each listed orbital are included)
    :returns: xi ascending, shape (len(sites) * nspin,) -- all in
      [0, 1]; values pinned at 0/1 are states fully outside/inside A

    The many-body reduced density matrix spectrum is ``prod_i (xi_i or
    1 - xi_i)`` over all subsets (Peschel); complementary regions give
    mirrored nontrivial spectra (both verified in the tests).
    """
    if model._dim_k != 0:
        raise PythtbError("correlation_spectrum requires a finite model")
    nocc = int(nocc)
    if not (0 < nocc <= model._nsta):
        raise PythtbError("nocc must be in 1..nsta")
    sites = np.asarray(sites, dtype=np.int64).reshape(-1)
    if len(np.unique(sites)) != len(sites) or sites.min() < 0 or (
        sites.max() >= model._norb
    ):
        raise PythtbError("sites must be distinct orbital indices")
    ns = model._nspin
    comp = (sites[:, None] * ns + np.arange(ns)[None, :]).reshape(-1)
    data = model._get_finalized()
    H = assemble(data, torch.zeros((1, data.dim_k), dtype=config.FLOAT, device=data.device))
    _, vecs = eigh_batched(H)  # (1, S, S) rows are states
    ua = vecs[0, :nocc][:, torch.as_tensor(comp, device=data.device)]  # (nocc, nA)
    xi = torch.linalg.eigvalsh(ua.conj().T @ ua)
    return np.clip(np.asarray(xi.cpu().numpy(), np.float64), 0.0, 1.0)



def entanglement_flow(model, occ, cut_dir, L=16, LA=None, nk=51):
    """Entanglement spectrum flow of a 2-D insulator across a virtual
    cut of a cylinder.

    The cylinder is a glued ring of ``L`` cells along ``cut_dir``
    (periodic -- the cut is virtual, there are no physical edges); for
    each transverse momentum the lowest ``L * len(occ)`` states are
    occupied and the correlation matrix is restricted to the first
    ``LA`` cells.  One batched device pass for the whole flow.

    A Chern insulator shows gapless spectral flow through xi = 1/2
    (Fidkowski); a trivial one keeps an entanglement gap; a QSH
    insulator shows Kramers-paired flow.  Tested against those
    hallmarks and, via :func:`correlation_spectrum`, against an exact
    many-body partial trace on small systems.

    :param model: 2-D periodic model
    :param occ: occupied band indices of the 2-D bulk (an insulating
      filling -- the minimum gap at the ring filling is checked and a
      warning issued if it closes)
    :param cut_dir: periodic direction that is rolled into the ring
    :param L: ring circumference in cells; ``LA``: cells in region A
      (default L // 2)
    :param nk: transverse momenta (inclusive endpoint, for plotting a
      full period)
    :returns: ``(kpar, xi)`` with xi (nk, LA * norb * nspin) ascending
    """
    if model._dim_k != 2:
        raise PythtbError("entanglement_flow requires dim_k == 2")
    occ = tuple(int(o) for o in np.atleast_1d(occ))
    if len(set(occ)) != len(occ) or any(
        not (0 <= o < model._nsta) for o in occ
    ):
        raise PythtbError("occ must be distinct band indices")
    L = int(L)
    LA = L // 2 if LA is None else int(LA)
    if not (0 < LA < L):
        raise PythtbError("need 0 < LA < L")
    ring = model.cut_piece(L, cut_dir, glue_edgs=True)
    nocc = L * len(occ)
    nA = LA * model._norb * model._nspin
    kpar = np.linspace(0.0, 1.0, int(nk))
    data = ring._get_finalized()
    kpts = torch.as_tensor(kpar[:, None], dtype=config.FLOAT).to(data.device)
    evals, vecs = eigh_batched(assemble(data, kpts))  # (B, S, S) rows are states
    u = vecs[:, :nocc, :nA]  # region A = leading components
    xi = torch.linalg.eigvalsh(u.conj().transpose(-1, -2) @ u).cpu().numpy()
    mingap = (evals[:, nocc] - evals[:, nocc - 1]).amin().item()
    if float(mingap) < 1e-8:
        import warnings

        warnings.warn(
            "entanglement_flow: the ring spectrum has a (near-)zero gap "
            "at the chosen filling (min gap %.2e) -- the ground state "
            "is not an insulator there and the flow is ill-defined."
            % float(mingap),
            UserWarning, stacklevel=2,
        )
    return kpar, np.clip(np.asarray(xi, np.float64), 0.0, 1.0)
