"""Uniform magnetic fields via exact Peierls substitution (the host part
of ``pythtb_tpu.magnetic``).

Work in reduced coordinates ``(x1, x2)`` along the two chosen lattice
directions ``dirs = (d1, d2)``.  A uniform field with flux ``phi`` (in
units of the flux quantum) through the (d1, d2) unit-cell plaquette is
the 1-form ``A = 2*pi*phi * x1 dx2``.  The Peierls phase of a hopping
from a to b along the straight line is

    theta0 = 2*pi*phi * (a1 + b1)/2 * (b2 - a2).

For a model periodic along d1 the field needs rational flux p/q and a
q-fold cell along d1 (:func:`magnetic_supercell`); translating a hop by
one supercell vector shifts theta0 by ``2*pi*p * (t2_j - t2_i)``, which
the cell-dependent orbital gauge absorbs, so the supercell hop phases
are

    theta = theta0(representative with start in home supercell)
            - 2*pi*p * R1_sc * t2_j.

For a model finite along d1 (ribbons, flakes) no supercell is needed
and ``phi`` may be any real number (:func:`peierls_model`, Landau
gauge).

The supercell and Peierls constructions edit host hop tables in NumPy.
The device part: the Hofstadter butterfly (:func:`hofstadter_fn`,
:func:`hofstadter_butterfly`) assembles every flux of a sweep in one
launch of kernel 1's flux-batch mode (the hop phases are linear in the
flux index p, so all fluxes share the supercell's graph) and solves them
in one ``eigvalsh_batched`` (kernel 7 at 33-64 supercell states);
:func:`streda_labels` solves the supercell's grids once and takes every
open gap's Chern number from those states (kernels 3-4).
"""

from __future__ import annotations

import copy
import warnings

import numpy as np
import torch

from . import config
from .model import PythtbError

__all__ = ["magnetic_supercell", "peierls_model", "hofstadter_fn", "hofstadter_butterfly", "streda_labels"]


def _check_dirs(model, dirs):
    d1, d2 = (int(d) for d in dirs)
    if d1 == d2:
        raise PythtbError("Magnetic field plane needs two distinct directions")
    for d in (d1, d2):
        if d < 0 or d >= model._dim_r:
            raise PythtbError(
                "Magnetic field direction %d out of range for dim_r=%d" % (d, model._dim_r)
            )
    return d1, d2


def _hop_arrays(model):
    """Hop table of a builder model as dense arrays (R zero-filled when
    the model is fully finite and stores no R column)."""
    nhop = len(model._hoppings)
    ii = np.array([h[1] for h in model._hoppings], dtype=np.int64).reshape(nhop)
    jj = np.array([h[2] for h in model._hoppings], dtype=np.int64).reshape(nhop)
    if model._dim_k == 0 or nhop == 0:
        R = np.zeros((nhop, model._dim_r), dtype=np.float64)
    else:
        R = np.array([h[3] for h in model._hoppings], dtype=np.float64).reshape(nhop, model._dim_r)
    return ii, jj, R


def _phase_multiply(model, theta):
    """Multiply each stored hopping amplitude by exp(1j*theta) in place
    (spin blocks get a common phase), then drop the finalized tensors."""
    for n, h in enumerate(model._hoppings):
        h[0] = np.asarray(h[0], dtype=complex) * np.exp(1.0j * theta[n])
    model._invalidate()


def _sc_exponents(sc, q, d1, d2):
    """Per-hopping exponent slope for a q-fold magnetic supercell: the
    hop phase at flux index p is exp(1j * p * slope).  Coordinates of
    the supercell model are converted back to original-cell units
    (x1_orig = q * x1_sc along d1; d2 is unchanged)."""
    ii, jj, R = _hop_arrays(sc)
    orb = sc._orb
    a1 = q * orb[ii, d1]
    a2 = orb[ii, d2]
    b1 = q * (orb[jj, d1] + R[:, d1])
    b2 = orb[jj, d2] + R[:, d2]
    base = 0.5 * (a1 + b1) * (b2 - a2)  # integral of x1 dx2, original units
    corr = R[:, d1] * orb[jj, d2]  # magnetic-translation gauge correction
    return 2.0 * np.pi * (base / q - corr)


def _magnetic_sc_base(model, q, dirs, to_home=True):
    """(supercell model at zero field, per-hop exponent slopes)."""
    d1, d2 = _check_dirs(model, dirs)
    if d1 not in model._per:
        raise PythtbError(
            "magnetic_supercell enlarges the cell along dirs[0], which must "
            "be a periodic direction; for a finite dirs[0] use peierls_model"
        )
    q = int(q)
    if q < 1:
        raise PythtbError("Magnetic supercell size q must be a positive integer")
    sc_red_lat = np.identity(model._dim_r, dtype=int)
    sc_red_lat[d1, d1] = q
    sc = model.make_supercell(sc_red_lat, to_home=to_home, to_home_suppress_warning=True)
    return sc, _sc_exponents(sc, q, d1, d2)


def magnetic_supercell(model, p, q, dirs=(0, 1), to_home=True):
    """Uniform magnetic field with rational flux ``p/q`` per unit-cell
    plaquette spanned by lattice directions ``dirs``, as a NEW model on
    a q-fold enlarged cell along ``dirs[0]``.

    :param p, q: integers; flux per original (dirs) plaquette is p/q
      flux quanta (p need not be coprime with q, may be negative)
    :param dirs: the two lattice directions spanning the field plane;
      ``dirs[0]`` must be periodic (it is enlarged q-fold)
    :param to_home: passed through to :meth:`tb_model.make_supercell`
    :returns: a NEW tb_model with ``q * norb`` orbitals
    """
    if not (float(p).is_integer() and float(q).is_integer()):
        raise PythtbError("Flux must be rational: p and q must be integers")
    sc, slope = _magnetic_sc_base(model, q, dirs, to_home=to_home)
    _phase_multiply(sc, int(p) * slope)
    return sc


def peierls_model(model, phi, dirs=(0, 1)):
    """Uniform magnetic field on a model that is FINITE along
    ``dirs[0]`` (a ribbon or flake): multiply every hopping by its
    exact Peierls phase in the Landau gauge ``A = 2*pi*phi*x1 dx2``.

    The gauge varies only along the non-periodic direction, so no
    supercell is needed and ``phi`` -- the flux in quanta per (dirs)
    unit reduced plaquette -- may be any real number.  Models produced
    by ``cut_piece`` keep the original lattice vectors, so ``phi`` is
    still per original-cell plaquette there.

    :returns: a NEW tb_model with phased hoppings
    """
    d1, d2 = _check_dirs(model, dirs)
    if d1 in model._per:
        raise PythtbError(
            "peierls_model requires dirs[0] to be non-periodic (finite); "
            "for a periodic dirs[0] use magnetic_supercell(p, q)"
        )
    out = copy.deepcopy(model)
    ii, jj, R = _hop_arrays(out)
    if len(out._hoppings):
        orb = out._orb
        a1 = orb[ii, d1]  # R[:, d1] == 0 along a finite direction
        a2 = orb[ii, d2]
        b1 = orb[jj, d1]
        b2 = orb[jj, d2] + R[:, d2]
        theta = 2.0 * np.pi * float(phi) * 0.5 * (a1 + b1) * (b2 - a2)
        _phase_multiply(out, theta)
    return out


def hofstadter_fn(model, q, dirs=(0, 1)):
    """The Hofstadter solver at denominator ``q``.

    Returns ``(fn, sc)``: ``sc`` is the q-fold zero-field supercell and
    ``fn(p_values, k_list)`` maps flux indices ``p_values`` (P,) (any real
    p; flux p/q) and reduced k-points of the supercell BZ (NK, dim_k) to
    the eigenvalues, a (P, NK, nsta_sc) float64 tensor on the model's
    device.  Every flux and k-point is assembled in one launch of kernel
    1's flux-batch mode -- member p's amplitudes are amps0 e^{i p slope}
    -- and solved in one ``eigvalsh_batched``.  (The JAX package's
    ``mesh`` sharding of the flux axis is not ported.)
    """
    from .ops.eigh import eigvalsh_batched
    from .ops.hamiltonian import assemble_members

    sc, slope = _magnetic_sc_base(model, q, dirs)
    data = sc._get_finalized()
    slope_t = torch.as_tensor(slope, dtype=config.FLOAT).to(data.device)

    def fn(p_values, k_list):
        p = torch.as_tensor(np.asarray(p_values, dtype=np.float64).reshape(-1)).to(data.device)
        kpts = np.ascontiguousarray(np.asarray(k_list, dtype=np.float64).reshape(-1, data.dim_k))
        kpts = torch.as_tensor(kpts).to(data.device)
        evals = eigvalsh_batched(assemble_members(data, *_flux_members(data, slope_t, p), kpts))
        return evals.reshape(p.shape[0], kpts.shape[0], data.nsta)

    return fn, sc


def _flux_members(data, slope, p):
    """Kernel 1's flux-batch members of a zero-field supercell: member i
    has the amplitudes amps0 e^{i p_i slope} (P, nhop[, 2, 2]) and the
    supercell's on-site matrix (P, nsta, nsta)."""
    ph = torch.polar(torch.ones_like(p[:, None] * slope), p[:, None] * slope)  # (P, nhop)
    amps = (ph.reshape(ph.shape + (1,) * (data.amps.dim() - 1)) * data.amps[None]).contiguous()
    return amps, data.diag.expand((p.shape[0],) + tuple(data.diag.shape)).contiguous()


def hofstadter_butterfly(model, q, dirs=(0, 1), nk=4, p_values=None):
    """The Hofstadter butterfly of ``model``: every flux phi = p/q for p =
    0..q (or the given ``p_values``) on a uniform ``nk x .. x nk`` mesh of
    the magnetic supercell's BZ, through :func:`hofstadter_fn` (one
    assembly launch, one eigensolve).

    :returns: ``(phis, evals)``, evals (P, NK, q * nsta) NumPy float64
    """
    fn, sc = hofstadter_fn(model, q, dirs)
    if p_values is None:
        p_values = np.arange(0, int(q) + 1)
    p_values = np.asarray(p_values, dtype=np.float64)
    shape = (int(nk),) * sc._dim_k
    if sc._dim_k == 0:
        kpts = np.zeros((1, 0))
    else:
        grids = np.meshgrid(*[np.arange(n) / n for n in shape], indexing="ij")
        kpts = np.stack([g.ravel() for g in grids], axis=-1)
    evals = fn(p_values, kpts).cpu().numpy().astype(np.float64)
    return p_values / float(q), evals


def streda_labels(model, p, q, nk=31, dirs=(0, 1), gap_tol=None):
    """Chern labels of the Hofstadter gaps at flux ``p/q`` (the Streda
    quantum numbers t_r = dN_r/dphi that colour the butterfly).

    Builds the magnetic supercell (:func:`magnetic_supercell`) and solves,
    in one assembly and one eigensolve, both grids the JAX package uses:
    the ``nk x nk`` gap-scan mesh from the origin and the Chern grid of
    ``flows.chern_number(nk=(nk, nk))`` ((nk - 1)^2 points from (-1/2,
    -1/2), closed with the periodic gauge).  For every OPEN gap r of the
    scan, the Chern number of the bands below it is the plaquette flux of
    those same Chern-grid states (link determinants, kernel 3, up to 64
    bands on the card; plaquette sums, kernel 4): no per-gap re-solve,
    where the JAX package solves the Chern grid again for each gap.

    :param p, q: integer flux ``p/q`` per ``dirs`` plaquette
    :param nk: mesh per direction (supercell BZ)
    :param dirs: the two periodic directions threaded by the flux
    :param gap_tol: minimum indirect gap treated as open (default
      ``1e-6 * bandwidth``)
    :returns: dict with ``gaps`` (list of (bottom, top) energies of each
      open gap), ``labels`` (int Chern label below each gap), ``filling``
      (bands below each gap), ``phi`` = p/q
    """
    from .flows import _phase_tensor
    from .ops.berry import _plane_link_dets, plaquette_flux
    from .ops.eigh import eigh_batched
    from .ops.hamiltonian import assemble
    from .ops.solver import device_uniform_grid, extend_pbc_seq

    sc = magnetic_supercell(model, p, q, dirs=dirs)
    data = sc._get_finalized()
    if data.dim_k != 2:
        raise PythtbError("streda_labels requires a model with two periodic directions")
    nk = int(nk)
    scan = device_uniform_grid((nk, nk), (0.0, 0.0), data.device)
    chern = device_uniform_grid((nk - 1, nk - 1), (-0.5, -0.5), data.device)
    evals, v = eigh_batched(assemble(data, torch.cat([scan, chern])))
    ev = evals[: nk * nk].cpu().numpy().T  # (nsta_sc, nk^2), as solve_all
    w = extend_pbc_seq(v[nk * nk :].reshape(nk - 1, nk - 1, data.nsta, data.nsta),
                       [_phase_tensor(sc, d, data.device) for d in (0, 1)])  # (nk, nk, nsta, F)
    bmax = ev.max(axis=1)
    bmin = ev.min(axis=1)
    if gap_tol is None:
        gap_tol = 1e-6 * float(ev.max() - ev.min())
    gaps, labels, filling = [], [], []
    for r in range(ev.shape[0] - 1):
        lo, hi = float(bmax[r]), float(bmin[r + 1])
        if hi - lo <= gap_tol:
            continue
        c = float(plaquette_flux(*_plane_link_dets(w[:, :, : r + 1].contiguous()))[0]) / (2.0 * np.pi)
        ci = int(round(c))
        if abs(c - ci) > 0.05:
            warnings.warn(
                "streda_labels: non-integer Chern %.3f below the gap "
                "at filling %d (raise nk)" % (c, r + 1), stacklevel=2)
        gaps.append((lo, hi))
        labels.append(ci)
        filling.append(r + 1)
    return {"phi": float(p) / float(q), "gaps": gaps, "labels": labels, "filling": filling}
