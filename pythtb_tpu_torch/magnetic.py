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

Everything here edits host hop tables in NumPy.  The Hofstadter
butterfly (``hofstadter_fn``, ``hofstadter_butterfly``) and
``streda_labels`` of the JAX package are not ported yet.
"""

from __future__ import annotations

import copy

import numpy as np

from .model import PythtbError

__all__ = ["magnetic_supercell", "peierls_model"]


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
