"""Analytic continuation of Matsubara data to the real axis (counterpart
of ``pythtb_tpu.continuation``, a host NumPy copy: the Thiele recursion
runs in ``numpy.clongdouble``, a precision torch lacks, so it stays on
the host as it does in the JAX package).

The package's ED-DMFT stack never *needs* numerical continuation --
the converged AIM is a finite pole model whose real-axis ``Sigma(w)``
and ``A(w)`` are closed-form rationals (``dmft.DMFTResult.sigma_real``
/ ``local_spectral`` / ``dmft.band_spectral``).  That exactness is
what makes this module testable: the Thiele/Pade continuation here is
pinned against those exact real-axis results (a within-package
differential oracle no continuation code usually has), against exact
finite-pole rationals (recovered to ~1e-12), and against ED Lehmann
spectra of small interacting clusters.

Use it for data the exact route cannot reach: externally produced
G(iw_n) / Sigma(iw_n) (QMC, other codes), or package objects whose
real-axis form you deliberately do not want to re-derive.

Method: Vidberg-Serene Thiele continued-fraction interpolation
[J. Low Temp. Phys. 29, 179 (1977)] -- the N-point Pade approximant

    C_N(z) = a_1 / (1 + a_2 (z - z_1) / (1 + a_3 (z - z_2) / ...))

through all input points, with the recursion and evaluation carried in
extended precision (``numpy.clongdouble``, 80-bit on this platform,
eps ~ 1e-19): float64 divided differences visibly corrupt the
continuation beyond ~40 points.  The forward A/B evaluation is
renormalized every step so the partial numerators cannot overflow.

Honest numerics notes (also enforced by the diagnostics):

* Pade continuation is exponentially ill-conditioned in the noise of
  the input -- it is quantitatively reliable for CLEAN data (machine-
  precision Matsubara values, e.g. from ED/Lehmann sums).  For noisy
  QMC data the diagnostics will show it: large ``residual`` or a
  negative-spectral-weight ``causality_violation``.
* Degenerate divided differences (exactly rational inputs of lower
  order than the point count) terminate the recursion early; the
  returned approximant is then the exact lower-order rational.

Reference: PythTB 1.8.0 is a single-particle code with no Matsubara axis at all; this module belongs to
the beyond-reference interacting stack (ed/dmft/meanfield).
"""

from __future__ import annotations

import numpy as np

from .model import PythtbError

__all__ = ["pade", "pade_spectral"]


def _thiele_coeffs(z, u):
    """Thiele reciprocal-difference coefficients a_p (clongdouble).

    g_0(z_i) = u_i;  g_p(z_i) = (g_{p-1}(z_{p-1}) - g_{p-1}(z_i))
                                / ((z_i - z_{p-1}) g_{p-1}(z_i));
    a_p = g_p(z_p).  Returns (a, order) where ``order <= N`` is the
    number of usable coefficients (the recursion stops early when a
    divided difference degenerates -- exact lower-order rationals)."""
    n = len(z)
    g = np.array(u, dtype=np.clongdouble)
    zl = np.array(z, dtype=np.clongdouble)
    a = np.zeros(n, dtype=np.clongdouble)
    a[0] = g[0]
    order = n
    for p in range(1, n):
        prev = g[p - 1]
        den = (zl[p:] - zl[p - 1]) * g[p:]
        with np.errstate(divide="ignore", invalid="ignore"):
            gnew = (prev - g[p:]) / den
        if (not np.all(np.isfinite(gnew.astype(complex)))
                or abs(complex(gnew[0])) == 0.0):
            order = p
            break
        g = np.concatenate([g[:p], gnew])
        a[p] = g[p]
    return a[:order], order


def _thiele_eval(a, z_nodes, z):
    """Evaluate the continued fraction at points ``z`` by the forward
    A/B recurrence, renormalizing each step (clongdouble)."""
    z = np.asarray(z, dtype=np.clongdouble)
    am = np.zeros_like(z)            # A_{-1}
    a0 = np.full_like(z, a[0])       # A_0
    bm = np.ones_like(z)             # B_{-1}
    b0 = np.ones_like(z)             # B_0
    for p in range(1, len(a)):
        w = (z - z_nodes[p - 1]) * a[p]
        a1 = a0 + w * am
        b1 = b0 + w * bm
        am, a0 = a0, a1
        bm, b0 = b0, b1
        scale = np.abs(b0)
        scale[scale == 0.0] = 1.0
        am /= scale
        a0 /= scale
        bm /= scale
        b0 /= scale
    with np.errstate(divide="ignore", invalid="ignore"):
        out = a0 / b0
    return out.astype(complex)


def pade(wn, gw, omegas, eta=0.01, n_points=None, diagnostics=False):
    """Continue Matsubara data ``g(i w_n)`` to ``g(w + i eta)``.

    :param wn: (n,) positive fermionic Matsubara frequencies (as from
      :func:`pythtb_tpu_torch.dmft.matsubara`)
    :param gw: (n,) complex values on the Matsubara axis
    :param omegas: real frequencies to evaluate at
    :param eta: distance above the real axis (0 allowed: the
      approximant is rational, so the boundary value exists -- but a
      small eta smooths between the approximant's discrete poles)
    :param n_points: use only the first ``n_points`` Matsubara points
      (default: all).  Fewer points = smoother, more robust to noise;
      more points = sharper structure from clean data.
    :param diagnostics: also return a dict with ``residual`` (max
      mismatch re-evaluating at the INPUT points -- interpolation
      should make this ~0; larger values mean a degenerate/truncated
      fraction), ``order`` (coefficients actually used) and
      ``causality_violation`` (max positive Im g(w + i eta); a
      retarded Green's function must keep Im g <= 0 -- a large value
      flags an untrustworthy continuation, e.g. noisy input)
    :returns: complex array ``g(omegas + i eta)`` (with
      ``diagnostics``: ``(g, info)``)
    """
    wn = np.asarray(wn, dtype=np.float64)
    gw = np.asarray(gw, dtype=complex)
    if wn.ndim != 1 or gw.shape != wn.shape:
        raise PythtbError("pade: wn and gw must be matching 1-D arrays")
    if len(wn) < 2:
        raise PythtbError("pade: need at least two Matsubara points")
    if np.any(wn <= 0):
        raise PythtbError(
            "pade: wn must be the POSITIVE Matsubara frequencies "
            "(use dmft.matsubara); the lower half plane follows from "
            "g(-iw) = g(iw)*")
    if n_points is not None:
        n_points = int(n_points)
        if not 2 <= n_points <= len(wn):
            raise PythtbError("pade: n_points out of range")
        wn, gw = wn[:n_points], gw[:n_points]
    z_nodes = np.asarray(1j * wn, dtype=np.clongdouble)
    a, order = _thiele_coeffs(z_nodes, gw)
    omegas = np.asarray(omegas, dtype=float)
    zq = omegas.astype(np.clongdouble) + np.clongdouble(1j) * np.clongdouble(eta)
    out = _thiele_eval(a, z_nodes, zq)
    if not diagnostics:
        return out
    back = _thiele_eval(a, z_nodes, z_nodes)
    residual = float(np.max(np.abs(back - gw)))
    viol = float(max(0.0, np.max(np.imag(out)))) if len(out) else 0.0
    return out, {"residual": residual, "order": int(order),
                 "causality_violation": viol}


def pade_spectral(wn, gw, omegas, eta=0.01, n_points=None):
    """Spectral function ``A(w) = -(1/pi) Im g(w + i eta)`` from the
    Pade continuation of Matsubara data (see :func:`pade`)."""
    g = pade(wn, gw, omegas, eta=eta, n_points=n_points)
    return -np.imag(g) / np.pi
