"""Fermi-sweep band sums (kernel 17) and the dilogarithm.

    out[m, p] = sum_t G[p, t] w_kind((E_t - mu_m) / kT) (E_t - mu_m)^j_p

The chemical-potential (or Fermi-level, or energy) sweeps of the response
family all reduce to this: the anomalous Hall, Nernst and thermal Hall
sweeps and the Berry dipole in :mod:`pythtb_tpu_torch.flows`, the
Boltzmann coefficients, the transport distribution and the Edelstein
tensor in :mod:`pythtb_tpu_torch.boltzmann`, and the Drude weight in
:mod:`pythtb_tpu_torch.geometry`.  Each caller lays its per-(k, band)
factors out as the columns of G over t = (k, band) and picks a weight:

* ``"step"``: 1 where E - mu <= 0 (E == mu counts as occupied), T = 0;
* ``"fermi"``: f(x) = 1 / (1 + e^x);
* ``"entropy"``: x f(x) + ln(1 + e^-x);
* ``"c2"``: the thermal-transport weight :func:`c2_weight`;
* ``"dfde"``: -df/de = e^-|x| / ((1 + e^-|x|)^2 kT), the stable form of
  ``boltzmann._bt_jit``'s f (1 - f) / kT, which loses e^|x| eps to the
  cancellation in 1 - f outside the bands;
* ``"dfde_cosh"``: -df/de as 0.25 / (kT cosh^2(x / 2)), clipped
  (``flows._dipole_jit``);
* ``"gauss"``: exp(-x^2 / 2) / (kT sqrt(2 pi)), kT the width.

On a CUDA tensor :func:`fermi_sweep` launches kernel 17
(``csrc/fermi_sweep.cu``: chunks of t over the card, each block sweeping
every mu of its chunk, then the chunks added in order), which uses the
stable form for both -df/de weights; on a CPU tensor it runs
:func:`_fermi_sweep_plain` over bounded chunks of mu, with the same
``"dfde"`` form and the dipole's own clipped cosh form.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import config
from . import _kernels

__all__ = ["fermi_sweep", "spence", "c2_weight", "KINDS"]

# weight kind -> kernel 17's code (both -df/de forms share code 4)
KINDS = {"step": 0, "fermi": 1, "entropy": 2, "c2": 3, "dfde": 4, "dfde_cosh": 4, "gauss": 5}

# Cephes spence.c polynomials (those of jax.scipy.special.spence)
_SPENCE_A = (4.65128586073990045278E-5, 7.31589045238094711071E-3, 1.33847639578309018650E-1,
             8.79691311754530315341E-1, 2.71149851196553469920E0, 4.25697156008121755724E0,
             3.29771340985225106936E0, 1.00000000000000000126E0)
_SPENCE_B = (6.90990488912553276999E-4, 2.54043763932544379113E-2, 2.82974860602568089943E-1,
             1.41172597751831069617E0, 3.63800533345137075418E0, 5.03278880143316990390E0,
             3.54771340985225096217E0, 9.99999999999999998740E-1)

# most mu values one plain chunk broadcasts against T
_PLAIN_ELEMS = 1 << 24

# kernel 17's launch layout (csrc/fermi_sweep.cu): t staged in tiles of
# _SWEEP_TILE, at most _SWEEP_MAX_MU chemical potentials (a thread each)
# and _SWEEP_MAX_COLS slots a block, runs of _SWEEP_RUN slots of one power,
# and chunks of t enough for about _SWEEP_BLOCKS_PER_SM blocks an SM
_SWEEP_TILE = 128
_SWEEP_MAX_MU = 256
_SWEEP_MAX_COLS = 16
_SWEEP_RUN = 4
_SWEEP_BLOCKS_PER_SM = 4


def _polyval(c, x):
    r = torch.full_like(x, c[0])
    for ci in c[1:]:
        r = r * x + ci
    return r


def spence(x):
    """scipy's ``spence(x) = int_1^x ln t / (1 - t) dt`` for float64
    x >= 0 (NaN below), the Cephes series of scipy and JAX; the
    dilogarithm is Li2(w) = spence(1 - w)."""
    inv = x > 2.0
    x = torch.where(inv, 1.0 / x, x)
    high = x > 1.5
    low = x < 0.5
    flag2 = inv | high
    w = torch.where(high, 1.0 / x - 1.0, torch.where(low, -x, x - 1.0))
    y = -w * _polyval(_SPENCE_A, w) / _polyval(_SPENCE_B, w)
    y = torch.where(low, math.pi**2 / 6.0 - torch.log(x) * torch.log1p(-x) - y, y)
    y = torch.where(flag2, -0.5 * torch.log(x) ** 2 - y, y)
    y = torch.where(x == 1.0, torch.zeros_like(y), y)
    y = torch.where(x == 0.0, torch.full_like(y, math.pi**2 / 6.0), y)
    return torch.where(x < 0.0, torch.full_like(y, math.nan), y)


def _softplus(x):
    """ln(1 + e^x), exact at every x (torch's softplus is linear past a
    threshold)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def c2_weight(x):
    """Thermal-transport weight W(x) = int_x^inf y^2 (-df/dy) dy =
    x^2 f(x) + 2 x ln(1 + e^-x) - 2 Li2(-e^-x), evaluated at |x| (every
    term bounded by pi^2/6) and reflected, W(-x) = pi^2/3 - W(x); the clip
    at 30 keeps e^-x finite (``pythtb_tpu.flows._c2_weight``)."""
    xa = x.abs()
    w = (xa**2 * torch.sigmoid(-xa) + 2.0 * xa * _softplus(-xa)
         - 2.0 * spence(1.0 + torch.exp(-xa.clamp(0.0, 30.0))))
    return torch.where(x < 0.0, math.pi**2 / 3.0 - w, w)


def _weight(kind, d, kt):
    if kind == "step":
        return (d <= 0.0).to(d.dtype)
    x = d / kt
    if kind == "fermi":
        return torch.sigmoid(-x)
    if kind == "entropy":
        return x * torch.sigmoid(-x) + _softplus(-x)
    if kind == "c2":
        return c2_weight(x)
    if kind == "dfde":
        e = torch.exp(-x.abs())
        return e / ((1.0 + e) ** 2 * kt)
    if kind == "dfde_cosh":
        return 0.25 / kt / torch.cosh(torch.clamp(x / 2.0, -40.0, 40.0)) ** 2
    return torch.exp(-0.5 * x * x) / (kt * math.sqrt(2.0 * math.pi))


def _fermi_sweep_plain(E, G, mus, kt, kind, jpow):
    """Plain PyTorch sweep: for a chunk of mu values the (chunk, T)
    weights, times (E - mu)^j, contracted with G.  The oracle of kernel
    17."""
    T = E.shape[0]
    P = G.shape[0]
    out = torch.zeros((mus.shape[0], P), dtype=config.FLOAT, device=E.device)
    step = max(1, _PLAIN_ELEMS // max(T, 1))
    for m0 in range(0, mus.shape[0], step):
        d = E[None, :] - mus[m0 : m0 + step, None]
        w = _weight(kind, d, kt)
        for j in sorted(set(jpow)):
            cols = [p for p in range(P) if jpow[p] == j]
            out[m0 : m0 + step, cols] = (w * d**j) @ G[cols].T
    return out


def _sweep_layout(T, M, jpow, sms):
    """Kernel 17's launch layout for T terms, M chemical potentials and
    the columns' powers ``jpow`` on a card of ``sms`` SMs: ``(slots, rpow,
    cols, threads, chunk)``.  ``slots`` lists G's rows sorted by power,
    each power's run padded with -1 (a row of zeros) to a multiple of
    ``_SWEEP_RUN`` and the whole to a multiple of ``cols`` (4, 8 or 16, the
    slots a block); ``rpow`` gives each run's power; ``threads`` is the
    chemical potentials a block takes (a multiple of 32); ``chunk`` the
    terms (a multiple of ``_SWEEP_TILE``), so that the blocks number about
    ``_SWEEP_BLOCKS_PER_SM`` an SM."""
    slots, rpow = [], []
    for j in (0, 1, 2):
        run = [p for p, jp in enumerate(jpow) if jp == j]
        run += [-1] * (-len(run) % _SWEEP_RUN)
        slots += run
        rpow += [j] * (len(run) // _SWEEP_RUN)
    cols = next((c for c in (4, 8) if len(slots) <= c), _SWEEP_MAX_COLS)
    pad = -len(slots) % cols
    slots += [-1] * pad
    rpow += [0] * (pad // _SWEEP_RUN)
    threads = 32 * -(-min(M, _SWEEP_MAX_MU) // 32)
    blocks = len(slots) // cols * -(-M // threads)
    chunks = max(1, -(-_SWEEP_BLOCKS_PER_SM * sms // blocks))
    chunk = max(1, -(-T // (chunks * _SWEEP_TILE))) * _SWEEP_TILE
    return slots, rpow, cols, threads, chunk


def fermi_sweep(E, G, mus, kt, kind, jpow=None):
    """out (M, P) = sum_t G[p, t] w_kind((E_t - mu_m) / kt) (E_t - mu_m)^jpow[p].

    :param E: (T,) float64 band energies, flattened over (k, band)
    :param G: (P, T) float64 per-(k, band) factors
    :param mus: (M,) float64 chemical potentials (or energies)
    :param kt: k_B T (the width for ``"gauss"``); ignored by ``"step"``
    :param kind: a key of :data:`KINDS`
    :param jpow: P powers in {0, 1, 2} (default all 0)
    """
    if kind not in KINDS:
        raise ValueError("unknown weight kind %r" % kind)
    P, T = G.shape
    jpow = [0] * P if jpow is None else [int(j) for j in jpow]
    if len(jpow) != P or not set(jpow) <= {0, 1, 2}:
        raise ValueError("jpow must give a power in {0, 1, 2} for each of the %d columns" % P)
    kt = float(kt)
    if E.device.type == "cpu":
        return _fermi_sweep_plain(E, G, mus, kt, kind, jpow)
    dev = E.device
    M = mus.shape[0]
    _kernels.require(E, "E", config.FLOAT, (T,), dev)
    _kernels.require(G, "G", config.FLOAT, (P, T), dev)
    _kernels.require(mus, "mus", config.FLOAT, (M,), dev)
    if kind != "step" and not kt > 0.0:
        raise ValueError("weight %r needs kt > 0, got %g" % (kind, kt))
    slots, rpow, cols, threads, chunk = _sweep_layout(T, M, jpow, _kernels.card(dev)[0])
    lay = torch.as_tensor(np.asarray(slots + rpow, dtype=np.int32)).to(dev)
    part = torch.empty((-(-T // chunk) * M * len(slots),), dtype=config.FLOAT, device=dev)
    out = torch.empty((M, P), dtype=config.FLOAT, device=dev)
    # the chunks' sums (none at T 0), then their reduction
    launches = (2 if T else 1) if M and P else 0
    _kernels.launch("fermi_sweep", dev, E, G, lay, lay[len(slots):], mus, part, out, T, P, M, len(slots), chunk, cols,
                    threads, kt, KINDS[kind], count=launches)
    return out
