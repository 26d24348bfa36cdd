"""Coherent quantum transport: Landauer conductance by NEGF (counterpart
of ``pythtb_tpu.negf``).

    T(E) = Tr[ Gamma_L G_D Gamma_R G_D^dag ],
    G_D = [(E + i eta) - H_D - Sigma_L - Sigma_R]^{-1},
    Sigma_L = V^dag g_L V,   Sigma_R = V g_R V^dag,
    Gamma = i (Sigma - Sigma^dag),

with ``g_L/R`` the left/right lead surface Green's functions.  Leads are
any 1-D periodic model (typically ``ribbon = model2d.cut_piece(W, 1)``):
the principal-layer blocks H00/H01 come from
:func:`pythtb_tpu_torch.surface._layer_blocks`, H00 assembled by kernel
1 and H01 by its one-sided mode at k = 0 (:func:`lead_blocks`).

On the device:

* the lead decimation is kernel 12's Green's-function mode
  (:func:`pythtb_tpu_torch.surface.decimate` with ``green=True``), the
  whole energy batch of both orientations of a lead in one launch (the
  orientation on kernel 12's K axis: H01^dag for the left lead, H01 for
  the right one); each lead of :func:`multi_terminal` gets its own
  launch, since leads may differ in size;
* the self-energies, the recursive Green's-function sweep over the
  device layers (a host loop over layers of batched
  ``torch.linalg.solve`` and ``torch.matmul``, only G_N1 formed), the
  dense device solve of :func:`multi_terminal` and the Caroli traces are
  torch library calls.

:func:`mode_count`, :func:`buttiker`, :func:`hall_bar` and the Landauer
integrals of :func:`thermoelectrics` are host NumPy, as in the JAX
package; ``hall_bar``'s device disorder draws from
``np.random.default_rng(seed)`` exactly as the JAX package does.

Oracle: a PRISTINE wire's transmission is the number of propagating
modes at E (an integer staircase counted independently from the lead
dispersion by :func:`mode_count`); disorder can only reduce it.
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import torch

from . import config
from .model import PythtbError
from .ops.hamiltonian import assemble, assemble_one_sided
from .surface import _layer_blocks, _residual, decimate

__all__ = ["landauer_transmission", "thermoelectrics", "lead_blocks",
           "mode_count", "multi_terminal", "buttiker", "hall_bar"]

# largest residual coupling a converged lead decimation leaves: sqrt(eps)
_RES_TOL = math.sqrt(float(np.finfo(np.float64).eps))


def _lead_tensors(data00, data01):
    """(H00, H01) (S, S) device tensors of a dim_k == 0 principal-layer
    pair of tables: kernel 1 and its one-sided mode at k = 0."""
    k0 = torch.zeros((1, 0), dtype=config.FLOAT, device=data00.device)
    return assemble(data00, k0)[0], assemble_one_sided(data01, k0)[0]


def lead_blocks(lead_model):
    """Principal-layer blocks of a 1-D lead: ``(H00, H01)`` dense
    complex matrices (H00 Hermitian intra-layer, H01 the one-sided
    coupling INTO the next layer along the wire).  Multi-cell hopping
    ranges are folded by the same supercell construction as
    :mod:`pythtb_tpu_torch.surface`."""
    if lead_model._dim_k != 1:
        raise PythtbError(
            "lead_blocks needs a 1-D periodic lead (cut_piece a ribbon "
            "from a higher-dimensional model first)"
        )
    d00, d01, _m = _layer_blocks(lead_model, int(lead_model._per[0]))
    H00, H01 = _lead_tensors(d00, d01)
    return H00.cpu().numpy().astype(np.complex128), H01.cpu().numpy().astype(np.complex128)


def _sancho_scan(H00, a0, w, iters):
    """Sancho-Rubio decimation of (K, S, S) layer blocks with couplings a0
    at every energy of w (nE,) complex: kernel 12's Green's-function mode.
    Returns the surface Green's functions (nE, K, S, S) and the residual
    (the final effective coupling over the bare scale; inf where the
    recursion overflowed, as :func:`surface._residual` rules)."""
    G, afin, peak = decimate(H00.contiguous(), a0.contiguous(), w, iters, green=True)
    return G, _residual(a0, afin, peak)


def _transmission(H00, H01, Hd, energies, eta, iters):
    """T(E) (nE,) and the decimation residual for device tensors H00, H01
    (S, S) and the device layers Hd (nlay, S, S): both lead orientations
    decimated in one launch, then the left-connected recursive Green's
    function sweep along the device chain (the last layer absorbs
    Sigma_R; P_l = G_{l,1}, so T = Tr[Gamma_R G_N1 Gamma_L G_N1^dag])."""
    dev = H00.device
    S = H00.shape[-1]
    nlay = Hd.shape[0]
    w = torch.as_tensor(np.asarray(energies, dtype=np.float64) + 1j * float(eta),
                        dtype=config.COMPLEX).to(dev)
    eye = torch.eye(S, dtype=config.COMPLEX, device=dev)
    wI = w[:, None, None] * eye  # (E, S, S)
    H01d = H01.conj().T
    G2, res = _sancho_scan(torch.stack([H00, H00]), torch.stack([H01d, H01]), w, iters)
    gL, gR = G2[:, 0], G2[:, 1]
    SigL = H01d @ (gL @ H01)
    SigR = H01 @ (gR @ H01d)
    GamL = 1j * (SigL - SigL.conj().transpose(-1, -2))
    GamR = 1j * (SigR - SigR.conj().transpose(-1, -2))

    def solve(A):
        return torch.linalg.solve(A, eye.expand_as(A))

    g1 = solve(wI - Hd[0] - SigL - (SigR if nlay == 1 else 0.0))
    if nlay == 1:
        GN1 = g1
    else:
        gprev, P = g1, g1
        for l in range(1, nlay - 1):
            g = solve(wI - Hd[l] - H01d @ (gprev @ H01))
            P = g @ (H01d @ P)
            gprev = g
        gN = solve(wI - Hd[-1] - H01d @ (gprev @ H01) - SigR)
        GN1 = gN @ (H01d @ P)
    T = torch.einsum("eab,ebc,ecd,eda->e", GamR, GN1, GamL, GN1.conj().transpose(-1, -2))
    return T.real.cpu().numpy().astype(np.float64), res


def landauer_transmission(lead_model, energies, device=None, eta=1e-6,
                          iters=60, spin_resolved=False):
    """Two-terminal Landauer transmission ``T(E)`` (conductance in
    units of ``2 e^2 / h`` per spin convention of the model), the whole
    energy batch at once: one launch of kernel 12 for both leads, then the
    batched layer sweep.

    :param lead_model: 1-D periodic lead (e.g. a ribbon from
      ``cut_piece``); both leads are copies of it
    :param energies: (nE,) energies
    :param device: scattering region in the principal-layer basis
      (default: one pristine layer H00): a Hermitian (S, S) matrix or
      a LIST of them -- consecutive layers chained by the lead's H01
      (solved by the recursive Green's function sweep, O(nlay S^3) per
      energy).  Build blocks from :func:`lead_blocks`
    :param eta: positive infinitesimal
    :param iters: decimation depth; warns when the effective lead
      coupling has not collapsed -- incl. the eta -> 0 overflow mode
      where the residual alone would spuriously read 0
    :param spin_resolved: for an Sz-CONSERVING spinful lead+device
      (verified numerically: all spin-off-diagonal blocks must vanish,
      else raises), return the per-spin pair ``(nE, 2)``
    :returns: (nE,) float transmission, or (nE, 2) spin-resolved
    """
    if lead_model._dim_k != 1:
        raise PythtbError(
            "landauer_transmission needs a 1-D periodic lead "
            "(cut_piece a ribbon from a higher-dimensional model first)"
        )
    s00, s01, _m = _layer_blocks(lead_model, int(lead_model._per[0]))
    if device is None:
        H00, _H01 = lead_blocks(lead_model)
        layers = [H00]
    elif isinstance(device, (list, tuple)):
        layers = [np.asarray(d, dtype=np.complex128) for d in device]
    else:
        layers = [np.asarray(device, dtype=np.complex128)]
    if len(layers) == 0:
        raise PythtbError("device needs at least one layer")
    S = s00.nsta
    for d in layers:
        if d.shape != (S, S):
            raise PythtbError(
                "device layers must be (%d, %d) in the principal-layer "
                "basis (see lead_blocks)" % (S, S))
        if np.abs(d - d.conj().T).max() > 1e-12:
            raise PythtbError("device layers must be Hermitian")
    Hd = np.stack(layers)
    energies = np.atleast_1d(np.asarray(energies, dtype=np.float64))
    if spin_resolved:
        if s00.nspin != 2:
            raise PythtbError("spin_resolved needs a spinful lead")
        H00, H01 = lead_blocks(lead_model)
        Ts = []
        for sp in (0, 1):
            idx = np.arange(sp, S, 2)
            off = max(
                np.abs(M[np.ix_(idx, np.arange(1 - sp, S, 2))]).max()
                for M in [H00, H01] + layers
            )
            if off > 1e-10:
                raise PythtbError(
                    "spin_resolved requires Sz conservation (largest "
                    "spin-off-diagonal element %.1e)" % off)
            Ts.append(_dense_transmission(
                H00[np.ix_(idx, idx)], H01[np.ix_(idx, idx)],
                np.stack([d[np.ix_(idx, idx)] for d in layers]),
                energies, eta, iters))
        return np.stack(Ts, axis=-1)
    H00t, H01t = _lead_tensors(s00, s01)
    T, res = _transmission(H00t, H01t, _upload(Hd, H00t.device), energies, eta, iters)
    if not res < _RES_TOL:
        warnings.warn(
            "landauer_transmission: the lead decimation has not "
            "converged (residual coupling %.1e) -- increase iters or "
            "eta; at very small eta the recursion can overflow and "
            "the result is garbage." % float(res),
            UserWarning, stacklevel=2,
        )
    return T


def _upload(a, dev):
    """A complex128 host array as a C-contiguous tensor on ``dev``."""
    return torch.as_tensor(np.ascontiguousarray(a, dtype=np.complex128)).to(dev)


def _dense_transmission(H00, H01, Hd, energies, eta, iters):
    """Transmission from explicit dense lead blocks (the spin-split
    path): the same decimation and layer sweep as the lead-model path."""
    dev = config.checked_device()
    T, res = _transmission(_upload(H00, dev), _upload(H01, dev), _upload(Hd, dev), energies, eta, iters)
    if not res < _RES_TOL:
        warnings.warn(
            "landauer_transmission: the lead decimation has not "
            "converged (residual coupling %.1e)." % float(res),
            UserWarning, stacklevel=3,
        )
    return T


def mode_count(lead_model, energies, nk=512, stability_h=None):
    """Independent mode counter: the number of propagating channels at
    each energy from the lead dispersion (band crossings around the
    closed k-loop, counted with multiplicity) -- the value of the
    pristine-wire transmission AWAY from band edges.

    CAVEATS (crossing counting): a band extremum tangent to E
    undercounts by its multiplicity, and an exactly sampled ev == E
    point (flat bands) miscounts.  Pass ``stability_h`` to mark
    energies where the count changes under a +-h shift: those entries
    come back as -1 instead of a wrong integer."""
    if lead_model._dim_k != 1:
        raise PythtbError("mode_count needs a 1-D lead")
    ks = (np.arange(nk) / nk)[:, None]
    ev = np.asarray(lead_model.solve_all(ks))  # (nsta, nk)
    energies = np.atleast_1d(np.asarray(energies, dtype=np.float64))
    def count(Es):
        out = np.zeros(len(Es), dtype=int)
        for ie, E in enumerate(Es):
            sg = np.sign(ev - E)  # (nsta, nk)
            crossings = np.sum(sg != np.roll(sg, 1, axis=1), axis=1)
            out[ie] = int(np.sum(crossings) // 2)
        return out

    out = count(energies)
    if stability_h is not None:
        h = float(stability_h)
        lo = count(energies - h)
        hi = count(energies + h)
        out = np.where((out == lo) & (out == hi), out, -1)
    return out


# ---------------------------------------------------------------------------
# multi-terminal Landauer-Buttiker
#
# multi_terminal() takes the device as ONE dense Hermitian matrix plus a
# list of (H00, Hin, W) leads -- H00 the lead surface layer, Hin the hop
# from the surface INTO the next-deeper layer, W the (S, N) coupling
# <lead surface | H | device> -- and returns the full T_pq(E) matrix:
# every lead decimated by its own launch of kernel 12's Green's-function
# mode, the device solved dense (torch.linalg.solve over the energy
# batch), Caroli traces for all pairs (torch.einsum).  buttiker() inverts
# the Landauer-Buttiker current relations for terminal potentials;
# hall_bar() builds the standard cross geometry from any 2-D model with
# nearest-cell hops.


def _multi_terminal(Hd, leads, energies, eta, iters):
    """T_pq(E) (nE, nl, nl) for all terminal pairs and the worst lead
    residual, from the host arrays of :func:`multi_terminal`."""
    dev = config.checked_device()
    N = Hd.shape[-1]
    w = torch.as_tensor(np.asarray(energies, dtype=np.float64) + 1j * float(eta),
                        dtype=config.COMPLEX).to(dev)
    eyeN = torch.eye(N, dtype=config.COMPLEX, device=dev)
    wIN = w[:, None, None] * eyeN  # (E, N, N)
    Sig = torch.zeros_like(wIN)
    Gammas = []
    res = 0.0
    for H00, Hin, W in leads:
        g, r = _sancho_scan(_upload(H00, dev)[None], _upload(Hin, dev)[None], w, iters)
        if r != r or r > res:  # NaN-propagating maximum
            res = r
        Wt = _upload(W, dev)  # (S, N)
        Sg = Wt.conj().T @ (g[:, 0] @ Wt)
        Sig = Sig + Sg
        Gammas.append(1j * (Sg - Sg.conj().transpose(-1, -2)))
    G = torch.linalg.solve(wIN - _upload(Hd, dev) - Sig, eyeN.expand_as(wIN))
    Gd = G.conj().transpose(-1, -2)
    nl = len(Gammas)
    T = torch.zeros((w.shape[0], nl, nl), dtype=config.FLOAT, device=dev)
    for p in range(nl):
        GpG = Gammas[p] @ G  # (E, N, N)
        for q in range(nl):
            if q != p:
                T[:, p, q] = torch.einsum("eab,ebc,eca->e", GpG, Gammas[q], Gd).real
    return T.cpu().numpy().astype(np.float64), res


def multi_terminal(device_h, leads, energies, eta=1e-6, iters=60):
    """Multi-terminal transmission matrix ``T_pq(E)`` (p != q:
    transmission INTO terminal p FROM terminal q; diagonal returned 0).

    :param device_h: dense Hermitian (N, N) scattering-region matrix
      (e.g. from a finite flake, plus disorder)
    :param leads: list of ``(H00, Hin, W)`` per terminal: ``H00`` the
      (S, S) lead surface-layer block, ``Hin`` the (S, S) hop from the
      surface layer INTO the next layer deeper in the lead, ``W`` the
      (S, N) coupling ``<lead surface | H | device>``.  Use
      :func:`hall_bar` to build these for standard geometries.
    :param energies: (nE,) energies
    :returns: (nE, nleads, nleads) float array

    Every lead's Sancho-Rubio decimation is one launch of kernel 12 over
    the energy batch; the dense device Green's function and the Caroli
    traces are batched over energies.  Sum rules ``sum_q T_pq == sum_q
    T_qp`` (S-matrix unitarity) hold.
    """
    Hd = np.asarray(device_h, dtype=np.complex128)
    N = Hd.shape[0]
    if Hd.shape != (N, N) or np.abs(Hd - Hd.conj().T).max() > 1e-10:
        raise PythtbError("multi_terminal: device_h must be Hermitian")
    if len(leads) < 2:
        raise PythtbError("multi_terminal needs at least 2 leads")
    checked = []
    for li, (H00, Hin, W) in enumerate(leads):
        H00 = np.asarray(H00, dtype=np.complex128)
        Hin = np.asarray(Hin, dtype=np.complex128)
        W = np.asarray(W, dtype=np.complex128)
        S = H00.shape[0]
        if H00.shape != (S, S) or Hin.shape != (S, S):
            raise PythtbError(
                "multi_terminal: lead %d blocks must be square and "
                "matching" % li)
        if np.abs(H00 - H00.conj().T).max() > 1e-10:
            raise PythtbError("multi_terminal: lead %d H00 not Hermitian"
                              % li)
        if W.shape != (S, N):
            raise PythtbError(
                "multi_terminal: lead %d coupling must be (%d, %d), got "
                "%r" % (li, S, N, W.shape))
        checked.append((H00, Hin, W))
    energies = np.atleast_1d(np.asarray(energies, dtype=np.float64))

    def run(Es, et):
        return _multi_terminal(Hd, checked, Es, et, iters)

    T, res = run(energies, eta)
    # The fixed-depth Sancho-Rubio recursion overflows to NaN at
    # isolated energies when eta is very small (slowly-decaying
    # channels near band edges).  Recompute only the failing energies
    # at escalated eta so the rest of the batch keeps full accuracy.
    bad = ~np.isfinite(T).all(axis=(1, 2))
    n_bad0 = int(bad.sum())
    esc = float(eta)
    for _ in range(2):
        if not bad.any():
            break
        esc *= 32.0
        T[bad], _ = run(energies[bad], esc)
        bad = ~np.isfinite(T).all(axis=(1, 2))
    if n_bad0:
        warnings.warn(
            "multi_terminal: decimation overflowed at %d of %d energies "
            "at eta=%.1e; recomputed them at escalated eta=%.1e%s" % (
                n_bad0, len(energies), eta, esc,
                " (%d still non-finite -- raise eta)" % int(bad.sum())
                if bad.any() else ""),
            UserWarning, stacklevel=2)
    elif not res < _RES_TOL:
        warnings.warn(
            "multi_terminal: a lead decimation has not converged "
            "(residual coupling %.1e) -- increase iters or eta."
            % res, UserWarning, stacklevel=2)
    return T


def buttiker(T, source, drain, current=1.0):
    """Terminal potentials from the Landauer-Buttiker current
    relations ``I_p = (e^2/h) [ sum_q T_qp V_p - sum_q T_pq V_q ]``
    with unit current driven ``source -> drain``, every other terminal
    a floating voltage probe (I = 0), and the drain grounded.

    :param T: (nleads, nleads) transmission matrix at one energy (or a
      Fermi-window average), ``T[p, q]`` = into p from q
    :param current: driven current in ``e^2/h * energy`` units
    :returns: (nleads,) potentials ``V_p`` with ``V[drain] = 0``; e.g.
      a Hall resistance is ``(V[pa] - V[pb]) / current`` in h/e^2.

    The solve is gauge-consistent by construction (the conductance
    matrix has exact zero row sums, so only potential DIFFERENCES
    matter) and current-conserving (column sums vanish when T
    satisfies the unitarity sum rule -- warned otherwise).
    """
    T = np.asarray(T, dtype=np.float64)
    nl = T.shape[0]
    if T.shape != (nl, nl):
        raise PythtbError("buttiker: T must be square (one energy)")
    s, d = int(source), int(drain)
    if s == d or not (0 <= s < nl and 0 <= d < nl):
        raise PythtbError("buttiker: bad source/drain")
    sumrule = np.abs(T.sum(axis=0) - T.sum(axis=1)).max()
    # the JAX package's threshold (sized for float32 transmissions); a
    # GENUINE unitarity violation (truncated decimation, wrong coupling
    # blocks) is orders of magnitude above it
    if sumrule > 1e-4 * max(T.max(), 1.0):
        warnings.warn(
            "buttiker: T violates the unitarity sum rule by %.1e; "
            "potentials will not conserve current exactly" % sumrule,
            UserWarning, stacklevel=2)
    # G V = I with G_pp = sum_q T_pq, G_pq = -T_pq: EXACT zero row sums
    # (gauge invariance by construction; the row/column choice is
    # equivalent under the unitarity sum rule, warned above when T
    # violates it numerically)
    G = -T.copy()
    G[np.diag_indices(nl)] = T.sum(axis=1)
    I = np.zeros(nl)
    I[s] = float(current)
    I[d] = -float(current)
    keep = [p for p in range(nl) if p != d]
    V = np.zeros(nl)
    V[keep] = np.linalg.solve(G[np.ix_(keep, keep)], I[keep])
    return V



def hall_bar(model, size, lead_width=None, disorder=0.0, seed=0):
    """Four-terminal Hall-cross geometry from a 2-D periodic model.

    The scattering region is an ``Lx x Ly`` open flake of the model;
    four semi-infinite leads of the SAME model attach flush to the
    west/east edges (full height, extending along -x/+x) and the
    south/north edges (full width, extending along -y/+y).  Returns
    ``(device_h, leads, info)`` ready for :func:`multi_terminal`, with
    ``leads`` ordered ``[W, E, S, N]``.

    Using leads of the same gapped model is the gauge-free way to read
    quantized Hall response: inside the bulk gap each lead carries
    only the chiral edge channels, so for a Chern insulator
    ``buttiker`` gives ``R_xy = (V_N - V_S)/I = -h/(C e^2)`` exactly
    and zero longitudinal drop (tests).

    :param model: 2-D periodic model whose hops reach at most one cell
      in each direction (``|R_d| <= 1``; raises otherwise)
    :param size: (Lx, Ly) device cells
    :param lead_width: cells per transverse lead direction (default:
      the full matching edge)
    :param disorder: Anderson onsite disorder strength W in the DEVICE
      region only (uniform in [-W/2, W/2] per site, both spin
      components alike)
    :param seed: disorder RNG seed
    :returns: ``(device_h, leads, info)``; ``info["site"](x, y, orb)``
      maps device coordinates to the flat mode index
    """
    if model._dim_k != 2 or model._dim_r != 2:
        raise PythtbError("hall_bar needs a 2-D periodic model")
    Lx, Ly = (int(x) for x in size)
    if Lx < 2 or Ly < 2:
        raise PythtbError("hall_bar: size must be at least 2 x 2")
    norb = model._norb
    nspin = model._nspin
    hops = []
    for h in model._hoppings:
        amp = np.asarray(h[0], dtype=complex)
        i, j, R = h[1], h[2], np.asarray(h[3], dtype=np.int64)
        if np.abs(R).max() > 1:
            raise PythtbError(
                "hall_bar: hop %r reaches beyond the nearest cell; the "
                "flush lead attachment assumes |R_d| <= 1" % (h,))
        hops.append((amp, i, j, tuple(int(x) for x in R)))
    ons = [np.asarray(model._site_energies[i], dtype=complex)
           for i in range(norb)]

    def block(nr, nc):
        if nspin == 1:
            return np.zeros((nr * norb, nc * norb), dtype=complex)
        return np.zeros((2 * nr * norb, 2 * nc * norb), dtype=complex)

    def put(M, a, b, amp):
        if nspin == 1:
            M[a, b] += amp
        else:
            M[2 * a: 2 * a + 2, 2 * b: 2 * b + 2] += amp

    def put_h(M, a, b, amp):
        put(M, a, b, amp)
        put(M, b, a, amp.conj().T if nspin == 2 else np.conj(amp))

    # ---- device flake: site = (y * Lx + x) * norb + orb ------------
    def dsite(x, y, o):
        return (y * Lx + x) * norb + o

    Nsite = Lx * Ly * norb
    Hd = block(Lx * Ly, Lx * Ly)
    for y in range(Ly):
        for x in range(Lx):
            for o in range(norb):
                a = dsite(x, y, o)
                put(Hd, a, a,
                    ons[o] if nspin == 1 or np.ndim(ons[o]) == 2
                    else ons[o] * np.eye(2))
    for amp, i, j, (rx, ry) in hops:
        for y in range(Ly):
            y2 = y + ry
            if not 0 <= y2 < Ly:
                continue
            for x in range(Lx):
                x2 = x + rx
                if not 0 <= x2 < Lx:
                    continue
                put_h(Hd, dsite(x, y, i), dsite(x2, y2, j), amp)
    if np.ndim(disorder) == 0 and float(disorder) != 0.0:
        delta = np.random.default_rng(seed).uniform(
            -float(disorder) / 2.0, float(disorder) / 2.0, Nsite)
        if nspin == 1:
            Hd[np.diag_indices(Nsite)] += delta
        else:
            Hd[np.diag_indices(2 * Nsite)] += np.repeat(delta, 2)

    # ---- lead column/row blocks ------------------------------------
    # a lead along +-x: transverse cells indexed by y (width Wy); H00
    # is one column with open transverse edges, Hx the hop from a
    # column to the NEXT column toward +x.
    def strip_blocks(width, axis):
        H00 = block(width, width)
        Hfwd = block(width, width)
        for t in range(width):
            for o in range(norb):
                a = t * norb + o
                put(H00, a, a,
                    ons[o] if nspin == 1 or np.ndim(ons[o]) == 2
                    else ons[o] * np.eye(2))
        for amp, i, j, R in hops:
            ra = R[axis]        # along the lead
            rt = R[1 - axis]    # transverse
            for t in range(width):
                t2 = t + rt
                if not 0 <= t2 < width:
                    continue
                a, b = t * norb + i, t2 * norb + j
                if ra == 0:
                    put_h(H00, a, b, amp)
                elif ra == 1:
                    put(Hfwd, a, b, amp)
                else:
                    put(Hfwd, b, a,
                        amp.conj().T if nspin == 2 else np.conj(amp))
        return H00, Hfwd

    # ---- couplings device <-> lead surface --------------------------
    # W rows: lead surface sites; columns: device sites.  Every hop is
    # first canonicalized so its lead->device crossing points along the
    # needed direction (a device->lead hop is the Hermitian partner of
    # a lead->device hop with (amp^dag, j, i, -R)); then one uniform
    # loop fills W_{s,n} = <lead s | H | device n>.
    def canonical(axis, sign):
        """Hops re-expressed so R[axis] == sign (lead -> device)."""
        out = []
        for amp, i, j, R in hops:
            if R[axis] == sign:
                out.append((amp, i, j, R[1 - axis]))
            elif R[axis] == -sign:
                out.append((amp.conj().T if nspin == 2 else np.conj(amp),
                            j, i, -R[1 - axis]))
        return out

    def coupling(side, width, offset):
        S = (2 if nspin == 2 else 1) * width * norb
        Ndev = (2 if nspin == 2 else 1) * Nsite
        W = np.zeros((S, Ndev), dtype=complex)
        axis = 0 if side in ("W", "E") else 1
        # direction of the lead->device crossing along `axis`
        sign = 1 if side in ("W", "S") else -1
        edge = {"W": 0, "E": Lx - 1, "S": 0, "N": Ly - 1}[side]
        tmax = Ly if axis == 0 else Lx
        for amp, i, j, rt in canonical(axis, sign):
            for t in range(width):
                td = offset + t + rt  # transverse device coordinate
                if not 0 <= td < tmax:
                    continue
                dev = dsite(edge, td, j) if axis == 0 else dsite(td, edge, j)
                put(W, t * norb + i, dev, amp)
        return W

    wy = int(lead_width) if lead_width is not None else Ly
    wx = int(lead_width) if lead_width is not None else Lx
    if wy > Ly or wx > Lx:
        raise PythtbError("hall_bar: lead_width exceeds the device edge")
    offy = (Ly - wy) // 2
    offx = (Lx - wx) // 2
    H00y, Hx = strip_blocks(wy, 0)   # leads along x (W/E)
    H00x, Hy = strip_blocks(wx, 1)   # leads along y (S/N)
    Hxd = Hx.conj().T
    Hyd = Hy.conj().T
    leads = [
        (H00y, Hxd, coupling("W", wy, offy)),   # west: deeper = -x
        (H00y, Hx, coupling("E", wy, offy)),    # east: deeper = +x
        (H00x, Hyd, coupling("S", wx, offx)),   # south: deeper = -y
        (H00x, Hy, coupling("N", wx, offx)),    # north: deeper = +y
    ]
    info = {"order": ["W", "E", "S", "N"], "site": dsite,
            "size": (Lx, Ly), "lead_width": (wy, wy, wx, wx)}
    return Hd, leads, info



def thermoelectrics(lead_model, mu, temperature, device=None,
                    e_window=None, n_energies=801, eta=1e-6, iters=60):
    """Linear-response thermoelectric coefficients from the Landauer
    integrals ``L_n = int dE (-df/dE) (E - mu)^n T(E)``:

    * ``G = L_0`` -- conductance (2 e^2/h units, matching
      :func:`landauer_transmission`);
    * ``S = -(k_B/e) L_1 / (k_B T L_0)`` -- Seebeck coefficient in
      k_B/e units;
    * ``kappa_e = (L_2 - L_1^2 / L_0) / T`` -- electronic thermal
      conductance in k_B^2 T/h-style units.

    Committed oracles: the Mott relation ``S ~ -(pi^2/3) k_B T
    d ln T(E)/dE`` at low temperature (independent numerical E
    derivative) and Wiedemann-Franz ``kappa_e / (G T) -> pi^2/3``.

    :param mu: chemical potential (scalar or (nmu,))
    :param temperature: k_B T > 0
    :param e_window: (lo, hi) integration window (default: mu +-
      12 k_B T around the extreme mus)
    :param n_energies: MINIMUM number of integration energies; the grid
      is automatically refined so the Fermi window stays resolved
      (dE <= k_B T / 4), capped at 50001 points with a warning
    :returns: dict with ``"G"``, ``"S"``, ``"kappa_e"`` (each (nmu,)
      or scalar to match mu).  When mu sits in a transport gap
      (``G`` below the numerical noise floor of the integration) the
      ratios ``S`` and ``kappa_e`` are ill-conditioned 0/0 forms and
      are returned as NaN with a ``UserWarning`` (mirroring the
      decimation-convergence diagnostics).
    """
    if float(temperature) <= 0.0:
        raise PythtbError("thermoelectrics requires temperature > 0")
    mus = np.atleast_1d(np.asarray(mu, dtype=np.float64))
    kt = float(temperature)
    if e_window is None:
        e_window = (mus.min() - 12.0 * kt, mus.max() + 12.0 * kt)
    window = float(e_window[1]) - float(e_window[0])
    # a wide mu sweep must not under-resolve the ~kT Fermi window: keep
    # dE <= kT/4, capped so a pathological window cannot
    # explode the device batch
    n_resolve = int(np.ceil(window / (0.25 * kt))) + 1
    n_use = max(int(n_energies), n_resolve)
    if n_use > 50001:
        warnings.warn(
            "thermoelectrics: resolving the Fermi window over this "
            "e_window needs %d energies; capping at 50001 (dE = %.3g kT "
            "> kT/4) -- narrow e_window or raise temperature"
            % (n_use, window / 50000.0 / kt),
            UserWarning, stacklevel=2,
        )
        n_use = 50001
    Es = np.linspace(float(e_window[0]), float(e_window[1]), n_use)
    T = np.asarray(landauer_transmission(lead_model, Es, device=device,
                                         eta=eta, iters=iters),
                   dtype=np.float64)
    # the Sancho-Rubio recursion can overflow to NaN at isolated energies
    # (band-edge tangencies at small eta) even when the bulk of the grid
    # is fine, which would poison every L_n integral: escalate eta
    # locally on the failing energies, then interpolate any holdouts from
    # finite neighbors (a dense grid, dE <= kT/4, so linear fill-in is far
    # below the integration error).
    bad = ~np.isfinite(T)
    n_bad0 = int(bad.sum())
    esc = float(eta)
    for _ in range(2):
        if not bad.any():
            break
        esc *= 32.0
        T[bad] = np.asarray(landauer_transmission(
            lead_model, Es[bad], device=device, eta=esc, iters=iters),
            dtype=np.float64)
        bad = ~np.isfinite(T)
    n_holdout = int(bad.sum())
    if bad.any():
        good = np.where(~bad)[0]
        if len(good) < 2:
            raise PythtbError(
                "thermoelectrics: transmission is non-finite on "
                "essentially the whole grid -- raise eta"
            )
        T[bad] = np.interp(np.where(bad)[0], good, T[good])
    if n_bad0:
        warnings.warn(
            "thermoelectrics: decimation overflowed at %d of %d "
            "energies (f32 recursion at eta=%.1e); recomputed them at "
            "escalated eta=%.1e%s" % (
                n_bad0, len(Es), eta, esc,
                " and interpolated %d holdouts" % n_holdout
                if n_holdout else ""),
            UserWarning, stacklevel=2,
        )
    dE = Es[1] - Es[0]
    # numerical noise floor for L0: a gap's true L0 is exponentially
    # small, but eta-broadening leaks T ~ (eta/gap)^2 into the gap and
    # the compute carries ~eps-scale roundoff -- anything below BOTH
    # scales is indistinguishable from noise and makes S = L1/L0
    # astronomical garbage; the floor scales with the compute dtype and
    # with eta^2, as in the JAX package.
    eps_t = float(np.finfo(np.asarray(T).dtype).eps)
    l0_floor = max(
        max(float(np.max(T)), 1.0) * max(100.0 * eps_t, 1e-12),
        (10.0 * float(eta)) ** 2,
    )
    out = {"G": [], "S": [], "kappa_e": []}
    gapped_mus = []
    for m in mus:
        x = (Es - m) / kt
        mdf = 0.25 / (kt * np.cosh(np.clip(x / 2.0, -40.0, 40.0)) ** 2)
        L0 = np.sum(mdf * T) * dE
        L1 = np.sum(mdf * (Es - m) * T) * dE
        L2 = np.sum(mdf * (Es - m) ** 2 * T) * dE
        out["G"].append(L0)
        if L0 < l0_floor:
            gapped_mus.append(float(m))
            out["S"].append(np.nan)
            out["kappa_e"].append(np.nan)
        else:
            out["S"].append(-L1 / (kt * L0))
            out["kappa_e"].append((L2 - L1**2 / L0) / kt)
    if gapped_mus:
        warnings.warn(
            "thermoelectrics: G below the numerical noise floor (%.1e) "
            "at mu=%s -- mu lies in a transport gap; S and kappa_e are "
            "ill-conditioned there and returned as NaN"
            % (l0_floor, np.round(gapped_mus, 6).tolist()),
            UserWarning, stacklevel=2,
        )
    if np.ndim(mu) == 0:
        return {k: float(v[0]) for k, v in out.items()}
    return {k: np.asarray(v) for k, v in out.items()}
