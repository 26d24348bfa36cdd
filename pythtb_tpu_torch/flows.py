"""Fused end-to-end device pipelines (counterpart of ``pythtb_tpu.flows``).

These compute the same objects as the ``wf_array`` route (solve_on_grid
+ impose_pbc + berry_flux / berry_phase) with everything on the device:
the k-grid is built there, assembled (kernel 1), diagonalized (kernel 2
at two bands), extended by the periodic gauge, and then either reduced
to link determinants (kernel 3) and summed over plaquettes (kernel 4) --
``chern_number`` -- or chained into Wilson loops (kernel 5) --
``wilson_flow`` and the Z2 invariant.  Only the results come back.
``polarization`` goes through ``wf_array``.

Matrix-free, on the ELL tables of :mod:`pythtb_tpu_torch.ops.matvec`:
``kpm_dos`` (its Chebyshev moment recursion is one call of kernel 9);
``solve_window`` (Chebyshev-filtered subspace iteration: the Gaussian
filter is one call of kernel 11, H Q one launch of kernel 8, the Gram and
Rayleigh-Ritz steps torch.linalg) with ``wilson_window`` and
``chern_window`` on its states; ``solve_lowest`` (complex block LOBPCG,
:mod:`pythtb_tpu_torch.ops.lobpcg`, on kernel 8).

Response sweeps: ``anomalous_hall``, ``anomalous_nernst`` and
``thermal_hall`` weight per-band plaquette fluxes (kernels 1-4) with the
occupation, entropy or c2 factor of every chemical potential in one
launch of kernel 17 (:mod:`pythtb_tpu_torch.ops.fermi_sweep`);
``berry_dipole``, ``spin_hall_conductivity`` and
``orbital_magnetization`` build band-basis velocity matrices from
dH/dk (kernel 15) and contract them with torch, the dipole's mu sweep
on kernel 17.

Spectra and band-resolved calls: ``density_of_states`` and
``projected_dos`` broaden the grid's levels with kernel 16's Gaussian
mode; ``band_velocities`` are Hellmann-Feynman diag(U^H dH/dk U) on
kernel 15; ``spin_texture`` reads the states of kernels 1-2 (or 7).

Invariants beyond the Chern number: ``quadrupole`` (nested Wilson loops:
kernel 5 and ``unitary_eig``), ``sector_chern`` / ``spin_chern`` (the
P O P eigenstates, then kernels 3-4 per sector), ``valley_chern`` (the
per-band fluxes of the Hall sweeps, partitioned on the host),
``parity_z2`` / ``parity_polarization`` (inversion eigenvalues at the
TRIMs), ``find_nodes`` / ``node_chirality`` (a gap scan on kernels 1-2,
a Hellmann-Feynman descent on kernels 1, 2 and 15, cube fluxes on
kernels 3-4) and ``second_chern`` / ``axion_theta`` (the projector
curvature of a model family as torch einsums).

Functions of the model parameters: ``energy_fn`` (band energies with a
``torch.autograd.Function`` whose backward is kernel 29) and
``chern_fn`` (a member axis in place of ``jax.vmap``: one flux-batch
solve, then kernels 3-4 per member).
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from . import config
from .core import BlochData
from .ops import chebyshev
from .ops.berry import _dets, _plane_link_dets, _wrap, plaquette_flux, wilson_eigenphases, wilson_loop
from .ops.eigh import eigh_batched, eigvalsh_batched
from .ops.fermi_sweep import fermi_sweep
from .ops.hamiltonian import _hermitian_part, assemble, assemble_dk, assemble_members, energy_vjp
from .ops.solver import device_uniform_grid, extend_pbc_seq
from .optical import _band_tensors, _inv_gaps

__all__ = [
    "gauge_phases", "berry_flux_grid", "chern_number", "wilson_flow", "z2_fn",
    "z2_invariant", "polarization", "kpm_dos", "solve_lowest", "solve_window", "wilson_window",
    "chern_window", "anomalous_hall", "anomalous_nernst", "thermal_hall", "berry_dipole",
    "spin_hall_conductivity", "orbital_magnetization", "density_of_states", "projected_dos",
    "band_velocities", "spin_texture", "quadrupole", "sector_chern", "spin_chern", "valley_chern",
    "parity_z2", "parity_polarization", "find_nodes", "node_chirality", "second_chern", "axion_theta",
    "energy_fn", "chern_fn",
]


def gauge_phases(model, dims, flatten=True):
    """Periodic-gauge boundary phases exp(-2j*pi*orb[:, per[d]]) for the
    given mesh dimensions, as NumPy arrays.  With ``flatten`` the spin
    axis is merged into the orbital axis; otherwise shape (norb, 2)."""
    out = []
    for d in dims:
        ffac = np.exp(-2.0j * np.pi * model._orb[:, model._per[d]])
        if model._nspin == 2:
            ffac = np.repeat(ffac, 2) if flatten else np.repeat(ffac[:, None], 2, axis=1)
        out.append(ffac)
    return out


def _phase_tensor(model, dim, device):
    """Periodic-gauge phases of mesh dimension ``dim`` as a flattened
    complex tensor on ``device``."""
    return torch.as_tensor(gauge_phases(model, (dim,))[0], dtype=config.COMPLEX).to(device)


def _check_occ(occ, nsta):
    occ = tuple(int(o) for o in occ)
    if occ and (min(occ) < 0 or max(occ) >= nsta):
        raise IndexError("occ indices %s out of range for %d states" % (sorted(set(occ)), nsta))
    return occ


def _solve_grid_states(data: BlochData, kpts, occ, n0, n1):
    """Solve the interior grid and return occ states (n0-1, n1-1, nocc, F)."""
    _, v = eigh_batched(assemble(data, kpts))  # rows are states
    v = v[:, list(occ), :]
    return v.reshape(n0 - 1, n1 - 1, len(occ), data.nsta)


def _total_flux(w):
    """Sum of plaquette Berry phases of an extended (n0, n1, nocc, F)
    grid, and the smallest link |det|."""
    return plaquette_flux(*_plane_link_dets(w.contiguous()))


def berry_flux_grid(model, occ, nk=(101, 101), start_k=(-0.5, -0.5), mesh=None):
    """Total Berry flux of ``occ`` bands over the BZ on an (n0 x n1)
    grid, computed on the device.  Equals
    ``wf_array(model, nk).solve_on_grid(start_k); wf.berry_flux(occ)``.
    ``mesh`` must be None (:func:`config.require_no_mesh`).
    """
    config.require_no_mesh(mesh)
    n0, n1 = int(nk[0]), int(nk[1])
    data = model._get_finalized()
    if data.dim_k != 2:
        raise ValueError("chern_number requires a model with dim_k == 2")
    occ = _check_occ(occ, data.nsta)
    kpts = device_uniform_grid((n0 - 1, n1 - 1), np.asarray(start_k, dtype=np.float64), data.device)
    w = _solve_grid_states(data, kpts, occ, n0, n1)
    w = extend_pbc_seq(w, [_phase_tensor(model, d, data.device) for d in (0, 1)])
    return float(_total_flux(w)[0])


def chern_number(model, occ, nk=(101, 101), start_k=(-0.5, -0.5), mesh=None):
    """Chern number of the ``occ`` bands (flux / 2 pi); ``mesh`` must be
    None."""
    return berry_flux_grid(model, occ, nk, start_k, mesh) / (2.0 * np.pi)


def _params(data: BlochData, params):
    """(amps (P, nhop[, 2, 2]), diag (P, nsta, nsta), member): the
    parameters as complex128 tensors on the model's device, with a member
    axis; ``member`` says whether either came with one (the other is
    broadcast along it)."""
    amps = torch.as_tensor(params["amps"]).to(device=data.device, dtype=config.COMPLEX)
    diag = torch.as_tensor(params["diag"]).to(device=data.device, dtype=config.COMPLEX)
    a_member = amps.dim() == data.amps.dim() + 1
    d_member = diag.dim() == 3
    if tuple(amps.shape[int(a_member):]) != tuple(data.amps.shape):
        raise ValueError("amps must have shape %s or (P, *%s), got %s"
                         % (tuple(data.amps.shape), tuple(data.amps.shape), tuple(amps.shape)))
    if tuple(diag.shape[int(d_member):]) != (data.nsta, data.nsta):
        raise ValueError("diag must have shape (%d, %d) or (P, %d, %d), got %s"
                         % (data.nsta, data.nsta, data.nsta, data.nsta, tuple(diag.shape)))
    if a_member and d_member and amps.shape[0] != diag.shape[0]:
        raise ValueError("amps and diag have %d and %d members" % (amps.shape[0], diag.shape[0]))
    P = amps.shape[0] if a_member else (diag.shape[0] if d_member else 1)
    amps = (amps if a_member else amps[None]).expand((P,) + tuple(data.amps.shape))
    diag = (diag if d_member else diag[None]).expand(P, data.nsta, data.nsta)
    return amps, diag, a_member or d_member


def _degenerate_mean(w, g):
    """``g`` (B, S) averaged over each group of the ascending ``w`` (B, S)
    whose levels are equal to rounding (1e-12 of max(1, |w|) apart).  At
    a degeneracy sum_n g_n u_n u_n^H then sums projectors onto the groups,
    which no choice of basis inside a group changes: the symmetric
    subgradient, as the closed-form 2 x 2 gives."""
    tol = 1e-12 * torch.clamp(w.abs().amax(dim=-1, keepdim=True), min=1.0)
    brk = (w[:, 1:] - w[:, :-1]) > tol
    gid = torch.cat([torch.zeros_like(brk[:, :1], dtype=torch.int64), brk.to(torch.int64).cumsum(dim=-1)], dim=-1)
    sums = torch.zeros_like(g).scatter_add_(-1, gid, g)
    counts = torch.zeros_like(g).scatter_add_(-1, gid, torch.ones_like(g))
    return (sums / counts.clamp(min=1.0)).gather(-1, gid)


class _BandEnergies(torch.autograd.Function):
    """Band energies of P members of one hopping graph at shared k-points,
    (P, NK, nsta), with kernel 29 as the backward (:func:`energy_vjp`).
    The cotangent is averaged over each degenerate group first
    (:func:`_degenerate_mean`), so the gradient does not depend on the
    eigenbasis the solver returns there, on the card or on the CPU."""

    @staticmethod
    def forward(ctx, amps, diag, kpts, data):
        P, NK, S = amps.shape[0], kpts.shape[0], data.nsta
        amps, diag_h = amps.contiguous(), _hermitian_part(diag).contiguous()
        if P == 1:  # kernel 1
            H = assemble(dataclasses.replace(data, amps=amps[0], diag=diag_h[0]), kpts)
        else:  # kernel 1's flux-batch mode
            H = assemble_members(data, amps, diag_h, kpts)
        w, U = eigh_batched(H)
        ctx.save_for_backward(amps, diag_h, kpts, U, w)
        ctx.data = data
        return w.reshape(P, NK, S)

    @staticmethod
    def backward(ctx, gw):
        amps, diag_h, kpts, U, w = ctx.saved_tensors
        gbar = _degenerate_mean(w, gw.reshape(w.shape).to(config.FLOAT))
        ga, gd = energy_vjp(ctx.data, amps, diag_h, kpts, U, gbar.contiguous())
        return ga, gd, None, None


def energy_fn(model):
    """Differentiable band-energy function: returns ``(fn, params0)``,
    ``params0 = {"amps": ..., "diag": ...}`` the model's hopping amplitudes
    (nhop,) ((nhop, 2, 2) at nspin 2, in :class:`~pythtb_tpu_torch.core.BlochData`'s
    hop order) and on-site matrix (nsta, nsta) as complex128 tensors, and
    ``fn(params, kpts) -> evals (B, nsta)``, a torch function of them.

    Gradients flow through a ``torch.autograd.Function`` whose forward is
    kernel 1 and ``eigh_batched`` and whose backward is kernel 29
    (:func:`~pythtb_tpu_torch.ops.hamiltonian.energy_vjp`, the plain
    autograd version on the CPU): first derivatives with respect to the
    parameters, not to ``kpts``.  The energies are those of the on-site
    matrix's Hermitian part, and ``.grad`` of a complex leaf is
    dL/dRe + i dL/dIm (torch's convention; ``convert.grad_from_jax``
    turns the JAX package's ri-packed gradient into it).

    Params with a leading member axis, (P, nhop[, 2, 2]) amplitudes and/or
    (P, nsta, nsta) on-site matrices (the other broadcast), give (P, B,
    nsta): one launch of kernel 1's flux-batch mode, the counterpart of
    ``jax.vmap`` over the JAX package's ``fn``.

    Example::

        fn, p0 = flows.energy_fn(model)
        p = {k: v.clone().requires_grad_() for k, v in p0.items()}
        ev = fn(p, kpts)
        (ev[:, 1].min() - ev[:, 0].max()).backward()
        dgap = p["amps"].grad
    """
    data = model._get_finalized()
    params0 = {"amps": data.amps.clone(), "diag": data.diag.clone()}

    def fn(params, kpts):
        amps, diag, member = _params(data, params)
        k = torch.as_tensor(np.asarray(kpts) if not torch.is_tensor(kpts) else kpts)
        k = k.to(device=data.device, dtype=config.FLOAT).reshape(-1, data.dim_k).contiguous()
        ev = _BandEnergies.apply(amps, diag, k, data)
        return ev if member else ev[0]

    return fn, params0


def chern_fn(model, occ, nk=(31, 31), start_k=(-0.5, -0.5)):
    """Chern-number function of the model parameters: returns ``(fn,
    params0)`` with ``params0`` as in :func:`energy_fn` and ``fn(params)
    -> chern``, a 0-d float64 tensor, or (P,) for params with a leading
    member axis (the phase diagram that the JAX package vmaps):

        fn, p0 = flows.chern_fn(model, [0])
        cherns = fn({"amps": amps_grid, "diag": p0["diag"]})   # (P,)

    One call solves every member on the grid with
    ``ops.solver.solve_grid_family`` (one launch of kernel 1's flux-batch
    mode and one ``eigh_batched``), extends it by the periodic gauge, and
    sums plaquette fluxes with kernels 3 and 4.  The value is an integer
    almost everywhere, so ``fn`` computes it without autograd and returns
    a tensor with no graph.  The hopping graph is fixed; only amplitudes
    and on-site energies (their Hermitian part) vary.
    """
    from .ops.solver import solve_grid_family

    data = model._get_finalized()
    if data.dim_k != 2:
        raise ValueError("chern_fn requires a model with dim_k == 2")
    occ = _check_occ(occ, data.nsta)
    n0, n1 = int(nk[0]), int(nk[1])
    start = np.asarray(start_k, dtype=np.float64)
    params0 = {"amps": data.amps.clone(), "diag": data.diag.clone()}
    occ_idx = torch.as_tensor(np.asarray(occ, dtype=np.int64), device=data.device)

    def fn(params):
        amps, diag, member = _params(data, params)
        with torch.no_grad():
            _, _, w = solve_grid_family(data, amps.contiguous(), _hermitian_part(diag).contiguous(), (n0, n1), start,
                                        model._orb, model._per, model._nspin)
            P = w.shape[0]
            ws = w.reshape(P, n0, n1, data.nsta, data.nsta).index_select(3, occ_idx).contiguous()
            flux = plaquette_flux(*_plane_link_dets(ws))[0] / (2.0 * np.pi)
        return flux if member else flux[0]

    return fn, params0


def wilson_flow(model, occ, nk=(41, 41), loop_dir=1, start_k=(-0.5, -0.5)):
    """Hybrid Wannier centre flow on the device: for every grid value of
    the flow axis, the Wilson-loop eigenphases (hybrid Wannier centres x
    2 pi) and the traced Berry phase of the ``occ`` bands around the
    ``loop_dir`` axis.  Equals ``wf_array.solve_on_grid`` + two
    ``berry_phase`` calls, with only the (nflow, nocc) result crossing to
    the host.

    :returns: ``(evph, traced)``: (nflow, nocc) sorted eigenphases and
      (nflow,) traced phases, flow-axis endpoint included (equal to the
      first row, as for a periodic gauge).  Warns on (near-)singular link
      overlaps like the wf_array methods.
    """
    data = model._get_finalized()
    if data.dim_k != 2:
        raise ValueError("wilson_flow requires a model with dim_k == 2")
    occ = _check_occ(occ, data.nsta)
    if loop_dir not in (0, 1):
        raise ValueError("loop_dir must be 0 or 1")
    n0, n1 = int(nk[0]), int(nk[1])
    kpts = device_uniform_grid((n0 - 1, n1 - 1), np.asarray(start_k, dtype=np.float64), data.device)
    w = _solve_grid_states(data, kpts, occ, n0, n1)  # (n0-1, n1-1, nocc, F)
    # close each loop with the periodic gauge; the loop axis stays in place
    ph = _phase_tensor(model, loop_dir, data.device)
    w = torch.cat([w, w.narrow(loop_dir, 0, 1) * ph], dim=loop_dir).contiguous()
    prod, smin = wilson_loop(w, int(loop_dir))  # (nflow-1, nocc, nocc)
    evph = torch.sort(-wilson_eigenphases(prod), dim=-1).values  # wf_array convention
    traced = -torch.angle(_dets(prod))
    # flow boundary row = row 0: the pbc phase along the flow axis is a
    # k-independent diagonal unitary, which leaves Wilson spectra unchanged
    evph = torch.cat([evph, evph[:1]], dim=0).cpu().numpy().astype(np.float64)
    traced = torch.cat([traced, traced[:1]], dim=0).cpu().numpy().astype(np.float64)
    sing = float(smin.amin())
    if sing < np.sqrt(np.finfo(np.float64).eps):
        warnings.warn(
            "wilson_flow: smallest link-overlap singular value is %.2e -- "
            "neighboring occupied subspaces are (nearly) orthogonal; refine "
            "the grid or check the band choice." % sing,
            UserWarning,
            stacklevel=2,
        )
    return evph, traced


def _wilson_half_cycle(data, occ, n0, n1, start, phase0):
    """Wilson-loop eigenphases along k1 for the half cycle of k2 strings
    from the first TRIM to the second: (half+1, nocc), half = (n1-1)//2.
    Only those strings are solved."""
    half = (n1 - 1) // 2
    kpts = device_uniform_grid((n0 - 1, half + 1), start, data.device, denoms=(n0 - 1, n1 - 1))
    w = _solve_grid_states(data, kpts, occ, n0, half + 2)  # (n0-1, half+1, nocc, F)
    w = extend_pbc_seq(w, [phase0]).contiguous()  # (n0, half+1, nocc, F)
    prod, _ = wilson_loop(w, 0)  # (half+1, nocc, nocc)
    return wilson_eigenphases(prod)


def _gaps_sorted(theta):
    """Sorted centres and their circular gaps; entry nocc-1 is the
    wrap-around gap through the +-pi branch point."""
    th = torch.sort(theta, dim=-1).values
    gaps = torch.cat([th[:, 1:] - th[:, :-1], (2.0 * np.pi - (th[:, -1] - th[:, 0]))[:, None]], dim=-1)
    return th, gaps


def _z2_from_flow(theta):
    """Gap-crossing Z2 count from Wilson eigenphases (half+1, nocc):
    track the midpoint of the largest circular gap between the hybrid
    Wannier centres from TRIM to TRIM; Z2 is the parity of the number of
    centres the moving gap line sweeps past (Soluyanov & Vanderbilt,
    PRB 83, 235401 (2011), for any even number of bands)."""
    th, gaps = _gaps_sorted(theta)
    imax = torch.argmax(gaps, dim=-1, keepdim=True)
    lo = torch.take_along_dim(th, imax, dim=-1)[:, 0]
    width = torch.take_along_dim(gaps, imax, dim=-1)[:, 0]
    g = _wrap(lo + 0.5 * width)  # largest-gap midpoint per string
    dg = _wrap(g[1:] - g[:-1])
    rel = _wrap(theta[1:] - g[:-1, None])
    swept = (torch.sign(rel) == torch.sign(dg)[:, None]) & (rel.abs() <= dg.abs()[:, None])
    return torch.remainder(swept.sum(), 2).to(config.FLOAT)


def _z2_degenerate_flow(theta):
    """1.0 when the Wannier centres stay pairwise degenerate (at least
    nocc/2 circular gaps below 1e-8) on every interior string -- the
    gap-counting method's blind spot -- else 0.0."""
    nocc = theta.shape[-1]
    if theta.shape[0] <= 2:  # no interior strings: nothing to diagnose
        return torch.zeros((), dtype=config.FLOAT, device=theta.device)
    _, gaps = _gaps_sorted(theta)
    paired = (gaps <= 1e-8).sum(dim=-1) >= nocc // 2
    return paired[1:-1].all().to(config.FLOAT)


def _z2_prep(model, occ, nk):
    """Shared validation and set-up of the Z2 flows."""
    data0 = model._get_finalized()
    if data0.dim_k != 2:
        raise ValueError("z2_fn requires a model with dim_k == 2")
    occ = tuple(int(o) for o in occ)
    if len(occ) < 2 or len(occ) % 2 != 0:
        raise ValueError(
            "z2_fn needs an even number of occupied bands (Kramers pairs); got %d" % len(occ)
        )
    if min(occ) < 0 or max(occ) >= data0.nsta:
        raise IndexError("occ indices %s out of range for %d states" % (sorted(set(occ)), data0.nsta))
    n0, n1 = int(nk[0]), int(nk[1])
    if (n1 - 1) % 2 != 0:
        raise ValueError("nk[1] must be odd (half cycle must end on a TRIM)")
    phase0 = _phase_tensor(model, 0, data0.device)
    start = np.array([-0.5, -0.5])
    params0 = {"amps": data0.amps, "diag": data0.diag}
    return data0, occ, n0, n1, phase0, start, params0


def z2_fn(model, occ=(0, 1), nk=(31, 31), check=False):
    """Z2 invariant of an even number of occupied bands as a function of
    the model's parameter tensors.

    Uses the gap-crossing criterion of Soluyanov & Vanderbilt (PRB 83,
    235401 (2011)) over half the k2 cycle (TRIM to TRIM).  Returns
    ``(fn, params0)``: ``params0 = {"amps", "diag"}`` are the model's
    device tensors (hopping amplitudes, on-site matrix), and
    ``fn(params) -> z2`` (0.0 or 1.0, a device scalar); with ``check``,
    ``fn(params) -> (z2, converged)`` where ``z2`` is evaluated on the
    refined grid ``(2*nk[0]-1, 2*nk[1]-1)`` and ``converged`` is 1.0 when
    it agrees with the ``nk`` value and the flow is not pairwise
    degenerate throughout (the method's blind spot).  ``nk[1]`` must be
    odd so the half cycle ends on the second TRIM.
    """
    data0, occ, n0, n1, phase0, start, params0 = _z2_prep(model, occ, nk)

    def fn(params):
        data = dataclasses.replace(data0, amps=params["amps"], diag=params["diag"])
        z2 = _z2_from_flow(_wilson_half_cycle(data, occ, n0, n1, start, phase0))
        if not check:
            return z2
        theta_fine = _wilson_half_cycle(data, occ, 2 * n0 - 1, 2 * n1 - 1, start, phase0)
        z2_fine = _z2_from_flow(theta_fine)
        # an exactly pairwise-degenerate flow defeats the parity count on
        # BOTH grids, so grid agreement alone would certify a wrong answer
        converged = (z2 == z2_fine).to(config.FLOAT) * (1.0 - _z2_degenerate_flow(theta_fine))
        return z2_fine, converged

    return fn, params0


def z2_invariant(model, occ=(0, 1), nk=(31, 31), check=False):
    """Z2 invariant of an even number of occupied bands (see
    :func:`z2_fn`).  With ``check`` the invariant is recomputed on a
    refined grid; on disagreement (or a degenerate flow) a
    ``UserWarning`` is raised and the refined value is returned."""
    if not check:
        fn, p0 = z2_fn(model, occ, nk)
        return float(fn(p0))
    fn, p0 = z2_fn(model, occ, nk, check=True)
    v_fine, converged = (float(x) for x in fn(p0))
    if not converged:
        nk_fine = (2 * int(nk[0]) - 1, 2 * int(nk[1]) - 1)
        warnings.warn(
            "z2_invariant: not converged at nk=%s vs nk=%s (refined value "
            "%g).  Either the coarse grid under-resolves the Wannier-gap "
            "flow (increase nk and re-check until stable), or the centers "
            "are exactly pairwise degenerate along the whole flow -- the "
            "gap-counting method's structural blind spot; split the "
            "degeneracy with a small symmetry-breaking perturbation "
            "(inspect with wf_array.berry_phase(..., berry_evals=True))."
            % (tuple(nk), nk_fine, v_fine),
            UserWarning,
            stacklevel=2,
        )
    return v_fine


def polarization(model, occ, dir=0, nk=31, start_k=None):
    """Electronic polarization of the filled bands along one lattice
    vector, in reduced units (mod 1): ``p_d = <phi_d(k_perp)> / 2 pi``,
    the branch-continuous Berry phases averaged over the perpendicular
    grid (King-Smith--Vanderbilt).  Values are defined modulo the
    polarization quantum 1.

    :param occ: filled band indices
    :param dir: polarization direction (a periodic lattice vector)
    :param nk: scalar or per-direction grid sizes
    :param start_k: grid origin (default zeros)
    :returns: float in [0, 1)
    """
    from .model import PythtbError
    from .wf_array import wf_array

    d = model._dim_k
    if d < 1:
        raise PythtbError("polarization needs a periodic model")
    dir = int(dir)
    if not 0 <= dir < d:
        raise PythtbError("dir must index a periodic direction")
    occ = tuple(int(o) for o in np.atleast_1d(occ))
    if len(occ) == 0 or min(occ) < 0 or max(occ) >= model._nsta:
        raise PythtbError("bad occ")
    nks = tuple(int(x) for x in (np.atleast_1d(nk) if np.ndim(nk) else [nk] * d))
    if len(nks) == 1 and d > 1:
        nks = nks * d
    if len(nks) != d:
        raise PythtbError("nk must give one size per direction")
    start = np.zeros(d) if start_k is None else np.asarray(start_k, dtype=np.float64)
    wf = wf_array(model, list(nks))
    wf.solve_on_grid(start)
    ph = np.asarray(wf.berry_phase(list(occ), dir, contin=True))
    # drop the wrapped pbc duplicate row per perpendicular axis, which
    # would double-count k_perp = start
    if ph.ndim > 0:
        ph = ph[tuple(slice(0, -1) for _ in range(ph.ndim))]
    return float(np.mean(ph) / (2.0 * np.pi) % 1.0)


def _kpm_moments(h, a, b, x0, M):
    """Stochastic Chebyshev moments mu_0..mu_{M-1} of the rescaled
    (H - b)/a, averaged over the random-phase columns of ``x0`` (nsta, R)
    (counterpart of ``_kpm_moments_jit``, which draws the vectors itself):
    one call of kernel 9, two moments per matvec."""
    ab = torch.tensor([a, b], dtype=config.FLOAT, device=h.device)
    return chebyshev.moments(h, ab, x0, M, float(h.nsta)).mean(dim=1)


def _jackson(M):
    """Jackson kernel g_m, m < M (Weisse et al., Rev. Mod. Phys. 78, 275
    (2006))."""
    m = np.arange(M)
    Mp = M + 1.0
    return ((Mp - m) * np.cos(np.pi * m / Mp) + np.sin(np.pi * m / Mp) / np.tan(np.pi / Mp)) / Mp


def _chebyshev_density(mu, a, b, lo, hi, energies, n_energies):
    """Jackson-damped KPM reconstruction ``sum_m w_m g_m mu_m T_m(e) /
    (pi sqrt(1 - e^2) a)`` on host, zero outside the rescaled window;
    ``mu`` is (M,) or (M, nprobe).  Returns (energies, density) with
    density (nE,) or (nprobe, nE)."""
    M = mu.shape[0]
    if energies is None:
        energies = np.linspace(lo, hi, int(n_energies))
    energies = np.asarray(energies, dtype=np.float64)
    et_raw = (energies - b) / a
    inside = np.abs(et_raw) < 1.0 - 1e-12  # outside the window the density is 0
    et = np.clip(et_raw, -1.0 + 1e-12, 1.0 - 1e-12)
    m_arr = np.arange(M)
    tm = np.cos(m_arr[None, :] * np.arccos(et)[:, None])  # (nE, M)
    w = np.full(M, 2.0)
    w[0] = 1.0
    dens = (tm * (w * _jackson(M))[None, :]) @ mu  # (nE,) or (nE, nprobe)
    dens = dens.T / (np.pi * np.sqrt(1.0 - et**2)) / a
    return energies, np.where(inside, dens, 0.0)


def kpm_dos(model, energies=None, num_moments=512, num_vectors=8, n_energies=401, seed=0):
    """Density of states of a FINITE model by the kernel polynomial
    method (stochastic Chebyshev expansion with the Jackson kernel).

    Needs only ``num_moments/2`` Hamiltonian applications per random
    vector and no diagonalization.  The moment recursion over the ELL
    tables (:mod:`pythtb_tpu_torch.ops.matvec`) is one call of kernel 9,
    with the doubling identities ``mu_{2m} = 2<T_m|T_m> - mu_0`` and
    ``mu_{2m+1} = 2<T_{m+1}|T_m> - mu_1``.

    :param energies: energy grid (default: Gershgorin window,
      ``n_energies`` points)
    :param num_moments: Chebyshev moments (resolution ~ spectral width
      / num_moments; Jackson-kernel broadening)
    :param num_vectors: random-phase vectors for the stochastic trace
      (relative error ~ 1/sqrt(num_vectors * norb)), drawn by
      :func:`pythtb_tpu_torch.ops.chebyshev.phase_vectors` from ``seed``
    :returns: ``(energies, dos)`` with ``sum(dos) * dE ~ norb * nspin``
    """
    from .ops.matvec import gershgorin_window, sparse_h

    h = sparse_h(model)
    lo, hi = gershgorin_window(h)
    a = 0.5 * (hi - lo) / 0.98 + 1e-12  # keep the spectrum inside (-0.98, 0.98)
    b = 0.5 * (hi + lo)
    x0 = chebyshev.phase_vectors(h.nsta, num_vectors, seed, h.device)
    mu = _kpm_moments(h, a, b, x0, int(num_moments)).cpu().numpy()
    return _chebyshev_density(mu, a, b, lo, hi, energies, n_energies)


# ---------------------------------------------------------------------------
# Matrix-free solvers for large finite models
# ---------------------------------------------------------------------------


def _hmat(h, V):
    """H @ V for an (nsta, B) block: one launch of kernel 8 on the card."""
    from .ops.matvec import apply_rows

    return apply_rows(h, V, torch.empty_like(V))


def solve_lowest(model, num_states, eig_vectors=False, max_iters=300, tol=None, seed=0):
    """Lowest ``num_states`` eigenpairs of a FINITE model, matrix-free.

    Block LOBPCG on the hopping table (O(nhop) memory, O(nhop *
    num_states) per iteration): the top eigenpairs of the spectrum-
    reversed ``sigma * I - H`` (Gershgorin shift) by the complex LOBPCG of
    :mod:`pythtb_tpu_torch.ops.lobpcg`, every application of H one
    launch of kernel 8.  The complex LOBPCG returns k orthonormal Ritz
    vectors with their Rayleigh-Ritz values, so the JAX package's post
    step (an SVD and a second Rayleigh-Ritz solve, which shrink its real
    embedding's doubled block) has no counterpart here.

    :param num_states: how many lowest states (needs ``10 * num_states <
      norb * nspin``)
    :param eig_vectors: also return eigenvectors
    :param max_iters: LOBPCG iteration cap
    :param tol: LOBPCG residual tolerance (None = float64 epsilon; see
      :func:`pythtb_tpu_torch.ops.lobpcg.lobpcg_standard`)
    :param seed: seed of the random starting block, drawn on the host with
      ``torch.Generator().manual_seed(seed)`` (the JAX package draws with
      ``jax.random``: other numbers)
    :returns: ``evals (num_states,)`` ascending, and with
      ``eig_vectors=True`` also ``evecs`` in solve_all layout
      ``(num_states, norb)`` or ``(num_states, norb, 2)``

    Caveat: if the cut at ``num_states`` falls inside a degenerate
    multiplet, which members are returned is arbitrary.
    """
    from .ops.lobpcg import lobpcg_standard
    from .ops.matvec import gershgorin_window, sparse_h

    h = sparse_h(model)
    N = h.nsta
    k = int(num_states)
    if k < 1:
        raise ValueError("num_states must be >= 1")
    if 10 * k >= N:
        raise ValueError("solve_lowest needs 10*num_states < %d states; use solve_all for small models" % N)
    lo, hi = gershgorin_window(h)
    sigma = hi + 0.01 * (hi - lo) + 1e-12

    def amat(V):
        return sigma * V - _hmat(h, V)

    gen = torch.Generator().manual_seed(int(seed))
    X0 = torch.complex(torch.randn((N, k), dtype=config.FLOAT, generator=gen),
                       torch.randn((N, k), dtype=config.FLOAT, generator=gen)).to(h.device)
    theta, V, _ = lobpcg_standard(amat, X0, m=int(max_iters), tol=tol)
    # the Ritz pairs of sigma - H, descending, are those of H ascending
    w = (sigma - theta).cpu().numpy().astype(np.float64)
    if not eig_vectors:
        return w
    vecs = V.T.cpu().numpy()
    if h.nspin == 2:
        vecs = vecs.reshape(k, h.norb, 2)
    return w, vecs


def _window_round(h, X, coef, ab):
    """One Chebyshev-filter + Rayleigh-Ritz round of the spectrum-slice
    solver (``_window_round_jit``): the filter is one call of kernel 11,
    H Q one launch of kernel 8; the whitening is an eigh-based inverse
    square root of the Gram matrix, whose rank-deficient columns are
    dropped and flagged.

    Returns (theta, Z, res, valid): Ritz values, the Ritz block (N, nb),
    per-column residual norms ||H z - theta z||, and the mask of
    numerically independent columns (dropped ones carry 1e30)."""
    Y = chebyshev.filter(h, ab, coef, X)
    G = Y.conj().T @ Y
    s, V = torch.linalg.eigh(0.5 * (G + G.conj().T))  # ascending
    smax = torch.clamp(s[-1], min=1e-300)
    valid = s > 100.0 * torch.finfo(s.dtype).eps * smax
    inv_sqrt = torch.where(valid, 1.0 / torch.sqrt(torch.where(valid, s, torch.ones_like(s))),
                           torch.zeros_like(s))
    Q = Y @ (V * inv_sqrt[None, :])
    # Rayleigh-Ritz on the unmapped H (true eigenvalues)
    HQ = _hmat(h, Q)
    Hk = Q.conj().T @ HQ
    Hk = 0.5 * (Hk + Hk.conj().T)
    # dropped columns are zero vectors: a huge diagonal sorts their Ritz
    # values far from any physical sigma
    big = 1e30
    Hk = Hk + torch.diag(torch.where(valid, torch.zeros_like(s), torch.full_like(s, big)).to(Hk.dtype))
    theta, S = torch.linalg.eigh(Hk)
    Z = Q @ S
    R = HQ @ S - Z * theta[None, :]
    nrm = torch.linalg.vector_norm(Z, dim=0)
    res = torch.linalg.vector_norm(R, dim=0) / torch.clamp(nrm, min=1e-30)
    col_valid = nrm > 0.5  # whitened+rotated live columns have norm 1
    theta = torch.where(col_valid, theta, big)
    res = torch.where(col_valid, res, big)
    return theta, Z, res, col_valid


def _gaussian_cheb_coef(sigma_hat, width_hat, degree):
    """Chebyshev coefficients of the Gaussian window
    exp(-(x - sigma_hat)^2 / (2 width_hat^2)) on [-1, 1] by Gauss-Chebyshev
    quadrature (host float64).  The Gaussian is entire, so the
    coefficients decay superexponentially once m > ~2/width_hat -- no
    damping kernel is needed."""
    M = int(degree)
    nq = 2 * (M + 1)
    theta = (np.arange(nq) + 0.5) * np.pi / nq
    x = np.cos(theta)
    g = np.exp(-((x - sigma_hat) ** 2) / (2.0 * width_hat**2))
    m = np.arange(M)
    c = (2.0 / nq) * (np.cos(m[:, None] * theta[None, :]) @ g)
    c[0] *= 0.5
    return c


def solve_window(model, num_states, sigma, k_point=None, width=None, degree=None, block=None,
                 max_rounds=10, tol=None, eig_vectors=False, seed=0):
    """The ``num_states`` eigenpairs NEAREST ``sigma`` (an interior
    spectrum slice), matrix-free: Chebyshev-filtered subspace iteration on
    the hopping table.

    A Gaussian spectral filter ``exp(-(H - sigma)^2 / 2 width^2)``,
    expanded in Chebyshev polynomials and applied by kernel 11, acts on a
    random block, then Rayleigh-Ritz; each round multiplies the filter's
    discrimination, so a handful of rounds converges interior states
    without ever forming H.  Works for FINITE models (``dim_k == 0``) and
    for PERIODIC models at a fixed ``k_point``
    (:func:`pythtb_tpu_torch.ops.matvec.sparse_h_k`, Convention I, so
    eigenvectors match ``solve_all``'s gauge).

    :param num_states: how many eigenpairs nearest ``sigma``
    :param sigma: target energy
    :param k_point: reduced k for a periodic model (None for finite)
    :param width: Gaussian filter width in energy units.  Default is
      ADAPTIVE: a wide probe round first (span/20), then after each round
      the width tightens to one third of the distance from ``sigma`` to
      the block-edge Ritz value.  Pass an explicit width to pin it.
    :param degree: cap on the Chebyshev degree (default 6144); the working
      degree is ``4 a / width`` with ``a`` the half-span, rounded up to a
      multiple of 16
    :param block: subspace dimension (default ``num_states + max(6,
      num_states)``); must exceed ``num_states``
    :param max_rounds: filter+Rayleigh-Ritz rounds before giving up
    :param tol: relative residual target on the selected states (default
      ``sqrt(eps)`` of float64)
    :param eig_vectors: also return eigenvectors (solve_all layout)
    :param seed: seed of the starting block, drawn with
      ``np.random.default_rng(seed)`` exactly as the JAX package draws it
    :returns: ``evals (num_states,)`` ascending (and ``evecs``
      ``(num_states, norb[, 2])`` with ``eig_vectors=True``)

    A ``UserWarning`` reports the worst residual if ``max_rounds`` is
    exhausted before ``tol`` is met.
    """
    from .ops.matvec import gershgorin_window, sparse_h, sparse_h_k

    h = sparse_h(model) if k_point is None else sparse_h_k(model, k_point)
    N = h.nsta
    kk = int(num_states)
    if kk < 1:
        raise ValueError("num_states must be >= 1")
    if int(max_rounds) < 1:
        raise ValueError("max_rounds must be >= 1")
    nb = int(block) if block is not None else kk + max(6, kk)
    if nb <= kk:
        raise ValueError("block must exceed num_states")
    if nb >= N:
        raise ValueError("solve_window needs block < %d states; use solve_all for small models" % N)
    lo, hi = gershgorin_window(h)
    a = 0.5 * (hi - lo) / 0.98 + 1e-12
    b = 0.5 * (hi + lo)
    sigma = float(sigma)
    if not (lo <= sigma <= hi):
        raise ValueError("sigma=%g outside the spectral window (%g, %g)" % (sigma, lo, hi))
    adaptive = width is None
    w = float(width) if width is not None else (hi - lo) / 20.0
    max_degree = int(degree) if degree is not None else 6144

    def _deg(wv):
        return int(min(max(np.ceil(4.0 * a / wv / 16.0) * 16, 32), max_degree))

    def _coef(wv):
        return torch.as_tensor(_gaussian_cheb_coef((sigma - b) / a, wv / a, _deg(wv)),
                               dtype=config.FLOAT).to(h.device)

    if tol is None:
        tol = float(np.sqrt(np.finfo(np.float64).eps))
    target = tol * max(abs(hi), abs(lo), 1.0)

    rng = np.random.default_rng(seed)
    X_ri = np.stack([rng.standard_normal((N, nb)), rng.standard_normal((N, nb))], axis=-1)
    X = torch.as_tensor(X_ri[..., 0] + 1j * X_ri[..., 1], dtype=config.COMPLEX).to(h.device)
    ab = torch.tensor([a, b], dtype=config.FLOAT, device=h.device)
    coef = _coef(w)
    worst = np.inf
    for _ in range(int(max_rounds)):
        theta, Z, res, _ = _window_round(h, X, coef, ab)
        theta_h = theta.cpu().numpy().astype(np.float64)
        res_h = res.cpu().numpy()
        dist = np.sort(np.abs(theta_h - sigma))
        dist = dist[dist < 1e29]  # drop rank-deficient sentinel columns
        order = np.argsort(np.abs(theta_h - sigma), kind="stable")[:kk]
        worst = float(np.max(res_h[order]))
        if worst < target:
            break
        X = Z  # re-filter the Ritz block
        if adaptive:
            # a third of the distance to the (nb-1)-th Ritz value: the
            # filter then passes the retained subspace and kills the rest
            d_edge = float(dist[min(nb - 1, len(dist) - 1)])
            w_new = max(d_edge / 3.0, (hi - lo) * 1e-9)
            if abs(w_new - w) > 0.2 * w:
                w = w_new
                coef = _coef(w)
    if not worst < target:
        warnings.warn(
            "solve_window: residual %.2e after %d rounds (target %.1e) "
            "-- increase max_rounds, degree, or width coverage" % (worst, int(max_rounds), target),
            UserWarning, stacklevel=2,
        )
    sel = np.sort(order)
    evals = theta_h[sel]
    if not eig_vectors:
        return evals
    vecs = Z[:, torch.as_tensor(sel, device=Z.device)].T.cpu().numpy()  # (kk, N)
    if h.nspin == 2:
        vecs = vecs.reshape(kk, h.norb, 2)
    return evals, vecs


def wilson_window(model, sigma, num_states, k_loop, berry_evals=False, **solve_kwargs):
    """Berry phase (or Wilson-loop eigenphases) of the ``num_states``
    manifold nearest ``sigma`` around an explicit k-loop, with the states
    at every loop point from the matrix-free :func:`solve_window`.

    The loop is a (L, dim_k) array whose last point equals the first plus
    an INTEGER reciprocal offset G; the closing overlap uses the
    periodic-gauge factors ``exp(-2j pi G . t_orb)``, and the sign
    convention matches ``wf_array.berry_phase``.  A near-singular link
    (|det O| < 0.5: the selected manifold changes character between
    adjacent loop points) is reported with a ``UserWarning``.

    :param sigma: target energy selecting the manifold at every point
    :param num_states: manifold dimension
    :param k_loop: (L, dim_k) reduced k-points; closed as above
    :param berry_evals: return the individual Wilson eigenphases
      (polar-unitarized product) instead of the total phase
    :param solve_kwargs: forwarded to :func:`solve_window`
    :returns: total Berry phase in (-pi, pi] (or (num_states,) sorted
      eigenphases with ``berry_evals``)
    """
    from .model import PythtbError

    k_loop = np.asarray(k_loop, dtype=np.float64)
    if k_loop.ndim != 2 or k_loop.shape[0] < 3:
        raise PythtbError("k_loop must be (L >= 3, dim_k)")
    G = k_loop[-1] - k_loop[0]
    if np.abs(G - np.round(G)).max() > 1e-8:
        raise PythtbError(
            "k_loop must close on itself modulo integer reciprocal vectors (last - first = %s)" % (G,))
    G = np.round(G).astype(int)

    vecs = []
    for kpt in k_loop[:-1]:
        _, v = solve_window(model, num_states, sigma, k_point=kpt, eig_vectors=True, **solve_kwargs)
        vecs.append(np.asarray(v).reshape(num_states, -1))
    lam = np.ones(vecs[0].shape[1], dtype=complex)
    phs = gauge_phases(model, range(model._dim_k))
    for d in range(model._dim_k):
        if G[d]:
            lam = lam * np.asarray(phs[d]) ** G[d]
    vecs.append(vecs[0] * lam[None, :])

    W = np.eye(num_states, dtype=complex)
    min_det = np.inf
    for j in range(len(vecs) - 1):
        O = np.conj(vecs[j]) @ vecs[j + 1].T
        min_det = min(min_det, abs(np.linalg.det(O)))
        W = W @ O
    if min_det < 0.5:
        warnings.warn(
            "wilson_window: near-singular link (|det O| = %.3f) -- the "
            "selected manifold changes character along the loop (a band "
            "crosses the selection window); the phase is not trustworthy "
            "there" % min_det,
            UserWarning, stacklevel=2,
        )
    if not berry_evals:
        return float(-np.angle(np.linalg.det(W)))
    U_, _s, Vh_ = np.linalg.svd(W)
    return np.sort(-np.angle(np.linalg.eigvals(U_ @ Vh_)))


def chern_window(model, sigma, num_states, nk=(12, 12), **solve_kwargs):
    """Chern number of the ``num_states`` manifold nearest ``sigma``, every
    grid point solved matrix-free by :func:`solve_window`: the standard
    plaquette Berry-flux construction on an (nk0, nk1) closed grid of
    slice states, the wrapped boundary rows in the package's periodic
    gauge.  A ``UserWarning`` reports the weakest link when the selected
    manifold changes character somewhere on the grid.

    :param nk: (nk0, nk1) grid
    :param solve_kwargs: forwarded to :func:`solve_window`
    :returns: float Chern number (sum of plaquette fluxes / 2 pi)
    """
    from .model import PythtbError

    if model._dim_k != 2:
        raise PythtbError("chern_window requires dim_k == 2")
    n0, n1 = (int(x) for x in nk)
    if min(n0, n1) < 3:
        raise PythtbError("nk must be >= 3 in both directions")
    kk = int(num_states)
    grid = np.empty((n0 + 1, n1 + 1), dtype=object)
    for i in range(n0):
        for j in range(n1):
            _, v = solve_window(model, kk, sigma, k_point=np.array([i / n0, j / n1]), eig_vectors=True,
                                **solve_kwargs)
            grid[i, j] = np.asarray(v).reshape(kk, -1)
    ph0, ph1 = (np.asarray(p) for p in gauge_phases(model, range(model._dim_k)))
    for j in range(n1):
        grid[n0, j] = grid[0, j] * ph0[None, :]
    for i in range(n0):
        grid[i, n1] = grid[i, 0] * ph1[None, :]
    grid[n0, n1] = grid[0, 0] * (ph0 * ph1)[None, :]

    def link(a, b):
        return np.linalg.det(np.conj(a) @ b.T)

    total = 0.0
    min_det = np.inf
    for i in range(n0):
        for j in range(n1):
            u1 = link(grid[i, j], grid[i + 1, j])
            u2 = link(grid[i + 1, j], grid[i + 1, j + 1])
            u3 = link(grid[i + 1, j + 1], grid[i, j + 1])
            u4 = link(grid[i, j + 1], grid[i, j])
            min_det = min(min_det, abs(u1), abs(u2), abs(u3), abs(u4))
            total += np.angle(u1 * u2 * u3 * u4)
    if min_det < 0.5:
        warnings.warn(
            "chern_window: near-singular link (|det O| = %.3f) -- a band "
            "crosses the selection window somewhere on the grid; the Chern "
            "number is not trustworthy" % min_det,
            UserWarning, stacklevel=2,
        )
    # orientation flip: the package-wide flux convention of chern_number
    return float(-total / (2.0 * np.pi))


# ---------------------------------------------------------------------------
# Berry-curvature sweeps and band-resolved response (velocity operators)
# ---------------------------------------------------------------------------


def _grid_inputs(model, nk, caller):
    n0, n1 = int(nk[0]), int(nk[1])
    data = model._get_finalized()
    if data.dim_k != 2:
        raise ValueError("%s requires a model with dim_k == 2" % caller)
    return data, (n0, n1), [_phase_tensor(model, d, data.device) for d in (0, 1)]


def _band_curvature_grid(data: BlochData, n0, n1, start, phases):
    """Shared engine of the Hall / Nernst / thermal Hall sweeps: solve the
    interior grid (kernels 1, 2), close it with the periodic gauge,
    per-band plaquette fluxes (kernels 3, 4 at S 1, individual).  Returns
    (om (nsta, n0-1, n1-1), E (nsta, n0-1, n1-1))."""
    kpts = device_uniform_grid((n0 - 1, n1 - 1), start, data.device)
    evals, v = eigh_batched(assemble(data, kpts))
    w = v.reshape(n0 - 1, n1 - 1, data.nsta, data.nsta)
    w = extend_pbc_seq(w, phases)
    wb = torch.movedim(w, 2, 0)[..., None, :].contiguous()  # (nsta, n0, n1, 1, F)
    om = plaquette_flux(*_plane_link_dets(wb), individual=True)[0]
    E = evals.reshape(n0 - 1, n1 - 1, data.nsta).permute(2, 0, 1)
    return om, E


def _curvature_sweep(model, nk, start_k, caller, mus, kt, kind):
    """Sum over (band, k) of the per-band curvature / 2 pi weighted by
    ``kind`` at each chemical potential (kernel 17).  Returns the (nmu,)
    sums and the energies E (nsta, n0-1, n1-1)."""
    data, (n0, n1), phases = _grid_inputs(model, nk, caller)
    om, E = _band_curvature_grid(data, n0, n1, np.asarray(start_k, dtype=np.float64), phases)
    mus_t = torch.as_tensor(np.asarray(mus, dtype=np.float64)).to(data.device)
    G = (om / (2.0 * np.pi)).reshape(1, -1).contiguous()
    out = fermi_sweep(E.reshape(-1).contiguous(), G, mus_t, kt, kind)[:, 0]
    return out, E, mus_t


def anomalous_hall(model, fermi_levels, nk=(101, 101), start_k=(-0.5, -0.5), temperature=0.0):
    """Intrinsic anomalous Hall conductivity sigma_xy(E_F) in units of
    e^2/h from the band-resolved Berry curvature (counterpart of
    ``pythtb_tpu.flows.anomalous_hall``): per-band plaquette fluxes on the
    device, then the whole Fermi-level sweep in one launch of kernel 17
    (T = 0 step, or Fermi-Dirac at ``temperature`` > 0).  Warns at T = 0
    when E_F passes through a band degeneracy at a grid point.

    :returns: sigma_xy float array (nef,) -- scalar input gives a float
    """
    efs = np.atleast_1d(np.asarray(fermi_levels, dtype=np.float64))
    kt = float(temperature)
    out, E, efs_t = _curvature_sweep(model, nk, start_k, "anomalous_hall", efs, kt,
                                     "fermi" if kt > 0.0 else "step")
    out = out.cpu().numpy().astype(np.float64)
    if kt == 0.0 and E.shape[0] > 1:
        # E_F through a degeneracy at a grid point: the occupation factor
        # splits degenerate partners and the per-band curvature there is
        # basis-arbitrary
        tol = 100.0 * np.sqrt(np.finfo(np.float64).eps) * max(float(E.abs().max()), 1.0)
        gap = E[1:] - E[:-1]
        ef = efs_t[:, None, None, None]
        near = (gap[None] < tol) & (E[None, :-1] <= ef + tol) & (E[None, 1:] >= ef - tol)
        flagged = near.flatten(1).any(dim=1).cpu().numpy()
        if flagged.any():
            warnings.warn(
                "anomalous_hall: E_F = %s passes through a band degeneracy at "
                "a grid point -- the occupation factor splits degenerate "
                "partners there and the band-resolved curvature is "
                "basis-arbitrary. Shift the grid origin or E_F." % efs[flagged].tolist(),
                UserWarning, stacklevel=2,
            )
    return float(out[0]) if np.ndim(fermi_levels) == 0 else out


def anomalous_nernst(model, mu, temperature, nk=(101, 101), start_k=(-0.5, -0.5)):
    """Intrinsic anomalous Nernst coefficient alpha_xy(mu, T) in units of
    e k_B / h: the entropy-weighted band-resolved Berry curvature
    (counterpart of ``pythtb_tpu.flows.anomalous_nernst``), the mu sweep
    in one launch of kernel 17.

    :returns: float array (nmu,) -- scalar input gives a float
    """
    if float(temperature) <= 0.0:
        raise ValueError("anomalous_nernst requires temperature > 0")
    out, _, _ = _curvature_sweep(model, nk, start_k, "anomalous_nernst", np.atleast_1d(mu),
                                 float(temperature), "entropy")
    out = out.cpu().numpy().astype(np.float64)
    return float(out[0]) if np.ndim(mu) == 0 else out


def thermal_hall(model, mu, temperature, nk=(101, 101), start_k=(-0.5, -0.5)):
    """Intrinsic electronic thermal Hall conductivity kappa_xy(mu, T) in
    units of k_B^2 T / h: the c2-weighted band-resolved Berry curvature
    (counterpart of ``pythtb_tpu.flows.thermal_hall``; the weight is
    :func:`pythtb_tpu_torch.ops.fermi_sweep.c2_weight`), the mu sweep in
    one launch of kernel 17.

    :returns: float array (nmu,) -- scalar input gives a float
    """
    if float(temperature) <= 0.0:
        raise ValueError("thermal_hall requires temperature > 0")
    out, _, _ = _curvature_sweep(model, nk, start_k, "thermal_hall", np.atleast_1d(mu),
                                 float(temperature), "c2")
    out = out.cpu().numpy().astype(np.float64)
    return float(out[0]) if np.ndim(mu) == 0 else out


def _grid_2d(model, caller, nk):
    data = model._get_finalized()
    if data.dim_k != 2 or model._dim_r != 2:
        raise ValueError("%s requires a fully periodic 2-D model" % caller)
    nk = tuple(int(x) for x in np.atleast_1d(nk))
    if len(nk) != 2:
        raise ValueError("nk must give two grid sizes")
    return data, nk, np.asarray(model._lat, dtype=np.float64)


def berry_dipole(model, mu, temperature, nk=(101, 101)):
    """Berry-curvature dipole D_a(mu, T) of a 2-D metal (counterpart of
    ``pythtb_tpu.flows.berry_dipole``): the analytic per-band curvature
    and the group velocities from the velocity matrices (kernel 15), the
    Fermi-surface sum over the mu batch in one launch of kernel 17.

    :returns: (nmu, 2) array of (D_x, D_y) -- scalar mu gives (2,)
    """
    if float(temperature) <= 0.0:
        raise ValueError("berry_dipole requires temperature > 0")
    data, nk, lat = _grid_2d(model, "berry_dipole", nk)
    mus = np.atleast_1d(np.asarray(mu, dtype=np.float64))
    evals, _vecs, V, _ = _band_tensors(data, nk, lat, need_d2=False)
    inv2 = _inv_gaps(evals, 1e-7)[1] ** 2  # 1 / (e_n - e_m)^2 off degeneracies
    om = -2.0 * torch.einsum("bnm,bnm,bnm->bn", V[:, 0], V[:, 1].conj(), inv2.to(V.dtype)).imag
    Vd = torch.diagonal(V, dim1=-2, dim2=-1).real  # (B, d, S)
    norm = 1.0 / float(np.prod(nk))
    G = (Vd * om[:, None, :] * norm).permute(1, 0, 2).reshape(2, -1).contiguous()
    mus_t = torch.as_tensor(mus).to(data.device)
    out = fermi_sweep(evals.reshape(-1).contiguous(), G, mus_t, float(temperature), "dfde_cosh")
    out = out.cpu().numpy().astype(np.float64) / abs(np.linalg.det(lat))
    return out[0] if np.ndim(mu) == 0 else out


def spin_hall_conductivity(model, occ, nk=(101, 101)):
    """Intrinsic spin Hall conductivity of a 2-D spinful insulator from the
    Kubo spin Berry curvature (counterpart of
    ``pythtb_tpu.flows.spin_hall_conductivity``), normalized so that an
    s_z-conserving model gives the integer C_up - C_dn.  The velocity
    matrices come from kernel 15; the band contractions are torch.

    :returns: float
    """
    data, nk, lat = _grid_2d(model, "spin_hall_conductivity", nk)
    if data.nspin != 2:
        raise ValueError("spin_hall_conductivity requires a spinful model")
    occ = tuple(int(o) for o in np.atleast_1d(occ))
    if len(set(occ)) != len(occ) or any(not (0 <= o < data.nsta) for o in occ):
        raise ValueError("occ must be distinct band indices")
    evals, vecs, V, _ = _band_tensors(data, nk, lat, need_d2=False)
    sz = torch.as_tensor(np.tile([1.0, -1.0], data.norb), dtype=config.COMPLEX).to(data.device)
    Szb = torch.einsum("bns,s,bms->bnm", vecs.conj(), sz, vecs)
    Jx = 0.5 * (V[:, 0] @ Szb + Szb @ V[:, 0])
    inv2 = _inv_gaps(evals, 1e-7)[1] ** 2
    om_sz = -2.0 * torch.einsum("bnm,bnm,bnm->bn", Jx, V[:, 1].conj(), inv2.to(V.dtype)).imag
    occ_idx = torch.as_tensor(occ, device=data.device)
    vol = abs(np.linalg.det(lat))
    return float(om_sz[:, occ_idx].sum()) * (2.0 * np.pi) / (float(np.prod(nk)) * vol)


def orbital_magnetization(model, occ, nk=(61, 61), mu=None):
    """Orbital magnetization of a 2-D insulator (modern theory; counterpart
    of ``pythtb_tpu.flows.orbital_magnetization``): the k-space band sum
    of Im <n|dH/dk_1|m><m|dH/dk_2|n> (e_n + e_m - 2 mu) / (e_n - e_m)^2
    over occupied n and empty m, with dH/dk from kernel 15.  M is linear
    in mu, so one device pass serves any mu (default midgap).

    :returns: float M per unit cell
    """
    data = model._get_finalized()
    if data.dim_k != 2:
        raise ValueError("orbital_magnetization requires dim_k == 2")
    occ = tuple(sorted(int(o) for o in occ))
    if not occ or min(occ) < 0 or max(occ) >= data.nsta:
        raise IndexError("occ indices %s out of range for %d states" % (occ, data.nsta))
    if len(occ) == data.nsta:
        raise ValueError("orbital_magnetization needs at least one empty band")
    n0, n1 = (int(nk), int(nk)) if np.isscalar(nk) else (int(nk[0]), int(nk[1]))
    dev = data.device
    kpts = device_uniform_grid((n0, n1), (0.0, 0.0), dev)
    evals, vecs = eigh_batched(assemble(data, kpts))
    dH = assemble_dk(data, kpts)  # (B, 2, S, S)
    occ_idx = torch.as_tensor(occ, device=dev)
    unocc_idx = torch.as_tensor([s for s in range(data.nsta) if s not in occ], device=dev)
    uo, uu = vecs[:, occ_idx], vecs[:, unocc_idx]
    eo, eu = evals[:, occ_idx], evals[:, unocc_idx]
    V = torch.einsum("bns,bast,bmt->banm", uo.conj(), dH, uu)  # (B, 2, no, nu)
    de = eo[:, :, None] - eu[:, None, :]
    VV = V[:, 0] * V[:, 1].conj()
    w0 = (eo[:, :, None] + eu[:, None, :]) / (de * de)
    w1 = -2.0 / (de * de)
    norm = 4.0 * np.pi**2 * kpts.shape[0]
    M0 = float(torch.sum(VV * w0).imag) / norm
    dMdmu = float(torch.sum(VV * w1).imag) / norm
    emax_occ, emin_unocc = float(eo.max()), float(eu.min())
    if mu is None:
        mu = 0.5 * (emax_occ + emin_unocc)
    M = M0 + float(mu) * dMdmu
    if not emax_occ < mu < emin_unocc:
        warnings.warn(
            "orbital_magnetization: mu=%.6g is not inside the band gap of "
            "the chosen occupation (occupied max %.6g, unoccupied min "
            "%.6g); the insulating formula does not apply." % (mu, emax_occ, emin_unocc),
            UserWarning, stacklevel=2,
        )
    return float(M)


# ---------------------------------------------------------------------------
# Spectra and band-resolved quantities
# ---------------------------------------------------------------------------


def _grid_dos(model, k_mesh, energies, sigma, n_energies, projected):
    """Gaussian-broadened (P)DOS on the Gamma-inclusive device grid: the
    levels of kernels 1 and 2 (or 7), broadened by kernel 16's Gaussian
    mode, whose 1/(sigma sqrt(2 pi)) norm is the only one applied; the
    1/B k-average rides on the weights.  Returns NumPy (e_grid, dos (nE,)
    or pdos (nE, norb))."""
    from .optical import spectral_sum

    data = model._get_finalized()
    if data.dim_k == 0 or len(k_mesh) != data.dim_k:
        raise ValueError("k_mesh must give one size per periodic direction")
    mesh_shape = tuple(int(n) for n in k_mesh)
    if energies is None:
        probe = model.solve_all(model.k_uniform_mesh([max(4, n // 4) for n in mesh_shape]))
        energies = (probe.min() - 3.0 * sigma, probe.max() + 3.0 * sigma)
    erange = np.asarray(energies, dtype=np.float64)
    e_grid = np.linspace(erange[0], erange[1], int(n_energies))
    dev = data.device
    kpts = device_uniform_grid(mesh_shape, np.zeros(data.dim_k), dev)
    B = kpts.shape[0]
    H = assemble(data, kpts)
    if projected:
        evals, v = eigh_batched(H)  # rows are states
        wts = v.abs() ** 2  # (B, nsta, F)
        if data.nspin == 2:
            wts = wts.reshape(B, data.nsta, data.norb, 2).sum(-1)
        W = (wts.reshape(-1, data.norb).T / B).contiguous()  # (norb, B nsta)
    else:
        evals = eigvalsh_batched(H)
        W = torch.full((1, evals.numel()), 1.0 / B, dtype=config.FLOAT, device=dev)
    out = spectral_sum(W, evals.reshape(-1).contiguous(), torch.as_tensor(e_grid).to(dev), float(sigma), "gauss")
    out = out.cpu().numpy().astype(np.float64)
    return e_grid, (out.T if projected else out[0])


def density_of_states(model, k_mesh, energies=None, sigma=0.1, n_energies=201):
    """Gaussian-broadened density of states on the device (counterpart of
    ``pythtb_tpu.flows.density_of_states``).

    :param k_mesh: per-periodic-direction mesh sizes (Gamma-inclusive
      uniform mesh, built on the device)
    :param energies: (emin, emax) energy window; defaults to the band
      range padded by 3 sigma
    :param sigma: Gaussian broadening width
    :returns: (energy_grid, dos) with dos normalized to states per unit
      cell (integrates to norb*nspin)
    """
    return _grid_dos(model, k_mesh, energies, sigma, n_energies, False)


def projected_dos(model, k_mesh, energies=None, sigma=0.1, n_energies=201):
    """Orbital-projected (Gaussian-broadened) density of states:
    ``pdos[e, orb] = sum_kn |u_nk[orb]|^2 g(e - E_nk)`` (spin components
    summed for nspin=2), one launch of kernel 16 with a row per orbital.
    Returns (energy_grid, pdos (nE, norb))."""
    return _grid_dos(model, k_mesh, energies, sigma, n_energies, True)


def band_velocities(model, k_list):
    """Band group velocities dE_n/dk at each k-point by Hellmann-Feynman,
    diag(U^H dH/dk U), with dH/dk from kernel 15 (the JAX package
    differentiates through the eigensolver: the same derivative away from
    band crossings, where neither is defined).

    :param k_list: (nkp, dim_k) reduced k-points
    :returns: (vels, evals) with vels[band, kpt, dir] = dE/dk in reduced
      coordinates and evals[band, kpt] as in solve_all.
    """
    data = model._get_finalized()
    if data.dim_k == 0:
        raise ValueError("band velocities require a periodic model")
    kpts = np.asarray(k_list, dtype=np.float64)
    if kpts.ndim == 1:
        kpts = kpts[:, None] if data.dim_k == 1 else kpts[None, :]
    k = torch.as_tensor(np.ascontiguousarray(kpts)).to(data.device)
    evals, v = eigh_batched(assemble(data, k))  # rows are states
    vel = torch.einsum("bns,bast,bnt->nba", v.conj(), assemble_dk(data, k), v).real
    return vel.cpu().numpy().astype(np.float64), evals.T.cpu().numpy().astype(np.float64)


def spin_texture(model, bands, k_list):
    """Spin expectation values ``<S_a>_n(k) = <psi_n| sigma_a (x) 1
    |psi_n>`` (units of hbar/2) for a batch of k-points and bands.  Warns
    where a requested band is within 1e-8 of a neighbour (per-band spin is
    basis-arbitrary there).

    :param bands: band indices
    :param k_list: (B, dim_k) reduced k-points
    :returns: (B, nb, 3) float array
    """
    from .model import PythtbError

    data = model._get_finalized()
    if data.nspin != 2:
        raise PythtbError("spin_texture requires a spinful model")
    bands = tuple(int(b) for b in np.atleast_1d(bands))
    if len(bands) == 0 or min(bands) < 0 or max(bands) >= data.nsta:
        raise PythtbError("bands out of range")
    kpts = np.asarray(k_list, dtype=np.float64)
    if kpts.ndim != 2 or kpts.shape[1] != data.dim_k:
        raise PythtbError("k_list must be (B, %d)" % data.dim_k)
    k = torch.as_tensor(np.ascontiguousarray(kpts)).to(data.device)
    evals, vecs = eigh_batched(assemble(data, k))
    bidx = torch.as_tensor(bands, device=data.device)
    D = (evals[:, :, None] - evals[:, None, :]).abs()
    D = D + torch.eye(data.nsta, dtype=config.FLOAT, device=data.device)[None] * 1e30
    mingap = float(D.amin(dim=-1)[:, bidx].min())
    v = vecs[:, bidx, :]
    vv = v.reshape(v.shape[0], v.shape[1], data.norb, 2)  # spin fastest
    up, dn = vv[..., 0], vv[..., 1]
    ud = torch.einsum("bno,bno->bn", up.conj(), dn)
    sz = (up.abs() ** 2).sum(-1) - (dn.abs() ** 2).sum(-1)
    out = torch.stack([2.0 * ud.real, 2.0 * ud.imag, sz], dim=-1)
    if mingap < 1e-8:
        warnings.warn(
            "spin_texture: a requested band is within %.1e of a "
            "neighbor somewhere in the batch -- per-band spin "
            "expectations are basis-arbitrary at (near-)degenerate "
            "k-points (Kramers points of TRS models); only degenerate-"
            "subspace sums are well-defined there." % mingap,
            UserWarning, stacklevel=2,
        )
    return out.cpu().numpy().astype(np.float64)


# ---------------------------------------------------------------------------
# Nested Wilson loops, sector and valley Chern numbers
# ---------------------------------------------------------------------------


def _nested_wilson(data, occ, n0, n1, nest_dir, start, phases):
    """Wannier-sector polarizations by nested Wilson loops (Benalcazar,
    Bernevig & Hughes, PRB 96, 245115 (2017), Sec. VI), as
    ``pythtb_tpu.flows._nested_wilson_jit``: Wilson loops wind along grid
    axis 1, the nested loop along axis 0 (``nest_dir`` 1 transposes).  The
    polar factor of every link is kernel 5 on two-point strings (one
    launch); their running products C_j = W_0 ... W_j are batched torch
    matmuls; the eigenvectors of the whole loop come from ``unitary_eig``.
    Returns (p (nsec, ny-1) in [0, 1), min Wannier gap, min link singular
    value)."""
    from .ops.berry import unitary_eig

    kpts = device_uniform_grid((n0 - 1, n1 - 1), start, data.device)
    w = _solve_grid_states(data, kpts, occ, n0, n1)  # (n0-1, n1-1, S, F)
    p_loop, p_nest = phases[1], phases[0]
    if nest_dir == 1:
        w = w.transpose(0, 1)
        p_loop, p_nest = p_nest, p_loop
    w = torch.cat([w, w[:, :1] * p_loop], dim=1)  # close the loop axis
    nx, ny, S, F = w.shape
    links = torch.stack([w[:, :-1], w[:, 1:]], dim=2).contiguous()  # (nx, ny-1, 2, S, F)
    Wl, smin = wilson_loop(links, 2)  # polar factor of each link
    C = [Wl[:, 0]]
    for j in range(1, ny - 1):
        C.append(C[-1] @ Wl[:, j])
    theta, P = unitary_eig(C[-1])  # the whole loop based at 0
    order = torch.argsort(theta, dim=-1)
    theta = torch.take_along_dim(theta, order, dim=-1)
    P = torch.take_along_dim(P, order[:, None, :], dim=-1)
    gaps = torch.cat([theta[:, 1:] - theta[:, :-1], (2.0 * np.pi - (theta[:, -1] - theta[:, 0]))[:, None]], dim=-1)
    # eigenvectors of the loop based at j: nu_j = C_{j-1}^H P (identity at 0)
    eye = torch.eye(S, dtype=config.COMPLEX, device=w.device).expand(nx, S, S)
    Cfull = torch.stack([eye] + C[:-1], dim=1)  # (nx, ny-1, S, S)
    nu = torch.einsum("xjmn,xms->xjns", Cfull.conj(), P)
    ws = torch.einsum("xjnf,xjns->xjsf", w[:, :-1], nu)  # Wannier-band basis, rows = sector
    ws = extend_pbc_seq(ws, [p_nest])  # close the nested axis with the periodic gauge
    link = torch.einsum("xjsf,xjsf->xjs", ws[:-1].conj(), ws[1:])
    p = _wrap(-torch.angle(link).sum(dim=0)).T / (2.0 * np.pi)
    return torch.remainder(p, 1.0), float(gaps.min()), float(smin.amin())


def quadrupole(model, occ=(0, 1), nk=(31, 31), start_k=(0.0, 0.0)):
    """Wannier-sector polarizations and the quadrupole invariant by nested
    Wilson loops (Benalcazar-Bernevig-Hughes, PRB 96, 245115 (2017)).

    :param occ: occupied bands (even count; sectors = Wannier bands)
    :returns: dict with ``px``/``py`` ((nsec,) sector polarizations,
      circular means over base points), ``px_spread``/``py_spread``,
      ``qxy`` (2 px[0] py[0] mod 1), ``wannier_gap``
    """
    data, (n0, n1), phases = _grid_inputs(model, nk, "quadrupole")
    occ = _check_occ(occ, data.nsta)
    start = np.asarray(start_k, dtype=np.float64)
    out = {}
    for name, nest_dir in (("px", 0), ("py", 1)):
        p, wgap, sing = _nested_wilson(data, occ, n0, n1, nest_dir, start, phases)
        p = p.cpu().numpy().astype(np.float64)
        # circular mean over base points (values live on a circle)
        mean = np.mod(np.angle(np.exp(2j * np.pi * p).mean(axis=1)) / (2 * np.pi), 1.0)
        dev = np.abs(np.angle(np.exp(2j * np.pi * (p - mean[:, None])))).max() / (2 * np.pi)
        out[name] = mean
        out[name + "_spread"] = float(dev)
        out["wannier_gap"] = min(out.get("wannier_gap", np.inf), wgap)
        if sing < 1e-8:
            warnings.warn("quadrupole: (near-)singular Wilson links -- refine the grid.", UserWarning, stacklevel=2)
    out["qxy"] = float(np.mod(2.0 * out["px"][0] * out["py"][0], 1.0))
    return out


def _sector_chern(data, occ, n0, n1, split, start, phases, op):
    """Prodan sector Chern engine (PRB 80, 125327 (2009)): the projected
    operator P O P in the occupied space of every closed-grid point,
    diagonalized by ``eigh_batched`` (kernel 2 at two occupied bands), its
    lowest ``split`` and remaining eigenstates integrated as two sectors
    (kernels 3-4).  Returns (flux-, flux+, min projection gap at the split,
    max eigenvalue below it, min eigenvalue above it)."""
    kpts = device_uniform_grid((n0 - 1, n1 - 1), start, data.device)
    w = extend_pbc_seq(_solve_grid_states(data, kpts, occ, n0, n1), phases)  # (n0, n1, nocc, F)
    nocc = len(occ)
    M = torch.einsum("...nf,fg,...mg->...nm", w.conj(), op, w)
    ev, V = eigh_batched(M.reshape(-1, nocc, nocc).contiguous())  # V: rows are eigenstates
    ev = ev.reshape(n0, n1, nocc)
    ws = torch.einsum("...nf,...sn->...sf", w, V.reshape(n0, n1, nocc, nocc))
    fm = float(_total_flux(ws[..., :split, :])[0])
    fp = float(_total_flux(ws[..., split:, :])[0])
    gap = float((ev[..., split] - ev[..., split - 1]).min())
    return fm, fp, gap, float(ev[..., split - 1].max()), float(ev[..., split].min())


def sector_chern(model, occ, op, nk=(41, 41), start_k=(-0.5, -0.5), split=None):
    """Chern numbers of the eigensectors of a Hermitian, k-independent
    operator projected into the occupied space (the Prodan construction):
    ``op`` = the spin matrix gives the spin Chern number, ``op`` = i M for
    a spinful mirror M the mirror Chern number.  ``op`` acts in the
    flattened state space (orb x spin, spin fastest).

    :param occ: occupied band indices
    :param op: (nsta, nsta) Hermitian matrix (or a length-nsta diagonal)
    :param split: size of the lower-eigenvalue sector (default
      ``len(occ) // 2``); warns when the projected spectrum does not
      straddle zero there, or is gapless
    :returns: dict with ``sector_chern`` ((C+ - C-)/2), ``chern_plus``,
      ``chern_minus``, ``gap``
    """
    data, (n0, n1), phases = _grid_inputs(model, nk, "sector_chern")
    occ = tuple(int(o) for o in np.atleast_1d(occ))
    if len(occ) < 2:
        raise ValueError("sector_chern needs at least two occupied bands")
    if min(occ) < 0 or max(occ) >= data.nsta:
        raise IndexError("occ indices %s out of range for %d states" % (sorted(set(occ)), data.nsta))
    split = len(occ) // 2 if split is None else int(split)
    if not (1 <= split <= len(occ) - 1):
        raise ValueError("split must be in [1, %d]" % (len(occ) - 1))
    op = np.asarray(op, dtype=np.complex128)
    if op.ndim == 1:
        op = np.diag(op)
    if op.shape != (data.nsta, data.nsta):
        raise ValueError("op must be (%d, %d) (or a length-%d diagonal)" % (data.nsta, data.nsta, data.nsta))
    if np.abs(op - op.conj().T).max() > 1e-12:
        raise ValueError("op must be Hermitian (for a spinful mirror M with M^2 = -1, pass 1j * M)")
    fm, fp, gap, lo_max, hi_min = _sector_chern(data, occ, n0, n1, split, np.asarray(start_k, dtype=np.float64),
                                                phases, torch.as_tensor(op).to(data.device))
    cm, cp = fm / (2.0 * np.pi), fp / (2.0 * np.pi)
    if gap < 1e-3:
        warnings.warn(
            "sector_chern: the P O P spectrum is (nearly) gapless at the "
            "split (min gap %.2e) -- the sector Chern numbers are "
            "ill-defined for this model/operator/band choice." % gap,
            UserWarning, stacklevel=2,
        )
    elif not (lo_max < 0.0 < hi_min):
        warnings.warn(
            "sector_chern: the P O P spectrum does not straddle zero at "
            "the requested split (eigenvalues around it in [%.3f, %.3f]) "
            "-- the +- sector labels are arbitrary; check `split`." % (lo_max, hi_min),
            UserWarning, stacklevel=2,
        )
    return {"sector_chern": 0.5 * (cp - cm), "chern_plus": cp, "chern_minus": cm, "gap": gap}


def spin_chern(model, occ=(0, 1), nk=(41, 41), start_k=(-0.5, -0.5)):
    """Spin Chern number by the Prodan construction: :func:`sector_chern`
    with the spin matrix S_z (its warnings re-worded for P Sz P).

    :param occ: occupied bands (even count)
    :returns: dict with ``spin_chern`` ((C+ - C-)/2), ``chern_plus``,
      ``chern_minus``, ``sz_gap``
    """
    data = model._get_finalized()
    if data.dim_k != 2:
        raise ValueError("spin_chern requires a model with dim_k == 2")
    if data.nspin != 2:
        raise ValueError("spin_chern requires a spinful model (nspin=2)")
    occ = tuple(int(o) for o in occ)
    if len(occ) % 2 != 0 or len(occ) == 0:
        raise ValueError("spin_chern needs an even, nonempty set of occupied bands")
    sz = np.tile([1.0, -1.0], data.norb)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = sector_chern(model, occ, sz, nk=nk, start_k=start_k)
    for w in caught:
        msg = str(w.message).replace("sector_chern", "spin_chern").replace("P O P", "P Sz P")
        warnings.warn(msg, w.category, stacklevel=2)
    return {"spin_chern": out["sector_chern"], "chern_plus": out["chern_plus"],
            "chern_minus": out["chern_minus"], "sz_gap": out["gap"]}


def valley_chern(model, occ, valley_points, nk=(101, 101), start_k=(-0.5, -0.5)):
    """Valley-resolved Chern numbers: the occupied bands' plaquette fluxes
    (the per-band engine of the Hall sweeps, kernels 1-4) partitioned by
    the nearest valley in the reciprocal metric of the periodic lattice
    vectors (torus distance over the nine neighbour images), each basin
    integrated.  The valley values sum to the total Chern number exactly.

    :param occ: occupied bands
    :param valley_points: (nv, 2) reduced valley centres
    :returns: (nv,) float array
    """
    data, (n0, n1), phases = _grid_inputs(model, nk, "valley_chern")
    occ = tuple(int(o) for o in np.atleast_1d(occ))
    if len(occ) == 0 or min(occ) < 0 or max(occ) >= data.nsta:
        raise ValueError("occ out of range")
    vp = np.asarray(valley_points, dtype=np.float64)
    if vp.ndim != 2 or vp.shape[1] != 2 or len(vp) < 1:
        raise ValueError("valley_points must be (nv, 2) reduced points")
    start = np.asarray(start_k, dtype=np.float64)
    om, _ = _band_curvature_grid(data, n0, n1, start, phases)
    om_occ = om[torch.as_tensor(occ, device=data.device)].sum(dim=0).cpu().numpy().astype(np.float64)
    c0 = (np.arange(n0 - 1) + 0.5) / (n0 - 1) + start[0]
    c1 = (np.arange(n1 - 1) + 0.5) / (n1 - 1) + start[1]
    cc = np.stack(np.meshgrid(c0, c1, indexing="ij"), axis=-1)
    lat_per = np.asarray(model._lat, dtype=np.float64)[list(model._per)]
    k_metric = np.linalg.inv(lat_per @ lat_per.T)
    imgs = np.array([(i, j) for i in (-1, 0, 1) for j in (-1, 0, 1)])
    d2 = np.empty((len(vp),) + cc.shape[:2])
    for v, kv in enumerate(vp):
        dred = cc - kv[None, None, :]
        best = None
        for im in imgs:
            dk = dred + im[None, None, :]
            dd = np.einsum("ija,ab,ijb->ij", dk, k_metric, dk)
            best = dd if best is None else np.minimum(best, dd)
        d2[v] = best
    owner = np.argmin(d2, axis=0)
    return np.array([om_occ[owner == v].sum() / (2.0 * np.pi) for v in range(len(vp))])


# ---------------------------------------------------------------------------
# Inversion-parity indicators
# ---------------------------------------------------------------------------


def _inversion_partners(orb, c):
    """Partner map p(a), R_a with 2c - t_a = t_{p(a)} + R_a (the rule of
    ``pythtb_tpu.flows._inversion_partners``: the self-map preferred at
    inversion-fixed positions, coincident partners consumed from a pool)."""
    from .model import PythtbError

    norb, d = orb.shape
    p = np.full(norb, -1, dtype=np.int64)
    Ra = np.zeros((norb, d))
    available = set(range(norb))
    for a in range(norb):
        if p[a] >= 0:
            continue
        target = 2.0 * c - orb[a]
        diff = target[None, :] - orb
        Rcand = np.round(diff)
        hit = [int(b) for b in np.where(np.abs(diff - Rcand).max(axis=1) < 1e-8)[0] if b in available]
        if not hit:
            raise PythtbError("no inversion partner for orbital %d about center %s "
                              "-- wrong center or no inversion symmetry" % (a, c.tolist()))
        use = a if a in hit else hit[0]
        p[a] = use
        Ra[a] = Rcand[use]
        available.discard(a)
        if use != a:
            p[use] = a
            back = 2.0 * c - orb[use] - orb[a]
            Ra[use] = np.round(back)
            if np.abs(back - Ra[use]).max() > 1e-8:
                raise PythtbError("inversion partner mismatch for orbitals %d/%d" % (a, use))
            available.discard(use)
    return p, Ra


def _inversion_matrix(p, Ra, xi, k):
    """Convention-II inversion representation at reduced k:
    P_{p(a), a} = xi_a e^{2 pi i k . R_a} (orbital space only)."""
    norb = len(p)
    P = np.zeros((norb, norb), dtype=complex)
    P[p, np.arange(norb)] = xi * np.exp(2.0j * np.pi * (Ra @ np.asarray(k)))
    return P


def _verify_inversion(data, orb, spinful, P_of_k, c, tol, caller):
    """Vet the inversion representation: P H_II(-k) P^+ == H_II(k) at three
    random k (numpy default_rng(0), as the JAX package draws them)."""
    from .model import PythtbError

    def H_II(k):
        kt = torch.as_tensor(np.ascontiguousarray(np.asarray(k, dtype=np.float64)[None])).to(data.device)
        Hk = assemble(data, kt)[0].cpu().numpy()
        t = np.repeat(orb, 2, axis=0) if spinful else orb
        ph = np.exp(2.0j * np.pi * (t @ np.asarray(k)))
        return ph[:, None] * Hk * np.conj(ph)[None, :]

    rng = np.random.default_rng(0)
    for _ in range(3):
        k = rng.random(orb.shape[1])
        Pk = P_of_k(k)
        dev = np.abs(Pk @ H_II(-k) @ Pk.conj().T - H_II(k)).max()
        if dev > tol:
            raise PythtbError(
                "%s: model is not inversion symmetric about %s with "
                "the given orbital parities (|P H(-k) P^+ - H(k)| = "
                "%.2e).  Note coincident-orbital partners are paired "
                "greedily by position -- if your model's true partner "
                "map differs, relabel the orbitals so partners are "
                "geometrically distinct." % (caller, c.tolist(), dev)
            )


def _trim_parities(model, kap, occ, orb, P_of_k, tol, spinful, not_closed, not_quantized):
    """Inversion eigenvalues of the occupied states at the TRIM ``kap``:
    the Convention-II states of ``solve_one``, M = u^H P u, checked unitary
    and quantized."""
    from .model import PythtbError

    _, vec = model.solve_one(kap, eig_vectors=True)
    vec = np.atleast_2d(np.asarray(vec)).reshape(model._nsta, -1)
    t = np.repeat(orb, 2, axis=0) if spinful else orb
    uo = (vec * np.exp(2.0j * np.pi * (t @ kap))[None, :])[list(occ)]
    M = uo.conj() @ P_of_k(kap) @ uo.T
    if np.abs(M @ M.conj().T - np.eye(len(occ))).max() > 10.0 * tol:
        raise PythtbError(not_closed)
    xis = np.linalg.eigvalsh(0.5 * (M + M.conj().T))
    if np.abs(np.abs(xis) - 1.0).max() > 10.0 * tol:
        raise PythtbError(not_quantized)
    return xis


def _parity_setup(model, c, parity):
    """Orbital positions, inversion centre, parities and the verified
    partner map shared by :func:`parity_z2` and :func:`parity_polarization`."""
    from .model import PythtbError

    norb = model._norb
    orb = np.asarray(model._orb, dtype=np.float64)[:, model._per]
    xi = np.ones(norb) if parity is None else np.asarray(parity, dtype=np.float64)
    if xi.shape != (norb,) or np.abs(np.abs(xi) - 1.0).max() > 0:
        raise PythtbError("parity must give +-1 per orbital")
    p, Ra = _inversion_partners(orb, c)
    spinful = model._nspin == 2

    def P_of_k(k):
        P = _inversion_matrix(p, Ra, xi, k)
        return np.kron(P, np.eye(2)) if spinful else P  # spin untouched, spin-fastest

    return orb, P_of_k, spinful


def parity_z2(model, occ, center=None, parity=None, tol=1e-6):
    """Fu-Kane Z2 invariants from parity eigenvalues at the TRIMs (PRB 76,
    045302 (2007)).  The inversion operator is built from the geometry
    (orbital a at t_a maps to the orbital at 2c - t_a, up to a lattice
    vector R_a; intrinsic parities ``parity``) and verified numerically
    (P H(-k) P^+ == H(k), kernel 1) before any invariant is computed.

    :param occ: occupied bands (even count; Kramers pairs)
    :param center: inversion center in reduced coordinates (default 0)
    :param parity: per-orbital intrinsic parities (+-1; default all +1)
    :param tol: symmetry/quantization tolerance
    :returns: dict with ``nu0`` (strong index), ``delta`` ({TRIM: +-1}),
      and for dim_k == 3 ``weak`` (three 0/1 indices)
    """
    from .model import PythtbError

    data = model._get_finalized()
    d = data.dim_k
    if d < 1:
        raise PythtbError("parity_z2 needs a periodic model")
    if data.nspin != 2:
        raise PythtbError("parity_z2 requires a spinful model (the Fu-Kane formula counts Kramers pairs)")
    occ = tuple(int(o) for o in np.atleast_1d(occ))
    if len(occ) == 0 or len(occ) % 2 != 0 or len(set(occ)) != len(occ):
        raise PythtbError("occ must be an even number of distinct bands")
    if min(occ) < 0 or max(occ) >= data.nsta:
        raise PythtbError("occ indices %s out of range for %d states" % (sorted(occ), data.nsta))
    c = np.zeros(d) if center is None else np.asarray(center, dtype=np.float64)
    if c.shape != (d,):
        raise PythtbError("center must have dim_k components")
    orb, P_of_k, _ = _parity_setup(model, c, parity)
    _verify_inversion(data, orb, True, P_of_k, c, tol, "parity_z2")

    trims = np.stack(np.meshgrid(*([[0.0, 0.5]] * d), indexing="ij"), axis=-1).reshape(-1, d)
    delta = {}
    for kappa in trims:
        where = np.asarray(kappa).tolist()
        xis = _trim_parities(
            model, kappa, occ, orb, P_of_k, tol, True,
            "occupied space at TRIM %s is not closed under inversion -- check that occ is an isolated group" % (where,),
            "parity eigenvalues not quantized at TRIM %s" % (where,))
        n_minus = int(np.sum(xis < 0))
        if n_minus % 2 != 0:
            raise PythtbError("odd parity count at a TRIM -- Kramers pairing violated (is the model TRS?)")
        delta[tuple(float(x) for x in kappa)] = int((-1) ** (n_minus // 2))
    prod_all = int(np.prod(list(delta.values())))
    out = {"nu0": 0 if prod_all == 1 else 1, "delta": delta}
    if d == 3:
        weak = []
        for i in range(3):
            pr = int(np.prod([v for k_, v in delta.items() if k_[i] == 0.5]))
            weak.append(0 if pr == 1 else 1)
        out["weak"] = tuple(weak)
    return out


def parity_polarization(model, occ, center=None, parity=None, tol=1e-6):
    """Quantized polarization of a 1-D inversion-symmetric insulator from
    the TRIM parity products (Zak): ``p = n_occ c + {0 or 1/2} mod 1``
    with the product over all occupied states; the inversion operator is
    built and verified as in :func:`parity_z2`.

    :returns: float polarization in [0, 1)
    """
    from .model import PythtbError

    data = model._get_finalized()
    if data.dim_k != 1:
        raise PythtbError("parity_polarization is 1-D (reduce_dim higher-dimensional models first)")
    occ = tuple(int(o) for o in np.atleast_1d(occ))
    if len(occ) == 0 or len(set(occ)) != len(occ) or min(occ) < 0 or max(occ) >= data.nsta:
        raise PythtbError("occ must be distinct bands in range")
    c = np.zeros(1) if center is None else np.atleast_1d(np.asarray(center, dtype=np.float64))
    if c.shape != (1,):
        raise PythtbError("center must have dim_k = 1 components")
    orb, P_of_k, spinful = _parity_setup(model, c, parity)
    _verify_inversion(data, orb, spinful, P_of_k, c, tol, "parity_polarization")
    prod = 1.0
    for kap in (np.zeros(1), np.array([0.5])):
        xis = _trim_parities(model, kap, occ, orb, P_of_k, tol, spinful,
                             "occupied space at TRIM %s not closed under inversion" % kap.tolist(),
                             "parity eigenvalues not quantized")
        prod *= float(np.prod(np.sign(xis)))
    branch = 0.0 if prod > 0 else 0.5
    return float((len(occ) * float(c[0]) + branch) % 1.0)


# ---------------------------------------------------------------------------
# Band-touching points
# ---------------------------------------------------------------------------


def _node_band(data, band):
    if band is None:
        band = data.nsta // 2 - 1
    band = int(band)
    if not (0 <= band < data.nsta - 1):
        raise ValueError("band must satisfy 0 <= band < nsta - 1")
    return band


def _node_refine(data, k, band, steps, step0, decay):
    """Normalized-gradient descent on the direct gap, the whole candidate
    batch per step (``pythtb_tpu.flows._node_refine_jit`` as a host loop):
    each step assembles H (kernel 1), solves it (kernel 2 or the library),
    and takes the Hellmann-Feynman gap gradient <u_{b+1}|dH|u_{b+1}> -
    <u_b|dH|u_b> from dH/dk (kernel 15); eigenvectors are ROWS.  Returns
    the final points, their direct gaps and band-``band`` energies."""
    for i in range(int(steps)):
        _, v = eigh_batched(assemble(data, k))
        dH = assemble_dk(data, k)  # (B, dim, nsta, nsta)
        vn, vm = v[:, band, :], v[:, band + 1, :]
        gm = torch.einsum("bn,banm,bm->ba", vm.conj(), dH, vm).real
        gn = torch.einsum("bn,banm,bm->ba", vn.conj(), dH, vn).real
        g = gm - gn
        norm = torch.linalg.vector_norm(g, dim=-1, keepdim=True)
        step = step0 * decay**i
        k = k - step * g / torch.where(norm > 1e-30, norm, torch.ones_like(norm))
    w = eigvalsh_batched(assemble(data, k))
    return k, w[:, band + 1] - w[:, band], w[:, band]


def find_nodes(model, band=None, nk=24, gap_tol=1e-5, steps=120, merge_tol=1e-3, return_energies=False):
    """Band-touching points (Dirac/Weyl nodes, band crossings) between
    bands ``band`` and ``band + 1`` anywhere in the BZ: the direct gap on
    a uniform ``nk^dim_k`` grid (kernels 1-2), every axis-aligned periodic
    local minimum refined by normalized Hellmann-Feynman descent with a
    geometrically decaying step (:func:`_node_refine`), wrapped to [0, 1),
    filtered to ``gap < gap_tol`` and merged within ``merge_tol``
    (minimum-image metric in reduced coordinates).

    :returns: ``(kpts (M, dim_k), gaps (M,))`` sorted by gap, plus
      ``energies (M,)`` if requested; empty arrays when gapped
    """
    data = model._get_finalized()
    dim = data.dim_k
    if dim < 1:
        raise ValueError("find_nodes requires at least one periodic direction")
    band = _node_band(data, band)
    nk = tuple(int(x) for x in np.atleast_1d(nk))
    if len(nk) == 1:
        nk = nk * dim
    if len(nk) != dim or any(n < 3 for n in nk):
        raise ValueError("nk must give >= 3 points per periodic direction")
    dev = data.device
    w = eigvalsh_batched(assemble(data, device_uniform_grid(nk, np.zeros(dim), dev)))
    gaps = (w[:, band + 1] - w[:, band]).reshape(nk).cpu().numpy()
    is_min = np.ones(nk, dtype=bool)
    for ax in range(dim):
        is_min &= gaps <= np.roll(gaps, 1, axis=ax)
        is_min &= gaps <= np.roll(gaps, -1, axis=ax)
    idx = np.argwhere(is_min)
    if idx.size == 0:
        empty = (np.zeros((0, dim)), np.zeros((0,)))
        return empty + (np.zeros((0,)),) if return_energies else empty
    k0 = idx.astype(np.float64) / np.asarray(nk, np.float64)
    h = float(max(1.0 / n for n in nk))
    decay = float((1e-7 / h) ** (1.0 / max(steps, 1)))
    # np.argwhere's rows are a transposed view: the kernels read C order
    k_fin, g_fin, e_fin = _node_refine(data, torch.as_tensor(np.ascontiguousarray(k0)).to(dev), band, steps, h, decay)
    k_fin = k_fin.cpu().numpy().astype(np.float64) % 1.0
    g_fin = g_fin.cpu().numpy().astype(np.float64)
    e_fin = e_fin.cpu().numpy().astype(np.float64)
    keep = g_fin < float(gap_tol)
    k_fin, g_fin, e_fin = k_fin[keep], g_fin[keep], e_fin[keep]
    # merge duplicates, keeping the smallest-gap representative
    order = np.argsort(g_fin, kind="stable")
    sel_k, sel_g, sel_e = [], [], []
    for i in order:
        dup = False
        for kk in sel_k:
            d = k_fin[i] - kk
            d -= np.round(d)
            if np.linalg.norm(d) < merge_tol:
                dup = True
                break
        if not dup:
            sel_k.append(k_fin[i])
            sel_g.append(g_fin[i])
            sel_e.append(e_fin[i])
    kpts = np.asarray(sel_k, np.float64).reshape(-1, dim)
    out = (kpts, np.asarray(sel_g, np.float64))
    return out + (np.asarray(sel_e, np.float64),) if return_energies else out


def node_chirality(model, k0, band=None, radius=0.02, nf=10):
    """Topological charge of a 3-D band-touching point: the Chern number
    of bands ``0..band`` over the six faces of a cube of half-width
    ``radius`` around ``k0`` (reduced coordinates), faces oriented with
    the outward normal (the package's slice-Chern convention: C above the
    node minus C below).  All six faces are assembled and solved as one
    batch (kernels 1-2), their plaquette fluxes from kernels 3-4.  Warns
    when a plaquette carries more than pi/2 (another touching on or near
    the cube) or the total is not near an integer.

    :returns: integer charge
    """
    data = model._get_finalized()
    if data.dim_k != 3:
        raise ValueError("node_chirality requires a 3-D periodic model")
    band = _node_band(data, band)
    dev = data.device
    k0 = torch.as_tensor(np.asarray(k0, np.float64).reshape(3)).to(dev)
    nf = int(nf)
    radius = float(radius)
    offs = (torch.arange(nf, dtype=config.FLOAT, device=dev) / (nf - 1.0) * 2.0 - 1.0) * radius
    U, V = torch.meshgrid(offs, offs, indexing="ij")

    def face(d, s, a, b):
        k = k0.expand(nf, nf, 3).clone()
        k[..., d] += s * radius
        k[..., a] += U
        k[..., b] += V
        return k

    faces = torch.stack([
        face(0, +1.0, 1, 2), face(0, -1.0, 2, 1),
        face(1, +1.0, 2, 0), face(1, -1.0, 0, 2),
        face(2, +1.0, 0, 1), face(2, -1.0, 1, 0),
    ])  # (6, nf, nf, 3)
    w, v = eigh_batched(assemble(data, faces.reshape(-1, 3)))
    states = v[:, : band + 1, :].reshape(6, nf, nf, band + 1, data.nsta).contiguous()
    ph = plaquette_flux(*_plane_link_dets(states), individual=True)[0]
    chi = float(ph.sum()) / (2.0 * np.pi)
    surf_gap = float((w[:, band + 1] - w[:, band]).min())
    max_ph = float(ph.abs().max())
    if max_ph > 0.5 * np.pi:
        warnings.warn(
            "node_chirality: a surface plaquette carries %.2f rad of "
            "flux (band-pair surface gap %.2e) -- another touching "
            "sits on or near the cube; shrink radius, re-center, or "
            "raise nf.  The charge is unreliable." % (max_ph, surf_gap))
    out = int(round(chi))
    if abs(chi - out) > 0.05:
        warnings.warn("node_chirality: non-integer total flux %.4f (unresolved curvature -- raise nf or shrink "
                      "radius)" % chi)
    return out


# ---------------------------------------------------------------------------
# Second Chern number and the axion angle of a model family
# ---------------------------------------------------------------------------


def _c2_dens(G, closed_lam, nlam):
    """Second-Chern density of a (L, n1, n2, n3, no, S) state family:
    per-lambda-slice k-means of eps^{abcd} Tr[F_ab F_cd], F_ab = P [d_a P,
    d_b P] P, with P the occupied projector (gauge-invariant), as
    ``pythtb_tpu.flows._c2_dens_jit``: k-derivatives 4th-order central,
    the lambda axis periodic when ``closed_lam`` else one-sided 2nd-order
    at the path ends.  Torch einsums and matmuls.  Returns (L,)."""
    P = torch.einsum("...ms,...mt->...st", G, G.conj())
    nvec = (nlam,) + tuple(P.shape[1:4])
    d0 = 1.0 / nvec[0]

    def central(ax, d):
        def r(s):
            return torch.roll(P, -s, dims=ax)
        return (-r(2) + 8 * r(1) - 8 * r(-1) + r(-2)) / (12 * d)

    if closed_lam:
        dPl = central(0, d0)
    else:
        dPl = (torch.roll(P, -1, dims=0) - torch.roll(P, 1, dims=0)) / (2 * d0)
        dPl[0] = (-3 * P[0] + 4 * P[1] - P[2]) / (2 * d0)
        dPl[-1] = (3 * P[-1] - 4 * P[-2] + P[-3]) / (2 * d0)
    dP = [dPl] + [central(ax, 1.0 / nvec[ax]) for ax in range(1, 4)]

    def fab(a, b):
        return P @ (dP[a] @ dP[b] - dP[b] @ dP[a]) @ P

    def tr2(X, Y):
        return torch.einsum("...ij,...ji->...", X, Y)

    dens = (tr2(fab(0, 1), fab(2, 3)) - tr2(fab(0, 2), fab(1, 3)) + tr2(fab(0, 3), fab(1, 2))).real
    return dens.mean(dim=(1, 2, 3))


def _family_states(models, occ, nk):
    """(L, n1, n2, n3, no, S) Convention-II occupied states of a model
    family on a shared k-grid from the origin: per slice one assembly
    (kernel 1) and one ``eigh_batched`` (kernels 2/7 or the library), the
    states times e^{2 pi i k.t_orb}."""
    out = []
    n1, n2, n3 = nk
    for m in models:
        data = m._get_finalized()
        if data.dim_k != 3:
            raise ValueError("second_chern/axion_theta require dim_k == 3")
        if max(occ) >= data.nsta or min(occ) < 0:
            raise IndexError("occ indices out of range")
        t = np.asarray(m._orb)[:, m._per].T
        if m._nspin == 2:
            t = np.repeat(t, 2, axis=1)
        kpts = device_uniform_grid(tuple(nk), np.zeros(3), data.device)
        _, vecs = eigh_batched(assemble(data, kpts))
        u = vecs[:, list(occ), :]
        ang = (2.0 * np.pi) * (kpts @ torch.as_tensor(t, dtype=config.FLOAT).to(data.device))
        u = u * torch.polar(torch.ones_like(ang), ang)[:, None, :]
        out.append(u.reshape(n1, n2, n3, len(occ), -1))
    return torch.stack(out)


def _refined(nk):
    return tuple(max(n + 4, int(round(n * 1.25))) for n in nk)


def second_chern(models, occ, nk=(16, 16, 16), refine=True):
    """Second Chern number of a CLOSED gapped family of 3-D models (axion
    pump): models[i] is the lambda = i/L slice (endpoint not duplicated).
    The gauge-invariant projector-curvature density (:func:`_c2_dens`);
    with ``refine`` the ~n^-3 tail is Richardson-extrapolated from nk and
    ~1.25 nk.

    :returns: float (near-integer)
    """
    occ = tuple(int(o) for o in occ)
    nk = (nk,) * 3 if np.isscalar(nk) else tuple(int(n) for n in nk)
    L = len(models)
    if L < 5:
        raise ValueError("need at least 5 lambda slices")

    def raw(nkv):
        dk = _c2_dens(_family_states(models, occ, nkv), True, L)
        return -float(dk.mean()) / (4.0 * np.pi**2)

    c = raw(nk)
    if not refine:
        return c
    nk2 = _refined(nk)
    c2_ = raw(nk2)
    rr = float(np.prod(nk2)) / float(np.prod(nk))
    return c2_ + (c2_ - c) / (rr - 1.0)


def axion_theta(models_path, occ, nk=(16, 16, 16), refine=True):
    """Chern-Simons axion angle theta of ``models_path[0]`` by adiabatic
    pumping along a GAPPED path to a theta = 0 reference at
    ``models_path[-1]`` (endpoints included): theta = -2 pi C2_open(path),
    from the same projector-curvature density as :func:`second_chern`
    (open lambda axis, trapezoid rule).

    :returns: theta in (-pi, pi]
    """
    occ = tuple(int(o) for o in occ)
    nk = (nk,) * 3 if np.isscalar(nk) else tuple(int(n) for n in nk)
    L = len(models_path)
    if L < 5:
        raise ValueError("need at least 5 path slices")
    w = np.ones(L)
    w[0] = w[-1] = 0.5

    def raw(nkv):
        dk = _c2_dens(_family_states(models_path, occ, nkv), False, L - 1).cpu().numpy()
        return float((dk * w).sum() / (L - 1)) / (2.0 * np.pi)

    th = raw(nk)
    if refine:
        nk2 = _refined(nk)
        th2 = raw(nk2)
        rr = float(np.prod(nk2)) / float(np.prod(nk))
        th = th2 + (th2 - th) / (rr - 1.0)
    return float((th + np.pi) % (2.0 * np.pi) - np.pi)
