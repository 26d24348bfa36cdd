"""k-batch solvers: assemble H(k), then diagonalize (counterpart of
``pythtb_tpu.ops.solver``).

* ``solve_kpts`` / ``hamiltonian_kpts`` -- host-provided k-lists (bands
  along paths, user meshes); NumPy in, NumPy out.
* ``solve_grid_device`` -- uniform grids built on the device with
  ``torch.arange``, solved, and extended by the periodic-gauge boundary
  slices on the device; its state and energy grids stay there for
  :class:`pythtb_tpu_torch.wf_array`.
* ``solve_grid_family`` -- the same for P members of one hopping graph
  (a parameter family): one launch of kernel 1's member mode assembles
  every member at every grid point, one ``eigh_batched`` solves them.

Host and device exchange one tensor per input or output.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import config
from ..core import BlochData
from .eigh import eigh_batched, eigvalsh_batched
from .hamiltonian import assemble

__all__ = [
    "solve_kpts",
    "hamiltonian_kpts",
    "device_uniform_grid",
    "extend_pbc_seq",
    "solve_grid_device",
    "solve_grid_family",
]


def _prep_kpts(data: BlochData, k_list):
    """Validate the k-list and move it to the device as (B, dim_k)."""
    if data.dim_k == 0:
        if k_list is not None:
            raise ValueError(
                "k-vector of wrong shape: this model has dim_k=0 "
                "(no k-points should be provided)"
            )
        kpts = np.zeros((1, 0), dtype=np.float64)
    elif k_list is None:
        raise ValueError("Have to provide a k-vector (model has dim_k=%d)!" % data.dim_k)
    else:
        kpts = np.asarray(k_list, dtype=np.float64)
        if kpts.ndim == 1:
            kpts = kpts[:, None] if data.dim_k == 1 else kpts[None, :]
        if kpts.shape[1] != data.dim_k:
            raise ValueError(
                "k-vectors have wrong dimension: expected dim_k=%d, got %d"
                % (data.dim_k, kpts.shape[1])
            )
    return torch.as_tensor(np.ascontiguousarray(kpts), dtype=config.FLOAT).to(data.device)


def _to_host(t: torch.Tensor) -> np.ndarray:
    """Device tensor -> NumPy array that owns its memory (a CPU tensor's
    .numpy() would alias it)."""
    return np.array(t.detach().cpu().numpy(), copy=True)


def hamiltonian_kpts(data: BlochData, k_list, mesh=None):
    """Dense H(k) for a k-list -> (nkp, nsta, nsta) complex128 NumPy;
    ``mesh`` must be None (:func:`config.require_no_mesh`)."""
    config.require_no_mesh(mesh)
    return _to_host(assemble(data, _prep_kpts(data, k_list)))


def solve_kpts(data: BlochData, k_list, eig_vectors=False, mesh=None):
    """Batched solve of a k-list (k-batch leading).

    Returns eval (nkp, nsta) float64, and with ``eig_vectors`` also evec
    (nkp, nsta, norb[, 2]) complex128 with rows as states.  ``mesh`` must
    be None.
    """
    config.require_no_mesh(mesh)
    H = assemble(data, _prep_kpts(data, k_list))
    if not eig_vectors:
        return _to_host(eigvalsh_batched(H))
    w, v = eigh_batched(H)
    if data.nspin == 2:
        v = v.reshape(v.shape[0], data.nsta, data.norb, 2)
    return _to_host(w), _to_host(v)


def device_uniform_grid(shape, start, device, denoms=None):
    """Uniform grid built on ``device``: point[i_1..i_d, d] =
    i_d / denoms[d] + start[d], flattened to (prod(shape), len(shape))."""
    if denoms is None:
        denoms = shape
    axes = [
        torch.arange(n, dtype=config.FLOAT, device=device) / float(dn) + float(s)
        for n, dn, s in zip(shape, denoms, start)
    ]
    grids = torch.meshgrid(*axes, indexing="ij")
    return torch.stack([g.reshape(-1) for g in grids], dim=-1)


def extend_pbc_seq(w, phases):
    """Append the wrapped-around boundary slice per grid dimension,
    multiplied by the periodic-gauge ``phases[d]`` (which broadcast
    against the trailing orbital(/spin) axes), in dimension order."""
    for d, ph in enumerate(phases):
        w = torch.cat([w, w.narrow(d, 0, 1) * ph], dim=d)
    return w


def grid_phases(orb, per, nspin, ndim, device):
    """Periodic-gauge boundary phases exp(-2j*pi*orb[:, per[d]]) as
    (ndim, norb[, 2]) complex on ``device``."""
    phases = []
    for d in range(ndim):
        ffac = np.exp(-2.0j * np.pi * np.asarray(orb)[:, per[d]])
        if nspin == 2:
            ffac = np.repeat(ffac[:, None], 2, axis=1)
        phases.append(ffac)
    return torch.as_tensor(np.stack(phases), dtype=config.COMPLEX).to(device)


def _solve_grid_core(data: BlochData, interior, start, phases):
    """Solve on a uniform grid of shape ``interior`` (per-dim sizes
    n_d - 1) anchored at ``start``, then append the wrapped boundary
    slice per dimension with periodic-gauge phases (as wf_array's
    solve_on_grid + impose_pbc).

    Returns (min_gaps (nsta-1,), evals (*mesh, nsta),
    wfs (*mesh, nsta, norb[, 2])), all on the device.
    """
    kpts = device_uniform_grid(interior, start, data.device)
    evals, v = eigh_batched(assemble(data, kpts))  # (B, nsta), (B, nsta, nsta)
    if data.nspin == 2:
        v = v.reshape(v.shape[0], data.nsta, data.norb, 2)
    w = v.reshape(tuple(interior) + v.shape[1:])
    w = extend_pbc_seq(w, [phases[d] for d in range(len(interior))])
    # band energies on the full grid (boundary = periodic copy)
    eg = evals.reshape(tuple(interior) + (data.nsta,))
    for d in range(len(interior)):
        eg = torch.cat([eg, eg.narrow(d, 0, 1)], dim=d)
    if data.nsta > 1:
        min_gaps = (evals[:, 1:] - evals[:, :-1]).amin(dim=0)
    else:
        min_gaps = evals.new_zeros((0,))
    return min_gaps, eg, w


def solve_grid_device(data: BlochData, mesh_sizes, start_k, orb, per, nspin, mesh=None):
    """Uniform-grid solve that leaves its results on the device (``mesh``
    must be None).

    Returns (min_gaps (nsta-1,) float64 NumPy, evals tensor
    (*mesh_sizes, nsta), wfs tensor (*mesh_sizes, nsta, norb[, 2])).
    """
    config.require_no_mesh(mesh)
    interior = tuple(int(m) - 1 for m in mesh_sizes)
    start = np.asarray(start_k, dtype=np.float64).reshape(len(interior))
    phases = grid_phases(orb, per, nspin, len(interior), data.device)
    min_gaps, evals, wfs = _solve_grid_core(data, interior, start, phases)
    return _to_host(min_gaps), evals, wfs


def solve_grid_family(data: BlochData, amps, diags, mesh_sizes, start_k, orb, per, nspin):
    """Uniform-grid solve of P members of one hopping graph, member p with
    amplitudes ``amps[p]`` and on-site matrix ``diags[p]`` (the arguments
    of :func:`..ops.hamiltonian.assemble_members`): one kernel-1 launch and
    one ``eigh_batched`` for the whole family, then the periodic-gauge
    boundary slices as in :func:`solve_grid_device`.

    Returns (min_gaps (nsta-1,) float64 NumPy over the whole family, evals
    tensor (P, *mesh_sizes, nsta), wfs tensor (P, *mesh_sizes, nsta,
    norb[, 2])).
    """
    from .hamiltonian import assemble_members

    interior = tuple(int(m) - 1 for m in mesh_sizes)
    start = np.asarray(start_k, dtype=np.float64).reshape(len(interior))
    phases = grid_phases(orb, per, nspin, len(interior), data.device)
    P = amps.shape[0]
    kpts = device_uniform_grid(interior, start, data.device)
    evals, v = eigh_batched(assemble_members(data, amps, diags, kpts))
    if data.nspin == 2:
        v = v.reshape(v.shape[0], data.nsta, data.norb, 2)
    w = v.reshape((P,) + interior + tuple(v.shape[1:]))
    eg = evals.reshape((P,) + interior + (data.nsta,))
    for d in range(len(interior)):
        w = torch.cat([w, w.narrow(d + 1, 0, 1) * phases[d]], dim=d + 1)
        eg = torch.cat([eg, eg.narrow(d + 1, 0, 1)], dim=d + 1)
    if data.nsta > 1:
        min_gaps = (evals[:, 1:] - evals[:, :-1]).amin(dim=0)
    else:
        min_gaps = evals.new_zeros((0,))
    return _to_host(min_gaps), eg, w
