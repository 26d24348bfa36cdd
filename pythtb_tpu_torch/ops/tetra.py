"""Linear-interpolation density of states on a uniform grid: kernel 21
(``csrc/tetra_dos.cu``), the counterpart of the simplex sum inside
``pythtb_tpu.fermisurface._dos_lin_jit``.

The grid eigenvalues (nk^d, S), C order, are cut into simplices --
segments (d 1), the triangles (00, 10, 11) and (00, 01, 11) of each
square (d 2), the six tetrahedra of each cube along its 000-111 diagonal
(d 3) -- whose sorted corner energies give, at every energy E, the
piecewise-analytic linear-interpolation weight (Bloechl's tetrahedron
formulas without smearing, with the JAX package's max(., eps) clamps);
the DOS is their sum times 1 / (d! nk^d).

:func:`tetra_dos` launches kernel 21 on a CUDA tensor and runs
:func:`_tetra_dos_plain` (``torch.roll`` corners, the branches broadcast
over chunks of energies) on a CPU tensor.
"""

from __future__ import annotations

import math

import torch

from .. import config
from . import _kernels

__all__ = ["tetra_dos", "simplex_corners"]

# the six tetrahedra of a cube along 000-111 (fermisurface.py:293-300)
_TETS = (
    ((0, 0, 0), (1, 0, 0), (1, 1, 0), (1, 1, 1)),
    ((0, 0, 0), (1, 0, 0), (1, 0, 1), (1, 1, 1)),
    ((0, 0, 0), (0, 1, 0), (1, 1, 0), (1, 1, 1)),
    ((0, 0, 0), (0, 1, 0), (0, 1, 1), (1, 1, 1)),
    ((0, 0, 0), (0, 0, 1), (1, 0, 1), (1, 1, 1)),
    ((0, 0, 0), (0, 0, 1), (0, 1, 1), (1, 1, 1)),
)
_TRIS = (((0, 0), (1, 0), (1, 1)), ((0, 0), (0, 1), (1, 1)))
# simplices per grid point, and energies per chunk of the plain version
_SPLITS = {1: 1, 2: 2, 3: 6}
_PLAIN_ENERGIES = 8


def _shifted(grid, offsets):
    for axis, a in enumerate(offsets):
        if a:
            grid = torch.roll(grid, -1, dims=axis)
    return grid


def simplex_corners(evals, nk, d):
    """Sorted corner energies (T, d+1) of every simplex of the grid
    eigenvalues ``evals`` (nk^d, S), in the JAX package's layout
    (grid point, split, band)."""
    S = evals.shape[-1]
    grid = evals.reshape((nk,) * d + (S,))
    if d == 1:
        corners = torch.stack([grid, _shifted(grid, (1,))], dim=-1)
    elif d == 2:
        corners = torch.cat([torch.stack([_shifted(grid, o) for o in tri], dim=-1) for tri in _TRIS], dim=-2)
    else:
        corners = torch.cat([torch.stack([_shifted(grid, o) for o in tet], dim=-1) for tet in _TETS], dim=-2)
    return torch.sort(corners.reshape(-1, d + 1), dim=-1).values


def _weights(cs, E, d):
    """(nE, T) simplex weights at energies E (nE,) from sorted corners cs."""
    eps = torch.finfo(cs.dtype).eps
    E = E[:, None]
    if d == 1:
        e1, e2 = cs[:, 0], cs[:, 1]
        inside = (E >= e1) & (E < e2)
        return torch.where(inside, 1.0 / torch.clamp(e2 - e1, min=eps), torch.zeros_like(E))
    if d == 2:
        e1, e2, e3 = cs[:, 0], cs[:, 1], cs[:, 2]
        d31 = torch.clamp(e3 - e1, min=eps)
        d21 = torch.clamp(e2 - e1, min=eps)
        d32 = torch.clamp(e3 - e2, min=eps)
        lo = (E >= e1) & (E < e2)
        hi = (E >= e2) & (E < e3)
        zero = torch.zeros_like(E)
        return (torch.where(lo, 2.0 * (E - e1) / (d21 * d31), zero)
                + torch.where(hi, 2.0 * (e3 - E) / (d32 * d31), zero))
    e1, e2, e3, e4 = cs[:, 0], cs[:, 1], cs[:, 2], cs[:, 3]
    d21 = torch.clamp(e2 - e1, min=eps)
    d31 = torch.clamp(e3 - e1, min=eps)
    d41 = torch.clamp(e4 - e1, min=eps)
    d32 = torch.clamp(e3 - e2, min=eps)
    d42 = torch.clamp(e4 - e2, min=eps)
    d43 = torch.clamp(e4 - e3, min=eps)
    r1 = (E >= e1) & (E < e2)
    r2 = (E >= e2) & (E < e3)
    r3 = (E >= e3) & (E < e4)
    x1, x2, x3 = E - e1, E - e2, e4 - E
    v1 = 3.0 * (x1 * x1) / (d21 * d31 * d41)
    v2 = (3.0 * d21 + 6.0 * x2 - 3.0 * (d31 + d42) * (x2 * x2) / (d32 * d42)) / (d31 * d41)
    v3 = 3.0 * (x3 * x3) / (d41 * d42 * d43)
    zero = torch.zeros_like(E)
    return torch.where(r1, v1, zero) + torch.where(r2, v2, zero) + torch.where(r3, v3, zero)


def _tetra_dos_plain(evals, nk, d, energies):
    """Plain PyTorch linear-interpolation DOS: the sorted corners of
    :func:`simplex_corners`, the branches broadcast over chunks of
    energies and summed over the simplices.  The oracle of kernel 21."""
    cs = simplex_corners(evals, nk, d)
    w = 1.0 / (math.factorial(d) * nk**d)
    out = [_weights(cs, energies[i : i + _PLAIN_ENERGIES], d).sum(dim=-1)
           for i in range(0, energies.shape[0], _PLAIN_ENERGIES)]
    return torch.cat(out) * w if out else energies.new_zeros((0,))


def tetra_dos(evals, nk, d, energies):
    """DOS per cell (nE,) at ``energies`` (nE,) from the grid eigenvalues
    ``evals`` (nk^d, S), C order, by the linear-interpolation simplex
    method in ``d`` = 1, 2 or 3 dimensions."""
    if d not in (1, 2, 3):
        raise ValueError("d must be 1, 2 or 3, got %r" % (d,))
    if evals.device.type == "cpu":
        return _tetra_dos_plain(evals, nk, d, energies)
    S = evals.shape[-1]
    dev = evals.device
    _kernels.require(evals, "evals", config.FLOAT, (nk**d, S))
    _kernels.require(energies, "energies", config.FLOAT, (energies.shape[0],), dev)
    T = _SPLITS[d] * nk**d * S
    nE = energies.shape[0]
    cs = torch.empty((T, d + 1), dtype=config.FLOAT, device=dev)
    buf = torch.empty((max(-(-T // 512), 1), max(nE, 1)), dtype=config.FLOAT, device=dev)
    out = torch.empty((nE,), dtype=config.FLOAT, device=dev)
    _kernels.launch("tetra_dos", dev, evals, cs, energies, buf, out, d, nk, S, nE,
                    1.0 / (math.factorial(d) * nk**d))
    return out
