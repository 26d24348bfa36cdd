"""Host-side phase-continuity (branch-fixing) helpers.

These replicate, decision-for-decision, the reference's sequential greedy
algorithms (PythTB 1.8.0 pythtb.py:3867-3921): ``no_2pi`` ironing of
2*pi jumps, 1-D chain continuity, and the greedy nearest-phase matching
across multiband strings (including the ``<=`` tie-break and iteration
order).  They are inherently order-dependent scalar code, so they stay
on host NumPy -- they are O(strings * bands^2), never hot.
"""

from __future__ import annotations

import numpy as np

__all__ = ["no_2pi", "one_phase_cont", "array_phases_cont"]


def no_2pi(x, clos):
    """Shift x by multiples of 2*pi until it is within pi of clos."""
    while abs(clos - x) > np.pi:
        if clos - x > np.pi:
            x += 2.0 * np.pi
        elif clos - x < -1.0 * np.pi:
            x -= 2.0 * np.pi
    return x


def one_phase_cont(pha, clos):
    """Iron out 2*pi jumps along a 1-D array; first element pinned near clos."""
    ret = np.copy(pha)
    for i in range(len(ret)):
        cmpr = clos if i == 0 else ret[i - 1]
        ret[i] = no_2pi(ret[i], cmpr)
    return ret


def array_phases_cont(arr_pha, clos):
    """Greedy nearest-phase matching of multiband phases along axis 0.

    arr_pha: (npoints, nbands).  Each successive row is permuted so that
    each phase pairs with the nearest (on the unit circle) phase of the
    previous (already fixed) row, then branch-fixed with no_2pi.
    """
    ret = np.zeros_like(arr_pha)
    for i in range(arr_pha.shape[0]):
        cmpr = clos if i == 0 else ret[i - 1, :]
        avail = list(range(arr_pha.shape[1]))
        for j in range(cmpr.shape[0]):
            min_dist = 1.0e10
            best_k = None
            for k in avail:
                cur_dist = np.abs(
                    np.exp(1.0j * cmpr[j]) - np.exp(1.0j * arr_pha[i, k])
                )
                if cur_dist <= min_dist:
                    min_dist = cur_dist
                    best_k = k
            avail.pop(avail.index(best_k))
            ret[i, j] = no_2pi(arr_pha[i, best_k], cmpr[j])
    return ret
