"""Text report and matplotlib geometry visualization (counterpart of
``pythtb_tpu.viz``, host NumPy).

Host-side, equivalents of ``tb_model.display``
(PythTB 1.8.0 pythtb.py:562-634) and ``tb_model.visualize``
(pythtb.py:636-860): text dump of the model, and a 2-D projection of
orbitals / hoppings / an optional eigenstate with amplitude-sized,
phase-colored markers ("black", "red-blue", or "wheel" color schemes).
matplotlib is imported lazily, as in the reference (pythtb.py:733).

Structure: all geometry (projections, hopping polylines with their
bend, marker sizes, phase colors) is computed VECTORIZED up front
(:func:`_visualize_geometry` -- also the unit-testable surface), then
drawn with O(1) artists (``LineCollection`` + array-valued
plot/scatter calls) instead of the reference's per-hopping plot loop.
Visual-compatibility constants (marker sizes 4.0/4.5, bend factor 0.05,
line widths 1.5/0.75, zorders 7-11, the muted color tuples, and the
phase -> color maps) are taken from the reference's rendering
(pythtb.py:746-855) so figures remain pixel-comparable; everything
around them is this package's own design.
"""

from __future__ import annotations

import numpy as np

__all__ = ["display", "visualize"]


def _nice_float(x, just, rnd):
    return str(round(x, rnd)).rjust(just)


def _nice_int(x, just):
    return str(x).rjust(just)


def _nice_complex(x, just, rnd):
    ret = _nice_float(complex(x).real, just, rnd)
    ret += " - " if complex(x).imag < 0.0 else " + "
    ret += _nice_float(abs(complex(x).imag), just, rnd) + " i"
    return ret


def display(model):
    """Print a human-readable report of the model."""
    print("---------------------------------------")
    print("report of tight-binding model")
    print("---------------------------------------")
    print("k-space dimension           =", model._dim_k)
    print("r-space dimension           =", model._dim_r)
    print("number of spin components   =", model._nspin)
    print("periodic directions         =", model._per)
    print("number of orbitals          =", model._norb)
    print("number of electronic states =", model._nsta)
    print("lattice vectors:")
    for i, o in enumerate(model._lat):
        row = " , ".join(_nice_float(v, 7, 4) for v in o)
        print(" #", _nice_int(i, 2), " ===>  [", row, "]")
    print("positions of orbitals:")
    for i, o in enumerate(model._orb):
        row = " , ".join(_nice_float(v, 7, 4) for v in o)
        print(" #", _nice_int(i, 2), " ===>  [", row, "]")
    print("site energies:")
    for i, site in enumerate(model._site_energies):
        if model._nspin == 1:
            print(" #", _nice_int(i, 2), " ===>  ", _nice_float(site, 7, 4))
        else:
            print(" #", _nice_int(i, 2), " ===>  ", str(site).replace("\n", " "))
    print("hoppings:")
    for h in model._hoppings:
        tail = ""
        if len(h) == 4:
            tail = " + [ " + " , ".join(_nice_int(v, 2) for v in h[3]) + " ]"
        amp_str = (
            _nice_complex(h[0], 7, 4)
            if model._nspin == 1
            else str(h[0]).replace("\n", " ")
        )
        print("<", _nice_int(h[1], 2), "| H |", _nice_int(h[2], 2), tail, ">     ===> ", amp_str)
    print("hopping distances:")
    for h in model._hoppings:
        pos_i = np.dot(model._orb[h[1]], model._lat)
        pos_j = np.dot(model._orb[h[2]], model._lat)
        if len(h) == 4:
            pos_j = pos_j + np.dot(h[3], model._lat)
        tail = ""
        if len(h) == 4:
            tail = " + [ " + " , ".join(_nice_int(v, 2) for v in h[3]) + " ]"
        print(
            "|  pos(", _nice_int(h[1], 2), ")  - pos(", _nice_int(h[2], 2), tail,
            ") |  =  ", _nice_float(float(np.linalg.norm(pos_j - pos_i)), 7, 4),
        )
    print()


def _phase_colors(phases, scheme):
    """Vectorized phase -> RGB map, (n,) angles -> (n, 3) colors.

    'red-blue' interpolates red (phase 0) to blue (phase +-pi); 'wheel'
    walks the hue circle in pi/3 sectors (red, yellow, green, cyan,
    blue, magenta) -- the reference's maps (pythtb.py:755-790)."""
    phases = np.asarray(phases, dtype=float)
    if scheme == "red-blue":
        frac = np.abs(phases / np.pi)
        return np.stack([1.0 - frac, np.zeros_like(frac), frac], axis=-1)
    ph = np.where(phases < 0.0, phases + 2.0 * np.pi, phases)
    ph = 6.0 * ph / (2.0 * np.pi)
    x = 1.0 - np.abs(ph % 2.0 - 1.0)
    sector = np.minimum(ph, 5.999).astype(int)
    z, o = np.zeros_like(x), np.ones_like(x)
    table = np.stack([  # (6, n, 3)
        np.stack([o, x, z], -1), np.stack([x, o, z], -1),
        np.stack([z, o, x], -1), np.stack([z, x, o], -1),
        np.stack([x, z, o], -1), np.stack([o, z, x], -1),
    ])
    return table[sector, np.arange(len(ph))]


def _visualize_geometry(model, dir_first, dir_second, draw_hoppings):
    """All coordinates of the sketch, computed vectorized.

    Returns a dict: ``orb_xy`` (norb, 2); ``cell_segs`` (nper, 2, 2)
    origin->lattice-vector segments; ``hop_lines`` (2*nhop, 3, 2)
    three-point bent polylines (both directions of every hopping, the
    reference's 0.05-bend convention); ``hop_ends`` (4*nhop, 2) line
    endpoints that get neighbor markers."""
    cols = [dir_first] + ([dir_second] if dir_second is not None else [])
    P = model._lat[:, cols]  # project AFTER the red->cart map: (dim_r, <=2)

    def proj(red):
        xy = np.asarray(red, dtype=float) @ P
        if xy.shape[-1] == 1:  # 1-D models project onto the x axis
            xy = np.concatenate([xy, np.zeros_like(xy)], axis=-1)
        return xy

    out = {"orb_xy": proj(model._orb), "proj": proj}
    out["cell_segs"] = np.array(
        [[[0.0, 0.0], proj(np.eye(model._dim_r)[i])] for i in model._per]
    ).reshape(-1, 2, 2)

    if draw_hoppings and len(model._hoppings) > 0:
        hi = np.array([h[1] for h in model._hoppings])
        hj = np.array([h[2] for h in model._hoppings])
        ri = model._orb[hi].astype(float)  # (nhop, dim_r) reduced
        rj = model._orb[hj].astype(float)
        if model._dim_k != 0:
            R = np.array([np.asarray(h[3], dtype=float) for h in model._hoppings])
            shift = np.zeros_like(ri)
            shift[:, model._per] = R[:, model._per]
        else:
            shift = np.zeros_like(ri)
        # both drawing directions: <i|H|j+R> and the same bond anchored
        # at the conjugate cell (i-R -> j), as in pythtb.py:800-824
        a = proj(np.concatenate([ri, ri - shift]))  # (2*nhop, 2)
        b = proj(np.concatenate([rj + shift, rj]))
        mid = 0.5 * (a + b)
        dif = b - a
        orth = np.stack([dif[:, 1], -dif[:, 0]], axis=-1)
        nrm = np.linalg.norm(orth, axis=-1, keepdims=True)
        length = np.linalg.norm(dif, axis=-1, keepdims=True)
        with np.errstate(invalid="ignore"):
            bend = np.where(nrm > 0.0, orth / np.where(nrm == 0.0, 1.0, nrm), 0.0)
        mid = mid + bend * 0.05 * length
        out["hop_lines"] = np.stack([a, mid, b], axis=1)  # (2*nhop, 3, 2)
        out["hop_ends"] = np.concatenate([a, b])
    else:
        out["hop_lines"] = np.zeros((0, 3, 2))
        out["hop_ends"] = np.zeros((0, 2))
    return out


def visualize(model, dir_first, dir_second=None, eig_dr=None, draw_hoppings=True, ph_color="black", annotate_hoppings=False):
    """2-D projected sketch of the model; returns (fig, ax).

    Figure content matches the reference's ``visualize``
    (pythtb.py:636-860: same projection, bend, marker sizes, colors and
    z-order), drawn with vectorized artist collections.

    ``annotate_hoppings=True`` additionally labels each hopping with its
    amplitude at the bond's bend point (an upstream wish-list feature,
    PythTB notes/TODO:49 "Put labels for hopping terms"; spin
    blocks are labelled by their Frobenius norm).
    """
    if eig_dr is not None:
        if np.asarray(eig_dr).shape != (model._norb,):
            raise ValueError("Wrong format of eig_dr! Must be array of size norb.")
    if ph_color not in ["black", "red-blue", "wheel"]:
        raise ValueError("Wrong value of ph_color parameter!")
    if dir_second is None and model._dim_r > 1:
        raise ValueError("Need to specify index of second coordinate for projection!")

    import matplotlib.pyplot as plt
    from matplotlib.collections import LineCollection

    geo = _visualize_geometry(model, dir_first, dir_second, draw_hoppings)

    fig = plt.figure(
        figsize=[plt.rcParams["figure.figsize"][0], plt.rcParams["figure.figsize"][0]]
    )
    ax = fig.add_subplot(111, aspect="equal")

    if eig_dr is None or ph_color == "black":
        c_cell, c_orb, c_nei, c_hop = "b", "r", [0.85, 0.65, 0.65], "g"
    else:
        c_cell, c_orb = [0.4, 0.4, 0.4], [0.0, 0.0, 0.0]
        c_nei, c_hop = [0.6, 0.6, 0.6], [0.0, 0.0, 0.0]

    # origin marker + periodic cell vectors (one collection)
    ax.plot([0.0], [0.0], "o", c=c_cell, mec="w", mew=0.0, zorder=7, ms=4.5)
    ax.add_collection(
        LineCollection(geo["cell_segs"], colors=c_cell, linewidths=1.5, zorder=7)
    )

    # hoppings: every bent polyline in one collection, every endpoint
    # marker in one plot call
    if geo["hop_lines"].shape[0]:
        ax.add_collection(
            LineCollection(geo["hop_lines"], colors=c_hop, linewidths=0.75, zorder=8)
        )
        ends = geo["hop_ends"]
        ax.plot(ends[:, 0], ends[:, 1], "o", c=c_nei, zorder=9, mew=0.0,
                ms=4.0, mec="w", ls="none")

    if annotate_hoppings and len(model._hoppings):
        # one label per stored hopping (first nhop polylines are the
        # <i|H|j+R> drawing direction, in _hoppings order); labels are
        # honored even when the bond lines themselves are hidden
        label_geo = (
            geo
            if geo["hop_lines"].shape[0]
            else _visualize_geometry(model, dir_first, dir_second, True)
        )
        mids = label_geo["hop_lines"][: len(model._hoppings), 1]
        for h, xy in zip(model._hoppings, mids):
            z = np.asarray(h[0], dtype=complex)
            if model._nspin == 2:
                txt = "|t|=%.3g" % np.linalg.norm(z)
            else:
                scale = abs(z) + 1e-300
                re = 0.0 if abs(z.real) < 1e-9 * scale else float(z.real)
                im = 0.0 if abs(z.imag) < 1e-9 * scale else float(z.imag)
                if im == 0.0:
                    txt = "%.3g" % re
                elif re == 0.0:
                    txt = "%.3gj" % im
                else:
                    txt = "%.3g%+.3gj" % (re, im)
            ax.annotate(txt, xy, fontsize=6.0, ha="center", va="bottom",
                        color=c_hop, zorder=12)

    # orbitals
    orb_xy = geo["orb_xy"]
    ax.plot(orb_xy[:, 0], orb_xy[:, 1], "o", c=c_orb, mec="w", mew=0.0,
            zorder=10, ms=4.0, ls="none")

    # eigenstate markers: size ~ amplitude, color ~ phase (one scatter;
    # scatter sizes are areas in pt^2 = (plot ms)^2)
    if eig_dr is not None:
        eig = np.asarray(eig_dr)
        ms = 2.0 * (eig * eig.conj()).real * float(model._norb)
        if ph_color == "black":
            colors = "k"
        else:
            colors = _phase_colors(np.angle(eig), ph_color)
        ax.scatter(orb_xy[:, 0], orb_xy[:, 1], s=ms * ms, c=colors,
                   zorder=11, alpha=0.8, edgecolors="none")

    # square up the limits (reference pythtb.py:845-855)
    ax.autoscale_view()
    xl, yl = ax.set_xlim(), ax.set_ylim()
    centx, centy = (xl[1] + xl[0]) * 0.5, (yl[1] + yl[0]) * 0.5
    mx = max([xl[1] - xl[0], yl[1] - yl[0]])
    extr = 0.05
    ax.set_xlim(centx - mx * (0.5 + extr), centx + mx * (0.5 + extr))
    ax.set_ylim(centy - mx * (0.5 + extr), centy + mx * (0.5 + extr))
    return (fig, ax)


def hamiltonian_string(model, precision=4):
    """Human-readable closed form of the Bloch Hamiltonian H(k) -- an
    upstream wish-list feature (PythTB notes/TODO:61-62: "Make
    it possible to print out a tb model in terms of cos sin and so on
    that would help with debugging").

    Convention I (pythtb.py:912-916): each hopping contributes
    ``amp * exp(2j*pi*k.rv)`` with ``rv = -t_i + t_j + R`` restricted to
    the periodic directions, plus the Hermitian conjugate.  Diagonal
    entries combine each hop with its conjugate into a real
    ``2*|amp|*cos(2*pi*k.rv + arg)`` term; off-diagonal entries are
    printed as complex exponentials (their conjugates live in the lower
    triangle, which is omitted).  k is in reduced coordinates.

    :param model: a tb_model
    :param precision: digits for the numeric coefficients
    :returns: multi-line string, one line per independent H(k) entry
    """
    import numpy as np

    p = int(precision)

    def _num(x):
        if abs(x.imag if isinstance(x, complex) else 0.0) < 10.0 ** (-p - 6):
            return "%.*g" % (p, float(np.real(x)))
        return "(%.*g%+.*gj)" % (p, x.real, p, x.imag)

    def _kdot(rv):
        terms = []
        for d, r in enumerate(rv):
            if abs(r) < 1e-12:
                continue
            if abs(r - 1.0) < 1e-12:
                terms.append("k%d" % d)
            elif abs(r + 1.0) < 1e-12:
                terms.append("-k%d" % d)
            else:
                terms.append("%.*g*k%d" % (p, r, d))
        if not terms:
            return ""
        out = terms[0]
        for t in terms[1:]:
            out += (" - " + t[1:]) if t.startswith("-") else (" + " + t)
        return out

    per = model._per
    spin_labels = ("u", "d") if model._nspin == 2 else (None,)

    def _entry_label(i, si, j, sj):
        if model._nspin == 2:
            return "H[%d%s,%d%s]" % (i, spin_labels[si], j, spin_labels[sj])
        return "H[%d,%d]" % (i, j)

    # collect terms per (i, si, j, sj): list of (amp, rv)
    terms = {}

    def _add(i, si, j, sj, amp, rv):
        terms.setdefault((i, si, j, sj), []).append((complex(amp), np.asarray(rv)))

    def _add_hop(i, si, j, sj, amp, rv):
        # stored hops carry an implicit Hermitian conjugate; fold any
        # lower-triangle contribution into its upper-triangle entry so
        # the printed upper triangle is complete
        if (j, sj) < (i, si):
            _add(j, sj, i, si, np.conj(complex(amp)), -np.asarray(rv))
        else:
            _add(i, si, j, sj, amp, rv)

    for i in range(model._norb):
        if model._nspin == 1:
            _add(i, 0, i, 0, model._site_energies[i], np.zeros(len(per)))
        else:
            blk = model._site_energies[i]
            for si in range(2):
                for sj in range(2):
                    if abs(blk[si, sj]) > 1e-14:
                        _add(i, si, i, sj, blk[si, sj], np.zeros(len(per)))
    for h in model._hoppings:
        amp, i, j = h[0], h[1], h[2]
        if model._dim_k > 0:
            R = np.asarray(h[3], dtype=float)
            rv = (-model._orb[i] + model._orb[j] + R)[list(per)]
        else:
            rv = np.zeros(0)
        if model._nspin == 1:
            _add_hop(i, 0, j, 0, amp, rv)
        else:
            blk = np.asarray(amp, dtype=complex).reshape(2, 2)
            for si in range(2):
                for sj in range(2):
                    if abs(blk[si, sj]) > 1e-14:
                        _add_hop(i, si, j, sj, blk[si, sj], rv)

    lines = []
    for (i, si, j, sj), tl in sorted(terms.items()):
        # keep the upper triangle of the (orbital, spin) index pair
        if (j, sj) < (i, si):
            continue
        parts = []
        diagonal = (i, si) == (j, sj)
        for amp, rv in tl:
            phase = _kdot(rv)
            if not phase:
                parts.append(_num(amp if not diagonal else amp.real))
            elif diagonal:
                # hop + h.c. on the diagonal: 2|t| cos(2 pi k.rv + arg t)
                mag, arg = abs(amp), np.angle(amp)
                c = "2*%s*cos(2*pi*(%s)" % (_num(mag), phase)
                c += ")" if abs(arg) < 10.0 ** (-p - 6) else " %+.*g)" % (p, arg)
                parts.append(c)
            else:
                parts.append("%s*exp(2j*pi*(%s))" % (_num(amp), phase))
        lines.append("%s = %s" % (_entry_label(i, si, j, sj), " + ".join(parts)))
    tail = "  (+ h.c. of the off-diagonal lines; k in reduced coordinates)"
    return "\n".join(lines) + ("\n" + tail if lines else "")
