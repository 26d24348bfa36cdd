"""Wannier90 interface: pythtb_tpu_torch.w90 (counterpart of
``pythtb_tpu.w90``).

API-compatible with PythTB 1.8.0's ``w90`` class: parses ``prefix.win``
(unit cell, with bohr->Angstrom conversion), ``prefix_hr.dat``
(Wigner-Seitz degeneracies + <i|H|j+R> matrix elements) and
``prefix_centres.xyz`` (Wannier centres), or Wannier90's ``_tb.dat``,
and exposes ``model()`` with the ``zero_energy`` / ``min_hopping_norm`` /
``max_distance`` / ``ignorable_imaginary_part`` filters plus the
``dist_hop`` / ``shells`` / ``w90_bands_consistency`` diagnostics;
:func:`write_w90` exports a model as such a fileset.

This is host parsing in NumPy; the produced :class:`tb_model` solves on
the device like any other.  It flags
``_assume_position_operator_diagonal = False``, as PythTB does, which
guards Berry-type quantities.

Units: eV and Angstrom throughout.
"""

from __future__ import annotations

import numpy as np

from .model import PythtbError, tb_model

__all__ = ["w90"]

_BOHR_TO_ANG = 0.5291772108  # the conversion PythTB uses


class w90(object):
    """Reader for Wannier90 output; call :meth:`model` to build a
    :class:`pythtb_tpu_torch.tb_model`.

    :param path: folder containing the Wannier90 files
    :param prefix: seedname used by the Wannier90 run
    :param use_tb_file: read everything from ``<prefix>_tb.dat``
      (Wannier90's ``write_tb = .true.`` output: lattice, H(R), and
      position matrices in one file) instead of the
      ``.win`` / ``_hr.dat`` / ``_centres.xyz`` triple.  ``None``
      (default) auto-selects: the standard triple when complete,
      otherwise ``_tb.dat``.
      When read from ``_tb.dat``, the full position matrices are kept
      on ``self.pos_r`` (dict R -> (nw, nw, 3) complex, Angstrom) and
      Wannier centers are their R=0 diagonal.
    """

    def __init__(self, path, prefix, use_tb_file=None):
        import os

        self.path = path
        self.prefix = prefix
        self.pos_r = None

        tb_path = os.path.join(path, prefix + "_tb.dat")
        std = [
            os.path.join(path, prefix + s)
            for s in (".win", "_hr.dat", "_centres.xyz")
        ]
        if use_tb_file is None:
            use_tb_file = os.path.exists(tb_path) and not all(
                os.path.exists(p) for p in std
            )
        if use_tb_file:
            self._parse_tb(tb_path)
        else:
            self._parse_standard()

    def _parse_standard(self):
        # ---- unit cell from <prefix>.win -----------------------------
        with open(self.path + "/" + self.prefix + ".win", "r") as f:
            ln = f.readlines()
        self.lat = np.zeros((3, 3), dtype=float)
        found = False
        for i in range(len(ln)):
            sp = ln[i].split()
            if len(sp) >= 2 and sp[0].lower() == "begin" and sp[1].lower() == "unit_cell_cart":
                unit_line = ln[i + 1].strip().lower()
                if unit_line == "bohr":
                    pref, skip = _BOHR_TO_ANG, 1
                elif unit_line in ["ang", "angstrom"]:
                    pref, skip = 1.0, 1
                else:
                    pref, skip = 1.0, 0
                for j in range(3):
                    sp = ln[i + skip + 1 + j].split()
                    for k in range(3):
                        self.lat[j, k] = float(sp[k]) * pref
                found = True
                break
        if not found:
            raise PythtbError("Unable to find unit_cell_cart block in the .win file.")

        # ---- Hamiltonian from <prefix>_hr.dat ------------------------
        with open(self.path + "/" + self.prefix + "_hr.dat", "r") as f:
            ln = f.readlines()
        self.num_wan = int(ln[1])
        num_ws = int(ln[2])
        deg_ws = []
        last_j = None
        for j in range(3, len(ln)):
            deg_ws.extend(int(s) for s in ln[j].split())
            if len(deg_ws) == num_ws:
                last_j = j
                break
            if len(deg_ws) > num_ws:
                raise PythtbError("Too many degeneracies for WS points!")
        deg_ws = np.array(deg_ws, dtype=int)

        # ham_r[(R1,R2,R3)] = {"h": (nw, nw) complex <i|H|j+R>, "deg": int}
        self.ham_r = {}
        ind_R = 0
        for j in range(last_j + 1, len(ln)):
            sp = ln[j].split()
            if not sp:
                continue
            R = (int(sp[0]), int(sp[1]), int(sp[2]))
            hi, hj = int(sp[3]) - 1, int(sp[4]) - 1
            val = float(sp[5]) + 1.0j * float(sp[6])
            if R not in self.ham_r:
                self.ham_r[R] = {
                    "h": np.zeros((self.num_wan, self.num_wan), dtype=complex),
                    "deg": int(deg_ws[ind_R]),
                }
                ind_R += 1
            self.ham_r[R]["h"][hi, hj] = val

        # sanity: every nonzero R must have exactly one -R partner
        keys = set(self.ham_r.keys())
        for R in keys:
            if R != (0, 0, 0):
                if (-R[0], -R[1], -R[2]) not in keys:
                    raise PythtbError("Did not find negative R for R = " + str(R) + "!")

        # ---- Wannier centers from <prefix>_centres.xyz ---------------
        with open(self.path + "/" + self.prefix + "_centres.xyz", "r") as f:
            ln = f.readlines()
        xyz_cen = []
        for i in range(2, 2 + self.num_wan):
            sp = ln[i].split()
            if sp[0] != "X":
                raise PythtbError("Inconsistency in the centres file.")
            xyz_cen.append([float(sp[1]), float(sp[2]), float(sp[3])])
        self.xyz_cen = np.array(xyz_cen, dtype=float)
        # reduced coordinates of the centers
        self.red_cen = self.xyz_cen @ np.linalg.inv(self.lat.T).T

    def _parse_tb(self, tb_path):
        """Parse ``<prefix>_tb.dat`` (Wannier90 ``write_tb``): comment
        line; 3 lattice rows (Angstrom); num_wann; nrpts; Wigner-Seitz
        degeneracies; nrpts blocks of [blank, R, nw^2 lines "i j re im"]
        for H(R); then nrpts blocks of [blank, R, nw^2 lines
        "i j re_x im_x re_y im_y re_z im_z"] for the position matrices.
        Entries are indexed by the explicit (i, j) on each line, so any
        writing order is accepted."""
        with open(tb_path, "r") as f:
            ln = f.readlines()
        self.lat = np.array(
            [[float(x) for x in ln[1 + j].split()[:3]] for j in range(3)], dtype=float
        )
        self.num_wan = int(ln[4])
        num_ws = int(ln[5])
        deg_ws = []
        last_j = None
        for j in range(6, len(ln)):
            deg_ws.extend(int(s) for s in ln[j].split())
            if len(deg_ws) == num_ws:
                last_j = j
                break
            if len(deg_ws) > num_ws:
                raise PythtbError("Too many degeneracies for WS points!")
        if last_j is None:
            raise PythtbError("Degeneracy list in _tb.dat is incomplete.")

        nw = self.num_wan
        self.ham_r = {}
        self.pos_r = {}
        block = None  # (R, kind) while consuming nw*nw entry lines
        n_entries = 0
        n_blocks = 0
        for j in range(last_j + 1, len(ln)):
            sp = ln[j].split()
            if not sp:
                continue
            if block is None:
                if len(sp) != 3:
                    raise PythtbError(
                        "Expected an R-vector line in _tb.dat, got: " + ln[j].strip()
                    )
                R = (int(sp[0]), int(sp[1]), int(sp[2]))
                if n_blocks < num_ws:
                    self.ham_r[R] = {
                        "h": np.zeros((nw, nw), dtype=complex),
                        "deg": int(deg_ws[n_blocks]),
                    }
                    block = (R, "ham")
                else:
                    self.pos_r[R] = np.zeros((nw, nw, 3), dtype=complex)
                    block = (R, "pos")
                n_entries = 0
                continue
            R, kind = block
            hi, hj = int(sp[0]) - 1, int(sp[1]) - 1
            if kind == "ham":
                self.ham_r[R]["h"][hi, hj] = float(sp[2]) + 1.0j * float(sp[3])
            else:
                v = [float(x) for x in sp[2:8]]
                self.pos_r[R][hi, hj] = [
                    v[0] + 1.0j * v[1],
                    v[2] + 1.0j * v[3],
                    v[4] + 1.0j * v[5],
                ]
            n_entries += 1
            if n_entries == nw * nw:
                block = None
                n_blocks += 1
        if n_blocks < 2 * num_ws:
            raise PythtbError(
                "_tb.dat ended early: expected %d blocks, found %d"
                % (2 * num_ws, n_blocks)
            )

        # sanity: every nonzero R must have exactly one -R partner
        keys = set(self.ham_r.keys())
        for R in keys:
            if R != (0, 0, 0):
                if (-R[0], -R[1], -R[2]) not in keys:
                    raise PythtbError("Did not find negative R for R = " + str(R) + "!")

        # Wannier centers = diagonal of the home-cell position matrix
        if (0, 0, 0) not in self.pos_r:
            raise PythtbError("_tb.dat has no R=0 position block.")
        self.xyz_cen = np.real(
            np.einsum("iid->id", self.pos_r[(0, 0, 0)])
        ).astype(float)
        self.red_cen = self.xyz_cen @ np.linalg.inv(self.lat.T).T

    # ------------------------------------------------------------------

    @staticmethod
    def _use_half_space(R):
        """Lexicographic R > 0 rule to avoid double-counting R and -R."""
        if R[0] != 0:
            return R[0] > 0
        if R[1] != 0:
            return R[1] > 0
        return R[2] > 0

    def model(self, zero_energy=0.0, min_hopping_norm=None, max_distance=None, ignorable_imaginary_part=None):
        """Build a tb_model from the parsed Wannier90 data.

        Vectorized per R block (filters are NumPy masks; surviving hops
        are bulk-appended), keeping PythTB's hopping order exactly: R in
        file order, then i-major / j-minor."""
        nw = self.num_wan
        tb = tb_model(3, 3, self.lat, self.red_cen)
        tb._assume_position_operator_diagonal = False

        h0 = self.ham_r[(0, 0, 0)]
        onsite = np.diagonal(h0["h"]) / float(h0["deg"])
        if np.abs(onsite.imag).max() > 1.0e-9:
            raise PythtbError("Onsite terms should be real!")
        tb.set_onsite(onsite.real - zero_energy)

        iu, ju = np.triu_indices(nw, k=1)  # R = 0: strict upper triangle
        ia, ja = [x.reshape(-1) for x in np.meshgrid(
            np.arange(nw), np.arange(nw), indexing="ij")]
        for R, entry in self.ham_r.items():
            diagonal_R = R == (0, 0, 0)
            if not diagonal_R and not self._use_half_space(R):
                continue
            ii, jj = (iu, ju) if diagonal_R else (ia, ja)
            amp = entry["h"][ii, jj] / float(entry["deg"])
            keep = np.ones(amp.shape, dtype=bool)
            if max_distance is not None:
                vecR = np.array(R, dtype=float) @ self.lat
                d = -self.xyz_cen[ii] + self.xyz_cen[jj] + vecR
                keep &= np.sqrt(np.sum(d * d, axis=-1)) <= max_distance
            if min_hopping_norm is not None:
                keep &= np.abs(amp) >= min_hopping_norm
            amp = amp[keep]
            if ignorable_imaginary_part is not None:
                amp = np.where(
                    np.abs(amp.imag) < ignorable_imaginary_part, amp.real + 0.0j, amp
                )
            Rs = np.broadcast_to(np.array(R, dtype=int), (amp.shape[0], 3))
            tb._append_scalar_hops(amp, ii[keep], jj[keep], Rs)
        return tb

    # ---- diagnostics -------------------------------------------------

    def _all_dists_hams(self, skip_diagonal_onsite: bool):
        """All (distance, amplitude) pairs in PythTB's iteration order:
        R (file order), then i-major, j-minor."""
        dists, hams = [], []
        for R, entry in self.ham_r.items():
            diagonal_R = R == (0, 0, 0)
            vecR = np.array(R, dtype=float) @ self.lat
            # (i, j) separation vectors, vectorized
            d = -self.xyz_cen[:, None, :] + self.xyz_cen[None, :, :] + vecR
            dist = np.sqrt(np.sum(d * d, axis=-1))  # (nw, nw)
            ham = entry["h"] / float(entry["deg"])
            if skip_diagonal_onsite and diagonal_R:
                mask = ~np.eye(self.num_wan, dtype=bool)
                dists.append(dist[mask])
                hams.append(ham[mask])
            else:
                dists.append(dist.reshape(-1))
                hams.append(ham.reshape(-1))
        return np.concatenate(dists), np.concatenate(hams)

    def dist_hop(self):
        """(distances, hopping amplitudes) for all pairs, for diagnosing
        localization."""
        dist, ham = self._all_dists_hams(skip_diagonal_onsite=True)
        return (dist, ham)

    def shells(self, num_digits=2):
        """Sorted unique distances between Wannier centers, rounded."""
        dist, _ = self._all_dists_hams(skip_diagonal_onsite=False)
        return np.sort(list(set(np.round(dist, num_digits).tolist())))

    def w90_bands_consistency(self):
        """(kpts, energies[band, kpt]) as interpolated by Wannier90
        itself, for cross-checking."""
        kpts = np.loadtxt(self.path + "/" + self.prefix + "_band.kpt", skiprows=1)
        kpts = kpts[:, :3]
        ene = np.loadtxt(self.path + "/" + self.prefix + "_band.dat")
        ene = ene[:, 1]
        ene = ene.reshape((self.num_wan, kpts.shape[0]))
        return (kpts, ene)


def write_w90(model, path, prefix):
    """Export a tb_model as a Wannier90 fileset (the inverse of the
    :class:`w90` reader): writes ``<prefix>.win`` (unit cell),
    ``<prefix>_hr.dat`` (full H(R) blocks, all degeneracies 1) and
    ``<prefix>_centres.xyz`` (Cartesian orbital centers).

    Round trips through the package's own reader are exact to float
    round-off.

    Requirements: fully periodic 3-D model (``dim_k == dim_r == 3``),
    ``nspin == 1`` (the _hr.dat format has no spinor structure -- a
    spinful model must be flattened to 2 nw scalar orbitals first),
    real on-site energies (guaranteed by ``set_onsite``).

    :param model: the tb_model to export
    :param path: output directory (created if missing)
    :param prefix: fileset prefix
    """
    import os

    if model._dim_k != 3 or model._dim_r != 3:
        raise PythtbError("write_w90 requires a fully periodic 3-D model")
    if model._nspin != 1:
        raise PythtbError(
            "write_w90 requires nspin == 1 (flatten spinors to scalar "
            "orbitals first)"
        )
    os.makedirs(path, exist_ok=True)
    lat = np.asarray(model._lat, dtype=np.float64)
    orb = np.asarray(model._orb, dtype=np.float64)
    nw = model._norb

    # H(R) blocks: onsite + hops, Hermitian partner into -R
    ham_r = {(0, 0, 0): np.zeros((nw, nw), dtype=complex)}
    np.fill_diagonal(ham_r[(0, 0, 0)],
                     np.asarray(model._site_energies, dtype=np.float64))
    for h in model._hoppings:
        amp, i, j = complex(h[0]), int(h[1]), int(h[2])
        R = tuple(int(round(x)) for x in np.asarray(h[3]))
        if np.abs(np.asarray(h[3], dtype=np.float64)
                  - np.asarray(R, dtype=np.float64)).max() > 1e-9:
            raise PythtbError(
                "write_w90 requires integer hopping R vectors (got %r)"
                % (h[3],)
            )
        mR = (-R[0], -R[1], -R[2])
        for key in (R, mR):
            if key not in ham_r:
                ham_r[key] = np.zeros((nw, nw), dtype=complex)
        ham_r[R][i, j] += amp
        ham_r[mR][j, i] += np.conj(amp)

    # deterministic R order: lexicographic
    Rs = sorted(ham_r.keys())
    with open(os.path.join(path, prefix + ".win"), "w") as f:
        f.write("! written by pythtb_tpu_torch.w90.write_w90\n")
        f.write("begin unit_cell_cart\nang\n")
        for row in lat:
            f.write("  %.18e %.18e %.18e\n" % tuple(row))
        f.write("end unit_cell_cart\n")
    with open(os.path.join(path, prefix + "_hr.dat"), "w") as f:
        f.write("written by pythtb_tpu_torch.w90.write_w90\n")
        f.write("%12d\n%12d\n" % (nw, len(Rs)))
        for i0 in range(0, len(Rs), 15):
            f.write(" ".join("%5d" % 1 for _ in Rs[i0:i0 + 15]) + "\n")
        for R in Rs:
            H = ham_r[R]
            for j in range(nw):
                for i in range(nw):
                    f.write(
                        "%5d %5d %5d %5d %5d %22.14e %22.14e\n"
                        % (R[0], R[1], R[2], i + 1, j + 1,
                           H[i, j].real, H[i, j].imag)
                    )
    xyz = orb @ lat
    with open(os.path.join(path, prefix + "_centres.xyz"), "w") as f:
        f.write("%d\n" % nw)
        f.write("written by pythtb_tpu_torch.w90.write_w90\n")
        for row in xyz:
            f.write("X %.14f %.14f %.14f\n" % tuple(row))
