"""The tight-binding model class: pythtb_tpu_torch.tb_model.

Counterpart of ``pythtb_tpu.model`` and API-compatible with PythTB
1.8.0's ``tb_model``: same constructor, ``set_onsite``/``set_hop`` with
set/reset/add modes and conjugate-pair detection, and the k-space
helpers and solvers.  Model construction is host NumPy with an O(1) hash index
over (i, j, R|per); solving freezes the model once into
:class:`pythtb_tpu_torch.core.BlochData` on the chosen device
(:func:`pythtb_tpu_torch.config.set_device`) and runs the whole k-batch
through the batched operators of :mod:`pythtb_tpu_torch.ops`.

Model surgery (``cut_piece``, ``reduce_dim``, ``make_supercell``,
``remove_orb``, ``change_nonperiodic_vector``) is host NumPy, as in
pythtb_tpu; the position operators run through
:mod:`pythtb_tpu_torch.ops.position` (kernel 6) on the device.
``display``, ``hamiltonian_string`` and ``visualize`` are host text and
matplotlib (:mod:`pythtb_tpu_torch.viz`); ``save``/``load`` write and
read the JAX package's ``.npz`` layout
(:mod:`pythtb_tpu_torch.utils.serialization`).
"""

from __future__ import annotations

import copy as _copy

import numpy as np

from . import config, core, kspace
from .ops import position as _pos_ops
from .ops import solver as _solver

__all__ = ["tb_model", "PythtbError"]


def _is_int(a) -> bool:
    return np.issubdtype(type(a), np.integer)


class PythtbError(Exception):
    """Raised on model misuse (mirrors the reference's bare Exceptions)."""


def _offdiag_approximation_warning_and_stop():
    raise PythtbError(
        "This tight-binding model was generated from Wannier90, where the "
        "position operator is not diagonal in the tight-binding basis. "
        "Berry-like quantities computed from it are therefore approximate. "
        "If you want to proceed anyway, call "
        "model.ignore_position_operator_offdiagonal() first."
    )


class tb_model(object):
    r"""Tight-binding model on a dim_r-dimensional lattice with dim_k
    periodic directions.  Parameters match ``pythtb.tb_model``.

    :param dim_k: dimensionality of reciprocal space (0..4)
    :param dim_r: dimensionality of real space (dim_k..4)
    :param lat: (dim_r, dim_r) lattice vectors, Cartesian rows
    :param orb: (norb, dim_r) reduced orbital coordinates (or int count)
    :param per: list of dim_k real-space axes that are periodic
    :param nspin: 1 (spinless) or 2 (explicit spinor components)
    """

    def __init__(self, dim_k, dim_r, lat=None, orb=None, per=None, nspin=1):
        if not _is_int(dim_k):
            raise PythtbError("Argument dim_k not an integer")
        if dim_k < 0 or dim_k > 4:
            raise PythtbError("Argument dim_k out of range. Must be between 0 and 4.")
        self._dim_k = dim_k

        if not _is_int(dim_r):
            raise PythtbError("Argument dim_r not an integer")
        if dim_r < dim_k or dim_r > 4:
            raise PythtbError(
                "Argument dim_r out of range. Must be dim_r>=dim_k and dim_r<=4."
            )
        self._dim_r = dim_r

        if (isinstance(lat, str) and lat == "unit") or lat is None:
            self._lat = np.identity(dim_r, float)
            print(" Lattice vectors not specified! I will use identity matrix.")
        else:
            self._lat = np.array(lat, dtype=float)
            if self._lat.shape != (dim_r, dim_r):
                raise PythtbError("Wrong lat array dimensions")
        if dim_r > 0:
            if np.abs(np.linalg.det(self._lat)) < 1.0e-6:
                raise PythtbError(
                    "Lattice vectors length/area/volume too close to zero, or zero."
                )
            if np.linalg.det(self._lat) < 0.0:
                raise PythtbError("Lattice vectors need to form right handed system.")

        if (isinstance(orb, str) and orb == "bravais") or orb is None:
            self._norb = 1
            self._orb = np.zeros((1, dim_r))
            print(
                " Orbital positions not specified. I will assume a single orbital at the origin."
            )
        elif _is_int(orb):
            self._norb = orb
            self._orb = np.zeros((orb, dim_r))
            print(
                " Orbital positions not specified. I will assume ",
                orb,
                " orbitals at the origin",
            )
        else:
            self._orb = np.array(orb, dtype=float)
            if len(self._orb.shape) != 2:
                raise PythtbError("Wrong orb array rank")
            self._norb = self._orb.shape[0]
            if self._orb.shape[1] != dim_r:
                raise PythtbError("Wrong orb array dimensions")

        if per is None:
            self._per = list(range(self._dim_k))
        else:
            if len(per) != self._dim_k:
                raise PythtbError("Wrong choice of periodic/infinite direction!")
            self._per = list(per)

        if nspin not in [1, 2]:
            raise PythtbError("Wrong value of nspin, must be 1 or 2!")
        self._nspin = nspin

        self._assume_position_operator_diagonal = True
        self._nsta = self._norb * self._nspin

        if self._nspin == 1:
            self._site_energies = np.zeros((self._norb), dtype=float)
        else:
            self._site_energies = np.zeros((self._norb, 2, 2), dtype=complex)
        self._site_energies_specified = np.zeros(self._norb, dtype=bool)

        # hopping table: list of [amp, i, j, ind_R] (ind_R absent if
        # dim_k == 0) plus a hash index keyed on (i, j, R|per)
        self._hoppings = []
        self._hop_index = {}
        self._finalized = None

    # -- internals ------------------------------------------------------

    def __deepcopy__(self, memo):
        """Deep copy skipping the derived ``_finalized`` device tensors."""
        new = self.__class__.__new__(self.__class__)
        memo[id(self)] = new
        for key, value in self.__dict__.items():
            if key == "_finalized":
                new._finalized = None
            else:
                new.__dict__[key] = _copy.deepcopy(value, memo)
        return new

    def _invalidate(self):
        self._finalized = None

    def _hop_key(self, i, j, ind_R):
        if self._dim_k == 0:
            return (int(i), int(j))
        # R is kept exactly as given (non-integer lattice vectors enter
        # the Bloch phase); Python hashes 1.0 and 1 alike
        Rp = tuple(np.asarray(ind_R)[p].item() for p in self._per)
        return (int(i), int(j), Rp)

    def _conj_key(self, i, j, ind_R):
        if self._dim_k == 0:
            return (int(j), int(i))
        Rp = tuple((-np.asarray(ind_R)[p]).item() for p in self._per)
        return (int(j), int(i), Rp)

    def _rebuild_hop_index(self):
        self._hop_index = {}
        for idx, h in enumerate(self._hoppings):
            R = h[3] if self._dim_k != 0 else None
            self._hop_index[self._hop_key(h[1], h[2], R)] = idx

    def _append_scalar_hops(self, amps, ii, jj, ind_R):
        """Bulk-append scalar (nspin=1) hoppings whose keys are known to
        be fresh and conjugate-free (the w90 importer's half-space R rule
        guarantees it), skipping the per-call checks of :meth:`set_hop`.

        amps: (n,) complex; ii, jj: (n,) int; ind_R: (n, dim_r) int.
        """
        base = len(self._hoppings)
        for t in range(len(amps)):
            R = ind_R[t]
            key = (int(ii[t]), int(jj[t]), tuple(R[p].item() for p in self._per))
            self._hop_index[key] = base + t
            self._hoppings.append([complex(amps[t]), int(ii[t]), int(jj[t]), np.array(R)])
        self._invalidate()

    def _get_finalized(self):
        """Freeze the host model state into BlochData on the current device
        (cached until the model changes or the device does)."""
        dev = config.device()
        if self._finalized is None or self._finalized.device != dev:
            amps = [h[0] for h in self._hoppings]
            his = [h[1] for h in self._hoppings]
            hjs = [h[2] for h in self._hoppings]
            if self._dim_k != 0:
                hRs = [h[3] for h in self._hoppings]
            else:
                hRs = [np.zeros(self._dim_r) for _ in self._hoppings]
            self._finalized = core.finalize(
                self._dim_k,
                self._dim_r,
                self._per,
                self._nspin,
                self._norb,
                self._orb,
                self._site_energies,
                amps if amps else np.zeros((0,) if self._nspin == 1 else (0, 2, 2)),
                his,
                hjs,
                hRs,
                dev,
            )
        return self._finalized

    def _val_to_block(self, val):
        """Scalar / Pauli 4-vector / 2x2 block -> stored amplitude."""
        if self._nspin == 1:
            return val
        ret = np.zeros((2, 2), dtype=complex)
        use_val = np.array(val)
        if use_val.shape == ():
            ret[0, 0] += use_val
            ret[1, 1] += use_val
        elif use_val.shape == (4,):
            # coefficients of identity and sigma_x, sigma_y, sigma_z
            ret[0, 0] += use_val[0] + use_val[3]
            ret[1, 1] += use_val[0] - use_val[3]
            ret[0, 1] += use_val[1] - 1.0j * use_val[2]
            ret[1, 0] += use_val[1] + 1.0j * use_val[2]
        elif use_val.shape == (2, 2):
            return use_val
        else:
            raise PythtbError(
                "Wrong format of the on-site or hopping term. Must be single "
                "number, or in the case of a spinfull model can be array of "
                "four numbers or 2x2 matrix."
            )
        return ret

    # -- mutators -------------------------------------------------------

    def set_onsite(self, onsite_en, ind_i=None, mode="set"):
        """Set/reset/add on-site energies."""
        if ind_i is None:
            if len(onsite_en) != self._norb:
                raise PythtbError("Wrong number of site energies")
        else:
            if ind_i < 0 or ind_i >= self._norb:
                raise PythtbError("Index ind_i out of scope.")
        to_check = [onsite_en] if ind_i is not None else onsite_en
        for ons in to_check:
            arr = np.array(ons)
            if arr.shape == ():
                if np.abs(arr - arr.conjugate()) > 1.0e-8:
                    raise PythtbError("Onsite energy should not have imaginary part!")
            elif arr.shape == (4,):
                if np.max(np.abs(arr - arr.conjugate())) > 1.0e-8:
                    raise PythtbError(
                        "Onsite energy or Zeeman field should not have imaginary part!"
                    )
            elif arr.shape == (2, 2):
                if np.max(np.abs(arr - arr.T.conjugate())) > 1.0e-8:
                    raise PythtbError("Onsite matrix should be Hermitian!")
        mode = mode.lower()
        if mode not in ("set", "reset", "add"):
            raise PythtbError("Wrong value of mode parameter")
        if mode == "set":
            if ind_i is not None:
                if self._site_energies_specified[ind_i]:
                    raise PythtbError(
                        'Onsite energy for this site was already specified! '
                        'Use mode="reset" or mode="add".'
                    )
            elif self._site_energies_specified.any():
                raise PythtbError(
                    'Some or all onsite energies were already specified! '
                    'Use mode="reset" or mode="add".'
                )
        targets = [ind_i] if ind_i is not None else list(range(self._norb))
        vals = [onsite_en] if ind_i is not None else list(onsite_en)
        for t, v in zip(targets, vals):
            blk = self._val_to_block(v)
            if self._nspin == 1 and np.ndim(blk) == 0:
                # imaginary part already verified negligible above
                blk = float(np.real(blk))
            if mode == "add":
                self._site_energies[t] += blk
            else:
                self._site_energies[t] = blk
            self._site_energies_specified[t] = True
        self._invalidate()

    def set_hop(self, hop_amp, ind_i, ind_j, ind_R=None, mode="set", allow_conjugate_pair=False):
        """Set/reset/add one hopping <i|H|j+R>.

        The Hermitian partner <j|H|i-R> is always implied and added
        during Hamiltonian assembly.
        """
        if self._dim_k != 0 and (ind_R is None):
            raise PythtbError("Need to specify ind_R!")
        if self._dim_k == 1 and _is_int(ind_R):
            tmpR = np.zeros(self._dim_r, dtype=int)
            tmpR[self._per] = ind_R
            ind_R = tmpR
        if self._dim_k != 0:
            if len(ind_R) != self._dim_r:
                raise PythtbError(
                    "Length of input ind_R vector must equal dim_r! Even if dim_k<dim_r."
                )
        if ind_i < 0 or ind_i >= self._norb:
            raise PythtbError("Index ind_i out of scope.")
        if ind_j < 0 or ind_j >= self._norb:
            raise PythtbError("Index ind_j out of scope.")
        # on-site terms through set_hop would be double counted
        if self._dim_k == 0:
            if ind_i == ind_j:
                raise PythtbError(
                    "Do not use set_hop for onsite terms. Use set_onsite instead!"
                )
        else:
            if ind_i == ind_j and all(int(ind_R[k]) == 0 for k in self._per):
                raise PythtbError(
                    "Do not use set_hop for onsite terms. Use set_onsite instead!"
                )

        if self._dim_k != 0:
            # kept uncast: fractional R is legal and enters the Bloch phase
            ind_R = np.array(ind_R)

        key = self._hop_key(ind_i, ind_j, ind_R)
        if not allow_conjugate_pair:
            ckey = self._conj_key(ind_i, ind_j, ind_R)
            if ckey in self._hop_index:
                raise PythtbError(
                    "Following matrix element was already implicitly specified: "
                    "i=%s j=%s%s. Specifying <i|H|j+R> automatically specifies "
                    "<j|H|i-R>; specify all hoppings for a given bond in the "
                    "same direction, or see the allow_conjugate_pair flag."
                    % (ind_i, ind_j, "" if self._dim_k == 0 else " R=" + str(ind_R))
                )

        hop_use = self._val_to_block(hop_amp)
        if self._dim_k == 0:
            new_hop = [hop_use, int(ind_i), int(ind_j)]
        else:
            new_hop = [hop_use, int(ind_i), int(ind_j), np.array(ind_R)]

        use_index = self._hop_index.get(key)
        mode = mode.lower()
        if mode == "set":
            if use_index is not None:
                raise PythtbError(
                    'Hopping energy for this site was already specified! '
                    'Use mode="reset" or mode="add".'
                )
            self._hop_index[key] = len(self._hoppings)
            self._hoppings.append(new_hop)
        elif mode == "reset":
            if use_index is not None:
                self._hoppings[use_index] = new_hop
            else:
                self._hop_index[key] = len(self._hoppings)
                self._hoppings.append(new_hop)
        elif mode == "add":
            if use_index is not None:
                self._hoppings[use_index][0] = self._hoppings[use_index][0] + new_hop[0]
            else:
                self._hop_index[key] = len(self._hoppings)
                self._hoppings.append(new_hop)
        else:
            raise PythtbError("Wrong value of mode parameter")
        self._invalidate()

    # -- accessors ------------------------------------------------------

    def get_num_orbitals(self):
        "Returns number of orbitals in the model."
        return self._norb

    def get_orb(self):
        "Returns reduced coordinates of orbitals, [orbital, coordinate]."
        return self._orb.copy()

    def get_lat(self):
        "Returns lattice vectors, [vector, coordinate]."
        return self._lat.copy()

    def ignore_position_operator_offdiagonal(self):
        """Allow approximate Berry-like quantities on w90-derived models."""
        self._assume_position_operator_diagonal = True

    # -- solving --------------------------------------------------------

    def solve_all(self, k_list=None, eig_vectors=False):
        """Diagonalize the Bloch Hamiltonian on a list of k-points, the
        whole batch at once on the current device.

        :param k_list: (nkp, dim_k) reduced k-points; omit for dim_k=0
        :param eig_vectors: also return eigenvectors
        :returns: ``eval[band, kpt]`` float, ascending per k-point (or
          ``eval[band]`` for dim_k=0); with ``eig_vectors``, also
          ``evec[band, kpt, orb(, spin)]`` complex (Convention I)

        Example::

            k_vec, k_dist, k_node = model.k_path([[0, 0], [0.5, 0.5]], 51)
            evals = model.solve_all(k_vec)              # (nsta, 51)
        """
        if k_list is None:
            if self._dim_k != 0:
                raise PythtbError("Have to provide a k-vector!")
            data = self._get_finalized()
            if not eig_vectors:
                return _solver.solve_kpts(data, None, False)[0]
            w, v = _solver.solve_kpts(data, None, True)
            return w[0], v[0]
        if self._dim_k == 0:
            raise PythtbError(
                "k-vector of wrong shape: this model has dim_k=0, call "
                "solve_all() without a k_list"
            )
        data = self._get_finalized()
        if not eig_vectors:
            w = _solver.solve_kpts(data, k_list, False)
            return np.ascontiguousarray(w.T)  # [band, kpt]
        w, v = _solver.solve_kpts(data, k_list, True)
        # internal [kpt, band, ...] -> reference [band, kpt, ...]
        w = np.ascontiguousarray(w.T)
        v = np.ascontiguousarray(np.moveaxis(v, 0, 1))
        return w, v

    # -- reports, pictures and files --------------------------------------

    def display(self):
        """Print a text report of the model (PythTB's ``display``)."""
        from .viz import display as _display

        _display(self)

    def hamiltonian_string(self, precision=4):
        """Closed-form text of the Bloch Hamiltonian H(k): diagonal entries
        as ``2|t|cos(2*pi*k.rv + arg)`` terms, off-diagonal ones as complex
        exponentials (upper triangle; k reduced)."""
        from .viz import hamiltonian_string as _hs

        return _hs(self, precision=precision)

    def visualize(self, dir_first, dir_second=None, eig_dr=None, draw_hoppings=True, ph_color="black", annotate_hoppings=False):
        """Matplotlib sketch of the model geometry or of an eigenstate
        (PythTB's ``visualize``); ``annotate_hoppings=True`` labels each
        bond with its amplitude.  Returns (fig, ax)."""
        from .viz import visualize as _visualize

        return _visualize(self, dir_first, dir_second, eig_dr, draw_hoppings, ph_color, annotate_hoppings)

    def save(self, path):
        """Serialize this model to a compressed .npz file (no pickle), in
        the JAX package's layout."""
        from .utils.serialization import save_model

        save_model(self, path)

    @staticmethod
    def load(path):
        """Load a model written with :meth:`save` (by either package)."""
        from .utils.serialization import load_model

        return load_model(path)

    def solve_one(self, k_point=None, eig_vectors=False):
        """Like solve_all for a single k-point."""
        if k_point is None:
            return self.solve_all(eig_vectors=eig_vectors)
        if not eig_vectors:
            return self.solve_all([k_point], eig_vectors=False)[:, 0]
        w, v = self.solve_all([k_point], eig_vectors=True)
        return w[:, 0], v[:, 0]

    def gen_ham(self, k_list=None):
        """Dense Bloch Hamiltonian(s): (nkp, nsta, nsta) complex for a
        k-list, (nsta, nsta) for dim_k=0.  The nspin=2 basis is
        (orb, spin) flattened."""
        if k_list is None and self._dim_k != 0:
            raise PythtbError("Have to provide a k-vector!")
        if k_list is not None and self._dim_k == 0:
            raise PythtbError("k-vector of wrong shape (model has dim_k=0)!")
        H = _solver.hamiltonian_kpts(self._get_finalized(), k_list)
        if k_list is None:
            return H[0]
        return H

    # -- k-space helpers ------------------------------------------------

    def k_uniform_mesh(self, mesh_size):
        """Gamma-inclusive uniform k-mesh, (prod(mesh_size), dim_k)."""
        return kspace.k_uniform_mesh(self._dim_k, mesh_size)

    def k_path(self, kpts, nk, report=True):
        """Near-equidistant k-path through the given nodes: returns
        ``(k_vec (nk, dim_k), k_dist (nk,), k_node (nnodes,))``."""
        return kspace.k_path(self._lat, self._per, self._dim_k, kpts, nk, report)

    # -- position operator ----------------------------------------------

    def _check_position_dir(self, dir):
        if dir in self._per:
            raise PythtbError(
                "Can not compute position matrix elements along periodic direction!"
            )
        if dir < 0 or dir >= self._dim_r:
            raise PythtbError("Direction out of range!")
        if self._assume_position_operator_diagonal is False:
            _offdiag_approximation_warning_and_stop()

    def _pos_weights(self, dir):
        pos = self._orb[:, dir]
        if self._nspin == 2:
            pos = np.repeat(pos, 2)
        return pos

    def _flatten_states(self, evec):
        evec = np.asarray(evec, dtype=complex)
        if self._nspin == 2:
            return evec.reshape(evec.shape[:-2] + (evec.shape[-2] * 2,))
        return evec

    def position_matrix(self, evec, dir):
        """X[m, n] = <u_m| r_dir |u_n> in the diagonal-position
        approximation, for states ``evec`` (..., nb, norb[, 2])."""
        self._check_position_dir(dir)
        X = _pos_ops.position_matrix_host(self._flatten_states(evec), self._pos_weights(dir))
        # Hermiticity sanity check of the reference, at its float64 tolerance
        scale = max(1.0, float(np.max(np.abs(X))))
        if np.max(np.abs(X - np.swapaxes(X, -1, -2).conj())) > 1.0e-9 * scale:
            raise PythtbError("Position matrix is not hermitian?!")
        return X

    def position_expectation(self, evec, dir):
        """Diagonal of the position matrix."""
        self._check_position_dir(dir)
        X = self.position_matrix(evec, dir)
        return np.array(np.real(np.diagonal(X, axis1=-2, axis2=-1)), dtype=float)

    def position_hwf(self, evec, dir, hwf_evec=False, basis="orbital"):
        """Hybrid-Wannier centers (and functions) from eigen-decomposing
        the position matrix."""
        self._check_position_dir(dir)
        wfs = self._flatten_states(evec)
        pos = self._pos_weights(dir)
        basis = basis.lower().strip()
        if not hwf_evec:
            return _pos_ops.position_hwf_host(wfs, pos, want_evec=False)
        if basis in ("wavefunction", "bloch"):
            return _pos_ops.position_hwf_host(wfs, pos, want_evec=True, orbital_basis=False)
        elif basis == "orbital":
            hwfc, hwf = _pos_ops.position_hwf_host(wfs, pos, want_evec=True, orbital_basis=True)
            if self._nspin == 2:
                hwf = hwf.reshape(hwf.shape[:-1] + (self._norb, 2))
            return hwfc, hwf
        else:
            raise PythtbError(
                "Basis must be either 'wavefunction', 'bloch', or 'orbital'"
            )

    # -- diagnostics -----------------------------------------------------

    def validate(self, k_list=None, tol=1.0e-9):
        """Opt-in invariant checks: finite lattice/orbital/hopping data,
        in-range hopping indices, and Hermiticity of the assembled Bloch
        Hamiltonian at the given k-points (default: a small random
        sample).  Raises :class:`PythtbError`; returns self."""
        if not np.all(np.isfinite(self._lat)):
            raise PythtbError("Lattice vectors contain non-finite entries")
        if not np.all(np.isfinite(self._orb)):
            raise PythtbError("Orbital coordinates contain non-finite entries")
        if not np.all(np.isfinite(np.asarray(self._site_energies))):
            raise PythtbError("Site energies contain non-finite entries")
        for h in self._hoppings:
            if not (0 <= h[1] < self._norb and 0 <= h[2] < self._norb):
                raise PythtbError("Hopping with out-of-range orbital index")
            if not np.all(np.isfinite(np.asarray(h[0], dtype=complex))):
                raise PythtbError("Hopping amplitude is non-finite")
        if self._dim_k == 0:
            H = self.gen_ham()[None]
        elif k_list is None:
            rng = np.random.RandomState(0)
            H = self.gen_ham(rng.rand(4, self._dim_k))
        else:
            H = self.gen_ham(k_list)
        herm = np.abs(H - np.conj(np.swapaxes(H, -1, -2))).max()
        if herm > tol:
            raise PythtbError(
                "Assembled Hamiltonian is not Hermitian (max dev %.3e)" % herm
            )
        if not np.all(np.isfinite(H)):
            raise PythtbError("Assembled Hamiltonian contains non-finite entries")
        return self

    # -- model surgery ---------------------------------------------------

    def cut_piece(self, num, fin_dir, glue_edgs=False, trim_first=None, trim_last=None):
        """Cut a finite piece: repeat the cell ``num`` times along
        periodic direction ``fin_dir`` and make it non-periodic.

        Orbital i of cell copy n gets index ``i + norb*n``; hoppings that
        spill past the edge are dropped (or wrapped around when
        ``glue_edgs=True``).  ``trim_first``/``trim_last`` list
        original-cell orbitals to drop from the first/last copy (open
        edges only).  Returns a NEW tb_model with dim_k reduced by one.
        """
        if trim_first is not None or trim_last is not None:
            if glue_edgs:
                raise PythtbError(
                    "Edge trimming (trim_first/trim_last) requires open "
                    "edges (glue_edgs=False)."
                )
            tf = np.atleast_1d(trim_first if trim_first is not None else []).astype(int)
            tl = np.atleast_1d(trim_last if trim_last is not None else []).astype(int)
            for idx in list(tf) + list(tl):
                if not (0 <= idx < self._norb):
                    raise PythtbError(
                        "trim_first/trim_last entries are original-cell "
                        "orbital indices (0..%d)." % (self._norb - 1)
                    )
            cut = self.cut_piece(num, fin_dir, glue_edgs=False)
            drop = sorted(set(list(tf) + [int(i) + self._norb * (num - 1) for i in tl]))
            return cut.remove_orb(drop) if drop else cut
        if self._dim_k == 0:
            raise PythtbError("Model is already finite")
        if not _is_int(num):
            raise PythtbError("Argument num not an integer")
        if num < 1:
            raise PythtbError("Argument num must be positive!")
        if num == 1 and glue_edgs:
            raise PythtbError("Can't have num==1 and glueing of the edges!")
        if self._per.count(fin_dir) != 1:
            raise PythtbError("Can not make model finite along this direction!")

        fin_orb = np.concatenate(
            [self._orb + np.eye(self._dim_r)[fin_dir] * float(c) for c in range(num)],
            axis=0,
        )
        onsite = np.concatenate([self._site_energies for _ in range(num)], axis=0)

        fin_per = [p for p in self._per if p != fin_dir]
        fin_model = tb_model(
            self._dim_k - 1, self._dim_r, _copy.deepcopy(self._lat), fin_orb, fin_per,
            self._nspin,
        )
        fin_model._assume_position_operator_diagonal = (
            self._assume_position_operator_diagonal
        )
        fin_model.set_onsite(onsite, mode="reset")

        for c in range(num):
            for h in self._hoppings:
                amp = h[0]
                ind_R = np.array(h[3], dtype=int)
                jump_fin = int(ind_R[fin_dir])
                if fin_model._dim_k != 0:
                    ind_R = ind_R.copy()
                    ind_R[fin_dir] = 0
                hi = h[1] + c * self._norb
                hj = h[2] + (c + jump_fin) * self._norb
                if not glue_edgs:
                    if hj < 0 or hj >= self._norb * num:
                        continue
                else:
                    hj = int(hj) % int(self._norb * num)
                if fin_model._dim_k == 0:
                    fin_model.set_hop(amp, hi, hj, mode="add", allow_conjugate_pair=True)
                else:
                    fin_model.set_hop(amp, hi, hj, ind_R, mode="add", allow_conjugate_pair=True)
        return fin_model

    def reduce_dim(self, remove_k, value_k):
        """Freeze reduced momentum component ``remove_k`` at ``value_k``:
        its Bloch phase is baked into the amplitudes, and hops that become
        on-site fold together with their conjugates.  Returns a NEW
        tb_model with dim_k reduced by one."""
        if self._dim_k == 0:
            raise PythtbError("Can not reduce dimensionality even further!")
        red_tb = _copy.deepcopy(self)
        red_tb._invalidate()
        red_tb._per = [p for p in self._per if p != remove_k]
        red_tb._dim_k = len(red_tb._per)
        if red_tb._dim_k != self._dim_k - 1:
            raise PythtbError("Specified wrong dimension to reduce!")
        red_tb._hoppings = []
        red_tb._hop_index = {}
        for h in self._hoppings:
            if self._nspin == 1:
                amp = complex(h[0])
            else:
                amp = np.array(h[0], dtype=complex)
            i, j = h[1], h[2]
            ind_R = np.array(h[3], dtype=int)
            rv = (-self._orb[i, :] + self._orb[j, :] + ind_R.astype(float))[remove_k]
            phase = np.exp((2.0j) * np.pi * (value_k * rv))
            if i == j and np.all(ind_R[red_tb._per] == 0):
                if ind_R[remove_k] == 0:
                    red_tb.set_onsite(amp * phase, i, mode="add")
                else:
                    # R and -R would both have contributed
                    if self._nspin == 1:
                        red_tb.set_onsite(amp * phase + (amp * phase).conj(), i, mode="add")
                    else:
                        red_tb.set_onsite(amp * phase + (amp.T * phase).conj(), i, mode="add")
            else:
                ind_R = ind_R.copy()
                ind_R[remove_k] = 0
                red_tb.set_hop(amp * phase, i, j, ind_R, mode="add", allow_conjugate_pair=True)
        return red_tb

    def change_nonperiodic_vector(self, np_dir, new_latt_vec=None, to_home=True, to_home_suppress_warning=False, to_home_compat="intent"):
        """Re-choose one nonperiodic lattice vector (by default the
        original projected perpendicular to all periodic vectors),
        keeping Cartesian orbital positions fixed."""
        if self._per.count(np_dir) == 1:
            raise PythtbError("Selected direction is not nonperiodic")

        if new_latt_vec is None:
            per_temp = np.zeros_like(self._lat)
            for direc in self._per:
                per_temp[direc] = self._lat[direc]
            coeffs = np.linalg.lstsq(per_temp.T, self._lat[np_dir], rcond=None)[0]
            projec = np.dot(self._lat.T, coeffs)
            np_lattice_vec = self._lat[np_dir] - projec
        else:
            np_lattice_vec = np.array(new_latt_vec)
            if np_lattice_vec.shape != (self._dim_r,):
                raise PythtbError("Nonperiodic vector has wrong length")

        np_lat = _copy.deepcopy(self._lat)
        np_lat[np_dir] = np_lattice_vec
        np_orb = []
        for orb in self._orb:
            orb_cart = np.dot(self._lat.T, orb)
            np_orb.append(np.linalg.solve(np_lat.T, orb_cart))

        nnp_tb = _copy.deepcopy(self)
        nnp_tb._invalidate()
        nnp_tb._lat = np.array(np_lat, dtype=float)
        nnp_tb._orb = np.array(np_orb, dtype=float)

        if new_latt_vec is None:
            for i in nnp_tb._per:
                if np.abs(np.dot(nnp_tb._lat[i], nnp_tb._lat[np_dir])) > 1.0e-6:
                    raise PythtbError(
                        "New nonperiodic vector is not perpendicular to periodic vectors!?"
                    )
        for i in range(self._orb.shape[0]):
            cart_old = np.dot(self._lat.T, self._orb[i])
            cart_new = np.dot(nnp_tb._lat.T, nnp_tb._orb[i])
            if np.max(np.abs(cart_old - cart_new)) > 1.0e-6:
                raise PythtbError(
                    "New choice of nonperiodic vector changed Cartesian coordinates of orbitals."
                )
        if np.abs(np.linalg.det(nnp_tb._lat)) < 1.0e-6:
            raise PythtbError(
                "Lattice with new choice of nonperiodic vector has zero volume?!"
            )
        if to_home:
            nnp_tb._shift_to_home(to_home_suppress_warning, compat=to_home_compat)
        return nnp_tb

    def make_supercell(self, sc_red_lat, return_sc_vectors=False, to_home=True, to_home_suppress_warning=False, to_home_compat="intent"):
        """Build a supercell model.  ``sc_red_lat`` is an integer matrix
        whose rows are the new lattice vectors in units of the old ones;
        hoppings are re-folded into the new cell.  Returns a NEW tb_model
        (and, with ``return_sc_vectors``, the old-cell positions inside
        the new cell)."""
        if self._dim_r == 0:
            raise PythtbError(
                "Must have at least one periodic direction to make a super-cell"
            )
        use_sc_red_lat = np.array(sc_red_lat)
        if use_sc_red_lat.shape != (self._dim_r, self._dim_r):
            raise PythtbError("Dimension of sc_red_lat array must be dim_r*dim_r")
        if use_sc_red_lat.dtype != int:
            raise PythtbError("sc_red_lat array elements must be integers")
        for i in range(self._dim_r):
            for j in range(self._dim_r):
                if (i == j) and (i not in self._per) and use_sc_red_lat[i, j] != 1:
                    raise PythtbError(
                        "Diagonal elements of sc_red_lat for non-periodic directions must equal 1."
                    )
                if (
                    (i != j)
                    and ((i not in self._per) or (j not in self._per))
                    and use_sc_red_lat[i, j] != 0
                ):
                    raise PythtbError(
                        "Off-diagonal elements of sc_red_lat for non-periodic directions must equal 0."
                    )
        if np.abs(np.linalg.det(use_sc_red_lat)) < 1.0e-6:
            raise PythtbError(
                "Super-cell lattice vectors length/area/volume too close to zero, or zero."
            )
        if np.linalg.det(use_sc_red_lat) < 0.0:
            raise PythtbError(
                "Super-cell lattice vectors need to form right handed system."
            )

        scT = np.array(use_sc_red_lat.T, dtype=float)
        scT_inv = np.linalg.inv(scT)

        def to_red_sc(vec):
            # np.linalg.solve, for the reference's rounding at exact-integer
            # boundaries
            return np.linalg.solve(scT, np.asarray(vec, dtype=float))

        # candidate old-cell vectors over [-max_R, max_R]^dim_r
        max_R = int(np.max(np.abs(use_sc_red_lat)) * self._dim_r)
        rng = np.arange(-max_R, max_R + 1)
        grids = np.meshgrid(*([rng] * self._dim_r), indexing="ij")
        cands = np.stack([g.reshape(-1) for g in grids], axis=-1)
        red = cands.astype(float) @ scT_inv.T
        eps_shift = np.sqrt(2.0) * 1.0e-8
        inside = np.all((red > -eps_shift) & (red <= 1.0 - eps_shift), axis=1)
        sc_vec = cands[inside]
        num_sc = sc_vec.shape[0]
        if int(round(np.abs(np.linalg.det(use_sc_red_lat)))) != num_sc:
            raise PythtbError(
                "Super-cell generation failed! Wrong number of super-cell vectors found."
            )

        sc_cart_lat = np.dot(use_sc_red_lat, self._lat)
        sc_orb = (
            (self._orb[None, :, :] + sc_vec[:, None, :].astype(float)) @ scT_inv.T
        ).reshape(num_sc * self._norb, self._dim_r)

        sc_tb = tb_model(
            self._dim_k, self._dim_r, sc_cart_lat, sc_orb, per=self._per, nspin=self._nspin
        )
        sc_tb._assume_position_operator_diagonal = (
            self._assume_position_operator_diagonal
        )
        sc_onsite = np.concatenate([self._site_energies for _ in range(num_sc)], axis=0)
        sc_tb.set_onsite(sc_onsite, mode="reset")

        pair_lookup = {tuple(v): p for p, v in enumerate(sc_vec)}
        for c, cur_sc_vec in enumerate(sc_vec):
            for h in self._hoppings:
                amp = h[0]
                ind_R = np.array(h[3], dtype=int)
                shifted = ind_R + cur_sc_vec
                sc_part = np.floor(to_red_sc(shifted)).astype(int)
                orig_part = shifted - sc_part @ use_sc_red_lat
                pair_ind = pair_lookup.get(tuple(orig_part))
                if pair_ind is None:
                    raise PythtbError("Did not find super cell vector!")
                hi = h[1] + c * self._norb
                hj = h[2] + pair_ind * self._norb
                sc_tb.set_hop(amp, hi, hj, sc_part, mode="add", allow_conjugate_pair=True)

        if to_home:
            sc_tb._shift_to_home(to_home_suppress_warning, compat=to_home_compat)
        if not return_sc_vectors:
            return sc_tb
        return (sc_tb, [np.array(v) for v in sc_vec])

    def _shift_to_home(self, to_home_suppress_warning=False, compat="intent"):
        """Shift orbital reduced coordinates along *periodic* directions
        into [0, 1), refolding hop R-vectors accordingly.

        ``compat="intent"`` (default) shifts every orbital, the documented
        intent of PythTB's ``_shift_to_home``.  ``compat="snapshot"``
        reproduces the PythTB 1.8.0 snapshot bit for bit: only the last
        orbital is shifted, and nothing at all when
        ``to_home_suppress_warning=True``."""
        if compat not in ("intent", "snapshot"):
            raise PythtbError("_shift_to_home: compat must be 'intent' or 'snapshot'")
        warning_list = [[] for _ in range(self._dim_r)]
        disp = np.zeros((self._norb, self._dim_r), dtype=int)
        for i in range(self._norb):
            for k in range(self._dim_r):
                shift = int(np.floor(self._orb[i, k] + 1.0e-6))
                if k in self._per:
                    disp[i, k] = shift
                elif shift != 0:
                    warning_list[k].append(i)

        if not to_home_suppress_warning:
            warn_str = ""
            for k in range(self._dim_r):
                if warning_list[k]:
                    warn_str += "  * Direction %1d : Orbitals " % k + ", ".join(
                        str(e) for e in warning_list[k]
                    ) + "\n"
            if warn_str != "":
                print(
                    "  WARNING from '_shift_to_home': orbitals are not shifted to\n"
                    "  home along non-periodic directions (matching PythTB >= 1.7.3\n"
                    "  semantics).  Affected:\n" + warn_str
                )

        if compat == "snapshot":
            if to_home_suppress_warning:
                return
            keep = np.zeros(self._norb, dtype=bool)
            keep[-1] = True
            disp = np.where(keep[:, None], disp, 0)

        self._orb = self._orb - disp
        if self._dim_k != 0:
            for h in self._hoppings:
                h[3] = h[3] - disp[h[1]] + disp[h[2]]
            self._rebuild_hop_index()
        self._invalidate()

    def remove_orb(self, to_remove):
        """Return a model with the listed orbitals (and incident
        hoppings) removed; survivors are reindexed in order."""
        if _is_int(to_remove):
            orb_index = [to_remove]
        else:
            orb_index = list(_copy.deepcopy(to_remove))
        for orb_ind in orb_index:
            if orb_ind < 0 or orb_ind > self._norb - 1 or (not _is_int(orb_ind)):
                raise PythtbError("Specified wrong orbitals to remove!")
        if len(set(orb_index)) != len(orb_index):
            raise PythtbError("Specified duplicate orbitals to remove!")

        remove_set = set(orb_index)
        keep = [i for i in range(self._norb) if i not in remove_set]
        remap = {old: new for new, old in enumerate(keep)}

        ret = _copy.deepcopy(self)
        ret._invalidate()
        ret._norb = len(keep)
        ret._nsta = ret._norb * self._nspin
        ret._orb = self._orb[keep]
        ret._site_energies = self._site_energies[keep]
        ret._site_energies_specified = self._site_energies_specified[keep]
        ret._hoppings = []
        ret._hop_index = {}
        for h in self._hoppings:
            if h[1] in remove_set or h[2] in remove_set:
                continue
            nh = [h[0], remap[h[1]], remap[h[2]]]
            if self._dim_k != 0:
                nh.append(np.array(h[3]))
            R = nh[3] if self._dim_k != 0 else None
            ret._hop_index[ret._hop_key(nh[1], nh[2], R)] = len(ret._hoppings)
            ret._hoppings.append(nh)
        return ret
