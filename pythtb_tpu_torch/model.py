"""The tight-binding model class: pythtb_tpu_torch.tb_model.

Counterpart of ``pythtb_tpu.model`` and API-compatible with PythTB
1.8.0's ``tb_model``: same constructor, ``set_onsite``/``set_hop`` with
set/reset/add modes and conjugate-pair detection, and the k-space
helpers and solvers.  Model construction is host NumPy with an O(1) hash index
over (i, j, R|per); solving freezes the model once into
:class:`pythtb_tpu_torch.core.BlochData` on the chosen device
(:func:`pythtb_tpu_torch.config.set_device`) and runs the whole k-batch
through the batched operators of :mod:`pythtb_tpu_torch.ops`.

Model surgery, position operators and ``visualize``/``display`` are not
ported yet.
"""

from __future__ import annotations

import copy as _copy

import numpy as np

from . import config, core, kspace
from .ops import solver as _solver

__all__ = ["tb_model", "PythtbError"]


def _is_int(a) -> bool:
    return np.issubdtype(type(a), np.integer)


class PythtbError(Exception):
    """Raised on model misuse (mirrors the reference's bare Exceptions)."""


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
