"""Wavefunction grids and Berry-phase quantities: pythtb_tpu_torch.wf_array.

Counterpart of ``pythtb_tpu.wf_array`` and API-compatible with PythTB
1.8.0's ``wf_array``: a (n1..nd, nsta, norb[, spin]) complex array of
states over a 1-4 dimensional grid, with periodic-gauge boundary
fixups, Berry phases / Wilson loops and Berry fluxes.

Storage is device-resident with a lazy host view.  ``solve_on_grid``
builds and solves the grid on the device and leaves the states there;
the Berry methods read the device copy.  Host-side mutation
(``wf[i, j] = evec``, ``impose_pbc``) materializes the NumPy view and
marks the device copy stale, preserving reference semantics, including
mutation through views returned by ``wf[key]``.

The position wrappers (per grid point, and batched over the whole grid
as ``position_expectation_all``/``position_hwf_all``) run through
:mod:`pythtb_tpu_torch.ops.position` (kernel 6).  ``solve_on_grid_models``
fills a (parameter x k-grid) array from a family of models (kernel 1's
member mode when they share one hopping graph); ``smooth_gauge`` and
``adiabatic_evolve`` run through :mod:`pythtb_tpu_torch.ops.transport`
(kernel 14); ``save``/``load`` checkpoint to the JAX package's ``.npz``
layout.
"""

from __future__ import annotations

import copy as _copy
import warnings

import numpy as np
import torch

from . import config
from .model import PythtbError, _is_int, _offdiag_approximation_warning_and_stop
from .ops import berry as _berry
from .ops import position as _pos
from .ops import solver as _solver
from .ops import transport as _transport
from .utils import continuity as _cont

__all__ = ["wf_array"]


class wf_array(object):
    r"""Array of wavefunctions over a regular 1-4 dimensional grid.

    :param model: associated :class:`pythtb_tpu_torch.tb_model`
    :param mesh_arr: list of mesh dimensions (each >= 2)
    :param nsta_arr: optional number of states stored per grid point
      (defaults to all norb*nspin states)
    """

    def __init__(self, model, mesh_arr, nsta_arr=None):
        if nsta_arr is None:
            self._nsta_arr = model._nsta
        else:
            if not _is_int(nsta_arr):
                raise PythtbError("Argument nsta_arr not an integer")
            self._nsta_arr = nsta_arr
        self._nspin = model._nspin
        self._norb = model._norb
        self._orb = np.copy(model._orb)
        self._model = _copy.deepcopy(model)
        self._mesh_arr = np.array(mesh_arr)
        self._dim_arr = len(self._mesh_arr)
        if True in (self._mesh_arr <= 1).tolist():
            raise PythtbError(
                "Dimension of wf_array object in each direction must be 2 or larger."
            )
        wfs_dim = list(self._mesh_arr) + [self._nsta_arr, self._norb]
        if self._nspin == 2:
            wfs_dim += [self._nspin]
        # host storage: _wfs[k1_index, ..., state, orb(, spin)]
        self._host = np.zeros(tuple(wfs_dim), dtype=complex)
        self._host_valid = True
        # device storage: complex tensor twin of _host
        self._dev = None
        self._dev_valid = False
        # once a live NumPy view of _host has been handed out (wf[key] /
        # the _wfs property), external code can mutate storage at any
        # later time without notice, so device uploads are never cached
        # again for this object
        self._views_exposed = False
        # band energies: a device tensor from solve_on_grid, or host
        self._energies_dev = None
        self._energies_host = None
        # per-band-pair minimum direct gaps from solve_on_grid (host)
        self._min_gaps = None

    # -- storage management ---------------------------------------------

    def _sync_host(self):
        if not self._host_valid:
            fresh = self._dev.cpu().numpy()
            if self._host is not None and self._host.shape == fresh.shape:
                # copy IN PLACE so NumPy views handed out earlier stay
                # aliased to the storage (reference semantics)
                np.copyto(self._host, fresh)
            else:
                self._host = np.array(fresh, copy=True)
            self._host_valid = True

    def _host_rw(self, exposes_view=False):
        """Host array for mutation; the device copy becomes stale and is
        released, and so is the solve-derived ``_min_gaps``."""
        self._sync_host()
        self._dev = None
        self._dev_valid = False
        self._min_gaps = None
        if exposes_view:
            self._views_exposed = True
        return self._host

    def _host_ro(self):
        """Host array for read-only use; device copy stays valid."""
        self._sync_host()
        return self._host

    def _device_states(self):
        """Device-resident states (uploads the host copy if stale); the
        counterpart of pythtb_tpu's ``_packed``, without ri-packing.

        The upload is cached only while no external views of the host
        array exist; afterwards every device op re-uploads, so writes
        through old views are always honored."""
        if self._dev_valid:
            return self._dev
        dev = torch.as_tensor(self._host_ro(), dtype=config.COMPLEX).to(
            config.checked_device(), copy=True
        )
        if not self._views_exposed:
            self._dev = dev
            self._dev_valid = True
        return dev

    def _set_device(self, wfs):
        self._dev = wfs
        self._dev_valid = True
        self._host_valid = False
        if self._views_exposed:
            # live views must see the new data now and may mutate it
            # later: materialize in place and release the device copy
            self._sync_host()
            self._dev = None
            self._dev_valid = False

    @property
    def _wfs(self):
        """Reference-compatible mutable host view of the stored states."""
        return self._host_rw(exposes_view=True)

    @_wfs.setter
    def _wfs(self, value):
        self._host = np.asarray(value, dtype=complex)
        self._host_valid = True
        self._dev_valid = False

    # -- population -----------------------------------------------------

    def solve_on_grid(self, start_k):
        """Solve the model on a uniform grid covering the BZ (both
        endpoints included, the last point fixed by the periodic gauge),
        on the device.  Returns the minimum direct gap per band pair."""
        if self._dim_arr != self._model._dim_k:
            raise PythtbError(
                "If using solve_on_grid method, dimension of wf_array must equal "
                "dim_k of the tight-binding model!"
            )
        if self._nsta_arr != self._model._nsta:
            raise PythtbError(
                "solve_on_grid requires nsta_arr to match the model's total number "
                "of states (do not pass nsta_arr when initializing this object)."
            )
        if self._dim_arr > 4:
            raise PythtbError("Wrong dimensionality!")
        min_gaps, evals_dev, wfs = _solver.solve_grid_device(
            self._model._get_finalized(),
            [int(m) for m in self._mesh_arr],
            start_k,
            self._orb,
            self._model._per,
            self._nspin,
        )
        self._set_device(wfs)
        self._energies_dev = evals_dev
        self._energies_host = None
        self._min_gaps = np.array(min_gaps) if self._nsta_arr > 1 else None
        if self._nsta_arr <= 1:
            return None
        return min_gaps

    def solve_on_grid_models(self, models, param_dir=0, start_k=None):
        """Fill a (parameter x k-grid) wf_array from a family of models,
        one per index along ``param_dir`` (pump cycles, adiabatic
        interpolations, any lambda x BZ workflow).

        When all models share one hopping graph (same hoppings, orbital
        positions and periodic axes; a sweep over amplitudes and on-site
        terms), the whole family is assembled in one launch of kernel 1's
        member mode and solved in one batched eigensolve; otherwise each
        model gets its own grid solve.  The k-axes get the periodic gauge
        of :meth:`solve_on_grid`; close the parameter axis yourself
        (``impose_loop(param_dir)`` / ``impose_pbc``) if it is cyclic.
        Band energies are stored (see :attr:`energies`).

        :param models: sequence of models, ``len(models) ==
          mesh_arr[param_dir]``, each with ``dim_k == dim_arr - 1``
        :param param_dir: which grid axis is the parameter axis
        :param start_k: origin of the k-grid (default zeros)
        :returns: minimum direct gap per band pair over the whole family,
          or None for 1 stored state
        """
        models = list(models)
        if param_dir < 0 or param_dir >= self._dim_arr:
            raise PythtbError("Wrong value of param_dir.")
        if len(models) != int(self._mesh_arr[param_dir]):
            raise PythtbError(
                "Expected %d models along axis %d, got %d"
                % (int(self._mesh_arr[param_dir]), param_dir, len(models))
            )
        k_sizes = [int(m) for d, m in enumerate(self._mesh_arr) if d != param_dir]
        fins = [m._get_finalized() for m in models]
        for m in models:
            if m._dim_k != self._dim_arr - 1:
                raise PythtbError(
                    "Each family model must have dim_k == dim_arr - 1 "
                    "(the non-parameter axes are the k-grid)."
                )
            if m._nsta != self._nsta_arr:
                raise PythtbError(
                    "solve_on_grid_models requires nsta_arr to match the models."
                )
        if start_k is None:
            start_k = [0.0] * (self._dim_arr - 1)
        d0, m0 = fins[0], models[0]
        same_graph = all(
            d.nhop == d0.nhop and d.nspin == d0.nspin and torch.equal(d.ii, d0.ii)
            and torch.equal(d.jj, d0.jj) and torch.equal(d.rv, d0.rv)
            and np.array_equal(m._orb, m0._orb) and m._per == m0._per
            for d, m in zip(fins, models)
        )
        if same_graph:
            amps = torch.stack([d.amps for d in fins]).contiguous()
            diags = torch.stack([d.diag for d in fins]).contiguous()
            min_gaps, evals, wfs = _solver.solve_grid_family(
                d0, amps, diags, k_sizes, start_k, m0._orb, m0._per, self._nspin
            )
        else:
            rows = [
                _solver.solve_grid_device(d, k_sizes, start_k, m._orb, m._per, self._nspin)
                for d, m in zip(fins, models)
            ]
            min_gaps = np.min(np.stack([r[0] for r in rows]), axis=0)
            evals = torch.stack([r[1] for r in rows])
            wfs = torch.stack([r[2] for r in rows])
        self._set_device(torch.movedim(wfs, 0, param_dir).contiguous())
        self._energies_dev = torch.movedim(evals, 0, param_dir).contiguous()
        self._energies_host = None
        self._min_gaps = np.array(min_gaps) if self._nsta_arr > 1 else None
        if self._nsta_arr <= 1:
            return None
        return min_gaps

    def solve_on_one_point(self, kpt, mesh_indices):
        """Solve at one k-point and store at mesh_indices."""
        _, evec = self._model.solve_one(kpt, eig_vectors=True)
        host = self._host_rw()
        if _is_int(mesh_indices):
            host[(mesh_indices,)] = evec
        else:
            host[tuple(mesh_indices)] = evec

    # -- array utilities ------------------------------------------------

    def _copy_shell(self):
        """Deep copy without duplicating device buffers."""
        self._sync_host()
        dev, dev_valid = self._dev, self._dev_valid
        edev = self._energies_dev
        self._dev, self._dev_valid = None, False
        self._energies_dev = None
        new = _copy.deepcopy(self)
        self._dev, self._dev_valid = dev, dev_valid
        self._energies_dev = edev
        # the copy sees the same (never mutated) device energies
        new._energies_dev = edev
        # the copy owns a fresh host buffer no external view points at
        new._views_exposed = False
        return new

    def choose_states(self, subset):
        """New wf_array keeping only the given state indices; stored
        energies (if any) are sliced to the subset."""
        subset = np.array(subset, dtype=int)
        if subset.ndim != 1:
            raise PythtbError("Parameter subset must be a one-dimensional array.")
        has_energies = self._energies_host is not None or self._energies_dev is not None
        energies = np.array(self.energies[..., subset]) if has_energies else None
        wf_new = self._copy_shell()
        wf_new._nsta_arr = subset.shape[0]
        idx = (slice(None),) * self._dim_arr + (subset,)
        wf_new._wfs = wf_new._host[idx]
        wf_new._energies_dev = None
        wf_new._energies_host = energies
        wf_new._min_gaps = None  # adjacency broken by re-subsetting
        return wf_new

    def empty_like(self, nsta_arr=None):
        """New uninitialized wf_array of the same shape (optionally with a
        different number of states)."""
        wf_new = self._copy_shell()
        wf_new._energies_dev = None
        wf_new._energies_host = None
        wf_new._min_gaps = None
        if nsta_arr is not None:
            wf_new._nsta_arr = nsta_arr
            shape = list(wf_new._host.shape)
            shape[self._dim_arr] = nsta_arr
            wf_new._wfs = np.empty(tuple(shape), dtype=complex)
        else:
            wf_new._wfs = np.empty_like(wf_new._host)
        return wf_new

    # -- indexing -------------------------------------------------------

    def __check_key(self, key):
        if self._dim_arr == 1:
            if not _is_int(key):
                raise TypeError("Key should be an integer!")
            if key < (-1) * self._mesh_arr[0] or key >= self._mesh_arr[0]:
                raise IndexError("Key outside the range!")
        else:
            if len(key) != self._dim_arr:
                raise TypeError("Wrong dimensionality of key!")
            for i, k in enumerate(key):
                if not _is_int(k):
                    raise TypeError("Key should be set of integers!")
                if k < (-1) * self._mesh_arr[i] or k >= self._mesh_arr[i]:
                    raise IndexError("Key outside the range!")

    def __getitem__(self, key):
        self.__check_key(key)
        # a mutable NumPy view (reference semantics) that can outlive this
        # call, so device uploads are never cached again for this object
        return self._host_rw(exposes_view=True)[key]

    def __setitem__(self, key, value):
        self.__check_key(key)
        self._host_rw()[key] = np.array(value, dtype=complex)

    # -- boundary conditions --------------------------------------------

    def impose_pbc(self, mesh_dir, k_dir):
        r"""Periodic gauge across the BZ: set the last grid point along
        ``mesh_dir`` to ``exp(-2j*pi*orb[:, k_dir])`` times the first."""
        if k_dir not in self._model._per:
            raise PythtbError(
                "Periodic boundary condition can be specified only along periodic directions!"
            )
        if mesh_dir < 0 or mesh_dir >= self._dim_arr:
            raise PythtbError("Wrong value of mesh_dir.")
        ffac = np.exp(-2.0j * np.pi * self._orb[:, k_dir])
        if self._nspin == 1:
            phase = ffac
        else:
            phase = np.zeros((self._norb, 2), dtype=complex)
            phase[:, 0] = ffac
            phase[:, 1] = ffac
        host = self._host_rw()
        first = (slice(None),) * mesh_dir + (0, Ellipsis)
        last = (slice(None),) * mesh_dir + (-1, Ellipsis)
        host[last] = host[first] * phase

    def impose_loop(self, mesh_dir):
        """Copy the first slice along mesh_dir onto the last (closed
        non-winding loops)."""
        if mesh_dir < 0 or mesh_dir >= self._dim_arr:
            raise PythtbError("Wrong value of mesh_dir.")
        host = self._host_rw()
        first = (slice(None),) * mesh_dir + (0, Ellipsis)
        last = (slice(None),) * mesh_dir + (-1, Ellipsis)
        host[last] = host[first]

    # -- energies -------------------------------------------------------

    @property
    def energies(self):
        """Band energies stored alongside the states, a mutable float
        array of shape ``(*mesh, nsta_arr)``: filled by
        :meth:`solve_on_grid` (kept on the device until first read) or
        assigned by hand; unset entries are NaN.  State writes do not
        invalidate them."""
        if self._energies_host is None:
            if self._energies_dev is not None:
                self._energies_host = np.array(self._energies_dev.cpu().numpy(), dtype=np.float64)
                self._energies_dev = None
            else:
                self._energies_host = np.full(
                    tuple(self._mesh_arr) + (self._nsta_arr,), np.nan
                )
        return self._energies_host

    @energies.setter
    def energies(self, value):
        value = np.asarray(value, dtype=np.float64)
        expect = tuple(self._mesh_arr) + (self._nsta_arr,)
        if value.shape != expect:
            raise PythtbError(
                "energies must have shape %s (mesh + nsta_arr), got %s"
                % (expect, value.shape)
            )
        self._energies_host = value
        self._energies_dev = None

    def band_separation(self, occ="All"):
        """Smallest energy separation, over the whole grid, between the
        states ``occ`` and their complement; ``inf`` when ``occ`` is all
        stored states.  Requires :attr:`energies`."""
        occ = self._occ_index(occ)
        comp = np.setdiff1d(np.arange(self._nsta_arr), occ)
        if comp.size == 0 or occ.size == 0:
            return np.inf
        if self._min_gaps is not None:
            # sorted eigenvalues: the minimum is attained at an adjacent
            # pair straddling an occ/comp boundary, already reduced
            mask = np.zeros(self._nsta_arr, dtype=bool)
            mask[occ] = True
            boundary = np.nonzero(mask[:-1] != mask[1:])[0]
            return float(self._min_gaps[boundary].min())
        E = self.energies
        if np.isnan(E).any():
            raise PythtbError(
                "band_separation requires energies on the whole grid; run "
                "solve_on_grid or fill wf.energies manually first."
            )
        diff = np.abs(E[..., comp][..., None, :] - E[..., occ][..., :, None])
        return float(diff.min())

    def _check_separation(self, occ, kind):
        """Warn when the chosen states touch their complement somewhere
        on the grid (the Berry result is gauge noise there)."""
        if (
            self._min_gaps is None
            and self._energies_host is None
            and self._energies_dev is None
        ):
            return
        E = self._energies_host
        if self._min_gaps is None and E is not None and np.isnan(E).any():
            return  # manually managed, incomplete -- not our call
        sep = self.band_separation(occ)
        if sep < 1e-8:
            warnings.warn(
                "wf_array.%s: the chosen states are degenerate with their "
                "complement somewhere on the grid (min separation %.2e) -- "
                "the result is gauge-dependent noise there. Choose a set "
                "closed under degeneracy." % (kind, sep),
                UserWarning,
                stacklevel=3,
            )

    # -- checkpoints ----------------------------------------------------

    def save(self, path):
        """Checkpoint this wf_array (model, states and stored energies) to
        a compressed ``.npz``, in the layout of the JAX package (a file
        written by either package loads in the other).  No pickle."""
        from .utils.serialization import save_wf_array

        save_wf_array(self, path)

    @staticmethod
    def load(path):
        """Load a wf_array written by :meth:`save`."""
        from .utils.serialization import load_wf_array

        return load_wf_array(path)

    # -- gauge and adiabatic evolution -----------------------------------

    def smooth_gauge(self, occ="All", dir=0, closed=True):
        r"""Impose the optimally smooth parallel-transport gauge of
        Marzari & Vanderbilt 1997 on states ``occ`` along grid axis
        ``dir``, in place.

        With ``closed=False`` this is pure parallel transport: each link
        overlap of the smoothed states is Hermitian positive.  With
        ``closed=True`` (default) the loop holonomy is spread evenly along
        the axis by fractional powers, so the endpoints of both
        :meth:`impose_loop` and :meth:`impose_pbc` are kept.  The subspace
        at each grid point is unchanged; only the basis within it rotates,
        so gauge-invariant quantities (Berry phases and fluxes, Wilson
        eigenphases) are untouched.  Runs through kernel 14 on the card
        (:mod:`pythtb_tpu_torch.ops.transport`).

        :param occ: stored-state indices to smooth (default all)
        :param dir: grid axis along which to smooth
        :param closed: spread the loop holonomy (see above)
        """
        occ = self._occ_index(occ)
        if dir < 0 or dir >= self._dim_arr:
            raise PythtbError("Wrong value of dir.")
        wfs, min_s = _transport.smooth_gauge(
            self._device_states(), occ, dir, self._nspin, self._dim_arr, closed
        )
        self._warn_singular(min_s, "smooth_gauge:singular value")
        self._set_device(wfs)

    def adiabatic_evolve(self, occ, dir=0, return_states=False):
        r"""Adiabatically follow the subspace of stored states ``occ``
        along grid axis ``dir``: at each step the ``len(occ)`` stored
        states with the largest squared overlap with the transported
        subspace are selected and the subspace is carried into them, so
        states are followed through crossings by continuity rather than
        by energy order.

        :param occ: stored-state indices of the initial subspace
        :param dir: grid axis to evolve along
        :param return_states: also return the followed states
        :returns: ``(indices, fidelity)``: indices (L, ..., nocc) with the
          evolved axis first, the stored states occupied at each step;
          fidelity (L-1, ...), the fraction of the subspace captured at
          each step (1 = adiabatic).  With ``return_states=True`` a third
          element, a new :class:`wf_array` with ``nsta_arr = len(occ)``
          holding the followed states in a smooth gauge.
        """
        occ = self._occ_index(occ)
        if dir < 0 or dir >= self._dim_arr:
            raise PythtbError("Wrong value of dir.")
        idx, fid, states = _transport.follow_states(
            self._device_states(), occ, dir, self._nspin, self._dim_arr
        )
        if not return_states:
            return idx, fid
        wf_new = self.empty_like(nsta_arr=len(occ))
        wf_new._set_device(states)
        return idx, fid, wf_new

    # -- internal helpers -----------------------------------------------

    def _occ_index(self, occ):
        if (isinstance(occ, str) and occ == "All") or occ is None:
            return np.arange(self._nsta_arr, dtype=int)
        occ = np.array(occ, dtype=int)
        if occ.ndim != 1:
            raise PythtbError(
                'Parameter occ must be a one-dimensional array or string "All".'
            )
        if occ.size and (occ.min() < -self._nsta_arr or occ.max() >= self._nsta_arr):
            raise IndexError(
                "occ indices %s out of range for %d states"
                % (np.unique(occ).tolist(), self._nsta_arr)
            )
        return occ % self._nsta_arr if occ.size and occ.min() < 0 else occ

    def _check_w90(self):
        if self._model._assume_position_operator_diagonal is False:
            _offdiag_approximation_warning_and_stop()

    def _warn_singular(self, min_val, kind):
        """Warn when a link overlap is (near-)singular: the discretized
        Berry quantity is then undefined and the numbers are noise."""
        eps = float(np.finfo(np.float64).eps)
        if min_val < np.sqrt(eps):
            warnings.warn(
                "wf_array.%s: smallest link-overlap %s is %.2e -- the "
                "occupied subspaces of neighboring grid points are "
                "(nearly) orthogonal, so the discretized result is "
                "unreliable. Refine the k-grid or check the band choice."
                % (kind.split(":")[0], kind.split(":")[1], min_val),
                UserWarning,
                stacklevel=3,
            )

    # -- position wrappers ----------------------------------------------

    def _key_occ_states(self, key, occ):
        occ = self._occ_index(occ)
        if _is_int(key):
            key = (key,)
        return self._host_ro()[tuple(key)][occ]

    def position_matrix(self, key, occ, dir):
        """Position matrix at one grid point for the given states."""
        self._check_w90()
        return self._model.position_matrix(self._key_occ_states(key, occ), dir)

    def position_expectation(self, key, occ, dir):
        """Position expectations at one grid point."""
        self._check_w90()
        return self._model.position_expectation(self._key_occ_states(key, occ), dir)

    def position_hwf(self, key, occ, dir, hwf_evec=False, basis="wavefunction"):
        """Hybrid Wannier centers/functions at one grid point.  The
        default basis differs from tb_model.position_hwf, as in PythTB."""
        self._check_w90()
        return self._model.position_hwf(self._key_occ_states(key, occ), dir, hwf_evec, basis)

    def position_expectation_all(self, occ, dir):
        """Position expectations of the ``occ`` states at every grid
        point in one device pass (kernel 6's diagonal mode): returns
        ``(mesh..., nocc)`` float."""
        self._check_w90()
        self._model._check_position_dir(dir)
        occ = self._occ_index(occ)
        return _pos.position_expectation_states(
            self._device_states(), self._model._pos_weights(dir), occ, self._dim_arr
        )

    def position_hwf_all(self, occ, dir, hwf_evec=False, basis="wavefunction"):
        """Hybrid-Wannier centers (and functions) at every grid point in
        one device pass.  Returns ``hwfc`` of shape ``(mesh..., nocc)``
        (plus ``hwf`` of shape ``(mesh..., nocc, nocc)`` for basis
        'wavefunction'/'bloch' or ``(mesh..., nocc, norb[, spin])`` for
        'orbital' when ``hwf_evec``)."""
        self._check_w90()
        self._model._check_position_dir(dir)
        occ = self._occ_index(occ)
        basis = basis.lower().strip()
        if basis not in ("wavefunction", "bloch", "orbital"):
            raise PythtbError("Basis must be either 'wavefunction', 'bloch', or 'orbital'")
        out = _pos.position_hwf_states(
            self._device_states(), self._model._pos_weights(dir), occ, self._dim_arr,
            hwf_evec, basis == "orbital",
        )
        if not hwf_evec:
            return out
        hwfc, hwf = out
        if basis == "orbital" and self._nspin == 2:
            hwf = hwf.reshape(hwf.shape[:-1] + (self._norb, 2))
        return hwfc, hwf

    # -- Berry phases ----------------------------------------------------

    def berry_phase(self, occ="All", dir=None, contin=True, berry_evals=False):
        r"""Berry phase along ``dir`` for each string of grid points.
        With ``berry_evals`` the phases of the Wilson-loop eigenvalues
        are returned instead of the trace.  Warns if a link overlap along
        the strings is (nearly) singular.

        Example::

            wf = wf_array(model, [31, 31])
            wf.solve_on_grid([-0.5, -0.5])
            flow = wf.berry_phase([0], dir=1, contin=True)   # (31,)
        """
        occ = self._occ_index(occ)
        self._check_w90()
        self._check_separation(occ, "berry_phase")
        if self._dim_arr == 1:
            dir = 0
        if dir is None or dir < 0 or dir >= self._dim_arr:
            raise PythtbError("Wrong direction for Berry phase calculation!")
        if self._dim_arr > 3:
            raise PythtbError("Wrong dimensionality!")

        states = self._device_states()
        if not berry_evals:
            ret, mdet = _berry.berry_phase_traced(
                states, occ, dir, self._nspin, self._dim_arr
            )
            self._warn_singular(mdet, "berry_phase:|det|")
            if self._dim_arr == 1:
                ret = float(ret)
        else:
            ret, msv = _berry.berry_evals(states, occ, dir, self._nspin, self._dim_arr)
            self._warn_singular(msv, "berry_phase:singular value")

        if self._dim_arr > 1 or berry_evals:
            ret = np.array(ret, dtype=float)

        # branch fixing across strings (host, greedy, as the reference)
        if contin:
            if not berry_evals:
                if self._dim_arr == 2:
                    ret = _cont.one_phase_cont(ret, ret[0])
                elif self._dim_arr == 3:
                    for i in range(ret.shape[1]):
                        clos = ret[0, 0] if i == 0 else ret[0, i - 1]
                        ret[:, i] = _cont.one_phase_cont(ret[:, i], clos)
                elif self._dim_arr != 1:
                    raise PythtbError("Wrong dimensionality!")
            else:
                if self._dim_arr == 2:
                    ret = _cont.array_phases_cont(ret, ret[0, :])
                elif self._dim_arr == 3:
                    for i in range(ret.shape[1]):
                        clos = ret[0, 0, :] if i == 0 else ret[0, i - 1, :]
                        ret[:, i] = _cont.array_phases_cont(ret[:, i], clos)
                elif self._dim_arr != 1:
                    raise PythtbError("Wrong dimensionality!")
        return ret

    # -- Berry flux ------------------------------------------------------

    def berry_flux(self, occ="All", dirs=None, individual_phases=False):
        r"""Integrated Berry curvature over planes spanned by ``dirs``;
        for dim > 2, for every 2-D slice over the remaining directions.

        :param occ: state indices (or "All")
        :param dirs: the two grid directions spanning the plane
        :param individual_phases: return the (n0-1, n1-1) plaquette
          phases instead of their sum
        :returns: total flux (Chern number x 2 pi for a full-BZ grid),
          or per-slice sums / per-plaquette arrays for rank > 2

        Example::

            wf = wf_array(model, [31, 31])
            wf.solve_on_grid([-0.5, -0.5])
            chern = wf.berry_flux([0]) / (2 * np.pi)
        """
        occ = self._occ_index(occ)
        self._check_w90()
        self._check_separation(occ, "berry_flux")
        if dirs is None:
            dirs = [0, 1]
        if dirs[0] == dirs[1]:
            raise PythtbError(
                "Need to specify two different directions for Berry flux calculation."
            )
        if (
            dirs[0] >= self._dim_arr
            or dirs[1] >= self._dim_arr
            or dirs[0] < 0
            or dirs[1] < 0
        ):
            raise PythtbError("Direction for Berry flux calculation out of bounds.")
        if self._dim_arr not in (2, 3, 4):
            raise PythtbError("Wrong dimensionality!")

        out, mdet = _berry.berry_flux_planes(
            self._device_states(), occ, dirs[0], dirs[1], self._nspin, self._dim_arr,
            individual_phases,
        )
        self._warn_singular(mdet, "berry_flux:|det|")
        if self._dim_arr == 2 and not individual_phases:
            return float(out)
        return out
