"""Carry models across from the JAX package, pythtb_tpu, or any PythTB-style model.

Every function takes plain NumPy data, so this module imports neither
package it converts from:

* :func:`tb_model_from_state` rebuilds a :class:`tb_model` from the
  host state of another model;
* :func:`bloch_from_numpy` turns the arrays of a ``pythtb_tpu.core.finalize``
  result (ri-packed, trailing [re, im] axis) into this package's
  :class:`~pythtb_tpu_torch.core.BlochData`;
* :func:`wf_array_from_numpy` fills a :class:`wf_array` with the states
  of another package's wf_array (eigenvector gauges of separate solves
  differ, so gauge-dependent comparisons need the same states);
* :func:`wannier_inputs_from_numpy` turns coarse-grid states and raw
  neighbour overlaps into the tensors of the port's Wannier code
  (:func:`wannier.mv_localize` and the build helpers), for the same
  reason;
* :func:`dmft_result_from_numpy` rebuilds a converged DMFT state from
  another package's result arrays (two correct runs of the L-BFGS-B bath
  fit can take different iterates from 1e-15 differences, so the real-
  axis observables are compared on the identical state);
* :func:`force_model_from_state` and :func:`spin_model_from_state`
  rebuild a phonon :class:`~pythtb_tpu_torch.phonon.force_model` or a
  :class:`~pythtb_tpu_torch.magnon.spin_model` from another package's
  model state;
* :func:`params_from_jax` and :func:`grad_from_jax` carry the parameters
  of ``energy_fn`` / ``chern_fn`` and their gradients across: the JAX
  package packs them as real arrays with a trailing [re, im] axis, the
  port keeps complex tensors, and its gradients follow torch's
  convention for complex leaves.
"""

from __future__ import annotations

import numpy as np
import torch

from . import config, core
from .model import tb_model
from .wf_array import wf_array

__all__ = [
    "tb_model_from_state", "bloch_from_numpy", "wf_array_from_numpy", "wannier_inputs_from_numpy",
    "dmft_result_from_numpy", "force_model_from_state", "spin_model_from_state", "params_from_jax", "grad_from_jax",
]


def tb_model_from_state(state) -> tb_model:
    """Build a :class:`tb_model` from a dict of NumPy arrays and ints.

    Keys: ``dim_k``, ``dim_r``, ``lat`` (dim_r, dim_r), ``orb``
    (norb, dim_r), ``per``, ``nspin``, ``site_energies`` ((norb,) real or
    (norb, 2, 2) complex), and the hoppings ``amps`` ((nhop,) or
    (nhop, 2, 2) complex), ``i``, ``j`` (nhop,) and ``R`` (nhop, dim_r),
    each hopping being <i|H|j+R> without its implied Hermitian partner.
    """
    dim_k, dim_r = int(state["dim_k"]), int(state["dim_r"])
    m = tb_model(
        dim_k, dim_r, np.asarray(state["lat"], dtype=float),
        np.asarray(state["orb"], dtype=float), [int(p) for p in state["per"]],
        int(state["nspin"]),
    )
    dtype = float if m._nspin == 1 else complex
    m._site_energies = np.array(state["site_energies"], dtype=dtype).reshape(
        m._site_energies.shape
    )
    m._site_energies_specified[:] = True
    amps, ii, jj = state["amps"], state["i"], state["j"]
    R = np.asarray(state["R"]).reshape(len(ii), dim_r) if len(ii) else None
    for h in range(len(ii)):
        amp = complex(amps[h]) if m._nspin == 1 else np.array(amps[h], dtype=complex)
        hop = [amp, int(ii[h]), int(jj[h])]
        if dim_k != 0:
            hop.append(np.array(R[h]))
        m._hoppings.append(hop)
    m._rebuild_hop_index()
    return m


def _unpack(x):
    x = np.asarray(x, dtype=np.float64)
    return x[..., 0] + 1j * x[..., 1]


def bloch_from_numpy(static_fields, data_arrays, device=None) -> core.BlochData:
    """Port a ``pythtb_tpu.core.finalize`` result.

    :param static_fields: mapping with ``dim_k``, ``norb`` and ``nspin``
      (e.g. ``dataclasses.asdict(static)``)
    :param data_arrays: mapping of NumPy arrays ``diag`` and ``amps``
      (ri-packed), ``rv``, ``ii`` and ``jj`` (e.g. ``data._asdict()``)
    :param device: target device (default ``config.device()``)
    """
    return core.bloch_data(
        int(static_fields["dim_k"]),
        int(static_fields["norb"]),
        int(static_fields["nspin"]),
        _unpack(data_arrays["diag"]),
        _unpack(data_arrays["amps"]),
        np.asarray(data_arrays["rv"], dtype=np.float64),
        data_arrays["ii"],
        data_arrays["jj"],
        device,
    )


def wf_array_from_numpy(model, wfs, energies=None) -> wf_array:
    """A :class:`wf_array` of ``model`` holding the states ``wfs``.

    :param wfs: (mesh..., nsta_arr, norb[, 2]) complex NumPy array, e.g.
      the host states of a ``pythtb_tpu.wf_array``
    :param energies: optional (mesh..., nsta_arr) band energies
    """
    wfs = np.asarray(wfs, dtype=np.complex128)
    dim_arr = wfs.ndim - 2 - (model._nspin == 2)
    wf = wf_array(model, list(wfs.shape[:dim_arr]), nsta_arr=int(wfs.shape[dim_arr]))
    wf._wfs = np.array(wfs, copy=True)
    if energies is not None:
        wf.energies = energies
    return wf


def wannier_inputs_from_numpy(M0, nbr, w_b, b_cart, u=None, device=None):
    """Tensors for the port's Marzari-Vanderbilt code from NumPy arrays.

    :param M0: (B, nb, n, n) complex raw (or gauge-rotated) overlaps
      M0(k, b) = <u(k)|u(k+b)>
    :param nbr: (B, nb) flat index of grid point k + b
    :param w_b: (nb,) shell weights; ``b_cart``: (nb, dim_r) b-vectors
    :param u: optional (B, n, nsta) complex coarse-grid states (rows)
    :param device: target device (default ``config.device()``)
    :returns: ``(M0, nbr, w_b, b_cart)``, plus ``u`` when given, as
      contiguous complex128 / int64 / float64 tensors
    """
    dev = config.checked_device(device)

    def put(x, dtype):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype).to(dev)

    out = (put(M0, config.COMPLEX), put(nbr, torch.int64), put(w_b, config.FLOAT), put(b_cart, config.FLOAT))
    return out if u is None else out + (put(u, config.COMPLEX),)


def dmft_result_from_numpy(state, model_state=None, device=None):
    """A :class:`pythtb_tpu_torch.dmft.DMFTResult` holding another
    package's converged DMFT state.

    :param state: mapping of NumPy arrays and scalars: ``wn``, ``sigma``,
      ``g_loc``, ``g_imp``, ``g0_inv`` (n_w,), ``mu``, ``eps_d``, ``bath``
      ``(eps_bath, V_bath)``, ``amps`` and ``poles`` (the Lehmann weights
      and poles of the solved impurity), ``orb`` (None for the Bethe
      lattice), ``real_axis`` -- ``("pole", (epso, amps, lams))`` with the
      (Nk,), (Nk, nv), (Nk, nv) Schur data of the lattice sum, or
      ``("bethe", (nodes, weights))`` -- and optionally ``beta``, ``U``,
      ``n_imp``, ``docc``, ``iterations``, ``converged``,
      ``sc_residual``, ``fit_err``, ``history``
    :param model_state: the lattice model's host state (see
      :func:`tb_model_from_state`); required for lattice results
    :param device: target device of the Schur data (default
      ``config.device()``)
    """
    from .dmft import DMFTResult

    dev = config.checked_device(device)
    kind, arrays = state["real_axis"]
    if kind == "pole":
        dat = tuple(torch.as_tensor(np.ascontiguousarray(a, dtype=np.float64)).to(dev) for a in arrays)
    elif kind == "bethe":
        dat = tuple(np.array(a, dtype=np.float64) for a in arrays)
    else:
        raise ValueError("real_axis kind must be 'pole' or 'bethe', got %r" % (kind,))
    eps_b, v_b = state["bath"]
    res = DMFTResult(
        wn=np.array(state["wn"], dtype=np.float64),
        **{key: np.array(state[key], dtype=complex) for key in ("sigma", "g_loc", "g_imp", "g0_inv")},
        mu=float(state["mu"]), eps_d=float(state["eps_d"]),
        bath=(np.array(eps_b, dtype=np.float64), np.array(v_b, dtype=np.float64)),
        **{key: state.get(key) for key in ("beta", "U", "n_imp", "docc", "iterations", "converged",
                                           "sc_residual", "fit_err", "history")},
        _amps=np.array(state["amps"], dtype=np.float64), _poles=np.array(state["poles"], dtype=np.float64),
    )
    res.Z = res.quasiparticle_weight()
    res._real_axis = (kind, dat)
    if kind == "pole":
        if model_state is None:
            raise ValueError("a lattice DMFT result needs its model_state")
        res._model = tb_model_from_state(model_state)
        res._orb = int(state["orb"])
    else:
        res._model = None
        res._orb = None
    return res


def force_model_from_state(state):
    """Build a :class:`~pythtb_tpu_torch.phonon.force_model` from a dict of
    NumPy arrays.

    Keys: ``lat`` (dim_r, dim_r), ``pos`` (natom, dim_r), ``masses``
    (natom,), ``dim_k``, the listed force blocks ``fc_blocks`` (nb, d, d)
    with their atoms ``fc_i``, ``fc_j`` (nb,) and cells ``fc_R`` (nb,
    dim_r), and the pinning blocks ``pins`` (natom, d, d).
    """
    from .phonon import force_model

    fm = force_model(state["lat"], state["pos"], masses=np.asarray(state["masses"], dtype=float),
                     dim_k=int(state["dim_k"]))
    blocks = np.asarray(state["fc_blocks"], dtype=float)
    for b in range(blocks.shape[0]):
        fm._fcs.append((blocks[b].copy(), int(state["fc_i"][b]), int(state["fc_j"][b]),
                        np.array(state["fc_R"][b], dtype=float)))
    fm._pin = [np.array(p, dtype=float) for p in state["pins"]]
    return fm


def spin_model_from_state(state):
    """Build a :class:`~pythtb_tpu_torch.magnon.spin_model` from a dict of
    NumPy arrays.

    Keys: ``lat`` (dim_r, dim_r), ``pos`` (nsite, dim_r), ``spin``
    (nsite,), ``dim_k``, the listed bonds ``J`` (nb, 3, 3) with their
    sites ``i``, ``j`` (nb,) and cells ``R`` (nb, dim_r), ``single_ion``
    (nsite, 3, 3), ``field`` (nsite, 3) and ``moments`` (nsite, 3).
    """
    from .magnon import spin_model

    sm = spin_model(state["lat"], state["pos"], spin=np.asarray(state["spin"], dtype=float),
                    dim_k=int(state["dim_k"]))
    J = np.asarray(state["J"], dtype=float)
    for b in range(J.shape[0]):
        sm._bonds.append((J[b].copy(), int(state["i"][b]), int(state["j"][b]), np.array(state["R"][b], dtype=float)))
    sm._single_ion = [np.array(a, dtype=float) for a in state["single_ion"]]
    sm._field = np.array(state["field"], dtype=float)
    sm._moments = np.array(state["moments"], dtype=float)
    return sm


def params_from_jax(params, device=None):
    """``{"amps", "diag"}`` of the JAX package's ``energy_fn`` /
    ``chern_fn`` (ri-packed NumPy arrays, any leading member axis) as the
    port's complex128 tensors on ``device`` (default ``config.device()``)."""
    dev = config.checked_device(device)
    return {key: torch.as_tensor(_unpack(params[key]), dtype=config.COMPLEX).to(dev) for key in ("amps", "diag")}


def grad_from_jax(g):
    """A gradient of the JAX package with respect to ri-packed parameters
    (an array, or a dict of them) in torch's convention for a complex leaf,
    dL/dRe + i dL/dIm: g[..., 0] + 1j g[..., 1], as complex128 CPU
    tensors."""
    if isinstance(g, dict):
        return {key: grad_from_jax(val) for key, val in g.items()}
    return torch.as_tensor(_unpack(g), dtype=config.COMPLEX)
