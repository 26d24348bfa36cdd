"""Model serialization: save/load tb_model objects to .npz
(counterpart of ``pythtb_tpu.utils.serialization``, the same file
layout: a file written by either package loads in the other).

The reference has no persistence layer -- its docs tell users to pickle
models themselves (PythTB examples/w90.py:33-38).  Here models
round-trip through a single compressed .npz holding plain arrays, which
is portable, versioned, and safe (no pickle).  Useful for caching
Wannier90 imports and large supercell constructions.
"""

from __future__ import annotations

import json

import numpy as np

__all__ = ["save_model", "load_model", "save_wf_array", "load_wf_array"]

_FORMAT_VERSION = 1


def _model_meta(model):
    return {
        "dim_k": int(model._dim_k),
        "dim_r": int(model._dim_r),
        "per": [int(p) for p in model._per],
        "nspin": int(model._nspin),
        "norb": int(model._norb),
        "position_operator_diagonal": bool(model._assume_position_operator_diagonal),
    }


def _model_arrays(model):
    nhop = len(model._hoppings)
    if model._nspin == 1:
        amps = np.array([h[0] for h in model._hoppings], dtype=complex).reshape(nhop)
    else:
        amps = np.array([h[0] for h in model._hoppings], dtype=complex).reshape(nhop, 2, 2)
    hi = np.array([h[1] for h in model._hoppings], dtype=np.int64)
    hj = np.array([h[2] for h in model._hoppings], dtype=np.int64)
    if model._dim_k != 0:
        hR = np.array([h[3] for h in model._hoppings], dtype=np.float64).reshape(
            nhop, model._dim_r
        )
    else:
        hR = np.zeros((nhop, 0), dtype=np.float64)
    return dict(
        lat=model._lat,
        orb=model._orb,
        site_energies=model._site_energies,
        site_specified=model._site_energies_specified,
        hop_amps=amps,
        hop_i=hi,
        hop_j=hj,
        hop_R=hR,
    )


def _restore_model(f, meta):
    from ..model import tb_model

    m = tb_model(
        meta["dim_k"], meta["dim_r"], lat=f["lat"], orb=f["orb"],
        per=meta["per"], nspin=meta["nspin"],
    )
    m._assume_position_operator_diagonal = meta["position_operator_diagonal"]
    m._site_energies = np.array(f["site_energies"])
    m._site_energies_specified = np.array(f["site_specified"])
    amps, hi, hj, hR = f["hop_amps"], f["hop_i"], f["hop_j"], f["hop_R"]
    for n in range(hi.shape[0]):
        amp = amps[n] if meta["nspin"] == 2 else complex(amps[n])
        if meta["dim_k"] == 0:
            h = [amp, int(hi[n]), int(hj[n])]
            R = None
        else:
            R = np.array(hR[n])
            # restore exact-integer vectors to int (the common case)
            if np.all(R == np.round(R)):
                R = R.astype(np.int64)
            h = [amp, int(hi[n]), int(hj[n]), R]
        m._hop_index[m._hop_key(h[1], h[2], R)] = len(m._hoppings)
        m._hoppings.append(h)
    m._invalidate()
    return m


def _resolve_npz_path(path):
    """np.savez appends .npz; accept either path string on load."""
    import os

    if not os.path.exists(path) and os.path.exists(str(path) + ".npz"):
        return str(path) + ".npz"
    return path


def save_model(model, path):
    """Write a tb_model to ``path`` (.npz)."""
    meta = {"format_version": _FORMAT_VERSION}
    meta.update(_model_meta(model))
    np.savez_compressed(
        path,
        meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
        **_model_arrays(model)
    )


def load_model(path):
    """Read a tb_model previously written by :func:`save_model`.

    Mirrors np.savez's suffix handling: if ``path`` does not exist but
    ``path + '.npz'`` does (savez appends the suffix), the latter is
    opened, so save/load round-trip with the same path string.
    """
    with np.load(_resolve_npz_path(path)) as f:
        meta = json.loads(bytes(f["meta"]).decode())
        if meta.get("format_version", 0) > _FORMAT_VERSION:
            raise ValueError(
                "model file written by a newer format (%s)"
                % meta["format_version"]
            )
        if meta.get("kind", "model") != "model":
            raise ValueError(
                "%r is a %r checkpoint, not a model file -- use load_%s"
                % (path, meta["kind"], meta["kind"])
            )
        return _restore_model(f, meta)


def save_wf_array(wf, path):
    """Write a wf_array -- its model, grid of states, and stored band
    energies -- to ``path`` (.npz).  Checkpoint/resume for expensive
    grid solves (large meshes, pump families): reload with
    :func:`load_wf_array` and continue with Berry/Wannier analysis
    without re-diagonalizing.  No pickle."""
    meta = {
        "format_version": _FORMAT_VERSION,
        "kind": "wf_array",
        "mesh_arr": [int(m) for m in wf._mesh_arr],
        "nsta_arr": int(wf._nsta_arr),
    }
    meta.update(_model_meta(wf._model))
    arrays = _model_arrays(wf._model)
    arrays["states"] = np.asarray(wf._host_ro())
    if wf._energies_host is not None or wf._energies_dev is not None:
        arrays["energies"] = np.asarray(wf.energies)
    np.savez_compressed(
        path,
        meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
        **arrays
    )


def load_wf_array(path):
    """Read a wf_array previously written by :func:`save_wf_array`."""
    from ..wf_array import wf_array as _wf_array

    with np.load(_resolve_npz_path(path)) as f:
        meta = json.loads(bytes(f["meta"]).decode())
        if meta.get("kind") != "wf_array":
            raise ValueError("Not a wf_array file (use load_model instead).")
        if meta.get("format_version", 0) > _FORMAT_VERSION:
            raise ValueError(
                "wf_array file written by a newer format (%s)"
                % meta["format_version"]
            )
        states = np.array(f["states"])
        energies = np.array(f["energies"]) if "energies" in f.files else None
        m = _restore_model(f, meta)
    nsta_arr = meta["nsta_arr"]
    nspin = meta["nspin"]
    expect = tuple(meta["mesh_arr"]) + (nsta_arr, meta["norb"]) + (
        (2,) if nspin == 2 else ()
    )
    if states.shape != expect:
        raise ValueError(
            "Corrupt wf_array file: states shape %s does not match the "
            "recorded mesh/model (%s)." % (states.shape, expect)
        )
    wf = _wf_array(
        m, meta["mesh_arr"],
        nsta_arr=None if nsta_arr == m._nsta else nsta_arr,
    )
    wf._wfs = states
    if energies is not None:
        wf.energies = energies
    return wf
