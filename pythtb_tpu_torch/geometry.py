"""Quantum geometry of Bloch bands: quantum geometric tensor, metric,
Berry curvature, the BZ-integrated metric and the Drude weight
(counterpart of ``pythtb_tpu.geometry``).

All matrix elements come from the analytic Convention-I k-gradient
(kernel 15, :func:`pythtb_tpu_torch.ops.hamiltonian.assemble_dk`) in the
band basis; the interband connection is

    G^a_mn = V^a_mn / (E_n - E_m) + i <m| t_cart_a |n>    (m != n)

(the second term is the orbital-embedding correction), and the
non-abelian QGT of an occupied group is Q_ab = sum_{n occ, m unocc}
conj(G^a_mn) G^b_mn: g = Re Q is the quantum metric, -2 Im Q the Berry
curvature.  The band contractions are torch; ``drude_weight``'s band sum
over the occupation is kernel 17.  ``superfluid_weight``,
``effective_mass`` and ``kp_model`` are not ported yet.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from . import config
from .model import PythtbError
from .ops.fermi_sweep import fermi_sweep
from .ops.solver import device_uniform_grid
from .optical import _band_tensors, _inv_gaps, _inverse_mass, _velocity_tensors

__all__ = ["quantum_geometric_tensor", "quantum_metric", "berry_curvature", "integrated_metric",
           "drude_weight"]

_DEG_TOL = 1e-7  # energy-denominator mask, as in optical and flows


def _connection(data, kpts, lat, tcart):
    """Interband connection G (B, d, S, S): G[b, a, m, n] = <u_m|d u_n/dk_a>
    = V^a_mn / (E_n - E_m) + i t^a_mn, zero where |E_n - E_m| <= _DEG_TOL.
    Returns (evals, G)."""
    evals, vecs, V, _ = _velocity_tensors(data, kpts, lat, need_d2=False)  # V[b, a, m, n] = <m|dH_a|n>
    tc = torch.as_tensor(tcart, dtype=config.COMPLEX).to(data.device)
    T = torch.einsum("bms,sa,bns->bamn", vecs.conj(), tc, vecs)
    mask, inv = _inv_gaps(evals, _DEG_TOL)  # inv[b, m, n] = 1 / (E_m - E_n)
    G = (V * (-inv)[:, None].to(V.dtype) + 1j * T) * mask[:, None].to(V.dtype)
    return evals, G


def _qgt_occ(data, kpts, occ, lat, tcart):
    """Non-abelian QGT of the occupied multiplet (B, d, d), and the
    smallest occupied-empty separation."""
    evals, G = _connection(data, kpts, lat, tcart)
    occ_idx = torch.as_tensor(occ, device=data.device)
    unocc_idx = torch.as_tensor([s for s in range(data.nsta) if s not in occ], device=data.device)
    Gs = G[:, :, unocc_idx[:, None], occ_idx[None, :]]  # (B, d, nu, no)
    Q = torch.einsum("bamn,bcmn->bac", Gs.conj(), Gs)
    gap = (evals[:, unocc_idx][:, :, None] - evals[:, occ_idx][:, None, :]).abs().min()
    return Q, float(gap)


def _prep(model, caller):
    data = model._get_finalized()
    if data.dim_k != model._dim_r:
        raise PythtbError("%s requires a fully periodic model (dim_k == dim_r)" % caller)
    if data.dim_k == 0:
        raise PythtbError("%s requires at least one periodic direction" % caller)
    lat = np.asarray(model._lat, dtype=np.float64)
    tcart = np.asarray(model._orb, dtype=np.float64) @ lat
    if data.nspin == 2:
        tcart = np.repeat(tcart, 2, axis=0)  # spin-fastest state layout
    return data, lat, tcart


def _check_occ(occ, nsta):
    occ = tuple(int(o) for o in np.atleast_1d(occ))
    if len(occ) == 0 or len(set(occ)) != len(occ):
        raise PythtbError("occ must be a nonempty set of distinct bands")
    if min(occ) < 0 or max(occ) >= nsta:
        raise PythtbError("occ indices %s out of range for %d states" % (sorted(occ), nsta))
    if len(occ) == nsta:
        raise PythtbError("occ cannot contain every band (QGT of the full space vanishes identically)")
    return occ


def quantum_geometric_tensor(model, k_list, occ=None, bands=None):
    """Quantum geometric tensor at arbitrary k-points (counterpart of
    ``pythtb_tpu.geometry.quantum_geometric_tensor``).  Exactly one of
    ``occ`` (the non-abelian QGT of the occupied multiplet, (B, d, d);
    warns when occupied and empty bands come within 1e-6) or ``bands``
    (``"all"`` or a list: the per-band abelian QGT, (B, nbands, d, d)).
    Complex, Cartesian, [length^2]."""
    data, lat, tcart = _prep(model, "quantum_geometric_tensor")
    kpts = np.asarray(k_list, dtype=np.float64)
    if kpts.ndim != 2 or kpts.shape[1] != data.dim_k:
        raise PythtbError("k_list must be (B, %d)" % data.dim_k)
    if (occ is None) == (bands is None):
        raise PythtbError("give exactly one of occ= or bands=")
    k = torch.as_tensor(kpts).to(data.device)
    if occ is not None:
        occ = _check_occ(occ, data.nsta)
        Q, gap = _qgt_occ(data, k, occ, lat, tcart)
        if gap < 1e-6:
            warnings.warn(
                "quantum_geometric_tensor: occupied and empty bands come "
                "within %.2e of degeneracy -- the multiplet QGT is "
                "ill-defined there (masked pairs dropped)." % gap,
                UserWarning, stacklevel=2,
            )
        return Q.cpu().numpy()
    _, G = _connection(data, k, lat, tcart)
    Q = torch.einsum("bamn,bcmn->bnac", G.conj(), G).cpu().numpy()
    if isinstance(bands, str):
        if bands != "all":
            raise PythtbError('bands must be "all" or a list of bands')
        return Q
    bands = [int(b) for b in np.atleast_1d(bands)]
    if len(bands) and (min(bands) < 0 or max(bands) >= data.nsta):
        raise PythtbError("bands %s out of range for %d states" % (bands, data.nsta))
    return Q[:, bands]


def quantum_metric(model, k_list, occ=None, bands=None):
    """Quantum (Fubini-Study) metric g_ab = Re Q_ab (see
    :func:`quantum_geometric_tensor`)."""
    return quantum_geometric_tensor(model, k_list, occ=occ, bands=bands).real


def berry_curvature(model, k_list, occ=None, bands=None):
    """Pointwise Berry curvature Omega_ab = -2 Im Q_ab (see
    :func:`quantum_geometric_tensor`); orbital-embedded convention."""
    return -2.0 * quantum_geometric_tensor(model, k_list, occ=occ, bands=bands).imag


def integrated_metric(model, occ, nk=(31, 31)):
    """BZ-integrated quantum geometry of an occupied group (counterpart of
    ``pythtb_tpu.geometry.integrated_metric``): a dict of ``omega_i``
    (the gauge-invariant Wannier spread, (1/N_k) sum tr g), ``metric``
    (d, d), ``curvature`` (d, d) and, in 2-D, ``chern``."""
    data, lat, tcart = _prep(model, "integrated_metric")
    occ = _check_occ(occ, data.nsta)
    nk = tuple(int(n) for n in np.atleast_1d(nk))
    if len(nk) != data.dim_k or min(nk) < 2:
        raise PythtbError("nk must give %d sizes >= 2" % data.dim_k)
    kpts = device_uniform_grid(nk, np.zeros(data.dim_k), data.device)
    Q, gap = _qgt_occ(data, kpts, occ, lat, tcart)
    if gap < 1e-6:
        warnings.warn(
            "integrated_metric: occupied and empty bands come within "
            "%.2e of degeneracy on the grid -- Omega_I diverges "
            "logarithmically at a band touching and the masked value "
            "is grid-dependent." % gap,
            UserWarning, stacklevel=2,
        )
    Q = Q.mean(dim=0).cpu().numpy()
    out = {"omega_i": float(np.trace(Q.real)), "metric": Q.real, "curvature": -2.0 * Q.imag}
    if data.dim_k == 2:
        out["chern"] = float(out["curvature"][0, 1] * 2.0 * np.pi / abs(np.linalg.det(lat)))
    return out


def drude_weight(model, mu, nk=(64, 64), temperature=1e-3):
    """Drude weight (charge stiffness) of the clean metal (counterpart of
    ``pythtb_tpu.geometry.drude_weight``): (2/(A_c N_k)) sum_kn
    (d2 eps_n / dk_a dk_b) f(eps_n), the band second derivatives from the
    exact sum rule on kernel 15's dH and d2H, the occupation-weighted band
    sum on kernel 17.  Returns (d, d)."""
    data, lat, _ = _prep(model, "drude_weight")
    nk = tuple(int(n) for n in np.atleast_1d(nk))
    if len(nk) != data.dim_k or min(nk) < 2:
        raise PythtbError("nk must give %d sizes >= 2" % data.dim_k)
    evals, _vecs, V, W2 = _band_tensors(data, nk, lat, need_d2=True)
    d2 = _inverse_mass(evals, V, W2)  # (B, a, c, n)
    spin = 2.0 if data.nspin == 1 else 1.0
    d = data.dim_k
    B = evals.shape[0]
    G = (spin * d2 / B).permute(1, 2, 0, 3).reshape(d * d, -1).contiguous()
    mus = torch.tensor([float(mu)], dtype=config.FLOAT, device=data.device)
    out = fermi_sweep(evals.reshape(-1).contiguous(), G, mus, float(temperature), "fermi")
    return out.reshape(d, d).cpu().numpy() / abs(np.linalg.det(lat))
