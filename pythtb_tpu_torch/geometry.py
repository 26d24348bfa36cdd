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
over the occupation is kernel 17.  ``effective_mass``, ``kp_model`` and
``KPModel`` take the band energies and the Cartesian dH, d2H matrix
elements at one k-point (kernels 1 and 15, ``eigh_batched``, einsums) and
do the perturbation-theory algebra on the host, as the JAX package does.
``superfluid_weight`` takes H, dH and d2H at +k and -k in one launch each
(kernels 1 and 15), packs the BdG matrix by torch indexing, solves it
with ``eigh_batched`` and sums the Daleckii-Krein Hessian on kernel 23;
its finite-difference route assembles every twist's +-k in one kernel-1
launch, takes ``eigvalsh_batched`` and sums the grand potential on
kernel 23's second mode.
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import torch

from . import config
from .model import PythtbError
from .ops.bdg_hessian import bdg_grand_potential, bdg_hessian
from .ops.eigh import eigh_batched, eigvalsh_batched
from .ops.fermi_sweep import fermi_sweep
from .ops.hamiltonian import assemble, assemble_d2k, assemble_dk
from .ops.solver import device_uniform_grid
from .optical import _band_tensors, _inv_gaps, _inverse_mass, _velocity_tensors

__all__ = ["quantum_geometric_tensor", "quantum_metric", "berry_curvature", "integrated_metric",
           "superfluid_weight", "drude_weight", "effective_mass", "kp_model", "KPModel"]

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


# ---------------------------------------------------------------------------
# superfluid weight (BdG phase-twist response)
# ---------------------------------------------------------------------------


def _bdg_matrix(Hp, Hm, mu, delta):
    """(B, 2S, 2S) BdG matrices [[Hp - mu, delta], [delta, -(conj(Hm) -
    mu)]] with s-wave pairing delta on every orbital."""
    B, S = Hp.shape[0], Hp.shape[-1]
    M = torch.zeros((B, 2 * S, 2 * S), dtype=config.COMPLEX, device=Hp.device)
    idx = torch.arange(S, device=Hp.device)
    M[:, :S, :S] = Hp
    M[:, S:, S:] = -Hm.conj()
    M[:, idx, idx] -= mu
    M[:, S + idx, S + idx] += mu
    M[:, idx, S + idx] = delta
    M[:, S + idx, idx] = delta
    return M


def _sfw_free_energy(data, nk, dqs, mu, delta, kt):
    """BdG grand potential per cell at each reduced twist of ``dqs`` (nq,
    d) (counterpart of ``pythtb_tpu.geometry._sfw_free_energy_jit``): the
    particle block H(k + dq), the hole block -conj(H(-k + dq)) + mu.
    Returns (nq,) float64 as a tensor."""
    dev = data.device
    d, S = data.dim_k, data.nsta
    kg = device_uniform_grid(nk, np.zeros(d), dev)
    B = kg.shape[0]
    dq = torch.as_tensor(np.asarray(dqs, dtype=np.float64)).to(dev)
    nq = dq.shape[0]
    kp = (kg[None] + dq[:, None]).reshape(nq * B, d)
    km = (-kg[None] + dq[:, None]).reshape(nq * B, d)
    H = assemble(data, torch.cat([kp, km]))
    Hp, Hm = H[: nq * B], H[nq * B:]
    lam = eigvalsh_batched(_bdg_matrix(Hp, Hm, mu, delta))
    tr = torch.diagonal(Hm, dim1=-2, dim2=-1).real.sum(dim=-1)
    return bdg_grand_potential(lam, tr, nq, kt, mu * S) / B


def _sfw_analytic(data, nk, lat, mu, delta, kt):
    """Analytic BdG phase-twist Hessian d2F/dq_a dq_b at q = 0
    (counterpart of ``pythtb_tpu.geometry._sfw_analytic_jit``): the
    Daleckii-Krein sums on kernel 23, plus the hole normal-ordering trace
    sum_k Re tr d2H(-k), over B, symmetrized.  Returns (d, d) float64."""
    dev = data.device
    d = data.dim_k
    kg = device_uniform_grid(nk, np.zeros(d), dev)
    B = kg.shape[0]
    ks = torch.cat([kg, -kg])
    H = assemble(data, ks)
    dH = assemble_dk(data, ks)
    d2H = assemble_d2k(data, ks)
    lam, U = eigh_batched(_bdg_matrix(H[:B], H[B:], mu, delta))
    # the near-degeneracy switch of the divided differences: one tolerance
    # for the whole batch, as the reference's
    tol = 256.0 * torch.finfo(config.FLOAT).eps * max(float(lam.abs().max()), 1.0)
    out = bdg_hessian(lam, U, dH[:B], dH[B:], d2H[:B], d2H[B:], lat, kt, tol)
    latt = torch.as_tensor(lat, dtype=config.FLOAT).to(dev)
    tr_red = torch.diagonal(d2H[B:], dim1=-2, dim2=-1).real.sum(dim=(0, -1))  # (d, d) reduced
    tr2 = torch.einsum("ra,sc,rs->ac", latt, latt, tr_red) / ((2.0 * math.pi) ** 2)
    out = (out + tr2) / B
    return 0.5 * (out + out.T)


def _hessian_offsets(d, h):
    """Central-difference stencil for a d-dim Hessian: origin, +-h e_a,
    and the four signed corners per (a, b) pair."""
    qs = [np.zeros(d)]
    for a in range(d):
        for s in (+1.0, -1.0):
            v = np.zeros(d)
            v[a] = s * h
            qs.append(v)
    pairs = [(a, b) for a in range(d) for b in range(a + 1, d)]
    for a, b in pairs:
        for sa, sb in ((1, 1), (-1, -1), (1, -1), (-1, 1)):
            v = np.zeros(d)
            v[a], v[b] = sa * h, sb * h
            qs.append(v)
    return np.array(qs), pairs


def superfluid_weight(model, mu, delta, nk=(31, 31), temperature=None, step=1e-3, method="analytic"):
    """Superfluid weight D_s^{ab} of the s-wave mean-field state by exact
    BdG phase-twist response (counterpart of
    ``pythtb_tpu.geometry.superfluid_weight``): ``method="analytic"`` (the
    Daleckii-Krein Hessian) or ``"fd"`` (the central-difference stencil on
    the twisted grand potential).  Counts both spin species of a spinless
    model.  Returns (d, d) float64 per cell volume."""
    data, lat, _ = _prep(model, "superfluid_weight")
    if data.nspin != 1:
        raise PythtbError(
            "superfluid_weight supports spinless (spin-degenerate) "
            "models only -- explicit-spin pairing needs a Delta matrix"
        )
    if float(delta) <= 0.0:
        raise PythtbError("superfluid_weight requires delta > 0")
    d = data.dim_k
    nk = tuple(int(n) for n in np.atleast_1d(nk))
    if len(nk) != d or min(nk) < 2:
        raise PythtbError("nk must give %d sizes >= 2" % d)
    kt = float(delta) / 50.0 if temperature is None else float(temperature)
    if kt <= 0.0:
        raise PythtbError("temperature must be > 0 (use the default)")
    if method not in ("analytic", "fd"):
        raise PythtbError("superfluid_weight: unknown method %r" % (method,))
    vol = abs(np.linalg.det(lat))
    if method == "analytic":
        D = _sfw_analytic(data, nk, lat, float(mu), float(delta), kt).cpu().numpy()
        return D / vol
    h = float(step)
    # the BdG dispersion near the Fermi surface curves on the twist
    # scale q_c ~ delta / v_F; a step that cannot resolve it
    # underestimates the weight
    bw = float(np.abs(np.asarray(model._site_energies)).max() + 2.0 * sum(
        np.abs(complex(hh[0])) for hh in model._hoppings) + 1e-12)
    if h > float(delta) / max(bw, 1e-12):
        warnings.warn(
            "superfluid_weight: step = %.1e cannot resolve the BdG "
            "coherence scale delta / bandwidth ~ %.1e -- the finite-"
            "difference Hessian will underestimate D_s; reduce `step` "
            "(or treat the delta -> 0 limit with drude_weight)."
            % (h, float(delta) / max(bw, 1e-12)),
            UserWarning, stacklevel=2,
        )
    qs_cart, pairs = _hessian_offsets(d, h)
    # reduced twist: k_red = lat @ k_cart / (2 pi) (row convention)
    dqs = qs_cart @ lat.T / (2.0 * np.pi)
    F = _sfw_free_energy(data, nk, dqs, float(mu), float(delta), kt).cpu().numpy()
    D = np.zeros((d, d))
    for a in range(d):
        D[a, a] = (F[1 + 2 * a] + F[2 + 2 * a] - 2.0 * F[0]) / h**2
    base = 1 + 2 * d
    for idx, (a, b) in enumerate(pairs):
        f = F[base + 4 * idx: base + 4 * idx + 4]
        D[a, b] = D[b, a] = (f[0] + f[1] - f[2] - f[3]) / (4.0 * h**2)
    return D / vol


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


def _kp_tensors(data, kpts, lat):
    """Band energies (B, S), Cartesian first-derivative matrix elements V
    (B, d, S, S) and second-derivative ones W2 (B, d, d, S, S) of H(k) at
    the k-points ``kpts`` (the JAX package's ``_kp_tensors_jit``): kernel
    1, ``eigh_batched``, kernel 15 (dH, d2H) and einsums."""
    evals, _, V, W2 = _velocity_tensors(data, kpts, lat, need_d2=True)
    return evals, V, W2


def _kp_fetch(model, k0, caller):
    """Host-side (evals (S,), V (d, S, S), W2 (d, d, S, S)) at one k."""
    data, lat, _ = _prep(model, caller)
    k0 = np.atleast_1d(np.asarray(k0, dtype=np.float64))
    if k0.shape != (data.dim_k,):
        raise PythtbError("%s: k0 must have %d components" % (caller, data.dim_k))
    ev, V, W2 = _kp_tensors(data, torch.as_tensor(k0[None, :], dtype=config.FLOAT).to(data.device), lat)
    return (ev[0].cpu().numpy().astype(np.float64), V[0].cpu().numpy().astype(np.complex128),
            W2[0].cpu().numpy().astype(np.complex128), lat)


def effective_mass(model, k0, band, deg_tol=1e-7):
    """Inverse effective-mass tensor of one band at one k-point, from
    exact second-order perturbation theory (no finite differences):

    ``d2 eps_n / dk_a dk_b = W2^{ab}_nn
    + 2 Re sum_{m != n} V^a_nm V^b_mn / (e_n - e_m)``

    with the analytic Cartesian derivative matrix elements of
    :func:`pythtb_tpu.ops.hamiltonian.assemble_dk` /
    :func:`~pythtb_tpu.ops.hamiltonian.assemble_d2k` (the same sum
    rule as :func:`drude_weight`, resolved to a single band and
    k-point).  The reference has no band-derivative machinery at all
    (velocities and masses there mean finite-differencing
    ``solve_all`` output by hand).

    Beyond the reference.  Units: hbar = 1, so the returned Hessian is
    ``d2 eps/dk^2`` in [energy x length^2] and the principal masses are
    ``1/lambda_i`` in [1/(energy x length^2)].

    :param k0: one reduced k-point
    :param band: band index
    :param deg_tol: raise if another band sits within ``deg_tol`` of
      the target (single-band perturbation theory breaks down; use
      :func:`kp_model` on the whole multiplet instead)
    :returns: dict with ``hessian`` (d, d) symmetric float array,
      ``mass`` (d,) principal masses ``1/eigval``, ``axes`` (d, d)
      principal directions (columns), ``velocity`` (d,) band group
      velocity, ``energy`` float
    """
    ev, V, W2, _lat = _kp_fetch(model, k0, "effective_mass")
    n = int(band)
    if n < 0 or n >= ev.shape[0]:
        raise PythtbError("effective_mass: band %d out of range" % n)
    others = np.array([m for m in range(ev.shape[0]) if m != n], dtype=int)
    if others.size and np.min(np.abs(ev[others] - ev[n])) <= deg_tol:
        raise PythtbError(
            "effective_mass: band %d is degenerate at this k-point "
            "(min separation %.2e <= deg_tol %.2e); use kp_model on "
            "the degenerate multiplet"
            % (n, float(np.min(np.abs(ev[others] - ev[n]))), deg_tol)
        )
    d = V.shape[0]
    hess = np.real(W2[:, :, n, n]).copy()
    for m in others:
        vnm = V[:, n, m]  # (d,)
        hess += 2.0 * np.real(np.outer(vnm, np.conj(vnm))) / (ev[n] - ev[m])
    hess = 0.5 * (hess + hess.T)
    lam, axes = np.linalg.eigh(hess)
    with np.errstate(divide="ignore"):
        mass = np.where(lam != 0.0, 1.0 / np.where(lam != 0.0, lam, 1.0),
                        np.inf)
    return {
        "hessian": hess,
        "mass": mass,
        "axes": axes,
        "velocity": np.real(np.diagonal(V[:, :, :], axis1=1, axis2=2))[:, n],
        "energy": float(ev[n]),
    }


class KPModel:
    """Quasi-degenerate (Loewdin) k.p expansion around one k-point.

    ``H(dk) = h0 + sum_a dk_a h1[a] + (1/2) sum_ab dk_a dk_b h2[a, b]``
    with ``dk`` the CARTESIAN offset from ``k0`` (hbar = 1).  Built by
    :func:`kp_model`; calling the object with a batch of Cartesian
    offsets returns eigenvalues, ``.hamiltonian(dk)`` the matrix."""

    def __init__(self, k0, bands, h0, h1, h2, gap):
        self.k0 = np.asarray(k0, dtype=np.float64)
        self.bands = tuple(int(b) for b in bands)
        self.h0 = h0    # (nb, nb)
        self.h1 = h1    # (d, nb, nb)
        self.h2 = h2    # (d, d, nb, nb)
        self.gap = float(gap)  # min separation to the complement

    def hamiltonian(self, dk):
        """k.p matrix at Cartesian offset(s) dk: (..., nb, nb)."""
        dk = np.asarray(dk, dtype=np.float64)
        return (self.h0
                + np.einsum("...a,aij->...ij", dk, self.h1)
                + 0.5 * np.einsum("...a,...b,abij->...ij", dk, dk, self.h2))

    def __call__(self, dk):
        """Eigenvalues at Cartesian offset(s) dk: (..., nb)."""
        return np.linalg.eigvalsh(self.hamiltonian(dk))


def kp_model(model, k0, bands, deg_tol=1e-7):
    """Exact second-order k.p (Loewdin partitioning) model of a band
    multiplet around a k-point.

    The effective Hamiltonian on the selected set A is

    ``h0_mn = e_m delta_mn``,  ``h1^a_mn = V^a_mn``,
    ``h2^{ab}_mn = W2^{ab}_mn + (1/2) sum_{l not in A}
    (V^a_ml V^b_ln + V^b_ml V^a_ln)
    [1/(e_m - e_l) + 1/(e_n - e_l)]``

    (Loewdin quasi-degenerate perturbation theory to second order; all
    matrix elements analytic, Cartesian, from ``assemble_dk`` /
    ``assemble_d2k``).  Its eigenvalues reproduce the full model's
    bands in A to third order in |dk| when A is separated from its
    complement -- the committed convergence test halves dk and checks
    the error drops ~8x.

    Beyond the reference (which has no k.p machinery).  Typical uses:
    Dirac cones (graphene K: a 2x2 linear model with the exact Fermi
    velocity), Luttinger-type multiband masses, minimal models for
    transport.

    :param k0: reduced k-point to expand around
    :param bands: band indices forming the quasi-degenerate set A
    :param deg_tol: warn when the complement approaches A within
      100 x deg_tol (denominators degrade the expansion)
    :returns: :class:`KPModel`
    """
    ev, V, W2, _lat = _kp_fetch(model, k0, "kp_model")
    S = ev.shape[0]
    A = [int(b) for b in np.atleast_1d(bands)]
    if len(set(A)) != len(A) or min(A) < 0 or max(A) >= S:
        raise PythtbError("kp_model: bands must be distinct valid indices")
    comp = [l for l in range(S) if l not in A]
    d = V.shape[0]
    nb = len(A)
    Ai = np.asarray(A, dtype=int)
    h0 = np.diag(ev[Ai]).astype(np.complex128)
    h1 = V[:, Ai[:, None], Ai[None, :]]  # (d, nb, nb)
    h2 = W2[:, :, Ai[:, None], Ai[None, :]].copy()  # (d, d, nb, nb)
    gap = np.inf
    if comp:
        Ci = np.asarray(comp, dtype=int)
        gap = float(np.min(np.abs(ev[Ci][None, :] - ev[Ai][:, None])))
        if gap <= deg_tol:
            raise PythtbError(
                "kp_model: the selected set is degenerate with its "
                "complement (min separation %.2e); enlarge `bands` to "
                "cover the whole multiplet" % gap
            )
        if gap <= 100.0 * deg_tol:
            warnings.warn(
                "kp_model: only %.2e separates the set from its "
                "complement -- the expansion radius is tiny" % gap,
                stacklevel=2,
            )
        VA = V[:, Ai[:, None], Ci[None, :]]  # (d, nb, nc)
        # inv[m, l] = 1 / (e_m - e_l), m in A, l in comp
        inv = 1.0 / (ev[Ai][:, None] - ev[Ci][None, :])
        # second-order Loewdin: (1/2) (V^a_ml V^b_ln + a<->b)
        #                       [inv[m, l] + inv[n, l]]
        t1 = np.einsum("aml,bnl,ml->abmn", VA, np.conj(VA), inv)
        h2 += 0.5 * ((t1 + t1.transpose(1, 0, 2, 3))
                     + (np.conj(t1.transpose(0, 1, 3, 2))
                        + np.conj(t1.transpose(1, 0, 3, 2))))
    return KPModel(np.atleast_1d(k0), A, h0, h1, h2, gap)
