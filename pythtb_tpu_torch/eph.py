"""Electron-phonon coupling from bond-length (Peierls/SSH) modulation
(counterpart of ``pythtb_tpu.eph``).

Every hopping depends on its bond length through
``t(d) = t0 exp(-beta (d/d0 - 1))``, so ``dt/du = -(beta/d0) t dhat``; a
stored hop (i -> j, R, t) contributes

    dH(k, q)_{ij} += e^{2 pi i k.R} t'(d0) dhat . (A_j e^{2 pi i q.R} - A_i)

and its Hermitian partner the mirrored term, with the phonon amplitudes
``A_kappa = e_{nu,kappa} / sqrt(2 m_kappa omega_nu)`` of
:mod:`pythtb_tpu_torch.phonon`.

* :func:`coupling` -- the vertex at one (k, q) on the host (the
  reference's ``gen_ham`` and NumPy ``eigh``);
* :func:`linewidths` -- Fermi-golden-rule electron linewidths over a
  q-grid;
* :func:`eliashberg` -- alpha^2 F(omega) and lambda.

The batched vertex of the last two (``pythtb_tpu.eph._gsq_qbatch_jit``)
runs a chunk of electron k-points per launch: kernel 1 assembles H at k
and k + q for the whole chunk, ``eigh_batched`` solves them, the states
turn to convention II by e^{2 pi i k.t_a}, the phonon amplitudes are
formed in torch, and kernel 26
(:func:`pythtb_tpu_torch.ops.eph_vertex.eph_vertex`) writes |g|^2.  Each
k's result is the per-k call's: kernels 1 and 26 and the eigensolver act
matrix by matrix.  A chunk's |g|^2 and states stay under
``ops.propagate.CHUNK_BYTES`` (2 GB): eliashberg's default 24^2 x 24^2
is one chunk.  The Bose/Fermi/Gaussian weights and the golden-rule sums
run in torch on the same device in float64.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import config
from .model import PythtbError
from .ops import propagate
from .ops.eigh import eigh_batched
from .ops.eph_vertex import VertexTables, eph_vertex
from .ops.hamiltonian import assemble
from .ops.solver import device_uniform_grid
from .phonon import _solve as _ph_solve
from .phonon import force_model

__all__ = ["coupling", "linewidths", "eliashberg"]


def _prep(model, fc, beta, atom_of):
    """Validate and extract the doubled hop-geometry table: per DIRECTED
    hop (both directions of every stored bond) i, j (orbital), R (dim_k
    ints), tp (t'(d0) = -beta t / d0), dhat (Cartesian unit bond vector
    i -> j).  Host NumPy, as in the reference."""
    if model._nspin != 1:
        raise PythtbError("eph: spinless electronic models only")
    if not isinstance(fc, force_model):
        raise PythtbError("eph: fc must be a phonon.force_model")
    if model._dim_k != model._dim_r:
        raise PythtbError("eph: fully periodic models only")
    if fc._dim_k != model._dim_k or fc._dim_r != model._dim_r:
        raise PythtbError("eph: electron and phonon models disagree on dimensionality")
    norb = model._norb
    if atom_of is None:
        if fc._natom != norb:
            raise PythtbError("eph: %d orbitals vs %d atoms -- pass atom_of" % (norb, fc._natom))
        atom_of = np.arange(norb)
    atom_of = np.asarray(atom_of, dtype=np.int64)
    if atom_of.shape != (norb,) or atom_of.min() < 0 or atom_of.max() >= fc._natom:
        raise PythtbError("eph: bad atom_of map")
    # orbital positions must ride their atoms exactly: a whole-lattice-
    # vector offset would need folding into every q phase
    lat = np.asarray(model._lat, dtype=np.float64)
    dpos = np.asarray(model._orb) - np.asarray(fc._pos)[atom_of]
    if np.abs(dpos).max() > 1e-6:
        raise PythtbError(
            "eph: orbital positions do not coincide with their atoms "
            "(max reduced mismatch %.2e%s); make the electronic "
            "orbitals and phonon atoms use the same home-cell "
            "convention (identical reduced coordinates), or fix "
            "atom_of" % (
                np.abs(dpos).max(),
                ", a whole lattice vector" if np.abs(dpos - np.round(dpos)).max() <= 1e-6 else ""))
    ii, jj, RR, tp, dh = [], [], [], [], []
    for hop in model._hoppings:
        amp, i, j = complex(hop[0]), hop[1], hop[2]
        R = np.asarray(hop[3], dtype=np.int64)
        dvec = (np.asarray(model._orb[j]) + R - np.asarray(model._orb[i])) @ lat
        d0 = float(np.linalg.norm(dvec))
        if d0 < 1e-12:
            continue  # coincident orbitals: bond length is frozen
        dhat = dvec / d0
        fpr = -float(beta) / d0
        # stored direction
        ii.append(i)
        jj.append(j)
        RR.append(R)
        tp.append(fpr * amp)
        dh.append(dhat)
        # Hermitian partner
        ii.append(j)
        jj.append(i)
        RR.append(-R)
        tp.append(fpr * np.conj(amp))
        dh.append(-dhat)
    if not ii:
        raise PythtbError("eph: the model has no finite-length bonds")
    return {
        "i": np.asarray(ii, dtype=np.int64),
        "j": np.asarray(jj, dtype=np.int64),
        "R": np.asarray(RR, dtype=np.float64),
        "tp": np.asarray(tp, dtype=complex),
        "dhat": np.asarray(dh, dtype=np.float64),
        "atom_of": atom_of,
        "norb": norb,
        "d": model._dim_r,
    }


def _dH_host(geom, fc, k, q, modes=None):
    """Host reference: (omega, dH(k, q) (nmode_sel, norb, norb))."""
    d = geom["d"]
    omega, vecs = _ph_solve(fc, np.atleast_2d(q), want_vectors=True)
    omega, vecs = omega[0], vecs[0]  # (nmode,), rows are modes
    nmode = len(omega)
    sel = range(nmode) if modes is None else modes
    misq = 1.0 / np.sqrt(fc._mass)
    out = []
    w_out = []
    for nu in sel:
        w = float(omega[nu])
        # zero/acoustic-at-Gamma mode: the bare vertex vanishes; report 0
        zp = 0.0 if w < 1e-9 else 1.0 / np.sqrt(2.0 * w)
        e = vecs[nu].reshape(fc._natom, d)
        A = (misq[:, None] * e) * zp  # (natom, d)
        Ai = A[geom["atom_of"][geom["i"]]]  # (nh, d)
        Aj = A[geom["atom_of"][geom["j"]]]
        phk = np.exp(2.0j * np.pi * (geom["R"] @ np.asarray(k, float)))
        phq = np.exp(2.0j * np.pi * (geom["R"] @ np.asarray(q, float)))
        coef = geom["tp"] * phk * np.einsum("hd,hd->h", geom["dhat"], Aj * phq[:, None] - Ai)
        dH = np.zeros((geom["norb"], geom["norb"]), complex)
        np.add.at(dH, (geom["i"], geom["j"]), coef)
        out.append(dH)
        w_out.append(w)
    return np.asarray(w_out), np.asarray(out)


def coupling(model, fc, beta, k, q, atom_of=None, band_basis=True, occ=None):
    """The e-ph vertex at a single (k, q) pair, host-facing.

    :returns: dict with ``"omega"`` (nmode,), ``"g"`` (nmode, nsta,
      nsta) -- in the band basis ``g[nu, m, n] = <m, k+q|dH|n, k>`` when
      ``band_basis`` (default), else the orbital-basis dH(k, q).
    """
    geom = _prep(model, fc, beta, atom_of)
    k = np.asarray(k, dtype=np.float64)
    q = np.asarray(q, dtype=np.float64)
    omega, dH = _dH_host(geom, fc, k, q)
    if not band_basis:
        return {"omega": omega, "g": dH}
    orb = np.asarray(model._orb)

    def _vec2(kpt):
        H = np.asarray(model.gen_ham([list(kpt)])[0], dtype=complex)
        ph = np.exp(2.0j * np.pi * (orb @ kpt))
        H2 = ph[:, None] * H * np.conj(ph)[None, :]
        w, v = np.linalg.eigh(H2)
        return w, v  # columns are states (conv II)

    _, vk = _vec2(k)
    _, vkq = _vec2(k + q)
    g = np.einsum("am,uab,bn->umn", np.conj(vkq), dH, vk)
    return {"omega": omega, "g": g}


# ---------------------------------------------------------------------------
# the batched vertex: a chunk of electron k against the whole q-grid


class _QGrid:
    """What ``_qgrid_setup`` hands the batched vertex: the q-grid (same
    C-order as ``device_uniform_grid(nkq)``), the phonon frequencies and
    the amplitudes A (Q, nmode, natom, d) with the zero-point factor, the
    hop tables and the orbital positions, all on the model's device."""

    def __init__(self, model, fc, geom, nkq, ph_w, ph_vecs):
        dev = config.device()
        self.device = dev
        self.d = geom["d"]
        self.qg = device_uniform_grid(nkq, [0.0] * self.d, dev)
        self.ph_w = torch.as_tensor(ph_w, dtype=config.FLOAT).to(dev)
        Q, nmode = ph_w.shape
        e = torch.as_tensor(ph_vecs, dtype=config.COMPLEX).to(dev).reshape(Q, nmode, fc._natom, self.d)
        misq = torch.as_tensor(1.0 / np.sqrt(fc._mass), dtype=config.FLOAT).to(dev)
        w = self.ph_w
        zp = torch.where(w > 1e-7, 1.0 / torch.sqrt(2.0 * torch.clamp(w, min=1e-30)), torch.zeros_like(w))
        self.A = (e * misq[None, None, :, None] * zp[:, :, None, None]).contiguous()
        self.tab = VertexTables(geom, dev)
        self.orbs = torch.as_tensor(np.asarray(model._orb, dtype=np.float64)).to(dev)


def _qgrid_setup(model, fc, beta, atom_of, nkq):
    """Host prep shared by linewidths/eliashberg: the geometry table and
    the phonon solve on the q-grid, moved to the device."""
    geom = _prep(model, fc, beta, atom_of)
    d = geom["d"]
    nkq = tuple(int(n) for n in np.atleast_1d(nkq))
    if len(nkq) != d:
        raise PythtbError("eph: nkq must give %d sizes" % d)
    grids = [np.arange(n) / float(n) for n in nkq]
    qg = np.stack(np.meshgrid(*grids, indexing="ij"), axis=-1).reshape(-1, d)
    ph_w, ph_vecs = _ph_solve(fc, qg, want_vectors=True)
    ph_w = np.maximum(ph_w, 0.0)
    return geom, nkq, qg, ph_w, _QGrid(model, fc, geom, nkq, ph_w, ph_vecs)


def _gsq_chunk(data, kpts, grid):
    """|g|^2 (Kc, Q, nmode, S, S), e(k) (Kc, S) and e(k+q) (Kc, Q, S) for
    the (Kc, d) electron k-points ``kpts`` (a device tensor)."""
    Kc, Q = kpts.shape[0], grid.qg.shape[0]
    kall = torch.cat([kpts, (kpts[:, None, :] + grid.qg[None]).reshape(Kc * Q, grid.d)])
    evals, vecs = eigh_batched(assemble(data, kall))  # rows are states (conv I)
    # conv I -> conv II: v_II[n, a] = e^{2 pi i k.t_a} v_I[n, a]
    ang = (2.0 * math.pi) * (kall @ grid.orbs.T)
    v2 = vecs * torch.polar(torch.ones_like(ang), ang)[:, None, :]
    S = v2.shape[-1]
    vkq = v2[Kc:].reshape(Kc, Q, S, S)
    gsq = eph_vertex(v2[:Kc], vkq, grid.A, grid.tab, kpts, grid.qg)
    return gsq, evals[:Kc], evals[Kc:].reshape(Kc, Q, S)


def _chunks(kpts, grid, S):
    """The electron k-points as device tensors, in chunks whose |g|^2,
    weights and states stay under ``ops.propagate.CHUNK_BYTES``."""
    Q, nmode = grid.ph_w.shape
    per_k = (Q + 1) * S * S * (2 * 8 * nmode + 3 * 16)
    step = max(1, propagate.CHUNK_BYTES // per_k)
    kt = torch.as_tensor(np.ascontiguousarray(kpts, dtype=np.float64)).to(grid.device)
    return [kt[i:i + step] for i in range(0, kt.shape[0], step)]


def _gsq_at_k(data, kpt, grid):
    """One electron k-point against the q-grid: (|g|^2 (B, nmode, S, S),
    e(k) (S,), e(k+q) (B, S)) as NumPy (the reference's ``_gsq_at_k``)."""
    k = torch.as_tensor(np.asarray(kpt, dtype=np.float64).reshape(1, -1)).to(grid.device)
    gsq, ek, ekq = _gsq_chunk(data, k, grid)
    return tuple(np.array(t[0].cpu().numpy(), dtype=np.float64) for t in (gsq, ek, ekq))


def _gauss(x, s):
    return torch.exp(-0.5 * (x / s) ** 2) / (s * math.sqrt(2.0 * math.pi))


def linewidths(model, fc, beta, kpts, mu, temperature, nkq=(24, 24), sigma=0.05, atom_of=None):
    """Phonon-limited electron linewidths Gamma_n(k) (Fermi golden rule):

    Gamma_n(k) = 2 pi (1/Nq) sum_{q m nu} |g_{mn nu}(k, q)|^2 *
      [ (n_nu + f_m) G_sigma(e_n + w_nu - e_m)
      + (n_nu + 1 - f_m) G_sigma(e_n - w_nu - e_m) ]

    with Bose/Fermi occupations at ``temperature``/``mu`` and Gaussian
    energy conservation of width ``sigma``.

    :returns: (nk, nsta) float array.
    """
    if float(temperature) <= 0.0:
        raise PythtbError("eph.linewidths: temperature must be > 0")
    kt = float(temperature)
    geom, nkq, qg, ph_w, grid = _qgrid_setup(model, fc, beta, atom_of, nkq)
    data = model._get_finalized()
    w = grid.ph_w  # (B, nmode)
    x = torch.clamp(w / kt, 1e-10, 60.0)
    nb = torch.where(w / kt > 60.0, torch.zeros_like(w), 1.0 / torch.expm1(x))
    out = []
    for k in _chunks(np.atleast_2d(np.asarray(kpts, dtype=np.float64)), grid, data.nsta):
        gsq, ek, ekq = _gsq_chunk(data, k, grid)
        f = 1.0 / (1.0 + torch.exp(torch.clamp((ekq - mu) / kt, -60.0, 60.0)))
        em = ekq[:, :, None, :, None]       # (K, B, 1, m, 1)
        en = ek[:, None, None, None, :]     # (K, 1, 1, 1, n)
        wv = w[None, :, :, None, None]
        nbv = nb[None, :, :, None, None]
        fv = f[:, :, None, :, None]
        weight = ((nbv + fv) * _gauss(en + wv - em, sigma)
                  + (nbv + 1.0 - fv) * _gauss(en - wv - em, sigma))
        out.append(2.0 * math.pi * torch.einsum("kbumn,kbumn->kn", gsq, weight) / gsq.shape[1])
    return torch.cat(out).cpu().numpy().astype(np.float64)


def eliashberg(model, fc, beta, mu, nk=(24, 24), nkq=(24, 24), omegas=None, sigma_e=0.05, sigma_w=None,
               atom_of=None):
    """Eliashberg spectral function and mass enhancement:

    alpha^2 F(w) = (1/N(mu)) (1/(Nk Nq)) sum_{k q m n nu}
        |g_{mn nu}(k, q)|^2 G_se(e_nk - mu) G_se(e_m,k+q - mu) G_sw(w - w_nu),
    N(mu) = (1/Nk) sum_{nk} G_se(e_nk - mu),
    lambda = 2 sum |g|^2 dd / w over the same terms.

    :returns: dict with ``"omega"``, ``"a2f"``, ``"lambda"``, ``"dos_ef"``.
    """
    geom, nkq, qg, ph_w, grid = _qgrid_setup(model, fc, beta, atom_of, nkq)
    data = model._get_finalized()
    d = geom["d"]
    nk = tuple(int(n) for n in np.atleast_1d(nk))
    if len(nk) != d:
        raise PythtbError("eph: nk must give %d sizes" % d)
    grids = [np.arange(n) / float(n) for n in nk]
    kg = np.stack(np.meshgrid(*grids, indexing="ij"), axis=-1).reshape(-1, d)
    wmax = float(ph_w.max())
    if sigma_w is None:
        sigma_w = max(wmax / 40.0, 1e-6)
    if omegas is None:
        omegas = np.linspace(0.0, 1.15 * wmax + 5.0 * sigma_w, 240)
    omegas = np.asarray(omegas, dtype=np.float64)
    dos = torch.zeros((), dtype=config.FLOAT, device=grid.device)
    s_mode = torch.zeros_like(grid.ph_w)  # sum over k of (B, nmode)
    for k in _chunks(kg, grid, data.nsta):
        gsq, ek, ekq = _gsq_chunk(data, k, grid)
        dn = _gauss(ek - mu, sigma_e)   # (K, n)
        dm = _gauss(ekq - mu, sigma_e)  # (K, B, m)
        dos = dos + dn.sum()
        s_mode = s_mode + torch.einsum("kbumn,kbm,kn->bu", gsq, dm, dn)
    w = grid.ph_w
    om = torch.as_tensor(omegas).to(grid.device)
    a2f = (_gauss(om[None, None, :] - w[:, :, None], sigma_w) * s_mode[:, :, None]).sum(dim=(0, 1))
    lam = 2.0 * float(torch.where(w > 1e-6, s_mode / torch.where(w > 1e-6, w, torch.ones_like(w)),
                                  torch.zeros_like(w)).sum())
    nqk = len(kg) * len(qg)
    dos = float(dos) / len(kg)
    if dos < 1e-12:
        raise PythtbError("eliashberg: no states at mu (N(mu) ~ 0); move mu or raise sigma_e")
    return {"omega": omegas, "a2f": a2f.cpu().numpy().astype(np.float64) / (dos * nqk),
            "lambda": float(lam / (dos * nqk)), "dos_ef": float(dos)}
