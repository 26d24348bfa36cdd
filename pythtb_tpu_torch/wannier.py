"""Projection-based Wannier interpolation with maximal localization and
disentanglement (counterpart of ``pythtb_tpu.wannier``).

Solve the model on a coarse uniform grid, project a chosen band group
onto trial vectors (Lowdin / polar orthonormalization), optionally
minimize the Marzari-Vanderbilt spread (and, for entangled groups,
select an optimally smooth subspace first, Souza-Marzari-Vanderbilt),
Fourier-transform the projected Hamiltonian to real space, and
interpolate to arbitrary k.

Formulation (as in the JAX package).  Convention-I eigenvector
coefficients are rephased to ``c'_alpha = exp(2j*pi*k.t_alpha) c_alpha``
so every k-dependent object is periodic under k -> k+G.  With trial
vectors g the projection ``A(k) = <u'_n(k)|g_m>`` is polar-decomposed,
``V = U V^H``; the projected Hamiltonian ``B(k) = V^H diag(E) V`` has the
Fourier coefficients ``H(R) = (1/Nk) sum_k exp(-2j*pi*k.R) B(k)`` over a
centred R grid, and ``E(k') = eigvalsh(sum_R exp(2j*pi*k'.R) H(R))``.

Device work: the coarse solve is kernel 1 and ``eigh_batched`` (kernels
2 or 7, or ``torch.linalg.eigh``, by band count); the Marzari-Vanderbilt
run is kernel 19 (``csrc/mv_step.cu``: to 8 Wannier functions the whole
run in one launch and its closing spreads in a second, from 9 to 32 three
launches a step; no host read inside the run; raising above 32 on the
card; :func:`_mv_step_plain`, the JAX arithmetic in torch, on CPU tensors);
the SMV subspace iteration,
the projections and the R-grid transforms are library calls
(``torch.linalg.eigh``/``svd``, ``torch.einsum``, ``torch.matmul``).
The b-shells, neighbour tables, R grids and the greedy anchor trials are
host NumPy.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import config
from .model import PythtbError
from .ops import _kernels
from .ops.eigh import eigh_batched, eigvalsh_batched
from .ops.hamiltonian import assemble
from .ops.solver import device_uniform_grid

__all__ = ["WannierInterpolator", "interpolator", "disentangled_interpolator"]

# most Wannier functions kernel 19 takes (the run kernel, a warp a k, up to
# 8; three block launches a step from 9 to 32)
_KERNEL_MAX_NW = 32
# kernel 19's designs and the most Wannier functions each takes: "grid", the
# run kernel (the whole run in one cooperative launch, a warp a k) and
# "block", three block launches a step
_MV_DESIGNS = {"grid": 8, "block": _KERNEL_MAX_NW}
# the run kernel's k-points a block (csrc/mv_step.cu's kMVGridWarps): they
# size its partial sums
_MV_GRID_WARPS = 4
# the run kernel's partial sums a block: dc nw (at most 3 x 8) + 2, then one
_MV_RED_STRIDE = 3 * 8 + 2 + 1
# all of a run kernel step's phases (overlaps 1, reductions 2, update 4);
# chip_smoke.py leaves some out to time the others
_MV_PHASES = 7
# heavy-ball momentum of the MV descent
_MU = 0.9


def _r_grid(nk):
    """Centered integer R-lattice for the nk coarse grid: (NR, dim) NumPy,
    components in [-n//2, n - n//2).  The single home of the R ordering."""
    grids = np.meshgrid(*[np.arange(n) - (n // 2) for n in nk], indexing="ij")
    return np.stack([g.ravel() for g in grids], axis=-1)


# -- finite-difference b-shells (Mostofi et al., CPC 178, 685 (2008)) --


def _bshells(lat, per, nk, search=3, tol=1e-6):
    """Nearest-neighbor shells of the coarse k-grid with completeness
    weights: returns ``(b_int, b_cart, w_b)`` where ``b_int`` (nb,
    dim_k) are integer grid offsets, ``b_cart`` (nb, dim_r) are the
    Cartesian b-vectors, and ``w_b`` satisfies the B1 condition
    ``sum_b w_b b_i b_j = delta_ij`` restricted to the periodic span.

    The gradient discretization behind every MV/SMV quantity (spreads,
    centers, gauge gradients) needs finite-difference vectors whose
    weighted outer products resolve the identity; shells of equal-length
    b's are added in increasing length until a least-squares solve for
    the shell weights closes the condition (the standard Wannier90
    construction, re-derived for arbitrary dim_k and row-vector
    lattices)."""
    lat = np.asarray(lat, dtype=np.float64)
    per = list(per)
    A = lat[per, :]  # (dim_k, dim_r) periodic lattice rows
    dim_k, dim_r = A.shape
    # reciprocal rows within the span: G @ A.T = 2 pi I
    G = 2.0 * np.pi * np.linalg.solve(A @ A.T, A)
    # orthonormal basis of the span (for the B1 condition)
    Q = np.linalg.svd(G, full_matrices=False)[2]  # (dim_k, dim_r)

    rng = [np.arange(-search, search + 1)] * dim_k
    ms = np.stack(np.meshgrid(*rng, indexing="ij"), axis=-1).reshape(-1, dim_k)
    ms = ms[np.any(ms != 0, axis=1)]
    bc = (ms / np.asarray(nk, dtype=np.float64)) @ G  # (M, dim_r)
    ln = np.linalg.norm(bc, axis=1)
    order = np.argsort(ln, kind="stable")
    ms, bc, ln = ms[order], bc[order], ln[order]

    # group into shells by length
    shells = []
    i = 0
    while i < len(ln):
        j = i
        while j < len(ln) and ln[j] <= ln[i] * (1.0 + tol):
            j += 1
        shells.append((ms[i:j], bc[i:j]))
        i = j

    # B1 condition in span coordinates: for each shell s,
    # sum_{b in s} (b.q_i)(b.q_j) summed with weight w_s == delta_ij
    npair = dim_k * (dim_k + 1) // 2
    iu = np.triu_indices(dim_k)
    target = np.eye(dim_k)[iu]

    rows = []  # (npair,) per accepted shell
    acc = []
    for s_ms, s_bc in shells:
        bq = s_bc @ Q.T  # (ns, dim_k)
        outer = np.einsum("ni,nj->ij", bq, bq)[iu]
        # skip shells linearly dependent on the accepted ones
        trial_rows = rows + [outer]
        Mt = np.stack(trial_rows, axis=1)  # (npair, ns+1)
        if np.linalg.matrix_rank(np.stack(trial_rows, axis=0), tol=1e-10) == len(rows):
            continue
        rows = trial_rows
        acc.append((s_ms, s_bc))
        w, res, _, _ = np.linalg.lstsq(Mt, target, rcond=None)
        if np.linalg.norm(Mt @ w - target) < 1e-8 and np.all(
            np.asarray(w) > 1e-12
        ):
            b_int = np.concatenate([a[0] for a in acc], axis=0)
            b_cart = np.concatenate([a[1] for a in acc], axis=0)
            w_b = np.concatenate(
                [np.full(len(a[0]), float(wi)) for a, wi in zip(acc, w)]
            )
            return b_int.astype(np.int64), b_cart, w_b
    raise PythtbError(
        "could not find finite-difference shells satisfying the B1 "
        "completeness condition for this lattice/grid (raise `search`)"
    )


def _neighbor_index(nk, b_int):
    """(Nk, nb) flat row-major index of grid point k + b (periodic)."""
    nk = np.asarray(nk, dtype=np.int64)
    grids = np.meshgrid(*[np.arange(n) for n in nk], indexing="ij")
    idx = np.stack([g.ravel() for g in grids], axis=-1)  # (Nk, dim)
    nb = (idx[:, None, :] + b_int[None, :, :]) % nk[None, None, :]
    strides = np.concatenate([np.cumprod(nk[::-1])[::-1][1:], [1]])
    return (nb * strides[None, None, :]).sum(-1)


def _greedy_anchor_trials(u, nw):
    """Orbital anchors chosen greedily to maximize the WORST-k smallest
    singular value of the projection (host-side; u is (B, no, nsta)
    complex).  The automatic fallback when the mean-projector trials
    degenerate: e.g. for silicon valence the grid-averaged projector is
    ~I/2 (the two sublattices carry equal weight), so its eigenvectors
    are arbitrary and project near-singularly, while greedily-chosen
    one-hot orbital anchors give sv ~ 0.4."""
    import itertools
    from math import comb

    B, no, nsta = u.shape
    cols = np.conj(u)  # candidate column s of A(k) = conj(u[:, :, s])

    def score(sel):
        A = cols[:, :, list(sel)]
        return float(np.linalg.svd(A, compute_uv=False).min())

    if comb(nsta, nw) <= 512:
        # exhaustive over orbital subsets (greedy is myopic: its first
        # pick conditions the rest and can land far from the optimum)
        best = max(itertools.combinations(range(nsta), nw), key=score)
    else:
        sel = []
        for _ in range(nw):
            cand = [s for s in range(nsta) if s not in sel]
            sel.append(max(cand, key=lambda s: score(sel + [s])))
        best = tuple(sel)
    g = np.zeros((nw, nsta), dtype=complex)
    for m, s in enumerate(best):
        g[m, s] = 1.0
    return g, score(best)



# -- the Marzari-Vanderbilt step (kernel 19) and its plain version -----


def _ct(X):
    return X.conj().transpose(-1, -2)


def _expm_antiherm(G):
    """exp(G) for anti-Hermitian (..., n, n) G via eigh of iG."""
    lam, W = torch.linalg.eigh(1.0j * G)
    return (W * torch.polar(torch.ones_like(lam), -lam)[..., None, :]) @ _ct(W)


def _gauge_overlaps(M0, U, nbr):
    """M(k,b) = U(k)^H M0(k,b) U(k+b)."""
    return torch.einsum("kmi,kbmn,kbnj->kbij", U.conj(), M0, U[nbr])


def _spread_terms(M, w_b, b_cart):
    """Centers and spread pieces from overlaps M (B, nb, n, n): (rbar (dc,
    n), Omega_I, Omega_tilde) as tensors."""
    N, n = M.shape[0], M.shape[-1]
    Mnn = torch.diagonal(M, dim1=-2, dim2=-1)  # (B, nb, n)
    ang = torch.angle(Mnn)
    rbar = -(torch.einsum("b,bd,kbn->dn", w_b, b_cart, ang) / N)
    q = ang + (b_cart @ rbar)[None]
    sum_all = (M.abs() ** 2).sum(dim=(-1, -2))  # (B, nb)
    sum_diag = (Mnn.abs() ** 2).sum(dim=-1)
    omega_i = (w_b[None] * (n - sum_all)).sum() / N
    omega_od = (w_b[None] * (sum_all - sum_diag)).sum() / N
    omega_d = (w_b[None, :, None] * q**2).sum() / N
    return rbar, omega_i, omega_od + omega_d


def _mv_gradient(M, w_b, b_cart, rbar):
    """MV steepest-descent direction dOmega/dW (anti-Hermitian, per k)."""
    Mnn = torch.diagonal(M, dim1=-2, dim2=-1)
    q = torch.angle(Mnn) + (b_cart @ rbar)[None]
    R = M * Mnn.conj()[:, :, None, :]
    den = torch.where(Mnn.abs() < 1e-12, torch.ones_like(Mnn), Mnn)
    T = M / den[:, :, None, :] * q[:, :, None, :]
    A_ = (R - _ct(R)) / 2.0
    S_ = (T + _ct(T)) / 2.0j
    return 4.0 * torch.einsum("b,kbmn->kmn", w_b.to(M.dtype), A_ - S_)


def _mv_step_plain(M0, nbr, w_b, b_cart, U, dW, eps, om_prev, eps_cap):
    """One MV step in plain PyTorch, the arithmetic of the JAX package's
    ``_mv_localize`` scan step: the oracle of kernel 19.  ``eps`` and
    ``om_prev`` are 0-d tensors.  Returns (U, dW, eps, om)."""
    M = _gauge_overlaps(M0, U, nbr)
    rbar, oi, ot = _spread_terms(M, w_b, b_cart)
    om = oi + ot
    up = om > om_prev
    eps = torch.clamp(torch.where(up, eps * 0.5, eps * 1.1), max=eps_cap)
    # (a float64 momentum: torch.where of two Python numbers would be float32)
    dW = torch.where(up, torch.zeros_like(om), torch.full_like(om, _MU)) * dW
    dW = dW + eps * _mv_gradient(M, w_b, b_cart, rbar)
    return U @ _expm_antiherm(dW), dW, eps, om


def _mv_run_plain(M0, nbr, w_b, b_cart, steps, eps0):
    B, nb, n, _ = M0.shape
    U = torch.eye(n, dtype=config.COMPLEX, device=M0.device).expand(B, n, n).clone()
    dW = torch.zeros_like(U)
    eps = torch.tensor(eps0, dtype=config.FLOAT, device=M0.device)
    om = torch.tensor(math.inf, dtype=config.FLOAT, device=M0.device)
    hist = []
    for _ in range(steps):
        U, dW, eps, om = _mv_step_plain(M0, nbr, w_b, b_cart, U, dW, eps, om, 20.0 * eps0)
        hist.append(om)
    hist = torch.stack(hist) if hist else torch.zeros((0,), dtype=config.FLOAT, device=M0.device)
    return U, hist, _spread_terms(_gauge_overlaps(M0, U, nbr), w_b, b_cart)


def _mv_design(B, nb, n, sms):
    """Kernel 19's design for B k-points, nb b-vectors and n Wannier
    functions on a card of ``sms`` SMs: the run kernel's cooperative grid to
    8 Wannier functions, the three block launches a step above.  On the
    H100 the run kernel won at every shape measured, B 64-4,096 and nw 1-8
    on 132 SMs (PERF.md section 6), so the line does not move with B, nb or
    the SMs."""
    return "grid" if n <= _MV_DESIGNS["grid"] else "block"


def _mv_red_blocks(B):
    """Blocks the run kernel's partial sums must hold at B k-points: its
    cooperative grid never takes more than a block each four k-points."""
    return max(1, -(-B // _MV_GRID_WARPS))


class _MVState:
    """Kernel 19's device buffers for one run."""

    def __init__(self, M0, nbr, w_b, b_cart, steps, eps0, design=None):
        dev = M0.device
        B, nb, n, _ = M0.shape
        dc = b_cart.shape[1]
        _kernels.require(M0, "M0", config.COMPLEX, (B, nb, n, n), dev)
        _kernels.require(nbr, "nbr", torch.int64, (B, nb), dev)
        _kernels.require(w_b, "w_b", config.FLOAT, (nb,), dev)
        _kernels.require(b_cart, "b_cart", config.FLOAT, (nb, dc), dev)
        if not 1 <= dc <= 3:
            raise ValueError("kernel 19 takes 1 to 3 Cartesian components, got %d" % dc)
        if n > _KERNEL_MAX_NW:
            raise ValueError(
                "kernel 19 takes at most %d Wannier functions on a CUDA tensor, got %d; run the call on the "
                'CPU (config.set_device("cpu")) for more' % (_KERNEL_MAX_NW, n))
        if design is None:
            design = _mv_design(B, nb, n, _kernels.card(dev)[0])
        if design not in _MV_DESIGNS:
            raise ValueError("kernel 19 has no %r design; it has %s" % (design, ", ".join(_MV_DESIGNS)))
        if n > _MV_DESIGNS[design]:
            raise ValueError("kernel 19's %r design takes at most %d Wannier functions, got %d"
                             % (design, _MV_DESIGNS[design], n))
        self.design = design
        self.args = (M0, nbr, w_b, b_cart)
        self.shape = (B, nb, n, dc)
        self.U = torch.eye(n, dtype=config.COMPLEX, device=dev).expand(B, n, n).contiguous()
        self.dW = torch.zeros_like(self.U)
        self.M = torch.empty_like(M0)
        self.part = torch.empty((B * nb, n + 2), dtype=config.FLOAT, device=dev)
        self.red_blocks = _mv_red_blocks(B)
        self.red = (torch.empty((self.red_blocks * _MV_RED_STRIDE,), dtype=config.FLOAT, device=dev)
                    if design != "block" else None)
        self.scal = torch.tensor([eps0, math.inf, 0.0], dtype=config.FLOAT, device=dev)
        self.rbar = torch.empty((dc, n), dtype=config.FLOAT, device=dev)
        self.hist = torch.empty((max(steps, 1),), dtype=config.FLOAT, device=dev)
        self.fin = torch.empty((2,), dtype=config.FLOAT, device=dev)
        self.eps_cap = 20.0 * eps0

    def run(self, steps, counter, phases=_MV_PHASES):
        """``steps`` steps in one launch of the run kernel (0: the closing
        pair), or three block launches a step; counted in ``counter``."""
        M0, nbr, w_b, b_cart = self.args
        B, nb, n, dc = self.shape
        dev = M0.device
        if self.design != "block":
            _kernels.launch("mv_run", dev, M0, nbr, w_b, b_cart, self.U, self.dW, self.M, self.part, self.red,
                            self.scal, self.rbar, self.hist, self.fin, B, nb, n, dc, _MU, self.eps_cap, steps,
                            self.red_blocks, phases, counter=counter)
            return
        for step in range(steps) if steps else (-1,):
            _kernels.launch("mv_overlaps", dev, M0, nbr, self.U, self.M, self.part, B, nb, n,
                            counter=counter, count=0)
            _kernels.launch("mv_reduce", dev, self.part, w_b, b_cart, self.scal, self.rbar, self.hist,
                            self.fin, B, nb, n, dc, _MU, self.eps_cap, step, counter=counter,
                            count=int(step < 0))
            if step >= 0:
                _kernels.launch("mv_update", dev, self.M, w_b, b_cart, self.rbar, self.scal,
                                self.U, self.dW, B, nb, n, dc, counter=counter)


def mv_step(M0, nbr, w_b, b_cart, U, dW, eps, om_prev, eps0, design=None):
    """One MV step from the state (U, dW, eps, om_prev), returning the new
    (U, dW, eps, om).  Kernel 19 on a CUDA tensor (the run kernel with one
    step, or three block launches; ``design`` as :func:`_mv_kernel_run`'s),
    the plain version on a CPU tensor: the unit that the tests and the chip
    check hold against each other."""
    eps_cap = 20.0 * eps0
    if M0.device.type == "cpu":
        return _mv_step_plain(M0, nbr, w_b, b_cart, U, dW, torch.as_tensor(eps, dtype=config.FLOAT),
                              torch.as_tensor(om_prev, dtype=config.FLOAT), eps_cap)
    st = _MVState(M0, nbr, w_b, b_cart, 1, eps0, design)
    st.U.copy_(U)
    st.dW.copy_(dW)
    st.scal[0], st.scal[1] = float(eps), float(om_prev)
    st.run(1, "mv_step")
    return st.U, st.dW, st.scal[0], st.hist[0]


def _mv_kernel_run(M0, nbr, w_b, b_cart, steps, eps0, design=None, phases=_MV_PHASES):
    """Kernel 19's whole run on design ``design`` (:func:`_mv_design`'s
    choice if None): the steps, then the closing pair.  ``phases`` leaves a
    run kernel's phases out for timing.  Returns :func:`mv_localize`'s
    tuple."""
    st = _MVState(M0, nbr, w_b, b_cart, steps, eps0, design)
    if steps:
        st.run(steps, "mv_step", phases)
    st.run(0, "mv_final", phases)
    return st.U, st.hist[:steps], (st.rbar, st.fin[0], st.fin[1])


def mv_localize(M0, nbr, w_b, b_cart, steps, alpha):
    """Marzari-Vanderbilt spread minimization: ``steps`` heavy-ball
    gradient steps U(k) <- U(k) exp(dW), dW = mu dW_prev + eps G(k), with
    bold-driver step control (eps grows 1.1x while the spread falls,
    halves -- and the momentum resets -- on overshoot).

    ``M0`` (B, nb, n, n) complex, ``nbr`` (B, nb) int64, ``w_b`` (nb,),
    ``b_cart`` (nb, dc), all on one device.  Returns (U (B, n, n), the
    spread history (steps,), (rbar (dc, n), Omega_I, Omega_tilde)) as
    tensors.  Kernel 19 on the card (no host read inside the run); the
    plain loop on the CPU."""
    eps0 = float(alpha) / (4.0 * float(w_b.sum()))
    if M0.device.type == "cpu":
        return _mv_run_plain(M0, nbr, w_b, b_cart, steps, eps0)
    return _mv_kernel_run(M0, nbr, w_b, b_cart, steps, eps0)


def _smv_disentangle(S_full, nbr, w_b, win_mask, froz_mask, nw, steps, mixing, F0):
    """Souza-Marzari-Vanderbilt subspace selection (the JAX package's
    scan, as library calls): at every grid point the nw-dimensional
    subspace of the window bands maximizing sum_b w_b Tr[P(k) P(k+b)],
    frozen bands kept exactly through a deflated self-consistency matrix.
    Returns F (B, nsta, nw) isometries."""
    B, nb, ns, _ = S_full.shape
    BIG = 10.0 * (float(w_b.sum()) + 1.0)
    win = win_mask.to(S_full.dtype)
    froz = froz_mask.to(S_full.dtype)
    eye = torch.eye(ns, dtype=S_full.dtype, device=S_full.device)
    Qc = win[:, :, None] * win[:, None, :] * ((1.0 - froz)[:, :, None] * (1.0 - froz)[:, None, :])
    shift = BIG * (froz[:, :, None] * eye) - BIG * ((1.0 - win)[:, :, None] * eye)
    wc = w_b.to(S_full.dtype)
    F = F0
    Z = torch.zeros((B, ns, ns), dtype=S_full.dtype, device=S_full.device)
    for _ in range(steps):
        P = F @ _ct(F)
        Znew = torch.einsum("b,kbst,kbtu,kbvu->ksv", wc, S_full, P[nbr], S_full.conj())
        Z = mixing * Znew + (1.0 - mixing) * Z
        Z = (Z + _ct(Z)) / 2.0
        F = torch.linalg.eigh(Z * Qc + shift)[1][..., -nw:]
    return F


# -- builds ------------------------------------------------------------


def _grid_solve(data, nk, t_orb):
    """Coarse uniform grid (k = j / n), its energies and rephased states:
    (kpts (B, dim), evals (B, nsta), Convention-II states (B, nsta, nsta)
    with rows as states)."""
    kpts = device_uniform_grid(tuple(nk), np.zeros(len(nk)), data.device)
    evals, vecs = eigh_batched(assemble(data, kpts))
    ph = torch.polar(torch.ones((), dtype=config.FLOAT, device=data.device),
                     2.0 * math.pi * (kpts @ t_orb))
    return kpts, evals, vecs * ph[:, None, :]


def _polar_iso(A):
    U, s, Vh = torch.linalg.svd(A, full_matrices=False)
    return U @ Vh, s


def _project_gauge(u, g, auto_trial):
    """Lowdin-projected initial gauge of source states ``u`` (B, n_src,
    nsta): (V0, min sv)."""
    nw = u.shape[1]
    if auto_trial:
        Q = torch.einsum("bns,bnt->st", u, u.conj()) / u.shape[0]
        g = torch.linalg.eigh((Q + _ct(Q)) / 2)[1][:, -nw:].T
    V0, s = _polar_iso(torch.einsum("bns,ms->bnm", u.conj(), g))
    return V0, s.amin()


def _hr_from_B(Bk, nk, kpts):
    """Fourier coefficients H(R) of the (B, nw, nw) projected Hamiltonian
    over the centred R grid."""
    Rs = torch.as_tensor(_r_grid(nk), dtype=config.FLOAT, device=kpts.device)
    w = torch.polar(torch.ones((), dtype=config.FLOAT, device=kpts.device),
                    -2.0 * math.pi * (Rs @ kpts.T))
    return torch.einsum("rb,bml->rml", w, Bk) / Bk.shape[0]


def _finish_gauge(u, V, e_or_h, nk, kpts, diag_energies):
    """H(R) in the final gauge, and the re-projection quality (min sv of
    <u|g_wf> with g_wf the localized Wannier vectors)."""
    if diag_energies:
        Bk = torch.einsum("bnm,bn,bnl->bml", V.conj(), e_or_h.to(V.dtype), V)
    else:
        Bk = torch.einsum("bnm,bnl,blp->bmp", V.conj(), e_or_h, V)
    hr = _hr_from_B(Bk, nk, kpts)
    g_wf = torch.einsum("knm,kns->ms", V, u) / u.shape[0]
    s2 = torch.linalg.svdvals(torch.einsum("bns,ms->bnm", u.conj(), g_wf))
    return hr, s2.amin()


def _rotated_overlaps(u, V0, nbr):
    """The raw neighbour overlaps <u(k)|u(k+b)> of states ``u`` (B, n,
    nsta), rotated into the gauge V0: M0(k,b) = V0(k)^H S(k,b) V0(k+b),
    (B, nb, n, n) contiguous, the input of :func:`mv_localize`."""
    S = torch.einsum("kms,kbns->kbmn", u.conj(), u[nbr])
    return torch.einsum("kmi,kbmn,kbnj->kbij", V0.conj(), S, V0[nbr]).contiguous()


def _localize(u, V0, nbr, w_b, b_cart, mv_steps, alpha):
    """The MV run from the gauge V0 of states ``u``: (V, history, (rbar,
    Omega_I, Omega_tilde))."""
    U, hist, spreads = mv_localize(_rotated_overlaps(u, V0, nbr), nbr, w_b, b_cart, mv_steps, alpha)
    return V0 @ U, hist, spreads


def _shells_on(model, nk, device):
    b_int, b_cart, w_b = _bshells(model._lat, model._per, nk)
    nbr = np.ascontiguousarray(_neighbor_index(nk, b_int))
    as_t = lambda x, dt: torch.as_tensor(np.ascontiguousarray(x), dtype=dt).to(device)
    return as_t(nbr, torch.int64), as_t(w_b, config.FLOAT), as_t(b_cart, config.FLOAT)


def _build(data, nk, t_orb, g, occ, auto_trial):
    """One-shot projection: (hr, min proj sv, grid energies)."""
    kpts, evals, u = _grid_solve(data, nk, t_orb)
    e, u = evals[:, occ], u[:, occ, :]
    V, min_s = _project_gauge(u, g, auto_trial)
    Bk = torch.einsum("bnm,bn,bnl->bml", V.conj(), e.to(V.dtype), V)
    return _hr_from_B(Bk, nk, kpts), min_s, e


def _build_loc(data, nk, t_orb, g, occ, auto_trial, shells, mv_steps, alpha):
    """Isolated group with MV localization: (hr, min proj sv, e, history,
    rbar, Omega_I, Omega_tilde, final sv, real-space Wannier vectors wR)."""
    kpts, evals, u = _grid_solve(data, nk, t_orb)
    e, u = evals[:, occ], u[:, occ, :]
    V0, min_s = _project_gauge(u, g, auto_trial)
    V, hist, (rbar, oi, ot) = _localize(u, V0, *shells, mv_steps, alpha)
    hr, final_sv = _finish_gauge(u, V, e, nk, kpts, True)
    Rs = torch.as_tensor(_r_grid(nk), dtype=config.FLOAT, device=kpts.device)
    wph = torch.polar(torch.ones((), dtype=config.FLOAT, device=kpts.device),
                      2.0 * math.pi * (Rs @ kpts.T))
    wR = torch.einsum("rb,bnm,bns->rms", wph, V, u) / V.shape[0]
    return hr, min_s, e, hist, rbar, oi, ot, final_sv, wR


def _build_fine(data, nk, t_orb, wR, occ, nk_coarse, shells, mv_steps, alpha):
    """Multigrid refinement: re-solve on the fine grid, project onto the
    coarse run's real-space Wannier vectors, polish with a short MV run."""
    kpts, evals, u = _grid_solve(data, nk, t_orb)
    e, u = evals[:, occ], u[:, occ, :]
    Rs = torch.as_tensor(_r_grid(nk_coarse), dtype=config.FLOAT, device=kpts.device)
    tph = torch.polar(torch.ones((), dtype=config.FLOAT, device=kpts.device),
                      -2.0 * math.pi * (kpts @ Rs.T))
    G = torch.einsum("br,rms->bms", tph, wR)
    V0, s = _polar_iso(torch.einsum("bns,bms->bnm", u.conj(), G))
    V, hist, (rbar, oi, ot) = _localize(u, V0, *shells, mv_steps, alpha)
    hr, final_sv = _finish_gauge(u, V, e, nk, kpts, True)
    return hr, s.amin(), e, hist, rbar, oi, ot, final_sv


def _build_disent(data, nk, t_orb, g, nw, auto_trial, shells, windows, dis_steps, mixing,
                  mv_steps, alpha, has_frozen):
    """Entangled group: SMV subspace in the window, then project and
    localize: (hr, min proj sv, subspace energies, history, rbar, Omega_I,
    Omega_tilde, final sv, min window count, max frozen count)."""
    nbr, w_b, b_cart = shells
    kpts, evals, uall = _grid_solve(data, nk, t_orb)
    emin, emax, fmin, fmax = windows
    win = (evals >= emin) & (evals <= emax)
    froz = win & (evals >= fmin) & (evals <= fmax) if has_frozen else torch.zeros_like(win)
    S_full = torch.einsum("kms,kbns->kbmn", uall.conj(), uall[nbr])
    winf = win.to(uall.dtype)
    if auto_trial:
        Qw = torch.einsum("kns,kn,knt->st", uall, winf, uall.conj()) / uall.shape[0]
        g_seed = torch.linalg.eigh((Qw + _ct(Qw)) / 2)[1][:, -nw:].T
    else:
        g_seed = g
    F0 = _polar_iso(torch.einsum("kns,ms->knm", uall.conj(), g_seed) * winf[:, :, None])[0]
    F = _smv_disentangle(S_full, nbr, w_b, win, froz, nw, dis_steps, mixing, F0)
    usub = torch.einsum("knm,kns->kms", F, uall)
    Hsub = torch.einsum("knm,kn,knl->kml", F.conj(), evals.to(F.dtype), F)
    V0, min_s = _project_gauge(usub, g, auto_trial)
    V, hist, (rbar, oi, ot) = _localize(usub, V0, nbr, w_b, b_cart, mv_steps, alpha)
    hr, final_sv = _finish_gauge(usub, V, Hsub, nk, kpts, False)
    esub = torch.linalg.eigvalsh(Hsub)
    return (hr, min_s, esub, hist, rbar, oi, ot, final_sv,
            int(win.sum(dim=1).amin()), int(froz.sum(dim=1).amax()))


def _bands(hr, kpts, nk):
    """Interpolated energies (B, nw) at reduced k-points ``kpts``."""
    Rs = torch.as_tensor(_r_grid(nk), dtype=config.FLOAT, device=kpts.device)
    w = torch.polar(torch.ones((), dtype=config.FLOAT, device=kpts.device),
                    2.0 * math.pi * (kpts @ Rs.T))
    Hk = torch.einsum("br,rml->bml", w, hr)
    return eigvalsh_batched(((Hk + _ct(Hk)) / 2).contiguous())


def _to_np(t):
    return np.array(t.detach().cpu().numpy(), copy=True)


class WannierInterpolator(object):
    """Interpolate an isolated band group from a coarse BZ grid; see the
    module docstring.  Build with :func:`interpolator`."""

    def __init__(self, model, occ, nk, trial=None, localize=0,
                 localize_step=0.5, coarse_nk=None, polish=None):
        data = model._get_finalized()
        if data.dim_k < 1:
            raise PythtbError("Wannier interpolation requires a periodic model.")
        occ = [int(o) for o in occ]
        if len(occ) == 0:
            raise PythtbError("Need at least one band to interpolate.")
        if min(occ) < 0 or max(occ) >= data.nsta:
            raise IndexError(
                "occ indices %s out of range for %d states" % (occ, data.nsta)
            )
        nk = (nk,) * data.dim_k if np.isscalar(nk) else tuple(int(n) for n in nk)
        if len(nk) != data.dim_k:
            raise PythtbError("nk must give one grid size per periodic direction.")
        self._nk = nk
        self._dim_k = data.dim_k
        self._lat = np.array(model._lat, dtype=np.float64)
        self._per = list(model._per)
        nocc = len(occ)
        dev = data.device
        t = torch.as_tensor(self._t_orb(model), dtype=config.FLOAT).to(dev)
        occ_t = torch.as_tensor(occ, dtype=torch.int64, device=dev)

        if localize is True:
            localize = 200
        run_nk = nk
        if localize and coarse_nk is not None:
            run_nk = ((coarse_nk,) * data.dim_k
                      if np.isscalar(coarse_nk)
                      else tuple(int(n) for n in coarse_nk))
        auto = trial is None

        def build(g, auto):
            g = torch.as_tensor(g, dtype=config.COMPLEX).to(dev)
            if not localize:
                hr, min_s, e_grid = _build(data, nk, t, g, occ_t, auto)
                return hr, min_s, e_grid, (None,) * 5, min_s
            out = _build_loc(data, run_nk, t, g, occ_t, auto,
                             _shells_on(model, run_nk, dev), int(localize),
                             float(localize_step))
            hr, min_s, e_grid, hist, rbar, oi, ot, fsv, wR = out
            gate_sv = min_s  # the coarse projection sv decides trial health
            if run_nk != nk:
                # multigrid: the coarse run's real-space Wannier vectors
                # become (k-dependent) trials on the fine grid
                pol = polish
                if pol is None:
                    pol = max(100, int(localize) // 4)
                out = _build_fine(data, nk, t, wR, occ_t, run_nk,
                                  _shells_on(model, nk, dev), pol, float(localize_step))
                hr, min_s, e_grid, hist, rbar, oi, ot, fsv = out
            return hr, min_s, e_grid, (hist, rbar, oi, ot, fsv), gate_sv

        g = self._trial_array(trial, nocc, data.nsta)
        hr, min_s, e_grid, diag, gate_sv = build(g, auto)
        if auto and float(gate_sv) < 1e-2:
            # automatic fallback: the mean-projector trials degenerate when
            # the averaged projector is (near-)proportional to the identity;
            # greedily-chosen one-hot orbital anchors maximize the worst-k
            # conditioning
            u = _to_np(_grid_solve(data, run_nk, t)[2][:, occ_t, :])
            g2, sv2 = _greedy_anchor_trials(u, nocc)
            if sv2 > 2.0 * float(gate_sv):
                hr, min_s, e_grid, diag, _ = build(g2, False)
        self._set_diagnostics(min_s, *diag)
        self._hr = hr
        self._e_grid = e_grid  # (Nk, nw) on the device; see grid_energies
        self._warn_singular()

    # -- construction helpers -------------------------------------------

    @staticmethod
    def _t_orb(model):
        """Orbital positions along periodic directions, per state."""
        t = np.asarray(model._orb)[:, model._per].T  # (dim_k, norb)
        if model._nspin == 2:
            t = np.repeat(t, 2, axis=1)
        return np.ascontiguousarray(t)

    @staticmethod
    def _trial_array(trial, nw, nsta):
        if trial is None:
            # default trials are computed from the grid: the top
            # eigenvectors of the grid-averaged source-state projector
            return np.zeros((nw, nsta), dtype=complex)  # placeholder
        return np.asarray(trial, dtype=complex).reshape(nw, nsta)

    def _set_diagnostics(self, min_s, hist=None, rbar=None, oi=None,
                         ot=None, fsv=None):
        self.min_projection_sv = float(min_s)
        self.spread_history = None if hist is None else _to_np(hist).astype(np.float64)
        self.centers = None if rbar is None else _to_np(rbar).astype(np.float64).T
        self.omega_i = None if oi is None else float(oi)
        self.omega_tilde = None if ot is None else float(ot)
        self.final_projection_sv = None if fsv is None else float(fsv)

    def _warn_singular(self):
        if self.min_projection_sv < 1e-3:
            import warnings

            warnings.warn(
                "Wannier projection is near-singular (min singular value "
                "%.2e): the chosen band group is not smoothly Wannierizable "
                "with these trial vectors (topological obstruction, or a "
                "band touching) -- interpolated bands are unreliable."
                % self.min_projection_sv,
                UserWarning,
                stacklevel=4,
            )

    @property
    def grid_energies(self):
        """Exact band energies of the group at the coarse-grid k-points
        (flat (prod(nk), nocc) float array, row-major over the grid)."""
        return _to_np(self._e_grid).astype(np.float64)

    @property
    def hoppings(self):
        """Effective hoppings H(R) of the projected group: complex
        (NR, nw, nw) over the centered R grid (see :meth:`r_vectors`)."""
        return _to_np(self._hr)

    def r_vectors(self):
        """(NR, dim_k) integer lattice vectors matching :attr:`hoppings`."""
        return _r_grid(self._nk)

    def model(self, min_hopping_norm=1e-8, zero_energy=0.0):
        """Downfold to an effective :class:`~pythtb_tpu_torch.tb_model` whose
        orbitals are the Wannier functions and whose hoppings are the
        interpolated H(R) -- the native analog of importing a Wannier90
        ``_hr.dat`` (w90.model, PythTB pythtb.py:3448-3586), with no
        external tools.  The result is an ordinary model: cut it, apply
        Peierls fields, feed it to the surface/response machinery.

        Orbital positions are the Wannier centers (reduced coordinates)
        when the gauge was localized, else the cell origin; the model is
        flagged non-position-diagonal (like w90 imports) so
        position-operator methods warn unless overridden.

        :param min_hopping_norm: drop |H_R[i,j]| below this (the H(R)
          tail is truncation noise at the working grid)
        :param zero_energy: energy shift subtracted from the on-site
          terms
        :returns: a NEW tb_model with ``nw`` orbitals
        """
        from .model import tb_model

        hr = self.hoppings  # (NR, nw, nw) complex
        Rall = np.asarray(self.r_vectors())  # (NR, dim_k)
        nw = hr.shape[-1]
        lat = np.asarray(self._lat)
        dim_r = lat.shape[0]
        # embed the dim_k R-components into dim_r integer vectors
        Remb = np.zeros((Rall.shape[0], dim_r), dtype=int)
        Remb[:, list(self._per)] = Rall
        if self.centers is not None:
            orb_red = np.asarray(self.centers) @ np.linalg.inv(lat)
            orb_red = orb_red - np.floor(orb_red)  # home cell
        else:
            orb_red = np.zeros((nw, dim_r))
        m = tb_model(self._dim_k, dim_r, lat.tolist(), orb_red.tolist(),
                     per=list(self._per))
        iR0 = int(np.flatnonzero((Rall == 0).all(axis=1))[0])
        m.set_onsite(np.real(np.diagonal(hr[iR0])) - zero_energy)
        # Hermiticity pairs H(-R) = H(R)^dagger: keep one representative
        # per pair (first nonzero R-component positive; at R = 0 the
        # strict upper triangle), the w90 half-space convention.  The
        # centered R grid of an EVEN n spans [-n/2, n/2): its boundary
        # rows have NO -R partner and must be kept (either sign) at
        # HALF amplitude -- tb_model re-adds the h.c., reproducing
        # exactly the Hermitization `bands()` applies to H(k).
        iu, ju = np.triu_indices(nw, k=1)
        ia, ja = [x.reshape(-1) for x in np.meshgrid(
            np.arange(nw), np.arange(nw), indexing="ij")]
        rset = {tuple(R) for R in Rall}
        for r_idx in range(Rall.shape[0]):
            R = Rall[r_idx]
            nz = np.flatnonzero(R)
            paired = tuple(-R) in rset
            if len(nz) and paired and R[nz[0]] < 0:
                continue  # the -R partner carries this block
            scale = 1.0 if (len(nz) == 0 or paired) else 0.5
            ii, jj = (iu, ju) if len(nz) == 0 else (ia, ja)
            amp = hr[r_idx, ii, jj] * scale
            keep = np.abs(amp) >= min_hopping_norm
            if not keep.any():
                continue
            Rs = np.broadcast_to(Remb[r_idx], (int(keep.sum()), dim_r))
            m._append_scalar_hops(amp[keep], ii[keep], jj[keep], Rs)
        m._assume_position_operator_diagonal = False
        return m

    def bands(self, k_list):
        """Interpolated band energies of the group at arbitrary reduced
        k-points: (nw, nkp) in solve_all layout."""
        kpts = np.asarray(k_list, dtype=np.float64)
        if kpts.ndim == 1:
            kpts = kpts[:, None] if self._dim_k == 1 else kpts[None, :]
        if kpts.shape[1] != self._dim_k:
            raise PythtbError("k-vectors have wrong dimension.")
        k_t = torch.as_tensor(np.ascontiguousarray(kpts)).to(self._hr.device)
        return _to_np(_bands(self._hr, k_t, self._nk)).astype(np.float64).T


def interpolator(model, occ, nk=8, trial=None, localize=0,
                 localize_step=0.5, coarse_nk=None,
                 polish=None) -> WannierInterpolator:
    """Build a :class:`WannierInterpolator` for the band group ``occ``
    of ``model`` from an ``nk``-per-direction coarse grid.

    :param occ: band indices of an ISOLATED group (gapped from the rest
      everywhere; for spinful models include both Kramers partners)
    :param nk: coarse grid size per periodic direction (scalar or tuple)
    :param trial: optional (nocc, nsta) complex trial vectors; default =
      the top eigenvectors of the grid-averaged band projector (an
      automatic SCDM-like choice, computed from the coarse grid)
    :param localize: Marzari-Vanderbilt maximal-localization steps run
      after the one-shot projection (``True`` = 200).  The MV descent
      smooths kinks the one-shot gauge leaves when the trials have the
      wrong character somewhere in the BZ (the classic valence-only
      silicon failure), restoring exponential H(R) decay; inspect
      ``.spread_history`` / ``.omega_tilde`` / ``.final_projection_sv``.
    :param localize_step: initial MV step-size factor (halved
      automatically whenever the spread rises)
    :param coarse_nk: multigrid refinement: run the full localization on
      this (cheap) grid first, then re-solve on ``nk`` and project onto
      the coarse run's real-space Wannier vectors -- by Fourier
      inversion that projection is near-unitary, so the fine gauge
      starts smooth and only a short ``polish`` MV pass (or none) is
      needed.  This is how large ``nk`` stays affordable: e.g. silicon
      valence at nk=28 via coarse_nk=8 reaches sub-meV interpolation.
    :param polish: fine-grid MV steps after multigrid projection
      (default ``max(100, localize // 4)``; ``0`` = pure projection)
    :returns: interpolator with ``.bands(k_list)``, ``.hoppings``,
      ``.r_vectors()``, ``.min_projection_sv`` (+ with ``localize``:
      ``.spread_history``, ``.centers``, ``.omega_i``, ``.omega_tilde``,
      ``.final_projection_sv``)

    Example::

        itp = wannier.interpolator(models.bn(), [0], nk=10)
        ek = itp.bands(kpts)        # lower band anywhere, no re-solve
    """
    return WannierInterpolator(model, occ, nk, trial=trial,
                               localize=localize,
                               localize_step=localize_step,
                               coarse_nk=coarse_nk, polish=polish)


def disentangled_interpolator(model, nw, nk, window, frozen=None,
                              trial=None, dis_steps=80, mixing=0.7,
                              localize=200,
                              localize_step=0.5) -> WannierInterpolator:
    """Wannier interpolation of an ENTANGLED band group: select an
    optimally-smooth ``nw``-dimensional subspace inside the energy
    ``window`` by Souza-Marzari-Vanderbilt disentanglement (PRB 65,
    035109 (2001)), then project + maximally localize inside it.

    The subspace at each coarse-grid k maximizes the inter-k overlap
    functional (minimal gauge-invariant spread Omega_I), iterated to
    self-consistency as a fixed-length device scan; bands inside the
    ``frozen`` window are kept EXACTLY (they are reproduced by the
    interpolation wherever they fall inside it).  Replaces the
    reference's external-Wannier90 pipeline (pythtb.py:3448-3586) for
    metals and crossing band groups.

    :param nw: number of Wannier functions (subspace dimension); must
      not exceed the number of window bands at any grid point and must
      be >= the number of frozen bands everywhere
    :param window: (emin, emax) outer energy window
    :param frozen: optional (fmin, fmax) inner window kept exactly
    :param dis_steps: disentanglement self-consistency iterations
    :param mixing: Z-matrix mixing factor (0 < mixing <= 1)
    :param localize: MV maximal-localization steps after projection
    :returns: :class:`WannierInterpolator` (``.bands`` etc.); grid
      energies are the subspace eigenvalues
    """
    data = model._get_finalized()
    if data.dim_k < 1:
        raise PythtbError("Wannier interpolation requires a periodic model.")
    nw = int(nw)
    if nw < 1 or nw > data.nsta:
        raise PythtbError("nw must be in 1..%d" % data.nsta)
    nk = (nk,) * data.dim_k if np.isscalar(nk) else tuple(int(n) for n in nk)
    if len(nk) != data.dim_k:
        raise PythtbError("nk must give one grid size per periodic direction.")
    emin, emax = (float(window[0]), float(window[1]))
    if frozen is None:
        fmin, fmax = 0.0, -1.0
    else:
        fmin, fmax = float(frozen[0]), float(frozen[1])
        if fmin < emin or fmax > emax:
            raise PythtbError("frozen window must lie inside the outer window")

    if localize is True:
        localize = 200
    self = WannierInterpolator.__new__(WannierInterpolator)
    self._nk = nk
    self._dim_k = data.dim_k
    self._lat = np.array(model._lat, dtype=np.float64)
    self._per = list(model._per)
    dev = data.device
    t = torch.as_tensor(WannierInterpolator._t_orb(model), dtype=config.FLOAT).to(dev)
    g = torch.as_tensor(WannierInterpolator._trial_array(trial, nw, data.nsta),
                        dtype=config.COMPLEX).to(dev)
    (hr, min_s, e_grid, hist, rbar, oi, ot, fsv, nwin_min, nfroz_max) = _build_disent(
        data, nk, t, g, nw, trial is None, _shells_on(model, nk, dev),
        (emin, emax, fmin, fmax), int(dis_steps), float(mixing), int(localize),
        float(localize_step), frozen is not None,
    )
    # window feasibility, counted in the build
    if nwin_min < nw:
        raise PythtbError(
            "outer window holds only %d bands at some grid point; nw=%d "
            "needs at least nw window bands everywhere" % (nwin_min, nw)
        )
    if frozen is not None and nfroz_max > nw:
        raise PythtbError(
            "frozen window holds %d bands at some grid point; must "
            "not exceed nw=%d" % (nfroz_max, nw)
        )
    self._hr = hr
    self._e_grid = e_grid
    self._set_diagnostics(min_s, hist, rbar, oi, ot, fsv)
    self._warn_singular()
    return self
