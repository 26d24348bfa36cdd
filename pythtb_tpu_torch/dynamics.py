"""Real-time quantum dynamics: Chebyshev propagation and quench echoes
(counterpart of ``pythtb_tpu.dynamics``).

* :func:`evolve` -- ``psi(t) = e^{-i H t} psi(0)`` for FINITE models,
  matrix-free: the Chebyshev expansion of the propagator (Tal-Ezer &
  Kosloff, J. Chem. Phys. 81, 3967 (1984)),

      e^{-i H dt} = sum_n c_n T_n(Ht),   c_n = (2 - d_n0) (-i)^n
                    e^{-i b dt} J_n(a dt),

  with ``Ht = (H - b)/a`` the Gershgorin-rescaled Hamiltonian and J_n
  Bessel functions (host scipy, float64).  Every step is ``M`` ELL
  matvecs; all steps run as one call of kernel 10
  (:func:`pythtb_tpu_torch.ops.chebyshev.evolve`).

* :func:`quench_echo` -- the Loschmidt rate function of a sudden quench
  between two periodic models (Heyl, Polkovnikov & Kehrein, PRL 110,
  135704 (2013)): ``g(t) = -(1/(N_k n_occ)) ln prod_k |det M_k(t)|^2``
  with ``M_k(t)_mn = <u^i_m(k)| e^{-i H_f(k) t} |u^i_n(k)>``.  It runs on
  kernel 1 (assembly) and ``eigh_batched`` (kernel 2 at two bands).
"""

from __future__ import annotations

import numpy as np
import torch

from . import config
from .model import PythtbError

__all__ = ["evolve", "quench_echo"]


def _cheb_order(a, dt):
    """Bessel tail: J_n(x) decays superexponentially for n > x, but the
    turning-point width grows like x^(1/3); x + 12 x^(1/3) + 40 holds
    double-precision round-off at any step length."""
    x = abs(a * dt)
    return int(np.ceil(x + 12.0 * x ** (1.0 / 3.0))) + 40


def _cheb_evolve(h, ab, coef, psi0, nsteps, seed_coef=None):
    """The state block after each of ``nsteps`` steps of ``coef`` (the
    JAX ``_cheb_evolve_jit``); with ``seed_coef`` one step of those
    coefficients runs first (``_cheb_evolve_seeded_jit``).  Kernel 10 on
    the card, its plain version on the CPU."""
    from .ops import chebyshev

    start = psi0 if seed_coef is None else chebyshev.evolve(h, ab, seed_coef, psi0, 1)[0]
    return chebyshev.evolve(h, ab, coef, start, nsteps)


def evolve(model, psi0, times, order=None):
    """Propagate states of a FINITE model: ``psi(t_s) = e^{-i H t_s}
    psi0`` at uniformly spaced times.

    :param model: finite (dim_k == 0) tb_model, or a
      :class:`pythtb_tpu_torch.realspace.TorusSample`
    :param psi0: (nsta,) or (nsta, B) complex initial states (flat
      spin-fastest layout for spinful models)
    :param times: 1-D array of UNIFORMLY spaced times (any start,
      including 0); the step is ``times[1] - times[0]`` and an initial
      fractional step seeds the series at ``times[0]``
    :param order: Chebyshev order per step (default: Bessel-safe
      ``a dt + 12 (a dt)^(1/3) + 40``)
    :returns: (ntimes, nsta) or (ntimes, nsta, B) complex array
    """
    from scipy.special import jv

    from .ops.matvec import gershgorin_window, sparse_h
    from .realspace import TorusSample

    h = sparse_h(model) if not isinstance(model, TorusSample) else model.h
    times = np.asarray(times, dtype=np.float64)
    if times.ndim != 1 or len(times) < 1:
        raise PythtbError("times must be a nonempty 1-D array")
    if len(times) > 1:
        dt = float(times[1] - times[0])
        if dt <= 0 or np.abs(np.diff(times) - dt).max() > 1e-9 * abs(dt):
            raise PythtbError("times must be uniformly spaced and increasing")
    else:
        dt = float(times[0])
        if dt == 0.0:
            raise PythtbError("a single requested time must be nonzero")
    seed_dt = float(times[0]) - dt  # fractional step to reach times[0]
    psi0 = np.asarray(psi0, dtype=np.complex128)
    squeeze = psi0.ndim == 1
    if squeeze:
        psi0 = psi0[:, None]
    if psi0.shape[0] != h.nsta:
        raise PythtbError("psi0 must have %d components" % h.nsta)
    B = psi0.shape[1]
    lo, hi = gershgorin_window(h)
    a = 0.5 * (hi - lo) + 1e-12  # no 0.98 margin here, as in pythtb_tpu
    b = 0.5 * (hi + lo)
    M = _cheb_order(a, dt) if order is None else int(order)
    if M < 2:
        raise PythtbError("order must be >= 2 (got %d)" % M)
    # the seed step can be much longer than dt; it gets its own
    # Bessel-safe order
    M_seed = _cheb_order(a, seed_dt)

    def coef(step, order_):
        nn = np.arange(order_)
        c = (2.0 - (nn == 0)) * (-1.0j) ** nn * jv(nn, a * step) * np.exp(-1.0j * b * step)
        return torch.as_tensor(c, dtype=config.COMPLEX).to(h.device)

    ab = torch.tensor([a, b], dtype=config.FLOAT, device=h.device)
    start = torch.as_tensor(np.ascontiguousarray(psi0), dtype=config.COMPLEX).to(h.device)
    seeded = abs(seed_dt) > 1e-12 * max(abs(dt), 1.0)
    hist = _cheb_evolve(h, ab, coef(dt, M), start, len(times),
                        coef(seed_dt, M_seed) if seeded else None)
    psi_t = hist.cpu().numpy().reshape(len(times), h.nsta, B)
    return psi_t[:, :, 0] if squeeze else psi_t


def _init_states(data, occ, nk):
    """Occupied eigenstates on the grid, (nkpt, nocc, nsta)."""
    from .ops.eigh import eigh_batched
    from .ops.hamiltonian import assemble
    from .ops.solver import device_uniform_grid

    kpts = device_uniform_grid(nk, np.zeros(data.dim_k), data.device)
    _, v = eigh_batched(assemble(data, kpts))
    return v[:, list(occ), :]


def _echo(data_f, u0, nk, times):
    """ln L(t) for the whole time batch: eigendecompose H_f on the grid
    once, then det M_k(t) = det(A e^{-i e_f t} A^H) for every time."""
    from .ops.berry import _dets
    from .ops.eigh import eigh_batched
    from .ops.hamiltonian import assemble
    from .ops.solver import device_uniform_grid

    kpts = device_uniform_grid(nk, np.zeros(data_f.dim_k), data_f.device)
    ef, vf = eigh_batched(assemble(data_f, kpts))  # rows are states
    # A[k, m, j] = <u0_m | f_j>: the initial states in the final eigenbasis
    A = torch.einsum("bms,bjs->bmj", u0.conj(), vf)
    t = torch.as_tensor(times, dtype=config.FLOAT).to(data_f.device)
    ph = torch.polar(torch.ones_like(ef)[None], -ef[None] * t[:, None, None])  # (nt, B, nsta)
    Mt = torch.einsum("bmj,tbj,bnj->tbmn", A, ph, A.conj())
    if Mt.shape[-1] <= 2:
        # closed forms: torch.linalg.slogdet on the card factors a batch of
        # tiny matrices one by one (22 s for 160,000 1 x 1 on an H100)
        logdet = torch.log(_dets(Mt).abs())
    else:
        logdet = torch.linalg.slogdet(Mt)[1]
    return 2.0 * logdet.sum(dim=1)


def quench_echo(model_i, model_f, occ, nk, times):
    """Loschmidt rate function of a sudden quench.

    Prepare the filled ``occ`` bands of ``model_i`` at every point of an
    ``nk`` grid, evolve each Slater determinant with ``model_f``, and
    return ``g(t) = -(1/(N_k n_occ)) ln prod_k |det M_k(t)|^2``.

    :param model_i: initial model (ground state source)
    :param model_f: final model (generator of the evolution); must share
      the initial model's state space and periodicity
    :param occ: occupied band indices
    :param nk: grid sizes, one per periodic direction
    :param times: (nt,) times
    :returns: (nt,) float rate function g(t)
    """
    di = model_i._get_finalized()
    df = model_f._get_finalized()
    if di.dim_k == 0:
        raise PythtbError("quench_echo needs a periodic model (use evolve() for finite samples)")
    if (di.nsta, di.dim_k) != (df.nsta, df.dim_k):
        raise PythtbError("model_i and model_f must share the state space and periodic dimensions")
    if np.abs(np.asarray(model_i._orb) - np.asarray(model_f._orb)).max() > 1e-12:
        raise PythtbError("model_i and model_f must share orbital positions (same cell geometry)")
    occ = tuple(int(o) for o in np.atleast_1d(occ))
    if len(occ) == 0 or len(set(occ)) != len(occ) or min(occ) < 0 or max(occ) >= di.nsta:
        raise PythtbError("occ must be distinct band indices in [0, %d)" % di.nsta)
    nk = tuple(int(x) for x in np.atleast_1d(nk))
    if len(nk) != di.dim_k or min(nk) < 2:
        raise PythtbError("nk must give %d sizes >= 2" % di.dim_k)
    times = np.asarray(times, dtype=np.float64)
    lnL = _echo(df, _init_states(di, occ, nk), nk, times).cpu().numpy()
    N = int(np.prod(nk)) * len(occ)
    return -np.asarray(lnL, dtype=np.float64) / N
