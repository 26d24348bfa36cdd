"""Chebyshev recursions: kernels 9, 10, 11 and 11b.

Kernels 9-11 run T_{m+1} = 2 Ht T_m - T_{m-1} with Ht = (H - b) / a, the JAX
programs' ``(matvec(h, v) - ab[1] * v) / ab[0]``; ``ab`` is a (2,)
float64 tensor (a, b) on ``h``'s device.  Blocks of vectors are
(nsta, B), flat state index spin-fastest, as in :mod:`.matvec`.

* :func:`moments` -- kernel 9 in moments mode (``csrc/cheb_moments.cu``):
  the KPM moments mu (M, B) of ``flows._kpm_moments_jit`` and
  ``realspace._ldos_moments_jit``, two per matvec by the doubling
  identities.
* :func:`recursion` -- kernel 9 in recursion-only mode: slots 1..M-1 of
  a Chebyshev block from slot 0, written in place (the two recursions
  of ``realspace._kubo_moments_jit``).
* :func:`evolve` -- kernel 10 (``csrc/cheb_evolve.cu``): Chebyshev-Bessel
  time steps of ``dynamics._cheb_evolve_jit``, the state after each step.
* :func:`filter` -- kernel 11 (``csrc/cheb_filter.cu``): the real-
  coefficient Chebyshev filter of ``flows._window_round_jit``.
* :func:`dense_filter` -- kernel 11b (``csrc/dense_filter.cu``): the
  rescaled T_p filter of a dense sector Hamiltonian, ``ed._chebfilter_dev``
  (not on the ELL tables: the ED sector solver holds H dense).

Kernels 9 and 11 run a whole recursion in one cooperative launch
(``csrc/cheb_grid.cuh``: a grid barrier a step, each block a contiguous
range of rows with its tables in shared memory where they fit); the
launch counters count those launches, one a call.  Kernel 10 runs one
launch per term (``csrc/cheb_term.cuh``) from one C call and counts the
terms.  :func:`_grid_plan` mirrors the kernels' sizes, so the CPU tests
check the row partition and the placements.  CPU tensors run the plain
PyTorch versions (``_*_plain``), the JAX scan bodies written out; a CUDA
tensor launches the kernel or raises.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .. import config
from . import _kernels
from .matvec import SparseH, _check_tables, _matvec_plain

__all__ = ["phase_vectors", "moments", "recursion", "evolve", "filter", "dense_filter"]

# cheb_grid.cuh: the thread counts a block may take (the fewest whose
# blocks hold every row in one pass, else _GRID_MANY_PASSES: at 1,024 a
# thread has 64 registers and spills).  Kernel 9 stops at 512: 1,024 lost
# to 512 at every kernel-9 shape timed (PERF.md section 6), kernel 11's
# TBG filter is the one shape where it won.
_GRID_THREADS = {"filter": (256, 512, 1024), "moments": (256, 512), "recursion": (256, 512)}
_GRID_MANY_PASSES = 512
# dense_filter.cu, the cores design: rows of H a product block (kBR), H
# columns a staged tile (kTJ), rows an epilogue block (kEThreads); product
# blocks aimed at an SM
_DENSE_BR, _DENSE_TJ, _DENSE_EPI, _DENSE_BLOCKS_PER_SM = 128, 8, 256, 4
# the tensor design: rows of H a block (kTcRows), H columns a box (kTcK),
# boxes of H a stage (kTcKB), stages in the ring (kTcStages), the fewest
# stages a slice
_DENSE_TC_ROWS, _DENSE_TC_K, _DENSE_TC_KB, _DENSE_TC_STAGES, _DENSE_TC_MIN_STAGES = 128, 8, 4, 2, 4
# kernel 11b's designs: "cores" (CUDA-core tiles, four launches a step) and
# "tensor" (FP64 tensor cores fed by TMA, one launch a step); the tensor
# design from this many rows of H (PERF.md section 6: the cores design wins
# at the 6-ring's D 400 and 924, the tensor design from D 1,400)
_DENSE_DESIGNS = ("cores", "tensor")
_DENSE_TC_MIN_D = 1024


def phase_vectors(nsta: int, R: int, seed: int, device):
    """R random-phase vectors ``exp(1j * theta)`` as an (nsta, R) block on
    ``device``: ``theta = 2 pi * torch.rand((nsta, R), dtype=float64,
    generator=torch.Generator().manual_seed(seed))``, drawn on the host,
    so the CPU and the card see the same vectors.  (JAX's threefry draws
    of the JAX package are other numbers.)"""
    gen = torch.Generator().manual_seed(int(seed))
    theta = torch.rand((int(nsta), int(R)), dtype=config.FLOAT, generator=gen) * (2.0 * math.pi)
    return torch.polar(torch.ones_like(theta), theta).to(device)


class GridPlan(NamedTuple):
    """A cooperative launch of kernel 9 or 11: ``blocks`` blocks of
    ``threads``; the tables and kernel 11's on-chip state (acc and T_{m-1};
    "none" for kernel 9) in "shared" or "device" memory; ``smem`` bytes of
    dynamic shared memory a block."""

    blocks: int
    threads: int
    tables: str
    state: str
    smem: int


def _grid_shape(norb: int, nspin: int, B: int, sms: int, kind: str):
    """(G, T): the fewest threads T of ``_GRID_THREADS[kind]`` whose blocks
    (bx = min(B, T) columns by T // bx row lanes, whole orbitals a block)
    hold every row in one pass on at most ``sms`` blocks, else
    ``_GRID_MANY_PASSES``; G the fewest blocks of T that hold the rows in
    one pass, at most one an SM."""
    for T in _GRID_THREADS[kind]:
        per_pass = max(1, T // min(B, T) // nspin)
        G = -(-norb // per_pass)
        if G <= sms:
            return max(1, G), T
    return sms, _GRID_MANY_PASSES


def _grid_rows(norb: int, nspin: int, G: int):
    """Each block's state rows [r0, r1): block g owns the orbitals
    [g norb // G, (g + 1) norb // G) (cheb_grid.cuh:grid_orbital)."""
    return [(g * norb // G * nspin, (g + 1) * norb // G * nspin) for g in range(G)]


def _grid_tables_bytes(orbs: int, D: int, nspin: int) -> int:
    """A block's cols (rounded to 16 bytes) and vals for ``orbs`` orbitals."""
    return -(-orbs * D * 4 // 16) * 16 + orbs * D * nspin * nspin * 16


def _grid_plan(norb: int, nspin: int, B: int, D: int, sms: int, smem: int, kind: str) -> GridPlan:
    """The launch of kernel 9 (``kind`` "moments" or "recursion") or 11
    ("filter") on a card of ``sms`` SMs whose blocks may take ``smem``
    bytes of shared memory (its opt-in limit; the moments kernel keeps 16
    bytes a thread of its own for its block sums).  The tables go to shared
    memory where a block's rows fit beside the state, else they are read
    from device memory; kernel 11's state (2 x rows x B complex) stays in
    shared memory where it fits alone, else in device memory."""
    G, T = _grid_shape(norb, nspin, B, sms, kind)
    orbs = -(-norb // G)
    tables = _grid_tables_bytes(orbs, D, nspin)
    state = kind == "filter"
    st = 2 * orbs * nspin * B * 16 if state else 0
    room = smem - (16 * T if kind == "moments" else 0)
    if tables + st <= room:
        return GridPlan(G, T, "shared", "shared" if state else "none", tables + st)
    if state and st <= room:
        return GridPlan(G, T, "device", "shared", st)
    return GridPlan(G, T, "device", "device" if state else "none", 0)


def _scaled(h: SparseH, ab, v):
    """(H v - b v) / a for a (nsta, B) block, plain PyTorch."""
    B = v.shape[-1]
    shape = (h.norb, 2, B) if h.nspin == 2 else (h.norb, B)
    return (_matvec_plain(h, v.reshape(shape)).reshape(h.nsta, B) - ab[1] * v) / ab[0]


def _check(h: SparseH, ab, x, name):
    D = _check_tables(h)
    _kernels.require(ab, "ab", config.FLOAT, (2,), h.device)
    _kernels.require(x, name, config.COMPLEX, (h.nsta, x.shape[-1]), h.device)
    return D


# -- kernel 9, moments mode ----------------------------------------------


def _moments_plain(h: SparseH, ab, x0, M, mu0):
    """The JAX moment scan in torch: mu_0 = mu0, mu_1 = <x0|T_1>,
    mu_2m = 2<T_m|T_m> - mu_0, mu_2m+1 = 2<T_m+1|T_m> - mu_1."""
    B = x0.shape[1]
    mu = torch.empty((M, B), dtype=config.FLOAT, device=x0.device)
    mu[0] = mu0
    if M < 2:
        return mu
    tm, tc = x0, _scaled(h, ab, x0)
    mu[1] = torch.sum(torch.real(torch.conj(tm) * tc), dim=0)
    for m in range(1, (M - 1) // 2 + 1):
        tn = 2.0 * _scaled(h, ab, tc) - tm
        mu[2 * m] = 2.0 * torch.sum(torch.real(torch.conj(tc) * tc), dim=0) - mu[0]
        if 2 * m + 1 < M:
            mu[2 * m + 1] = 2.0 * torch.sum(torch.real(torch.conj(tn) * tc), dim=0) - mu[1]
        tm, tc = tc, tn
    return mu


def moments(h: SparseH, ab, x0, M: int, mu0: float):
    """Chebyshev moments ``mu[m, b] = <x0_b| T_m(Ht) |x0_b>`` (real part)
    for m < M, with ``mu[0]`` set to ``mu0`` as the JAX programs set it
    (N for random-phase vectors, 1 for unit vectors).

    :param x0: (nsta, B) complex start vectors on ``h``'s device
    :returns: (M, B) float64
    """
    return _moments(h, ab, x0, M, mu0, None)


def _moments(h: SparseH, ab, x0, M, mu0, smem):
    """:func:`moments` with the plan's shared memory ``smem`` (None: the
    card's opt-in limit)."""
    M = int(M)
    if x0.device.type == "cpu":
        return _moments_plain(h, ab, x0, M, mu0)
    D = _check(h, ab, x0, "x0")
    B = x0.shape[1]
    sms, optin = _kernels.card(h.device)
    plan = _grid_plan(h.norb, h.nspin, B, D, sms, optin if smem is None else smem, "moments")
    work = torch.empty((2, h.nsta, B), dtype=config.COMPLEX, device=h.device)
    work[0].copy_(x0)
    part = torch.empty((2, 2, plan.blocks, B), dtype=config.FLOAT, device=h.device)
    mu = torch.empty((M, B), dtype=config.FLOAT, device=h.device)
    mu[0] = mu0
    _kernels.launch("cheb_moments", h.device, h.cols, h.vals, ab, work, part, mu, h.norb, D, h.nspin, B, M,
                    plan.blocks, plan.threads, int(plan.tables == "shared"), count=int(M >= 2 and h.nsta * B > 0))
    return mu


# -- kernel 9, recursion-only mode -----------------------------------------


def _recursion_plain(h: SparseH, ab, block):
    """Slots 1.. of ``block`` (count, nsta, B) from slot 0, in place."""
    for k in range(1, block.shape[0]):
        t = _scaled(h, ab, block[k - 1])
        block[k] = t if k == 1 else 2.0 * t - block[k - 2]
    return block


def recursion(h: SparseH, ab, block):
    """Fill a Chebyshev block in place: ``block[k] = T_k(Ht) block[0]``
    for k >= 1.  ``block`` is (count, nsta, B) complex, or any view of
    that shape whose (nsta, B) rows are contiguous and share one row
    stride (e.g. ``buf.permute(1, 0, 2)`` of an (nsta, count, B) buffer,
    so that a later kernel-8 launch reads all slots as one block).

    :returns: ``block``
    """
    return _recursion(h, ab, block, None)


def _recursion(h: SparseH, ab, block, smem):
    """:func:`recursion` with the plan's shared memory ``smem`` (None: the
    card's opt-in limit)."""
    if block.device.type == "cpu":
        return _recursion_plain(h, ab, block)
    D = _check_tables(h)
    _kernels.require(ab, "ab", config.FLOAT, (2,), h.device)
    count, nsta, B = block.shape
    if block.dtype != config.COMPLEX or block.device != h.device or nsta != h.nsta:
        raise ValueError("block must be complex128 (count, %d, B) on %s, got %s %s on %s"
                         % (h.nsta, h.device, block.dtype, tuple(block.shape), block.device))
    if block.stride(2) != 1 or block.stride(1) < B:
        raise ValueError("block rows must be contiguous, got strides %s" % (block.stride(),))
    sms, optin = _kernels.card(h.device)
    plan = _grid_plan(h.norb, h.nspin, B, D, sms, optin if smem is None else smem, "recursion")
    _kernels.launch("cheb_recursion", h.device, h.cols, h.vals, ab, block, h.norb, D, h.nspin, B,
                    block.stride(1), block.stride(0), count, plan.blocks, plan.threads, int(plan.tables == "shared"),
                    counter="cheb_moments", count=int(count >= 2 and nsta * B > 0))
    return block


# -- kernel 10 -------------------------------------------------------------


def _evolve_plain(h: SparseH, ab, coef, psi0, nsteps):
    """The JAX scan body in torch: per step, acc = c_0 T_0 + c_1 T_1 +
    sum_n c_n T_n with T_0 the current state; the state after each step."""
    out = torch.empty((nsteps,) + tuple(psi0.shape), dtype=config.COMPLEX, device=psi0.device)
    psi = psi0
    for s in range(nsteps):
        tm, tc = psi, _scaled(h, ab, psi)
        acc = coef[0] * tm + coef[1] * tc
        for c in coef[2:]:
            tn = 2.0 * _scaled(h, ab, tc) - tm
            acc = acc + c * tn
            tm, tc = tc, tn
        out[s] = acc
        psi = acc
    return out


def evolve(h: SparseH, ab, coef, psi0, nsteps: int):
    """``nsteps`` Chebyshev steps ``psi <- sum_n coef[n] T_n(Ht) psi``.

    :param coef: (M,) complex128 step coefficients on ``h``'s device,
      M >= 2
    :param psi0: (nsta, B) complex128 start block
    :returns: (nsteps, nsta, B), the state after every step
    """
    nsteps = int(nsteps)
    if psi0.device.type == "cpu":
        return _evolve_plain(h, ab, coef, psi0, nsteps)
    D = _check(h, ab, psi0, "psi0")
    M = coef.shape[0]
    if M < 2:
        raise ValueError("evolve needs at least 2 coefficients, got %d" % M)
    _kernels.require(coef, "coef", config.COMPLEX, (M,), h.device)
    B = psi0.shape[1]
    work = torch.empty((2, h.nsta, B), dtype=config.COMPLEX, device=h.device)
    hist = torch.empty((nsteps, h.nsta, B), dtype=config.COMPLEX, device=h.device)
    _kernels.launch("cheb_evolve", h.device, h.cols, h.vals, ab, coef, psi0, work, hist,
                    h.norb, D, h.nspin, B, M, nsteps, count=nsteps * (M - 1))
    return hist


# -- kernel 11 -------------------------------------------------------------


def _filter_plain(h: SparseH, ab, coef, X):
    """The JAX filter scan in torch: acc = c_0 T_0 + c_1 T_1, then
    T_{m+1} = 2 Ht T_m - T_{m-1} and acc += c_{m+1} T_{m+1}."""
    tm, tc = X, _scaled(h, ab, X)
    acc = coef[0] * tm + coef[1] * tc
    for c in coef[2:]:
        tn = 2.0 * _scaled(h, ab, tc) - tm
        acc = acc + c * tn
        tm, tc = tc, tn
    return acc


def filter(h: SparseH, ab, coef, X):  # noqa: A001  (the JAX program's name)
    """Chebyshev filter ``Y = sum_m coef[m] T_m(Ht) X`` with real
    coefficients (a Gaussian spectral window of the spectrum-slice solver).

    :param coef: (M,) float64 on ``h``'s device, M >= 2 (any degree; it
      changes between rounds)
    :param X: (nsta, B) complex128 block, not written
    :returns: (nsta, B) complex128
    """
    return _filter(h, ab, coef, X, None)


def _filter(h: SparseH, ab, coef, X, smem):
    """:func:`filter` with the plan's shared memory ``smem`` (None: the
    card's opt-in limit)."""
    M = coef.shape[0]
    if M < 2:
        raise ValueError("filter needs at least 2 coefficients, got %d" % M)
    if X.device.type == "cpu":
        return _filter_plain(h, ab, coef, X)
    D = _check(h, ab, X, "X")
    _kernels.require(coef, "coef", config.FLOAT, (M,), h.device)
    B = X.shape[1]
    sms, optin = _kernels.card(h.device)
    plan = _grid_plan(h.norb, h.nspin, B, D, sms, optin if smem is None else smem, "filter")
    work = torch.empty((2, h.nsta, B), dtype=config.COMPLEX, device=h.device)
    state = torch.empty_like(work) if plan.state == "device" else None
    Y = torch.empty((h.nsta, B), dtype=config.COMPLEX, device=h.device)
    _kernels.launch("cheb_filter", h.device, h.cols, h.vals, ab, coef, X, work, state, Y, h.norb, D, h.nspin, B,
                    M, plan.blocks, plan.threads, int(plan.tables == "shared"), int(plan.state == "shared"),
                    count=int(h.nsta * B > 0))
    return Y


# -- kernel 11b ------------------------------------------------------------


def _dense_filter_plain(H, X, p, c, hw):
    """The JAX filter scan of ``ed._chebfilter_dev`` in torch: T_1 X =
    (H X - c X) / hw, then p - 1 steps of n = 2 (H b - c b) / hw - a with
    both carries divided by s = max(max_rows |n|, 1) per column; the last
    b (T_1 X for p <= 1).  The oracle of kernel 11b."""

    def hx(v):
        return (H @ v - c * v) / hw

    a, b = X, hx(X)
    for _ in range(max(int(p) - 1, 0)):
        n = 2.0 * hx(b) - a
        s = torch.clamp(n.abs().amax(dim=0), min=1.0)
        a = torch.view_as_complex(torch.view_as_real(b) / s[:, None])
        b = torch.view_as_complex(torch.view_as_real(n) / s[:, None])
    return b


def dense_filter(H, X, p: int, c: float, hw: float):
    """Chebyshev filter ``T_p((H - c) / hw) X`` of a dense Hermitian ``H``
    with the JAX program's joint per-column rescaling each step (a common
    scalar per column: the spanned subspace is unchanged).

    :param H: (D, D) complex128
    :param X: (D, nb) complex128 block, not written
    :param p: degree (p <= 1 gives T_1 X, as the JAX scan of length
      max(p - 1, 0) does)
    :returns: (D, nb) complex128
    """
    return _dense_filter(H, X, p, c, hw, None)


def _dense_design(D: int, nb: int) -> str:
    """Kernel 11b's design for a (D, D) H and nb columns: the tensor cores
    from ``_DENSE_TC_MIN_D`` rows, where H's stream leads, the CUDA cores
    below, where the tensor design's few row tiles leave SMs idle."""
    return "tensor" if D >= _DENSE_TC_MIN_D else "cores"


def _dense_filter(H, X, p, c, hw, design):
    """:func:`dense_filter` on kernel 11b's ``design`` (one of
    ``_DENSE_DESIGNS``; :func:`_dense_design`'s choice if None).  On the
    card the tensor design takes (S + 4) D nb complex of scratch, S the
    slices of :func:`_dense_tc_slices`."""
    if design is not None and design not in _DENSE_DESIGNS:
        raise ValueError("kernel 11b has no %r design; it has %s" % (design, ", ".join(_DENSE_DESIGNS)))
    if X.device.type == "cpu":
        return _dense_filter_plain(H, X, p, float(c), float(hw))
    D, nb = X.shape
    dev = X.device
    _kernels.require(H, "H", config.COMPLEX, (D, D), dev)
    _kernels.require(X, "X", config.COMPLEX, (D, nb), dev)
    design = _dense_design(D, nb) if design is None else design
    props = torch.cuda.get_device_properties(dev)
    sms = props.multi_processor_count
    steps = max(int(p), 1)
    out = torch.empty((D, nb), dtype=config.COMPLEX, device=dev)
    if design == "cores":
        S, jlen = _dense_slices(D, nb, sms)
        A = torch.empty((D, nb), dtype=config.COMPLEX, device=dev)
        part = torch.empty((S, D, nb), dtype=config.COMPLEX, device=dev)
        partial = torch.empty((max(-(-D // _DENSE_EPI), 1), nb), dtype=config.FLOAT, device=dev)
        scale = torch.empty((nb,), dtype=config.FLOAT, device=dev)
        _kernels.launch("dense_filter", dev, H, X, A, out, part, partial, scale, D, nb, steps, S, jlen, float(c),
                        float(hw), count=steps)
        return out
    S, jlen = _dense_tc_slices(D, nb, sms, props.shared_memory_per_block_optin)
    nrt = -(-D // _DENSE_TC_ROWS)
    work = torch.empty((4, D, nb), dtype=config.COMPLEX, device=dev)
    part = torch.empty((S, D, nb), dtype=config.COMPLEX, device=dev)
    partial = torch.empty((2, nrt, nb), dtype=config.FLOAT, device=dev)
    counters = torch.zeros((nrt * -(-nb // _dense_tc_columns(nb)),), dtype=torch.int32, device=dev)
    _kernels.launch("dense_filter_tc", dev, H, X, work, out, part, partial, counters, D, nb, steps, S, jlen,
                    float(c), float(hw), counter="dense_filter", count=steps)
    return out


def _dense_slices(D: int, nb: int, sms: int):
    """(S, jlen): kernel 11b's cores design splits the H columns into S
    slices of jlen (a multiple of the staged tile) so that some four blocks
    an SM are in flight; the epilogue adds the S partial products in order."""
    nc = 4 if nb <= 4 else 8 if nb <= 8 else 12 if nb <= 12 else 16
    blocks = -(-D // _DENSE_BR) * -(-nb // nc)
    S = max(1, min(-(-_DENSE_BLOCKS_PER_SM * sms // blocks), -(-D // _DENSE_TJ)))
    jlen = -(-(-(-D // S)) // _DENSE_TJ) * _DENSE_TJ
    return -(-D // jlen), jlen


def _dense_tc_columns(nb: int) -> int:
    """Columns of X a block of kernel 11b's tensor design takes: 8, 16 or 32."""
    return 8 if nb <= 8 else 16 if nb <= 16 else 32


def _dense_tc_fit(nb: int, smem: int) -> int:
    """Blocks of the tensor design an SM holds at once, by their shared
    memory (the ring's stages of boxes of H and b, 1 kB of alignment, ~2 kB
    of the block's own) against ``smem``, the shared memory a block may
    take (the device's opt-in limit): 1 on the H100's 227 kB (145 kB a
    block at nb 10)."""
    stage = _DENSE_TC_KB * (16384 + 1024 * (_dense_tc_columns(nb) // 8))
    return max(1, smem // (_DENSE_TC_STAGES * stage + 1024 + 2048))


def _dense_tc_slices(D: int, nb: int, sms: int, smem: int):
    """(S, jlen): the tensor design splits the H columns into S slices of
    jlen (a multiple of a stage's 32 columns, at least 4 stages) so that
    the blocks fit on the ``sms`` SMs at once (no second wave); the last
    block of a row tile to finish adds the S partial products in order."""
    blocks = -(-D // _DENSE_TC_ROWS) * -(-nb // _dense_tc_columns(nb))
    step = _DENSE_TC_K * _DENSE_TC_KB
    S = max(1, min(_dense_tc_fit(nb, smem) * sms // blocks, D // (step * _DENSE_TC_MIN_STAGES)))
    jlen = -(-(-(-D // S)) // step) * step
    return -(-D // jlen), jlen
