#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (pythtb_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:

1. environment: needs torch.cuda.is_available(); prints the card's name
   and power limit (nvidia-smi), torch and CUDA versions;
2. build: compiles every CUDA source under pythtb_tpu_torch/csrc/ with
   nvcc (sm_90a, one nvcc per source, all started together) into build/pythtb_tpu_torch/ and prints
   the build seconds and ptxas usage;
3. each kernel against its plain PyTorch version on the card, at the
   main path's shapes: max |diff| (tolerance 1e-12, float64), the median
   time of each over 25 runs (CUDA events), the time of the one PyTorch
   call that computes the same function where there is one, and the
   least time the card could take for the work (bytes over 3.35 TB/s or
   float64 operations over 34 TFLOP/s, 67 TFLOP/s for kernel 6's matrix
   product on the tensor cores, whichever is larger); kernel 5 on both
   of its designs (a warp or a block a link) and kernel 6 on both of its
   own (a thread an element, tiles on the FP64 tensor cores) at the
   shapes that place their dispatch lines; single steps of kernels 9 and
   10 are held at 1e-12, their whole recursions at 1e-10 relative (sums
   of N terms in another order), kernel 11's
   Gaussian filters (the magic-angle moire cell's tables, degree 512 and
   6,144, and a spinful table) at 1e-10 relative, kernel 12's decimation
   (the Fermi-arc map and a spinful ribbon) and kernel 1's one-sided mode
   at 1e-12; kernel 15 (dH/dk, d2H/dk dk) on every grid of the fifth
   slice's rows at 1e-12, kernels 16 (spectral sums) and 17 (Fermi sweeps,
   every weight kind) on the inputs those rows build at 1e-10 relative;
   the sixth slice's kernels: kernel 12's Green's-function mode at the
   Hall-bar leads and the graphene ribbon (1e-12 at eta 0.02; 1e-9 at the
   main path's eta 1e-6, where the plain version alone parts that far
   between the card and the CPU), kernel 13 (the CPA's
   local Green's function) at the CPA row, one iteration at 1e-12 and the
   whole fixed point at 1e-10 relative, kernel 18 (Lyapunov transfer
   products) at 512 energies x 2,048 steps of the row's disordered strip
   (1e-10 relative at stride 1; the non-negative half at 1e-8 at the row's
   stride 8, where two correct QRs part at ~1e-9), kernel 16 at the impurity T-matrix's shape and kernel
   1 at the leads' and the strip's principal layers; the seventh slice's
   kernel 7 (batched Jacobi eigensolver) against its plain version and
   torch.linalg.eigh at m 33-64, the slab's and the Hofstadter row's
   matrices (eigenvalues 1e-12 of max(1, ||H||_F), projectors 1e-10),
   timed against torch.linalg.eigh there and at m 8, 16, 32, and kernel
   1's flux-batch mode at the Hofstadter row (1e-14); the eighth slice's
   kernel 14 (parallel transport: chain, rotate closed and open, follow)
   at the pump's 41 x 31 grid along both axes and a 41 x 41 Kane-Mele
   grid (nspin 2, nocc 2) at 1e-12, and kernel 19 (one Marzari-Vanderbilt
   step) on the silicon row's coarse 8^3 overlaps, single steps at 1e-12
   and the whole 400-step run against the plain run (Omega_I 1e-10,
   Omega 1e-9, history and centres 1e-7, relative: PERF.md section 2);
   the ninth slice's kernel 11b (the ED sector solver's dense Chebyshev
   filter) at the 4,900-dim Hubbard sector, one step at 1e-12 of each
   column's largest entry and the whole p = 30 filter at 1e-10, the
   6-ring's D 400 and a spinful-layout D 924 sector, and kernel 20 (the
   DMFT Schur pole sums) in its k-mean, pole, map and resolved modes at
   the DMFT rows' shapes at 1e-12; the eleventh slice's kernel 22 (the
   midpoint-propagator chain: state mode at the strong-field harmonic
   call's 2,560 steps x 2,304 rows, full mode at the Floquet Chern row and
   with its history at the Rudner winding row, random chains at S 4-64;
   at the first two rows also against a copy of csrc/propagate.cu built
   in phase 2 without its S <= 2 prefetch, timed in alternation),
   kernel 23 (the BdG Hessian and grand potential at the Lieb superfluid
   row, random 2S 2-64; 1e-10 relative), kernel 24 (the Rudner winding
   stencil, random S 4 and 16; 1e-10 relative) and kernel 1's
   Floquet-block mode (driven graphene at nharm 5, Kane-Mele at nspin 2),
   with the device times PERF.md listed as not measured; the twelfth
   slice's kernel 25 (the phonon kappa sweep at the 768^2 x 40 T row,
   1e-10 relative), kernel 26 (the e-ph vertex at the linewidth example's
   49 k x 18^2 q and eliashberg's default 576 k x 24^2 q chunk) and kernel
   27 (the Colpa factorization at the thermal-Hall 41^2 grid and the
   neutron row's 4,096 q, random 2n 16 and 64, a matrix that is not
   positive definite), the library eigh of the kappa row against kernel 7,
   and the Floquet Chern row's states step with its bound; the thirteenth
   slice's kernel 28 (the BSE pair matrix and its Fock shifts, captured
   from the bse_exciton_hbn_30x30 call and the same model at 48^2, random
   S 4 / 8 with s_x 0, 1, 2 on a 3-D grid; 1e-12 of the largest entry) and
   kernel 29 (the band-energy gradient gather at Haldane 301^2, the Peierls
   sweep and random S 4 / 16 / 40; 1e-10 relative to torch autograd
   through the plain versions); kernel 14's chain mode beside the
   library SVD of its overlaps, on every design that takes S at the
   pump, Kane-Mele, 301 x 300 (S 1 / 2 / 4 / 8), slab and random-frame
   shapes (the fifteenth slice's register path at S 1 and link path, a
   warp or a block a link); and kernel 11b's two designs (tensor cores,
   CUDA cores) at the Hubbard row, nb 1 / 16 / 17 / 32 at its sector
   beside the matmul steps, a repeated call giving the same bits;
   kernel 14's rotate on every design that takes S (the sixteenth
   slice's register path to S 3, a warp or a block a point on the CUDA
   cores, tensor-core tiles a block each 16 rows of a point) at the slab,
   random 9 x 7 and 41 x 41 frames (S 2-64), beside
   the matmul of conj(C) and the rows, the rows outside occ bit for bit;
   kernel 7 below 33 states on both designs (a block, or to 16 states a
   team of lanes, a matrix) at random B 1,600 m 3-32, degenerate batches and every
   eigh_batched call of phase 4 at m 3-32 (the kappa row, Kane-Mele 41^2,
   silicon, the magnon grids, the Floquet spectrum, the Lieb BdG),
   beside torch.linalg.eigh; the seventeenth slice's kernel 18 on both
   designs (a warp a chain to S 8, a block a chain to S 40) on random
   strips at S 1 / 3 / 8 / 16 / 40, stride 1 and 8, ndis 1 and 2 and
   across a chunk boundary (every exponent 1e-10 relative at stride 1;
   the largest 1e-10 and to S 8 every exponent 1e-8 at stride 8), each
   design's device time at the row's shape and about the design line,
   and the Lyapunov row's 200,000 steps; kernel 19's run kernel (the
   whole run in one cooperative launch) and block design against the
   plain step at nw 1 / 4 / 8, both branches of the step-size rule, the
   silicon 400-step run on the block design, each design's device time a
   step, the run kernel's split by phase and its launches a run; the
   eighteenth slice's kernel 14 follow mode (the selection scan split from
   the polar factors) at the slab, the pump, Kane-Mele 41^2, random 9 x 7
   frames at NS 9-64 and random frames at NS 1-8 (indices identical,
   1e-12), the slab's call split by kernel, and kernel 17's nine cases
   called twice, bit for bit;
4. the main path through the public API, on the card's default device,
   held against a CPU run of the same calls and PythTB's goldens:
   Haldane bands; the 301 x 301 Chern number (wf_array, flows); Kane-Mele
   Wilson flows (wf_array 21 x 21 and flows.wilson_flow 21 x 21 against
   the golden, 41 x 41 odd/even against the CPU); the Z2 invariant of
   both phases with its refinement check; hybrid Wannier centres of a
   20-layer cubic slab on a 41 x 41 grid; the 800-orbital Haldane flake's
   levels and position expectations; Wannier90 silicon bands; the
   matrix-free stack at the widths of tools/bench_suite.py: kpm_dos on the
   90,000-site Peierls flake, evolve of a wavepacket on it (20 steps),
   Kubo-Bastin sigma_xy on the 24 x 24 disordered Haldane torus, kpm_ldos
   of 64 probes on the 5,000-site Haldane flake, and the SSH quench echo;
   and the fourth slice's rows: the four flat-band states of magic-angle
   twisted bilayer graphene (11,164 orbitals) by solve_window at Gamma, K
   and M against the x64 pins, solve_lowest on the 3,600-site Peierls
   flake (each of the ten values within 5e-3 of the dense levels), the Bianco-Resta marker of the 608-site Penrose patch, the spin
   Chern marker of the 784-state Kane-Mele flake, the Bott index of the
   512-site disordered torus and the Weyl Fermi-arc map (10,201 pixels);
   and the fifth slice's nine response rows at full width with their pins:
   anomalous Hall (81 E_F) and thermal Hall (81 mu) on 101 x 101, orbital
   magnetization 121 x 121, the Kubo tensor and the BN shift current on
   161 x 161, the Rice-Mele shift current on 2,001 k, the integrated QGT
   72 x 72, Boltzmann 512^2 (201 mu) and Edelstein 256^2 (201 mu), held
   against the CPU run at 1e-10 relative (optics, shift, Boltzmann and
   Edelstein on 64 x 64 there); and the sixth slice's rows with their pins:
   the QWZ Hall bar's R_xy (4 leads, 128 modes, 41 E), the 8-leg strip's
   Lyapunov spectrum (512 E x 200,000 steps, W 1.5) and its clean-strip
   arccosh check, the kagome alloy CPA (256 w x 48^2), with the published
   widths of examples/quantum_transport.py (graphene ribbon at 301 E, the
   Kane-Mele ribbon with a disordered layer at 121 E) and
   examples/impurity_states.py (BN T-matrix at 96^2, 481 E), held against
   the CPU run at 1e-10 relative (Lyapunov at 2,048 steps, CPA at 24^2
   there); and the seventh slice's rows with their pins: the Hofstadter
   butterfly at q 40 (41 fluxes x 16 k), the BBH quadrupole 21 x 21, the
   spin Chern number 41 x 41, the bilayer sector Chern numbers 41 x 41
   and the Weyl node search on 40^3 with both charges, with Streda labels
   at 1/5, a family whose stacked eigensolve is 40 x 40, the Haldane DOS
   and the Fu-Kane-Mele second Chern number, against the CPU run at 1e-10
   relative (the nodes at 5e-6, the second Chern number at 8^3 there);
   kernel 7 must carry the slab's solve and the Hofstadter call, and the
   flux-batch mode the latter; and the eighth slice's rows with their
   pins: the silicon valence MLWF (coarse 8^3, 400 MV steps through
   kernel 19, 16^3 refinement), the 5 x 5 graphene unfolding (50 bands,
   121 k), the Haldane entanglement flow (L 20, 61 k), examples/
   pump_tools.py at 41 x 31 (family fill, adiabatic following, smooth
   gauge: kernels 1, 14) and examples/symmetry_indicators.py's Chern
   indicators, against the CPU run (1e-10; the MLWF's bands and spreads,
   which end a whole MV run, at the tolerances of PERF.md section 2);
   and the ninth slice's rows with their pins: the 8-site Hubbard ring's
   4,900-dim sector by the filtered solver (kernel 11b; also against the
   card's dense eigh of the same H at 1e-10), the interacting Haldane 2x2
   many-body Chern number (kernels 3-4), the Bethe-lattice DMFT at U 3
   and the 8-orbital ARPES map at 1001 k x 2001 w (kernel 20), with
   examples/hubbard_ed.py (HF >= ED, spectral functions), the BCS panel of
   examples/mean_field.py and examples/majorana.py's Majorana numbers,
   against the CPU run at 1e-10 (the ED filter on the 6-ring there; the
   ARPES map on the card's converged state carried to the CPU at 101 k x
   201 w; the DMFT fixed points, which pass through L-BFGS-B bath fits,
   at the rows' pins); and the eleventh slice's calls with their pins:
   superfluid_weight_lieb_48x48 (analytic, and the fd route at 1e-6),
   floquet_chern_31x31_nt128, examples/high_harmonics.py's three calls
   (weak field 36^2 x 2,304 steps, strong field 48^2 x 2,560 steps, the
   10-frequency SHG sweep), examples/floquet_graphene.py and
   examples/floquet_anomalous.py (the Rudner windings in both gaps),
   against the CPU run at 1e-10 relative (the harmonic calls at 6^2 x 80
   steps, the superfluid weight at 12^2, the Chern row at 11^2 x 32 steps
   there; exact quasienergies as sets on the circle; the small harmonic
   calls and the Rudner numbers also run on the card in chunks of 13
   steps); and the twelfth slice's rows with their pins:
   phonon_kappa_map_honeycomb (768^2 x 40 T), examples/phonon_bands.py,
   examples/eph_linewidths.py and eliashberg at its defaults (24^2 x 24^2),
   magnon_thermal_hall_map (41^2 x 20 T, Chern 31^2) and
   neutron_map_kagome_4096q (4,096 q x 300 w, the FM trace sum rule),
   against the CPU run at 1e-10 relative (kappa at 48^2, eliashberg at
   14^2, the neutron map at 64 q there; the phonon DOS at 1e-7);
   and the thirteenth slice's calls with their pins: bse_exciton_hbn_30x30
   (qp "hf"), absorption on its model over 401 omega, the 37 x 41 Haldane
   phase diagram through chern_fn's member axis, the graphene fit of
   examples/autodiff_tools.py (150 steps through kernel 29), the Peierls
   sweep and a band loss's gradient on Haldane 301^2, against the CPU run
   of the same calls (1e-10; group sums of oscillator strengths 1e-8);
   then the steady wall time of the main calls, of the thirteenth
   slice's five paths and of the fifteenth slice's two (the slab's
   smooth gauge, the 4,900-dim ED solve: walls and CUDA-event spans);
   the kappa row and the Kane-Mele flow and Z2 walls with their
   CUDA-event spans; the kappa row's and Kane-Mele's 4 x 4 solves must
   launch kernel 7;
5. launches: every kernel's counter must have risen during phase 4;
6. a JSON line of per-kernel results, then the last line
   {"ok": true, "device": {...}}.

It imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import subprocess
import sys
import time
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np

TOL = 1e-12
GRID = 301
REPS = 25
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
FP64_FLOPS_PER_S = 34e12  # H100 SXM float64 outside the tensor cores (data sheet)
FP64_TC_FLOPS_PER_S = 67e12  # H100 SXM float64 on the tensor cores (data sheet)
C128, F64, I64 = 16, 8, 8  # bytes per element
ROOT = Path(__file__).resolve().parent


class SmokeError(Exception):
    pass


def check(ok, msg):
    if not ok:
        raise SmokeError(msg)


def quiet(fn, *args, **kwargs):
    with redirect_stdout(io.StringIO()):
        return fn(*args, **kwargs)


def haldane(pt):
    """Haldane model, parameters of bench.py (examples/haldane.py)."""
    lat = [[1.0, 0.0], [0.5, np.sqrt(3.0) / 2.0]]
    orb = [[1.0 / 3.0, 1.0 / 3.0], [2.0 / 3.0, 2.0 / 3.0]]
    m = pt.tb_model(2, 2, lat, orb)
    delta, t, t2 = 0.2, -1.0, 0.15 * np.exp(1.0j * np.pi / 2.0)
    m.set_onsite([-delta, delta])
    m.set_hop(t, 0, 1, [0, 0])
    m.set_hop(t, 1, 0, [1, 0])
    m.set_hop(t, 1, 0, [0, 1])
    for lv in ([1, 0], [-1, 1], [0, -1]):
        m.set_hop(t2, 0, 0, lv)
    for lv in ([1, 0], [-1, 1], [0, -1]):
        m.set_hop(t2.conjugate(), 1, 1, lv)
    return m


def cubic_slab(pt, layers=20):
    """The cubic slab of examples/cubic_slab_hwf.py at ``layers`` layers,
    the top layer's second orbital removed: 2*layers - 1 orbitals."""
    model = quiet(pt.tb_model, 3, 3, np.eye(3), [[0.0, 0.0, 0.0], [0.5, 0.5, 0.5]])
    model.set_onsite([-1.0, 1.0])
    for lvec in ([-1, 0, 0], [0, 0, -1], [-1, -1, 0], [0, -1, -1]):
        model.set_hop(0.4, 0, 1, lvec)
    for lvec in ([0, 0, 0], [0, -1, 0], [-1, -1, -1], [-1, 0, -1]):
        model.set_hop(0.7, 0, 1, lvec)
    return model.cut_piece(layers, 2).remove_orb(2 * layers - 1)


def random_model_data(core, rng, device, norb=64, nhop=4096, dim=3):
    """A random nspin-1 model, finalized onto ``device``."""
    ii = rng.integers(0, norb, nhop)
    jj = rng.integers(0, norb, nhop)
    R = rng.integers(-2, 3, (nhop, dim))
    amps = rng.normal(size=nhop) + 1j * rng.normal(size=nhop)
    return core.finalize(
        dim, dim, list(range(dim)), 1, norb, rng.random((norb, dim)),
        rng.normal(size=norb), amps, ii, jj, R, device,
    )


def unit_states(torch, rng, shape, device):
    """Random states with unit rows, as eigenvectors are."""
    z = rng.normal(size=shape) + 1j * rng.normal(size=shape)
    z /= np.linalg.norm(z, axis=-1, keepdims=True)
    return torch.as_tensor(z, dtype=torch.complex128).to(device)


def cuda_ms(torch, fn, reps=REPS):
    """Median milliseconds of ``fn`` over ``reps`` runs after warm-up (up
    to three runs, no more than ``reps``), each run timed by the port's
    ``utils.profiling.timed``: CUDA events behind a synchronize."""
    from pythtb_tpu_torch import config
    from pythtb_tpu_torch.utils import profiling

    check(config.device().type == "cuda", "cuda_ms times the card, not %s" % config.device())
    for _ in range(min(3, reps)):
        fn()
    times = []
    for _ in range(reps):
        with profiling.timed(out=times):
            fn()
    return 1e3 * float(np.median(times))


def event_us(torch, fn, reps=10):
    """Median device microseconds of ``fn`` between two CUDA events that
    are queued behind a ~1 ms spin kernel, so the host's enqueue time
    (the wrapper's Python and ctypes) is hidden: the time the device takes
    from the first to the last of ``fn``'s launches.  ``fn`` must not
    wait on the device."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(1e3 * start.elapsed_time(end))
    return float(np.median(times))


def wall_ms(torch, fn, reps):
    """Median host-clock milliseconds of ``fn`` (which ends on the host)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return 1e3 * float(np.median(times))


def profiled(torch, fn, reps):
    """torch.profiler over ``reps`` calls of ``fn``: the device events, the
    kernel-launch calls and the kernels recorded for them (the profiler
    loses some windows' kernels, fewer or more from one window to the
    next)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    calls = sum("LaunchKernel" in e.name for e in prof.events() if e.device_type == DeviceType.CPU)
    kernels = sum(not e.name.startswith(("Memcpy", "Memset")) for e in events)
    return events, calls, kernels


def device_us(torch, fn, reps=10):
    """Device time (us) and device activities (kernels, copies) per call
    of ``fn``, from torch.profiler's CUDA events over ``reps`` calls;
    (None, None) where the profiler records no device activity or fewer
    kernels than the window's kernel-launch calls (it lost events)."""
    events, calls, kernels = profiled(torch, fn, reps)
    if kernels < calls:
        print("    (profiler: %d kernels for %d launch calls, events lost: device time not measured)"
              % (kernels, calls))
    if not events or kernels < calls:
        return None, None
    return sum(e.time_range.elapsed_us() for e in events) / reps, len(events) / reps


def device_top(torch, fn, n=4, reps=2):
    """The ``n`` device activities that take most of ``fn``'s device time
    per call (profiler, summed by name), and the total; the total is None
    where the profiler recorded fewer kernels than kernel-launch calls (it
    lost events, so the sums are short)."""
    events, calls, kernels = profiled(torch, fn, reps)
    if kernels < calls:
        print("    (profiler: %d kernels for %d launch calls, events lost: the sums below are incomplete)"
              % (kernels, calls))
    per = {}
    for e in events:
        per[e.name] = per.get(e.name, 0.0) + e.time_range.elapsed_us() / reps
    return sorted(per.items(), key=lambda kv: -kv[1])[:n], (None if kernels < calls else sum(per.values()))


def fmt(x):
    return "not measured" if x is None else "%.1f" % x


def eigh_library_ms(torch, H):
    """One torch.linalg.eigh call on the whole batch.  cuSOLVER's batched
    syev, torch's default for complex matrices up to 32 x 32, refuses
    batches of 32,768 and more (CUSOLVER_STATUS_INVALID_VALUE with torch
    2.11 and CUDA 12.8), so this yardstick call runs on MAGMA's backend."""
    prev = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library("magma")
    try:
        return cuda_ms(torch, lambda: torch.linalg.eigh(H), 5)
    finally:
        torch.backends.cuda.preferred_linalg_library(prev)


def bound(nbytes, flops, rate=FP64_FLOPS_PER_S):
    """Least time (ms) of the work on the card, and what bounds it; the
    operations at ``rate`` (the tensor cores' for a matrix product)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_diff(torch, a, b):
    torch.cuda.synchronize()
    check(a.shape == b.shape, "shape %s vs %s" % (tuple(a.shape), tuple(b.shape)))
    check(bool(torch.isfinite(torch.as_tensor(a)).all()), "non-finite kernel output")
    return float((a - b).abs().max()) if a.numel() else 0.0


def wrapped_diff(torch, a, b):
    """Max |a - b| for phases, modulo 2 pi."""
    torch.cuda.synchronize()
    d = torch.remainder(a - b + math.pi, 2 * math.pi) - math.pi
    return float(d.abs().max())


def match_phase_sets(got, want, tol, what):
    """Compare multiband phase rows as sets on the unit circle."""
    got2 = np.asarray(got).reshape(-1, np.shape(got)[-1])
    want2 = np.asarray(want).reshape(-1, np.shape(want)[-1])
    check(got2.shape == want2.shape, "%s: shape %s vs %s" % (what, got2.shape, want2.shape))
    worst = 0.0
    for row in range(got2.shape[0]):
        avail = list(range(got2.shape[1]))
        for w in want2[row]:
            dists = [abs(np.angle(np.exp(1j * (got2[row, k] - w)))) for k in avail]
            k_best = int(np.argmin(dists))
            worst = max(worst, dists[k_best])
            avail.pop(k_best)
    check(worst < tol, "%s: phases differ from the reference set by %.3e" % (what, worst))
    return worst


# -- work counts of each kernel at a shape (bytes read + written, fp64 ops) --


def cost_assemble(data, B):
    blk = 4 if data.nspin == 2 else 1
    nbytes = (B * data.dim_k * F64 + data.nhop * (data.dim_k * F64 + blk * C128)
              + data.nsta**2 * C128 + (data.norb**2 + 1 + 2 * data.nhop) * 4
              + B * data.nsta**2 * C128)
    # per (k, hop): k.rv, sin and cos (one op each), and both landing
    # entries' complex multiply-add (8 ops per scalar entry)
    flops = B * data.nhop * (2 * data.dim_k + 2 + 2 * blk * 8)
    return bound(nbytes, flops)


def cost_eig2(B):
    return bound(B * (4 * C128 + 2 * F64 + 4 * C128), B * 40)


def cost_link_dets(grid, S, F, axis):
    nlinks = math.prod(grid) // grid[axis] * (grid[axis] - 1)
    nbytes = math.prod(grid) * S * F * C128 + nlinks * C128
    return bound(nbytes, nlinks * (S * S * F * 8 + 8 * S**3))


def cost_plaquette(n0, n1):
    nbytes = ((n0 - 1) * n1 + n0 * (n1 - 1)) * C128 + 2 * F64
    return bound(nbytes, (n0 - 1) * (n1 - 1) * 20)


def cost_wilson(grid, S, F, axis):
    """One Jacobi sweep per link at S >= 3 (the sweep count depends on the
    data; one is the least any link needs)."""
    strings = math.prod(grid) // grid[axis]
    nlinks = strings * (grid[axis] - 1)
    nbytes = math.prod(grid) * S * F * C128 + strings * (S * S * C128 + F64)
    polar = {1: 10, 2: 80}.get(S, S * (S - 1) // 2 * S * 40 + S * S * S * 8)
    return bound(nbytes, nlinks * (S * S * F * 8 + polar + S**3 * 8))


def cost_position(B, S, F, diagonal=False):
    """Kernel 6: the chosen states read once, X written once; X's upper
    triangle is a matrix product, at the FP64 tensor cores' rate."""
    if diagonal:
        return bound(B * S * F * C128 + F * F64 + S * I64 + B * S * F64, B * S * F * 4)
    return bound(B * S * F * C128 + F * F64 + S * I64 + B * S * S * C128, B * S * (S + 1) // 2 * F * 8,
                 FP64_TC_FLOPS_PER_S)


def _ell_table_bytes(h):
    D = h.cols.shape[1]
    return h.norb * D * (4 + h.nspin**2 * C128)


def _ell_row_ops(h):
    """fp64 operations of one ELL row product, on average over the rows: a
    complex multiply-add per real slot and spin component (the padding's
    zero slots need no work, so they are not counted)."""
    nonzero = h.vals != 0
    if h.nspin == 2:
        nonzero = nonzero.flatten(2).any(dim=2)
    return int(nonzero.sum()) / h.norb * h.nspin * 8


def cost_ell_matvec(h, B):
    return bound(_ell_table_bytes(h) + 2 * h.nsta * B * C128, h.nsta * B * _ell_row_ops(h))


def cost_cheb(h, B, steps, out_bytes, extra_ops=0):
    """A kernel-9 call of ``steps`` steps: the tables and the start block
    read once, ``out_bytes`` written once; per element and step the ELL
    row, the rescaling (4 ops) and 2 Ht T_m - T_m-1 (4), plus
    ``extra_ops`` (4 for the two moment sums)."""
    per = h.nsta * B * (_ell_row_ops(h) + 8 + extra_ops)
    return bound(_ell_table_bytes(h) + h.nsta * B * C128 + out_bytes, steps * per)


def cost_cheb_evolve(h, B, M, nsteps):
    """Kernel 10: the tables, psi0 and the (M,) coefficients read once, the
    (nsteps, nsta, B) history written once; per element and term the ELL
    row, the recursion (8 ops) and acc += c T (8)."""
    per = h.nsta * B * (_ell_row_ops(h) + 16)
    nbytes = _ell_table_bytes(h) + h.nsta * B * C128 + M * C128 + nsteps * h.nsta * B * C128
    return bound(nbytes, nsteps * (M - 1) * per)


def cost_cheb_filter(h, B, M):
    """Kernel 11: the tables, X and the (M,) coefficients read once, Y
    written once; per element and term the ELL row, the rescaling (4 ops),
    the recursion (4) and acc += c T (4)."""
    nbytes = _ell_table_bytes(h) + 2 * h.nsta * B * C128 + M * F64
    return bound(nbytes, (M - 1) * h.nsta * B * (_ell_row_ops(h) + 12))


def cost_one_sided(data, B):
    """Kernel 1's one-sided mode: k, rv, amps and the gather index read
    once, H written once; per (k, hop) k.rv, sin, cos and one landing
    entry's complex multiply-add per spin-block element."""
    blk = 4 if data.nspin == 2 else 1
    nbytes = (B * data.dim_k * F64 + data.nhop * (data.dim_k * F64 + blk * C128)
              + (data.norb**2 + 1 + 2 * data.nhop) * 4 + B * data.nsta**2 * C128)
    return bound(nbytes, B * data.nhop * (2 * data.dim_k + 2 + blk * 8))


def cost_decimation(K, nE, S, iters):
    """Kernel 12: H00, H01 (K, S, S) and w (nE,) read once, the (nE, K, S)
    surface and bulk weights and two (nE, K) maxima written once; per
    pixel and iteration one S x S inverse (~8 S^3 ops) and six complex
    S x S products (48 S^3), plus the 3 S^2 complex updates (6 S^2), and
    the two final inverses."""
    nbytes = 2 * K * S * S * C128 + nE * C128 + 2 * nE * K * S * F64 + 2 * nE * K * F64
    flops = nE * K * (iters * (56 * S**3 + 6 * S * S) + 16 * S**3)
    return bound(nbytes, flops)


def cost_assemble_deriv(data, B, order):
    """Kernel 15: k, rv, amps and the gather index read once, the (B,
    dim_k^order, S, S) derivative written once; per (k, hop) k.rv, sin and
    cos, and per landing entry and spin-block element the term v (6 ops)
    and a multiply-add (4) for each distinct direction."""
    blk = 4 if data.nspin == 2 else 1
    dim = data.dim_k
    ndir = dim if order == 1 else dim * (dim + 1) // 2
    nbytes = (B * dim * F64 + data.nhop * (dim * F64 + blk * C128) + (data.norb**2 + 1 + 2 * data.nhop) * 4
              + B * dim**order * data.nsta**2 * C128)
    return bound(nbytes, B * data.nhop * (2 * dim + 2 + 2 * blk * (6 + 4 * ndir)))


def cost_spectral_sum(T, P, nw, lorentz):
    """Kernel 16: de, W and the frequencies read once, the (P, nw) sums
    written once; per (transition, frequency) the kernel value (6 ops) and
    P multiply-adds (8 ops complex, 2 real)."""
    w = C128 if lorentz else F64
    nbytes = T * F64 + P * T * w + nw * F64 + P * nw * w
    return bound(nbytes, T * nw * (6 + P * (8 if lorentz else 2)))


# operations of one weight of kernel 17 (exp, log and division one op each;
# the dilogarithm's two degree-7 polynomials 28)
SWEEP_WEIGHT_OPS = {"step": 1, "fermi": 4, "entropy": 9, "c2": 45, "dfde": 6, "dfde_cosh": 6, "gauss": 5}


def cost_fermi_sweep(T, P, M, kind):
    """Kernel 17: E, G, the powers and mu read once, the (M, P) sums written
    once; per (mu, t) the difference (1), the weight, its two powers (2)
    and P multiply-adds (2 each)."""
    nbytes = T * F64 + P * T * F64 + P * 4 + M * F64 + M * P * F64
    return bound(nbytes, M * T * (3 + SWEEP_WEIGHT_OPS[kind] + 2 * P))


# ----------------------------------------------------------------------------


def phase_kernels(torch, pt, device):
    """Phase 3: each kernel vs its plain version at the main path's shapes."""
    from pythtb_tpu_torch import core, flows
    from pythtb_tpu_torch.ops import berry, eigh, hamiltonian, position, solver
    from tests import workloads, zoo

    rng = np.random.default_rng(1)
    res = {}
    failures = []

    def held(name, key, err, tol=TOL, scale=1.0):
        """A kernel held against its plain version at a further main-path
        shape, without timing."""
        print("  %-15s %-34s max|diff| %.3e%s  (held, not timed)"
              % (name, key, err, "" if scale == 1.0 else " (relative %.3e)" % (err / scale)))
        if not err <= tol * scale:
            failures.append("%s %s disagrees with its plain version: %.3e (limit %.1e)"
                            % (name, key, err, tol * scale))
        r = res.setdefault(name, {"max_abs_err": 0.0})
        r["max_abs_err"] = max(r["max_abs_err"], err)

    def record(name, key, err, kernel, plain, cost, main=False, library_ms=None, reps=REPS,
               scale=1.0, tol=TOL, prof_reps=10, prof_plain=True, profile=False):
        """Time ``kernel`` and ``plain`` (CUDA events, median of ``reps``)
        and, at the main shape, their device time per call (profiler).
        ``err`` is the max |diff|; it must stay within ``tol * scale``.
        ``prof_plain=False`` leaves out the plain version's profile (the
        plain evolve's 12,500 launches take the profiler some 9 s);
        ``profile`` profiles a row that is not the main shape."""
        t0 = time.perf_counter()
        ms, plain_ms = cuda_ms(torch, kernel, reps), cuda_ms(torch, plain, reps)
        ev = event_us(torch, kernel, min(reps, 10))
        print("  %-15s %-34s max|diff| %.3e%s  kernel %.4f ms (device %.1f us, CUDA events)  plain %.4f ms%s  "
              "bound %.5f ms (%s)  [%.1f s]"
              % (name, key, err, "" if scale == 1.0 else " (relative %.3e)" % (err / scale), ms, ev, plain_ms,
                 "" if library_ms is None else "  library %.4f ms" % library_ms, *cost,
                 time.perf_counter() - t0))
        if not err <= tol * scale:
            failures.append("%s %s disagrees with its plain version: %.3e (limit %.1e)"
                            % (name, key, err, tol * scale))
        r = res.setdefault(name, {"max_abs_err": 0.0})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if main or profile:
            t0 = time.perf_counter()
            (dev_us, n) = device_us(torch, kernel, prof_reps)
            (plain_us, plain_n) = device_us(torch, plain, prof_reps) if prof_plain else (None, None)
            # a device time below the bound is a window that lost events
            if dev_us is not None and dev_us < 1e3 * cost[0]:
                dev_us = None
            if plain_us is not None and plain_us < 1e3 * cost[0]:
                plain_us = None
            print("  %-15s %-34s device per call: kernel %s us (%s launches), plain %s us (%s launches)  [%.1f s]"
                  % (name, key, fmt(dev_us), fmt(n), fmt(plain_us), fmt(plain_n), time.perf_counter() - t0))
        if main:
            r.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=cost[0],
                     bound_by=cost[1], shape=key, device_us=dev_us, plain_device_us=plain_us,
                     plain_launches_per_call=plain_n, event_us=ev)

    # kernel 1: assemble, at every shape of the main path
    hal = haldane(pt)._get_finalized()
    km = zoo.kane_mele(pt, "odd")._get_finalized()
    fl = flake(pt)
    fld = fl._get_finalized()
    slab = cubic_slab(pt)
    sd = slab._get_finalized()
    si = pt.w90(workloads.W90_DATA_DIR, "silicon")
    si_k = si.w90_bands_consistency()[0]
    si1 = si.model(min_hopping_norm=0.01)._get_finalized()
    si2 = si.model(zero_energy=6.2285135, min_hopping_norm=0.05, max_distance=4.0)._get_finalized()
    rnd = random_model_data(core, rng, device)
    k_hal = solver.device_uniform_grid((GRID - 1, GRID - 1), (-0.5, -0.5), device)
    k_km = solver.device_uniform_grid((40, 40), (-0.5, -0.5), device)
    k_slab = solver.device_uniform_grid((40, 40), (0.0, 0.0), device)
    k_rnd = torch.as_tensor(rng.random((16384, 3)), dtype=torch.float64).to(device)
    for key, data, k, main in (
        ("haldane B=90000", hal, k_hal, True),
        ("kane_mele nspin2 B=1600", km, k_km, False),
        ("flake norb800 dim_k0 B=1", fld, solver._prep_kpts(fld, None), False),
        ("slab norb39 B=1600", sd, k_slab, False),
        ("w90 silicon nhop%d B=190" % si1.nhop, si1, solver._prep_kpts(si1, si_k), False),
        ("w90 silicon filtered B=48", si2, solver._prep_kpts(si2, si_k[::4]), False),
        ("norb64 nhop4096 B=16384", rnd, k_rnd, False),
    ):
        err = max_diff(torch, hamiltonian.assemble(data, k), hamiltonian._assemble_plain(data, k))
        record("assemble", key, err, lambda: hamiltonian.assemble(data, k),
               lambda: hamiltonian._assemble_plain(data, k), cost_assemble(data, k.shape[0]), main)

    # kernel 2: eig2
    H = hamiltonian._assemble_plain(hal, k_hal)
    w, v = eigh.eig2(H)
    wp, vp = eigh._eig2_plain(H)
    err = max(max_diff(torch, w, wp), max_diff(torch, v, vp))
    record("eig2", "B=90000", err, lambda: eigh.eig2(H), lambda: eigh._eig2_plain(H),
           cost_eig2(H.shape[0]), True, eigh_library_ms(torch, H))

    # kernels 3 and 4: link dets and plaquette flux
    _, _, wfs = solver.solve_grid_device(hal, (GRID, GRID), (-0.5, -0.5),
                                         haldane(pt)._orb, [0, 1], 1)
    grids = [("%dx%d S=1 F=2" % (GRID, GRID), berry.prep_states(wfs, [0], 1, 2), True)]
    for S, F in ((2, 4), (4, 8)):
        grids.append(("%dx%d S=%d F=%d random" % (GRID, GRID, S, F),
                      unit_states(torch, rng, (GRID, GRID, S, F), device), False))
    for key, st, main in grids:
        err = 0.0
        for axis in (0, 1):
            err = max(err, max_diff(torch, berry.link_dets(st, axis), berry._link_dets_plain(st, axis)))
        record("link_dets", key, err, lambda: berry.link_dets(st, 0),
               lambda: berry._link_dets_plain(st, 0),
               cost_link_dets((GRID, GRID), st.shape[-2], st.shape[-1], 0), main)
        Dr, Du = berry._link_dets_plain(st, 0), berry._link_dets_plain(st, 1)
        s_k, m_k = berry.plaquette_flux(Dr, Du)
        s_p, m_p = berry._plaquette_flux_plain(Dr, Du, False)
        p_k, _ = berry.plaquette_flux(Dr, Du, individual=True)
        p_p, _ = berry._plaquette_flux_plain(Dr, Du, True)
        err = max(max_diff(torch, s_k, s_p), max_diff(torch, m_k, m_p), wrapped_diff(torch, p_k, p_p))
        record("plaquette_flux", key, err, lambda: berry.plaquette_flux(Dr, Du),
               lambda: berry._plaquette_flux_plain(Dr, Du, False), cost_plaquette(GRID, GRID), main)

    # kernel 5: Wilson loops.  Main shape: flows.wilson_flow on Kane-Mele
    # 41 x 41 (40 strings of 41 links, S 2, F 4), built as the flow builds it
    kpts = solver.device_uniform_grid((40, 40), (-0.5, -0.5), device)
    wk = flows._solve_grid_states(km, kpts, (0, 1), 41, 41)
    ph = flows._phase_tensor(zoo.kane_mele(pt, "odd"), 1, device)
    wk = torch.cat([wk, wk.narrow(1, 0, 1) * ph], dim=1).contiguous()
    cases = [("kane_mele flow 40x41 S=2 F=4", wk, (1,), True)]
    for S in (1, 2, 4, 8):
        cases.append(("%dx%d S=%d F=%d random" % (GRID, GRID, S, 2 * S),
                      unit_states(torch, rng, (GRID, GRID, S, 2 * S), device), (0, 1), False))
    for key, st, axes, main in cases:
        err = 0.0
        for axis in axes:
            prod, smin = berry.wilson_loop(st, axis)
            want, want_min = berry._wilson_loop_plain(st, axis)
            err = max(err, max_diff(torch, prod, want), max_diff(torch, smin, want_min))
        ax = axes[0]
        ws_ = torch.movedim(st, ax, 0)
        ov = berry._overlap(ws_[:-1], ws_[1:]).contiguous()
        record("wilson_loop", key, err, lambda: berry.wilson_loop(st, ax),
               lambda: berry._wilson_loop_plain(st, ax),
               cost_wilson(tuple(st.shape[:-2]), st.shape[-2], st.shape[-1], ax), main,
               cuda_ms(torch, lambda: torch.linalg.svd(ov, full_matrices=False), 3), reps=REPS if main else 3)
        del ov

    # kernel 6: position matrices.  Main shape: the 20-layer slab on a
    # 41 x 41 grid (B 1681, 39 states of F 39, the lower 20 chosen)
    _, _, ws = solver.solve_grid_device(sd, (41, 41), (0.0, 0.0), slab._orb, slab._per, 1)
    w3 = ws.reshape(41 * 41, sd.nsta, -1)
    pos = torch.as_tensor(slab._pos_weights(2), dtype=torch.float64).to(device)
    occ = torch.arange(20, dtype=torch.int64, device=device)
    sel = w3[:, :20].contiguous()
    posc = pos.to(torch.complex128)
    B, F = w3.shape[0], w3.shape[-1]
    err = max_diff(torch, position.xmat(w3, pos, occ), position._xmat_plain(w3, pos, occ))
    record("position", "slab 41x41 B=1681 S=20 F=39", err, lambda: position.xmat(w3, pos, occ),
           lambda: position._xmat_plain(w3, pos, occ), cost_position(B, 20, F), True,
           cuda_ms(torch, lambda: torch.einsum("bnf,f,bmf->bnm", sel.conj(), posc, sel)))
    err = max_diff(torch, position.xmat(w3, pos, occ, diagonal=True), position._xdiag_plain(w3, pos, occ))
    record("position", "slab 41x41 diagonal mode", err,
           lambda: position.xmat(w3, pos, occ, diagonal=True),
           lambda: position._xdiag_plain(w3, pos, occ), cost_position(B, 20, F, diagonal=True))
    # the flake's position_expectation: all 800 card eigenvectors at once
    # (B 1, S = F = 800, no selection), along both directions
    fv = torch.as_tensor(np.ascontiguousarray(fl.solve_all(eig_vectors=True)[1][None])).to(device)
    err = 0.0
    for d in (0, 1):
        p = torch.as_tensor(fl._pos_weights(d), dtype=torch.float64).to(device)
        err = max(err, max_diff(torch, position.xmat(fv, p), position._xmat_plain(fv, p)))
    record("position", "flake B=1 S=800 F=800", err, lambda: position.xmat(fv, p),
           lambda: position._xmat_plain(fv, p), cost_position(1, 800, 800), reps=5, profile=True,
           prof_reps=3, library_ms=cuda_ms(torch, lambda: torch.einsum("bnf,f,bmf->bnm", fv.conj(),
                                                                        p.to(fv.dtype), fv), 5))

    def position_paths(key, st, p, o, reps):
        """Kernel 6's two designs for X (threads: a thread an element;
        tiles: the FP64 tensor cores) on the same inputs."""
        B, S, F = st.shape[0], o.shape[0], st.shape[-1]
        want = position._xmat_plain(st, p, o)
        sel = st.index_select(1, o).contiguous()
        lib = cuda_ms(torch, lambda: torch.einsum("bnf,f,bmf->bnm", sel.conj(), p.to(sel.dtype), sel), reps)
        for path in ("tiles", "threads"):
            X = position._xmat(st, p, o, False, path)
            err = max_diff(torch, X, want)
            check(float((X - X.conj().transpose(-1, -2)).abs().max()) == 0.0,
                  "kernel 6's %s path: X is not exactly Hermitian at %s" % (path, key))
            record("position", "%s, %s" % (key, path), err, lambda: position._xmat(st, p, o, False, path),
                   lambda: position._xmat_plain(st, p, o), cost_position(B, S, F), reps=reps, library_ms=lib)

    position_paths("flake B=1 S=800 F=800", fv, p, torch.arange(800, device=device), 5)
    position_paths("slab 41x41 B=1681 S=20 F=39", w3, pos, occ, 5)
    for key, B, S, nsta, F in (("ragged B=1 S=333 of 340 F=797", 1, 333, 340, 797),
                               ("ragged B=3 S=33 of 40 F=97", 3, 33, 40, 97),
                               ("kane_mele marker shape B=1 S=392 of 784 F=784", 1, 392, 784, 784)):
        st = unit_states(torch, rng, (B, nsta, F), device)
        p = torch.as_tensor(rng.uniform(-15.0, 15.0, F)).to(device)
        o = torch.as_tensor(rng.permutation(nsta)[:S]).to(device)
        position_paths(key, st, p, o, 5)
    # where the tiles overtake: the slab's k-points at S 4-16 (F 39)
    for S in (4, 8, 12, 16):
        st = unit_states(torch, rng, (1681, 39, 39), device)
        p = torch.as_tensor(rng.uniform(0.0, 20.0, 39)).to(device)
        position_paths("slab-like B=1681 S=%d of 39 F=39" % S, st, p,
                       torch.as_tensor(rng.permutation(39)[:S]).to(device), 3)
    for S, F in ((1, 3), (2, 4), (8, 16), (64, 96)):
        st = unit_states(torch, rng, (257, S + 2, F), device)
        p = torch.as_tensor(rng.uniform(0.0, 20.0, F)).to(device)
        o = torch.as_tensor(rng.permutation(S + 2)[:S]).to(device)
        err = max(max_diff(torch, position.xmat(st, p, o), position._xmat_plain(st, p, o)),
                  max_diff(torch, position.xmat(st, p, o, diagonal=True), position._xdiag_plain(st, p, o)))
        record("position", "random B=257 S=%d F=%d" % (S, F), err, lambda: position.xmat(st, p, o),
               lambda: position._xmat_plain(st, p, o), cost_position(257, S, F), reps=3)
    matrix_free_kernels(torch, pt, device, rng, record, held)
    slice4_kernels(torch, pt, device, rng, record, held)
    slice5_kernels(torch, pt, device, record, held)
    slice6_kernels(torch, pt, device, record, held)
    slice7_kernels(torch, pt, device, record, held)
    slice8_kernels(torch, pt, device, record, held)
    slice9_kernels(torch, pt, device, record, held)
    slice10_kernels(torch, pt, device, record, held)
    slice11_kernels(torch, pt, device, record, held)
    slice12_kernels(torch, pt, device, record, held)
    slice13_kernels(torch, pt, device, record, held)
    slice17_kernels(torch, pt, device, record, held)
    slice18_kernels(torch, pt, device, held)
    check(not failures, "; ".join(failures))
    return res


def flake(pt):
    """The 800-orbital Haldane flake (BASELINE.md): a 20 x 20 cut."""
    return haldane(pt).cut_piece(20, 0).cut_piece(20, 1)


# -- the matrix-free workloads: the rows of tools/bench_suite.py ------------------

EVOLVE_TIMES = np.linspace(0.5, 10.0, 20)  # chebyshev_evolve_90k_20steps: dt 0.5, order 58
LDOS_SITES = np.concatenate([np.arange(32), 2500 + np.arange(32)])  # kpm_ldos_5k_sites_64probe
KPM_MOMENTS, KPM_VECTORS = 512, 8
_MODELS = {}


def cached(key, build):
    """Models built once per run."""
    if key not in _MODELS:
        _MODELS[key] = build()
    return _MODELS[key]


def peierls_flake(pt):
    """The 90,000-site Peierls flake of kpm_dos_90k_sites_M512 and
    chebyshev_evolve_90k_20steps: the square lattice cut 300 wide, flux
    1/9 per plaquette (Landau gauge), cut 300 high."""
    return cached("peierls_flake", lambda: pt.magnetic.peierls_model(
        pt.models.square().cut_piece(300, 0), 1.0 / 9.0, dirs=(0, 1)).cut_piece(300, 1))


def haldane_flake5k(pt):
    """The 5,000-site Haldane flake of kpm_ldos_5k_sites_64probe (open edges)."""
    return cached("haldane_flake5k", lambda: pt.models.haldane().cut_piece(
        50, 0, glue_edgs=False).cut_piece(50, 1, glue_edgs=False))


def kubo_torus(pt):
    """The 24 x 24 Haldane torus with W = 1 Anderson disorder of
    kpm_hall_1152_sites_M512 (1,152 sites), on the current device."""
    from pythtb_tpu_torch import config

    return cached(("kubo_torus", str(config.device())), lambda: pt.realspace.torus_sample(
        pt.models.haldane(), (24, 24), onsite_disorder=1.0, seed=2))


def ell_csr(torch, h):
    """The ELL tables of an nspin-1 SparseH as a CSR tensor: the operand of
    the library yardstick torch.sparse.mm (cuSPARSE), never the port's path."""
    norb, D = h.cols.shape
    rows = torch.arange(norb, device=h.device).repeat_interleave(D)
    idx = torch.stack([rows, h.cols.reshape(-1).long()])
    return torch.sparse_coo_tensor(idx, h.vals.reshape(-1), (norb, norb)).coalesce().to_sparse_csr()


def matrix_free_kernels(torch, pt, device, rng, record, held):
    """Phase 3 for kernels 8-10 at the matrix-free main path's shapes:
    single steps at 1e-12, whole recursions at 1e-10 relative.  The timed
    rows are the bench-suite shapes; every other shape that phase 4 gives
    the kernels (the shorter calls compared with the CPU, the Kubo right
    block, the seeded evolve, kernels 1 and 2 in quench_echo) is held
    once without timing."""
    from pythtb_tpu_torch import dynamics
    from pythtb_tpu_torch.ops import _kernels, chebyshev, matvec

    h90 = matvec.sparse_h(peierls_flake(pt))
    h5k = matvec.sparse_h(haldane_flake5k(pt))
    torus = kubo_torus(pt)
    N90 = h90.nsta

    def block(shape):
        z = rng.normal(size=shape) + 1j * rng.normal(size=shape)
        return torch.as_tensor(z).to(device)

    def ab_of(h, margin):
        lo, hi = h.window
        return torch.tensor([0.5 * (hi - lo) / margin + 1e-12, 0.5 * (hi + lo)],
                            dtype=torch.float64, device=device)

    # kernel 8: the flake at B 8, and the Kubo velocity application, one
    # launch over all M * R left vectors
    for key, h, B, main in (("flake N=90000 B=8", h90, KPM_VECTORS, True),
                             ("kubo velocity N=1152 B=4096", torus.velocity[0], KPM_MOMENTS * KPM_VECTORS, False)):
        x = block((h.nsta, B))
        want = matvec._matvec_plain(h, x)
        csr = ell_csr(torch, h)
        lib_err = max_diff(torch, torch.sparse.mm(csr, x), want)
        print("  %-15s %-34s torch.sparse.mm (CSR) vs plain: max|diff| %.3e" % ("ell_matvec", key, lib_err))
        record("ell_matvec", key, max_diff(torch, matvec.matvec(h, x), want), lambda: matvec.matvec(h, x),
               lambda: matvec._matvec_plain(h, x), cost_ell_matvec(h, B), main,
               cuda_ms(torch, lambda: torch.sparse.mm(csr, x)), profile=True)

    # kernel 9, one step (T_1, then T_2 = 2 Ht T_1 - T_0): 90k x R 8 from
    # random phases, 5k x B 64 from the LDOS probes' unit vectors
    onehot = torch.zeros((h5k.nsta, len(LDOS_SITES)), dtype=torch.complex128, device=device)
    onehot[torch.as_tensor(LDOS_SITES).to(device), torch.arange(len(LDOS_SITES), device=device)] = 1.0
    for key, h, x0 in (("one step 90k R=8", h90, chebyshev.phase_vectors(N90, KPM_VECTORS, 1, device)),
                       ("one step 5k B=64", h5k, onehot)):
        ab = ab_of(h, 0.98)
        blk = torch.empty((3,) + tuple(x0.shape), dtype=torch.complex128, device=device)
        blk[0] = x0
        got = chebyshev.recursion(h, ab, blk.clone())
        want = chebyshev._recursion_plain(h, ab, blk.clone())
        B = x0.shape[1]
        record("cheb_moments", key, max_diff(torch, got, want), lambda: chebyshev.recursion(h, ab, blk),
               lambda: chebyshev._recursion_plain(h, ab, blk), cost_cheb(h, B, 2, 2 * h.nsta * B * C128))

    # kernel 9, whole recursions: the kpm_dos moments at 90k (main), the
    # LDOS moments at 5k, a Kubo left block at 1,152
    M = KPM_MOMENTS
    steps = 1 + (M - 1) // 2
    ab = ab_of(h90, 0.98)
    x0 = chebyshev.phase_vectors(N90, KPM_VECTORS, 0, device)
    err = max_diff(torch, chebyshev.moments(h90, ab, x0, M, float(N90)),
                   chebyshev._moments_plain(h90, ab, x0, M, float(N90)))
    record("cheb_moments", "kpm_dos 90k M=512 R=8 (256 steps)", err,
           lambda: chebyshev.moments(h90, ab, x0, M, float(N90)),
           lambda: chebyshev._moments_plain(h90, ab, x0, M, float(N90)),
           cost_cheb(h90, KPM_VECTORS, steps, M * KPM_VECTORS * F64, 4), True, reps=3,
           scale=N90, tol=1e-10, prof_reps=1)
    check(torch.equal(chebyshev.moments(h90, ab, x0, M, float(N90)), chebyshev.moments(h90, ab, x0, M, float(N90))),
          "kernel 9: two kpm_dos calls gave other bits")
    sms, smem = _kernels.card(device)
    for key, h, B, kind in (("kpm_dos 90k R=8", h90, KPM_VECTORS, "moments"), ("kpm_ldos 5k B=64", h5k, 64, "moments"),
                            ("kubo 1152 R=8", torus.h, KPM_VECTORS, "recursion")):
        print("  %-15s %-34s plan %s" % ("cheb_moments", key, chebyshev._grid_plan(
            h.norb, h.nspin, B, h.cols.shape[1], sms, smem, kind)))
    ab5 = ab_of(h5k, 0.98)
    err = max_diff(torch, chebyshev.moments(h5k, ab5, onehot, M, 1.0),
                   chebyshev._moments_plain(h5k, ab5, onehot, M, 1.0))
    record("cheb_moments", "kpm_ldos 5k B=64 M=512", err, lambda: chebyshev.moments(h5k, ab5, onehot, M, 1.0),
           lambda: chebyshev._moments_plain(h5k, ab5, onehot, M, 1.0),
           cost_cheb(h5k, 64, steps, M * 64 * F64, 4), reps=3, tol=1e-10, profile=True, prof_reps=1)
    ht = torus.h
    abt = ab_of(ht, 0.98)
    left = torch.empty((ht.nsta, M, KPM_VECTORS), dtype=torch.complex128, device=device)
    left[:, 0] = chebyshev.phase_vectors(ht.nsta, KPM_VECTORS, 0, device)
    got = chebyshev.recursion(ht, abt, left.clone().permute(1, 0, 2))
    want = chebyshev._recursion_plain(ht, abt, left.clone().permute(1, 0, 2))
    record("cheb_moments", "kubo left block 1152 M=512 R=8", max_diff(torch, got, want),
           lambda: chebyshev.recursion(ht, abt, left.permute(1, 0, 2)),
           lambda: chebyshev._recursion_plain(ht, abt, left.permute(1, 0, 2)),
           cost_cheb(ht, KPM_VECTORS, M - 1, (M - 1) * ht.nsta * KPM_VECTORS * C128), reps=3,
           scale=float(want.abs().max()), tol=1e-10, profile=True, prof_reps=1)

    # kernel 10: one term (order 3, one step) and the whole evolve call at
    # 90k x B 1 (20 steps of order 58)
    ab = ab_of(h90, 1.0)
    a, b = float(ab[0]), float(ab[1])
    dt = float(EVOLVE_TIMES[1] - EVOLVE_TIMES[0])

    def coef(order):
        from scipy.special import jv

        nn = np.arange(order)
        c = (2.0 - (nn == 0)) * (-1.0j) ** nn * jv(nn, a * dt) * np.exp(-1.0j * b * dt)
        return torch.as_tensor(c).to(device)

    psi = block((N90, 1))
    psi /= torch.linalg.vector_norm(psi)
    c3 = coef(3)
    err = max_diff(torch, chebyshev.evolve(h90, ab, c3, psi, 1), chebyshev._evolve_plain(h90, ab, c3, psi, 1))
    record("cheb_evolve", "one term 90k B=1", err, lambda: chebyshev.evolve(h90, ab, c3, psi, 1),
           lambda: chebyshev._evolve_plain(h90, ab, c3, psi, 1), cost_cheb_evolve(h90, 1, 3, 1))
    order = dynamics._cheb_order(a, dt)
    cM = coef(order)
    nsteps = len(EVOLVE_TIMES)
    p0 = torch.zeros((N90, 1), dtype=torch.complex128, device=device)
    p0[N90 // 2] = 1.0
    err = max_diff(torch, chebyshev.evolve(h90, ab, cM, p0, nsteps), chebyshev._evolve_plain(h90, ab, cM, p0, nsteps))
    record("cheb_evolve", "evolve 90k 20 steps order %d" % order, err,
           lambda: chebyshev.evolve(h90, ab, cM, p0, nsteps),
           lambda: chebyshev._evolve_plain(h90, ab, cM, p0, nsteps),
           cost_cheb_evolve(h90, 1, order, nsteps), True, reps=3, tol=1e-10, prof_reps=1, prof_plain=False)

    # the other main-path shapes, held once
    from pythtb_tpu_torch.ops import eigh, hamiltonian, solver

    # v_b x at R 8 and 2 (dirs (0, 1): v_b is velocity[1]), v_a on the left block at R 2
    for d, B in ((1, KPM_VECTORS), (1, 2), (0, KPM_MOMENTS * 2)):
        h = torus.velocity[d]
        x = block((h.nsta, B))
        held("ell_matvec", "kubo velocity %d N=1152 B=%d" % (d, B),
             max_diff(torch, matvec.matvec(h, x), matvec._matvec_plain(h, x)))
    for R in (KPM_VECTORS, 2):  # the Kubo right block (M, N, R) (timed at R 8) and the R 2 left block
        phi = torch.empty((M, ht.nsta, R), dtype=torch.complex128, device=device)
        phi[0] = block((ht.nsta, R))
        want = chebyshev._recursion_plain(ht, abt, phi.clone())
        err = max_diff(torch, chebyshev.recursion(ht, abt, phi.clone()), want)
        if R == KPM_VECTORS:
            record("cheb_moments", "kubo right block 1152 M=512 R=%d" % R, err,
                   lambda: chebyshev.recursion(ht, abt, phi), lambda: chebyshev._recursion_plain(ht, abt, phi),
                   cost_cheb(ht, R, M - 1, (M - 1) * ht.nsta * R * C128), reps=3, scale=float(want.abs().max()),
                   tol=1e-10)
        else:
            held("cheb_moments", "kubo right block 1152 M=512 R=%d" % R, err, 1e-10, float(want.abs().max()))
        lft = torch.empty((ht.nsta, M, R), dtype=torch.complex128, device=device)
        lft[:, 0] = chebyshev.phase_vectors(ht.nsta, R, 2, device)
        want = chebyshev._recursion_plain(ht, abt, lft.clone().permute(1, 0, 2))
        held("cheb_moments", "kubo left block 1152 M=512 R=%d" % R,
             max_diff(torch, chebyshev.recursion(ht, abt, lft.clone().permute(1, 0, 2)), want),
             1e-10, float(want.abs().max()))
    ab = ab_of(h90, 0.98)
    x0 = chebyshev.phase_vectors(N90, 2, 0, device)
    held("cheb_moments", "kpm_dos 90k M=128 R=2",
         max_diff(torch, chebyshev.moments(h90, ab, x0, 128, float(N90)),
                  chebyshev._moments_plain(h90, ab, x0, 128, float(N90))), 1e-10, N90)
    held("cheb_moments", "kpm_ldos 5k B=8 M=128",
         max_diff(torch, chebyshev.moments(h5k, ab5, onehot[:, ::8].contiguous(), 128, 1.0),
                  chebyshev._moments_plain(h5k, ab5, onehot[:, ::8].contiguous(), 128, 1.0)), 1e-10)
    # the seeded evolve of phase 4: 5k flake, times from 0.2 in steps of 0.4
    ab5e = ab_of(h5k, 1.0)
    a5, b5 = float(ab5e[0]), float(ab5e[1])

    def coef5(step):
        from scipy.special import jv

        nn = np.arange(dynamics._cheb_order(a5, step))
        return torch.as_tensor((2.0 - (nn == 0)) * (-1.0j) ** nn * jv(nn, a5 * step)
                               * np.exp(-1.0j * b5 * step)).to(device)

    p5 = torch.zeros((h5k.nsta, 1), dtype=torch.complex128, device=device)
    p5[h5k.nsta // 2] = 1.0
    c, cs = coef5(0.4), coef5(-0.2)
    want = chebyshev._evolve_plain(h5k, ab5e, c, chebyshev._evolve_plain(h5k, ab5e, cs, p5, 1)[0], 8)
    held("cheb_evolve", "seeded evolve 5k B=1, 8 steps",
         max_diff(torch, dynamics._cheb_evolve(h5k, ab5e, c, p5, 8, cs), want), 1e-10)
    # kernels 1 and 2 in quench_echo: the SSH chain on its 400-point grid
    k400 = solver.device_uniform_grid((400,), (0.0,), device)
    for delta in (0.6, -0.6):
        data = pt.models.ssh(delta=delta)._get_finalized()
        H = hamiltonian.assemble(data, k400)
        held("assemble", "ssh quench nk=400 delta=%g" % delta, max_diff(torch, H, hamiltonian._assemble_plain(data, k400)))
        w, v = eigh.eig2(H)
        wp, vp = eigh._eig2_plain(H)
        held("eig2", "ssh quench B=400 delta=%g" % delta, max(max_diff(torch, w, wp), max_diff(torch, v, vp)))


# -- the fourth slice: interior and lowest eigensolvers, markers, surfaces -------

TBG_KPTS = ((0.0, 0.0), (1.0 / 3.0, 2.0 / 3.0), (0.5, 0.5))  # Gamma, K, M
# x64 pins of tbg_magic_angle_flatband_11k (tools/bench_suite.py), meV from E_D
TBG_PINS_MEV = np.array([[-1.216, -1.185, 0.035, 0.035], [11.992, 12.038, 12.038, 12.078],
                         [10.754, 10.789, 13.241, 13.256]]).T
ARC_K = np.stack(np.meshgrid(np.linspace(-0.5, 0.5, 101), np.linspace(0.0, 1.0, 101), indexing="ij"),
                 -1).reshape(-1, 2)  # weyl_fermi_arc_10201px


def dirac_energy(pt):
    """E_D: the Slater-Koster monolayer's Dirac energy at K."""
    return cached("e_dirac", lambda: float(pt.models.sk_graphene().solve_all(np.array([[2 / 3, 1 / 3]]))[:, 0].mean()))


def tbg(pt, m):
    return cached(("tbg", m), lambda: pt.models.tbg(m))


def lowest_flake(pt):
    """The 60 x 60 Peierls square flake (flux 1/9) of solve_lowest_3600_sites."""
    return cached("lowest_flake", lambda: pt.magnetic.peierls_model(
        pt.models.square().cut_piece(60, 0), 1.0 / 9.0, dirs=(0, 1)).cut_piece(60, 1))


def penrose608(pt):
    """penrose_chern_marker_608sites: the radius-12 Penrose patch at flux 0.1,
    its tiling and vertex areas."""
    def build():
        m, til = pt.models.penrose(12.0, return_tiling=True)
        return pt.magnetic.peierls_model(m, 0.1, dirs=(0, 1)), til

    return cached("penrose608", build)


def km784(pt):
    """spin_marker_km14x14_784states: the 14 x 14 Kane-Mele flake, Rashba on."""
    return cached("km784", lambda: pt.models.kane_mele(rashba=0.25).cut_piece(14, 0).cut_piece(14, 1))


def bott_torus(pt):
    """bott_index_512_sites: the 16 x 16 Haldane torus, W = 2, seed 1, on the
    current device."""
    from pythtb_tpu_torch import config

    return cached(("bott_torus", str(config.device())), lambda: pt.realspace.torus_sample(
        pt.models.haldane(), (16, 16), onsite_disorder=2.0, seed=1))


def slice4_kernels(torch, pt, device, rng, record, held):
    """Phase 3 for kernels 11 and 12 and kernel 1's one-sided mode at the
    fourth slice's main-path shapes, and the further shapes that path gives
    kernels 1, 6 and 8 (held once, or timed where PERF.md asks for it)."""
    from pythtb_tpu_torch import flows, realspace, surface
    from pythtb_tpu_torch.ops import _kernels, chebyshev, hamiltonian, matvec, position

    def block(shape):
        z = rng.normal(size=shape) + 1j * rng.normal(size=shape)
        return torch.as_tensor(z).to(device)

    def rel_err(got, want):
        return max_diff(torch, got, want), max(1.0, float(want.abs().max()))

    # kernel 11: the TBG m=30 tables at K, B 12, Gaussian windows of degree
    # 512 (timed) and 6,144 (the cap, held); then a spinful table
    e_d = dirac_energy(pt)
    hK = matvec.sparse_h_k(tbg(pt, 30), TBG_KPTS[1])
    D = hK.cols.shape[1]

    def window(h, deg):
        lo, hi = h.window
        a, b = 0.5 * (hi - lo) / 0.98 + 1e-12, 0.5 * (hi + lo)
        coef = flows._gaussian_cheb_coef((e_d - b) / a, 4.0 / deg, deg)
        return (torch.tensor([a, b], dtype=torch.float64, device=device),
                torch.as_tensor(coef).to(device))

    X = block((hK.nsta, 12))
    ab, c512 = window(hK, 512)
    got = chebyshev.filter(hK, ab, c512, X)
    err, scale = rel_err(got, chebyshev._filter_plain(hK, ab, c512, X))
    record("cheb_filter", "tbg m=30 K N=%d D=%d B=12 deg 512" % (hK.nsta, D), err,
           lambda: chebyshev.filter(hK, ab, c512, X), lambda: chebyshev._filter_plain(hK, ab, c512, X),
           cost_cheb_filter(hK, 12, 512), True, reps=3, scale=scale, tol=1e-10, prof_reps=1)
    # the tables left in device memory (the plan's shared memory cut to the
    # on-chip state): the same bits, timed beside the chosen placement
    sms, smem = _kernels.card(device)
    plan = chebyshev._grid_plan(hK.norb, hK.nspin, 12, D, sms, smem, "filter")
    room = 2 * -(-hK.norb // plan.blocks) * 12 * 16
    print("  %-15s %-34s plan %s; tables in device memory: %s"
          % ("cheb_filter", "tbg m=30 K B=12", plan,
             chebyshev._grid_plan(hK.norb, hK.nspin, 12, D, sms, room, "filter")))
    check(torch.equal(chebyshev._filter(hK, ab, c512, X, room), got),
          "kernel 11: the tables in device memory gave other bits at the tbg shape")
    print("  %-15s %-34s tables in device memory: device %.1f us (CUDA events)"
          % ("cheb_filter", "tbg m=30 K B=12 deg 512", event_us(torch, lambda: chebyshev._filter(hK, ab, c512, X, room))))
    _, c6k = window(hK, 6144)
    err, scale = rel_err(chebyshev.filter(hK, ab, c6k, X), chebyshev._filter_plain(hK, ab, c6k, X))
    held("cheb_filter", "tbg m=30 K B=12 deg 6144", err, 1e-10, scale)
    ms = cuda_ms(torch, lambda: chebyshev.filter(hK, ab, c6k, X), 3)
    print("  %-15s %-34s kernel %.4f ms (%.2f us a term)  bound %.5f ms (%s)"
          % ("cheb_filter", "tbg m=30 K B=12 deg 6144", ms, 1e3 * ms / 6143, *cost_cheb_filter(hK, 12, 6144)))
    hs = matvec.sparse_h_k(pt.models.kane_mele().make_supercell([[20, 0], [0, 20]]), [0.13, -0.31])
    Xs = block((hs.nsta, 12))
    abs_, cs = window(hs, 512)
    err, scale = rel_err(chebyshev.filter(hs, abs_, cs, Xs), chebyshev._filter_plain(hs, abs_, cs, Xs))
    record("cheb_filter", "kane_mele 20x20 nspin2 N=%d B=12 deg 512" % hs.nsta, err,
           lambda: chebyshev.filter(hs, abs_, cs, Xs), lambda: chebyshev._filter_plain(hs, abs_, cs, Xs),
           cost_cheb_filter(hs, 12, 512), reps=3, scale=scale, tol=1e-10)
    # kernel 8 at the slice's other shapes: H Q of a TBG round, the LOBPCG
    # blocks, the Bott densify on the identity
    for key, h, B in (("tbg m=30 K H.Q B=12", hK, 12),
                      ("lowest flake N=3600 B=30", matvec.sparse_h(lowest_flake(pt)), 30),
                      ("lowest flake N=3600 B=10", matvec.sparse_h(lowest_flake(pt)), 10)):
        x = block((h.nsta, B))
        held("ell_matvec", key, max_diff(torch, matvec.matvec(h, x), matvec._matvec_plain(h, x)))
    ht = bott_torus(pt).h
    eye = torch.eye(ht.nsta, dtype=torch.complex128, device=device)
    held("ell_matvec", "bott densify N=512 B=512 (identity)",
         max_diff(torch, realspace._dense_from_ell(ht), matvec._matvec_plain(ht, eye)))

    # kernel 12 and kernel 1 (both modes) at the Fermi-arc shape (E 1, K
    # 10,201, S 2) and at the Kane-Mele ribbon (E 8, K 101, S 4)
    kt = torch.as_tensor(ARC_K).to(device)
    kr = torch.as_tensor(np.linspace(0.0, 1.0, 101)[:, None]).to(device)
    for key, model, d, k, energies, eta, main in (
            ("weyl arc E=1 K=10201 S=2", pt.models.weyl(), 0, kt, np.array([0.0]), 0.02, True),
            ("kane_mele ribbon E=8 K=101 S=4", pt.models.kane_mele(), 1, kr, np.linspace(-0.5, 0.5, 8), 0.03,
             False)):
        d00, d01, _ = surface._layer_blocks(model, d)
        H00 = hamiltonian.assemble(d00, k)
        held("assemble", key + " H00", max_diff(torch, H00, hamiltonian._assemble_plain(d00, k)))
        H01 = hamiltonian.assemble_one_sided(d01, k)
        record("assemble_one_sided", key + " H01", max_diff(torch, H01, hamiltonian._one_sided_plain(d01, k)),
               lambda: hamiltonian.assemble_one_sided(d01, k), lambda: hamiltonian._one_sided_plain(d01, k),
               cost_one_sided(d01, k.shape[0]), main)
        w = torch.as_tensor(energies + 1j * eta).to(device)
        got, want = surface.decimate(H00, H01, w, 35), surface._decimate_plain(H00, H01, w, 35)
        err = max(max_diff(torch, g, p) / max(1.0, float(p.abs().max())) for g, p in zip(got, want))
        record("decimation", key + " iters 35", err, lambda: surface.decimate(H00, H01, w, 35),
               lambda: surface._decimate_plain(H00, H01, w, 35),
               cost_decimation(k.shape[0], len(energies), H00.shape[-1], 35), main)
    # kernel 12's block path at its largest layer (S 40, the shared memory
    # opted in), on random blocks whose decimation converges
    S = surface.DECIMATION_MAX_S
    a = rng.normal(size=(16, S, S)) + 1j * rng.normal(size=(16, S, S))
    H00 = torch.as_tensor(np.ascontiguousarray(a + np.conj(np.swapaxes(a, -1, -2)))).to(device)
    H01 = 0.3 * block((16, S, S))
    w = torch.as_tensor(np.array([-1.0, 0.5]) + 0.05j).to(device)
    got, want = surface.decimate(H00, H01, w, 35), surface._decimate_plain(H00, H01, w, 35)
    err = max(max_diff(torch, g, p) / max(1.0, float(p.abs().max())) for g, p in zip(got, want))
    record("decimation", "random E=2 K=16 S=%d iters 35" % S, err, lambda: surface.decimate(H00, H01, w, 35),
           lambda: surface._decimate_plain(H00, H01, w, 35), cost_decimation(16, 2, S, 35), reps=5)

    # kernels 1 (dim_k 0) and 6 at the marker shapes: the Penrose patch
    # (nocc 50 of 608), the Kane-Mele flake (nocc 392 of 784, and a sector
    # of 196), timed against the one einsum
    k0 = torch.zeros((1, 0), dtype=torch.float64, device=device)
    for key, model, nocc in (("penrose 608 nocc 50", penrose608(pt)[0], 50),
                             ("kane_mele 784 nocc 392", km784(pt), 392)):
        data = model._get_finalized()
        held("assemble", key + " dim_k 0",
             max_diff(torch, hamiltonian.assemble(data, k0), hamiltonian._assemble_plain(data, k0)))
        W = realspace._device_states(model, nocc)[1].contiguous()
        X, Y, _ = realspace._positions(model, device)
        for sub, Wi in (("", W), (" sector 196", W[: nocc // 2].contiguous()))[: 1 + (nocc > 100)]:
            wi = Wi[None]
            S, F = Wi.shape
            err = max(max_diff(torch, position.xmat(wi, p), position._xmat_plain(wi, p)) for p in (X, Y, X * Y))
            record("position", "marker %s%s B=1 S=%d F=%d" % (key, sub, S, F), err,
                   lambda: position.xmat(wi, X), lambda: position._xmat_plain(wi, X), cost_position(1, S, F),
                   library_ms=cuda_ms(torch, lambda: torch.einsum("nf,f,mf->nm", Wi.conj(), X.to(Wi.dtype), Wi)),
                   reps=5, profile=True, prof_reps=5)


def slice4_path(pt, where, reference):
    """The six rows of tools/bench_suite.py that the fourth slice carries,
    through their public calls, with the rows' checks and the tighter
    float64 ones.  The CPU reference (``reference``) leaves out the m = 30
    moire cell (hours of the plain filter on a host CPU) and runs the rest,
    tbg(8) included, for the comparison."""
    out = {}

    def timed(fn, *args, **kwargs):
        t0 = time.perf_counter()
        result = fn(*args, **kwargs)
        return result, time.perf_counter() - t0

    # tbg_magic_angle_flatband_11k: the four states nearest E_D at Gamma, K, M
    e_d = dirac_energy(pt)

    def middle4(m):
        return np.stack([pt.flows.solve_window(tbg(pt, m), 4, e_d, k_point=np.asarray(kf), block=12, seed=0)
                         for kf in TBG_KPTS], axis=-1)  # (4, nk)

    out["tbg8"], sec = timed(middle4, 8)
    print("  %s tbg m=8 (%d orbitals) solve_window at Gamma, K, M  [%.2f s]" % (where, tbg(pt, 8)._norb, sec))
    if not reference:
        # kernel 11: one launch a filter round (flows._window_round counted)
        from pythtb_tpu_torch.ops import _kernels

        rounds, inner = [0], pt.flows._window_round

        def counted(*args):
            rounds[0] += 1
            return inner(*args)

        before = _kernels.LAUNCHES["cheb_filter"]
        pt.flows._window_round = counted
        try:
            mid30, sec = timed(middle4, 30)
        finally:
            pt.flows._window_round = inner
        out["tbg30_filter"] = {"rounds": rounds[0], "launches": _kernels.LAUNCHES["cheb_filter"] - before}
        bw30 = float(mid30.max() - mid30.min())
        bw8 = float(out["tbg8"].max() - out["tbg8"].min())
        dev = float(np.abs(1e3 * (mid30 - e_d) - TBG_PINS_MEV).max())
        print("  %s tbg m=30 (%d orbitals, %.4f deg): flat-band spread %.3f meV (m=8: %.1f meV); worst "
              "state vs x64 pins %.5f meV  [%.2f s]"
              % (where, tbg(pt, 30)._norb, pt.models.tbg_angle(30), 1e3 * bw30, 1e3 * bw8, dev, sec))
        print("  %s tbg m=30 states (meV from E_D; columns Gamma, K, M):\n%s"
              % (where, np.array2string(1e3 * (mid30 - e_d), precision=4)))
        check(bw30 < 0.025 and bw30 < 0.1 * bw8, "tbg flat-band spread %.4f eV (m=8 %.4f eV)" % (bw30, bw8))
        check(dev < 0.01, "tbg m=30 states off the x64 pins by %.5f meV" % dev)

    # solve_lowest_3600_sites
    fl = lowest_flake(pt)
    out["lowest"], sec = timed(pt.flows.solve_lowest, fl, 10, max_iters=300, tol=1e-7)
    print("  %s solve_lowest %d sites k=10: E0 %.6f  [%.2f s]" % (where, fl._nsta, out["lowest"][0], sec))
    check(abs(out["lowest"][0] + 3.3616) < 5e-3, "solve_lowest E0 %.6f is not -3.3616" % out["lowest"][0])

    # penrose_chern_marker_608sites
    mb, til = penrose608(pt)
    r = np.linalg.norm(til["verts"], axis=1)
    owned = pt.models.vertex_areas(til)
    out["penrose_marker"], sec = timed(pt.realspace.chern_marker, mb, nocc=50)
    C = float(out["penrose_marker"][r < 5.0].sum() / owned[r < 5.0].sum())
    print("  %s chern_marker penrose %d sites nocc 50: bulk C %.6f  [%.2f s]" % (where, mb._norb, C, sec))
    check(abs(C - 0.992004) < 1e-4, "Penrose bulk marker %.6f is not 0.992004" % C)

    # spin_marker_km14x14_784states
    fk = km784(pt)
    res, sec = timed(pt.realspace.spin_chern_marker, fk, nocc=fk._nsta // 2)
    pp = np.asarray(fk._orb, float) @ np.asarray(fk._lat, float)
    rr = np.linalg.norm(pp - pp.mean(axis=0), axis=1)
    cp = 2.0 * float(res["c_plus"][rr < 0.3 * rr.max()].mean())
    out["spin_marker"] = np.concatenate([res["c_plus"], res["c_minus"], [res["gap"]]])
    print("  %s spin_chern_marker kane_mele %d states: c+ %.6f, gap %.6f  [%.2f s]"
          % (where, fk._nsta, cp, res["gap"], sec))
    check(abs(cp + 0.983066) < 1e-4 and abs(res["gap"] - 1.764531) < 1e-5,
          "spin marker c+ %.6f / gap %.6f off -0.983066 / 1.764531" % (cp, res["gap"]))

    # bott_index_512_sites
    bott, sec = timed(pt.realspace.bott_index, bott_torus(pt), nocc=256)
    out["bott"] = np.array([bott])
    print("  %s bott_index 16x16 torus (512 sites, W=2): %.12f  [%.2f s]" % (where, bott, sec))
    check(abs(bott + 1.0) < 5e-2, "Bott index %.6f is not -1" % bott)

    # weyl_fermi_arc_10201px
    A, sec = timed(pt.surface.spectral_function, pt.models.weyl(), 0, k_par=ARC_K, energies=np.array([0.0]),
                   eta=0.02)
    arc = A.reshape(101, 101)
    out["arc"] = A
    print("  %s spectral_function weyl arc 10201 px: arc[50,50] %.4f, arc[5,5] %.3e  [%.2f s]"
          % (where, arc[50, 50], arc[5, 5], sec))
    check(np.isfinite(arc).all() and arc[50, 50] > 50 * arc[5, 5], "no Fermi arc: %.3e vs %.3e"
          % (arc[50, 50], arc[5, 5]))
    return out


LOWEST_TOL = 5e-3  # the row's own E0 limit, applied to each of the ten values


def composite_bounds(torch, pt, card):
    """Bounds of two torch compositions that have no kernel of their own,
    by this file's convention (bytes over 3.35 TB/s or float64 operations
    over 34 TFLOP/s, whichever is larger), beside their device time a call
    (profiler):

    * ``flows.solve_lowest`` (3,600 sites, k 10): each LOBPCG iteration
      applies H to 3k and to k columns (two kernel-8 launches, counted in
      this run: 1 + 2 per iteration) and does ~38 N k^2 complex
      multiply-adds of GEMMs (the 3k Gram and Rayleigh-Ritz, the X and P
      updates, two projections and orthonormalizations), 8 operations
      each, plus a 3k-state eigh (36 (3k)^3);
    * the markers (``realspace.chern_marker`` Penrose 608, nocc 50;
      ``spin_chern_marker`` Kane-Mele 784, nocc 392 split into two
      196-state sectors): H by kernel 1 (n^2 written), one dense eigh
      with vectors (36 n^3), for the spin marker the projected S_z (8 n^2
      S + 8 S^2 n), its eigh (36 S^3) and the two sector bases (8 S^2 n),
      then per marker core three kernel-6 products (cost_position), K = C
      - A B (8 S^3) and the trace against W (8 S^2 n)."""
    from pythtb_tpu_torch.ops import _kernels, matvec

    fl = lowest_flake(pt)
    h = matvec.sparse_h(fl)
    N, k = h.nsta, 10
    before = _kernels.LAUNCHES["ell_matvec"]
    pt.flows.solve_lowest(fl, k, max_iters=300, tol=1e-7)
    iters = (_kernels.LAUNCHES["ell_matvec"] - before - 1) // 2
    t_mv = cost_ell_matvec(h, 3 * k)[0] + cost_ell_matvec(h, k)[0]
    t_dense = bound(0, 8 * 38 * N * k * k + 36 * (3 * k) ** 3)[0]
    out = {"solve_lowest": (iters, iters * (t_mv + t_dense))}
    print("  bound of flows.solve_lowest %d sites k %d: %d LOBPCG iterations x (kernel 8 %.5f ms + GEMMs and eigh "
          "%.5f ms) = %.4f ms (%s)" % (N, k, iters, t_mv, t_dense, out["solve_lowest"][1], card))

    def pos_ops(S, F):
        return S * (S + 1) // 2 * F * 8

    for key, n, nocc, parts in (("chern_marker penrose 608 nocc 50", 608, 50, [(50, 608)]),
                                ("spin_chern_marker kane_mele 784 nocc 392", 784, 392, [(196, 784), (196, 784)])):
        nbytes = 2 * n * n * C128 + sum(S * n * C128 for S, _ in parts)
        sector = 8 * n * n * nocc + 16 * nocc * nocc * n + 36 * nocc**3 if len(parts) > 1 else 0
        ops = 36 * n**3 + sector + sum(3 * pos_ops(S, F) + 8 * S**3 + 8 * S * S * F for S, F in parts)
        out[key] = bound(nbytes, ops)
        print("  bound of realspace.%s: %.4f ms (%s): dense eigh 36 n^3, three kernel-6 products a marker, "
              "K = C - A B and its trace (%s)" % (key, out[key][0], out[key][1], card))
    return out


def more_bounds(torch, pt, card):
    """Bounds of torch compositions of earlier slices that PERF.md section 6
    lists without one, by this file's convention (cost_* helpers, the
    shapes of this run's calls):

    * ``meanfield.hartree_fock`` 6-ring U 4: per iteration two 6 x 6
      eigh with vectors (cost_eigh) and the densities (12 x 6 x 8);
      ``bcs_gap`` square 36^2: per iteration one 2 x 2 BdG eigh a k-point
      (cost_eig2) and the gap sum (10 a k-point); times this run's
      iteration counts;
    * the silicon MLWF's refinement (``wannier._build*``): kernel 1 and an
      8-state eigh at 4,096 k-points, the 8 x 4 projections (8 x 8 x 4
      x 8), their 4 x 4 polar factors (36 x 4^3) and B(k) (4 x 4 x 8 x 8)
      a k-point, and the H(R) transform (4,096 R x 4,096 k x 16 x 8);
    * ``unfold.unfold_bands`` graphene 5 x 5 (kernel 1, a 50-state eigh at
      121 k-points, the orbital-group sums 50 x 50 x 8 a k-point) and
      ``entanglement.entanglement_flow`` Haldane L 20 (kernel 1, a
      40-state eigh at 61 k-points, the 20 x 20 correlation eigvalsh);
    * one SMV iteration of ``wannier._smv_disentangle`` at the silicon
      coarse grid's shape (512 k, 8 b, 8 window states, 4 functions): an
      8-state eigh and four (8 x 8 x 4) einsums a (k, b), 8 each;
    * ``dmft._assemble_ri_jit``: kernel 1 at the ARPES row, B 1,001, 8 x 8
      (cost_assemble);
    * ``fermisurface._grid_evals`` at the square lattice's 301^2 grid
      (kernel 1 and a one-state eigh a k-point) and
      ``geometry._kp_tensors`` at one k of graphene (kernel 1, a 2-state
      eigh, kernel 15's dH and d2H and their band-basis einsums).

    A composition's bound is the sum of its parts' bounds ("parts"), each
    the larger of its bytes and its operations."""
    import warnings

    out = {}
    ring6 = ring(pt, S9["hf_L"])
    hf = pt.meanfield.hartree_fock(ring6, 4.0, 6.0, temperature=2e-3, stagger=0.4, seed=1, max_iters=4000)
    b_eigh = cost_eigh(2, 6)[0] + bound(0, 12 * 6 * 8)[0]
    out["meanfield.hartree_fock 6-ring U 4"] = (hf["iters"] * b_eigh, "parts")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        bcs = pt.meanfield.bcs_gap(pt.models.square(t=-1.0), 2.0, -0.4, nk=(36, 36), temperature=0.01,
                                   max_iters=4000)
    t_bcs = cost_eig2(36 * 36)[0] + bound(0, 36 * 36 * 10)[0]
    out["meanfield.bcs_gap square 36^2 g 2"] = (bcs["iters"] * t_bcs, "parts")
    si = silicon_model(pt)._get_finalized()
    B, NR = 16**3, 16**3
    t_si = (cost_assemble(si, B)[0] + cost_eigh(B, 8)[0]
            + bound(0, B * (8 * 8 * 4 * 8 + 36 * 4**3 + 4 * 4 * 8 * 8) + NR * B * 16 * 8)[0])
    out["wannier._build* silicon 16^3 refinement"] = (t_si, "parts")
    g5 = pt.models.graphene().make_supercell(np.diag([5, 5]))._get_finalized()
    out["unfold.unfold_bands graphene 5x5 121 k"] = (
        cost_assemble(g5, 121)[0] + cost_eigh(121, 50)[0] + bound(0, 121 * 50 * 50 * 8)[0], "parts")
    hs = pt.models.haldane().cut_piece(S8["ent_L"], 1)._get_finalized()
    out["entanglement.entanglement_flow haldane L 20 61 k"] = (
        cost_assemble(hs, 61)[0] + cost_eigh(61, 40)[0] + cost_eigh(61, 20, vectors=False)[0], "parts")
    out["wannier._smv_disentangle one iteration, 512 k x 8 b, 8 states, nw 4"] = (
        cost_eigh(512, 8)[0] + bound(0, 512 * 8 * 4 * 8 * 8 * 4 * 8)[0], "parts")
    out["dmft._assemble_ri_jit ARPES B 1001 8x8"] = cost_assemble(arpes_model(pt)._get_finalized(), 1001)
    sq = pt.models.square(t=-1.0)._get_finalized()
    out["fermisurface._grid_evals square 301^2"] = (
        cost_assemble(sq, S10["fs_nk"] ** 2)[0] + cost_eigh(S10["fs_nk"] ** 2, 1, vectors=False)[0], "parts")
    gr = pt.models.graphene()._get_finalized()
    out["geometry._kp_tensors graphene K, one k"] = (
        cost_assemble(gr, 1)[0] + cost_eigh(1, 2)[0] + cost_assemble_deriv(gr, 1, 1)[0]
        + cost_assemble_deriv(gr, 1, 2)[0] + bound(0, (2 + 4) * 2 * 2 * 2 * 8)[0], "parts")
    for key, (t, by) in out.items():
        print("  bound of %s: %.4e ms (%s) (%s)" % (key, t, by, card))
    return out


def check_lowest_bound(torch, pt, low, device):
    """The ten Ritz values of solve_lowest against torch.linalg.eigvalsh of
    the same dense H on the card, from both sides: none below its exact
    level (Cauchy interlacing: a Ritz value is an upper bound), none above
    it by LOWEST_TOL or more.  The flux-1/9 flake's lowest Landau level
    holds ~400 levels within 1e-3, so 300 LOBPCG iterations at tol 1e-7
    stop short of 1e-6 (the JAX package's own result is off by up to
    7.6e-3); the distances are printed."""
    from pythtb_tpu_torch.ops import matvec

    H = torch.as_tensor(matvec.to_dense(matvec.sparse_h(lowest_flake(pt)))).to(device)
    ev = torch.linalg.eigvalsh(H).cpu().numpy()[:10]
    gap = low - ev
    print("  solve_lowest vs torch.linalg.eigvalsh of the dense H on the card: Ritz - exact in [%.3e, %.3e] "
          "(limit %.0e)" % (gap.min(), gap.max(), LOWEST_TOL))
    check(gap.min() > -1e-10, "solve_lowest value below the exact eigenvalue by %.3e" % -gap.min())
    check(gap.max() < LOWEST_TOL, "solve_lowest value above the exact eigenvalue by %.3e" % gap.max())


# -- the fifth slice: velocity operators and the response family ----------------

# grid sizes of the nine rows of tools/bench_suite.py (AHC and thermal Hall,
# orbital magnetization, optics and BN shift current, Boltzmann, Edelstein,
# QGT, Rice-Mele), and of the smaller calls the CPU reference repeats
S5 = {"hall": 101, "orbmag": 121, "optical": 161, "boltzmann": 512, "edelstein": 256, "qgt": 72,
      "rice_mele": 2001, "cpu": 64}
AHC_EFS = np.linspace(-4.0, 4.0, 81)
THERMAL_MUS = np.linspace(-3.5, 3.5, 81)
OPTICAL_W = np.linspace(0.0, 6.0, 121)
SHIFT_W = np.linspace(0.5, 4.0, 121)
BT_MUS = np.linspace(-4.0, 4.0, 201)
EDEL_MUS = np.linspace(-4.2, 4.2, 201)


def rice_mele(pt):
    """shift_current_rice_mele_2001k's polar chain."""
    m = pt.tb_model(1, 1, lat=[[1.0]], orb=[[0.0], [0.5]])
    m.set_onsite([0.4, -0.4])
    m.set_hop(1.3, 0, 1, [0])
    m.set_hop(0.7, 1, 0, [1])
    return m


def rashba(pt):
    """edelstein_rashba_201mu_256grid's square-lattice Rashba model."""
    sy = np.array([[0, -1j], [1j, 0]]) / 2
    sx = np.array([[0, 1], [1, 0]], dtype=complex) / 2
    m = pt.tb_model(2, 2, np.eye(2), [[0.0, 0.0]], nspin=2)
    m.set_hop(-1.0 * np.eye(2) - 1j * 0.6 * sy, 0, 0, [1, 0])
    m.set_hop(-1.0 * np.eye(2) + 1j * 0.6 * sx, 0, 0, [0, 1])
    return m


def orbmag_haldane(pt):
    """orbital_magnetization_121x121's Haldane model."""
    return pt.models.haldane(delta=0.2, t2=0.15 * np.exp(0.7j))


def slice5_kernels(torch, pt, device, record, held):
    """Phase 3 for kernels 15, 16 and 17 at the fifth slice's main-path
    shapes, on the inputs that path builds: kernel 15 at 1e-12 (relative
    to max(1, |dH|)), kernels 16 and 17 (sums of up to 5e5 terms in another
    order) at 1e-10 relative."""
    from pythtb_tpu_torch import boltzmann, flows, optical
    from pythtb_tpu_torch.ops import fermi_sweep as fs
    from pythtb_tpu_torch.ops import hamiltonian, solver

    hal = pt.models.haldane()
    hal_d = hal._get_finalized()
    lat = np.asarray(hal._lat, dtype=np.float64)

    def grid(model, n):
        data = model._get_finalized()
        nk = (n,) * data.dim_k
        return data, solver.device_uniform_grid(nk, np.zeros(data.dim_k), device)

    # kernel 15: every grid of the slice's rows; Boltzmann 512^2 (both
    # modes) and the spinful Edelstein grid timed
    nb, ne = S5["boltzmann"], S5["edelstein"]
    for key, model, n, orders, timed in (
            ("boltzmann haldane %d^2" % nb, hal, nb, (1, 2), True),
            ("edelstein rashba nspin2 %d^2" % ne, rashba(pt), ne, (1,), True),
            ("orbital mag haldane %d^2" % S5["orbmag"], orbmag_haldane(pt), S5["orbmag"], (1,), False),
            ("optical haldane %d^2" % S5["optical"], hal, S5["optical"], (1,), False),
            ("shift bn %d^2" % S5["optical"], pt.models.bn(), S5["optical"], (1, 2), False),
            ("qgt haldane %d^2" % S5["qgt"], hal, S5["qgt"], (1,), False),
            ("shift rice_mele %d" % S5["rice_mele"], rice_mele(pt), S5["rice_mele"], (1, 2), False)):
        data, k = grid(model, n)
        for order in orders:
            fn, plain = ((hamiltonian.assemble_dk, hamiltonian._assemble_dk_plain) if order == 1 else
                         (hamiltonian.assemble_d2k, hamiltonian._assemble_d2k_plain))
            want = plain(data, k)
            err, scale = max_diff(torch, fn(data, k), want), max(1.0, float(want.abs().max()))
            label = "%s B=%d %s" % (key, k.shape[0], "dk" if order == 1 else "d2k")
            record("assemble_dk", label, err, lambda: fn(data, k), lambda: plain(data, k),
                   cost_assemble_deriv(data, k.shape[0], order), order == 1 and model is hal and timed, scale=scale,
                   profile=timed, reps=REPS if timed else 5)
            del want

    # kernel 16: the optical row's Lehmann scan (Lorentzian), the BN and
    # Rice-Mele shift currents (Gaussian), on the weights those calls build
    no = S5["optical"]
    de, W, _ = optical._band_velocity_weights(hal_d, (no, no), (0,), (0.0, 0.0), lat)
    Wl = W.permute(1, 2, 0, 3).reshape(4, -1).contiguous()
    de = de.contiguous()
    bn = pt.models.bn()
    rm = rice_mele(pt)
    cases = [("optical lorentz", Wl, de, OPTICAL_W, 0.04, "lorentz", True)]
    for name, model, n, sigma in (("shift bn gauss", bn, no, 0.08),
                                  ("shift rice_mele gauss", rm, S5["rice_mele"], 0.06)):
        Wg, dg = optical._shift_weights(model._get_finalized(), (n,) * model._dim_k, [0], [1],
                                        np.asarray(model._lat, dtype=np.float64))
        cases.append((name, Wg, dg, SHIFT_W, sigma, "gauss", False))
    for name, Wt, det, w, width, mode, main in cases:
        om = torch.as_tensor(w).to(device)
        P, T = Wt.shape
        want = optical._spectral_sum_plain(Wt, det, om, width, mode)
        err = max_diff(torch, optical.spectral_sum(Wt, det, om, width, mode), want)
        lib = cuda_ms(torch, lambda: Wt @ optical._kernel_matrix(det, om, width, mode).to(Wt.dtype), 5)
        record("spectral_sum", "%s T=%d P=%d nw=%d" % (name, T, P, len(w)), err,
               lambda: optical.spectral_sum(Wt, det, om, width, mode),
               lambda: optical._spectral_sum_plain(Wt, det, om, width, mode),
               cost_spectral_sum(T, P, len(w), mode == "lorentz"), main, library_ms=lib,
               scale=float(want.abs().max()), tol=1e-10, profile=True)

    # kernel 17: the Hall-family sweeps on the per-band curvature of the
    # 101^2 grid (T 20,000), Boltzmann 512^2 (M 201, T 524,288, P 16, the
    # main shape) and Edelstein 256^2 (T 131,072, P 6); every weight kind
    nh = S5["hall"]
    data, (n0, n1), phases = flows._grid_inputs(hal, (nh, nh), "anomalous_hall")
    om_c, E_c = flows._band_curvature_grid(data, n0, n1, np.array([-0.5, -0.5]), phases)
    Ec = E_c.reshape(-1).contiguous()
    Gc = (om_c / (2.0 * np.pi)).reshape(1, -1).contiguous()
    data_b, kb = grid(hal, nb)
    Eb, Gb, jb, _ = boltzmann._bt_columns(data_b, kb, lat)
    data_e, ke = grid(rashba(pt), ne)
    Ee, Ge = boltzmann._edelstein_columns(data_e, ke, np.eye(2))
    cases = [
        ("ahc step", Ec, Gc, AHC_EFS, 0.0, "step", None, True, False),
        ("thermal hall c2", Ec, Gc, THERMAL_MUS, 0.15, "c2", None, True, False),
        ("nernst entropy", Ec, Gc, THERMAL_MUS, 0.15, "entropy", None, False, False),
        ("ahc fermi", Ec, Gc, AHC_EFS, 0.1, "fermi", None, False, False),
        ("boltzmann -df/de", Eb, Gb, BT_MUS, 0.05, "dfde", jb, True, True),
        ("boltzmann n_e fermi", Eb, torch.full_like(Gb[:1], 1.0 / kb.shape[0]), BT_MUS, 0.05, "fermi", None,
         False, False),
        ("edelstein -df/de", Ee, Ge, EDEL_MUS, 0.05, "dfde", None, True, False),
        ("dipole -df/de cosh form", Eb, Gb[:2], BT_MUS, 0.05, "dfde_cosh", None, False, False),
        ("transport distribution gauss", Eb, Gb[:4], BT_MUS, 0.05, "gauss", None, False, False),
    ]
    def library(E, G, mu_t, kt, jpow):
        """The -df/de sweep as one W @ K call a power of (E - mu), K formed:
        kernel 17's library yardstick."""
        d = E[None, :] - mu_t[:, None]
        e = torch.exp(-(d / kt).abs())
        K = e / ((1.0 + e) ** 2 * kt)
        out = torch.empty((mu_t.shape[0], G.shape[0]), dtype=G.dtype, device=device)
        for j in sorted(set(jpow)):
            cols = [p for p in range(G.shape[0]) if jpow[p] == j]
            out[:, cols] = (K * d**j) @ G[cols].T
        return out

    for name, E, G, mus, kt, kind, jpow, timed, main in cases:
        mu_t = torch.as_tensor(mus).to(device)
        want = fs._fermi_sweep_plain(E, G, mu_t, kt, kind, jpow or [0] * G.shape[0])
        got = fs.fermi_sweep(E, G, mu_t, kt, kind, jpow)
        err = max_diff(torch, got, want)
        label = "%s M=%d T=%d P=%d" % (name, len(mus), E.shape[0], G.shape[0])
        # the chunks' sums are added in a fixed order
        check(torch.equal(got, fs.fermi_sweep(E, G, mu_t, kt, kind, jpow)),
              "fermi_sweep %s: two calls differ in their bits" % label)
        scale = float(want.abs().max())
        lib = None
        if main:
            check(float((library(E, G, mu_t, kt, jpow) - want).abs().max()) <= 1e-10 * scale,
                  "kernel 17's library yardstick computes another function")
            lib = cuda_ms(torch, lambda: library(E, G, mu_t, kt, jpow), 5)
        record("fermi_sweep", label, err, lambda: fs.fermi_sweep(E, G, mu_t, kt, kind, jpow),
               lambda: fs._fermi_sweep_plain(E, G, mu_t, kt, kind, jpow or [0] * G.shape[0]),
               cost_fermi_sweep(E.shape[0], G.shape[0], len(mus), kind), main, scale=scale, tol=1e-10,
               reps=REPS if main else 5, profile=timed, library_ms=lib)


def slice5_path(pt, where, reference):
    """The nine rows of tools/bench_suite.py that the fifth slice carries,
    through their public calls, with each row's own pin.  The CPU reference
    (``reference``) runs the optics, BN shift, Boltzmann and Edelstein rows
    at 64^2 only (the card repeats those calls for the comparison) and the
    other five at full width."""
    out = {}

    def timed(fn, *args, **kwargs):
        t0 = time.perf_counter()
        result = fn(*args, **kwargs)
        return result, time.perf_counter() - t0

    hal = pt.models.haldane()
    nh, nc = S5["hall"], S5["cpu"]

    # anomalous_hall_81ef_101x101
    sxy, sec = timed(pt.flows.anomalous_hall, hal, AHC_EFS, nk=(nh, nh))
    i0 = int(np.argmin(np.abs(AHC_EFS)))
    out["ahc"] = sxy
    print("  %s anomalous_hall %dx%d, 81 E_F: sigma(0) %.6f, sigma(-4) %.3e  [%.2f s]"
          % (where, nh, nh, sxy[i0], sxy[0], sec))
    check(abs(abs(sxy[i0]) - 1.0) < 5e-3 and abs(sxy[0]) < 5e-3, "AHC staircase off: %.6f, %.3e" % (sxy[i0], sxy[0]))

    # thermal_hall_81mu_101x101
    th, sec = timed(pt.flows.thermal_hall, hal, THERMAL_MUS, 0.15, nk=(nh, nh))
    i0 = int(np.argmin(np.abs(THERMAL_MUS)))
    out["thermal_hall"] = th
    print("  %s thermal_hall %dx%d, 81 mu, kT 0.15: kappa(0) %.7f  [%.2f s]" % (where, nh, nh, th[i0], sec))
    check(abs(th[i0] + 3.0470865) < 2e-3, "thermal Hall kappa(0) %.7f is not -3.0470865" % th[i0])

    # orbital_magnetization_121x121
    n = S5["orbmag"]
    M, sec = timed(pt.flows.orbital_magnetization, orbmag_haldane(pt), [0], nk=(n, n))
    out["orbmag"] = np.array([M])
    print("  %s orbital_magnetization %dx%d: M %.8f  [%.2f s]" % (where, n, n, M, sec))
    check(abs(M - 0.0117) < 2e-4, "orbital magnetization %.6f is not 0.0117" % M)

    # optical_tensor_121w_161x161 (CPU: 64^2)
    n = S5["optical"]
    if not reference:
        sig, sec = timed(pt.optical.optical_conductivity, hal, OPTICAL_W, occ=[0], nk=(n, n), eta=0.04)
        print("  %s optical_conductivity %dx%d, 121 w: dc Re sigma_yx %.6f  [%.2f s]"
              % (where, n, n, sig[0, 1, 0].real, sec))
        check(np.isfinite(sig).all() and abs(sig[0, 1, 0].real + 1.0) < 2e-3,
              "dc Re sigma_yx %.6f is not -1" % sig[0, 1, 0].real)
    out["optical_cpu"], sec = timed(pt.optical.optical_conductivity, hal, OPTICAL_W, occ=[0], nk=(nc, nc), eta=0.04)
    print("  %s optical_conductivity %dx%d (the CPU comparison's grid)  [%.2f s]" % (where, nc, nc, sec))

    # shift_current_121w_161x161 (CPU: 64^2)
    bn = pt.models.bn()
    if not reference:
        sc, sec = timed(pt.optical.shift_current, bn, SHIFT_W, [0], nk=(n, n), sigma=0.08)
        print("  %s shift_current bn %dx%d, 121 w: max |sigma| %.6f  [%.2f s]" % (where, n, n, np.abs(sc).max(), sec))
        check(np.isfinite(sc).all() and np.abs(sc).max() > 1e-3, "BN shift current max %.3e" % np.abs(sc).max())
    out["shift_cpu"], sec = timed(pt.optical.shift_current, bn, SHIFT_W, [0], nk=(nc, nc), sigma=0.08)
    print("  %s shift_current bn %dx%d (the CPU comparison's grid)  [%.2f s]" % (where, nc, nc, sec))

    # shift_current_rice_mele_2001k
    n = S5["rice_mele"]
    srm, sec = timed(pt.optical.shift_current, rice_mele(pt), SHIFT_W, [0], nk=(n,), sigma=0.06)
    out["rice_mele"] = srm
    print("  %s shift_current rice_mele %d k: peak %.6f  [%.2f s]" % (where, n, srm[0, 0, 0].max(), sec))
    check(abs(srm[0, 0, 0].max() - 0.0694) < 2e-3, "Rice-Mele peak %.6f is not 0.0694" % srm[0, 0, 0].max())

    # qgt_integrated_72x72
    n = S5["qgt"]
    rg, sec = timed(pt.geometry.integrated_metric, hal, [0], nk=(n, n))
    out["qgt"] = np.concatenate([[rg["chern"], rg["omega_i"]], rg["metric"].ravel(), rg["curvature"].ravel()])
    print("  %s integrated_metric %dx%d: C %.8f, Omega_I %.8f  [%.2f s]"
          % (where, n, n, rg["chern"], rg["omega_i"], sec))
    check(abs(rg["chern"] + 1.0) < 1e-3 and abs(rg["omega_i"] - 0.223447) < 1e-3,
          "QGT C %.6f / Omega_I %.6f off -1 / 0.223447" % (rg["chern"], rg["omega_i"]))

    def bt_arrays(r):
        """The linear sums (sigma, sigma_H, n) and the ratios (Seebeck,
        kappa_e, Lorenz, R_H), one row per mu."""
        lin = np.concatenate([r["sigma"].reshape(len(BT_MUS), -1), r["sigma_hall"][:, None], r["n"][:, None]], 1)
        ratio = np.concatenate([r["seebeck"].reshape(len(BT_MUS), -1), r["kappa_e"].reshape(len(BT_MUS), -1),
                                r["lorenz"][:, None], r["hall_coefficient"][:, None]], 1)
        return lin, ratio

    # boltzmann_sweep_haldane (CPU: 64^2)
    n = S5["boltzmann"]
    if not reference:
        r, sec = timed(quiet_warnings, pt.boltzmann.transport_coefficients, hal, BT_MUS, 0.05, n, tau=1.0)
        i = int(np.argmin(np.abs(BT_MUS + 2.0)))
        vals = (r["sigma"][i, 0, 0], r["seebeck"][i, 0, 0], r["sigma_hall"][i])
        print("  %s transport_coefficients %d^2, 201 mu: at mu -2 sigma_xx %.6f, S_xx %.6f, sigma_H %.6f  [%.2f s]"
              % (where, n, *vals, sec))
        check(abs(vals[0] - 0.279203) < 3e-3 and abs(vals[1] + 0.127144) < 3e-3 and abs(vals[2] + 0.107893) < 3e-3,
              "Boltzmann pins at mu -2 off: %s" % (vals,))
    r, sec = timed(quiet_warnings, pt.boltzmann.transport_coefficients, hal, BT_MUS, 0.05, nc, tau=1.0)
    out["boltzmann_lin_cpu"], out["boltzmann_ratio_cpu"] = bt_arrays(r)
    print("  %s transport_coefficients %d^2 (the CPU comparison's grid)  [%.2f s]" % (where, nc, sec))

    # edelstein_rashba_201mu_256grid (CPU: 64^2)
    n = S5["edelstein"]
    if not reference:
        al, sec = timed(pt.boltzmann.edelstein, rashba(pt), EDEL_MUS, 0.05, n)
        ayx = float(np.interp(-2.5, EDEL_MUS, al[:, 1, 0]))
        asym = float(np.abs(al[:, 0, 1] + al[:, 1, 0]).max())
        print("  %s edelstein rashba %d^2, 201 mu: alpha_yx(-2.5) %.7f, antisymmetry %.3e  [%.2f s]"
              % (where, n, ayx, asym, sec))
        check(abs(ayx - 0.0232659) < 5e-4 and asym < 1e-4, "Edelstein alpha_yx %.7f / antisymmetry %.3e" % (ayx, asym))
    out["edelstein_cpu"], sec = timed(pt.boltzmann.edelstein, rashba(pt), EDEL_MUS, 0.05, nc)
    print("  %s edelstein rashba %d^2 (the CPU comparison's grid)  [%.2f s]" % (where, nc, sec))
    return out


def quiet_warnings(fn, *args, **kwargs):
    """fn(...) with its warnings dropped (the Boltzmann sweep warns for the
    chemical potentials below its bands)."""
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn(*args, **kwargs)


def compare_slice5(out, ref):
    """The fifth slice's rows on the card against the CPU run: 1e-10
    relative to each result's largest entry (NaN where the CPU has NaN), at
    every chemical potential: both sides take -df/de in its stable form and
    the Edelstein sum as a trace over each degenerate group."""
    nc = S5["cpu"]
    cases = [("ahc", ""), ("thermal_hall", ""), ("orbmag", ""), ("rice_mele", ""), ("qgt", ""),
             ("optical_cpu", " (%d^2)" % nc), ("shift_cpu", " (%d^2)" % nc),
             ("boltzmann_lin_cpu", " (%d^2; sigma, sigma_H, n at all 201 mu)" % nc),
             ("boltzmann_ratio_cpu", " (%d^2; Seebeck, kappa_e, Lorenz, R_H at all 201 mu)" % nc),
             ("edelstein_cpu", " (%d^2; all 201 mu, the Kramers pairs at E -4, 0, 4 included)" % nc)]
    for key, note in cases:
        got, want = np.asarray(out[key]), np.asarray(ref[key])
        check(got.shape == want.shape and np.array_equal(np.isnan(got), np.isnan(want)),
              "%s: shape or NaN pattern differs from the CPU run" % key)
        ok = ~np.isnan(want)
        err = float(np.abs(got - want)[ok].max() / np.abs(want[ok]).max())
        print("  %s vs CPU%s: max|diff| %.3e (relative)" % (key, note, err))
        check(err < 1e-10, "%s differs from the CPU path by %.3e (relative)" % (key, err))


# -- the sixth slice: Green's functions and disorder ---------------------------

HALL_E = np.linspace(-0.8, 0.8, 41)  # hall_bar_qwz_4terminal_41E
LYAP_E = np.linspace(-3.5, 3.5, 512)  # lyapunov_strip_512E_200k_steps
LYAP_STEPS, LYAP_CPU_STEPS = 200000, 2048
CPA_W = np.linspace(-5.0, 5.0, 256)  # cpa_alloy_dos_kagome
CPA_DISORDER = ("binary", [0.3, 0.7], [1.2, -0.3])
RIBBON_E = np.linspace(-3.0, 3.0, 301)  # examples/quantum_transport.py
KM_RIBBON_E = np.linspace(-0.6, 0.6, 121)
IMPURITY_E = np.linspace(-3.6, 3.6, 481)  # examples/impurity_states.py
S6 = {"cpa_nk": 48, "cpa_cpu_nk": 24, "impurity_nk": 96}


def qwz(pt):
    """The QWZ model of hall_bar_qwz_4terminal_41E."""
    m = pt.tb_model(2, 2, [[1.0, 0.0], [0.0, 1.0]], [[0.0, 0.0], [0.0, 0.0]])
    m.set_onsite([-1.0, 1.0])
    for amp, i, j, R in [(0.5, 0, 0, [1, 0]), (-0.5, 1, 1, [1, 0]), (0.5, 0, 0, [0, 1]), (-0.5, 1, 1, [0, 1]),
                         (0.5j, 0, 1, [1, 0]), (0.5j, 1, 0, [1, 0]), (0.5, 0, 1, [0, 1]), (-0.5, 1, 0, [0, 1])]:
        m.set_hop(amp, i, j, R)
    return m


def lyap_strip(pt):
    """The 8-leg square strip of lyapunov_strip_512E_200k_steps."""
    sq = pt.tb_model(2, 2, np.eye(2), [[0.0, 0.0]])
    sq.set_hop(-1.0, 0, 0, [1, 0])
    sq.set_hop(-1.0, 0, 0, [0, 1])
    return sq.cut_piece(8, 1)


def graphene_ribbon(pt):
    return pt.models.graphene(t=-1.0).cut_piece(5, 1, glue_edgs=False)


def km_ribbon(pt):
    """The Kane-Mele 6-wide ribbon of examples/quantum_transport.py and its
    disordered device layer (default_rng(1), both spins alike)."""
    rib = pt.models.kane_mele(esite=1.0, rashba=0.0).cut_piece(6, 1, glue_edgs=False)
    H00, _ = pt.negf.lead_blocks(rib)
    dis = np.repeat(np.random.default_rng(1).uniform(-0.5, 0.5, len(H00) // 2), 2)
    return rib, H00 + np.diag(dis)


def cost_decimation_green(K, nE, S, iters):
    """Kernel 12's Green's-function mode: H00, H01 and w read once, the
    (nE, K, S, S) surface G and two (nE, K) maxima written once; per pixel
    and iteration as kernel 12, then one final inverse (8 S^3)."""
    nbytes = 2 * K * S * S * C128 + nE * C128 + nE * K * S * S * C128 + 2 * nE * K * F64
    return bound(nbytes, nE * K * (iters * (56 * S**3 + 6 * S * S) + 8 * S**3))


def cost_cpa(W, B, S):
    """Kernel 13: H, z and Sigma read once, G (W, S) written once; per (w, k)
    the matrix built (2 S ops) and the Gauss-Jordan elimination of [M | I]
    (S columns x (S - 1) rows x 2S complex multiply-adds, 16 S^3), plus
    the pivot row's 2S complex divisions."""
    nbytes = B * S * S * C128 + W * C128 + 2 * W * S * C128
    return bound(nbytes, W * B * (16 * S**3 + 2 * S * S * 11 + 2 * S))


def cost_lyapunov(ndis, nE, S, steps, stride):
    """Kernel 18: A, Hinv, Bm and the (steps, ndis, S) onsite values read
    once, the frames Q and the log sums read and written once; per block
    and step the 2 S^2 new entries of 2S complex multiply-adds (32 S^3) and
    the S^2 entries of A - Hinv w (4 S^2); per QR the two Gram-Schmidt
    passes (64 S^3) and 2S norms (8 S each)."""
    n = 2 * S
    nbytes = (nE * S * S + 2 * S * S) * C128 + steps * ndis * S * F64 + 2 * ndis * nE * (n * n * C128 + n * F64)
    per_block = steps * (32 * S**3 + 4 * S * S) + steps // stride * (64 * S**3 + 16 * S * S)
    return bound(nbytes, ndis * nE * per_block)


def slice6_kernels(torch, pt, device, record, held):
    """Phase 3 for kernel 12's Green's-function mode, kernels 13 and 18, and
    kernels 1 and 16 at the sixth slice's shapes: kernel 12G at the Hall-bar
    leads and the graphene ribbon's two orientations (relative to max(1,
    |G|): 1e-12 at eta 0.02, 1e-9 at the main path's eta 1e-6), kernel 13
    one iteration at the CPA row (1e-12) and the whole fixed point against
    the plain version's (1e-10 relative), kernel
    18 at 512 E x 2,048 steps of the row's disordered strip (stride 8: the
    non-negative half of the exponents at 1e-8 relative; stride 1: every
    exponent at 1e-10), kernel 16 at the impurity shape (1e-10
    relative)."""
    from pythtb_tpu_torch import disorder, impurity, localization, negf, surface
    from pythtb_tpu_torch.ops import hamiltonian

    def rel_err(got, want):
        return max_diff(torch, got, want), max(1.0, float(want.abs().max()))

    def rel_all(got, want):
        return max(max_diff(torch, g, p) / max(1.0, float(p.abs().max())) for g, p in zip(got, want))

    # kernel 1 (both modes) at the principal layers of the slice's leads and strip
    k0 = torch.zeros((1, 0), dtype=torch.float64, device=device)
    for key, model in (("graphene ribbon 5", graphene_ribbon(pt)), ("kane_mele ribbon 6", km_ribbon(pt)[0]),
                       ("lyapunov strip 8", lyap_strip(pt))):
        d00, d01, _ = surface._layer_blocks(model, model._per[0])
        held("assemble", key + " H00 dim_k 0",
             max_diff(torch, hamiltonian.assemble(d00, k0), hamiltonian._assemble_plain(d00, k0)))
        held("assemble_one_sided", key + " H01 dim_k 0",
             max_diff(torch, hamiltonian.assemble_one_sided(d01, k0), hamiltonian._one_sided_plain(d01, k0)))

    # kernel 12's Green's-function mode: the four Hall-bar leads (S 16, K 1,
    # 41 E) and the ribbon's stacked orientations (S 10, K 2, 301 E), 60
    # iterations.  At the main path's eta 1e-6 the inverses' condition is
    # ~1e6, and two correct eliminations (the kernel's Gauss-Jordan, the
    # plain LU; or the plain version on the card and on the CPU) differ by
    # some 1e-10 relative: held there at 1e-9, and at 1e-12 at eta 0.02
    def green(H0, H1, w_, plain=False):
        return (surface._decimate_plain if plain else surface.decimate)(H0, H1, w_, 60, green=True)

    def green_checks(key, H0, H1, energies):
        w6, w2 = (torch.as_tensor(energies + 1j * eta).to(device) for eta in (1e-6, 0.02))
        err6 = rel_all(green(H0, H1, w6), green(H0, H1, w6, True))
        held("decimation_green", key + " eta 0.02", rel_all(green(H0, H1, w2), green(H0, H1, w2, True)))
        cpu = [x.to(device) for x in green(H0.cpu(), H1.cpu(), w6.cpu(), True)]
        print("  %-15s %-34s the plain version on the card vs on the CPU at eta 1e-6: max|diff| %.3e relative"
              % ("decimation_green", key, rel_all(green(H0, H1, w6, True), cpu)))
        return err6, w6

    Hd, leads, _ = negf.hall_bar(qwz(pt), (8, 8))
    H00, Hin = (torch.as_tensor(np.ascontiguousarray(x)).to(device)[None] for x in leads[0][:2])
    err, w = green_checks("hall bar lead E=41 K=1 S=16", H00, Hin, HALL_E)
    record("decimation_green", "hall bar lead E=41 K=1 S=16 iters 60", err, lambda: green(H00, Hin, w),
           lambda: green(H00, Hin, w, True), cost_decimation_green(1, 41, 16, 60), True, profile=True, tol=1e-9)
    for lead in leads[1:]:
        a, b = (torch.as_tensor(np.ascontiguousarray(x)).to(device)[None] for x in lead[:2])
        held("decimation_green", "hall bar lead S=%d eta 1e-6" % a.shape[-1],
             green_checks("hall bar lead S=%d" % a.shape[-1], a, b, HALL_E)[0], 1e-9)
    r00, r01 = (torch.as_tensor(x).to(device) for x in negf.lead_blocks(graphene_ribbon(pt)))
    Hs, As = torch.stack([r00, r00]).contiguous(), torch.stack([r01.conj().T, r01]).contiguous()
    err, wr = green_checks("graphene ribbon E=301 K=2 S=10", Hs, As, RIBBON_E)
    record("decimation_green", "graphene ribbon E=301 K=2 S=10 iters 60", err, lambda: green(Hs, As, wr),
           lambda: green(Hs, As, wr, True), cost_decimation_green(2, 301, 10, 60), tol=1e-9)

    # kernel 13 at the CPA row: 256 w x 2,304 k, S 3, H once by kernel 1
    kg = pt.models.kagome(t=-1.0)
    data = kg._get_finalized()
    nk = S6["cpa_nk"]
    kpts = torch.as_tensor(np.stack([g.reshape(-1) for g in np.meshgrid(*[np.arange(nk) / nk] * 2, indexing="ij")],
                                    axis=-1)).to(device)
    H = hamiltonian.assemble(data, kpts)
    z = torch.as_tensor(CPA_W + 0.05j).to(device)
    probs, vals, _, _, mask = disorder._norm_disorder(kg, CPA_DISORDER)
    sig0 = (torch.zeros((len(CPA_W), 3), dtype=torch.complex128, device=device)
            + float(np.dot(probs, vals)) * torch.as_tensor(mask).to(device))
    err, scale = rel_err(disorder.local_green(H, z, sig0), disorder._local_green_plain(H, z, sig0))
    record("cpa", "kagome W=256 B=%d S=3 (one iteration)" % H.shape[0], err / scale,
           lambda: disorder.local_green(H, z, sig0), lambda: disorder._local_green_plain(H, z, sig0),
           cost_cpa(len(CPA_W), H.shape[0], 3), True, profile=True)
    args = (H, z, probs, vals, mask, 200, False, 0.0, float(np.finfo(np.float64).eps ** (2.0 / 3.0)))
    sk, gk, _, ik = disorder._cpa_loop(*args)
    fast = disorder.local_green
    disorder.local_green = disorder._local_green_plain  # the whole loop on the plain version
    try:
        t0 = time.perf_counter()
        sp, gp, _, ip = disorder._cpa_loop(*args)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
    finally:
        disorder.local_green = fast
    check(ik == ip, "CPA iterations: kernel %d, plain %d" % (ik, ip))
    err = max(max_diff(torch, sk, sp) / float(sp.abs().max()), max_diff(torch, gk, gp) / float(gp.abs().max()))
    held("cpa", "kagome fixed point, %d iterations (plain loop %.2f s)" % (ik, plain_s), err, 1e-10)

    # kernel 18 at the Lyapunov row's strip: 512 E x 2,048 steps, W 1.5
    H00d, H01d, _ = localization._blocks_dense(lyap_strip(pt))
    S = H00d.shape[0]
    h00, h01 = torch.as_tensor(H00d).to(device), torch.as_tensor(H01d).to(device)
    hinv = torch.linalg.solve(h01, torch.eye(S, dtype=torch.complex128, device=device)).contiguous()
    E = torch.as_tensor(LYAP_E.astype(np.complex128)).to(device)
    A = (E[:, None, None] * hinv[None] - (hinv @ h00)[None]).contiguous()
    Bm = (-hinv @ h01.conj().T).contiguous()
    wl = torch.as_tensor(localization._onsite(np.zeros((1, S)), 1.5, np.random.default_rng(2), 0, LYAP_CPU_STEPS,
                                              1)).to(device)
    Q0 = torch.eye(2 * S, dtype=torch.complex128, device=device).expand(1, len(LYAP_E), 2 * S, 2 * S).contiguous()
    l0 = torch.zeros((1, len(LYAP_E), 2 * S), dtype=torch.float64, device=device)

    def kern(w_, stride):
        return localization.lyapunov_chunk(A, hinv, Bm, w_, Q0.clone(), l0.clone(), stride)[1]

    def plain(w_, stride):
        return localization._lyapunov_plain(A, hinv, Bm, w_, Q0, l0, stride)[1]

    # the row's stride 8: a stride's product has a condition number up to
    # e^{8 (gamma_max - gamma_min)} ~ 1e11, so two correct QRs (the
    # kernel's Householder, LAPACK's on either device) part at ~1e-9
    # relative on the non-negative half, ~1e-8 on the whole spectrum: the
    # half is held at 1e-8 here, and every exponent at 1e-10 at stride 1
    got = torch.sort(kern(wl, 8), -1, descending=True)[0]
    want = torch.sort(plain(wl, 8), -1, descending=True)[0]
    scale = float(want.abs().max())
    cpu = torch.sort(localization._lyapunov_plain(A.cpu(), hinv.cpu(), Bm.cpu(), wl.cpu(), Q0.cpu(), l0.cpu(), 8)[1],
                     -1, descending=True)[0].to(device)
    print("  %-15s %-34s stride 8: whole spectrum max|diff| %.3e relative; the plain version on the card vs on the "
          "CPU: half %.3e, whole %.3e" % ("lyapunov", "strip 8 E=512 2048 steps", max_diff(torch, got, want) / scale,
                                          max_diff(torch, want[..., :S], cpu[..., :S]) / scale,
                                          max_diff(torch, want, cpu) / scale))
    record("lyapunov", "strip 8 E=512 2048 steps W=1.5 (upper half)", max_diff(torch, got[..., :S], want[..., :S]),
           lambda: kern(wl, 8), lambda: plain(wl, 8), cost_lyapunov(1, len(LYAP_E), S, LYAP_CPU_STEPS, 8), True,
           reps=1, scale=scale, tol=1e-8, prof_reps=3, prof_plain=False)
    w1 = wl[:256].contiguous()
    got, want = torch.sort(kern(w1, 1), -1)[0], torch.sort(plain(w1, 1), -1)[0]
    held("lyapunov", "strip 8 E=512 256 steps stride 1 (whole)", max_diff(torch, got, want), 1e-10,
         float(want.abs().max()))

    # kernel 16 at the impurity shape: BN 96^2 (T 18,432, P 1, 481 E, eta 0.04)
    bn = pt.models.bn(delta=1.0)
    pos, states = impurity._cluster_arrays(bn, [0])
    E16, W16, _ = impurity._spectrum(bn, bn._get_finalized(), pos, states, (S6["impurity_nk"],) * 2)
    om = torch.as_tensor(IMPURITY_E).to(device)
    from pythtb_tpu_torch import optical

    want = optical._spectral_sum_plain(W16, E16, om, 0.04, "lorentz")
    lib = cuda_ms(torch, lambda: W16 @ optical._kernel_matrix(E16, om, 0.04, "lorentz").to(W16.dtype), 5)
    record("spectral_sum", "impurity bn 96^2 T=%d P=1 nw=481" % E16.shape[0],
           max_diff(torch, optical.spectral_sum(W16, E16, om, 0.04, "lorentz"), want),
           lambda: optical.spectral_sum(W16, E16, om, 0.04, "lorentz"),
           lambda: optical._spectral_sum_plain(W16, E16, om, 0.04, "lorentz"),
           cost_spectral_sum(E16.shape[0], 1, len(IMPURITY_E), True), library_ms=lib, scale=float(want.abs().max()),
           tol=1e-10, profile=True)


def slice6_path(pt, where, reference):
    """The three rows of tools/bench_suite.py that the sixth slice carries
    and the published widths of examples/quantum_transport.py and
    examples/impurity_states.py, through their public calls, with each
    row's own pin.  The CPU reference (``reference``) runs the Lyapunov
    spectrum at 2,048 of the row's 200,000 steps and the CPA at 24^2 of its
    48^2 k-points (the card repeats both for the comparison), the rest at
    full width."""
    import warnings

    out = {}

    def timed(fn, *args, **kwargs):
        t0 = time.perf_counter()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            result = fn(*args, **kwargs)
        return result, time.perf_counter() - t0

    # hall_bar_qwz_4terminal_41E
    Hd, leads, _ = pt.negf.hall_bar(qwz(pt), (8, 8))
    T, sec = timed(pt.negf.multi_terminal, Hd, leads, HALL_E, eta=1e-6)
    V = pt.negf.buttiker(T[20], source=0, drain=1)
    rxy = float(V[3] - V[2])
    out["hall_T"] = T
    print("  %s multi_terminal qwz 8x8 hall bar (128 modes, 4 leads), 41 E: R_xy %.6f  [%.2f s]" % (where, rxy, sec))
    check(abs(rxy - 1.0) < 5e-3, "Hall-bar R_xy %.6f is not 1" % rxy)

    # lyapunov_strip_512E_200k_steps (CPU: 2,048 steps)
    st = lyap_strip(pt)
    if not reference:
        ly, sec = timed(pt.localization.lyapunov_spectrum, st, LYAP_E, LYAP_STEPS, disorder=1.5, seed=2)
        pair = float(np.abs(ly[0, :, :8] + ly[0, :, :7:-1]).max())
        desc = bool(np.all(np.diff(ly[0], axis=-1) <= 1e-9))
        print("  %s lyapunov_spectrum strip 8, 512 E x %d steps, W 1.5: gamma_min(0) %.6f, +- pairing %.2e  "
              "[%.2f s]" % (where, LYAP_STEPS, ly[0, len(LYAP_E) // 2, 7], pair, sec))
        check(np.isfinite(ly).all() and desc and pair < 1e-3, "Lyapunov exponents not finite, descending and paired "
              "(pairing %.3e)" % pair)
        eps = np.linalg.eigvalsh(-np.eye(8, k=1) - np.eye(8, k=-1))
        lyc, sec = timed(pt.localization.lyapunov_spectrum, st, [4.6], 50000)
        dev = float(np.abs(lyc[0, 0, :8] - np.sort(np.arccosh(np.abs(4.6 - eps) / 2.0))[::-1]).max())
        print("  %s lyapunov_spectrum clean strip at E 4.6, 50,000 steps: arccosh deviation %.3e  [%.2f s]"
              % (where, dev, sec))
        check(dev < 5e-3, "clean-strip exponents off the arccosh values by %.3e" % dev)
    out["lyap_cpu"], sec = timed(pt.localization.lyapunov_spectrum, st, LYAP_E, LYAP_CPU_STEPS, disorder=1.5, seed=2)
    print("  %s lyapunov_spectrum strip 8, 512 E x %d steps (the CPU comparison's length)  [%.2f s]"
          % (where, LYAP_CPU_STEPS, sec))
    out["lyap_stride1"], sec = timed(pt.localization.lyapunov_spectrum, st, LYAP_E, 256, disorder=1.5, seed=2,
                                     stride=1)
    print("  %s lyapunov_spectrum strip 8, 512 E x 256 steps, QR every step  [%.2f s]" % (where, sec))

    # cpa_alloy_dos_kagome (CPU: 24^2)
    kg = pt.models.kagome(t=-1.0)
    if not reference:
        r, sec = timed(pt.disorder.cpa, kg, CPA_W, S6["cpa_nk"], CPA_DISORDER, eta=0.05)
        wsum = float(np.trapezoid(r["dos"], CPA_W))
        i0 = len(CPA_W) // 2  # the row reads its w index 128
        print("  %s cpa kagome 256 w x %d^2: DOS weight %.5f, dos(0) %.6f, Sigma(0)_0 %.6f%+.6fi, %d iterations, "
              "converged %s  [%.2f s]" % (where, S6["cpa_nk"], wsum, r["dos"][i0], r["sigma"][i0, 0].real,
                                          r["sigma"][i0, 0].imag, r["iters"], r["converged"], sec))
        check(abs(wsum - 2.9757) < 0.02 and abs(r["dos"][i0] - 0.473439) < 5e-3
              and abs(r["sigma"][i0, 0] - (0.004903 - 0.167533j)) < 5e-3 and r["converged"],
              "CPA pins off: weight %.5f, dos(0) %.6f, Sigma(0)_0 %s" % (wsum, r["dos"][i0], r["sigma"][i0, 0]))
    r, sec = timed(pt.disorder.cpa, kg, CPA_W, S6["cpa_cpu_nk"], CPA_DISORDER, eta=0.05)
    out["cpa_cpu"] = np.concatenate([r["sigma"].ravel(), r["gloc"].ravel(), [r["iters"]]])
    print("  %s cpa kagome 256 w x %d^2 (the CPU comparison's grid): %d iterations  [%.2f s]"
          % (where, S6["cpa_cpu_nk"], r["iters"], sec))

    # examples/quantum_transport.py: the graphene staircase and the Kane-Mele ribbon
    rib = graphene_ribbon(pt)
    out["ribbon_T"], sec = timed(pt.negf.landauer_transmission, rib, RIBBON_E, eta=1e-6)
    M = pt.negf.mode_count(rib, RIBBON_E + 0.005, stability_h=0.02)
    Tc = pt.negf.landauer_transmission(rib, RIBBON_E + 0.005, eta=1e-6)
    stair = float(np.abs(Tc - M)[M > 0].max())
    print("  %s landauer_transmission graphene ribbon 5, 301 E: |T - modes| %.2e where the count is stable  [%.2f s]"
          % (where, stair, sec))
    check(stair < 1e-4, "graphene staircase off the mode count by %.3e" % stair)
    km, dev_layer = km_ribbon(pt)
    out["km_T"], sec = timed(pt.negf.landauer_transmission, km, KM_RIBBON_E, device=dev_layer, eta=1e-6)
    # the helical pair in the gap (E -0.4, -0.2, 0.2, 0.4, as tests/test_negf.py holds it)
    helical = out["km_T"][[20, 40, 80, 100]]
    print("  %s landauer_transmission kane_mele ribbon 6 with a disordered layer, 121 E: T(+-0.2, +-0.4) %s  "
          "[%.2f s]" % (where, np.array2string(helical, precision=6), sec))
    check(np.abs(helical - 2.0).max() < 2e-2, "helical pair T %s is not 2" % helical)

    # examples/impurity_states.py: the BN T-matrix at 96^2, 481 E
    n = S6["impurity_nk"]
    (G, Tm), sec = timed(pt.impurity.t_matrix, pt.models.bn(delta=1.0), np.array([[4.0]]), IMPURITY_E, [0],
                         nk=(n, n), eta=0.04)
    out["impurity"] = np.concatenate([G.ravel(), Tm.ravel()])
    ldos = -G[:, 0, 0].imag / np.pi
    gap = np.abs(IMPURITY_E) < 0.9
    print("  %s t_matrix bn %d^2, 481 E, U 4: LDOS weight %.5f, peak in the gap %.4f  [%.2f s]"
          % (where, n, float(np.trapezoid(ldos, IMPURITY_E)), ldos[gap].max(), sec))
    check(np.isfinite(G).all() and ldos.min() > -1e-9, "impurity LDOS not finite and positive")
    return out


def compare_slice6(out, ref):
    """The sixth slice's rows on the card against the CPU run: 1e-10
    relative to each result's largest entry.  The Lyapunov exponents come
    from the same numpy draws on both sides; at the row's stride 8 two
    correct QRs part at ~1e-9 relative on the non-negative half (a
    stride's product has a condition number up to 1e11), so that half is
    held at 1e-8 and the whole spectrum at 1e-10 at stride 1."""
    ly, lr = out["lyap_cpu"], ref["lyap_cpu"]
    full = float(np.abs(ly - lr).max() / np.abs(lr).max())
    print("  lyap_cpu vs CPU, whole spectrum: max|diff| %.3e (relative; reported, not held)" % full)
    out = dict(out, lyap_cpu=ly[..., :8])
    ref = dict(ref, lyap_cpu=lr[..., :8])
    for key, note, tol in (("hall_T", " (41 E)", 1e-10),
                           ("lyap_cpu", " (512 E x 2,048 steps, stride 8, the non-negative half)", 1e-8),
                           ("lyap_stride1", " (512 E x 256 steps, stride 1, every exponent)", 1e-10),
                           ("cpa_cpu", " (24^2, Sigma, G and the iteration count)", 1e-10),
                           ("ribbon_T", " (301 E)", 1e-10), ("km_T", " (121 E)", 1e-10),
                           ("impurity", " (96^2, 481 E, G and T)", 1e-10)):
        got, want = np.asarray(out[key]), np.asarray(ref[key])
        check(got.shape == want.shape, "%s: shape differs from the CPU run" % key)
        err = float(np.abs(got - want).max() / np.abs(want).max())
        print("  %s vs CPU%s: max|diff| %.3e (relative)" % (key, note, err))
        check(err < tol, "%s differs from the CPU path by %.3e (relative, limit %.0e)" % (key, err, tol))


# -- the seventeenth slice: kernel 18 a warp a chain, kernel 19 a run a launch --

LYAP17_S = (1, 3, 8, 16, 40)  # both of kernel 18's designs at their edges
MV17_NW = (1, 4, 8)  # kernel 19's run kernel (the block path's nw: LARGE_NW)


def lyap_random(torch, S, nE, seed, device, emax=3.0):
    """A square strip of width S with a random inter-layer block (the
    kernel tests' strip): A (nE energies in [-emax, emax]), Hinv, Bm and the
    rng that draws its onsite values."""
    rng = np.random.default_rng(seed)
    h00 = -(np.eye(S, k=1) + np.eye(S, k=-1)).astype(complex)
    h01 = -np.eye(S, dtype=complex) + 0.1 * (rng.normal(size=(S, S)) + 1j * rng.normal(size=(S, S)))
    hinv = np.linalg.inv(h01)
    E = np.linspace(-emax, emax, nE)
    A = torch.as_tensor(np.ascontiguousarray(E[:, None, None] * hinv - hinv @ h00)).to(device)
    Bm = torch.as_tensor(np.ascontiguousarray(-hinv @ h01.conj().T)).to(device)
    return A, torch.as_tensor(hinv).to(device), Bm, rng


def mv_random(torch, n, B, nb, dc, seed, device):
    """Near-identity overlaps (a polar factor near 1, so |M_nn| ~ 1) and a
    state (U near 1, a small momentum) for single MV steps."""
    from pythtb_tpu_torch import wannier

    rng = np.random.default_rng(seed)
    X = rng.normal(size=(B, nb, n, n)) + 1j * rng.normal(size=(B, nb, n, n))
    u, _, vh = np.linalg.svd(np.eye(n) + 0.05 * X)
    H = rng.normal(size=(B, n, n)) + 1j * rng.normal(size=(B, n, n))
    A = torch.as_tensor(0.02 * (H - np.conj(np.swapaxes(H, -1, -2))))
    return (torch.as_tensor(np.ascontiguousarray(0.98 * (u @ vh))).to(device),
            torch.as_tensor(rng.integers(0, B, (B, nb))).to(device), torch.as_tensor(rng.uniform(0.5, 2.0, nb)).to(device),
            torch.as_tensor(rng.normal(size=(nb, dc)) * 0.3).to(device),
            wannier._expm_antiherm(A).to(device).contiguous(), (0.01 * A).to(device).contiguous())


def slice17_kernels(torch, pt, device, record, held):
    """Phase 3 for the seventeenth slice's redesigns.  Kernel 18 on both of
    its designs (a warp a chain to S 8, a block a chain to S 40) against
    the plain version on random strips at S 1 / 3 / 8 / 16 / 40, 5 E x 64
    steps, ndis 1 and 2: at stride 1 every exponent at 1e-10 relative, at
    stride 8 the largest at 1e-10 (energies in [-3, 3] take a stride's
    product near 1 / eps, where the smallest exponents of any two QRs
    part: reported) and, to S 8, every exponent at 1e-8 in the band
    (energies in [-0.5, 0.5], onsite values in [-0.2, 0.2]); two chunks of
    32 steps against one launch, bit for bit; then each design's device time at the
    row's shape (512 E x 2,048 steps), the design line (S 8 at 1-512
    chains, S 1-8 at 512 chains) and the row itself (512 E x 200,000
    steps) on the wrapper's design.  Kernel 19's run kernel (the whole run
    in one cooperative launch) and its block design (three launches a
    step) against the plain step at 1e-12 (nw 1 / 4 / 8, both branches of
    the step-size rule) and the silicon 400-step run on the block design
    against the plain run (the run kernel's is slice 8's); the device time
    of a run on each design, the run kernel's split by phase (the run with
    phases left out) and its launches."""
    from pythtb_tpu_torch import localization, wannier
    from pythtb_tpu_torch.ops import _kernels

    def frames(S, ndis):
        Q0 = torch.eye(2 * S, dtype=torch.complex128, device=device).expand(ndis, 5, 2 * S, 2 * S).contiguous()
        return Q0, torch.zeros((ndis, 5, 2 * S), dtype=torch.float64, device=device)

    def spectra(A, hinv, Bm, w, stride, design):
        Q0, l0 = frames(A.shape[-1], w.shape[1])
        got = localization.lyapunov_chunk(A, hinv, Bm, w, Q0.clone(), l0.clone(), stride, design)[1]
        want = localization._lyapunov_plain(A, hinv, Bm, w, Q0, l0, stride)[1]
        return torch.sort(got, -1, descending=True)[0], torch.sort(want, -1, descending=True)[0]

    for S in LYAP17_S:
        A, hinv, Bm, rng = lyap_random(torch, S, 5, 180 + S, device)
        Ab, hinvb, Bmb, rngb = lyap_random(torch, S, 5, 180 + S, device, emax=0.5)
        designs = ("warp", "block") if S <= localization._LYAPUNOV_DESIGNS["warp"][1] else ("block",)
        for ndis in (1, 2):
            w = {stride: torch.as_tensor(rng.uniform(-1.0, 1.0, (64, ndis, S))).to(device) for stride in (8, 1)}
            wb = torch.as_tensor(rngb.uniform(-0.2, 0.2, (64, ndis, S))).to(device)
            for design in designs:
                for stride in (8, 1):
                    got, want = spectra(A, hinv, Bm, w[stride], stride, design)
                    key = "random S %d ndis %d stride %d %s" % (S, ndis, stride, design)
                    scale = float(want.abs().max())
                    check(bool(torch.isfinite(got).all()), "lyapunov %s: exponents not finite" % key)
                    held("lyapunov", key + " (largest)", max_diff(torch, got[..., 0], want[..., 0]), 1e-10, scale)
                    if stride == 1:
                        held("lyapunov", key + " (whole)", max_diff(torch, got, want), 1e-10, scale)
                    else:
                        # energies in [-3, 3] close channels: a stride's product
                        # reaches a condition number of ~1e11, where any two
                        # correct QRs part at ~1e-7 on the smallest exponents
                        print("  %-15s %-34s whole spectrum max|diff| %.3e relative (reported: a stride's product "
                              "nears 1 / eps)" % ("lyapunov", key, max_diff(torch, got, want) / scale))
                if S <= 8:  # in the band a stride's product stays far from 1 / eps
                    got, want = spectra(Ab, hinvb, Bmb, wb, 8, design)
                    held("lyapunov", "in-band S %d ndis %d stride 8 %s (whole)" % (S, ndis, design),
                         max_diff(torch, got, want), 1e-8, float(want.abs().max()))
        # a chunk boundary: two launches of 32 steps give one launch's bits
        w = torch.as_tensor(rng.uniform(-1.0, 1.0, (64, 2, S))).to(device)
        Q0, l0 = frames(S, 2)
        one = localization.lyapunov_chunk(A, hinv, Bm, w, Q0.clone(), l0.clone(), 8)[1]
        Q1, l1 = localization.lyapunov_chunk(A, hinv, Bm, w[:32].contiguous(), Q0.clone(), l0.clone(), 8)
        two = localization.lyapunov_chunk(A, hinv, Bm, w[32:].contiguous(), Q1, l1, 8)[1]
        held("lyapunov", "random S %d two chunks of 32 steps vs one launch" % S, max_diff(torch, one, two), 0.0)

    # each design's device time at the row's strip (CUDA events)
    H00d, H01d, _ = localization._blocks_dense(lyap_strip(pt))
    S = H00d.shape[0]
    h00, h01 = torch.as_tensor(H00d).to(device), torch.as_tensor(H01d).to(device)
    hinv = torch.linalg.solve(h01, torch.eye(S, dtype=torch.complex128, device=device)).contiguous()
    Bm = (-hinv @ h01.conj().T).contiguous()
    E = torch.as_tensor(LYAP_E.astype(np.complex128)).to(device)
    A = (E[:, None, None] * hinv[None] - (hinv @ h00)[None]).contiguous()

    def onsite(steps):
        return torch.as_tensor(localization._onsite(np.zeros((1, S)), 1.5, np.random.default_rng(2), 0, steps,
                                                    1)).to(device)

    def chain(A_, w_, design=None, Bm_=Bm, hinv_=hinv):
        n = A_.shape[-1]
        Q0 = torch.eye(2 * n, dtype=torch.complex128, device=device).expand(1, A_.shape[0], 2 * n, 2 * n).contiguous()
        l0 = torch.zeros((1, A_.shape[0], 2 * n), dtype=torch.float64, device=device)
        return localization.lyapunov_chunk(A_, hinv_, Bm_, w_, Q0, l0, 8, design)

    wl = onsite(LYAP_CPU_STEPS)
    times = {d: event_us(torch, lambda: chain(A, wl, d), 3) for d in ("warp", "block")}
    print("  %-15s %-34s device per call (CUDA events): warp %.1f us, block %.1f us; wrapper's design %s"
          % ("lyapunov", "strip 8 E=512 2048 steps", times["warp"], times["block"],
             localization._lyapunov_design(S, len(LYAP_E), 1, _kernels.card(device)[0])))
    line = []
    for nE in (1, 16, 132, 512):
        line.append("S 8 x %d chains: warp %.1f / block %.1f" % (nE, event_us(torch, lambda: chain(A[:nE].contiguous(), wl, "warp"), 3),
                                                              event_us(torch, lambda: chain(A[:nE].contiguous(), wl, "block"), 3)))
    for S2 in (1, 4):
        A2, hinv2, Bm2, rng2 = lyap_random(torch, S2, 512, 7, device)
        w2 = torch.as_tensor(rng2.uniform(-1.0, 1.0, (LYAP_CPU_STEPS, 1, S2))).to(device)
        line.append("S %d x 512 chains: warp %.1f / block %.1f" % (
            S2, event_us(torch, lambda: chain(A2, w2, "warp", Bm2, hinv2), 3),
            event_us(torch, lambda: chain(A2, w2, "block", Bm2, hinv2), 3)))
    print("  %-15s the design line, 2,048 steps, device us (CUDA events): %s" % ("lyapunov", "; ".join(line)))
    wrow = onsite(LYAP_STEPS)
    print("  %-15s %-34s device per call (CUDA events) on the wrapper's design: %.1f us; bound %.1f us (%s)"
          % ("lyapunov", "the row: strip 8 E=512 200000 steps", event_us(torch, lambda: chain(A, wrow), 2),
             1e3 * cost_lyapunov(1, len(LYAP_E), S, LYAP_STEPS, 8)[0], cost_lyapunov(1, len(LYAP_E), S, LYAP_STEPS, 8)[1]))
    del wrow

    # kernel 19's run kernel: single steps on both designs, both branches
    for n in MV17_NW:
        M0, nbr, w_b, b_cart, U, dW = mv_random(torch, n, 64, 8, 3, 260 + n, device)
        eps0 = 0.5 / (4.0 * float(w_b.sum()))
        for om_prev in (math.inf, -1.0):
            want = wannier._mv_step_plain(M0, nbr, w_b, b_cart, U, dW,
                                          torch.tensor(1.3 * eps0, dtype=torch.float64, device=device),
                                          torch.tensor(om_prev, dtype=torch.float64, device=device), 20.0 * eps0)
            for design in ("grid", "block"):
                got = wannier.mv_step(M0, nbr, w_b, b_cart, U, dW, 1.3 * eps0, om_prev, eps0, design)
                held("mv_step", "random B 64 nb 8 nw %d %s, %s" % (n, design, "first" if om_prev > 0 else "overshoot"),
                     max(max_diff(torch, a, b) / max(1.0, float(b.abs().max())) for a, b in zip(got, want)))
    M0, nbr, w_b, b_cart = silicon_overlaps(torch, pt, (S8["si_coarse"],) * 3)
    B, nb, n, _ = M0.shape
    eps0 = 0.5 / (4.0 * float(w_b.sum()))
    steps = S8["si_steps"]
    U, hist, (rbar, oi, ot) = wannier._mv_kernel_run(M0, nbr, w_b, b_cart, steps, eps0, "block")
    Up, hp, (rp, oip, otp) = wannier._mv_run_plain(M0, nbr, w_b, b_cart, steps, eps0)
    e = (abs(float(oi) - float(oip)) / abs(float(oip)), abs(float(oi + ot) - float(oip + otp)) / abs(float(oip + otp)),
         max_diff(torch, hist, hp) / float(hp.abs().max()), max_diff(torch, rbar, rp) / max(1.0, float(rp.abs().max())))
    print("  mv_step         silicon 8^3 %d-step run, block design, vs plain run: Omega_I %.3e, Omega %.3e, history "
          "%.3e, centres %.3e (relative)" % ((steps,) + e))
    check(e[0] <= MV_TOL["omega_i"] and e[1] <= MV_TOL["omega"] and max(e[2:]) <= MV_TOL["history"],
          "kernel 19's block design departs from the plain run")
    run_us = {d: event_us(torch, lambda: wannier._mv_kernel_run(M0, nbr, w_b, b_cart, steps, eps0, d), 3)
              for d in ("grid", "block")}
    split = {ph: event_us(torch, lambda: wannier._mv_kernel_run(M0, nbr, w_b, b_cart, steps, eps0, "grid", ph), 3)
             for ph in (0, 1, 3)}
    print("  %-15s silicon 8^3 %d-step run, device (CUDA events): grid %.1f us (%.2f a step), block %.1f us (%.2f a "
          "step); the grid's split a step (the run with phases left out): barriers and partial sums %.2f, overlaps "
          "%.2f, reductions %.2f, update %.2f us" % ("mv_step", steps, run_us["grid"], run_us["grid"] / steps,
                                                    run_us["block"], run_us["block"] / steps, split[0] / steps,
                                                    (split[1] - split[0]) / steps, (split[3] - split[1]) / steps,
                                                    (run_us["grid"] - split[3]) / steps))
    before = dict(_kernels.LAUNCHES)
    wannier.mv_localize(M0, nbr, w_b, b_cart, steps, 0.5)
    torch.cuda.synchronize()
    print("  %-15s silicon 8^3 %d-step run on the wrapper's design (%s): %d launches a run (%s)"
          % ("mv_step", steps, wannier._mv_design(B, nb, n, _kernels.card(device)[0]),
             sum(_kernels.LAUNCHES[k] - before[k] for k in ("mv_step", "mv_final")),
             {k: _kernels.LAUNCHES[k] - before[k] for k in ("mv_step", "mv_final")}))


FOLLOW18_NS = (1, 2, 3, 4, 5, 6, 7, 8)  # kernel 14's follow below 9 stored states
FOLLOW18_GRIDS = ((9, 7), (41, 41))


def slice18_kernels(torch, pt, device, held):
    """Phase 3 for the eighteenth slice's redesign of kernel 14's follow
    mode (the selection scan split from the polar factors) against the
    plain version -- the followed indices identical, fidelity and states
    at 1e-12 -- with its device time (CUDA events) and the designs of its
    phases, at the slab (20 of 39 along k1, the main path's call, and k0),
    the pump along lambda and k, Kane-Mele 41^2 along both axes, random 9 x
    7 frames at NS 9 / 12 / 16 / 32 / 64, and random frames at NS 1-8 (9 x
    7 and 41 x 41, nocc 1, NS / 2 and up to 4); the slab's call split by
    kernel (profiler device times).  Kernel 17's redesign is held and timed
    in slice 5's rows."""
    from pythtb_tpu_torch.ops import _kernels, solver, transport

    card = _kernels.card(device)
    rng = np.random.default_rng(18)

    def follow(key, w5, occ):
        occ_t = torch.as_tensor(occ, dtype=torch.int64, device=device)
        outer, L, inner, NS, F = w5.shape
        ip, fp, sp = transport._follow_plain(w5, occ_t)
        idx, fid, st = transport._follow(w5, occ_t)
        check(torch.equal(idx, ip), "transport_follow %s: the followed indices differ from the plain version" % key)
        held("transport_follow", key, max(max_diff(torch, fid, fp), max_diff(torch, st, sp)))
        print("  %-15s %-34s polar factors, states: %s; device us (CUDA events): %.1f"
              % ("transport_follow", key, ", ".join(transport._follow_path(NS, len(occ), F, outer * inner, L, *card)),
                 event_us(torch, lambda: transport._follow(w5, occ_t), 5)))
        return occ_t

    slab = cubic_slab(pt)
    sd = slab._get_finalized()
    _, _, ws = solver.solve_grid_device(sd, (41, 41), (0.0, 0.0), slab._orb, slab._per, 1)
    occ = list(range(S10["smooth_occ"]))
    for axis in (1, 0):
        w5 = transport._strings(ws, 1, 2, axis)[0].contiguous()
        occ_t = follow("slab 41x41 along k%d, %d of 39" % (axis, len(occ)), w5, occ)
        if axis == 1:
            top, total = device_top(torch, lambda: transport._follow(w5, occ_t), n=5, reps=5)
            print("  %-15s %-34s split by kernel, device us (profiler): %s; total %s"
                  % ("transport_follow", "slab 41x41 along k1", "; ".join(
                      "%s %.1f" % (name.split("(")[0].replace("void ", ""), us) for name, us in top), fmt(total)))
    del ws, w5
    wp, _ = pump_grid(pt)
    kmw = pt.wf_array(pt.models.kane_mele(), [S8["km_grid"]] * 2)
    kmw.solve_on_grid([0.0, 0.0])
    for key, wf, nspin, occ in (("pump 41x31", wp, 1, [0]), ("kane_mele 41x41 nspin 2", kmw, 2, [0, 1])):
        for axis in (0, 1):
            follow("%s along %s, nocc %d" % (key, ("lambda" if key.startswith("pump") and axis == 0 else "k%d" % axis),
                                            len(occ)), transport._strings(wf._device_states(), nspin, 2, axis)[0]
                   .contiguous(), occ)

    def frames(grid, NS, F):
        z = rng.normal(size=grid + (F, NS)) + 1j * rng.normal(size=grid + (F, NS))
        fr = torch.as_tensor(np.ascontiguousarray(np.swapaxes(np.linalg.qr(z)[0], -1, -2))).to(device)
        return transport._strings(fr, 1, 2, 0)[0].contiguous()

    for S in LARGE_S:
        NS = min(S + 2, 64)
        follow("random 9x7 frames, %d of %d" % (S, NS), frames((9, 7), NS, NS + 4), list(range(S)))
    for grid in FOLLOW18_GRIDS:
        for NS in FOLLOW18_NS:
            for nocc in sorted({1, max(1, NS // 2), min(4, NS)}):
                follow("random %dx%d, %d of %d" % (grid + (nocc, NS)), frames(grid, NS, NS + 2), list(range(nocc)))


# -- the seventh slice: kernel 7, kernel 1's flux-batch mode, the rest of
# flows, the Hofstadter solver and model families ---------------------------

HOF_Q = 40  # hofstadter_butterfly_q40: 41 fluxes x 16 k x 40 bands
HOF_K = np.stack(np.meshgrid(np.arange(4) / 4.0, np.arange(4) / 4.0, indexing="ij"), -1).reshape(-1, 2)
S7 = {"quadrupole": 21, "spin_chern": 41, "sector": 41, "nodes": 40, "family": 16, "c2": 16, "c2_slices": 16,
      "c2_cpu": 8}
JACOBI_M = (33, 39, 40, 48, 63, 64)  # kernel 7 held at these sizes
# kernel 7 against torch.linalg.eigh and the plain Jacobi at m 3-32, random B 1,600 (eigh._route's line; the
# callers of phase 4 in that range are held on their own matrices by eigh_route_case)
JACOBI_ROUTE_M = (3, 4, 8, 16, 24, 32)
# (B, m) about eigh._route's batch line at 9-26 states and its library range 27-32, and about
# eigh._jacobi_design's team / block line (to 12 states from 16,384 matrices)
JACOBI_LINE_SHAPES = ((256, 16), (1024, 16), (256, 22), (1024, 22), (1024, 26), (1600, 28), (4096, 4), (16384, 4),
                      (16384, 12), (16384, 16))


def haldane_bilayer(pt):
    """The opposite-Chern Haldane bilayer of sector_chern_bilayer_41x41
    (tools/bench_suite.py:426), coupled by tperp 0.3."""
    m = pt.tb_model(2, 2, [[1.0, 0.0], [0.5, np.sqrt(3.0) / 2.0]], [[1 / 3, 1 / 3], [2 / 3, 2 / 3]] * 2)
    m.set_onsite([-0.2, 0.2, -0.2, 0.2])
    for off, sgn in ((0, 1.0), (2, -1.0)):
        t2v = 0.15 * np.exp(1.0j * np.pi / 2.0 * sgn)
        m.set_hop(-1.0, 0 + off, 1 + off, [0, 0])
        m.set_hop(-1.0, 1 + off, 0 + off, [1, 0])
        m.set_hop(-1.0, 1 + off, 0 + off, [0, 1])
        for lv in ([1, 0], [-1, 1], [0, -1]):
            m.set_hop(t2v, 0 + off, 0 + off, lv)
            m.set_hop(np.conj(t2v), 1 + off, 1 + off, lv)
    m.set_hop(0.3, 0, 2, [0, 0])
    m.set_hop(0.3, 1, 3, [0, 0])
    return m


def haldane_family(pt):
    """Haldane supercells of 1, 4 and 20 cells: the family's stacked
    eigensolve is 40 x 40 (kernel 7)."""
    hal = pt.models.haldane()
    return [hal] + [quiet(hal.make_supercell, M, to_home=False) for M in ([[2, 0], [0, 2]], [[4, 0], [0, 5]])]


def cost_eigh(B, m, vectors=True):
    """Kernel 7's bound: H read once, w (and v) written once; the operations
    of a Householder-tridiagonal eigensolve, ~36 m^3 float64 operations a
    complex Hermitian matrix with vectors (16 m^3 / 3 without), which is
    less than the Jacobi sweeps do (~48 m^3 a sweep)."""
    nbytes = B * m * m * C128 + B * m * F64 + (B * m * m * C128 if vectors else 0)
    return bound(nbytes, B * (36.0 if vectors else 16.0 / 3.0) * m**3)


def cost_assemble_members(data, P, NK):
    """Kernel 1's flux-batch mode: as kernel 1 with P members' amplitudes
    and diagonals read once and P * NK matrices written."""
    blk = 4 if data.nspin == 2 else 1
    nbytes = (NK * data.dim_k * F64 + data.nhop * data.dim_k * F64 + P * (data.nhop * blk + data.nsta**2) * C128
              + (data.norb**2 + 1 + 2 * data.nhop) * 4 + P * NK * data.nsta**2 * C128)
    return bound(nbytes, P * NK * data.nhop * (2 * data.dim_k + 2 + 2 * blk * 8))


def eigh_route_case(torch, key, H, record, reps=5, cpu_route=False):
    """Kernel 7 on B matrices of m <= 32 states against the plain Jacobi
    (eigenvalues within 1e-12 of max(1, ||H||_F), every group's projector
    within its perturbation limit, projector_diff) and against
    torch.linalg.eigh in eigh_batched's slices: the design eigh._jacobi_design
    picks is recorded with the library's time beside it, the other design
    that takes m timed beside it, and the route eigh._route takes for the
    shape (with the caller's ``cpu_route``) printed with the faster of
    kernel 7 and the library."""
    from pythtb_tpu_torch.ops import eigh

    B, m = H.shape[0], H.shape[-1]
    scale = max(1.0, float(torch.linalg.matrix_norm(H).max()))
    design = eigh._jacobi_design(m, B)
    route = eigh._route(m, B, "cuda", cpu_route)
    wp, vp = eigh._eigh_jacobi_plain(H)
    wl, vl = eigh._library_eigh(H)
    err, ratio = 0.0, 0.0
    designs = [d for d, (_, most) in eigh._JACOBI_DESIGNS.items() if m <= most]
    for d in designs:
        w, v = eigh._eigh_jacobi(H, True, d)
        err = max(err, max_diff(torch, w, wp), max_diff(torch, w, wl))
        ratio = max(ratio, projector_diff(torch, wp, v, vp, scale, chunk=128 if m > 8 else 8192)[0],
                    projector_diff(torch, wl, v, vl, scale, chunk=128 if m > 8 else 8192)[0])
        del w, v
    check(ratio <= 1.0, "eigh_jacobi %s: a projector exceeds its perturbation limit (%.3f)" % (key, ratio))
    del vp, vl
    lib = cuda_ms(torch, lambda: eigh._library_eigh(H), reps)
    record("eigh_jacobi", "%s, %s design" % (key, design), err, lambda: eigh._eigh_jacobi(H, True, design),
           lambda: eigh._eigh_jacobi_plain(H), cost_eigh(B, m), library_ms=lib, reps=reps, scale=scale)
    others = ["%s design %.4f ms" % (d, cuda_ms(torch, lambda: eigh._eigh_jacobi(H, True, d), reps))
              for d in designs if d != design]
    kernel = cuda_ms(torch, lambda: eigh._eigh_jacobi(H, True, design), reps)
    print("  %-15s %-34s %s; projectors within %.3f of their limits; route %s (kernel 7 %.4f, library %.4f ms: "
          "%s faster)" % ("eigh_jacobi", key, "; ".join(others) or "one design takes m", ratio, route, kernel, lib,
                          "kernel 7" if kernel <= lib else "the library"))


def projector_diff(torch, w_ref, v, v_ref, scale, gap=1e-8, chunk=128):
    """The spectral projectors of the groups of eigenvalues that ``w_ref``
    (B, m) splits by more than ``gap`` (v, v_ref row eigenvectors
    (B, m, m)), each group's max |P_g - Q_g| over its limit max(1e-10,
    1e-14 scale / gap_g), gap_g the distance to the nearest eigenvalue
    outside the group: two correct eigensolvers part by ~eps ||H|| / gap_g
    there (first-order perturbation theory), so a group split by 1e-7
    cannot be held at 1e-10.  Returns (the largest ratio, the largest
    |P_g - Q_g| of the groups held at 1e-10)."""
    m = w_ref.shape[-1]
    d = w_ref[:, 1:] - w_ref[:, :-1]
    cut = d > gap
    labels = torch.cat([torch.zeros_like(w_ref[:, :1], dtype=torch.int64), torch.cumsum(cut.to(torch.int64), -1)], -1)
    vals = torch.where(cut, d, torch.full_like(d, math.inf))
    inf = torch.full_like(w_ref, math.inf)
    left = inf.scatter_reduce(1, labels[:, 1:], vals, "amin")
    right = inf.scatter_reduce(1, labels[:, :-1], vals, "amin")
    limit = torch.clamp(1e-14 * scale / torch.minimum(left, right), min=1e-10)  # (B, groups)
    ratio, plain = 0.0, 0.0
    for b0 in range(0, w_ref.shape[0], chunk):
        sl = slice(b0, b0 + chunk)
        G = torch.nn.functional.one_hot(labels[sl], m).transpose(1, 2).to(v.dtype)  # (b, g, i)
        P = torch.einsum("bgi,bif,bih->bgfh", G, v[sl], v[sl].conj())
        Q = torch.einsum("bgi,bif,bih->bgfh", G, v_ref[sl], v_ref[sl].conj())
        err = (P - Q).abs().amax(dim=(-2, -1))  # (b, g)
        ratio = max(ratio, float((err / limit[sl]).max()))
        plain = max(plain, float(torch.where(limit[sl] == 1e-10, err, torch.zeros_like(err)).max()))
    return ratio, plain


def slice7_kernels(torch, pt, device, record, held):
    """Phase 3 for kernel 7 and kernel 1's flux-batch mode: kernel 7 against
    its plain version (the same Jacobi rotations in torch) and against
    torch.linalg.eigh, at m 33, 39, 40, 48, 63 and 64 (random Hermitian
    batches, one with exact four-fold degeneracies), on the slab's own
    matrices (B 1,600, m 39) and the Hofstadter row's (B 656, m 40, exact
    degeneracies at flux 0): eigenvalues within 1e-12 of max(1, ||H||_F),
    the projectors of eigenvalue groups split by more than 1e-8 within
    1e-10; timed against torch.linalg.eigh at the slab and Hofstadter
    shapes.  Below 33 states (eigh_route_case): every design that takes m
    at random B 1,600 m 3 / 4 / 8 / 16 / 24 / 32 and about the route's and
    the design's lines (JACOBI_LINE_SHAPES), degenerate B 64 m 4 / 16 and every
    eigh_batched call of phase 4 at m 3-32 (eigh_callers), each timed
    against torch.linalg.eigh.  A group split from its
    neighbours by less than 1e-4 ||H||_F (the Hofstadter spectra have
    splittings of 1e-7) is held at its perturbation bound, 1e-14
    ||H||_F / gap, instead: no eigensolver meets 1e-10 there.  The
    flux-batch mode at the Hofstadter row's 41 fluxes x 16 k within
    1e-14."""
    from pythtb_tpu_torch.ops import eigh, hamiltonian, solver

    rng = np.random.default_rng(7)

    def hermitian(B, m, degenerate=False):
        if degenerate:
            Q = torch.linalg.qr(torch.as_tensor(rng.normal(size=(B, m, m)) + 1j * rng.normal(size=(B, m, m))))[0]
            d = torch.as_tensor(np.sort(np.repeat(rng.normal(size=(B, m)), 4, axis=1)[:, :m], axis=1))
            return ((Q * d[:, None, :]) @ Q.conj().transpose(-1, -2)).contiguous().to(device)
        X = rng.normal(size=(B, m, m)) + 1j * rng.normal(size=(B, m, m))
        return torch.as_tensor(np.ascontiguousarray(0.5 * (X + np.conj(np.swapaxes(X, -1, -2))))).to(device)

    def hold(key, H, timed=False, cost=None, main=False):
        scale = max(1.0, float(torch.linalg.matrix_norm(H).max()))
        w, v = eigh.eigh_jacobi(H)
        wp, vp = eigh._eigh_jacobi_plain(H)
        wl, vl = torch.linalg.eigh(H)
        vl = vl.transpose(-1, -2)
        err_w = max(max_diff(torch, w, wp), max_diff(torch, w, wl))
        (rp, ep), (rl, el) = projector_diff(torch, wp, v, vp, scale), projector_diff(torch, wl, v, vl, scale)
        held("eigh_jacobi", key + " projectors (gaps >= 1e-4 ||H||)", max(ep, el), 1e-10)
        print("  %-15s %-34s every projector within %.3f of its limit max(1e-10, 1e-14 ||H|| / gap)"
              % ("eigh_jacobi", key, max(rp, rl)))
        check(max(rp, rl) <= 1.0, "eigh_jacobi %s: a projector exceeds its perturbation limit" % key)
        if not timed:
            held("eigh_jacobi", key + " eigenvalues", err_w, scale=scale)
            return
        # the plain Jacobi's profile (3 calls of ~0.8 s, their events lost) is left out: ~55 s of the time limit
        record("eigh_jacobi", key, err_w, lambda: eigh.eigh_jacobi(H), lambda: eigh._eigh_jacobi_plain(H), cost,
               main, cuda_ms(torch, lambda: torch.linalg.eigh(H), 3), reps=5, scale=scale, prof_reps=3,
               prof_plain=False, profile=True)

    for m in JACOBI_M:
        hold("random B=64 m=%d" % m, hermitian(64, m))
    hold("degenerate B=64 m=40", hermitian(64, 40, degenerate=True))
    slab = cubic_slab(pt)
    sd = slab._get_finalized()
    Hs = hamiltonian.assemble(sd, solver.device_uniform_grid((40, 40), (0.0, 0.0), device))
    hold("slab B=%d m=%d" % tuple(Hs.shape[:2]), Hs, True, cost_eigh(Hs.shape[0], sd.nsta), True)
    from pythtb_tpu_torch import magnetic

    sc, slope = magnetic._magnetic_sc_base(pt.models.square(), HOF_Q, (0, 1))
    sd_h = sc._get_finalized()
    pv = torch.arange(HOF_Q + 1, dtype=torch.float64, device=device)
    amps, diag = magnetic._flux_members(sd_h, torch.as_tensor(slope).to(device), pv)
    kh = torch.as_tensor(HOF_K).to(device)
    err = max_diff(torch, hamiltonian.assemble_members(sd_h, amps, diag, kh),
                   hamiltonian._assemble_members_plain(sd_h, amps, diag, kh))
    record("assemble_members", "hofstadter q40 P=41 NK=16 nsta 40", err,
           lambda: hamiltonian.assemble_members(sd_h, amps, diag, kh),
           lambda: hamiltonian._assemble_members_plain(sd_h, amps, diag, kh),
           cost_assemble_members(sd_h, HOF_Q + 1, len(HOF_K)), True, tol=1e-14)
    Hh = hamiltonian.assemble_members(sd_h, amps, diag, kh)
    hold("hofstadter B=656 m=40", Hh, True, cost_eigh(Hh.shape[0], 40))
    H0 = Hh[: len(HOF_K)].contiguous()  # flux 0: the folded free band, exact degeneracies
    hold("hofstadter flux 0 B=16 m=40", H0)
    wv = eigh.eigh_jacobi(Hh, vectors=False)
    held("eigh_jacobi", "hofstadter eigenvalues-only mode", max_diff(torch, wv, eigh._eigh_jacobi_plain(Hh, False)),
         scale=max(1.0, float(torch.linalg.matrix_norm(Hh).max())))
    # kernel 7 below 33 states (eigh._route's line): random B 1,600,
    # two degenerate batches, then the callers of phase 4 on their own
    # matrices (captured from the real calls)
    for m in JACOBI_ROUTE_M:
        eigh_route_case(torch, "random B=%d m=%d" % (Hs.shape[0], m), hermitian(Hs.shape[0], m), record)
    for B, m in JACOBI_LINE_SHAPES:
        eigh_route_case(torch, "random B=%d m=%d" % (B, m), hermitian(B, m), record, 3 if B > 4096 else 5)
    for m in (4, 16):
        eigh_route_case(torch, "degenerate B=64 m=%d" % m, hermitian(64, m, degenerate=True), record)
    eigh_callers(torch, pt, record)


def eigh_callers(torch, pt, record):
    """Every eigh_batched call of phase 4 at m 3-32, captured from the real
    calls: the kappa row (768^2 phonon 4 x 4), the Kane-Mele 41^2 Wilson
    flow (4 x 4), the w90 silicon bands (8 x 8), the magnon thermal-Hall
    grid (2n 4, on the CPU's route: its fluxes need the library's basis
    inside a degenerate pair) and neutron map (2n 6), the Floquet spectrum
    (22 x 22) and the Lieb superfluid weight's BdG matrices (2S 6), each
    through eigh_route_case."""
    from pythtb_tpu_torch import flows, floquet, geometry, magnon, phonon
    from pythtb_tpu_torch.ops import solver
    from tests import workloads, zoo

    si = pt.w90(workloads.W90_DATA_DIR, "silicon")
    si_k = si.w90_bands_consistency()[0]
    si_m = si.model(min_hopping_norm=0.01)
    km, qs = kagome_magnet(pt)
    kv = pt.models.graphene().k_path([[0.0, 0.0], [1.0 / 3.0, 2.0 / 3.0], [0.5, 0.5], [0.0, 0.0]], 121,
                                     report=False)[0]
    calls = (
        ("kappa row %d^2" % S12["kappa_nk"], phonon,
         lambda: pt.phonon.thermal_conductivity(honeycomb_springs(pt), KAPPA_TS, S12["kappa_nk"]), 3),
        ("kane_mele flow 41x41", flows, lambda: pt.flows.wilson_flow(zoo.kane_mele(pt, "odd"), [0, 1], nk=(41, 41)), 5),
        ("w90 silicon bands", solver, lambda: si_m.solve_all(si_k, eig_vectors=True), 5),
        ("magnon thermal Hall %d^2" % S12["hall_nk"], magnon, lambda: pt.magnon.thermal_hall(honeycomb_magnet(pt), MAGNON_TS,
                                                                            nk=S12["hall_nk"]), 5),
        ("magnon neutron 4,096 q", magnon, lambda: pt.magnon.structure_factor(km, qs, omegas=NEUTRON_W, eta=0.05), 5),
        ("floquet spectrum 121 k nharm 5", floquet, lambda: pt.floquet.quasienergies(pt.models.graphene(), FLQ_W,
                                                                                     circ(1.2), kv, nharm=5), 5),
        ("lieb BdG 48^2", geometry, lambda: pt.geometry.superfluid_weight(pt.models.lieb(), 0.0, 0.3, nk=(48, 48)), 5),
    )
    for key, module, call, reps in calls:
        (H,), kwargs = captured(module, "eigh_batched", call)
        H = H.reshape(-1, H.shape[-1], H.shape[-1]).contiguous()
        eigh_route_case(torch, "%s B=%d m=%d" % (key, H.shape[0], H.shape[-1]), H, record, reps,
                        kwargs.get("cpu_route", False))
        del H


def slice7_path(pt, where, reference):
    """The five rows of tools/bench_suite.py that the seventh slice carries
    (hofstadter_butterfly_q40 :190, bbh_quadrupole_21x21 :254,
    spin_chern_41x41 :261, sector_chern_bilayer_41x41 :426,
    weyl_node_search_40cube :972) with their pins, Streda labels at flux
    1/5 against TKNN, a family of Haldane supercells whose stacked
    eigensolve is 40 x 40, the DOS of the Haldane model, and the second
    Chern number of the Fu-Kane-Mele beta cycle (16 slices, 16^3 k,
    refined) against its integer.  The CPU reference runs the second Chern
    number at 8^3 unrefined (the card repeats it for the comparison), the
    rest at full width.  On the card, the launches of kernel 7 and the
    flux-batch mode during the Hofstadter call are returned."""
    from pythtb_tpu_torch.ops import _kernels

    out = {}

    def timed(fn, *args, **kwargs):
        t0 = time.perf_counter()
        result = fn(*args, **kwargs)
        return result, time.perf_counter() - t0

    # hofstadter_butterfly_q40
    fn, _ = pt.magnetic.hofstadter_fn(pt.models.square(), HOF_Q)
    before = dict(_kernels.LAUNCHES)
    evb, sec = timed(lambda: fn(np.arange(HOF_Q + 1.0), HOF_K).cpu().numpy())
    out["hof_launches"] = {k: _kernels.LAUNCHES[k] - before[k] for k in ("eigh_jacobi", "assemble_members")}
    out["hofstadter"] = evb
    print("  %s hofstadter_fn square q40: 41 fluxes x 16 k x %d bands, range [%.6f, %.6f]  [%.2f s]"
          % (where, evb.shape[-1], evb.min(), evb.max(), sec))
    check(evb.shape == (41, 16, 40) and np.isfinite(evb).all(), "bad Hofstadter eigenvalues %s" % (evb.shape,))
    lab, sec = timed(pt.magnetic.streda_labels, pt.models.square(), 1, 5, nk=21)
    out["streda"] = np.array(lab["labels"], float)
    print("  %s streda_labels square 1/5 nk 21: %s  [%.2f s]" % (where, lab["labels"], sec))
    # TKNN: r = s q + t p with |t| <= q / 2 gives t = 1, 2, -2, -1
    check(lab["labels"] == [1, 2, -2, -1] and lab["filling"] == [1, 2, 3, 4],
          "Streda labels %s are not TKNN's" % lab["labels"])

    # bbh_quadrupole_21x21
    n = S7["quadrupole"]
    q, sec = timed(pt.flows.quadrupole, pt.models.bbh(gamma=0.5), nk=(n, n))
    out["quadrupole"] = np.concatenate([q["px"], q["py"], [q["qxy"]]])
    print("  %s quadrupole bbh %dx%d: qxy %.10f, Wannier gap %.4f  [%.2f s]" % (where, n, n, q["qxy"],
                                                                             q["wannier_gap"], sec))
    check(abs(q["qxy"] - 0.5) < 1e-3, "BBH qxy %.6f is not 1/2" % q["qxy"])

    # spin_chern_41x41
    n = S7["spin_chern"]
    sc, sec = timed(pt.flows.spin_chern, pt.models.kane_mele(esite=1.0), (0, 1), nk=(n, n))
    out["spin_chern"] = np.array([sc["spin_chern"], sc["chern_plus"], sc["chern_minus"], sc["sz_gap"]])
    print("  %s spin_chern kane_mele %dx%d: Cs %.10f, sz gap %.4f  [%.2f s]" % (where, n, n, sc["spin_chern"],
                                                                          sc["sz_gap"], sec))
    check(abs(abs(sc["spin_chern"]) - 1.0) < 1e-3, "spin Chern %.6f is not +-1" % sc["spin_chern"])

    # sector_chern_bilayer_41x41
    n = S7["sector"]
    rs, sec = timed(pt.flows.sector_chern, haldane_bilayer(pt), (0, 1), np.array([1.0, 1.0, -1.0, -1.0]),
                    nk=(n, n))
    out["sector"] = np.array([rs["chern_plus"], rs["chern_minus"], rs["gap"]])
    print("  %s sector_chern haldane bilayer %dx%d: C+ %.10f, C- %.10f, gap %.4f  [%.2f s]"
          % (where, n, n, rs["chern_plus"], rs["chern_minus"], rs["gap"], sec))
    check(abs(rs["chern_plus"] + 1.0) < 1e-3 and abs(rs["chern_minus"] - 1.0) < 1e-3,
          "sector Chern C+ %.6f, C- %.6f are not -1, +1" % (rs["chern_plus"], rs["chern_minus"]))

    # weyl_node_search_40cube
    wy = pt.models.weyl()
    (kn, gn), sec = timed(pt.flows.find_nodes, wy, band=0, nk=S7["nodes"], gap_tol=0.05)
    chis, sec2 = timed(lambda: [pt.flows.node_chirality(wy, k, band=0) for k in kn])
    targets = [np.array([0.0, 0.0, 0.25]), np.array([0.0, 0.0, 0.75])]
    dev = max((min(np.linalg.norm((k - t) - np.round(k - t)) for t in targets) for k in kn), default=1e9)
    order = np.argsort(kn[:, 2])
    out["weyl"] = np.concatenate([kn[order].ravel(), np.array(chis, float)[order]])
    print("  %s find_nodes weyl %d^3 + node_chirality: %d nodes, deviation %.2e, charges %s  [%.2f s + %.2f s]"
          % (where, S7["nodes"], len(kn), dev, sorted(chis), sec, sec2))
    check(len(kn) == 2 and dev < 2e-3 and sorted(chis) == [-1, 1], "Weyl nodes %s, charges %s" % (kn, chis))

    # a family whose stacked eigensolve is 40 x 40 (kernel 7)
    fam = pt.family(haldane_family(pt))
    n = S7["family"]
    c, sec = timed(fam.chern, nocc=[1, 4, 20], nk=(n, n))
    out["family"] = c
    print("  %s family of haldane supercells (2, 8, 40 states), %dx%d: Chern %s  [%.2f s]"
          % (where, n, n, np.array2string(c, precision=10), sec))
    check(np.abs(c + 1.0).max() < 1e-8, "family Chern numbers %s are not -1" % c)
    (e, dos), sec = timed(pt.flows.density_of_states, pt.models.haldane(), (64, 64), n_energies=401)
    out["dos"] = dos
    integral = float(np.trapezoid(dos, e))
    print("  %s density_of_states haldane 64x64, 401 E: integral %.8f  [%.2f s]" % (where, integral, sec))
    check(abs(integral - 2.0) < 1e-3, "DOS integral %.6f is not 2" % integral)

    # the second Chern number of the Fu-Kane-Mele beta cycle
    L = S7["c2_slices"]
    loop = [pt.models.fu_kane_mele(beta=2 * np.pi * i / L) for i in range(L)]
    if not reference:
        c2, sec = timed(pt.flows.second_chern, loop, (0, 1), nk=(S7["c2"],) * 3)
        print("  %s second_chern fkm beta cycle, %d slices, %d^3 k, refined: C2 %.6f  [%.2f s]"
              % (where, L, S7["c2"], c2, sec))
        check(abs(c2 + 1.0) < 0.02, "second Chern number %.6f is not -1" % c2)
    out["c2_cpu"], sec = timed(pt.flows.second_chern, loop, (0, 1), nk=(S7["c2_cpu"],) * 3, refine=False)
    print("  %s second_chern fkm, %d^3 k, unrefined (the CPU comparison's grid): %.10f  [%.2f s]"
          % (where, S7["c2_cpu"], out["c2_cpu"], sec))
    return out


def compare_slice7(out, ref):
    """The seventh slice on the card against the CPU run: eigenvalues, the
    DOS and the invariants within 1e-10 (relative to the largest entry);
    the Weyl nodes within 5e-6 (the descent's resolution: the gap is a
    cone at a node, and rounding picks the last steps' directions)."""
    for key, tol, note in (("hofstadter", 1e-10, " (41 x 16 x 40)"), ("streda", 0.0, " (labels)"),
                           ("quadrupole", 1e-10, " (px, py, qxy)"), ("spin_chern", 1e-10, ""),
                           ("sector", 1e-10, ""), ("weyl", 5e-6, " (nodes and charges)"),
                           ("family", 1e-10, ""), ("dos", 1e-10, ""), ("c2_cpu", 1e-10, " (8^3, unrefined)")):
        got, want = np.asarray(out[key]), np.asarray(ref[key])
        check(got.shape == want.shape, "%s: shape differs from the CPU run" % key)
        err = float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))
        print("  %s vs CPU%s: max|diff| %.3e (relative)" % (key, note, err))
        check(err <= tol, "%s differs from the CPU path by %.3e (relative, limit %.0e)" % (key, err, tol))


PUMP_NL, PUMP_NK = 41, 31  # examples/pump_tools.py
S8 = {"si_nk": 16, "si_coarse": 8, "si_steps": 400, "unfold_k": 121, "ent_L": 20, "ent_nk": 61, "km_grid": 41}
SI_PATH = [[0.5, 0.5, 0.5], [0, 0, 0], [0.5, -0.5, 0.0]]  # si_valence_mlwf_multigrid_16: 51 points
SYM_HALDANE = ((0.2, 0.5), (0.2, -0.5), (1.5, 0.5), (0.5, 0.25), (0.9, -0.75))  # examples/symmetry_indicators.py
SYM_QWZ = (-1.0, 1.0, 2.5)
# whole MV runs, card against the CPU or the plain run (PERF.md section 2): the
# gauge-invariant Omega_I, the final Omega, and the history, centres, bands and
# projection sv (observed: 6e-14 / 5e-12, 9.2e-11, and at most 2.2e-9)
MV_TOL = {"omega_i": 1e-10, "omega": 1e-9, "history": 1e-7, "bands": 1e-7}


def cost_transport_chain(outer, L, inner, S, F):
    """Kernel 14's chain: the S selected rows of every point read once, the
    prefixes written; S^2 F complex multiply-adds a link, O(S^3) for the
    polar factor and the product."""
    pts = outer * L * inner
    nbytes = pts * S * F * C128 + pts * S * S * C128 + outer * inner * F64
    return bound(nbytes, outer * inner * (L - 1) * (8.0 * S * S * F + 80.0 * S**3))


def cost_transport_rotate(outer, L, inner, S, NS, F):
    """Kernel 14's rotate: the grid read once and written once, the prefixes
    and the holonomy eigenpairs read; S^2 F complex multiply-adds a point
    and the two S^3 products of Lambda^{-t}, at the FP64 tensor cores' rate
    (the card's peak for a product, whichever design runs, as
    cost_position)."""
    pts = outer * L * inner
    nbytes = 2 * pts * NS * F * C128 + pts * S * S * C128 + outer * inner * (S * S * C128 + S * F64)
    return bound(nbytes, pts * (8.0 * S * S * F + 16.0 * S**3), FP64_TC_FLOPS_PER_S)


def cost_transport_follow(outer, L, inner, NS, nocc, F):
    """Kernel 14's follow: every state read once, the followed rows, the
    indices and the fidelities written; nocc NS F multiply-adds a step."""
    pts = outer * L * inner
    nbytes = pts * NS * F * C128 + pts * nocc * (F * C128 + I64) + outer * (L - 1) * inner * F64
    return bound(nbytes, pts * (8.0 * nocc * NS * F + 8.0 * nocc * nocc * F + 80.0 * nocc**3))


def cost_mv_step(B, nb, n, steps=1):
    """Kernel 19 per step: M0 read, M written, U and dW read and written
    (the per-k partial sums are small); 2 n^3 complex products a (k, b) and
    the gradient and exp(dW) per k."""
    nbytes = 2 * B * nb * n * n * C128 + 4 * B * n * n * C128
    return bound(steps * nbytes, steps * (B * nb * (16.0 * n**3 + 60.0 * n * n) + B * 400.0 * n**3))


def silicon_model(pt):
    """The silicon MLWF row's model: Wannier90 silicon, hops below 0.01 eV dropped."""
    return pt.w90(str(ROOT / "tests" / "data" / "w90_silicon"), "silicon").model(min_hopping_norm=0.01)


def pump_grid(pt):
    """examples/pump_tools.py's family fill: the 3-site pump on 41 lambda x 31 k."""
    wf = pt.wf_array(pt.models.three_site_chain(0.0), [PUMP_NL, PUMP_NK])
    gaps = wf.solve_on_grid_models([pt.models.three_site_chain(lam) for lam in np.linspace(0.0, 1.0, PUMP_NL)],
                                   param_dir=0)
    wf.impose_loop(0)
    return wf, gaps


def silicon_overlaps(torch, pt, nk):
    """The silicon MLWF row's coarse-grid overlaps M0 (projected gauge) and
    shells, built by the port's own helpers on the current device."""
    from pythtb_tpu_torch import wannier

    si = silicon_model(pt)
    data = si._get_finalized()
    t = torch.as_tensor(wannier.WannierInterpolator._t_orb(si)).to(data.device)
    _, _, u = wannier._grid_solve(data, nk, t)
    u = u[:, :4]
    V0, _ = wannier._project_gauge(u, torch.eye(8, dtype=torch.complex128, device=data.device)[:4], False)
    nbr, w_b, b_cart = wannier._shells_on(si, nk, data.device)
    return wannier._rotated_overlaps(u, V0, nbr), nbr, w_b, b_cart


def slice8_kernels(torch, pt, device, record, held):
    """Phase 3 for kernels 14 and 19.  Kernel 14's chain, rotate (closed
    and open) and follow modes against their plain versions at 1e-12: the
    pump's 41 x 31 grid (nocc 1 of 3 states, F 3) along k (smoothing) and
    lambda (following), and a 41 x 41 Kane-Mele grid (nspin 2, nocc 2 of 4,
    F 4) along both axes.  Kernel 19: single MV steps on the silicon row's
    coarse 8^3 overlaps (from the start and from the state after 40 steps)
    at 1e-12, and the whole 400-step run against the plain run on
    Omega_I, Omega and the history (PERF.md section 2)."""
    from pythtb_tpu_torch import wannier
    from pythtb_tpu_torch.ops import berry, transport

    wp, _ = pump_grid(pt)
    kmw = pt.wf_array(pt.models.kane_mele(), [S8["km_grid"]] * 2)
    kmw.solve_on_grid([0.0, 0.0])
    cases = [("pump 41x31 along k, nocc 1 of 3", wp, 1, [0], True),
             ("pump 41x31 along lambda, nocc 1 of 3", wp, 0, [0], False),
             ("kane_mele 41x41 nspin 2 along k1, nocc 2 of 4", kmw, 1, [0, 1], False),
             ("kane_mele 41x41 nspin 2 along k0, nocc 2 of 4", kmw, 0, [0, 1], False)]
    for key, wf, axis, occ, main in cases:
        w5, _ = transport._strings(wf._device_states(), wf._nspin, 2, axis)
        w5 = w5.contiguous()
        outer, L, inner, NS, F = w5.shape
        occ_t = torch.as_tensor(occ, dtype=torch.int64, device=device)
        S = len(occ)
        C, smin = transport._chain(w5, occ_t)
        Cp, sp = transport._chain_plain(w5, occ_t)
        ws = w5[:, :, :, occ_t]
        ovr = berry._overlap(ws[:, :-1], ws[:, 1:]).contiguous()

        def polar_links():
            U, _, Vh = torch.linalg.svd(ovr, full_matrices=False)
            return U @ Vh

        record("transport_chain", key, max(max_diff(torch, C, Cp), max_diff(torch, smin, sp)),
               lambda: transport._chain(w5, occ_t), lambda: transport._chain_plain(w5, occ_t),
               cost_transport_chain(outer, L, inner, S, F), main, cuda_ms(torch, polar_links), reps=REPS if main else 5)
        theta, P = (t.contiguous() for t in berry.unitary_eig(Cp[:, -1].contiguous()))
        for closed in (True, False):
            err = max_diff(torch, transport._rotate(w5, occ_t, Cp, theta, P, closed),
                           transport._rotate_plain(w5, occ_t, Cp, theta, P, closed))
            record("transport_rotate", "%s, %s" % (key, "closed" if closed else "open"), err,
                   lambda: transport._rotate(w5, occ_t, Cp, theta, P, closed),
                   lambda: transport._rotate_plain(w5, occ_t, Cp, theta, P, closed),
                   cost_transport_rotate(outer, L, inner, S, NS, F), main and closed,
                   cuda_ms(torch, lambda: torch.matmul(Cp.conj(), ws)), reps=REPS if main else 5)
        idx, fid, st = transport._follow(w5, occ_t)
        idx_p, fid_p, st_p = transport._follow_plain(w5, occ_t)
        check(torch.equal(idx, idx_p), "transport_follow %s: the followed indices differ from the plain version" % key)
        record("transport_follow", key, max(max_diff(torch, fid, fid_p), max_diff(torch, st, st_p)),
               lambda: transport._follow(w5, occ_t), lambda: transport._follow_plain(w5, occ_t),
               cost_transport_follow(outer, L, inner, NS, S, F), key.startswith("pump") and axis == 0,
               reps=REPS if NS == 3 else 5)

    M0, nbr, w_b, b_cart = silicon_overlaps(torch, pt, (S8["si_coarse"],) * 3)
    B, nb, n, _ = M0.shape
    print("  silicon coarse %d^3: %d k-points, %d b-vectors (_bshells), nw %d" % (S8["si_coarse"], B, nb, n))
    eps0 = 0.5 / (4.0 * float(w_b.sum()))
    U40, _, _ = wannier._mv_run_plain(M0, nbr, w_b, b_cart, 40, eps0)
    rng = np.random.default_rng(8)
    X = torch.as_tensor(rng.normal(size=(B, n, n)) + 1j * rng.normal(size=(B, n, n))).to(device)
    dW40 = (1e-3 * (X - X.conj().transpose(-1, -2))).contiguous()
    eye = torch.eye(n, dtype=torch.complex128, device=device).expand(B, n, n).contiguous()
    for key, U, dW, eps, om_prev, main in (("silicon 8^3 first step", eye, torch.zeros_like(eye), eps0, math.inf, True),
                                           ("silicon 8^3 after 40 steps, overshoot", U40.contiguous(), dW40,
                                            3.0 * eps0, -1.0, False)):
        got = wannier.mv_step(M0, nbr, w_b, b_cart, U, dW, eps, om_prev, eps0)
        want = wannier._mv_step_plain(M0, nbr, w_b, b_cart, U, dW, torch.tensor(eps, dtype=torch.float64, device=device),
                                      torch.tensor(om_prev, dtype=torch.float64, device=device), 20.0 * eps0)
        err = max(max_diff(torch, a, b) / max(1.0, float(b.abs().max())) for a, b in zip(got, want))
        record("mv_step", key, err, lambda: wannier.mv_step(M0, nbr, w_b, b_cart, U, dW, eps, om_prev, eps0),
               lambda: wannier._mv_step_plain(M0, nbr, w_b, b_cart, U, dW, torch.tensor(eps, dtype=torch.float64, device=device),
                                              torch.tensor(om_prev, dtype=torch.float64, device=device), 20.0 * eps0),
               cost_mv_step(B, nb, n), main, reps=REPS if main else 5)
    steps = S8["si_steps"]
    U, hist, (rbar, oi, ot) = wannier.mv_localize(M0, nbr, w_b, b_cart, steps, 0.5)
    Up, hp, (rp, oip, otp) = wannier._mv_run_plain(M0, nbr, w_b, b_cart, steps, eps0)
    e_oi = abs(float(oi) - float(oip)) / abs(float(oip))
    e_om = abs(float(oi + ot) - float(oip + otp)) / abs(float(oip + otp))
    e_h = max_diff(torch, hist, hp) / float(hp.abs().max())
    e_r = max_diff(torch, rbar, rp) / max(1.0, float(rp.abs().max()))
    print("  mv_step         silicon 8^3 %d-step run vs plain run: Omega_I %.3e, Omega %.3e, history %.3e, "
          "centres %.3e (relative; limits %.0e, %.0e, %.0e, %.0e); Omega %.10f -> %.10f, Omega_I %.10f"
          % (steps, e_oi, e_om, e_h, e_r, MV_TOL["omega_i"], MV_TOL["omega"], MV_TOL["history"],
             MV_TOL["history"], float(hist[0]), float(hist[-1]), float(oi)))
    check(e_oi <= MV_TOL["omega_i"] and e_om <= MV_TOL["omega"] and e_h <= MV_TOL["history"]
          and e_r <= MV_TOL["history"], "kernel 19's whole run departs from the plain run")
    record("mv_step", "silicon 8^3 whole %d-step run" % steps, 0.0,
           lambda: wannier.mv_localize(M0, nbr, w_b, b_cart, steps, 0.5),
           lambda: wannier._mv_run_plain(M0, nbr, w_b, b_cart, steps, eps0), cost_mv_step(B, nb, n, steps),
           reps=3, profile=True, prof_reps=1, prof_plain=False)


def _cluster_sums(evals, w, tol=1e-8):
    """Unfolding weights summed over clusters of degenerate energies (a
    weight inside a degenerate eigenspace is basis dependent), in
    ascending energy order."""
    out = []
    for e, x in zip(evals, w):
        order = np.argsort(e, kind="stable")
        e, x = e[order], x[order]
        cut = np.concatenate([[0], np.nonzero(np.diff(e) > tol)[0] + 1, [len(e)]])
        out.append([x[a:b].sum() for a, b in zip(cut[:-1], cut[1:])])
    return out


def slice8_path(pt, where, reference):
    """The eighth slice's rows of tools/bench_suite.py with their pins:
    si_valence_mlwf_multigrid_16 (:277; coarse 8^3 MLWF, 400 MV steps,
    16^3 refinement, polish 0: band error < 2e-2 eV on the 51-point path,
    projection sv > 0.9), unfold_50band_121k (:377; weights sum to 2 within
    1e-3), entanglement_flow_L20_61k (:388; min |xi - 1/2| < 0.02);
    examples/pump_tools.py at its published 41 x 31 (|C| and the winding
    within 1e-3 and 1e-2 of 1, min fidelity > 0.97, link-phase spread
    < 1e-8 after smooth_gauge); and examples/symmetry_indicators.py's
    chern_indicator calls against chern_number 41 x 41.  The same at full
    width on the CPU for the comparison."""
    import warnings

    from pythtb_tpu_torch.ops import _kernels

    out = {}

    def timed(fn, *args, **kwargs):
        t0 = time.perf_counter()
        result = fn(*args, **kwargs)
        return result, time.perf_counter() - t0

    # si_valence_mlwf_multigrid_16
    si = silicon_model(pt)
    before = dict(_kernels.LAUNCHES)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        itp, sec = timed(pt.wannier.interpolator, si, [0, 1, 2, 3], nk=S8["si_nk"], trial=np.eye(8)[:4],
                         localize=S8["si_steps"], coarse_nk=S8["si_coarse"], polish=0)
    out["si_launches"] = {k: _kernels.LAUNCHES[k] - before[k] for k in ("mv_step", "mv_final")}
    kp = si.k_path(SI_PATH, 51, report=False)[0]
    out["si_mlwf_bands"] = itp.bands(kp)
    dev = float(np.abs(out["si_mlwf_bands"] - si.solve_all(kp)[:4]).max())
    out["si_mlwf_omega"] = np.array([itp.omega_i, itp.omega_i + itp.omega_tilde, itp.min_projection_sv])
    print("  %s wannier.interpolator silicon valence, coarse 8^3 x 400 MV steps -> 16^3: band error %.3e eV, "
          "projection sv %.4f, Omega_I %.8f, Omega %.8f  [%.2f s]"
          % (where, dev, itp.min_projection_sv, itp.omega_i, itp.omega_i + itp.omega_tilde, sec))
    check(dev < 2e-2 and itp.min_projection_sv > 0.9, "silicon MLWF: error %.3e, sv %.4f" % (dev, itp.min_projection_sv))

    # unfold_50band_121k
    gm = pt.models.graphene()
    M5 = np.diag([5, 5])
    sc5 = gm.make_supercell(M5)
    kl = np.linspace(0.0, 0.5, S8["unfold_k"])[:, None] * np.array([[1.0, 2.0]])
    (ue, uw), sec = timed(pt.unfold.unfold_bands, sc5, M5, kl)
    out["unfold_e"], out["unfold_w"] = ue, uw
    err = float(np.abs(uw.sum(axis=1) - 2.0).max())
    print("  %s unfold_bands graphene 5x5 (50 bands) onto 121 k: sum-rule error %.3e  [%.2f s]" % (where, err, sec))
    check(ue.shape == (121, 50) and err < 1e-3, "unfold sum rule off by %.3e" % err)

    # entanglement_flow_L20_61k
    (kpar, xi), sec = timed(pt.entanglement.entanglement_flow, pt.models.haldane(), [0], 0, L=S8["ent_L"],
                            nk=S8["ent_nk"])
    out["ent_xi"] = xi
    mid = float(np.abs(xi - 0.5).min())
    print("  %s entanglement_flow haldane L 20, 61 k: min |xi - 1/2| %.3e  [%.2f s]" % (where, mid, sec))
    check(xi.shape == (61, 20) and mid < 0.02, "entanglement flow mid-gap %.3e" % mid)

    # examples/pump_tools.py at its published widths
    (wf, gaps), sec = timed(pump_grid, pt)
    chern = wf.berry_flux([0], dirs=[0, 1]) / (2.0 * np.pi)
    idx, fid = wf.adiabatic_evolve([0], dir=0)
    flow = wf.berry_phase([0], dir=1, contin=True)
    winding = (flow[-1] - flow[0]) / (2.0 * np.pi)
    wf.smooth_gauge([0], dir=1, closed=True)
    w = np.asarray(wf._wfs)[0, :, 0, :]
    ang = np.angle(np.einsum("kf,kf->k", w[:-1].conj(), w[1:]))
    spread = float(ang.max() - ang.min())
    out["pump"] = np.array([chern, winding, fid.min()])
    out["pump_idx"], out["pump_fid"], out["pump_links"] = idx.astype(float), fid, ang
    print("  %s pump_tools 41 x 31: Chern %.8f, winding %.8f, band %d -> %d, min fidelity %.6f, link-phase spread "
          "%.2e  [%.2f s]" % (where, chern, winding, idx[0, 0, 0], idx[-1, 0, 0], fid.min(), spread, sec))
    check(abs(abs(chern) - 1.0) < 1e-3 and abs(abs(winding) - 1.0) < 1e-2, "pump Chern %.6f, winding %.6f"
          % (chern, winding))
    check(fid.min() > 0.97 and spread < 1e-8, "pump fidelity %.4f, spread %.2e" % (fid.min(), spread))

    # examples/symmetry_indicators.py's chern_indicator calls
    sym = []
    t0 = time.perf_counter()
    for delta, phi in SYM_HALDANE:
        m = pt.models.haldane(delta=delta, t2=0.15 * np.exp(1j * np.pi * phi))
        res = pt.symmetry.chern_indicator(m, occ=[0])
        C = int(round(pt.flows.chern_number(m, [0], nk=(41, 41))))
        check(res["c_mod_n"] == C % res["n"], "haldane (%g, %g): indicator %s vs C %d" % (delta, phi, res, C))
        sym.append([C, res["c_mod_n"], res["n"]])
    for u in SYM_QWZ:
        res = pt.symmetry.chern_indicator(pt.models.qwz(u), occ=[0], l=[0, 1])
        C = int(round(pt.flows.chern_number(pt.models.qwz(u), [0], nk=(41, 41))))
        check(res["c_mod_n"] == C % res["n"], "qwz %g: indicator %s vs C %d" % (u, res, C))
        sym.append([C, res["c_mod_n"], res["n"]])
    out["sym"] = np.array(sym, float)
    print("  %s symmetry.chern_indicator, 5 Haldane + 3 QWZ models vs chern_number 41x41: (C, C mod n, n) %s  "
          "[%.2f s]" % (where, sym, time.perf_counter() - t0))
    return out


def compare_slice8(out, ref):
    """The eighth slice on the card against the CPU run: entanglement
    spectra, unfolding energies and the weights summed over degenerate
    clusters, the pump's invariants, fidelities, indices and smoothed link
    phases, and the indicators within 1e-10 (relative to the largest
    entry); the silicon MLWF bands, spreads and fine-grid projection sv,
    which end a whole MV run, at MV_TOL (Omega_I 1e-10, Omega 1e-8, bands
    1e-6 relative, the sv 1e-6)."""
    for key, tol in (("ent_xi", 1e-10), ("unfold_e", 1e-10), ("pump", 1e-10), ("pump_idx", 0.0),
                     ("pump_fid", 1e-10), ("pump_links", 1e-10), ("sym", 0.0), ("si_mlwf_bands", MV_TOL["bands"])):
        got, want = np.asarray(out[key]), np.asarray(ref[key])
        check(got.shape == want.shape, "%s: shape differs from the CPU run" % key)
        err = float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))
        print("  %s vs CPU: max|diff| %.3e (relative)" % (key, err))
        check(err <= tol, "%s differs from the CPU path by %.3e (relative, limit %.0e)" % (key, err, tol))
    got = _cluster_sums(out["unfold_e"], out["unfold_w"])
    want = _cluster_sums(ref["unfold_e"], ref["unfold_w"])
    check([len(g) for g in got] == [len(w) for w in want], "unfold: degenerate clusters differ from the CPU run")
    err = max(float(np.abs(np.array(g) - np.array(w)).max()) for g, w in zip(got, want))
    print("  unfold weights summed over degenerate clusters vs CPU: max|diff| %.3e" % err)
    check(err <= 1e-10, "unfold cluster weights differ from the CPU path by %.3e" % err)
    (oi, om, sv), (roi, rom, rsv) = out["si_mlwf_omega"], ref["si_mlwf_omega"]
    e_oi, e_om, e_sv = abs(oi - roi) / abs(roi), abs(om - rom) / abs(rom), abs(sv - rsv)
    print("  silicon MLWF vs CPU: Omega_I %.3e, Omega %.3e (relative), projection sv %.3e" % (e_oi, e_om, e_sv))
    check(e_oi <= MV_TOL["omega_i"] and e_om <= MV_TOL["omega"] and e_sv <= MV_TOL["history"],
          "silicon MLWF spreads differ from the CPU run")


# -- the ninth slice: interacting clusters and DMFT -----------------------------

S9 = {"ed_L": 8, "ed_cpu_L": 6, "arpes_k": 1001, "arpes_w": 2001, "arpes_cpu_k": 101, "arpes_cpu_w": 201,
      "bcs_nk": 36, "hf_L": 6}
ARPES_PATH = [[0, 0], [0.5, 0], [0.5, 0.5], [0, 0]]
HUBBARD_ED_U = np.linspace(0.0, 10.0, 11)  # examples/hubbard_ed.py
HUBBARD_ED_W = np.linspace(-6.0, 10.0, 601)
BCS_G = np.linspace(1.0, 3.0, 7)  # examples/mean_field.py's BCS panel
MAJORANA_MU = np.linspace(-3.0, 3.0, 25)  # examples/majorana.py
HALDANE_NN_V = [(0.5, 0, 1, (0, 0)), (0.5, 1, 0, (1, 0)), (0.5, 1, 0, (0, 1))]  # many_body_chern_2x2_interacting


def ring(pt, L):
    """The L-site nearest-neighbour Hubbard ring of the ED rows."""
    return pt.models.chain().cut_piece(L, 0, glue_edgs=True)


def hubbard_sector(pt, L, U):
    """The half-filled (L/2, L/2) sector matrix that ed.hubbard builds for
    an L-ring (D = C(L, L/2)^2), on the host."""
    ed = pt.ed
    h = ed.dense_h(ring(pt, L))
    bu = ed.sector_basis(L, L // 2)
    T = ed.build_sector(h, bu)
    D1 = len(bu)
    H = np.kron(T, np.eye(D1)) + np.kron(np.eye(D1), T)
    occ = ed._occupations(bu, L)
    H[np.diag_indices(D1 * D1)] += U * np.einsum("ui,di->ud", occ, occ).reshape(-1)
    return H


def spinful_sector(pt, L, U):
    """The general-layout (spinful) half-filled sector of an L-ring with
    Hubbard U: D = C(2L, L)."""
    ed = pt.ed
    hm, vmat, nmodes, _ = ed._general_setup(ring(pt, L), U, None, True)
    return ed.build_sector(hm, ed.sector_basis(nmodes, L), vmat)


def arpes_model(pt):
    """dmft_arpes_resolved_1001k_2001w's model: one correlated square-lattice
    orbital and seven spectators."""
    mb = pt.tb_model(2, 2, [[1.0, 0.0], [0.0, 1.0]], [[0.0, 0.0]] * 8)
    mb.set_onsite([0.0, -3.0, -2.0, -1.0, 1.5, 2.5, 3.5, 4.5])
    for o in range(8):
        mb.set_hop(-1.0 if o == 0 else -0.4, o, o, [1, 0])
        mb.set_hop(-1.0 if o == 0 else -0.4, o, o, [0, 1])
    for o in range(1, 8):
        mb.set_hop(0.25, 0, o, [0, 0])
    return mb


def gershgorin_filter_args(H):
    """(c, hw) of the ED solver's first filter round: the window above
    lo + 10% of the Gershgorin range mapped onto [-1, 1]."""
    radii = np.sum(np.abs(H), axis=1) - np.abs(np.diag(H))
    hi, lo = float(np.max(np.diag(H).real + radii)), float(np.min(np.diag(H).real - radii))
    cut = lo + 0.1 * (hi - lo)
    return 0.5 * (cut + hi), 0.5 * (hi - cut)


def cost_dense_filter(D, nb, steps):
    """Kernel 11b: H read once a step where it is larger than the H100's
    50 MB L2 (a step needs the whole previous block), else once; X read
    once, F written once; per step the complex (D x D) x (D x nb) product
    (8 D^2 nb) and the epilogue (~12 per element), all at the FP64 tensor
    cores' rate (the product's peak, whichever design runs it)."""
    h_reads = steps if D * D * C128 > 50e6 else 1
    return bound(h_reads * D * D * C128 + 2 * D * nb * C128, steps * (8 * D * D * nb + 12 * D * nb),
                 FP64_TC_FLOPS_PER_S)


def cost_pole(mode, Nk, nv, nw):
    """Kernel 20: inputs read once, outputs written once; per (k, w) the
    nv reciprocals R_m (~8 ops each) and their weighted sum (4), the Schur
    reciprocal (~10); the resolved mode adds per spectator j the c, d and
    |W|^2 sums (20 nv) and c G d (8).  The pole mode counts (t, w) pairs
    (~10 ops each)."""
    if mode == "pole":
        return bound(2 * Nk * F64 + 3 * nw * C128, Nk * nw * 10)
    per = 12 * nv + 10
    nbytes = Nk * F64 * (1 + 2 * nv) + 2 * nw * C128
    if mode == "kmean":
        return bound(nbytes + nw * C128, Nk * nw * (per + 2))
    if mode == "map":
        return bound(nbytes + Nk * nw * F64, Nk * nw * per)
    nbytes = Nk * (F64 * (1 + nv) + C128 * (nv * nv + nv)) + 2 * nw * C128 + Nk * nw * (1 + nv) * F64
    return bound(nbytes, Nk * nw * (per + nv * (20 * nv + 8)))


def col_rel(torch, a, b):
    """max over columns of max|a - b| / max|b| (column by column)."""
    torch.cuda.synchronize()
    check(a.shape == b.shape and bool(torch.isfinite(a).all()), "kernel 11b: bad output")
    return float(((a - b).abs().amax(dim=0) / b.abs().amax(dim=0)).max())


def slice9_kernels(torch, pt, device, record, held):
    """Phase 3 for kernels 11b and 20.  Kernel 11b at the ed_hubbard row's
    4,900-dim sector (nb 10, the solver's first window): one step at 1e-12
    of each column's largest entry, the whole p = 30 filter at 1e-10; the
    6-ring's D 400 and the spinful-layout D 924 sector filtered whole on
    both designs, each timed beside the recurrence as torch.matmul steps.
    Kernel 20's four modes at the DMFT rows' shapes at 1e-12 (relative):
    the k-mean at the ARPES row's lattice (Nk 256, nv 7, 96 Matsubara
    points), the pole mode at the Bethe quadrature (512 nodes x 128) and
    an AIM's Lehmann poles, the map and resolved modes at 1001 k x 2001 w."""
    from pythtb_tpu_torch import dmft
    from pythtb_tpu_torch.ops import chebyshev, eigh, pole_sum

    rng = np.random.default_rng(9)
    t0 = time.perf_counter()
    H = hubbard_sector(pt, S9["ed_L"], 4.0)
    c, hw = gershgorin_filter_args(H)
    Hd = torch.as_tensor(H).to(device)
    del H
    D, nb = Hd.shape[0], 10
    X = torch.as_tensor(rng.normal(size=(D, nb)) + 1j * rng.normal(size=(D, nb))).to(device)
    print("  hubbard 8-site sector D %d built and uploaded in %.1f s" % (D, time.perf_counter() - t0))
    for p in (1, 2):
        err = col_rel(torch, chebyshev.dense_filter(Hd, X, p, c, hw), chebyshev._dense_filter_plain(Hd, X, p, c, hw))
        held("dense_filter", "hubbard D 4900 nb 10, %d step%s" % (p, "s" if p > 1 else ""), err)

    def library(Hm, Xm, cm, hwm, p=30):
        # the same recurrence as torch.matmul steps, without the rescale
        a, b = Xm, (Hm @ Xm - cm * Xm) / hwm
        for _ in range(p - 1):
            a, b = b, 2.0 * ((Hm @ b - cm * b) / hwm) - a
        return b

    got = chebyshev.dense_filter(Hd, X, 30, c, hw)
    err = col_rel(torch, got, chebyshev._dense_filter_plain(Hd, X, 30, c, hw))
    check(torch.equal(got, chebyshev.dense_filter(Hd, X, 30, c, hw)), "kernel 11b: a repeated call gave other bits")
    lib = cuda_ms(torch, lambda: library(Hd, X, c, hw), 5)
    record("dense_filter", "hubbard D 4900 nb 10, p 30", err, lambda: chebyshev.dense_filter(Hd, X, 30, c, hw),
           lambda: chebyshev._dense_filter_plain(Hd, X, 30, c, hw), cost_dense_filter(D, nb, 30), True,
           lib, reps=5, tol=1e-10, prof_reps=2)
    # the other design (the default is _dense_design's), timed in the same run
    for design in chebyshev._DENSE_DESIGNS:
        if design == chebyshev._dense_design(D, nb):
            continue
        err = col_rel(torch, chebyshev._dense_filter(Hd, X, 30, c, hw, design),
                      chebyshev._dense_filter_plain(Hd, X, 30, c, hw))
        record("dense_filter", "hubbard D 4900 nb 10, p 30, %s design" % design, err,
               lambda: chebyshev._dense_filter(Hd, X, 30, c, hw, design),
               lambda: chebyshev._dense_filter_plain(Hd, X, 30, c, hw), cost_dense_filter(D, nb, 30),
               library_ms=lib, reps=5, tol=1e-10)
    # other block widths at the sector: one to four n-tiles of 8, a ragged group
    for nbx in (1, 16, 17, 32):
        Xx = torch.as_tensor(rng.normal(size=(D, nbx)) + 1j * rng.normal(size=(D, nbx))).to(device)
        err = col_rel(torch, chebyshev.dense_filter(Hd, Xx, 2, c, hw), chebyshev._dense_filter_plain(Hd, Xx, 2, c, hw))
        record("dense_filter", "hubbard D 4900 nb %d, 2 steps" % nbx, err,
               lambda: chebyshev.dense_filter(Hd, Xx, 2, c, hw),
               lambda: chebyshev._dense_filter_plain(Hd, Xx, 2, c, hw), cost_dense_filter(D, nbx, 2),
               library_ms=cuda_ms(torch, lambda: library(Hd, Xx, c, hw, 2), 5), reps=5)
    del Hd
    for key, Hs in (("6-ring D 400, p 30", hubbard_sector(pt, 6, 4.0)),
                    ("spinful layout 6-ring D 924, p 30", spinful_sector(pt, 6, 4.0))):
        c6, hw6 = gershgorin_filter_args(Hs)
        H6 = torch.as_tensor(Hs).to(device)
        X6 = torch.as_tensor(rng.normal(size=(Hs.shape[0], nb)) + 1j * rng.normal(size=(Hs.shape[0], nb))).to(device)
        lib6 = cuda_ms(torch, lambda: library(H6, X6, c6, hw6), 5)
        for design in chebyshev._DENSE_DESIGNS:
            record("dense_filter", "%s, %s design" % (key, design),
                   col_rel(torch, chebyshev._dense_filter(H6, X6, 30, c6, hw6, design),
                           chebyshev._dense_filter_plain(H6, X6, 30, c6, hw6)),
                   lambda: chebyshev._dense_filter(H6, X6, 30, c6, hw6, design),
                   lambda: chebyshev._dense_filter_plain(H6, X6, 30, c6, hw6), cost_dense_filter(Hs.shape[0], nb, 30),
                   library_ms=lib6, reps=5, tol=1e-10)
        # the full path's one sector eigh (ed._eigh_dev): the library at D > 64
        m = Hs.shape[0]
        ms = cuda_ms(torch, lambda: eigh.eigh_batched(H6[None]), 5)
        print("  %-15s %-34s eigh_batched (torch.linalg.eigh) %.4f ms  bound %.5f ms (%s)"
              % ("sector eigh", "D %d" % m, ms, *cost_eigh(1, m)))
    # the twist grid's rows (ed._twist_chern_dev): 6 matrices of 70 x 70 a row
    At = rng.normal(size=(6, 70, 70)) + 1j * rng.normal(size=(6, 70, 70))
    Ht = torch.as_tensor(At + np.conj(np.swapaxes(At, -1, -2))).to(device)
    ms = cuda_ms(torch, lambda: eigh.eigh_batched(Ht), 5)
    print("  %-15s %-34s eigh_batched (torch.linalg.eigh) %.4f ms  bound %.5f ms (%s)"
          % ("twist row eigh", "B 6, D 70", ms, *cost_eigh(6, 70)))
    # kernel 16's Lorentzian mode at ed.spectral_function's shape: the
    # 6-ring's N+1 sector (792 poles) at examples/hubbard_ed.py's 601 w
    from pythtb_tpu_torch.optical import _spectral_sum_plain, spectral_sum

    Wl = torch.as_tensor(rng.random((1, 792)) + 0j).to(device)
    dl = torch.as_tensor(rng.uniform(-6.0, 10.0, 792)).to(device)
    oml = torch.as_tensor(HUBBARD_ED_W).to(device)
    want = _spectral_sum_plain(Wl, dl, oml, 0.15, "lorentz")
    record("spectral_sum", "ED Lehmann T 792 P 1 nw 601",
           max_diff(torch, spectral_sum(Wl, dl, oml, 0.15, "lorentz"), want),
           lambda: spectral_sum(Wl, dl, oml, 0.15, "lorentz"),
           lambda: _spectral_sum_plain(Wl, dl, oml, 0.15, "lorentz"),
           cost_spectral_sum(792, 1, 601, True), tol=1e-10, scale=float(want.abs().max()))

    def rel(a, b):
        torch.cuda.synchronize()
        check(a.shape == b.shape and bool(torch.isfinite(a).all()), "kernel 20: bad output")
        return float((a - b).abs().max()) / max(1.0, float(b.abs().max()))

    # k-mean: the ARPES row's lattice sum on the Matsubara axis
    prev = pt.config.device()
    pt.config.set_device(device)
    try:
        epso, amps, lams, _ = dmft._lattice_pole_data(arpes_model(pt), 0, 16)
    finally:
        pt.config.set_device(prev)
    wn = dmft.matsubara(15.0, 96)
    zm = torch.complex(torch.full((96,), 0.5, dtype=torch.float64), torch.as_tensor(wn)).to(device)
    sig = torch.as_tensor(1.0 - 0.5j * np.exp(-wn)).to(device)
    args = (epso, amps, lams, zm, sig)
    record("pole_sum", "k-mean Nk 256 nv 7 nw 96",
           rel(pole_sum.lattice_gloc(*args), pole_sum._lattice_gloc_plain(*args)),
           lambda: pole_sum.lattice_gloc(*args), lambda: pole_sum._lattice_gloc_plain(*args),
           cost_pole("kmean", 256, 7, 96))
    # pole mode: the Bethe quadrature (512 nodes x 128 w) and Lehmann poles
    j = np.arange(1, 513, dtype=np.float64)
    th = j * np.pi / 513
    nodes = torch.as_tensor(2.0 * np.cos(th)).to(device)
    weights = torch.as_tensor(np.sin(th) ** 2 / np.sum(np.sin(th) ** 2)).to(device)
    wb = dmft.matsubara(20.0, 128)
    zb = (torch.complex(torch.full((128,), 1.5, dtype=torch.float64), torch.as_tensor(wb))
          - torch.as_tensor(0.8 - 0.3j * np.exp(-wb))).to(device)
    record("pole_sum", "pole: Bethe 512 nodes x 128 w", rel(pole_sum.pole_sum(weights, nodes, zb),
                                                             pole_sum._pole_sum_plain(weights, nodes, zb)),
           lambda: pole_sum.pole_sum(weights, nodes, zb), lambda: pole_sum._pole_sum_plain(weights, nodes, zb),
           cost_pole("pole", 512, 1, 128),
           library_ms=cuda_ms(torch, lambda: (1.0 / (zb[:, None] - nodes[None, :])) @ weights.to(zb.dtype), 5))
    _, info = dmft._aim_solve(-1.5, 3.0, np.array([-1.2, -0.4, 0.4, 1.2]), np.array([0.5, 0.4, 0.4, 0.5]), 20.0, wb)
    a_t, p_t = torch.as_tensor(info["amps"]).to(device), torch.as_tensor(info["poles"]).to(device)
    zl = torch.complex(torch.zeros(128, dtype=torch.float64), torch.as_tensor(wb)).to(device)
    held("pole_sum", "pole: AIM Lehmann %d poles x 128 iw" % len(info["poles"]),
         rel(pole_sum.pole_sum(a_t, p_t, zl), pole_sum._pole_sum_plain(a_t, p_t, zl)))
    # map and resolved modes at the ARPES row
    mb = arpes_model(pt)
    kp = mb.k_path(ARPES_PATH, S9["arpes_k"], report=False)[0]
    prev = pt.config.device()
    pt.config.set_device(device)
    try:
        epso_k, lam_k, W_k, b_k = dmft._spectator_eigh(dmft._hk(mb, kp), 0)
    finally:
        pt.config.set_device(prev)
    om = np.linspace(-8.0, 8.0, S9["arpes_w"])
    zr = torch.as_tensor((om + 0.5) + 0.15j).to(device)
    sr = torch.as_tensor(1.0 - 0.4j / (1.0 + om ** 2)).to(device)
    amp_k = (b_k.abs() ** 2).contiguous()
    margs = (epso_k, amp_k, lam_k, zr, sr)
    Nk, nw = S9["arpes_k"], S9["arpes_w"]
    record("pole_sum", "map 1001 k x 2001 w nv 7",
           rel(pole_sum.spectral_map(*margs), pole_sum._spectral_map_plain(*margs)),
           lambda: pole_sum.spectral_map(*margs), lambda: pole_sum._spectral_map_plain(*margs),
           cost_pole("map", Nk, 7, nw), reps=5,
           library_ms=cuda_ms(torch, lambda: torch.einsum("km,kmw->kw", amp_k.to(zr.dtype),
                                                          1.0 / (zr[None, None, :] - lam_k[:, :, None])), 3))
    rargs = (epso_k, lam_k, W_k, b_k, zr, sr)
    got, want = pole_sum.spectral_resolved(*rargs), pole_sum._spectral_resolved_plain(*rargs)
    record("pole_sum", "resolved 1001 k x 2001 w nv 7", max(rel(got[0], want[0]), rel(got[1], want[1])),
           lambda: pole_sum.spectral_resolved(*rargs), lambda: pole_sum._spectral_resolved_plain(*rargs),
           cost_pole("resolved", Nk, 7, nw), True, reps=5, prof_reps=3)


def slice9_path(pt, where, reference):
    """The ninth slice's rows of tools/bench_suite.py with their pins:
    ed_hubbard_8site_4900dim (:539; 8-site ring, U 4, the 4,900-dim
    sector, lowest 4: E0 -4.603526 within 1e-3, docc 0.094926 within 2e-4;
    on the card the four values against the card's dense eigh of the same
    H at 1e-10), many_body_chern_2x2_interacting (:797; C -1 within
    5e-3), dmft_bethe_u3 (:702; converged, Z 0.484227 within 5e-3, docc
    0.123281 within 2e-3) and dmft_arpes_resolved_1001k_2001w (:725; mean
    orbital weight within 5e-2 of 1, A > -1e-6); examples/hubbard_ed.py
    (the HF >= ED bound at L 6 over 11 U, spectral functions at 601 w,
    <S^z_0 S^z_r>), examples/mean_field.py's BCS panel (nk 36, 7 g,
    against its independent gap equation) and examples/majorana.py's
    Majorana numbers and open-chain splittings.  The CPU reference runs
    the ED filter on the 6-ring (D 400) instead of the 8-ring, and the rest
    at full width."""
    import warnings

    from pythtb_tpu_torch.ops import _kernels

    out = {}

    def timed(fn, *args, **kwargs):
        t0 = time.perf_counter()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            result = fn(*args, **kwargs)
        return result, time.perf_counter() - t0

    # ed_hubbard_8site_4900dim (the CPU: the 6-ring)
    if not reference:
        before = _kernels.LAUNCHES["dense_filter"]
        r, sec = timed(pt.ed.hubbard, ring(pt, S9["ed_L"]), 4.0, 4, 4, lowest=4)
        out["ed_filter_steps"] = _kernels.LAUNCHES["dense_filter"] - before
        docc = float(r.double_occupancy().mean())
        print("  %s ed.hubbard 8-ring U 4, 4,900-dim sector, lowest 4: E0 %.8f docc %.8f, gap %.8f, %d filter steps "
              "[%.2f s]" % (where, r.energy, docc, r.gap, out["ed_filter_steps"], sec))
        check(abs(r.energy + 4.603526) < 1e-3 and abs(docc - 0.094926) < 2e-4,
              "ed_hubbard_8site_4900dim: E0 %.6f, docc %.6f" % (r.energy, docc))
        out["ed8_evals"] = r.evals
    r6, sec = timed(pt.ed.hubbard, ring(pt, S9["ed_cpu_L"]), 4.0, 3, 3, lowest=4)
    out["ed6_evals"], out["ed6_docc"] = r6.evals, r6.double_occupancy()
    print("  %s ed.hubbard 6-ring U 4, 400-dim sector, lowest 4: E0 %.12f  [%.2f s]" % (where, r6.energy, sec))

    # many_body_chern_2x2_interacting
    c, sec = timed(pt.ed.many_body_chern, pt.models.haldane(), (2, 2), nelec=4, interactions=HALDANE_NN_V, grid=6)
    out["mbc"] = np.array([c])
    print("  %s ed.many_body_chern haldane 2x2, 70-dim sector, 6x6 twists: C %.12f  [%.2f s]" % (where, c, sec))
    check(abs(c + 1.0) < 5e-3, "many_body_chern_2x2_interacting: C %.6f" % c)

    # dmft_bethe_u3
    rb, sec = timed(pt.dmft.bethe, 3.0, D=2.0, beta=20.0, n_matsubara=128, n_bath=4, max_iter=40)
    out["bethe"] = np.array([rb.Z, rb.docc, rb.iterations])
    print("  %s dmft.bethe U 3, 128 w, 4 bath sites: converged %s in %d iterations, Z %.8f docc %.8f  [%.2f s]"
          % (where, rb.converged, rb.iterations, rb.Z, rb.docc, sec))
    check(rb.converged and abs(rb.Z - 0.484227) < 5e-3 and abs(rb.docc - 0.123281) < 2e-3,
          "dmft_bethe_u3: converged %s, Z %.6f, docc %.6f" % (rb.converged, rb.Z, rb.docc))

    # dmft_arpes_resolved_1001k_2001w
    mb = arpes_model(pt)
    r42, sec = timed(pt.dmft.solve, mb, U=2.0, orb=0, beta=15.0, nk=16, n_matsubara=96, n_bath=3, max_iter=30)
    out["arpes_fixed_point"] = np.array([r42.Z, r42.docc, r42.mu])
    nk_map, nw_map = (S9["arpes_cpu_k"], S9["arpes_cpu_w"]) if reference else (S9["arpes_k"], S9["arpes_w"])
    kp = mb.k_path(ARPES_PATH, nk_map, report=False)[0]
    om = np.linspace(-8.0, 8.0, nw_map)
    before = _kernels.LAUNCHES["pole_sum"]
    a42, sec2 = timed(pt.dmft.band_spectral, r42, kp, om, eta=0.15, resolved=True)
    wsum = float(np.trapezoid(a42, om, axis=1).mean())
    print("  %s dmft.solve 8 orbitals nk 16, 96 w, 3 bath sites: Z %.8f in %d iterations [%.2f s]; band_spectral "
          "resolved %d k x %d w x 8: mean orbital weight %.6f, min A %.3e  [%.2f s]"
          % (where, r42.Z, r42.iterations, sec, nk_map, nw_map, wsum, float(a42.min()), sec2))
    check(abs(wsum - 1.0) < 5e-2 and bool(np.all(a42 > -1e-6)),
          "dmft_arpes_resolved: weight %.4f, min A %.3e" % (wsum, float(a42.min())))
    if not reference:
        out["arpes_launches"] = _kernels.LAUNCHES["pole_sum"] - before
        # the card's converged state and its map at the CPU's size, for the comparison
        out["arpes_state"] = {key: getattr(r42, key) for key in ("wn", "sigma", "g_loc", "g_imp", "g0_inv", "mu",
                                                                  "eps_d", "bath")}
        out["arpes_state"].update(amps=r42._amps, poles=r42._poles, orb=0, real_axis=(
            "pole", tuple(t.cpu().numpy() for t in r42._real_axis[1])))
        kps = mb.k_path(ARPES_PATH, S9["arpes_cpu_k"], report=False)[0]
        out["arpes_small"] = pt.dmft.band_spectral(r42, kps, np.linspace(-8.0, 8.0, S9["arpes_cpu_w"]), eta=0.15,
                                                   resolved=True)
        out["arpes_local"] = r42.local_spectral(om[::10], eta=0.15)

    # examples/hubbard_ed.py
    L = S9["hf_L"]
    t0 = time.perf_counter()
    rg = ring(pt, L)
    docc, e_ed, e_hf, hf_iters = [], [], [], []
    for U in HUBBARD_ED_U:
        r = pt.ed.hubbard(rg, U, L // 2, L // 2)
        docc.append(r.double_occupancy().mean())
        e_ed.append(r.energy)
        rh = pt.meanfield.hartree_fock(rg, U, float(L), temperature=2e-3, stagger=0.4, seed=1, max_iters=4000)
        e_hf.append(rh["energy"])
        hf_iters.append(rh["iters"])
    spec = np.stack([pt.ed.spectral_function(rg, L, HUBBARD_ED_W, U=U, eta=0.15, modes=[0, 1])[0].sum(axis=0)
                     for U in (0.0, 4.0, 8.0)])
    szsz = np.stack([pt.ed.hubbard(rg, U, L // 2, L // 2).szsz()[0] for U in (0.0, 4.0, 10.0)])
    out["hubbard_ed"] = np.array([docc, e_ed, e_hf, hf_iters])
    out["hubbard_ed_spec"], out["hubbard_ed_szsz"] = spec, szsz
    bound_ok = all(h >= e - 1e-8 for h, e in zip(e_hf, e_ed))
    print("  %s examples/hubbard_ed.py L 6: HF >= ED at all 11 U: %s (min HF - ED %.3e, HF iterations %d-%d); "
          "A(w) 3 x 601 w, finite %s  [%.2f s]" % (where, bound_ok, min(h - e for h, e in zip(e_hf, e_ed)),
                                                   min(hf_iters), max(hf_iters), bool(np.isfinite(spec).all()),
                                                   time.perf_counter() - t0))
    check(bound_ok and bool(np.isfinite(spec).all()), "hubbard_ed: the HF variational bound or A(w) fails")

    # examples/mean_field.py's BCS panel
    t0 = time.perf_counter()
    sq = pt.models.square(t=-1.0)
    mu, kt, nk = -0.4, 0.01, S9["bcs_nk"]
    bcs = [pt.meanfield.bcs_gap(sq, float(g), mu, nk=(nk, nk), temperature=kt, max_iters=4000) for g in BCS_G]
    ks = np.arange(nk) / nk
    KX, KY = np.meshgrid(ks, ks, indexing="ij")
    eps = np.asarray(sq.solve_all(np.stack([KX.ravel(), KY.ravel()], -1)))[0]

    def gap_eq(gc):
        lo, hi = 1e-9, 10.0
        for _ in range(80):
            mid = 0.5 * (lo + hi)
            E = np.sqrt((eps - mu) ** 2 + mid ** 2)
            if np.mean(np.tanh(E / (2 * kt)) / (2 * E)) > 1.0 / gc:
                lo = mid
            else:
                hi = mid
        return 0.5 * (lo + hi)

    deltas = np.array([b["delta"][0] for b in bcs])
    dev = float(np.abs(deltas - np.array([gap_eq(g) for g in BCS_G])).max())
    out["bcs"] = np.array([deltas, [b["iters"] for b in bcs]])
    print("  %s examples/mean_field.py BCS nk %d, 7 g: max |BdG - gap equation| %.3e, iterations %s  [%.2f s]"
          % (where, nk, dev, [b["iters"] for b in bcs], time.perf_counter() - t0))
    check(dev < 1e-6 and all(b["converged"] for b in bcs), "BCS panel: max |BdG - gap equation| %.3e" % dev)

    # examples/majorana.py's Majorana numbers and open-chain splittings
    t0 = time.perf_counter()
    M = np.array([pt.bdg.majorana_number(pt.bdg.kitaev_chain(1.0, 0.4, mu)) if abs(abs(mu) - 2.0) > 1e-6 else np.nan
                  for mu in MAJORANA_MU])
    split = np.array([[np.abs(np.asarray(pt.bdg.kitaev_chain(1.0, 0.4, mu).cut_piece(Lc, 0).solve_all())).min()
                       for mu in MAJORANA_MU] for Lc in (12, 24, 36)])
    out["majorana"], out["majorana_split"] = M, split
    want = np.where(np.abs(np.abs(MAJORANA_MU) - 2.0) <= 1e-6, np.nan, np.where(np.abs(MAJORANA_MU) < 2.0, -1.0, 1.0))
    print("  %s examples/majorana.py: Majorana numbers at 25 mu match |mu| < 2: %s; L 36 splitting at mu 0 %.3e  "
          "[%.2f s]" % (where, bool(np.array_equal(M, want, equal_nan=True)), split[2, 12], time.perf_counter() - t0))
    check(np.array_equal(M, want, equal_nan=True), "Majorana numbers %s" % M)
    return out


def compare_slice9(torch, pt, out, ref, device):
    """The ninth slice on the card against the CPU run: the 6-ring's four
    filtered eigenvalues and docc, the many-body Chern number, the
    hubbard_ed, BCS and Majorana numbers at 1e-10 (relative to the largest
    entry); the ARPES map on the card's converged state carried to the
    CPU (convert.dmft_result_from_numpy) at 101 k x 201 w at 1e-10; the
    two DMFT fixed points, which pass through L-BFGS-B bath fits, at the
    rows' pins (Z 5e-3, docc 2e-3).  On the card, the 8-ring's four values
    against the card's dense torch.linalg.eigh of the same H at 1e-10."""
    for key in ("ed6_evals", "ed6_docc", "mbc", "hubbard_ed", "hubbard_ed_spec", "hubbard_ed_szsz", "bcs",
                "majorana", "majorana_split"):
        got, want = np.asarray(out[key]), np.asarray(ref[key])
        check(got.shape == want.shape and np.array_equal(np.isnan(got), np.isnan(want)),
              "%s: shape or NaN pattern differs from the CPU run" % key)
        ok = ~np.isnan(want)
        err = float(np.abs(got - want)[ok].max() / max(1.0, np.abs(want[ok]).max()))
        print("  %s vs CPU: max|diff| %.3e (relative)" % (key, err))
        check(err <= 1e-10, "%s differs from the CPU path by %.3e (relative)" % (key, err))
    for key, what in (("bethe", "dmft_bethe_u3"), ("arpes_fixed_point", "ARPES lattice")):
        d = np.abs(np.asarray(out[key]) - np.asarray(ref[key]))
        print("  %s fixed point vs CPU: |dZ| %.3e, |ddocc| %.3e" % (what, d[0], d[1]))
        check(d[0] < 5e-3 and d[1] < 2e-3, "%s fixed point departs from the CPU run" % what)
    from pythtb_tpu_torch import convert

    prev = pt.config.device()
    pt.config.set_device("cpu")
    try:
        r = convert.dmft_result_from_numpy(out["arpes_state"], _state_of(arpes_model(pt)), device="cpu")
        mb = arpes_model(pt)
        kps = mb.k_path(ARPES_PATH, S9["arpes_cpu_k"], report=False)[0]
        want = pt.dmft.band_spectral(r, kps, np.linspace(-8.0, 8.0, S9["arpes_cpu_w"]), eta=0.15, resolved=True)
        want_local = r.local_spectral(np.linspace(-8.0, 8.0, S9["arpes_w"])[::10], eta=0.15)
    finally:
        pt.config.set_device(prev)
    for key, w in (("arpes_small", want), ("arpes_local", want_local)):
        err = float(np.abs(out[key] - w).max() / max(1.0, np.abs(w).max()))
        print("  %s (card's state carried to the CPU) vs CPU: max|diff| %.3e (relative)" % (key, err))
        check(err <= 1e-10, "%s differs from the CPU path by %.3e" % (key, err))
    Hd = torch.as_tensor(hubbard_sector(pt, S9["ed_L"], 4.0)).to(device)
    t0 = time.perf_counter()
    w = torch.linalg.eigvalsh(Hd)[:4].cpu().numpy()
    err = float(np.abs(out["ed8_evals"] - w).max())
    print("  ed 4,900-dim lowest 4 vs the card's dense torch.linalg.eigvalsh: max|diff| %.3e  [%.2f s]"
          % (err, time.perf_counter() - t0))
    check(err <= 1e-10, "the filtered 4,900-dim eigenvalues depart from the dense eigh by %.3e" % err)


# -- the tenth slice: Fermi surfaces, tetrahedron DOS, Lindhard / RPA, k.p --------

S10 = {"tetra_nk": 48, "tetra_cpu_nk": 16, "lind_nk": 24, "lind_cpu_q": 8, "fs_nk": 301, "gdos_nk": 256,
       "gdos_cpu_nk": 64, "stoner_nk": 25, "mt_nk": 301, "mt_bt_nk": 901, "ext_slices": 48, "ext_nk": 151,
       "ext_cpu_slices": 12, "ext_cpu_nk": 51, "mlwf_nk": 12, "mlwf_coarse": 6, "mlwf_steps": 100, "slab_occ": 20,
       "smooth_occ": 20, "chain_strings": 301, "chain_L": 300}
TETRA_E = np.linspace(-6.5, 6.5, 1601)  # tetrahedron_dos_3d_48cube
LIND_Q = np.array([[i / 8, j / 8] for i in range(8) for j in range(8)])  # lindhard_qsweep_64q
LIND_W = np.linspace(0.0, 6.0, 16)
LIND_PIN = 0.189441 + 0.001618j  # chi[18, 1][0, 0], q (1/4, 1/4), omega 0.4
GDOS_E = np.linspace(-3.3, 3.3, 1200)  # examples/fermi_surface_tools.py
FS_EFS = (-3.0, -1.5, 0.0, 1.5, 3.0)
ORBIT_EFS = np.linspace(-3.9, -2.6, 14)
_STONER_PATH = np.array([[0.0, 0.0], [0.5, 0.0], [1 / 3, 2 / 3], [0.0, 0.0]])  # examples/rpa_stoner.py
STONER_Q = np.concatenate([_STONER_PATH[i] + (_STONER_PATH[i + 1] - _STONER_PATH[i]) * np.linspace(0, 1, 12, False)[:, None]
                           for i in range(3)] + [_STONER_PATH[-1:]], axis=0)
MT_BS = np.array([0.02, 0.1, 0.3, 1.0]) / 7.0  # tests/test_magnetotransport.py's Drude collapse, tau 7
LARGE_S = (9, 12, 16, 32, 64)  # kernels 3, 5 and 14 past 8 states
ROTATE_S = (2, 4, 8, 9, 16, 20, 32, 64)  # kernel 14's rotate about its dispatch line
LARGE_NW = (9, 12, 16, 32)  # kernel 19 past its register path
# (simplex, energy) pairs: operations where E lies in the simplex's range
TETRA_OPS = {1: 4, 2: 14, 3: 25}


def cubic_model(pt, tz=-1.0):
    """The simple-cubic band of tetrahedron_dos_3d_48cube and tests/test_extremal_orbits.py."""
    m = pt.tb_model(3, 3, np.eye(3), [[0.0, 0.0, 0.0]])
    m.set_hop(-1.0, 0, 0, [1, 0, 0])
    m.set_hop(-1.0, 0, 0, [0, 1, 0])
    m.set_hop(tz, 0, 0, [0, 0, 1])
    return m


def bn_supercell(pt):
    """A 3 x 3 supercell of gapped honeycomb (delta 1): 18 orbitals, the 9
    valence bands isolated, for a 9-function MLWF run (kernel 19's block path)."""
    return pt.models.bn(delta=1.0).make_supercell(np.diag([3, 3]))


def cost_tetra(torch, tetra, ev, nk, d, E):
    """Kernel 21: the grid eigenvalues and energies read once, the DOS
    written once; per (simplex, energy) two comparisons, and the branch's
    arithmetic (TETRA_OPS) where E falls inside the simplex's range --
    counted from this run's corners."""
    cs = tetra.simplex_corners(ev, nk, d)
    inside = float((torch.searchsorted(E, cs[:, -1].contiguous()) - torch.searchsorted(E, cs[:, 0].contiguous())).sum())
    return bound(ev.numel() * F64 + 2 * E.shape[0] * F64, 2.0 * cs.shape[0] * E.shape[0] + TETRA_OPS[d] * inside)


def cost_spectral_sum_qbatch(Q, P, T, nw):
    """Kernel 16's q-batch mode: W, de and the frequencies read once, the
    (Q, P, nw) sums written once; per (q, transition, frequency) the
    Lorentzian (6 ops) and P complex multiply-adds (8 each)."""
    return bound(Q * T * (F64 + P * C128) + nw * F64 + Q * P * nw * C128, Q * T * nw * (6 + 8 * P))


def slice10_kernels(torch, pt, device, record, held):
    """Phase 3 for kernel 21 and kernel 16's q-batch mode, and the block
    paths of kernels 3, 5, 14 and 19.  Kernel 21 at the tetrahedron row
    (cubic 48^3, 663,552 tetrahedra x 1,601 E) and graphene 256^2 x 1,200 E
    at 1e-10 relative; kernel 16's q-batch mode at the Lindhard row (64 q,
    4 operator pairs, 2,304 transitions, 16 w) and the Stoner row at 1e-10
    relative; kernels 3 and 5 at the slab's 20 occupied states (41 x 41)
    and random states at S 9, 12, 16, 32, 64, kernel 5 also at S 1-8, 24
    and 28, and from S 20 to 32 on both of its designs (a warp or a block
    a link), beside the library SVD; kernel 14 at the
    slab's 20 states and random frames at S 9-64 (beside the library SVD
    of the chain's overlaps), kernel 19's single steps at nw 9, 12, 16,
    32, all at 1e-12 as their register paths; kernel 14's rotate on every
    design about its dispatch line (rotate_paths: the frames above and S 2
    / 4 / 8 / 9 / 16 / 20 / 32 / 64 at 63 and 1,681 points) beside the matmul,
    the rows outside occ bit for bit."""
    from pythtb_tpu_torch import fermisurface, optical, response, wannier
    from pythtb_tpu_torch.ops import _kernels, berry, solver, tetra, transport

    rng = np.random.default_rng(10)
    # kernel 21
    for key, model, nk, E, main in (("cubic 48^3 S 1, 1601 E", cubic_model(pt), S10["tetra_nk"], TETRA_E, True),
                                    ("graphene 256^2 S 2, 1200 E", pt.models.graphene(t=-1.0), S10["gdos_nk"], GDOS_E,
                                     False)):
        d = model._dim_k
        ev = fermisurface._grid_evals_dev(model._get_finalized(), nk)
        Et = torch.as_tensor(E).to(device)
        want = tetra._tetra_dos_plain(ev, nk, d, Et)
        record("tetra_dos", key, max_diff(torch, tetra.tetra_dos(ev, nk, d, Et), want),
               lambda: tetra.tetra_dos(ev, nk, d, Et), lambda: tetra._tetra_dos_plain(ev, nk, d, Et),
               cost_tetra(torch, tetra, ev, nk, d, Et), main, reps=REPS if main else 5, tol=1e-10,
               scale=float(want.abs().max()), prof_reps=3, prof_plain=False)
    # kernel 16's q-batch mode: the Lindhard and Stoner rows' weights
    g = pt.models.graphene()
    gd = g._get_finalized()
    for key, nk, q, w, kt, eta, main in (("lindhard 64 q x 576 k x 16 w", S10["lind_nk"], LIND_Q, LIND_W, 2e-3, 0.05, True),
                                         ("stoner 37 q x 625 k x 1 w", S10["stoner_nk"], STONER_Q, np.zeros(1), 2e-3,
                                          1e-4, False)):
        _, kpts = response._setup(g, nk)
        W, de = response._lindhard_weights(gd, kpts, q, None, 0.0, kt, response._default_ops(g))
        om = torch.as_tensor(w).to(device)
        Q, P, T = W.shape
        want = optical._spectral_sum_qbatch_plain(W, de, om, eta)
        lib = cuda_ms(torch, lambda: torch.matmul(W, 1.0 / (om[None, None, :] - de[:, :, None] + 1j * eta)), 5)
        record("spectral_sum_qbatch", "%s (Q %d P %d T %d)" % (key, Q, P, T),
               max_diff(torch, optical.spectral_sum_qbatch(W, de, om, eta), want),
               lambda: optical.spectral_sum_qbatch(W, de, om, eta),
               lambda: optical._spectral_sum_qbatch_plain(W, de, om, eta), cost_spectral_sum_qbatch(Q, P, T, len(w)),
               main, library_ms=lib, tol=1e-10, scale=float(want.abs().max()), reps=REPS if main else 5)

    def wilson_paths(key, st, reps):
        """Kernel 5 at its default design, and from S 20 to 32 (about its
        dispatch line) at the other (a warp or a block a link), beside the
        library SVD of the same overlaps."""
        S, F = st.shape[-2], st.shape[-1]
        ov = berry._overlap(st[:-1], st[1:]).contiguous()
        lib = cuda_ms(torch, lambda: torch.linalg.svd(ov, full_matrices=False), 3)
        default = berry._wilson_path(S)
        for path in [default] + [q for q in berry._WILSON_MODES if q != default and 20 <= S <= 32]:
            err = 0.0
            for ax in (0, 1):
                prod, smin = berry._wilson_loop(st, ax, path)
                want, want_min = berry._wilson_loop_plain(st, ax)
                err = max(err, max_diff(torch, prod, want), max_diff(torch, smin, want_min))
            record("wilson_loop", key if path == default else "%s, %s path" % (key, path), err,
                   lambda: berry._wilson_loop(st, 0, path), lambda: berry._wilson_loop_plain(st, 0),
                   cost_wilson(tuple(st.shape[:-2]), S, F, 0), reps=reps, library_ms=lib)

    # kernel 5 below S 9, and where a warp a link gives way to a block a link
    for S in (1, 2, 3, 4, 5, 6, 7, 8, 24, 28):
        wilson_paths("33x17 S=%d F=%d random" % (S, S + 8), unit_states(torch, rng, (33, 17, S, S + 8), device), 3)
    # kernels 3 and 5 past S 8: the slab's 20 occupied states, then random states
    slab = cubic_slab(pt)
    sd = slab._get_finalized()
    _, _, ws = solver.solve_grid_device(sd, (41, 41), (0.0, 0.0), slab._orb, slab._per, 1)
    cases = [("slab 41x41 S=20 F=39", berry.prep_states(ws, list(range(S10["slab_occ"])), 1, 2), 5)]
    cases += [("33x17 S=%d F=%d random" % (S, S + 8), unit_states(torch, rng, (33, 17, S, S + 8), device), 3)
              for S in LARGE_S]
    for key, st, reps in cases:
        S, F = st.shape[-2], st.shape[-1]
        err = max(max_diff(torch, berry.link_dets(st, ax), berry._link_dets_plain(st, ax)) for ax in (0, 1))
        record("link_dets", key, err, lambda: berry.link_dets(st, 0), lambda: berry._link_dets_plain(st, 0),
               cost_link_dets(tuple(st.shape[:-2]), S, F, 0), reps=reps,
               library_ms=cuda_ms(torch, lambda: torch.linalg.det(berry._overlap(st[:-1], st[1:])), 3))
        wilson_paths(key, st, reps)
    # kernel 14 past 8 states: the slab's smooth gauge and following of its
    # 20 occupied states (of 39), then random frames
    w5s, _ = transport._strings(ws, 1, 2, 0)
    frames = [("slab 41x41 along k0, %d of 39" % S10["smooth_occ"], w5s.contiguous(), list(range(S10["smooth_occ"])), 5)]
    for S in LARGE_S:
        NS = min(S + 2, 64)  # kernel 14 takes up to 64 states
        z = rng.normal(size=(9, 7, NS + 4, NS)) + 1j * rng.normal(size=(9, 7, NS + 4, NS))
        fr = torch.as_tensor(np.ascontiguousarray(np.swapaxes(np.linalg.qr(z)[0], -1, -2))).to(device)
        frames.append(("random 9x7 frames, %d of %d" % (S, NS), transport._strings(fr, 1, 2, 0)[0].contiguous(),
                       list(range(S)), 3))
    def chain_paths(key, w5, occ, reps):
        """Kernel 14's chain at its default design, and at the others where
        the dispatch line was measured (S 1-8: the register path; S 20-32:
        a warp or a block a link), beside the library SVD of the same
        overlaps; C and the smallest singular value at 1e-12."""
        outer, L, inner, NS, F = w5.shape
        occ_t = torch.as_tensor(occ, dtype=torch.int64, device=device)
        S = len(occ)
        Cp, sp = transport._chain_plain(w5, occ_t)
        sel = w5.index_select(3, occ_t)
        ov = berry._overlap(sel[:, :-1], sel[:, 1:]).contiguous()
        lib = cuda_ms(torch, lambda: torch.linalg.svd(ov, full_matrices=False), 3)
        default = transport._chain_path(S, outer * inner, L,
                                        torch.cuda.get_device_properties(device).multi_processor_count)
        others = [q for q, (_, most, _) in transport._CHAIN_MODES.items()
                  if q != default and S <= most and (S <= 8 or 20 <= S <= 32)]
        for path in [default] + others:
            C, smin = transport._chain(w5, occ_t, path)
            record("transport_chain", key if path == default else "%s, %s path" % (key, path),
                   max(max_diff(torch, C, Cp), max_diff(torch, smin, sp)),
                   lambda: transport._chain(w5, occ_t, path), lambda: transport._chain_plain(w5, occ_t),
                   cost_transport_chain(outer, L, inner, S, F), reps=reps, library_ms=lib)
        return Cp

    # the chain where the register path ran before: 301 strings of 300 points
    ns, nl = S10["chain_strings"], S10["chain_L"]
    for S in (1, 2, 4, 8):
        st = unit_states(torch, rng, (ns, nl, S, 2 * S), device)
        chain_paths("%dx%d S=%d F=%d random" % (ns, nl, S, 2 * S), transport._strings(st, 1, 2, 1)[0].contiguous(),
                    list(range(S)), 3)
        del st
    # about the link path's warp / block line
    for S in (24, 28, 32):
        fr = torch.as_tensor(np.ascontiguousarray(np.swapaxes(np.linalg.qr(
            rng.normal(size=(9, 7, S + 4, S + 2)) + 1j * rng.normal(size=(9, 7, S + 4, S + 2)))[0], -1, -2))).to(device)
        chain_paths("random 9x7 frames, %d of %d" % (S, S + 2), transport._strings(fr, 1, 2, 0)[0].contiguous(),
                    list(range(S)), 3)
    def rotate_paths(key, w5, occ, reps, Cp=None):
        """Kernel 14's rotate, closed and open, on every design that takes S
        (a block that cannot hold the occ rows whole takes them a chunk of
        columns at a time), against the plain version at 1e-12, the rows
        outside occ bit for bit; the default design (_rotate_path's) recorded
        closed beside the matmul of conj(C) and the occ rows, the others
        timed beside it (closed)."""
        outer, L, inner, NS, F = w5.shape
        occ_t = torch.as_tensor(occ, dtype=torch.int64, device=device)
        S = len(occ)
        if Cp is None:
            Cp, _ = transport._chain_plain(w5, occ_t)
        theta, P = (t.contiguous() for t in berry.unitary_eig(Cp[:, -1].contiguous()))
        sel = w5.index_select(3, occ_t)
        rest = torch.as_tensor([r for r in range(NS) if r not in occ], dtype=torch.int64, device=device)
        lib = cuda_ms(torch, lambda: torch.matmul(Cp.conj(), sel), reps)
        sms, smem = _kernels.card(device)
        default = transport._rotate_path(S, outer * L * inner, F, sms, smem)
        cost = cost_transport_rotate(outer, L, inner, S, NS, F)
        others = []
        for path, (_, most) in transport._ROTATE_MODES.items():
            if S > most:
                continue
            err = {}
            for closed in (True, False):
                got = transport._rotate(w5, occ_t, Cp, theta, P, closed, path)
                err[closed] = max_diff(torch, got, transport._rotate_plain(w5, occ_t, Cp, theta, P, closed))
                check(torch.equal(got.index_select(3, rest), w5.index_select(3, rest)),
                      "transport_rotate %s, %s path: a row outside occ changed" % (key, path))
                if path != default or not closed:
                    held("transport_rotate", "%s, %s, %s path" % (key, "closed" if closed else "open", path),
                         err[closed])
            if path == default:
                record("transport_rotate", key + ", closed", err[True],
                       lambda: transport._rotate(w5, occ_t, Cp, theta, P, True, path),
                       lambda: transport._rotate_plain(w5, occ_t, Cp, theta, P, True), cost, reps=reps,
                       library_ms=lib)
            else:
                others.append("%s %.4f ms, %.1f us" % (
                    path, cuda_ms(torch, lambda: transport._rotate(w5, occ_t, Cp, theta, P, True, path), reps),
                    event_us(torch, lambda: transport._rotate(w5, occ_t, Cp, theta, P, True, path))))
        print("  %-15s %-34s default %s; the other designs (closed, wrapper and device by CUDA events): %s; "
              "matmul %.4f ms" % ("transport_rotate", key, default, "; ".join(others), lib))

    for key, w5, occ, reps in frames:
        outer, L, inner, NS, F = w5.shape
        Cp = chain_paths(key, w5, occ, reps)
        rotate_paths(key, w5, occ, reps, Cp)
        nocc = len(occ)
        occ_f = torch.as_tensor(occ, dtype=torch.int64, device=device)
        idx, fid, stt = transport._follow(w5, occ_f)
        idx_p, fid_p, st_p = transport._follow_plain(w5, occ_f)
        check(torch.equal(idx, idx_p), "transport_follow %s: the followed indices differ from the plain version" % key)
        record("transport_follow", "%s, follow %d of %d" % (key, nocc, NS),
               max(max_diff(torch, fid, fid_p), max_diff(torch, stt, st_p)),
               lambda: transport._follow(w5, occ_f), lambda: transport._follow_plain(w5, occ_f),
               cost_transport_follow(outer, L, inner, NS, nocc, F), reps=reps)
    # the rotate's dispatch line: S 2 / 4 / 8 / 9 / 16 / 20 / 32 / 64 at
    # 63 points (random 9 x 7 frames; the frames above hold S 9-64 there)
    # and 1,681 (41 x 41), the occ rows scattered (every other state) where
    # the frames have room
    for grid in ((9, 7), (41, 41)):
        for S in ROTATE_S if grid == (41, 41) else [S for S in ROTATE_S if S not in LARGE_S]:
            NS = min(2 * S + 1, 66)
            z = rng.normal(size=grid + (NS + 4, NS)) + 1j * rng.normal(size=grid + (NS + 4, NS))
            fr = torch.as_tensor(np.ascontiguousarray(np.swapaxes(np.linalg.qr(z)[0], -1, -2))).to(device)
            occ = list(range(1, 2 * S, 2)) if 2 * S <= NS else list(range(S))
            rotate_paths("random %dx%d frames, %d of %d, F %d" % (grid + (S, NS, NS + 4)),
                         transport._strings(fr, 1, 2, 0)[0].contiguous(), occ, 5)
            del fr, z
    # kernel 19 past 8 Wannier functions: single steps on near-identity overlaps
    for n in LARGE_NW:
        B, nb = 64, 8
        X = rng.normal(size=(B, nb, n, n)) + 1j * rng.normal(size=(B, nb, n, n))
        u, _, vh = np.linalg.svd(np.eye(n) + 0.05 * X)
        M0 = torch.as_tensor(np.ascontiguousarray(0.98 * (u @ vh))).to(device)
        nbr = torch.as_tensor(rng.integers(0, B, (B, nb))).to(device)
        w_b = torch.as_tensor(rng.uniform(0.5, 2.0, nb)).to(device)
        b_cart = torch.as_tensor(rng.normal(size=(nb, 3)) * 0.3).to(device)
        H = rng.normal(size=(B, n, n)) + 1j * rng.normal(size=(B, n, n))
        A = torch.as_tensor(0.02 * (H - np.conj(np.swapaxes(H, -1, -2))))
        U = wannier._expm_antiherm(A).to(device).contiguous()
        dW = (0.01 * A).to(device).contiguous()
        eps0 = 0.5 / (4.0 * float(w_b.sum()))
        for om_prev in (math.inf, -1.0):
            got = wannier.mv_step(M0, nbr, w_b, b_cart, U, dW, 1.3 * eps0, om_prev, eps0)
            want = wannier._mv_step_plain(M0, nbr, w_b, b_cart, U, dW, torch.tensor(1.3 * eps0, dtype=torch.float64,
                                                                                      device=device),
                                          torch.tensor(om_prev, dtype=torch.float64, device=device), 20.0 * eps0)
            err = max(max_diff(torch, a, b) / max(1.0, float(b.abs().max())) for a, b in zip(got, want))
            if om_prev < 0:
                held("mv_step", "random B 64 nb 8 nw %d, overshoot" % n, err)
        record("mv_step", "random B 64 nb 8 nw %d" % n, err,
               lambda: wannier.mv_step(M0, nbr, w_b, b_cart, U, dW, 1.3 * eps0, math.inf, eps0),
               lambda: wannier._mv_step_plain(M0, nbr, w_b, b_cart, U, dW,
                                              torch.tensor(1.3 * eps0, dtype=torch.float64, device=device),
                                              torch.tensor(math.inf, dtype=torch.float64, device=device), 20.0 * eps0),
               cost_mv_step(B, nb, n), reps=5)


def _link_traces(wf, occ, axis):
    """Traces of the link overlaps <w_m|w_m+1> of states ``occ`` along grid
    ``axis`` (invariant under the one unitary by which two open smooth
    gauges of the same projectors differ on a string)."""
    w = np.asarray(wf._wfs)[:, :, occ]
    w = np.moveaxis(w, axis, 0)
    w = w.reshape(w.shape[:3] + (-1,))
    return np.einsum("lsnf,lsnf->ls", w[:-1].conj(), w[1:])


def slice10_path(pt, where, reference):
    """The tenth slice's rows of tools/bench_suite.py with their pins:
    tetrahedron_dos_3d_48cube (:850; 663,552 tetrahedra x 1,601 E, the
    state count within 1e-2 of 1) and lindhard_qsweep_64q (:556; graphene,
    64 q x 576 k x 16 w, chi[18, 1][0, 0] within 3e-3 of 0.189441 +
    0.001618i); examples/fermi_surface_tools.py (the square lattice's
    contours at nk 301 for five levels, graphene's dos_linear at nk 256 x
    1,200 E, 14 orbit areas and the cyclotron mass at nk 301 against the
    parabolic pi k_F^2 and m* 1/2); examples/rpa_stoner.py's
    stoner_analysis at nk 25 (37 q, U_c within 2.1-2.5);
    tests/test_magnetotransport.py's Drude collapse at nk 301 (2e-2);
    extremal_orbits on the cubic pocket (48 slices x 151^2, one solve of
    1.09 M k-points; the belly area pi (E_F + 6) within 3e-2); kp_model at
    graphene's K (v_F sqrt(3)/2 within 1e-3); and the block paths on real
    calls: the 20-layer slab's Berry phases and Wilson loops of its 20
    occupied states (kernels 3, 5), their smooth gauge and adiabatic
    following (kernel 14), and a 9-function MLWF of a 3 x 3
    BN supercell (kernel 19).  The CPU reference runs the DOS at 16^3 and
    64^2, 8 of the 64 q, the extremal orbits at 12 x 51^2 and leaves out
    the 901^2 zero-field Drude reference; the card runs those sizes too,
    for the comparison."""
    import warnings

    from pythtb_tpu_torch.ops import _kernels

    out = {}

    def timed(fn, *args, **kwargs):
        t0 = time.perf_counter()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            result = fn(*args, **kwargs)
        return result, time.perf_counter() - t0

    cub = cubic_model(pt)
    # tetrahedron_dos_3d_48cube
    if not reference:
        d46, sec = timed(pt.fermisurface.dos_linear, cub, TETRA_E, nk=S10["tetra_nk"])
        tot = float(np.trapezoid(d46, TETRA_E))
        print("  %s fermisurface.dos_linear cubic 48^3 (663,552 tetrahedra) x 1601 E: state count %.6f  [%.2f s]"
              % (where, tot, sec))
        check(abs(tot - 1.0) < 1e-2 and bool(np.isfinite(d46).all()), "tetrahedron_dos_3d_48cube: count %.6f" % tot)
    out["tetra_small"], sec = timed(pt.fermisurface.dos_linear, cub, TETRA_E, nk=S10["tetra_cpu_nk"])
    print("  %s fermisurface.dos_linear cubic 16^3 x 1601 E: state count %.6f  [%.2f s]"
          % (where, float(np.trapezoid(out["tetra_small"], TETRA_E)), sec))

    # lindhard_qsweep_64q (the CPU: the first 8 q)
    g = pt.models.graphene()
    q = LIND_Q[: S10["lind_cpu_q"]] if reference else LIND_Q
    before = _kernels.LAUNCHES["spectral_sum_qbatch"]
    chi, sec = timed(pt.response.lindhard, g, q, LIND_W, nk=S10["lind_nk"], mu=0.0, temperature=2e-3, eta=0.05)
    out["lindhard"] = chi[: S10["lind_cpu_q"]]
    if not reference:
        out["lindhard_launches"] = _kernels.LAUNCHES["spectral_sum_qbatch"] - before
        dev = abs(chi[18, 1][0, 0] - LIND_PIN)
        print("  %s response.lindhard graphene 64 q x 576 k x 16 w: pin deviation %.3e, %d q-batch launch  [%.2f s]"
              % (where, dev, out["lindhard_launches"], sec))
        check(dev < 3e-3 and bool(np.isfinite(chi).all()), "lindhard_qsweep_64q: pin deviation %.3e" % dev)

    # examples/fermi_surface_tools.py
    t0 = time.perf_counter()
    sq = pt.models.square(t=-1.0)
    conts = {ef: pt.fermisurface.fermi_surface(sq, ef, nk=S10["fs_nk"])[0] for ef in FS_EFS}
    out["fs_contours"] = np.concatenate([np.concatenate([p for p, _ in conts[ef]]) for ef in FS_EFS])
    out["fs_closed"] = np.array([[c for _, c in conts[ef]].count(True) for ef in FS_EFS], float)
    ev = np.asarray(sq.solve_all(out["fs_contours"][::37] % 1.0))[0]
    on = float(np.abs(ev - np.repeat(FS_EFS, [sum(len(p) for p, _ in conts[ef]) for ef in FS_EFS])[::37]).max())
    gdos_nk = S10["gdos_cpu_nk"] if reference else S10["gdos_nk"]
    gdos = pt.fermisurface.dos_linear(pt.models.graphene(t=-1.0), GDOS_E, nk=gdos_nk)
    areas = np.array([pt.fermisurface.orbit_areas(sq, e, 0, nk=S10["fs_nk"])[0] for e in ORBIT_EFS])
    mstar = pt.fermisurface.cyclotron_mass(sq, -3.8, 0, nk=S10["fs_nk"])
    out["fs_areas"] = np.concatenate([areas, [mstar]])
    if not reference:
        out["gdos_small"] = pt.fermisurface.dos_linear(pt.models.graphene(t=-1.0), GDOS_E, nk=S10["gdos_cpu_nk"])
    else:
        out["gdos_small"] = gdos
    par = float(np.abs(areas[:3] / (np.pi * (ORBIT_EFS[:3] + 4.0)) - 1.0).max())
    count = float(np.trapezoid(gdos, GDOS_E))
    print("  %s examples/fermi_surface_tools.py: contours at 5 levels (%s closed), max |E(k) - E_F| %.2e; graphene "
          "DOS %d^2 x 1200 E, state count %.5f; 14 orbit areas (parabolic limit %.2e), m*(-3.8) %.6f  [%.2f s]"
          % (where, out["fs_closed"].astype(int).tolist(), on, gdos_nk, count, par, mstar, time.perf_counter() - t0))
    check(on < 2e-3 and abs(count - 2.0) < 2e-2 and par < 3e-2 and abs(mstar - 0.5) < 3e-2,
          "fermi_surface_tools: contour %.2e, count %.5f, areas %.2e, m* %.5f" % (on, count, par, mstar))

    # examples/rpa_stoner.py
    st, sec = timed(pt.response.stoner_analysis, g, STONER_Q, nk=S10["stoner_nk"], mu=0.0, temperature=2e-3)
    out["stoner"] = np.concatenate([st["lambda"], [st["U_c_min"]]])
    print("  %s response.stoner_analysis graphene nk 25, 37 q: U_c %.8f at q %s  [%.2f s]"
          % (where, st["U_c_min"], st["q_best"], sec))
    check(2.1 < st["U_c_min"] < 2.5, "rpa_stoner: U_c %.6f" % st["U_c_min"])

    # tests/test_magnetotransport.py's Drude collapse
    t0 = time.perf_counter()
    mt_m = pt.fermisurface.cyclotron_mass(sq, -3.6, 0, nk=S10["mt_nk"])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        mt = pt.boltzmann.magnetotransport(sq, -3.6, MT_BS, tau=7.0, nk=S10["mt_nk"])
    out["mt"] = np.concatenate([mt["sigma"].ravel(), [mt_m]])
    if not reference:
        tc = pt.boltzmann.transport_coefficients(sq, [-3.6], 0.03, S10["mt_bt_nk"], tau=7.0)
        s0 = tc["sigma"][0, 0, 0]
        wct = MT_BS / mt_m * 7.0
        sig = mt["sigma"]
        dev = max(float(np.abs(sig[:, 0, 0] / (s0 / (1 + wct**2)) - 1).max()),
                  float(np.abs(sig[:, 1, 1] / (s0 / (1 + wct**2)) - 1).max()),
                  float(np.abs(np.abs(sig[:, 0, 1]) / sig[:, 0, 0] / wct - 1).max()))
        print("  %s boltzmann.magnetotransport square 301^2, 4 B (Drude collapse vs 901^2 sigma_0): max relative "
              "deviation %.3e, orbits %s  [%.2f s]" % (where, dev, mt["orbits"], time.perf_counter() - t0))
        check(dev < 2e-2 and float(np.abs(sig[:, 0, 1] + sig[:, 1, 0]).max()) <= 1e-10 * float(np.abs(sig).max()),
              "magnetotransport Drude collapse: deviation %.3e" % dev)

    # extremal_orbits: the cubic pocket (the CPU: 12 x 51^2)
    sizes = [(S10["ext_cpu_slices"], S10["ext_cpu_nk"])] + ([] if reference else [(S10["ext_slices"], S10["ext_nk"])])
    for ns, nk in sizes:
        ex, sec = timed(pt.fermisurface.extremal_orbits, cub, -5.7, 0, n_slices=ns, nk=nk)
        if ns == S10["ext_cpu_slices"]:
            out["extremal"] = np.array([[e["k_slice"], e["area"], e["kind"] == "max"] for e in ex], float)
        print("  %s fermisurface.extremal_orbits cubic %d x %d^2: %s  [%.2f s]"
              % (where, ns, nk, [(e["kind"], round(e["area"], 6)) for e in ex], sec))
        if ns == S10["ext_slices"]:
            check(len(ex) == 1 and ex[0]["kind"] == "max" and abs(ex[0]["area"] / (np.pi * 0.3) - 1) < 3e-2,
                  "extremal_orbits: %s" % ex)

    # kp_model at graphene's K
    kp, sec = timed(pt.geometry.kp_model, pt.models.graphene(t=-1.0), [1 / 3, 2 / 3], [0, 1])
    th = np.array([0.0, 0.7, 1.9, 3.0])
    e = kp(1e-4 * np.stack([np.cos(th), np.sin(th)], axis=1))
    vs = (e[:, 1] - e[:, 0]) / 2e-4
    em = pt.geometry.effective_mass(pt.models.haldane(), [0.11, 0.27], 0)
    out["kp"] = np.concatenate([vs, em["hessian"].ravel()])
    print("  %s geometry.kp_model graphene K: v_F %s (sqrt(3)/2 = %.6f)  [%.2f s]"
          % (where, np.round(vs, 6).tolist(), np.sqrt(3) / 2, sec))
    check(float(np.abs(vs - np.sqrt(3.0) / 2.0).max()) < 1e-3, "kp_model Dirac velocity %s" % vs)

    # the block paths of kernels 3, 5, 14 and 19 on real calls
    slab = cubic_slab(pt)
    ws = pt.wf_array(slab, [41, 41])
    ws.solve_on_grid([0.0, 0.0])
    occ = list(range(S10["slab_occ"]))
    before = dict(_kernels.LAUNCHES)
    out["slab_berry"] = np.concatenate([ws.berry_phase(occ, dir=0, contin=False).ravel(),
                                        ws.berry_phase(occ, dir=0, contin=False, berry_evals=True).ravel()])
    occ_s = list(range(S10["smooth_occ"]))
    idx, fid = ws.adiabatic_evolve(occ_s, dir=1)
    # the open gauge: the twisted one takes a fractional power of the
    # holonomy, whose eigenphases near pi can fall on either side of the
    # branch cut on the card and the CPU (on an H100 the closed gauge's traces came
    # out 1.8e-3 apart), so only the open gauge is compared
    ws.smooth_gauge(occ_s, dir=0, closed=False)
    tr = _link_traces(ws, occ_s, 0)
    out["slab_transport"] = np.concatenate([idx.astype(float).ravel(), fid.ravel()])
    out["slab_traces"] = np.concatenate([tr.real.ravel(), tr.imag.ravel()])
    sc = bn_supercell(pt)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        itp = pt.wannier.interpolator(sc, list(range(9)), nk=S10["mlwf_nk"], trial=np.eye(18)[0::2],
                                      localize=S10["mlwf_steps"], coarse_nk=S10["mlwf_coarse"], polish=0)
    kpb = sc.k_path([[0, 0], [0.5, 0], [1 / 3, 1 / 3], [0, 0]], 31, report=False)[0]
    out["bn_mlwf_bands"] = itp.bands(kpb)
    out["bn_mlwf_omega"] = np.array([itp.omega_i, itp.omega_i + itp.omega_tilde, itp.min_projection_sv])
    band_dev = float(np.abs(out["bn_mlwf_bands"] - sc.solve_all(kpb)[:9]).max())
    print("  %s block paths: slab Berry phases, following and smooth gauge of 20 states; BN 3x3 MLWF nw 9 "
          "(%d MV steps, coarse 6^2 -> 12^2): band error %.3e, Omega_I %.8f, Omega %.8f"
          % (where, S10["mlwf_steps"], band_dev, itp.omega_i, itp.omega_i + itp.omega_tilde))
    check(band_dev < 5e-2, "BN supercell MLWF band error %.3e" % band_dev)
    if not reference:
        out["block_launches"] = {k: _kernels.LAUNCHES[k] - before[k] for k in (
            "link_dets", "wilson_loop", "transport_chain", "transport_rotate", "transport_follow", "mv_step")}
        print("  %s launches of the block-path calls: %s" % (where, out["block_launches"]))
    return out


def compare_slice10(out, ref):
    """The tenth slice on the card against the CPU run: the DOS at 16^3 and
    64^2, chi0 at the first 8 q, the contours, areas and mass, the Stoner
    eigenvalues, sigma(B), the extremal orbits at 12 x 51^2, the k.p
    velocities and mass tensor, the slab's Berry phases (mod 2 pi),
    following and smoothed link traces, all at 1e-10 relative to the
    largest entry; the BN MLWF, which ends a whole MV run, at MV_TOL."""
    for key in ("tetra_small", "lindhard", "fs_contours", "fs_closed", "gdos_small", "fs_areas", "stoner", "mt",
                "extremal", "kp", "slab_transport", "slab_traces"):
        got, want = np.asarray(out[key]), np.asarray(ref[key])
        check(got.shape == want.shape, "%s: shape %s differs from the CPU run's %s" % (key, got.shape, want.shape))
        err = float(np.abs(got - want).max() / max(1.0, np.abs(want).max())) if want.size else 0.0
        print("  %s vs CPU: max|diff| %.3e (relative)" % (key, err))
        check(err <= 1e-10, "%s differs from the CPU path by %.3e (relative)" % (key, err))
    d = np.asarray(out["slab_berry"]) - np.asarray(ref["slab_berry"])
    err = float(np.abs(np.angle(np.exp(1j * d))).max())
    print("  slab Berry phases and Wilson-loop phases of 20 states vs CPU: max|diff| %.3e (mod 2 pi)" % err)
    check(err <= 1e-10, "slab Berry phases differ from the CPU path by %.3e" % err)
    err = float(np.abs(out["bn_mlwf_bands"] - ref["bn_mlwf_bands"]).max() / np.abs(ref["bn_mlwf_bands"]).max())
    (oi, om, sv), (roi, rom, rsv) = out["bn_mlwf_omega"], ref["bn_mlwf_omega"]
    print("  BN 3x3 MLWF nw 9 vs CPU: bands %.3e, Omega_I %.3e, Omega %.3e (relative), projection sv %.3e"
          % (err, abs(oi - roi) / abs(roi), abs(om - rom) / abs(rom), abs(sv - rsv)))
    check(err <= MV_TOL["bands"] and abs(oi - roi) <= MV_TOL["omega_i"] * abs(roi)
          and abs(om - rom) <= MV_TOL["omega"] * abs(rom) and abs(sv - rsv) <= MV_TOL["history"],
          "the BN MLWF differs from the CPU run")
    bl = out["block_launches"]
    check(all(v > 0 for v in bl.values()), "a block-path call did not launch its kernel: %s" % bl)
    check(out["lindhard_launches"] == 1, "the 64-q Lindhard call did not make one q-batch launch")


# -- slice 11: Peierls time evolution, the BdG superfluid weight, Floquet -----

S11 = {"sfw_nk": 48, "sfw_cpu_nk": 12, "flq_nk": 31, "flq_nt": 128, "flq_cpu_nk": 11, "flq_cpu_nt": 32,
       "ribbon_cpu_k": 9, "hhg_cpu_nk": 6, "chunk": 13}
# examples/high_harmonics.py's three calls: (omega, E0, keyword arguments)
HHG_CALLS = {
    "weak": (0.6, 5e-3, dict(occ=[0], nk=(36, 36), cycles=24, ramp_cycles=8, steps_per_cycle=96, n_harmonics=7)),
    "strong": (0.25, 0.6, dict(occ=[0], nk=(48, 48), cycles=20, ramp_cycles=6, steps_per_cycle=128,
                               n_harmonics=25)),
    "shg": (np.linspace(0.3, 0.95, 10), 1e-3, dict(occ=[0], nk=(36, 36), cycles=24, ramp_cycles=8,
                                                    steps_per_cycle=72)),
}
# the CPU comparison's size of each (the same omega, E0 and n_harmonics)
HHG_CPU = dict(cycles=5, ramp_cycles=1, steps_per_cycle=16)
FLQ_W = 10.0  # examples/floquet_graphene.py, tools/bench_suite.py:343
RUDNER_W = 1.0  # examples/floquet_anomalous.py
SFW_PIN = 0.211647  # superfluid_weight_lieb_48x48 (tools/bench_suite.py:463)


def circ(A):
    return {"A": [A, A], "phase": [0.0, np.pi / 2]}


def rudner(pt):
    """The Rudner-Lindner-Berg-Levin bulk of examples/floquet_anomalous.py."""
    T = 2.0 * np.pi / RUDNER_W
    J = 0.85 * (np.pi / 2.0) / (T / 5.0)
    m = pt.tb_model(2, 2, lat=[[1.0, 0.0], [0.0, 1.0]], orb=[[0.0, 0.0], [0.5, 0.5]])
    for R in ([0, 0], [-1, 0], [-1, -1], [0, -1]):
        m.set_hop(J, 0, 1, R)
    return m


def rudner_drive(pt, model):
    """examples/floquet_anomalous.py's five-step drive for ``model`` (bulk
    or ribbon): each hop inherits the step of its bulk bond type."""
    from pythtb_tpu_torch.floquet import _hop_displacements

    T = 2.0 * np.pi / RUDNER_W
    nhop = len(model._hoppings)
    if nhop == 4:
        step_of = np.arange(nhop) % 4
    else:
        d = _hop_displacements(model)
        step_of = (np.round((np.arctan2(d[:, 1], d[:, 0]) - np.pi / 4.0) / (np.pi / 2.0))).astype(int) % 4
    norb = model._norb

    def hop_factors(t):
        return (step_of == int(t / (T / 5.0))).astype(float)

    def onsite(t):
        if int(t / (T / 5.0)) != 4:
            return np.zeros(norb)
        return 0.5 * (1.0 - 2.0 * (np.arange(norb) % 2))

    return {"hop_factors": hop_factors, "onsite": onsite}


def captured(module, name, call):
    """Run ``call`` with ``module.name`` wrapped so that its first call's
    arguments are kept (tensors cloned before the call, which may update
    them in place); returns them."""
    import torch

    real = getattr(module, name)
    seen = []

    def spy(*args, **kwargs):
        if not seen:
            seen.append(([a.clone() if isinstance(a, torch.Tensor) else a for a in args], dict(kwargs)))
        return real(*args, **kwargs)

    setattr(module, name, spy)
    try:
        call()
    finally:
        setattr(module, name, real)
    return seen[0]


def cost_propagate(Tc, R, S, nocc=None, d=0, hist=False):
    """Kernel 22: V, w (and dH) read once a row-step, the state read and
    written once (and the history written); E = V^H diag V (8 S^3 a
    row-step) and its product with the state (8 S^3, or 8 nocc S^2 and the
    current's 8 d nocc S^2)."""
    rs = Tc * R
    if nocc is None:
        nbytes = rs * (8 * S + C128 * S * S * (2 if hist else 1)) + 2 * R * C128 * S * S
        return bound(nbytes, rs * 16 * S**3)
    nbytes = rs * (8 * S + C128 * S * S * (1 + d)) + 2 * R * C128 * nocc * S
    return bound(nbytes, rs * (8 * S**3 + 8 * nocc * S * S * (1 + d)))


def cost_bdg_hessian(B, N, d):
    """Kernel 23's Hessian mode: lam, U and the four derivative blocks read
    once; A_a = U^H M'_a U a direction with M'_a block-diagonal (two S x S
    blocks), so U^H M'_a is N^3 / 2 complex multiply-adds and its product
    with U N^3 (12 N^3 operations), <n|M''|n> (2 S^2 N a pair), the pair
    sums (8 d^2 N^2)."""
    S = N // 2
    nbytes = B * (8 * N + C128 * N * N + 2 * C128 * d * S * S + 2 * C128 * d * d * S * S)
    return bound(nbytes, B * (12 * d * N**3 + 16 * d * d * S * S * N + 8 * d * d * N * N))


def cost_bdg_grand_potential(M, N):
    """Kernel 23's grand-potential mode: lam and the traces read once; a
    softplus (exp, log1p: ~20 operations) an eigenvalue."""
    return bound(M * (8 * N + 8), M * N * 20)


def cost_assemble_floquet(B, dimK):
    """Kernel 1's Floquet-block mode: the store of K."""
    return bound(B * dimK * dimK * C128, 0)


def cost_winding(G, nt, B, S):
    """Kernel 24: its inputs read once, the history (nt + 1, B, S, S), P
    (B, S, S) and eps (G, B, S) (U_e is an intermediate: a kernel could
    form it where it is used); per (g, t, k) the periodizing product
    (16 S^3) and the stencil's three A_mu and two commutator products
    (40 S^3)."""
    nbytes = C128 * S * S * ((nt + 1) * B + B) + 8 * G * B * S
    return bound(nbytes, G * nt * B * 56 * S**3)


# kernel 22's register paths load the next step's w, V and dH while a
# step computes at S <= 2 (kPrefetch); phase 2 builds a copy of
# csrc/propagate.cu with that turned off, and phase 3 times both
PREFETCH_LINE = "constexpr bool kPrefetch = S <= 2;"
NO_PREFETCH = {}


def start_no_prefetch_build():
    """Start nvcc on a copy of csrc/propagate.cu whose register kernels
    read each step's inputs where they use them (kPrefetch false), into a
    library of its own; returns (process, library path, log)."""
    from pythtb_tpu_torch.ops import _kernels as kernels

    src = Path(kernels._CSRC) / "propagate.cu"
    text = src.read_text()
    check(text.count(PREFETCH_LINE) == 2, "csrc/propagate.cu no longer has its two kPrefetch lines")
    out = Path(kernels.BUILD_DIR) / "ab"
    out.mkdir(parents=True, exist_ok=True)
    cu, so, log = out / "propagate_no_prefetch.cu", out / "libpropagate_no_prefetch.so", out / "nvcc.log"
    cu.write_text(text.replace(PREFETCH_LINE, "constexpr bool kPrefetch = false;"))
    with open(log, "w") as err:
        proc = subprocess.Popen([kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-I", str(src.parent), "-o",
                                 str(so), str(cu)], stdout=subprocess.DEVNULL, stderr=err)
    return proc, so, log


def finish_no_prefetch_build(proc, so, log):
    import ctypes

    from pythtb_tpu_torch.ops import _kernels

    rc = proc.wait(timeout=600)
    check(rc == 0, "nvcc failed on kernel 22 without its prefetch (rc %d):\n%s" % (rc, log.read_text()[-4000:]))
    lib = ctypes.CDLL(str(so))
    for name in ("pythtb_propagate_state", "pythtb_propagate_full"):
        fn = getattr(lib, name)
        fn.argtypes = _kernels._SIGNATURES[name]
        fn.restype = ctypes.c_int
    return lib


def prefetch_ab(torch, what, mode, args, reps=3):
    """Kernel 22 as built against the copy without its S <= 2 prefetch,
    on the same inputs: the two results' largest difference (relative to
    max(1, |entry|)) and each one's CUDA-event device time, alternated
    ``reps`` times (medians)."""
    from pythtb_tpu_torch.ops import propagate

    lib = NO_PREFETCH["lib"]
    if mode == "state":
        w, V, dH, psi0, dt, groups = args
        Tc, R, S = w.shape
        check(S <= 2, "the prefetch A/B runs at S <= 2, got S %d" % S)
        d, nocc, Rg = dH.shape[2], psi0.shape[1], R // groups
        part = torch.empty((Tc, groups, -(-Rg // 32), d), dtype=torch.float64, device=w.device)

        def built():
            return propagate.propagate_state(w, V, dH, psi0.clone(), dt, groups)

        def without():
            psi, j = psi0.clone(), torch.empty((Tc, groups, d), dtype=torch.float64, device=w.device)
            rc = lib.pythtb_propagate_state(w.data_ptr(), V.data_ptr(), dH.data_ptr(), psi.data_ptr(), dt.data_ptr(),
                                            part.data_ptr(), j.data_ptr(), Tc, R, Rg, S, nocc, d,
                                            torch.cuda.current_stream().cuda_stream)
            check(rc == 0, "kernel 22 without its prefetch failed to launch: cudaError %d" % rc)
            return psi, j
    else:
        w, V, U0, dt, hist = args
        Tc, R, S = w.shape
        h2 = None if hist is None else torch.empty_like(hist)

        def built():
            return (propagate.propagate_full(w, V, U0.clone(), dt, hist),)

        def without():
            U = U0.clone()
            rc = lib.pythtb_propagate_full(w.data_ptr(), V.data_ptr(), U.data_ptr(), dt.data_ptr(),
                                           None if h2 is None else h2.data_ptr(), Tc, R, S,
                                           torch.cuda.current_stream().cuda_stream)
            check(rc == 0, "kernel 22 without its prefetch failed to launch: cudaError %d" % rc)
            return (U,)

    err = max(max_diff(torch, a, b) / max(1.0, float(b.abs().max())) for a, b in zip(built(), without()))
    with_us, without_us = [], []
    for _ in range(reps):
        with_us.append(event_us(torch, built, 5))
        without_us.append(event_us(torch, without, 5))
    a, b = float(np.median(with_us)), float(np.median(without_us))
    print("  kernel 22 prefetch A/B, %s: with the S <= 2 prefetch %.1f us, without %.1f us (CUDA events, medians "
          "of %d alternations; without / with %.3f); max|diff| %.2e" % (what, a, b, reps, b / a, err))
    check(err <= TOL, "kernel 22 without its prefetch differs from the built kernel by %.3e" % err)


def slice11_kernels(torch, pt, device, record, held):
    """Phase 3 for kernel 22 (the propagator chain: state mode at the
    strong-field harmonic call's one chunk, 2,304 rows x 2,560 steps; full
    mode at floquet_chern_31x31_nt128's 900 k-points x 128 steps and with
    its history at the Rudner winding's 256 k-points x 200 steps; random
    chains at S 4, 8, 9, 24, 32, 64), kernel 23 (the Hessian at
    superfluid_weight_lieb_48x48, 2,304 k, 2S 6; the grand potential at the
    same row's fd stencil, 9 twists; random 2S 2, 8, 12, 64), kernel 24
    (the Rudner winding at 17^2, nt 200, both gaps; random S 4, 16) and
    kernel 1's Floquet-block mode (driven graphene at nharm 5 on the 121-k
    path; nspin 2).  Each is held at 1e-12 against its plain version (the
    fixed-order sums of kernels 23 and 24 at 1e-10 relative); kernel 22's
    full mode against two batched torch.matmul calls a step as its
    library yardstick.  Then the device times PERF.md section 6 listed as
    not measured (CUDA events)."""
    from pythtb_tpu_torch import floquet, geometry, optical
    from pythtb_tpu_torch.ops import bdg_hessian as bh
    from pythtb_tpu_torch.ops import hamiltonian, propagate, winding

    rng = np.random.default_rng(11)
    # kernel 22, state mode: the strong-field call's whole chain (one chunk)
    w0, E0, kw = HHG_CALLS["strong"]
    (w, V, dH, psi0, dt, groups), _ = captured(optical, "propagate_state",
                                               lambda: pt.optical.harmonic_spectrum(pt.models.bn(delta=1.0), w0, E0,
                                                                                    **kw))
    Tc, R, S = w.shape
    want = propagate._propagate_state_plain(w, V, dH, psi0, dt, groups)
    got = propagate.propagate_state(w, V, dH, psi0.clone(), dt, groups)
    err = max(max_diff(torch, got[0], want[0]), max_diff(torch, got[1], want[1]) / float(want[1].abs().max()))
    record("propagate_state", "hhg strong: %d steps x %d rows S %d" % (Tc, R, S), err,
           lambda: propagate.propagate_state(w, V, dH, psi0.clone(), dt, groups),
           lambda: propagate._propagate_state_plain(w, V, dH, psi0, dt, groups),
           cost_propagate(Tc, R, S, psi0.shape[1], dH.shape[2]), True, reps=5, prof_reps=3, prof_plain=False)
    prefetch_ab(torch, "hhg strong: %d steps x %d rows S %d" % (Tc, R, S), "state", (w, V, dH, psi0, dt, groups))
    del w, V, dH, want, got

    def two_matmuls(w, V, U, dt):
        """The chain as two batched torch.matmul calls a step, exp(-i H dt)
        formed: kernel 22's full-mode library yardstick."""
        for st in range(w.shape[0]):
            E = (V[st].transpose(-1, -2) * torch.polar(torch.ones_like(w[st]), -w[st] * dt[:, None])[:, None, :]) \
                @ V[st].conj()
            U = E @ U
        return U

    # kernel 22, full mode: floquet_chern_31x31_nt128's chain
    g = pt.models.graphene()
    (w, V, U0, dt, hist), _ = captured(floquet, "propagate_full",
                                       lambda: pt.floquet.chern(g, FLQ_W, circ(0.8), band=0, nk=(S11["flq_nk"],) * 2,
                                                                nt=S11["flq_nt"]))
    Tc, R, S = w.shape
    check(hist is None, "the chern call should not keep a history")
    err = max_diff(torch, propagate.propagate_full(w, V, U0.clone(), dt), propagate._propagate_full_plain(w, V, U0, dt))
    record("propagate_full", "floquet chern 31^2: %d steps x %d k S %d" % (Tc, R, S), err,
           lambda: propagate.propagate_full(w, V, U0.clone(), dt),
           lambda: propagate._propagate_full_plain(w, V, U0, dt), cost_propagate(Tc, R, S), True,
           library_ms=cuda_ms(torch, lambda: two_matmuls(w, V, U0, dt), 5), reps=10, prof_reps=3, prof_plain=False)
    prefetch_ab(torch, "floquet chern 31^2: %d steps x %d k S %d" % (Tc, R, S), "full", (w, V, U0, dt, None))
    rd = rudner(pt)
    (w, V, U0, dt, hist0), _ = captured(floquet, "propagate_full",
                                        lambda: pt.floquet.winding_number(rd, RUDNER_W, rudner_drive(pt, rd),
                                                                          egap=[0.0, 0.5], nk=(17, 17), nt=200))
    hk, hp = torch.empty_like(hist0), torch.empty_like(hist0)
    err = max(max_diff(torch, propagate.propagate_full(w, V, U0.clone(), dt, hk),
                       propagate._propagate_full_plain(w, V, U0, dt, hp)), max_diff(torch, hk, hp))
    record("propagate_full", "rudner 17^2 history: %d steps x %d k" % tuple(w.shape[:2]), err,
           lambda: propagate.propagate_full(w, V, U0.clone(), dt, hk),
           lambda: propagate._propagate_full_plain(w, V, U0, dt, hp), cost_propagate(*w.shape, hist=True),
           library_ms=cuda_ms(torch, lambda: two_matmuls(w, V, U0, dt), 5), reps=5)
    for S in (4, 8, 9, 24, 32, 64):
        Tc, R = 12, (512 if S <= 8 else 24)
        a = rng.normal(size=(Tc, R, S, S)) + 1j * rng.normal(size=(Tc, R, S, S))
        wr, vr = np.linalg.eigh(a + np.conj(np.swapaxes(a, -1, -2)))
        wt = torch.as_tensor(wr).to(device)
        Vt = torch.as_tensor(np.ascontiguousarray(np.swapaxes(vr, -1, -2))).to(device)
        b = rng.normal(size=(Tc, R, 2, S, S)) + 1j * rng.normal(size=(Tc, R, 2, S, S))
        dHt = torch.as_tensor(b + np.conj(np.swapaxes(b, -1, -2))).to(device)
        q = np.linalg.qr(rng.normal(size=(R, S, S)) + 1j * rng.normal(size=(R, S, S)))[0]
        pst = torch.as_tensor(np.ascontiguousarray(q[:, : S // 2])).to(device)
        Ut = torch.as_tensor(q).to(device)
        dtt = torch.as_tensor(rng.uniform(0.05, 0.2, R)).to(device)
        got = propagate.propagate_state(wt, Vt, dHt, pst.clone(), dtt, 2)
        want = propagate._propagate_state_plain(wt, Vt, dHt, pst, dtt, 2)
        held("propagate_state", "random S %d, %d steps x %d rows" % (S, Tc, R),
             max(max_diff(torch, got[0], want[0]), max_diff(torch, got[1], want[1]) / float(want[1].abs().max())))
        record("propagate_full", "random S %d, %d steps x %d rows" % (S, Tc, R),
               max_diff(torch, propagate.propagate_full(wt, Vt, Ut.clone(), dtt),
                        propagate._propagate_full_plain(wt, Vt, Ut, dtt)),
               lambda: propagate.propagate_full(wt, Vt, Ut.clone(), dtt),
               lambda: propagate._propagate_full_plain(wt, Vt, Ut, dtt), cost_propagate(Tc, R, S),
               library_ms=cuda_ms(torch, lambda: two_matmuls(wt, Vt, Ut, dtt), 5), reps=5)

    # kernel 23: superfluid_weight_lieb_48x48, analytic and fd
    lieb = pt.models.lieb()
    nk = (S11["sfw_nk"],) * 2
    args, _ = captured(geometry, "bdg_hessian", lambda: pt.geometry.superfluid_weight(lieb, 0.0, 0.3, nk=nk))
    lam, U, dHp, dHm, d2p, d2m, lat, kt, tol = args
    want = bh._bdg_hessian_plain(*args)
    err = max_diff(torch, bh.bdg_hessian(*args), want) / float(want.abs().max())
    record("bdg_hessian", "lieb 48^2: B %d, 2S %d, d %d" % (lam.shape[0], lam.shape[1], dHp.shape[1]), err,
           lambda: bh.bdg_hessian(*args), lambda: bh._bdg_hessian_plain(*args),
           cost_bdg_hessian(lam.shape[0], lam.shape[1], dHp.shape[1]), True, tol=1e-10)
    gargs, _ = captured(geometry, "bdg_grand_potential",
                        lambda: quiet_warnings(pt.geometry.superfluid_weight, lieb, 0.0, 0.3, nk=nk, method="fd"))
    want = bh._bdg_grand_potential_plain(*gargs)
    err = max_diff(torch, bh.bdg_grand_potential(*gargs), want) / float(want.abs().max())
    record("bdg_grand_potential", "lieb 48^2 fd: %d twists x %d k, 2S %d" % (gargs[2], gargs[0].shape[0] // gargs[2],
                                                                              gargs[0].shape[1]), err,
           lambda: bh.bdg_grand_potential(*gargs), lambda: bh._bdg_grand_potential_plain(*gargs),
           cost_bdg_grand_potential(*gargs[0].shape), True, tol=1e-10)
    for N in (2, 8, 12, 64):
        B, d, Sh = (2048 if N <= 8 else 64), 2, N // 2
        a = rng.normal(size=(B, N, N)) + 1j * rng.normal(size=(B, N, N))
        lr, vr = np.linalg.eigh(a + np.conj(np.swapaxes(a, -1, -2)))
        lr[0, 1] = lr[0, 0]
        mats = []
        for shape in ((B, d, Sh, Sh), (B, d, Sh, Sh), (B, d, d, Sh, Sh), (B, d, d, Sh, Sh)):
            x = rng.normal(size=shape) + 1j * rng.normal(size=shape)
            mats.append(torch.as_tensor(x + np.conj(np.swapaxes(x, -1, -2))).to(device))
        rargs = (torch.as_tensor(lr).to(device), torch.as_tensor(np.ascontiguousarray(np.swapaxes(vr, -1, -2))).to(
            device), *mats, np.array([[1.0, 0.2], [0.0, 1.1]]), 0.05, 1e-13)
        want = bh._bdg_hessian_plain(*rargs)
        record("bdg_hessian", "random B %d 2S %d" % (B, N), max_diff(torch, bh.bdg_hessian(*rargs), want)
               / float(want.abs().max()), lambda: bh.bdg_hessian(*rargs), lambda: bh._bdg_hessian_plain(*rargs),
               cost_bdg_hessian(B, N, d), tol=1e-10, reps=5)
        lq = torch.as_tensor(rng.normal(size=(4 * B, N)) * 3.0).to(device)
        tq = torch.as_tensor(rng.normal(size=4 * B)).to(device)
        want = bh._bdg_grand_potential_plain(lq, tq, 4, 1e-3, 0.3)
        held("bdg_grand_potential", "random 4 x %d, 2S %d" % (B, N),
             max_diff(torch, bh.bdg_grand_potential(lq, tq, 4, 1e-3, 0.3), want) / float(want.abs().max()), tol=1e-10)

    # kernel 1's Floquet-block mode: examples/floquet_graphene.py's spectrum
    kv = g.k_path([[0.0, 0.0], [2.0 / 3.0, 1.0 / 3.0], [0.5, 0.5], [0.0, 0.0]], 121, report=False)[0]
    fargs, _ = captured(floquet, "assemble_floquet", lambda: pt.floquet.quasienergies(g, FLQ_W, circ(1.2), kv,
                                                                                       nharm=5))
    K = hamiltonian.assemble_floquet(*fargs)
    record("assemble_floquet", "graphene 121 k, nharm 5 (22 x 22)",
           max_diff(torch, K, hamiltonian._assemble_floquet_plain(*fargs)),
           lambda: hamiltonian.assemble_floquet(*fargs), lambda: hamiltonian._assemble_floquet_plain(*fargs),
           cost_assemble_floquet(K.shape[0], K.shape[-1]), True)
    km2 = pt.models.kane_mele()
    fargs2, _ = captured(floquet, "assemble_floquet", lambda: pt.floquet.quasienergies(km2, 8.0, circ(0.6), kv[::4],
                                                                                        nharm=2))
    held("assemble_floquet", "kane_mele nspin 2, 31 k, nharm 2",
         max_diff(torch, hamiltonian.assemble_floquet(*fargs2), hamiltonian._assemble_floquet_plain(*fargs2)))

    # kernel 24: examples/floquet_anomalous.py's winding numbers
    wargs, _ = captured(floquet, "winding", lambda: pt.floquet.winding_number(rd, RUDNER_W, rudner_drive(pt, rd),
                                                                              egap=[0.0, 0.5], nk=(17, 17), nt=200))
    hist, P, eps, p0, p1, n0, n1, T = wargs
    want = winding._winding_plain(*wargs)
    record("winding", "rudner 16^2 x 200 steps, 2 gaps, S 2",
           max_diff(torch, winding.winding(*wargs), want) / max(1.0, float(want.abs().max())),
           lambda: winding.winding(*wargs), lambda: winding._winding_plain(*wargs),
           cost_winding(eps.shape[0], hist.shape[0] - 1, hist.shape[1], hist.shape[-1]), True, tol=1e-10, reps=10)
    for S in (4, 16):
        n0, n1, nt, B = 6, 5, 24, 30
        a = rng.normal(size=(nt + 1, B, S, S)) + 1j * rng.normal(size=(nt + 1, B, S, S))
        hr = torch.as_tensor(np.linalg.qr(a)[0]).to(device)
        Pr = torch.as_tensor(np.linalg.qr(rng.normal(size=(B, S, S)) + 1j * rng.normal(size=(B, S, S)))[0]).to(device)
        er = torch.as_tensor(rng.uniform(-1.0, 1.0, (2, B, S))).to(device)
        pr0, pr1 = (torch.as_tensor(np.exp(2j * np.pi * rng.random(S))).to(device) for _ in range(2))
        rargs = (hr, Pr, er, pr0, pr1, n0, n1, 2.0)
        want = winding._winding_plain(*rargs)
        record("winding", "random S %d, %d x %d x %d steps" % (S, n0, n1, nt),
               max_diff(torch, winding.winding(*rargs), want) / max(1.0, float(want.abs().max())),
               lambda: winding.winding(*rargs), lambda: winding._winding_plain(*rargs), cost_winding(2, nt, B, S),
               tol=1e-10, reps=5)
    gap_fill(torch, pt, device)


def gap_fill(torch, pt, device):
    """Device times (CUDA events) that PERF.md section 6 listed as not
    measured: kernel 16 at ed.spectral_function's shape, kernel 1 at
    dmft._assemble_ri_jit's, ed._eigh_dev's library eigh at D 400 and 924,
    fermisurface._grid_evals_dev at the square lattice's 301^2 grid and
    geometry._kp_tensors at graphene's K."""
    from pythtb_tpu_torch import fermisurface, geometry
    from pythtb_tpu_torch.ops import eigh, hamiltonian
    from pythtb_tpu_torch.optical import spectral_sum

    rng = np.random.default_rng(12)
    Wl = torch.as_tensor(rng.random((1, 792)) + 0j).to(device)
    dl = torch.as_tensor(rng.uniform(-6.0, 10.0, 792)).to(device)
    oml = torch.as_tensor(HUBBARD_ED_W).to(device)
    print("  gap: ed._lorentz_sum_dev (kernel 16, T 792, nw 601): %.1f us (CUDA events)"
          % event_us(torch, lambda: spectral_sum(Wl, dl, oml, 0.15, "lorentz")))
    ad = arpes_model(pt)._get_finalized()
    ka = torch.as_tensor(rng.random((1001, 2))).to(device)
    print("  gap: dmft._assemble_ri_jit (kernel 1, B 1,001, 8 x 8): %.1f us (CUDA events)"
          % event_us(torch, lambda: hamiltonian.assemble(ad, ka)))
    for D in (400, 924):
        a = rng.normal(size=(D, D)) + 1j * rng.normal(size=(D, D))
        Hd = torch.as_tensor(a + a.conj().T).to(device)[None]
        print("  gap: ed._eigh_dev (eigh_batched, torch.linalg.eigh) D %d: %.1f us (CUDA events)"
              % (D, event_us(torch, lambda: eigh.eigh_batched(Hd), 5)))
    sq = pt.models.square(t=-1.0)._get_finalized()
    print("  gap: fermisurface._grid_evals_dev square 301^2: %.1f us (CUDA events)"
          % event_us(torch, lambda: fermisurface._grid_evals_dev(sq, S10["fs_nk"])))
    gd = pt.models.graphene()._get_finalized()
    kK = torch.as_tensor([[1.0 / 3.0, 2.0 / 3.0]], dtype=torch.float64).to(device)
    lat = np.asarray(pt.models.graphene()._lat, dtype=np.float64)
    print("  gap: geometry._kp_tensors graphene K (one k): %.1f us (CUDA events)"
          % event_us(torch, lambda: geometry._kp_tensors(gd, kK, lat)))


def slice11_path(pt, where, reference):
    """The eleventh slice's calls with their pins: superfluid_weight_lieb_48x48
    (tools/bench_suite.py:463; D_xx within 2e-3 of 0.211647, |D_xx - D_yy| <
    1e-3, and the fd route at the same size within 1e-6 relative),
    floquet_chern_31x31_nt128 (:343; |C + 1| < 1e-3), the three calls of
    examples/high_harmonics.py (weak field 36^2 x 2,304 steps, strong
    field 48^2 x 2,560 steps with 25 harmonics, the 10-frequency SHG sweep
    36^2 x 1,728 steps), examples/floquet_graphene.py (quasienergies at
    nharm 5 on 121 k, the 12-cell ribbon's exact quasienergies at 81 k, nt
    96, the gap sweep at K, the Chern number at 19^2, nt 96) and
    examples/floquet_anomalous.py (the 16-cell Rudner ribbon at 81 k, nt
    300, the bulk at 81 k, W in both gaps at 17^2, nt 200, |W| within 0.06
    of 1, and the band Chern number, |C| < 0.1).  The CPU reference runs
    the harmonic calls at 6^2 x 5 cycles of 16 steps (the same omega and
    E0), the superfluid weight at 12^2 (fd at step 3e-2: the stencil
    divides the free energies' rounding by step^2), the Chern row at
    11^2 x 32 steps and the ribbons at 9 k; the card runs those sizes
    too, for the comparison, and runs the small harmonic calls and the
    Rudner winding and Chern calls once more in chunks of 13 steps, so
    that kernel 22 hands its state from one launch to the next."""
    import warnings

    from pythtb_tpu_torch.ops import _kernels

    out = {}

    def timed(fn, *args, **kwargs):
        t0 = time.perf_counter()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            result = fn(*args, **kwargs)
        return result, time.perf_counter() - t0

    bn = pt.models.bn(delta=1.0)
    for key, (w0, E0, kw) in HHG_CALLS.items():
        if not reference:
            before = dict(_kernels.LAUNCHES)
            r, sec = timed(pt.optical.harmonic_spectrum, bn, w0, E0, **kw)
            amps = np.abs(r["harmonics"]).max(axis=-1)
            delta = {k: v - before[k] for k, v in _kernels.LAUNCHES.items() if v != before[k]}
            print("  %s harmonic_spectrum bn %s field (nk %s, %d steps, %d frequencies): |C_1| %s  launches %s "
                  "(%d in all)  [%.2f s]" % (where, key, kw["nk"], kw["cycles"] * kw["steps_per_cycle"],
                                             np.size(w0), np.array2string(amps[..., 1], precision=4), delta,
                                             sum(delta.values()), sec))
            check(bool(np.isfinite(r["current"]).all()) and bool(np.isfinite(r["harmonics"]).all()),
                  "harmonic_spectrum %s: non-finite output" % key)
            check(delta.get("propagate_state", 0) >= 1 and delta.get("assemble_dk", 0) == delta["propagate_state"]
                  and delta.get("assemble", 0) == delta["propagate_state"] + 1,
                  "harmonic_spectrum %s: not one kernel-1, kernel-15 and kernel-22 launch a chunk: %s" % (key, delta))
            if key == "strong":
                out["hhg_strong_launches"] = delta
        small = dict(kw, nk=(S11["hhg_cpu_nk"],) * 2, **HHG_CPU)
        r, sec = timed(pt.optical.harmonic_spectrum, bn, w0, E0, **small)
        out["hhg_" + key] = np.concatenate([r["current"].reshape(-1), np.abs(r["harmonics"]).reshape(-1)])
        print("  %s harmonic_spectrum bn %s field at nk %s, %d steps (the CPU comparison's size)  [%.2f s]"
              % (where, key, small["nk"], HHG_CPU["cycles"] * HHG_CPU["steps_per_cycle"], sec))
        if not reference:
            # the same call in chunks of 13 steps: the state handed from
            # one kernel-22 launch to the next, held against the CPU's
            # single chunk
            before = _kernels.LAUNCHES["propagate_state"]
            with steps_a_chunk(pt, S11["chunk"]):
                r = pt.optical.harmonic_spectrum(bn, w0, E0, **small)
            chunks = _kernels.LAUNCHES["propagate_state"] - before
            out["hhg_%s_chunked" % key] = np.concatenate([r["current"].reshape(-1),
                                                          np.abs(r["harmonics"]).reshape(-1)])
            nt = HHG_CPU["cycles"] * HHG_CPU["steps_per_cycle"]
            check(chunks == -(-nt // S11["chunk"]),
                  "harmonic_spectrum %s in chunks of %d steps made %d kernel-22 launches" % (key, S11["chunk"], chunks))

    lieb = pt.models.lieb()
    if not reference:
        nk = (S11["sfw_nk"],) * 2
        D, sec = timed(pt.geometry.superfluid_weight, lieb, 0.0, 0.3, nk=nk)
        Dfd, sec2 = timed(pt.geometry.superfluid_weight, lieb, 0.0, 0.3, nk=nk, method="fd")
        rel = float(np.abs(Dfd - D).max() / np.abs(D).max())
        print("  %s superfluid_weight lieb 48x48: D_xx %.6f D_yy %.6f  [%.2f s]; fd %.6f (relative %.3e)  [%.2f s]"
              % (where, D[0, 0], D[1, 1], sec, Dfd[0, 0], rel, sec2))
        check(abs(D[0, 0] - SFW_PIN) < 2e-3 and abs(D[0, 0] - D[1, 1]) < 1e-3,
              "superfluid_weight_lieb_48x48: D_xx %.6f, D_yy %.6f" % (D[0, 0], D[1, 1]))
        check(rel < 1e-6, "the fd superfluid weight differs from the analytic one by %.3e" % rel)
    nc = (S11["sfw_cpu_nk"],) * 2
    out["sfw"] = np.concatenate([pt.geometry.superfluid_weight(lieb, 0.0, 0.3, nk=nc).reshape(-1),
                                 pt.geometry.superfluid_weight(lieb, 0.0, 0.3, nk=nc, method="fd",
                                                               step=3e-2).reshape(-1)])

    g = pt.models.graphene()
    if not reference:
        before = dict(_kernels.LAUNCHES)
        c, sec = timed(pt.floquet.chern, g, FLQ_W, circ(0.8), band=0, nk=(S11["flq_nk"],) * 2, nt=S11["flq_nt"])
        delta = {k: v - before[k] for k, v in _kernels.LAUNCHES.items() if v != before[k]}
        print("  %s floquet.chern graphene 31x31 nt 128: C %.8f  launches %s  [%.2f s]" % (where, c, delta, sec))
        check(abs(c + 1.0) < 1e-3, "floquet_chern_31x31_nt128: C %.6f is not -1" % c)
        check(delta.get("propagate_full") == 1 and delta.get("assemble_members") == 1,
              "floquet.chern: not one flux-batch and one kernel-22 launch for its one chunk: %s" % delta)
    out["flq_chern_small"] = np.array([pt.floquet.chern(g, FLQ_W, circ(0.8), band=0, nk=(S11["flq_cpu_nk"],) * 2,
                                                        nt=S11["flq_cpu_nt"])])
    # examples/floquet_graphene.py
    kv = g.k_path([[0.0, 0.0], [1.0 / 3.0, 2.0 / 3.0], [0.5, 0.5], [0.0, 0.0]], 121, report=False)[0]
    (quasi, wgt), sec = timed(pt.floquet.quasienergies, g, FLQ_W, circ(1.2), kv, nharm=5)
    print("  %s floquet.quasienergies graphene 121 k, nharm 5 (22 x 22)  [%.2f s]" % (where, sec))
    out["flq_quasi"], out["flq_weights"] = quasi, wgt
    rib = g.cut_piece(12, 1, glue_edgs=False)
    kr = np.linspace(0.0, 1.0, 81)[:, None]
    if not reference:
        eps_r, sec = timed(pt.floquet.quasienergies_exact, rib, FLQ_W, circ(1.2), kr, nt=96)
        print("  %s floquet.quasienergies_exact 12-cell ribbon (S 24), 81 k, nt 96: finite %s  [%.2f s]"
              % (where, bool(np.isfinite(eps_r).all()), sec))
        check(eps_r.shape == (81, 24) and bool(np.isfinite(eps_r).all()), "the driven ribbon's quasienergies")
    out["flq_ribbon"] = pt.floquet.quasienergies_exact(rib, FLQ_W, circ(1.2), kr[:: 80 // (S11["ribbon_cpu_k"] - 1)],
                                                       nt=96)
    kK = np.array([[1.0 / 3.0, 2.0 / 3.0]])
    gaps = []
    for A in np.linspace(0.0, 1.6, 9):
        e = pt.floquet.quasienergies_exact(g, FLQ_W, circ(A), kK, nt=128)
        ek = pt.floquet.effective_model(g, FLQ_W, circ(A)).solve_all(kK)
        gaps.append([e[0, 1] - e[0, 0], ek[1, 0] - ek[0, 0]])
    out["flq_gaps"] = np.array(gaps)
    c19, sec = timed(pt.floquet.chern, g, FLQ_W, circ(1.2), band=0, nk=(19, 19), nt=96)
    out["flq_chern19"] = np.array([c19])
    print("  %s floquet gap sweep at K (9 amplitudes) and chern 19x19 nt 96: C %.6f  [%.2f s]" % (where, c19, sec))
    # examples/floquet_anomalous.py
    rd = rudner(pt)
    rrib = rd.cut_piece(16, 1, glue_edgs=False)
    if not reference:
        e_rib, sec = timed(pt.floquet.quasienergies_exact, rrib, RUDNER_W, rudner_drive(pt, rrib), kr, nt=300)
        print("  %s floquet.quasienergies_exact 16-cell Rudner ribbon (S 32), 81 k, nt 300  [%.2f s]" % (where, sec))
        check(e_rib.shape == (81, 32) and bool(np.isfinite(e_rib).all()), "the Rudner ribbon's quasienergies")
    out["rudner_ribbon"] = pt.floquet.quasienergies_exact(rrib, RUDNER_W, rudner_drive(pt, rrib),
                                                          kr[:: 80 // (S11["ribbon_cpu_k"] - 1)], nt=300)
    kb = np.stack([np.linspace(0.0, 1.0, 81), np.zeros(81)], -1)
    out["rudner_bulk"] = pt.floquet.quasienergies_exact(rd, RUDNER_W, rudner_drive(pt, rd), kb, nt=300)
    (w0, wp), sec = timed(pt.floquet.winding_number, rd, RUDNER_W, rudner_drive(pt, rd), egap=[0.0, RUDNER_W / 2],
                          nk=(17, 17), nt=200)
    c0 = pt.floquet.chern(rd, RUDNER_W, rudner_drive(pt, rd), band=0, nk=(17, 17), nt=200)
    print("  %s floquet.winding_number rudner 17x17 nt 200: W(0) %+.4f W(pi) %+.4f, band Chern %+.5f  [%.2f s]"
          % (where, w0, wp, c0, sec))
    check(abs(w0 - round(w0)) < 0.06 and abs(round(w0)) == 1 and abs(wp - round(wp)) < 0.06
          and round(wp) == round(w0) and abs(c0) < 0.1, "the anomalous phase: W %.4f, %.4f, C %.4f" % (w0, wp, c0))
    out["rudner_wc"] = np.array([w0, wp, c0])
    if not reference:
        # the winding call with its history written in chunks of 13 steps
        before = _kernels.LAUNCHES["propagate_full"]
        with steps_a_chunk(pt, S11["chunk"]):
            wc = pt.floquet.winding_number(rd, RUDNER_W, rudner_drive(pt, rd), egap=[0.0, RUDNER_W / 2], nk=(17, 17),
                                           nt=200)
            cc = pt.floquet.chern(rd, RUDNER_W, rudner_drive(pt, rd), band=0, nk=(17, 17), nt=200)
        chunks = _kernels.LAUNCHES["propagate_full"] - before
        out["rudner_wc_chunked"] = np.array([wc[0], wc[1], cc])
        check(chunks == 2 * -(-200 // S11["chunk"]),
              "the Rudner winding and Chern calls in chunks of %d steps made %d kernel-22 launches"
              % (S11["chunk"], chunks))
    return out


@contextlib.contextmanager
def steps_a_chunk(pt, n):
    """Run the harmonic and Floquet chains in chunks of ``n`` steps (their
    chunk_steps patched), so the state or U passes between kernel-22
    launches."""
    saved = pt.optical.chunk_steps, pt.floquet.chunk_steps
    pt.optical.chunk_steps = pt.floquet.chunk_steps = lambda nt, step_bytes: min(nt, n)
    try:
        yield
    finally:
        pt.optical.chunk_steps, pt.floquet.chunk_steps = saved


def compare_slice11(out, ref):
    """The eleventh slice on the card against the CPU run, each at 1e-10
    relative to its largest entry: the three harmonic calls' currents and
    |C_n| at the small size, the superfluid weight (analytic and fd at step
    3e-2), the Floquet Chern numbers, the graphene spectrum with its sorted
    m = 0 weights, the ribbons' and the bulk's exact quasienergies, the gap
    sweep and the Rudner winding numbers; the harmonic calls and the
    Rudner numbers also as the card ran them in chunks of 13 steps."""
    pairs = [(key, key) for key in ("hhg_weak", "hhg_strong", "hhg_shg", "sfw", "flq_chern_small", "flq_quasi",
                                    "flq_gaps", "flq_chern19", "rudner_wc")]
    # the card's runs in chunks of 13 steps against the CPU's one chunk
    pairs += [(key + "_chunked", key) for key in ("hhg_weak", "hhg_strong", "hhg_shg", "rudner_wc")]
    for key, rkey in pairs:
        got, want = np.asarray(out[key]), np.asarray(ref[rkey])
        check(got.shape == want.shape, "%s: shape %s differs from the CPU run's %s" % (key, got.shape, want.shape))
        err = float(np.abs(got - want).max() / max(1e-300, np.abs(want).max()))
        print("  %s vs CPU: max|diff| %.3e (relative)" % (key, err))
        check(err <= 1e-10, "%s differs from the CPU path by %.3e (relative)" % (key, err))
    # m = 0 weights where the spectrum is not degenerate
    q = np.asarray(ref["flq_quasi"])
    ok = np.ones(q.shape, dtype=bool)
    gap = np.diff(q, axis=-1) > 1e-6
    ok[:, 1:] &= gap
    ok[:, :-1] &= gap
    err = float(np.abs(np.asarray(out["flq_weights"]) - np.asarray(ref["flq_weights"]))[ok].max())
    print("  flq_weights vs CPU (%d of %d non-degenerate): max|diff| %.3e" % (ok.sum(), ok.size, err))
    check(err <= 1e-10, "the Floquet m = 0 weights differ from the CPU path by %.3e" % err)
    # exact quasienergies as sets on the circle: an eigenphase at the zone
    # edge may land on either side of the fold on the card and the CPU
    for key, omega in (("flq_ribbon", FLQ_W), ("rudner_ribbon", RUDNER_W), ("rudner_bulk", RUDNER_W)):
        err = match_phase_sets(2.0 * np.pi * np.asarray(out[key]) / omega, 2.0 * np.pi * np.asarray(ref[key]) / omega,
                               2.0 * np.pi * 1e-10, key)
        print("  %s vs CPU: max|diff| %.3e (quasienergy phases modulo 2 pi, as sets)" % (key, err))


# -- slice 12: lattice dynamics, electron-phonon coupling, linear spin waves --

S12 = {"kappa_nk": 768, "kappa_cpu_nk": 48, "dos_nk": 96, "hc_nk": 64, "eli_nk": 24, "eli_cpu_nk": 14, "neutron_q": 4096,
       "neutron_cpu_q": 64, "hall_nk": 41, "chern_nk": 31}
KAPPA_TS = np.linspace(0.05, 1.0, 40)  # phonon_kappa_map_honeycomb
KAPPA_PIN = 0.074135  # kappa_xx(0.5) (tools/bench_suite.py:648)
OMEGA_M_PIN = np.array([0.707107, 1.322876, 1.414214, 1.802776])  # omega at M, the same row
MAGNON_TS = np.linspace(0.05, 1.0, 20)  # magnon_thermal_hall_map
KXY_PIN = -0.0916  # kappa_xy(0.5) (tools/bench_suite.py:576)
NEUTRON_W = np.linspace(0.0, 4.5, 300)  # neutron_map_kagome_4096q (:812)
EPH_BETA, EPH_MU = 2.0, -0.8  # examples/eph_linewidths.py
EPH_TS = np.array([0.02, 0.04, 0.08, 0.15, 0.3])


def honeycomb_springs(pt):
    """The spring honeycomb of examples/phonon_bands.py and the kappa row."""
    fm = pt.phonon.force_model([[1.0, 0.0], [0.5, np.sqrt(3.0) / 2.0]], [[1 / 3, 1 / 3], [2 / 3, 2 / 3]])
    fm.set_spring(1.0, 0, 1, [0, 0], kt=0.25)
    fm.set_spring(1.0, 1, 0, [1, 0], kt=0.25)
    fm.set_spring(1.0, 1, 0, [0, 1], kt=0.25)
    return fm


def eph_honeycomb(pt):
    """examples/eph_linewidths.py's electrons and phonons on one honeycomb."""
    lat, orb = [[1.0, 0.0], [0.5, np.sqrt(3.0) / 2.0]], [[1 / 3, 1 / 3], [2 / 3, 2 / 3]]
    m = pt.tb_model(2, 2, lat, orb)
    m.set_hop(-1.0, 0, 1, [0, 0])
    m.set_hop(-1.0, 1, 0, [1, 0])
    m.set_hop(-1.0, 1, 0, [0, 1])
    fc = pt.phonon.force_model(lat, orb, masses=[1.0, 1.0])
    fc.set_spring(1.0, 0, 1, [0, 0], kt=0.25)
    fc.set_spring(1.0, 1, 0, [1, 0], kt=0.25)
    fc.set_spring(1.0, 1, 0, [0, 1], kt=0.25)
    return m, fc


def eph_paths(m):
    """examples/eph_linewidths.py's k-path (49 k) and its Fermi-surface
    and band-bottom points."""
    kpath = m.k_path([[0, 0], [2 / 3, 1 / 3], [0.5, 0.0], [0, 0]], 49, report=False)[0]
    kline = np.stack([np.linspace(0.0, 2 / 3, 160), np.linspace(0.0, 1 / 3, 160)], axis=-1)
    e_lo = np.asarray(m.solve_all(kline))[0]
    return kpath, np.stack([kline[np.argmin(np.abs(e_lo - EPH_MU))], [0.0, 0.0]])


def honeycomb_magnet(pt):
    """magnon_thermal_hall_map's FM honeycomb with DM and field."""
    sm = pt.magnon.spin_model([[1.0, 0.0], [0.5, np.sqrt(3) / 2]], [[1 / 3, 1 / 3], [2 / 3, 2 / 3]], spin=0.5)
    sm.set_coupling(-1.0, 0, 1, [0, 0])
    sm.set_coupling(-1.0, 1, 0, [1, 0])
    sm.set_coupling(-1.0, 1, 0, [0, 1])
    for dR in ((1, 0), (-1, 1), (0, -1)):
        sm.set_coupling(np.zeros((3, 3)), 0, 0, dR, dm=[0, 0, 0.2])
        sm.set_coupling(np.zeros((3, 3)), 1, 1, dR, dm=[0, 0, -0.2])
    sm.set_field([0, 0, 0.05])
    return sm


def kagome_magnet(pt):
    """neutron_map_kagome_4096q's FM kagome with DM and field, and its q draws."""
    sm = pt.magnon.spin_model([[1.0, 0.0], [0.5, np.sqrt(3) / 2]], [[0.0, 0.0], [0.5, 0.0], [0.0, 0.5]], spin=0.5)
    for i, j, R in ((0, 1, [0, 0]), (0, 2, [0, 0]), (1, 2, [0, 0]), (1, 0, [1, 0]), (2, 0, [0, 1]), (2, 1, [-1, 1])):
        sm.set_coupling(-1.0, i, j, R, dm=[0.0, 0.0, 0.15])
    sm.set_field([0, 0, 0.02])
    return sm, np.random.default_rng(7).random((S12["neutron_q"], 2))


def cost_phonon_kappa(B, N, dk, nT):
    """Kernel 25: the eigenvectors and dD read once (16 (1 + dk) B N^2
    bytes), omega and the (nT, dk, dk) result; per (k, mode) the dk
    sandwiches (8 N^2 each) and per (k, mode, T) the c_v weight (~25
    operations: a division, a sinh, a square) and dk^2 products."""
    nbytes = C128 * B * N * N * (1 + dk) + F64 * B * N + F64 * nT * (1 + dk * dk)
    return bound(nbytes, B * N * (8 * dk * N * N + nT * (25 + 2 * dk * dk)))


def cost_eph_vertex(Kc, Q, nmode, S, nh, natom, d):
    """Kernel 26: the |g|^2 write, the states of k and k + q and the
    amplitudes read once; 8 S^2 nh operations a (k, q, mode) for the
    complex sums (the coefficients' ~40 nh come on top)."""
    nbytes = F64 * Kc * Q * nmode * S * S + C128 * (Kc * Q * S * S + Kc * S * S + Q * nmode * natom * d)
    return bound(nbytes, Kc * Q * nmode * (8 * S * S * nh + 40 * nh))


def cost_colpa(B, m, nb):
    """Kernel 27: T and L written (32 m^2 bytes a k), the k-points read;
    per k the Cholesky (m^3 / 6 complex multiply-adds, 8 operations each)
    and the product (m^3 / 3 of them), and the bond gather (m^2 nb
    comparisons)."""
    return bound(B * (2 * C128 * m * m + F64 * 2), B * (4 * m**3 + m * m * nb))


def slice12_kernels(torch, pt, device, record, held):
    """Phase 3 for kernel 25 (the kappa sweep at phonon_kappa_map_honeycomb:
    768^2 k, N 4, 40 T; the sums at 1e-10 relative), kernel 26 (the e-ph
    vertex at examples/eph_linewidths.py's 49-k path x 18^2 q and at
    eliashberg's default 24^2 x 24^2 chunk; random S 4 / 17 held) and
    kernel 27 (the Colpa factorization at magnon_thermal_hall_map's 41^2 x
    2n 4 and neutron_map_kagome_4096q's 4,096 q x 2n 6, random 2n 16 / 64),
    each against its plain version (1e-12 of its largest entry), captured
    from the real calls.  Then the device time and bound of the Floquet
    Chern row's states step (unitary_eig and kernels 3-4, PERF.md section
    6).  (The kappa row's eigensolve, on kernel 7, is held and
    timed against the library by eigh_callers in slice7_kernels.)"""
    from pythtb_tpu_torch import eph, floquet, magnon, phonon
    from pythtb_tpu_torch.ops import colpa, eph_vertex, phonon_kappa

    rng = np.random.default_rng(12)
    fm = honeycomb_springs(pt)
    nk = S12["kappa_nk"]
    args, _ = captured(phonon, "phonon_kappa", lambda: pt.phonon.thermal_conductivity(fm, KAPPA_TS, nk))
    vecs, dD, omega, Ts = args
    B, N, dk = vecs.shape[0], vecs.shape[1], dD.shape[1]
    want = phonon_kappa._phonon_kappa_plain(*args)
    err = max_diff(torch, phonon_kappa.phonon_kappa(*args), want) / float(want.abs().max())
    record("phonon_kappa", "kappa honeycomb %d^2: B %d, N %d, %d T" % (nk, B, N, Ts.shape[0]), err,
           lambda: phonon_kappa.phonon_kappa(*args), lambda: phonon_kappa._phonon_kappa_plain(*args),
           cost_phonon_kappa(B, N, dk, Ts.shape[0]), True, tol=1e-10, reps=10)
    for Bs, Ns, dks in ((4096, 6, 3), (20000, 2, 1)):
        v = unit_states(torch, rng, (Bs, Ns, Ns), device)
        a = rng.normal(size=(Bs, dks, Ns, Ns)) + 1j * rng.normal(size=(Bs, dks, Ns, Ns))
        dDr = torch.as_tensor(a + np.conj(np.swapaxes(a, -1, -2))).to(device)
        om = torch.as_tensor(rng.uniform(0.0, 3.0, (Bs, Ns))).to(device)
        want = phonon_kappa._phonon_kappa_plain(v, dDr, om, Ts)
        held("phonon_kappa", "random B %d, N %d, dim_k %d" % (Bs, Ns, dks),
             max_diff(torch, phonon_kappa.phonon_kappa(v, dDr, om, Ts), want) / float(want.abs().max()), tol=1e-10)
    # the kappa row's eigensolve: kernel 7, held and timed against
    # the library by eigh_callers in slice7_kernels
    del args, vecs, dD, omega

    # kernel 26: the example's linewidth path and eliashberg's default chunk
    m, fc = eph_honeycomb(pt)
    kpath, _ = eph_paths(m)
    for key, call, main in (
            ("eph example: 49 k x 18^2 q", lambda: pt.eph.linewidths(m, fc, EPH_BETA, kpath, mu=EPH_MU, temperature=0.08,
                                                                      nkq=(18, 18), sigma=0.08), False),
            ("eliashberg default: 576 k x 24^2 q", lambda: pt.eph.eliashberg(m, fc, EPH_BETA, mu=EPH_MU), True)):
        va, _ = captured(eph, "eph_vertex", call)
        vk, vkq, A, tab, kk, qg = va
        Kc, Q, S = vkq.shape[0], vkq.shape[1], vkq.shape[-1]
        want = eph_vertex._eph_vertex_plain(*va)
        err = max_diff(torch, eph_vertex.eph_vertex(*va), want) / float(want.abs().max())
        record("eph_vertex", "%s, %d modes, S %d" % (key, A.shape[1], S), err, lambda: eph_vertex.eph_vertex(*va),
               lambda: eph_vertex._eph_vertex_plain(*va),
               cost_eph_vertex(Kc, Q, A.shape[1], S, tab.nh, A.shape[2], A.shape[3]), main, reps=10)
    for S, nh in ((4, 40), (17, 300)):
        geom = {"i": rng.integers(0, S, nh), "j": rng.integers(0, S, nh), "R": rng.integers(-2, 3, (nh, 2)) * 1.0,
                "tp": rng.normal(size=nh) + 1j * rng.normal(size=nh), "dhat": rng.normal(size=(nh, 2)),
                "atom_of": rng.integers(0, 3, S)}
        tabr = eph_vertex.VertexTables(geom, device)
        vk, vkq = unit_states(torch, rng, (4, S, S), device), unit_states(torch, rng, (4, 36, S, S), device)
        A = torch.as_tensor(rng.normal(size=(36, 6, 3, 2)) + 1j * rng.normal(size=(36, 6, 3, 2))).to(device)
        kk = torch.as_tensor(rng.random((4, 2))).to(device)
        qg = torch.as_tensor(rng.random((36, 2))).to(device)
        want = eph_vertex._eph_vertex_plain(vk, vkq, A, tabr, kk, qg)
        held("eph_vertex", "random S %d, nh %d, 4 k x 36 q x 6 modes" % (S, nh),
             max_diff(torch, eph_vertex.eph_vertex(vk, vkq, A, tabr, kk, qg), want) / float(want.abs().max()))

    # kernel 27: the thermal-Hall grid and the neutron row
    hm = honeycomb_magnet(pt)
    km, qs = kagome_magnet(pt)
    for key, call, main in (
            ("thermal Hall 41^2, 2n 4", lambda: pt.magnon.thermal_hall(hm, MAGNON_TS, nk=S12["hall_nk"]), True),
            ("neutron 4,096 q, 2n 6", lambda: pt.magnon.structure_factor(km, qs, omegas=NEUTRON_W, eta=0.05), False)):
        (tab, shift, kk), _ = captured(magnon, "colpa", call)
        T, L = colpa.colpa(tab, shift, kk)
        Tp, Lp = colpa._colpa_plain(tab, shift, kk)
        err = max(max_diff(torch, T, Tp) / float(Tp.abs().max()), max_diff(torch, L, Lp) / float(Lp.abs().max()))
        m2 = 2 * tab.n
        record("colpa", "%s, B %d" % (key, kk.shape[0]), err, lambda: colpa.colpa(tab, shift, kk),
               lambda: colpa._colpa_plain(tab, shift, kk), cost_colpa(kk.shape[0], m2, tab.nb), main)
        hlib = (Lp @ Lp.mH).contiguous()
        print("  colpa %s: torch.linalg.cholesky_ex of the same h alone %.4f ms (a part of the function)"
              % (key, cuda_ms(torch, lambda: torch.linalg.cholesky_ex(hlib))))
    for n, nb, B in ((8, 40, 4096), (32, 200, 256)):
        amp = (rng.normal(size=nb) + 1j * rng.normal(size=nb)) * 0.3
        tabr = colpa.ColpaTables(rng.integers(0, n, nb), rng.integers(0, n, nb), rng.normal(size=(nb, 2)), amp,
                                 np.roll(amp, 1), -(3.0 + 0.3 * nb / n) * np.ones(n), device)
        kk = torch.as_tensor(rng.random((B, 2))).to(device)
        T, L = colpa.colpa(tabr, 1e-9, kk)
        Tp, Lp = colpa._colpa_plain(tabr, 1e-9, kk)
        err = max(max_diff(torch, T, Tp) / float(Tp.abs().max()), max_diff(torch, L, Lp) / float(Lp.abs().max()))
        record("colpa", "random 2n %d, nb %d, B %d" % (2 * n, nb, B), err, lambda: colpa.colpa(tabr, 1e-9, kk),
               lambda: colpa._colpa_plain(tabr, 1e-9, kk), cost_colpa(B, 2 * n, nb), reps=5)
    bad = pt.magnon.spin_model([[2.0]], [[0.0], [0.5]], spin=0.5)
    bad.set_coupling(1.0, 0, 1, [0])
    bad.set_coupling(1.0, 1, 0, [1])
    T, _ = colpa.colpa(colpa.ColpaTables(*bad._tables(), device), 0.0, torch.tensor([[0.25]], device=device,
                                                                                    dtype=torch.float64))
    torch.cuda.synchronize()
    check(bool(torch.isnan(T).all()), "kernel 27 did not write NaN for an h(k) that is not positive definite")
    try:
        pt.magnon.bands(bad, [[0.25]], shift=0.0)
        check(False, "magnon.bands accepted a configuration that is not a classical minimum")
    except pt.PythtbError as exc:
        check("Colpa decomposition failed" in str(exc), "unexpected error %s" % exc)
    print("  colpa: an h(k) that is not positive definite gives NaN and the reference's error on the card")

    # the Floquet Chern row's states step (floquet._eigenphases_packed,
    # _floquet_states_jit): unitary_eig and kernels 3-4, PERF.md section 6
    g = pt.models.graphene()
    fargs, _ = captured(floquet, "_floquet_states_flux",
                        lambda: pt.floquet.chern(g, FLQ_W, circ(0.8), band=0, nk=(S11["flq_nk"],) * 2,
                                                 nt=S11["flq_nt"]))
    U = fargs[4]
    Bf, Sf = U.shape[0], U.shape[-1]
    us = event_us(torch, lambda: floquet._floquet_states_flux(*fargs))
    prof_us, prof_n = device_us(torch, lambda: floquet._floquet_states_flux(*fargs), 10)
    A = (U + U.mH) / 2
    lib = event_us(torch, lambda: torch.linalg.eigh(A))
    nbytes = C128 * Bf * Sf * Sf
    bnd = bound(nbytes, Bf * 36 * Sf**3)
    print("  gap: floquet._eigenphases_packed + _floquet_states_jit (unitary_eig, kernels 3-4) at the Chern row's "
          "%d states of %d x %d: %.1f us (CUDA events; the eigh's info check waits on the device, so host time is "
          "in it), profiler %s us in %s device activities; bound %.5f ms (%s: the states read once, 36 m^3 "
          "operations an eigh); library torch.linalg.eigh of (U + U^H) / 2 alone %.1f us"
          % (Bf, Sf, Sf, us, fmt(prof_us), fmt(prof_n), bnd[0], bnd[1], lib))
    slice12_rows(torch, pt, device)


def slice12_rows(torch, pt, device):
    """The device time and bound of each B2 program of PERF.md section 6,
    whole, at its row's shape: _dynmat_jit (kernel 1 on the expanded force
    blocks), _solve_jit (+ eigh_batched) and _kappa_jit (kernels 1, 15,
    eigh_batched and 25) at the kappa row's 589,824 k, _gsq_qbatch_jit at
    eliashberg's default chunk (kernels 1, 2, 26 and the torch glue) and
    _lswt_solve_jit at the thermal-Hall grid (kernel 27, eigh_batched and
    the triangular solve).  CUDA events, and the profiler's device time
    (the library eigh and the Colpa failure check read flags on the host,
    so the events' span holds host time too).  A program's bound adds its
    parts' bounds."""
    from pythtb_tpu_torch import eph, magnon, phonon
    from pythtb_tpu_torch.ops import eigh, hamiltonian, phonon_kappa

    fm = honeycomb_springs(pt)
    data = phonon._bloch(fm)
    kk = torch.as_tensor(phonon._grid(fm, S12["kappa_nk"], shift=0.5)).to(device)
    B, N = kk.shape[0], data.nsta
    Ts = torch.as_tensor(KAPPA_TS).to(device)

    def kappa():
        w2, v = eigh.eigh_batched(hamiltonian.assemble(data, kk))
        return phonon_kappa.phonon_kappa(v, hamiltonian.assemble_dk(data, kk), torch.sqrt(torch.clamp(w2, min=0.0)),
                                         Ts)

    b_asm, b_eig = cost_assemble(data, B), cost_eigh(B, N)
    rows = [("phonon._dynmat_jit (kernel 1)", "kappa row B %d, N %d" % (B, N), lambda: hamiltonian.assemble(data, kk),
             [b_asm]),
            ("phonon._solve_jit (kernel 1 + eigh_batched)", "the same", lambda: eigh.eigh_batched(
                hamiltonian.assemble(data, kk)), [b_asm, b_eig]),
            ("phonon._kappa_jit (kernels 1, 15, 25 + eigh_batched)", "the same, 40 T", kappa,
             [b_asm, b_eig, cost_assemble_deriv(data, B, 1), cost_phonon_kappa(B, N, data.dim_k, len(KAPPA_TS))])]
    m, fc = eph_honeycomb(pt)
    _, _, _, _, grid = eph._qgrid_setup(m, fc, EPH_BETA, None, (S12["eli_nk"],) * 2)
    ed = m._get_finalized()
    n = S12["eli_nk"]
    kg = torch.as_tensor(np.stack(np.meshgrid(np.arange(n) / n, np.arange(n) / n, indexing="ij"), -1).reshape(-1, 2))
    kg = kg.to(device)
    Kc, Q = kg.shape[0], grid.qg.shape[0]
    rows.append(("eph._gsq_qbatch_jit (kernels 1, 2, 26)", "eliashberg chunk %d k x %d q, S %d" % (Kc, Q, ed.nsta),
                 lambda: eph._gsq_chunk(ed, kg, grid),
                 [cost_assemble(ed, Kc * (Q + 1)), cost_eig2(Kc * (Q + 1)),
                  cost_eph_vertex(Kc, Q, grid.A.shape[1], ed.nsta, grid.tab.nh, grid.A.shape[2], grid.A.shape[3])]))
    hm = honeycomb_magnet(pt)
    nh = S12["hall_nk"]
    kh = np.stack(np.meshgrid(np.arange(nh) / nh, np.arange(nh) / nh, indexing="ij"), -1).reshape(-1, 2)
    mm = 2 * hm._nsite
    Bh = kh.shape[0]
    rows.append(("magnon._lswt_solve_jit (kernel 27 + eigh_batched + solve)", "thermal Hall %d^2, 2n %d" % (nh, mm),
                 lambda: magnon._solve_device(hm, kh, 1e-8, True),
                 [cost_colpa(Bh, mm, len(hm._tables()[0])), cost_eigh(Bh, mm),
                  bound(3 * C128 * Bh * mm * mm, 4 * Bh * mm**3)]))
    for name, shape, fn, parts in rows:
        us = event_us(torch, fn)
        prof_us, prof_n = device_us(torch, fn, 5)
        t = sum(p[0] for p in parts)
        by = max(parts, key=lambda p: p[0])[1]
        print("  row: %s at %s: %.1f us (CUDA events), profiler %s us in %s device activities; bound %.5f ms (%s, "
              "the parts' bounds added)" % (name, shape, us, fmt(prof_us), fmt(prof_n), t, by))


def slice12_path(pt, where, reference):
    """The twelfth slice's calls with their pins: phonon_kappa_map_honeycomb
    (tools/bench_suite.py:648; kappa_xx(0.5) within 1e-3 of 0.074135, omega
    at M within 1e-3 of the row's four values) at 768^2 x 40 T;
    examples/phonon_bands.py (181-k path, DOS at 96^2 x 301 E, C_v at 64^2
    x 40 T, the 6 x 6 isotope cluster); examples/eph_linewidths.py
    (linewidths on the 49-k path at 18^2 q, the Fermi-liquid sweep of 5 T,
    eliashberg 14^2 x 14^2) and eliashberg at its defaults 24^2 x 24^2;
    magnon_thermal_hall_map (:576; 20 T on 41^2, kappa_xy(0.5) within
    5e-3 of -0.0916, Chern +1 at 31^2); neutron_map_kagome_4096q (:812;
    4,096 q x 300 omega, the FM trace sum rule 1.5 on the gapped of the
    first 64 draws at 1e-10).  The CPU reference runs kappa at 48^2,
    eliashberg at 14^2 only and the neutron map at its first 64 q; the card
    runs those sizes too, for the comparison."""
    import warnings

    from pythtb_tpu_torch.ops import _kernels

    out = {}

    def timed(fn, *args, **kwargs):
        t0 = time.perf_counter()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            result = fn(*args, **kwargs)
        return result, time.perf_counter() - t0

    fm = honeycomb_springs(pt)
    if not reference:
        before = _kernels.LAUNCHES["eigh_jacobi"]
        k31, sec = timed(pt.phonon.thermal_conductivity, fm, KAPPA_TS, S12["kappa_nk"])
        out["kappa_jacobi_launches"] = _kernels.LAUNCHES["eigh_jacobi"] - before
        wM = pt.phonon.bands(fm, [[0.5, 0.0]])[0]
        kap5 = float(np.interp(0.5, KAPPA_TS, k31[:, 0, 0]))
        print("  %s phonon_kappa_map_honeycomb %d^2 x 40 T: kappa_xx(0.5) %.6f (pin %.6f), omega(M) %s  [%.2f s]"
              % (where, S12["kappa_nk"], kap5, KAPPA_PIN, np.array2string(wM, precision=6), sec))
        check(abs(kap5 - KAPPA_PIN) < 1e-3 and np.abs(wM - OMEGA_M_PIN).max() < 1e-3,
              "phonon_kappa_map_honeycomb: kappa_xx(0.5) %.6f, omega(M) %s" % (kap5, wM))
    out["kappa_small"] = pt.phonon.thermal_conductivity(fm, KAPPA_TS, S12["kappa_cpu_nk"])
    # examples/phonon_bands.py
    nodes = [[0, 0], [0.5, 0.0], [1 / 3, 2 / 3], [0, 0]]
    kp = [(1 - s / 60) * np.asarray(nodes[a]) + s / 60 * np.asarray(nodes[a + 1]) for a in range(3) for s in range(60)]
    kp = np.asarray(kp + [nodes[-1]])
    (w, sec) = timed(pt.phonon.bands, fm, kp)
    d = pt.phonon.dos(fm, np.linspace(0.0, 2.1, 301), S12["dos_nk"], smearing=0.02)
    C = pt.phonon.heat_capacity(fm, np.logspace(-1.6, 0.8, 40), S12["hc_nk"])
    masses = np.tile([1.0, 1.0], 36)
    masses[20] = 0.45
    _, wc = pt.phonon.dynamical_cluster(fm, (6, 6), masses=masses)
    print("  %s examples/phonon_bands.py: band top %.4f, defect mode %.4f, C_v(6.3) %.4f (Dulong-Petit 4)  [%.2f s]"
          % (where, w.max(), wc.max(), C[-1], sec))
    check(wc.max() > w.max() + 0.05 and abs(C[-1] - 4.0) < 0.05, "phonon_bands.py: no split-off mode or C_v %.4f"
          % C[-1])
    # omega^2: the path starts and ends at Gamma, where omega = sqrt(clip(w^2))
    # of the acoustic modes is 0 or ~1e-8 from a 1e-16 w^2
    out.update(ph_bands=w**2, ph_dos=d, ph_cv=C, ph_cluster=wc)
    # examples/eph_linewidths.py
    m, fc = eph_honeycomb(pt)
    kpath, k2 = eph_paths(m)
    gam, sec = timed(pt.eph.linewidths, m, fc, EPH_BETA, kpath, mu=EPH_MU, temperature=0.08, nkq=(18, 18), sigma=0.08)
    sweep = np.array([pt.eph.linewidths(m, fc, EPH_BETA, k2, mu=EPH_MU, temperature=float(T), nkq=(18, 18),
                                        sigma=0.08)[:, 0] for T in EPH_TS])
    r = pt.eph.eliashberg(m, fc, EPH_BETA, mu=EPH_MU, nk=(S12["eli_cpu_nk"],) * 2, nkq=(S12["eli_cpu_nk"],) * 2)
    print("  %s examples/eph_linewidths.py: Gamma on the path [%.3e, %.3e]  [%.2f s]; on-shell Gamma(T) %s; "
          "lambda(14^2) %.6f" % (where, gam.min(), gam.max(), sec, np.array2string(sweep[:, 0], precision=4),
                                 r["lambda"]))
    check(bool(np.all(gam >= 0.0)) and sweep[0, 0] < sweep[-1, 0] and sweep[0, 1] > 0.0,
          "eph_linewidths.py: the on-shell state does not sharpen as T -> 0")
    out.update(eph_gamma=gam, eph_sweep=sweep, eph_a2f=r["a2f"], eph_lam=np.array([r["lambda"], r["dos_ef"]]))
    if not reference:
        r24, sec = timed(pt.eph.eliashberg, m, fc, EPH_BETA, mu=EPH_MU)
        print("  %s eph.eliashberg defaults 24^2 x 24^2: lambda %.6f, N(mu) %.6f  [%.2f s]"
              % (where, r24["lambda"], r24["dos_ef"], sec))
        check(np.isfinite(r24["a2f"]).all() and r24["lambda"] > 0.0, "eliashberg at its defaults")
    # magnon_thermal_hall_map
    hm = honeycomb_magnet(pt)
    kxy, sec = timed(pt.magnon.thermal_hall, hm, MAGNON_TS, nk=S12["hall_nk"])
    c0 = pt.magnon.chern(hm, 0, nk=S12["chern_nk"])
    kx5 = float(np.interp(0.5, MAGNON_TS, kxy))
    print("  %s magnon_thermal_hall_map %d^2 x 20 T: kappa_xy(0.5) %.5f (pin %.4f), Chern %+g  [%.2f s]"
          % (where, S12["hall_nk"], kx5, KXY_PIN, c0, sec))
    check(abs(kx5 - KXY_PIN) < 5e-3 and c0 == 1.0, "magnon_thermal_hall_map: kxy(0.5) %.5f, C %g" % (kx5, c0))
    out.update(mag_kxy=kxy, mag_chern=np.array([c0]))
    # neutron_map_kagome_4096q
    km, qs = kagome_magnet(pt)
    if not reference:
        I, sec = timed(pt.magnon.structure_factor, km, qs, omegas=NEUTRON_W, eta=0.05)
        print("  %s neutron_map_kagome_4096q %d q x 300 w: finite %s  [%.2f s]"
              % (where, S12["neutron_q"], bool(np.isfinite(I).all()), sec))
        check(I.shape == (S12["neutron_q"], len(NEUTRON_W)) and bool(np.isfinite(I).all()), "the neutron map")
    nq = S12["neutron_cpu_q"]
    w45, S45 = pt.magnon.structure_factor(km, qs[:nq])
    tr = np.real(np.einsum("qnaa->q", S45))
    gapped = w45[:, 0] > 0.1
    dev = float(np.abs(tr[gapped] - 1.5).max())
    print("  %s FM trace sum rule on %d gapped of %d draws: max |tr - 1.5| %.3e" % (where, gapped.sum(), nq, dev))
    check(dev < 1e-10 and gapped.sum() > 48, "the FM trace sum rule: %.3e" % dev)
    out["neutron_small"] = pt.magnon.structure_factor(km, qs[:nq], omegas=NEUTRON_W, eta=0.05)
    out["neutron_T"] = pt.magnon.structure_factor(km, qs[:16], omegas=np.linspace(-4.5, 4.5, 301), eta=0.05,
                                                  temperature=0.3, polarization=False)
    return out


def compare_slice12(out, ref):
    """The twelfth slice on the card against the CPU run, at 1e-10 relative
    to the largest entry: kappa at 48^2, the example's omega^2 on its path,
    C_v and cluster, the linewidths and their T sweep, eliashberg at 14^2, the
    thermal Hall sweep and Chern number, the neutron maps at 64 q (T = 0)
    and 16 q (T 0.3, both sides); the phonon DOS at 1e-7: the grid holds
    Gamma, where omega = sqrt(clip(w^2)) of the acoustic modes is 0 or
    ~1e-8 from a 1e-16 w^2 on either side, which the Gaussian's slope at
    smearing 0.02 turns into ~1e-9 of the DOS."""
    for key in ("kappa_small", "ph_bands", "ph_cv", "ph_cluster", "eph_gamma", "eph_sweep", "eph_a2f", "eph_lam",
                "mag_kxy", "mag_chern", "neutron_small", "neutron_T", "ph_dos"):
        got, want = np.asarray(out[key]), np.asarray(ref[key])
        check(got.shape == want.shape, "%s: shape %s differs from the CPU run's %s" % (key, got.shape, want.shape))
        err = float(np.abs(got - want).max() / max(1e-300, np.abs(want).max()))
        tol = 1e-7 if key == "ph_dos" else 1e-10
        print("  %s vs CPU: max|diff| %.3e (relative)" % (key, err))
        check(err <= tol, "%s differs from the CPU path by %.3e (relative)" % (key, err))


S13 = {"bse_nk": 30, "bse_big_nk": 48, "pd_delta": 37, "pd_phi": 41, "pd_nk": 21, "fit_steps": 150, "loss_nk": 301,
       "peierls_nk": 256, "peierls_p": 121}
BSE_E0_PIN, BSE_F_PIN = 1.051907, 23.570831  # bse_exciton_hbn_30x30 (tools/bench_suite.py:674-700)
ABS_W = np.linspace(0.0, 6.0, 401)
FIT_T = -1.37  # examples/autodiff_tools.py
PD_T2 = 0.15  # examples/haldane_phase_diagram.py
PD_MARGIN = 0.1  # |Delta| this far from the analytic boundary counts as away from it


def hbn_bse(pt):
    """The bse_exciton_hbn_30x30 row's model and interaction."""
    m = pt.tb_model(2, 2, [[1.0, 0.0], [0.5, np.sqrt(3.0) / 2.0]], [[1 / 3, 1 / 3], [2 / 3, 2 / 3]])
    m.set_onsite([-0.9, 0.9])
    for ij in ((0, 1, [0, 0]), (1, 0, [1, 0]), (1, 0, [0, 1])):
        m.set_hop(-1.0, *ij)
    return m, pt.exciton.radial_interaction(m, lambda x: 1.6 / (x + 0.5), 3.0)


def phase_diagram_params(torch, pt):
    """examples/haldane_phase_diagram.py's 37 x 41 (delta, phi) members:
    their amplitudes (in the hop order of the graph) and on-site matrices,
    built on the host and uploaded once."""
    from pythtb_tpu_torch import config

    deltas = np.linspace(0.0, 1.2, S13["pd_delta"])
    phis = np.linspace(-np.pi, np.pi, S13["pd_phi"])
    amps, diags = [], []
    for d in deltas:
        for p in phis:
            m = pt.models.haldane(delta=d, t2=PD_T2 * np.exp(1.0j * p))
            amps.append(np.array([h[0] for h in m._hoppings], dtype=complex))
            diags.append(np.diag(np.asarray(m._site_energies, dtype=complex)))
    dev = config.device()
    return deltas, phis, {"amps": torch.as_tensor(np.stack(amps)).to(dev),
                          "diag": torch.as_tensor(np.stack(diags)).to(dev)}


def peierls_params(torch, device, offset=0.0):
    """examples/peierls_ssh.py's sweep: 121 distortions of the SSH chain as
    member amplitudes (the on-site matrix shared), and its 256 k-points;
    ``offset`` shifts the distortions (by half a step, no member closes
    its gap at k = 1/2)."""
    deltas = np.linspace(-0.6, 0.6, S13["peierls_p"]) + offset
    amps = np.stack([1.0 + deltas, 1.0 - deltas], axis=-1).astype(complex)
    kpts = (np.arange(S13["peierls_nk"]) / S13["peierls_nk"])[:, None]
    return torch.as_tensor(amps).to(device), torch.as_tensor(kpts).to(device)


def cost_bse_pair(B, nc, nv, S, sx):
    """Kernel 28's pair mode: the states, the table and W(Q) read once, H
    (M^2) written once.  Operations, the function's least: per (x, y)
    block the products conj(ue) ue and conj(uh) uh (nc^2 S + nv^2 S
    complex products, 6 each), W contracted with the smaller of them
    (min(nc^2, nv^2) S^2 multiply-adds, 8 each) and with the other
    (nc^2 nv^2 S); the scale of an element (2) and the diagonal (1).  The
    exchange is rank S: P = conj(ue) uh and Pc (M S products), PW = P WQ
    (M S^2 multiply-adds), then 8 S a element, its scale and its sum (4)."""
    M = B * nc * nv
    nbytes = (B * (nc + nv) * S + B * S * S + S * S + M * M) * C128 + M * F64
    direct = B * B * (6 * (nc * nc + nv * nv) * S + 8 * min(nc * nc, nv * nv) * S * S + 8 * nc * nc * nv * nv * S)
    exchange = M * M * (8 * S + 4) + M * S * (12 + 8 * S) if sx else 0
    return bound(nbytes, direct + 2 * M * M + M + exchange)


def cost_bse_fock(B, nb, S):
    """Kernel 28's Fock mode: the table, rho and the states read once, the
    shifts written; the convolution's 8 operations a (x, y, a, b) and the
    contraction's S (8 S + 4) a (x, n)."""
    nbytes = (2 * B * S * S + B * nb * S) * C128 + B * nb * F64
    return bound(nbytes, 8 * B * B * S * S + B * nb * S * (8 * S + 4))


def cost_energy_vjp(data, P, NK):
    """Kernel 29: U and gbar read once, the k-points and the graph once,
    the gradients written once.  Operations, the function's least: per
    (member, k) G = sum_n gbar_n u_n u_n^H on its S (S + 1) / 2 entries on
    and above the diagonal (G is Hermitian; 8 S each), and for a hop
    entry its phase (2 dim_k + 2) and the complex multiply-add (8)."""
    S, ns2 = data.nsta, data.nspin**2
    nhe = data.nhop * ns2
    nbytes = (P * NK * (S * S * C128 + S * F64) + NK * data.dim_k * F64 + data.nhop * (data.dim_k * F64 + 2 * I64)
              + P * (nhe + S * S) * C128)
    return bound(nbytes, P * NK * (S * (S + 1) // 2 * 8 * S + nhe * (2 * data.dim_k + 10)))


def slice13_kernels(torch, pt, device, record, held):
    """Phase 3 for kernel 28 (the BSE pair matrix and the Fock shifts) and
    kernel 29 (the band-energy gradient gather), each against its plain
    version: kernel 28 captured from the bse_exciton_hbn_30x30 call (B 900,
    S 2, nc = nv = 1) and the same model at 48^2 (M 2,304), and on random
    states and tables at S 4 / nc 2 / nv 2 / B 256 (16^2) and S 8 / nc 3 /
    nv 4 / B 64 (4^3) with s_x 0, 1 and 2 (any W(Q)), at 1e-12 of the
    largest entry; kernel 29 at the Haldane 301^2 grid (B 90,000), the
    Peierls sweep (P 121 x 256 k, its distortions shifted by half a step so
    that no member closes its gap) and random models at S 4 / 16 / 40 (the
    eigensolve of the last through kernel 7), against torch autograd
    through the plain assembly and eigensolver at 1e-10 relative."""
    import dataclasses

    from pythtb_tpu_torch import core, exciton, optical
    from pythtb_tpu_torch.ops import bse, eigh, hamiltonian, solver

    rng = np.random.default_rng(13)
    m, V = hbn_bse(pt)
    for nk, main in ((S13["bse_nk"], True), (S13["bse_big_nk"], False)):
        call = lambda: pt.exciton.bse(m, V, occ=[0], nk=(nk, nk), qp="hf")  # noqa: E731
        args, _ = captured(exciton, "pair_matrix", call)
        ue, uh, wtab, wq, de, grid, sx = args
        B, nc, S = ue.shape
        nv = uh.shape[1]
        want = bse._pair_matrix_plain(*args)
        err = max_diff(torch, bse.pair_matrix(*args), want) / float(want.abs().max())
        record("bse_pair", "hBN %d^2: M %d, S %d, s_x %g" % (nk, B * nc * nv, S, sx), err,
               lambda: bse.pair_matrix(*args), lambda: bse._pair_matrix_plain(*args), cost_bse_pair(B, nc, nv, S, sx),
               main, reps=10 if main else 3)
        fargs, _ = captured(exciton, "fock_shifts", call)
        wt, occ_u, u, grid = fargs
        want = bse._fock_shifts_plain(*fargs)
        err = max_diff(torch, bse.fock_shifts(*fargs), want) / float(want.abs().max())
        record("bse_fock", "hBN %d^2: B %d, S %d, nb %d" % (nk, B, S, u.shape[1]), err,
               lambda: bse.fock_shifts(*fargs), lambda: bse._fock_shifts_plain(*fargs),
               cost_bse_fock(B, u.shape[1], S), main, reps=10 if main else 3)
        del args, fargs, want
    # the rest of the row's program: its W table on kernel 1's one-sided
    # mode, the M x M library eigh, absorption's poles on kernel 16
    nk = S13["bse_nk"]
    wdata = exciton._interaction_data(m, *exciton._prep_interaction(m, V), device)
    kg = solver.device_uniform_grid((nk, nk), (0.0, 0.0), device)
    err = max_diff(torch, hamiltonian.assemble_one_sided(wdata, kg), hamiltonian._one_sided_plain(wdata, kg))
    record("assemble_one_sided", "BSE W table %d^2, %d terms" % (nk, wdata.nhop), err,
           lambda: hamiltonian.assemble_one_sided(wdata, kg), lambda: hamiltonian._one_sided_plain(wdata, kg),
           cost_one_sided(wdata, kg.shape[0]), reps=10)
    call = lambda: pt.exciton.bse(m, V, occ=[0], nk=(nk, nk), qp="hf")  # noqa: E731
    H = bse.pair_matrix(*captured(exciton, "pair_matrix", call)[0])
    M = H.shape[0]
    ms = cuda_ms(torch, lambda: eigh.eigh_batched(H[None]), 5)
    us = event_us(torch, lambda: eigh.eigh_batched(H[None]), 5)
    print("  bse row's M x M eigh (eigh_batched: torch.linalg.eigh), M %d: %.4f ms (CUDA-event span %.1f us; the info "
          "check reads the device)  bound %.5f ms (%s)" % (M, ms, us, *cost_eigh(1, M)))
    (W, de, om, width, mode), _ = captured(exciton, "spectral_sum",
                                           lambda: pt.exciton.absorption(m, V, ABS_W, occ=[0], nk=(nk, nk)))
    want = optical._spectral_sum_plain(W, de, om, width, mode)
    err = max_diff(torch, optical.spectral_sum(W, de, om, width, mode), want) / float(want.abs().max())
    lib = cuda_ms(torch, lambda: W @ (1.0 / (om[None, :] - de[:, None] + 1j * width)))
    record("spectral_sum", "absorption poles T %d, P %d, nw %d" % (de.shape[0], W.shape[0], om.shape[0]), err,
           lambda: optical.spectral_sum(W, de, om, width, mode),
           lambda: optical._spectral_sum_plain(W, de, om, width, mode),
           cost_spectral_sum(de.shape[0], W.shape[0], om.shape[0], True), library_ms=lib, tol=1e-10, reps=10)
    del H, W
    for grid, S, nc, nv in (((16, 16), 4, 2, 2), ((4, 4, 4), 8, 3, 4)):
        B = int(np.prod(grid))
        ue, uh, occ_u = (unit_states(torch, rng, (B, n, S), device) for n in (nc, nv, 3))
        wtab = torch.as_tensor(rng.normal(size=(B, S, S)) + 1j * rng.normal(size=(B, S, S))).to(device)
        wq = torch.as_tensor(rng.normal(size=(S, S)) + 1j * rng.normal(size=(S, S))).to(device)
        de = torch.as_tensor(rng.uniform(1.0, 3.0, B * nc * nv)).to(device)
        for sx in (0.0, 1.0, 2.0):
            want = bse._pair_matrix_plain(ue, uh, wtab, wq, de, grid, sx)
            err = max_diff(torch, bse.pair_matrix(ue, uh, wtab, wq, de, grid, sx), want) / float(want.abs().max())
            record("bse_pair", "random %s S %d nc %d nv %d s_x %g" % ("x".join(map(str, grid)), S, nc, nv, sx), err,
                   lambda: bse.pair_matrix(ue, uh, wtab, wq, de, grid, sx),
                   lambda: bse._pair_matrix_plain(ue, uh, wtab, wq, de, grid, sx), cost_bse_pair(B, nc, nv, S, sx),
                   reps=3)
        want = bse._fock_shifts_plain(wtab, occ_u, ue, grid)
        err = max_diff(torch, bse.fock_shifts(wtab, occ_u, ue, grid), want) / float(want.abs().max())
        record("bse_fock", "random %s S %d nb %d, 3 occupied" % ("x".join(map(str, grid)), S, nc), err,
               lambda: bse.fock_shifts(wtab, occ_u, ue, grid), lambda: bse._fock_shifts_plain(wtab, occ_u, ue, grid),
               cost_bse_fock(B, nc, S), reps=3)

    # kernel 29: the Haldane 301^2 grid, one member
    def vjp_case(key, data, amps, diag, kpts, main, reps, tol_held=False):
        P, NK, S = amps.shape[0], kpts.shape[0], data.nsta
        H = hamiltonian.assemble_members(data, amps, diag, kpts) if P > 1 else hamiltonian.assemble(
            dataclasses.replace(data, amps=amps[0], diag=diag[0]), kpts)
        _, U = eigh.eigh_batched(H)
        gbar = torch.as_tensor(rng.normal(size=(P * NK, S))).to(device)
        got = hamiltonian.energy_vjp(data, amps, diag, kpts, U, gbar)
        want = hamiltonian._energy_vjp_plain(data, amps, diag, kpts, gbar)
        err = max(max_diff(torch, g, w) / float(w.abs().max()) for g, w in zip(got, want))
        if tol_held:
            held("energy_vjp", key, err, tol=1e-10)
            ms = cuda_ms(torch, lambda: hamiltonian.energy_vjp(data, amps, diag, kpts, U, gbar), 3)
            ev = event_us(torch, lambda: hamiltonian.energy_vjp(data, amps, diag, kpts, U, gbar), 5)
            print("  %-15s %-34s kernel %.4f ms (device %.1f us, CUDA events)  bound %.5f ms (%s)"
                  % ("energy_vjp", key, ms, ev, *cost_energy_vjp(data, P, NK)))
            return
        record("energy_vjp", key, err, lambda: hamiltonian.energy_vjp(data, amps, diag, kpts, U, gbar),
               lambda: hamiltonian._energy_vjp_plain(data, amps, diag, kpts, gbar), cost_energy_vjp(data, P, NK),
               main, tol=1e-10, reps=reps)

    hal = haldane(pt)._get_finalized()
    k_hal = solver.device_uniform_grid((GRID - 1, GRID - 1), (-0.5, -0.5), device)
    vjp_case("haldane %d^2: B %d, S 2" % (GRID, k_hal.shape[0]), hal, hal.amps[None], hal.diag[None], k_hal, True,
             10)
    ssh = pt.models.ssh(0.0)._get_finalized()
    amps, kp = peierls_params(torch, device, offset=0.005)
    vjp_case("peierls P %d x %d k, S 2" % (amps.shape[0], kp.shape[0]), ssh, amps,
             ssh.diag[None].expand(amps.shape[0], 2, 2).contiguous(), kp, False, 5)
    for S, P, NK in ((4, 4, 1024), (16, 2, 256), (40, 1, 64)):
        data = random_model_data(core, rng, device, norb=S, nhop=6 * S, dim=2)
        amps = torch.as_tensor(rng.normal(size=(P, data.nhop)) + 1j * rng.normal(size=(P, data.nhop))).to(device)
        diag = data.diag[None].expand(P, S, S).contiguous()
        kk = torch.as_tensor(rng.random((NK, 2))).to(device)
        vjp_case("random S %d: P %d x %d k, nhop %d" % (S, P, NK, data.nhop), data, amps, diag, kk, False, 3,
                 tol_held=S == 40)


def _timed_call(fn, *args, **kwargs):
    t0 = time.perf_counter()
    result = fn(*args, **kwargs)
    return result, time.perf_counter() - t0


def _group_sums(E, f, tol=1e-7):
    """Sums of ``f`` (M, ...) over each group of (near-)degenerate levels
    of the ascending E."""
    cuts = np.nonzero(np.diff(E) > tol)[0] + 1
    return np.stack([f[g].sum(0) for g in np.split(np.arange(E.size), cuts)])


def slice13_path(pt, where, reference):
    """The thirteenth slice's calls with their pins, the same on the card
    and in the CPU reference: bse_exciton_hbn_30x30 (tools/bench_suite.py
    :674-700; qp "hf": E0 within 5e-3 of 1.051907, the doublet's oscillator
    sum within 0.12 of 23.570831); absorption on the same model at 30^2
    over 401 omega; examples/haldane_phase_diagram.py (37 x 41 members at
    NK 21 through chern_fn's member axis: integers 0 or +-1, 0 beyond the
    analytic boundary |Delta| = 3 sqrt(3) |t2| |sin phi| and +-1 inside it,
    where |Delta| is 0.1 away from it); examples/autodiff_tools.py's
    graphene fit (150 descent steps through energy_fn's backward, fitted t
    within 1e-3 of -1.37); examples/peierls_ssh.py's sweep (121 members x
    256 k, forward); and one forward and backward of a mean-squared band
    loss on Haldane 301^2 (300^2 k-points)."""
    import torch

    from pythtb_tpu_torch import config

    dev = config.device()
    out = {}
    m, V = hbn_bse(pt)
    nk = (S13["bse_nk"],) * 2
    r, sec = _timed_call(pt.exciton.bse, m, V, occ=[0], nk=nk, qp="hf")
    f = r.oscillator_strengths(0)
    print("  %s bse_exciton_hbn_30x30 (M %d): E0 %.6f (pin %.6f), f0 + f1 %.6f (pin %.6f)  [%.2f s]"
          % (where, r.energies.size, r.energies[0], BSE_E0_PIN, f[0] + f[1], BSE_F_PIN, sec))
    check(abs(r.energies[0] - BSE_E0_PIN) < 5e-3 and abs(f[0] + f[1] - BSE_F_PIN) < 0.12,
          "bse_exciton_hbn_30x30: E0 %.6f, f0 + f1 %.6f" % (r.energies[0], f[0] + f[1]))
    check(r.amplitudes.shape == (900, 900) and np.isfinite(r.dipoles).all(), "bse: bad amplitudes or dipoles")
    osc = np.stack([r.oscillator_strengths(d) for d in range(2)], axis=-1)
    out.update(bse_e=r.energies, bse_de=r.pair_energies, bse_osc=_group_sums(r.energies, osc),
               bse_amp2=_group_sums(r.energies, np.abs(r.amplitudes) ** 2))
    sig, sec = _timed_call(pt.exciton.absorption, m, V, ABS_W, occ=[0], nk=nk, qp="hf")
    i0 = int(np.argmax(sig[0, 0].real))
    print("  %s absorption hBN 30^2 x %d omega: Re sigma_xx peaks %.4f at omega %.4f  [%.2f s]"
          % (where, ABS_W.size, sig[0, 0].real[i0], ABS_W[i0], sec))
    check(sig.shape == (2, 2, ABS_W.size) and np.isfinite(sig).all() and abs(ABS_W[i0] - r.energies[0]) < 0.1,
          "absorption: shape %s or its first peak at %.4f is not the exciton's" % (sig.shape, ABS_W[i0]))
    out["abs"] = sig

    # examples/haldane_phase_diagram.py through chern_fn's member axis
    deltas, phis, params = phase_diagram_params(torch, pt)
    fn, _ = pt.flows.chern_fn(pt.models.haldane(), [0], nk=(S13["pd_nk"],) * 2)
    C, sec = _timed_call(lambda: fn(params).cpu().numpy())
    C = C.reshape(deltas.size, phis.size)
    edge = 3.0 * np.sqrt(3.0) * PD_T2 * np.abs(np.sin(phis))[None, :]
    away = phase_diagram_away()
    inside, beyond = away & (deltas[:, None] < edge), away & (deltas[:, None] > edge)
    print("  %s haldane phase diagram %d x %d members at %d^2: %d inside with |C| 1, %d beyond with C 0, worst "
          "|C - round(C)| away from the boundary %.2e  [%.2f s]"
          % (where, deltas.size, phis.size, S13["pd_nk"], inside.sum(), beyond.sum(),
             np.abs(C - np.round(C))[away].max(), sec))
    check(np.abs(C - np.round(C))[away].max() < 1e-6 and np.all(np.abs(np.round(C[inside])) == 1)
          and np.all(np.round(C[beyond]) == 0) and inside.sum() > 100 and beyond.sum() > 100,
          "the Haldane phase diagram is not 0 / +-1 on either side of the boundary")
    out["pd"] = C

    # examples/autodiff_tools.py: fit t by 150 descent steps
    amps, sec = _timed_call(graphene_fit(torch, pt, dev))
    fitted = float(amps[0].real)
    print("  %s examples/autodiff_tools.py fit: t %.6f (target %.2f) after %d steps  [%.2f s]"
          % (where, fitted, FIT_T, S13["fit_steps"], sec))
    check(abs(fitted - FIT_T) < 1e-3, "the graphene fit ended at t %.6f" % fitted)
    out["fit"] = amps.numpy()

    # examples/peierls_ssh.py: the distortion sweep as one member call
    fn, p0 = pt.flows.energy_fn(pt.models.ssh(0.0))
    pamps, kp = peierls_params(torch, dev)
    e_el, sec = _timed_call(lambda: torch.clamp(fn({"amps": pamps, "diag": p0["diag"]}, kp), max=0.0).sum(dim=(1, 2))
                            .cpu().numpy() / S13["peierls_nk"])
    deltas = np.linspace(-0.6, 0.6, S13["peierls_p"])
    e_tot = e_el + 0.5 * 1.8 * deltas**2
    print("  %s examples/peierls_ssh.py sweep %d x %d k: min E at delta %+.3f  [%.2f s]"
          % (where, deltas.size, S13["peierls_nk"], deltas[np.argmin(e_tot)], sec))
    check(abs(deltas[np.argmin(e_tot)]) > 1e-3, "the Peierls sweep's minimum is not dimerized")
    out["peierls"] = e_el

    # one forward and backward of a mean-squared band loss on Haldane 301^2
    (loss, grads), sec = _timed_call(band_loss_301(torch, pt, dev))
    print("  %s band loss Haldane %d^2: loss %.9f, |grad amps| %.6e  [%.2f s]"
          % (where, S13["loss_nk"], loss, np.abs(grads[0]).max(), sec))
    check(np.isfinite(loss) and all(np.isfinite(g).all() for g in grads), "the 301^2 band loss is not finite")
    out.update(loss301=np.array([loss]), grad301_amps=grads[0], grad301_diag=grads[1])
    return out


def graphene_fit(torch, pt, dev):
    """examples/autodiff_tools.py's fit as a function: 150 descent steps
    (rate 0.5) of the mean-squared band misfit to graphene at t -1.37 on
    a 6 x 6 mesh, from t -1; returns the fitted amplitudes (host)."""
    target = pt.models.graphene(t=FIT_T)
    kfit = target.k_uniform_mesh([6, 6])
    tb = torch.as_tensor(target.solve_all(kfit).T).to(dev)
    fn, p = pt.flows.energy_fn(pt.models.graphene(t=-1.0))

    def fit():
        amps = p["amps"]
        for _ in range(S13["fit_steps"]):
            a = amps.detach().requires_grad_()
            (g,) = torch.autograd.grad(((fn({"amps": a, "diag": p["diag"]}, kfit) - tb) ** 2).mean(), a)
            amps = a.detach() - 0.5 * g
        return amps.cpu()

    return fit


def band_loss_301(torch, pt, dev):
    """One forward and backward of mean((E - E_target)^2), Haldane (delta
    0.2) against Haldane (delta 0.35), on the 301^2 Chern grid's 300^2
    k-points, as a function returning (loss, (g_amps, g_diag)) on the host."""
    from pythtb_tpu_torch.ops import solver

    kp = solver.device_uniform_grid((S13["loss_nk"] - 1,) * 2, (-0.5, -0.5), dev)
    fn, p0 = pt.flows.energy_fn(pt.models.haldane())
    ft, pt0 = pt.flows.energy_fn(pt.models.haldane(delta=0.35))
    with torch.no_grad():
        target = ft(pt0, kp)

    def step():
        p = {k: v.clone().requires_grad_() for k, v in p0.items()}
        loss = ((fn(p, kp) - target) ** 2).mean()
        loss.backward()
        return float(loss.detach()), (p["amps"].grad.cpu().numpy(), p["diag"].grad.cpu().numpy())

    return step


def slice13_rows(torch, pt, card):
    """Wall (host clock, median of 3), the span between two CUDA events
    around a call (host waits inside the call, such as the eigh's info
    check and the copies back, are in it), the profiler's device time and
    the launches of kernels 28 and 29 per call, for the five paths: bse at
    the row, absorption, the phase diagram, the graphene fit and the 301^2
    loss."""
    from pythtb_tpu_torch import config
    from pythtb_tpu_torch.ops import _kernels

    dev = config.device()
    m, V = hbn_bse(pt)
    nk = (S13["bse_nk"],) * 2
    deltas, phis, params = phase_diagram_params(torch, pt)
    cfn, _ = pt.flows.chern_fn(pt.models.haldane(), [0], nk=(S13["pd_nk"],) * 2)
    rows = (("exciton.bse hBN 30^2, qp hf", lambda: pt.exciton.bse(m, V, occ=[0], nk=nk, qp="hf")),
            ("exciton.absorption hBN 30^2, 401 omega", lambda: pt.exciton.absorption(m, V, ABS_W, occ=[0], nk=nk)),
            ("flows.chern_fn phase diagram 37 x 41 at 21^2", lambda: cfn(params).cpu()),
            ("energy_fn graphene fit, 150 steps", graphene_fit(torch, pt, dev)),
            ("energy_fn Haldane 301^2 loss, forward + backward", band_loss_301(torch, pt, dev)))
    for name, fn in rows:
        before = dict(_kernels.LAUNCHES)
        fn()
        torch.cuda.synchronize()
        n = {k: _kernels.LAUNCHES[k] - before[k] for k in ("bse_pair", "bse_fock", "energy_vjp", "assemble",
                                                            "assemble_members", "spectral_sum", "eig2")}
        wall = wall_ms(torch, fn, 3)
        span = event_us(torch, fn, 3)
        prof_us, prof_n = device_us(torch, fn, 2)
        print("  path: %s: wall %.3f ms, CUDA-event span %.1f us, profiler device %s us in %s activities; launches "
              "a call %s  (%s)" % (name, wall, span, fmt(prof_us), fmt(prof_n),
                                  {k: v for k, v in n.items() if v}, card))


def phase_diagram_away():
    """(37, 41) mask of the phase diagram's members whose |Delta| is more
    than PD_MARGIN from the analytic boundary 3 sqrt(3) |t2| |sin phi|."""
    deltas = np.linspace(0.0, 1.2, S13["pd_delta"])
    edge = 3.0 * np.sqrt(3.0) * PD_T2 * np.abs(np.sin(np.linspace(-np.pi, np.pi, S13["pd_phi"])))
    return np.abs(deltas[:, None] - edge[None, :]) > PD_MARGIN


def phase_diagram_gapless():
    """(37, 41) mask of the phase diagram's members on the analytic boundary
    itself: Delta 0 at phi 0 and +-pi, where H(K) is degenerate, the
    plaquette that holds K has a flux of +-pi to rounding and the Chern
    number is not defined."""
    deltas = np.linspace(0.0, 1.2, S13["pd_delta"])
    edge = 3.0 * np.sqrt(3.0) * PD_T2 * np.abs(np.sin(np.linspace(-np.pi, np.pi, S13["pd_phi"])))
    return np.abs(deltas[:, None] - edge[None, :]) < 1e-9


def gapless_cherns(pt, device, nk):
    """chern_fn at the phase diagram's gapless members, on ``device`` at
    NK ``nk``: what a finer grid gives where the Chern number is not
    defined."""
    deltas = np.linspace(0.0, 1.2, S13["pd_delta"])
    phis = np.linspace(-np.pi, np.pi, S13["pd_phi"])
    prev = pt.config.device()
    pt.config.set_device(device)
    try:
        vals = []
        for i, j in np.argwhere(phase_diagram_gapless()):
            fn, p0 = pt.flows.chern_fn(pt.models.haldane(delta=deltas[i], t2=PD_T2 * np.exp(1.0j * phis[j])), [0],
                                       nk=(nk, nk))
            vals.append(round(float(fn(p0)), 12))
        return vals
    finally:
        pt.config.set_device(prev)


def compare_slice13(pt, out, ref, device):
    """The thirteenth slice on the card against the CPU run: exciton energies
    and pair energies at 1e-10, oscillator strengths and |A|^2 summed over
    each degenerate group at 1e-8 of the largest, absorption, the phase
    diagram (every member but the three on the boundary itself, where the
    gap closes and the Chern number is not defined: those only integers),
    the fitted amplitudes, the Peierls sweep and the 301^2 loss and its
    gradients at 1e-10 relative to the largest entry."""
    gapless = phase_diagram_gapless()
    pd_got, pd_want = np.asarray(out["pd"]), np.asarray(ref["pd"])
    near = ~phase_diagram_away() & ~gapless
    print("  pd: %d members within %.1f of the boundary held with the rest; on the boundary itself (gap closed, "
          "not held) card %s, CPU %s" % (near.sum(), PD_MARGIN, np.round(pd_got[gapless], 12).tolist(),
                                         np.round(pd_want[gapless], 12).tolist()))
    check(np.abs(pd_got[gapless] - np.round(pd_got[gapless])).max() < 1e-6
          and np.abs(np.round(pd_got[gapless])).max() <= 1,
          "the phase diagram's gapless members are not 0 or +-1 on the card: %s" % pd_got[gapless])
    nk = 2 * S13["pd_nk"] - 1
    print("  pd: the gapless members at NK %d: card %s, CPU %s" % (nk, gapless_cherns(pt, device, nk),
                                                                 gapless_cherns(pt, "cpu", nk)))
    for key in ("bse_e", "bse_de", "bse_osc", "bse_amp2", "abs", "pd", "fit", "peierls", "loss301", "grad301_amps",
                "grad301_diag"):
        got, want = np.asarray(out[key]), np.asarray(ref[key])
        if key == "pd":
            got, want = got[~gapless], want[~gapless]
        check(got.shape == want.shape, "%s: shape %s differs from the CPU run's %s" % (key, got.shape, want.shape))
        scale = 1.0 if key in ("bse_e", "bse_de") else max(1e-300, np.abs(want).max())
        err = float(np.abs(got - want).max() / scale)
        tol = 1e-8 if key in ("bse_osc", "bse_amp2") else 1e-10
        print("  %s vs CPU: max|diff| %.3e (%s)" % (key, err, "absolute" if scale == 1.0 else "relative"))
        check(err <= tol, "%s differs from the CPU path by %.3e" % (key, err))


def _state_of(m):
    """Host state of a model, for convert.tb_model_from_state."""
    hops = m._hoppings
    return {
        "dim_k": m._dim_k, "dim_r": m._dim_r, "lat": m._lat, "orb": m._orb, "per": m._per, "nspin": m._nspin,
        "site_energies": m._site_energies, "amps": np.array([h[0] for h in hops], dtype=complex),
        "i": np.array([h[1] for h in hops], dtype=int), "j": np.array([h[2] for h in hops], dtype=int),
        "R": np.array([h[3] for h in hops]).reshape(len(hops), m._dim_r),
    }


def phase_main_path(torch, pt, where, reference=False):
    """Phase 4: the port's main path through the entry points a user calls.
    The CPU reference (``reference``) evolves the 90k flake 4 steps of the
    card's 20, to keep the run short; the steps are the same."""
    from pythtb_tpu_torch.ops import _kernels
    from tests import workloads, zoo

    out = {}
    m = haldane(pt)
    path = [[0.0, 0.0], [2.0 / 3.0, 1.0 / 3.0], [0.5, 0.5], [0.0, 0.0]]
    k_vec = m.k_path(path, 121, report=False)[0]
    evals = m.solve_all(k_vec)
    check(evals.shape == (2, 121) and np.isfinite(evals).all(), "bad Haldane bands %s" % (evals.shape,))
    out["evals"] = evals

    wf = pt.wf_array(m, [GRID, GRID])
    gaps = wf.solve_on_grid([-0.5, -0.5])
    c_wf = wf.berry_flux([0]) / (2.0 * np.pi)
    c_flow = pt.flows.chern_number(m, [0], nk=(GRID, GRID))
    print("  %s haldane 301x301: min gap %.6f  chern wf_array %.12f  chern flows %.12f"
          % (where, gaps[0], c_wf, c_flow))
    check(abs(c_wf + 1.0) < 1e-8, "wf_array.berry_flux Chern %.12f is not -1" % c_wf)
    check(abs(c_flow + 1.0) < 1e-8, "flows.chern_number %.12f is not -1" % c_flow)

    # Kane-Mele: Wilson flows and the Z2 invariant (kernel 5)
    km = zoo.kane_mele(pt, "odd")
    wk = pt.wf_array(km, [21, 21])
    wk.solve_on_grid([-0.5, -0.5])
    flow = wk.berry_phase([0, 1], dir=1, berry_evals=True)
    out["flow_raw"] = wk.berry_phase([0, 1], dir=1, contin=False, berry_evals=True)
    check(flow.shape == (21, 2) and np.isfinite(flow).all(), "bad Kane-Mele flow %s" % (flow.shape,))
    out["wilson_flow_21"] = pt.flows.wilson_flow(km, [0, 1], nk=(21, 21))[0]
    z2 = {}
    before = _kernels.LAUNCHES["eigh_jacobi"]
    for topo in ("odd", "even"):
        model = zoo.kane_mele(pt, topo)
        out["wilson_flow_41_" + topo] = pt.flows.wilson_flow(model, [0, 1], nk=(41, 41))[0]
        z2[topo] = pt.flows.z2_invariant(model, check=True)
    out["km_jacobi_launches"] = _kernels.LAUNCHES["eigh_jacobi"] - before
    print("  %s kane_mele Z2 (check=True, 31x31 and 61x61): odd %g, even %g" % (where, z2["odd"], z2["even"]))
    check(z2 == {"odd": 1.0, "even": 0.0}, "Kane-Mele Z2 %s is not odd 1, even 0" % z2)

    # the 20-layer slab: hybrid Wannier centres over a 41 x 41 grid (kernel 6)
    slab = cubic_slab(pt)
    ws = pt.wf_array(slab, [41, 41])
    before = _kernels.LAUNCHES["eigh_jacobi"]
    ws.solve_on_grid([0.0, 0.0])
    out["slab_jacobi_launches"] = _kernels.LAUNCHES["eigh_jacobi"] - before
    out["slab_hwfc"] = ws.position_hwf_all(list(range(20)), 2)
    check(out["slab_hwfc"].shape == (41, 41, 20) and np.isfinite(out["slab_hwfc"]).all(),
          "bad slab centres %s" % (out["slab_hwfc"].shape,))

    # the 800-orbital flake: levels, states, position expectations
    fl = flake(pt)
    fe, fv = fl.solve_all(eig_vectors=True)
    out["flake_evals"] = fe
    out["flake_pos"] = [fl.position_expectation(fv, d) for d in (0, 1)]
    check(fe.shape == (800,) and fv.shape == (800, 800), "bad flake solve %s" % (fv.shape,))

    # Wannier90 silicon: the golden workload, and 1,192 hops on 190 k-points
    out["w90"] = quiet(workloads.w90_silicon, pt, workloads.W90_DATA_DIR)
    si = pt.w90(workloads.W90_DATA_DIR, "silicon")
    sm = si.model(min_hopping_norm=0.01)
    out["si_nhop"] = len(sm._hoppings)
    out["si_bands"] = sm.solve_all(si.w90_bands_consistency()[0])
    out.update(matrix_free_path(pt, where, reference))
    out.update(slice4_path(pt, where, reference))
    out.update(slice5_path(pt, where, reference))
    out.update(slice6_path(pt, where, reference))
    out.update(slice7_path(pt, where, reference))
    out.update(slice8_path(pt, where, reference))
    out.update(slice9_path(pt, where, reference))
    out.update(slice10_path(pt, where, reference))
    out.update(slice11_path(pt, where, reference))
    out.update(slice12_path(pt, where, reference))
    out.update(slice13_path(pt, where, reference))
    return out


def matrix_free_path(pt, where, reference):
    """The matrix-free stack (kernels 8-10) through its public calls, with
    the checks of tools/bench_suite.py's rows.  To keep the run short, the
    CPU reference (``reference``) runs shorter calls, which the card
    repeats for the comparison: the 90k kpm_dos at 128 moments and 2
    vectors, kpm_conductivity at 2 vectors, kpm_ldos at 128 moments and 8
    of the 64 probes; and it evolves 4 of the 20 steps."""
    out = {}

    def timed(fn, *args, **kwargs):
        t0 = time.perf_counter()
        result = fn(*args, **kwargs)
        return result, time.perf_counter() - t0

    fl = peierls_flake(pt)
    N = fl._nsta
    if not reference:
        (e, dos), sec = timed(pt.flows.kpm_dos, fl, num_moments=KPM_MOMENTS, num_vectors=KPM_VECTORS)
        integral = float(dos.sum() * (e[1] - e[0]))
        print("  %s kpm_dos %d sites M=%d R=%d: integral %.2f  [%.2f s]"
              % (where, N, KPM_MOMENTS, KPM_VECTORS, integral, sec))
        check(np.isfinite(dos).all() and abs(integral - N) < 0.02 * N,
              "kpm_dos integral %.2f is not %d" % (integral, N))
    (_, out["kpm_dos_short"]), sec = timed(pt.flows.kpm_dos, fl, num_moments=128, num_vectors=2)
    print("  %s kpm_dos %d sites M=128 R=2  [%.2f s]" % (where, N, sec))

    p0 = np.zeros(N, complex)
    p0[N // 2] = 1.0
    psi, sec = timed(pt.dynamics.evolve, fl, p0, EVOLVE_TIMES[:4] if reference else EVOLVE_TIMES)
    drift = float(np.abs(np.linalg.norm(psi, axis=1) - 1.0).max())
    out["evolve"] = psi
    print("  %s evolve %d sites, %d steps of dt 0.5: norm drift %.3e  [%.2f s]"
          % (where, N, psi.shape[0], drift, sec))
    check(psi.shape == ((4 if reference else 20), N) and drift < 1e-10, "evolve norm drift %.3e" % drift)
    # the seeded branch (times[0] != dt: one backward step of its own order first)
    f5 = haldane_flake5k(pt)
    p5 = np.zeros(f5._nsta, complex)
    p5[f5._nsta // 2] = 1.0
    out["evolve_seeded"], sec = timed(pt.dynamics.evolve, f5, p5, np.linspace(0.2, 3.0, 8))
    drift = float(np.abs(np.linalg.norm(out["evolve_seeded"], axis=1) - 1.0).max())
    print("  %s evolve %d sites, seeded (times from 0.2, dt 0.4): norm drift %.3e  [%.2f s]"
          % (where, f5._nsta, drift, sec))
    check(drift < 1e-10, "seeded evolve norm drift %.3e" % drift)

    if not reference:
        (ef, sxy), sec = timed(pt.realspace.kpm_conductivity, kubo_torus(pt), dirs=(0, 1),
                               num_moments=KPM_MOMENTS, num_vectors=KPM_VECTORS)
        mid = float(sxy[np.argmin(np.abs(ef))])
        print("  %s kpm_conductivity 24x24 torus (1152 sites, W=1) M=%d R=%d: mid-gap sigma_xy %.6f  [%.2f s]"
              % (where, KPM_MOMENTS, KPM_VECTORS, mid, sec))
        check(np.isfinite(sxy).all() and abs(mid + 1.0) < 5e-2, "mid-gap sigma_xy %.6f is not -1" % mid)
    (_, out["sxy_short"]), sec = timed(pt.realspace.kpm_conductivity, kubo_torus(pt), dirs=(0, 1),
                                       num_moments=KPM_MOMENTS, num_vectors=2)
    print("  %s kpm_conductivity 24x24 torus M=%d R=2  [%.2f s]" % (where, KPM_MOMENTS, sec))

    if not reference:
        (el, ld), sec = timed(pt.realspace.kpm_ldos, f5, LDOS_SITES, num_moments=KPM_MOMENTS, n_energies=801)
        probe = np.abs(ld.sum(axis=1) * (el[1] - el[0]) - 1.0).max()
        print("  %s kpm_ldos %d sites, %d probes M=%d: worst |sum rho dE - 1| %.3e  [%.2f s]"
              % (where, f5._nsta, len(LDOS_SITES), KPM_MOMENTS, probe, sec))
        check(ld.shape == (len(LDOS_SITES), 801) and probe < 0.05, "LDOS probe integrals off by %.3e" % probe)
    (_, out["ldos_short"]), sec = timed(pt.realspace.kpm_ldos, f5, LDOS_SITES[::8], num_moments=128,
                                        n_energies=801)
    print("  %s kpm_ldos %d sites, %d probes M=128  [%.2f s]" % (where, f5._nsta, len(LDOS_SITES[::8]), sec))

    # the SSH quench across the transition (tests/test_dynamics.py), nk 400,
    # 400 times: kernels 1 and 2
    g, sec = timed(pt.dynamics.quench_echo, pt.models.ssh(delta=0.6), pt.models.ssh(delta=-0.6), [0], (400,),
                   np.linspace(0.02, 6.0, 400))
    out["quench"] = g
    print("  %s quench_echo ssh 0.6 -> -0.6, nk 400, 400 times: max g %.6f  [%.2f s]" % (where, float(g.max()), sec))
    check(np.isfinite(g).all() and g.max() > 0.1, "quench echo rate function has no cusp: max %.3e" % g.max())
    return out


def compare_main_path(out, ref, gold_km, gold_si):
    """Phase 4 checks: the card's run against the CPU run and the goldens."""
    err = float(np.abs(out["evals"] - ref["evals"]).max())
    print("  haldane bands vs CPU plain path: max|diff| %.3e" % err)
    check(err < TOL, "Haldane bands differ from the CPU path by %.3e" % err)
    w = match_phase_sets(out["flow_raw"], gold_km["pha_flow_odd"], 1e-8, "wf_array flow vs golden")
    print("  kane_mele odd Wilson flow (wf_array 21x21) vs PythTB golden: worst %.3e" % w)
    w = match_phase_sets(out["wilson_flow_21"], gold_km["pha_flow_odd"], 1e-8, "wilson_flow vs golden")
    print("  kane_mele odd flows.wilson_flow 21x21 vs PythTB golden: worst %.3e" % w)
    for topo in ("odd", "even"):
        key = "wilson_flow_41_" + topo
        w = match_phase_sets(out[key], ref[key], 1e-8, key + " vs CPU")
        print("  kane_mele %s flows.wilson_flow 41x41 vs CPU: worst %.3e" % (topo, w))
    err = float(np.abs(out["slab_hwfc"] - ref["slab_hwfc"]).max())
    print("  slab 41x41 hybrid Wannier centres vs CPU plain path: max|diff| %.3e" % err)
    check(err < 1e-10, "slab centres differ from the CPU path by %.3e" % err)
    err = float(np.abs(out["flake_evals"] - ref["flake_evals"]).max())
    print("  flake 800 levels vs CPU (LAPACK): max|diff| %.3e" % err)
    check(err < 1e-10, "flake levels differ from the CPU path by %.3e" % err)
    # position expectations are gauge-free only for isolated levels
    e = ref["flake_evals"]
    iso = np.ones(e.shape, dtype=bool)
    close = np.diff(e) < 1e-4
    iso[:-1] &= ~close
    iso[1:] &= ~close
    for d in (0, 1):
        got, want = out["flake_pos"][d], ref["flake_pos"][d]
        err = float(np.abs(got - want)[iso].max())
        tr = abs(got.sum() - want.sum())
        print("  flake position expectation dir %d vs CPU: max|diff| %.3e over %d isolated levels, "
              "trace diff %.3e" % (d, err, int(iso.sum()), tr))
        check(err < 1e-8 and tr < 1e-8, "flake position expectations differ from the CPU path")
    worst = 0.0
    for key in gold_si.files:
        got, want = np.asarray(out["w90"][key]), np.asarray(gold_si[key])
        check(got.shape == want.shape, "w90 %s shape %s vs %s" % (key, got.shape, want.shape))
        check(np.allclose(got, want, rtol=1e-8, atol=1e-10), "w90 silicon %s differs from the golden" % key)
        worst = max(worst, float(np.abs(got - want).max()))
    err = float(np.abs(out["si_bands"] - ref["si_bands"]).max())
    print("  w90 silicon vs PythTB golden (rtol 1e-8): max|diff| %.3e; %d hops, 190 k-points vs CPU %.3e"
          % (worst, out["si_nhop"], err))
    check(err < 1e-10, "w90 silicon bands differ from the CPU path by %.3e" % err)
    for key, tol, what in (("kpm_dos_short", 1e-10, "relative"), ("evolve", 1e-10, "absolute"),
                           ("evolve_seeded", 1e-10, "absolute"), ("sxy_short", 1e-8, "absolute"),
                           ("ldos_short", 1e-10, "absolute"), ("quench", 1e-10, "absolute")):
        got, want = out[key][: len(ref[key])], ref[key]
        err = float(np.abs(got - want).max())
        if what == "relative":
            err /= float(np.abs(want).max())
        print("  %s vs CPU: max|diff| %.3e (%s)" % (key, err, what))
        check(got.shape == want.shape and err < tol, "%s differs from the CPU path by %.3e" % (key, err))
    for key, tol, what in (("tbg8", 1e-10, "absolute"), ("lowest", 1e-8, "absolute"),
                           ("penrose_marker", 1e-10, "absolute"), ("spin_marker", 1e-10, "absolute"),
                           ("bott", 1e-10, "absolute"), ("arc", 1e-10, "relative")):
        got, want = np.asarray(out[key]), np.asarray(ref[key])
        err = float(np.abs(got - want).max())
        if what == "relative":
            err /= float(np.abs(want).max())
        print("  %s vs CPU: max|diff| %.3e (%s)" % (key, err, what))
        check(got.shape == want.shape and err < tol, "%s differs from the CPU path by %.3e" % (key, err))


def bisect_mu_plain(torch, pt, w, kt, n_target, norm):
    """The JAX package's mu bisection as written there: 80 sequential
    halvings, all on the device with no host read.  The yardstick for the
    port's rounds of dyadic points (``meanfield._bisect_mu``)."""
    w = w.reshape(-1)
    lo = torch.min(w) - 30.0 * kt
    hi = torch.max(w) + 30.0 * kt
    for _ in range(80):
        mid = 0.5 * (lo + hi)
        few = torch.sum(pt.meanfield._fermi((w - mid) / kt)) / norm < n_target
        lo, hi = torch.where(few, mid, lo), torch.where(few, hi, mid)
    return 0.5 * (lo + hi)


def with_plain_bisection(torch, pt, fn):
    """``fn`` run with :func:`bisect_mu_plain` in place of the port's."""
    def run():
        saved = pt.meanfield._bisect_mu
        pt.meanfield._bisect_mu = lambda *a: bisect_mu_plain(torch, pt, *a)
        try:
            return fn()
        finally:
            pt.meanfield._bisect_mu = saved
    return run


def phase_walls(torch, pt, card):
    """Steady wall time of the main calls and their device time per call
    (profiler): the device's busy share."""
    from pythtb_tpu_torch.ops import _kernels, matvec
    from tests import zoo

    m = haldane(pt)
    kmo = zoo.kane_mele(pt, "odd")
    fl = flake(pt)
    slab = cubic_slab(pt)
    ws = pt.wf_array(slab, [41, 41])
    ws.solve_on_grid([0.0, 0.0])
    fl90, f5, torus = peierls_flake(pt), haldane_flake5k(pt), kubo_torus(pt)
    p0 = np.zeros(fl90._nsta, complex)
    p0[fl90._nsta // 2] = 1.0
    # (call, timed calls, profiled calls): the profiler drops the last
    # events of a window, so the short Fermi-arc call is profiled 20 times
    # (2 calls recorded none)
    calls = {
        "flows.chern_number haldane 301x301": (
            lambda: pt.flows.chern_number(m, [0], nk=(GRID, GRID)), 10, 10),
        "flows.wilson_flow kane_mele 41x41": (
            lambda: pt.flows.wilson_flow(kmo, [0, 1], nk=(41, 41)), 10, 10),
        "flows.z2_invariant kane_mele check=True (31x31 + 61x61)": (
            lambda: pt.flows.z2_invariant(kmo, check=True), 5, 5),
        "flake 800 solve_all(eig_vectors=True)": (lambda: fl.solve_all(eig_vectors=True), 3, 3),
        "slab 41x41 wf_array.solve_on_grid (nsta 39, kernel 7)": (lambda: ws.solve_on_grid([0.0, 0.0]), 5, 3),
        "slab 41x41 position_hwf_all (20 states)": (
            lambda: ws.position_hwf_all(list(range(20)), 2), 5, 5),
        "flows.kpm_dos 90k M=512 R=8": (
            lambda: pt.flows.kpm_dos(fl90, num_moments=KPM_MOMENTS, num_vectors=KPM_VECTORS), 3, 2),
        "dynamics.evolve 90k 20 steps": (lambda: pt.dynamics.evolve(fl90, p0, EVOLVE_TIMES), 3, 2),
        "realspace.kpm_conductivity 1152 M=512 R=8": (
            lambda: pt.realspace.kpm_conductivity(torus, num_moments=KPM_MOMENTS, num_vectors=KPM_VECTORS), 3, 2),
        "realspace.kpm_ldos 5k 64 probes M=512": (
            lambda: pt.realspace.kpm_ldos(f5, LDOS_SITES, num_moments=KPM_MOMENTS, n_energies=801), 3, 2),
        "ops.matvec.sparse_h_k tbg m=30 at K (the host ELL build of solve_window)": (
            lambda: matvec.sparse_h_k(tbg(pt, 30), TBG_KPTS[1]), 3, 0),
        "flows.solve_window tbg m=30 at K (4 states, block 12)": (
            lambda: pt.flows.solve_window(tbg(pt, 30), 4, dirac_energy(pt), k_point=np.asarray(TBG_KPTS[1]),
                                          block=12, seed=0), 2, 1),
        "flows.solve_lowest 3600 sites k=10": (
            lambda: pt.flows.solve_lowest(lowest_flake(pt), 10, max_iters=300, tol=1e-7), 3, 2),
        "realspace.chern_marker penrose 608 nocc 50": (
            lambda: pt.realspace.chern_marker(penrose608(pt)[0], nocc=50), 3, 2),
        "realspace.spin_chern_marker kane_mele 784 states": (
            lambda: pt.realspace.spin_chern_marker(km784(pt), nocc=392), 3, 2),
        "realspace.bott_index 512 sites": (lambda: pt.realspace.bott_index(bott_torus(pt), nocc=256), 3, 2),
        "surface.spectral_function weyl arc 10201 px": (
            lambda: pt.surface.spectral_function(pt.models.weyl(), 0, k_par=ARC_K, energies=np.array([0.0]),
                                                 eta=0.02), 3, 20),
    }
    hal, nh, no = pt.models.haldane(), S5["hall"], S5["optical"]
    orb, bn, rm, ra = orbmag_haldane(pt), pt.models.bn(), rice_mele(pt), rashba(pt)
    calls.update({
        "flows.anomalous_hall 101x101 81 E_F": (lambda: pt.flows.anomalous_hall(hal, AHC_EFS, nk=(nh, nh)), 5, 3),
        "flows.thermal_hall 101x101 81 mu": (
            lambda: pt.flows.thermal_hall(hal, THERMAL_MUS, 0.15, nk=(nh, nh)), 5, 3),
        "flows.orbital_magnetization 121x121": (
            lambda: pt.flows.orbital_magnetization(orb, [0], nk=(S5["orbmag"],) * 2), 5, 3),
        "optical.optical_conductivity 161x161 121 w": (
            lambda: pt.optical.optical_conductivity(hal, OPTICAL_W, occ=[0], nk=(no, no), eta=0.04), 3, 2),
        "optical.shift_current bn 161x161 121 w": (
            lambda: pt.optical.shift_current(bn, SHIFT_W, [0], nk=(no, no), sigma=0.08), 3, 2),
        "optical.shift_current rice_mele 2001 k": (
            lambda: pt.optical.shift_current(rm, SHIFT_W, [0], nk=(S5["rice_mele"],), sigma=0.06), 5, 3),
        "geometry.integrated_metric 72x72": (
            lambda: pt.geometry.integrated_metric(hal, [0], nk=(S5["qgt"],) * 2), 5, 3),
        "boltzmann.transport_coefficients 512^2 201 mu": (
            lambda: quiet_warnings(pt.boltzmann.transport_coefficients, hal, BT_MUS, 0.05, S5["boltzmann"]), 3, 2),
        "boltzmann.edelstein 256^2 201 mu": (
            lambda: pt.boltzmann.edelstein(ra, EDEL_MUS, 0.05, S5["edelstein"]), 3, 2),
    })
    Hd, leads, _ = pt.negf.hall_bar(qwz(pt), (8, 8))
    st, kg, rib = lyap_strip(pt), pt.models.kagome(t=-1.0), graphene_ribbon(pt)
    kmr, kdev = km_ribbon(pt)
    bn1 = pt.models.bn(delta=1.0)
    calls.update({
        "negf.multi_terminal qwz hall bar 8x8 41 E": (
            lambda: quiet_warnings(pt.negf.multi_terminal, Hd, leads, HALL_E, eta=1e-6), 3, 2),
        "localization.lyapunov_spectrum strip 8 512 E x 200,000 steps": (
            lambda: pt.localization.lyapunov_spectrum(st, LYAP_E, LYAP_STEPS, disorder=1.5, seed=2), 2, 1),
        "disorder.cpa kagome 256 w x 48^2": (
            lambda: pt.disorder.cpa(kg, CPA_W, S6["cpa_nk"], CPA_DISORDER, eta=0.05), 2, 1),
        "negf.landauer_transmission graphene ribbon 5 301 E": (
            lambda: pt.negf.landauer_transmission(rib, RIBBON_E, eta=1e-6), 3, 2),
        "negf.landauer_transmission kane_mele ribbon 6 disordered 121 E": (
            lambda: pt.negf.landauer_transmission(kmr, KM_RIBBON_E, device=kdev, eta=1e-6), 3, 2),
        "impurity.t_matrix bn 96^2 481 E": (
            lambda: pt.impurity.t_matrix(bn1, np.array([[4.0]]), IMPURITY_E, [0], nk=(S6["impurity_nk"],) * 2,
                                         eta=0.04), 3, 2),
    })
    sq, bbh, kme, bil, wy = (pt.models.square(), pt.models.bbh(gamma=0.5), pt.models.kane_mele(esite=1.0),
                             haldane_bilayer(pt), pt.models.weyl())
    hof, _ = pt.magnetic.hofstadter_fn(sq, HOF_Q)
    fam = pt.family(haldane_family(pt))

    def node_search():
        kn, _ = pt.flows.find_nodes(wy, band=0, nk=S7["nodes"], gap_tol=0.05)
        return [pt.flows.node_chirality(wy, k, band=0) for k in kn]

    calls.update({
        "magnetic.hofstadter_fn square q40, 41 fluxes x 16 k": (
            lambda: hof(np.arange(HOF_Q + 1.0), HOF_K).cpu().numpy(), 10, 5),
        "flows.quadrupole bbh 21x21": (lambda: pt.flows.quadrupole(bbh, nk=(S7["quadrupole"],) * 2), 5, 3),
        "flows.spin_chern kane_mele 41x41": (
            lambda: pt.flows.spin_chern(kme, (0, 1), nk=(S7["spin_chern"],) * 2), 5, 3),
        "flows.sector_chern haldane bilayer 41x41": (
            lambda: pt.flows.sector_chern(bil, (0, 1), np.array([1.0, 1.0, -1.0, -1.0]), nk=(S7["sector"],) * 2),
            5, 3),
        "flows.find_nodes + node_chirality weyl 40^3": (node_search, 3, 1),
        "family.chern haldane supercells (40 states) 16x16": (
            lambda: fam.chern(nocc=[1, 4, 20], nk=(S7["family"],) * 2), 5, 3),
    })
    import warnings

    si = silicon_model(pt)
    sc5, M5 = pt.models.graphene().make_supercell(np.diag([5, 5])), np.diag([5, 5])
    kl = np.linspace(0.0, 0.5, S8["unfold_k"])[:, None] * np.array([[1.0, 2.0]])

    def silicon_mlwf():
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return pt.wannier.interpolator(si, [0, 1, 2, 3], nk=S8["si_nk"], trial=np.eye(8)[:4],
                                           localize=S8["si_steps"], coarse_nk=S8["si_coarse"], polish=0)

    def pump():
        wf, _ = pump_grid(pt)
        wf.adiabatic_evolve([0], dir=0)
        wf.smooth_gauge([0], dir=1, closed=True)
        return wf

    def indicators():
        return ([pt.symmetry.chern_indicator(pt.models.haldane(delta=d, t2=0.15 * np.exp(1j * np.pi * p)), occ=[0])
                 for d, p in SYM_HALDANE]
                + [pt.symmetry.chern_indicator(pt.models.qwz(u), occ=[0], l=[0, 1]) for u in SYM_QWZ])

    calls.update({
        "wannier.interpolator silicon 8^3 x 400 MV steps -> 16^3": (silicon_mlwf, 3, 1),
        "unfold.unfold_bands graphene 5x5 50 bands 121 k": (lambda: pt.unfold.unfold_bands(sc5, M5, kl), 5, 3),
        "entanglement.entanglement_flow haldane L20 61 k": (
            lambda: pt.entanglement.entanglement_flow(hal, [0], 0, L=S8["ent_L"], nk=S8["ent_nk"]), 5, 3),
        "pump_tools 41x31: solve_on_grid_models + adiabatic_evolve + smooth_gauge": (pump, 5, 3),
        "symmetry.chern_indicator 5 haldane + 3 qwz": (indicators, 3, 1),
    })
    mb9 = arpes_model(pt)
    r42 = quiet_warnings(pt.dmft.solve, mb9, U=2.0, orb=0, beta=15.0, nk=16, n_matsubara=96, n_bath=3, max_iter=30)
    kp9 = mb9.k_path(ARPES_PATH, S9["arpes_k"], report=False)[0]
    om9 = np.linspace(-8.0, 8.0, S9["arpes_w"])
    ring8, ring6, sq9 = ring(pt, S9["ed_L"]), ring(pt, S9["hf_L"]), pt.models.square(t=-1.0)
    calls.update({
        "ed.hubbard 8-ring U 4, 4,900-dim sector, lowest 4": (
            lambda: pt.ed.hubbard(ring8, 4.0, 4, 4, lowest=4), 3, 1),
        "ed.many_body_chern haldane 2x2, 70-dim sector, 6x6 twists": (
            lambda: pt.ed.many_body_chern(hal, (2, 2), nelec=4, interactions=HALDANE_NN_V, grid=6), 3, 2),
        "ed.spectral_function 6-ring U 4, 601 w (examples/hubbard_ed.py)": (
            lambda: pt.ed.spectral_function(ring6, 6, HUBBARD_ED_W, U=4.0, eta=0.15, modes=[0, 1]), 3, 2),
        "dmft.bethe U 3, 128 w, 4 bath sites": (
            lambda: quiet_warnings(pt.dmft.bethe, 3.0, D=2.0, beta=20.0, n_matsubara=128, n_bath=4, max_iter=40),
            2, 1),
        "dmft.solve 8 orbitals nk 16, 96 w, 3 bath sites": (
            lambda: quiet_warnings(pt.dmft.solve, mb9, U=2.0, orb=0, beta=15.0, nk=16, n_matsubara=96, n_bath=3,
                                   max_iter=30), 2, 1),
        "dmft.band_spectral 1001 k x 2001 w x 8 resolved (host array)": (
            lambda: pt.dmft.band_spectral(r42, kp9, om9, eta=0.15, resolved=True), 3, 2),
        "dmft.band_spectral 1001 k x 2001 w x 8 resolved, device=True": (
            lambda: pt.dmft.band_spectral(r42, kp9, om9, eta=0.15, resolved=True, device=True), 5, 3),
        "meanfield.hartree_fock 6-ring U 4 (examples/hubbard_ed.py)": (
            lambda: pt.meanfield.hartree_fock(ring6, 4.0, 6.0, temperature=2e-3, stagger=0.4, seed=1,
                                              max_iters=4000), 3, 1),
        "meanfield.bcs_gap square 36x36 g 2 (examples/mean_field.py)": (
            lambda: pt.meanfield.bcs_gap(sq9, 2.0, -0.4, nk=(36, 36), temperature=0.01, max_iters=4000), 3, 1),
    })
    cub10, g10, sq10 = cubic_model(pt), pt.models.graphene(), pt.models.square(t=-1.0)
    slab10 = pt.wf_array(slab, [41, 41])
    slab10.solve_on_grid([0.0, 0.0])
    occ10 = list(range(S10["slab_occ"]))
    sc10 = bn_supercell(pt)

    def bn_mlwf():
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return pt.wannier.interpolator(sc10, list(range(9)), nk=S10["mlwf_nk"], trial=np.eye(18)[0::2],
                                           localize=S10["mlwf_steps"], coarse_nk=S10["mlwf_coarse"], polish=0)

    calls.update({
        "fermisurface.dos_linear cubic 48^3 x 1601 E (kernel 21)": (
            lambda: pt.fermisurface.dos_linear(cub10, TETRA_E, nk=S10["tetra_nk"]), 5, 3),
        "response.lindhard graphene 64 q x 576 k x 16 w": (
            lambda: pt.response.lindhard(g10, LIND_Q, LIND_W, nk=S10["lind_nk"], mu=0.0, temperature=2e-3, eta=0.05),
            5, 3),
        "fermisurface.dos_linear graphene 256^2 x 1200 E": (
            lambda: pt.fermisurface.dos_linear(pt.models.graphene(t=-1.0), GDOS_E, nk=S10["gdos_nk"]), 5, 3),
        "fermisurface.fermi_surface square 301^2 at E_F -1.5": (
            lambda: pt.fermisurface.fermi_surface(sq10, -1.5, nk=S10["fs_nk"]), 2, 0),
        "fermisurface.cyclotron_mass square 301^2": (
            lambda: pt.fermisurface.cyclotron_mass(sq10, -3.8, 0, nk=S10["fs_nk"]), 2, 0),
        "response.stoner_analysis graphene nk 25, 37 q": (
            lambda: pt.response.stoner_analysis(g10, STONER_Q, nk=S10["stoner_nk"], mu=0.0, temperature=2e-3), 5, 3),
        "boltzmann.magnetotransport square 301^2, 4 B": (
            lambda: quiet_warnings(pt.boltzmann.magnetotransport, sq10, -3.6, MT_BS, tau=7.0, nk=S10["mt_nk"]), 3, 1),
        "fermisurface.extremal_orbits cubic 48 x 151^2": (
            lambda: pt.fermisurface.extremal_orbits(cub10, -5.7, 0, n_slices=S10["ext_slices"], nk=S10["ext_nk"]),
            1, 0),
        "geometry.kp_model graphene K": (lambda: pt.geometry.kp_model(g10, [1 / 3, 2 / 3], [0, 1]), 10, 5),
        "wf_array.berry_phase slab 41x41, 20 states, Wilson loops (kernel 5 S 20)": (
            lambda: slab10.berry_phase(occ10, dir=0, contin=False, berry_evals=True), 5, 3),
        "wf_array.berry_phase slab 41x41, 20 states, traced (kernel 3 S 20)": (
            lambda: slab10.berry_phase(occ10, dir=0, contin=False), 5, 3),
        "wf_array.smooth_gauge slab 41x41, 20 states (kernel 14 S 20)": (
            lambda: slab10.smooth_gauge(occ10, dir=0, closed=True), 5, 3),
        "wf_array.adiabatic_evolve slab 41x41, 20 of 39 states along k1 (kernel 14 follow)": (
            lambda: slab10.adiabatic_evolve(occ10, dir=1), 5, 3),
        "wannier.interpolator BN 3x3 nw 9, 6^2 x 100 MV steps -> 12^2": (bn_mlwf, 3, 1),
    })
    # the eleventh slice's calls
    bn11, lieb11, g11, rd11 = pt.models.bn(delta=1.0), pt.models.lieb(), pt.models.graphene(), rudner(pt)
    rdrv11 = rudner_drive(pt, rd11)
    kv11 = g11.k_path([[0.0, 0.0], [1.0 / 3.0, 2.0 / 3.0], [0.5, 0.5], [0.0, 0.0]], 121, report=False)[0]

    def hhg(key):
        w0, E0, kw = HHG_CALLS[key]
        return lambda: pt.optical.harmonic_spectrum(bn11, w0, E0, **kw)

    calls.update({
        "optical.harmonic_spectrum bn strong field 48^2 x 2,560 steps (kernel 22)": (hhg("strong"), 3, 1),
        "optical.harmonic_spectrum bn weak field 36^2 x 2,304 steps": (hhg("weak"), 3, 0),
        "optical.harmonic_spectrum bn SHG sweep 10 w x 36^2 x 1,728 steps": (hhg("shg"), 2, 0),
        "geometry.superfluid_weight lieb 48x48 analytic (kernel 23)": (
            lambda: pt.geometry.superfluid_weight(lieb11, 0.0, 0.3, nk=(48, 48)), 10, 3),
        "geometry.superfluid_weight lieb 48x48 fd": (
            lambda: quiet_warnings(pt.geometry.superfluid_weight, lieb11, 0.0, 0.3, nk=(48, 48), method="fd"), 5, 3),
        "floquet.chern graphene 31x31 nt 128": (
            lambda: pt.floquet.chern(g11, FLQ_W, circ(0.8), band=0, nk=(31, 31), nt=128), 10, 3),
        "floquet.quasienergies graphene 121 k nharm 5 (kernel 1 Floquet mode)": (
            lambda: pt.floquet.quasienergies(g11, FLQ_W, circ(1.2), kv11, nharm=5), 10, 3),
        "floquet.winding_number rudner 17x17 nt 200, 2 gaps (kernels 22, 24)": (
            lambda: pt.floquet.winding_number(rd11, RUDNER_W, rdrv11, egap=[0.0, 0.5], nk=(17, 17), nt=200), 5, 3),
    })
    # the twelfth slice's calls
    fm12, hm12 = honeycomb_springs(pt), honeycomb_magnet(pt)
    m12, fc12 = eph_honeycomb(pt)
    kpath12, _ = eph_paths(m12)
    km12, qs12 = kagome_magnet(pt)
    calls.update({
        "phonon.thermal_conductivity honeycomb 768^2 x 40 T (kernels 1, 15, 25)": (
            lambda: pt.phonon.thermal_conductivity(fm12, KAPPA_TS, S12["kappa_nk"]), 3, 1),
        "phonon.dos honeycomb 96^2 x 301 E (examples/phonon_bands.py)": (
            lambda: pt.phonon.dos(fm12, np.linspace(0.0, 2.1, 301), S12["dos_nk"], smearing=0.02), 5, 3),
        "eph.linewidths 49 k x 18^2 q (examples/eph_linewidths.py, kernel 26)": (
            lambda: pt.eph.linewidths(m12, fc12, EPH_BETA, kpath12, mu=EPH_MU, temperature=0.08, nkq=(18, 18),
                                      sigma=0.08), 5, 3),
        "eph.eliashberg defaults 24^2 x 24^2 (one chunk)": (
            lambda: pt.eph.eliashberg(m12, fc12, EPH_BETA, mu=EPH_MU), 3, 1),
        "magnon.thermal_hall honeycomb 41^2 x 20 T (kernel 27)": (
            lambda: pt.magnon.thermal_hall(hm12, MAGNON_TS, nk=S12["hall_nk"]), 5, 3),
        "magnon.structure_factor kagome 4,096 q x 300 w (kernels 27, 16)": (
            lambda: pt.magnon.structure_factor(km12, qs12, omegas=NEUTRON_W, eta=0.05), 3, 1),
    })
    hf = calls["meanfield.hartree_fock 6-ring U 4 (examples/hubbard_ed.py)"][0]
    calls["meanfield.hartree_fock 6-ring U 4, the reference's 80-step mu bisection"] = (
        with_plain_bisection(torch, pt, hf), 3, 0)
    a, b = hf(), with_plain_bisection(torch, pt, hf)()
    print("  hartree_fock 6-ring U 4: %d iterations with the port's mu bisection, %d with the reference's; "
          "max |density diff| %.3e, |mu diff| %.3e" % (
              a["iters"], b["iters"], max(np.abs(a["n_up"] - b["n_up"]).max(), np.abs(a["n_dn"] - b["n_dn"]).max()),
              abs(a["mu"] - b["mu"])))
    # the walls behind kernels 14, 17, 11b and kernel 7 below 33 states
    # also get the span between two CUDA events around a call (host waits
    # inside the call in it) and the launches of their kernels a call
    spans = {"wf_array.smooth_gauge slab 41x41, 20 states (kernel 14 S 20)": ("transport_chain", "transport_rotate"),
             "wf_array.adiabatic_evolve slab 41x41, 20 of 39 states along k1 (kernel 14 follow)": ("transport_follow",),
             "boltzmann.transport_coefficients 512^2 201 mu": ("fermi_sweep", "assemble_dk"),
             "boltzmann.edelstein 256^2 201 mu": ("fermi_sweep",),
             "ed.hubbard 8-ring U 4, 4,900-dim sector, lowest 4": ("dense_filter", "eigh_jacobi"),
             "phonon.thermal_conductivity honeycomb 768^2 x 40 T (kernels 1, 15, 25)": (
                 "eigh_jacobi", "phonon_kappa", "assemble", "assemble_dk"),
             "flows.wilson_flow kane_mele 41x41": ("eigh_jacobi", "wilson_loop", "assemble"),
             "flows.z2_invariant kane_mele check=True (31x31 + 61x61)": ("eigh_jacobi", "wilson_loop", "assemble")}
    check(set(spans) <= set(calls), "phase_walls: a span row names no call")
    walls = {}
    for name, (fn, reps, prof_reps) in calls.items():
        ms = wall_ms(torch, fn, reps)
        dev_us, n = device_us(torch, fn, prof_reps) if prof_reps else (None, None)
        busy = None if dev_us is None else 100.0 * dev_us / (1e3 * ms)
        walls[name] = {"wall_ms": ms, "device_us": dev_us, "device_activities": n, "busy_pct": busy}
        extra = ""
        if name in spans:
            before = dict(_kernels.LAUNCHES)
            fn()
            torch.cuda.synchronize()
            ran = {k: _kernels.LAUNCHES[k] - before[k] for k in spans[name]}
            span = event_us(torch, fn, reps)
            walls[name].update(span_us=span, launches=ran)
            extra = ", CUDA-event span %.1f us, launches a call %s" % (span, ran)
        print("  steady wall %s: median %.3f ms, device %s us in %s activities per call, busy %s %%%s (%s)"
              % (name, ms, fmt(dev_us), fmt(n), fmt(busy), extra, card))
    # where the device time of the heaviest response rows goes
    for name in ("boltzmann.transport_coefficients 512^2 201 mu", "optical.shift_current bn 161x161 121 w",
                 "optical.optical_conductivity 161x161 121 w", "boltzmann.edelstein 256^2 201 mu",
                 "negf.multi_terminal qwz hall bar 8x8 41 E", "disorder.cpa kagome 256 w x 48^2",
                 "negf.landauer_transmission kane_mele ribbon 6 disordered 121 E",
                 "slab 41x41 wf_array.solve_on_grid (nsta 39, kernel 7)",
                 "magnetic.hofstadter_fn square q40, 41 fluxes x 16 k",
                 "flows.find_nodes + node_chirality weyl 40^3",
                 "wannier.interpolator silicon 8^3 x 400 MV steps -> 16^3",
                 "pump_tools 41x31: solve_on_grid_models + adiabatic_evolve + smooth_gauge",
                 "ed.hubbard 8-ring U 4, 4,900-dim sector, lowest 4",
                 "dmft.band_spectral 1001 k x 2001 w x 8 resolved, device=True",
                 "meanfield.bcs_gap square 36x36 g 2 (examples/mean_field.py)",
                 "fermisurface.dos_linear cubic 48^3 x 1601 E (kernel 21)",
                 "response.lindhard graphene 64 q x 576 k x 16 w",
                 "wf_array.berry_phase slab 41x41, 20 states, Wilson loops (kernel 5 S 20)",
                 "optical.harmonic_spectrum bn strong field 48^2 x 2,560 steps (kernel 22)",
                 "geometry.superfluid_weight lieb 48x48 analytic (kernel 23)",
                 "phonon.thermal_conductivity honeycomb 768^2 x 40 T (kernels 1, 15, 25)",
                 "eph.eliashberg defaults 24^2 x 24^2 (one chunk)",
                 "magnon.structure_factor kagome 4,096 q x 300 w (kernels 27, 16)"):
        top, total = device_top(torch, calls[name][0])
        print("  device time of %s: %s us per call; largest: %s" % (name, fmt(total), "; ".join(
            "%s %.1f us" % (k[:70], us) for k, us in top)))
    return walls


def main():
    import torch

    # -- phase 1: environment ------------------------------------------
    if not torch.cuda.is_available():
        raise SmokeError("torch.cuda.is_available() is false: this smoke run needs an NVIDIA GPU")
    import pythtb_tpu_torch as pt
    from pythtb_tpu_torch import config
    from pythtb_tpu_torch.ops import _kernels

    device = config.device()  # the card, by default
    check(device.type == "cuda", "the port's default device is %s, not the card" % device)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    card = smi.stdout.strip().splitlines()[device.index] if smi.returncode == 0 else "nvidia-smi failed"
    print("[1 env] card (nvidia-smi name, power.limit):")
    print(card)
    print("[1 env] torch %s, CUDA %s, %s, python %s"
          % (torch.__version__, torch.version.cuda, torch.cuda.get_device_name(device),
             sys.version.split()[0]))

    # -- phase 2: build -------------------------------------------------
    t0 = time.perf_counter()
    ab = start_no_prefetch_build()
    try:
        _kernels.library()
    finally:
        NO_PREFETCH["lib"] = finish_no_prefetch_build(*ab)
    print("[2 build] kernels ready in %.2f s (nvcc %s s) -> %s"
          % (time.perf_counter() - t0, _kernels.build_info["seconds"], _kernels.build_info["path"]))
    print("[2 build] kernel 22 without its S <= 2 prefetch (the A/B of phase 3) built in %.2f s in all"
          % (time.perf_counter() - t0))
    print("[2 build] nvcc seconds per source (all started together): %s"
          % ", ".join("%s %.1f" % kv for kv in sorted(_kernels.build_info["compile_seconds"].items())))
    for line in _kernels.build_info["ptxas"].splitlines():
        if "Used" in line or "spill" in line or "Compiling entry" in line:
            print("[2 build] " + line.strip())

    # -- phase 3: kernels vs plain versions ------------------------------
    print("[3 kernels] each kernel vs its plain PyTorch version (tolerance %.0e):" % TOL)
    t0 = time.perf_counter()
    res = phase_kernels(torch, pt, device)
    print("[3 kernels] done in %.1f s; launches that went through once torch's cache was released: %d "
          "(the allocator's cache holds %.1f GB)" % (time.perf_counter() - t0, _kernels.cache_releases,
                                                     torch.cuda.memory_reserved(device) / 1e9))

    # CPU references for phase 4, made before the counted window
    t0 = time.perf_counter()
    config.set_device("cpu")
    ref = phase_main_path(torch, pt, "[cpu reference]", reference=True)
    config.set_device(device)
    gold_km = np.load(ROOT / "tests" / "golden" / "data" / "kane_mele_flow.npz")
    gold_si = np.load(ROOT / "tests" / "golden" / "data" / "w90_silicon.npz")
    print("[4 main] CPU reference in %.1f s" % (time.perf_counter() - t0))

    # -- phase 4: main path ----------------------------------------------
    print("[4 main] Haldane bands and Chern, Kane-Mele flows and Z2, slab HWF, flake, w90 silicon, "
          "KPM DOS/LDOS/Kubo, Chebyshev evolution, quench echo, interior and lowest states, markers, surfaces, "
          "Hall sweeps, orbital magnetization, optics, shift current, QGT, Boltzmann, Edelstein, Hall bar, Lyapunov "
          "spectra, CPA, ribbons, impurity T-matrix, ED sectors and twists, DMFT, mean fields, BdG, harmonics, "
          "superfluid weight, Floquet, phonons, e-ph coupling, magnons, excitons, differentiable flows:")
    t0 = time.perf_counter()
    _kernels.reset_launches()
    out = phase_main_path(torch, pt, "[gpu]")
    torch.cuda.synchronize()
    launches = dict(_kernels.LAUNCHES)
    print("[4 main] card run in %.1f s" % (time.perf_counter() - t0))
    compare_main_path(out, ref, gold_km, gold_si)
    compare_slice5(out, ref)
    compare_slice6(out, ref)
    compare_slice7(out, ref)
    compare_slice8(out, ref)
    compare_slice9(torch, pt, out, ref, device)
    compare_slice10(out, ref)
    compare_slice11(out, ref)
    compare_slice12(out, ref)
    compare_slice13(pt, out, ref, device)
    check_lowest_bound(torch, pt, out["lowest"], device)
    print("[4 main] kernel 7 launches in the slab's solve_on_grid: %d; in hofstadter_fn: %s"
          % (out["slab_jacobi_launches"], out["hof_launches"]))
    check(out["slab_jacobi_launches"] > 0, "the slab's 39-state solve did not go through kernel 7")
    print("[4 main] kernel 7 launches in the kappa row's 589,824 4 x 4 solves: %d; in the Kane-Mele 41x41 flows and "
          "Z2 (4 x 4): %d" % (out["kappa_jacobi_launches"], out["km_jacobi_launches"]))
    check(out["kappa_jacobi_launches"] > 0, "the kappa row's 4 x 4 solves did not go through kernel 7")
    check(out["km_jacobi_launches"] > 0, "the Kane-Mele flows' 4 x 4 solves did not go through kernel 7")
    check(min(out["hof_launches"].values()) > 0, "the Hofstadter call did not launch kernel 7 and the flux-batch mode")
    print("[4 main] kernel 19 in the silicon MLWF build: %s (the 400 steps on the coarse grid in one launch, the "
          "closing spreads on both grids)" % out["si_launches"])
    check(out["si_launches"]["mv_step"] == 1 and out["si_launches"]["mv_final"] == 2,
          "the silicon MLWF build did not run its 400 steps through kernel 19 in one launch")
    print("[4 main] kernel 11b filter steps in the 4,900-dim ED solve: %d; kernel 20 calls in the ARPES map: %d"
          % (out["ed_filter_steps"], out["arpes_launches"]))
    print("[4 main] kernels 3, 5, 14 and 19 past 8 states (slab 20 states, BN MLWF nw 9): %s; kernel 16 q-batch "
          "launches in the 64-q Lindhard call: %d" % (out["block_launches"], out["lindhard_launches"]))
    check(out["ed_filter_steps"] > 0, "the 4,900-dim ED solve did not go through kernel 11b")
    print("[4 main] kernel 11 in the tbg m=30 solve_window calls (Gamma, K, M): %(launches)d launches in %(rounds)d "
          "filter rounds" % out["tbg30_filter"])
    check(0 < out["tbg30_filter"]["launches"] <= out["tbg30_filter"]["rounds"],
          "the tbg m=30 filter rounds made more kernel-11 launches than rounds, or none")
    check(out["arpes_launches"] > 0, "the ARPES map did not go through kernel 20")

    # steady wall times of the main calls, after the counted window
    t0 = time.perf_counter()
    walls = phase_walls(torch, pt, card)
    walls["bounds"] = composite_bounds(torch, pt, card)
    walls["bounds"].update(more_bounds(torch, pt, card))
    slice13_rows(torch, pt, card)
    print("[4 main] steady walls in %.1f s" % (time.perf_counter() - t0))

    # -- phase 5: launches -----------------------------------------------
    print("[5 launches] main path: %s" % json.dumps(launches))
    kernels = ("assemble", "assemble_one_sided", "eig2", "link_dets", "plaquette_flux", "wilson_loop",
               "position", "ell_matvec", "cheb_moments", "cheb_evolve", "cheb_filter", "decimation",
               "assemble_dk", "spectral_sum", "fermi_sweep", "decimation_green", "cpa", "lyapunov", "eigh_jacobi",
               "assemble_members", "transport_chain", "transport_rotate", "transport_follow", "mv_step",
               "dense_filter", "pole_sum", "tetra_dos", "spectral_sum_qbatch", "propagate_state", "propagate_full",
               "bdg_hessian", "bdg_grand_potential", "assemble_floquet", "winding", "phonon_kappa", "eph_vertex",
               "colpa", "bse_pair", "bse_fock", "energy_vjp")
    for name in kernels:
        check(launches[name] > 0, "kernel %s was not launched on the main path" % name)

    # -- phase 6: results ------------------------------------------------
    sources = {
        "assemble": ("assemble.cu", "pythtb_tpu/ops/hamiltonian.py:46"),
        "eig2": ("eig2.cu", "pythtb_tpu/ops/eigh.py:30"),
        "link_dets": ("link_dets.cu", "pythtb_tpu/ops/berry.py:75"),
        "plaquette_flux": ("plaquette_flux.cu", "pythtb_tpu/ops/berry.py:83"),
        "wilson_loop": ("wilson_loop.cu", "pythtb_tpu/ops/berry.py:263"),
        "position": ("position.cu", "pythtb_tpu/ops/position.py:33"),
        "ell_matvec": ("ell_matvec.cu", "pythtb_tpu/ops/matvec.py:201"),
        "cheb_moments": ("cheb_moments.cu", "pythtb_tpu/flows.py:1061"),
        "cheb_evolve": ("cheb_evolve.cu", "pythtb_tpu/dynamics.py:95"),
        "assemble_one_sided": ("assemble.cu", "pythtb_tpu/surface.py:117"),
        "cheb_filter": ("cheb_filter.cu", "pythtb_tpu/flows.py:696"),
        "decimation": ("decimation.cu", "pythtb_tpu/surface.py:138"),
        "assemble_dk": ("assemble.cu", "pythtb_tpu/ops/hamiltonian.py:115"),
        "spectral_sum": ("spectral_sum.cu", "pythtb_tpu/optical.py:124"),
        "fermi_sweep": ("fermi_sweep.cu", "pythtb_tpu/flows.py:1284"),
        "decimation_green": ("decimation.cu", "pythtb_tpu/negf.py:79"),
        "cpa": ("cpa.cu", "pythtb_tpu/disorder.py:61"),
        "lyapunov": ("lyapunov.cu", "pythtb_tpu/localization.py:73"),
        "eigh_jacobi": ("eigh_jacobi.cu", "pythtb_tpu/ops/eigh.py:69"),
        "assemble_members": ("assemble.cu", "pythtb_tpu/magnetic.py:241"),
        "transport_chain": ("transport.cu", "pythtb_tpu/ops/transport.py:56"),
        "transport_rotate": ("transport.cu", "pythtb_tpu/ops/transport.py:56"),
        "transport_follow": ("transport.cu", "pythtb_tpu/ops/transport.py:103"),
        "mv_step": ("mv_step.cu", "pythtb_tpu/wannier.py:214"),
        "dense_filter": ("dense_filter.cu", "pythtb_tpu/ed.py:238"),
        "pole_sum": ("pole_sum.cu", "pythtb_tpu/dmft.py:215"),
        "tetra_dos": ("tetra_dos.cu", "pythtb_tpu/fermisurface.py:239"),
        "spectral_sum_qbatch": ("spectral_sum.cu", "pythtb_tpu/response.py:64"),
        "propagate_state": ("propagate.cu", "pythtb_tpu/optical.py:601"),
        "propagate_full": ("propagate.cu", "pythtb_tpu/floquet.py:299"),
        "bdg_hessian": ("bdg_hessian.cu", "pythtb_tpu/geometry.py:373"),
        "bdg_grand_potential": ("bdg_hessian.cu", "pythtb_tpu/geometry.py:333"),
        "assemble_floquet": ("assemble.cu", "pythtb_tpu/floquet.py:260"),
        "winding": ("winding.cu", "pythtb_tpu/floquet.py:592"),
        "phonon_kappa": ("phonon_kappa.cu", "pythtb_tpu/phonon.py:389"),
        "eph_vertex": ("eph_vertex.cu", "pythtb_tpu/eph.py:220"),
        "colpa": ("colpa.cu", "pythtb_tpu/magnon.py:284"),
        "bse_pair": ("bse_kernel.cu", "pythtb_tpu/exciton.py:339"),
        "bse_fock": ("bse_kernel.cu", "pythtb_tpu/exciton.py:257"),
        "energy_vjp": ("energy_vjp.cu", "pythtb_tpu/flows.py:521"),
    }
    rows = []
    for name in kernels:
        src, replaces = sources[name]
        r = res[name]
        rows.append({
            "name": name, "route": "cuda", "source": "pythtb_tpu_torch/csrc/" + src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shape": r["shape"], "device_us": r["device_us"], "event_us": r["event_us"],
            "plain_device_us": r["plain_device_us"],
            "plain_launches_per_call": r["plain_launches_per_call"],
        })
    print(json.dumps({"kernels": rows, "wall_ms": walls, "card": card}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    try:
        main()
    except Exception as exc:  # report any phase's failure and exit non-zero
        import traceback

        traceback.print_exc()
        print("chip_smoke FAILED: %s" % exc, file=sys.stderr)
        sys.exit(1)
