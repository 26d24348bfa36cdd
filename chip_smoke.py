#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (pythtb_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:

1. environment: needs torch.cuda.is_available(); prints the card's name
   and power limit (nvidia-smi), torch and CUDA versions;
2. build: compiles the four CUDA kernels with nvcc (sm_90a) into
   build/pythtb_tpu_torch/ and prints the build seconds and ptxas usage;
3. each kernel against its plain PyTorch version on the card, at the
   main path's shapes: max |diff| (tolerance 1e-12, float64), and the
   median time of each over 25 runs (CUDA events);
4. the main path through the public API: Haldane bands, the 301 x 301
   Chern number through wf_array.berry_flux and flows.chern_number
   (both -1 within 1e-8), and the Kane-Mele Wilson-loop flow checked
   against PythTB's own golden numbers;
5. launches: every kernel's counter must have risen during phase 4;
6. a JSON line of per-kernel results, then the last line
   {"ok": true, "device": {...}}.

It imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

TOL = 1e-12
GRID = 301
REPS = 25
ROOT = Path(__file__).resolve().parent


class SmokeError(Exception):
    pass


def check(ok, msg):
    if not ok:
        raise SmokeError(msg)


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


def cuda_ms(torch, fn):
    """Median milliseconds of ``fn`` over REPS runs after warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


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


def match_phase_sets(got, want, tol):
    """Compare multiband phase rows as sets on the unit circle."""
    got2 = np.asarray(got).reshape(-1, np.shape(got)[-1])
    want2 = np.asarray(want).reshape(-1, np.shape(want)[-1])
    worst = 0.0
    for row in range(got2.shape[0]):
        avail = list(range(got2.shape[1]))
        for w in want2[row]:
            dists = [abs(np.angle(np.exp(1j * (got2[row, k] - w)))) for k in avail]
            k_best = int(np.argmin(dists))
            worst = max(worst, dists[k_best])
            avail.pop(k_best)
    check(worst < tol, "Wilson phases differ from the golden set by %.3e" % worst)
    return worst


def phase_kernels(torch, pt, device):
    """Phase 3: each kernel vs its plain version at the main path's shapes."""
    from pythtb_tpu_torch import core
    from pythtb_tpu_torch.ops import berry, eigh, hamiltonian, solver
    from tests import zoo

    rng = np.random.default_rng(1)
    res = {}
    failures = []

    def record(name, key, err, ms, plain_ms, main):
        print("  %-15s %-28s max|diff| %.3e  kernel %.4f ms  plain %.4f ms"
              % (name, key, err, ms, plain_ms))
        if not err <= TOL:
            failures.append("%s %s disagrees with its plain version: %.3e" % (name, key, err))
        r = res.setdefault(name, {"max_abs_err": 0.0})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if main:
            r["ms"], r["plain_ms"] = ms, plain_ms

    # kernel 1: assemble
    hal = haldane(pt)._get_finalized()
    km = zoo.kane_mele(pt, "odd")._get_finalized()
    rnd = random_model_data(core, rng, device)
    k_hal = solver.device_uniform_grid((GRID - 1, GRID - 1), (-0.5, -0.5), device)
    k_km = solver.device_uniform_grid((40, 40), (-0.5, -0.5), device)
    k_rnd = torch.as_tensor(rng.random((16384, 3)), dtype=torch.float64).to(device)
    for key, data, k, main in (
        ("haldane B=90000", hal, k_hal, True),
        ("kane_mele nspin2 B=1600", km, k_km, False),
        ("norb64 nhop4096 B=16384", rnd, k_rnd, False),
    ):
        err = max_diff(torch, hamiltonian.assemble(data, k), hamiltonian._assemble_plain(data, k))
        ms = cuda_ms(torch, lambda: hamiltonian.assemble(data, k))
        plain_ms = cuda_ms(torch, lambda: hamiltonian._assemble_plain(data, k))
        record("assemble", key, err, ms, plain_ms, main)

    # kernel 2: eig2
    H = hamiltonian._assemble_plain(hal, k_hal)
    w, v = eigh.eig2(H)
    wp, vp = eigh._eig2_plain(H)
    err = max(max_diff(torch, w, wp), max_diff(torch, v, vp))
    record("eig2", "B=90000", err, cuda_ms(torch, lambda: eigh.eig2(H)),
           cuda_ms(torch, lambda: eigh._eig2_plain(H)), True)

    # kernels 3 and 4: link dets and plaquette flux
    _, _, wfs = solver.solve_grid_device(hal, (GRID, GRID), (-0.5, -0.5),
                                         haldane(pt)._orb, [0, 1], 1)
    grids = [("301x301 S=1 F=2", berry.prep_states(wfs, [0], 1, 2), True)]
    for S, F in ((2, 4), (4, 8)):
        z = rng.normal(size=(GRID, GRID, S, F)) + 1j * rng.normal(size=(GRID, GRID, S, F))
        z /= np.linalg.norm(z, axis=-1, keepdims=True)  # unit states, as eigenvectors are
        grids.append(("301x301 S=%d F=%d random" % (S, F),
                      torch.as_tensor(z, dtype=torch.complex128).to(device), False))
    for key, st, main in grids:
        err = 0.0
        for axis in (0, 1):
            err = max(err, max_diff(torch, berry.link_dets(st, axis), berry._link_dets_plain(st, axis)))
        record("link_dets", key, err, cuda_ms(torch, lambda: berry.link_dets(st, 0)),
               cuda_ms(torch, lambda: berry._link_dets_plain(st, 0)), main)
        Dr, Du = berry._link_dets_plain(st, 0), berry._link_dets_plain(st, 1)
        s_k, m_k = berry.plaquette_flux(Dr, Du)
        s_p, m_p = berry._plaquette_flux_plain(Dr, Du, False)
        p_k, _ = berry.plaquette_flux(Dr, Du, individual=True)
        p_p, _ = berry._plaquette_flux_plain(Dr, Du, True)
        err = max(max_diff(torch, s_k, s_p), max_diff(torch, m_k, m_p), wrapped_diff(torch, p_k, p_p))
        record("plaquette_flux", key, err, cuda_ms(torch, lambda: berry.plaquette_flux(Dr, Du)),
               cuda_ms(torch, lambda: berry._plaquette_flux_plain(Dr, Du, False)), main)
    check(not failures, "; ".join(failures))
    return res


def phase_main_path(torch, pt, where):
    """Phase 4: the port's main path through the entry points a user calls."""
    from tests import zoo

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

    km = zoo.kane_mele(pt, "odd")
    wk = pt.wf_array(km, [21, 21])
    wk.solve_on_grid([-0.5, -0.5])
    flow = wk.berry_phase([0, 1], dir=1, berry_evals=True)
    flow_raw = wk.berry_phase([0, 1], dir=1, contin=False, berry_evals=True)
    check(flow.shape == (21, 2) and np.isfinite(flow).all(), "bad Kane-Mele flow %s" % (flow.shape,))
    out["flow_raw"] = flow_raw
    return out


def main():
    import torch

    # -- phase 1: environment ------------------------------------------
    if not torch.cuda.is_available():
        raise SmokeError("torch.cuda.is_available() is false: this smoke run needs an NVIDIA GPU")
    import pythtb_tpu_torch as pt
    from pythtb_tpu_torch import config
    from pythtb_tpu_torch.ops import _kernels

    device = config.set_device("cuda")
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
    _kernels.library()
    print("[2 build] kernels ready in %.2f s (nvcc %s s) -> %s"
          % (time.perf_counter() - t0, _kernels.build_info["seconds"], _kernels.build_info["path"]))
    for line in _kernels.build_info["ptxas"].splitlines():
        if "Used" in line or "spill" in line or "Compiling entry" in line:
            print("[2 build] " + line.strip())

    # -- phase 3: kernels vs plain versions ------------------------------
    print("[3 kernels] each kernel vs its plain PyTorch version (tolerance %.0e):" % TOL)
    res = phase_kernels(torch, pt, device)

    # CPU references for phase 4, made before the counted window
    config.set_device("cpu")
    ref = phase_main_path(torch, pt, "[cpu reference]")
    config.set_device(device)
    gold = np.load(ROOT / "tests" / "golden" / "data" / "kane_mele_flow.npz")

    # -- phase 4: main path ----------------------------------------------
    print("[4 main] Haldane bands, 301x301 Chern (wf_array, flows), Kane-Mele Wilson flow:")
    _kernels.reset_launches()
    out = phase_main_path(torch, pt, "[gpu]")
    torch.cuda.synchronize()
    launches = dict(_kernels.LAUNCHES)
    err_bands = float(np.abs(out["evals"] - ref["evals"]).max())
    print("  haldane bands vs CPU plain path: max|diff| %.3e" % err_bands)
    check(err_bands < TOL, "Haldane bands differ from the CPU path by %.3e" % err_bands)
    worst = match_phase_sets(out["flow_raw"], gold["pha_flow_odd"], 1e-8)
    print("  kane_mele odd Wilson flow vs PythTB golden: worst %.3e (tolerance 1e-8)" % worst)
    m = haldane(pt)
    pt.flows.chern_number(m, [0], nk=(GRID, GRID))
    times = []
    for _ in range(10):
        t0 = time.perf_counter()
        pt.flows.chern_number(m, [0], nk=(GRID, GRID))
        times.append(time.perf_counter() - t0)
    chern_ms = 1e3 * float(np.median(times))
    print("  flows.chern_number 301x301 steady wall: median %.3f ms, min %.3f ms (%s)"
          % (chern_ms, 1e3 * min(times), card))

    # -- phase 5: launches -----------------------------------------------
    print("[5 launches] main path: %s" % json.dumps(launches))
    kernels = ("assemble", "eig2", "link_dets", "plaquette_flux")
    for name in kernels:
        check(launches[name] > 0, "kernel %s was not launched on the main path" % name)

    # -- phase 6: results ------------------------------------------------
    sources = {
        "assemble": ("assemble.cu", "pythtb_tpu/ops/hamiltonian.py:46"),
        "eig2": ("eig2.cu", "pythtb_tpu/ops/eigh.py:30"),
        "link_dets": ("link_dets.cu", "pythtb_tpu/ops/berry.py:75"),
        "plaquette_flux": ("plaquette_flux.cu", "pythtb_tpu/ops/berry.py:83"),
    }
    rows = []
    for name in kernels:
        src, replaces = sources[name]
        rows.append({
            "name": name, "route": "cuda", "source": "pythtb_tpu_torch/csrc/" + src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": res[name]["max_abs_err"], "ms": res[name]["ms"],
            "plain_ms": res[name]["plain_ms"],
        })
    print(json.dumps({"kernels": rows}))
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
