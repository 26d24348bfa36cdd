"""Build, load and launch the hand-written CUDA kernels.

The sources under ``pythtb_tpu_torch/csrc/`` are compiled at first use
with ``nvcc`` for ``sm_90a`` -- one ``nvcc -c`` per source, all started
together, then one link -- into a shared library with a plain C
interface, loaded with ctypes.  The library is named by a hash of the
sources and flags and lives in ``build/pythtb_tpu_torch/`` at the root
of the checkout, so a changed source rebuilds it.  Nothing here runs at
import: the CPU tests import every module.

Each kernel wrapper (in the module of the JAX program it replaces, in
``ops/chebyshev.py`` for the recursions of kernels 9, 10 and 11, or in
``ops/fermi_sweep.py`` for kernel 17, which serves three modules, and
in ``ops/phonon_kappa.py``, ``ops/eph_vertex.py`` and ``ops/colpa.py``
for kernels 25-27, in ``ops/bse.py`` for kernel 28)
validates its tensors with :func:`require`, allocates its outputs with
``torch.empty``, launches through :func:`launch` on the current stream,
and counts the launch in :data:`LAUNCHES`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

__all__ = ["LAUNCHES", "reset_launches", "library", "require", "launch", "card"]

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "pythtb_tpu_torch"
GENCODE = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*GENCODE, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _D = ctypes.c_void_p, ctypes.c_int64, ctypes.c_double
# C entry point -> argument types (all return cudaGetLastError())
_SIGNATURES = {
    "pythtb_assemble": [_P] * 7 + [_I] * 5 + [_P],
    "pythtb_eig2": [_P] * 3 + [_I, _P],
    "pythtb_link_dets": [_P] * 2 + [_I] * 5 + [_P],
    "pythtb_plaquette_flux": [_P] * 7 + [_I] * 4 + [_P],
    "pythtb_wilson_loop": [_P] * 5 + [_I] * 6 + [_P],
    "pythtb_position": [_P] * 4 + [_I] * 5 + [_P],
    "pythtb_ell_matvec": [_P] * 4 + [_I] * 6 + [_P],
    "pythtb_cheb_moments": [_P] * 6 + [_I] * 8 + [_P],
    "pythtb_cheb_recursion": [_P] * 4 + [_I] * 10 + [_P],
    "pythtb_cheb_evolve": [_P] * 7 + [_I] * 6 + [_P],
    "pythtb_cheb_filter": [_P] * 8 + [_I] * 9 + [_P],
    "pythtb_decimation": [_P] * 7 + [_I] * 4 + [_P],
    "pythtb_decimation_green": [_P] * 6 + [_I] * 4 + [_P],
    "pythtb_assemble_deriv": [_P] * 6 + [_I] * 5 + [_P],
    "pythtb_spectral_sum": [_P] * 5 + [_I] * 5 + [_D, _P],
    "pythtb_fermi_sweep": [_P] * 7 + [_I] * 7 + [_D, _I, _P],
    "pythtb_cpa": [_P] * 4 + [_I] * 3 + [_P],
    "pythtb_lyapunov": [_P] * 6 + [_I] * 6 + [_P],
    "pythtb_eigh_jacobi": [_P] * 4 + [_I] * 3 + [_D, _I, _I, _P],
    "pythtb_assemble_members": [_P] * 7 + [_I] * 6 + [_P],
    "pythtb_transport_chain": [_P] * 5 + [_I] * 7 + [_P],
    "pythtb_transport_rotate": [_P] * 6 + [_I] * 8 + [_P],
    "pythtb_transport_follow": [_P] * 7 + [_I] * 8 + [_P],
    "pythtb_mv_run": [_P] * 13 + [_I] * 4 + [_D] * 2 + [_I] * 3 + [_P],
    "pythtb_mv_overlaps": [_P] * 5 + [_I] * 3 + [_P],
    "pythtb_mv_reduce": [_P] * 7 + [_I] * 4 + [_D, _D, _I, _P],
    "pythtb_mv_update": [_P] * 7 + [_I] * 4 + [_P],
    "pythtb_dense_filter": [_P] * 7 + [_I] * 5 + [_D, _D, _P],
    "pythtb_dense_filter_tc": [_P] * 7 + [_I] * 5 + [_D, _D, _P],
    "pythtb_pole_sum": [_P] * 7 + [_I] * 5 + [_D, _P],
    "pythtb_pole_map": [_P] * 6 + [_I] * 3 + [_P],
    "pythtb_pole_resolved": [_P] * 8 + [_I] * 3 + [_P],
    "pythtb_tetra_dos": [_P] * 5 + [_I] * 4 + [_D, _P],
    "pythtb_spectral_sum_qbatch": [_P] * 5 + [_I] * 5 + [_D, _P],
    "pythtb_propagate_state": [_P] * 7 + [_I] * 6 + [_P],
    "pythtb_propagate_full": [_P] * 5 + [_I] * 3 + [_P],
    "pythtb_bdg_hessian": [_P] * 9 + [_I] * 3 + [_D] * 11 + [_P],
    "pythtb_bdg_grand_potential": [_P] * 3 + [_I] * 3 + [_D] * 2 + [_P],
    "pythtb_assemble_floquet": [_P] * 9 + [_I] * 6 + [_D, _P],
    "pythtb_winding": [_P] * 8 + [_I] * 5 + [_D, _P],
    "pythtb_phonon_kappa": [_P] * 6 + [_I] * 4 + [_P],
    "pythtb_eph_vertex": [_P] * 13 + [_I] * 8 + [_P],
    "pythtb_colpa": [_P] * 9 + [_I] * 4 + [_D, _P],
    "pythtb_bse_pair": [_P] * 6 + [_I] * 7 + [_D, _P],
    "pythtb_bse_fock": [_P] * 5 + [_I] * 6 + [_P],
    "pythtb_energy_vjp": [_P] * 9 + [_I] * 7 + [_P],
}

# Launches per kernel since the last reset.  "wilson_loop" counts kernel
# 5's launches, two a call (the links' polar factors, then the chains).
# Kernels 9 and 11 run a whole recursion in one cooperative launch and
# count it (one a moments, recursion or filter call); kernel 10 runs one
# launch per term from one C call and counts the terms.
# "assemble_one_sided" counts kernel 1's one-sided launches (not in
# "assemble"); "assemble_dk" counts
# kernel 15 in both its modes (dH/dk and d2H/dk dk); "spectral_sum" counts
# kernel 16's calls (a partial pass and a reduction each); "decimation_green"
# counts kernel 12's Green's-function mode (not in "decimation"); "lyapunov"
# counts kernel 18's launches, one per chunk of steps, in both designs; "eigh_jacobi" counts
# kernel 7; "assemble_members" counts kernel 1's flux-batch mode (not in
# "assemble"); "transport_chain", "transport_rotate" and "transport_follow"
# count kernel 14's three modes (the chain's link path is two launches a
# call, the links' polar factors and the prefixes; the follow mode five:
# the overlaps, the scan, the polar factors, the prefixes and the states,
# three where the axis has one point); "fermi_sweep" counts
# kernel 17's two launches a call, the chunks' sums and their reduction; "mv_step" counts kernel 19's
# launches that carry Marzari-Vanderbilt steps -- to 8 Wannier functions one
# a run (every step of it in one launch), from 9 one a step (the update, the
# last of the step's three launches: overlaps, reduction, update) -- and
# "mv_final" its closing pairs of overlaps and reduction, one a run (a
# launch of the run kernel with no steps, or two block launches); "dense_filter"
# counts kernel 11b's filter steps in both designs (cores: four launches a
# step -- the product, the epilogue, the scale reduction, the rescale; the
# first step two; tensor: one launch a step, and one more a call for the
# final scale); "pole_sum"
# counts kernel 20's calls in all four modes (k-mean and pole: a partial
# pass and a reduction each; map and resolved: one launch); "tetra_dos"
# counts kernel 21's calls (corners, partial sums and reduction each);
# "spectral_sum_qbatch" counts kernel 16's q-batch calls (a partial pass
# and a reduction each, not in "spectral_sum"); "propagate_state" and
# "propagate_full" count kernel 22's calls in its two modes (a chunk of
# steps each; the state mode adds a reduction launch); "bdg_hessian" and
# "bdg_grand_potential" count kernel 23's calls (a partial pass and a
# reduction each); "assemble_floquet" counts kernel 1's Floquet-block
# mode (not in "assemble"); "winding" counts kernel 24's calls (the
# periodized history, the stencil and a reduction each); "phonon_kappa"
# counts kernel 25's calls (a partial pass and a reduction each);
# "eph_vertex" counts kernel 26 and "colpa" kernel 27 (one launch each);
# "bse_pair" and "bse_fock" count kernel 28's two modes (a call each; a
# Fock call is two launches, the convolution and the contraction);
# "energy_vjp" counts kernel 29's calls (a partial pass and a reduction
# each).
LAUNCHES = dict.fromkeys(
    ("assemble", "assemble_one_sided", "eig2", "link_dets", "plaquette_flux", "wilson_loop",
     "position", "ell_matvec", "cheb_moments", "cheb_evolve", "cheb_filter", "decimation",
     "assemble_dk", "spectral_sum", "fermi_sweep", "decimation_green", "cpa", "lyapunov",
     "eigh_jacobi", "assemble_members", "transport_chain", "transport_rotate",
     "transport_follow", "mv_step", "mv_final", "dense_filter", "pole_sum", "tetra_dos",
     "spectral_sum_qbatch", "propagate_state", "propagate_full", "bdg_hessian", "bdg_grand_potential",
     "assemble_floquet", "winding", "phonon_kappa", "eph_vertex", "colpa", "bse_pair", "bse_fock",
     "energy_vjp"), 0
)

_lib = None
build_info = {"seconds": None, "path": None, "ptxas": "", "compile_seconds": {}}

# cudaErrorMemoryAllocation
_OUT_OF_MEMORY = 2
# the C entries whose first launch may grow the card's local-memory
# reservation and which launch nothing before it: kernel 22's register
# paths keep the step's eigenpairs in ~18 kB stack frames a thread, and
# the card reserves a frame for every thread it can hold (~5 GB on the
# H100) at the first such launch, outside torch's caching allocator
GROWS_LOCAL_MEMORY = frozenset({"propagate_state", "propagate_full"})
# how many such launches had torch's cache released before they went through
cache_releases = 0


@functools.lru_cache(maxsize=None)
def card(device):
    """The SM count and the shared memory a block may opt into of a CUDA
    ``device``, read once (the wrappers that pick a design by them run in
    hot paths)."""
    props = torch.cuda.get_device_properties(device)
    return props.multi_processor_count, props.shared_memory_per_block_optin


def reset_launches():
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def _nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    return str(cand) if cand.exists() else "nvcc"


def library():
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is not None:
        return _lib
    sources = sorted(_CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(_CSRC.glob("*.cu*")):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    so = BUILD_DIR / ("libpythtb_kernels_%s.so" % digest.hexdigest()[:16])
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tag = "%s.%d" % (digest.hexdigest()[:16], os.getpid())
        t0 = time.perf_counter()
        objs = [BUILD_DIR / ("%s.%s.o" % (src.stem, tag)) for src in sources]

        def compile_one(src, obj):
            start = time.perf_counter()
            proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                                  capture_output=True, text=True)
            return proc, time.perf_counter() - start

        try:
            # one thread per source, so every nvcc starts at once
            with ThreadPoolExecutor(len(sources)) as pool:
                results = list(pool.map(compile_one, sources, objs))
            logs = [proc.stderr for proc, _ in results]
            build_info["compile_seconds"] = {src.name: sec for src, (_, sec) in zip(sources, results)}
            failed = ["%s (rc %d):\n%s" % (src.name, proc.returncode, proc.stderr)
                      for src, (proc, _) in zip(sources, results) if proc.returncode != 0]
            if failed:
                raise RuntimeError("nvcc failed for " + "\n".join(failed))
            tmp = so.with_name("%s.%d.tmp" % (so.name, os.getpid()))
            proc = subprocess.run(
                [_nvcc(), "-shared", *GENCODE, "-o", str(tmp), *map(str, objs)],
                capture_output=True, text=True,
            )
            if proc.returncode != 0:
                raise RuntimeError("nvcc link failed (rc %d):\n%s" % (proc.returncode, proc.stderr))
            os.replace(tmp, so)
        finally:
            for obj in objs:
                obj.unlink(missing_ok=True)
        build_info["seconds"] = time.perf_counter() - t0
        build_info["ptxas"] = "".join(logs)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    build_info["path"] = str(so)
    _lib = lib
    return lib


def require(t: torch.Tensor, name: str, dtype: torch.dtype, shape=None, device=None):
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` (and
    ``shape``, and on ``device`` where given)."""
    if t.device.type != "cuda":
        raise ValueError("%s must be a CUDA tensor, got %s" % (name, t.device))
    if device is not None and t.device != device:
        raise ValueError("%s is on %s, expected %s" % (name, t.device, device))
    if t.dtype != dtype:
        raise TypeError("%s must be %s, got %s" % (name, dtype, t.dtype))
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError("%s must have shape %s, got %s" % (name, tuple(shape), tuple(t.shape)))
    if not t.is_contiguous():
        raise ValueError("%s must be contiguous" % name)


def require_rows(t: torch.Tensor, name: str, dtype: torch.dtype, shape, device=None) -> int:
    """As :func:`require` for a 2-D view whose rows need not be adjacent
    (a slot of a larger block): each row must be contiguous.  Returns the
    row stride in elements."""
    if t.device.type != "cuda":
        raise ValueError("%s must be a CUDA tensor, got %s" % (name, t.device))
    if device is not None and t.device != device:
        raise ValueError("%s is on %s, expected %s" % (name, t.device, device))
    if t.dtype != dtype:
        raise TypeError("%s must be %s, got %s" % (name, dtype, t.dtype))
    if tuple(t.shape) != tuple(shape):
        raise ValueError("%s must have shape %s, got %s" % (name, tuple(shape), tuple(t.shape)))
    if t.stride(1) != 1 or t.stride(0) < t.shape[1]:
        raise ValueError("%s must have contiguous rows, got strides %s" % (name, t.stride()))
    return t.stride(0)


def launch(kernel: str, device: torch.device, *args, counter=None, count=1):
    """Call C entry point ``pythtb_<kernel>`` on ``device``'s current
    stream; tensors in ``args`` pass as pointers, ints as sizes, floats
    as doubles.  Raises if the launch was refused; otherwise adds
    ``count`` device launches to ``LAUNCHES[counter or kernel]``.  An entry
    of ``GROWS_LOCAL_MEMORY`` refused for want of memory is called once
    more after torch's allocator releases the blocks it holds unused."""
    fn = getattr(library(), "pythtb_" + kernel)
    conv = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*conv, stream)
        if rc == _OUT_OF_MEMORY and kernel in GROWS_LOCAL_MEMORY:
            global cache_releases
            torch.cuda.empty_cache()
            rc = fn(*conv, stream)
            cache_releases += rc == 0
    if rc != 0:
        raise RuntimeError("CUDA kernel %s failed to launch: cudaError %d" % (kernel, rc))
    LAUNCHES[counter or kernel] += count
