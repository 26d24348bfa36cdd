// Kernel 10: Chebyshev-Bessel time stepping psi <- e^{-i H dt} psi.
//
// Replaces the XLA-fused lax.scan programs pythtb_tpu/dynamics.py:
// _cheb_evolve_jit and _cheb_evolve_seeded_jit.  One step of order M is
//   T_0 = psi, T_1 = Ht psi, acc = c_0 T_0 + c_1 T_1,
//   T_{n+1} = 2 Ht T_n - T_{n-1}, acc += c_{n+1} T_{n+1}   (n = 1 .. M-2),
// with Ht = (H - b) / a and the step coefficients c (M,) complex read from
// the device; acc is the new psi, written into row s of the history
// (nsteps, nsta, B), and the next step starts from it.
//
// What bounds it on the H100: bytes.  A term reads T_n (gathered
// through the D slots), T_{n-1}, acc, cols and vals, and writes T_{n+1}
// and acc: at N 90,000, D 5, B 1 about 16 MB, a bound of ~4.8 us.
// Design: one launch per term does the recursion and the accumulation
// (the JAX scan body; cheb_term.cuh), one thread per element (r, b) with
// b fastest.  The C entry point runs all M - 1 terms of all steps on the
// stream (1,140 launches for 20 steps of order 58), so an evolve call is
// one ctypes call.  The history rows hold acc.
// No reductions, no atomics.
#include "cheb_term.cuh"

template <int S>
static int evolve(const int* cols, const cplx* vals, const double* ab, const cplx* coef,
                  const cplx* psi0, cplx* work, cplx* hist, int64_t nsta, int64_t D, int64_t B,
                  int64_t M, int64_t nsteps, cudaStream_t st) {
    const int64_t n = nsta * B;
    for (int64_t s = 0; s < nsteps; ++s) {
        const cplx* psi = s == 0 ? psi0 : hist + (s - 1) * n;
        const int err = cheb_expand<S>(cols, vals, ab, coef, psi, work, hist + s * n, nsta, D, B, M, st);
        if (err != 0) return err;
    }
    return 0;
}

// coef (M,) complex, psi0 (nsta, B), work (2, nsta, B), hist (nsteps, nsta, B).
extern "C" int pythtb_cheb_evolve(const void* cols, const void* vals, const void* ab,
                                  const void* coef, const void* psi0, void* work, void* hist,
                                  int64_t norb, int64_t D, int64_t nspin, int64_t B, int64_t M,
                                  int64_t nsteps, void* stream) {
    const int64_t nsta = norb * nspin;
    if (nsta * B == 0 || M < 2) return 0;
    if (nspin == 2)
        return evolve<2>((const int*)cols, (const cplx*)vals, (const double*)ab,
                         (const cplx*)coef, (const cplx*)psi0, (cplx*)work, (cplx*)hist, nsta, D,
                         B, M, nsteps, (cudaStream_t)stream);
    return evolve<1>((const int*)cols, (const cplx*)vals, (const double*)ab, (const cplx*)coef,
                     (const cplx*)psi0, (cplx*)work, (cplx*)hist, nsta, D, B, M, nsteps,
                     (cudaStream_t)stream);
}
