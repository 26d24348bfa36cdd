// Kernel 11: the Gaussian-window Chebyshev filter of the spectrum-slice
// solver,  Y = sum_{m < M} coef[m] T_m(Ht) X,  Ht = (H - b) / a,  coef real.
//
// Replaces the lax.scan of pythtb_tpu/flows.py:_window_round_jit (the
// filter at :696-706); the whitening and Rayleigh-Ritz of that program
// stay torch.linalg in ops/chebyshev.py's caller (flows._window_round).
//
// What bounds it on the H100: bytes, at the magic-angle TBG shape (N
// 11,164, D ~49, B 12): a term reads the ELL tables (10.9 MB), T_n, T_{n-1}
// and acc, and writes T_{n+1} and acc, about 21.7 MB, ~6.5 us at 3.35
// TB/s; the working set (~17 MB) fits the 50 MB L2.  At N*B ~134k
// elements a term is only ~520 blocks, so launch latency is of the same
// order as the work.  Design: kernel 10's term kernel (cheb_term.cuh)
// instantiated with real coefficients, one launch a term; the C entry
// point runs all M - 1 terms of one filter on the stream, so a round is
// one ctypes call whatever its degree.  X is not written; the two work
// buffers are written in place.  A persistent kernel is left to a speed PR.
#include "cheb_term.cuh"

// coef (M,) float64, x (nsta, B), work (2, nsta, B), y (nsta, B).
extern "C" int pythtb_cheb_filter(const void* cols, const void* vals, const void* ab,
                                  const void* coef, const void* x, void* work, void* y,
                                  int64_t norb, int64_t D, int64_t nspin, int64_t B, int64_t M,
                                  void* stream) {
    const int64_t nsta = norb * nspin;
    if (nsta * B == 0 || M < 2) return 0;
    if (nspin == 2)
        return cheb_expand<2, double>((const int*)cols, (const cplx*)vals, (const double*)ab,
                                      (const double*)coef, (const cplx*)x, (cplx*)work, (cplx*)y,
                                      nsta, D, B, M, (cudaStream_t)stream);
    return cheb_expand<1, double>((const int*)cols, (const cplx*)vals, (const double*)ab,
                                  (const double*)coef, (const cplx*)x, (cplx*)work, (cplx*)y,
                                  nsta, D, B, M, (cudaStream_t)stream);
}
