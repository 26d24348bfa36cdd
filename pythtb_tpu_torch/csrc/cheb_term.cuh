// The Chebyshev term of kernel 10 (cheb_evolve.cu): one launch per term of
//   acc = sum_m c_m T_m(Ht) x,   Ht = (H - b) / a,
// with the recursion T_{m+1} = 2 Ht T_m - T_{m-1} and the accumulation in
// the same pass, one thread per element (r, b) with b fastest, complex
// coefficients (the Bessel weights).  T_{m+1} is written over T_{m-1}
// element by element (only the thread that reads T_{m-1}[r, b] writes
// T_{m+1}[r, b]), so two work buffers hold the recursion.
#pragma once

#include "ell.cuh"

// FIRST: tn = Ht tc, acc = coef[0] tc + coef[1] tn.  Otherwise
// tn = 2 Ht tc - tm (tn may be tm), acc += coef[0] tn.
template <int S, bool FIRST>
__global__ void cheb_term_kernel(const int* __restrict__ cols, const cplx* __restrict__ vals,
                                 const double* __restrict__ ab, const cplx* __restrict__ coef,
                                 const cplx* tm, const cplx* __restrict__ tc, cplx* tn,
                                 cplx* __restrict__ acc, int64_t nsta, int64_t B, int D) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= nsta * B) return;
    const int64_t r = i / B;
    const int64_t b = i - r * B;
    cplx out = ell_scaled<S>(cols, vals, tc, B, r, b, D, ab[0], ab[1]);
    if (FIRST) {
        tn[i] = out;
        acc[i] = cuCadd(cuCmul(coef[0], tc[i]), cuCmul(coef[1], out));
    } else {
        const cplx m = tm[i];
        out = make_cuDoubleComplex(2.0 * out.x - m.x, 2.0 * out.y - m.y);
        tn[i] = out;
        acc[i] = cuCadd(acc[i], cuCmul(coef[0], out));
    }
}

// All M - 1 terms of one expansion acc = sum_{m < M} coef[m] T_m(Ht) x on
// the stream, M >= 2: one launch a term.  work holds 2 * nsta * B.
template <int S>
static int cheb_expand(const int* cols, const cplx* vals, const double* ab, const cplx* coef,
                       const cplx* x, cplx* work, cplx* acc, int64_t nsta, int64_t D, int64_t B,
                       int64_t M, cudaStream_t st) {
    const int64_t n = nsta * B;
    const unsigned int grid = blocks_for(n);
    cplx* slot[2] = {work, work + n};
    // T_m (m >= 1) lives in slot (m - 1) % 2; T_0 is x
    cheb_term_kernel<S, true><<<grid, kThreads, 0, st>>>(cols, vals, ab, coef, nullptr, x, slot[0], acc,
                                                         nsta, B, (int)D);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    for (int64_t m = 2; m < M; ++m) {
        const cplx* tc = slot[(m - 2) & 1];
        cplx* tn = slot[(m - 1) & 1];
        const cplx* tm = m == 2 ? x : tn;
        cheb_term_kernel<S, false><<<grid, kThreads, 0, st>>>(cols, vals, ab, coef + m, tm, tc, tn, acc,
                                                              nsta, B, (int)D);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    return 0;
}
