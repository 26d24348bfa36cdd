// The ELL gather shared by kernels 8 and 10 (kernels 9 and 11 keep its
// arithmetic in cheb_grid.cuh).
//
// A finite Hamiltonian in padded-row (ELL) form: cols (norb, D) int32 and
// vals (norb, D) complex128 at nspin 1, or (norb, D, 2, 2) spin blocks at
// nspin 2 (ops/matvec.py).  Padding slots hold column 0 and value 0, and
// no slot is assumed to be the diagonal.  A block of vectors x is
// addressed as x[row * ld + b]: row is the flat state index, spin-fastest
// (row = orbital * S + spin), and b the vector.
#pragma once

#include "common.cuh"

// (H x)[r, b] = sum_d sum_t vals[n, d, s, t] * x[cols[n, d] * S + t, b],
// n = r / S, s = r % S, summed in slot order (then spin order).
template <int S>
__device__ __forceinline__ cplx ell_row(const int* __restrict__ cols, const cplx* __restrict__ vals,
                                        const cplx* __restrict__ x, int64_t ld, int64_t r,
                                        int64_t b, int D) {
    const int64_t n = r / S;
    const int s = (int)(r - n * S);
    const int* crow = cols + n * D;
    const cplx* vrow = vals + n * D * S * S + s * S;
    double re = 0.0, im = 0.0;
    for (int d = 0; d < D; ++d) {
        const int64_t c = crow[d];
#pragma unroll
        for (int t = 0; t < S; ++t) {
            const cplx v = vrow[d * S * S + t];
            const cplx xv = x[(c * S + t) * ld + b];
            re += v.x * xv.x - v.y * xv.y;
            im += v.x * xv.y + v.y * xv.x;
        }
    }
    return make_cuDoubleComplex(re, im);
}

// The rescaled operator of the Chebyshev recursions, ((H - shift) x / a)[r, b],
// as the JAX programs write it: (matvec(h, v) - ab[1] * v) / ab[0].
template <int S>
__device__ __forceinline__ cplx ell_scaled(const int* __restrict__ cols,
                                           const cplx* __restrict__ vals,
                                           const cplx* __restrict__ x, int64_t ld, int64_t r,
                                           int64_t b, int D, double a, double shift) {
    const cplx h = ell_row<S>(cols, vals, x, ld, r, b, D);
    const cplx xv = x[r * ld + b];
    return make_cuDoubleComplex((h.x - shift * xv.x) / a, (h.y - shift * xv.y) / a);
}
