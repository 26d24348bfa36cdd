// The polar factor of a 1 x 1 or 2 x 2 complex matrix in registers, for
// kernel 14's register paths (transport.cu).
//
// polar_factor<S>(M) overwrites M (S x S) with U V^H, where M = U diag(s) V^H,
// and returns the smallest singular value:
//   S = 1: M / |M|;
//   S = 2: closed form U = (M + phi adj(M)^H) / (s1 + s2), phi = det/|det|,
//          s1 + s2 = sqrt(|M|_F^2 + 2 |det M|).
//
// The one-sided Jacobi of a matrix of up to kPolarBlockMaxS = 64 rows in
// shared memory, run by a team of threads, is link_polar.cuh's; kernel 5
// multiplies its chains with block_mul_left.
#pragma once

#include "common.cuh"

constexpr int kPolarMaxSweeps = 40;
constexpr double kPolarTol = 1.0e-15;

// Overwrites M with its polar factor; returns its smallest singular value.
template <int S>
__device__ __forceinline__ double polar_factor(cplx (&M)[S][S]) {
    static_assert(S == 1 || S == 2, "the closed forms take 1 and 2 states");
    if constexpr (S == 1) {
        const double r = hypot(M[0][0].x, M[0][0].y);
        M[0][0] = r > 0.0 ? make_cuDoubleComplex(M[0][0].x / r, M[0][0].y / r)
                          : make_cuDoubleComplex(1.0, 0.0);
        return r;
    } else if constexpr (S == 2) {
        const cplx d = cuCsub(cuCmul(M[0][0], M[1][1]), cuCmul(M[0][1], M[1][0]));
        const double ad = hypot(d.x, d.y);
        const cplx phi = ad > 0.0 ? make_cuDoubleComplex(d.x / ad, d.y / ad)
                                  : make_cuDoubleComplex(1.0, 0.0);
        double fro2 = 0.0;
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int c = 0; c < 2; ++c) fro2 += M[r][c].x * M[r][c].x + M[r][c].y * M[r][c].y;
        // adj(M)^H = [[conj(M11), -conj(M10)], [-conj(M01), conj(M00)]]
        const cplx a00 = cconj(M[1][1]);
        const cplx a01 = make_cuDoubleComplex(-M[1][0].x, M[1][0].y);
        const cplx a10 = make_cuDoubleComplex(-M[0][1].x, M[0][1].y);
        const cplx a11 = cconj(M[0][0]);
        const double ssum = sqrt(fro2 + 2.0 * ad);
        const double inv = ssum > 0.0 ? 1.0 / ssum : 0.0;
        const cplx n00 = cuCadd(M[0][0], cuCmul(phi, a00));
        const cplx n01 = cuCadd(M[0][1], cuCmul(phi, a01));
        const cplx n10 = cuCadd(M[1][0], cuCmul(phi, a10));
        const cplx n11 = cuCadd(M[1][1], cuCmul(phi, a11));
        M[0][0] = make_cuDoubleComplex(n00.x * inv, n00.y * inv);
        M[0][1] = make_cuDoubleComplex(n01.x * inv, n01.y * inv);
        M[1][0] = make_cuDoubleComplex(n10.x * inv, n10.y * inv);
        M[1][1] = make_cuDoubleComplex(n11.x * inv, n11.y * inv);
        // s1 - s2 = sqrt(|M|_F^2 - 2 |det|); s_min = |det| / s_max
        const double smax = 0.5 * (ssum + sqrt(fmax(fro2 - 2.0 * ad, 0.0)));
        return smax > 0.0 ? ad / smax : 0.0;
    }
}

// the most states of the team paths (link_polar.cuh), and a block's threads
constexpr int kPolarBlockMaxS = 64;
constexpr int kBlockThreads = 256;
// entries of an S x S matrix each thread holds while a product is formed in place
constexpr int kBlockEntries = kPolarBlockMaxS * kPolarBlockMaxS / kBlockThreads;

// A <- A B for S x S row-major matrices in shared memory (every thread of
// the block calls it; the block has kBlockThreads threads).
__device__ __forceinline__ void block_mul_left(cplx* A, const cplx* B, int S) {
    cplx acc[kBlockEntries];
#pragma unroll
    for (int i = 0; i < kBlockEntries; ++i) {
        const int e = threadIdx.x + i * kBlockThreads;
        if (e < S * S) {
            const int r = e / S, c = e % S;
            cplx a = make_cuDoubleComplex(0.0, 0.0);
            for (int k = 0; k < S; ++k) a = cuCadd(a, cuCmul(A[r * S + k], B[k * S + c]));
            acc[i] = a;
        }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kBlockEntries; ++i) {
        const int e = threadIdx.x + i * kBlockThreads;
        if (e < S * S) A[e] = acc[i];
    }
    __syncthreads();
}
