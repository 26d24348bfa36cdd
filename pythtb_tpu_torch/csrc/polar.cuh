// The polar factor of a small complex matrix in registers, for kernel 14
// (transport.cu).
//
// polar_factor<S>(M) overwrites M (S x S) with U V^H, where M = U diag(s) V^H,
// and returns the smallest singular value:
//   S = 1: M / |M|;
//   S = 2: closed form U = (M + phi adj(M)^H) / (s1 + s2), phi = det/|det|,
//          s1 + s2 = sqrt(|M|_F^2 + 2 |det M|);
//   3 <= S <= 8: one-sided (Hestenes) Jacobi on the columns of M -- the
//          Jacobi eigensolve of M^H M carried out on M itself, so the
//          condition number is not squared -- giving M V = U S, and
//          polar(M) = (M V) S^-1 V^H.
//
// polar_factor_block(M, V, S, red) is the same algorithm for one matrix
// of up to kPolarBlockMaxS = 64 rows in shared memory, run by a whole
// block of kBlockThreads threads: each sweep visits the S (S - 1) / 2
// column pairs in S - 1 rounds of disjoint pairs (the circle ordering),
// a warp per pair, so the pairs of a round rotate at once.  Kernel 14's
// large-S paths (9 <= S <= 64) call it; kernel 5 has its own
// (link_polar.cuh) and multiplies its chains with block_mul_left.
#pragma once

#include "common.cuh"

constexpr int kPolarMaxSweeps = 40;
constexpr double kPolarTol = 1.0e-15;

// Overwrites M with its polar factor; returns its smallest singular value.
template <int S>
__device__ __forceinline__ double polar_factor(cplx (&M)[S][S]) {
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
    } else {
        cplx V[S][S];
#pragma unroll
        for (int r = 0; r < S; ++r)
#pragma unroll
            for (int c = 0; c < S; ++c) V[r][c] = make_cuDoubleComplex(r == c ? 1.0 : 0.0, 0.0);
        for (int sweep = 0; sweep < kPolarMaxSweeps; ++sweep) {
            bool rotated = false;
#pragma unroll
            for (int p = 0; p < S - 1; ++p) {
#pragma unroll
                for (int q = p + 1; q < S; ++q) {
                    double alpha = 0.0, beta = 0.0, gre = 0.0, gim = 0.0;
#pragma unroll
                    for (int r = 0; r < S; ++r) {
                        alpha += M[r][p].x * M[r][p].x + M[r][p].y * M[r][p].y;
                        beta += M[r][q].x * M[r][q].x + M[r][q].y * M[r][q].y;
                        const cplx z = cmul_conj(M[r][p], M[r][q]);
                        gre += z.x;
                        gim += z.y;
                    }
                    const double g = hypot(gre, gim);
                    if (!(g > kPolarTol * sqrt(alpha * beta))) continue;
                    rotated = true;
                    // rotation zeroing column p^H column q:
                    //   p' = c p - s conj(e) q,  q' = s e p + c q,  e = gamma / |gamma|
                    const double zeta = (beta - alpha) / (2.0 * g);
                    const double t = (zeta >= 0.0 ? 1.0 : -1.0) / (fabs(zeta) + sqrt(1.0 + zeta * zeta));
                    const double c = 1.0 / sqrt(1.0 + t * t);
                    const double s = c * t;
                    const double er = gre / g, ei = gim / g;
#pragma unroll
                    for (int r = 0; r < S; ++r) {
                        const cplx mp = M[r][p], mq = M[r][q];
                        // conj(e) * mq and e * mp
                        const double cq_x = er * mq.x + ei * mq.y, cq_y = er * mq.y - ei * mq.x;
                        const double ep_x = er * mp.x - ei * mp.y, ep_y = er * mp.y + ei * mp.x;
                        M[r][p] = make_cuDoubleComplex(c * mp.x - s * cq_x, c * mp.y - s * cq_y);
                        M[r][q] = make_cuDoubleComplex(s * ep_x + c * mq.x, s * ep_y + c * mq.y);
                        const cplx vp = V[r][p], vq = V[r][q];
                        const double vq_x = er * vq.x + ei * vq.y, vq_y = er * vq.y - ei * vq.x;
                        const double vp_x = er * vp.x - ei * vp.y, vp_y = er * vp.y + ei * vp.x;
                        V[r][p] = make_cuDoubleComplex(c * vp.x - s * vq_x, c * vp.y - s * vq_y);
                        V[r][q] = make_cuDoubleComplex(s * vp_x + c * vq.x, s * vp_y + c * vq.y);
                    }
                }
            }
            if (!rotated) break;
        }
        // M now holds M V = U diag(sigma): polar(M) = sum_j (M V)_j / sigma_j V_j^H
        double inv[S];
        double smin = 1.0e300;
#pragma unroll
        for (int j = 0; j < S; ++j) {
            double n2 = 0.0;
#pragma unroll
            for (int r = 0; r < S; ++r) n2 += M[r][j].x * M[r][j].x + M[r][j].y * M[r][j].y;
            const double sig = sqrt(n2);
            smin = fmin(smin, sig);
            inv[j] = sig > 0.0 ? 1.0 / sig : 0.0;
        }
#pragma unroll
        for (int r = 0; r < S; ++r) {
            cplx row[S];
#pragma unroll
            for (int c = 0; c < S; ++c) {
                double re = 0.0, im = 0.0;
#pragma unroll
                for (int j = 0; j < S; ++j) {
                    // (M V)[r][j] * inv[j] * conj(V[c][j])
                    const double ax = M[r][j].x * inv[j], ay = M[r][j].y * inv[j];
                    re += ax * V[c][j].x + ay * V[c][j].y;
                    im += ay * V[c][j].x - ax * V[c][j].y;
                }
                row[c] = make_cuDoubleComplex(re, im);
            }
#pragma unroll
            for (int c = 0; c < S; ++c) M[r][c] = row[c];
        }
        return smin;
    }
}

// -- block-level path, 9 <= S <= 64 --------------------------------------

constexpr int kPolarBlockMaxS = 64;
constexpr int kBlockThreads = 256;  // threads of a large-S block (8 warps)
// entries of an S x S matrix each thread holds while a product is formed in place
constexpr int kBlockEntries = kPolarBlockMaxS * kPolarBlockMaxS / kBlockThreads;
// doubles of the scratch `red` that polar_factor_block needs
constexpr int kPolarRed = kPolarBlockMaxS + 2;

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

// Sum over a warp, the same value in every lane (lane 0's, broadcast).
__device__ __forceinline__ double warp_sum(double x) {
    for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
    return __shfl_sync(0xffffffffu, x, 0);
}

// Overwrites the S x S matrix M (row-major, shared memory) with its polar
// factor; V (S x S, shared) is scratch and red (kPolarRed doubles, shared)
// too.  Returns the smallest singular value in every thread.  Every thread
// of the block (kBlockThreads) calls it; M must be visible to all of them.
static __device__ double polar_factor_block(cplx* M, cplx* V, int S, double* red) {
    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5, nwarps = kBlockThreads >> 5;
    int* flag = (int*)(red + kPolarBlockMaxS + 1);
    for (int e = tid; e < S * S; e += kBlockThreads)
        V[e] = make_cuDoubleComplex(e / S == e % S ? 1.0 : 0.0, 0.0);
    const int Se = S + (S & 1);
    // the rounding of an S-term inner product stays below this cosine
    const double tol = kPolarTol * fmax(1.0, S / 8.0);
    for (int sweep = 0; sweep < kPolarMaxSweeps; ++sweep) {
        if (tid == 0) *flag = 0;
        __syncthreads();
        for (int round = 0; round < Se - 1; ++round) {
            for (int k = warp; k < Se / 2; k += nwarps) {
                int p, q;
                circle_pair(Se, round, k, p, q);
                if (q >= S) continue;  // the idle player of an odd S (warp-uniform)
                double alpha = 0.0, beta = 0.0, gre = 0.0, gim = 0.0;
                for (int r = lane; r < S; r += 32) {
                    const cplx mp = M[r * S + p], mq = M[r * S + q];
                    alpha += mp.x * mp.x + mp.y * mp.y;
                    beta += mq.x * mq.x + mq.y * mq.y;
                    const cplx z = cmul_conj(mp, mq);
                    gre += z.x;
                    gim += z.y;
                }
                alpha = warp_sum(alpha);
                beta = warp_sum(beta);
                gre = warp_sum(gre);
                gim = warp_sum(gim);
                const double g = hypot(gre, gim);
                if (!(g > tol * sqrt(alpha * beta))) continue;  // warp-uniform
                if (lane == 0) *flag = 1;
                const double zeta = (beta - alpha) / (2.0 * g);
                const double t = (zeta >= 0.0 ? 1.0 : -1.0) / (fabs(zeta) + sqrt(1.0 + zeta * zeta));
                const double c = 1.0 / sqrt(1.0 + t * t);
                const double s = c * t;
                const double er = gre / g, ei = gim / g;
                for (int r = lane; r < S; r += 32) {
                    const cplx mp = M[r * S + p], mq = M[r * S + q];
                    const double cq_x = er * mq.x + ei * mq.y, cq_y = er * mq.y - ei * mq.x;
                    const double ep_x = er * mp.x - ei * mp.y, ep_y = er * mp.y + ei * mp.x;
                    M[r * S + p] = make_cuDoubleComplex(c * mp.x - s * cq_x, c * mp.y - s * cq_y);
                    M[r * S + q] = make_cuDoubleComplex(s * ep_x + c * mq.x, s * ep_y + c * mq.y);
                    const cplx vp = V[r * S + p], vq = V[r * S + q];
                    const double vq_x = er * vq.x + ei * vq.y, vq_y = er * vq.y - ei * vq.x;
                    const double vp_x = er * vp.x - ei * vp.y, vp_y = er * vp.y + ei * vp.x;
                    V[r * S + p] = make_cuDoubleComplex(c * vp.x - s * vq_x, c * vp.y - s * vq_y);
                    V[r * S + q] = make_cuDoubleComplex(s * vp_x + c * vq.x, s * vp_y + c * vq.y);
                }
            }
            __syncthreads();
        }
        const int rotated = *flag;
        __syncthreads();
        if (!rotated) break;
    }
    // M now holds M V = U diag(sigma): sigma_j into red[j]
    for (int j = tid; j < S; j += kBlockThreads) {
        double n2 = 0.0;
        for (int r = 0; r < S; ++r) n2 += M[r * S + j].x * M[r * S + j].x + M[r * S + j].y * M[r * S + j].y;
        red[j] = sqrt(n2);
    }
    __syncthreads();
    if (tid == 0) {
        double smin = 1.0e300;
        for (int j = 0; j < S; ++j) smin = fmin(smin, red[j]);
        red[kPolarBlockMaxS] = smin;
    }
    // polar(M) = sum_j (M V)_j / sigma_j V_j^H, formed in registers, then stored
    cplx acc[kBlockEntries];
#pragma unroll
    for (int i = 0; i < kBlockEntries; ++i) {
        const int e = tid + i * kBlockThreads;
        if (e < S * S) {
            const int r = e / S, c = e % S;
            double re = 0.0, im = 0.0;
            for (int j = 0; j < S; ++j) {
                const double inv = red[j] > 0.0 ? 1.0 / red[j] : 0.0;
                const double ax = M[r * S + j].x * inv, ay = M[r * S + j].y * inv;
                const cplx v = V[c * S + j];
                re += ax * v.x + ay * v.y;
                im += ay * v.x - ax * v.y;
            }
            acc[i] = make_cuDoubleComplex(re, im);
        }
    }
    __syncthreads();
    const double smin = red[kPolarBlockMaxS];
#pragma unroll
    for (int i = 0; i < kBlockEntries; ++i) {
        const int e = tid + i * kBlockThreads;
        if (e < S * S) M[e] = acc[i];
    }
    __syncthreads();
    return smin;
}

// Dynamic shared memory of a block holding `mats` S x S complex matrices
// and the polar scratch; sets the kernel's limit where it exceeds 48 kB.
template <typename Kernel>
static inline size_t block_smem(Kernel kernel, int S, int mats, size_t extra = 0) {
    const size_t bytes = (size_t)mats * S * S * sizeof(cplx) + kPolarRed * sizeof(double) + extra;
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    return bytes;
}
