// The overlap and polar factor of one link, computed by a team of threads:
// a warp (kTeam 32, one warp a block) or a whole block (kTeam =
// kBlockThreads).  Used by kernel 5 (wilson_loop.cu) and kernel 14's
// chain (transport.cu), where every link of the grid is a team of its own.
//
// team_overlap forms M = <wa | wb> (S x S, rows of F components) in shared
// memory, staging chunks of both state panels there by cp.async; the
// panels' rows are either the first S rows of wa and wb (rows null) or
// rows[0..S) of them (kernel 14's selected states, gathered by the
// staging copies themselves; rows_b, where given, lists wb's).
// team_jacobi is the one-sided (Hestenes) Jacobi of polar.cuh on M's
// columns, giving M V = U diag(sigma), with the same rotation, tolerance
// and sweep limit; only the work split differs.  A sweep's S (S - 1) / 2
// column pairs run in S - 1 rounds of disjoint pairs (the circle
// ordering); each pair of a round takes G lanes of one warp, G the
// largest power of two with G * (pairs of a round) <= kTeam (at most 32),
// which split the S rows and sum over the group with xor shuffles.  A
// round ends in one team barrier: __syncwarp for a warp, __syncthreads
// for a block.  team_polar_store writes polar(M) = (M V) diag(1/sigma)
// V^H to device memory and returns the smallest sigma.
//
// Matrices are row-major with row stride ld (odd, so that lanes reading
// one column of consecutive rows, or consecutive rows of one column, hit
// different banks).
#pragma once

#include "polar.cuh"

template <int kTeam>
__device__ __forceinline__ void team_sync() {
    if constexpr (kTeam == 32) {
        __syncwarp();
    } else {
        __syncthreads();
    }
}

template <int kTeam>
__device__ __forceinline__ bool team_any(bool pred) {
    if constexpr (kTeam == 32) {
        return __any_sync(0xffffffffu, pred);
    } else {
        return __syncthreads_or(pred) != 0;
    }
}

// Row stride of an S x S matrix of kernel 5, and the staged-chunk
// width (odd) that two S-row panels of which fit in the V matrix's place.
__host__ __device__ inline int link_ld(int S) { return S | 1; }
__host__ __device__ inline int link_vld(int S) { return link_ld(S) > 30 ? link_ld(S) : 30; }
__host__ __device__ inline int link_chunk(int S) {
    const int c = link_vld(S) / 2;
    return c & 1 ? c : c - 1;
}
// Shared-memory bytes of one team: M (S x ld), V (S x vld, the staging
// area while M is formed), sigma and 1 / sigma (S doubles each).
__host__ __device__ inline size_t link_smem(int S) {
    return (size_t)S * (link_ld(S) + link_vld(S)) * sizeof(cplx) + 2 * (size_t)S * sizeof(double);
}

// M = <wa | wb>: M[n][m] = sum_f conj(wa[r_n][f]) wb[q_m][f], r_n = n
// (rows null) or rows[n], q_m = r_m or rows_b[m].  `stage` holds 2 S kc
// complex entries (kc = link_chunk(S)).
template <int kTeam>
__device__ void team_overlap(const cplx* __restrict__ wa, const cplx* __restrict__ wb, cplx* M, cplx* stage,
                             int S, int F, const int64_t* __restrict__ rows = nullptr,
                             const int64_t* __restrict__ rows_b = nullptr) {
    const int tt = threadIdx.x % kTeam;
    const int ld = link_ld(S), kc = link_chunk(S);
    cplx* A = stage;
    cplx* B = stage + S * kc;
    for (int e = tt; e < S * S; e += kTeam) M[(e / S) * ld + e % S] = make_cuDoubleComplex(0.0, 0.0);
    for (int f0 = 0; f0 < F; f0 += kc) {
        const int nf = min(kc, F - f0);
        for (int e = tt; e < 2 * S * nf; e += kTeam) {
            const int panel = e / (S * nf), rest = e % (S * nf);
            const int n = rest / nf, f = rest % nf;
            const int64_t r = rows ? (panel && rows_b ? rows_b[n] : rows[n]) : n;
            cp_async16((panel ? B : A) + n * kc + f, (panel ? wb : wa) + r * F + f0 + f);
        }
        cp_async_commit();
        cp_async_wait<0>();
        team_sync<kTeam>();
        for (int e = tt; e < S * S; e += kTeam) {
            const int n = e / S, m = e % S;
            double re = 0.0, im = 0.0;
            for (int f = 0; f < nf; ++f) {
                const cplx z = cmul_conj(A[n * kc + f], B[m * kc + f]);
                re += z.x;
                im += z.y;
            }
            cplx& out = M[n * ld + m];
            out = make_cuDoubleComplex(out.x + re, out.y + im);
        }
        team_sync<kTeam>();
    }
}

// One-sided Jacobi on the columns of M (S x S, stride ld); V (stride ld)
// accumulates the rotations.  Every thread of the team calls it.
template <int kTeam>
__device__ void team_jacobi(cplx* M, cplx* V, int S) {
    const int tt = threadIdx.x % kTeam;
    const int ld = link_ld(S);
    const int Se = S + (S & 1);
    const int npairs = Se / 2;
    int G = 1;
    while (G < 32 && 2 * G * npairs <= kTeam) G *= 2;
    const int k = tt / G, sub = tt % G;
    // the rounding of an S-term inner product stays below this cosine
    const double tol = kPolarTol * fmax(1.0, S / 8.0);
    for (int e = tt; e < S * S; e += kTeam)
        V[(e / S) * ld + e % S] = make_cuDoubleComplex(e / S == e % S ? 1.0 : 0.0, 0.0);
    team_sync<kTeam>();
    for (int sweep = 0; sweep < kPolarMaxSweeps; ++sweep) {
        bool rotated = false;
        for (int round = 0; round < Se - 1; ++round) {
            int p = 0, q = 0;
            bool active = k < npairs;
            if (active) {
                circle_pair(Se, round, k, p, q);
                active = q < S;  // the idle player of an odd S
            }
            double alpha = 0.0, beta = 0.0, gre = 0.0, gim = 0.0;
            if (active) {
                for (int r = sub; r < S; r += G) {
                    const cplx mp = M[r * ld + p], mq = M[r * ld + q];
                    alpha += mp.x * mp.x + mp.y * mp.y;
                    beta += mq.x * mq.x + mq.y * mq.y;
                    const cplx z = cmul_conj(mp, mq);
                    gre += z.x;
                    gim += z.y;
                }
            }
            // the group's sums: partners add the same two values, so every
            // lane of the group ends with the same bits
            for (int off = G / 2; off > 0; off >>= 1) {
                alpha += __shfl_xor_sync(0xffffffffu, alpha, off);
                beta += __shfl_xor_sync(0xffffffffu, beta, off);
                gre += __shfl_xor_sync(0xffffffffu, gre, off);
                gim += __shfl_xor_sync(0xffffffffu, gim, off);
            }
            const double g = hypot(gre, gim);
            if (active && g > tol * sqrt(alpha * beta)) {
                rotated = true;
                // rotation zeroing column p^H column q:
                //   p' = c p - s conj(e) q,  q' = s e p + c q,  e = gamma / |gamma|
                const double zeta = (beta - alpha) / (2.0 * g);
                const double t = (zeta >= 0.0 ? 1.0 : -1.0) / (fabs(zeta) + sqrt(1.0 + zeta * zeta));
                const double c = 1.0 / sqrt(1.0 + t * t);
                const double s = c * t;
                const double er = gre / g, ei = gim / g;
                for (int r = sub; r < S; r += G) {
                    const cplx mp = M[r * ld + p], mq = M[r * ld + q];
                    const double cq_x = er * mq.x + ei * mq.y, cq_y = er * mq.y - ei * mq.x;
                    const double ep_x = er * mp.x - ei * mp.y, ep_y = er * mp.y + ei * mp.x;
                    M[r * ld + p] = make_cuDoubleComplex(c * mp.x - s * cq_x, c * mp.y - s * cq_y);
                    M[r * ld + q] = make_cuDoubleComplex(s * ep_x + c * mq.x, s * ep_y + c * mq.y);
                    const cplx vp = V[r * ld + p], vq = V[r * ld + q];
                    const double vq_x = er * vq.x + ei * vq.y, vq_y = er * vq.y - ei * vq.x;
                    const double vp_x = er * vp.x - ei * vp.y, vp_y = er * vp.y + ei * vp.x;
                    V[r * ld + p] = make_cuDoubleComplex(c * vp.x - s * vq_x, c * vp.y - s * vq_y);
                    V[r * ld + q] = make_cuDoubleComplex(s * vp_x + c * vq.x, s * vp_y + c * vq.y);
                }
            }
            team_sync<kTeam>();
        }
        if (!team_any<kTeam>(rotated)) break;
    }
}

// After team_jacobi: out (S x S row-major, device memory) = polar(M) =
// sum_j (M V)_j / sigma_j V_j^H; sig (2 S doubles, shared) is scratch.
// Returns the smallest sigma in every thread of the team.
template <int kTeam>
__device__ double team_polar_store(const cplx* M, const cplx* V, int S, double* sig, cplx* __restrict__ out) {
    const int tt = threadIdx.x % kTeam;
    const int ld = link_ld(S);
    double* inv = sig + S;
    for (int j = tt; j < S; j += kTeam) {
        double n2 = 0.0;
        for (int r = 0; r < S; ++r) n2 += M[r * ld + j].x * M[r * ld + j].x + M[r * ld + j].y * M[r * ld + j].y;
        sig[j] = sqrt(n2);
        inv[j] = sig[j] > 0.0 ? 1.0 / sig[j] : 0.0;
    }
    team_sync<kTeam>();
    double smin = 1.0e300;
    for (int j = 0; j < S; ++j) smin = fmin(smin, sig[j]);
    for (int e = tt; e < S * S; e += kTeam) {
        const int r = e / S, c = e % S;
        double re = 0.0, im = 0.0;
        for (int j = 0; j < S; ++j) {
            const double ax = M[r * ld + j].x * inv[j], ay = M[r * ld + j].y * inv[j];
            const cplx v = V[c * ld + j];
            re += ax * v.x + ay * v.y;
            im += ay * v.x - ax * v.y;
        }
        out[e] = make_cuDoubleComplex(re, im);
    }
    return smin;
}
