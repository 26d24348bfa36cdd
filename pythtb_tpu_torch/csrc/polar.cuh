// The polar factor of a small complex matrix in registers, shared by
// kernel 5 (wilson_loop.cu) and kernel 14 (transport.cu).
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
