// Kernel 19: one Marzari-Vanderbilt maximal-localization step.
//
// Replaces the body of pythtb_tpu/wannier.py:_mv_localize (the lax.scan
// step of _build_loc_jit, _build_fine_jit and _build_disent_jit), which XLA
// fused into one program per step.  For nw Wannier functions on B k-points
// with nb neighbour vectors b (weights w_b, Cartesian b_cart (nb, dc)), raw
// overlaps M0 (B, nb, nw, nw), the gauge U (B, nw, nw) and the momentum dW,
// one step is three launches on the current stream and no host read:
//
//   overlaps (one thread per (k, b)): M(k, b) = U(k)^H M0(k, b) U(k + b),
//     stored, and per (k, b) the diagonal phases ang_n = arg M_nn, the sum of
//     |M|^2 and the sum of |M_nn|^2.
//   reduce (one block): fixed-order sums over every (k, b) -- each thread a
//     strided serial sum, then a shuffle and shared-memory tree, the same
//     order on every run (no atomics: a rounding change could flip the
//     step-size rule's branch) -- give the centres rbar_n = -(1/N) sum w_b b ang_n,
//     Omega_I = (1/N) sum w_b (nw - sum |M|^2), the off-diagonal spread and,
//     in a second pass with rbar known, the diagonal spread
//     (1/N) sum w_b (ang_n + b.rbar_n)^2.  With Omega = Omega_I + Omega~ the
//     step-size rule ("bold driver") runs on the device: eps *= 0.5 and the momentum resets if
//     Omega > Omega_prev, else eps *= 1.1; eps <= 20 eps0; Omega goes into
//     the history.
//   update (one thread per k): the gradient G = 4 sum_b w_b (A - S) of
//     pythtb_tpu's _mv_gradient, dW <- mu dW + eps G (mu reset to 0 on
//     overshoot), exp(dW) from the eigenpairs of the Hermitian i dW by cyclic
//     complex Jacobi in registers, U <- U exp(dW).
//
// A last overlaps + reduce pair (step = -1) gives the final centres and
// spreads without touching the step size.
//
// What bounds it on the H100: per step the bytes of M0, U, dW and M (the
// silicon coarse grid: 512 k x 8 b x 4 x 4 complex, about 1 MB), some 0.3 us
// at 3.35 TB/s -- far below the ~3 x 2-4 us of three launches, so the step
// is launch-bound; the one-block reduction and the serial Jacobi are the
// rest.  nw is a template parameter (1..8), so the small matrices stay in
// registers.  From 9 to 32 Wannier functions the same three launches run
// block kernels: overlaps a block per (k, b) and update a block per k,
// the nw x nw matrices in shared memory (48 kB for the update at 32) and
// their entries spread over 256 threads, the per-k exp(dW) by a parallel
// (Brent-Luk) Jacobi -- the same rotations as the register path, the
// disjoint pairs of a round applied at once -- and the reduction with its
// sums taken one quantity at a time.  Larger nw is refused.
#include "common.cuh"

constexpr int kMVMaxDC = 3;
constexpr int kMVReduceThreads = 256;
constexpr int kMVJacobiSweeps = 30;

// M(k, b) and the per-(k, b) pieces: part[row] = (ang_0..ang_{N-1}, sum|M|^2, sum|M_nn|^2)
template <int N>
__global__ void mv_overlaps_kernel(const cplx* __restrict__ M0, const int64_t* __restrict__ nbr,
                                   const cplx* __restrict__ U, cplx* __restrict__ Mout,
                                   double* __restrict__ part, int64_t rows, int64_t nb) {
    const int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= rows) return;
    const int64_t k = r / nb;
    const cplx* u = U + k * N * N;
    const cplx* v = U + nbr[r] * N * N;
    const cplx* m0 = M0 + r * N * N;
    // T = M0 U(k+b), then M = U(k)^H T
    cplx T[N][N];
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
        for (int j = 0; j < N; ++j) {
            cplx acc = make_cuDoubleComplex(0.0, 0.0);
#pragma unroll
            for (int l = 0; l < N; ++l) acc = cuCadd(acc, cuCmul(m0[i * N + l], v[l * N + j]));
            T[i][j] = acc;
        }
    double sall = 0.0, sdiag = 0.0;
    double* p = part + r * (N + 2);
    cplx* mo = Mout + r * N * N;
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
        for (int j = 0; j < N; ++j) {
            cplx acc = make_cuDoubleComplex(0.0, 0.0);
#pragma unroll
            for (int l = 0; l < N; ++l) acc = cuCadd(acc, cmul_conj(u[l * N + i], T[l][j]));
            mo[i * N + j] = acc;
            const double a2 = acc.x * acc.x + acc.y * acc.y;
            sall += a2;
            if (i == j) {
                sdiag += a2;
                p[i] = atan2(acc.y, acc.x);
            }
        }
    p[N] = sall;
    p[N + 1] = sdiag;
}

// sum of one double over the block, the same order on every run
__device__ double mv_block_sum(double x, double* red) {
    for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    __syncthreads();
    if (lane == 0) red[warp] = x;
    __syncthreads();
    double total = 0.0;
    for (int i = 0; i < (int)(blockDim.x >> 5); ++i) total += red[i];
    return total;
}

// scal: [0] eps, [1] Omega_prev, [2] momentum factor for the next update;
// fin: [0] Omega_I, [1] Omega~
template <int N>
__global__ void mv_reduce_kernel(const double* __restrict__ part, const double* __restrict__ w_b,
                                 const double* __restrict__ b_cart, double* __restrict__ scal,
                                 double* __restrict__ rbar_out, double* __restrict__ hist,
                                 double* __restrict__ fin, int64_t rows, int64_t nb, int dc,
                                 int64_t nk, double mu, double eps_cap, int64_t step) {
    __shared__ double red[32];
    __shared__ double rbar[kMVMaxDC * N];
    const int tid = threadIdx.x;
    double acc[kMVMaxDC * N + 2];
#pragma unroll
    for (int i = 0; i < kMVMaxDC * N + 2; ++i) acc[i] = 0.0;
    for (int64_t r = tid; r < rows; r += blockDim.x) {
        const int64_t b = r % nb;
        const double w = w_b[b];
        const double* p = part + r * (N + 2);
#pragma unroll
        for (int d = 0; d < kMVMaxDC; ++d) {
            if (d < dc) {
                const double wbd = w * b_cart[b * dc + d];
#pragma unroll
                for (int n = 0; n < N; ++n) acc[d * N + n] += wbd * p[n];
            }
        }
        acc[kMVMaxDC * N] += w * ((double)N - p[N]);
        acc[kMVMaxDC * N + 1] += w * (p[N] - p[N + 1]);
    }
    const double inv_n = 1.0 / (double)nk;
    for (int d = 0; d < dc; ++d)
        for (int n = 0; n < N; ++n) {
            const double s = mv_block_sum(acc[d * N + n], red);
            if (tid == 0) rbar[d * N + n] = -s * inv_n;
        }
    const double oi = mv_block_sum(acc[kMVMaxDC * N], red) * inv_n;
    const double od = mv_block_sum(acc[kMVMaxDC * N + 1], red) * inv_n;
    __syncthreads();  // rbar visible to every thread
    double q2 = 0.0;
    for (int64_t r = tid; r < rows; r += blockDim.x) {
        const int64_t b = r % nb;
        const double* p = part + r * (N + 2);
        double s = 0.0;
#pragma unroll
        for (int n = 0; n < N; ++n) {
            double q = p[n];
            for (int d = 0; d < dc; ++d) q += b_cart[b * dc + d] * rbar[d * N + n];
            s += q * q;
        }
        q2 += w_b[b] * s;
    }
    const double odiag = mv_block_sum(q2, red) * inv_n;
    if (tid == 0) {
        const double ot = od + odiag;
        const double om = oi + ot;
        for (int i = 0; i < dc * N; ++i) rbar_out[i] = rbar[i];
        fin[0] = oi;
        fin[1] = ot;
        if (step >= 0) {
            const bool up = om > scal[1];
            const double eps = fmin(up ? scal[0] * 0.5 : scal[0] * 1.1, eps_cap);
            scal[0] = eps;
            scal[1] = om;
            scal[2] = up ? 0.0 : mu;
            hist[step] = om;
        }
    }
}

// exp(X) of an anti-Hermitian X (in place) through the eigenpairs of i X
template <int N>
__device__ void expm_antiherm(cplx (&X)[N][N]) {
    cplx A[N][N], V[N][N];
    double fro2 = 0.0;
#pragma unroll
    for (int r = 0; r < N; ++r)
#pragma unroll
        for (int c = 0; c < N; ++c) {
            // (H + H^H) / 2 of H = i X
            const cplx h = make_cuDoubleComplex(-X[r][c].y, X[r][c].x);
            const cplx g = make_cuDoubleComplex(-X[c][r].y, X[c][r].x);
            A[r][c] = make_cuDoubleComplex(0.5 * (h.x + g.x), r == c ? 0.0 : 0.5 * (h.y - g.y));
            V[r][c] = make_cuDoubleComplex(r == c ? 1.0 : 0.0, 0.0);
            fro2 += A[r][c].x * A[r][c].x + A[r][c].y * A[r][c].y;
        }
    const double limit = 1.0e-30 * fro2;
    for (int sweep = 0; sweep < kMVJacobiSweeps; ++sweep) {
        double off = 0.0;
#pragma unroll
        for (int p = 0; p < N; ++p)
#pragma unroll
            for (int q = p + 1; q < N; ++q) off += A[p][q].x * A[p][q].x + A[p][q].y * A[p][q].y;
        if (!(off > limit)) break;
#pragma unroll
        for (int p = 0; p < N - 1; ++p) {
#pragma unroll
            for (int q = p + 1; q < N; ++q) {
                const cplx b = A[p][q];
                const double absb = hypot(b.x, b.y);
                if (!(absb > 0.0)) continue;
                const double app = A[p][p].x, aqq = A[q][q].x;
                const double nb100 = __dmul_rn(100.0, absb);
                if (__dadd_rn(nb100, fabs(app)) == fabs(app) && __dadd_rn(nb100, fabs(aqq)) == fabs(aqq)) {
                    A[p][q] = make_cuDoubleComplex(0.0, 0.0);
                    A[q][p] = make_cuDoubleComplex(0.0, 0.0);
                    continue;
                }
                const double tau = (aqq - app) / (2.0 * absb);
                const double t = (tau >= 0.0 ? 1.0 : -1.0) / (fabs(tau) + hypot(1.0, tau));
                const double c = 1.0 / sqrt(1.0 + t * t);
                const double s = t * c;
                const double er = b.x / absb, ei = b.y / absb;  // e = e^{i phi}
#pragma unroll
                for (int j = 0; j < N; ++j) {  // rows p, q
                    const cplx ap = A[p][j], aq = A[q][j];
                    const double eq_x = er * aq.x - ei * aq.y, eq_y = er * aq.y + ei * aq.x;  // e aq
                    A[p][j] = make_cuDoubleComplex(c * ap.x - s * eq_x, c * ap.y - s * eq_y);
                    A[q][j] = make_cuDoubleComplex(s * ap.x + c * eq_x, s * ap.y + c * eq_y);
                }
#pragma unroll
                for (int i = 0; i < N; ++i) {  // columns p, q of A and V
                    const cplx ap = A[i][p], aq = A[i][q];
                    const double cq_x = er * aq.x + ei * aq.y, cq_y = er * aq.y - ei * aq.x;  // conj(e) aq
                    A[i][p] = make_cuDoubleComplex(c * ap.x - s * cq_x, c * ap.y - s * cq_y);
                    A[i][q] = make_cuDoubleComplex(s * ap.x + c * cq_x, s * ap.y + c * cq_y);
                    const cplx vp = V[i][p], vq = V[i][q];
                    const double vq_x = er * vq.x + ei * vq.y, vq_y = er * vq.y - ei * vq.x;
                    V[i][p] = make_cuDoubleComplex(c * vp.x - s * vq_x, c * vp.y - s * vq_y);
                    V[i][q] = make_cuDoubleComplex(s * vp.x + c * vq_x, s * vp.y + c * vq_y);
                }
                A[p][p] = make_cuDoubleComplex(app - t * absb, 0.0);
                A[q][q] = make_cuDoubleComplex(aqq + t * absb, 0.0);
                A[p][q] = make_cuDoubleComplex(0.0, 0.0);
                A[q][p] = make_cuDoubleComplex(0.0, 0.0);
            }
        }
    }
    // exp(X) = V diag(e^{-i lambda}) V^H
    cplx ph[N];
#pragma unroll
    for (int j = 0; j < N; ++j) {
        double sn, cs;
        sincos(-A[j][j].x, &sn, &cs);
        ph[j] = make_cuDoubleComplex(cs, sn);
    }
#pragma unroll
    for (int r = 0; r < N; ++r)
#pragma unroll
        for (int c = 0; c < N; ++c) {
            cplx acc = make_cuDoubleComplex(0.0, 0.0);
#pragma unroll
            for (int j = 0; j < N; ++j) acc = cuCadd(acc, cuCmul(cuCmul(V[r][j], ph[j]), cconj(V[c][j])));
            X[r][c] = acc;
        }
}

template <int N>
__global__ void mv_update_kernel(const cplx* __restrict__ M, const double* __restrict__ w_b,
                                 const double* __restrict__ b_cart, const double* __restrict__ rbar,
                                 const double* __restrict__ scal, cplx* __restrict__ U,
                                 cplx* __restrict__ dW, int64_t nk, int64_t nb, int dc) {
    const int64_t k = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (k >= nk) return;
    cplx G[N][N];
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
        for (int j = 0; j < N; ++j) G[i][j] = make_cuDoubleComplex(0.0, 0.0);
    for (int64_t b = 0; b < nb; ++b) {
        const cplx* m = M + (k * nb + b) * N * N;
        const double w = w_b[b];
        cplx dn[N], tfac[N];  // conj(M_nn) and q_n / M_nn
#pragma unroll
        for (int n = 0; n < N; ++n) {
            const cplx mnn = m[n * N + n];
            double q = atan2(mnn.y, mnn.x);
            for (int d = 0; d < dc; ++d) q += b_cart[b * dc + d] * rbar[d * N + n];
            dn[n] = cconj(mnn);
            const cplx den = hypot(mnn.x, mnn.y) < 1e-12 ? make_cuDoubleComplex(1.0, 0.0) : mnn;
            tfac[n] = cuCdiv(make_cuDoubleComplex(q, 0.0), den);
        }
        // A - S with R_mn = M_mn conj(M_nn), T_mn = M_mn q_n / M_nn,
        // A = (R - R^H) / 2, S = (T + T^H) / 2i
#pragma unroll
        for (int i = 0; i < N; ++i)
#pragma unroll
            for (int j = 0; j < N; ++j) {
                const cplx mij = m[i * N + j], mji = m[j * N + i];
                const cplx rij = cuCmul(mij, dn[j]), rji = cuCmul(mji, dn[i]);
                const cplx tij = cuCmul(mij, tfac[j]), tji = cuCmul(mji, tfac[i]);
                // A_ij = (R_ij - conj(R_ji)) / 2
                const double ax = 0.5 * (rij.x - rji.x), ay = 0.5 * (rij.y + rji.y);
                // S_ij = (T_ij + conj(T_ji)) / 2i = -i (T_ij + conj(T_ji)) / 2
                const double sx = 0.5 * (tij.y - tji.y), sy = -0.5 * (tij.x + tji.x);
                G[i][j].x += w * (ax - sx);
                G[i][j].y += w * (ay - sy);
            }
    }
    const double eps = scal[0], fac = scal[2];
    cplx X[N][N];
    cplx* dw = dW + k * N * N;
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
        for (int j = 0; j < N; ++j) {
            const cplx d = dw[i * N + j];
            X[i][j] = make_cuDoubleComplex(fac * d.x + eps * 4.0 * G[i][j].x, fac * d.y + eps * 4.0 * G[i][j].y);
            dw[i * N + j] = X[i][j];
        }
    expm_antiherm<N>(X);
    cplx* u = U + k * N * N;
#pragma unroll
    for (int i = 0; i < N; ++i) {
        cplx row[N];
#pragma unroll
        for (int j = 0; j < N; ++j) {
            cplx acc = make_cuDoubleComplex(0.0, 0.0);
#pragma unroll
            for (int l = 0; l < N; ++l) acc = cuCadd(acc, cuCmul(u[i * N + l], X[l][j]));
            row[j] = acc;
        }
#pragma unroll
        for (int j = 0; j < N; ++j) u[i * N + j] = row[j];
    }
}

// -- block paths, 9 <= nw <= 32 ----------------------------------------------

constexpr int kMVBlockMaxN = 32;
constexpr int kMVBlockThreads = 256;
constexpr int kMVBlockEntries = kMVBlockMaxN * kMVBlockMaxN / kMVBlockThreads;  // 4

__global__ void __launch_bounds__(kMVBlockThreads)
mv_overlaps_block_kernel(const cplx* __restrict__ M0, const int64_t* __restrict__ nbr, const cplx* __restrict__ U,
                         cplx* __restrict__ Mout, double* __restrict__ part, int64_t nb, int n) {
    extern __shared__ double smem[];
    cplx* T = (cplx*)smem;
    __shared__ double red[32];
    const int tid = threadIdx.x;
    const int64_t r = blockIdx.x;  // the (k, b) row
    const int64_t k = r / nb;
    const cplx* u = U + k * n * n;
    const cplx* v = U + nbr[r] * n * n;
    const cplx* m0 = M0 + r * n * n;
    for (int e = tid; e < n * n; e += kMVBlockThreads) {
        const int i = e / n, j = e % n;
        cplx acc = make_cuDoubleComplex(0.0, 0.0);
        for (int l = 0; l < n; ++l) acc = cuCadd(acc, cuCmul(m0[i * n + l], v[l * n + j]));
        T[e] = acc;
    }
    __syncthreads();
    double* p = part + r * (n + 2);
    cplx* mo = Mout + r * n * n;
    double sall = 0.0, sdiag = 0.0;
    for (int e = tid; e < n * n; e += kMVBlockThreads) {
        const int i = e / n, j = e % n;
        cplx acc = make_cuDoubleComplex(0.0, 0.0);
        for (int l = 0; l < n; ++l) acc = cuCadd(acc, cmul_conj(u[l * n + i], T[l * n + j]));
        mo[e] = acc;
        const double a2 = acc.x * acc.x + acc.y * acc.y;
        sall += a2;
        if (i == j) {
            sdiag += a2;
            p[i] = atan2(acc.y, acc.x);
        }
    }
    sall = mv_block_sum(sall, red);
    sdiag = mv_block_sum(sdiag, red);
    if (tid == 0) {
        p[n] = sall;
        p[n + 1] = sdiag;
    }
}

// the reduction of mv_reduce_kernel with n a runtime size: each of the
// dc * n + 2 sums in its own pass over the rows (the same strided order)
__global__ void mv_reduce_block_kernel(const double* __restrict__ part, const double* __restrict__ w_b,
                                       const double* __restrict__ b_cart, double* __restrict__ scal,
                                       double* __restrict__ rbar_out, double* __restrict__ hist,
                                       double* __restrict__ fin, int64_t rows, int64_t nb, int n, int dc,
                                       int64_t nk, double mu, double eps_cap, int64_t step) {
    __shared__ double red[32];
    __shared__ double rbar[kMVMaxDC * kMVBlockMaxN];
    const int tid = threadIdx.x;
    const double inv_n = 1.0 / (double)nk;
    for (int qi = 0; qi < dc * n; ++qi) {
        const int d = qi / n, nn = qi % n;
        double acc = 0.0;
        for (int64_t r = tid; r < rows; r += blockDim.x) {
            const int64_t b = r % nb;
            acc += w_b[b] * b_cart[b * dc + d] * part[r * (n + 2) + nn];
        }
        const double s = mv_block_sum(acc, red);
        if (tid == 0) rbar[qi] = -s * inv_n;
    }
    double ai = 0.0, ad = 0.0;
    for (int64_t r = tid; r < rows; r += blockDim.x) {
        const int64_t b = r % nb;
        const double* p = part + r * (n + 2);
        ai += w_b[b] * ((double)n - p[n]);
        ad += w_b[b] * (p[n] - p[n + 1]);
    }
    const double oi = mv_block_sum(ai, red) * inv_n;
    const double od = mv_block_sum(ad, red) * inv_n;
    __syncthreads();  // rbar visible to every thread
    double q2 = 0.0;
    for (int64_t r = tid; r < rows; r += blockDim.x) {
        const int64_t b = r % nb;
        const double* p = part + r * (n + 2);
        double s = 0.0;
        for (int nn = 0; nn < n; ++nn) {
            double q = p[nn];
            for (int d = 0; d < dc; ++d) q += b_cart[b * dc + d] * rbar[d * n + nn];
            s += q * q;
        }
        q2 += w_b[b] * s;
    }
    const double odiag = mv_block_sum(q2, red) * inv_n;
    if (tid == 0) {
        const double ot = od + odiag;
        const double om = oi + ot;
        for (int i = 0; i < dc * n; ++i) rbar_out[i] = rbar[i];
        fin[0] = oi;
        fin[1] = ot;
        if (step >= 0) {
            const bool up = om > scal[1];
            const double eps = fmin(up ? scal[0] * 0.5 : scal[0] * 1.1, eps_cap);
            scal[0] = eps;
            scal[1] = om;
            scal[2] = up ? 0.0 : mu;
            hist[step] = om;
        }
    }
}

// exp(X) of the anti-Hermitian n x n X in shared memory (in place), through
// the eigenpairs of i X by a parallel cyclic Jacobi: each round's disjoint
// pairs (the circle ordering) get their rotations from the round's start,
// then all row rotations, all column rotations, the 2 x 2 fix-ups.  A and
// V are n x n shared scratch; prm holds 8 doubles a pair.
__device__ void expm_antiherm_block(cplx* X, cplx* A, cplx* V, double* prm, int* act, double* red, int n) {
    const int tid = threadIdx.x;
    double fro = 0.0;
    for (int e = tid; e < n * n; e += kMVBlockThreads) {
        const int r = e / n, c = e % n;
        const cplx h = make_cuDoubleComplex(-X[r * n + c].y, X[r * n + c].x);  // (i X)_rc
        const cplx g = make_cuDoubleComplex(-X[c * n + r].y, X[c * n + r].x);
        A[e] = make_cuDoubleComplex(0.5 * (h.x + g.x), r == c ? 0.0 : 0.5 * (h.y - g.y));
        V[e] = make_cuDoubleComplex(r == c ? 1.0 : 0.0, 0.0);
        fro += A[e].x * A[e].x + A[e].y * A[e].y;
    }
    const double limit = 1.0e-30 * mv_block_sum(fro, red);
    const int Se = n + (n & 1), npair = Se / 2;
    for (int sweep = 0; sweep < kMVJacobiSweeps; ++sweep) {
        double off = 0.0;
        for (int e = tid; e < n * n; e += kMVBlockThreads) {
            const int p = e / n, q = e % n;
            if (q > p) off += A[e].x * A[e].x + A[e].y * A[e].y;
        }
        if (!(mv_block_sum(off, red) > limit)) break;  // the same total in every thread
        for (int round = 0; round < Se - 1; ++round) {
            // the rotation of each pair: act 0 skip, 1 zero the pair, 2 rotate
            for (int k = tid; k < npair; k += kMVBlockThreads) {
                int p, q;
                circle_pair(Se, round, k, p, q);
                act[k] = 0;
                if (q >= n) continue;
                const cplx b = A[p * n + q];
                const double absb = hypot(b.x, b.y);
                if (!(absb > 0.0)) continue;
                const double app = A[p * n + p].x, aqq = A[q * n + q].x;
                const double nb100 = __dmul_rn(100.0, absb);
                if (__dadd_rn(nb100, fabs(app)) == fabs(app) && __dadd_rn(nb100, fabs(aqq)) == fabs(aqq)) {
                    act[k] = 1;
                    continue;
                }
                const double tau = (aqq - app) / (2.0 * absb);
                const double t = (tau >= 0.0 ? 1.0 : -1.0) / (fabs(tau) + hypot(1.0, tau));
                const double c = 1.0 / sqrt(1.0 + t * t);
                double* pr = prm + 8 * k;
                pr[0] = c;
                pr[1] = t * c;
                pr[2] = b.x / absb;
                pr[3] = b.y / absb;
                pr[4] = app - t * absb;
                pr[5] = aqq + t * absb;
                act[k] = 2;
            }
            __syncthreads();
            // rows p, q of A
            for (int e = tid; e < npair * n; e += kMVBlockThreads) {
                const int k = e / n, j = e % n;
                if (act[k] != 2) continue;
                int p, q;
                circle_pair(Se, round, k, p, q);
                const double* pr = prm + 8 * k;
                const double c = pr[0], s = pr[1], er = pr[2], ei = pr[3];
                const cplx ap = A[p * n + j], aq = A[q * n + j];
                const double eq_x = er * aq.x - ei * aq.y, eq_y = er * aq.y + ei * aq.x;  // e aq
                A[p * n + j] = make_cuDoubleComplex(c * ap.x - s * eq_x, c * ap.y - s * eq_y);
                A[q * n + j] = make_cuDoubleComplex(s * ap.x + c * eq_x, s * ap.y + c * eq_y);
            }
            __syncthreads();
            // columns p, q of A and V
            for (int e = tid; e < npair * n; e += kMVBlockThreads) {
                const int k = e / n, i = e % n;
                if (act[k] != 2) continue;
                int p, q;
                circle_pair(Se, round, k, p, q);
                const double* pr = prm + 8 * k;
                const double c = pr[0], s = pr[1], er = pr[2], ei = pr[3];
                const cplx ap = A[i * n + p], aq = A[i * n + q];
                const double cq_x = er * aq.x + ei * aq.y, cq_y = er * aq.y - ei * aq.x;  // conj(e) aq
                A[i * n + p] = make_cuDoubleComplex(c * ap.x - s * cq_x, c * ap.y - s * cq_y);
                A[i * n + q] = make_cuDoubleComplex(s * ap.x + c * cq_x, s * ap.y + c * cq_y);
                const cplx vp = V[i * n + p], vq = V[i * n + q];
                const double vq_x = er * vq.x + ei * vq.y, vq_y = er * vq.y - ei * vq.x;
                V[i * n + p] = make_cuDoubleComplex(c * vp.x - s * vq_x, c * vp.y - s * vq_y);
                V[i * n + q] = make_cuDoubleComplex(s * vp.x + c * vq_x, s * vp.y + c * vq_y);
            }
            __syncthreads();
            for (int k = tid; k < npair; k += kMVBlockThreads) {
                if (act[k] == 0) continue;
                int p, q;
                circle_pair(Se, round, k, p, q);
                if (act[k] == 2) {
                    A[p * n + p] = make_cuDoubleComplex(prm[8 * k + 4], 0.0);
                    A[q * n + q] = make_cuDoubleComplex(prm[8 * k + 5], 0.0);
                }
                A[p * n + q] = make_cuDoubleComplex(0.0, 0.0);
                A[q * n + p] = make_cuDoubleComplex(0.0, 0.0);
            }
            __syncthreads();
        }
    }
    // exp(X) = V diag(e^{-i lambda}) V^H
    for (int e = tid; e < n * n; e += kMVBlockThreads) {
        const int r = e / n, c = e % n;
        cplx acc = make_cuDoubleComplex(0.0, 0.0);
        for (int j = 0; j < n; ++j) {
            double sn, cs;
            sincos(-A[j * n + j].x, &sn, &cs);
            acc = cuCadd(acc, cuCmul(cuCmul(V[r * n + j], make_cuDoubleComplex(cs, sn)), cconj(V[c * n + j])));
        }
        X[e] = acc;
    }
    __syncthreads();
}

__global__ void __launch_bounds__(kMVBlockThreads)
mv_update_block_kernel(const cplx* __restrict__ M, const double* __restrict__ w_b, const double* __restrict__ b_cart,
                       const double* __restrict__ rbar, const double* __restrict__ scal, cplx* __restrict__ U,
                       cplx* __restrict__ dW, int64_t nb, int n, int dc) {
    extern __shared__ double smem[];
    cplx* X = (cplx*)smem;
    cplx* A = X + n * n;
    cplx* V = A + n * n;
    cplx* dn = V + n * n;     // conj(M_nn)
    cplx* tfac = dn + n;      // q_n / M_nn
    double* prm = (double*)(tfac + n);  // 8 a pair
    int* act = (int*)(prm + 8 * (kMVBlockMaxN / 2));
    __shared__ double red[32];
    const int tid = threadIdx.x;
    const int64_t k = blockIdx.x;
    cplx G[kMVBlockEntries];
#pragma unroll
    for (int i = 0; i < kMVBlockEntries; ++i) G[i] = make_cuDoubleComplex(0.0, 0.0);
    for (int64_t b = 0; b < nb; ++b) {
        const cplx* m = M + (k * nb + b) * n * n;
        const double w = w_b[b];
        for (int nn = tid; nn < n; nn += kMVBlockThreads) {
            const cplx mnn = m[nn * n + nn];
            double q = atan2(mnn.y, mnn.x);
            for (int d = 0; d < dc; ++d) q += b_cart[b * dc + d] * rbar[d * n + nn];
            dn[nn] = cconj(mnn);
            const cplx den = hypot(mnn.x, mnn.y) < 1e-12 ? make_cuDoubleComplex(1.0, 0.0) : mnn;
            tfac[nn] = cuCdiv(make_cuDoubleComplex(q, 0.0), den);
        }
        __syncthreads();
#pragma unroll
        for (int ii = 0; ii < kMVBlockEntries; ++ii) {
            const int e = tid + ii * kMVBlockThreads;
            if (e < n * n) {
                const int i = e / n, j = e % n;
                const cplx mij = m[i * n + j], mji = m[j * n + i];
                const cplx rij = cuCmul(mij, dn[j]), rji = cuCmul(mji, dn[i]);
                const cplx tij = cuCmul(mij, tfac[j]), tji = cuCmul(mji, tfac[i]);
                const double ax = 0.5 * (rij.x - rji.x), ay = 0.5 * (rij.y + rji.y);
                const double sx = 0.5 * (tij.y - tji.y), sy = -0.5 * (tij.x + tji.x);
                G[ii].x += w * (ax - sx);
                G[ii].y += w * (ay - sy);
            }
        }
        __syncthreads();
    }
    const double eps = scal[0], fac = scal[2];
    cplx* dw = dW + k * n * n;
#pragma unroll
    for (int ii = 0; ii < kMVBlockEntries; ++ii) {
        const int e = tid + ii * kMVBlockThreads;
        if (e < n * n) {
            const cplx d = dw[e];
            X[e] = make_cuDoubleComplex(fac * d.x + eps * 4.0 * G[ii].x, fac * d.y + eps * 4.0 * G[ii].y);
            dw[e] = X[e];
        }
    }
    __syncthreads();
    expm_antiherm_block(X, A, V, prm, act, red, n);
    // U <- U exp(dW), formed in registers then stored
    cplx* u = U + k * n * n;
    cplx acc[kMVBlockEntries];
#pragma unroll
    for (int ii = 0; ii < kMVBlockEntries; ++ii) {
        const int e = tid + ii * kMVBlockThreads;
        if (e < n * n) {
            const int i = e / n, j = e % n;
            cplx a = make_cuDoubleComplex(0.0, 0.0);
            for (int l = 0; l < n; ++l) a = cuCadd(a, cuCmul(u[i * n + l], X[l * n + j]));
            acc[ii] = a;
        }
    }
    __syncthreads();
#pragma unroll
    for (int ii = 0; ii < kMVBlockEntries; ++ii) {
        const int e = tid + ii * kMVBlockThreads;
        if (e < n * n) u[e] = acc[ii];
    }
}

static size_t mv_update_smem(int n) {
    return (size_t)(3 * n * n + 2 * n) * sizeof(cplx) + 8 * (kMVBlockMaxN / 2) * sizeof(double) +
           (kMVBlockMaxN / 2) * sizeof(int);
}

#define PYTHTB_MV_DISPATCH(N, CALL)              \
    switch (N) {                                 \
        case 1: CALL(1); break;                  \
        case 2: CALL(2); break;                  \
        case 3: CALL(3); break;                  \
        case 4: CALL(4); break;                  \
        case 5: CALL(5); break;                  \
        case 6: CALL(6); break;                  \
        case 7: CALL(7); break;                  \
        case 8: CALL(8); break;                  \
        default: return (int)cudaErrorInvalidValue; \
    }

extern "C" int pythtb_mv_overlaps(const void* M0, const void* nbr, const void* U, void* M,
                                  void* part, int64_t nk, int64_t nb, int64_t n, void* stream) {
    const int64_t rows = nk * nb;
    if (rows <= 0) return (int)cudaGetLastError();
    cudaStream_t st = (cudaStream_t)stream;
    if (n > 8) {
        if (n > kMVBlockMaxN) return (int)cudaErrorInvalidValue;
        mv_overlaps_block_kernel<<<(unsigned int)rows, kMVBlockThreads, n * n * sizeof(cplx), st>>>(
            (const cplx*)M0, (const int64_t*)nbr, (const cplx*)U, (cplx*)M, (double*)part, nb, (int)n);
        return (int)cudaGetLastError();
    }
#define OVERLAPS(K)                                                                          \
    mv_overlaps_kernel<K><<<blocks_for(rows), kThreads, 0, st>>>(                            \
        (const cplx*)M0, (const int64_t*)nbr, (const cplx*)U, (cplx*)M, (double*)part, rows, nb)
    PYTHTB_MV_DISPATCH(n, OVERLAPS)
#undef OVERLAPS
    return (int)cudaGetLastError();
}

extern "C" int pythtb_mv_reduce(const void* part, const void* w_b, const void* b_cart, void* scal,
                                void* rbar, void* hist, void* fin, int64_t nk, int64_t nb, int64_t n,
                                int64_t dc, double mu, double eps_cap, int64_t step, void* stream) {
    if (dc < 1 || dc > kMVMaxDC) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    if (n > 8) {
        if (n > kMVBlockMaxN) return (int)cudaErrorInvalidValue;
        mv_reduce_block_kernel<<<1, kMVReduceThreads, 0, st>>>(
            (const double*)part, (const double*)w_b, (const double*)b_cart, (double*)scal, (double*)rbar,
            (double*)hist, (double*)fin, nk * nb, nb, (int)n, (int)dc, nk, mu, eps_cap, step);
        return (int)cudaGetLastError();
    }
#define REDUCE(K)                                                                                \
    mv_reduce_kernel<K><<<1, kMVReduceThreads, 0, st>>>(                                         \
        (const double*)part, (const double*)w_b, (const double*)b_cart, (double*)scal,           \
        (double*)rbar, (double*)hist, (double*)fin, nk * nb, nb, (int)dc, nk, mu, eps_cap, step)
    PYTHTB_MV_DISPATCH(n, REDUCE)
#undef REDUCE
    return (int)cudaGetLastError();
}

extern "C" int pythtb_mv_update(const void* M, const void* w_b, const void* b_cart, const void* rbar,
                                const void* scal, void* U, void* dW, int64_t nk, int64_t nb,
                                int64_t n, int64_t dc, void* stream) {
    if (nk <= 0) return (int)cudaGetLastError();
    cudaStream_t st = (cudaStream_t)stream;
    if (n > 8) {
        if (n > kMVBlockMaxN) return (int)cudaErrorInvalidValue;
        const size_t smem = mv_update_smem((int)n);
        cudaFuncSetAttribute(mv_update_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        mv_update_block_kernel<<<(unsigned int)nk, kMVBlockThreads, smem, st>>>(
            (const cplx*)M, (const double*)w_b, (const double*)b_cart, (const double*)rbar, (const double*)scal,
            (cplx*)U, (cplx*)dW, nb, (int)n, (int)dc);
        return (int)cudaGetLastError();
    }
#define UPDATE(K)                                                                                \
    mv_update_kernel<K><<<blocks_for(nk), kThreads, 0, st>>>(                                    \
        (const cplx*)M, (const double*)w_b, (const double*)b_cart, (const double*)rbar,          \
        (const double*)scal, (cplx*)U, (cplx*)dW, nk, nb, (int)dc)
    PYTHTB_MV_DISPATCH(n, UPDATE)
#undef UPDATE
    return (int)cudaGetLastError();
}
