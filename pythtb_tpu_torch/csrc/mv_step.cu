// Kernel 19: Marzari-Vanderbilt maximal localization, a whole run of steps.
//
// Replaces the body of pythtb_tpu/wannier.py:_mv_localize (the lax.scan
// step of _build_loc_jit, _build_fine_jit and _build_disent_jit), which XLA
// fused into one program per step.  For nw Wannier functions on B k-points
// with nb neighbour vectors b (weights w_b, Cartesian b_cart (nb, dc)), raw
// overlaps M0 (B, nb, nw, nw), the gauge U (B, nw, nw) and the momentum dW,
// one step is:
//
//   overlaps: M(k, b) = U(k)^H M0(k, b) U(k + b), stored, and per (k, b)
//     the diagonal phases ang_n = arg M_nn, the sum of |M|^2 and the sum of
//     |M_nn|^2;
//   reduce: fixed-order sums over every (k, b) give the centres
//     rbar_n = -(1/N) sum w_b b ang_n, Omega_I = (1/N) sum w_b (nw - sum
//     |M|^2), the off-diagonal spread and, in a second pass with rbar known,
//     the diagonal spread (1/N) sum w_b (ang_n + b.rbar_n)^2.  With Omega =
//     Omega_I + Omega~ the step-size rule ("bold driver") runs on the
//     device: eps *= 0.5 and the momentum resets if Omega > Omega_prev,
//     else eps *= 1.1; eps <= 20 eps0; Omega goes into the history;
//   update: the gradient G = 4 sum_b w_b (A - S) of pythtb_tpu's
//     _mv_gradient, dW <- mu dW + eps G (mu reset to 0 on overshoot), exp(dW)
//     from the eigenpairs of the Hermitian i dW by complex Jacobi, U <- U
//     exp(dW).
//
// A closing overlaps + reduce pair gives the final centres and spreads
// without touching the step size.  The sums run in an order fixed by the
// launch's shape and never by scheduling (no floating-point atomics): a
// rounding change could flip the step-size rule's branch.
//
// What bounds it on the H100: per step the bytes of M0, U, dW and M (the
// silicon coarse grid: 512 k x 8 b x 4 x 4 complex, about 1 MB), some 0.3 us
// at 3.35 TB/s; the work is a few hundred complex products a k.  So a step
// is latency: of its launches, of its reductions across the card, and of
// each k's serial Jacobi.
//
// Design, nw <= 8 (the run kernel): the whole run is one cooperative launch
// of the blocks of four warps that fit the card at once, each phase spread
// over every SM the launch holds and the phases separated by
// cooperative_groups' grid barrier -- three a step (after the overlaps,
// after the second pass, after the update).  A warp takes a k (its nb rows
// of overlaps, its gradient, exp(dW) and U exp(dW)), lanes owning matrix
// entries and the warp's small matrices in shared memory.  The rows' inputs
// of a chunk of b-vectors (M0 and the neighbours' U in the overlaps, M in
// the gradient) are copied by cp.async at once, so a warp waits on L2 once
// a chunk and not once a row; each lane keeps its share of the
// sums in registers until the warp's k-points are done; the gradient takes
// the phases stored by the overlaps and forms every (b, n) factor of a k at
// once, a lane a pair; the Jacobi applies each round's disjoint pairs (the
// circle ordering) at once and ends a step of it in a __syncwarp.  Each
// block writes its partial sums in block order; every block then sums all
// the partials in block order (the same bits in every block), so no block
// waits on another for the step size, which every block carries alike.
// The data crossing blocks (U, the partial sums) is read through L2
// (cp.async.cg, __ldcg).  One thread-block cluster of at most 16 blocks with the
// cluster's barrier in place of the grid's was slower at every shape
// measured (PERF.md section 6).
//
// From 9 to 32 Wannier functions three launches a step run block kernels:
// overlaps a block per (k, b) and update a block per k, the nw x nw
// matrices in shared memory (48 kB for the update at 32) and their entries
// spread over 256 threads, the per-k exp(dW) by the same parallel
// (Brent-Luk) Jacobi, and the reduction with its sums taken one quantity at
// a time in one block.  Larger nw is refused.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

constexpr int kMVMaxDC = 3;
constexpr int kMVReduceThreads = 256;
constexpr int kMVJacobiSweeps = 30;
constexpr int kMVRunMaxN = 8;                    // the run kernel's largest nw
constexpr int kMVQ = kMVMaxDC * kMVRunMaxN + 2;  // first-pass sums: dc nw centres, Omega_I, off-diagonal
constexpr int kMVGridWarps = 4;                  // the run kernel's blocks: 128 threads, a k a warp
constexpr int kMVNbChunk = 8;                    // b-vectors whose rows a warp stages at once
constexpr int kMVPhases = 7;                     // overlaps 1, reductions 2, update 4

// -- the run kernel, nw <= 8 ---------------------------------------------------

__device__ __forceinline__ double mv_warp_sum(double x) {
    for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
    return x;
}

// a warp's shared scratch for nw N, in doubles (16-byte aligned pieces first):
// A, V, X (N x N each; A is also T = M0 U(k + b) in the overlaps), the
// staged rows of a chunk of kMVNbChunk b-vectors (their M0 blocks and
// neighbours' U in the overlaps, their M in the gradient), U(k), the
// gradient factors conj(M_nn) and q_n / M_nn (kMVNbChunk x N each),
// e^{-i lambda} (N), the rotations (8 a pair), the first-pass sums (kMVQ)
// and each index's pair this round (8 ints)
template <int N>
struct MVWarpArea {
    static constexpr int kMat = 2 * N * N;
    static constexpr int kDoubles =
        (4 + 2 * kMVNbChunk) * kMat + 2 * 2 * kMVNbChunk * N + 2 * N + 8 * 4 + kMVQ + 4;
};

// copy n contiguous 16-byte pieces from src to dst by cp.async, the warp's
// lanes sharing them (not committed)
__device__ __forceinline__ void mv_copy(cplx* dst, const cplx* src, int n) {
    for (int e = threadIdx.x & 31; e < n; e += 32) cp_async16(dst + e, src + e);
}

// the block's shared scratch: per-warp partial sums, per-warp chunk sums,
// the totals, then the warps' areas
template <int N>
__host__ __device__ constexpr int mv_run_smem_doubles() {
    return 2 * kMVGridWarps * kMVQ + kMVQ + 8 + kMVGridWarps * ((MVWarpArea<N>::kDoubles + 1) / 2 * 2);
}

// the sum over every block of quantity q < nq of part (blocks x stride), in
// block order: warp w sums its contiguous chunk of blocks, then thread q the
// chunks in order; out[q] in shared memory, visible to the block on return
__device__ void mv_blocks_total(const double* part, int stride, int nq, double* csum, double* out) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, G = gridDim.x;
    const int lo = G * warp / kMVGridWarps, hi = G * (warp + 1) / kMVGridWarps;
    if (lane < nq) {
        double a = 0.0;
#pragma unroll 8
        for (int g = lo; g < hi; ++g) a += __ldcg(part + (int64_t)g * stride + lane);
        csum[warp * kMVQ + lane] = a;
    }
    __syncthreads();
    if (threadIdx.x < nq) {
        double a = 0.0;
        for (int w = 0; w < kMVGridWarps; ++w) a += csum[w * kMVQ + threadIdx.x];
        out[threadIdx.x] = a;
    }
    __syncthreads();
}

// exp(X) of the anti-Hermitian N x N X in the warp's shared memory (in
// place), through the eigenpairs of i X by a parallel cyclic Jacobi.  Each
// round's disjoint pairs (the circle ordering) get their rotations from the
// round's start (a lane a pair, the block path's formulas); then every
// entry takes its new value J^H A J from the four entries of its rows' and
// columns' pairs at once -- the row and then the column rotation of the
// sequential sweep, with its arithmetic, in one pass -- V J likewise, the
// rotated pairs' 2 x 2 blocks set exactly.  A round ends in a __syncwarp.
// prm holds 8 doubles a pair; slot[x] is the pair and side of index x this
// round (2k + side; -1: not rotated).
template <int N>
__device__ void mv_expm_warp(cplx* X, cplx* A, cplx* V, cplx* ph, double* prm, int* slot) {
    constexpr int NN = N * N, kE = (NN + 31) / 32;
    constexpr int Se = N + (N & 1), npair = Se / 2;
    const int lane = threadIdx.x & 31;
    double fro = 0.0;
#pragma unroll
    for (int m = 0; m < kE; ++m) {
        const int e = lane + 32 * m;
        if (e < NN) {
            const int r = e / N, c = e % N;
            const cplx h = make_cuDoubleComplex(-X[r * N + c].y, X[r * N + c].x);  // (i X)_rc
            const cplx g = make_cuDoubleComplex(-X[c * N + r].y, X[c * N + r].x);
            A[e] = make_cuDoubleComplex(0.5 * (h.x + g.x), r == c ? 0.0 : 0.5 * (h.y - g.y));
            V[e] = make_cuDoubleComplex(r == c ? 1.0 : 0.0, 0.0);
            fro += A[e].x * A[e].x + A[e].y * A[e].y;
        }
    }
    const double limit = 1.0e-30 * mv_warp_sum(fro);
    __syncwarp();
    for (int sweep = 0; sweep < kMVJacobiSweeps; ++sweep) {
        double off = 0.0;
#pragma unroll
        for (int m = 0; m < kE; ++m) {
            const int e = lane + 32 * m;
            if (e < NN && e % N > e / N) off += A[e].x * A[e].x + A[e].y * A[e].y;
        }
        if (!(mv_warp_sum(off) > limit)) break;  // the same total in every lane
        for (int round = 0; round < Se - 1; ++round) {
            // the rotation of each pair: slot -1 skip; prm[6] 1 zero the pair, 2 rotate
            if (lane < npair) {
                int p, q;
                circle_pair(Se, round, lane, p, q);
                int a = 0;
                if (q < N) {
                    const cplx b = A[p * N + q];
                    const double absb = hypot(b.x, b.y);
                    if (absb > 0.0) {
                        const double app = A[p * N + p].x, aqq = A[q * N + q].x;
                        const double nb100 = __dmul_rn(100.0, absb);
                        double* pr = prm + 8 * lane;
                        if (__dadd_rn(nb100, fabs(app)) == fabs(app) && __dadd_rn(nb100, fabs(aqq)) == fabs(aqq)) {
                            a = 1;
                        } else {
                            const double tau = (aqq - app) / (2.0 * absb);
                            const double t = (tau >= 0.0 ? 1.0 : -1.0) / (fabs(tau) + hypot(1.0, tau));
                            const double c = 1.0 / sqrt(1.0 + t * t);
                            pr[0] = c;
                            pr[1] = t * c;
                            pr[2] = b.x / absb;
                            pr[3] = b.y / absb;
                            pr[4] = app - t * absb;
                            pr[5] = aqq + t * absb;
                            a = 2;
                        }
                        pr[6] = a;
                    }
                }
                if (q < N) {
                    slot[p] = a ? 2 * lane : -1;
                    slot[q] = a ? 2 * lane + 1 : -1;
                } else if (p < N) {
                    slot[p] = -1;
                }
            }
            __syncwarp();
            // every entry's new value from its rows' and columns' pairs
            cplx na[kE], nv[kE];
#pragma unroll
            for (int m = 0; m < kE; ++m) {
                const int e = lane + 32 * m;
                if (e >= NN) continue;
                const int i = e / N, j = e % N;
                const int si = slot[i], sj = slot[j];
                na[m] = A[e];
                nv[m] = V[e];
                const bool ri = si >= 0 && prm[8 * (si >> 1) + 6] == 2.0;
                const bool rj = sj >= 0 && prm[8 * (sj >> 1) + 6] == 2.0;
                int cp = j, cq = j;  // the column's pair
                if (rj) {
                    circle_pair(Se, round, sj >> 1, cp, cq);
                    const double* pr = prm + 8 * (sj >> 1);
                    const double c = pr[0], sn = pr[1], er = pr[2], ei = pr[3];
                    const cplx vp = V[i * N + cp], vq = V[i * N + cq];
                    const double vq_x = er * vq.x + ei * vq.y, vq_y = er * vq.y - ei * vq.x;
                    nv[m] = (sj & 1) ? make_cuDoubleComplex(sn * vp.x + c * vq_x, sn * vp.y + c * vq_y)
                                     : make_cuDoubleComplex(c * vp.x - sn * vq_x, c * vp.y - sn * vq_y);
                }
                if (si >= 0 && si >> 1 == sj >> 1) {  // the pair's own 2 x 2 block, set exactly
                    if (i != j) na[m] = make_cuDoubleComplex(0.0, 0.0);
                    else if (ri) na[m] = make_cuDoubleComplex(prm[8 * (si >> 1) + 4 + (si & 1)], 0.0);
                } else if (ri || rj) {
                    // the row rotation of row i at columns j and j' (j's partner),
                    // then the column rotation of j, each as the sequential sweep
                    // computes it: rows p, q <- c A_p - s e A_q, s A_p + c e A_q;
                    // columns p, q <- c A_p - s conj(e) A_q, s A_p + c conj(e) A_q
                    int rp = i, rq = i;  // the row's pair
                    if (ri) circle_pair(Se, round, si >> 1, rp, rq);
                    cplx r[2];  // A1[i][cp], A1[i][cq] (only r[0] when j is not rotated)
#pragma unroll
                    for (int h = 0; h < 2; ++h) {
                        const int x = h ? cq : cp;
                        if (ri) {
                            const double* pr = prm + 8 * (si >> 1);
                            const double c = pr[0], sn = pr[1], er = pr[2], ei = pr[3];
                            const cplx ap = A[rp * N + x], aq = A[rq * N + x];
                            const double eq_x = er * aq.x - ei * aq.y, eq_y = er * aq.y + ei * aq.x;  // e aq
                            r[h] = (si & 1) ? make_cuDoubleComplex(sn * ap.x + c * eq_x, sn * ap.y + c * eq_y)
                                            : make_cuDoubleComplex(c * ap.x - sn * eq_x, c * ap.y - sn * eq_y);
                        } else {
                            r[h] = A[i * N + x];
                        }
                    }
                    if (rj) {
                        const double* pr = prm + 8 * (sj >> 1);
                        const double c = pr[0], sn = pr[1], er = pr[2], ei = pr[3];
                        const cplx ap = r[0], aq = r[1];
                        const double cq_x = er * aq.x + ei * aq.y, cq_y = er * aq.y - ei * aq.x;  // conj(e) aq
                        na[m] = (sj & 1) ? make_cuDoubleComplex(sn * ap.x + c * cq_x, sn * ap.y + c * cq_y)
                                         : make_cuDoubleComplex(c * ap.x - sn * cq_x, c * ap.y - sn * cq_y);
                    } else {
                        na[m] = r[0];
                    }
                }
            }
            __syncwarp();  // every read of A and V is done
#pragma unroll
            for (int m = 0; m < kE; ++m) {
                const int e = lane + 32 * m;
                if (e < NN) {
                    A[e] = na[m];
                    V[e] = nv[m];
                }
            }
            __syncwarp();
        }
    }
    // exp(X) = V diag(e^{-i lambda}) V^H
    if (lane < N) {
        double sn, cs;
        sincos(-A[lane * N + lane].x, &sn, &cs);
        ph[lane] = make_cuDoubleComplex(cs, sn);
    }
    __syncwarp();
#pragma unroll
    for (int m = 0; m < kE; ++m) {
        const int e = lane + 32 * m;
        if (e < NN) {
            const int r = e / N, c = e % N;
            cplx acc = make_cuDoubleComplex(0.0, 0.0);
#pragma unroll
            for (int j = 0; j < N; ++j) acc = cuCadd(acc, cuCmul(cuCmul(V[r * N + j], ph[j]), cconj(V[c * N + j])));
            X[e] = acc;
        }
    }
    __syncwarp();
}

// scal: [0] eps, [1] Omega_prev, [2] momentum factor, read at the start and
// written at the end of a run; fin: [0] Omega_I, [1] Omega~ and rbar_out
// (dc, N) of the closing pair (steps 0); hist (steps,); part (B nb, N + 2)
// the rows' phases; red (G, kMVQ) then (G,) the blocks' partial sums.
// `phases` leaves phases out for timing (overlaps 1, reductions 2, update 4).
// Warp w of the grid takes k = w, w + 4G, ... in every phase.
template <int N>
__global__ void __launch_bounds__(32 * kMVGridWarps, 1)
    mv_run_kernel(const cplx* __restrict__ M0, const int64_t* __restrict__ nbr, const double* __restrict__ w_b,
                  const double* __restrict__ b_cart, cplx* U, cplx* dW, cplx* M, double* part, double* red,
                  double* scal, double* rbar_out, double* hist, double* fin, int64_t nk, int64_t nb, int dc,
                  double mu, double eps_cap, int64_t steps, int phases) {
    constexpr int NN = N * N, kE = (NN + 31) / 32;
    extern __shared__ double sh[];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, G = gridDim.x;
    const int nq = dc * N + 2;
    double* wsum = sh;                          // warps x kMVQ
    double* csum = wsum + kMVGridWarps * kMVQ;  // warps x kMVQ
    double* tot = csum + kMVGridWarps * kMVQ;   // kMVQ totals (rbar first), then the diagonal spread
    double* wa = tot + kMVQ + 8 + warp * ((MVWarpArea<N>::kDoubles + 1) / 2 * 2);
    cplx* Aw = (cplx*)wa;  // the Jacobi's A; T in the overlaps
    cplx* Vw = Aw + NN;    // the Jacobi's V
    cplx* Xw = Vw + NN;
    cplx* stg = Xw + NN;   // a chunk's rows: 2 kMVNbChunk NN
    cplx* Uk = stg + 2 * kMVNbChunk * NN;
    cplx* dn = Uk + NN;               // conj(M_nn), kMVNbChunk x N
    cplx* tf = dn + kMVNbChunk * N;   // q_n / M_nn
    cplx* ph = tf + kMVNbChunk * N;
    double* prm = (double*)(ph + N);  // 8 a pair
    double* qv = prm + 8 * 4;         // the warp's first-pass sums
    int* slot = (int*)(qv + kMVQ);
    const int64_t gw = (int64_t)blockIdx.x * kMVGridWarps + warp, nwarps = (int64_t)G * kMVGridWarps;
    const double inv_n = 1.0 / (double)nk;
    double wsum_b = 0.0;  // sum_b w_b
    for (int64_t b = 0; b < nb; ++b) wsum_b += w_b[b];
    double eps = scal[0], om_prev = scal[1], fac = scal[2];
    const bool closing = steps == 0;
    const int64_t passes = closing ? 1 : steps;
    cg::grid_group grid = cg::this_grid();
    for (int64_t step = 0; step < passes; ++step) {
        // -- overlaps, and the warp's first-pass sums, each lane its own
        double ai = 0.0, ao = 0.0;  // sum w_b |M|^2, sum w_b |M_off|^2
        double cen = 0.0;           // lane d N + n: sum w_b b_d ang_n
        int64_t ks = 0;             // the warp's k-points
        if (phases & 1) {
            for (int64_t k = gw; k < nk; k += nwarps, ++ks) {
                for (int64_t b0 = 0; b0 < nb; b0 += kMVNbChunk) {
                    // U(k) and the chunk's M0 blocks and neighbours' U, at once
                    // (cp.async reads L2: U was written by other blocks)
                    const int nbc = (int)(nb - b0 < kMVNbChunk ? nb - b0 : kMVNbChunk);
                    if (b0 == 0) mv_copy(Uk, U + k * NN, NN);
                    mv_copy(stg, M0 + (k * nb + b0) * NN, nbc * NN);
                    for (int e = lane; e < nbc * NN; e += 32)
                        cp_async16(stg + kMVNbChunk * NN + e, U + nbr[k * nb + b0 + e / NN] * NN + e % NN);
                    cp_async_commit();
                    cp_async_wait<0>();
                    __syncwarp();
                    for (int bb = 0; bb < nbc; ++bb) {
                        const int64_t r = k * nb + b0 + bb;
                        const cplx* m0 = stg + bb * NN;
                        const cplx* v = stg + (kMVNbChunk + bb) * NN;
#pragma unroll
                        for (int m = 0; m < kE; ++m) {
                            const int e = lane + 32 * m;
                            if (e < NN) {
                                const int i = e / N, j = e % N;
                                cplx a = make_cuDoubleComplex(0.0, 0.0);
#pragma unroll
                                for (int l = 0; l < N; ++l) a = cuCadd(a, cuCmul(m0[i * N + l], v[l * N + j]));
                                Aw[e] = a;
                            }
                        }
                        __syncwarp();
                        const double w = w_b[b0 + bb];
#pragma unroll
                        for (int m = 0; m < kE; ++m) {
                            const int e = lane + 32 * m;
                            if (e < NN) {
                                const int i = e / N, j = e % N;
                                cplx a = make_cuDoubleComplex(0.0, 0.0);
#pragma unroll
                                for (int l = 0; l < N; ++l) a = cuCadd(a, cmul_conj(Uk[l * N + i], Aw[l * N + j]));
                                M[r * NN + e] = a;
                                const double s2 = w * (a.x * a.x + a.y * a.y);
                                ai += s2;
                                if (i == j) dn[bb * N + i] = a;
                                else ao += s2;
                            }
                        }
                        __syncwarp();  // T free, M_nn visible
                    }
                    // the chunk's phases arg M_nn, a lane a (b, n); then lane
                    // d N + n adds w_b b_d ang_n over the chunk in b order
                    double* ang = (double*)tf;
                    for (int p = lane; p < nbc * N; p += 32) {
                        const double a = atan2(dn[p].y, dn[p].x);
                        ang[p] = a;
                        part[(k * nb + b0 + p / N) * (N + 2) + p % N] = a;
                    }
                    __syncwarp();
                    if (lane < dc * N)
                        for (int c = 0; c < nbc; ++c)
                            cen += (w_b[b0 + c] * b_cart[(b0 + c) * dc + lane / N]) * ang[c * N + lane % N];
                    __syncwarp();  // the staged rows, M_nn and the phases free
                }
            }
        }
        // the warp's sums into lane q: the centres, Omega_I = sum w_b (N -
        // sum |M|^2), the off-diagonal spread
        ai = mv_warp_sum(ai);
        ao = mv_warp_sum(ao);
        if (lane < dc * N) qv[lane] = cen;
        if (lane == 0) {
            qv[dc * N] = (double)ks * (double)N * wsum_b - ai;
            qv[dc * N + 1] = ao;
        }
        __syncwarp();
        if (lane < nq) wsum[warp * kMVQ + lane] = qv[lane];
        __syncthreads();
        if (threadIdx.x < nq) {
            double a = 0.0;
            for (int w = 0; w < kMVGridWarps; ++w) a += wsum[w * kMVQ + threadIdx.x];
            red[(int64_t)blockIdx.x * kMVQ + threadIdx.x] = a;
        }
        grid.sync();
        // -- the first pass's totals, the centres, then the diagonal spread's rows
        if (phases & 2) mv_blocks_total(red, kMVQ, nq, csum, tot);
        if (threadIdx.x < dc * N) tot[threadIdx.x] = -tot[threadIdx.x] * inv_n;  // rbar (dc, N)
        __syncthreads();
        const double oi = tot[dc * N] * inv_n, od = tot[dc * N + 1] * inv_n;
        double acc2 = 0.0;
        if (phases & 2) {
            const int64_t pairs = nb * N;
            for (int64_t k = gw; k < nk; k += nwarps)
                for (int64_t p = lane; p < pairs; p += 32) {
                    const int64_t b = p / N;
                    const int n = (int)(p % N);
                    double q = part[(k * nb + b) * (N + 2) + n];
                    for (int d = 0; d < dc; ++d) q += b_cart[b * dc + d] * tot[d * N + n];
                    acc2 += w_b[b] * (q * q);
                }
        }
        acc2 = mv_warp_sum(acc2);
        if (lane == 0) wsum[warp * kMVQ] = acc2;
        __syncthreads();
        if (threadIdx.x == 0) {
            double a = 0.0;
            for (int w = 0; w < kMVGridWarps; ++w) a += wsum[w * kMVQ];
            red[(int64_t)G * kMVQ + blockIdx.x] = a;
        }
        grid.sync();
        // -- the spread, the step-size rule, the update
        if (phases & 2) mv_blocks_total(red + (int64_t)G * kMVQ, 1, 1, csum, tot + kMVQ);
        const double ot = od + tot[kMVQ] * inv_n;
        const double om = oi + ot;
        if (closing) {
            if (blockIdx.x == 0) {
                if (threadIdx.x < dc * N) rbar_out[threadIdx.x] = tot[threadIdx.x];
                if (threadIdx.x == 0) {
                    fin[0] = oi;
                    fin[1] = ot;
                }
            }
            break;
        }
        const bool up = om > om_prev;
        eps = fmin(up ? eps * 0.5 : eps * 1.1, eps_cap);
        fac = up ? 0.0 : mu;
        om_prev = om;
        if (blockIdx.x == 0 && threadIdx.x == 0) hist[step] = om;
        if (phases & 4) {
            for (int64_t k = gw; k < nk; k += nwarps) {
                // dW(k) and U(k) now, used after the gradient and the Jacobi
                cplx* dw = dW + k * NN;
                cplx dwk[kE], g[kE];
#pragma unroll
                for (int m = 0; m < kE; ++m) {
                    const int e = lane + 32 * m;
                    dwk[m] = e < NN ? dw[e] : make_cuDoubleComplex(0.0, 0.0);
                    g[m] = make_cuDoubleComplex(0.0, 0.0);
                }
                for (int64_t b0 = 0; b0 < nb; b0 += kMVNbChunk) {
                    // U(k) and the chunk's M(k, b), at once
                    const int nbc = (int)(nb - b0 < kMVNbChunk ? nb - b0 : kMVNbChunk);
                    if (b0 == 0) mv_copy(Uk, U + k * NN, NN);
                    mv_copy(stg, M + (k * nb + b0) * NN, nbc * NN);
                    cp_async_commit();
                    double qp[(kMVNbChunk * N + 31) / 32];  // the phases, loaded meanwhile
#pragma unroll
                    for (int t = 0; t < (kMVNbChunk * N + 31) / 32; ++t) {
                        const int p = lane + 32 * t;
                        qp[t] = p < nbc * N ? part[(k * nb + b0 + p / N) * (N + 2) + p % N] : 0.0;
                    }
                    cp_async_wait<0>();
                    __syncwarp();
                    // conj(M_nn) and q_n / M_nn of every (b, n) of the chunk, a lane a pair
#pragma unroll
                    for (int t = 0; t < (kMVNbChunk * N + 31) / 32; ++t) {
                        const int p = lane + 32 * t;
                        if (p < nbc * N) {
                            const int bb = p / N, n = p % N;
                            const cplx mnn = stg[bb * NN + n * N + n];
                            double q = qp[t];
                            for (int d = 0; d < dc; ++d) q += b_cart[(b0 + bb) * dc + d] * tot[d * N + n];
                            dn[p] = cconj(mnn);
                            const cplx den = hypot(mnn.x, mnn.y) < 1e-12 ? make_cuDoubleComplex(1.0, 0.0) : mnn;
                            tf[p] = cuCdiv(make_cuDoubleComplex(q, 0.0), den);
                        }
                    }
                    __syncwarp();
                    // A - S with R_mn = M_mn conj(M_nn), T_mn = M_mn q_n / M_nn,
                    // A = (R - R^H) / 2, S = (T + T^H) / 2i
                    for (int bb = 0; bb < nbc; ++bb) {
                        const cplx* mk = stg + bb * NN;
                        const double w = w_b[b0 + bb];
                        const cplx* dnb = dn + bb * N;
                        const cplx* tfb = tf + bb * N;
#pragma unroll
                        for (int m = 0; m < kE; ++m) {
                            const int e = lane + 32 * m;
                            if (e < NN) {
                                const int i = e / N, j = e % N;
                                const cplx mij = mk[i * N + j], mji = mk[j * N + i];
                                const cplx rij = cuCmul(mij, dnb[j]), rji = cuCmul(mji, dnb[i]);
                                const cplx tij = cuCmul(mij, tfb[j]), tji = cuCmul(mji, tfb[i]);
                                const double ax = 0.5 * (rij.x - rji.x), ay = 0.5 * (rij.y + rji.y);
                                const double sx = 0.5 * (tij.y - tji.y), sy = -0.5 * (tij.x + tji.x);
                                g[m].x += w * (ax - sx);
                                g[m].y += w * (ay - sy);
                            }
                        }
                    }
                    __syncwarp();  // the staged rows, dn and tf free
                }
#pragma unroll
                for (int m = 0; m < kE; ++m) {
                    const int e = lane + 32 * m;
                    if (e < NN) {
                        const cplx x = make_cuDoubleComplex(fac * dwk[m].x + eps * 4.0 * g[m].x,
                                                            fac * dwk[m].y + eps * 4.0 * g[m].y);
                        dw[e] = x;
                        Xw[e] = x;
                    }
                }
                __syncwarp();
                mv_expm_warp<N>(Xw, Aw, Vw, ph, prm, slot);
                // U <- U exp(dW), from the staged U(k)
                cplx* u = U + k * NN;
#pragma unroll
                for (int m = 0; m < kE; ++m) {
                    const int e = lane + 32 * m;
                    if (e < NN) {
                        const int i = e / N, j = e % N;
                        cplx a = make_cuDoubleComplex(0.0, 0.0);
#pragma unroll
                        for (int l = 0; l < N; ++l) a = cuCadd(a, cuCmul(Uk[i * N + l], Xw[l * N + j]));
                        u[e] = a;
                    }
                }
                __syncwarp();
            }
        }
        if (step + 1 < passes) grid.sync();
    }
    if (!closing && blockIdx.x == 0 && threadIdx.x == 0) {
        scal[0] = eps;
        scal[1] = om_prev;
        scal[2] = fac;
    }
}

// -- block paths, 9 <= nw <= 32 ----------------------------------------------

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

// A whole run of `steps` steps (0: the closing overlaps + reduce pair) of the
// run kernel, nw <= 8, as a cooperative launch of the blocks that fit the
// card at once (a k-point a warp, so at most nk / 4); red holds red_blocks x
// (kMVQ + 1) doubles.
template <int N>
static int mv_run_launch(void** args, int64_t nk, int64_t red_blocks, cudaStream_t st) {
    const void* kern = (const void*)mv_run_kernel<N>;
    const size_t smem = (size_t)mv_run_smem_doubles<N>() * sizeof(double);
    int dev = 0, sms = 0, per = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kern, 32 * kMVGridWarps, smem);
    if (err != cudaSuccess) return (int)err;
    const int64_t want = (nk + kMVGridWarps - 1) / kMVGridWarps;
    const int grid = (int)(want < (int64_t)per * sms ? want : (int64_t)per * sms);
    if (grid < 1 || grid > red_blocks) return (int)cudaErrorInvalidConfiguration;
    return (int)cudaLaunchCooperativeKernel(kern, dim3(grid), dim3(32 * kMVGridWarps), args, smem, st);
}

extern "C" int pythtb_mv_run(const void* M0, const void* nbr, const void* w_b, const void* b_cart, void* U,
                             void* dW, void* M, void* part, void* red, void* scal, void* rbar, void* hist,
                             void* fin, int64_t nk, int64_t nb, int64_t n, int64_t dc, double mu,
                             double eps_cap, int64_t steps, int64_t red_blocks, int64_t phases, void* stream) {
    if (nk <= 0) return (int)cudaGetLastError();
    if (n < 1 || n > kMVRunMaxN || dc < 1 || dc > kMVMaxDC || nb < 1 || steps < 0 || phases < 0 ||
        phases > kMVPhases)
        return (int)cudaErrorInvalidValue;
    int idc = (int)dc, iph = (int)phases;
    void* args[] = {(void*)&M0, (void*)&nbr, (void*)&w_b, (void*)&b_cart, &U, &dW, &M, &part, &red, &scal,
                    &rbar, &hist, &fin, &nk, &nb, &idc, &mu, &eps_cap, &steps, &iph};
    cudaStream_t st = (cudaStream_t)stream;
    switch (n) {
        case 1: return mv_run_launch<1>(args, nk, red_blocks, st);
        case 2: return mv_run_launch<2>(args, nk, red_blocks, st);
        case 3: return mv_run_launch<3>(args, nk, red_blocks, st);
        case 4: return mv_run_launch<4>(args, nk, red_blocks, st);
        case 5: return mv_run_launch<5>(args, nk, red_blocks, st);
        case 6: return mv_run_launch<6>(args, nk, red_blocks, st);
        case 7: return mv_run_launch<7>(args, nk, red_blocks, st);
        default: return mv_run_launch<8>(args, nk, red_blocks, st);
    }
}

// -- the block path's three entries (one step, nw <= 32) -----------------------

extern "C" int pythtb_mv_overlaps(const void* M0, const void* nbr, const void* U, void* M,
                                  void* part, int64_t nk, int64_t nb, int64_t n, void* stream) {
    const int64_t rows = nk * nb;
    if (rows <= 0) return (int)cudaGetLastError();
    if (n < 1 || n > kMVBlockMaxN) return (int)cudaErrorInvalidValue;
    mv_overlaps_block_kernel<<<(unsigned int)rows, kMVBlockThreads, n * n * sizeof(cplx), (cudaStream_t)stream>>>(
        (const cplx*)M0, (const int64_t*)nbr, (const cplx*)U, (cplx*)M, (double*)part, nb, (int)n);
    return (int)cudaGetLastError();
}

extern "C" int pythtb_mv_reduce(const void* part, const void* w_b, const void* b_cart, void* scal,
                                void* rbar, void* hist, void* fin, int64_t nk, int64_t nb, int64_t n,
                                int64_t dc, double mu, double eps_cap, int64_t step, void* stream) {
    if (dc < 1 || dc > kMVMaxDC || n < 1 || n > kMVBlockMaxN) return (int)cudaErrorInvalidValue;
    mv_reduce_block_kernel<<<1, kMVReduceThreads, 0, (cudaStream_t)stream>>>(
        (const double*)part, (const double*)w_b, (const double*)b_cart, (double*)scal, (double*)rbar,
        (double*)hist, (double*)fin, nk * nb, nb, (int)n, (int)dc, nk, mu, eps_cap, step);
    return (int)cudaGetLastError();
}

extern "C" int pythtb_mv_update(const void* M, const void* w_b, const void* b_cart, const void* rbar,
                                const void* scal, void* U, void* dW, int64_t nk, int64_t nb,
                                int64_t n, int64_t dc, void* stream) {
    if (nk <= 0) return (int)cudaGetLastError();
    if (n < 1 || n > kMVBlockMaxN) return (int)cudaErrorInvalidValue;
    const size_t smem = mv_update_smem((int)n);
    cudaFuncSetAttribute(mv_update_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    mv_update_block_kernel<<<(unsigned int)nk, kMVBlockThreads, smem, (cudaStream_t)stream>>>(
        (const cplx*)M, (const double*)w_b, (const double*)b_cart, (const double*)rbar, (const double*)scal,
        (cplx*)U, (cplx*)dW, nb, (int)n, (int)dc);
    return (int)cudaGetLastError();
}
