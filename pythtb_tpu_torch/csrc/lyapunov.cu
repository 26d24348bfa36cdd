// Kernel 18: the QR-stabilized transfer-matrix product of a quasi-1-D
// strip, per (disorder realization, energy).
//
// Replaces the lax.scan of pythtb_tpu/localization.py:_lyapunov_jit
// (:73-139).  With S states per principal layer, A_E = E H01^{-1} -
// H01^{-1} H00 (S x S, one per energy), Hinv = H01^{-1} and
// Bm = -H01^{-1} H01^H, each step l advances the 2S x 2S frame
//   Q <- [ (A_E - Hinv diag(w_l)) Q_top + Bm Q_bot ; Q_top ],
// w_l the S onsite values of layer l (potential plus disorder, the same
// for every energy of a realization), and every `stride` steps Q is
// re-orthonormalized by a QR factorization, log max(|R_jj|, tiny) adding
// to the Lyapunov sums.  The host divides by the length and sorts.
//
// The QR is Householder's (the reflectors below the diagonal, then the
// unitary factor formed from them, as LAPACK's zgeqr2 and zung2r do): it
// stays backward stable however far apart the exponents of a stride's
// product are, where Gram-Schmidt, even applied twice, loses the frame
// once that product's condition number nears 1 / eps.  The sums of
// log |R_jj| do not depend on the phases of Q's columns, so the kernel's
// signs need not be LAPACK's.
//
// What bounds it on the H100: latency.  The work is some 4 S^3 complex
// multiply-adds a step and a QR every `stride` steps (the row: 512
// energies x 200,000 steps of S 8, ~2e12 float64 operations, some 60 ms
// at the float64 peak); the bytes are only the (steps, realizations, S)
// onsite values, read by every chain from L2.  The chains are
// independent, so the design gives each as little synchronization as its
// frame allows:
//
// * the warp design (S <= 8, 2S <= 16 columns): a warp a chain, for every
//   step of a launch, with no block barrier in the step or the QR.  Lane
//   2c + h holds column c of the frame, rows hS .. hS + S - 1, in
//   registers.  A step forms M = A_E - Hinv diag(w_l) in the warp's shared
//   memory (two entries a lane, from A_E and Hinv held in registers and
//   the onsite values loaded one step ahead), then the top lane of each
//   column multiplies M by Q_top and the bottom lane Bm (in the block's
//   shared memory, read as broadcasts) by Q_bot; one xor shuffle of S
//   complex numbers gives the top lane the sum and the bottom lane the
//   old top.  The QR runs in the warp: column j goes to every lane through
//   the warp's shared memory, every lane computes the reflector alike
//   (one square root, one division) while the columns right of j take
//   their dot products with the raw column, and each column's two lanes
//   update it at once; the reflectors wait in shared memory for the pass
//   that forms Q.  The block packs four chains (consecutive energies of
//   one realization) and shares Bm.
// * the block design (S 9-40): a block a chain keeps Q, A_E, Hinv and Bm
//   in shared memory (at S 40 some 180 KB, opted in above 48 KB); each
//   thread owns up to kMaxPer elements of the new top block in registers,
//   so the step needs no second frame, and the onsite values of the next
//   step are loaded while the current one is written.  Its QR takes each
//   column's norm by a warp reduction and updates the columns right of it
//   a group of lanes a column, every thread sharing the work.
//
// Sums run in a fixed order.  The wrapper launches once per chunk of
// whole macro steps, carrying Q and the sums in global memory, so one
// chunk's onsite values bound the memory used; it picks the design
// (localization._lyapunov_design).  Above S 40 (cudaErrorInvalidValue)
// the Python wrapper raises before it gets here.
#include <algorithm>

#include "common.cuh"

constexpr int kMaxS = 40;   // 2S x 2S frame of 80 x 80 complex: 100 KB
constexpr int kMaxPer = 8;  // top-block elements a thread keeps in registers
constexpr int kMaxThreads = 512;  // 512 x kMaxPer covers the 3,200 top entries at S 40
constexpr int kWarpMaxS = 8;      // the warp design: 2S columns, two lanes each
constexpr int kChainsPerBlock = 4;
constexpr double kTiny = 2.2250738585072014e-308;

__device__ __forceinline__ cplx shfl_c(cplx v, int src) {
    return make_cuDoubleComplex(__shfl_sync(0xffffffffu, v.x, src), __shfl_sync(0xffffffffu, v.y, src));
}

__device__ __forceinline__ cplx shfl_xor_c(cplx v, int mask) {
    return make_cuDoubleComplex(__shfl_xor_sync(0xffffffffu, v.x, mask), __shfl_xor_sync(0xffffffffu, v.y, mask));
}

// c + a b
__device__ __forceinline__ cplx cfma(cplx a, cplx b, cplx c) {
    return make_cuDoubleComplex(fma(a.x, b.x, fma(-a.y, b.y, c.x)), fma(a.x, b.y, fma(a.y, b.x, c.y)));
}

// c + conj(a) b
__device__ __forceinline__ cplx cfma_conj(cplx a, cplx b, cplx c) {
    return make_cuDoubleComplex(fma(a.x, b.x, fma(a.y, b.y, c.x)), fma(a.x, b.y, fma(-a.y, b.x, c.y)));
}

// the sum over the warp, the same bits in every lane (an xor butterfly)
__device__ __forceinline__ double lyap_warp_sum(double x) {
    for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
    return x;
}

// -- the warp design ----------------------------------------------------------

// sum_i conj(a_i) b_i in two interleaved chains (half the latency of one)
template <int S>
__device__ __forceinline__ cplx dot_conj(const cplx (&a)[S], const cplx (&b)[S]) {
    cplx e = make_cuDoubleComplex(0.0, 0.0), o = e;
#pragma unroll
    for (int i = 0; i < S; i += 2) e = cfma_conj(a[i], b[i], e);
#pragma unroll
    for (int i = 1; i < S; i += 2) o = cfma_conj(a[i], b[i], o);
    return cuCadd(e, o);
}

// The Householder QR of the warp's frame (zgeqr2, then zung2r), in place in
// the lanes' registers; lane 2c adds log max(|R_cc|, tiny) to its sum `ly`.
// The warp's shared scratch: col (2 x 2S complex, column j handed to every
// lane, double-buffered), V (2S x 2S, the reflectors, row j holding v_j)
// and tau (2S).  Column j's critical path is kept short: every lane takes
// the raw column from `col`, so the dot products of the columns right of j
// with it run beside the norm, the square root and the one division that
// give the reflector; log |R_jj| waits for the end.
template <int S>
__device__ __forceinline__ void qr_warp(cplx (&X)[S], double& ly, cplx* col, cplx* V, cplx* tau, int lane) {
    constexpr int n = 2 * S;
    const int c = lane >> 1, h = lane & 1;
    double rcc = 1.0;  // |R_cc| of this lane's column (lane 2c)
#pragma unroll
    for (int j = 0; j < n; ++j) {
        cplx* cj = col + (j & 1) * n;
        if (c == j) {
#pragma unroll
            for (int i = 0; i < S; ++i) cj[h * S + i] = X[i];
        }
        __syncwarp();
        cplx x[S];
#pragma unroll
        for (int i = 0; i < S; ++i) x[i] = cj[h * S + i];
        const cplx alpha = cj[j];
        // this half's rows below j: |x|^2 (four short chains), conj(x) . X, and row j of X
        double pa = 0.0, pb = 0.0, pc = 0.0, pd = 0.0;
        cplx d = make_cuDoubleComplex(0.0, 0.0), xj = d;
        cplx xb[S];
#pragma unroll
        for (int i = 0; i < S; ++i) {
            const int r = h * S + i;
            xb[i] = r > j ? x[i] : make_cuDoubleComplex(0.0, 0.0);
            if (i & 1) {
                pc = fma(xb[i].x, xb[i].x, pc);
                pd = fma(xb[i].y, xb[i].y, pd);
            } else {
                pa = fma(xb[i].x, xb[i].x, pa);
                pb = fma(xb[i].y, xb[i].y, pb);
            }
            if (r == j) xj = X[i];
        }
        d = dot_conj<S>(xb, X);
        const double part = (pa + pb) + (pc + pd);
        const double xn2 = part + __shfl_xor_sync(0xffffffffu, part, 1);  // the same bits in every lane
        d = cuCadd(d, shfl_xor_c(d, 1));
        xj = cuCadd(xj, shfl_xor_c(xj, 1));
        cplx tj = make_cuDoubleComplex(0.0, 0.0), scal = make_cuDoubleComplex(1.0, 0.0);
        double rjj;
        if (xn2 == 0.0 && alpha.y == 0.0) {
            rjj = fabs(alpha.x);
        } else {
            const double nrm = sqrt(alpha.x * alpha.x + alpha.y * alpha.y + xn2);
            const double beta = alpha.x >= 0.0 ? -nrm : nrm;
            const cplx u1 = make_cuDoubleComplex(alpha.x - beta, alpha.y);
            const double u1sq = u1.x * u1.x + u1.y * u1.y;
            const double inv = 1.0 / (beta * u1sq);
            const double ib = u1sq * inv, iu = beta * inv;  // 1 / beta, 1 / |u1|^2
            tj = make_cuDoubleComplex((beta - alpha.x) * ib, -alpha.y * ib);
            scal = make_cuDoubleComplex(u1.x * iu, -u1.y * iu);  // 1 / u1
            rjj = nrm;
        }
        if (c == j) {
            rcc = rjj;
#pragma unroll
            for (int i = 0; i < S; ++i)
                if (h * S + i > j) V[j * n + h * S + i] = cuCmul(x[i], scal);
            if (h == 0) tau[j] = tj;
        }
        // the columns right of j: A(j:, c) -= conj(tau) v (v^H A(j:, c)),
        // v = [1; scal x], v^H A(j:, c) = X_j + conj(scal) d
        if (c > j) {
            const cplx wv = cuCmul(cconj(tj), cuCadd(xj, cuCmul(cconj(scal), d)));
            const cplx sw = cuCmul(scal, wv);
#pragma unroll
            for (int i = 0; i < S; ++i) {
                const int r = h * S + i;
                if (r > j) X[i] = csub(X[i], cuCmul(x[i], sw));
                else if (r == j) X[i] = csub(X[i], wv);
            }
        }
    }
    __syncwarp();  // V and tau visible to every lane
    // form Q: for j = n-1 .. 0, A(j:, j+1:) = H_j A(j:, j+1:), then column j
#pragma unroll
    for (int j = n - 1; j >= 0; --j) {
        const cplx tj = tau[j];
        cplx v[S];
#pragma unroll
        for (int i = 0; i < S; ++i) {
            const int r = h * S + i;
            v[i] = r > j ? V[j * n + r] : make_cuDoubleComplex(r == j ? 1.0 : 0.0, 0.0);
        }
        cplx wv = dot_conj<S>(v, X);
        wv = cuCadd(wv, shfl_xor_c(wv, 1));
        wv = cuCmul(tj, wv);
        if (c > j) {
#pragma unroll
            for (int i = 0; i < S; ++i) X[i] = csub(X[i], cuCmul(v[i], wv));
        } else if (c == j) {
            const cplx mt = make_cuDoubleComplex(-tj.x, -tj.y);
#pragma unroll
            for (int i = 0; i < S; ++i) {
                const int r = h * S + i;
                X[i] = r > j ? cuCmul(v[i], mt)
                             : make_cuDoubleComplex(r == j ? 1.0 - tj.x : 0.0, r == j ? -tj.y : 0.0);
            }
        }
    }
    if (h == 0 && c < n) ly += log(fmax(rcc, kTiny));
    __syncwarp();  // the scratch free for the next QR
}

// A (nE, S, S), hinv (S, S), Bm (S, S) complex; w (nsteps, ndis, S) float64;
// Q (ndis, nE, 2S, 2S) complex and lyap (ndis, nE, 2S) float64, read and
// written.  Warp `warp` of block b takes chain b * kChainsPerBlock + warp
// = d * nE + e.
template <int S>
__global__ void __launch_bounds__(32 * kChainsPerBlock)
    lyapunov_warp_kernel(const cplx* __restrict__ A, const cplx* __restrict__ hinv, const cplx* __restrict__ Bm,
                         const double* __restrict__ w, cplx* __restrict__ Qg, double* __restrict__ lyapg,
                         int64_t nE, int64_t ndis, int64_t nsteps, int stride) {
    constexpr int n = 2 * S, SS = S * S;
    constexpr int kEnt = (SS + 31) / 32;           // entries of M a lane forms: 1 or 2
    constexpr int kBmArea = (SS + 7) / 8 * 8 + 4;  // Bm, then 64 bytes: M's banks are not Bm's
    constexpr int kWarpArea = (SS + 3 * n + n * n + 7) / 8 * 8;  // M, tau, col, V; a multiple of 128 bytes
    __shared__ cplx sm[kBmArea + kChainsPerBlock * kWarpArea];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int c = lane >> 1, h = lane & 1;  // column c, rows hS .. hS + S - 1
    for (int q = threadIdx.x; q < SS; q += blockDim.x) sm[q] = Bm[q];
    __syncthreads();  // the launch's one block barrier: Bm, shared by the block's chains
    const int64_t b = (int64_t)blockIdx.x * kChainsPerBlock + warp;
    if (b >= nE * ndis) return;
    const int64_t d = b / nE, e = b % nE;
    cplx* Mw = sm + kBmArea + warp * kWarpArea;
    cplx* tau = Mw + SS;
    cplx* col = tau + n;
    cplx* V = col + 2 * n;
    const cplx* coef = h ? sm : Mw;  // the bottom lane multiplies Bm, the top lane M
    const bool live = c < n;
    cplx X[S];
#pragma unroll
    for (int i = 0; i < S; ++i)
        X[i] = live ? Qg[(b * n + h * S + i) * n + c] : make_cuDoubleComplex(0.0, 0.0);
    double ly = live && h == 0 ? lyapg[b * n + c] : 0.0;
    cplx ae[kEnt], he[kEnt];
    double wn[kEnt];
    const double* wd = w + d * S;  // w[(l ndis + d) S + t]
#pragma unroll
    for (int m = 0; m < kEnt; ++m) {
        const int idx = lane + 32 * m;
        const bool ok = idx < SS;
        ae[m] = ok ? A[e * SS + idx] : make_cuDoubleComplex(0.0, 0.0);
        he[m] = ok ? hinv[idx] : make_cuDoubleComplex(0.0, 0.0);
        wn[m] = ok && nsteps > 0 ? wd[idx % S] : 0.0;
    }
    const int64_t wstep = ndis * S;
    int since = 0;
    for (int64_t l = 0; l < nsteps; ++l) {
        double wl[kEnt];
#pragma unroll
        for (int m = 0; m < kEnt; ++m) {
            wl[m] = wn[m];
            const int idx = lane + 32 * m;
            if (idx < SS && l + 1 < nsteps) wn[m] = wd[(l + 1) * wstep + idx % S];  // one step ahead
        }
        __syncwarp();  // the last step's reads of M are done
#pragma unroll
        for (int m = 0; m < kEnt; ++m) {
            const int idx = lane + 32 * m;
            if (idx < SS) Mw[idx] = make_cuDoubleComplex(ae[m].x - he[m].x * wl[m], ae[m].y - he[m].y * wl[m]);
        }
        __syncwarp();
        cplx P[S];
#pragma unroll
        for (int s = 0; s < S; ++s) {
            cplx acc = make_cuDoubleComplex(0.0, 0.0);
#pragma unroll
            for (int t = 0; t < S; ++t) acc = cfma(coef[s * S + t], X[t], acc);
            P[s] = acc;
        }
        // top lane: M Q_top + Bm Q_bot; bottom lane: the old Q_top
#pragma unroll
        for (int i = 0; i < S; ++i) {
            const cplx r = shfl_xor_c(h ? P[i] : X[i], 1);
            X[i] = h ? r : cuCadd(P[i], r);
        }
        if (++since == stride) {
            since = 0;
            qr_warp<S>(X, ly, col, V, tau, lane);
        }
    }
    if (live) {
#pragma unroll
        for (int i = 0; i < S; ++i) Qg[(b * n + h * S + i) * n + c] = X[i];
        if (h == 0) lyapg[b * n + c] = ly;
    }
}

// -- the block design ---------------------------------------------------------

struct LyapSmem {
    cplx *Q, *A, *hinv, *Bm, *r;
    double *wv, *lyap;
};

__host__ __device__ inline size_t lyap_smem_bytes(int S) {
    const int n = 2 * S;
    return (size_t)(n * n + 3 * S * S + n + 1) * sizeof(cplx) + (size_t)(2 * S + n) * sizeof(double);
}

__device__ inline LyapSmem lyap_smem(cplx* base, int S) {
    const int n = 2 * S;
    LyapSmem s;
    s.Q = base;
    s.A = s.Q + n * n;
    s.hinv = s.A + S * S;
    s.Bm = s.hinv + S * S;
    s.r = s.Bm + S * S;  // the reflectors' tau, then one scale
    s.wv = (double*)(s.r + n + 1);
    s.lyap = s.wv + 2 * S;
    return s;
}

// H_j applied from the left to the columns right of j:
// A(j:, c) -= t v (v^H A(j:, c)), v = [1; Q(j+1:, j)].  Each column takes a
// group of g lanes, g the largest power of two (to 32) that gives every
// column a group, and they split its rows.  A warp holds 32 / g columns:
// lane = column + (32 / g) row, so the eight lanes of a 16-byte access
// phase read consecutive columns of one row (no bank conflict whatever
// the row stride), and an xor butterfly over the row lanes sums the dot
// product (the same bits in every lane of the group).
__device__ __forceinline__ void reflect_columns(cplx* Q, int n, int j, cplx t) {
    const int ncol = n - j - 1;
    if (ncol <= 0) return;
    int g = 32;
    while (g > 1 && g * ncol > (int)blockDim.x) g >>= 1;
    const int cw = 32 / g, lane = threadIdx.x & 31;
    const int l = lane / cw, c = j + 1 + (int)(threadIdx.x >> 5) * cw + lane % cw;
    const bool live = c < n;
    cplx wv = make_cuDoubleComplex(0.0, 0.0);
    if (live)
        for (int k = j + l; k < n; k += g)
            wv = cfma_conj(k == j ? make_cuDoubleComplex(1.0, 0.0) : Q[k * n + j], Q[k * n + c], wv);
    for (int off = 16; off >= cw; off >>= 1) {
        wv.x += __shfl_xor_sync(0xffffffffu, wv.x, off);
        wv.y += __shfl_xor_sync(0xffffffffu, wv.y, off);
    }
    if (!live) return;
    wv = cuCmul(t, wv);
    for (int k = j + l; k < n; k += g)
        Q[k * n + c] = csub(Q[k * n + c], cuCmul(k == j ? make_cuDoubleComplex(1.0, 0.0) : Q[k * n + j], wv));
}

// Q <- its unitary factor by Householder QR in place (zgeqr2, then zung2r),
// log max(|R_jj|, tiny) added to lyap.  Warp 0 takes each column's norm by a
// reduction and one lane the reflector's scalars; every thread shares each
// reflector's update, a group of lanes a column.
__device__ void householder_block(const LyapSmem& s, int n) {
    const int t = threadIdx.x, nt = blockDim.x, lane = t & 31;
    cplx* Q = s.Q;
    cplx* tau = s.r;
    for (int j = 0; j < n; ++j) {
        if (t < 32) {
            double xn2 = 0.0;
            for (int k = j + 1 + lane; k < n; k += 32)
                xn2 = fma(Q[k * n + j].x, Q[k * n + j].x, fma(Q[k * n + j].y, Q[k * n + j].y, xn2));
            xn2 = lyap_warp_sum(xn2);
            if (lane == 0) {
                const cplx alpha = Q[j * n + j];
                cplx scal = make_cuDoubleComplex(1.0, 0.0);
                if (xn2 == 0.0 && alpha.y == 0.0) {
                    tau[j] = make_cuDoubleComplex(0.0, 0.0);
                    s.lyap[j] += log(fmax(fabs(alpha.x), kTiny));
                } else {
                    const double nrm = sqrt(alpha.x * alpha.x + alpha.y * alpha.y + xn2);
                    const double beta = alpha.x >= 0.0 ? -nrm : nrm;
                    tau[j] = make_cuDoubleComplex((beta - alpha.x) / beta, -alpha.y / beta);
                    scal = cuCdiv(make_cuDoubleComplex(1.0, 0.0), make_cuDoubleComplex(alpha.x - beta, alpha.y));
                    Q[j * n + j] = make_cuDoubleComplex(beta, 0.0);
                    s.lyap[j] += log(fmax(nrm, kTiny));
                }
                s.r[n] = scal;  // the reflector's scale, in the slot after tau
            }
        }
        __syncthreads();
        const cplx scal = s.r[n];
        for (int k = j + 1 + t; k < n; k += nt) Q[k * n + j] = cuCmul(Q[k * n + j], scal);
        __syncthreads();
        reflect_columns(Q, n, j, cconj(tau[j]));
        __syncthreads();
    }
    for (int j = n - 1; j >= 0; --j) {
        const cplx tj = tau[j];
        reflect_columns(Q, n, j, tj);
        __syncthreads();
        const cplx mt = make_cuDoubleComplex(-tj.x, -tj.y);
        for (int k = t; k < n; k += nt) {
            if (k > j) Q[k * n + j] = cuCmul(Q[k * n + j], mt);
            else if (k == j) Q[k * n + j] = make_cuDoubleComplex(1.0 - tj.x, -tj.y);
            else Q[k * n + j] = make_cuDoubleComplex(0.0, 0.0);
        }
        __syncthreads();
    }
}

// The arguments of lyapunov_warp_kernel; block b = d * nE + e.
__global__ void __launch_bounds__(kMaxThreads)
    lyapunov_kernel(const cplx* __restrict__ A, const cplx* __restrict__ hinv, const cplx* __restrict__ Bm,
                    const double* __restrict__ w, cplx* __restrict__ Qg, double* __restrict__ lyapg, int64_t nE,
                    int64_t ndis, int S, int64_t nsteps, int stride) {
    extern __shared__ cplx smem[];
    const int t = threadIdx.x, nt = blockDim.x, n = 2 * S, ntop = S * n;
    const LyapSmem s = lyap_smem(smem, S);
    const int64_t b = blockIdx.x;
    const int64_t d = b / nE, e = b % nE;
    for (int q = t; q < n * n; q += nt) s.Q[q] = Qg[b * n * n + q];
    for (int q = t; q < S * S; q += nt) {
        s.A[q] = A[e * S * S + q];
        s.hinv[q] = hinv[q];
        s.Bm[q] = Bm[q];
    }
    for (int q = t; q < n; q += nt) s.lyap[q] = lyapg[b * n + q];
    for (int q = t; q < S; q += nt) s.wv[q] = w[d * S + q];  // step 0
    __syncthreads();
    cplx top[kMaxPer];
    for (int64_t l = 0; l < nsteps; ++l) {
        const double* wl = s.wv + (l & 1) * S;
        // top[s, q] = sum_t (A[s, t] - hinv[s, t] w[t]) Q[t, q] + Bm[s, t] Q[S + t, q]
#pragma unroll
        for (int m = 0; m < kMaxPer; ++m) {
            const int q = t + m * nt;
            if (q >= ntop) continue;
            const int row = q / n, col = q - row * n;
            cplx acc = make_cuDoubleComplex(0.0, 0.0);
            for (int k = 0; k < S; ++k) {
                const cplx h = s.hinv[row * S + k];
                const cplx a = s.A[row * S + k];
                const cplx mk = make_cuDoubleComplex(a.x - h.x * wl[k], a.y - h.y * wl[k]);
                acc = cuCadd(acc, cuCmul(mk, s.Q[k * n + col]));
            }
            for (int k = 0; k < S; ++k) acc = cuCadd(acc, cuCmul(s.Bm[row * S + k], s.Q[(S + k) * n + col]));
            top[m] = acc;
        }
        __syncthreads();
        // each thread moves only its own elements: bottom <- top, top <- new
#pragma unroll
        for (int m = 0; m < kMaxPer; ++m) {
            const int q = t + m * nt;
            if (q >= ntop) continue;
            s.Q[ntop + q] = s.Q[q];
            s.Q[q] = top[m];
        }
        if (l + 1 < nsteps)
            for (int q = t; q < S; q += nt) s.wv[((l + 1) & 1) * S + q] = w[((l + 1) * ndis + d) * S + q];
        __syncthreads();
        if ((l + 1) % stride == 0) householder_block(s, n);
    }
    for (int q = t; q < n * n; q += nt) Qg[b * n * n + q] = s.Q[q];
    for (int q = t; q < n; q += nt) lyapg[b * n + q] = s.lyap[q];
}

// design 0: the block design (S <= 40); 1: the warp design (S <= 8)
extern "C" int pythtb_lyapunov(const void* A, const void* hinv, const void* Bm, const void* w,
                               void* Q, void* lyap, int64_t nE, int64_t ndis, int64_t S,
                               int64_t nsteps, int64_t stride, int64_t design, void* stream) {
    const int64_t nb = nE * ndis;
    if (nb == 0 || nsteps == 0) return 0;
    if (S < 1 || S > kMaxS || stride < 1 || design < 0 || design > 1) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    if (design == 1) {
        if (S > kWarpMaxS) return (int)cudaErrorInvalidValue;
        const unsigned int grid = (unsigned int)((nb + kChainsPerBlock - 1) / kChainsPerBlock);
#define LYAP_WARP(K)                                                                                        \
    lyapunov_warp_kernel<K><<<grid, 32 * kChainsPerBlock, 0, st>>>(                                         \
        (const cplx*)A, (const cplx*)hinv, (const cplx*)Bm, (const double*)w, (cplx*)Q, (double*)lyap, nE, \
        ndis, nsteps, (int)stride)
        switch (S) {
            case 1: LYAP_WARP(1); break;
            case 2: LYAP_WARP(2); break;
            case 3: LYAP_WARP(3); break;
            case 4: LYAP_WARP(4); break;
            case 5: LYAP_WARP(5); break;
            case 6: LYAP_WARP(6); break;
            case 7: LYAP_WARP(7); break;
            case 8: LYAP_WARP(8); break;
            default: break;
        }
#undef LYAP_WARP
        return (int)cudaGetLastError();
    }
    cudaFuncAttributes fa;
    cudaError_t err = cudaFuncGetAttributes(&fa, lyapunov_kernel);
    if (err != cudaSuccess) return (int)err;
    const int ntop = (int)(2 * S * S);
    const int nt = std::min<int>(fa.maxThreadsPerBlock / 32 * 32, (ntop + 31) / 32 * 32);
    if (nt * kMaxPer < ntop) return (int)cudaErrorInvalidConfiguration;
    const size_t smem = lyap_smem_bytes((int)S);
    int dev = 0, optin = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return (int)err;
    if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
    err = cudaFuncSetAttribute(lyapunov_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    lyapunov_kernel<<<(unsigned int)nb, (unsigned int)nt, smem, st>>>(
        (const cplx*)A, (const cplx*)hinv, (const cplx*)Bm, (const double*)w, (cplx*)Q,
        (double*)lyap, nE, ndis, (int)S, nsteps, (int)stride);
    return (int)cudaGetLastError();
}
