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
// The QR is Householder's, in place in shared memory (the reflectors
// below the diagonal, then the unitary factor formed from them, as
// LAPACK's zgeqr2 and zung2r do): it stays backward stable however far
// apart the exponents of a stride's product are, where Gram-Schmidt,
// even applied twice, loses the frame once that product's condition
// number nears 1 / eps.  The sums of log |R_jj| do not depend on the
// phases of Q's columns, so the kernel's signs need not be LAPACK's.
//
// What bounds it on the H100: latency.  The work is some 4 S^3 complex
// multiply-adds a step and a QR every `stride` steps (the row: 512
// energies x 200,000 steps of S 8, ~2e12 float64 operations, some 60 ms
// at the float64 peak), the bytes only the (steps, realizations, S)
// onsite values, read by every energy's block from L2.  Design: one block
// per (realization, energy) keeps Q, A_E, Hinv and Bm in shared memory
// for all the steps of a launch (at S 40 some 180 KB, opted in above
// 48 KB); each thread owns up to kMaxPer elements of the new top block in
// registers, so the step needs no second frame; the onsite values of the
// next step are loaded while the current one is written (double
// buffer).  Sums run in a fixed order.  The wrapper launches once per
// chunk of whole macro steps, carrying Q and the sums in global memory,
// so one chunk's onsite values bound the memory used.  Above S 40
// (cudaErrorInvalidValue) the Python wrapper raises before it gets here.
#include <algorithm>

#include "common.cuh"

constexpr int kMaxS = 40;   // 2S x 2S frame of 80 x 80 complex: 100 KB
constexpr int kMaxPer = 8;  // top-block elements a thread keeps in registers
constexpr int kMaxThreads = 512;  // 512 x kMaxPer covers the 3,200 top entries at S 40

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

// Q <- its unitary factor by Householder QR in place (LAPACK's zgeqr2, then
// zung2r to form Q from the reflectors kept below the diagonal), log
// max(|R_jj|, tiny) added to lyap.  Thread 0 takes each column's norm and
// reflector; the threads share the columns of each reflector's update.
__device__ void householder(const LyapSmem& s, int n) {
    const int t = threadIdx.x, nt = blockDim.x;
    cplx* Q = s.Q;
    cplx* tau = s.r;
    for (int j = 0; j < n; ++j) {
        if (t == 0) {
            double xn2 = 0.0;
            for (int k = j + 1; k < n; ++k) xn2 += Q[k * n + j].x * Q[k * n + j].x + Q[k * n + j].y * Q[k * n + j].y;
            const cplx alpha = Q[j * n + j];
            cplx scal = make_cuDoubleComplex(1.0, 0.0);
            if (xn2 == 0.0 && alpha.y == 0.0) {
                tau[j] = make_cuDoubleComplex(0.0, 0.0);
                s.lyap[j] += log(fmax(fabs(alpha.x), 2.2250738585072014e-308));
            } else {
                const double nrm = sqrt(alpha.x * alpha.x + alpha.y * alpha.y + xn2);
                const double beta = alpha.x >= 0.0 ? -nrm : nrm;
                tau[j] = make_cuDoubleComplex((beta - alpha.x) / beta, -alpha.y / beta);
                scal = cuCdiv(make_cuDoubleComplex(1.0, 0.0), make_cuDoubleComplex(alpha.x - beta, alpha.y));
                Q[j * n + j] = make_cuDoubleComplex(beta, 0.0);
                s.lyap[j] += log(fmax(nrm, 2.2250738585072014e-308));
            }
            s.r[n] = scal;  // the reflector's scale, in the slot after tau
        }
        __syncthreads();
        const cplx scal = s.r[n];
        for (int k = j + 1 + t; k < n; k += nt) Q[k * n + j] = cuCmul(Q[k * n + j], scal);
        __syncthreads();
        // A(j:, c) -= conj(tau) v (v^H A(j:, c)), v = [1; Q(j+1:, j)], for c > j
        const cplx tc = cconj(tau[j]);
        for (int c = j + 1 + t; c < n; c += nt) {
            cplx w = Q[j * n + c];
            for (int k = j + 1; k < n; ++k) w = cuCadd(w, cmul_conj(Q[k * n + j], Q[k * n + c]));
            w = cuCmul(tc, w);
            Q[j * n + c] = csub(Q[j * n + c], w);
            for (int k = j + 1; k < n; ++k) Q[k * n + c] = csub(Q[k * n + c], cuCmul(Q[k * n + j], w));
        }
        __syncthreads();
    }
    // form Q: for j = n-1 .. 0, A(j:, j+1:) = H_j A(j:, j+1:), then column j
    for (int j = n - 1; j >= 0; --j) {
        const cplx tj = tau[j];
        for (int c = j + 1 + t; c < n; c += nt) {
            cplx w = Q[j * n + c];  // v_j = 1
            for (int k = j + 1; k < n; ++k) w = cuCadd(w, cmul_conj(Q[k * n + j], Q[k * n + c]));
            w = cuCmul(tj, w);
            Q[j * n + c] = csub(Q[j * n + c], w);
            for (int k = j + 1; k < n; ++k) Q[k * n + c] = csub(Q[k * n + c], cuCmul(Q[k * n + j], w));
        }
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

// A (nE, S, S), hinv (S, S), Bm (S, S) complex; w (nsteps, ndis, S) float64;
// Q (ndis, nE, 2S, 2S) complex and lyap (ndis, nE, 2S) float64, read and
// written.  Block b = d * nE + e.
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
        if ((l + 1) % stride == 0) householder(s, n);
    }
    for (int q = t; q < n * n; q += nt) Qg[b * n * n + q] = s.Q[q];
    for (int q = t; q < n; q += nt) lyapg[b * n + q] = s.lyap[q];
}

extern "C" int pythtb_lyapunov(const void* A, const void* hinv, const void* Bm, const void* w,
                               void* Q, void* lyap, int64_t nE, int64_t ndis, int64_t S,
                               int64_t nsteps, int64_t stride, void* stream) {
    const int64_t nb = nE * ndis;
    if (nb == 0 || nsteps == 0) return 0;
    if (S < 1 || S > kMaxS || stride < 1) return (int)cudaErrorInvalidValue;
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
    lyapunov_kernel<<<(unsigned int)nb, (unsigned int)nt, smem, (cudaStream_t)stream>>>(
        (const cplx*)A, (const cplx*)hinv, (const cplx*)Bm, (const double*)w, (cplx*)Q,
        (double*)lyap, nE, ndis, (int)S, nsteps, (int)stride);
    return (int)cudaGetLastError();
}
