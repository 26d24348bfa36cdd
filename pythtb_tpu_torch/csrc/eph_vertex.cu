// Kernel 26: the electron-phonon vertex |g|^2.
//
// Replaces the vertex of pythtb_tpu/eph.py:_gsq_qbatch_jit (:250-292):
// the bond tensor over (q, mode, hop), the one-hot matmuls that scatter
// the hops into dH (B, nmode, S, S) ("TPU: scatters with duplicate
// indices serialize", :284-291), and the band sandwich.  The states of k
// and k + q (kernel 1 and eigh_batched, turned to convention II) and the
// phonon amplitudes A come from the caller.  For each electron k of a
// chunk, q of the grid and mode nu:
//
//   g_mn = sum_h coef_h conj(v_{k+q}[m, i_h]) v_k[n, j_h]
//   coef_h = tp_h e^{2 pi i k.R_h} (dhat_h . (A[q, nu, atom(j_h)] e^{2 pi i q.R_h}
//                                            - A[q, nu, atom(i_h)]))
//
// over the directed hop list h (both directions of every bond), and
// |g_mn|^2 is written to gsq (Kc, Q, nmode, S, S).
//
// What bounds it on the H100: at S <= 4 the bytes (the |g|^2 write and
// the v_{k+q} and A reads); at larger S the 8 S^2 nh operations of the
// complex sums a (k, q, mode).  Design: one block per (k, q, mode); the
// block first computes its hops' coefficients (and their orbital pair)
// into shared memory, kVertexChunk hops a round, then a thread per
// element (m, n) -- up to kMaxPer elements a thread -- accumulates over
// the hops in list order (deterministic) in registers.  The dH tensor and
// the one-hot matrices are never formed.
#include "common.cuh"

namespace {

constexpr int kVertexChunk = 512;  // hops a round of shared memory
constexpr int kMaxPer = 16;        // elements a thread: S^2 <= 16 x 256

__global__ void eph_vertex_kernel(const cplx* __restrict__ vk, const cplx* __restrict__ vkq,
                                  const cplx* __restrict__ A, const int* __restrict__ hi,
                                  const int* __restrict__ hj, const int* __restrict__ ai,
                                  const int* __restrict__ aj, const double* __restrict__ R,
                                  const cplx* __restrict__ tp, const double* __restrict__ dhat,
                                  const double* __restrict__ kpts, const double* __restrict__ qg,
                                  double* __restrict__ gsq, int64_t Q, int nmode, int natom, int S, int d,
                                  int nh) {
    __shared__ cplx coef[kVertexChunk];
    __shared__ int2 pair[kVertexChunk];
    const int64_t blk = blockIdx.x;  // ((kc Q) + q) nmode + nu
    const int nu = (int)(blk % nmode);
    const int64_t kq = blk / nmode;
    const int64_t q = kq % Q;
    const int64_t kc = kq / Q;
    const double* k = kpts + kc * d;
    const double* qq = qg + q * d;
    const cplx* Aq = A + (q * nmode + nu) * (int64_t)natom * d;
    const int SS = S * S;
    const cplx* vK = vk + kc * SS;
    const cplx* vKQ = vkq + kq * SS;
    cplx acc[kMaxPer];
#pragma unroll
    for (int j = 0; j < kMaxPer; ++j) acc[j] = make_cuDoubleComplex(0.0, 0.0);

    for (int h0 = 0; h0 < nh; h0 += kVertexChunk) {
        const int nc = min(kVertexChunk, nh - h0);
        for (int c = threadIdx.x; c < nc; c += blockDim.x) {
            const int h = h0 + c;
            double xk = 0.0, xq = 0.0;
            for (int a = 0; a < d; ++a) {
                xk = fma(k[a], R[(int64_t)h * d + a], xk);
                xq = fma(qq[a], R[(int64_t)h * d + a], xq);
            }
            double sk, ck, sq, cq;
            sincospi(2.0 * xk, &sk, &ck);  // e^{2 pi i k.R}
            sincospi(2.0 * xq, &sq, &cq);  // e^{2 pi i q.R}
            double br = 0.0, bi = 0.0;     // dhat . (A_j e^{2 pi i q.R} - A_i)
            for (int a = 0; a < d; ++a) {
                const cplx Aj = Aq[aj[h] * d + a], Ai = Aq[ai[h] * d + a];
                const double dh = dhat[(int64_t)h * d + a];
                br += dh * (Aj.x * cq - Aj.y * sq - Ai.x);
                bi += dh * (Aj.x * sq + Aj.y * cq - Ai.y);
            }
            const cplx t = tp[h];
            const double pr = t.x * ck - t.y * sk, pi = t.x * sk + t.y * ck;  // tp e^{2 pi i k.R}
            coef[c] = make_cuDoubleComplex(pr * br - pi * bi, pr * bi + pi * br);
            pair[c] = make_int2(hi[h], hj[h]);
        }
        __syncthreads();
#pragma unroll
        for (int j = 0; j < kMaxPer; ++j) {
            const int e = threadIdx.x + j * blockDim.x;
            if (e < SS) {
                const int m = e / S, n = e - m * S;
                double re = acc[j].x, im = acc[j].y;
                for (int c = 0; c < nc; ++c) {
                    const cplx x = cuCmul(coef[c], cmul_conj(vKQ[m * S + pair[c].x], vK[n * S + pair[c].y]));
                    re += x.x;
                    im += x.y;
                }
                acc[j] = make_cuDoubleComplex(re, im);
            }
        }
        __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < kMaxPer; ++j) {
        const int e = threadIdx.x + j * blockDim.x;
        if (e < SS) gsq[blk * SS + e] = acc[j].x * acc[j].x + acc[j].y * acc[j].y;
    }
}

}  // namespace

// Kernel 26.  vk (Kc, S, S), vkq (Kc, Q, S, S) c128, states as rows in
// convention II; A (Q, nmode, natom, d) c128; hi, hj, ai, aj (nh,) i32
// (orbitals and their atoms); R (nh, d), dhat (nh, d) f64; tp (nh,) c128;
// kpts (Kc, d), qg (Q, d) f64; gsq (Kc, Q, nmode, S, S) f64.  threads a
// multiple of 32, at most 256, with S^2 <= 16 threads.
extern "C" int pythtb_eph_vertex(const void* vk, const void* vkq, const void* A, const void* hi, const void* hj,
                                 const void* ai, const void* aj, const void* R, const void* tp, const void* dhat,
                                 const void* kpts, const void* qg, void* gsq, int64_t Kc, int64_t Q, int64_t nmode,
                                 int64_t natom, int64_t S, int64_t d, int64_t nh, int64_t threads, void* stream) {
    const int64_t blocks = Kc * Q * nmode;
    if (blocks > 0) {
        eph_vertex_kernel<<<(unsigned int)blocks, (unsigned int)threads, 0, (cudaStream_t)stream>>>(
            (const cplx*)vk, (const cplx*)vkq, (const cplx*)A, (const int*)hi, (const int*)hj, (const int*)ai,
            (const int*)aj, (const double*)R, (const cplx*)tp, (const double*)dhat, (const double*)kpts,
            (const double*)qg, (double*)gsq, Q, (int)nmode, (int)natom, (int)S, (int)d, (int)nh);
    }
    return (int)cudaGetLastError();
}
