// Kernel 25: the phonon kappa sweep.
//
// Replaces the velocity and temperature part of
// pythtb_tpu/phonon.py:_kappa_jit (:389-444): the (B, dim_k, N, N) dD
// sandwich "bns,bast,bnt->ban", the guarded Hellmann-Feynman velocities,
// the (nT, B, N) heat-capacity array and the einsum "tbn,ban,bcn->tac".
// D and its eigenvectors come from kernel 1 and eigh_batched, dD/dk_a
// from kernel 15, on the caller's side.
//
//   kappa_red[t, a, c] = (1 / B) sum_{b, n} cv(omega_bn / T_t) v_a v_c
//   v_a = Re(e_n^H dD_a e_n) / (2 omega_bn), 0 where omega_bn <= 1e-9
//   cv(x) = (x / (2 sinh(min(x, 80) / 2)))^2, 1 where x < 1e-8
//
// What bounds it on the H100: the bytes of the eigenvectors and dD (16 (1
// + dim_k) B N^2), read once; the sweep's ~30 operations per (k, mode,
// T) come second at the kappa row (768^2, N 4, 40 T).  Design: one thread
// per (k, mode) forms its dim_k velocities in registers, then walks the
// temperatures; per temperature the block adds its threads' cv v_a v_c
// with warp shuffles (a fixed tree) and its eight warp sums in order, and
// writes one partial (nT, dim_k^2) slot a block.  A second pass adds the
// blocks' slots in a fixed order (kernel 17's two-pass pattern, with a
// block tree), so the sum order is fixed (deterministic).  The (B, dim_k,
// N) velocity array and the (nT, B, N) weights never reach memory.
#include "common.cuh"

namespace {

constexpr int kKappaThreads = 256;
constexpr int kKappaWarps = kKappaThreads / 32;
constexpr int kMaxDim = 3;
constexpr int kTChunk = 16;  // temperatures a round of the shared buffer

__device__ __forceinline__ double warp_sum(double v) {  // lane 0 holds the sum
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    return v;
}

__device__ __forceinline__ double cv_weight(double x) {
    if (x < 1e-8) return 1.0;
    const double r = x / (2.0 * sinh(fmin(x, 80.0) / 2.0));
    return r * r;
}

__global__ void kappa_partial_kernel(const cplx* __restrict__ vecs, const cplx* __restrict__ dD,
                                     const double* __restrict__ omega, const double* __restrict__ Ts,
                                     double* __restrict__ partial, int64_t total, int N, int dk, int nT) {
    __shared__ double red[kKappaWarps][kTChunk * kMaxDim * kMaxDim];
    const int64_t item = (int64_t)blockIdx.x * kKappaThreads + threadIdx.x;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int dd = dk * dk;
    double v[kMaxDim] = {0.0, 0.0, 0.0};
    double w = 0.0;
    if (item < total) {
        const int64_t b = item / N;
        w = omega[item];
        if (w > 1e-9) {
            const cplx* e = vecs + item * N;  // row n of vecs[b]
#pragma unroll
            for (int a = 0; a < kMaxDim; ++a) {
                if (a < dk) {
                    const cplx* M = dD + (b * dk + a) * (int64_t)N * N;
                    double acc = 0.0;
                    for (int s = 0; s < N; ++s) {
                        double re = 0.0, im = 0.0;  // (dD_a e)_s
                        for (int t = 0; t < N; ++t) {
                            const cplx m = M[s * N + t], et = e[t];
                            re += m.x * et.x - m.y * et.y;
                            im += m.x * et.y + m.y * et.x;
                        }
                        acc += e[s].x * re + e[s].y * im;  // Re(conj(e_s) (dD_a e)_s)
                    }
                    v[a] = acc / (2.0 * w);
                }
            }
        }
    }
    for (int t0 = 0; t0 < nT; t0 += kTChunk) {
        const int nt = min(kTChunk, nT - t0);
        for (int t = 0; t < nt; ++t) {
            const double cv = item < total ? cv_weight(w / Ts[t0 + t]) : 0.0;
#pragma unroll
            for (int a = 0; a < kMaxDim; ++a) {
#pragma unroll
                for (int c = 0; c < kMaxDim; ++c) {
                    if (a < dk && c < dk) {
                        const double s = warp_sum(cv * v[a] * v[c]);
                        if (lane == 0) red[warp][t * dd + a * dk + c] = s;
                    }
                }
            }
        }
        __syncthreads();
        for (int idx = threadIdx.x; idx < nt * dd; idx += kKappaThreads) {
            double s = 0.0;
#pragma unroll
            for (int wp = 0; wp < kKappaWarps; ++wp) s += red[wp][idx];
            partial[((int64_t)blockIdx.x * nT + t0) * dd + idx] = s;
        }
        __syncthreads();
    }
}

// one block per output (t, a, c): its threads stride over the partial
// slots in order, then a block tree
__global__ void kappa_reduce_kernel(const double* __restrict__ partial, double* __restrict__ out, int64_t nblocks,
                                    int nout, double scale) {
    __shared__ double red[kKappaThreads];
    const int o = blockIdx.x;
    double s = 0.0;
    for (int64_t p = threadIdx.x; p < nblocks; p += kKappaThreads) s += partial[p * nout + o];
    red[threadIdx.x] = s;
    __syncthreads();
    for (int st = kKappaThreads / 2; st > 0; st >>= 1) {
        if (threadIdx.x < st) red[threadIdx.x] += red[threadIdx.x + st];
        __syncthreads();
    }
    if (threadIdx.x == 0) out[o] = red[0] * scale;
}

}  // namespace

// Kernel 25.  vecs (B, N, N) c128, rows are modes; dD (B, dk, N, N) c128;
// omega (B, N) f64; Ts (nT,) f64 > 0; partial (ceil(B N / 256), nT, dk, dk)
// f64 scratch; out (nT, dk, dk) f64.  dk <= 3.
extern "C" int pythtb_phonon_kappa(const void* vecs, const void* dD, const void* omega, const void* Ts, void* partial,
                                   void* out, int64_t B, int64_t N, int64_t dk, int64_t nT, void* stream) {
    const int64_t total = B * N;
    const int64_t nblocks = (total + kKappaThreads - 1) / kKappaThreads;
    if (nblocks > 0 && nT > 0 && dk > 0) {
        kappa_partial_kernel<<<(unsigned int)nblocks, kKappaThreads, 0, (cudaStream_t)stream>>>(
            (const cplx*)vecs, (const cplx*)dD, (const double*)omega, (const double*)Ts, (double*)partial, total,
            (int)N, (int)dk, (int)nT);
        kappa_reduce_kernel<<<(unsigned int)(nT * dk * dk), kKappaThreads, 0, (cudaStream_t)stream>>>(
            (const double*)partial, (double*)out, nblocks, (int)(nT * dk * dk), 1.0 / (double)B);
    }
    return (int)cudaGetLastError();
}
