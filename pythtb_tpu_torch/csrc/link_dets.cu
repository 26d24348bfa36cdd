// Kernel 3: link-overlap determinants along one grid axis.
//
// Replaces pythtb_tpu/ops/berry.py:_overlap + _dets + _link_dets (and
// the same pair inside _berry_traced_jit), which XLA fused into one
// program: for states w laid out as (outer, L, inner, S, F) -- any grid
// axis is the L of such a view, with no copy -- it computes
//   det_{n,m} <w[o, l, i, n, :] | w[o, l+1, i, m, :]>
// for every link (o, l, i), l < L-1, into (outer, L-1, inner).
//
// What bounds it on the H100: reading the states, 2*S*F*16 bytes per
// link, each state read by its two links; the flops are S*S*F complex
// multiply-adds plus an S^3 elimination.  Design: one thread per link
// forms the S x S overlap in registers (S is a template parameter, so the
// loops unroll) and takes its determinant there: closed form for S <= 2,
// LU with partial pivoting for S <= 8.  The overlap matrices never reach
// device memory (eager PyTorch would write them and read them back for a
// separate det launch).  For 9 <= S <= 64 one block of 256 threads takes
// a link (link_dets_block_kernel): the overlap in dynamic shared memory
// (64 kB at S 64), its entries spread over the threads, and the same LU
// with partial pivoting there -- a warp finds the pivot, the block swaps
// and eliminates the trailing rows.  Larger S is refused.
#include "common.cuh"

constexpr int kDetBlockMaxS = 64;
constexpr int kDetThreads = 256;

template <int S>
__device__ __forceinline__ cplx det_small(cplx (&M)[S][S]) {
    if constexpr (S == 1) {
        return M[0][0];
    } else if constexpr (S == 2) {
        return cuCsub(cuCmul(M[0][0], M[1][1]), cuCmul(M[0][1], M[1][0]));
    } else {
        cplx det = make_cuDoubleComplex(1.0, 0.0);
#pragma unroll
        for (int col = 0; col < S; ++col) {
            // pivot on |re| + |im|, as LAPACK's izamax does
            int piv = col;
            double best = fabs(M[col][col].x) + fabs(M[col][col].y);
#pragma unroll
            for (int r = col + 1; r < S; ++r) {
                const double mag = fabs(M[r][col].x) + fabs(M[r][col].y);
                if (mag > best) {
                    best = mag;
                    piv = r;
                }
            }
            if (best == 0.0) return make_cuDoubleComplex(0.0, 0.0);
            if (piv != col) {
                // swap with static indices only, so M stays in registers
#pragma unroll
                for (int r = col + 1; r < S; ++r) {
                    if (r == piv) {
#pragma unroll
                        for (int c2 = col; c2 < S; ++c2) {
                            const cplx tmp = M[col][c2];
                            M[col][c2] = M[r][c2];
                            M[r][c2] = tmp;
                        }
                    }
                }
                det = make_cuDoubleComplex(-det.x, -det.y);
            }
            det = cuCmul(det, M[col][col]);
#pragma unroll
            for (int r = col + 1; r < S; ++r) {
                const cplx f = cuCdiv(M[r][col], M[col][col]);
#pragma unroll
                for (int c2 = col + 1; c2 < S; ++c2) M[r][c2] = cuCsub(M[r][c2], cuCmul(f, M[col][c2]));
            }
        }
        return det;
    }
}

template <int S>
__global__ void link_dets_kernel(const cplx* __restrict__ w, cplx* __restrict__ out,
                                 int64_t outer, int64_t L, int64_t inner, int F) {
    const int64_t nlinks = outer * (L - 1) * inner;
    const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= nlinks) return;
    const int64_t i = t % inner;
    const int64_t rest = t / inner;
    const int64_t l = rest % (L - 1);
    const int64_t o = rest / (L - 1);
    const int64_t SF = (int64_t)S * F;
    const cplx* wa = w + ((o * L + l) * inner + i) * SF;
    const cplx* wb = wa + inner * SF;

    cplx M[S][S];
#pragma unroll
    for (int n = 0; n < S; ++n) {
#pragma unroll
        for (int m = 0; m < S; ++m) {
            double re = 0.0, im = 0.0;
            for (int f = 0; f < F; ++f) {
                const cplx z = cmul_conj(wa[n * F + f], wb[m * F + f]);
                re += z.x;
                im += z.y;
            }
            M[n][m] = make_cuDoubleComplex(re, im);
        }
    }
    out[t] = det_small<S>(M);
}

__global__ void __launch_bounds__(kDetThreads)
link_dets_block_kernel(const cplx* __restrict__ w, cplx* __restrict__ out, int64_t L, int64_t inner, int S,
                       int F) {
    extern __shared__ double smem[];
    cplx* M = (cplx*)smem;
    __shared__ int piv_s;
    __shared__ double best_s;
    const int tid = threadIdx.x, lane = tid & 31;
    const int64_t t = blockIdx.x;  // the link
    const int64_t i = t % inner;
    const int64_t rest = t / inner;
    const int64_t l = rest % (L - 1);
    const int64_t o = rest / (L - 1);
    const int64_t SF = (int64_t)S * F;
    const cplx* wa = w + ((o * L + l) * inner + i) * SF;
    const cplx* wb = wa + inner * SF;
    for (int e = tid; e < S * S; e += kDetThreads) {
        const int n = e / S, m = e % S;
        double re = 0.0, im = 0.0;
        for (int f = 0; f < F; ++f) {
            const cplx z = cmul_conj(wa[n * F + f], wb[m * F + f]);
            re += z.x;
            im += z.y;
        }
        M[e] = make_cuDoubleComplex(re, im);
    }
    __syncthreads();
    cplx det = make_cuDoubleComplex(1.0, 0.0);  // kept by thread 0
    for (int col = 0; col < S; ++col) {
        if (tid < 32) {
            // pivot on |re| + |im|, the first row of the largest (as izamax)
            double best = -1.0;
            int piv = S;
            for (int r = col + lane; r < S; r += 32) {
                const double mag = fabs(M[r * S + col].x) + fabs(M[r * S + col].y);
                if (mag > best) {
                    best = mag;
                    piv = r;
                }
            }
            for (int off = 16; off > 0; off >>= 1) {
                const double ob = __shfl_down_sync(0xffffffffu, best, off);
                const int op = __shfl_down_sync(0xffffffffu, piv, off);
                if (ob > best || (ob == best && op < piv)) {
                    best = ob;
                    piv = op;
                }
            }
            if (lane == 0) {
                piv_s = piv;
                best_s = best;
            }
        }
        __syncthreads();
        const int piv = piv_s;
        if (best_s == 0.0) {
            det = make_cuDoubleComplex(0.0, 0.0);
            break;  // block-uniform
        }
        if (piv != col) {
            for (int c2 = col + tid; c2 < S; c2 += kDetThreads) {
                const cplx tmp = M[col * S + c2];
                M[col * S + c2] = M[piv * S + c2];
                M[piv * S + c2] = tmp;
            }
            det = make_cuDoubleComplex(-det.x, -det.y);
        }
        __syncthreads();
        det = cuCmul(det, M[col * S + col]);
        const int n = S - col - 1;
        for (int e = tid; e < n * n; e += kDetThreads) {
            const int r = col + 1 + e / n, c2 = col + 1 + e % n;
            const cplx f = cuCdiv(M[r * S + col], M[col * S + col]);
            M[r * S + c2] = cuCsub(M[r * S + c2], cuCmul(f, M[col * S + c2]));
        }
        __syncthreads();
    }
    if (tid == 0) out[t] = det;
}

template <int S>
static void launch(const void* w, void* out, int64_t outer, int64_t L, int64_t inner, int64_t F,
                   cudaStream_t stream) {
    const int64_t nlinks = outer * (L - 1) * inner;
    link_dets_kernel<S><<<blocks_for(nlinks), kThreads, 0, stream>>>(
        (const cplx*)w, (cplx*)out, outer, L, inner, (int)F);
}

extern "C" int pythtb_link_dets(const void* w, void* out, int64_t outer, int64_t L, int64_t inner,
                                int64_t S, int64_t F, void* stream) {
    if (outer * (L - 1) * inner <= 0) return (int)cudaGetLastError();
    cudaStream_t st = (cudaStream_t)stream;
    switch (S) {
        case 1: launch<1>(w, out, outer, L, inner, F, st); break;
        case 2: launch<2>(w, out, outer, L, inner, F, st); break;
        case 3: launch<3>(w, out, outer, L, inner, F, st); break;
        case 4: launch<4>(w, out, outer, L, inner, F, st); break;
        case 5: launch<5>(w, out, outer, L, inner, F, st); break;
        case 6: launch<6>(w, out, outer, L, inner, F, st); break;
        case 7: launch<7>(w, out, outer, L, inner, F, st); break;
        case 8: launch<8>(w, out, outer, L, inner, F, st); break;
        default: {
            if (S > kDetBlockMaxS) return (int)cudaErrorInvalidValue;
            const size_t smem = (size_t)S * S * sizeof(cplx);
            cudaFuncSetAttribute(link_dets_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
            link_dets_block_kernel<<<(unsigned int)(outer * (L - 1) * inner), kDetThreads, smem, st>>>(
                (const cplx*)w, (cplx*)out, L, inner, (int)S, (int)F);
        }
    }
    return (int)cudaGetLastError();
}
