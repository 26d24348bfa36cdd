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
// separate det launch).  Larger S goes to the library path in the
// Python wrapper.
#include "common.cuh"

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
        default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
