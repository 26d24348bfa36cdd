// Kernel 5: Wilson loops -- polar factors of the link overlaps, chained.
//
// Replaces pythtb_tpu/ops/berry.py:_berry_products_jit and its inlined
// copies in flows.py (_wilson_half_cycle, _wilson_flow_jit), which XLA
// fused into one program: link overlaps, SVD unitarization U V^H per
// link, and the ordered product by associative scan.  For states w laid
// out as (outer, L, inner, S, F) -- any grid axis is the L of such a
// view, with no copy -- each string (o, i) gets
//   P = W_0 W_1 ... W_{L-2},  W_l = polar(M_l),  M_l = <w_l | w_{l+1}>
// written to prod (outer, inner, S, S), and the smallest singular value
// of its links to smin (outer, inner).
//
// What bounds it on the H100: reading the states, outer*L*inner*S*F*16
// bytes, each state once per string; the overlaps take S*S*F complex
// multiply-adds per link and the polar factors and the chain O(S^3) more,
// far below the fp64 peak at the main path's S <= 4.  Design: one thread
// per string walks its links in order (the TPU's log-depth scan becomes a
// loop; the products agree to rounding, about L*eps, not bit for bit).
// The overlap, its polar factor and the running product stay in
// registers (S is a template parameter, so every loop unrolls):
//   S = 1: M / |M|;
//   S = 2: closed form U = (M + phi adj(M)^H) / (s1 + s2), phi = det/|det|,
//          s1 + s2 = sqrt(|M|_F^2 + 2 |det M|);
//   3 <= S <= 8: one-sided (Hestenes) Jacobi on the columns of M -- the
//          Jacobi eigensolve of M^H M carried out on M itself, so the
//          condition number is not squared -- giving M V = U S, and
//          polar(M) = (M V) S^-1 V^H.
// 9 <= S <= 64: one block per string (wilson_loop_block_kernel), the
// overlap, the running product and the polar scratch in dynamic shared
// memory (three S x S complex matrices, 192 kB at S 64), the overlap
// entries spread over the block's threads and the polar factor by
// polar_factor_block (polar.cuh).  Larger S is refused.  Most of the
// card idles at the main path's few strings (Kane-Mele 41 x 41: 40).
#include "polar.cuh"

template <int S>
__global__ void wilson_loop_kernel(const cplx* __restrict__ w, cplx* __restrict__ prod,
                                   double* __restrict__ smin_out, int64_t outer, int64_t L,
                                   int64_t inner, int F) {
    const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= outer * inner) return;
    const int64_t i = t % inner;
    const int64_t o = t / inner;
    const int64_t SF = (int64_t)S * F;
    const cplx* base = w + (o * L * inner + i) * SF;

    cplx P[S][S];
#pragma unroll
    for (int r = 0; r < S; ++r)
#pragma unroll
        for (int c = 0; c < S; ++c) P[r][c] = make_cuDoubleComplex(r == c ? 1.0 : 0.0, 0.0);
    double smin = 1.0e300;
    for (int64_t l = 0; l + 1 < L; ++l) {
        const cplx* wa = base + l * inner * SF;
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
        smin = fmin(smin, polar_factor<S>(M));
        // P <- P M, row by row
#pragma unroll
        for (int r = 0; r < S; ++r) {
            cplx row[S];
#pragma unroll
            for (int c = 0; c < S; ++c) {
                cplx acc = make_cuDoubleComplex(0.0, 0.0);
#pragma unroll
                for (int k = 0; k < S; ++k) acc = cuCadd(acc, cuCmul(P[r][k], M[k][c]));
                row[c] = acc;
            }
#pragma unroll
            for (int c = 0; c < S; ++c) P[r][c] = row[c];
        }
    }
    cplx* out = prod + t * S * S;
#pragma unroll
    for (int r = 0; r < S; ++r)
#pragma unroll
        for (int c = 0; c < S; ++c) out[r * S + c] = P[r][c];
    smin_out[t] = smin;
}

// Overlap M[n][m] = <wa_n | wb_m> of S rows of F components, into shared M.
__device__ __forceinline__ void block_overlap(const cplx* __restrict__ wa, const cplx* __restrict__ wb,
                                              cplx* M, int S, int F) {
    for (int e = threadIdx.x; e < S * S; e += kBlockThreads) {
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
}

__global__ void __launch_bounds__(kBlockThreads)
wilson_loop_block_kernel(const cplx* __restrict__ w, cplx* __restrict__ prod, double* __restrict__ smin_out,
                         int64_t L, int64_t inner, int S, int F) {
    extern __shared__ double smem[];
    cplx* P = (cplx*)smem;
    cplx* M = P + S * S;
    cplx* V = M + S * S;
    double* red = (double*)(V + S * S);
    const int64_t t = blockIdx.x;  // the string
    const int64_t i = t % inner;
    const int64_t o = t / inner;
    const int64_t SF = (int64_t)S * F;
    const cplx* base = w + (o * L * inner + i) * SF;
    for (int e = threadIdx.x; e < S * S; e += kBlockThreads)
        P[e] = make_cuDoubleComplex(e / S == e % S ? 1.0 : 0.0, 0.0);
    double smin = 1.0e300;
    for (int64_t l = 0; l + 1 < L; ++l) {
        const cplx* wa = base + l * inner * SF;
        block_overlap(wa, wa + inner * SF, M, S, F);
        smin = fmin(smin, polar_factor_block(M, V, S, red));
        block_mul_left(P, M, S);  // P <- P W_l
    }
    cplx* out = prod + t * S * S;
    for (int e = threadIdx.x; e < S * S; e += kBlockThreads) out[e] = P[e];
    if (threadIdx.x == 0) smin_out[t] = smin;
}

template <int S>
static void launch(const void* w, void* prod, void* smin, int64_t outer, int64_t L, int64_t inner,
                   int64_t F, cudaStream_t stream) {
    wilson_loop_kernel<S><<<blocks_for(outer * inner), kThreads, 0, stream>>>(
        (const cplx*)w, (cplx*)prod, (double*)smin, outer, L, inner, (int)F);
}

extern "C" int pythtb_wilson_loop(const void* w, void* prod, void* smin, int64_t outer, int64_t L,
                                  int64_t inner, int64_t S, int64_t F, void* stream) {
    if (outer * inner <= 0) return (int)cudaGetLastError();
    cudaStream_t st = (cudaStream_t)stream;
    switch (S) {
        case 1: launch<1>(w, prod, smin, outer, L, inner, F, st); break;
        case 2: launch<2>(w, prod, smin, outer, L, inner, F, st); break;
        case 3: launch<3>(w, prod, smin, outer, L, inner, F, st); break;
        case 4: launch<4>(w, prod, smin, outer, L, inner, F, st); break;
        case 5: launch<5>(w, prod, smin, outer, L, inner, F, st); break;
        case 6: launch<6>(w, prod, smin, outer, L, inner, F, st); break;
        case 7: launch<7>(w, prod, smin, outer, L, inner, F, st); break;
        case 8: launch<8>(w, prod, smin, outer, L, inner, F, st); break;
        default: {
            if (S > kPolarBlockMaxS) return (int)cudaErrorInvalidValue;
            const size_t smem = block_smem(wilson_loop_block_kernel, (int)S, 3);
            wilson_loop_block_kernel<<<(unsigned int)(outer * inner), kBlockThreads, smem, st>>>(
                (const cplx*)w, (cplx*)prod, (double*)smin, L, inner, (int)S, (int)F);
        }
    }
    return (int)cudaGetLastError();
}
