// Kernel 11b: the dense Chebyshev filter of the ED sector solver,
//   F = T_p((H - c) / hw) X  (three-term recurrence, rescaled per column),
// H a dense (D, D) complex128 sector Hamiltonian, X a (D, nb) block.
//
// Replaces the lax.scan of pythtb_tpu/ed.py:_chebfilter_dev (:238-284):
//   T_1 X = (H X - c X) / hw;  then p - 1 steps of
//   n = 2 (H b - c b) / hw - a,  s = max(max_rows |n|, 1) per column,
//   (a, b) <- (b / s, n / s);
// the result is the last b (T_1 X itself for p <= 1).  The complex
// (D x D) x (D x nb) product of every step is computed here, by hand.
//
// What bounds it on the H100: bytes.  At the ed_hubbard_8site_4900dim
// row (D 4,900, nb 10) a step streams H once, 384 MB, ~115 us at 3.35
// TB/s, against 8 D^2 nb = 1.9 GFLOP, ~56 us at the float64 peak; the
// (D, nb) block (784 kB) stays in the 50 MB L2.  Design: the product is
// a tiled GEMM with a thin N.  A block owns 128 rows of H and up to 16
// columns of the block, in tiles of 8 H columns staged in shared memory
// by asynchronous 16-byte copies into two buffers (the next tile's copies
// fly while this one is used; rows padded by one element, so that the
// eight rows a warp reads at once fall on distinct banks); each thread
// keeps 4 rows x CPT columns of sums in registers, so a staged value
// feeds several products.  The H columns are split into slices (a third
// grid dimension) so that some four blocks an SM run at D 4,900; each
// slice writes its partial product, and the epilogue adds the slices in
// order (deterministic), applies 2 ((H b - c b) / hw) - a (the first
// step: (H X - c X) / hw), writes n over a in place and each block's
// column maxima.  A small reduction turns those into the scale s and an
// elementwise pass writes a = b / s, b = n / s: four launches a step, all
// issued by the C entry point for the whole filter.  (Earlier versions on
// the H100, a p = 30 filter at D 4,900: a warp per row with the block
// staged row-major, 66 ms -- lanes 256 bytes apart on one bank group, an
// 8-way conflict on every read; column-major, two rows a warp, 22.7 ms at
// one block an SM; single-buffered tiles of 16, 7.2 ms; this one 6.9 ms,
// 106 registers a thread, four blocks an SM.)
#include <cuda_pipeline.h>

#include "common.cuh"

constexpr int kBR = 128;             // rows of H a block
constexpr int kRPT = 4;              // rows a thread
constexpr int kGroups = 4;           // column groups a row (threads sharing its rows)
constexpr int kPThreads = kBR / kRPT * kGroups;  // 128
constexpr int kTJ = 8;               // H columns a staged tile (two buffers)
constexpr int kEThreads = 256;       // rows an epilogue block

// stage the H tile of columns [j0, j0 + nt) of the block's rows and the
// matching b rows into buffer `buf`: asynchronous 16-byte copies where the
// element exists (a zero otherwise), committed as one batch
template <int NC>
__device__ __forceinline__ void stage_tile(cplx (*hs)[kTJ + 1], cplx (*bs)[NC], const cplx* __restrict__ H,
                                           const cplx* __restrict__ bin, int64_t r0, int64_t j0, int nt,
                                           int64_t D, int nb, int c0, int ncol) {
    const int t = threadIdx.x;
    for (int e = t; e < kBR * kTJ; e += kPThreads) {
        const int i = e / kTJ, jj = e % kTJ;
        if (r0 + i < D && jj < nt)
            __pipeline_memcpy_async(&hs[i][jj], &H[(r0 + i) * D + j0 + jj], sizeof(cplx));
        else
            hs[i][jj] = make_cuDoubleComplex(0.0, 0.0);
    }
    for (int e = t; e < kTJ * NC; e += kPThreads) {
        const int jj = e / NC, c = e % NC;
        if (jj < nt && c < ncol)
            __pipeline_memcpy_async(&bs[jj][c], &bin[(j0 + jj) * nb + c0 + c], sizeof(cplx));
        else
            bs[jj][c] = make_cuDoubleComplex(0.0, 0.0);
    }
    __pipeline_commit();
}

// part[s, r, c0 + col] = sum over the slice's H columns j of H[r, j] b[j, c0 + col];
// two tile buffers: the next tile's copies are in flight while this one is used
template <int CPT>
__global__ void __launch_bounds__(kPThreads)
    dense_filter_product(const cplx* __restrict__ H, const cplx* __restrict__ bin, cplx* __restrict__ part,
                         int64_t D, int nb, int64_t jlen) {
    constexpr int NC = kGroups * CPT;
    __shared__ cplx hs[2][kBR][kTJ + 1];
    __shared__ cplx bs[2][kTJ][NC];
    const int t = threadIdx.x;
    const int rg = t / kGroups, g = t % kGroups;  // rows rg + 32 q, columns g CPT + c
    const int64_t r0 = (int64_t)blockIdx.x * kBR;
    const int c0 = blockIdx.y * NC;
    const int ncol = min(NC, nb - c0);
    const int64_t j_begin = (int64_t)blockIdx.z * jlen;
    const int64_t j_end = min(D, j_begin + jlen);
    double ar[kRPT][CPT], ai[kRPT][CPT];
#pragma unroll
    for (int q = 0; q < kRPT; ++q)
#pragma unroll
        for (int c = 0; c < CPT; ++c) ar[q][c] = ai[q][c] = 0.0;
    if (j_begin < j_end)
        stage_tile<NC>(hs[0], bs[0], H, bin, r0, j_begin, (int)min((int64_t)kTJ, j_end - j_begin), D, nb, c0,
                       ncol);
    int cur = 0;
    for (int64_t j0 = j_begin; j0 < j_end; j0 += kTJ) {
        const int64_t jn = j0 + kTJ;
        if (jn < j_end) {
            stage_tile<NC>(hs[cur ^ 1], bs[cur ^ 1], H, bin, r0, jn, (int)min((int64_t)kTJ, j_end - jn), D, nb,
                           c0, ncol);
            __pipeline_wait_prior(1);
        } else {
            __pipeline_wait_prior(0);
        }
        __syncthreads();
#pragma unroll 4
        for (int jj = 0; jj < kTJ; ++jj) {
            cplx b[CPT];
#pragma unroll
            for (int c = 0; c < CPT; ++c) b[c] = bs[cur][jj][g * CPT + c];
#pragma unroll
            for (int q = 0; q < kRPT; ++q) {
                const cplx h = hs[cur][rg + (kBR / kRPT) * q][jj];
#pragma unroll
                for (int c = 0; c < CPT; ++c) {
                    ar[q][c] += h.x * b[c].x - h.y * b[c].y;
                    ai[q][c] += h.x * b[c].y + h.y * b[c].x;
                }
            }
        }
        __syncthreads();  // the buffer just read is the next stage's target
        cur ^= 1;
    }
#pragma unroll
    for (int q = 0; q < kRPT; ++q) {
        const int64_t r = r0 + rg + (kBR / kRPT) * q;
        if (r >= D) continue;
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
            const int col = g * CPT + c;
            if (col < ncol)
                part[((int64_t)blockIdx.z * D + r) * nb + c0 + col] = make_cuDoubleComplex(ar[q][c], ai[q][c]);
        }
    }
}

// y = sum over the S slices (in order) of part; first step: a = b, out =
// (y - c b) / hw; later steps: a <- n = 2 (y - c b) / hw - a, and the
// block's max |n| of its column into partial[blockIdx.x, col]
template <bool FIRST>
__global__ void __launch_bounds__(kEThreads)
    dense_filter_epilogue(const cplx* __restrict__ part, const cplx* __restrict__ bin, cplx* __restrict__ a,
                          cplx* __restrict__ out, double* __restrict__ partial, int64_t D, int nb, int64_t S,
                          double c, double hw) {
    __shared__ double red[kEThreads];
    const int col = blockIdx.y;
    const int64_t r = (int64_t)blockIdx.x * kEThreads + threadIdx.x;
    double mine = 0.0;  // rows past D give 0
    if (r < D) {
        const int64_t o = r * nb + col;
        double yr = 0.0, yi = 0.0;
        for (int64_t s = 0; s < S; ++s) {
            const cplx v = part[s * D * nb + o];
            yr += v.x;
            yi += v.y;
        }
        const cplx b = bin[o];
        yr = (yr - c * b.x) / hw;
        yi = (yi - c * b.y) / hw;
        if (FIRST) {
            a[o] = b;
            out[o] = make_cuDoubleComplex(yr, yi);
        } else {
            const cplx p = a[o];
            const double nr = 2.0 * yr - p.x, ni = 2.0 * yi - p.y;
            a[o] = make_cuDoubleComplex(nr, ni);
            mine = sqrt(nr * nr + ni * ni);
        }
    }
    if (FIRST) return;
    red[threadIdx.x] = mine;
    __syncthreads();
    for (int h = kEThreads / 2; h > 0; h >>= 1) {
        if ((int)threadIdx.x < h) red[threadIdx.x] = fmax(red[threadIdx.x], red[threadIdx.x + h]);
        __syncthreads();
    }
    if (threadIdx.x == 0) partial[(int64_t)blockIdx.x * nb + col] = red[0];
}

// scale[col] = max(max over row blocks of partial, 1): columns are never
// scaled up
__global__ void dense_filter_scale(const double* __restrict__ partial, double* __restrict__ scale, int64_t nblk,
                                   int nb) {
    const int col = blockIdx.x * blockDim.x + threadIdx.x;
    if (col >= nb) return;
    double m = 1.0;
    for (int64_t b = 0; b < nblk; ++b) m = fmax(m, partial[b * nb + col]);
    scale[col] = m;
}

// (a, b) <- (b / s, n / s), n held in a
__global__ void dense_filter_rescale(cplx* __restrict__ a, cplx* __restrict__ b, const double* __restrict__ scale,
                                     int64_t n, int nb) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const double s = scale[i % nb];
    const cplx t = a[i];
    const cplx u = b[i];
    a[i] = make_cuDoubleComplex(u.x / s, u.y / s);
    b[i] = make_cuDoubleComplex(t.x / s, t.y / s);
}

template <int CPT>
static int run_filter(const cplx* H, const cplx* X, cplx* A, cplx* B, cplx* part, double* partial, double* scale,
                      int64_t D, int nb, int64_t p, int64_t S, int64_t jlen, double c, double hw, cudaStream_t st) {
    constexpr int NC = kGroups * CPT;
    const dim3 pgrid((unsigned int)((D + kBR - 1) / kBR), (unsigned int)((nb + NC - 1) / NC), (unsigned int)S);
    const int64_t nblk = (D + kEThreads - 1) / kEThreads;
    const dim3 egrid((unsigned int)nblk, (unsigned int)nb);
    dense_filter_product<CPT><<<pgrid, kPThreads, 0, st>>>(H, X, part, D, nb, jlen);
    dense_filter_epilogue<true><<<egrid, kEThreads, 0, st>>>(part, X, A, B, nullptr, D, nb, S, c, hw);
    const int64_t n = D * nb;
    for (int64_t s = 1; s < p; ++s) {
        dense_filter_product<CPT><<<pgrid, kPThreads, 0, st>>>(H, B, part, D, nb, jlen);
        dense_filter_epilogue<false><<<egrid, kEThreads, 0, st>>>(part, B, A, nullptr, partial, D, nb, S, c, hw);
        dense_filter_scale<<<(nb + 63) / 64, 64, 0, st>>>(partial, scale, nblk, nb);
        dense_filter_rescale<<<blocks_for(n), kThreads, 0, st>>>(A, B, scale, n, nb);
    }
    return (int)cudaGetLastError();
}

// Kernel 11b.  H (D, D) c128, X (D, nb) c128 (not written); A, B (D, nb)
// c128 work (the result in B); part (S, D, nb) c128, partial
// (ceil(D / 256), nb) and scale (nb,) f64 scratch; S slices of jlen H
// columns (jlen a multiple of 16).  p >= 1 steps (p <= 1: T_1 X).
// Columns go in groups of 4, 8, 12 or 16 a block (the smallest that
// holds nb, 16 above).
extern "C" int pythtb_dense_filter(const void* H, const void* X, void* A, void* B, void* part, void* partial,
                                   void* scale, int64_t D, int64_t nb, int64_t p, int64_t S, int64_t jlen,
                                   double c, double hw, void* stream) {
    if (D * nb == 0) return 0;
    cudaStream_t st = (cudaStream_t)stream;
    const cplx* h = (const cplx*)H;
    const cplx* x = (const cplx*)X;
    cplx *a = (cplx*)A, *b = (cplx*)B, *pt = (cplx*)part;
    double *pa = (double*)partial, *sc = (double*)scale;
    if (nb <= 4) return run_filter<1>(h, x, a, b, pt, pa, sc, D, (int)nb, p, S, jlen, c, hw, st);
    if (nb <= 8) return run_filter<2>(h, x, a, b, pt, pa, sc, D, (int)nb, p, S, jlen, c, hw, st);
    if (nb <= 12) return run_filter<3>(h, x, a, b, pt, pa, sc, D, (int)nb, p, S, jlen, c, hw, st);
    return run_filter<4>(h, x, a, b, pt, pa, sc, D, (int)nb, p, S, jlen, c, hw, st);
}
