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
// TB/s, against 8 D^2 nb = 1.9 GFLOP, ~56 us at the float64 CUDA cores'
// peak; the (D, nb) block (784 kB) stays in the 50 MB L2.  The product is
// a GEMM with a thin N; a block owns 128 rows of H and a group of the
// block's columns, and the H columns are split into slices (a third grid
// dimension) so that D 4,900's 39 row tiles fill the SMs; each slice
// writes its partial product, and the slices are added in slice order
// (deterministic: no atomics on the result).  Two designs, chosen by
// ops/chebyshev.py:_dense_design (the cores below D 1,024, where the
// tensor design's few row tiles leave SMs idle):
//
// cores (pythtb_dense_filter): tiles of 8 H columns staged in shared
//   memory by asynchronous 16-byte copies into two buffers (rows padded by
//   one element, so that the eight rows a warp reads at once fall on
//   distinct banks), complex multiply-adds on the CUDA cores, 4 rows x CPT
//   columns of sums a thread.  An epilogue launch adds the slices, applies
//   2 ((H b - c b) / hw) - a (the first step: (H X - c X) / hw), writes n
//   over a and each block's column maxima; a small reduction turns those
//   into s and an elementwise pass writes a = b / s, b = n / s: four
//   launches a step.  51% of the byte bound at the row: the CUDA-core
//   multiply-adds, fed from shared memory, keep H from streaming at full
//   rate.  (Earlier versions, a p = 30 filter at D 4,900: a warp per row
//   with the block staged row-major, 66 ms -- an 8-way bank conflict on
//   every read; column-major, two rows a warp, 22.7 ms; single-buffered
//   tiles of 16, 7.2 ms; this one 6.9 ms, 106 registers a thread.)
// tensor (pythtb_dense_filter_tc): a ring of 2 stages in dynamic shared
//   memory, each four 128-row x 8-complex boxes of H side by side and
//   32-row boxes of b, loaded by TMA (2-D tensor maps over H and b viewed
//   as rows of doubles, the 128-byte swizzle, zeros past the edges; H with
//   the L2 evict-first hint, b evict-last) on mbarriers by one producer
//   lane, one block an SM; four consumer warps, 32 rows each, run the complex
//   product as four real mma.sync m16n8k8 FP64 products a step (kernel
//   6's fragments, common.cuh), nb padded to 8, 16 or 32.  The carries
//   stay unscaled -- (a, b) = (A, N) / s -- so one launch a step does it
//   all: its blocks take s from the last step's column maxima of every
//   row tile, scale b as its fragments load, and the last slice block of
//   a row tile to finish (a ticket counter) adds the slices in order,
//   writes (A, N) <- (b, n) into the other of two buffers and the tile's
//   column maxima; a last launch writes N / s.  p + 1 launches a filter.
#include <cuda.h>
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

// -- the tensor-core design: TMA tiles of H, FP64 mma.sync, one launch a step --

constexpr int kTcRows = 128;                     // rows of H a block: 8 m-tiles of 16
constexpr int kTcK = 8;                          // H columns a box: one 128-byte row of 8 complex
constexpr int kTcKB = 4;                         // boxes of H a stage, side by side: 512 bytes of each row
constexpr int kTcStages = 2;                     // stages in the ring
constexpr int kTcConsumers = 4;                  // consumer warps, two m-tiles (32 rows) each
constexpr int kTcThreads = 32 * (kTcConsumers + 1);  // and one producer warp
constexpr unsigned kTcHBytes = kTcRows * kTcK * sizeof(cplx);  // an H box, 16 kB
constexpr unsigned kTcBBytes = kTcK * 8 * sizeof(cplx);        // 8 rows x one n-tile of b, 1 kB

// A stage holds kTcKB boxes of H side by side (kTcKB * 8 columns: runs of 512
// bytes of a row, which the H100's memory serves faster than runs of 128
// or 256) and, per n-tile, the 8 kTcKB rows of b they meet.  The dynamic
// shared memory of the step kernel with NT n-tiles (8 columns each): the
// ring, and 1 kB to align it to the 128-byte swizzle's 1,024-byte period
// (145 kB at NT 2: one block an SM).
__host__ __device__ constexpr unsigned tc_stage_bytes(int NT) { return kTcKB * (kTcHBytes + NT * kTcBBytes); }
__host__ __device__ constexpr unsigned tc_smem(int NT) { return kTcStages * tc_stage_bytes(NT) + 1024; }

// TMA: the box of `map` at (x, y) (x the inner coordinate, in doubles) into
// dst, completing on bar's transaction count; with an L2 cache-policy hint
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int x, int y, uint64_t* bar,
                                            uint64_t policy) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint"
        " [%0], [%1, {%2, %3}], [%4], %5;\n" ::"r"(smem_u32(dst)),
        "l"((uint64_t)map), "r"(x), "r"(y), "r"(smem_u32(bar)), "l"(policy)
        : "memory");
}

// L2 cache policies (the encodings of CUTLASS's CacheHintSm90): H streams
// through once a step and goes first; b, the carries and the partial
// products, read again within the step, stay
constexpr uint64_t kEvictFirst = 0x12F0000000000000ull;
constexpr uint64_t kEvictLast = 0x14F0000000000000ull;

// complex entry (row, col) of a box of 128-byte rows (8 complex) that TMA
// wrote with the 128-byte swizzle: the 16-byte chunk index is xor-ed with
// the row modulo 8
__device__ __forceinline__ int swz(int row, int col) { return row * 8 + (col ^ (row & 7)); }

// One step of the recurrence for row tile blockIdx.x, n-tile group
// blockIdx.y (8 NT columns) and slice blockIdx.z of jlen H columns.  The
// carries are held unscaled: the true (a, b) are (acur, bcur) / s, with s
// = max(max over the row tiles' pcur, 1) per column (s = 1 where pcur is
// null).  The slice's product H[rows, slice] (bcur / s)[slice] goes to
// part[z]; the last slice block of the row tile to finish (a ticket on
// counters) adds the S partial products in slice order and writes
//   first:  anext = b, nnext = (y - c b) / hw
//   later:  anext = b, nnext = n = 2 (y - c b) / hw - a, pnext = max |n|
// for its rows (y = H b).
template <int NT>
__global__ void __launch_bounds__(kTcThreads)
    dense_filter_tc_step(const __grid_constant__ CUtensorMap tmH, const __grid_constant__ CUtensorMap tmB,
                         const cplx* __restrict__ bcur, const cplx* __restrict__ acur, cplx* __restrict__ anext,
                         cplx* __restrict__ nnext, cplx* __restrict__ part, const double* __restrict__ pcur,
                         double* __restrict__ pnext, int* __restrict__ counters, int64_t D, int nb, int64_t S,
                         int64_t jlen, int first, double c, double hw) {
    constexpr int NC = 8 * NT;
    constexpr int kStages = kTcStages;
    constexpr unsigned kStageBytes = tc_stage_bytes(NT);
    extern __shared__ __align__(16) uint8_t smem_raw[];
    __shared__ uint64_t full[kStages], empty[kStages];
    __shared__ double svec[NC], sinv[NC];
    __shared__ unsigned long long cmax[NC];
    __shared__ int last;
    uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int64_t r0 = (int64_t)blockIdx.x * kTcRows;
    const int c0 = blockIdx.y * NC;
    const int64_t z = blockIdx.z;
    const int64_t j_begin = z * jlen;
    const int64_t j_end = min(D, j_begin + jlen);
    const int ntiles = (int)((j_end - j_begin + kTcKB * kTcK - 1) / (kTcKB * kTcK));
    if (tid == 0) {
        for (int s = 0; s < kStages; ++s) {
            mbar_init(&full[s], 1);
            mbar_init(&empty[s], kTcConsumers);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (warp == kTcConsumers) {
        // the producer: one lane keeps the ring's TMA loads in flight
        if (lane == 0) {
            for (int kt = 0; kt < ntiles; ++kt) {
                const int st = kt % kStages;
                mbar_wait(&empty[st], ((kt / kStages) & 1) ^ 1);
                uint8_t* sb = ring + st * kStageBytes;
                mbar_expect_tx(&full[st], kStageBytes);
                const int j0 = (int)(j_begin + (int64_t)kt * kTcKB * kTcK);
#pragma unroll
                for (int kb = 0; kb < kTcKB; ++kb)
                    tma_load_2d(sb + kb * kTcHBytes, &tmH, 2 * (j0 + kTcK * kb), (int)r0, &full[st], kEvictFirst);
#pragma unroll
                for (int n = 0; n < NT; ++n) {
                    uint8_t* dst = sb + kTcKB * kTcHBytes + n * kTcKB * kTcBBytes;
                    tma_load_2d(dst, &tmB, 2 * (c0 + 8 * n), j0, &full[st], kEvictLast);
                }
            }
        }
    } else {
        // the consumers: warp w owns rows 32 w .. 32 w + 31 of the tile.  The
        // MMA's k = t and t + 4 take the stage's columns 2t and 2t + 1, so a
        // lane's 16-byte reads of the swizzled boxes fall on distinct banks.
        const int g = lane >> 2, t = lane & 3;
        // s for the block's columns, while the producer's first loads fly;
        // then a barrier of the consumer warps alone
        if (tid < NC) {
            double m = 1.0;  // columns are never scaled up
            if (pcur != nullptr && c0 + tid < nb) {
#pragma unroll 8
                for (unsigned b = 0; b < gridDim.x; ++b) m = fmax(m, pcur[(int64_t)b * nb + c0 + tid]);
            }
            svec[tid] = m;
            sinv[tid] = 1.0 / m;
            cmax[tid] = 0ull;
        }
        asm volatile("bar.sync 1, %0;\n" ::"n"(32 * kTcConsumers) : "memory");
        double re[2][NT][4], im[2][NT][4];
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
            for (int n = 0; n < NT; ++n)
#pragma unroll
                for (int h = 0; h < 4; ++h) re[m][n][h] = im[m][n][h] = 0.0;
        double inv[NT];
#pragma unroll
        for (int n = 0; n < NT; ++n) inv[n] = sinv[8 * n + g];
        for (int kt = 0; kt < ntiles; ++kt) {
            const int st = kt % kStages;
            mbar_wait(&full[st], (kt / kStages) & 1);
            __syncwarp();  // the warp's lanes leave the wait together for mma.sync
            const uint8_t* sb = ring + st * kStageBytes;
#pragma unroll
            for (int kb = 0; kb < kTcKB; ++kb) {
                const cplx* Hs = (const cplx*)(sb + kb * kTcHBytes);
                double br0[NT], bi0[NT], br1[NT], bi1[NT];
#pragma unroll
                for (int n = 0; n < NT; ++n) {
                    // rows 8 kb .. 8 kb + 7 of the n-tile's box of 8 kTcKB rows
                    const cplx* Bs = (const cplx*)(sb + kTcKB * kTcHBytes + n * kTcKB * kTcBBytes) + 64 * kb;
                    const cplx u0 = Bs[swz(2 * t, g)], u1 = Bs[swz(2 * t + 1, g)];
                    br0[n] = u0.x * inv[n];
                    bi0[n] = u0.y * inv[n];
                    br1[n] = u1.x * inv[n];
                    bi1[n] = u1.y * inv[n];
                }
#pragma unroll
                for (int m = 0; m < 2; ++m) {
                    const int r = 32 * warp + 16 * m + g;
                    const cplx a0 = Hs[swz(r, 2 * t)], a1 = Hs[swz(r + 8, 2 * t)];
                    const cplx a2 = Hs[swz(r, 2 * t + 1)], a3 = Hs[swz(r + 8, 2 * t + 1)];
#pragma unroll
                    for (int n = 0; n < NT; ++n) {
                        // (hr + i hi)(br + i bi) = (hr br - hi bi) + i (hr bi + hi br)
                        dmma16(re[m][n], a0.x, a1.x, a2.x, a3.x, br0[n], br1[n]);
                        dmma16(re[m][n], -a0.y, -a1.y, -a2.y, -a3.y, bi0[n], bi1[n]);
                        dmma16(im[m][n], a0.x, a1.x, a2.x, a3.x, bi0[n], bi1[n]);
                        dmma16(im[m][n], a0.y, a1.y, a2.y, a3.y, br0[n], br1[n]);
                    }
                }
            }
            __syncwarp();
            if (lane == 0) mbar_arrive(&empty[st]);
        }
        cplx* pz = part + z * D * nb;
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
            for (int n = 0; n < NT; ++n)
#pragma unroll
                for (int h = 0; h < 4; ++h) {
                    const int64_t r = r0 + 32 * warp + 16 * m + g + 8 * (h >> 1);
                    const int col = c0 + 8 * n + 2 * t + (h & 1);
                    if (r < D && col < nb) pz[r * nb + col] = make_cuDoubleComplex(re[m][n][h], im[m][n][h]);
                }
    }

    // the last slice block of this row tile and column group does the epilogue
    __threadfence();
    __syncthreads();
    if (tid == 0) {
        int* ticket = counters + (int64_t)blockIdx.x * gridDim.y + blockIdx.y;
        last = atomicAdd(ticket, 1) == (int)S - 1;
        if (last) *ticket = 0;  // ready for the next step's launch
    }
    __syncthreads();
    if (!last) return;
    __threadfence();
#pragma unroll 4
    for (int e = tid; e < kTcRows * NC; e += kTcThreads) {
        const int rr = e / NC, cc = e % NC;
        const int64_t r = r0 + rr;
        const int col = c0 + cc;
        if (r >= D || col >= nb) continue;
        const int64_t o = r * nb + col;
        double yr = 0.0, yi = 0.0;
#pragma unroll 4
        for (int64_t s = 0; s < S; ++s) {
            const double2 v = __ldcg((const double2*)(part + s * D * nb + o));
            yr += v.x;
            yi += v.y;
        }
        const double s = svec[cc];
        const cplx bv = bcur[o];
        const double br = bv.x / s, bi = bv.y / s;
        const double hr = (yr - c * br) / hw, hi = (yi - c * bi) / hw;
        anext[o] = make_cuDoubleComplex(br, bi);
        if (first) {
            nnext[o] = make_cuDoubleComplex(hr, hi);
        } else {
            const cplx av = acur[o];
            const double nr = 2.0 * hr - av.x / s, ni = 2.0 * hi - av.y / s;
            nnext[o] = make_cuDoubleComplex(nr, ni);
            // non-negative doubles order as their bit patterns
            atomicMax(&cmax[cc], (unsigned long long)__double_as_longlong(sqrt(nr * nr + ni * ni)));
        }
    }
    if (first) return;
    __syncthreads();
    if (tid < NC && c0 + tid < nb)
        pnext[(int64_t)blockIdx.x * nb + c0 + tid] = __longlong_as_double((long long)cmax[tid]);
}

// out = n / s, s = max(max over the row tiles' pcur, 1) per column (1 where
// pcur is null): the carry b of the last step
__global__ void dense_filter_tc_final(const cplx* __restrict__ n, const double* __restrict__ pcur,
                                      cplx* __restrict__ out, int64_t D, int nb, int nrt) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= D * nb) return;
    double s = 1.0;
    if (pcur != nullptr)
        for (int b = 0; b < nrt; ++b) s = fmax(s, pcur[(int64_t)b * nb + i % nb]);
    const cplx v = n[i];
    out[i] = make_cuDoubleComplex(v.x / s, v.y / s);
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up at run time through the CUDA
// runtime's entry-point query, so the library links no libcuda
static EncodeTiledFn encode_tiled() {
    static EncodeTiledFn fn = nullptr;
    if (fn == nullptr) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
        const cudaError_t rc =
            cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
        const cudaError_t rc = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
        if (rc == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = (EncodeTiledFn)p;
    }
    return fn;
}

// A map over `rows` x `cols` complex (row-major, viewed as rows x 2 cols
// doubles) that loads boxes of box_rows x 8 complex with the 128-byte
// swizzle; out-of-range entries load as zeros.
static bool encode_box(CUtensorMap* map, const void* base, int64_t rows, int64_t cols, int box_rows) {
    const EncodeTiledFn fn = encode_tiled();
    if (fn == nullptr) return false;
    const cuuint64_t dims[2] = {(cuuint64_t)(2 * cols), (cuuint64_t)rows};
    const cuuint64_t strides[1] = {(cuuint64_t)(cols * sizeof(cplx))};
    const cuuint32_t box[2] = {16, (cuuint32_t)box_rows};
    const cuuint32_t estr[2] = {1, 1};
    return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT64, 2, const_cast<void*>(base), dims, strides, box, estr,
              CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NT>
static int run_filter_tc(const cplx* H, const cplx* X, cplx* work, cplx* out, cplx* part, double* partial,
                         int* counters, int64_t D, int nb, int64_t p, int64_t S, int64_t jlen, double c, double hw,
                         cudaStream_t st) {
    const int64_t Dnb = D * nb;
    const int nrt = (int)((D + kTcRows - 1) / kTcRows);
    cplx* A[2] = {work, work + Dnb};
    cplx* N[2] = {work + 2 * Dnb, work + 3 * Dnb};
    double* P[2] = {partial, partial + (int64_t)nrt * nb};
    CUtensorMap tmH, tmX, tmN[2];
    if (!encode_box(&tmH, H, D, D, kTcRows) || !encode_box(&tmX, X, D, nb, kTcKB * kTcK) ||
        !encode_box(&tmN[0], N[0], D, nb, kTcKB * kTcK) || !encode_box(&tmN[1], N[1], D, nb, kTcKB * kTcK))
        return (int)cudaErrorNotSupported;
    const unsigned bytes = tc_smem(NT);
    cudaFuncSetAttribute(dense_filter_tc_step<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    const dim3 grid((unsigned)nrt, (unsigned)((nb + 8 * NT - 1) / (8 * NT)), (unsigned)S);
    const int64_t steps = p > 1 ? p : 1;
    for (int64_t m = 0; m < steps; ++m) {
        const int cur = (int)((m + 1) & 1), nxt = (int)(m & 1);  // step m reads index (m - 1) & 1, writes m & 1
        const bool first = m == 0;
        dense_filter_tc_step<NT><<<grid, kTcThreads, bytes, st>>>(
            tmH, first ? tmX : tmN[cur], first ? X : N[cur], A[cur], A[nxt], N[nxt], part,
            m >= 2 ? P[cur] : nullptr, P[nxt], counters, D, nb, S, jlen, first ? 1 : 0, c, hw);
        const int rc = (int)cudaGetLastError();
        if (rc != 0) return rc;
    }
    const int last = (int)((steps - 1) & 1);
    dense_filter_tc_final<<<blocks_for(Dnb), kThreads, 0, st>>>(N[last], steps >= 2 ? P[last] : nullptr, out, D, nb,
                                                                 nrt);
    return (int)cudaGetLastError();
}

// Kernel 11b on the tensor cores.  H (D, D) c128, X (D, nb) c128 (not
// written), out (D, nb) c128; work (4, D, nb) c128 (the carries, two
// buffers each), part (S, D, nb) c128, partial (2, ceil(D / 128), nb) f64
// scratch, counters (ceil(D / 128) * groups) int32, zero (and left zero);
// S slices of jlen H columns (jlen a multiple of a stage's 32).  p >= 1
// steps (p <= 1: T_1 X), a launch each, then one for the final scale.
// Columns go in groups of 8, 16 or 32 a block (the smallest that holds nb,
// 32 above).
extern "C" int pythtb_dense_filter_tc(const void* H, const void* X, void* work, void* out, void* part,
                                      void* partial, void* counters, int64_t D, int64_t nb, int64_t p, int64_t S,
                                      int64_t jlen, double c, double hw, void* stream) {
    if (D * nb == 0) return 0;
    if (jlen % (kTcKB * kTcK) != 0 || S < 1) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    const cplx* h = (const cplx*)H;
    const cplx* x = (const cplx*)X;
    cplx *w = (cplx*)work, *o = (cplx*)out, *pt = (cplx*)part;
    double* pa = (double*)partial;
    int* cn = (int*)counters;
    if (nb <= 8) return run_filter_tc<1>(h, x, w, o, pt, pa, cn, D, (int)nb, p, S, jlen, c, hw, st);
    if (nb <= 16) return run_filter_tc<2>(h, x, w, o, pt, pa, cn, D, (int)nb, p, S, jlen, c, hw, st);
    return run_filter_tc<4>(h, x, w, o, pt, pa, cn, D, (int)nb, p, S, jlen, c, hw, st);
}
