// The persistent Chebyshev recursion shared by kernels 9 (cheb_moments.cu)
// and 11 (cheb_filter.cu): one cooperative launch walks every step of
//   T_{m+1} = 2 Ht T_m - T_{m-1},   Ht = (H - b) / a,
// on the ELL tables, with cooperative_groups' grid barrier between steps.
//
// Layout.  T threads a block (256, 512, or 1024 for kernel 11 alone: the
// wrapper's choice), one block an SM at most.  Block g of G owns the orbitals [g norb / G, (g + 1)
// norb / G) and so a contiguous range of state rows (an orbital's spin rows
// stay in one block).  Its threads are bx columns by ry row lanes (bx =
// min(B, T), ry = T / bx, columns fastest): thread (tx, ty) takes the
// elements (row ty + i ry, column tx + j bx) of the block's rows.  The
// wrapper picks the fewest threads whose blocks hold every row in one pass
// on the card's SMs, else 512: at 1,024 ptxas holds a thread to 64
// registers and spills (ops/chebyshev.py:_grid_plan mirrors every size
// here).
//
// The tables.  A block copies its rows of cols and vals into shared memory
// once per launch where they fit (TAB_SMEM), so the B threads of a row read
// them by broadcast; elsewhere they are read from device memory past the L1
// (ld.global.nc.L1::no_allocate), which is left to the gathers.
//
// The row sum keeps the JAX programs' arithmetic, that of ell.cuh:ell_row:
// the slots summed in order, then the spin components, one complex
// multiply-add each.  What bounds a step at the main path's shapes is its
// latency, not bytes: a thread's row is D dependent (column, gather) pairs.
// So the columns of K / S slots are read first and their gathers issued
// together, then added in slot order: K = 8 gathers in flight, 4 in the
// 1,024-thread blocks, whose 64 registers spill less at 4 (PERF.md §6).
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

// The gathers a thread keeps in flight in blocks of T threads.
template <int T>
__host__ __device__ constexpr int gather_depth() {
    return T >= 1024 ? 4 : 8;
}

__device__ __forceinline__ int64_t grid_orbital(int64_t g, int64_t G, int64_t norb) { return g * norb / G; }

__device__ __forceinline__ int ld_stream(const int* p) {
    int v;
    asm("ld.global.nc.L1::no_allocate.s32 %0, [%1];" : "=r"(v) : "l"(p));
    return v;
}

__device__ __forceinline__ cplx ld_stream(const cplx* p) {
    double x, y;
    asm("ld.global.nc.L1::no_allocate.v2.f64 {%0, %1}, [%2];" : "=d"(x), "=d"(y) : "l"(p));
    return make_cuDoubleComplex(x, y);
}

template <bool SMEM, typename T>
__device__ __forceinline__ T tab_load(const T* p) {
    if constexpr (SMEM)
        return *p;
    else
        return ld_stream(p);
}

// The sizes of a block's part of dynamic shared memory: its rows' cols
// (rounded to 16 bytes) and vals, for at most `orbs` orbitals.
__host__ __device__ __forceinline__ int64_t grid_cols_bytes(int64_t orbs, int64_t D) {
    return (orbs * D * 4 + 15) / 16 * 16;
}

__host__ __device__ __forceinline__ int64_t grid_tables_bytes(int64_t orbs, int64_t D, int S) {
    return grid_cols_bytes(orbs, D) + orbs * D * S * S * (int64_t)sizeof(cplx);
}

// A block's rows and its threads' place among them.
struct GridRows {
    int64_t n0, r0;  // first orbital, first row
    int rows, bx, ry, tx, ty;
    bool active;
};

template <int S, int T>
__device__ __forceinline__ GridRows grid_rows(int64_t norb, int64_t B) {
    GridRows g;
    const int64_t G = gridDim.x;
    g.n0 = grid_orbital(blockIdx.x, G, norb);
    g.r0 = g.n0 * S;
    g.rows = (int)((grid_orbital(blockIdx.x + 1, G, norb) - g.n0) * S);
    g.bx = (int)(B < T ? B : T);
    g.ry = T / g.bx;
    g.tx = threadIdx.x % g.bx;
    g.ty = threadIdx.x / g.bx;
    g.active = g.ty < g.ry;
    return g;
}

// Copy the block's rows of cols and vals into shared memory (TAB_SMEM);
// returns the table bases to index by local orbital.
template <int S, bool TAB_SMEM>
__device__ __forceinline__ void grid_tables(const GridRows& g, const int* cols, const cplx* vals, int D,
                                            unsigned char* smem, const int*& tcols, const cplx*& tvals) {
    if constexpr (TAB_SMEM) {
        int* sc = (int*)smem;
        const int orbs = g.rows / S;
        cplx* sv = (cplx*)(smem + grid_cols_bytes(orbs, D));
        const int nc = orbs * D;
        for (int i = threadIdx.x; i < nc; i += blockDim.x) sc[i] = __ldg(cols + g.n0 * D + i);
        for (int i = threadIdx.x; i < nc * S * S; i += blockDim.x) sv[i] = __ldg(vals + g.n0 * D * S * S + i);
        __syncthreads();
        tcols = sc;
        tvals = sv;
    } else {
        tcols = cols + g.n0 * D;
        tvals = vals + g.n0 * D * S * S;
    }
}

// ((H x - shift x) / a)[r, b] for the block's local row rl, ell_scaled's
// arithmetic, with xb = x + b (rows ld apart, ldS = S ld; both below 2^31)
// and own = x[r, b] read by the caller beforehand.  The gathers are plain
// loads cached in L1: x was written by other blocks before the last grid
// barrier, which orders them at gpu scope.  Column offsets are 32-bit
// products widened once (IMAD.WIDE); KG gathers stay in flight.
template <int S, bool TAB_SMEM, int KG>
__device__ __forceinline__ cplx grid_scaled(const int* tcols, const cplx* tvals, const cplx* xb, int ld, int ldS,
                                            int rl, int D, double a, double shift, cplx own) {
    constexpr int K = KG / S;
    const int nl = rl / S;
    const int s = rl - nl * S;
    const int* crow = tcols + nl * D;
    const cplx* vrow = tvals + (nl * D * S + s) * S;
    double re = 0.0, im = 0.0;
    for (int d0 = 0; d0 < D; d0 += K) {
        cplx g[K][S];
#pragma unroll
        for (int k = 0; k < K; ++k) {
            if (d0 + k < D) {
                const cplx* p = xb + (int64_t)tab_load<TAB_SMEM>(crow + d0 + k) * ldS;
#pragma unroll
                for (int t = 0; t < S; ++t) g[k][t] = __ldca(p + t * ld);
            }
        }
#pragma unroll
        for (int k = 0; k < K; ++k) {
            if (d0 + k < D) {
#pragma unroll
                for (int t = 0; t < S; ++t) {
                    const cplx v = tab_load<TAB_SMEM>(vrow + (d0 + k) * S * S + t);
                    re += v.x * g[k][t].x - v.y * g[k][t].y;
                    im += v.x * g[k][t].y + v.y * g[k][t].x;
                }
            }
        }
    }
    return make_cuDoubleComplex((re - shift * own.x) / a, (im - shift * own.y) / a);
}

// One cooperative launch of G blocks of T threads with `smem`
// bytes of dynamic shared memory.  The L1 / shared-memory split asks for
// no more shared memory than the block takes, so the rest is L1 for the
// gathers.  Refused (cudaErrorCooperativeLaunchTooLarge) unless all G
// blocks fit the card at once.
static int grid_launch(const void* kern, int64_t G, int T, size_t smem, void** args, cudaStream_t st) {
    int dev = 0, sms = 0, per = 0, sm_smem = 0;
    cudaFuncAttributes attr;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sm_smem, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kern);
    if (err == cudaSuccess) err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess) {
        const int64_t need = (int64_t)smem + (int64_t)attr.sharedSizeBytes + 1024;
        int64_t carve = (need * 100 + sm_smem - 1) / sm_smem;
        err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                                   (int)(carve > 100 ? 100 : carve));
    }
    if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kern, T, smem);
    if (err != cudaSuccess) return (int)err;
    if (G < 1 || G > (int64_t)per * sms) return (int)cudaErrorCooperativeLaunchTooLarge;
    return (int)cudaLaunchCooperativeKernel(kern, dim3((unsigned)G), dim3(T), args, smem, st);
}
