// Kernel 13: the local Green's function of the coherent-potential
// approximation, per frequency.
//
// Replaces gdiag of pythtb_tpu/disorder.py:_cpa_jit (:61-123), the hot op
// of its while loop: for each frequency w,
//   G[w, i] = (1/B) sum_k [ (z_w - H(k) - diag(Sigma[w]))^{-1} ]_ii,
// z_w = omega_w + i eta, H(k) the (B, S, S) Bloch Hamiltonians (built
// once per call by kernel 1; only Sigma changes between iterations).  The
// t-matrix update of the loop stays a few (W, S) torch operations.
//
// What bounds it on the H100: the operations, a Gauss-Jordan inverse per
// (w, k) (some 16 S^3 complex-multiply-add operations; the kagome row,
// 256 w x 2,304 k at S 3, about 3e8 float64 operations an iteration, ~10
// us at the float64 peak); H is read once per block from L2.  Design:
// one block per frequency.  For S <= 4 each thread owns a k-point at a
// time, inverts [M | I] in registers by Gauss-Jordan with partial
// pivoting and adds the diagonal to its own sums, its k-points taken in
// order; for 5 <= S <= 40 a warp owns a k-point, [M | I] in the warp's
// slice of shared memory.  A tree in shared memory then adds the threads'
// (or warps') sums in a fixed order and the block divides by B, so the
// result is the same on every run.  Above S 40 (cudaErrorInvalidValue)
// the Python wrapper raises before it gets here.
#include <algorithm>

#include "common.cuh"

constexpr int kMaxS = 40;
constexpr int kRegS = 4;           // largest S inverted in registers
constexpr int kSmallThreads = 256;
constexpr int kWarpThreads = 128;  // four warps a block for 5 <= S <= 40

__device__ __forceinline__ double cabs2(cplx z) { return z.x * z.x + z.y * z.y; }

// the fixed-order tree over nt partial vectors of length S in buf (nt a
// power of two); leaves the total in buf[0..S)
__device__ void tree_sum(cplx* buf, int S) {
    const int t = threadIdx.x;
    for (int h = blockDim.x / 2; h > 0; h >>= 1) {
        if (t < h)
            for (int i = 0; i < S; ++i) buf[t * S + i] = cuCadd(buf[t * S + i], buf[(t + h) * S + i]);
        __syncthreads();
    }
}

template <int S>
__global__ void cpa_small(const cplx* __restrict__ H, const cplx* __restrict__ z,
                          const cplx* __restrict__ sigma, cplx* __restrict__ G, int64_t B) {
    __shared__ cplx buf[kSmallThreads * S];
    const int t = threadIdx.x;
    const int64_t w = blockIdx.x;
    const cplx zw = z[w];
    cplx sg[S], acc[S];
#pragma unroll
    for (int i = 0; i < S; ++i) {
        sg[i] = sigma[w * S + i];
        acc[i] = make_cuDoubleComplex(0.0, 0.0);
    }
    for (int64_t k = t; k < B; k += blockDim.x) {
        cplx m[S][S], g[S][S];
#pragma unroll
        for (int i = 0; i < S; ++i)
#pragma unroll
            for (int j = 0; j < S; ++j) {
                const cplx h = H[(k * S + i) * S + j];
                m[i][j] = make_cuDoubleComplex(-h.x, -h.y);
                g[i][j] = make_cuDoubleComplex(i == j ? 1.0 : 0.0, 0.0);
            }
#pragma unroll
        for (int i = 0; i < S; ++i) m[i][i] = csub(cuCadd(m[i][i], zw), sg[i]);
        // Gauss-Jordan with partial pivoting (rows swapped by value: the
        // indices stay compile-time constants, so m and g stay in registers)
#pragma unroll
        for (int c = 0; c < S; ++c) {
            double best = cabs2(m[c][c]);
#pragma unroll
            for (int r = c + 1; r < S; ++r) {
                const double v = cabs2(m[r][c]);
                if (v > best) {
                    best = v;
#pragma unroll
                    for (int j = 0; j < S; ++j) {
                        const cplx tm = m[c][j];
                        m[c][j] = m[r][j];
                        m[r][j] = tm;
                        const cplx tg = g[c][j];
                        g[c][j] = g[r][j];
                        g[r][j] = tg;
                    }
                }
            }
            const cplx pv = m[c][c];
#pragma unroll
            for (int j = 0; j < S; ++j) {
                m[c][j] = cuCdiv(m[c][j], pv);
                g[c][j] = cuCdiv(g[c][j], pv);
            }
#pragma unroll
            for (int i = 0; i < S; ++i) {
                if (i == c) continue;
                const cplx f = m[i][c];
#pragma unroll
                for (int j = 0; j < S; ++j) {
                    m[i][j] = csub(m[i][j], cuCmul(f, m[c][j]));
                    g[i][j] = csub(g[i][j], cuCmul(f, g[c][j]));
                }
            }
        }
#pragma unroll
        for (int i = 0; i < S; ++i) acc[i] = cuCadd(acc[i], g[i][i]);
    }
#pragma unroll
    for (int i = 0; i < S; ++i) buf[t * S + i] = acc[i];
    __syncthreads();
    tree_sum(buf, S);
    if (t < S) G[w * S + t] = make_cuDoubleComplex(buf[t].x / (double)B, buf[t].y / (double)B);
}

// 5 <= S <= 40: warp v of the block owns k = v, v + nwarps, ...; its
// [M | I] (S x 2S) lives in its own slice of shared memory.  Dynamic
// shared memory: nwarps slices of 2 S^2 complex, then nwarps * S partial
// sums and one pivot index a warp.
__global__ void cpa_warp(const cplx* __restrict__ H, const cplx* __restrict__ z,
                         const cplx* __restrict__ sigma, cplx* __restrict__ G, int64_t B, int S) {
    extern __shared__ cplx smem[];
    const int lane = threadIdx.x & 31, v = threadIdx.x >> 5, nw = blockDim.x >> 5;
    const int n2 = 2 * S;
    cplx* aug = smem + (size_t)v * S * n2;
    cplx* part = smem + (size_t)nw * S * n2;
    int* piv = (int*)(part + nw * S);
    const int64_t w = blockIdx.x;
    const cplx zw = z[w];
    for (int i = lane; i < S; i += 32) part[v * S + i] = make_cuDoubleComplex(0.0, 0.0);
    for (int64_t k = v; k < B; k += nw) {
        for (int q = lane; q < S * n2; q += 32) {
            const int i = q / n2, j = q - i * n2;
            cplx x;
            if (j < S) {
                const cplx h = H[(k * S + i) * S + j];
                x = make_cuDoubleComplex(-h.x, -h.y);
                if (i == j) x = csub(cuCadd(x, zw), sigma[w * S + i]);
            } else {
                x = make_cuDoubleComplex(j - S == i ? 1.0 : 0.0, 0.0);
            }
            aug[q] = x;
        }
        __syncwarp();
        for (int c = 0; c < S; ++c) {
            if (lane == 0) {
                int r = c;
                double best = cabs2(aug[c * n2 + c]);
                for (int q = c + 1; q < S; ++q) {
                    const double val = cabs2(aug[q * n2 + c]);
                    if (val > best) {
                        best = val;
                        r = q;
                    }
                }
                piv[v] = r;
            }
            __syncwarp();
            const int r = piv[v];
            if (r != c)
                for (int j = lane; j < n2; j += 32) {
                    const cplx tm = aug[c * n2 + j];
                    aug[c * n2 + j] = aug[r * n2 + j];
                    aug[r * n2 + j] = tm;
                }
            __syncwarp();
            const cplx pv = aug[c * n2 + c];
            __syncwarp();
            for (int j = lane; j < n2; j += 32) aug[c * n2 + j] = cuCdiv(aug[c * n2 + j], pv);
            __syncwarp();
            // each lane owns whole columns j: the factors aug[i][c] are read
            // before column c itself is updated (by the lane that owns it)
            for (int j = lane; j < n2; j += 32) {
                if (j == c) continue;
                const cplx rc = aug[c * n2 + j];
                for (int i = 0; i < S; ++i)
                    if (i != c) aug[i * n2 + j] = csub(aug[i * n2 + j], cuCmul(aug[i * n2 + c], rc));
            }
            __syncwarp();
            if (lane == (c & 31))
                for (int i = 0; i < S; ++i)
                    if (i != c) aug[i * n2 + c] = make_cuDoubleComplex(0.0, 0.0);
            __syncwarp();
        }
        for (int i = lane; i < S; i += 32) part[v * S + i] = cuCadd(part[v * S + i], aug[i * n2 + S + i]);
        __syncwarp();
    }
    __syncthreads();
    if (threadIdx.x < S) {
        cplx acc = make_cuDoubleComplex(0.0, 0.0);
        for (int u = 0; u < nw; ++u) acc = cuCadd(acc, part[u * S + threadIdx.x]);
        G[w * S + threadIdx.x] = make_cuDoubleComplex(acc.x / (double)B, acc.y / (double)B);
    }
}

// H (B, S, S), z (W,), sigma (W, S) complex; G (W, S) complex out.
extern "C" int pythtb_cpa(const void* H, const void* z, const void* sigma, void* G, int64_t W,
                          int64_t B, int64_t S, void* stream) {
    if (W == 0) return 0;
    if (S < 1 || S > kMaxS || B < 1) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    const cplx *h = (const cplx*)H, *zz = (const cplx*)z, *sg = (const cplx*)sigma;
    cplx* g = (cplx*)G;
    const unsigned int grid = (unsigned int)W;
    if (S <= kRegS) {
        // a power of two (the tree), as many as the registers allow
        cudaFuncAttributes fa;
        cudaError_t err = S == 1   ? cudaFuncGetAttributes(&fa, cpa_small<1>)
                          : S == 2 ? cudaFuncGetAttributes(&fa, cpa_small<2>)
                          : S == 3 ? cudaFuncGetAttributes(&fa, cpa_small<3>)
                                   : cudaFuncGetAttributes(&fa, cpa_small<4>);
        if (err != cudaSuccess) return (int)err;
        int nt = kSmallThreads;
        while (nt > 32 && nt > fa.maxThreadsPerBlock) nt >>= 1;
        switch (S) {
            case 1: cpa_small<1><<<grid, nt, 0, st>>>(h, zz, sg, g, B); break;
            case 2: cpa_small<2><<<grid, nt, 0, st>>>(h, zz, sg, g, B); break;
            case 3: cpa_small<3><<<grid, nt, 0, st>>>(h, zz, sg, g, B); break;
            default: cpa_small<4><<<grid, nt, 0, st>>>(h, zz, sg, g, B);
        }
    } else {
        // four warps a block, if the registers allow them
        cudaFuncAttributes fa;
        cudaError_t err = cudaFuncGetAttributes(&fa, cpa_warp);
        if (err != cudaSuccess) return (int)err;
        if (fa.maxThreadsPerBlock < kWarpThreads) return (int)cudaErrorInvalidConfiguration;
        const int nw = kWarpThreads / 32;
        const size_t smem = (size_t)nw * (2 * S * S + S) * sizeof(cplx) + nw * sizeof(int);
        int dev = 0, optin = 0;
        err = cudaGetDevice(&dev);
        if (err == cudaSuccess)
            err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
        if (err != cudaSuccess) return (int)err;
        if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
        err = cudaFuncSetAttribute(cpa_warp, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
        cpa_warp<<<grid, kWarpThreads, smem, st>>>(h, zz, sg, g, B, (int)S);
    }
    return (int)cudaGetLastError();
}
