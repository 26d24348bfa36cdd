// Shared helpers of the pythtb_tpu_torch kernels.
//
// torch complex128 tensors are interleaved (re, im) pairs, which is the
// layout of cuDoubleComplex (a double2), so a kernel reads data_ptr()
// directly as cplx.  Each entry point has a plain C interface for
// ctypes: pointers and the stream arrive as void*, sizes as int64_t, and
// it returns cudaGetLastError() after its launches.
#pragma once

#include <cuComplex.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef cuDoubleComplex cplx;

constexpr int kThreads = 256;

static inline unsigned int blocks_for(int64_t n) {
    return (unsigned int)((n + kThreads - 1) / kThreads);
}

__device__ __forceinline__ cplx cconj(cplx a) { return make_cuDoubleComplex(a.x, -a.y); }

// conj(a) * b
__device__ __forceinline__ cplx cmul_conj(cplx a, cplx b) {
    return make_cuDoubleComplex(a.x * b.x + a.y * b.y, a.x * b.y - a.y * b.x);
}

__device__ __forceinline__ cplx csub(cplx a, cplx b) { return make_cuDoubleComplex(a.x - b.x, a.y - b.y); }

// Asynchronous copies from device to shared memory (cp.async, sm_80+),
// 16 or 8 bytes; with ok false the destination is filled with zeros and
// src is not read (it must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok = true) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(ok ? 16 : 0)
                 : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool ok = true) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s), "l"(src), "r"(ok ? 8 : 0)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// Wait until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Pair k of round `round` of the circle ordering of Se (even) players:
// over Se - 1 rounds every pair p < q appears once, disjoint within a
// round (the parallel Jacobi sweeps of polar.cuh and mv_step.cu).
__device__ __forceinline__ void circle_pair(int Se, int round, int k, int& p, int& q) {
    const int m = Se - 1;
    const int a = k == 0 ? 0 : 1 + (round + k - 1) % m;
    const int b = 1 + (round + m - 1 - k) % m;
    p = min(a, b);
    q = max(a, b);
}

// D += A B on the FP64 tensor cores, one 16 x 8 x 8 step (kernels 6 and
// 11b): a lane holds A[g][t], A[g + 8][t], A[g][t + 4], A[g + 8][t + 4],
// B[t][g], B[t + 4][g] and D[g][2t + {0, 1}], D[g + 8][2t + {0, 1}], with
// g = lane / 4, t = lane % 4.
__device__ __forceinline__ void dmma16(double (&d)[4], double a0, double a1, double a2, double a3, double b0,
                                       double b1) {
    asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
        : "d"(a0), "d"(a1), "d"(a2), "d"(a3), "d"(b0), "d"(b1));
}

// mbarriers in shared memory (sm_90; kernels 11b and 14)
__device__ __forceinline__ uint32_t smem_u32(const void* p) { return (uint32_t)__cvta_generic_to_shared(p); }

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// wait until the barrier's phase differs from `parity`
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
    uint32_t done = 0;
    do {
        asm volatile(
            "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done)
            : "r"(smem_u32(bar)), "r"(parity)
            : "memory");
    } while (!done);
}

// TMA's one-dimensional copy: `bytes` (a multiple of 16; both addresses
// 16-byte aligned) from device memory to shared memory, completing on
// bar's transaction count
__device__ __forceinline__ void tma_load_1d(void* dst, const void* src, unsigned bytes, uint64_t* bar) {
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "r"(bytes), "r"(smem_u32(bar))
                 : "memory");
}
