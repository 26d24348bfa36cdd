// Kernel 4: plaquette Berry phases, their per-plane sums, and min |det|.
//
// Replaces pythtb_tpu/ops/berry.py:plaquette_phases / _berry_flux_jit and
// flows.py:_total_flux / _chern_jit (XLA-fused): for link determinants
// Dr (P, n0-1, n1) and Du (P, n0, n1-1) of P planes,
//   phase[p, i, j] = -arg(Dr[i, j] Du[i+1, j] conj(Dr[i, j+1]) conj(Du[i, j]))
// (the index pattern of berry.py:88-93), either written per plaquette or
// summed per plane, plus the smallest |det| over every link of every
// plane for the singular-link warning.
//
// What bounds it on the H100: one read of Dr and Du (about 32 bytes per
// plaquette) -- far below the card's bandwidth at any grid a user runs,
// so launch count and the cross-block reduction dominate.  Design: pass
// 1 runs an (nblk, P) grid; each thread walks plaquettes and links in a
// fixed grid-stride order, each block reduces in shared memory and
// writes one partial sum and one partial min.  Pass 2, a single block,
// reduces the partials of each plane in a fixed tree order.  No atomics,
// so the sum does not depend on the order the blocks ran in.
#include <math.h>

#include "common.cuh"

__device__ __forceinline__ void block_reduce(double* ssum, double* smin, double s, double mn) {
    const int tid = threadIdx.x;
    ssum[tid] = s;
    smin[tid] = mn;
    __syncthreads();
    for (int width = blockDim.x / 2; width > 0; width >>= 1) {
        if (tid < width) {
            ssum[tid] += ssum[tid + width];
            smin[tid] = fmin(smin[tid], smin[tid + width]);
        }
        __syncthreads();
    }
}

__global__ void plaquette_partial_kernel(const cplx* __restrict__ Dr, const cplx* __restrict__ Du,
                                         double* __restrict__ plaq, double* __restrict__ psum,
                                         double* __restrict__ pmin, int64_t n0, int64_t n1,
                                         int nblk) {
    __shared__ double ssum[kThreads];
    __shared__ double smin[kThreads];
    const int64_t p = blockIdx.y;
    const int64_t m1 = n1 - 1;
    const int64_t nplaq = (n0 - 1) * m1;
    const int64_t ndr = (n0 - 1) * n1;
    const int64_t ndu = n0 * m1;
    const int64_t nlink = ndr > ndu ? ndr : ndu;
    const int64_t nmax = nplaq > nlink ? nplaq : nlink;
    const cplx* dr = Dr + p * ndr;
    const cplx* du = Du + p * ndu;

    double s = 0.0, mn = INFINITY;
    const int64_t stride = (int64_t)nblk * blockDim.x;
    for (int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; idx < nmax; idx += stride) {
        if (idx < nplaq) {
            const int64_t i = idx / m1;
            const int64_t j = idx - i * m1;
            cplx z = cuCmul(dr[i * n1 + j], du[(i + 1) * m1 + j]);
            z = cuCmul(z, cconj(dr[i * n1 + j + 1]));
            z = cuCmul(z, cconj(du[i * m1 + j]));
            const double ph = -atan2(z.y, z.x);
            if (plaq != nullptr) plaq[p * nplaq + idx] = ph;
            s += ph;
        }
        if (idx < ndr) mn = fmin(mn, cuCabs(dr[idx]));
        if (idx < ndu) mn = fmin(mn, cuCabs(du[idx]));
    }
    block_reduce(ssum, smin, s, mn);
    if (threadIdx.x == 0) {
        psum[p * nblk + blockIdx.x] = ssum[0];
        pmin[p * nblk + blockIdx.x] = smin[0];
    }
}

__global__ void plaquette_reduce_kernel(const double* __restrict__ psum,
                                        const double* __restrict__ pmin, double* __restrict__ sums,
                                        double* __restrict__ mdet, int64_t P, int nblk) {
    __shared__ double ssum[kThreads];
    __shared__ double smin[kThreads];
    double gmin = INFINITY;
    for (int64_t p = 0; p < P; ++p) {
        double s = 0.0, mn = INFINITY;
        for (int b = threadIdx.x; b < nblk; b += blockDim.x) {
            s += psum[p * nblk + b];
            mn = fmin(mn, pmin[p * nblk + b]);
        }
        block_reduce(ssum, smin, s, mn);
        if (threadIdx.x == 0) {
            sums[p] = ssum[0];
            gmin = fmin(gmin, smin[0]);
        }
        __syncthreads();
    }
    if (threadIdx.x == 0) mdet[0] = gmin;
}

extern "C" int pythtb_plaquette_flux(const void* Dr, const void* Du, void* plaq, void* psum,
                                     void* pmin, void* sums, void* mdet, int64_t P, int64_t n0,
                                     int64_t n1, int64_t nblk, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    dim3 grid((unsigned int)nblk, (unsigned int)P);
    plaquette_partial_kernel<<<grid, kThreads, 0, st>>>((const cplx*)Dr, (const cplx*)Du,
                                                        (double*)plaq, (double*)psum,
                                                        (double*)pmin, n0, n1, (int)nblk);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    plaquette_reduce_kernel<<<1, kThreads, 0, st>>>((const double*)psum, (const double*)pmin,
                                                    (double*)sums, (double*)mdet, P, (int)nblk);
    return (int)cudaGetLastError();
}
