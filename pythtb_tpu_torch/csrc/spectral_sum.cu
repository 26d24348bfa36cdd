// Kernel 16: the spectral sum of the optical responses.
//
// Replaces the lax.scan over chunks of 4,096 transitions in
// pythtb_tpu/optical.py:_optical_jit (:124-166, the Lehmann frequency
// scan), _shift_jit (:340-383), _injection_jit (:450-494) and the
// broadcast of _jdos_jit (:545-564): there each chunk's (C, nw) kernel
// matrix is built in memory and reduced with an einsum.
//
//   acc[p, w] = sum_t W[p, t] K(omega_w - de_t)
//   Lorentzian mode: K = 1 / (x + i eta), W complex (P, T), acc complex
//   Gaussian mode:   K = exp(-x^2 / (2 sigma^2)) / (sigma sqrt(2 pi)),
//                    W real (P, T), acc real
//
// What bounds it on the H100: the operations, about (P * 8 + 10) per
// (transition, frequency) pair -- the bytes (W once, the (P, nw) result)
// are small.  Design: the (T, nw) kernel matrix is never stored.  A grid
// of (transition chunks x frequency tiles x column groups) lets each
// thread own one frequency and up to kGroup columns in registers and walk
// its chunk of transitions in order; every thread of a block reads
// the same de_t and W[p, t] (a broadcast load).  Partial sums go to a
// (chunks, P, nw) buffer, and a second pass adds the chunks in order, so
// the sum order is fixed (deterministic).  One thread per frequency
// alone would give 121-968 threads, too few for 132 SMs; the chunks give
// T / chunk times as many, the wrapper choosing the chunk (32-512
// transitions) so that some 500 blocks are in flight where T allows (the
// 2,001 transitions of a 1-D chain still give 63).  T is taken exactly:
// no padding.
//
// The q-batch Lorentzian mode (pythtb_spectral_sum_qbatch) replaces the
// frequency contraction of pythtb_tpu/response.py:_lindhard_jit (:64-115,
// vmapped over q there): W (Q, P, T) c128 and de (Q, T) f64 against one
// omega grid give acc (Q, P, nw) in one launch of each pass, the q axis
// beside the column groups in the grid's z dimension and the same
// fixed-order second pass over the chunks of each q.
#include "common.cuh"

constexpr int kOmegaTile = 128;  // frequencies (threads) per block
constexpr int kGroup = 8;        // columns per block

template <bool LORENTZ>
__global__ void spectral_partial_kernel(const double* __restrict__ de, const double* __restrict__ W,
                                        const double* __restrict__ omegas, double* __restrict__ buf,
                                        int64_t T, int64_t chunk_len, int P, int nw, double width,
                                        double gnorm, int groups) {
    const int iw = blockIdx.y * blockDim.x + threadIdx.x;
    if (iw >= nw) return;
    const int64_t chunk = blockIdx.x;
    // blockIdx.z = q * groups + column group; one q (groups == gridDim.z) in the plain mode
    const int64_t q = blockIdx.z / groups;
    de += q * T;
    W += q * (int64_t)P * T * (LORENTZ ? 2 : 1);
    buf += q * (int64_t)gridDim.x * P * nw * (LORENTZ ? 2 : 1);
    const int p0 = (blockIdx.z % groups) * kGroup;
    const int np = min(kGroup, P - p0);
    const double om = omegas[iw];
    const int64_t t0 = chunk * chunk_len;
    const int64_t t1 = min(T, t0 + chunk_len);
    double ar[kGroup], ai[kGroup];
#pragma unroll
    for (int j = 0; j < kGroup; ++j) ar[j] = ai[j] = 0.0;
    for (int64_t t = t0; t < t1; ++t) {
        const double x = om - de[t];
        if (LORENTZ) {
            // 1 / (x + i eta) = (x - i eta) / (x^2 + eta^2)
            const double inv = 1.0 / (x * x + width * width);
            const double kr = x * inv, ki = -width * inv;
            const cplx* Wc = (const cplx*)W;
#pragma unroll
            for (int j = 0; j < kGroup; ++j) {
                if (j < np) {
                    const cplx w = Wc[(int64_t)(p0 + j) * T + t];
                    ar[j] += w.x * kr - w.y * ki;
                    ai[j] += w.x * ki + w.y * kr;
                }
            }
        } else {
            const double y = x / width;
            const double g = exp(-0.5 * y * y) * gnorm;
#pragma unroll
            for (int j = 0; j < kGroup; ++j)
                if (j < np) ar[j] += W[(int64_t)(p0 + j) * T + t] * g;
        }
    }
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
        if (j < np) {
            const int64_t o = (chunk * P + p0 + j) * nw + iw;
            if (LORENTZ) {
                ((cplx*)buf)[o] = make_cuDoubleComplex(ar[j], ai[j]);
            } else {
                buf[o] = ar[j];
            }
        }
    }
}

// out[q, i] = sum over chunks c, in order, of buf[q, c, i] (n doubles a
// chunk, Q blocks of chunks; Q = 1 in the plain mode)
__global__ void spectral_reduce_kernel(const double* __restrict__ buf, double* __restrict__ out, int64_t nch,
                                       int64_t n, int64_t Q) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n * Q) return;
    const int64_t q = i / n, j = i % n;
    const double* b = buf + q * nch * n;
    double s = 0.0;
    for (int64_t c = 0; c < nch; ++c) s += b[c * n + j];
    out[i] = s;
}

// Kernel 16.  de (T,) f64; W (P, T) c128 (lorentz) or f64; omegas (nw,)
// f64; buf (ceil(T / chunk), P, nw) scratch of the output's type; out
// (P, nw).  width is eta (lorentz) or sigma (Gaussian).
extern "C" int pythtb_spectral_sum(const void* de, const void* W, const void* omegas, void* buf, void* out,
                                   int64_t T, int64_t P, int64_t nw, int64_t chunk, int64_t lorentz,
                                   double width, void* stream) {
    const int64_t nch = (T + chunk - 1) / chunk;
    cudaStream_t st = (cudaStream_t)stream;
    if (nch > 0 && P > 0 && nw > 0) {
        dim3 grid((unsigned int)nch, (unsigned int)((nw + kOmegaTile - 1) / kOmegaTile),
                  (unsigned int)((P + kGroup - 1) / kGroup));
        const double gnorm = 1.0 / (width * 2.5066282746310005024157652848110);  // sqrt(2 pi)
        if (lorentz) {
            spectral_partial_kernel<true><<<grid, kOmegaTile, 0, st>>>(
                (const double*)de, (const double*)W, (const double*)omegas, (double*)buf, T, chunk, (int)P,
                (int)nw, width, gnorm, (int)grid.z);
        } else {
            spectral_partial_kernel<false><<<grid, kOmegaTile, 0, st>>>(
                (const double*)de, (const double*)W, (const double*)omegas, (double*)buf, T, chunk, (int)P,
                (int)nw, width, gnorm, (int)grid.z);
        }
    }
    const int64_t n = P * nw * (lorentz ? 2 : 1);
    if (n > 0) {
        spectral_reduce_kernel<<<blocks_for(n), kThreads, 0, st>>>((const double*)buf, (double*)out, nch, n, 1);
    }
    return (int)cudaGetLastError();
}

// Kernel 16's q-batch Lorentzian mode.  de (Q, T) f64; W (Q, P, T) c128;
// omegas (nw,) f64; buf (Q, ceil(T / chunk), P, nw) c128 scratch; out
// (Q, P, nw) c128; width is eta.
extern "C" int pythtb_spectral_sum_qbatch(const void* de, const void* W, const void* omegas, void* buf, void* out,
                                          int64_t Q, int64_t T, int64_t P, int64_t nw, int64_t chunk, double width,
                                          void* stream) {
    const int64_t nch = (T + chunk - 1) / chunk;
    cudaStream_t st = (cudaStream_t)stream;
    if (Q <= 0 || nch <= 0 || P <= 0 || nw <= 0) return (int)cudaGetLastError();
    const int64_t groups = (P + kGroup - 1) / kGroup;
    if (Q * groups > 65535) return (int)cudaErrorInvalidValue;
    dim3 grid((unsigned int)nch, (unsigned int)((nw + kOmegaTile - 1) / kOmegaTile), (unsigned int)(Q * groups));
    spectral_partial_kernel<true><<<grid, kOmegaTile, 0, st>>>(
        (const double*)de, (const double*)W, (const double*)omegas, (double*)buf, T, chunk, (int)P, (int)nw, width,
        0.0, (int)groups);
    const int64_t n = P * nw * 2;
    spectral_reduce_kernel<<<blocks_for(n * Q), kThreads, 0, st>>>((const double*)buf, (double*)out, nch, n, Q);
    return (int)cudaGetLastError();
}
