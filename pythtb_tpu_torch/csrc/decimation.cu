// Kernel 12: Sancho-Rubio decimation of a semi-infinite principal-layer
// chain, per (energy, k) pixel.
//
// Replaces the XLA-fused lax.scan of pythtb_tpu/surface.py:_spectral_jit.
// For pixel p = (e, k), with w = E_e + i eta, es = e = H00_k, a = H01_k,
// b = a^H, each of the `iters` iterations is
//   g = (w - e)^{-1},  agb = a (g b),  bga = b (g a),
//   es += agb,  e += agb + bga,  a <- a (g a),  b <- b (g b),
// and the kernel writes, per pixel, -Im diag((w - es)^{-1}) / pi (the
// surface spectral weights), -Im diag((w - e)^{-1}) / pi (the bulk ones),
// max |a| after the last iteration, and the running peak of max |a|
// (the initial coupling included).  The host reduces the last two into
// the convergence residual and escalates `iters` as spectral_function
// does, so both packages run the same number of iterations.
//
// Green's-function mode (pythtb_decimation_green): the same recursion,
// but after the last iteration the kernel writes the whole surface
// Green's function G_s = (w - es)^{-1}, S x S complex per pixel, in place
// of the two weight vectors (the bulk inverse is not formed).  It replaces
// the decimation of pythtb_tpu/negf.py:_sancho_scan, the lead self-
// energies of NEGF transport: the host stacks the two orientations of a
// lead (H01^H for the left lead, H01 for the right one) on the K axis.
//
// What bounds it on the H100: latency.  The inputs are read once and
// the outputs written once (the Fermi-arc map, 10,201 pixels of S 2:
// 1.3 MB in, 0.3 MB out, well under a microsecond of bandwidth), but each
// pixel runs `iters` dependent steps of small complex algebra.  Design:
// the whole decimation of a pixel stays on chip.  At S <= 2 one thread
// owns a pixel, its matrices in registers and the inverse in closed form;
// for 3 <= S <= 40 one block owns a pixel, its threads (as many as the
// registers allow) striding over the S*S elements, the matrices in
// dynamic shared memory (opted in above 48 KB: about 205 KB at S 40) and
// the inverse by Gauss-Jordan with partial pivoting.  Larger S is refused (cudaErrorInvalidValue), and the
// Python wrapper raises before it gets here.  Maxima propagate NaN (the
// host's blow-up test needs it), so they are not fmax.
#include <algorithm>

#include "common.cuh"

constexpr int kMaxS = 40;  // 8 S*S complex matrices in 227 KB of shared memory
constexpr int kSmallThreads = 64;
constexpr double kPi = 3.141592653589793;

__device__ __forceinline__ double nan_max(double m, double x) {
    return (x > m || isnan(x)) ? x : m;
}

__device__ __forceinline__ double cabs_(cplx z) { return hypot(z.x, z.y); }

// -- S <= 2: one thread a pixel ---------------------------------------------

template <int S>
__device__ __forceinline__ void small_inv(const cplx* m, cplx* g) {
    if (S == 1) {
        g[0] = cuCdiv(make_cuDoubleComplex(1.0, 0.0), m[0]);
    } else {
        const cplx det = csub(cuCmul(m[0], m[3]), cuCmul(m[1], m[2]));
        g[0] = cuCdiv(m[3], det);
        g[1] = cuCdiv(make_cuDoubleComplex(-m[1].x, -m[1].y), det);
        g[2] = cuCdiv(make_cuDoubleComplex(-m[2].x, -m[2].y), det);
        g[3] = cuCdiv(m[0], det);
    }
}

template <int S>
__device__ __forceinline__ void small_mm(const cplx* x, const cplx* y, cplx* z) {
#pragma unroll
    for (int i = 0; i < S; ++i)
#pragma unroll
        for (int j = 0; j < S; ++j) {
            cplx s = make_cuDoubleComplex(0.0, 0.0);
#pragma unroll
            for (int l = 0; l < S; ++l) s = cuCadd(s, cuCmul(x[i * S + l], y[l * S + j]));
            z[i * S + j] = s;
        }
}

// -Im diag((w - m)^{-1}) / pi into out[0..S)
template <int S>
__device__ __forceinline__ void small_weights(cplx w, const cplx* m, double* out) {
    cplx r[S * S], g[S * S];
#pragma unroll
    for (int q = 0; q < S * S; ++q) r[q] = make_cuDoubleComplex(-m[q].x, -m[q].y);
#pragma unroll
    for (int s = 0; s < S; ++s) r[s * S + s] = cuCadd(r[s * S + s], w);
    small_inv<S>(r, g);
#pragma unroll
    for (int s = 0; s < S; ++s) out[s] = -g[s * S + s].y / kPi;
}

// (w - m)^{-1} into out[0..S*S)
template <int S>
__device__ __forceinline__ void small_green(cplx w, const cplx* m, cplx* out) {
    cplx r[S * S], g[S * S];
#pragma unroll
    for (int q = 0; q < S * S; ++q) r[q] = make_cuDoubleComplex(-m[q].x, -m[q].y);
#pragma unroll
    for (int s = 0; s < S; ++s) r[s * S + s] = cuCadd(r[s * S + s], w);
    small_inv<S>(r, g);
#pragma unroll
    for (int q = 0; q < S * S; ++q) out[q] = g[q];
}

// GREEN: write G_s into G (nE, K, S, S) and leave gs, gb alone
template <int S, bool GREEN>
__global__ void decimation_small(const cplx* __restrict__ H00, const cplx* __restrict__ H01,
                                 const cplx* __restrict__ wv, double* __restrict__ gs,
                                 double* __restrict__ gb, cplx* __restrict__ G,
                                 double* __restrict__ afin, double* __restrict__ peak, int64_t nE,
                                 int64_t K, int iters) {
    const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= nE * K) return;
    const int64_t k = p % K;
    const cplx w = wv[p / K];
    cplx es[S * S], e[S * S], a[S * S], b[S * S];
    double pk = 0.0;
#pragma unroll
    for (int i = 0; i < S; ++i)
#pragma unroll
        for (int j = 0; j < S; ++j) {
            es[i * S + j] = e[i * S + j] = H00[k * S * S + i * S + j];
            a[i * S + j] = H01[k * S * S + i * S + j];
            b[i * S + j] = cconj(H01[k * S * S + j * S + i]);
            pk = nan_max(pk, cabs_(a[i * S + j]));
        }
    for (int it = 0; it < iters; ++it) {
        cplx m[S * S], g[S * S], t1[S * S], t2[S * S], agb[S * S], bga[S * S];
#pragma unroll
        for (int q = 0; q < S * S; ++q) m[q] = make_cuDoubleComplex(-e[q].x, -e[q].y);
#pragma unroll
        for (int s = 0; s < S; ++s) m[s * S + s] = cuCadd(m[s * S + s], w);
        small_inv<S>(m, g);
        small_mm<S>(g, b, t1);
        small_mm<S>(g, a, t2);
        small_mm<S>(a, t1, agb);
        small_mm<S>(b, t2, bga);
        small_mm<S>(a, t2, m);  // a_n
        small_mm<S>(b, t1, g);  // b_n
#pragma unroll
        for (int q = 0; q < S * S; ++q) {
            es[q] = cuCadd(es[q], agb[q]);
            e[q] = cuCadd(cuCadd(e[q], agb[q]), bga[q]);
            a[q] = m[q];
            b[q] = g[q];
            pk = nan_max(pk, cabs_(a[q]));
        }
    }
    if (GREEN) {
        small_green<S>(w, es, G + p * S * S);
    } else {
        small_weights<S>(w, es, gs + p * S);
        small_weights<S>(w, e, gb + p * S);
    }
    double af = 0.0;
#pragma unroll
    for (int q = 0; q < S * S; ++q) af = nan_max(af, cabs_(a[q]));
    afin[p] = af;
    peak[p] = pk;
}

// -- 3 <= S <= kMaxS: one block a pixel ------------------------------------
//
// Thread t owns the elements q = t, t + nt, ... of every S x S matrix
// (nt = blockDim.x).  The eight matrices, three length-S vectors and the
// reduction buffer live in dynamic shared memory, laid out by `BlockSmem`.

struct BlockSmem {
    cplx *es, *e, *a, *b, *m, *g, *t1, *t2, *rowm, *rowg, *col;
    double* red;
    int* piv;
};

__host__ __device__ inline size_t block_smem_bytes(int S, int nt) {
    return (size_t)(8 * S * S + 3 * S) * sizeof(cplx) + (size_t)nt * sizeof(double) + sizeof(int);
}

__device__ inline BlockSmem block_smem(cplx* base, int S, int nt) {
    const int n = S * S;
    BlockSmem s;
    s.es = base;
    s.e = s.es + n;
    s.a = s.e + n;
    s.b = s.a + n;
    s.m = s.b + n;
    s.g = s.m + n;
    s.t1 = s.g + n;
    s.t2 = s.t1 + n;
    s.rowm = s.t2 + n;
    s.rowg = s.rowm + S;
    s.col = s.rowg + S;
    s.red = (double*)(s.col + S);
    s.piv = (int*)(s.red + nt);
    return s;
}

// g = m^{-1} by Gauss-Jordan with partial pivoting; m is destroyed.  Every
// thread of the block calls this; per column: the pivot search (thread 0),
// the row swap, the scaled pivot row and the column saved, the update.
__device__ void block_inv(const BlockSmem& s, int S) {
    const int t = threadIdx.x, nt = blockDim.x, n = S * S;
    cplx *m = s.m, *g = s.g;
    for (int q = t; q < n; q += nt) g[q] = make_cuDoubleComplex(q / S == q % S ? 1.0 : 0.0, 0.0);
    __syncthreads();
    for (int c = 0; c < S; ++c) {
        if (t == 0) {
            int r = c;
            double best = cabs_(m[c * S + c]);
            for (int q = c + 1; q < S; ++q) {
                const double v = cabs_(m[q * S + c]);
                if (v > best) {
                    best = v;
                    r = q;
                }
            }
            *s.piv = r;
        }
        __syncthreads();
        const int r = *s.piv;
        if (r != c)
            for (int j = t; j < S; j += nt) {
                cplx tmp = m[c * S + j];
                m[c * S + j] = m[r * S + j];
                m[r * S + j] = tmp;
                tmp = g[c * S + j];
                g[c * S + j] = g[r * S + j];
                g[r * S + j] = tmp;
            }
        __syncthreads();
        const cplx pv = m[c * S + c];
        for (int j = t; j < S; j += nt) {
            s.rowm[j] = cuCdiv(m[c * S + j], pv);
            s.rowg[j] = cuCdiv(g[c * S + j], pv);
            s.col[j] = m[j * S + c];
        }
        __syncthreads();
        for (int q = t; q < n; q += nt) {
            const int i = q / S, j = q - i * S;
            if (i == c) {
                m[q] = s.rowm[j];
                g[q] = s.rowg[j];
            } else {
                m[q] = csub(m[q], cuCmul(s.col[i], s.rowm[j]));
                g[q] = csub(g[q], cuCmul(s.col[i], s.rowg[j]));
            }
        }
        __syncthreads();
    }
}

__device__ __forceinline__ cplx block_mm(const cplx* x, const cplx* y, int S, int i, int j) {
    cplx s = make_cuDoubleComplex(0.0, 0.0);
    for (int l = 0; l < S; ++l) s = cuCadd(s, cuCmul(x[i * S + l], y[l * S + j]));
    return s;
}

// the NaN-propagating maximum of every thread's v
__device__ double block_max(double v, double* red) {
    const int t = threadIdx.x, nt = blockDim.x;
    red[t] = v;
    __syncthreads();
    if (t == 0) {
        double m = red[0];
        for (int q = 1; q < nt; ++q) m = nan_max(m, red[q]);
        red[0] = m;
    }
    __syncthreads();
    const double out = red[0];
    __syncthreads();
    return out;
}

// m = w I - x, then -Im diag(m^{-1}) / pi into out[0..S)
__device__ void block_weights(const BlockSmem& s, const cplx* x, cplx w, int S, double* out) {
    const int t = threadIdx.x, nt = blockDim.x, n = S * S;
    for (int q = t; q < n; q += nt) {
        const bool d = q / S == q % S;
        s.m[q] = make_cuDoubleComplex((d ? w.x : 0.0) - x[q].x, (d ? w.y : 0.0) - x[q].y);
    }
    __syncthreads();
    block_inv(s, S);
    for (int i = t; i < S; i += nt) out[i] = -s.g[i * S + i].y / kPi;
    __syncthreads();
}

template <bool GREEN>
__global__ void decimation_block(const cplx* __restrict__ H00, const cplx* __restrict__ H01,
                                 const cplx* __restrict__ wv, double* __restrict__ gs,
                                 double* __restrict__ gb, cplx* __restrict__ G,
                                 double* __restrict__ afin, double* __restrict__ peak, int64_t K,
                                 int S, int iters) {
    extern __shared__ cplx smem[];
    const int t = threadIdx.x, nt = blockDim.x, n = S * S;
    const BlockSmem s = block_smem(smem, S, nt);
    const int64_t p = blockIdx.x;
    const int64_t k = p % K;
    const cplx w = wv[p / K];
    const int64_t base = k * n;
    double pk = 0.0;
    for (int q = t; q < n; q += nt) {
        const int i = q / S, j = q - i * S;
        s.es[q] = s.e[q] = H00[base + q];
        s.a[q] = H01[base + q];
        s.b[q] = cconj(H01[base + j * S + i]);
        pk = nan_max(pk, cabs_(s.a[q]));
    }
    __syncthreads();
    for (int it = 0; it < iters; ++it) {
        for (int q = t; q < n; q += nt) {
            const bool d = q / S == q % S;
            s.m[q] = make_cuDoubleComplex((d ? w.x : 0.0) - s.e[q].x, (d ? w.y : 0.0) - s.e[q].y);
        }
        __syncthreads();
        block_inv(s, S);
        for (int q = t; q < n; q += nt) {
            const int i = q / S, j = q - i * S;
            s.t1[q] = block_mm(s.g, s.b, S, i, j);
            s.t2[q] = block_mm(s.g, s.a, S, i, j);
        }
        __syncthreads();
        // m, g <- agb = a t1, bga = b t2 (g is free once t1, t2 are made)
        for (int q = t; q < n; q += nt) {
            const int i = q / S, j = q - i * S;
            s.m[q] = block_mm(s.a, s.t1, S, i, j);
            s.g[q] = block_mm(s.b, s.t2, S, i, j);
        }
        __syncthreads();
        // each thread reads back only its own elements of m and g here
        for (int q = t; q < n; q += nt) {
            const int i = q / S, j = q - i * S;
            s.es[q] = cuCadd(s.es[q], s.m[q]);
            s.e[q] = cuCadd(cuCadd(s.e[q], s.m[q]), s.g[q]);
            s.m[q] = block_mm(s.a, s.t2, S, i, j);  // a_n
            s.g[q] = block_mm(s.b, s.t1, S, i, j);  // b_n
        }
        __syncthreads();
        for (int q = t; q < n; q += nt) {
            s.a[q] = s.m[q];
            s.b[q] = s.g[q];
            pk = nan_max(pk, cabs_(s.a[q]));
        }
        __syncthreads();
    }
    double af = 0.0;
    for (int q = t; q < n; q += nt) af = nan_max(af, cabs_(s.a[q]));
    af = block_max(af, s.red);
    pk = block_max(pk, s.red);
    if (t == 0) {
        afin[p] = af;
        peak[p] = pk;
    }
    if (GREEN) {
        for (int q = t; q < n; q += nt) {
            const bool d = q / S == q % S;
            s.m[q] = make_cuDoubleComplex((d ? w.x : 0.0) - s.es[q].x, (d ? w.y : 0.0) - s.es[q].y);
        }
        __syncthreads();
        block_inv(s, S);
        for (int q = t; q < n; q += nt) G[p * n + q] = s.g[q];
    } else {
        block_weights(s, s.es, w, S, gs + p * S);  // surface
        block_weights(s, s.e, w, S, gb + p * S);   // bulk
    }
}

template <bool GREEN>
static int decimation_launch(const void* H00, const void* H01, const void* w, void* gs, void* gb,
                             void* G, void* afin, void* peak, int64_t nE, int64_t K, int64_t S,
                             int64_t iters, void* stream) {
    const int64_t n = nE * K;
    if (n == 0) return 0;
    cudaStream_t st = (cudaStream_t)stream;
    const cplx *h0 = (const cplx*)H00, *h1 = (const cplx*)H01, *wv = (const cplx*)w;
    double *s = (double*)gs, *bk = (double*)gb, *af = (double*)afin, *pk = (double*)peak;
    cplx* g = (cplx*)G;
    const unsigned int grid = (unsigned int)((n + kSmallThreads - 1) / kSmallThreads);
    if (S == 1)
        decimation_small<1, GREEN><<<grid, kSmallThreads, 0, st>>>(h0, h1, wv, s, bk, g, af, pk, nE,
                                                                   K, (int)iters);
    else if (S == 2)
        decimation_small<2, GREEN><<<grid, kSmallThreads, 0, st>>>(h0, h1, wv, s, bk, g, af, pk, nE,
                                                                   K, (int)iters);
    else if (S <= kMaxS) {
        // as many threads as elements, up to what the kernel's registers
        // allow in one block (fewer than 1,024 in float64)
        cudaFuncAttributes fa;
        cudaError_t err = cudaFuncGetAttributes(&fa, decimation_block<GREEN>);
        if (err != cudaSuccess) return (int)err;
        const int nt = (int)std::min<int64_t>(fa.maxThreadsPerBlock / 32 * 32, (S * S + 31) / 32 * 32);
        const size_t smem = block_smem_bytes((int)S, nt);
        int dev = 0, optin = 0;
        err = cudaGetDevice(&dev);
        if (err == cudaSuccess)
            err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
        if (err != cudaSuccess) return (int)err;
        if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
        err = cudaFuncSetAttribute(decimation_block<GREEN>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
        decimation_block<GREEN><<<(unsigned int)n, (unsigned int)nt, smem, st>>>(
            h0, h1, wv, s, bk, g, af, pk, K, (int)S, (int)iters);
    } else
        return (int)cudaErrorInvalidValue;
    return (int)cudaGetLastError();
}

// H00, H01 (K, S, S) complex; w (nE,) complex (E + i eta); gs, gb (nE, K, S)
// float64; afin, peak (nE, K) float64.
extern "C" int pythtb_decimation(const void* H00, const void* H01, const void* w, void* gs,
                                 void* gb, void* afin, void* peak, int64_t nE, int64_t K,
                                 int64_t S, int64_t iters, void* stream) {
    return decimation_launch<false>(H00, H01, w, gs, gb, nullptr, afin, peak, nE, K, S, iters,
                                    stream);
}

// Green's-function mode: G (nE, K, S, S) complex in place of gs, gb.
extern "C" int pythtb_decimation_green(const void* H00, const void* H01, const void* w, void* G,
                                       void* afin, void* peak, int64_t nE, int64_t K, int64_t S,
                                       int64_t iters, void* stream) {
    return decimation_launch<true>(H00, H01, w, nullptr, nullptr, G, afin, peak, nE, K, S, iters,
                                   stream);
}
