// Kernel 20: the Schur pole sums of the DMFT lattice and impurity.
//
// One body, R_m = 1 / (z - lam_m), written as (x - i y) / (x^2 + y^2)
// with x + i y = z - lam_m (kernel 16's form), in four modes:
//
//   k-mean:   G(w)      = (1/Nk) sum_k 1 / (z_w - eps_o(k) - Sigma(w) - F(k, z_w)),
//             F(k, z)   = sum_m amps[k, m] R_m(k, z)
//             (pythtb_tpu/dmft.py:_gloc_pole_jit :116-146, _gloc_real_pole_jit :163-182)
//   pole:     G(w)      = sum_t a_t / (z_w - p_t), z_w complex per frequency
//             (_gloc_bethe_jit :149-155, _gloc_real_bethe_jit :185-191 with
//             z_w - Sigma(w) folded into z_w; _lehmann_matsubara_jit :256-262)
//   map:      A(k, w)   = -Im G_oo(k, z_w) / pi   (_aspec_pole_jit :194-212)
//   resolved: A_oo(k, w) and A_vv,jj(k, w) = -Im G_vv,jj / pi by the Schur
//             identity in the H_vv eigenbasis (_aspec_full_jit :215-253):
//             G_vv,jj = sum_m |W_jm|^2 R_m + c_j G_oo d_j,
//             c_j = sum_m W_jm b_m R_m,  d_j = sum_m conj(W_jm b_m) R_m.
//
// What bounds it on the H100: the operations at the resolved row (1,001 k
// x 2,001 w, nv 7: about 1,100 float64 operations a (k, w), 2.2 GFLOP,
// ~65 us) beside the 128 MB output write (~38 us); the k-mean and pole
// modes are small (Nk 256 x nw 96-128).  Design: no (k, w, m) tensor is
// ever stored.  Map and resolved: one thread per (k, w), a block per
// (k, tile of 128 frequencies), k on the grid's x dimension (any count);
// a resolved thread keeps R_m of its first 8 states in registers and
// recomputes those of later states for each spectator j (any nv).  K-mean and pole: a grid of
// (chunks of k or poles x frequency tiles), each thread summing its chunk
// in order into a partial, and a second pass that adds the chunks in
// order (deterministic, as kernel 16 does).
#include "common.cuh"

constexpr int kOmegaTile = 128;
constexpr int kRegNv = 8;  // resolved mode: R_m of the first 8 states in registers
constexpr double kInvPi = 0.31830988618379067154;

// a / (x + i y) for real a
__device__ __forceinline__ cplx real_over(double a, double x, double y) {
    const double inv = a / (x * x + y * y);
    return make_cuDoubleComplex(x * inv, -y * inv);
}

// 1 / (x + i y)
__device__ __forceinline__ cplx recip(double x, double y) { return real_over(1.0, x, y); }

// G_oo(k, z) of the Schur form: 1 / (z - eps - sigma - sum_m amps_m / (z - lam_m))
__device__ __forceinline__ cplx schur_goo(const double* __restrict__ amps, const double* __restrict__ lams,
                                          int64_t nv, double eps, cplx z, cplx sg) {
    double fr = 0.0, fi = 0.0;
    for (int64_t m = 0; m < nv; ++m) {
        const cplx r = real_over(amps[m], z.x - lams[m], z.y);
        fr += r.x;
        fi += r.y;
    }
    return recip(z.x - eps - sg.x - fr, z.y - sg.y - fi);
}

// modes 0 (k-mean) and 1 (pole): partial[chunk, w] over the chunk's terms
template <bool KMEAN>
__global__ void pole_partial_kernel(const double* __restrict__ eps, const double* __restrict__ amps,
                                    const double* __restrict__ lams, const cplx* __restrict__ z,
                                    const cplx* __restrict__ sigma, cplx* __restrict__ partial, int64_t T,
                                    int64_t nv, int64_t chunk_len, int64_t nw) {
    const int64_t iw = (int64_t)blockIdx.y * blockDim.x + threadIdx.x;
    if (iw >= nw) return;
    const int64_t t0 = (int64_t)blockIdx.x * chunk_len;
    const int64_t t1 = min(T, t0 + chunk_len);
    const cplx zw = z[iw];
    const cplx sg = KMEAN ? sigma[iw] : make_cuDoubleComplex(0.0, 0.0);
    double gr = 0.0, gi = 0.0;
    for (int64_t t = t0; t < t1; ++t) {
        cplx g;
        if (KMEAN) {
            g = schur_goo(amps + t * nv, lams + t * nv, nv, eps[t], zw, sg);
        } else {
            g = real_over(amps[t], zw.x - lams[t], zw.y);
        }
        gr += g.x;
        gi += g.y;
    }
    partial[(int64_t)blockIdx.x * nw + iw] = make_cuDoubleComplex(gr, gi);
}

// out[w] = (sum over chunks, in order, of partial[c, w]) * norm
__global__ void pole_reduce_kernel(const cplx* __restrict__ partial, cplx* __restrict__ out, int64_t nch,
                                   int64_t nw, double norm) {
    const int64_t iw = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (iw >= nw) return;
    double sr = 0.0, si = 0.0;
    for (int64_t c = 0; c < nch; ++c) {
        const cplx p = partial[c * nw + iw];
        sr += p.x;
        si += p.y;
    }
    out[iw] = make_cuDoubleComplex(sr * norm, si * norm);
}

// mode 2: A(k, w) = -Im G_oo / pi, grid (Nk, frequency tiles): k on the
// x dimension, which takes 2^31 - 1 blocks (y takes 65,535)
__global__ void pole_map_kernel(const double* __restrict__ eps, const double* __restrict__ amps,
                                const double* __restrict__ lams, const cplx* __restrict__ z,
                                const cplx* __restrict__ sigma, double* __restrict__ out, int64_t nv, int64_t nw) {
    const int64_t iw = (int64_t)blockIdx.y * blockDim.x + threadIdx.x;
    if (iw >= nw) return;
    const int64_t k = blockIdx.x;
    const cplx g = schur_goo(amps + k * nv, lams + k * nv, nv, eps[k], z[iw], sigma[iw]);
    out[k * nw + iw] = -g.y * kInvPi;
}

// c_j, d_j and s_j = sum_m |W_jm|^2 R_m of one spectator j, term by term
struct SpectatorSums {
    double cr = 0.0, ci = 0.0, dr = 0.0, di = 0.0, sr = 0.0, si = 0.0;
    __device__ __forceinline__ void add(cplx w, cplx bm, cplx r) {
        const cplx q = cuCmul(w, bm);
        const double w2 = w.x * w.x + w.y * w.y;
        cr += q.x * r.x - q.y * r.y;  // q R
        ci += q.x * r.y + q.y * r.x;
        dr += q.x * r.x + q.y * r.y;  // conj(q) R
        di += q.x * r.y - q.y * r.x;
        sr += w2 * r.x;
        si += w2 * r.y;
    }
};

// mode 3: A_oo (Nk, nw) and A_vv (Nk, nw, nv), any nv >= 1.  W[k] and b[k]
// are read where they are used (one address a warp: broadcast loads, L1
// hits); each thread keeps R_m of the first kRegNv states in registers and
// recomputes those of later states for every spectator.
__global__ void pole_resolved_kernel(const double* __restrict__ eps, const double* __restrict__ lams,
                                     const cplx* __restrict__ W, const cplx* __restrict__ b,
                                     const cplx* __restrict__ z, const cplx* __restrict__ sigma,
                                     double* __restrict__ aoo, double* __restrict__ avv, int64_t nv, int64_t nw) {
    const int64_t iw = (int64_t)blockIdx.y * blockDim.x + threadIdx.x;
    if (iw >= nw) return;
    const int64_t k = blockIdx.x;
    const double* lam = lams + k * nv;
    const cplx* bk = b + k * nv;
    const cplx* Wk = W + k * nv * nv;  // W[k, j, m] at j * nv + m
    const cplx zw = z[iw];
    const cplx sg = sigma[iw];
    cplx R[kRegNv];
    double fr = 0.0, fi = 0.0;
#pragma unroll
    for (int m = 0; m < kRegNv; ++m) {
        if (m < nv) {
            R[m] = recip(zw.x - lam[m], zw.y);
            const cplx bm = bk[m];
            const double b2 = bm.x * bm.x + bm.y * bm.y;
            fr += b2 * R[m].x;
            fi += b2 * R[m].y;
        }
    }
    for (int64_t m = kRegNv; m < nv; ++m) {
        const cplx r = recip(zw.x - lam[m], zw.y);
        const cplx bm = bk[m];
        const double b2 = bm.x * bm.x + bm.y * bm.y;
        fr += b2 * r.x;
        fi += b2 * r.y;
    }
    const cplx goo = recip(zw.x - eps[k] - sg.x - fr, zw.y - sg.y - fi);
    aoo[k * nw + iw] = -goo.y * kInvPi;
    double* out = avv + (k * nw + iw) * nv;
    for (int64_t j = 0; j < nv; ++j) {
        const cplx* wj = Wk + j * nv;
        SpectatorSums s;
#pragma unroll
        for (int m = 0; m < kRegNv; ++m) {
            if (m < nv) s.add(wj[m], bk[m], R[m]);
        }
        for (int64_t m = kRegNv; m < nv; ++m) s.add(wj[m], bk[m], recip(zw.x - lam[m], zw.y));
        // Im(s + c goo d)
        const double tr = s.cr * goo.x - s.ci * goo.y, ti = s.cr * goo.y + s.ci * goo.x;
        out[j] = -(s.si + tr * s.di + ti * s.dr) * kInvPi;
    }
}

// Kernel 20, modes 0 (k-mean) and 1 (pole).  eps (T,) f64 (k-mean only),
// amps and lams (T, nv) f64 (pole mode: nv 1, amps the weights, lams the
// poles), z and sigma (nw,) c128 (sigma k-mean only), partial
// (ceil(T / chunk), nw) c128 scratch, out (nw,) c128; norm multiplies
// the sum (1 / Nk for the k-mean, 1 for the pole sum).
extern "C" int pythtb_pole_sum(const void* eps, const void* amps, const void* lams, const void* z,
                               const void* sigma, void* partial, void* out, int64_t T, int64_t nv, int64_t nw,
                               int64_t chunk, int64_t kmean, double norm, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    const int64_t nch = (T + chunk - 1) / chunk;
    if (nw <= 0) return 0;
    if (nch > 0) {
        const dim3 grid((unsigned int)nch, (unsigned int)((nw + kOmegaTile - 1) / kOmegaTile));
        if (kmean) {
            pole_partial_kernel<true><<<grid, kOmegaTile, 0, st>>>(
                (const double*)eps, (const double*)amps, (const double*)lams, (const cplx*)z, (const cplx*)sigma,
                (cplx*)partial, T, nv, chunk, nw);
        } else {
            pole_partial_kernel<false><<<grid, kOmegaTile, 0, st>>>(
                nullptr, (const double*)amps, (const double*)lams, (const cplx*)z, nullptr, (cplx*)partial, T, 1,
                chunk, nw);
        }
    }
    pole_reduce_kernel<<<blocks_for(nw), kThreads, 0, st>>>((const cplx*)partial, (cplx*)out, nch, nw, norm);
    return (int)cudaGetLastError();
}

// Kernel 20, mode 2 (map).  eps (Nk,), amps and lams (Nk, nv) f64, z and
// sigma (nw,) c128, out (Nk, nw) f64.
extern "C" int pythtb_pole_map(const void* eps, const void* amps, const void* lams, const void* z,
                               const void* sigma, void* out, int64_t Nk, int64_t nv, int64_t nw, void* stream) {
    if (Nk <= 0 || nw <= 0) return 0;
    const dim3 grid((unsigned int)Nk, (unsigned int)((nw + kOmegaTile - 1) / kOmegaTile));
    pole_map_kernel<<<grid, kOmegaTile, 0, (cudaStream_t)stream>>>(
        (const double*)eps, (const double*)amps, (const double*)lams, (const cplx*)z, (const cplx*)sigma,
        (double*)out, nv, nw);
    return (int)cudaGetLastError();
}

// Kernel 20, mode 3 (resolved).  eps (Nk,), lams (Nk, nv) f64, W (Nk, nv,
// nv) c128 (columns eigenvectors of H_vv), b (Nk, nv) c128, z and sigma
// (nw,) c128; aoo (Nk, nw) and avv (Nk, nw, nv) f64.
extern "C" int pythtb_pole_resolved(const void* eps, const void* lams, const void* W, const void* b,
                                    const void* z, const void* sigma, void* aoo, void* avv, int64_t Nk,
                                    int64_t nv, int64_t nw, void* stream) {
    if (Nk <= 0 || nw <= 0) return 0;
    if (nv < 1) return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned int)Nk, (unsigned int)((nw + kOmegaTile - 1) / kOmegaTile));
    pole_resolved_kernel<<<grid, kOmegaTile, 0, (cudaStream_t)stream>>>(
        (const double*)eps, (const double*)lams, (const cplx*)W, (const cplx*)b, (const cplx*)z,
        (const cplx*)sigma, (double*)aoo, (double*)avv, nv, nw);
    return (int)cudaGetLastError();
}
