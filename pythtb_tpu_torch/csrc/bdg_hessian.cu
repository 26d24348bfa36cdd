// Kernel 23: the BdG Daleckii-Krein Hessian and grand potential of the
// superfluid weight.
//
// Hessian mode replaces the band-basis part of
// pythtb_tpu/geometry.py:_sfw_analytic_jit (:373-454).  Per k, with the
// BdG eigenpairs (lam (B, N) float64, U (B, N, N) complex128, states as
// rows, N = 2 S) and the reduced derivatives dH(+-k) (B, d, S, S),
// d2H(+-k) (B, d, d, S, S):
//
//   M'_a  = blockdiag(dHc_a(+k), -conj(dHc_a(-k)))   (Cartesian: lat / 2 pi)
//   M''_ab = blockdiag(d2c_ab(+k), -conj(d2c_ab(-k)))
//   A_a[i, j] = <i| M'_a |j>,   f = sigmoid(-lam / kT),  f' = -f (1 - f) / kT
//   f[l_i, l_j] = (f_i - f_j) / (l_i - l_j) where |l_i - l_j| > tol, else
//                 (f'_i + f'_j) / 2     (tol batch-global, from the caller)
//   H_ab = sum_k [ sum_n f_n Re <n|M''_ab|n> + Re sum_ij f[l_i, l_j] A_a[i,j] A_b[j,i] ]
//
// The zero-padded 2S blocks are never built: a matrix element of a block
// diagonal M is the particle part over the first S components plus the
// hole part over the last S.  The Cartesian rotation is linear, so A and
// <n|M''|n> are formed in reduced coordinates and rotated per pair with
// lat (passed by value, in the kernel's constant parameter space).  The
// caller adds the hole trace sum_k Re tr d2c(-k), divides by B and
// symmetrizes.
//
// Grand-potential mode replaces the sum of _sfw_free_energy_jit (:333-372):
// per twist q, sum over k of -kT sum_i softplus(-lam_i / kT) + Re tr
// H(-k + dq) - mu S, with the stable softplus max(x, 0) + log1p(e^{-|x|})
// (the default kT is delta / 50: x reaches -lam / kT ~ 1e3).
//
// Sums: each block writes its (d, d) partial (or, in grand-potential mode,
// its q's sum through a fixed-order tree), and a second launch adds the
// partials in block order: no atomics.
//
// Mapping.  N <= 8: one thread per k, the pair loop in registers
// (templated on N).  9 <= N <= 64: one block per k, U and a product
// buffer in shared memory, A in a global scratch (B, d, N, N) that the
// wrapper allocates.  Above 64 the wrapper raises.  Bound at the Lieb row
// (B 2,304, N 6, d 2): ~5.5 MB read once, ~1.7 us at 3.35 TB/s: the call
// is launch-bound.
#include "common.cuh"

namespace {

struct Lat {
    double L[9];  // L[r * 3 + a] = lat[r, a] / (2 pi)
};

__device__ __forceinline__ cplx cfma(cplx a, cplx b, cplx c) {  // a * b + c
    return make_cuDoubleComplex(fma(a.x, b.x, fma(-a.y, b.y, c.x)), fma(a.x, b.y, fma(a.y, b.x, c.y)));
}

__device__ __forceinline__ double sigmoid_neg(double lam, double kt) {  // 1 / (1 + e^{lam / kT})
    return 1.0 / (1.0 + exp(lam / kt));
}

// <i| blockdiag(P, -conj(Q)) |j> for S x S blocks P, Q (row-major) and the
// rows Ui, Uj of length 2 S
__device__ cplx block_elem(const cplx* Ui, const cplx* Uj, const cplx* P, const cplx* Q, int S) {
    cplx acc = make_cuDoubleComplex(0.0, 0.0);
    for (int s = 0; s < S; ++s) {
        cplx y = make_cuDoubleComplex(0.0, 0.0);
        for (int t = 0; t < S; ++t) y = cfma(P[s * S + t], Uj[t], y);
        acc = cfma(cconj(Ui[s]), y, acc);
    }
    for (int s = 0; s < S; ++s) {
        cplx y = make_cuDoubleComplex(0.0, 0.0);
        for (int t = 0; t < S; ++t) y = cfma(cconj(Q[s * S + t]), Uj[S + t], y);
        acc = make_cuDoubleComplex(acc.x - (Ui[S + s].x * y.x + Ui[S + s].y * y.y),
                                   acc.y - (Ui[S + s].x * y.y - Ui[S + s].y * y.x));
    }
    return acc;
}

__device__ __forceinline__ double divided_difference(double li, double lj, double fi, double fj, double fpi,
                                                     double fpj, double tol) {
    const double dl = li - lj;
    return fabs(dl) > tol ? (fi - fj) / dl : 0.5 * (fpi + fpj);
}

__device__ void block_sum(double* red) {
    for (int half = blockDim.x / 2; half > 0; half >>= 1) {
        __syncthreads();
        if ((int)threadIdx.x < half) red[threadIdx.x] += red[threadIdx.x + half];
    }
    __syncthreads();
}

// Adds this thread's acc[a][c] into part[slot, a, c] by a block tree.
__device__ void write_partial(double acc[3][3], double* red, double* part, int64_t slot, int d) {
    for (int a = 0; a < d; ++a)
        for (int c = 0; c < d; ++c) {
            red[threadIdx.x] = acc[a][c];
            block_sum(red);
            if (threadIdx.x == 0) part[(slot * d + a) * d + c] = red[0];
            __syncthreads();
        }
}

// ---- one thread per k (N <= 8) ----------------------------------------------

template <int N>
__global__ void hessian_reg_kernel(const double* __restrict__ lam, const cplx* __restrict__ U,
                                   const cplx* __restrict__ dHp, const cplx* __restrict__ dHm,
                                   const cplx* __restrict__ d2p, const cplx* __restrict__ d2m,
                                   double* __restrict__ part, int64_t B, int d, double kt, double tol, Lat lat) {
    __shared__ double red[kThreads];
    constexpr int S = N / 2;
    const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    double acc[3][3] = {{0.0, 0.0, 0.0}, {0.0, 0.0, 0.0}, {0.0, 0.0, 0.0}};
    if (b < B) {
        double l[N], f[N], fp[N];
#pragma unroll
        for (int n = 0; n < N; ++n) {
            l[n] = lam[b * N + n];
            f[n] = sigmoid_neg(l[n], kt);
            fp[n] = -f[n] * (1.0 - f[n]) / kt;
        }
        const cplx* Ub = U + b * N * N;
        const int64_t SS = S * S;
        // sum_n f_n Re <n|M''_rs|n>, rotated
        for (int n = 0; n < N; ++n)
            for (int r = 0; r < d; ++r)
                for (int s = 0; s < d; ++s) {
                    const int64_t o = ((b * d + r) * d + s) * SS;
                    const double v = block_elem(Ub + n * N, Ub + n * N, d2p + o, d2m + o, S).x * f[n];
                    for (int a = 0; a < d; ++a)
                        for (int c = 0; c < d; ++c) acc[a][c] += lat.L[r * 3 + a] * lat.L[s * 3 + c] * v;
                }
        // sum_ij f[l_i, l_j] A_a[i, j] A_c[j, i]
        for (int i = 0; i < N; ++i)
            for (int j = 0; j < N; ++j) {
                cplx Aij[3], Aji[3];
                for (int r = 0; r < d; ++r) {
                    const int64_t o = (b * d + r) * SS;
                    const cplx x = block_elem(Ub + i * N, Ub + j * N, dHp + o, dHm + o, S);
                    const cplx y = block_elem(Ub + j * N, Ub + i * N, dHp + o, dHm + o, S);
                    Aij[r] = x;
                    Aji[r] = y;
                }
                const double dd = divided_difference(l[i], l[j], f[i], f[j], fp[i], fp[j], tol);
                for (int a = 0; a < d; ++a) {
                    cplx x = make_cuDoubleComplex(0.0, 0.0);
                    for (int r = 0; r < d; ++r)
                        x = make_cuDoubleComplex(x.x + lat.L[r * 3 + a] * Aij[r].x, x.y + lat.L[r * 3 + a] * Aij[r].y);
                    for (int c = 0; c < d; ++c) {
                        cplx y = make_cuDoubleComplex(0.0, 0.0);
                        for (int r = 0; r < d; ++r)
                            y = make_cuDoubleComplex(y.x + lat.L[r * 3 + c] * Aji[r].x,
                                                     y.y + lat.L[r * 3 + c] * Aji[r].y);
                        acc[a][c] += dd * (x.x * y.x - x.y * y.y);
                    }
                }
            }
    }
    write_partial(acc, red, part, blockIdx.x, d);
}

// ---- one block per k (9 <= N <= 64) -----------------------------------------

__global__ void hessian_block_kernel(const double* __restrict__ lam, const cplx* __restrict__ U,
                                     const cplx* __restrict__ dHp, const cplx* __restrict__ dHm,
                                     const cplx* __restrict__ d2p, const cplx* __restrict__ d2m,
                                     cplx* __restrict__ scratch, double* __restrict__ part, int N, int d,
                                     double kt, double tol, Lat lat) {
    extern __shared__ double smem[];
    double* red = smem;                                   // kThreads
    double* l = red + kThreads;                           // N
    double* f = l + N;                                    // N
    double* fp = f + N;                                   // N
    cplx* Us = reinterpret_cast<cplx*>(fp + N);           // N * N
    cplx* W = Us + N * N;                                 // N * N
    const int64_t b = blockIdx.x;
    const int S = N / 2;
    const int NN = N * N;
    const int64_t SS = (int64_t)S * S;
    for (int i = threadIdx.x; i < NN; i += blockDim.x) Us[i] = U[b * NN + i];
    for (int n = threadIdx.x; n < N; n += blockDim.x) {
        l[n] = lam[b * N + n];
        f[n] = sigmoid_neg(l[n], kt);
        fp[n] = -f[n] * (1.0 - f[n]) / kt;
    }
    __syncthreads();
    cplx* A = scratch + b * (int64_t)d * NN;  // A[r, i, j], reduced
    for (int r = 0; r < d; ++r) {
        const cplx* P = dHp + (b * d + r) * SS;
        const cplx* Q = dHm + (b * d + r) * SS;
        // W[s, j] = sum_t M'_r[s, t] U[j, t]
        for (int e = threadIdx.x; e < NN; e += blockDim.x) {
            const int s = e / N, j = e - s * N;
            cplx y = make_cuDoubleComplex(0.0, 0.0);
            if (s < S) {
                for (int t = 0; t < S; ++t) y = cfma(P[s * S + t], Us[j * N + t], y);
            } else {
                for (int t = 0; t < S; ++t) y = cfma(cconj(Q[(s - S) * S + t]), Us[j * N + S + t], y);
                y = make_cuDoubleComplex(-y.x, -y.y);
            }
            W[e] = y;
        }
        __syncthreads();
        for (int e = threadIdx.x; e < NN; e += blockDim.x) {
            const int i = e / N, j = e - i * N;
            cplx acc = make_cuDoubleComplex(0.0, 0.0);
            for (int s = 0; s < N; ++s) acc = cfma(cconj(Us[i * N + s]), W[s * N + j], acc);
            A[r * NN + e] = acc;
        }
        __syncthreads();
    }
    double acc[3][3] = {{0.0, 0.0, 0.0}, {0.0, 0.0, 0.0}, {0.0, 0.0, 0.0}};
    for (int e = threadIdx.x; e < N * d * d; e += blockDim.x) {
        const int n = e / (d * d), rs = e - n * d * d, r = rs / d, s = rs - r * d;
        const int64_t o = ((b * d + r) * d + s) * SS;
        const double v = block_elem(Us + n * N, Us + n * N, d2p + o, d2m + o, S).x * f[n];
        for (int a = 0; a < d; ++a)
            for (int c = 0; c < d; ++c) acc[a][c] += lat.L[r * 3 + a] * lat.L[s * 3 + c] * v;
    }
    for (int e = threadIdx.x; e < NN; e += blockDim.x) {
        const int i = e / N, j = e - i * N;
        const double dd = divided_difference(l[i], l[j], f[i], f[j], fp[i], fp[j], tol);
        for (int a = 0; a < d; ++a) {
            cplx x = make_cuDoubleComplex(0.0, 0.0);
            for (int r = 0; r < d; ++r) {
                const cplx v = A[r * NN + i * N + j];
                x = make_cuDoubleComplex(x.x + lat.L[r * 3 + a] * v.x, x.y + lat.L[r * 3 + a] * v.y);
            }
            for (int c = 0; c < d; ++c) {
                cplx y = make_cuDoubleComplex(0.0, 0.0);
                for (int r = 0; r < d; ++r) {
                    const cplx v = A[r * NN + j * N + i];
                    y = make_cuDoubleComplex(y.x + lat.L[r * 3 + c] * v.x, y.y + lat.L[r * 3 + c] * v.y);
                }
                acc[a][c] += dd * (x.x * y.x - x.y * y.y);
            }
        }
    }
    write_partial(acc, red, part, b, d);
}

// out[a, c] = sum over p of part[p, a, c], in p order
__global__ void reduce_partials_kernel(const double* __restrict__ part, double* __restrict__ out, int64_t P,
                                       int m) {
    const int i = threadIdx.x;
    if (i >= m) return;
    double acc = 0.0;
    for (int64_t p = 0; p < P; ++p) acc += part[p * m + i];
    out[i] = acc;
}

// one block per q: sum over k of -kT sum_i softplus(-lam_i / kT) + tr_k - mu S
__global__ void grand_potential_kernel(const double* __restrict__ lam, const double* __restrict__ tr,
                                       double* __restrict__ out, int64_t B, int N, double kt, double muS) {
    __shared__ double red[kThreads];
    const int64_t q = blockIdx.x;
    double acc = 0.0;
    for (int64_t k = threadIdx.x; k < B; k += blockDim.x) {
        const double* lk = lam + (q * B + k) * N;
        double sp = 0.0;
        for (int i = 0; i < N; ++i) {
            const double x = -lk[i] / kt;
            sp += fmax(x, 0.0) + log1p(exp(-fabs(x)));
        }
        acc += -kt * sp + tr[q * B + k] - muS;
    }
    red[threadIdx.x] = acc;
    block_sum(red);
    if (threadIdx.x == 0) out[q] = red[0];
}

template <int N>
void launch_reg(const double* lam, const cplx* U, const cplx* dHp, const cplx* dHm, const cplx* d2p, const cplx* d2m,
                double* part, int64_t B, int d, double kt, double tol, Lat lat, cudaStream_t st) {
    hessian_reg_kernel<N><<<blocks_for(B), kThreads, 0, st>>>(lam, U, dHp, dHm, d2p, d2m, part, B, d, kt, tol, lat);
}

}  // namespace

// Hessian mode: lam (B, N), U (B, N, N), dHp/dHm (B, d, S, S), d2p/d2m (B,
// d, d, S, S), N = 2 S even, 1 <= d <= 3; scratch (B, d, N, N) for N > 8
// (may be null below); part (slots, d, d) with slots = ceil(B / 256) at N
// <= 8 and B above; out (d, d).
extern "C" int pythtb_bdg_hessian(const void* lam, const void* U, const void* dHp, const void* dHm, const void* d2p,
                                  const void* d2m, void* scratch, void* part, void* out, int64_t B, int64_t N,
                                  int64_t d, double kt, double tol, double l00, double l01, double l02, double l10,
                                  double l11, double l12, double l20, double l21, double l22, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    const double two_pi = 6.283185307179586476925286766559;
    Lat lat = {{l00 / two_pi, l01 / two_pi, l02 / two_pi, l10 / two_pi, l11 / two_pi, l12 / two_pi, l20 / two_pi,
                l21 / two_pi, l22 / two_pi}};
    const double* lam_ = (const double*)lam;
    const cplx* U_ = (const cplx*)U;
    const cplx* a_ = (const cplx*)dHp;
    const cplx* b_ = (const cplx*)dHm;
    const cplx* c_ = (const cplx*)d2p;
    const cplx* e_ = (const cplx*)d2m;
    double* p_ = (double*)part;
    if (B <= 0) return (int)cudaGetLastError();
    int64_t slots = B;
    switch (N) {
        case 2: launch_reg<2>(lam_, U_, a_, b_, c_, e_, p_, B, (int)d, kt, tol, lat, st); slots = blocks_for(B); break;
        case 4: launch_reg<4>(lam_, U_, a_, b_, c_, e_, p_, B, (int)d, kt, tol, lat, st); slots = blocks_for(B); break;
        case 6: launch_reg<6>(lam_, U_, a_, b_, c_, e_, p_, B, (int)d, kt, tol, lat, st); slots = blocks_for(B); break;
        case 8: launch_reg<8>(lam_, U_, a_, b_, c_, e_, p_, B, (int)d, kt, tol, lat, st); slots = blocks_for(B); break;
        default: {
            const size_t bytes = kThreads * sizeof(double) + 3 * N * sizeof(double) + 2 * N * N * sizeof(cplx);
            cudaFuncSetAttribute(hessian_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
            hessian_block_kernel<<<(unsigned)B, kThreads, bytes, st>>>(lam_, U_, a_, b_, c_, e_, (cplx*)scratch, p_,
                                                                        (int)N, (int)d, kt, tol, lat);
        }
    }
    reduce_partials_kernel<<<1, 32, 0, st>>>(p_, (double*)out, slots, (int)(d * d));
    return (int)cudaGetLastError();
}

// Grand-potential mode: lam (nq * B, N), tr (nq * B,) -> out (nq,) sums
// over k (the caller divides by B).
extern "C" int pythtb_bdg_grand_potential(const void* lam, const void* tr, void* out, int64_t nq, int64_t B,
                                          int64_t N, double kt, double muS, void* stream) {
    if (nq > 0)
        grand_potential_kernel<<<(unsigned)nq, kThreads, 0, (cudaStream_t)stream>>>(
            (const double*)lam, (const double*)tr, (double*)out, B, (int)N, kt, muS);
    return (int)cudaGetLastError();
}
