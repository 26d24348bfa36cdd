// Kernel 27: the Colpa factorization of linear spin-wave theory.
//
// Replaces the assembly and factorization of
// pythtb_tpu/magnon.py:_lswt_solve_jit (:284-329): the three scatters of
// A(k), B(k) and A(-k), the 2n x 2n bosonic BdG matrix, its
// Hermitization and shift, jnp.linalg.cholesky and the product
// K sigma3 K^H (K = L^H).  Per k of the batch:
//
//   h(k) = [[A(k) - C, B(k)], [B(k)^H, conj(A(-k)) - C]],
//   A(k)_ij = sum over DIRECTED bond entries b with (i_b, j_b) = (i, j) of
//             a_b e^{2 pi i k.d_b}, B(k) likewise with b_b (no implicit
//             partner: every direction is its own entry, unlike kernel 1),
//   h <- 0.5 (h + h^H) + shift 1,  h = L L^H (lower Cholesky),
//   T = L^H sigma3 L,  sigma3 = diag(1_n, -1_n).
//
// T shares the para-unitary spectrum of sigma3 h; the caller takes
// eigh_batched(T) and, for vectors, X = L^{-H} W |lambda|^{1/2} by one
// triangular solve.  A pivot that is not positive (or NaN) writes NaN
// into that k's T and L: the caller raises the reference's "Colpa
// decomposition failed" error, as jnp.linalg.cholesky's NaN does
// (:370-376).
//
// What bounds it on the H100: at the rows' 2n 4-6 the bytes (T and L
// written, 32 (2n)^2 a k) and the latency of the factorization's 2n
// dependent columns; the m^3 / 3 complex multiply-adds of the Cholesky
// and m^3 / 2 of the product (m = 2n) lead from 2n ~ 32.  Design: one
// block per k, h in shared memory (row stride m + 1 against bank
// conflicts; 2n <= 64, so at most 65 kB of dynamic shared memory); each
// element gathers its bond entries in list order (deterministic); a
// right-looking Cholesky on the lower triangle keeps the column
// unscaled until the end (h_il -= h_ij conj(h_lj) / h_jj), so each
// column costs one block barrier; then the columns are scaled, L and the
// product written.  Above 2n = 64 the wrapper raises.
#include "common.cuh"

namespace {

constexpr int kColpaThreads = 256;

__global__ void colpa_kernel(const double* __restrict__ kpts, const int* __restrict__ ii,
                             const int* __restrict__ jj, const double* __restrict__ dvec,
                             const cplx* __restrict__ a_amp, const cplx* __restrict__ b_amp,
                             const double* __restrict__ cdiag, double shift, cplx* __restrict__ T,
                             cplx* __restrict__ L, int n, int nb, int dk) {
    extern __shared__ cplx h[];  // (m, m + 1), then m doubles
    const int m = 2 * n, ld = m + 1;
    double* rs = reinterpret_cast<double*>(h + m * ld);  // 1 / sqrt of the pivots
    const int64_t b = blockIdx.x;
    const double* k = kpts + b * dk;
    const int tid = threadIdx.x;

    // 1. the raw h(k), every element gathering its entries in list order
    for (int e = tid; e < m * m; e += blockDim.x) {
        const int p = e / m, q = e - p * m;
        const bool lo_p = p >= n, lo_q = q >= n;
        const int pi = lo_p ? p - n : p, qi = lo_q ? q - n : q;
        double re = 0.0, im = 0.0;
        for (int c = 0; c < nb; ++c) {
            const int ib = ii[c], jb = jj[c];
            // top-left, top-right, bottom-right: (i, j) = (pi, qi); bottom-left: (qi, pi)
            const bool hit = (lo_p && !lo_q) ? (ib == qi && jb == pi) : (ib == pi && jb == qi);
            if (!hit) continue;
            double x = 0.0;
            for (int a = 0; a < dk; ++a) x = fma(k[a], dvec[(int64_t)c * dk + a], x);
            double sn, cs;
            sincospi(2.0 * x, &sn, &cs);  // e^{2 pi i k.d}
            const cplx amp = (lo_p == lo_q) ? a_amp[c] : b_amp[c];
            const double vr = amp.x * cs - amp.y * sn, vi = amp.x * sn + amp.y * cs;
            if (!lo_p && !lo_q) {  // A(k)
                re += vr;
                im += vi;
            } else if (!lo_p) {  // B(k)
                re += vr;
                im += vi;
            } else if (!lo_q) {  // B(k)^H: conj(b e^{i k.d})
                re += vr;
                im -= vi;
            } else {  // conj(A(-k)) = conj(a) e^{2 pi i k.d}
                re += amp.x * cs + amp.y * sn;
                im += amp.x * sn - amp.y * cs;
            }
        }
        if (p == q) re -= cdiag[pi];
        h[p * ld + q] = make_cuDoubleComplex(re, im);
    }
    __syncthreads();
    // 2. Hermitize into the lower triangle (the upper one is only read) and shift
    for (int e = tid; e < m * m; e += blockDim.x) {
        const int p = e / m, q = e - p * m;
        if (q > p) continue;
        const cplx x = h[p * ld + q], y = h[q * ld + p];
        h[p * ld + q] = p == q ? make_cuDoubleComplex(x.x + shift, 0.0)
                               : make_cuDoubleComplex(0.5 * (x.x + y.x), 0.5 * (x.y - y.y));
    }
    __syncthreads();
    // 3. right-looking Cholesky on the lower triangle, columns unscaled
    bool bad = false;
    for (int j = 0; j < m; ++j) {
        const double d = h[j * ld + j].x;
        if (!(d > 0.0)) {  // the same value in every thread: a uniform exit
            bad = true;
            break;
        }
        const int r = m - j - 1;
        for (int e = tid; e < r * r; e += blockDim.x) {
            const int i = j + 1 + e / r, l = j + 1 + e % r;
            if (l > i) continue;
            const cplx x = h[i * ld + j];
            if (i == l) {
                h[i * ld + i].x -= (x.x * x.x + x.y * x.y) / d;
            } else {
                const cplx y = h[l * ld + j];  // h_il -= x conj(y) / d
                h[i * ld + l].x -= (x.x * y.x + x.y * y.y) / d;
                h[i * ld + l].y -= (x.y * y.x - x.x * y.y) / d;
            }
        }
        __syncthreads();
    }
    cplx* Tb = T + b * m * m;
    cplx* Lb = L + b * m * m;
    if (bad) {
        const cplx nanv = make_cuDoubleComplex(nan(""), nan(""));
        for (int e = tid; e < m * m; e += blockDim.x) {
            Tb[e] = nanv;
            Lb[e] = nanv;
        }
        return;
    }
    // 4. scale the columns: L_ij = h_ij / sqrt(h_jj), L_jj = sqrt(h_jj)
    for (int j = tid; j < m; j += blockDim.x) rs[j] = 1.0 / sqrt(h[j * ld + j].x);
    __syncthreads();
    for (int e = tid; e < m * m; e += blockDim.x) {
        const int i = e / m, j = e - i * m;
        if (j < i) {
            h[i * ld + j] = make_cuDoubleComplex(h[i * ld + j].x * rs[j], h[i * ld + j].y * rs[j]);
        } else if (j == i) {
            h[i * ld + i] = make_cuDoubleComplex(sqrt(h[i * ld + i].x), 0.0);
        }
    }
    __syncthreads();
    // 5. L and T = L^H sigma3 L: T_pq = sum_{r >= max(p, q)} conj(L_rp) sigma_r L_rq
    for (int e = tid; e < m * m; e += blockDim.x) {
        const int p = e / m, q = e - p * m;
        Lb[e] = q <= p ? h[p * ld + q] : make_cuDoubleComplex(0.0, 0.0);
        double re = 0.0, im = 0.0;
        for (int r = max(p, q); r < m; ++r) {
            const cplx x = cmul_conj(h[r * ld + p], h[r * ld + q]);
            if (r < n) {
                re += x.x;
                im += x.y;
            } else {
                re -= x.x;
                im -= x.y;
            }
        }
        Tb[e] = make_cuDoubleComplex(re, p == q ? 0.0 : im);  // nvcc's FMAs leave ~1e-17 on the diagonal
    }
}

}  // namespace

// Kernel 27.  kpts (B, dk) f64; ii, jj (nb,) i32 site indices; dvec (nb,
// dk) f64; a_amp, b_amp (nb,) c128; cdiag (n,) f64; T, L (B, 2n, 2n) c128
// outputs.  2n <= 64.
extern "C" int pythtb_colpa(const void* kpts, const void* ii, const void* jj, const void* dvec, const void* a_amp,
                            const void* b_amp, const void* cdiag, void* T, void* L, int64_t B, int64_t n, int64_t nb,
                            int64_t dk, double shift, void* stream) {
    const int m = 2 * (int)n;
    const size_t smem = (size_t)m * (m + 1) * sizeof(cplx) + (size_t)m * sizeof(double);
    if (smem > 48 * 1024) {
        const cudaError_t rc =
            cudaFuncSetAttribute(colpa_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (rc != cudaSuccess) return (int)rc;
    }
    if (B > 0) {
        colpa_kernel<<<(unsigned int)B, kColpaThreads, smem, (cudaStream_t)stream>>>(
            (const double*)kpts, (const int*)ii, (const int*)jj, (const double*)dvec, (const cplx*)a_amp,
            (const cplx*)b_amp, (const double*)cdiag, shift, (cplx*)T, (cplx*)L, (int)n, (int)nb, (int)dk);
    }
    return (int)cudaGetLastError();
}
