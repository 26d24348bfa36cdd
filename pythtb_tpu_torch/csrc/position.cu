// Kernel 6: position-operator matrices of chosen states.
//
// Replaces pythtb_tpu/ops/position.py:_xmat (inside _pos_matrix_jit,
// _pos_matrix_packed_jit and _hwf_core) and the diagonal-only einsum of
// _pos_expectation_packed_jit, which XLA fused with the state gather:
//   X[b, n, m] = sum_f conj(w[b, occ[n], f]) * pos[f] * w[b, occ[m], f]
// for states w (B, nsta, F), an index array occ (S,) of the chosen states
// and real orbital positions pos (F,).  Full mode writes X (B, S, S)
// complex128; diagonal mode writes only Re X[b, n, n] as (B, S) float64.
//
// What bounds it on the H100: reading the chosen states, B*S*F*16 bytes,
// and writing X, B*S*S*16 bytes; S*S*F complex multiply-adds per batch
// element are far below the fp64 peak for the S of a slab or a Wannier
// set.  Design: one thread per output element (b, n, m) with n <= m --
// the upper triangle, addressed in closed form -- loops over F and writes
// (b, n, m) and its conjugate at (b, m, n), so X is exactly Hermitian,
// as the eigensolver downstream assumes.  The state selection is read
// through occ, so the chosen states are never copied out of the grid.
// Any S and F.
#include "common.cuh"

__global__ void position_matrix_kernel(const cplx* __restrict__ w, const double* __restrict__ pos,
                                       const int64_t* __restrict__ occ, cplx* __restrict__ X,
                                       int64_t B, int64_t nsta, int64_t S, int64_t F) {
    const int64_t npairs = S * (S + 1) / 2;
    const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= B * npairs) return;
    const int64_t b = t / npairs;
    const int64_t p = t % npairs;
    // row n of the upper triangle starts at n*S - n*(n-1)/2; estimate n
    // from the quadratic, then correct the rounding
    const double s2 = 2.0 * (double)S + 1.0;
    int64_t n = (int64_t)floor(0.5 * (s2 - sqrt(s2 * s2 - 8.0 * (double)p)));
    if (n < 0) n = 0;
    if (n > S - 1) n = S - 1;
    while (n > 0 && n * S - n * (n - 1) / 2 > p) --n;
    while (n + 1 < S && (n + 1) * S - (n + 1) * n / 2 <= p) ++n;
    const int64_t m = n + (p - (n * S - n * (n - 1) / 2));

    const cplx* wn = w + (b * nsta + occ[n]) * F;
    const cplx* wm = w + (b * nsta + occ[m]) * F;
    double re = 0.0, im = 0.0;
    for (int64_t f = 0; f < F; ++f) {
        const cplx z = cmul_conj(wn[f], wm[f]);
        re += pos[f] * z.x;
        im += pos[f] * z.y;
    }
    // the diagonal is real: x*y - y*x is 0 only without FMA contraction
    if (n == m) im = 0.0;
    cplx* Xb = X + b * S * S;
    Xb[n * S + m] = make_cuDoubleComplex(re, im);
    Xb[m * S + n] = make_cuDoubleComplex(re, -im);
}

__global__ void position_diag_kernel(const cplx* __restrict__ w, const double* __restrict__ pos,
                                     const int64_t* __restrict__ occ, double* __restrict__ out,
                                     int64_t B, int64_t nsta, int64_t S, int64_t F) {
    const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= B * S) return;
    const int64_t b = t / S;
    const int64_t n = t % S;
    const cplx* wn = w + (b * nsta + occ[n]) * F;
    double acc = 0.0;
    for (int64_t f = 0; f < F; ++f) acc += pos[f] * (wn[f].x * wn[f].x + wn[f].y * wn[f].y);
    out[t] = acc;
}

extern "C" int pythtb_position(const void* w, const void* pos, const void* occ, void* out,
                               int64_t B, int64_t nsta, int64_t S, int64_t F, int64_t diagonal,
                               void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (diagonal) {
        if (B * S > 0)
            position_diag_kernel<<<blocks_for(B * S), kThreads, 0, st>>>(
                (const cplx*)w, (const double*)pos, (const int64_t*)occ, (double*)out, B, nsta, S, F);
    } else {
        const int64_t n = B * (S * (S + 1) / 2);
        if (n > 0)
            position_matrix_kernel<<<blocks_for(n), kThreads, 0, st>>>(
                (const cplx*)w, (const double*)pos, (const int64_t*)occ, (cplx*)out, B, nsta, S, F);
    }
    return (int)cudaGetLastError();
}
