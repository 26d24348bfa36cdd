// Kernel 8: the ELL matrix-free Hamiltonian application y = H x.
//
// Replaces pythtb_tpu/ops/matvec.py:matvec (XLA-fused gather + einsum):
//   y[n, b] = sum_d vals[n, d] x[cols[n, d], b]                  (nspin 1)
//   y[n, s, b] = sum_d sum_t vals[n, d, s, t] x[cols[n, d], t, b] (nspin 2)
// on a block of B vectors.  x and y are (nsta, B) row-major with row
// strides ldx and ldy (ldy lets the Kubo recursion write a velocity
// application straight into a slot of its Chebyshev block).
//
// What bounds it on the H100: bytes.  Each output element reads D
// (col, val) pairs and D gathered x entries; at N 90,000, D 5, B 8 the
// unique bytes are ~32 MB (bound ~9.6 us at 3.35 TB/s) against ~1.4
// double-precision operations per byte.  Design: one thread per output
// element (r, b) with b fastest, so the threads of a warp read one
// gathered row x[cols[n, d], :] as contiguous bytes and share the row's
// cols and vals through L1; the slot sum runs in slot order, so the
// result does not depend on the launch shape.  No shared memory, no
// atomics.
#include "ell.cuh"

template <int S>
__global__ void ell_matvec_kernel(const int* __restrict__ cols, const cplx* __restrict__ vals,
                                  const cplx* __restrict__ x, cplx* __restrict__ y, int64_t nsta,
                                  int64_t B, int64_t ldx, int64_t ldy, int D) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= nsta * B) return;
    const int64_t r = i / B;
    const int64_t b = i - r * B;
    y[r * ldy + b] = ell_row<S>(cols, vals, x, ldx, r, b, D);
}

extern "C" int pythtb_ell_matvec(const void* cols, const void* vals, const void* x, void* y,
                                 int64_t norb, int64_t D, int64_t nspin, int64_t B, int64_t ldx,
                                 int64_t ldy, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    const int64_t nsta = norb * nspin;
    if (nsta * B == 0) return 0;
    const unsigned int grid = blocks_for(nsta * B);
    if (nspin == 2)
        ell_matvec_kernel<2><<<grid, kThreads, 0, st>>>((const int*)cols, (const cplx*)vals,
                                                        (const cplx*)x, (cplx*)y, nsta, B, ldx, ldy,
                                                        (int)D);
    else
        ell_matvec_kernel<1><<<grid, kThreads, 0, st>>>((const int*)cols, (const cplx*)vals,
                                                        (const cplx*)x, (cplx*)y, nsta, B, ldx, ldy,
                                                        (int)D);
    return (int)cudaGetLastError();
}
