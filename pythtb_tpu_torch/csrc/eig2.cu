// Kernel 2: closed-form eigenpairs of a batch of 2x2 Hermitian matrices.
//
// Replaces pythtb_tpu/ops/eigh.py:_eig2_analytic, the XLA-fused
// element-wise program that carries every two-band workload (Haldane &c).
// Same formulas and branches: w = mid -+ hypot(delta, |c|); the + state
// is [delta + r, conj(c)] for delta >= 0 and [c, r - delta] otherwise
// (no cancellation); the identity at exact degeneracy (nrm == 0); the
// - state is [-conj(q), conj(p)].  Rows are states, ascending.
//
// What bounds it on the H100: memory traffic, 64 bytes read and 80
// written per matrix, with a few dozen flops between.  Design: one
// thread per matrix, one pass, nothing staged; eager PyTorch would run
// the same formulas as some twenty separate element-wise launches, each
// a full round trip through device memory.
#include "common.cuh"

__global__ void eig2_kernel(const cplx* __restrict__ H, double* __restrict__ w,
                            cplx* __restrict__ v, int64_t B) {
    const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;
    const cplx* h = H + 4 * b;
    const double a = h[0].x;
    const double d = h[3].x;
    const cplx c = h[1];
    const double mid = 0.5 * (a + d);
    const double delta = 0.5 * (a - d);
    const double r = hypot(delta, hypot(c.x, c.y));
    w[2 * b] = mid - r;
    w[2 * b + 1] = mid + r;

    cplx p, q;
    if (delta >= 0.0) {
        p = make_cuDoubleComplex(delta + r, 0.0);
        q = cconj(c);
    } else {
        p = c;
        q = make_cuDoubleComplex(r - delta, 0.0);
    }
    const double nrm = sqrt(p.x * p.x + p.y * p.y + q.x * q.x + q.y * q.y);
    if (nrm == 0.0) {
        p = make_cuDoubleComplex(1.0, 0.0);
        q = make_cuDoubleComplex(0.0, 0.0);
    } else {
        p = make_cuDoubleComplex(p.x / nrm, p.y / nrm);
        q = make_cuDoubleComplex(q.x / nrm, q.y / nrm);
    }
    cplx* o = v + 4 * b;
    o[0] = make_cuDoubleComplex(-q.x, q.y);  // -conj(q)
    o[1] = cconj(p);
    o[2] = p;
    o[3] = q;
}

extern "C" int pythtb_eig2(const void* H, void* w, void* v, int64_t B, void* stream) {
    if (B > 0) {
        eig2_kernel<<<blocks_for(B), kThreads, 0, (cudaStream_t)stream>>>(
            (const cplx*)H, (double*)w, (cplx*)v, B);
    }
    return (int)cudaGetLastError();
}
