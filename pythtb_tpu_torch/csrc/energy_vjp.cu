// Kernel 29: the band-energy gradient gather, the backward of
// flows.energy_fn.
//
// Replaces the reverse pass that jax.grad / jax.vmap build through
// pythtb_tpu/flows.py:energy_fn (:521-553): eigvalsh_batched's
// eigenvalue VJP (U^H diag(g) U per k) and the transposed scatter of
// ops/hamiltonian.py:assemble back onto the hopping amplitudes and the
// on-site matrix.
//
// With U the eigenvectors (rows are states) of H(k) and gbar the
// cotangent of the energies E (P * NK, S), member-major as kernel 1's
// flux-batch mode lays them out, and
//
//   G_k[p, q] = sum_n gbar[k, n] U[k, n, p] conj(U[k, n, q])   (u_n u_n^H),
//
// torch's gradient of a complex leaf (dL/dRe + i dL/dIm) is
//
//   gamps[m, h, s, u] = 2 sum_{k of m} G_k[i_h nspin + s, j_h nspin + u] e^{-2 pi i k.rv_h},
//   gdiag[m, p, q]    = sum_{k of m} G_k[p, q],
//
// the first from the hop's direct entry amp e^{2 pi i k.rv} at (i, j) and
// its Hermitian partner's conjugate at (j, i), the second for the
// Hermitian part of the on-site matrix (the energies are those of it).
//
// What bounds it on the H100: the read of U (16 P NK S^2 bytes) at small
// S; the 8 S operations an entry a k (nout = nhop nspin^2 + S^2 entries)
// from S ~ 8.  Design: a first launch takes a block per (member, chunk
// of k); a thread per output entry walks the chunk's k in order (the
// block's threads read the same rows of U, from L1) and writes its
// partial sum; a second launch, a block per (member, entry), adds the
// chunks' partials (strided sums, then a block tree).  The (P NK, S, S)
// gradient of H never reaches memory, and the sum order is fixed
// (deterministic).
#include "common.cuh"

namespace {

constexpr int kVjpThreads = 256;

__global__ void energy_vjp_partial_kernel(const cplx* __restrict__ U, const double* __restrict__ gbar,
                                          const double* __restrict__ kpts, const double* __restrict__ rv,
                                          const int64_t* __restrict__ ii, const int64_t* __restrict__ jj,
                                          cplx* __restrict__ partial, int64_t NK, int64_t kchunk, int64_t nchunk,
                                          int dim_k, int S, int nspin, int64_t nhop) {
    const int64_t member = blockIdx.y;
    const int64_t chunk = blockIdx.x;
    const int ns2 = nspin * nspin;
    const int64_t nhe = nhop * ns2;
    const int64_t nout = nhe + (int64_t)S * S;
    const int64_t k0 = chunk * kchunk;
    const int64_t k1 = k0 + kchunk < NK ? k0 + kchunk : NK;
    cplx* out = partial + (member * nchunk + chunk) * nout;
    for (int64_t o = threadIdx.x; o < nout; o += blockDim.x) {
        int p, q;
        int64_t h = -1;
        if (o < nhe) {
            h = o / ns2;
            const int blk = (int)(o - h * ns2);
            const int s = blk / nspin, u = blk - s * nspin;
            p = (int)ii[h] * nspin + s;
            q = (int)jj[h] * nspin + u;
        } else {
            const int pq = (int)(o - nhe);
            p = pq / S;
            q = pq - p * S;
        }
        double ar = 0.0, ai = 0.0;
        for (int64_t k = k0; k < k1; ++k) {
            const int64_t row = member * NK + k;
            const cplx* Uk = U + row * S * S;
            const double* g = gbar + row * S;
            double gr = 0.0, gi = 0.0;  // G_k[p, q]
            for (int n = 0; n < S; ++n) {
                const cplx a = Uk[n * S + p], b = Uk[n * S + q];
                gr += g[n] * (a.x * b.x + a.y * b.y);  // a conj(b)
                gi += g[n] * (a.y * b.x - a.x * b.y);
            }
            if (h >= 0) {
                double x = 0.0;
                for (int d = 0; d < dim_k; ++d) x = fma(kpts[k * dim_k + d], rv[h * dim_k + d], x);
                double sn, cs;
                sincospi(2.0 * x, &sn, &cs);  // e^{2 pi i x}; times its conjugate below
                ar += gr * cs + gi * sn;
                ai += gi * cs - gr * sn;
            } else {
                ar += gr;
                ai += gi;
            }
        }
        out[o] = make_cuDoubleComplex(ar, ai);
    }
}

// one block per (member, entry): its threads stride over the chunks'
// partials in order, then a block tree (a fixed order)
__global__ void energy_vjp_reduce_kernel(const cplx* __restrict__ partial, cplx* __restrict__ gamps,
                                         cplx* __restrict__ gdiag, int64_t nchunk, int64_t nhe, int64_t nout) {
    __shared__ double red_r[kVjpThreads], red_i[kVjpThreads];
    const int64_t member = blockIdx.x / nout;
    const int64_t o = blockIdx.x - member * nout;
    double sr = 0.0, si = 0.0;
    for (int64_t c = threadIdx.x; c < nchunk; c += kVjpThreads) {
        const cplx v = partial[(member * nchunk + c) * nout + o];
        sr += v.x;
        si += v.y;
    }
    red_r[threadIdx.x] = sr;
    red_i[threadIdx.x] = si;
    __syncthreads();
    for (int st = kVjpThreads / 2; st > 0; st >>= 1) {
        if (threadIdx.x < st) {
            red_r[threadIdx.x] += red_r[threadIdx.x + st];
            red_i[threadIdx.x] += red_i[threadIdx.x + st];
        }
        __syncthreads();
    }
    if (threadIdx.x != 0) return;
    if (o < nhe) {
        gamps[member * nhe + o] = make_cuDoubleComplex(2.0 * red_r[0], 2.0 * red_i[0]);
    } else {
        gdiag[member * (nout - nhe) + (o - nhe)] = make_cuDoubleComplex(red_r[0], red_i[0]);
    }
}

}  // namespace

// Kernel 29.  U (P * NK, S, S) c128, rows are states; gbar (P * NK, S) f64;
// kpts (NK, dim_k) f64; rv (nhop, dim_k) f64; ii, jj (nhop,) int64;
// partial (P, nchunk, nhop nspin^2 + S^2) c128 scratch; gamps (P, nhop,
// nspin, nspin) c128; gdiag (P, S, S) c128.  Chunks of kchunk k-points,
// nchunk = ceil(NK / kchunk).
extern "C" int pythtb_energy_vjp(const void* U, const void* gbar, const void* kpts, const void* rv, const void* ii,
                                 const void* jj, void* partial, void* gamps, void* gdiag, int64_t P, int64_t NK,
                                 int64_t kchunk, int64_t dim_k, int64_t S, int64_t nspin, int64_t nhop,
                                 void* stream) {
    const int64_t nchunk = (NK + kchunk - 1) / kchunk;
    const int64_t nhe = nhop * nspin * nspin;
    const int64_t nout = nhe + S * S;
    if (P > 0 && NK > 0 && nout > 0) {
        const int64_t want = ((nout + 31) / 32) * 32;
        const int threads = want < kVjpThreads ? (int)want : kVjpThreads;
        energy_vjp_partial_kernel<<<dim3((unsigned int)nchunk, (unsigned int)P), threads, 0,
                                    (cudaStream_t)stream>>>(
            (const cplx*)U, (const double*)gbar, (const double*)kpts, (const double*)rv, (const int64_t*)ii,
            (const int64_t*)jj, (cplx*)partial, NK, kchunk, nchunk, (int)dim_k, (int)S, (int)nspin, nhop);
        energy_vjp_reduce_kernel<<<(unsigned int)(P * nout), kVjpThreads, 0, (cudaStream_t)stream>>>(
            (const cplx*)partial, (cplx*)gamps, (cplx*)gdiag, nchunk, nhe, nout);
    }
    return (int)cudaGetLastError();
}
