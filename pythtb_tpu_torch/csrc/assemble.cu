// Kernel 1: batched Bloch-Hamiltonian assembly.
//
// Replaces pythtb_tpu/ops/hamiltonian.py:assemble with _phases (the XLA
// program) and the deleted Pallas kernel ops/pallas_assemble.py:_kernel /
// assemble_pallas_nspin1 (git show 9a07da8^), which fused the k.rv
// product, cos/sin and the pattern matmuls so that the (B, nhop) phase
// array never reached memory.
//
//   H[b, p, q] = diag[p, q] + sum over hoppings h landing on (p, q) of
//                amp_h e^{2 pi i k_b.rv_h}           (direct, (i_h, j_h))
//                conj(amp_h e^{2 pi i k_b.rv_h})     (partner, (j_h, i_h))
// At nspin 2, p = 2a+s, q = 2c+u and the amplitude is the 2x2 block
// entry amp_h[s, u] for a direct hit and conj(amp_h[u, s]) for a partner
// hit (the spin-block rule of hamiltonian.py:105-111).
//
// Kernel 15, the derivative modes (pythtb_tpu/ops/hamiltonian.py:
// assemble_dk / assemble_d2k, the scatters of :146-165 and :199-213):
// the same gather walk, each term times (2 pi i rv_a) for dH/dk_a or
// -(2 pi)^2 rv_a rv_b for d2H/dk_a dk_b; a partner entry carries the
// conjugate of the direct value, conj(v (2 pi i rv_a)) =
// conj(v) (-2 pi i rv_a) -- the factor is not negated a second time --
// and no diagonal is added.  One thread per output element (b, p, q)
// computes each phase once, in registers, and accumulates all dim_k
// (or the dim_k (dim_k + 1) / 2 distinct (a <= b)) derivatives before
// it stores them, so one walk of the gather list serves every
// direction; d2H is written to (a, b) and (b, a).  Bound on the H100:
// the store of dim_k (or dim_k^2) complex values per element.
//
// One-sided mode (pythtb_tpu/surface.py:_one_sided, the inter-layer block
// H01 of a principal-layer chain): the direct terms only -- partner
// entries of the gather list are skipped and no diagonal is added -- so
// H[b, p, q] = sum over hoppings h with (i_h, j_h) landing on (p, q) of
// amp_h e^{2 pi i k_b.rv_h}, not Hermitian.
//
// Flux-batch mode (pythtb_tpu/magnetic.py:hofstadter_fn, whose vmap over
// the flux index runs one assemble per flux: magnetic.py:241): one graph
// (rv, ptr, ent shared) and P members of it, each with its own amplitudes
// amps[p] (P, nhop[, 2, 2]) and on-site matrix diag[p] (P, nsta, nsta),
// at NK shared k-points; H is (P * NK, nsta, nsta), member-major, from one
// launch.  Row b of H is member b / NK at k-point b mod NK; the walk is
// the plain mode's.
//
// Floquet-block mode (pythtb_tpu/floquet.py:_spectrum_jit with
// _assemble_hm, :218-296): the truncated extended-zone matrix K (B, NM S,
// NM S), NM = 2 M + 1, written directly.  Block (p, q) is H_{p-q} with
//   H_m[i, j] = sum over hoppings of amp e^{2 pi i k.rv} fac[m] (direct)
//               + conj(amp e^{2 pi i k.rv}) conj(fac[-m]) (partner)
//               + delta_{m0} diag + delta_{ij} ons[m]
// (fac (4M + 1, nhop) and ons (4M + 1, nsta) complex, m = -2M..2M; the
// partner's factor is the conjugate of the opposite harmonic's), plus
// (p - M) omega on the diagonal of the blocks p = q.  At nspin 2 the spin
// block shares the hop's scalar factor.  One thread per element of K walks
// its orbital pair's gather list, as the plain mode does; bound: the store
// of K, 16 bytes an element.
//
// What bounds it on the H100: the store of H, 16 bytes per element, and
// for models with many hoppings per element the double-precision sincospi
// per (k, hopping, element).  Design: one thread per output element walks
// the CSR gather list that core.finalize built for its orbital pair, so
// there are no atomics, the sum order is fixed (deterministic), the
// phases live only in registers, and neighbouring threads store
// neighbouring elements (coalesced).  Each phase is computed by the two
// elements it lands on (times 4 at nspin 2); the one-hot pattern matmul
// of the TPU version is not carried over.
#include "common.cuh"

// nk: k-points per member (every row when there is one member); a row's
// member reads its amplitudes at member * nhop * nspin^2 and its diagonal
// at member * nsta^2.
__global__ void assemble_kernel(const double* __restrict__ k, const double* __restrict__ rv,
                                const cplx* __restrict__ amps, const cplx* __restrict__ diag,
                                const int* __restrict__ ptr, const int* __restrict__ ent,
                                cplx* __restrict__ H, int64_t total, int64_t nk, int dim_k, int norb,
                                int nspin, int64_t nhop, bool one_sided) {
    const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= total) return;
    const int nsta = norb * nspin;
    const int64_t per_k = (int64_t)nsta * nsta;
    const int64_t b = t / per_k;
    const int elem = (int)(t - b * per_k);
    const int p = elem / nsta;
    const int q = elem - p * nsta;
    const int a = p / nspin, s = p - a * nspin;
    const int c = q / nspin, u = q - c * nspin;
    const int64_t member = b / nk;
    const double* kb = k + (b - member * nk) * dim_k;
    amps += member * nhop * nspin * nspin;
    diag += member * per_k;
    const int slot = a * norb + c;
    const int direct_blk = s * nspin + u;
    const int partner_blk = u * nspin + s;

    double re = 0.0, im = 0.0;
    for (int e = ptr[slot]; e < ptr[slot + 1]; ++e) {
        const int code = ent[e];
        const int h = code >> 1;
        const bool partner = (code & 1) != 0;
        if (one_sided && partner) continue;
        double x = 0.0;
        for (int d = 0; d < dim_k; ++d) x = fma(kb[d], rv[(int64_t)h * dim_k + d], x);
        double sn, cs;
        sincospi(2.0 * x, &sn, &cs);  // e^{2 pi i x}
        const cplx A = amps[(int64_t)h * nspin * nspin + (partner ? partner_blk : direct_blk)];
        const double vr = A.x * cs - A.y * sn;
        const double vi = A.x * sn + A.y * cs;
        re += vr;
        im += partner ? -vi : vi;
    }
    if (one_sided) {
        H[t] = make_cuDoubleComplex(re, im);
        return;
    }
    const cplx dg = diag[elem];
    H[t] = make_cuDoubleComplex(re + dg.x, im + dg.y);
}

__global__ void assemble_floquet_kernel(const double* __restrict__ k, const double* __restrict__ rv,
                                        const cplx* __restrict__ amps, const cplx* __restrict__ diag,
                                        const cplx* __restrict__ fac, const cplx* __restrict__ ons,
                                        const int* __restrict__ ptr, const int* __restrict__ ent,
                                        cplx* __restrict__ K, int64_t total, int dim_k, int norb, int nspin,
                                        int64_t nhop, int M, double omega) {
    const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= total) return;
    const int nsta = norb * nspin;
    const int NM = 2 * M + 1;
    const int64_t dimK = (int64_t)NM * nsta;
    const int64_t per_k = dimK * dimK;
    const int64_t b = t / per_k;
    const int64_t e2 = t - b * per_k;
    const int P = (int)(e2 / dimK);
    const int Q = (int)(e2 - (int64_t)P * dimK);
    const int pb = P / nsta, p = P - pb * nsta;
    const int qb = Q / nsta, q = Q - qb * nsta;
    const int mi = pb - qb + 2 * M;   // harmonic index of block (pb, qb), m = pb - qb
    const int mp = 4 * M - mi;        // its partner's: -m
    const int a = p / nspin, s = p - a * nspin;
    const int c = q / nspin, u = q - c * nspin;
    const double* kb = k + b * dim_k;
    const int slot = a * norb + c;
    const int direct_blk = s * nspin + u;
    const int partner_blk = u * nspin + s;
    double re = 0.0, im = 0.0;
    for (int e = ptr[slot]; e < ptr[slot + 1]; ++e) {
        const int code = ent[e];
        const int h = code >> 1;
        const bool partner = (code & 1) != 0;
        double x = 0.0;
        for (int d = 0; d < dim_k; ++d) x = fma(kb[d], rv[(int64_t)h * dim_k + d], x);
        double sn, cs;
        sincospi(2.0 * x, &sn, &cs);  // e^{2 pi i x}
        const cplx A = amps[(int64_t)h * nspin * nspin + (partner ? partner_blk : direct_blk)];
        double vr = A.x * cs - A.y * sn;
        double vi = A.x * sn + A.y * cs;
        cplx f;
        if (partner) {
            vi = -vi;  // conj(amp e^{2 pi i k.rv})
            const cplx g = fac[(int64_t)mp * nhop + h];
            f = make_cuDoubleComplex(g.x, -g.y);
        } else {
            f = fac[(int64_t)mi * nhop + h];
        }
        re += vr * f.x - vi * f.y;
        im += vr * f.y + vi * f.x;
    }
    if (mi == 2 * M) {
        const cplx dg = diag[p * nsta + q];
        re += dg.x;
        im += dg.y;
    }
    if (p == q) {
        const cplx o = ons[(int64_t)mi * nsta + p];
        re += o.x;
        im += o.y;
        if (pb == qb) re += (double)(pb - M) * omega;
    }
    K[t] = make_cuDoubleComplex(re, im);
}

template <int ORDER>
__global__ void assemble_deriv_kernel(const double* __restrict__ k, const double* __restrict__ rv,
                                      const cplx* __restrict__ amps, const int* __restrict__ ptr,
                                      const int* __restrict__ ent, cplx* __restrict__ out,
                                      int64_t total, int dim_k, int norb, int nspin) {
    const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= total) return;
    const int nsta = norb * nspin;
    const int64_t per_k = (int64_t)nsta * nsta;
    const int64_t bk = t / per_k;
    const int elem = (int)(t - bk * per_k);
    const int p = elem / nsta;
    const int q = elem - p * nsta;
    const int a = p / nspin, s = p - a * nspin;
    const int c = q / nspin, u = q - c * nspin;
    const double* kb = k + bk * dim_k;
    const int slot = a * norb + c;
    const int direct_blk = s * nspin + u;
    const int partner_blk = u * nspin + s;
    const double two_pi = 6.283185307179586476925286766559;

    // order 1: slot d is dH/dk_d; order 2: the pairs (0,0) (0,1) (0,2)
    // (1,1) (1,2) (2,2) in that order
    double re[6] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
    double im[6] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
    for (int e = ptr[slot]; e < ptr[slot + 1]; ++e) {
        const int code = ent[e];
        const int h = code >> 1;
        const bool partner = (code & 1) != 0;
        const double* r = rv + (int64_t)h * dim_k;
        double x = 0.0;
        for (int d = 0; d < dim_k; ++d) x = fma(kb[d], r[d], x);
        double sn, cs;
        sincospi(2.0 * x, &sn, &cs);  // e^{2 pi i x}
        const cplx A = amps[(int64_t)h * nspin * nspin + (partner ? partner_blk : direct_blk)];
        const double vr = A.x * cs - A.y * sn;
        const double vi = partner ? -(A.x * sn + A.y * cs) : A.x * sn + A.y * cs;
        if (ORDER == 1) {
            // direct: v (i f); partner: conj(v) (-i f)
            const double sg = partner ? -two_pi : two_pi;
#pragma unroll
            for (int d = 0; d < 3; ++d) {
                if (d < dim_k) {
                    const double f = sg * r[d];
                    re[d] -= vi * f;
                    im[d] += vr * f;
                }
            }
        } else {
            int slot2 = 0;
#pragma unroll
            for (int d0 = 0; d0 < 3; ++d0) {
#pragma unroll
                for (int d1 = d0; d1 < 3; ++d1) {
                    if (d1 < dim_k) {
                        const double f = -(two_pi * two_pi) * r[d0] * r[d1];
                        re[slot2] += vr * f;
                        im[slot2] += vi * f;
                    }
                    ++slot2;
                }
            }
        }
    }
    if (ORDER == 1) {
#pragma unroll
        for (int d = 0; d < 3; ++d)
            if (d < dim_k) out[(bk * dim_k + d) * per_k + elem] = make_cuDoubleComplex(re[d], im[d]);
    } else {
        int slot2 = 0;
#pragma unroll
        for (int d0 = 0; d0 < 3; ++d0) {
#pragma unroll
            for (int d1 = d0; d1 < 3; ++d1) {
                if (d1 < dim_k) {
                    const cplx v = make_cuDoubleComplex(re[slot2], im[slot2]);
                    out[((bk * dim_k + d0) * dim_k + d1) * per_k + elem] = v;
                    out[((bk * dim_k + d1) * dim_k + d0) * per_k + elem] = v;
                }
                ++slot2;
            }
        }
    }
}

// Kernel 15: dH/dk (order 1, out (B, dim_k, nsta, nsta)) or d2H/dk dk
// (order 2, out (B, dim_k, dim_k, nsta, nsta)); 1 <= dim_k <= 3.
extern "C" int pythtb_assemble_deriv(const void* k, const void* rv, const void* amps, const void* ptr,
                                     const void* ent, void* out, int64_t B, int64_t dim_k, int64_t norb,
                                     int64_t nspin, int64_t order, void* stream) {
    const int64_t nsta = norb * nspin;
    const int64_t total = B * nsta * nsta;
    if (total > 0) {
        if (order == 1) {
            assemble_deriv_kernel<1><<<blocks_for(total), kThreads, 0, (cudaStream_t)stream>>>(
                (const double*)k, (const double*)rv, (const cplx*)amps, (const int*)ptr, (const int*)ent,
                (cplx*)out, total, (int)dim_k, (int)norb, (int)nspin);
        } else {
            assemble_deriv_kernel<2><<<blocks_for(total), kThreads, 0, (cudaStream_t)stream>>>(
                (const double*)k, (const double*)rv, (const cplx*)amps, (const int*)ptr, (const int*)ent,
                (cplx*)out, total, (int)dim_k, (int)norb, (int)nspin);
        }
    }
    return (int)cudaGetLastError();
}

extern "C" int pythtb_assemble(const void* k, const void* rv, const void* amps, const void* diag,
                               const void* ptr, const void* ent, void* H, int64_t B,
                               int64_t dim_k, int64_t norb, int64_t nspin, int64_t one_sided,
                               void* stream) {
    const int64_t nsta = norb * nspin;
    const int64_t total = B * nsta * nsta;
    if (total > 0) {
        assemble_kernel<<<blocks_for(total), kThreads, 0, (cudaStream_t)stream>>>(
            (const double*)k, (const double*)rv, (const cplx*)amps, (const cplx*)diag,
            (const int*)ptr, (const int*)ent, (cplx*)H, total, B, (int)dim_k, (int)norb,
            (int)nspin, 0, one_sided != 0);
    }
    return (int)cudaGetLastError();
}

// Flux-batch mode: amps (P, nhop[, 2, 2]), diag (P, nsta, nsta), k (NK,
// dim_k) -> H (P * NK, nsta, nsta).
extern "C" int pythtb_assemble_members(const void* k, const void* rv, const void* amps, const void* diag,
                                       const void* ptr, const void* ent, void* H, int64_t P, int64_t NK,
                                       int64_t dim_k, int64_t norb, int64_t nspin, int64_t nhop,
                                       void* stream) {
    const int64_t nsta = norb * nspin;
    const int64_t total = P * NK * nsta * nsta;
    if (total > 0) {
        assemble_kernel<<<blocks_for(total), kThreads, 0, (cudaStream_t)stream>>>(
            (const double*)k, (const double*)rv, (const cplx*)amps, (const cplx*)diag,
            (const int*)ptr, (const int*)ent, (cplx*)H, total, NK, (int)dim_k, (int)norb,
            (int)nspin, nhop, false);
    }
    return (int)cudaGetLastError();
}

// Floquet-block mode: k (B, dim_k), fac (4M + 1, nhop), ons (4M + 1,
// nsta) -> K (B, (2M + 1) nsta, (2M + 1) nsta).
extern "C" int pythtb_assemble_floquet(const void* k, const void* rv, const void* amps, const void* diag,
                                       const void* fac, const void* ons, const void* ptr, const void* ent, void* K,
                                       int64_t B, int64_t dim_k, int64_t norb, int64_t nspin, int64_t nhop,
                                       int64_t M, double omega, void* stream) {
    const int64_t dimK = (2 * M + 1) * norb * nspin;
    const int64_t total = B * dimK * dimK;
    if (total > 0) {
        assemble_floquet_kernel<<<blocks_for(total), kThreads, 0, (cudaStream_t)stream>>>(
            (const double*)k, (const double*)rv, (const cplx*)amps, (const cplx*)diag, (const cplx*)fac,
            (const cplx*)ons, (const int*)ptr, (const int*)ent, (cplx*)K, total, (int)dim_k, (int)norb,
            (int)nspin, nhop, (int)M, omega);
    }
    return (int)cudaGetLastError();
}
