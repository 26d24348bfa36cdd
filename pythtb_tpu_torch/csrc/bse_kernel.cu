// Kernel 28: the Bethe-Salpeter pair matrix and the Fock shifts of its
// quasiparticles.
//
// Replaces the kernel contractions of pythtb_tpu/exciton.py:_bse_jit
// (:280-378): the (B, B, S, S) gather Wg = Wtab[idx] of the interaction
// table on the k-difference grid (_diff_index, :232-247), and the einsum
// chains built on it.
//
// Pair mode (:336-355).  Pairs t = (k, c, v) flattened k-major, M = B nc
// nv; row r = (x, c', v'), column s = (y, c, v):
//
//   H[r, s] = -D[r, s] + sx X[r, s] + de[r] delta_rs,
//   D[r, s] = (1/N) sum_ab W_ab(k_x - k_y) conj(ue[x,c',a]) ue[y,c,a]
//                                          conj(uh[y,v,b]) uh[x,v',b]   (direct)
//   X[r, s] = (1/N) sum_ab conj(ue[x,c',a]) uh[x,v',a] WQ[a,b]
//                          conj(uh[y,v,b]) ue[y,c,b]                    (exchange)
//
// with ue, uh the Convention-II electron (k + Q) and hole (k) states,
// Wt[g] = W(g / nk) the periodic table on the grid and WQ = W(Q).
// W(k_x - k_y) is read at the grid index ((g_x - g_y) mod nk), computed
// from the two flat indices (row-major over nk, at most three
// directions).
//
// Fock mode (_hf_shifts, :257-277, its exchange part):
//
//   sig[x, n] = -(1/N) Re sum_{y, ab} W_ab(k_x - k_y) rho[y,a,b] conj(u[x,n,a]) u[x,n,b],
//   rho[y,a,b] = sum_{v occupied} occ[y,v,a] conj(occ[y,v,b])   (the caller's)
//
// in two launches: G[x,a,b] = sum_y Wt[(g_x - g_y) mod nk][a,b] rho[y,a,b]
// (a thread an entry, y in order), then a thread a (x, n) contracts G
// with its state.
//
// What bounds it on the H100: at the rows' S 2 the store of H (16 M^2
// bytes: 13 MB at the 30^2 row, 85 MB at hBN 48^2); the S^2 complex
// multiply-adds of an element come second up to S ~ 4, then lead.
// Design: one thread an element of H, a loop over (a, b) in a fixed
// order (deterministic); neighbouring threads write neighbouring columns
// (coalesced) and read the states and the table (B S^2, in L2) by index.
// No (B, B, S, S) gather reaches memory (340 MB at 48^2, S 2); any S, nc
// and nv that fit memory are taken.
#include "common.cuh"

namespace {

__device__ __forceinline__ cplx cmul(cplx a, cplx b) {
    return make_cuDoubleComplex(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ cplx cadd(cplx a, cplx b) { return make_cuDoubleComplex(a.x + b.x, a.y + b.y); }

// flat index of (g_x - g_y) mod nk on the row-major grid n0 x n1 x n2
__device__ __forceinline__ int64_t diff_index(int64_t x, int64_t y, int64_t n0, int64_t n1, int64_t n2) {
    const int64_t x2 = x % n2, y2 = y % n2;
    x /= n2;
    y /= n2;
    const int64_t x1 = x % n1, y1 = y % n1;
    const int64_t x0 = x / n1, y0 = y / n1;
    const int64_t d0 = (x0 - y0 + n0) % n0;
    const int64_t d1 = (x1 - y1 + n1) % n1;
    const int64_t d2 = (x2 - y2 + n2) % n2;
    return (d0 * n1 + d1) * n2 + d2;
}

__global__ void bse_pair_kernel(const cplx* __restrict__ ue, const cplx* __restrict__ uh,
                                const cplx* __restrict__ wt, const cplx* __restrict__ wq,
                                const double* __restrict__ de, cplx* __restrict__ H, int64_t M, int nc, int nv,
                                int S, int64_t n0, int64_t n1, int64_t n2, double inv_n, double sx) {
    const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= M * M) return;
    const int64_t r = t / M, s = t - r * M;
    const int ncv = nc * nv;
    const int64_t x = r / ncv, y = s / ncv;
    const int rr = (int)(r - x * ncv), ss = (int)(s - y * ncv);
    const int cp = rr / nv, vp = rr - cp * nv;
    const int c = ss / nv, v = ss - c * nv;
    const cplx* uex = ue + (x * nc + cp) * S;
    const cplx* uey = ue + (y * nc + c) * S;
    const cplx* uhx = uh + (x * nv + vp) * S;
    const cplx* uhy = uh + (y * nv + v) * S;
    const cplx* W = wt + diff_index(x, y, n0, n1, n2) * S * S;

    // direct: sum_a conj(uex_a) uey_a sum_b W_ab conj(uhy_b) uhx_b
    cplx D = make_cuDoubleComplex(0.0, 0.0);
    for (int a = 0; a < S; ++a) {
        cplx inner = make_cuDoubleComplex(0.0, 0.0);
        for (int b = 0; b < S; ++b) inner = cadd(inner, cmul(W[a * S + b], cmul_conj(uhy[b], uhx[b])));
        D = cadd(D, cmul(cmul_conj(uex[a], uey[a]), inner));
    }
    double hr = -D.x * inv_n, hi = -D.y * inv_n;
    if (sx != 0.0) {
        // exchange: sum_a conj(uex_a) uhx_a sum_b WQ_ab conj(uhy_b) uey_b
        cplx X = make_cuDoubleComplex(0.0, 0.0);
        for (int a = 0; a < S; ++a) {
            cplx inner = make_cuDoubleComplex(0.0, 0.0);
            for (int b = 0; b < S; ++b) inner = cadd(inner, cmul(wq[a * S + b], cmul_conj(uhy[b], uey[b])));
            X = cadd(X, cmul(cmul_conj(uex[a], uhx[a]), inner));
        }
        hr += sx * X.x * inv_n;
        hi += sx * X.y * inv_n;
    }
    if (r == s) hr += de[r];
    H[t] = make_cuDoubleComplex(hr, hi);
}

// G[x, a, b] = sum_y Wt[(g_x - g_y) mod nk][a, b] rho[y, a, b], a thread an
// entry; y walks the grid in row-major order, its difference index kept
// by a subtraction a direction (no division in the loop)
__global__ void bse_fock_conv_kernel(const cplx* __restrict__ wt, const cplx* __restrict__ rho,
                                     cplx* __restrict__ G, int64_t B, int S, int64_t n0, int64_t n1, int64_t n2) {
    const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    const int64_t SS = (int64_t)S * S;
    if (t >= B * SS) return;
    const int64_t x = t / SS;
    const int64_t ab = t - x * SS;
    const int64_t x2 = x % n2, x1 = (x / n2) % n1, x0 = x / (n1 * n2);
    const cplx* r = rho + ab;
    double gr = 0.0, gi = 0.0;
    for (int64_t y0 = 0; y0 < n0; ++y0) {
        const int64_t d0 = x0 >= y0 ? x0 - y0 : x0 - y0 + n0;
        for (int64_t y1 = 0; y1 < n1; ++y1) {
            const int64_t d1 = x1 >= y1 ? x1 - y1 : x1 - y1 + n1;
            const cplx* w = wt + (d0 * n1 + d1) * n2 * SS + ab;
#pragma unroll 4
            for (int64_t y2 = 0; y2 < n2; ++y2) {
                const int64_t d2 = x2 >= y2 ? x2 - y2 : x2 - y2 + n2;
                const cplx wv = w[d2 * SS];
                const cplx p = *r;
                r += SS;
                gr += wv.x * p.x - wv.y * p.y;
                gi += wv.x * p.y + wv.y * p.x;
            }
        }
    }
    G[t] = make_cuDoubleComplex(gr, gi);
}

// sig[x, n] = -(1/N) Re sum_ab G[x,a,b] conj(u[x,n,a]) u[x,n,b], a thread a (x, n)
__global__ void bse_fock_contract_kernel(const cplx* __restrict__ G, const cplx* __restrict__ u,
                                         double* __restrict__ sig, int64_t B, int nb, int S, double inv_n) {
    const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= B * nb) return;
    const int64_t x = t / nb;
    const cplx* g = G + x * S * S;
    const cplx* un = u + t * S;
    double acc = 0.0;
    for (int a = 0; a < S; ++a) {
        double inner_r = 0.0, inner_i = 0.0;  // sum_b G_ab u_b
        for (int b = 0; b < S; ++b) {
            const cplx w = g[a * S + b];
            inner_r += w.x * un[b].x - w.y * un[b].y;
            inner_i += w.x * un[b].y + w.y * un[b].x;
        }
        acc += un[a].x * inner_r + un[a].y * inner_i;  // Re(conj(u_a) inner)
    }
    sig[t] = -acc * inv_n;
}

}  // namespace

// Pair mode.  ue (B, nc, S), uh (B, nv, S), wt (B, S, S), wq (S, S) c128;
// de (M,) f64; H (M, M) c128, M = B nc nv; n0 n1 n2 the grid (1 for a
// missing direction); sx the exchange factor.
extern "C" int pythtb_bse_pair(const void* ue, const void* uh, const void* wt, const void* wq, const void* de,
                               void* H, int64_t B, int64_t nc, int64_t nv, int64_t S, int64_t n0, int64_t n1,
                               int64_t n2, double sx, void* stream) {
    const int64_t M = B * nc * nv;
    if (M > 0) {
        bse_pair_kernel<<<blocks_for(M * M), kThreads, 0, (cudaStream_t)stream>>>(
            (const cplx*)ue, (const cplx*)uh, (const cplx*)wt, (const cplx*)wq, (const double*)de, (cplx*)H, M,
            (int)nc, (int)nv, (int)S, n0, n1, n2, 1.0 / (double)B, sx);
    }
    return (int)cudaGetLastError();
}

// Fock mode.  wt (B, S, S), rho (B, S, S), u (B, nb, S) c128; G (B, S, S)
// c128 scratch; sig (B, nb) f64.
extern "C" int pythtb_bse_fock(const void* wt, const void* rho, const void* u, void* G, void* sig, int64_t B,
                               int64_t nb, int64_t S, int64_t n0, int64_t n1, int64_t n2, void* stream) {
    if (B > 0 && S > 0) {
        bse_fock_conv_kernel<<<blocks_for(B * S * S), kThreads, 0, (cudaStream_t)stream>>>(
            (const cplx*)wt, (const cplx*)rho, (cplx*)G, B, (int)S, n0, n1, n2);
        if (nb > 0) {
            bse_fock_contract_kernel<<<blocks_for(B * nb), kThreads, 0, (cudaStream_t)stream>>>(
                (const cplx*)G, (const cplx*)u, (double*)sig, B, (int)nb, (int)S, 1.0 / (double)B);
        }
    }
    return (int)cudaGetLastError();
}
