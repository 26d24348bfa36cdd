// Kernel 24: the Rudner winding stencil.
//
// Replaces pythtb_tpu/floquet.py:_winding_jit (:592-681), the degree of
// the periodized evolution map (Rudner, Lindner, Berg & Levin, PRX 3,
// 031005 (2013), Eq. (10)) for a batch of G gap energies:
//
//   pass 1:  U_e[g, t, b] = U(t, b) P_b diag(e^{i eps[g, b, n] t dtau}) P_b^H,
//            t = 0 .. nt - 1 (the duplicated t = T slice is dropped), from
//            the history U (nt + 1, B, S, S) of kernel 22's full mode, the
//            eigenvectors P (B, S, S) of U(T) as COLUMNS (unitary_eig) and
//            the branched quasienergies eps (G, B, S);
//   pass 2:  at each (g, t, i, j) of the (nt, n0, n1) grid, periodic central
//            differences dU_t, dU_1, dU_2 (a k-wrap conjugated by the
//            embedding, U(k + G) = D U(k) D^H, D_su = p_s conj(p_u)),
//            A_mu = U_e^H dU_mu and Re tr A_t (A_1 A_2 - A_2 A_1);
//   pass 3:  per g, the fixed-order sum over the grid (a block tree); the
//            caller scales it by -(T / nt)(1 / n0)(1 / n1) / 8 pi^2.
//
// Mapping.  Pass 2 at S <= 4: one thread per grid point, matrices in
// registers (templated on S); 5 <= S <= 16: one block per point, a thread
// per matrix element, the eight S x S matrices in shared memory (32 kB at
// S 16).  Above 16 the wrapper raises.  Bound on the H100: reading the
// history (16 (nt + 1) B S^2 bytes) and writing and reading U_e (2 x 16 G
// nt B S^2) once each.
#include "common.cuh"

namespace {

__device__ __forceinline__ cplx cfma(cplx a, cplx b, cplx c) {  // a * b + c
    return make_cuDoubleComplex(fma(a.x, b.x, fma(-a.y, b.y, c.x)), fma(a.x, b.y, fma(a.y, b.x, c.y)));
}

__device__ __forceinline__ cplx csubc(cplx a, cplx b) { return make_cuDoubleComplex(a.x - b.x, a.y - b.y); }

__device__ __forceinline__ cplx cdiv(cplx a, double s) { return make_cuDoubleComplex(a.x / s, a.y / s); }

// element (s, u) of D (conj: conj(D)) = p_s conj(p_u)
__device__ __forceinline__ cplx embed(const cplx* p, int s, int u, bool conj) {
    const cplx v = cuCmul(p[s], cconj(p[u]));
    return conj ? cconj(v) : v;
}

// pass 1: one thread per element (g, t, b, s, u) of U_e
__global__ void periodize_kernel(const cplx* __restrict__ hist, const cplx* __restrict__ P,
                                 const double* __restrict__ eps, cplx* __restrict__ Ue, int64_t total, int64_t nt,
                                 int64_t B, int S, double dtau) {
    const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= total) return;
    const int SS = S * S;
    const int el = (int)(e % SS);
    const int64_t gtb = e / SS;
    const int64_t b = gtb % B;
    const int64_t gt = gtb / B;
    const int64_t t = gt % nt;
    const int64_t g = gt / nt;
    const int s = el / S, u = el - s * S;
    const double ts = (double)t * dtau;
    const cplx* Pb = P + b * SS;
    const double* eb = eps + (g * B + b) * S;
    const cplx* H = hist + (t * B + b) * SS;
    cplx acc = make_cuDoubleComplex(0.0, 0.0);
    for (int v = 0; v < S; ++v) {
        cplx x = make_cuDoubleComplex(0.0, 0.0);  // exp(+i t H_eff)[v, u]
        for (int n = 0; n < S; ++n) {
            double sn, cs;
            sincos(ts * eb[n], &sn, &cs);
            x = cfma(cuCmul(Pb[v * S + n], make_cuDoubleComplex(cs, sn)), cconj(Pb[u * S + n]), x);
        }
        acc = cfma(H[s * S + v], x, acc);
    }
    Ue[e] = acc;
}

struct Grid {
    int64_t nt, n0, n1;
    double den_t, den_0, den_1;  // 2 dt, 2 h_0, 2 h_1 of the central differences
};

// the six neighbours of point (t, i, j) (t +- 1, k1 +- 1, k2 +- 1) and whether a k-neighbour wraps
__device__ __forceinline__ void neighbours(const Grid& gr, int64_t t, int64_t i, int64_t j, int64_t pts[6],
                                           bool wrap[4]) {
    const int64_t tp = (t + 1) % gr.nt, tm = (t + gr.nt - 1) % gr.nt;
    const int64_t ip = (i + 1) % gr.n0, im = (i + gr.n0 - 1) % gr.n0;
    const int64_t jp = (j + 1) % gr.n1, jm = (j + gr.n1 - 1) % gr.n1;
    pts[0] = (tp * gr.n0 + i) * gr.n1 + j;
    pts[1] = (tm * gr.n0 + i) * gr.n1 + j;
    pts[2] = (t * gr.n0 + ip) * gr.n1 + j;
    pts[3] = (t * gr.n0 + im) * gr.n1 + j;
    pts[4] = (t * gr.n0 + i) * gr.n1 + jp;
    pts[5] = (t * gr.n0 + i) * gr.n1 + jm;
    wrap[0] = i == gr.n0 - 1;
    wrap[1] = i == 0;
    wrap[2] = j == gr.n1 - 1;
    wrap[3] = j == 0;
}

// dU[s, u] along one axis from the up / down neighbours
__device__ __forceinline__ cplx diff_elem(const cplx* up, const cplx* dn, const cplx* p, bool wup, bool wdn, int s,
                                          int u, int S, double den) {
    cplx a = up[s * S + u], b = dn[s * S + u];
    if (wup) a = cuCmul(a, embed(p, s, u, false));
    if (wdn) b = cuCmul(b, embed(p, s, u, true));
    return cdiv(csubc(a, b), den);
}

// pass 2 at S <= 4: one thread per grid point
template <int S>
__global__ void stencil_reg_kernel(const cplx* __restrict__ Ue, const cplx* __restrict__ p0,
                                   const cplx* __restrict__ p1, double* __restrict__ vals, int64_t npts, Grid gr) {
    const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= npts) return;
    const int64_t g = blockIdx.y;
    const int64_t pt = e;
    const int64_t j = pt % gr.n1, i = (pt / gr.n1) % gr.n0, t = pt / (gr.n0 * gr.n1);
    constexpr int SS = S * S;
    const cplx* base = Ue + g * npts * SS;
    int64_t nb[6];
    bool wrap[4];
    neighbours(gr, t, i, j, nb, wrap);
    const cplx* U = base + pt * SS;
    cplx At[S][S], A1[S][S], A2[S][S];
    // A_mu = U^H dU_mu, column u at a time
#pragma unroll
    for (int u = 0; u < S; ++u) {
        cplx dt_[S], d1[S], d2[S];
#pragma unroll
        for (int r = 0; r < S; ++r) {
            dt_[r] = cdiv(csubc(base[nb[0] * SS + r * S + u], base[nb[1] * SS + r * S + u]), gr.den_t);
            d1[r] = diff_elem(base + nb[2] * SS, base + nb[3] * SS, p0, wrap[0], wrap[1], r, u, S, gr.den_0);
            d2[r] = diff_elem(base + nb[4] * SS, base + nb[5] * SS, p1, wrap[2], wrap[3], r, u, S, gr.den_1);
        }
#pragma unroll
        for (int s = 0; s < S; ++s) {
            cplx a = make_cuDoubleComplex(0.0, 0.0), b = a, c = a;
#pragma unroll
            for (int r = 0; r < S; ++r) {
                const cplx ur = cconj(U[r * S + s]);
                a = cfma(ur, dt_[r], a);
                b = cfma(ur, d1[r], b);
                c = cfma(ur, d2[r], c);
            }
            At[s][u] = a;
            A1[s][u] = b;
            A2[s][u] = c;
        }
    }
    double tr = 0.0;
#pragma unroll
    for (int s = 0; s < S; ++s)
#pragma unroll
        for (int u = 0; u < S; ++u) {
            cplx x = make_cuDoubleComplex(0.0, 0.0), y = x;  // (A1 A2)[u, s], (A2 A1)[u, s]
#pragma unroll
            for (int r = 0; r < S; ++r) {
                x = cfma(A1[u][r], A2[r][s], x);
                y = cfma(A2[u][r], A1[r][s], y);
            }
            const cplx cm = csubc(x, y);
            tr += At[s][u].x * cm.x - At[s][u].y * cm.y;
        }
    vals[g * npts + pt] = tr;
}

// pass 2 at 5 <= S <= 16: one block per grid point, a thread per element
__global__ void stencil_block_kernel(const cplx* __restrict__ Ue, const cplx* __restrict__ p0,
                                     const cplx* __restrict__ p1, double* __restrict__ vals, int64_t npts, int S,
                                     Grid gr) {
    __shared__ cplx sm[8][256];
    __shared__ double red[kThreads];
    cplx *U = sm[0], *Dt = sm[1], *D1 = sm[2], *D2 = sm[3], *At = sm[4], *A1 = sm[5], *A2 = sm[6], *C = sm[7];
    const int64_t pt = blockIdx.x;
    const int64_t g = blockIdx.y;
    const int64_t j = pt % gr.n1, i = (pt / gr.n1) % gr.n0, t = pt / (gr.n0 * gr.n1);
    const int SS = S * S;
    const cplx* base = Ue + g * npts * SS;
    int64_t nb[6];
    bool wrap[4];
    neighbours(gr, t, i, j, nb, wrap);
    const int e = threadIdx.x;
    const int s = e / S, u = e - (e / S) * S;
    if (e < SS) {
        U[e] = base[pt * SS + e];
        Dt[e] = cdiv(csubc(base[nb[0] * SS + e], base[nb[1] * SS + e]), gr.den_t);
        D1[e] = diff_elem(base + nb[2] * SS, base + nb[3] * SS, p0, wrap[0], wrap[1], s, u, S, gr.den_0);
        D2[e] = diff_elem(base + nb[4] * SS, base + nb[5] * SS, p1, wrap[2], wrap[3], s, u, S, gr.den_1);
    }
    __syncthreads();
    if (e < SS) {
        cplx a = make_cuDoubleComplex(0.0, 0.0), b = a, c = a;
        for (int r = 0; r < S; ++r) {
            const cplx ur = cconj(U[r * S + s]);
            a = cfma(ur, Dt[r * S + u], a);
            b = cfma(ur, D1[r * S + u], b);
            c = cfma(ur, D2[r * S + u], c);
        }
        At[e] = a;
        A1[e] = b;
        A2[e] = c;
    }
    __syncthreads();
    if (e < SS) {
        cplx x = make_cuDoubleComplex(0.0, 0.0), y = x;
        for (int r = 0; r < S; ++r) {
            x = cfma(A1[s * S + r], A2[r * S + u], x);
            y = cfma(A2[s * S + r], A1[r * S + u], y);
        }
        C[e] = csubc(x, y);
    }
    __syncthreads();
    double v = 0.0;
    if (e < SS) {  // Re A_t[s, u] C[u, s]
        const cplx a = At[e], c = C[u * S + s];
        v = a.x * c.x - a.y * c.y;
    }
    red[threadIdx.x] = v;
    for (int half = blockDim.x / 2; half > 0; half >>= 1) {
        __syncthreads();
        if ((int)threadIdx.x < half) red[threadIdx.x] += red[threadIdx.x + half];
    }
    if (threadIdx.x == 0) vals[g * npts + pt] = red[0];
}

// pass 3: one block per gap energy
__global__ void sum_points_kernel(const double* __restrict__ vals, double* __restrict__ out, int64_t npts) {
    __shared__ double red[kThreads];
    const int64_t g = blockIdx.x;
    double acc = 0.0;
    for (int64_t p = threadIdx.x; p < npts; p += blockDim.x) acc += vals[g * npts + p];
    red[threadIdx.x] = acc;
    for (int half = blockDim.x / 2; half > 0; half >>= 1) {
        __syncthreads();
        if ((int)threadIdx.x < half) red[threadIdx.x] += red[threadIdx.x + half];
    }
    if (threadIdx.x == 0) out[g] = red[0];
}

template <int S>
void launch_reg(const cplx* Ue, const cplx* p0, const cplx* p1, double* vals, int64_t npts, int G, Grid gr,
                cudaStream_t st) {
    dim3 grid(blocks_for(npts), (unsigned)G);
    stencil_reg_kernel<S><<<grid, kThreads, 0, st>>>(Ue, p0, p1, vals, npts, gr);
}

}  // namespace

// hist (nt + 1, B, S, S), P (B, S, S) columns, eps (G, B, S), p0, p1 (S,);
// scratch Ue (G, nt, B, S, S) and vals (G, nt * B); out (G,) the unscaled
// sums.  B = n0 n1, S <= 16.
extern "C" int pythtb_winding(const void* hist, const void* P, const void* eps, const void* p0, const void* p1,
                              void* Ue, void* vals, void* out, int64_t G, int64_t nt, int64_t n0, int64_t n1,
                              int64_t S, double T, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    const int64_t B = n0 * n1;
    const int64_t npts = nt * B;
    const int64_t total = G * npts * S * S;
    if (total <= 0) return (int)cudaGetLastError();
    periodize_kernel<<<blocks_for(total), kThreads, 0, st>>>((const cplx*)hist, (const cplx*)P, (const double*)eps,
                                                             (cplx*)Ue, total, nt, B, (int)S, T / (double)nt);
    Grid gr;
    gr.nt = nt;
    gr.n0 = n0;
    gr.n1 = n1;
    gr.den_t = 2.0 * T / (double)nt;
    gr.den_0 = 2.0 * (1.0 / (double)n0);
    gr.den_1 = 2.0 * (1.0 / (double)n1);
    const cplx* U_ = (const cplx*)Ue;
    const cplx* a = (const cplx*)p0;
    const cplx* b = (const cplx*)p1;
    double* v = (double*)vals;
    switch (S) {
        case 1: launch_reg<1>(U_, a, b, v, npts, (int)G, gr, st); break;
        case 2: launch_reg<2>(U_, a, b, v, npts, (int)G, gr, st); break;
        case 3: launch_reg<3>(U_, a, b, v, npts, (int)G, gr, st); break;
        case 4: launch_reg<4>(U_, a, b, v, npts, (int)G, gr, st); break;
        default: {
            dim3 grid((unsigned)npts, (unsigned)G);
            stencil_block_kernel<<<grid, kThreads, 0, st>>>(U_, a, b, v, npts, (int)S, gr);
        }
    }
    sum_points_kernel<<<(unsigned)G, kThreads, 0, st>>>(v, (double*)out, npts);
    return (int)cudaGetLastError();
}
