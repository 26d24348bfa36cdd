// Kernel 9: the Chebyshev (KPM) recursion T_{m+1} = 2 Ht T_m - T_{m-1},
// Ht = (H - b) / a, on the ELL Hamiltonian, with its moments.
//
// Replaces the XLA-fused lax.scan programs pythtb_tpu/flows.py:
// _kpm_moments_jit, realspace.py:_ldos_moments_jit (moments mode) and the
// two recursions of realspace.py:_kubo_moments_jit (recursion-only mode).
//
// * Moments mode (pythtb_cheb_moments): from T_0 = x0 (nsta, B), each step
//   writes T_{m+1} over T_{m-1} (the ring holds two slots; only the thread
//   that reads T_{m-1}[r, b] writes T_{m+1}[r, b]) and each block's sums,
//   per column, of Re(conj(T_m) T_m) and Re(conj(T_{m+1}) T_m) over its rows
//   in a fixed tree order.  After the step's grid barrier the blocks' sums
//   of a column are added in block order by one warp and the doubling
//   identities mu_{2m} = 2<T_m|T_m> - mu_0, mu_{2m+1} = 2<T_{m+1}|T_m> -
//   mu_1 written into mu (M, B).  The caller fills mu[0] (the JAX programs
//   use the constant N, or 1 for unit vectors).  No atomics: two calls give
//   the same bits.
// * Recursion-only mode (pythtb_cheb_recursion): slot k of a Chebyshev
//   block lives at buf + k * slot with row stride ld; from slot 0 it
//   writes slots 1 .. count-1 in place, so the Kubo blocks are built there
//   (the left block's (nsta, M, R) buffer permuted: ld = M R, slot = R).
//
// What bounds it on the H100: latency.  A step's bytes (at N 90,000, D 5,
// R 8: the tables, T_m gathered, T_{m-1} and T_{m+1}, ~43.6 MB) stay in
// the 50 MB L2; at the Kubo torus (1,152 x 8) a step is a few hundred
// nanoseconds of work.  The one-launch-a-step design spent 9.3 us a step
// at 90k in its two launches.  Design: a whole call is one cooperative
// launch (cheb_grid.cuh), one grid barrier a step, the tables in shared
// memory where a block's rows fit; the moment sums need no second launch.
// Per element the recursion's arithmetic is the one-launch design's, so
// the recursion gives its bits.
#include "cheb_grid.cuh"

// The block's per-column sums of a step, over its row lanes in a fixed
// tree, into pm (2, G, B).
template <int T>
__device__ __forceinline__ void block_sums(const GridRows& g, int64_t b, int64_t B, double se, double so,
                                           double (&red)[2][T], double* pm) {
    const int tid = threadIdx.x;
    if (g.active) {
        red[0][tid] = se;
        red[1][tid] = so;
    }
    __syncthreads();
    for (int w = g.ry; w > 1;) {
        const int h = (w + 1) >> 1;
        if (g.active && g.ty + h < w) {
            red[0][tid] += red[0][tid + h * g.bx];
            red[1][tid] += red[1][tid + h * g.bx];
        }
        __syncthreads();
        w = h;
    }
    if (g.active && g.ty == 0 && b < B) {
        pm[blockIdx.x * B + b] = red[0][tid];
        pm[(gridDim.x + blockIdx.x) * B + b] = red[1][tid];
    }
    __syncthreads();
}

// The moments of step m from the blocks' sums pm (2, G, B): columns b =
// blockIdx.x + k G, a warp each (k mod the warps), the blocks' sums in
// block order per lane, then a fixed shuffle tree.
template <int T>
__device__ __forceinline__ void step_moments(const double* pm, double* mu, int64_t m, int64_t M, int64_t B) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int64_t G = gridDim.x;
    int64_t k = 0;
    for (int64_t b = blockIdx.x; b < B; b += G, ++k) {
        if ((int)(k % (T / 32)) != warp) continue;
        double se = 0.0, so = 0.0;
        for (int64_t j = lane; j < G; j += 32) {
            se += __ldcg(pm + j * B + b);
            so += __ldcg(pm + (G + j) * B + b);
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
            se += __shfl_xor_sync(0xffffffffu, se, off);
            so += __shfl_xor_sync(0xffffffffu, so, off);
        }
        if (lane == 0) {
            if (m == 0) {
                mu[B + b] = so;
            } else {
                if (2 * m < M) mu[2 * m * B + b] = 2.0 * se - mu[b];
                if (2 * m + 1 < M) mu[(2 * m + 1) * B + b] = 2.0 * so - mu[B + b];
            }
        }
    }
}

// Step m reads T_m from slot m % 2 and writes T_{m+1} over T_{m-1} in the
// other; its moments are formed during step m + 1 (the last step's after
// the final barrier), so no block waits for them.
template <int S, bool TAB_SMEM, int T>
__global__ void __launch_bounds__(T, 1)
cheb_moments_kernel(const int* __restrict__ cols, const cplx* __restrict__ vals, const double* __restrict__ ab,
                    cplx* work, double* part, double* mu, int64_t norb, int64_t B, int D, int64_t M) {
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ double red[2][T];
    cg::grid_group grid = cg::this_grid();
    const GridRows g = grid_rows<S, T>(norb, B);
    const int* tcols;
    const cplx* tvals;
    grid_tables<S, TAB_SMEM>(g, cols, vals, D, smem, tcols, tvals);
    const int64_t n = norb * S * B, G = gridDim.x;
    const int64_t steps = 1 + (M - 1) / 2;
    const double a = ab[0], shift = ab[1];
    const int ld = (int)B, ldS = S * (int)B;
    for (int64_t m = 0; m < steps; ++m) {
        const cplx* tc = work + (m & 1) * n;
        cplx* tn = work + ((m + 1) & 1) * n;
        const bool store = m + 1 < steps;
        for (int64_t cb = 0; cb < B; cb += g.bx) {
            const int64_t b = cb + g.tx;
            double se = 0.0, so = 0.0;
            if (g.active && b < B) {
                for (int rl = g.ty; rl < g.rows; rl += g.ry) {
                    const int64_t at = (g.r0 + rl) * B + b;
                    const cplx c = tc[at];
                    const cplx p = m > 0 ? tn[at] : c;
                    cplx out = grid_scaled<S, TAB_SMEM, gather_depth<T>()>(tcols, tvals, tc + b, ld, ldS, rl, D, a,
                                                                           shift, c);
                    if (m > 0) out = make_cuDoubleComplex(2.0 * out.x - p.x, 2.0 * out.y - p.y);
                    if (store) tn[at] = out;
                    se += c.x * c.x + c.y * c.y;
                    so += out.x * c.x + out.y * c.y;
                }
            }
            block_sums<T>(g, b, B, se, so, red, part + (m & 1) * 2 * G * B);
        }
        if (m > 0) step_moments<T>(part + ((m - 1) & 1) * 2 * G * B, mu, m - 1, M, B);
        grid.sync();
    }
    step_moments<T>(part + ((steps - 1) & 1) * 2 * G * B, mu, steps - 1, M, B);
}

// Slots 1 .. count-1 of buf from slot 0 (slot k at buf + k * slot, rows ld apart).
template <int S, bool TAB_SMEM, int T>
__global__ void __launch_bounds__(T, 1)
cheb_recursion_kernel(const int* __restrict__ cols, const cplx* __restrict__ vals, const double* __restrict__ ab,
                      cplx* buf, int64_t norb, int64_t B, int D, int64_t ld, int64_t slot, int64_t count) {
    extern __shared__ __align__(16) unsigned char smem[];
    cg::grid_group grid = cg::this_grid();
    const GridRows g = grid_rows<S, T>(norb, B);
    const int* tcols;
    const cplx* tvals;
    grid_tables<S, TAB_SMEM>(g, cols, vals, D, smem, tcols, tvals);
    const double a = ab[0], shift = ab[1];
    const int ldS = S * (int)ld;
    for (int64_t k = 1; k < count; ++k) {
        const cplx* tc = buf + (k - 1) * slot;
        cplx* tn = buf + k * slot;
        if (g.active) {
            for (int64_t b = g.tx; b < B; b += g.bx) {
                for (int rl = g.ty; rl < g.rows; rl += g.ry) {
                    const int64_t at = (g.r0 + rl) * ld + b;
                    const cplx c = tc[at];
                    const cplx p = k > 1 ? buf[(k - 2) * slot + at] : c;
                    cplx out = grid_scaled<S, TAB_SMEM, gather_depth<T>()>(tcols, tvals, tc + b, (int)ld, ldS, rl,
                                                                           D, a, shift, c);
                    if (k > 1) out = make_cuDoubleComplex(2.0 * out.x - p.x, 2.0 * out.y - p.y);
                    tn[at] = out;
                }
            }
        }
        if (k + 1 < count) grid.sync();
    }
}

static size_t tables_smem_bytes(int64_t norb, int64_t D, int64_t nspin, int64_t G, int64_t tables_smem) {
    return tables_smem ? (size_t)grid_tables_bytes((norb + G - 1) / G, D, (int)nspin) : 0;
}

template <int S, int T>
static const void* moments_kernel(bool tab) {
    return tab ? (const void*)cheb_moments_kernel<S, true, T> : (const void*)cheb_moments_kernel<S, false, T>;
}

template <int S, int T>
static const void* recursion_kernel(bool tab) {
    return tab ? (const void*)cheb_recursion_kernel<S, true, T> : (const void*)cheb_recursion_kernel<S, false, T>;
}

template <int S>
static const void* pick(bool moments, bool tab, int64_t T) {
    if (T == 256) return moments ? moments_kernel<S, 256>(tab) : recursion_kernel<S, 256>(tab);
    return moments ? moments_kernel<S, 512>(tab) : recursion_kernel<S, 512>(tab);
}

static bool grid_args_ok(int64_t norb, int64_t nspin, int64_t ld, int64_t G, int64_t T) {
    const int64_t orbs = G < 1 ? 0 : (norb + G - 1) / G;
    return (nspin == 1 || nspin == 2) && G >= 1 && (T == 256 || T == 512) &&
           orbs * nspin * ld < (1LL << 30) && nspin * ld < (1LL << 30);
}

// Moments mode.  work (2, nsta, B): slot 0 holds T_0 on entry (it is
// overwritten); part (2, 2, G, B) scratch; mu (M, B) with mu[0] filled.
extern "C" int pythtb_cheb_moments(const void* cols, const void* vals, const void* ab, void* work, void* part,
                                   void* mu, int64_t norb, int64_t D, int64_t nspin, int64_t B, int64_t M,
                                   int64_t G, int64_t T, int64_t tables_smem, void* stream) {
    if (M < 2 || norb * nspin * B == 0) return (int)cudaGetLastError();
    if (!grid_args_ok(norb, nspin, B, G, T)) return (int)cudaErrorInvalidValue;
    int iD = (int)D;
    void* args[] = {(void*)&cols, (void*)&vals, (void*)&ab, &work, &part, &mu, &norb, &B, &iD, &M};
    const void* kern = nspin == 2 ? pick<2>(true, tables_smem != 0, T) : pick<1>(true, tables_smem != 0, T);
    return grid_launch(kern, G, (int)T, tables_smem_bytes(norb, D, nspin, G, tables_smem), args,
                       (cudaStream_t)stream);
}

// Recursion-only mode: slots 1 .. count-1 of buf from slot 0.
extern "C" int pythtb_cheb_recursion(const void* cols, const void* vals, const void* ab, void* buf, int64_t norb,
                                     int64_t D, int64_t nspin, int64_t B, int64_t ld, int64_t slot, int64_t count,
                                     int64_t G, int64_t T, int64_t tables_smem, void* stream) {
    if (count < 2 || norb * nspin * B == 0) return (int)cudaGetLastError();
    if (!grid_args_ok(norb, nspin, ld, G, T)) return (int)cudaErrorInvalidValue;
    int iD = (int)D;
    void* args[] = {(void*)&cols, (void*)&vals, (void*)&ab, &buf, &norb, &B, &iD, &ld, &slot, &count};
    const void* kern = nspin == 2 ? pick<2>(false, tables_smem != 0, T) : pick<1>(false, tables_smem != 0, T);
    return grid_launch(kern, G, (int)T, tables_smem_bytes(norb, D, nspin, G, tables_smem), args,
                       (cudaStream_t)stream);
}
