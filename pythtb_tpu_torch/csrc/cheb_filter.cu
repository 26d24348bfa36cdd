// Kernel 11: the Gaussian-window Chebyshev filter of the spectrum-slice
// solver,  Y = sum_{m < M} coef[m] T_m(Ht) X,  Ht = (H - b) / a,  coef real.
//
// Replaces the lax.scan of pythtb_tpu/flows.py:_window_round_jit (the
// filter at :696-706); the whitening and Rayleigh-Ritz of that program
// stay torch.linalg in ops/chebyshev.py's caller (flows._window_round).
//
// What bounds it on the H100: latency.  At the magic-angle TBG shape (N
// 11,164, D 49, B 12, degree 512 to 6,144) a term's bytes (tables 10.9 MB,
// T_m gathered) take ~6 us at 3.35 TB/s and stay in the 50 MB L2; a thread
// walks its row's 49 dependent (column, gather) pairs.  The one-launch-a-
// term design spent ~16.6 us a term: 2.2 us of launch, 1.1 us of gathers
// and ~11.7 us of the table reads and their dependent chain (PERF.md §6).
//
// Design: the whole filter is one cooperative launch (cheb_grid.cuh), one
// grid barrier a term.  Each block owns a contiguous range of rows; its
// tables sit in shared memory for the launch where they fit, and its rows'
// acc and T_{m-1} stay on chip (shared memory; device memory where they do
// not fit), so only T_m crosses blocks: each term writes the block's rows
// of T_{m+1} into the other half of the two-slot ring, then the barrier.
// The last term writes acc into Y and nothing else.  The arithmetic per
// element is that of the term kernel it replaces (the same bits): no sums
// across elements.
#include "cheb_grid.cuh"

__device__ __forceinline__ cplx coef_mul(double c, cplx v) { return make_cuDoubleComplex(c * v.x, c * v.y); }

// x (nsta, B) is T_0; work (2, nsta, B) the ring of T_1, T_2, ...; state
// (2, nsta, B) holds acc and T_{m-1} where they stay in device memory.
template <int S, bool TAB_SMEM, int T>
__global__ void __launch_bounds__(T, 1)
cheb_filter_kernel(const int* __restrict__ cols, const cplx* __restrict__ vals, const double* __restrict__ ab,
                   const double* __restrict__ coef, const cplx* __restrict__ x, cplx* work, cplx* state,
                   cplx* __restrict__ y, int64_t norb, int64_t B, int D, int64_t M, int state_smem) {
    extern __shared__ __align__(16) unsigned char smem[];
    cg::grid_group grid = cg::this_grid();
    const GridRows g = grid_rows<S, T>(norb, B);
    const int64_t n = norb * S * B;
    const int64_t orbs_max = (norb + gridDim.x - 1) / gridDim.x;
    const int* tcols;
    const cplx* tvals;
    grid_tables<S, TAB_SMEM>(g, cols, vals, D, smem, tcols, tvals);
    // acc at st[e], T_{m-1} at st[E + e], e = local row * B + column
    const int E = g.rows * (int)B;
    cplx* st = state_smem ? (cplx*)(smem + (TAB_SMEM ? grid_tables_bytes(orbs_max, D, S) : 0))
                          : state + 2 * g.r0 * B;
    const double a = ab[0], shift = ab[1];
    const int ld = (int)B, ldS = S * (int)B;
    for (int64_t m = 0; m + 1 < M; ++m) {  // term m writes T_{m+1}
        const cplx* tc = m == 0 ? x : work + ((m - 1) & 1) * n;
        cplx* tn = work + (m & 1) * n;
        const bool last = m + 2 == M;
        if (g.active) {
            for (int b = g.tx; b < B; b += g.bx) {
                for (int rl = g.ty; rl < g.rows; rl += g.ry) {
                    const int e = rl * ld + b;
                    const int64_t at = g.r0 * B + e;
                    const cplx own = tc[at];
                    cplx out = grid_scaled<S, TAB_SMEM, gather_depth<T>()>(tcols, tvals, tc + b, ld, ldS, rl, D, a,
                                                                           shift, own);
                    cplx acc;
                    if (m == 0) {
                        acc = cuCadd(coef_mul(coef[0], own), coef_mul(coef[1], out));
                    } else {
                        const cplx prev = st[E + e];
                        out = make_cuDoubleComplex(2.0 * out.x - prev.x, 2.0 * out.y - prev.y);
                        acc = cuCadd(st[e], coef_mul(coef[m + 1], out));
                    }
                    if (last) {
                        y[at] = acc;
                    } else {
                        tn[at] = out;
                        st[e] = acc;
                        st[E + e] = own;
                    }
                }
            }
        }
        if (!last) grid.sync();
    }
}

template <int S, bool TAB_SMEM>
static int filter_launch(void** args, int64_t G, int64_t T, size_t smem, cudaStream_t st) {
    if (T == 256) return grid_launch((const void*)cheb_filter_kernel<S, TAB_SMEM, 256>, G, 256, smem, args, st);
    if (T == 512) return grid_launch((const void*)cheb_filter_kernel<S, TAB_SMEM, 512>, G, 512, smem, args, st);
    return grid_launch((const void*)cheb_filter_kernel<S, TAB_SMEM, 1024>, G, 1024, smem, args, st);
}

// coef (M,) float64, x (nsta, B), work (2, nsta, B), state (2, nsta, B) or
// unused (state_smem), y (nsta, B); G blocks of T threads; tables_smem /
// state_smem place the tables and the on-chip state in shared memory.
extern "C" int pythtb_cheb_filter(const void* cols, const void* vals, const void* ab, const void* coef,
                                  const void* x, void* work, void* state, void* y, int64_t norb, int64_t D,
                                  int64_t nspin, int64_t B, int64_t M, int64_t G, int64_t T, int64_t tables_smem,
                                  int64_t state_smem, void* stream) {
    if (norb * nspin * B == 0 || M < 2) return (int)cudaGetLastError();
    const int64_t orbs = G < 1 ? 0 : (norb + G - 1) / G;
    if ((nspin != 1 && nspin != 2) || orbs * nspin * B >= (1LL << 30) || (T != 256 && T != 512 && T != 1024))
        return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)((tables_smem ? grid_tables_bytes(orbs, D, (int)nspin) : 0) +
                                 (state_smem ? 2 * orbs * nspin * B * (int64_t)sizeof(cplx) : 0));
    int iD = (int)D, ist = (int)(state_smem != 0);
    void* args[] = {(void*)&cols, (void*)&vals, (void*)&ab, (void*)&coef, (void*)&x, &work, &state, &y,
                    &norb, &B, &iD, &M, &ist};
    cudaStream_t st = (cudaStream_t)stream;
    if (nspin == 2)
        return tables_smem ? filter_launch<2, true>(args, G, T, smem, st)
                           : filter_launch<2, false>(args, G, T, smem, st);
    return tables_smem ? filter_launch<1, true>(args, G, T, smem, st) : filter_launch<1, false>(args, G, T, smem, st);
}
