// Kernel 22: the midpoint-propagator chain.
//
// Replaces the step bodies of pythtb_tpu/optical.py:_td_current_jit
// (:601-651, with _td_current_batch_jit's vmap over the drive
// frequencies, :652-662) and pythtb_tpu/floquet.py:_propagation_scan
// (:299-354, run by _propagator_jit and _propagator_history_jit).  Both
// run the same midpoint step under lax.scan:
//
//   E[s, t] = sum_n V[n, s] e^{-i w_n dt} conj(V[n, t])   (exp(-i H dt))
//   state mode:  psi[m, s] <- sum_t E[s, t] psi[m, t]      (occupied rows)
//                j_a       += Re sum_{m,s,t} conj(psi[m,s]) dH_a[s,t] psi[m,t]
//   full mode:   U[s, u]   <- sum_t E[s, t] U[t, u]        (+ history)
//
// The eigenpairs (w, V) of every step's H, and in state mode dH at every
// step end, do not depend on the state, so the caller builds them for a
// chunk of Tc steps in a few launches (kernel 1, the batched eigensolver,
// kernel 15); only the product chain is sequential, and one launch walks
// it for the whole chunk.  Inputs: w (Tc, R, S) float64, V (Tc, R, S, S)
// complex128 with states as rows (the eigh_batched layout), dt (R,) per
// row (R folds the frequency batch into the k-rows: rows g * Rg .. (g+1) *
// Rg - 1 are frequency g); state mode also dH (Tc, R, d, S, S), reduced.
//
// The current is a sum over the k-rows of a frequency.  Each block
// writes its rows' partial sums, part[(step, g, slot, a)], and a second
// launch (reduce_slots_kernel) adds the slots of each (step, g) in slot
// order: no atomics, so the sum is the same on every run.  The
// Cartesian rotation by lat / 2 pi and the 1 / N_k factor are linear and
// are applied by the caller.
//
// Mapping.  S <= 8: one thread per row, templated on S, the state or U
// in registers (the compiler spills some of U at S 5-8), one warp a
// block; at S <= 2 the next step's w, V and dH are loaded while the step
// computes; slots are the warps of a frequency's rows, summed by a
// shuffle tree.  9 <= S <= 64: one block per row, with
// V, the state (or U) and the exponential in dynamic shared memory (3 x
// 64 kB at S 64, above the 48 kB default: cudaFuncSetAttribute); slots
// are the rows.  Above 64 the wrapper raises.
//
// What bounds it on the H100: reading V (and dH) once per step and row,
// 16 S^2 (1 + d) bytes; the arithmetic is 8 S^3 + 8 nocc S^2 (1 + d)
// float64 operations a row-step, which at S <= 8 stays below the bytes.
// At the strong-field harmonic call (2,304 rows, 2,560 steps, S 2, d 2)
// the chain reads ~1.2 GB: ~0.37 ms at 3.35 TB/s.
#include "common.cuh"

namespace {

__device__ __forceinline__ cplx cmul(cplx a, cplx b) { return cuCmul(a, b); }

__device__ __forceinline__ cplx cfma(cplx a, cplx b, cplx c) {  // a * b + c
    return make_cuDoubleComplex(fma(a.x, b.x, fma(-a.y, b.y, c.x)), fma(a.x, b.y, fma(a.y, b.x, c.y)));
}

// e^{-i w dt}
__device__ __forceinline__ cplx step_phase(double w, double dt) {
    double sn, cs;
    sincos(w * dt, &sn, &cs);
    return make_cuDoubleComplex(cs, -sn);
}

// Fixed-order tree sum of red[0 .. blockDim.x) (a power of two); the
// result is in red[0] for every thread after the call.
__device__ void block_sum(double* red) {
    for (int half = blockDim.x / 2; half > 0; half >>= 1) {
        __syncthreads();
        if ((int)threadIdx.x < half) red[threadIdx.x] += red[threadIdx.x + half];
    }
    __syncthreads();
}

// ---- one thread per row (S <= 8) -------------------------------------------

constexpr int kWarp = 32;  // threads a block on the register path

// One step's arrays at row-step index rs = st * R + r: w (S), V (S^2) and,
// in state mode, dH (d S^2, d <= 3).
template <int S>
__device__ __forceinline__ void load_step(const double* __restrict__ w, const cplx* __restrict__ V,
                                          const cplx* __restrict__ dH, int64_t rs, int d, double (&wv)[S],
                                          cplx (&Vv)[S * S], cplx (&Dv)[3 * S * S]) {
#pragma unroll
    for (int n = 0; n < S; ++n) wv[n] = w[rs * S + n];
#pragma unroll
    for (int i = 0; i < S * S; ++i) Vv[i] = V[rs * S * S + i];
    if (dH != nullptr) {
#pragma unroll
        for (int a = 0; a < 3; ++a)
            if (a < d)
#pragma unroll
                for (int i = 0; i < S * S; ++i) Dv[a * S * S + i] = dH[(rs * d + a) * S * S + i];
    }
}

// psi <- E psi for one step, then cur[a] = Re sum conj(psi) dH_a psi.
// Loops run to compile-time bounds with guards, so p stays in registers.
template <int S>
__device__ __forceinline__ void state_step(const double* ws, const cplx* Vs, const cplx* D, double dtr, int nocc,
                                           int d, cplx (&p)[S][S], double (&cur)[3]) {
    cplx e[S];
#pragma unroll
    for (int n = 0; n < S; ++n) e[n] = step_phase(ws[n], dtr);
    cplx q[S][S];
#pragma unroll
    for (int m = 0; m < S; ++m)
#pragma unroll
        for (int s = 0; s < S; ++s) q[m][s] = make_cuDoubleComplex(0.0, 0.0);
#pragma unroll
    for (int s = 0; s < S; ++s) {
#pragma unroll
        for (int t = 0; t < S; ++t) {
            cplx E = make_cuDoubleComplex(0.0, 0.0);
#pragma unroll
            for (int n = 0; n < S; ++n) E = cfma(cmul(Vs[n * S + s], e[n]), cconj(Vs[n * S + t]), E);
#pragma unroll
            for (int m = 0; m < S; ++m)
                if (m < nocc) q[m][s] = cfma(E, p[m][t], q[m][s]);
        }
    }
#pragma unroll
    for (int m = 0; m < S; ++m)
#pragma unroll
        for (int s = 0; s < S; ++s) p[m][s] = q[m][s];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
        if (a >= d) break;
        double acc = 0.0;
#pragma unroll
        for (int m = 0; m < S; ++m) {
            if (m >= nocc) break;
#pragma unroll
            for (int s = 0; s < S; ++s) {
                cplx y = make_cuDoubleComplex(0.0, 0.0);
#pragma unroll
                for (int t = 0; t < S; ++t) y = cfma(D[(a * S + s) * S + t], p[m][t], y);
                acc += p[m][s].x * y.x + p[m][s].y * y.y;  // Re conj(p) y
            }
        }
        cur[a] = acc;
    }
}

// U <- E U for one step
template <int S>
__device__ __forceinline__ void full_step(const double* ws, const cplx* Vs, double dtr, cplx (&u)[S][S]) {
    cplx e[S];
#pragma unroll
    for (int n = 0; n < S; ++n) e[n] = step_phase(ws[n], dtr);
    cplx q[S][S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
#pragma unroll
        for (int v = 0; v < S; ++v) q[s][v] = make_cuDoubleComplex(0.0, 0.0);
#pragma unroll
        for (int t = 0; t < S; ++t) {
            cplx E = make_cuDoubleComplex(0.0, 0.0);
#pragma unroll
            for (int n = 0; n < S; ++n) E = cfma(cmul(Vs[n * S + s], e[n]), cconj(Vs[n * S + t]), E);
#pragma unroll
            for (int v = 0; v < S; ++v) q[s][v] = cfma(E, u[t][v], q[s][v]);
        }
    }
#pragma unroll
    for (int s = 0; s < S; ++s)
#pragma unroll
        for (int v = 0; v < S; ++v) u[s][v] = q[s][v];
}

// One warp a block.  At S <= 2 the next step's w, V and dH are loaded
// while this step computes (they do not depend on the state); above,
// each step reads them where it uses them.  The current's partial sum
// over the warp's rows is a fixed-order shuffle tree: no block barrier.
template <int S>
__global__ void __launch_bounds__(kWarp) state_reg_kernel(const double* __restrict__ w, const cplx* __restrict__ V,
                                                          const cplx* __restrict__ dH, cplx* __restrict__ psi,
                                                          const double* __restrict__ dt, double* __restrict__ part,
                                                          int64_t Tc, int64_t R, int64_t Rg, int nocc, int d) {
    constexpr bool kPrefetch = S <= 2;
    const int g = blockIdx.y;
    const int64_t rin = (int64_t)blockIdx.x * kWarp + threadIdx.x;
    const bool active = rin < Rg;
    const int64_t r = (int64_t)g * Rg + rin;
    const int nslot = gridDim.x;
    cplx p[S][S];  // p[m][s], m < nocc
#pragma unroll
    for (int m = 0; m < S; ++m)
#pragma unroll
        for (int s = 0; s < S; ++s)
            p[m][s] = (active && m < nocc) ? psi[(r * nocc + m) * S + s] : make_cuDoubleComplex(0.0, 0.0);
    const double dtr = active ? dt[r] : 0.0;
    double wv[S];
    cplx Vv[S * S], Dv[3 * S * S];
    if (kPrefetch && active) load_step<S>(w, V, dH, r, d, wv, Vv, Dv);
    for (int64_t st = 0; st < Tc; ++st) {
        double cur[3] = {0.0, 0.0, 0.0};
        if (active) {
            const int64_t rs = st * R + r;
            if constexpr (kPrefetch) {
                double wc[S];
                cplx Vc[S * S], Dc[3 * S * S];
#pragma unroll
                for (int n = 0; n < S; ++n) wc[n] = wv[n];
#pragma unroll
                for (int i = 0; i < S * S; ++i) Vc[i] = Vv[i];
#pragma unroll
                for (int i = 0; i < 3 * S * S; ++i) Dc[i] = Dv[i];
                if (st + 1 < Tc) load_step<S>(w, V, dH, rs + R, d, wv, Vv, Dv);
                state_step<S>(wc, Vc, Dc, dtr, nocc, d, p, cur);
            } else {
                state_step<S>(w + rs * S, V + rs * S * S, dH + rs * d * S * S, dtr, nocc, d, p, cur);
            }
        }
        for (int a = 0; a < d; ++a) {
            double v = cur[0];
            if (a == 1) v = cur[1];
            if (a == 2) v = cur[2];
            for (int off = kWarp / 2; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
            if (threadIdx.x == 0) part[((st * gridDim.y + g) * nslot + blockIdx.x) * d + a] = v;
        }
    }
    if (active) {
#pragma unroll
        for (int m = 0; m < S; ++m)
            if (m < nocc)
#pragma unroll
                for (int s = 0; s < S; ++s) psi[(r * nocc + m) * S + s] = p[m][s];
    }
}

template <int S>
__global__ void __launch_bounds__(kWarp) full_reg_kernel(const double* __restrict__ w, const cplx* __restrict__ V,
                                                         cplx* __restrict__ U, const double* __restrict__ dt,
                                                         cplx* __restrict__ hist, int64_t Tc, int64_t R) {
    constexpr bool kPrefetch = S <= 2;
    const int64_t r = (int64_t)blockIdx.x * kWarp + threadIdx.x;
    if (r >= R) return;
    cplx u[S][S];
#pragma unroll
    for (int s = 0; s < S; ++s)
#pragma unroll
        for (int t = 0; t < S; ++t) u[s][t] = U[(r * S + s) * S + t];
    const double dtr = dt[r];
    double wv[S];
    cplx Vv[S * S], Dv[3 * S * S];
    if (kPrefetch) load_step<S>(w, V, nullptr, r, 0, wv, Vv, Dv);
    for (int64_t st = 0; st < Tc; ++st) {
        const int64_t rs = st * R + r;
        if constexpr (kPrefetch) {
            double wc[S];
            cplx Vc[S * S];
#pragma unroll
            for (int n = 0; n < S; ++n) wc[n] = wv[n];
#pragma unroll
            for (int i = 0; i < S * S; ++i) Vc[i] = Vv[i];
            if (st + 1 < Tc) load_step<S>(w, V, nullptr, rs + R, 0, wv, Vv, Dv);
            full_step<S>(wc, Vc, dtr, u);
        } else {
            full_step<S>(w + rs * S, V + rs * S * S, dtr, u);
        }
        if (hist != nullptr) {
            cplx* h = hist + rs * S * S;
#pragma unroll
            for (int s = 0; s < S; ++s)
#pragma unroll
                for (int v = 0; v < S; ++v) h[s * S + v] = u[s][v];
        }
    }
#pragma unroll
    for (int s = 0; s < S; ++s)
#pragma unroll
        for (int t = 0; t < S; ++t) U[(r * S + s) * S + t] = u[s][t];
}

// ---- one block per row (9 <= S <= 64) --------------------------------------

// E[s, t] = sum_n V[n, s] ph[n] conj(V[n, t]) for the block's row, from
// V and ph in shared memory into E (shared).
__device__ void exp_block(const cplx* Vs, const cplx* ph, cplx* E, int S) {
    for (int i = threadIdx.x; i < S * S; i += blockDim.x) {
        const int s = i / S, t = i - s * S;
        cplx acc = make_cuDoubleComplex(0.0, 0.0);
        for (int n = 0; n < S; ++n) acc = cfma(cmul(Vs[n * S + s], ph[n]), cconj(Vs[n * S + t]), acc);
        E[i] = acc;
    }
}

__global__ void state_block_kernel(const double* __restrict__ w, const cplx* __restrict__ V,
                                   const cplx* __restrict__ dH, cplx* __restrict__ psi,
                                   const double* __restrict__ dt, double* __restrict__ part, int64_t Tc,
                                   int64_t R, int64_t Rg, int S, int nocc, int d) {
    extern __shared__ double smem[];
    double* red = smem;  // kThreads
    cplx* ph = reinterpret_cast<cplx*>(smem + kThreads);  // S
    cplx* bufA = ph + S;                                  // S * S
    cplx* bufB = bufA + S * S;                            // S * S
    cplx* E = bufB + S * S;                               // S * S
    const int64_t r = blockIdx.x;
    const int64_t g = r / Rg, slot = r - g * Rg;
    const int ngroup = (int)(R / Rg);
    const int SS = S * S;
    cplx* P = bufA;  // the state, nocc x S
    cplx* Vs = bufB;
    for (int i = threadIdx.x; i < nocc * S; i += blockDim.x) P[i] = psi[r * nocc * S + i];
    const double dtr = dt[r];
    for (int64_t st = 0; st < Tc; ++st) {
        const cplx* Vg = V + (st * R + r) * SS;
        for (int i = threadIdx.x; i < SS; i += blockDim.x) Vs[i] = Vg[i];
        for (int n = threadIdx.x; n < S; n += blockDim.x) ph[n] = step_phase(w[(st * R + r) * S + n], dtr);
        __syncthreads();
        exp_block(Vs, ph, E, S);
        __syncthreads();
        // the new state goes where V was
        for (int i = threadIdx.x; i < nocc * S; i += blockDim.x) {
            const int m = i / S, s = i - m * S;
            cplx acc = make_cuDoubleComplex(0.0, 0.0);
            for (int t = 0; t < S; ++t) acc = cfma(E[s * S + t], P[m * S + t], acc);
            Vs[i] = acc;
        }
        __syncthreads();
        cplx* tmp = P;
        P = Vs;
        Vs = tmp;
        const cplx* D = dH + (st * R + r) * (int64_t)d * SS;
        for (int a = 0; a < d; ++a) {
            double acc = 0.0;
            for (int i = threadIdx.x; i < SS; i += blockDim.x) {
                const int s = i / S, t = i - s * S;
                const cplx h = D[a * SS + i];
                cplx o = make_cuDoubleComplex(0.0, 0.0);  // sum_m conj(P[m, s]) P[m, t]
                for (int m = 0; m < nocc; ++m) o = cfma(cconj(P[m * S + s]), P[m * S + t], o);
                acc += h.x * o.x - h.y * o.y;  // Re(h o)
            }
            red[threadIdx.x] = acc;
            block_sum(red);
            if (threadIdx.x == 0) part[((st * ngroup + g) * Rg + slot) * d + a] = red[0];
            __syncthreads();
        }
    }
    for (int i = threadIdx.x; i < nocc * S; i += blockDim.x) psi[r * nocc * S + i] = P[i];
}

__global__ void full_block_kernel(const double* __restrict__ w, const cplx* __restrict__ V, cplx* __restrict__ U,
                                  const double* __restrict__ dt, cplx* __restrict__ hist, int64_t Tc, int64_t R,
                                  int S) {
    extern __shared__ double smem[];
    cplx* ph = reinterpret_cast<cplx*>(smem);  // S
    cplx* bufA = ph + S;
    cplx* bufB = bufA + S * S;
    cplx* E = bufB + S * S;
    const int64_t r = blockIdx.x;
    const int SS = S * S;
    cplx* Us = bufA;
    cplx* Vs = bufB;
    for (int i = threadIdx.x; i < SS; i += blockDim.x) Us[i] = U[r * SS + i];
    const double dtr = dt[r];
    for (int64_t st = 0; st < Tc; ++st) {
        const cplx* Vg = V + (st * R + r) * SS;
        for (int i = threadIdx.x; i < SS; i += blockDim.x) Vs[i] = Vg[i];
        for (int n = threadIdx.x; n < S; n += blockDim.x) ph[n] = step_phase(w[(st * R + r) * S + n], dtr);
        __syncthreads();
        exp_block(Vs, ph, E, S);
        __syncthreads();
        for (int i = threadIdx.x; i < SS; i += blockDim.x) {
            const int s = i / S, v = i - s * S;
            cplx acc = make_cuDoubleComplex(0.0, 0.0);
            for (int t = 0; t < S; ++t) acc = cfma(E[s * S + t], Us[t * S + v], acc);
            Vs[i] = acc;
        }
        __syncthreads();
        cplx* tmp = Us;
        Us = Vs;
        Vs = tmp;
        if (hist != nullptr)
            for (int i = threadIdx.x; i < SS; i += blockDim.x) hist[(st * R + r) * SS + i] = Us[i];
    }
    for (int i = threadIdx.x; i < SS; i += blockDim.x) U[r * SS + i] = Us[i];
}

// out[row, a] = sum over slots of part[row, slot, a], in slot order
__global__ void reduce_slots_kernel(const double* __restrict__ part, double* __restrict__ out, int64_t rows,
                                    int64_t nslot, int d) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= rows * d) return;
    const int64_t row = i / d;
    const int a = (int)(i - row * d);
    double acc = 0.0;
    for (int64_t p = 0; p < nslot; ++p) acc += part[(row * nslot + p) * d + a];
    out[i] = acc;
}

template <int S>
void launch_state_reg(const double* w, const cplx* V, const cplx* dH, cplx* psi, const double* dt, double* part,
                      int64_t Tc, int64_t R, int64_t Rg, int nocc, int d, cudaStream_t stream) {
    dim3 grid((unsigned)((Rg + kWarp - 1) / kWarp), (unsigned)(R / Rg));
    state_reg_kernel<S><<<grid, kWarp, 0, stream>>>(w, V, dH, psi, dt, part, Tc, R, Rg, nocc, d);
}

template <int S>
void launch_full_reg(const double* w, const cplx* V, cplx* U, const double* dt, cplx* hist, int64_t Tc, int64_t R,
                     cudaStream_t stream) {
    full_reg_kernel<S><<<(unsigned)((R + kWarp - 1) / kWarp), kWarp, 0, stream>>>(w, V, U, dt, hist, Tc, R);
}

size_t block_smem(int S, bool state) {
    return (state ? kThreads * sizeof(double) : 0) + (size_t)(S + 3 * S * S) * sizeof(cplx);
}

}  // namespace

// State mode: psi (R, nocc, S) updated in place; part (Tc, R / Rg,
// slots, d) scratch, with slots = ceil(Rg / 32) at S <= 8 (a warp of
// rows each) and Rg above (a row each); j (Tc, R / Rg, d) the reduced
// currents.
extern "C" int pythtb_propagate_state(const void* w, const void* V, const void* dH, void* psi, const void* dt,
                                      void* part, void* j, int64_t Tc, int64_t R, int64_t Rg, int64_t S,
                                      int64_t nocc, int64_t d, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    const double* w_ = (const double*)w;
    const cplx* V_ = (const cplx*)V;
    const cplx* D_ = (const cplx*)dH;
    cplx* p_ = (cplx*)psi;
    const double* dt_ = (const double*)dt;
    double* part_ = (double*)part;
    if (Tc <= 0 || R <= 0) return (int)cudaGetLastError();
    switch (S) {
        case 1: launch_state_reg<1>(w_, V_, D_, p_, dt_, part_, Tc, R, Rg, (int)nocc, (int)d, st); break;
        case 2: launch_state_reg<2>(w_, V_, D_, p_, dt_, part_, Tc, R, Rg, (int)nocc, (int)d, st); break;
        case 3: launch_state_reg<3>(w_, V_, D_, p_, dt_, part_, Tc, R, Rg, (int)nocc, (int)d, st); break;
        case 4: launch_state_reg<4>(w_, V_, D_, p_, dt_, part_, Tc, R, Rg, (int)nocc, (int)d, st); break;
        case 5: launch_state_reg<5>(w_, V_, D_, p_, dt_, part_, Tc, R, Rg, (int)nocc, (int)d, st); break;
        case 6: launch_state_reg<6>(w_, V_, D_, p_, dt_, part_, Tc, R, Rg, (int)nocc, (int)d, st); break;
        case 7: launch_state_reg<7>(w_, V_, D_, p_, dt_, part_, Tc, R, Rg, (int)nocc, (int)d, st); break;
        case 8: launch_state_reg<8>(w_, V_, D_, p_, dt_, part_, Tc, R, Rg, (int)nocc, (int)d, st); break;
        default: {
            const size_t bytes = block_smem((int)S, true);
            cudaFuncSetAttribute(state_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
            state_block_kernel<<<(unsigned)R, kThreads, bytes, st>>>(w_, V_, D_, p_, dt_, part_, Tc, R, Rg,
                                                                      (int)S, (int)nocc, (int)d);
        }
    }
    const int64_t rows = Tc * (R / Rg);
    const int64_t nslot = S <= 8 ? (Rg + kWarp - 1) / kWarp : Rg;
    if (rows * d > 0)
        reduce_slots_kernel<<<blocks_for(rows * d), kThreads, 0, st>>>(part_, (double*)j, rows, nslot, (int)d);
    return (int)cudaGetLastError();
}

// Full mode: U (R, S, S) updated in place; hist (Tc, R, S, S) or null.
extern "C" int pythtb_propagate_full(const void* w, const void* V, void* U, const void* dt, void* hist, int64_t Tc,
                                     int64_t R, int64_t S, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    const double* w_ = (const double*)w;
    const cplx* V_ = (const cplx*)V;
    cplx* U_ = (cplx*)U;
    const double* dt_ = (const double*)dt;
    cplx* h_ = (cplx*)hist;
    if (Tc <= 0 || R <= 0) return (int)cudaGetLastError();
    switch (S) {
        case 1: launch_full_reg<1>(w_, V_, U_, dt_, h_, Tc, R, st); break;
        case 2: launch_full_reg<2>(w_, V_, U_, dt_, h_, Tc, R, st); break;
        case 3: launch_full_reg<3>(w_, V_, U_, dt_, h_, Tc, R, st); break;
        case 4: launch_full_reg<4>(w_, V_, U_, dt_, h_, Tc, R, st); break;
        case 5: launch_full_reg<5>(w_, V_, U_, dt_, h_, Tc, R, st); break;
        case 6: launch_full_reg<6>(w_, V_, U_, dt_, h_, Tc, R, st); break;
        case 7: launch_full_reg<7>(w_, V_, U_, dt_, h_, Tc, R, st); break;
        case 8: launch_full_reg<8>(w_, V_, U_, dt_, h_, Tc, R, st); break;
        default: {
            const size_t bytes = block_smem((int)S, false);
            cudaFuncSetAttribute(full_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
            full_block_kernel<<<(unsigned)R, kThreads, bytes, st>>>(w_, V_, U_, dt_, h_, Tc, R, (int)S);
        }
    }
    return (int)cudaGetLastError();
}
