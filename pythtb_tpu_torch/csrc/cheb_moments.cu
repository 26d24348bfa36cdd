// Kernel 9: the Chebyshev (KPM) recursion T_{m+1} = 2 Ht T_m - T_{m-1},
// Ht = (H - b) / a, on the ELL Hamiltonian, with its moments.
//
// Replaces the XLA-fused lax.scan programs pythtb_tpu/flows.py:
// _kpm_moments_jit, realspace.py:_ldos_moments_jit (moments mode) and the
// two recursions of realspace.py:_kubo_moments_jit (recursion-only mode).
//
// * Moments mode (pythtb_cheb_moments): from T_0 = x0 (nsta, B), one
//   launch per step writes T_{m+1} and per-block partial sums, per
//   column, of Re(conj(T_m) T_m) and Re(conj(T_{m+1}) T_m); a second,
//   one-block-per-column launch reduces them in a fixed order and writes
//   the doubling identities mu_{2m} = 2<T_m|T_m> - mu_0 and
//   mu_{2m+1} = 2<T_{m+1}|T_m> - mu_1 into mu (M, B) on the device.  The
//   caller fills mu[0] (the JAX programs use the constant N, or 1 for
//   unit vectors).  Steps stop at the last moment asked for.
// * Recursion-only mode (pythtb_cheb_recursion): slot k of a Chebyshev
//   block lives at buf + k * slot with row stride ld; from slot 0 it
//   writes slots 1 .. count-1, so the Kubo blocks are built in place.
//
// What bounds it on the H100: bytes.  A step reads T_m (gathered through
// the D slots), T_{m-1}, cols and vals and writes T_{m+1}: at N 90,000,
// D 5, R 8 about 43.6 MB, a bound of ~13 us; the moment sums add a few
// kB.  The C entry points run every step of the recursion and issue the
// launches on the stream, so a whole KPM call is one ctypes call, not
// 2 x M/2 Python launches (each would cost more than a step's bound).
// Design: blocks of (bx columns) x (256 / bx rows), columns fastest, the
// grid striding over rows with at most 1,024 row blocks; each thread
// keeps its partial sums in registers and the block reduces them over
// its rows in shared memory in a fixed tree order.  No atomics: the sums
// do not depend on the order the blocks ran in.  T_{m+1} is written over
// T_{m-1}, element by element (only the thread that reads T_{m-1}[r, b]
// writes T_{m+1}[r, b]), so the ring holds two buffers.
#include "ell.cuh"

constexpr int kMaxRowBlocks = 1024;

struct StepShape {
    dim3 grid, block;
};

static StepShape step_shape(int64_t nsta, int64_t B) {
    int bx = 1;
    while (bx < B && bx < 32) bx <<= 1;
    const int ry = kThreads / bx;
    int64_t gx = (nsta + ry - 1) / ry;
    if (gx > kMaxRowBlocks) gx = kMaxRowBlocks;
    if (gx < 1) gx = 1;
    const int64_t gy = (B + bx - 1) / bx;
    StepShape sh;
    sh.grid = dim3((unsigned int)gx, (unsigned int)gy);
    sh.block = dim3((unsigned int)bx, (unsigned int)ry);
    return sh;
}

// One step.  FIRST: tn = Ht tc (T_1 from T_0, tm unused).  Otherwise
// tn = 2 Ht tc - tm; tn may be tm itself.  With MOMENTS, part (2, nblk, B)
// receives this block's sums of Re(conj(tc) tc) and Re(conj(tn) tc).
template <int S, bool FIRST, bool MOMENTS>
__global__ void cheb_step_kernel(const int* __restrict__ cols, const cplx* __restrict__ vals,
                                 const double* __restrict__ ab, const cplx* tm,
                                 const cplx* __restrict__ tc, cplx* tn, double* __restrict__ part,
                                 int64_t nsta, int64_t B, int64_t ld, int D) {
    __shared__ double red[2][kThreads];
    const double a = ab[0], shift = ab[1];
    const int tx = threadIdx.x, ty = threadIdx.y;
    const int64_t b = (int64_t)blockIdx.y * blockDim.x + tx;
    double s_even = 0.0, s_odd = 0.0;
    if (b < B) {
        const int64_t stride = (int64_t)gridDim.x * blockDim.y;
        for (int64_t r = (int64_t)blockIdx.x * blockDim.y + ty; r < nsta; r += stride) {
            const int64_t at = r * ld + b;
            const cplx c = tc[at];
            cplx out = ell_scaled<S>(cols, vals, tc, ld, r, b, D, a, shift);
            if (!FIRST) {
                const cplx m = tm[at];
                out = make_cuDoubleComplex(2.0 * out.x - m.x, 2.0 * out.y - m.y);
            }
            tn[at] = out;
            if (MOMENTS) {
                s_even += c.x * c.x + c.y * c.y;
                s_odd += out.x * c.x + out.y * c.y;
            }
        }
    }
    if (MOMENTS) {
        const int t = ty * blockDim.x + tx;
        red[0][t] = s_even;
        red[1][t] = s_odd;
        __syncthreads();
        for (int w = blockDim.y / 2; w > 0; w >>= 1) {
            if (ty < w) {
                red[0][t] += red[0][t + w * blockDim.x];
                red[1][t] += red[1][t + w * blockDim.x];
            }
            __syncthreads();
        }
        if (ty == 0 && b < B) {
            part[(int64_t)blockIdx.x * B + b] = red[0][tx];
            part[((int64_t)gridDim.x + blockIdx.x) * B + b] = red[1][tx];
        }
    }
}

// Reduce the partial sums of step m (one block per column, fixed order)
// and write its moments: at m = 0 mu_1, else mu_{2m} and mu_{2m+1}
// (those below M).
__global__ void cheb_reduce_kernel(const double* __restrict__ part, double* __restrict__ mu,
                                   int64_t B, int nblk, int64_t m, int64_t M) {
    __shared__ double red[2][kThreads];
    const int64_t b = blockIdx.x;
    const int t = threadIdx.x;
    double s0 = 0.0, s1 = 0.0;
    for (int k = t; k < nblk; k += blockDim.x) {
        s0 += part[(int64_t)k * B + b];
        s1 += part[((int64_t)nblk + k) * B + b];
    }
    red[0][t] = s0;
    red[1][t] = s1;
    __syncthreads();
    for (int w = blockDim.x / 2; w > 0; w >>= 1) {
        if (t < w) {
            red[0][t] += red[0][t + w];
            red[1][t] += red[1][t + w];
        }
        __syncthreads();
    }
    if (t != 0) return;
    if (m == 0) {
        mu[B + b] = red[1][0];
    } else {
        if (2 * m < M) mu[2 * m * B + b] = 2.0 * red[0][0] - mu[b];
        if (2 * m + 1 < M) mu[(2 * m + 1) * B + b] = 2.0 * red[1][0] - mu[B + b];
    }
}

template <int S, bool FIRST, bool MOMENTS>
static void step(const StepShape& sh, cudaStream_t st, const int* cols, const cplx* vals,
                 const double* ab, const cplx* tm, const cplx* tc, cplx* tn, double* part,
                 int64_t nsta, int64_t B, int64_t ld, int D) {
    cheb_step_kernel<S, FIRST, MOMENTS>
        <<<sh.grid, sh.block, 0, st>>>(cols, vals, ab, tm, tc, tn, part, nsta, B, ld, D);
}

template <int S>
static int moments(const int* cols, const cplx* vals, const double* ab, cplx* work, double* part,
                   double* mu, int64_t nsta, int64_t D, int64_t B, int64_t M, cudaStream_t st) {
    const StepShape sh = step_shape(nsta, B);
    const int nblk = (int)sh.grid.x;
    cplx* slot[2] = {work, work + nsta * B};
    // T_1 = Ht T_0 and mu_1
    step<S, true, true>(sh, st, cols, vals, ab, nullptr, slot[0], slot[1], part, nsta, B, B, (int)D);
    cheb_reduce_kernel<<<(unsigned int)B, kThreads, 0, st>>>(part, mu, B, nblk, 0, M);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    // step m: T_{m+1} over T_{m-1}; mu_{2m}, mu_{2m+1}
    for (int64_t m = 1; m <= (M - 1) / 2; ++m) {
        cplx* tc = slot[m & 1];
        cplx* tn = slot[(m + 1) & 1];
        step<S, false, true>(sh, st, cols, vals, ab, tn, tc, tn, part, nsta, B, B, (int)D);
        cheb_reduce_kernel<<<(unsigned int)B, kThreads, 0, st>>>(part, mu, B, nblk, m, M);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    return 0;
}

template <int S>
static int recursion(const int* cols, const cplx* vals, const double* ab, cplx* buf, int64_t nsta,
                     int64_t D, int64_t B, int64_t ld, int64_t slot, int64_t count,
                     cudaStream_t st) {
    const StepShape sh = step_shape(nsta, B);
    for (int64_t k = 1; k < count; ++k) {
        cplx* tn = buf + k * slot;
        const cplx* tc = buf + (k - 1) * slot;
        if (k == 1)
            step<S, true, false>(sh, st, cols, vals, ab, nullptr, tc, tn, nullptr, nsta, B, ld, (int)D);
        else
            step<S, false, false>(sh, st, cols, vals, ab, buf + (k - 2) * slot, tc, tn, nullptr,
                                  nsta, B, ld, (int)D);
        cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    return 0;
}

// Moments mode.  work (2, nsta, B): slot 0 holds T_0 on entry (it is
// overwritten); part (2, 1024, B) scratch; mu (M, B) with mu[0] filled.
extern "C" int pythtb_cheb_moments(const void* cols, const void* vals, const void* ab, void* work,
                                   void* part, void* mu, int64_t norb, int64_t D, int64_t nspin,
                                   int64_t B, int64_t M, void* stream) {
    const int64_t nsta = norb * nspin;
    if (M < 2 || nsta * B == 0) return 0;
    if (nspin == 2)
        return moments<2>((const int*)cols, (const cplx*)vals, (const double*)ab, (cplx*)work,
                          (double*)part, (double*)mu, nsta, D, B, M, (cudaStream_t)stream);
    return moments<1>((const int*)cols, (const cplx*)vals, (const double*)ab, (cplx*)work,
                      (double*)part, (double*)mu, nsta, D, B, M, (cudaStream_t)stream);
}

// Recursion-only mode: slots 1 .. count-1 of buf from slot 0.
extern "C" int pythtb_cheb_recursion(const void* cols, const void* vals, const void* ab, void* buf,
                                     int64_t norb, int64_t D, int64_t nspin, int64_t B, int64_t ld,
                                     int64_t slot, int64_t count, void* stream) {
    const int64_t nsta = norb * nspin;
    if (nsta * B == 0) return 0;
    if (nspin == 2)
        return recursion<2>((const int*)cols, (const cplx*)vals, (const double*)ab, (cplx*)buf,
                            nsta, D, B, ld, slot, count, (cudaStream_t)stream);
    return recursion<1>((const int*)cols, (const cplx*)vals, (const double*)ab, (cplx*)buf, nsta,
                        D, B, ld, slot, count, (cudaStream_t)stream);
}
