// Kernel 17: the Fermi-sweep band sum.
//
// Replaces the (M, B, S) broadcasts and einsums of the chemical-potential
// sweeps: pythtb_tpu/flows.py:_ahc_jit (:1283-1313), _nernst_jit
// (:1365-1375), _thermal_hall_jit with _c2_weight (:1810-1843),
// _dipole_jit (:1377-1399); boltzmann.py:_bt_jit (:100-143), _tdf_jit
// and _edelstein_jit (:269-322); geometry.py:_drude_jit (:587-613).
//
//   out[m, p] = sum_t G[p, t] w_kind((E_t - mu_m) / kT) (E_t - mu_m)^j_p
//
// with j_p in {0, 1, 2} and the weights
//   0 step      1 if E_t - mu_m <= 0 (E == mu counts as occupied)
//   1 fermi     f(x) = 1 / (1 + e^x)
//   2 entropy   x f(x) + ln(1 + e^-x)
//   3 c2        W(x) = int_x^inf y^2 (-df/dy) dy, by the dilogarithm
//   4 -df/de    f (1 - f) / kT, in the stable form e^-|x| / ((1 + e^-|x|)^2 kT)
//   5 gauss     exp(-x^2 / 2) / (kT sqrt(2 pi))
//
// What bounds it on the H100: the bytes of G (P T doubles), which each
// block reads once for its chemical potential.  Design: one block per
// (mu, group of up to kGroup columns); its threads stride over T
// (neighbouring threads read neighbouring t), compute the weight once per
// t in registers, keep one partial sum per column, and reduce them with a
// fixed-order tree in shared memory.  The (M, B, S) arrays of the JAX
// programs (843 MB each at Boltzmann 512^2, M 201) are never formed.
#include "common.cuh"

constexpr int kSweepThreads = 256;
constexpr int kGroup = 8;

__device__ __forceinline__ double fermi_f(double x) {  // 1 / (1 + e^x), stable
    if (x >= 0.0) {
        const double e = exp(-x);
        return e / (1.0 + e);
    }
    return 1.0 / (1.0 + exp(x));
}

__device__ __forceinline__ double softplus_neg(double x) {  // ln(1 + e^-x), stable
    return fmax(-x, 0.0) + log1p(exp(-fabs(x)));
}

__device__ double polevl7(double x, const double* c) {
    double r = c[0];
#pragma unroll
    for (int i = 1; i < 8; ++i) r = r * x + c[i];
    return r;
}

// the Cephes polynomials of spence (numerator, denominator)
__constant__ double kSpenceA[8] = {4.65128586073990045278E-5, 7.31589045238094711071E-3, 1.33847639578309018650E-1,
                                   8.79691311754530315341E-1, 2.71149851196553469920E0,  4.25697156008121755724E0,
                                   3.29771340985225106936E0,  1.00000000000000000126E0};
__constant__ double kSpenceB[8] = {6.90990488912553276999E-4, 2.54043763932544379113E-2, 2.82974860602568089943E-1,
                                   1.41172597751831069617E0,  3.63800533345137075418E0,  5.03278880143316990390E0,
                                   3.54771340985225096217E0,  9.99999999999999998740E-1};

// scipy's spence(x) = int_1^x ln t / (1 - t) dt for x >= 0 (Cephes
// spence.c, the polynomials jax.scipy.special.spence uses); Li2(w) =
// spence(1 - w)
__device__ double spence(double x) {
    const double pi2_6 = 1.6449340668482264364724151666460;
    if (x < 0.0) return nan("");
    if (x == 1.0) return 0.0;
    if (x == 0.0) return pi2_6;
    bool flag1 = false, flag2 = false;
    if (x > 2.0) {
        x = 1.0 / x;
        flag2 = true;
    }
    double w;
    if (x > 1.5) {
        w = 1.0 / x - 1.0;
        flag2 = true;
    } else if (x < 0.5) {
        w = -x;
        flag1 = true;
    } else {
        w = x - 1.0;
    }
    double y = -w * polevl7(w, kSpenceA) / polevl7(w, kSpenceB);
    if (flag1) y = pi2_6 - log(x) * log(1.0 - x) - y;
    if (flag2) {
        const double z = log(x);
        y = -0.5 * z * z - y;
    }
    return y;
}

__device__ double sweep_weight(int kind, double d, double kt) {
    if (kind == 0) return d <= 0.0 ? 1.0 : 0.0;
    const double x = d / kt;
    switch (kind) {
        case 1:
            return fermi_f(x);
        case 2:
            return x * fermi_f(x) + softplus_neg(x);
        case 3: {
            // the closed form at |x| (every term bounded by pi^2/6), then
            // the reflection W(-x) = pi^2/3 - W(x); the clip keeps e^-x finite
            const double xa = fabs(x);
            const double w = xa * xa * fermi_f(xa) + 2.0 * xa * softplus_neg(xa) -
                             2.0 * spence(1.0 + exp(-fmin(xa, 30.0)));
            return x < 0.0 ? 3.2898681336964528729448303332920 - w : w;
        }
        case 4: {
            const double e = exp(-fabs(x));
            return e / ((1.0 + e) * (1.0 + e) * kt);
        }
        default:
            return exp(-0.5 * x * x) / (kt * 2.5066282746310005024157652848110);
    }
}

__global__ void fermi_sweep_kernel(const double* __restrict__ E, const double* __restrict__ G,
                                   const int* __restrict__ jpow, const double* __restrict__ mu,
                                   double* __restrict__ out, int64_t T, int P, double kt, int kind) {
    __shared__ double red[kGroup][kSweepThreads];
    const int m = blockIdx.x;
    const int p0 = blockIdx.y * kGroup;
    const int np = min(kGroup, P - p0);
    const int tid = threadIdx.x;
    const double mu_m = mu[m];
    int jp[kGroup];
    double acc[kGroup];
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
        jp[j] = j < np ? jpow[p0 + j] : 0;
        acc[j] = 0.0;
    }
    for (int64_t t = tid; t < T; t += kSweepThreads) {
        const double d = E[t] - mu_m;
        const double w0 = sweep_weight(kind, d, kt);
        const double w1 = w0 * d;
        const double w2 = w1 * d;
#pragma unroll
        for (int j = 0; j < kGroup; ++j) {
            if (j < np) {
                const double wj = jp[j] == 0 ? w0 : (jp[j] == 1 ? w1 : w2);
                acc[j] += G[(int64_t)(p0 + j) * T + t] * wj;
            }
        }
    }
#pragma unroll
    for (int j = 0; j < kGroup; ++j) red[j][tid] = acc[j];
    __syncthreads();
    for (int s = kSweepThreads / 2; s > 0; s >>= 1) {
        if (tid < s) {
#pragma unroll
            for (int j = 0; j < kGroup; ++j) red[j][tid] += red[j][tid + s];
        }
        __syncthreads();
    }
    if (tid < np) out[(int64_t)m * P + p0 + tid] = red[tid][0];
}

// Kernel 17.  E (T,) f64; G (P, T) f64; jpow (P,) i32 in {0, 1, 2};
// mu (M,) f64; out (M, P) f64.  kind as above; kT > 0 unless kind 0.
extern "C" int pythtb_fermi_sweep(const void* E, const void* G, const void* jpow, const void* mu, void* out,
                                  int64_t T, int64_t P, int64_t M, double kt, int64_t kind, void* stream) {
    if (M > 0 && P > 0) {
        dim3 grid((unsigned int)M, (unsigned int)((P + kGroup - 1) / kGroup));
        fermi_sweep_kernel<<<grid, kSweepThreads, 0, (cudaStream_t)stream>>>(
            (const double*)E, (const double*)G, (const int*)jpow, (const double*)mu, (double*)out, T, (int)P, kt,
            (int)kind);
    }
    return (int)cudaGetLastError();
}
