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
// What bounds it on the H100: the operations -- a weight (an exp and a
// division for most kinds) for every (mu, t), then P multiply-adds; G (P T
// doubles, 67 MB at Boltzmann 512^2, more than the 50 MB L2) is read once.
// Design: the grid splits t into chunks (ops/fermi_sweep.py:_sweep_layout:
// about four blocks an SM), and a block takes a chunk, a group of up to
// kMaxCols slots -- G's rows sorted by power, each aligned run of kRun slots
// of one power -- and up to kSweepMaxMu chemical potentials, a thread each.
// It streams its chunk's E and G through shared memory in tiles of
// kSweepTile t, the next tile in flight by cp.async while the current one is
// swept; every thread reads the same t at once (a broadcast), forms its
// weight once, picks its power once a run, and adds it into a register sum
// for every slot.  So each element of G leaves device memory once and each
// weight is computed once per (mu, t) and slot group (once wherever the
// slots number at most 16: every caller but 3-D Boltzmann).
// The blocks write their sums to a fixed scratch layout (chunk, mu, slot); a
// second launch adds the chunks in chunk order, so two calls give the same
// bits.  The (M, B, S) arrays of the JAX programs (843 MB each at Boltzmann
// 512^2, M 201) are never formed.
#include "common.cuh"

constexpr int kSweepTile = 128;    // t a shared-memory tile
constexpr int kSweepMaxMu = 256;   // chemical potentials (threads) a block
constexpr int kMaxCols = 16;       // columns a block

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

// The weight of kind kKind at d = E - mu; inv_kt = 1 / kT, a
// multiplication where the plain version divides.
template <int kKind>
__device__ __forceinline__ double sweep_weight(double d, double inv_kt) {
    if constexpr (kKind == 0) {
        return d <= 0.0 ? 1.0 : 0.0;
    } else {
        const double x = d * inv_kt;
        if constexpr (kKind == 1) {
            return fermi_f(x);
        } else if constexpr (kKind == 2) {
            return x * fermi_f(x) + softplus_neg(x);
        } else if constexpr (kKind == 3) {
            // the closed form at |x| (every term bounded by pi^2/6), then
            // the reflection W(-x) = pi^2/3 - W(x); the clip keeps e^-x finite
            const double xa = fabs(x);
            const double w = xa * xa * fermi_f(xa) + 2.0 * xa * softplus_neg(xa) -
                             2.0 * spence(1.0 + exp(-fmin(xa, 30.0)));
            return x < 0.0 ? 3.2898681336964528729448303332920 - w : w;
        } else if constexpr (kKind == 4) {
            const double e = exp(-fabs(x));
            return e * inv_kt / ((1.0 + e) * (1.0 + e));
        } else {
            return exp(-0.5 * x * x) * (inv_kt * 0.39894228040143267793994605993438);  // 1 / sqrt(2 pi)
        }
    }
}

// One staged tile: n terms, each weighed once for the thread's mu and
// added, times the run's power of E - mu, into every slot's sum.  The kind
// is a template parameter of the kernel: one instance a kind keeps each
// instance's registers to its own weight (more blocks an SM).
template <int kKind, int kCols, int kRuns>
__device__ __forceinline__ void sweep_tile(const double* __restrict__ Es, const double2* __restrict__ Gs, int n,
                                           double mu, double inv_kt, const int (&jr)[kRuns], double (&acc)[kCols]) {
    constexpr int kPairs = kCols / kRuns / 2;  // pairs of slots a run
#pragma unroll 2
    for (int tt = 0; tt < n; ++tt) {
        const double d = Es[tt] - mu;
        const double w0 = sweep_weight<kKind>(d, inv_kt);
        const double w1 = w0 * d, w2 = w1 * d;
#pragma unroll
        for (int r = 0; r < kRuns; ++r) {
            const double wr = jr[r] == 0 ? w0 : (jr[r] == 1 ? w1 : w2);
#pragma unroll
            for (int h = 0; h < kPairs; ++h) {
                const int q = r * kPairs + h;
                const double2 g = Gs[q * kSweepTile + tt];
                acc[2 * q] += g.x * wr;
                acc[2 * q + 1] += g.y * wr;
            }
        }
    }
}

// Block (chunk c, slot group g, mu block b): threads m = b blockDim + tid
// over mu, the slots [g kCols, g kCols + kCols) -- G's rows in an order
// the wrapper lays out (ops/fermi_sweep.py:_sweep_layout): sorted by power,
// each aligned run of kRun slots of one power, -1 for a slot of zeros --
// and t over [c chunk, c chunk + chunk) in tiles staged by cp.async in two
// buffers, each of kSweepTile E values and the slots' G values (pairs of
// slots interleaved, so a thread reads two at once).  One select of the
// weight's power serves a run.  Sums into part[(c M + m) nslots + slot].
constexpr int kRun = 4;

template <int kCols, int kKind>
__global__ void __launch_bounds__(kSweepMaxMu)
fermi_sweep_chunk_kernel(const double* __restrict__ E, const double* __restrict__ G, const int* __restrict__ slots,
                         const int* __restrict__ rpow, const double* __restrict__ mu, double* __restrict__ part,
                         int64_t T, int M, int nslots, int64_t chunk, double inv_kt) {
    constexpr int kStage = kSweepTile * (kCols + 1);  // doubles a buffer
    extern __shared__ __align__(16) double smem[];
    const int tid = threadIdx.x, nt = blockDim.x;
    const int64_t c = blockIdx.x;
    const int s0 = blockIdx.y * kCols;
    const int m = blockIdx.z * nt + tid;
    const double mu_m = mu[min(m, M - 1)];
    int jr[kCols / kRun];
#pragma unroll
    for (int r = 0; r < kCols / kRun; ++r) jr[r] = rpow[s0 / kRun + r];
    double acc[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[j] = 0.0;
    const int64_t t0 = c * chunk, t1 = min(T, t0 + chunk);
    const int tiles = (int)((t1 - t0 + kSweepTile - 1) / kSweepTile);
    auto stage = [&](int k) {
        double* Es = smem + (k & 1) * kStage;
        double* Gs = Es + kSweepTile;
        const int64_t ts = t0 + (int64_t)k * kSweepTile;
        const int n = (int)min((int64_t)kSweepTile, t1 - ts);
        for (int e = tid; e < kSweepTile; e += nt) cp_async8(Es + e, e < n ? E + ts + e : E, e < n);
        for (int e = tid; e < kCols * kSweepTile; e += nt) {
            const int j = e / kSweepTile, tt = e - j * kSweepTile;
            const int row = slots[s0 + j];
            const bool ok = row >= 0 && tt < n;
            cp_async8(Gs + 2 * ((j >> 1) * kSweepTile + tt) + (j & 1), ok ? G + (int64_t)row * T + ts + tt : G, ok);
        }
        cp_async_commit();
    };
    stage(0);
    for (int k = 0; k < tiles; ++k) {
        if (k + 1 < tiles)
            stage(k + 1);
        else
            cp_async_commit();
        cp_async_wait<1>();
        __syncthreads();
        const double* Es = smem + (k & 1) * kStage;
        const double2* Gs = (const double2*)(Es + kSweepTile);
        const int n = (int)min((int64_t)kSweepTile, t1 - t0 - (int64_t)k * kSweepTile);
        sweep_tile<kKind>(Es, Gs, n, mu_m, inv_kt, jr, acc);
        __syncthreads();  // the buffer is read out before the next tile's copies refill it
    }
    if (m < M) {
        double* out = part + ((int64_t)c * M + m) * nslots + s0;
#pragma unroll
        for (int j = 0; j < kCols; ++j) out[j] = acc[j];
    }
}

// out[m, slots[s]] = the chunks' sums part[c M nslots + m nslots + s] added
// in chunk order (none for a slot of zeros): a block takes 32 (m, s)
// entries, eight lanes each adding every eighth chunk, then the eight
// partial sums in lane order.
__global__ void __launch_bounds__(256)
fermi_sweep_sum_kernel(const double* __restrict__ part, const int* __restrict__ slots, double* __restrict__ out,
                       int64_t chunks, int64_t M, int nslots, int P) {
    __shared__ double red[8][32];
    const int j = threadIdx.x, lane = threadIdx.y;
    const int64_t MS = M * nslots;
    const int64_t e = (int64_t)blockIdx.x * 32 + j;
    double sum = 0.0;
    if (e < MS)
        for (int64_t c = lane; c < chunks; c += 8) sum += part[c * MS + e];
    red[lane][j] = sum;
    __syncthreads();
    if (lane == 0 && e < MS) {
        const int col = slots[e % nslots];
        double r = red[0][j];
#pragma unroll
        for (int k = 1; k < 8; ++k) r += red[k][j];
        if (col >= 0) out[(e / nslots) * P + col] = r;
    }
}

// Kernel 17.  E (T,) f64; G (P, T) f64; slots (nslots,) i32 and rpow
// (nslots / kRun,) i32, the wrapper's layout of G's rows and their powers
// in {0, 1, 2}; mu (M,) f64; part (chunks M nslots) f64 scratch; out (M,
// P) f64.  kind as above; kT > 0 unless kind 0.  The launch layout
// (ops/fermi_sweep.py:_sweep_layout): t chunks of `chunk` (a multiple of
// kSweepTile), slot groups of `cols` (4, 8 or 16; nslots a multiple) and
// mu blocks of `threads` (a multiple of 32, at most kSweepMaxMu).
extern "C" int pythtb_fermi_sweep(const void* E, const void* G, const void* slots, const void* rpow, const void* mu,
                                  void* part, void* out, int64_t T, int64_t P, int64_t M, int64_t nslots,
                                  int64_t chunk, int64_t cols, int64_t threads, double kt, int64_t kind,
                                  void* stream) {
    if (M <= 0 || P <= 0) return (int)cudaGetLastError();
    if (chunk < 1 || chunk % kSweepTile || threads < 32 || threads > kSweepMaxMu || threads % 32 || cols < kRun ||
        nslots % cols || kind < 0 || kind > 5)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    const int64_t chunks = (T + chunk - 1) / chunk;
    if (chunks > 0) {
        const dim3 grid((unsigned int)chunks, (unsigned int)(nslots / cols),
                        (unsigned int)((M + threads - 1) / threads));
        const size_t bytes = 2 * (size_t)kSweepTile * (cols + 1) * sizeof(double);
        const double inv_kt = kind == 0 ? 0.0 : 1.0 / kt;
#define SWEEP(K, KIND)                                                                                     \
    fermi_sweep_chunk_kernel<K, KIND><<<grid, (unsigned int)threads, bytes, st>>>(                         \
        (const double*)E, (const double*)G, (const int*)slots, (const int*)rpow, (const double*)mu,            \
        (double*)part, T, (int)M, (int)nslots, chunk, inv_kt)
#define KINDS(K)                                      \
    switch (kind) {                                   \
        case 0: SWEEP(K, 0); break;                   \
        case 1: SWEEP(K, 1); break;                   \
        case 2: SWEEP(K, 2); break;                   \
        case 3: SWEEP(K, 3); break;                   \
        case 4: SWEEP(K, 4); break;                   \
        default: SWEEP(K, 5); break;                  \
    }
        switch (cols) {
            case 4: KINDS(4); break;
            case 8: KINDS(8); break;
            case kMaxCols: KINDS(kMaxCols); break;
            default: return (int)cudaErrorInvalidValue;
        }
#undef KINDS
#undef SWEEP
        const int rc = (int)cudaGetLastError();
        if (rc != 0) return rc;
    }
    fermi_sweep_sum_kernel<<<(unsigned int)((M * nslots + 31) / 32), dim3(32, 8), 0, st>>>(
        (const double*)part, (const int*)slots, (double*)out, chunks, M, (int)nslots, (int)P);
    return (int)cudaGetLastError();
}
