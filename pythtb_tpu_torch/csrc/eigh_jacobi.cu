// Kernel 7: batched Hermitian eigensolver by cyclic two-sided complex
// Jacobi, for 1 <= m <= 64.
//
// Replaces pythtb_tpu/ops/eigh.py:eigh_batched / eigvalsh_batched at
// m > 2, which hand the batch to XLA's eigh (jnp.linalg.eigh, which
// symmetrizes its input).  Output as there: eigenvalues ascending, and
// eigenvectors as ROWS (v[b, s, :] is state s).
//
// Algorithm (the plain version ops/eigh.py:_eigh_jacobi_plain runs the
// same schedule and the same formulas):
//   * A = (H + H^H) / 2, its diagonal exactly real; V = I.
//   * Round-robin (Brent-Luk) order over n = m rounded up to even
//     indices: step r pairs position k with position n-1-k, where
//     position i holds index 0 for i = 0 and 1 + (i - 1 + r) mod (n - 1)
//     otherwise; n/2 disjoint pairs a step, n - 1 steps a sweep, every
//     pair once.  A pair holding the dummy index m (odd m) is skipped.
//   * Rotation of pair (p < q) with b = A_pq = |b| e^{i phi}:
//     tau = (A_qq - A_pp) / (2 |b|), t = sgn(tau) / (|tau| + hypot(1, tau))
//     (sgn(0) = +1), c = 1 / sqrt(1 + t^2), s = t c; with
//     G = [[c, s], [-s e^{-i phi}, c e^{-i phi}]] on (p, q):
//       rows    A_p <- c A_p - s e^{i phi} A_q,   A_q <- s A_p + c e^{i phi} A_q
//       columns A_p <- c A_p - s e^{-i phi} A_q,  A_q <- s A_p + c e^{-i phi} A_q
//     and the pair's 2 x 2 block is then set exactly to
//     diag(A_pp - t |b|, A_qq + t |b|).  V's columns rotate as A's.
//     b == 0 leaves the pair alone; a b negligible beside both diagonal
//     entries (fl(100 |b| + |A_pp|) == |A_pp| and the same for A_qq,
//     Rutishauser's rule) is set to 0 without a rotation, which keeps
//     tau from overflowing once a pair has converged to underflow.
//   * A sweep starts with off(A)^2 = sum_{i != j} |A_ij|^2; the block stops
//     once off(A)^2 <= (tol ||A||_F)^2 (||A||_F is invariant, taken at the
//     load).  After max_sweeps sweeps without that, flag[b] = 1 and the
//     wrapper raises: an unconverged matrix is never returned quietly.
//   * Eigenvalues sorted ascending by rank (ties by index, a stable sort).
//
// What bounds it on the H100: operations at large m, bytes at small m.  A
// sweep costs about (m - 1) (m / 2) rotations of 2m (rows and columns of
// A) plus m (V) complex pairs, ~48 m^3 float64 operations; ~8-10 sweeps
// converge a random matrix (quadratic convergence at the end), so ~400-500
// m^3 per matrix, against ~36 m^3 for a Householder-tridiagonal
// eigensolve with vectors, which sets the bound that chip_smoke.py
// reports.  A and V sit in dynamic shared memory (2 m ld x 16 B, 130 KiB
// at m 64; the limit is raised per launch), their rows ld = m | 1 elements
// apart: with an even stride the eight threads of a 16-byte access phase
// that walk a column (i, p), i = 0..7, hit the same four banks (an 8-way
// conflict at m 40); an odd stride spreads them over all 32.  Two designs
// (ops/eigh.py:_jacobi_design chooses):
//   block  one block per matrix; per step one thread per pair computes the
//          rotation, a barrier, the row updates, a barrier, the column
//          updates of A and V, a barrier.  The latency of three barriers a
//          step over ~10 (m - 1) steps, not the arithmetic, is what it
//          spends its time on.
//   team   m <= 16: a team of T lanes per matrix, T the power of two >=
//          n/2, one lane a rotation pair, the teams packed into warps (16
//          matrices a warp at m 4, 4 at m 16): each lane computes its
//          pair's rotation and updates the pair's two rows of A -- the
//          pairs' rows are disjoint, so no barrier sits between the two --
//          then __syncwarp(team), the pair's two columns of A and V, and
//          __syncwarp(team).  No block barrier: a team leaves its loop at
//          its own sweep.  off(A)^2 is an xor butterfly over the team with
//          lane 0's sum broadcast before the team-uniform branch (the
//          butterfly's sums may differ in the last bit between lanes).  It
//          wins where a batch of up to 12 states fills the card with its
//          warps; above 16 states the block design won at every batch
//          measured (PERF.md section 6).
#include <algorithm>

#include "common.cuh"

constexpr int kJacobiMaxM = 64;
constexpr int kJacobiMaxPairs = kJacobiMaxM / 2;
constexpr int kTeamMaxM = 16;  // the team design's most states (8 lanes a team)

__device__ __forceinline__ int rr_index(int i, int r, int n) {
    return i == 0 ? 0 : 1 + (i - 1 + r) % (n - 1);
}

// block-wide sum of one double per thread (blockDim.x a multiple of 32)
__device__ double block_sum(double x, double* red) {
    for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    __syncthreads();  // red may still be read by a previous call
    if (lane == 0) red[warp] = x;
    __syncthreads();
    double total = 0.0;
    const int nw = blockDim.x >> 5;
    for (int i = 0; i < nw; ++i) total += red[i];
    return total;
}

__global__ void eigh_jacobi_kernel(const cplx* __restrict__ H, double* __restrict__ w,
                                   cplx* __restrict__ v, int* __restrict__ flag, int m, bool vectors,
                                   double tol, int max_sweeps) {
    extern __shared__ cplx smem[];
    const int ld = m | 1;  // odd row stride: conflict-free column walks
    cplx* A = smem;
    cplx* V = smem + m * ld;  // only with vectors
    __shared__ int sp[kJacobiMaxPairs], sq[kJacobiMaxPairs];
    __shared__ double sc[kJacobiMaxPairs], ss[kJacobiMaxPairs], sdp[kJacobiMaxPairs], sdq[kJacobiMaxPairs];
    __shared__ cplx sph[kJacobiMaxPairs];
    __shared__ int srot[kJacobiMaxPairs];
    __shared__ int srank[kJacobiMaxM];
    __shared__ double red[32];

    const int64_t b = blockIdx.x;
    const cplx* h = H + b * m * m;
    const int tid = threadIdx.x, nt = blockDim.x;
    const int mm = m * m;

    double part = 0.0;
    for (int e = tid; e < mm; e += nt) {
        const int i = e / m, j = e - i * m;
        const cplx x = h[e], y = h[j * m + i];
        cplx a = make_cuDoubleComplex(0.5 * (x.x + y.x), 0.5 * (x.y - y.y));
        if (i == j) a.y = 0.0;
        A[i * ld + j] = a;
        part += a.x * a.x + a.y * a.y;
        if (vectors) V[i * ld + j] = make_cuDoubleComplex(i == j ? 1.0 : 0.0, 0.0);
    }
    const double fro2 = block_sum(part, red);
    const double limit = tol * tol * fro2;

    const int n = m + (m & 1);
    const int np = n / 2;
    for (int sweep = 0;; ++sweep) {
        part = 0.0;
        for (int e = tid; e < mm; e += nt) {
            const int i = e / m, j = e - i * m;
            const cplx a = A[i * ld + j];
            if (i != j) part += a.x * a.x + a.y * a.y;
        }
        const double off2 = block_sum(part, red);
        if (off2 <= limit) break;
        if (sweep == max_sweeps) {
            if (tid == 0) flag[b] = 1;
            break;
        }
        for (int r = 0; r < n - 1; ++r) {
            if (tid < np) {
                const int i0 = rr_index(tid, r, n), i1 = rr_index(n - 1 - tid, r, n);
                const int p = min(i0, i1), q = max(i0, i1);
                int rot = 0;
                double c = 1.0, s = 0.0, dp = 0.0, dq = 0.0;
                cplx ph = make_cuDoubleComplex(1.0, 0.0);
                if (q < m) {
                    const double app = A[p * ld + p].x, aqq = A[q * ld + q].x;
                    const cplx apq = A[p * ld + q];
                    const double absb = hypot(apq.x, apq.y);
                    // a pair negligible beside both diagonal entries is
                    // zeroed without rotating (uncontracted, as the plain
                    // version rounds it)
                    const double nb = __dmul_rn(100.0, absb);
                    rot = absb > 0.0;
                    dp = app;
                    dq = aqq;
                    if (rot && !(__dadd_rn(nb, fabs(app)) == fabs(app) && __dadd_rn(nb, fabs(aqq)) == fabs(aqq))) {
                        ph = make_cuDoubleComplex(apq.x / absb, apq.y / absb);
                        const double tau = (aqq - app) / (2.0 * absb);
                        const double t = (tau >= 0.0 ? 1.0 : -1.0) / (fabs(tau) + hypot(1.0, tau));
                        c = 1.0 / sqrt(1.0 + t * t);
                        s = t * c;
                        dp = app - t * absb;
                        dq = aqq + t * absb;
                    }
                }
                sp[tid] = p;
                sq[tid] = q;
                sc[tid] = c;
                ss[tid] = s;
                sph[tid] = ph;
                sdp[tid] = dp;
                sdq[tid] = dq;
                srot[tid] = rot;
            }
            __syncthreads();
            // rows p, q of every rotated pair: G^H A
            for (int e = tid; e < np * m; e += nt) {
                const int k = e / m, j = e - k * m;
                if (!srot[k]) continue;
                const int p = sp[k], q = sq[k];
                const double c = sc[k], s = ss[k];
                const cplx ph = sph[k];
                const cplx ap = A[p * ld + j], aq = A[q * ld + j];
                // e^{i phi} A_q
                const double ur = ph.x * aq.x - ph.y * aq.y, ui = ph.x * aq.y + ph.y * aq.x;
                A[p * ld + j] = make_cuDoubleComplex(c * ap.x - s * ur, c * ap.y - s * ui);
                A[q * ld + j] = make_cuDoubleComplex(s * ap.x + c * ur, s * ap.y + c * ui);
            }
            __syncthreads();
            // columns p, q of every rotated pair: (G^H A) G, and V G; the
            // pair's own 2 x 2 block is set exactly
            for (int e = tid; e < np * m; e += nt) {
                const int k = e / m, i = e - k * m;
                if (!srot[k]) continue;
                const int p = sp[k], q = sq[k];
                const double c = sc[k], s = ss[k];
                const cplx ph = sph[k];
                if (i == p) {
                    A[p * ld + p] = make_cuDoubleComplex(sdp[k], 0.0);
                    A[p * ld + q] = make_cuDoubleComplex(0.0, 0.0);
                } else if (i == q) {
                    A[q * ld + p] = make_cuDoubleComplex(0.0, 0.0);
                    A[q * ld + q] = make_cuDoubleComplex(sdq[k], 0.0);
                } else {
                    const cplx ap = A[i * ld + p], aq = A[i * ld + q];
                    // e^{-i phi} A_q
                    const double ur = ph.x * aq.x + ph.y * aq.y, ui = ph.x * aq.y - ph.y * aq.x;
                    A[i * ld + p] = make_cuDoubleComplex(c * ap.x - s * ur, c * ap.y - s * ui);
                    A[i * ld + q] = make_cuDoubleComplex(s * ap.x + c * ur, s * ap.y + c * ui);
                }
                if (vectors) {
                    const cplx vp = V[i * ld + p], vq = V[i * ld + q];
                    const double ur = ph.x * vq.x + ph.y * vq.y, ui = ph.x * vq.y - ph.y * vq.x;
                    V[i * ld + p] = make_cuDoubleComplex(c * vp.x - s * ur, c * vp.y - s * ui);
                    V[i * ld + q] = make_cuDoubleComplex(s * vp.x + c * ur, s * vp.y + c * ui);
                }
            }
            __syncthreads();
        }
    }

    // ascending order by rank; ties keep index order (a stable sort)
    for (int i = tid; i < m; i += nt) {
        const double di = A[i * ld + i].x;
        int rank = 0;
        for (int j = 0; j < m; ++j) {
            const double dj = A[j * ld + j].x;
            rank += (dj < di) || (dj == di && j < i);
        }
        srank[i] = rank;
        w[b * m + rank] = di;
    }
    if (!vectors) return;
    __syncthreads();
    // state rank[i] is column i of V: v[b, rank[i], f] = V[f, i]
    for (int e = tid; e < mm; e += nt) {
        const int i = e / m, f = e - i * m;
        v[(b * m + srank[i]) * m + f] = V[f * ld + i];
    }
}

// Sum over a team of T lanes (a power of two, aligned in the warp), lane
// 0's sum in every lane.
template <int T>
__device__ __forceinline__ double team_sum(double x, unsigned mask) {
#pragma unroll
    for (int off = T / 2; off > 0; off >>= 1) x += __shfl_xor_sync(mask, x, off, T);
    return __shfl_sync(mask, x, 0, T);
}

// Complex entries of one matrix's slot in the team design's shared memory:
// A, V (with vectors) and the m ints of the sort, rounded up to entries.
static __host__ __device__ int team_slot(int m, bool vectors) {
    return (vectors ? 2 : 1) * m * (m | 1) + (m + 3) / 4;
}

template <int T>
__global__ void eigh_jacobi_team_kernel(const cplx* __restrict__ H, double* __restrict__ w,
                                        cplx* __restrict__ v, int* __restrict__ flag, int64_t B, int m,
                                        bool vectors, double tol, int max_sweeps) {
    extern __shared__ __align__(16) double smem_team[];
    const int lane = threadIdx.x & (T - 1);
    const int team = threadIdx.x / T;
    const int64_t b = (int64_t)blockIdx.x * (blockDim.x / T) + team;
    if (b >= B) return;  // the whole team
    const unsigned mask = (unsigned)((1ull << T) - 1ull) << ((threadIdx.x & 31) & ~(T - 1));
    const int ld = m | 1;
    cplx* A = (cplx*)smem_team + (size_t)team * team_slot(m, vectors);
    cplx* V = A + m * ld;  // only with vectors
    int* inv = (int*)(A + (vectors ? 2 : 1) * m * ld);
    const cplx* h = H + b * m * m;
    const int mm = m * m;

    double part = 0.0;
    for (int e = lane; e < mm; e += T) {
        const int i = e / m, j = e - i * m;
        const cplx x = h[e], y = h[j * m + i];
        cplx a = make_cuDoubleComplex(0.5 * (x.x + y.x), 0.5 * (x.y - y.y));
        if (i == j) a.y = 0.0;
        A[i * ld + j] = a;
        part += a.x * a.x + a.y * a.y;
        if (vectors) V[i * ld + j] = make_cuDoubleComplex(i == j ? 1.0 : 0.0, 0.0);
    }
    const double limit = tol * tol * team_sum<T>(part, mask);
    __syncwarp(mask);

    const int n = m + (m & 1);
    const int np = n / 2;
    for (int sweep = 0;; ++sweep) {
        part = 0.0;
        for (int e = lane; e < mm; e += T) {
            const int i = e / m, j = e - i * m;
            const cplx a = A[i * ld + j];
            if (i != j) part += a.x * a.x + a.y * a.y;
        }
        const double off2 = team_sum<T>(part, mask);
        if (off2 <= limit) break;
        if (sweep == max_sweeps) {
            if (lane == 0) flag[b] = 1;
            break;
        }
        for (int r = 0; r < n - 1; ++r) {
            int p = 0, q = 0;
            bool rot = false;
            double c = 1.0, s = 0.0, dp = 0.0, dq = 0.0;
            cplx ph = make_cuDoubleComplex(1.0, 0.0);
            if (lane < np) {
                const int i0 = rr_index(lane, r, n), i1 = rr_index(n - 1 - lane, r, n);
                p = min(i0, i1);
                q = max(i0, i1);
                if (q < m) {
                    const double app = A[p * ld + p].x, aqq = A[q * ld + q].x;
                    const cplx apq = A[p * ld + q];
                    const double absb = hypot(apq.x, apq.y);
                    // a pair negligible beside both diagonal entries is
                    // zeroed without rotating (uncontracted, as the plain
                    // version rounds it)
                    const double nb = __dmul_rn(100.0, absb);
                    rot = absb > 0.0;
                    dp = app;
                    dq = aqq;
                    if (rot && !(__dadd_rn(nb, fabs(app)) == fabs(app) && __dadd_rn(nb, fabs(aqq)) == fabs(aqq))) {
                        ph = make_cuDoubleComplex(apq.x / absb, apq.y / absb);
                        const double tau = (aqq - app) / (2.0 * absb);
                        const double t = (tau >= 0.0 ? 1.0 : -1.0) / (fabs(tau) + hypot(1.0, tau));
                        c = 1.0 / sqrt(1.0 + t * t);
                        s = t * c;
                        dp = app - t * absb;
                        dq = aqq + t * absb;
                    }
                }
            }
            // rows p, q: G^H A (no other lane reads or writes these rows now)
            if (rot) {
                cplx* Ap = A + p * ld;
                cplx* Aq = A + q * ld;
#pragma unroll 4
                for (int j = 0; j < m; ++j) {
                    const cplx ap = Ap[j], aq = Aq[j];
                    const double ur = ph.x * aq.x - ph.y * aq.y, ui = ph.x * aq.y + ph.y * aq.x;
                    Ap[j] = make_cuDoubleComplex(c * ap.x - s * ur, c * ap.y - s * ui);
                    Aq[j] = make_cuDoubleComplex(s * ap.x + c * ur, s * ap.y + c * ui);
                }
            }
            __syncwarp(mask);
            // columns p, q: (G^H A) G and V G; the pair's block set exactly
            if (rot) {
#pragma unroll 4
                for (int i = 0; i < m; ++i) {
                    if (i == p) {
                        A[p * ld + p] = make_cuDoubleComplex(dp, 0.0);
                        A[p * ld + q] = make_cuDoubleComplex(0.0, 0.0);
                    } else if (i == q) {
                        A[q * ld + p] = make_cuDoubleComplex(0.0, 0.0);
                        A[q * ld + q] = make_cuDoubleComplex(dq, 0.0);
                    } else {
                        const cplx ap = A[i * ld + p], aq = A[i * ld + q];
                        const double ur = ph.x * aq.x + ph.y * aq.y, ui = ph.x * aq.y - ph.y * aq.x;
                        A[i * ld + p] = make_cuDoubleComplex(c * ap.x - s * ur, c * ap.y - s * ui);
                        A[i * ld + q] = make_cuDoubleComplex(s * ap.x + c * ur, s * ap.y + c * ui);
                    }
                    if (vectors) {
                        const cplx vp = V[i * ld + p], vq = V[i * ld + q];
                        const double ur = ph.x * vq.x + ph.y * vq.y, ui = ph.x * vq.y - ph.y * vq.x;
                        V[i * ld + p] = make_cuDoubleComplex(c * vp.x - s * ur, c * vp.y - s * ui);
                        V[i * ld + q] = make_cuDoubleComplex(s * vp.x + c * ur, s * vp.y + c * ui);
                    }
                }
            }
            __syncwarp(mask);
        }
    }

    // ascending order by rank; ties keep index order (a stable sort)
    for (int i = lane; i < m; i += T) {
        const double di = A[i * ld + i].x;
        int rank = 0;
        for (int j = 0; j < m; ++j) {
            const double dj = A[j * ld + j].x;
            rank += (dj < di) || (dj == di && j < i);
        }
        w[b * m + rank] = di;
        if (vectors) inv[rank] = i;
    }
    if (!vectors) return;
    __syncwarp(mask);
    // state r is column inv[r] of V: v[b, r, f] = V[f, inv[r]]
    for (int e = lane; e < mm; e += T) {
        const int r = e / m, f = e - r * m;
        v[b * mm + e] = V[f * ld + inv[r]];
    }
}

// the team design's shared memory a block: at most this much, at least one warp
constexpr int kTeamBlockSmem = 48 * 1024;
constexpr int kTeamMaxWarps = 8;

// H (B, m, m) complex128 -> w (B, m) float64 ascending and, with vectors,
// v (B, m, m) row eigenvectors; flag (B,) int32, zeroed by the caller, is
// set to 1 for every matrix that did not converge in max_sweeps sweeps.
// design 0: a block a matrix; 1: a team of lanes a matrix.
extern "C" int pythtb_eigh_jacobi(const void* H, void* w, void* v, void* flag, int64_t B, int64_t m,
                                  int64_t vectors, double tol, int64_t max_sweeps, int64_t design, void* stream) {
    if (B == 0) return 0;
    if (m < 1 || m > (design == 1 ? kTeamMaxM : kJacobiMaxM) || max_sweeps < 0 || design < 0 || design > 1)
        return (int)cudaErrorInvalidValue;
    cudaError_t err;
    if (design == 1) {
        const int np = (int)(m + (m & 1)) / 2;
        int T = 1;
        while (T < np) T *= 2;
        const size_t slot = (size_t)team_slot((int)m, vectors != 0) * sizeof(cplx);
        const size_t per_warp = slot * (32 / T);
        const int warps = (int)std::max<size_t>(1, std::min<size_t>(kTeamMaxWarps, kTeamBlockSmem / per_warp));
        const int64_t per_block = (int64_t)warps * (32 / T);
        const size_t smem = (size_t)per_block * slot;
        const unsigned int blocks = (unsigned int)((B + per_block - 1) / per_block);
#define TEAM(K)                                                                                             \
    case K:                                                                                                 \
        err = cudaFuncSetAttribute(eigh_jacobi_team_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, \
                                   (int)smem);                                                              \
        if (err != cudaSuccess) return (int)err;                                                            \
        eigh_jacobi_team_kernel<K><<<blocks, 32 * warps, smem, (cudaStream_t)stream>>>(                     \
            (const cplx*)H, (double*)w, (cplx*)v, (int*)flag, B, (int)m, vectors != 0, tol, (int)max_sweeps); \
        break;
        switch (T) {
            TEAM(1)
            TEAM(2)
            TEAM(4)
            TEAM(8)
            default:
                return (int)cudaErrorInvalidValue;
        }
#undef TEAM
        return (int)cudaGetLastError();
    }
    cudaFuncAttributes fa;
    err = cudaFuncGetAttributes(&fa, eigh_jacobi_kernel);
    if (err != cudaSuccess) return (int)err;
    const int n = (int)(m + (m & 1));
    // about four row or column items a thread, at least the n/2 pair threads
    const int want = std::max<int>(32, ((n / 2) * (int)m / 4 + 31) / 32 * 32);
    const int nt = std::min<int>(fa.maxThreadsPerBlock / 32 * 32, want);
    if (nt < n / 2) return (int)cudaErrorInvalidConfiguration;
    const size_t smem = (size_t)(vectors ? 2 : 1) * m * (m | 1) * sizeof(cplx);
    err = cudaFuncSetAttribute(eigh_jacobi_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    eigh_jacobi_kernel<<<(unsigned int)B, (unsigned int)nt, smem, (cudaStream_t)stream>>>(
        (const cplx*)H, (double*)w, (cplx*)v, (int*)flag, (int)m, vectors != 0, tol, (int)max_sweeps);
    return (int)cudaGetLastError();
}
