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
// What bounds it on the H100: operations.  A sweep costs about
// (m - 1) (m / 2) rotations of 2m (rows and columns of A) plus m (V)
// complex pairs, ~48 m^3 float64 operations; ~8-10 sweeps converge a
// random matrix (quadratic convergence at the end), so ~400-500 m^3 per
// matrix, against ~36 m^3 for a Householder-tridiagonal eigensolve with
// vectors, which sets the bound that chip_smoke.py reports.  Design
// (simple first): one block per matrix; A and V in dynamic shared memory
// (2 m ld x 16 B, 130 KiB at m 64; the limit is raised per launch), their
// rows ld = m | 1 elements apart: with an even stride the eight threads of
// a 16-byte access phase that walk a column (i, p), i = 0..7, hit the
// same four banks (an 8-way conflict at m 40); an odd stride spreads them
// over all 32; per
// step one thread per pair computes the rotation, a barrier, the row
// updates, a barrier, the column updates of A and V, a barrier.  The
// latency of three barriers a step over ~10 (m - 1) steps, not the
// arithmetic, is what this first version spends its time on.
#include <algorithm>

#include "common.cuh"

constexpr int kJacobiMaxM = 64;
constexpr int kJacobiMaxPairs = kJacobiMaxM / 2;

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

// H (B, m, m) complex128 -> w (B, m) float64 ascending and, with vectors,
// v (B, m, m) row eigenvectors; flag (B,) int32, zeroed by the caller, is
// set to 1 for every matrix that did not converge in max_sweeps sweeps.
extern "C" int pythtb_eigh_jacobi(const void* H, void* w, void* v, void* flag, int64_t B, int64_t m,
                                  int64_t vectors, double tol, int64_t max_sweeps, void* stream) {
    if (B == 0) return 0;
    if (m < 1 || m > kJacobiMaxM || max_sweeps < 0) return (int)cudaErrorInvalidValue;
    cudaFuncAttributes fa;
    cudaError_t err = cudaFuncGetAttributes(&fa, eigh_jacobi_kernel);
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
