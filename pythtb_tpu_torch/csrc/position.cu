// Kernel 6: position-operator matrices of chosen states.
//
// Replaces pythtb_tpu/ops/position.py:_xmat (inside _pos_matrix_jit,
// _pos_matrix_packed_jit and _hwf_core) and the diagonal-only einsum of
// _pos_expectation_packed_jit, which XLA fused with the state gather:
//   X[b, n, m] = sum_f conj(w[b, occ[n], f]) * pos[f] * w[b, occ[m], f]
// for states w (B, nsta, F), an index array occ (S,) of the chosen states
// and real orbital positions pos (F,).  Full mode writes X (B, S, S)
// complex128; diagonal mode writes only Re X[b, n, n] as (B, S) float64.
//
// What bounds it on the H100: reading the chosen states, B*S*F*16 bytes,
// and writing X, B*S*S*16 bytes, at small S (a slab's or a Wannier set's);
// the S*(S+1)/2*F complex multiply-adds per batch element at large S (a
// flake's or a marker's hundreds of states), at the FP64 tensor cores'
// rate.  The state selection is read through occ, so the chosen states are
// never copied out of the grid.  Any S and F.  Three designs (mode):
//
// 0, threads: one thread per output element (b, n, m) with n <= m -- the
//    upper triangle, addressed in closed form -- loops over F and writes
//    (b, n, m) and its conjugate at (b, m, n), so X is exactly Hermitian,
//    as the eigensolver downstream assumes.
// 1, diagonal: one thread per (b, n).
// 2, tiles: one block per (b, upper-triangle tile I <= J) of kTile x kTile
//    complex entries.  Chunks of kChunk columns of F of both operand
//    panels (the tile's rows and columns of states, gathered through occ,
//    zero past S and F) and of pos go to shared memory through a ring of
//    kStages cp.async buffers; four warps, 2 x 2 over the tile, multiply
//    them on the FP64 tensor cores (mma.sync m16n8k8, an sm_90 shape):
//    with conj(a) pos b = (ar br + ai bi) + i (ar bi - ai br), b times
//    pos (folded in as the B fragments load), four real products a step.  A diagonal tile loads one panel and
//    writes only n <= m; every entry is written with its conjugate
//    mirror, so X stays exactly Hermitian.
#include "common.cuh"

__global__ void position_matrix_kernel(const cplx* __restrict__ w, const double* __restrict__ pos,
                                       const int64_t* __restrict__ occ, cplx* __restrict__ X,
                                       int64_t B, int64_t nsta, int64_t S, int64_t F) {
    const int64_t npairs = S * (S + 1) / 2;
    const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= B * npairs) return;
    const int64_t b = t / npairs;
    const int64_t p = t % npairs;
    // row n of the upper triangle starts at n*S - n*(n-1)/2; estimate n
    // from the quadratic, then correct the rounding
    const double s2 = 2.0 * (double)S + 1.0;
    int64_t n = (int64_t)floor(0.5 * (s2 - sqrt(s2 * s2 - 8.0 * (double)p)));
    if (n < 0) n = 0;
    if (n > S - 1) n = S - 1;
    while (n > 0 && n * S - n * (n - 1) / 2 > p) --n;
    while (n + 1 < S && (n + 1) * S - (n + 1) * n / 2 <= p) ++n;
    const int64_t m = n + (p - (n * S - n * (n - 1) / 2));

    const cplx* wn = w + (b * nsta + occ[n]) * F;
    const cplx* wm = w + (b * nsta + occ[m]) * F;
    double re = 0.0, im = 0.0;
    for (int64_t f = 0; f < F; ++f) {
        const cplx z = cmul_conj(wn[f], wm[f]);
        re += pos[f] * z.x;
        im += pos[f] * z.y;
    }
    // the diagonal is real: x*y - y*x is 0 only without FMA contraction
    if (n == m) im = 0.0;
    cplx* Xb = X + b * S * S;
    Xb[n * S + m] = make_cuDoubleComplex(re, im);
    Xb[m * S + n] = make_cuDoubleComplex(re, -im);
}

__global__ void position_diag_kernel(const cplx* __restrict__ w, const double* __restrict__ pos,
                                     const int64_t* __restrict__ occ, double* __restrict__ out,
                                     int64_t B, int64_t nsta, int64_t S, int64_t F) {
    const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= B * S) return;
    const int64_t b = t / S;
    const int64_t n = t % S;
    const cplx* wn = w + (b * nsta + occ[n]) * F;
    double acc = 0.0;
    for (int64_t f = 0; f < F; ++f) acc += pos[f] * (wn[f].x * wn[f].x + wn[f].y * wn[f].y);
    out[t] = acc;
}

constexpr int kTile = 32;          // output tile edge, complex entries
constexpr int kChunk = 16;         // columns of F a stage
constexpr int kLdk = kChunk + 4;   // staged row stride: = 4 (mod 8), so a fragment's 8-lane phase hits 8 banks
constexpr int kStages = 3;         // chunks in the cp.async ring
constexpr int kTileThreads = 128;  // four warps, 2 x 2 sub-tiles of 16 x 16

// Dynamic shared memory of position_tiles_kernel: the ring's two operand
// panels and pos chunks.
constexpr size_t kTileSmem = kStages * (2 * kTile * kLdk * sizeof(cplx) + kChunk * sizeof(double));

__global__ void __launch_bounds__(kTileThreads)
position_tiles_kernel(const cplx* __restrict__ w, const double* __restrict__ pos, const int64_t* __restrict__ occ,
                      cplx* __restrict__ X, int64_t nsta, int64_t S, int64_t F, int64_t nt) {
    extern __shared__ __align__(16) double smem[];
    cplx* As = (cplx*)smem;                               // [kStages][kTile * kLdk]: the tile's rows
    cplx* Bs = As + kStages * kTile * kLdk;               // [kStages][kTile * kLdk]: its columns
    double* Ps = (double*)(Bs + kStages * kTile * kLdk);  // [kStages][kChunk]
    __shared__ int64_t rowA[kTile], rowB[kTile];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, tg = lane & 3;
    const int wr = warp >> 1, wc = warp & 1;
    // block -> (b, tile pair I <= J); row I of the upper triangle of tiles
    // starts at I*nt - I*(I-1)/2
    const int64_t ntri = nt * (nt + 1) / 2;
    const int64_t b = blockIdx.x / ntri;
    const int64_t p = blockIdx.x % ntri;
    int64_t I = 0;
    while ((I + 1) * nt - (I + 1) * I / 2 <= p) ++I;
    const int64_t J = I + (p - (I * nt - I * (I - 1) / 2));
    const bool diag = I == J;
    if (tid < kTile) {
        const int64_t n = I * kTile + tid;
        rowA[tid] = n < S ? (b * nsta + occ[n]) * F : -1;
    } else if (tid < 2 * kTile) {
        const int64_t m = J * kTile + tid - kTile;
        rowB[tid - kTile] = m < S ? (b * nsta + occ[m]) * F : -1;
    }
    __syncthreads();
    auto load = [&](int buf, int64_t f0) {
        cplx* A = As + buf * kTile * kLdk;
        cplx* B = Bs + buf * kTile * kLdk;
        for (int e = tid; e < kTile * kChunk; e += kTileThreads) {
            const int r = e / kChunk, f = e % kChunk;
            const bool inF = f0 + f < F;
            const int64_t a = rowA[r];
            cp_async16(A + r * kLdk + f, a >= 0 && inF ? w + a + f0 + f : w, a >= 0 && inF);
            if (!diag) {
                const int64_t c = rowB[r];
                cp_async16(B + r * kLdk + f, c >= 0 && inF ? w + c + f0 + f : w, c >= 0 && inF);
            }
        }
        if (tid < kChunk) cp_async8(Ps + buf * kChunk + tid, f0 + tid < F ? pos + f0 + tid : pos, f0 + tid < F);
    };
    // the warp's 16 x 16 sub-tile: n-tiles j = 0, 1 of 8 columns
    double re[2][4] = {}, im[2][4] = {};
    const int64_t nch = (F + kChunk - 1) / kChunk;
    // the ring: chunk ch lands in buffer ch % kStages, kStages - 1 ahead;
    // every thread commits one group an iteration, empty past the end
    for (int s = 0; s < kStages - 1; ++s) {
        if (s < nch) load(s, (int64_t)s * kChunk);
        cp_async_commit();
    }
    for (int64_t ch = 0; ch < nch; ++ch) {
        cp_async_wait<kStages - 2>();
        __syncthreads();
        const int64_t nxt = ch + kStages - 1;
        if (nxt < nch) load((int)(nxt % kStages), nxt * kChunk);
        cp_async_commit();
        const int buf = (int)(ch % kStages);
        const cplx* Ab = As + buf * kTile * kLdk;
        const cplx* Bb = (diag ? As : Bs) + buf * kTile * kLdk;
        const double* Pb = Ps + buf * kChunk;
#pragma unroll
        for (int kb = 0; kb < kChunk; kb += 8) {
            const int k0 = kb + tg, k1 = k0 + 4;
            const int r0 = 16 * wr + g;
            const cplx a0 = Ab[r0 * kLdk + k0], a1 = Ab[(r0 + 8) * kLdk + k0];
            const cplx a2 = Ab[r0 * kLdk + k1], a3 = Ab[(r0 + 8) * kLdk + k1];
            const double p0 = Pb[k0], p1 = Pb[k1];
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                const int c = 16 * wc + 8 * j + g;
                const cplx b0 = Bb[c * kLdk + k0], b1 = Bb[c * kLdk + k1];
                const double br0 = p0 * b0.x, bi0 = p0 * b0.y, br1 = p1 * b1.x, bi1 = p1 * b1.y;
                dmma16(re[j], a0.x, a1.x, a2.x, a3.x, br0, br1);
                dmma16(re[j], a0.y, a1.y, a2.y, a3.y, bi0, bi1);
                dmma16(im[j], a0.x, a1.x, a2.x, a3.x, bi0, bi1);
                dmma16(im[j], -a0.y, -a1.y, -a2.y, -a3.y, br0, br1);
            }
        }
    }
    cplx* Xb = X + b * S * S;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int h = 0; h < 4; ++h) {
            const int nl = 16 * wr + g + 8 * (h >> 1), ml = 16 * wc + 8 * j + 2 * tg + (h & 1);
            const int64_t n = I * kTile + nl, m = J * kTile + ml;
            if (n >= S || m >= S || (diag && nl > ml)) continue;
            // the diagonal is real: its imaginary sum is 0 only to rounding
            const double x = re[j][h], y = n == m ? 0.0 : im[j][h];
            Xb[n * S + m] = make_cuDoubleComplex(x, y);
            Xb[m * S + n] = make_cuDoubleComplex(x, -y);
        }
    }
}

// mode 0: a thread an upper-triangle element; 1: the diagonal; 2: tiles.
extern "C" int pythtb_position(const void* w, const void* pos, const void* occ, void* out,
                               int64_t B, int64_t nsta, int64_t S, int64_t F, int64_t mode,
                               void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (mode == 2) {
        const int64_t nt = (S + kTile - 1) / kTile;
        const int64_t blocks = B * (nt * (nt + 1) / 2);
        cudaFuncSetAttribute(position_tiles_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kTileSmem);
        if (blocks > 0)
            position_tiles_kernel<<<(unsigned int)blocks, kTileThreads, kTileSmem, st>>>(
                (const cplx*)w, (const double*)pos, (const int64_t*)occ, (cplx*)out, nsta, S, F, nt);
    } else if (mode == 1) {
        if (B * S > 0)
            position_diag_kernel<<<blocks_for(B * S), kThreads, 0, st>>>(
                (const cplx*)w, (const double*)pos, (const int64_t*)occ, (double*)out, B, nsta, S, F);
    } else {
        const int64_t n = B * (S * (S + 1) / 2);
        if (n > 0)
            position_matrix_kernel<<<blocks_for(n), kThreads, 0, st>>>(
                (const cplx*)w, (const double*)pos, (const int64_t*)occ, (cplx*)out, B, nsta, S, F);
    }
    return (int)cudaGetLastError();
}
