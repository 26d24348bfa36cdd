// Kernel 21: the linear-interpolation (segment / triangle / tetrahedron)
// density of states.
//
// Replaces pythtb_tpu/fermisurface.py:_dos_lin_jit (:239-346), which XLA
// fused into one program: the grid eigenvalues (nk^d, S) are cut into
// simplices -- segments (d 1), two triangles a square (d 2), six
// tetrahedra a cube along the 000-111 diagonal (d 3) -- each simplex's d+1
// corner energies sorted, and at every energy E the piecewise-analytic
// weight of each simplex summed (jax.lax.map over E), times 1 / (d! nk^d).
//
//   pass 1 (one thread per simplex): gathers the d+1 corners of simplex
//     t by periodic index arithmetic -- the reference's jnp.roll order and
//     its simplex layout, t = ((grid point) * nsplx + split) * S + band --
//     sorts them in registers and writes cs (T, d+1);
//   pass 2 (a grid of simplex chunks x energy tiles): each thread owns one
//     energy, the block stages its chunk of sorted corners in shared memory
//     and every thread walks it in order, evaluating the reference's
//     branches with its max(., eps) clamps; partial sums to (chunks, nE);
//   pass 3: adds the chunks in order (no atomics: the sum order is fixed,
//     the result deterministic) and scales by the simplex weight.
//
// What bounds it on the H100: the operations, ~25 float64 operations a
// (simplex, energy) pair (the tetrahedron row: 663,552 x 1,601); the bytes
// (cs once per energy tile, from L2) are small beside them.  Design: the
// (T, nE) weight matrix of the reference is never formed; the chunk of
// corners is read once per block from device memory and then from shared
// memory by all 128 energies of the tile.
#include "common.cuh"

constexpr int kTetraTile = 128;   // energies (threads) per block of pass 2
constexpr int kTetraChunk = 512;  // simplices per block of pass 2

__device__ __forceinline__ int64_t wrap_add(int64_t i, int a, int64_t nk) { return a ? (i + 1 == nk ? 0 : i + 1) : i; }

// corner offsets of the six tetrahedra of a cube, along 000-111
__constant__ int kTets[6][4][3] = {
    {{0, 0, 0}, {1, 0, 0}, {1, 1, 0}, {1, 1, 1}}, {{0, 0, 0}, {1, 0, 0}, {1, 0, 1}, {1, 1, 1}},
    {{0, 0, 0}, {0, 1, 0}, {1, 1, 0}, {1, 1, 1}}, {{0, 0, 0}, {0, 1, 0}, {0, 1, 1}, {1, 1, 1}},
    {{0, 0, 0}, {0, 0, 1}, {1, 0, 1}, {1, 1, 1}}, {{0, 0, 0}, {0, 0, 1}, {0, 1, 1}, {1, 1, 1}},
};
// the two triangles of a square: (00, 10, 11) and (00, 01, 11)
__constant__ int kTris[2][3][2] = {{{0, 0}, {1, 0}, {1, 1}}, {{0, 0}, {0, 1}, {1, 1}}};

template <int D>
__global__ void tetra_corners_kernel(const double* __restrict__ ev, double* __restrict__ cs, int64_t nk, int S,
                                     int64_t T) {
    const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= T) return;
    const int s = (int)(t % S);
    double c[D + 1];
    if constexpr (D == 1) {
        const int64_t i = t / S;
        c[0] = ev[i * S + s];
        c[1] = ev[wrap_add(i, 1, nk) * S + s];
    } else if constexpr (D == 2) {
        const int tri = (int)((t / S) % 2);
        const int64_t g = t / (2 * S);
        const int64_t i = g / nk, j = g % nk;
#pragma unroll
        for (int v = 0; v < 3; ++v) {
            const int64_t a = wrap_add(i, kTris[tri][v][0], nk), b = wrap_add(j, kTris[tri][v][1], nk);
            c[v] = ev[(a * nk + b) * S + s];
        }
    } else {
        const int tet = (int)((t / S) % 6);
        const int64_t g = t / (6 * S);
        const int64_t i = g / (nk * nk), j = (g / nk) % nk, l = g % nk;
#pragma unroll
        for (int v = 0; v < 4; ++v) {
            const int64_t a = wrap_add(i, kTets[tet][v][0], nk), b = wrap_add(j, kTets[tet][v][1], nk),
                          e = wrap_add(l, kTets[tet][v][2], nk);
            c[v] = ev[((a * nk + b) * nk + e) * S + s];
        }
    }
    // insertion sort, ascending
#pragma unroll
    for (int a = 1; a <= D; ++a) {
#pragma unroll
        for (int b = a; b > 0; --b) {
            if (c[b] < c[b - 1]) {
                const double tmp = c[b];
                c[b] = c[b - 1];
                c[b - 1] = tmp;
            }
        }
    }
#pragma unroll
    for (int v = 0; v <= D; ++v) cs[t * (D + 1) + v] = c[v];
}

// the weight of one simplex with sorted corners c at energy E (the reference's branches)
template <int D>
__device__ __forceinline__ double simplex_weight(const double* c, double E) {
    constexpr double eps = 2.220446049250313e-16;  // float64 eps, as jnp.finfo
    if constexpr (D == 1) {
        if (E >= c[0] && E < c[1]) return 1.0 / fmax(c[1] - c[0], eps);
        return 0.0;
    } else if constexpr (D == 2) {
        const double e1 = c[0], e2 = c[1], e3 = c[2];
        if (E >= e1 && E < e2) {
            return 2.0 * (E - e1) / (fmax(e2 - e1, eps) * fmax(e3 - e1, eps));
        } else if (E >= e2 && E < e3) {
            return 2.0 * (e3 - E) / (fmax(e3 - e2, eps) * fmax(e3 - e1, eps));
        }
        return 0.0;
    } else {
        const double e1 = c[0], e2 = c[1], e3 = c[2], e4 = c[3];
        if (E < e1 || E >= e4) return 0.0;
        const double d21 = fmax(e2 - e1, eps), d31 = fmax(e3 - e1, eps), d41 = fmax(e4 - e1, eps);
        const double d32 = fmax(e3 - e2, eps), d42 = fmax(e4 - e2, eps), d43 = fmax(e4 - e3, eps);
        if (E < e2) {
            const double x = E - e1;
            return 3.0 * (x * x) / (d21 * d31 * d41);
        } else if (E < e3) {
            const double x = E - e2;
            return (3.0 * d21 + 6.0 * x - 3.0 * (d31 + d42) * (x * x) / (d32 * d42)) / (d31 * d41);
        }
        const double x = e4 - E;
        return 3.0 * (x * x) / (d41 * d42 * d43);
    }
}

template <int D>
__global__ void __launch_bounds__(kTetraTile)
tetra_partial_kernel(const double* __restrict__ cs, const double* __restrict__ energies, double* __restrict__ buf,
                     int64_t T, int nE) {
    __shared__ double sc[kTetraChunk * (D + 1)];
    const int64_t chunk = blockIdx.x;
    const int64_t t0 = chunk * kTetraChunk;
    const int n = (int)(T - t0 < kTetraChunk ? T - t0 : kTetraChunk);
    for (int i = threadIdx.x; i < n * (D + 1); i += kTetraTile) sc[i] = cs[t0 * (D + 1) + i];
    __syncthreads();
    const int ie = blockIdx.y * kTetraTile + threadIdx.x;
    if (ie >= nE) return;
    const double E = energies[ie];
    double acc = 0.0;
    for (int t = 0; t < n; ++t) acc += simplex_weight<D>(sc + t * (D + 1), E);
    buf[chunk * nE + ie] = acc;
}

__global__ void tetra_reduce_kernel(const double* __restrict__ buf, double* __restrict__ out, int64_t nch, int nE,
                                    double weight) {
    const int ie = blockIdx.x * blockDim.x + threadIdx.x;
    if (ie >= nE) return;
    double s = 0.0;
    for (int64_t c = 0; c < nch; ++c) s += buf[c * nE + ie];
    out[ie] = s * weight;
}

template <int D>
static void launch_tetra(const void* ev, void* cs, const void* energies, void* buf, void* out, int64_t nk, int S,
                         int64_t T, int nE, double weight, cudaStream_t st) {
    tetra_corners_kernel<D><<<blocks_for(T), kThreads, 0, st>>>((const double*)ev, (double*)cs, nk, S, T);
    const int64_t nch = (T + kTetraChunk - 1) / kTetraChunk;
    dim3 grid((unsigned int)nch, (unsigned int)((nE + kTetraTile - 1) / kTetraTile));
    tetra_partial_kernel<D><<<grid, kTetraTile, 0, st>>>((const double*)cs, (const double*)energies, (double*)buf,
                                                         T, nE);
    tetra_reduce_kernel<<<blocks_for(nE), kThreads, 0, st>>>((const double*)buf, (double*)out, nch, nE, weight);
}

// Kernel 21.  ev (nk^d, S) f64 grid eigenvalues, C order; cs (T, d+1) and
// buf (ceil(T / 512), nE) f64 scratch; energies (nE,) f64; out (nE,) f64.
// T = d! nk^d S; weight = 1 / (d! nk^d).
extern "C" int pythtb_tetra_dos(const void* ev, void* cs, const void* energies, void* buf, void* out, int64_t d,
                                int64_t nk, int64_t S, int64_t nE, double weight, void* stream) {
    const int64_t T = (d == 1 ? nk : d == 2 ? 2 * nk * nk : 6 * nk * nk * nk) * S;
    if (T <= 0 || nE <= 0) return (int)cudaGetLastError();
    cudaStream_t st = (cudaStream_t)stream;
    switch (d) {
        case 1: launch_tetra<1>(ev, cs, energies, buf, out, nk, (int)S, T, (int)nE, weight, st); break;
        case 2: launch_tetra<2>(ev, cs, energies, buf, out, nk, (int)S, T, (int)nE, weight, st); break;
        case 3: launch_tetra<3>(ev, cs, energies, buf, out, nk, (int)S, T, (int)nE, weight, st); break;
        default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
