// Kernel 14: parallel transport, the twisted smooth gauge and adiabatic
// state following.
//
// Replaces pythtb_tpu/ops/transport.py:_smooth_gauge_jit and
// _follow_states_jit, which XLA fused into two programs.  States arrive as
// the full stored grid viewed as (outer, L, inner, NS, F) -- any grid axis
// is the L of such a view, with no copy -- and a list of S selected rows
// (occ).  Three modes:
//
//   chain   each string (o, i) has L - 1 links: M_l = <w_l | w_{l+1}> over
//           the occ rows, W_l = polar(M_l), C_{l+1} = C_l W_l with C_0 = I.
//           Writes every prefix C_m to C (outer, L, inner, S, S) and the
//           smallest link singular value of the string.
//   rotate  each grid point m of a string: B_m = C_m Lambda^{-t_m}, with
//           t_m = m / (L - 1) and Lambda^{-t} = P diag(e^{-i theta t}) P^H
//           from the string's holonomy eigenpairs (theta, P) (closed), or
//           B_m = C_m (open); the new occ rows are conj(B_m) w_m.  The
//           kernel writes every row of the output grid: the occ rows
//           rotated, the others copied bit for bit, so the grid is read
//           once and written once.
//   follow  the adiabatic scan of each string: at each step l = 1 .. L - 1
//           the overlaps of the nocc transported states with all NS states
//           of point l, the squared-overlap weights, the nocc largest (ties
//           to the lower index, as jax.lax.top_k) with their indices sorted
//           ascending, the polar factor of the selected nocc x nocc block
//           and the new transported states conj(U) w_sel.  Writes the
//           indices, the captured fraction and the states of every step.
//
// What bounds it on the H100: bytes at small S (the chain reads the
// selected rows once per string, rotate reads the grid once and writes it
// once; follow reads every state once and writes NOCC rows a point), the
// O(S^3) link and rotation algebra from S ~ 16 on.  The chain has two designs.  The
// register path runs a thread a string at S 1, the string's loop standing
// in for the TPU's log-depth associative_scan (it loses to the link path
// from S 2 on: PERF.md section 6).  The link path (any S to 64) is kernel
// 5's (wilson_loop.cu): phase 1 gives every link of the grid a team of its
// own -- a warp (S <= 32) or a block of 256 threads -- that stages the two
// panels of occ rows by cp.async (the row gather happens inside the
// staging copies), forms M in shared memory and runs the one-sided Jacobi
// of link_polar.cuh, writing W_l into C's slot l + 1 of the string (so the
// link factors take no scratch beyond C) and the link's smallest singular
// value into scratch; phase 2 gives each string a team (a warp to S 16, a
// block above) that walks the slots in order, P <- P W_l with the next
// factors in flight by cp.async (seven ahead for a warp, one for a block),
// writing each prefix over the factor it consumed.  The prefixes are the
// plain version's, in its order, to rounding; the JAX program's tree scan
// agrees to about L eps.  The ops wrapper chooses the design
// (ops/transport.py:_chain_path).  Rotate has three designs, chosen by
// ops/transport.py:_rotate_path: the register path (a thread a point, S <=
// 3, its rows outside occ copied by the same thread); the team path (a
// warp or a block of four warps a point, on the CUDA cores, while a
// point's matrices fit a block's shared memory); and the split tiles (a
// block each 16 rows of a point, to 64 states, on the FP64 tensor cores).
// A team or tile block stages its rows of C_m, the
// string's P and the point's occ rows (S x F) in shared memory by cp.async,
// zero-padded, and copies its share of the rows outside occ from source to
// destination while those copies are in flight; then T = C_m P diag(e^{-i
// theta t_m}), B = T P^H and conj(B) w_m, each an S x S x S (or S x S x F)
// complex product: on the CUDA cores an entry a thread, on the tensor
// cores a 16 x 8 tile a warp from mma.sync m16n8k8 fragments, four real
// products a step (kernel 6's).  The rows of B are independent, so a point
// split over blocks of 16 rows repeats no product: at few points (63 at S
// 64) that fills the SMs a block a point would leave idle, and it keeps a
// block's shared memory within 227 kB at S 64.
// Follow, NS to 64, rests on an identity: with f_{l-1} = conj(C_{l-1})
// w_{sel_{l-1}}, C_0 = I and every C unitary, the overlaps of the
// transported states are C_{l-1} O_l, O_l = <w_{sel_{l-1}} | w_l> the raw
// overlaps of the stored states, so the weights (column norms) and the
// selection do not depend on C; and polar(C_{l-1} A_l) = C_{l-1} polar(A_l)
// for A_l = O_l[:, sel_l], so C_l = C_{l-1} W_l with W_l = polar(A_l), a
// chain as in the chain mode.  Five launches: (1) every link's NS x NS
// weights |<w_{l-1,n} | w_{l,s}>|^2 of the stored states, a team a link
// over the grid (team_overlap); (2) the selection scan, a warp a string, on
// those weights alone -- the links' weights staged by TMA three links ahead
// while a step ranks, no polar factor and no block barrier on the serial
// path -- writing the indices and the fidelity; (3) A_l from the rows the
// scan chose and W_l = polar(A_l) for every link at once, into C's slot l
// (the chain's phase 1 with a row list a point); (4) the prefixes C_l in
// order (the chain's
// phase 2); (5) the states conj(C_l)
// w_{sel_l} at every point, on the rotate's teams or tensor-core tiles with
// the rows chosen per point.  In floating point the two orders differ by
// rounding, about L eps, as the chain's prefixes do against the JAX tree
// scan.  Larger S is refused.
#include "link_polar.cuh"

template <int S>
__global__ void transport_chain_kernel(const cplx* __restrict__ w, const int64_t* __restrict__ occ,
                                       cplx* __restrict__ C, double* __restrict__ smin_out,
                                       int64_t outer, int64_t L, int64_t inner, int NS, int F) {
    const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= outer * inner) return;
    const int64_t i = t % inner;
    const int64_t o = t / inner;
    const int64_t row = (int64_t)NS * F;  // one grid point of w
    const cplx* base = w + (o * L * inner + i) * row;
    cplx* cbase = C + (o * L * inner + i) * S * S;
    int rows[S];
#pragma unroll
    for (int n = 0; n < S; ++n) rows[n] = (int)occ[n];

    cplx P[S][S];
#pragma unroll
    for (int r = 0; r < S; ++r)
#pragma unroll
        for (int c = 0; c < S; ++c) {
            P[r][c] = make_cuDoubleComplex(r == c ? 1.0 : 0.0, 0.0);
            cbase[r * S + c] = P[r][c];
        }
    double smin = 1.0e300;
    for (int64_t l = 0; l + 1 < L; ++l) {
        const cplx* wa = base + l * inner * row;
        const cplx* wb = wa + inner * row;
        cplx M[S][S];
#pragma unroll
        for (int n = 0; n < S; ++n) {
#pragma unroll
            for (int m = 0; m < S; ++m) {
                double re = 0.0, im = 0.0;
                const cplx* a = wa + (int64_t)rows[n] * F;
                const cplx* b = wb + (int64_t)rows[m] * F;
                for (int f = 0; f < F; ++f) {
                    const cplx z = cmul_conj(a[f], b[f]);
                    re += z.x;
                    im += z.y;
                }
                M[n][m] = make_cuDoubleComplex(re, im);
            }
        }
        smin = fmin(smin, polar_factor<S>(M));
        cplx* out = cbase + (l + 1) * inner * S * S;
#pragma unroll
        for (int r = 0; r < S; ++r) {
            cplx nrow[S];
#pragma unroll
            for (int c = 0; c < S; ++c) {
                cplx acc = make_cuDoubleComplex(0.0, 0.0);
#pragma unroll
                for (int k = 0; k < S; ++k) acc = cuCadd(acc, cuCmul(P[r][k], M[k][c]));
                nrow[c] = acc;
            }
#pragma unroll
            for (int c = 0; c < S; ++c) {
                P[r][c] = nrow[c];
                out[r * S + c] = nrow[c];
            }
        }
    }
    smin_out[t] = smin;
}

// the register path's most states: from 4 its matrices spill (PERF.md section 6)
constexpr int kRotateRegisterMaxS = 3;

template <int S>
__global__ void transport_rotate_kernel(const cplx* __restrict__ w, const int64_t* __restrict__ occ,
                                        const cplx* __restrict__ C, const double* __restrict__ theta,
                                        const cplx* __restrict__ Pm, cplx* __restrict__ out,
                                        int64_t outer, int64_t L, int64_t inner, int NS, int F,
                                        int closed) {
    const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= outer * L * inner) return;
    const int64_t i = t % inner;
    const int64_t l = (t / inner) % L;
    const int64_t o = t / (inner * L);
    const int64_t str = o * inner + i;  // the string of this point
    const cplx* c = C + t * S * S;
    cplx B[S][S];
#pragma unroll
    for (int r = 0; r < S; ++r)
#pragma unroll
        for (int k = 0; k < S; ++k) B[r][k] = c[r * S + k];
    if (closed) {
        // Lambda^{-t} = P diag(e^{-i theta t}) P^H, then B <- C_m Lambda^{-t}
        const double tm = (double)l / (double)(L - 1);
        const cplx* p = Pm + str * S * S;
        cplx ph[S];
#pragma unroll
        for (int j = 0; j < S; ++j) {
            double sn, cs;
            sincos(-theta[str * S + j] * tm, &sn, &cs);
            ph[j] = make_cuDoubleComplex(cs, sn);
        }
        cplx lam[S][S];
#pragma unroll
        for (int r = 0; r < S; ++r)
#pragma unroll
            for (int k = 0; k < S; ++k) {
                cplx acc = make_cuDoubleComplex(0.0, 0.0);
#pragma unroll
                for (int j = 0; j < S; ++j)
                    acc = cuCadd(acc, cuCmul(cuCmul(p[r * S + j], ph[j]), cconj(p[k * S + j])));
                lam[r][k] = acc;
            }
#pragma unroll
        for (int r = 0; r < S; ++r) {
            cplx nrow[S];
#pragma unroll
            for (int k = 0; k < S; ++k) {
                cplx acc = make_cuDoubleComplex(0.0, 0.0);
#pragma unroll
                for (int j = 0; j < S; ++j) acc = cuCadd(acc, cuCmul(B[r][j], lam[j][k]));
                nrow[k] = acc;
            }
#pragma unroll
            for (int k = 0; k < S; ++k) B[r][k] = nrow[k];
        }
    }
    const int64_t row = (int64_t)NS * F;
    const cplx* src = w + t * row;
    cplx* dst = out + t * row;
    int rows[S];
#pragma unroll
    for (int n = 0; n < S; ++n) rows[n] = (int)occ[n];
    // the rows outside occ, unchanged
    for (int r = 0; r < NS; ++r) {
        bool chosen = false;
#pragma unroll
        for (int n = 0; n < S; ++n) chosen |= rows[n] == r;
        if (!chosen)
            for (int f = 0; f < F; ++f) dst[(int64_t)r * F + f] = src[(int64_t)r * F + f];
    }
    for (int f = 0; f < F; ++f) {
        cplx x[S];
#pragma unroll
        for (int j = 0; j < S; ++j) x[j] = src[(int64_t)rows[j] * F + f];
#pragma unroll
        for (int n = 0; n < S; ++n) {
            cplx acc = make_cuDoubleComplex(0.0, 0.0);
#pragma unroll
            for (int j = 0; j < S; ++j) acc = cuCadd(acc, cuCmul(cconj(B[n][j]), x[j]));
            dst[(int64_t)rows[n] * F + f] = acc;
        }
    }
}

// -- chain, the link path (any S to 64) -------------------------------------

// Phase 1: link t = string * (L - 1) + l of the grid, one team (kTeam
// threads, the whole block) each: M_l over the occ rows, W_l = polar(M_l)
// into C's slot l + 1 of the string, the link's smallest singular value
// into link_smin[t].
template <int kTeam>
__global__ void __launch_bounds__(kTeam)
transport_links_kernel(const cplx* __restrict__ w, const int64_t* __restrict__ occ, cplx* __restrict__ C,
                       double* __restrict__ link_smin, int64_t L, int64_t inner, int S, int NS, int F) {
    extern __shared__ __align__(16) double smem[];
    cplx* M = (cplx*)smem;
    cplx* V = M + S * link_ld(S);
    double* sig = (double*)(V + S * link_vld(S));
    const int64_t t = blockIdx.x;
    const int64_t string = t / (L - 1), l = t % (L - 1);
    const int64_t i = string % inner, o = string / inner;
    const int64_t row = (int64_t)NS * F;  // one grid point of w
    const cplx* wa = w + ((o * L + l) * inner + i) * row;
    team_overlap<kTeam>(wa, wa + inner * row, M, V, S, F, occ);
    team_jacobi<kTeam>(M, V, S);
    cplx* out = C + ((o * L + l + 1) * inner + i) * S * S;
    const double smin = team_polar_store<kTeam>(M, V, S, sig, out);
    if (threadIdx.x == 0) link_smin[t] = smin;
}

// Entries of an S x S product each thread of a team holds: a warp takes S
// to kPrefixWarpMaxS, a block of kBlockThreads to kPolarBlockMaxS.
constexpr int kPrefixWarpMaxS = 16;
template <int kTeam>
__host__ __device__ constexpr int prefix_entries() {
    return kTeam == 32 ? kPrefixWarpMaxS * kPrefixWarpMaxS / 32 : kPolarBlockMaxS * kPolarBlockMaxS / kTeam;
}

// Factors in flight in phase 2: a warp's are small (S <= 16: 4 kB each),
// so it keeps kDepth - 1 = 7 loads ahead of the product it forms, which
// hides the copies' latency behind the short products of small S.
template <int kTeam>
__host__ __device__ constexpr int prefix_depth() {
    return kTeam == 32 ? 8 : 2;
}

// Phase 2: string s = blockIdx.x, one team.  C_0 = I into slot 0; then in
// order, P <- P W_l with W_l read from slot l + 1 and C_{l+1} = P written
// over it, the next factors arriving by cp.async (a ring of kDepth
// buffers) while P W_l forms.  The minimum of the string's link singular
// values into smin_out[s] (none where link_smin is null: the follow mode's
// chain).
template <int kTeam>
__global__ void __launch_bounds__(kTeam)
transport_prefix_kernel(cplx* __restrict__ C, const double* __restrict__ link_smin, double* __restrict__ smin_out,
                        int64_t L, int64_t inner, int S) {
    constexpr int kE = prefix_entries<kTeam>();
    constexpr int kDepth = prefix_depth<kTeam>();
    extern __shared__ __align__(16) double smem[];
    const int tt = threadIdx.x;
    const int SS = S * S;
    cplx* P = (cplx*)smem;
    cplx* ring = P + SS;  // kDepth factors
    const int64_t s = blockIdx.x;
    const int64_t i = s % inner, o = s / inner;
    const int64_t slot = inner * SS;  // from one prefix of the string to the next
    cplx* base = C + (o * L * inner + i) * SS;
    for (int e = tt; e < SS; e += kTeam) {
        P[e] = make_cuDoubleComplex(e / S == e % S ? 1.0 : 0.0, 0.0);
        base[e] = P[e];
    }
    // W_d (slot d + 1) into buffer d, a commit group each
    for (int d = 0; d < kDepth - 1; ++d) {
        if (d + 1 < L)
            for (int e = tt; e < SS; e += kTeam) cp_async16(ring + d * SS + e, base + (d + 1) * slot + e);
        cp_async_commit();
    }
    for (int64_t l = 0; l + 1 < L; ++l) {
        cp_async_wait<kDepth - 2>();
        team_sync<kTeam>();  // W_l landed; the last product's reads of the buffer refilled next are done
        const int64_t nl = l + kDepth - 1;
        if (nl + 1 < L) {
            const cplx* src = base + (nl + 1) * slot;
            cplx* dst = ring + (nl % kDepth) * SS;
            for (int e = tt; e < SS; e += kTeam) cp_async16(dst + e, src + e);
        }
        cp_async_commit();
        const cplx* W = ring + (l % kDepth) * SS;
        cplx acc[kE];
#pragma unroll
        for (int j = 0; j < kE; ++j) {
            const int e = tt + j * kTeam;
            if (e < SS) {
                const int r = e / S, c = e % S;
                cplx a = make_cuDoubleComplex(0.0, 0.0);
                for (int k = 0; k < S; ++k) a = cuCadd(a, cuCmul(P[r * S + k], W[k * S + c]));
                acc[j] = a;
            }
        }
        team_sync<kTeam>();
        cplx* out = base + (l + 1) * slot;
#pragma unroll
        for (int j = 0; j < kE; ++j) {
            const int e = tt + j * kTeam;
            if (e < SS) {
                P[e] = acc[j];
                out[e] = acc[j];
            }
        }
    }
    if (link_smin != nullptr && tt < 32) {
        double m = 1.0e300;
        for (int64_t l = tt; l + 1 < L; l += 32) m = fmin(m, link_smin[s * (L - 1) + l]);
        for (int off = 16; off > 0; off >>= 1) m = fmin(m, __shfl_xor_sync(0xffffffffu, m, off));
        if (tt == 0) smin_out[s] = m;
    }
}

// -- rotate: the team path and the tiles, 4 <= states <= 64 ----------------

constexpr int kRotateBlock = 128;  // threads of a team block (four warps) and of a tile block

// An operand of a team product: entry (i, j) at p[i * rs + j * cs],
// conjugated where kConj.
template <bool kConj>
struct Operand {
    const cplx* p;
    int rs, cs;
    __device__ __forceinline__ cplx at(int i, int j) const {
        const cplx v = p[i * rs + j * cs];
        return kConj ? cconj(v) : v;
    }
};

// D = A B over M x N entries of depth K, each entry handed to
// store(r, c, re, im).  Tensor cores (kTC): M a multiple of 16, N and K of
// 8, the operands zero-padded to them; a warp forms a 16 x 8 tile at a
// time, four real mma.sync products a depth step of 8 (re += ar br - ai
// bi, im += ar bi + ai br).  (Strips of several tiles a warp, which share
// the A fragments, raised the registers to 185 and lost: PERF.md section
// 6.)  CUDA cores: a thread an entry at a time.  Every thread of the team
// (kTeam threads, the whole block) calls it.
template <bool kTC, int kTeam, class OpA, class OpB, class Store>
__device__ __forceinline__ void team_product(const OpA A, const OpB B, int M, int N, int K, Store store) {
    const int tid = threadIdx.x;
    if constexpr (kTC) {
        const int lane = tid & 31, warp = tid >> 5, g = lane >> 2, tg = lane & 3;
        const int nt = N / 8, tiles = (M / 16) * nt;
        for (int p = warp; p < tiles; p += kTeam / 32) {
            const int r0 = (p / nt) * 16, c0 = (p % nt) * 8;
            double re[4] = {0.0, 0.0, 0.0, 0.0}, im[4] = {0.0, 0.0, 0.0, 0.0};
            for (int k0 = 0; k0 < K; k0 += 8) {
                const cplx a0 = A.at(r0 + g, k0 + tg), a1 = A.at(r0 + g + 8, k0 + tg);
                const cplx a2 = A.at(r0 + g, k0 + tg + 4), a3 = A.at(r0 + g + 8, k0 + tg + 4);
                const cplx b0 = B.at(k0 + tg, c0 + g), b1 = B.at(k0 + tg + 4, c0 + g);
                dmma16(re, a0.x, a1.x, a2.x, a3.x, b0.x, b1.x);
                dmma16(re, -a0.y, -a1.y, -a2.y, -a3.y, b0.y, b1.y);
                dmma16(im, a0.x, a1.x, a2.x, a3.x, b0.y, b1.y);
                dmma16(im, a0.y, a1.y, a2.y, a3.y, b0.x, b1.x);
            }
#pragma unroll
            for (int h = 0; h < 4; ++h) store(r0 + g + 8 * (h >> 1), c0 + 2 * tg + (h & 1), re[h], im[h]);
        }
    } else {
        for (int e = tid; e < M * N; e += kTeam) {
            const int r = e / N, c = e - r * N;
            double re = 0.0, im = 0.0;
            for (int k = 0; k < K; ++k) {
                const cplx a = A.at(r, k), b = B.at(k, c);
                re += a.x * b.x - a.y * b.y;
                im += a.x * b.y + a.y * b.x;
            }
            store(r, c, re, im);
        }
    }
}

__host__ __device__ constexpr int pad8(int x) { return (x + 7) / 8 * 8; }

// Row strides of the staged matrices, in complex entries: = 4 (mod 8) for
// those read as an A fragment or as a transposed B fragment (lanes g, tg at
// row g, column tg), = 2 (mod 8) for the occ rows, read as a B fragment
// (row tg, column g), so each 8-lane phase of a 16-byte load hits 8 banks.
// P is read both ways (a B fragment in T = C P, a transposed one in T P^H):
// the first takes 2-way conflicts.
// Fc: the columns of the occ rows staged at a time (F, or a chunk of it
// where the whole rows do not fit beside the matrices).
struct RotateLayout {
    int Sp, Fp, ldS, ldF, R;
    size_t cs, ts, ps, xs, th, ph, flags;  // offsets in complex entries
    size_t bytes;
    __host__ __device__ RotateLayout(int S, int Fc, int NS, int rows, bool closed) {
        Sp = pad8(S);
        Fp = pad8(Fc);
        ldS = Sp + 4;
        ldF = Fp + 2;
        R = rows;
        cs = 0;
        ts = cs + (size_t)R * ldS;
        ps = ts + (closed ? (size_t)R * ldS : 0);
        xs = ps + (closed ? (size_t)Sp * ldS : 0);
        th = xs + (size_t)Sp * ldF;
        ph = th + (closed ? (size_t)(Sp + 1) / 2 : 0);
        flags = ph + (closed ? Sp : 0);
        bytes = flags * sizeof(cplx) + (size_t)((NS + 31) / 32) * sizeof(unsigned);
    }
};

// Block b = point * tiles + rb takes rows [rb R, rb R + R) of the point's
// occ rows (R = S, one tile, on the CUDA cores) and its share of the other
// rows.  Tensor cores: R = 16, the products over the padded sizes; CUDA
// cores: over S and F.  The new rows are formed Fc columns at a time.  The operands that need no occ index
// (C_m's rows, P, theta) are in flight while the occ list is read.
template <bool kTC, int kTeam>
__global__ void __launch_bounds__(kTeam)
transport_rotate_team_kernel(const cplx* __restrict__ w, const int64_t* __restrict__ occ,
                             const cplx* __restrict__ C, const double* __restrict__ theta,
                             const cplx* __restrict__ Pm, cplx* __restrict__ out, int64_t L, int64_t inner,
                             int S, int NS, int F, int Fc, int closed, int rows, int tiles) {
    extern __shared__ __align__(16) double smem[];
    __shared__ int socc[kPolarBlockMaxS];
    const RotateLayout lay(S, Fc, NS, rows, closed != 0);
    cplx* base = (cplx*)smem;
    cplx* Cs = base + lay.cs;
    cplx* Ts = base + lay.ts;
    cplx* Ps = base + lay.ps;
    cplx* Xs = base + lay.xs;
    const double* th = (const double*)(base + lay.th);
    cplx* ph = base + lay.ph;
    unsigned* flags = (unsigned*)(base + lay.flags);
    const int tid = threadIdx.x, R = lay.R, Sp = lay.Sp, Fp = lay.Fp, ldS = lay.ldS, ldF = lay.ldF;
    const int64_t t = blockIdx.x / tiles;  // the grid point
    const int rb = (int)(blockIdx.x % tiles), n0 = rb * R;
    const int64_t i = t % inner, l = (t / inner) % L, o = t / (inner * L);
    const int64_t str = o * inner + i;
    const int64_t row = (int64_t)NS * F;
    const cplx* src = w + t * row;
    cplx* dst = out + t * row;
    // group 1: the block's rows of C_m, the string's P and theta, zero-padded
    const cplx* c = C + t * S * S;
    for (int e = tid; e < R * Sp; e += kTeam) {
        const int r = e / Sp, k = e - r * Sp;
        const bool ok = n0 + r < S && k < S;
        cp_async16(Cs + r * ldS + k, ok ? c + (n0 + r) * S + k : c, ok);
    }
    if (closed) {
        const cplx* p = Pm + str * S * S;
        for (int e = tid; e < Sp * Sp; e += kTeam) {
            const int r = e / Sp, k = e - r * Sp;
            const bool ok = r < S && k < S;
            cp_async16(Ps + r * ldS + k, ok ? p + r * S + k : p, ok);
        }
        for (int j = tid; j < S; j += kTeam) cp_async8((double*)th + j, theta + str * S + j);
    }
    cp_async_commit();
    const int nwords = (NS + 31) / 32;
    for (int j = tid; j < S; j += kTeam) socc[j] = (int)occ[j];
    for (int j = tid; j < nwords; j += kTeam) flags[j] = 0u;
    __syncthreads();
    for (int j = tid; j < S; j += kTeam) atomicOr(flags + (socc[j] >> 5), 1u << (socc[j] & 31));
    // group 2: columns [f0, f0 + Fc) of the point's occ rows
    auto stage_rows = [&](int f0) {
        for (int e = tid; e < Sp * Fp; e += kTeam) {
            const int j = e / Fp, f = e - j * Fp;
            const bool ok = j < S && f < Fc && f0 + f < F;
            cp_async16(Xs + j * ldF + f, ok ? src + (int64_t)socc[j] * F + f0 + f : src, ok);
        }
        cp_async_commit();
    };
    stage_rows(0);
    __syncthreads();  // the occ flags
    // the block's share of the rows outside occ, source to destination,
    // eight loads in flight a thread
    {
        constexpr int kU = 8;
        const int e0 = (int)((int64_t)NS * rb / tiles) * F, e1 = (int)((int64_t)NS * (rb + 1) / tiles) * F;
        for (int e = e0 + tid; e < e1; e += kU * kTeam) {
            cplx v[kU];
            bool keep[kU];
#pragma unroll
            for (int u = 0; u < kU; ++u) {
                const int x = e + u * kTeam;
                const int r = x < e1 ? x / F : 0;
                keep[u] = x < e1 && !((flags[r >> 5] >> (r & 31)) & 1u);
                if (keep[u]) v[u] = src[x];
            }
#pragma unroll
            for (int u = 0; u < kU; ++u)
                if (keep[u]) dst[e + u * kTeam] = v[u];
        }
    }
    // the products' sizes: padded on the tensor cores, exact on the CUDA cores
    const int Mr = kTC ? R : min(R, S - n0), Ns = kTC ? Sp : S;
    if (closed) {
        cp_async_wait<1>();
        const double tm = (double)l / (double)(L - 1);
        for (int j = tid; j < Sp; j += kTeam) {
            double sn = 0.0, cs = 0.0;
            if (j < S) sincos(-th[j] * tm, &sn, &cs);
            ph[j] = make_cuDoubleComplex(cs, sn);
        }
        __syncthreads();
        // T = C_m P diag(e^{-i theta t_m})
        team_product<kTC, kTeam>(Operand<false>{Cs, ldS, 1}, Operand<false>{Ps, ldS, 1}, Mr, Ns, Ns,
                                 [&](int r, int k, double re, double im) {
                                     const cplx z = ph[k];
                                     Ts[r * ldS + k] = make_cuDoubleComplex(re * z.x - im * z.y, re * z.y + im * z.x);
                                 });
        __syncthreads();
        // B = T P^H, over the block's rows of C_m
        team_product<kTC, kTeam>(Operand<false>{Ts, ldS, 1}, Operand<true>{Ps, 1, ldS}, Mr, Ns, Ns,
                                 [&](int r, int k, double re, double im) {
                                     Cs[r * ldS + k] = make_cuDoubleComplex(re, im);
                                 });
    }
    // the new occ rows conj(B) w_m, Fc columns at a time
    for (int f0 = 0;;) {
        cp_async_wait<0>();
        __syncthreads();
        team_product<kTC, kTeam>(Operand<true>{Cs, ldS, 1}, Operand<false>{Xs, ldF, 1}, Mr,
                                 kTC ? Fp : min(Fc, F - f0), Ns, [&](int r, int f, double re, double im) {
                                     if (n0 + r < S && f < Fc && f0 + f < F)
                                         dst[(int64_t)socc[n0 + r] * F + f0 + f] = make_cuDoubleComplex(re, im);
                                 });
        f0 += Fc;
        if (f0 >= F) break;
        __syncthreads();  // every warp is done with the chunk
        stage_rows(f0);
    }
}

// -- follow, the scan design (NS to 64) -------------------------------------

// Phase 1: link t = string * (L - 1) + l - 1 (l = 1 .. L - 1), a team each
// (a warp to NS kOverlapWarpMaxS, a block above): the weights Wt_t[n][s] =
// |<w_{l-1,n} | w_{l,s}>|^2 over all NS states (NS x NS, row-major, links
// weight_stride(NS) doubles apart) into Wt.
constexpr int kOverlapWarpMaxS = 16;
__host__ __device__ inline int weight_stride(int NS) { return NS * NS + (NS & 1); }  // an even count: 16-byte copies

template <int kTeam>
__global__ void __launch_bounds__(kTeam, 1)  // (without the 1, ptxas held the block to 48 registers and spilled)
transport_follow_weights_kernel(const cplx* __restrict__ w, double* __restrict__ Wt, int64_t L, int64_t inner,
                                int NS, int F) {
    extern __shared__ __align__(16) double smem[];
    __shared__ double* out;  // the link's weights, kept here across the overlap rather than in registers
    cplx* M = (cplx*)smem;
    cplx* stage = M + NS * link_ld(NS);
    const int64_t t = blockIdx.x;
    const int64_t string = t / (L - 1), l = t % (L - 1) + 1;
    const int64_t i = string % inner, o = string / inner;
    const int64_t row = (int64_t)NS * F;
    const cplx* wb = w + ((o * L + l) * inner + i) * row;
    if (threadIdx.x == 0) out = Wt + t * weight_stride(NS);
    team_overlap<kTeam>(wb - inner * row, wb, M, stage, NS, F);
    const int ld = link_ld(NS);
    double* q = out;
    for (int e = threadIdx.x; e < NS * NS; e += kTeam) {
        const cplx z = M[(e / NS) * ld + e % NS];
        q[e] = z.x * z.x + z.y * z.y;
    }
}

// Phase 2: string s = blockIdx.x, one warp, the selection scan on the
// weights alone.  The links' weights arrive by TMA kScanDepth - 1 links
// ahead (a ring of kScanDepth NS x NS buffers, one copy and one mbarrier a
// link); step l weighs each state s by the sum of column s over the rows
// sel_{l-1} of Wt_l (a lane holds states lane and lane + 32), ranks the
// weights by shuffles (the number that are larger, or equal at a lower
// index: jax.lax.top_k's order), takes the nocc of rank below nocc in
// ascending order by ballots, and writes them to idx and their summed
// weight / nocc to fid.  Step 0 writes occ to idx.
constexpr int kScanDepth = 4;

__global__ void __launch_bounds__(32)
transport_follow_scan_kernel(const double* __restrict__ Wt, const int64_t* __restrict__ occ,
                             int64_t* __restrict__ idx, double* __restrict__ fid, int64_t L, int nocc, int NS) {
    extern __shared__ __align__(16) double smem[];
    __shared__ int sel[2][kPolarBlockMaxS];
    __shared__ __align__(8) uint64_t full[kScanDepth];
    const unsigned all = 0xffffffffu;
    const int lane = threadIdx.x;
    const int64_t s = blockIdx.x, nstr = gridDim.x;
    const int NW = weight_stride(NS);
    const double* q = Wt + s * (L - 1) * NW;
    for (int n = lane; n < nocc; n += 32) {
        sel[0][n] = (int)occ[n];
        idx[s * nocc + n] = occ[n];
    }
    if (lane == 0) {
        for (int d = 0; d < kScanDepth; ++d) mbar_init(&full[d], 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncwarp();
    auto stage = [&](int64_t k) {  // link k into its buffer
        if (lane == 0 && k < L - 1) {
            uint64_t* bar = &full[k % kScanDepth];
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // after the last step's reads
            mbar_expect_tx(bar, NW * sizeof(double));
            tma_load_1d(smem + (k % kScanDepth) * NW, q + k * NW, NW * sizeof(double), bar);
        }
    };
    for (int d = 0; d < kScanDepth - 1; ++d) stage(d);
    const unsigned below = (1u << lane) - 1u;
    const int s0 = lane, s1 = lane + 32;
    for (int64_t l = 1; l < L; ++l) {
        stage(l + kScanDepth - 2);
        mbar_wait(&full[(l - 1) % kScanDepth], (unsigned)(((l - 1) / kScanDepth) & 1));
        const double* Wc = smem + ((l - 1) % kScanDepth) * NW;
        const int* prev = sel[(l - 1) & 1];
        int* next = sel[l & 1];
        // a lane past NS reads a clamped column; its weight is never ranked
        const int c0 = min(s0, NS - 1), c1 = min(s1, NS - 1);
        double w0 = 0.0, w1 = 0.0;
#pragma unroll 4
        for (int n = 0; n < nocc; ++n) {
            const double* r = Wc + prev[n] * NS;
            w0 += r[c0];
            w1 += r[c1];
        }
        int r0 = 0, r1 = 0;
#pragma unroll 8
        for (int j = 0; j < min(NS, 32); ++j) {
            const double wj = __shfl_sync(all, w0, j);
            r0 += wj > w0 || (wj == w0 && j < s0);
            r1 += wj > w1 || (wj == w1 && j < s1);
        }
#pragma unroll 8
        for (int j = 32; j < NS; ++j) {
            const double wj = __shfl_sync(all, w1, j - 32);
            r0 += wj > w0 || (wj == w0 && j < s0);
            r1 += wj > w1 || (wj == w1 && j < s1);
        }
        const bool in0 = s0 < NS && r0 < nocc, in1 = s1 < NS && r1 < nocc;
        const unsigned b0 = __ballot_sync(all, in0), b1 = __ballot_sync(all, in1);
        if (in0) next[__popc(b0 & below)] = s0;
        if (in1) next[__popc(b0) + __popc(b1 & below)] = s1;
        // the captured weight, the same bits in every lane
        double f = (in0 ? w0 : 0.0) + (in1 ? w1 : 0.0);
        for (int off = 16; off > 0; off >>= 1) f += __shfl_xor_sync(all, f, off);
        __syncwarp();
        for (int n = lane; n < nocc; n += 32) idx[(l * nstr + s) * nocc + n] = next[n];
        if (lane == 0) fid[(l - 1) * nstr + s] = f / nocc;
        __syncwarp();  // every lane is done with this step's buffer and prev before they are refilled
    }
}

// Phase 3: link t = string * (L - 1) + l - 1, a team each: A_l =
// <w_{l-1}[sel_{l-1}] | w_l[sel_l]> staged by cp.async with the rows the
// scan chose (team_overlap), W_l = polar(A_l) into C's slot l.
template <int kTeam>
__global__ void __launch_bounds__(kTeam)
transport_follow_polar_kernel(const cplx* __restrict__ w, const int64_t* __restrict__ idx, cplx* __restrict__ C,
                              int64_t L, int64_t inner, int S, int NS, int F) {
    extern __shared__ __align__(16) double smem[];
    __shared__ cplx* out;  // the link's slot, kept here across the Jacobi rather than in registers
    cplx* M = (cplx*)smem;
    cplx* V = M + S * link_ld(S);
    double* sig = (double*)(V + S * link_vld(S));
    const int64_t t = blockIdx.x, nstr = gridDim.x / (L - 1);
    const int64_t string = t / (L - 1), l = t % (L - 1) + 1;
    const int64_t i = string % inner, o = string / inner;
    const int64_t row = (int64_t)NS * F;
    const cplx* wb = w + ((o * L + l) * inner + i) * row;
    if (threadIdx.x == 0) out = C + ((o * L + l) * inner + i) * S * S;
    team_overlap<kTeam>(wb - inner * row, wb, M, V, S, F, idx + ((l - 1) * nstr + string) * S,
                        idx + (l * nstr + string) * S);
    team_jacobi<kTeam>(M, V, S);
    team_polar_store<kTeam>(M, V, S, sig, out);
}

// Phase 5: block b = point * tiles + rb, the rotate's open product with the
// rows chosen per point: rows [rb R, rb R + R) of conj(C_m) w_m[sel_m] into
// the point's nocc rows of states, formed Fc columns at a time.
template <bool kTC, int kTeam>
__global__ void __launch_bounds__(kTeam)
transport_follow_states_kernel(const cplx* __restrict__ w, const int64_t* __restrict__ idx,
                               const cplx* __restrict__ C, cplx* __restrict__ states, int64_t L, int64_t inner,
                               int S, int NS, int F, int Fc, int rows, int tiles) {
    extern __shared__ __align__(16) double smem[];
    __shared__ int ssel[kPolarBlockMaxS];
    const RotateLayout lay(S, Fc, NS, rows, false);
    cplx* Cs = (cplx*)smem + lay.cs;
    cplx* Xs = (cplx*)smem + lay.xs;
    const int tid = threadIdx.x, R = lay.R, Sp = lay.Sp, Fp = lay.Fp, ldS = lay.ldS, ldF = lay.ldF;
    const int64_t t = blockIdx.x / tiles;  // the grid point
    const int rb = (int)(blockIdx.x % tiles), n0 = rb * R;
    const int64_t nstr = gridDim.x / tiles / L;
    const int64_t i = t % inner, l = (t / inner) % L, o = t / (inner * L);
    const cplx* src = w + t * NS * F;
    cplx* dst = states + t * S * F;
    const cplx* c = C + t * S * S;
    for (int e = tid; e < R * Sp; e += kTeam) {
        const int r = e / Sp, k = e - r * Sp;
        const bool ok = n0 + r < S && k < S;
        cp_async16(Cs + r * ldS + k, ok ? c + (n0 + r) * S + k : c, ok);
    }
    cp_async_commit();
    for (int j = tid; j < S; j += kTeam) ssel[j] = (int)idx[(l * nstr + o * inner + i) * S + j];
    __syncthreads();
    const int Mr = kTC ? R : min(R, S - n0), Ns = kTC ? Sp : S;
    for (int f0 = 0; f0 < F; f0 += Fc) {
        if (f0 > 0) __syncthreads();  // every warp is done with the last chunk
        // columns [f0, f0 + Fc) of the chosen rows, zero-padded
        for (int e = tid; e < Sp * Fp; e += kTeam) {
            const int j = e / Fp, f = e - j * Fp;
            const bool ok = j < S && f < Fc && f0 + f < F;
            cp_async16(Xs + j * ldF + f, ok ? src + (int64_t)ssel[j] * F + f0 + f : src, ok);
        }
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        team_product<kTC, kTeam>(Operand<true>{Cs, ldS, 1}, Operand<false>{Xs, ldF, 1}, Mr,
                                 kTC ? Fp : min(Fc, F - f0), Ns, [&](int r, int f, double re, double im) {
                                     if (n0 + r < S && f < Fc && f0 + f < F)
                                         dst[(int64_t)(n0 + r) * F + f0 + f] = make_cuDoubleComplex(re, im);
                                 });
    }
}

// Phase 2 of the chain (and phase 4 of the follow mode's scan design): a
// warp a string to S 16, a block above.
static int launch_prefix(cplx* C, const double* link_smin, double* smin, int64_t strings, int64_t L,
                         int64_t inner, int S, cudaStream_t st) {
    if (S <= kPrefixWarpMaxS) {
        const size_t chain = (1 + prefix_depth<32>()) * (size_t)S * S * sizeof(cplx);
        transport_prefix_kernel<32><<<(unsigned int)strings, 32, chain, st>>>(C, link_smin, smin, L, inner, S);
    } else {
        const size_t chain = (1 + prefix_depth<kBlockThreads>()) * (size_t)S * S * sizeof(cplx);
        cudaFuncSetAttribute(transport_prefix_kernel<kBlockThreads>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)chain);
        transport_prefix_kernel<kBlockThreads><<<(unsigned int)strings, kBlockThreads, chain, st>>>(
            C, link_smin, smin, L, inner, S);
    }
    return (int)cudaGetLastError();
}

// The columns of a point's occ rows a rotate or follow-states block stages
// at a time: F, or, where the rows do not fit whole beside the matrices in
// the H100's 227 kB a block (less the static occ list), the most columns
// that do, a multiple of 8; 0 where not even 8 do.
static int rows_chunk(int S, int F, int NS, int rows, bool closed) {
    const size_t limit = 232448 - 1024;
    if (RotateLayout(S, F, NS, rows, closed).bytes <= limit) return F;
    const size_t rest = RotateLayout(S, 0, NS, rows, closed).bytes;
    const int Fc = (rest < limit ? (int)((limit - rest) / (sizeof(cplx) * pad8(S))) - 2 : 0) / 8 * 8;
    return Fc < 8 ? 0 : Fc;
}

// path 0: the register path (a thread a string, S 1); 1: the link path
// with a warp a link (S <= 32); 2: the link path with a block a link (S <=
// 64).  The link path takes link_smin (strings * (L - 1) doubles) as
// scratch; the link factors go into C itself.
extern "C" int pythtb_transport_chain(const void* w, const void* occ, void* C, void* smin, void* link_smin,
                                      int64_t outer, int64_t L, int64_t inner, int64_t S,
                                      int64_t NS, int64_t F, int64_t path, void* stream) {
    if (outer * inner <= 0) return (int)cudaGetLastError();
    cudaStream_t st = (cudaStream_t)stream;
    if (path < 0 || path > 2 || S < 1 || S > (path == 0 ? 1 : path == 1 ? 32 : kPolarBlockMaxS) || L < 1)
        return (int)cudaErrorInvalidValue;
    const int64_t strings = outer * inner;
    if (path == 0) {
        transport_chain_kernel<1><<<blocks_for(strings), kThreads, 0, st>>>(
            (const cplx*)w, (const int64_t*)occ, (cplx*)C, (double*)smin, outer, L, inner, (int)NS, (int)F);
        return (int)cudaGetLastError();
    }
    if (L > 1) {
        const size_t bytes = link_smem((int)S);
        const unsigned int links = (unsigned int)(strings * (L - 1));
        if (path == 1) {
            cudaFuncSetAttribute(transport_links_kernel<32>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
            transport_links_kernel<32><<<links, 32, bytes, st>>>((const cplx*)w, (const int64_t*)occ, (cplx*)C,
                                                                 (double*)link_smin, L, inner, (int)S, (int)NS,
                                                                 (int)F);
        } else {
            cudaFuncSetAttribute(transport_links_kernel<kBlockThreads>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)bytes);
            transport_links_kernel<kBlockThreads><<<links, kBlockThreads, bytes, st>>>(
                (const cplx*)w, (const int64_t*)occ, (cplx*)C, (double*)link_smin, L, inner, (int)S, (int)NS,
                (int)F);
        }
        const int rc = (int)cudaGetLastError();
        if (rc != 0) return rc;
    }
    return launch_prefix((cplx*)C, (const double*)link_smin, (double*)smin, strings, L, inner, (int)S, st);
}

// path 0: the register path (a thread a point, S <= 3); 1: the team path
// with a warp a point; 2: the team path with a block of four warps a
// point; 3: the split tiles, a block each 16 rows of a point.  out receives the
// whole grid.
extern "C" int pythtb_transport_rotate(const void* w, const void* occ, const void* C,
                                       const void* theta, const void* P, void* out, int64_t outer,
                                       int64_t L, int64_t inner, int64_t S, int64_t NS, int64_t F,
                                       int64_t closed, int64_t path, void* stream) {
    if (outer * L * inner <= 0) return (int)cudaGetLastError();
    cudaStream_t st = (cudaStream_t)stream;
    if (path < 0 || path > 3 || S < 1 || S > (path == 0 ? kRotateRegisterMaxS : kPolarBlockMaxS) || NS < S)
        return (int)cudaErrorInvalidValue;
    const int64_t points = outer * L * inner;
    if (path == 0) {
#define ROTATE(K)                                                                               \
    transport_rotate_kernel<K><<<blocks_for(points), kThreads, 0, st>>>(                        \
        (const cplx*)w, (const int64_t*)occ, (const cplx*)C, (const double*)theta,              \
        (const cplx*)P, (cplx*)out, outer, L, inner, (int)NS, (int)F, (int)closed)
        switch (S) {
            case 1: ROTATE(1); break;
            case 2: ROTATE(2); break;
            default: ROTATE(3); break;
        }
#undef ROTATE
        return (int)cudaGetLastError();
    }
    const int rows = path <= 2 ? (int)S : 16;
    const int tiles = (int)((S + rows - 1) / rows);
    const int Fc = rows_chunk((int)S, (int)F, (int)NS, rows, closed != 0);
    if (Fc == 0) return (int)cudaErrorInvalidValue;
    const RotateLayout lay((int)S, Fc, (int)NS, rows, closed != 0);
    const unsigned int blocks = (unsigned int)(points * tiles);
#define TEAM(TC, THREADS)                                                                                    \
    do {                                                                                                     \
        cudaFuncSetAttribute(transport_rotate_team_kernel<TC, THREADS>,                                      \
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)lay.bytes);                   \
        transport_rotate_team_kernel<TC, THREADS><<<blocks, THREADS, lay.bytes, st>>>(                       \
            (const cplx*)w, (const int64_t*)occ, (const cplx*)C, (const double*)theta, (const cplx*)P,       \
            (cplx*)out, L, inner, (int)S, (int)NS, (int)F, Fc, (int)closed, rows, tiles);                    \
    } while (0)
    if (path == 1)
        TEAM(false, 32);
    else if (path == 2)
        TEAM(false, kRotateBlock);
    else
        TEAM(true, kRotateBlock);
#undef TEAM
    return (int)cudaGetLastError();
}

// 1 <= nocc <= NS <= 64.  Wt (strings x (L - 1) x weight_stride(NS)
// doubles) and C (outer x L x inner x nocc x nocc complex) are scratch;
// polar_block gives phase 3 a block a link (else a warp), states_mode phase
// 5 the rotate's design (1 a warp a point, 2 a block of four warps, 3 the
// tensor-core tiles).  At L 1 phases 1 and 3 have no link to run.
extern "C" int pythtb_transport_follow(const void* w, const void* occ, void* idx, void* fid, void* states, void* Wt,
                                       void* C, int64_t outer, int64_t L, int64_t inner, int64_t nocc, int64_t NS,
                                       int64_t F, int64_t polar_block, int64_t states_mode, void* stream) {
    if (outer * inner <= 0) return (int)cudaGetLastError();
    if (nocc < 1 || nocc > NS || NS > kPolarBlockMaxS || L < 1 || states_mode < 1 || states_mode > 3)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    const int64_t strings = outer * inner;
    const int S = (int)nocc;
    const unsigned int links = (unsigned int)(strings * (L - 1));
    int rc = 0;
    if (L > 1) {
        const size_t bytes = link_smem((int)NS);
        if (NS <= kOverlapWarpMaxS) {
            transport_follow_weights_kernel<32><<<links, 32, bytes, st>>>((const cplx*)w, (double*)Wt, L, inner,
                                                                          (int)NS, (int)F);
        } else {
            cudaFuncSetAttribute(transport_follow_weights_kernel<kBlockThreads>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
            transport_follow_weights_kernel<kBlockThreads><<<links, kBlockThreads, bytes, st>>>(
                (const cplx*)w, (double*)Wt, L, inner, (int)NS, (int)F);
        }
        if ((rc = (int)cudaGetLastError()) != 0) return rc;
    }
    {
        const size_t bytes = kScanDepth * (size_t)weight_stride((int)NS) * sizeof(double);
        cudaFuncSetAttribute(transport_follow_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
        transport_follow_scan_kernel<<<(unsigned int)strings, 32, bytes, st>>>(
            (const double*)Wt, (const int64_t*)occ, (int64_t*)idx, (double*)fid, L, S, (int)NS);
        if ((rc = (int)cudaGetLastError()) != 0) return rc;
    }
    if (L > 1) {
        const size_t bytes = link_smem(S);
        if (!polar_block) {
            transport_follow_polar_kernel<32><<<links, 32, bytes, st>>>((const cplx*)w, (const int64_t*)idx, (cplx*)C,
                                                                        L, inner, S, (int)NS, (int)F);
        } else {
            cudaFuncSetAttribute(transport_follow_polar_kernel<kBlockThreads>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
            transport_follow_polar_kernel<kBlockThreads><<<links, kBlockThreads, bytes, st>>>(
                (const cplx*)w, (const int64_t*)idx, (cplx*)C, L, inner, S, (int)NS, (int)F);
        }
        if ((rc = (int)cudaGetLastError()) != 0) return rc;
    }
    if ((rc = launch_prefix((cplx*)C, nullptr, nullptr, strings, L, inner, S, st)) != 0) return rc;
    {
        const int rows = states_mode <= 2 ? S : 16;
        const int tiles = (S + rows - 1) / rows;
        const int Fc = rows_chunk(S, (int)F, (int)NS, rows, false);
        if (Fc == 0) return (int)cudaErrorInvalidValue;
        const RotateLayout lay(S, Fc, (int)NS, rows, false);
        const unsigned int blocks = (unsigned int)(strings * L * tiles);
#define STATES(TC, THREADS)                                                                                  \
    do {                                                                                                     \
        cudaFuncSetAttribute(transport_follow_states_kernel<TC, THREADS>,                                    \
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)lay.bytes);                   \
        transport_follow_states_kernel<TC, THREADS><<<blocks, THREADS, lay.bytes, st>>>(                     \
            (const cplx*)w, (const int64_t*)idx, (const cplx*)C, (cplx*)states, L, inner, S, (int)NS, (int)F, \
            Fc, rows, tiles);                                                                                \
    } while (0)
        if (states_mode == 1)
            STATES(false, 32);
        else if (states_mode == 2)
            STATES(false, kRotateBlock);
        else
            STATES(true, kRotateBlock);
#undef STATES
    }
    return (int)cudaGetLastError();
}
