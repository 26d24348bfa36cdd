// Kernel 5: Wilson loops -- polar factors of the link overlaps, chained.
//
// Replaces pythtb_tpu/ops/berry.py:_berry_products_jit and its inlined
// copies in flows.py (_wilson_half_cycle, _wilson_flow_jit), which XLA
// fused into one program: link overlaps, SVD unitarization U V^H per
// link, and the ordered product by associative scan.  For states w laid
// out as (outer, L, inner, S, F) -- any grid axis is the L of such a
// view, with no copy -- each string (o, i) gets
//   P = W_0 W_1 ... W_{L-2},  W_l = polar(M_l),  M_l = <w_l | w_{l+1}>
// written to prod (outer, inner, S, S), and the smallest singular value
// of its links to smin (outer, inner).
//
// What bounds it on the H100: reading the states, outer*L*inner*S*F*16
// bytes; the overlaps take S*S*F complex multiply-adds per link and the
// polar factors and the chain O(S^3) more, which bound it from S ~ 16 on.
// The log-depth scan of the TPU becomes two launches, since the links'
// polar factors are independent and only the product chains them.  Phase
// 1 (wilson_links_kernel) gives every link of the grid a team of its own,
// a warp (S <= 32; the wrapper, ops/berry.py, takes it to S 28) or a block
// of 256 threads: it stages the two state panels in shared memory by
// cp.async, forms M there, runs the one-sided Jacobi of link_polar.cuh (a
// round of disjoint column pairs ends in __syncwarp for a warp), and
// writes W_l and the link's smallest singular value to scratch (strings x
// (L - 1) x S x S, and strings x (L - 1)).  Phase 2 (wilson_chain_kernel)
// gives each string a block that multiplies W_0 ... W_{L-2} in shared
// memory -- as the plain version's pairwise tree where the string's
// factors fit (S 1 to 16 on 32-41 links), else in order with the next
// factor loading by cp.async while the block multiplies -- and takes the
// minimum of the links' singular values.  The products agree with the
// plain version's to rounding, not bit for bit.  S above 64 is refused.
#include "link_polar.cuh"

// Phase 1: link t = string * (L - 1) + l of the grid, one team (kTeam
// threads, the whole block) each.
template <int kTeam>
__global__ void __launch_bounds__(kTeam)
wilson_links_kernel(const cplx* __restrict__ w, cplx* __restrict__ links, double* __restrict__ link_smin,
                    int64_t L, int64_t inner, int S, int F) {
    extern __shared__ __align__(16) double smem[];
    cplx* M = (cplx*)smem;
    cplx* V = M + S * link_ld(S);
    double* sig = (double*)(V + S * link_vld(S));
    const int64_t t = blockIdx.x;
    const int64_t string = t / (L - 1), l = t % (L - 1);
    const int64_t i = string % inner, o = string / inner;
    const int64_t SF = (int64_t)S * F;
    const cplx* wa = w + ((o * L + l) * inner + i) * SF;
    team_overlap<kTeam>(wa, wa + inner * SF, M, V, S, F);
    team_jacobi<kTeam>(M, V, S);
    const double smin = team_polar_store<kTeam>(M, V, S, sig, links + t * S * S);
    if (threadIdx.x == 0) link_smin[t] = smin;
}

// Phase 2: string s = blockIdx.x multiplies its nl = L - 1
// factors.  Where they fit in shared memory with half as many again
// (tree), all load at once and multiply as a pairwise tree, level by
// level between two buffers, in the order of the plain version's
// _chain_product (an odd last factor moves up a level as it is);
// otherwise in order, P <- P W_l, with W_{l+1} in flight while P W_l
// forms.
__global__ void __launch_bounds__(kBlockThreads)
wilson_chain_kernel(const cplx* __restrict__ links, const double* __restrict__ link_smin,
                    cplx* __restrict__ prod, double* __restrict__ smin_out, int64_t nl, int S, int tree) {
    extern __shared__ __align__(16) double smem[];
    const int tid = threadIdx.x;
    const int SS = S * S;
    const int64_t s = blockIdx.x;
    const cplx* Ws = links + s * nl * SS;
    cplx* P = (cplx*)smem;
    if (tree) {
        cplx* A = P;
        cplx* B = A + nl * SS;
        for (int64_t e = tid; e < nl * SS; e += kBlockThreads) cp_async16(A + e, Ws + e);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        for (int m = (int)nl; m > 1; m = m / 2 + (m & 1)) {
            const int pairs = m / 2;
            for (int e = tid; e < pairs * SS; e += kBlockThreads) {
                const int i = e / SS, r = (e % SS) / S, c = e % S;
                const cplx* X = A + 2 * i * SS;
                const cplx* Y = X + SS;
                cplx a = make_cuDoubleComplex(0.0, 0.0);
                for (int k = 0; k < S; ++k) a = cuCadd(a, cuCmul(X[r * S + k], Y[k * S + c]));
                B[e] = a;
            }
            if (m & 1)
                for (int e = tid; e < SS; e += kBlockThreads) B[pairs * SS + e] = A[(m - 1) * SS + e];
            __syncthreads();
            cplx* t = A;
            A = B;
            B = t;
        }
        P = A;
    } else {
        cplx* Wb[2] = {P + SS, P + 2 * SS};
        for (int e = tid; e < SS; e += kBlockThreads) cp_async16(P + e, Ws + e);
        if (nl > 1)
            for (int e = tid; e < SS; e += kBlockThreads) cp_async16(Wb[1] + e, Ws + SS + e);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        for (int64_t l = 1; l < nl; ++l) {
            if (l + 1 < nl) {
                cplx* next = Wb[(l + 1) & 1];
                const cplx* src = Ws + (l + 1) * SS;
                for (int e = tid; e < SS; e += kBlockThreads) cp_async16(next + e, src + e);
                cp_async_commit();
            }
            block_mul_left(P, Wb[l & 1], S);  // P <- P W_l
            cp_async_wait<0>();
            __syncthreads();
        }
    }
    cplx* out = prod + s * SS;
    for (int e = tid; e < SS; e += kBlockThreads) out[e] = P[e];
    if (tid < 32) {
        double m = 1.0e300;
        for (int64_t l = tid; l < nl; l += 32) m = fmin(m, link_smin[s * nl + l]);
        for (int off = 16; off > 0; off >>= 1) m = fmin(m, __shfl_xor_sync(0xffffffffu, m, off));
        if (tid == 0) smin_out[s] = m;
    }
}

// The chain's pairwise tree takes a string whose factors, and half as many
// again, fit in this much shared memory (S 16 at 32 links: 192 kB).
constexpr size_t kChainTreeBytes = 200 * 1024;

// block 0: a warp a link (S <= 32); block 1: a block a link (S <= 64).
// links (strings * (L - 1) * S * S complex) and link_smin (strings *
// (L - 1) doubles) are scratch.
extern "C" int pythtb_wilson_loop(const void* w, void* prod, void* smin, void* links, void* link_smin,
                                  int64_t outer, int64_t L, int64_t inner, int64_t S, int64_t F, int64_t block,
                                  void* stream) {
    if (outer * inner <= 0) return (int)cudaGetLastError();
    cudaStream_t st = (cudaStream_t)stream;
    if (S < 1 || S > (block ? kPolarBlockMaxS : 32) || block < 0 || block > 1 || L < 2)
        return (int)cudaErrorInvalidValue;
    const int64_t strings = outer * inner;
    const size_t bytes = link_smem((int)S);
    if (!block) {
        cudaFuncSetAttribute(wilson_links_kernel<32>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
        wilson_links_kernel<32><<<(unsigned int)(strings * (L - 1)), 32, bytes, st>>>(
            (const cplx*)w, (cplx*)links, (double*)link_smin, L, inner, (int)S, (int)F);
    } else {
        cudaFuncSetAttribute(wilson_links_kernel<kBlockThreads>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
        wilson_links_kernel<kBlockThreads><<<(unsigned int)(strings * (L - 1)), kBlockThreads, bytes, st>>>(
            (const cplx*)w, (cplx*)links, (double*)link_smin, L, inner, (int)S, (int)F);
    }
    const int rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
    const size_t mat = (size_t)S * S * sizeof(cplx);
    const size_t tree_bytes = (size_t)((L - 1) + L / 2) * mat;
    const int tree = tree_bytes <= kChainTreeBytes;
    const size_t chain = tree ? tree_bytes : 3 * mat;
    cudaFuncSetAttribute(wilson_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)chain);
    wilson_chain_kernel<<<(unsigned int)strings, kBlockThreads, chain, st>>>(
        (const cplx*)links, (const double*)link_smin, (cplx*)prod, (double*)smin, L - 1, (int)S, tree);
    return (int)cudaGetLastError();
}
