// EGNN edge-chain kernels for NVIDIA Hopper (sm_90a): fp32 in and out, the
// product by W2 on the tensor cores, as a three-term TF32 split
// (edge_chain_mma) or, in the bf16 variants, as one bf16 product with fp32
// sums (edge_chain_wgmma).
//
// Replaces the two Pallas TPU kernels of the JAX package,
// diffndm_tpu/ops/pallas_egnn.py:
//
//   egnn_gcl_messages        <- gcl_messages (_gcl_kernel)
//       out_i = sum_j adj_ij * m_ij / norm_factor,           out [B, N, H]
//       z_ij  = silu(a_i + b_j + d2c_ij * we0 + d2i_ij * we1)
//       m_ij  = silu(z_ij @ W2 + b2) [* sigmoid(m_ij . watt + batt)]
//
//   egnn_edge_vector_reduce  <- edge_vector_reduce (_vec_kernel)
//       out_i = sum_j adj_ij * phi_ij * v_ij / norm_factor,  out [B, N, 3]
//       phi_ij = m_ij . wout  [tanh(.) * coords_range]
//       v_ij   = (x_i - x_j) / (sqrt(|x_i - x_j|^2 + 1e-8) + norm_constant)
//             or ((x_i - c) x (x_j - c)) / (|.| + norm_constant)   (cross)
//       only rows < n_rows are computed; the caller zeroes the rest.
//   egnn_edge_vector_reduce_pair: the same for two weight sets (difference
//       and cross direction) in one launch, one output plane per set.
//   The entries *_bf16 port the Pallas kernels' mxu_dtype = bfloat16 mode
//       (EGNNConfig.compute_dtype = "bfloat16"): z, W2, m and watt / wout
//       are rounded to bf16 (nearest even) as the operands of their
//       products, whose sums stay fp32; everything else is fp32.
//
// What bounds them on this card.  Per edge with a nonzero adjacency the
// chain costs 2*H^2 FLOPs for the product by W2 (73.7 kFLOP at H=192)
// against a few bytes of edge input and O(N*H) node input: far above the
// ridge point of the tensor cores.  Beside the product, every edge computes
// 2*H silu (z, then m) and the H pre-activations of z: per (edge, k) about
// 30 FP32-pipe instructions and, per silu, one ex2 and one reciprocal on
// the special-function units (16 per SM per clock).  Under TF32x3 (three
// products at 495 TFLOP/s) the tensor cores bound the chain; in bf16 (one
// product at 989 TFLOP/s) the special functions do: at H = 128, 4*H of
// them per edge take ~4x the product's tensor time.  At the sampler's
// shapes either bound is a few microseconds, below the cost of a launch,
// so what matters is that the card is filled and that no work is done for
// edges the cutoff graph does not have.
//
// Common to both kernels:
//   * A block owns R whole output rows of one batch element: every G-th
//     row from its own index on (G = blocks per batch element), so that
//     the dense ligand rows and the sparse pocket rows are dealt evenly.
//     R is picked at launch from B, n_rows and the SM count so that the
//     grid is one block per SM or fewer: a pass of a block takes the same
//     time whether one or all of its warps have a tile, so one wave of
//     fuller blocks beat two waves of emptier ones on the card.  Only
//     blocks with rows to compute are launched.  Each row is reduced
//     inside its block in a fixed order and written once: no atomics, the
//     same bits from run to run.
//   * Compacted edge tiles.  The block first gathers the (row, column)
//     pairs of its rows with adj != 0 into a list in shared memory, row by
//     row (ballot + popcount prefix).  Each warp then takes 16 consecutive
//     list entries as the 16 rows of its tile (8 warps: 128 edges a pass);
//     only the last tile of a block is ragged, so the work is that of the
//     real edges.
//   * z never touches shared memory: it is elementwise in (edge, k), so
//     each thread computes exactly the A-fragment elements it owns from
//     a_i (shared memory), b_j (global, read-only path, fetched one step
//     ahead), we and the two distances, 16 k at a time from float4 loads.
//     Thread (g, t) of a warp computes k = 4t..4t+3 of its edges g and
//     g+8; the order of k inside a group of 16 is permuted the same way
//     for A and for the rows of W2, which keeps those loads 16 bytes wide.
//   * A warp holds its 16 x H accumulator tile (H/2 registers a thread, the
//     m16n8 layout), so bias, silu, the dot with watt / wout, the gate, the
//     direction math and the multiplication by adj_ij all happen on
//     registers.  Rows are summed per distinct row of the tile with a
//     halving exchange of warp shuffles (each lane ends with H/32 sums); a
//     row that continues from the previous tile goes through a per-warp
//     buffer that is folded in warp order, every other row has one writer.
//
// edge_chain_mma (fp32):
//   * The product runs as mma.sync.aligned.m16n8k8 TF32 with fp32
//     accumulators.  v3b is an fp32 model, so both operands are split into
//     a TF32 "big" part and a TF32 remainder and three products are
//     accumulated (big*small, small*big, big*big): fp32-level accuracy.
//     mma.sync was taken over wgmma because TF32 wgmma wants both operands
//     K-major in shared memory and 64-row tiles; mma.sync needs no
//     descriptors, swizzle or transposed weight copy.
//   * The tensor cores' fp32 accumulation truncates toward zero, so a sum
//     carried through many mma.sync drifts one way.  On the first forward
//     of a joint run (dense [16, 584, H] clouds, every row moving) the
//     carried sum missed the kernel-vs-plain gate by 2.3x at H = 128 and
//     7.3x at H = 256.  So each chunk's six products (two k-steps of the
//     three terms) go into zeroed accumulators, added to the running sum
//     with one rounded add: at most 0.47 of the gate there.  At H = 128
//     this costs ~1 %; at H = 192 / 256 the added registers spill and the
//     kernel is 10-55 % slower (scripts/forward_build_ab.py).
//   * W2 arrives already split and laid out for shared memory
//     ([H/16, 16, H+4, 2]: chunks of 16 rows of (big, remainder) pairs,
//     padded rows), which the wrapper computes once per weight tensor.
//     One 8-byte load feeds a B fragment of both parts, free of bank
//     conflicts.  The chunks stream through a 4-stage ring, each asked for
//     by one thread as one bulk copy (cp.async.bulk) that reports to an
//     mbarrier: chunk c+3 lands while chunk c multiplies, with one
//     __syncthreads per chunk to free a stage.  W2 crosses L2 -> shared
//     memory once per pass of 128 edges; the ring keeps running across
//     passes, so an epilogue overlaps the next copies.
//   * One block of 8 warps per SM: the accumulators put a thread at
//     ~190-255 registers.  More warps (12 at H=192) were slower on the
//     card: two warps per scheduler already keep mma.sync busy.  Where the
//     time of a pass goes at H=192 (-DEGNN_PROFILE): about 70 % in the mma
//     loop, 25 % in the epilogue, the rest in waiting for chunks.
//
// edge_chain_wgmma (bf16), shaped by its bound, the special functions:
//   * The product is wgmma.mma_async m64nHk16 bf16 with fp32 accumulators,
//     one instruction per k-step of 16 for the whole width H; each of the
//     two warpgroups multiplies its four warps' 64 edges.  A comes from
//     registers: a warp's rows of the warpgroup's A have m16n8k16's
//     fragment layout, so thread (g, t) packs its z of k = 4t, 4t+1 into
//     slots 2t, 2t+1 and of k = 4t+2, 4t+3 into slots 2t+8, 2t+9
//     (cvt.rn.bf16x2.f32), and the accumulator has the m16n8 layout the
//     epilogue reads.  A warp whose tile lies past the list feeds zeros; a
//     warpgroup with no edge skips the product.
//   * The product overlaps the elementwise chain: the warpgroup issues the
//     wgmma of k-step c - 1, computes z of step c into the other of two
//     sets of A registers, waits until the product of step c - 2 (the last
//     reader of that set) is done, and issues step c.  The k-steps are
//     unrolled whole: in a loop the compiler cannot tell the two sets
//     apart across the back edge and waits for each product as soon as it
//     is issued.  There is little to hide: on an H100 a k-step's product
//     takes ~70-140 cycles of the ~800 that its z takes, and that
//     serialised loop measured 0-6.5 % faster (scripts/forward_build_ab.py).
//   * W2 stays in shared memory whole for the block's life: 32 / 72 / 128
//     KB in bf16 at H = 128 / 192 / 256, asked for once by one thread as
//     H/64 bulk copies to one mbarrier while the block builds its edge
//     list.  No ring, no barrier per chunk: the block synchronises twice
//     per pass of 128 edges in gcl_messages (the fold of the per-warp row
//     heads) and not at all in the vector kernel.  The wrapper packs W2
//     once per weight tensor in wgmma's K-major layout with the 128-byte
//     swizzle ([H/64, H, 64] bf16: slab s holds k = 64s..64s+63, row n the
//     64 of column n, the 16-byte group q of row n at q ^ (n % 8), k
//     permuted inside each 16 as the A slots are), which reads free of
//     bank conflicts; the slab starts 1024-byte aligned.
//   * Shared memory (bytes): 1024 alignment + 2*H^2 (W2) + 16 (barrier) +
//     4 * (16*H a rows + 4*H weights + (gcl) 24*H row sums and heads + 28)
//     = 56,448 / 108,672 / 177,280 for gcl_messages at H = 128 / 192 / 256
//     and 44,160 / 90,240 / 152,704 for the vector kernel, plus 4 (gcl) or
//     16 (vector) bytes per candidate edge, R * N.  pick_rows lowers R
//     until it fits 232,448 bytes: at H = 256 and N = 344, 16 rows of
//     gcl_messages take 199,296 bytes; R = 1 fits any N up to 4096.
//   * The silu of z and of m is the fast one (__expf and __fdividef, as
//     the fp32 kernel's); z's pre-activation is summed in the plain
//     version's order without contraction, so z differs from the plain
//     version's only by the silu's last bits before its bf16 rounding.
//     Held to the bf16 gates of chip_smoke.py: at most 0.42 of the kernel
//     gate (1e-3 of the largest plain element) on [modes] (a)'s calls, and
//     0.238 A of the 10-step trajectory's 0.34 A.  The exact silu (expf,
//     an IEEE divide) read the same gate shares and 0.289 A, 1.5-2.1x
//     slower.
//   * The sum over k is carried in the accumulators across the H/16
//     k-steps (scale-d): with a 64 x H accumulator a second set for a
//     zeroed sum per chunk would take H/2 more registers (256 at H = 256).
//     The truncation that the fp32 kernel corrects for stays far inside
//     the bf16 gate: 0.13 of it at the joint first forward [16, 584, 128],
//     where the fp32 drift showed.
//   * No spill at any H (159-255 registers): b_j is read with a load the
//     compiler keeps in place (hoisted, every k-step's b_j sat in
//     registers at once), the epilogue reads its bias and weight four
//     column blocks at a time behind a __syncwarp (hoisted, H/2 registers
//     beside acc), the row sums go by parts of 64 columns, and the output
//     pointer is read where it is written.
//   * The gate or phi dot multiplies m rounded to bf16 by watt / wout
//     rounded to bf16 (staged so in shared memory), summed in fp32; the
//     gate multiplies the unrounded m, as the Pallas kernel does.
//   * One block of 8 warps (two warpgroups) per SM, as the fp32 kernel.
//     At H = 128 two blocks per SM (at most 128 registers a thread) ran
//     the joint first forward 23-31 % faster, but spilled 8-20 bytes.
// The rounding of the aggregate to bf16 on the way out, and of h, the
// coordinates, d2i, adj and W_e on the way in, is the caller's.
//
// Left for later work: the last pass of a block often has tiles for a few
// warps only (split such a tile's columns over the idle warps); the list
// is built from two reads of adj; single-pass TF32 once a chemistry
// metric can judge it; d2 and adjacency computed inside the kernel; the
// bf16 kernel at H = 128 in 128 registers, for two blocks per SM; its
// epilogue (the silu of m, half its special functions) overlapped with
// the next pass's z chain, where registers allow a second accumulator.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "egnn_mma.cuh"
#include "egnn_wgmma.cuh"

// -DEGNN_PROFILE: thread 0 of every block adds the cycles it spends in
// each phase to g_prof (0 set-up and compaction, 1 waiting for a chunk of
// W2 (bf16: for the whole of W2), 2 asking for the next (fp32 only), 3 the
// product loop with the z chain, 4 the whole loop over the passes, 6
// passes, 7 blocks); egnn_read_profile copies the sums out and clears them.
#ifdef EGNN_PROFILE
__device__ unsigned long long g_prof[8];
#define PROF_T(v) const long long v = clock64()
#define PROF_ADD(i, a, b)                                               \
    if (threadIdx.x == 0) atomicAdd(&g_prof[i], (unsigned long long)((b) - (a)))
extern "C" int egnn_read_profile(unsigned long long* dst) {
    const unsigned long long zero[8] = {0};
    cudaError_t e = cudaDeviceSynchronize();
    if (e == cudaSuccess) e = cudaMemcpyFromSymbol(dst, g_prof, sizeof(zero));
    if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_prof, zero, sizeof(zero));
    return (int)e;
}
#else
#define PROF_T(v)
#define PROF_ADD(i, a, b)
#endif

namespace {

constexpr int NW = 8;                // warps per block
constexpr int THREADS = 32 * NW;
constexpr int TM = 16;               // edges per warp tile (mma M)
constexpr int KC = 16;               // W2 rows per ring stage (fp32)
constexpr int STAGES = 4;
constexpr int NG = 4;                // column tiles per group of mma
constexpr int R_MAX = 16;            // most rows a block owns
constexpr int SMEM_LIMIT = 232448;   // bytes a block may use on sm_90
constexpr unsigned FULL = 0xffffffffu;

struct WeightSet {
    const float* a;       // [B, N, H]
    const float* b;       // [B, N, H]
    const float* we;      // [2, H]
    const float* w2;      // fp32: [H/16, 16, H+4, 2] split, laid out for the
                          // ring; bf16: [H/64, H, 64] bf16 for wgmma
    const float* b2;      // [H]
    const float* wvec;    // [H]: attention weight or phi weight
    float* out;           // [B, N, H] (gcl) or [B, N, 3] (vec)
    int cross;            // vec only
};

struct EdgeArgs {
    WeightSet s[2];       // blockIdx.z picks the set
    const float* d2c;     // [B, N, N]
    const float* d2i;     // [B, N, N]
    const float* adj;     // [B, N, N]
    const float* batt;    // [1] (gcl)
    const float* x;       // [B, N, 3] (vec)
    const float* center;  // [B, 1, 3] (vec)
    int N;
    int n_rows;           // rows computed (N for gcl)
    int R;                // rows per block
    int flag_a;           // gcl: attention; vec: tanh
    float coords_range;
    float norm_constant;
    float norm_factor;
};

__device__ __forceinline__ float silu_fast(float v) {
    return __fdividef(v, 1.0f + __expf(-v));
}

// the silu of the bf16 kernel's z and m
__device__ __forceinline__ float silu_bf16(float v) { return silu_fast(v); }

__device__ __forceinline__ float sigmoid_f(float v) {
    return 1.0f / (1.0f + expf(-v));
}

// a read-only 16-byte load that stays where it is written: an __ldg may
// be hoisted over the wgmma fences, and every k-step's b_j then sits in
// registers at once
__device__ __forceinline__ float4 ldg_in_place(const float* ptr) {
    float4 v;
    asm volatile("ld.global.nc.v4.f32 {%0, %1, %2, %3}, [%4];"
                 : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "l"(ptr));
    return v;
}

// v rounded to bf16, nearest even, as a float
__device__ __forceinline__ float bf16_round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
}

// ---------------------------------------------------------------------------
// shared memory
// ---------------------------------------------------------------------------

// floats of the fp32 kernel's shared memory besides the edge list
template <int H, bool VEC>
constexpr int fixed_floats() {
    return 2 * STAGES                 // the ring's barriers (8 bytes each)
           + STAGES * KC * (H + 4) * 2      // W2 ring (padded rows)
           + R_MAX * H                // a rows
           + 4 * H                    // we0, we1, b2, wvec
           + (VEC ? 0 : (R_MAX + NW) * H)   // row sums, per-warp heads
           + R_MAX + 1 + NW + 3;      // row starts, head rows (ints), pad
}

// bytes of the bf16 kernel's shared memory besides the edge list: the
// alignment of W2, W2 whole, its barrier, then the fp32 kernel's arrays
// after its ring
template <int H, bool VEC>
constexpr size_t fixed_bytes_bf16() {
    return 1024 + 2 * H * H + 16
           + 4 * (size_t)(fixed_floats<H, VEC>() - 2 * STAGES
                          - STAGES * KC * (H + 4) * 2);
}

// the edge list: 4 bytes per entry, 16 with the per-edge vector
// contributions
template <int H, bool VEC, bool BF>
constexpr size_t smem_bytes(int list_len) {
    return (BF ? fixed_bytes_bf16<H, VEC>()
               : (size_t)fixed_floats<H, VEC>() * 4)
           + (size_t)list_len * (VEC ? 16 : 4);
}

// ---------------------------------------------------------------------------
// the bf16 kernel's compaction, edge loads, epilogues and writes.  The fp32
// kernel below computes the same inline: written through these functions
// its SASS changed (spills at H = 192 / 256 moved, +3 % at [16, 80, 192]),
// and its code is held equal to its earlier SASS
// (scripts/forward_build_ab.py --bf16).
// ---------------------------------------------------------------------------

// the (local row, column) of every adj != 0 of the block's rows, row-major,
// into elist; row_start[lr] .. row_start[lr + 1] are row lr's entries.
// Returns the count; all threads of the block take part.
template <typename RowOf>
__device__ __forceinline__ int compact_edges(const float* adj_b, int N,
                                             int nrow, RowOf grow,
                                             int* row_start, int* elist) {
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    for (int lr = warp; lr < nrow; lr += NW) {
        const float* arow = adj_b + (size_t)grow(lr) * N;
        int cnt = 0;
        for (int c0 = 0; c0 < N; c0 += 32) {
            int col = c0 + lane;
            bool nz = col < N && arow[col] != 0.f;
            cnt += __popc(__ballot_sync(FULL, nz));
        }
        if (lane == 0) row_start[lr + 1] = cnt;
    }
    __syncthreads();
    if (tid == 0) {
        row_start[0] = 0;
        for (int lr = 0; lr < nrow; ++lr) row_start[lr + 1] += row_start[lr];
    }
    __syncthreads();
    for (int lr = warp; lr < nrow; lr += NW) {
        const float* arow = adj_b + (size_t)grow(lr) * N;
        int base = row_start[lr];
        for (int c0 = 0; c0 < N; c0 += 32) {
            int col = c0 + lane;
            bool nz = col < N && arow[col] != 0.f;
            unsigned m = __ballot_sync(FULL, nz);
            if (nz) elist[base + __popc(m & ((1u << lane) - 1u))] =
                        (lr << 16) | col;
            base += __popc(m);
        }
    }
    __syncthreads();
    return row_start[nrow];
}

// this thread's two edges of its warp's tile: list entries g and g + 8
struct EdgePair {
    bool v_lo, v_hi;
    int e_lo, e_hi, lr_lo, lr_hi, col_lo, col_hi;
    float adj_lo, adj_hi, dc_lo, dc_hi, di_lo, di_hi;
};

// an edge past the list computes on (row 0, column 0) with adj 0
template <typename RowOf>
__device__ __forceinline__ EdgePair load_pair(const EdgeArgs& p,
                                              const int* elist, int n_edges,
                                              int tile0, int bi, RowOf grow) {
    const int g = (threadIdx.x & 31) >> 2;
    const int N = p.N;
    EdgePair e;
    e.e_lo = tile0 + g;
    e.e_hi = e.e_lo + 8;
    e.v_lo = e.e_lo < n_edges;
    e.v_hi = e.e_hi < n_edges;
    int pk_lo = e.v_lo ? elist[e.e_lo] : 0;
    int pk_hi = e.v_hi ? elist[e.e_hi] : 0;
    e.lr_lo = pk_lo >> 16; e.col_lo = pk_lo & 0xffff;
    e.lr_hi = pk_hi >> 16; e.col_hi = pk_hi & 0xffff;
    size_t o_lo = ((size_t)bi * N + grow(e.lr_lo)) * N + e.col_lo;
    size_t o_hi = ((size_t)bi * N + grow(e.lr_hi)) * N + e.col_hi;
    e.adj_lo = e.v_lo ? __ldg(p.adj + o_lo) : 0.f;
    e.adj_hi = e.v_hi ? __ldg(p.adj + o_hi) : 0.f;
    e.dc_lo = e.v_lo ? __ldg(p.d2c + o_lo) : 0.f;
    e.dc_hi = e.v_hi ? __ldg(p.d2c + o_hi) : 0.f;
    e.di_lo = e.v_lo ? __ldg(p.d2i + o_lo) : 0.f;
    e.di_hi = e.v_hi ? __ldg(p.d2i + o_hi) : 0.f;
    return e;
}

// gcl epilogue of an active tile, after the gate: the tile's rows summed
// over its edges (m * f * adj), the first row into the warp's head
// buffer, every other row into its row sum; then head_row[warp].  Each
// row goes by parts of 64 columns, so that 16 registers hold a part's
// sums beside acc
template <int NT>
__device__ __forceinline__ void tile_row_sums(const float (&acc)[NT][4],
                                              const EdgePair& e, float f_lo,
                                              float f_hi, const int* elist,
                                              int tile0, int tile_n,
                                              float* rowsum, float* head,
                                              int* head_row) {
    constexpr int H = NT * 8;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int t = lane & 3;
    const int rf = elist[tile0] >> 16;
    const int rl = elist[tile0 + tile_n - 1] >> 16;
    for (int r = rf; r <= rl; ++r) {
        const bool lo = e.v_lo && e.lr_lo == r;
        const bool hi = e.v_hi && e.lr_hi == r;
        if (!__any_sync(FULL, lo || hi)) continue;
        float* dst = (r == rf) ? head + warp * H : rowsum + r * H;
        // this row's share of the thread's two edges
        const float sl = lo ? f_lo * e.adj_lo : 0.f;
        const float sh = hi ? f_hi * e.adj_hi : 0.f;
        // sum over the 8 lanes that share t, halving what a lane keeps at
        // each step: it ends with two sums, columns 2t, 2t + 1 of one
        // block of 8
        const bool up1 = lane & 16, up2 = lane & 8, up3 = lane & 4;
        const int base = (up1 ? 8 : 0) + (up2 ? 4 : 0) + (up3 ? 2 : 0);
#pragma unroll
        for (int q = 0; q < NT / 8; ++q) {
            float v[16];
#pragma unroll
            for (int nt = 0; nt < 8; ++nt) {
                v[2 * nt] = acc[8 * q + nt][0] * sl + acc[8 * q + nt][2] * sh;
                v[2 * nt + 1] =
                    acc[8 * q + nt][1] * sl + acc[8 * q + nt][3] * sh;
            }
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                const float keep = up1 ? v[j + 8] : v[j];
                const float send = up1 ? v[j] : v[j + 8];
                v[j] = keep + __shfl_xor_sync(FULL, send, 16);
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const float keep = up2 ? v[j + 4] : v[j];
                const float send = up2 ? v[j] : v[j + 4];
                v[j] = keep + __shfl_xor_sync(FULL, send, 8);
            }
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                const float keep = up3 ? v[j + 2] : v[j];
                const float send = up3 ? v[j] : v[j + 2];
                v[j] = keep + __shfl_xor_sync(FULL, send, 4);
            }
            *reinterpret_cast<float2*>(dst + (8 * q + (base >> 1)) * 8
                                       + 2 * t) = make_float2(v[0], v[1]);
        }
    }
    if (lane == 0) head_row[warp] = rf;
}

// fold the tiles' first-row sums into the row sums in warp order
template <int H>
__device__ __forceinline__ void fold_heads(float* rowsum, const float* head,
                                           const int* head_row) {
    for (int col = threadIdx.x; col < H; col += THREADS) {
#pragma unroll
        for (int w = 0; w < NW; ++w) {
            const int r = head_row[w];
            if (r >= 0) rowsum[r * H + col] += head[w * H + col];
        }
    }
}

// vector epilogue of an active tile, lanes with t == 0: each valid edge's
// phi * adj * v_ij into contrib
template <typename RowOf>
__device__ __forceinline__ void edge_contribs(const EdgeArgs& p,
                                              const WeightSet& ws,
                                              const EdgePair& e, float dot_lo,
                                              float dot_hi, int bi,
                                              RowOf grow, float* contrib) {
    const int N = p.N;
    const float* ctr = p.center + (size_t)bi * 3;
#pragma unroll
    for (int side = 0; side < 2; ++side) {
        const bool valid = side ? e.v_hi : e.v_lo;
        if (!valid) continue;
        const float dot = side ? dot_hi : dot_lo;
        const float av = side ? e.adj_hi : e.adj_lo;
        const int idx = side ? e.e_hi : e.e_lo;
        const int row = grow(side ? e.lr_hi : e.lr_lo);
        const int col = side ? e.col_hi : e.col_lo;
        const float* xr = p.x + ((size_t)bi * N + row) * 3;
        const float* xc = p.x + ((size_t)bi * N + col) * 3;
        const float phi = p.flag_a ? tanhf(dot) * p.coords_range : dot;
        const float w = phi * av;
        float v0, v1, v2, inv;
        if (ws.cross) {
            float a0 = xr[0] - ctr[0], a1 = xr[1] - ctr[1],
                  a2 = xr[2] - ctr[2];
            float c0 = xc[0] - ctr[0], c1 = xc[1] - ctr[1],
                  c2 = xc[2] - ctr[2];
            v0 = a1 * c2 - a2 * c1;
            v1 = a2 * c0 - a0 * c2;
            v2 = a0 * c1 - a1 * c0;
            float nrm = sqrtf(v0 * v0 + v1 * v1 + v2 * v2);
            inv = w / (nrm + p.norm_constant);
        } else {
            v0 = xr[0] - xc[0];
            v1 = xr[1] - xc[1];
            v2 = xr[2] - xc[2];
            float radial = v0 * v0 + v1 * v1 + v2 * v2;
            inv = w / (sqrtf(radial + 1e-8f) + p.norm_constant);
        }
        contrib[idx * 3 + 0] = v0 * inv;
        contrib[idx * 3 + 1] = v1 * inv;
        contrib[idx * 3 + 2] = v2 * inv;
    }
}

// write the block's rows to out, each once (after a __syncthreads)
template <int H, bool VEC, typename RowOf>
__device__ __forceinline__ void write_rows(const EdgeArgs& p, float* out_b,
                                           int bi, int nrow, RowOf grow,
                                           const float* rowsum,
                                           const int* row_start,
                                           const float* contrib) {
    const int N = p.N;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    if (!VEC) {
        for (int i = tid; i < nrow * H; i += THREADS)
            out_b[((size_t)bi * N + grow(i / H)) * H + i % H] =
                rowsum[i] / p.norm_factor;
    } else {
        for (int lr = warp; lr < nrow; lr += NW) {
            float s0 = 0.f, s1 = 0.f, s2 = 0.f;
            for (int e = row_start[lr] + lane; e < row_start[lr + 1]; e += 32) {
                s0 += contrib[e * 3 + 0];
                s1 += contrib[e * 3 + 1];
                s2 += contrib[e * 3 + 2];
            }
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) {
                s0 += __shfl_xor_sync(FULL, s0, off);
                s1 += __shfl_xor_sync(FULL, s1, off);
                s2 += __shfl_xor_sync(FULL, s2, off);
            }
            if (lane == 0) {
                float* out = out_b + ((size_t)bi * N + grow(lr)) * 3;
                out[0] = s0 / p.norm_factor;
                out[1] = s1 / p.norm_factor;
                out[2] = s2 / p.norm_factor;
            }
        }
    }
}

// ---------------------------------------------------------------------------
// the fp32 kernel: TF32x3 mma.sync, W2 through a ring
// ---------------------------------------------------------------------------

// VEC = false: gcl_messages; VEC = true: edge_vector_reduce
template <int H, bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
edge_chain_mma(const EdgeArgs p) {
    constexpr int LD = H + 4;         // 8-byte entries per padded row; = 4
                                      // mod 16: B loads hit all banks
    constexpr int NT = H / 8;         // mma N tiles of a warp
    constexpr int NC = H / KC;        // ring chunks per pass over W2
    constexpr int SF = KC * (H + 4) * 2;    // floats of a ring stage
    extern __shared__ __align__(16) float smem[];
    uint64_t* full = reinterpret_cast<uint64_t*>(smem);
    float* ring = smem + 2 * STAGES;
    float* as = ring + STAGES * SF;
    float* we0 = as + R_MAX * H;
    float* we1 = we0 + H;
    float* b2s = we1 + H;
    float* wvs = b2s + H;
    float* rowsum = wvs + H;                              // gcl only
    float* head = rowsum + (VEC ? 0 : R_MAX * H);         // gcl only
    int* row_start = reinterpret_cast<int*>(head + (VEC ? 0 : NW * H));
    int* head_row = row_start + R_MAX + 1;
    int* elist = head_row + NW;       // R * N entries at most

    const int N = p.N;
    const int R = p.R;
    const int bi = blockIdx.y;
    // the block's rows are blockIdx.x, blockIdx.x + gridDim.x, ...: dense
    // (ligand) and sparse (pocket) rows are dealt round the blocks
    const int G = gridDim.x;
    auto grow = [&](int lr) { return (int)blockIdx.x + lr * G; };
    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int row_limit = p.n_rows < N ? p.n_rows : N;
    const int nrow = (row_limit - (int)blockIdx.x + G - 1) / G;   // <= R
    const WeightSet ws = blockIdx.z ? p.s[1] : p.s[0];
    // vec only: three floats per list entry, after the list
    float* contrib = reinterpret_cast<float*>(elist + R * N);

    // ring stage q (mod STAGES) <- chunk q mod NC of W2: 16 rows of
    // (big, remainder) pairs, laid out by the wrapper exactly as they lie
    // here (row stride H + 4 pairs; row 4*i + j of a chunk at 4*j + i, so
    // that thread t finds the rows of its four k values 4t..4t+3 at t,
    // t+4, t+8, t+12, the positions the B fragments of two k-steps read).
    // One thread asks for the whole chunk as one bulk copy.
    PROF_T(p_start);
    constexpr uint32_t CHUNK_BYTES = SF * 4;
    auto request_chunk = [&](int q) {
        if (tid == 0)
            bulk_load(ring + (q % STAGES) * SF,
                      ws.w2 + (size_t)(q % NC) * SF, CHUNK_BYTES,
                      full + q % STAGES);
    };
    if (tid == 0) {
#pragma unroll
        for (int s = 0; s < STAGES; ++s) mbar_init(full + s, 1);
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
#pragma unroll
        for (int s = 0; s < STAGES - 1; ++s) request_chunk(s);
    }

    for (int i = tid; i < nrow * H; i += THREADS)
        as[i] = ws.a[((size_t)bi * N + grow(i / H)) * H + i % H];
    for (int i = tid; i < H; i += THREADS) {
        we0[i] = ws.we[i];
        we1[i] = ws.we[H + i];
        b2s[i] = ws.b2[i];
        wvs[i] = ws.wvec[i];
    }
    if (!VEC)
        for (int i = tid; i < R_MAX * H; i += THREADS) rowsum[i] = 0.f;

    // ---- compaction: (local row, column) of every adj != 0, row-major ----
    const float* adj_b = p.adj + (size_t)bi * N * N;
    for (int lr = warp; lr < nrow; lr += NW) {
        const float* arow = adj_b + (size_t)grow(lr) * N;
        int cnt = 0;
        for (int c0 = 0; c0 < N; c0 += 32) {
            int col = c0 + lane;
            bool nz = col < N && arow[col] != 0.f;
            cnt += __popc(__ballot_sync(FULL, nz));
        }
        if (lane == 0) row_start[lr + 1] = cnt;
    }
    __syncthreads();
    if (tid == 0) {
        row_start[0] = 0;
        for (int lr = 0; lr < nrow; ++lr) row_start[lr + 1] += row_start[lr];
    }
    __syncthreads();
    const int n_edges = row_start[nrow];
    for (int lr = warp; lr < nrow; lr += NW) {
        const float* arow = adj_b + (size_t)grow(lr) * N;
        int base = row_start[lr];
        for (int c0 = 0; c0 < N; c0 += 32) {
            int col = c0 + lane;
            bool nz = col < N && arow[col] != 0.f;
            unsigned m = __ballot_sync(FULL, nz);
            if (nz) elist[base + __popc(m & ((1u << lane) - 1u))] =
                        (lr << 16) | col;
            base += __popc(m);
        }
    }
    __syncthreads();

    const float batt = (!VEC && p.flag_a) ? p.batt[0] : 0.f;
    PROF_T(p_compact);
    PROF_ADD(0, p_start, p_compact);
    PROF_ADD(7, 0, 1);
    const int n_pass = (n_edges + NW * TM - 1) / (NW * TM);
    const int n_chunks = n_pass * NC;

    // this thread's two edges of the warp's tile: list entries g and g + 8
    float acc[NT][4];
    bool active = false;              // warp-uniform: the tile has edges
    bool v_lo = false, v_hi = false;
    int e_lo = 0, e_hi = 0, lr_lo = 0, lr_hi = 0, col_lo = 0, col_hi = 0;
    float adj_lo = 0.f, adj_hi = 0.f, dc_lo = 0.f, dc_hi = 0.f;
    float di_lo = 0.f, di_hi = 0.f;
    const float* b_lo = ws.b;
    const float* b_hi = ws.b;
    float4 bl_next = make_float4(0.f, 0.f, 0.f, 0.f), bh_next = bl_next;
    int tile0 = 0, tile_n = 0;

    for (int q = 0; q < n_chunks; ++q) {
        const int c = q % NC;
        if (c == 0) {
            tile0 = ((q / NC) * NW + warp) * TM;
            tile_n = n_edges - tile0 < TM ? n_edges - tile0 : TM;
            active = tile_n > 0;
            e_lo = tile0 + g;
            e_hi = e_lo + 8;
            v_lo = e_lo < n_edges;
            v_hi = e_hi < n_edges;
            // an edge past the list computes on (row 0, column 0) with adj 0
            int pk_lo = v_lo ? elist[e_lo] : 0;
            int pk_hi = v_hi ? elist[e_hi] : 0;
            lr_lo = pk_lo >> 16; col_lo = pk_lo & 0xffff;
            lr_hi = pk_hi >> 16; col_hi = pk_hi & 0xffff;
            size_t o_lo = ((size_t)bi * N + grow(lr_lo)) * N + col_lo;
            size_t o_hi = ((size_t)bi * N + grow(lr_hi)) * N + col_hi;
            adj_lo = v_lo ? __ldg(p.adj + o_lo) : 0.f;
            adj_hi = v_hi ? __ldg(p.adj + o_hi) : 0.f;
            dc_lo = v_lo ? __ldg(p.d2c + o_lo) : 0.f;
            dc_hi = v_hi ? __ldg(p.d2c + o_hi) : 0.f;
            di_lo = v_lo ? __ldg(p.d2i + o_lo) : 0.f;
            di_hi = v_hi ? __ldg(p.d2i + o_hi) : 0.f;
            b_lo = ws.b + ((size_t)bi * N + col_lo) * H;
            b_hi = ws.b + ((size_t)bi * N + col_hi) * H;
            bl_next = __ldg(reinterpret_cast<const float4*>(b_lo + 4 * t));
            bh_next = __ldg(reinterpret_cast<const float4*>(b_hi + 4 * t));
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
                for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;
        }

        PROF_T(p_a);
        mbar_wait(full + q % STAGES, (q / STAGES) & 1);   // chunk q is here
        __syncthreads();              // all are done with chunk q-1's stage
        PROF_T(p_b);
        if (q + STAGES - 1 < n_chunks) request_chunk(q + STAGES - 1);
        PROF_T(p_c);
        PROF_ADD(1, p_a, p_b);
        PROF_ADD(2, p_b, p_c);

        if (active) {
            const int kq = c * KC + 4 * t;
            const float4 al = *reinterpret_cast<const float4*>(
                as + lr_lo * H + kq);
            const float4 ah = *reinterpret_cast<const float4*>(
                as + lr_hi * H + kq);
            const float4 bl = bl_next, bh = bh_next;
            if (c + 1 < NC) {     // the next chunk's b_j, ahead of the mma
                bl_next = __ldg(reinterpret_cast<const float4*>(
                    b_lo + kq + KC));
                bh_next = __ldg(reinterpret_cast<const float4*>(
                    b_hi + kq + KC));
            }
            const float4 w0 = *reinterpret_cast<const float4*>(we0 + kq);
            const float4 w1 = *reinterpret_cast<const float4*>(we1 + kq);
            const float2* wst = reinterpret_cast<const float2*>(
                ring + (q % STAGES) * SF);
            float zl[4], zh[4];
            zl[0] = silu_fast(fmaf(di_lo, w1.x, fmaf(dc_lo, w0.x, al.x + bl.x)));
            zl[1] = silu_fast(fmaf(di_lo, w1.y, fmaf(dc_lo, w0.y, al.y + bl.y)));
            zl[2] = silu_fast(fmaf(di_lo, w1.z, fmaf(dc_lo, w0.z, al.z + bl.z)));
            zl[3] = silu_fast(fmaf(di_lo, w1.w, fmaf(dc_lo, w0.w, al.w + bl.w)));
            zh[0] = silu_fast(fmaf(di_hi, w1.x, fmaf(dc_hi, w0.x, ah.x + bh.x)));
            zh[1] = silu_fast(fmaf(di_hi, w1.y, fmaf(dc_hi, w0.y, ah.y + bh.y)));
            zh[2] = silu_fast(fmaf(di_hi, w1.z, fmaf(dc_hi, w0.z, ah.z + bh.z)));
            zh[3] = silu_fast(fmaf(di_hi, w1.w, fmaf(dc_hi, w0.w, ah.w + bh.w)));
            // the chunk's two k-steps of 8: slots t and t + 4 hold
            // k = 4t + 2*half, +1
            uint32_t ab[2][4], asml[2][4];
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                split_tf32(zl[2 * half], ab[half][0], asml[half][0]);
                split_tf32(zh[2 * half], ab[half][1], asml[half][1]);
                split_tf32(zl[2 * half + 1], ab[half][2], asml[half][2]);
                split_tf32(zh[2 * half + 1], ab[half][3], asml[half][3]);
            }
            // NG column tiles at a time, one product term after the other,
            // so that one mma does not wait on the accumulator of the mma
            // just before it; the chunk's six products into zeroed
            // accumulators, then one rounded add each
#pragma unroll
            for (int n0 = 0; n0 < NT; n0 += NG) {
                float part[NG][4];
#pragma unroll
                for (int j = 0; j < NG; ++j)
#pragma unroll
                    for (int i = 0; i < 4; ++i) part[j][i] = 0.f;
#pragma unroll
                for (int half = 0; half < 2; ++half) {
                    const float2* wk = wst + (half * 8 + t) * LD + g;
                    uint32_t bb0[NG], bs0[NG], bb1[NG], bs1[NG];
#pragma unroll
                    for (int j = 0; j < NG; ++j) {
                        const float2 f0 = wk[(n0 + j) * 8];
                        const float2 f1 = wk[4 * LD + (n0 + j) * 8];
                        bb0[j] = __float_as_uint(f0.x);
                        bs0[j] = __float_as_uint(f0.y);
                        bb1[j] = __float_as_uint(f1.x);
                        bs1[j] = __float_as_uint(f1.y);
                    }
#pragma unroll
                    for (int j = 0; j < NG; ++j)
                        mma_tf32(part[j], ab[half], bs0[j], bs1[j]);
#pragma unroll
                    for (int j = 0; j < NG; ++j)
                        mma_tf32(part[j], asml[half], bb0[j], bb1[j]);
#pragma unroll
                    for (int j = 0; j < NG; ++j)
                        mma_tf32(part[j], ab[half], bb0[j], bb1[j]);
                }
#pragma unroll
                for (int j = 0; j < NG; ++j)
#pragma unroll
                    for (int i = 0; i < 4; ++i)
                        acc[n0 + j][i] += part[j][i];
            }
        }

        PROF_T(p_d);
        PROF_ADD(3, p_c, p_d);
        PROF_ADD(6, 0, c == 0);
        if (c != NC - 1) continue;

        // ---- epilogue of a pass: acc holds z @ W2 of 16 edges x H ----
        float dot_lo = 0.f, dot_hi = 0.f;
        if (active) {
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
                const int c0 = nt * 8 + 2 * t;
                const float2 bias = *reinterpret_cast<const float2*>(b2s + c0);
                const float2 wv = *reinterpret_cast<const float2*>(wvs + c0);
                acc[nt][0] = silu_fast(acc[nt][0] + bias.x);
                acc[nt][1] = silu_fast(acc[nt][1] + bias.y);
                acc[nt][2] = silu_fast(acc[nt][2] + bias.x);
                acc[nt][3] = silu_fast(acc[nt][3] + bias.y);
                dot_lo = fmaf(acc[nt][0], wv.x, fmaf(acc[nt][1], wv.y, dot_lo));
                dot_hi = fmaf(acc[nt][2], wv.x, fmaf(acc[nt][3], wv.y, dot_hi));
            }
            if (VEC || p.flag_a) {
                dot_lo += __shfl_xor_sync(FULL, dot_lo, 1);
                dot_hi += __shfl_xor_sync(FULL, dot_hi, 1);
                dot_lo += __shfl_xor_sync(FULL, dot_lo, 2);
                dot_hi += __shfl_xor_sync(FULL, dot_hi, 2);
            }
        }

        if (!VEC) {
            if (active) {
                const float f_lo = (p.flag_a ? sigmoid_f(dot_lo + batt) : 1.f);
                const float f_hi = (p.flag_a ? sigmoid_f(dot_hi + batt) : 1.f);
                const int rf = elist[tile0] >> 16;
                const int rl = elist[tile0 + tile_n - 1] >> 16;
                for (int r = rf; r <= rl; ++r) {
                    const bool lo = v_lo && lr_lo == r;
                    const bool hi = v_hi && lr_hi == r;
                    if (!__any_sync(FULL, lo || hi)) continue;
                    float* dst = (r == rf) ? head + warp * H : rowsum + r * H;
                    // this row's share of the thread's two edges
                    const float sl = lo ? f_lo * adj_lo : 0.f;
                    const float sh = hi ? f_hi * adj_hi : 0.f;
                    constexpr int V = 2 * NT;
                    float v[V];
#pragma unroll
                    for (int nt = 0; nt < NT; ++nt) {
                        v[2 * nt] = acc[nt][0] * sl + acc[nt][2] * sh;
                        v[2 * nt + 1] = acc[nt][1] * sl + acc[nt][3] * sh;
                    }
                    // sum over the 8 lanes that share t, halving what a
                    // lane keeps at each step: it ends with V / 8 sums
                    const bool up1 = lane & 16, up2 = lane & 8, up3 = lane & 4;
#pragma unroll
                    for (int j = 0; j < V / 2; ++j) {
                        const float keep = up1 ? v[j + V / 2] : v[j];
                        const float send = up1 ? v[j] : v[j + V / 2];
                        v[j] = keep + __shfl_xor_sync(FULL, send, 16);
                    }
#pragma unroll
                    for (int j = 0; j < V / 4; ++j) {
                        const float keep = up2 ? v[j + V / 4] : v[j];
                        const float send = up2 ? v[j] : v[j + V / 4];
                        v[j] = keep + __shfl_xor_sync(FULL, send, 8);
                    }
#pragma unroll
                    for (int j = 0; j < V / 8; ++j) {
                        const float keep = up3 ? v[j + V / 8] : v[j];
                        const float send = up3 ? v[j] : v[j + V / 8];
                        v[j] = keep + __shfl_xor_sync(FULL, send, 4);
                    }
                    const int base = (up1 ? V / 2 : 0) + (up2 ? V / 4 : 0)
                                     + (up3 ? V / 8 : 0);
#pragma unroll
                    for (int j = 0; j < V / 8; j += 2)
                        *reinterpret_cast<float2*>(
                            dst + ((base + j) >> 1) * 8 + 2 * t) =
                            make_float2(v[j], v[j + 1]);
                }
                if (lane == 0) head_row[warp] = rf;
            } else if (lane == 0) {
                head_row[warp] = -1;
            }
            __syncthreads();
            // fold the tiles' first-row sums in warp order
            for (int col = tid; col < H; col += THREADS) {
#pragma unroll
                for (int w = 0; w < NW; ++w) {
                    const int r = head_row[w];
                    if (r >= 0) rowsum[r * H + col] += head[w * H + col];
                }
            }
        } else if (active && t == 0) {
            const float* ctr = p.center + (size_t)bi * 3;
#pragma unroll
            for (int side = 0; side < 2; ++side) {
                const bool valid = side ? v_hi : v_lo;
                if (!valid) continue;
                const float dot = side ? dot_hi : dot_lo;
                const float av = side ? adj_hi : adj_lo;
                const int e = side ? e_hi : e_lo;
                const int row = grow(side ? lr_hi : lr_lo);
                const int col = side ? col_hi : col_lo;
                const float* xr = p.x + ((size_t)bi * N + row) * 3;
                const float* xc = p.x + ((size_t)bi * N + col) * 3;
                const float phi = p.flag_a ? tanhf(dot) * p.coords_range : dot;
                const float w = phi * av;
                float v0, v1, v2, inv;
                if (ws.cross) {
                    float a0 = xr[0] - ctr[0], a1 = xr[1] - ctr[1],
                          a2 = xr[2] - ctr[2];
                    float c0 = xc[0] - ctr[0], c1 = xc[1] - ctr[1],
                          c2 = xc[2] - ctr[2];
                    v0 = a1 * c2 - a2 * c1;
                    v1 = a2 * c0 - a0 * c2;
                    v2 = a0 * c1 - a1 * c0;
                    float nrm = sqrtf(v0 * v0 + v1 * v1 + v2 * v2);
                    inv = w / (nrm + p.norm_constant);
                } else {
                    v0 = xr[0] - xc[0];
                    v1 = xr[1] - xc[1];
                    v2 = xr[2] - xc[2];
                    float radial = v0 * v0 + v1 * v1 + v2 * v2;
                    inv = w / (sqrtf(radial + 1e-8f) + p.norm_constant);
                }
                contrib[e * 3 + 0] = v0 * inv;
                contrib[e * 3 + 1] = v1 * inv;
                contrib[e * 3 + 2] = v2 * inv;
            }
        }
    }
    PROF_T(p_e);
    PROF_ADD(4, p_compact, p_e);
    if (n_chunks == 0)                // the first copies were asked for
        for (int s = 0; s < STAGES - 1; ++s) mbar_wait(full + s, 0);
    __syncthreads();

    // ---- write the block's rows, each once ----
    if (!VEC) {
        for (int i = tid; i < nrow * H; i += THREADS)
            ws.out[((size_t)bi * N + grow(i / H)) * H + i % H] =
                rowsum[i] / p.norm_factor;
    } else {
        for (int lr = warp; lr < nrow; lr += NW) {
            float s0 = 0.f, s1 = 0.f, s2 = 0.f;
            for (int e = row_start[lr] + lane; e < row_start[lr + 1]; e += 32) {
                s0 += contrib[e * 3 + 0];
                s1 += contrib[e * 3 + 1];
                s2 += contrib[e * 3 + 2];
            }
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) {
                s0 += __shfl_xor_sync(FULL, s0, off);
                s1 += __shfl_xor_sync(FULL, s1, off);
                s2 += __shfl_xor_sync(FULL, s2, off);
            }
            if (lane == 0) {
                float* out = ws.out + ((size_t)bi * N + grow(lr)) * 3;
                out[0] = s0 / p.norm_factor;
                out[1] = s1 / p.norm_factor;
                out[2] = s2 / p.norm_factor;
            }
        }
    }
}

// ---------------------------------------------------------------------------
// the bf16 kernel: wgmma, W2 whole in shared memory
// ---------------------------------------------------------------------------

// VEC = false: gcl_messages; VEC = true: edge_vector_reduce
template <int H, bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
edge_chain_wgmma(const EdgeArgs p) {
    constexpr int NT = H / 8;         // 8-column blocks of the accumulator
    constexpr int NK = H / 16;        // k-steps of one wgmma each
    constexpr uint32_t SLAB = 128 * H;        // bytes of 64 k of W2
    constexpr uint32_t W2_BYTES = 2 * H * H;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    // W2 on a 1024-byte boundary of the shared address space (the swizzle)
    unsigned char* w2s = smem_raw
        + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
    uint64_t* w2_full = reinterpret_cast<uint64_t*>(w2s + W2_BYTES);
    float* as = reinterpret_cast<float*>(w2s + W2_BYTES + 16);
    float* we0 = as + R_MAX * H;
    float* we1 = we0 + H;
    float* b2s = we1 + H;
    float* wvs = b2s + H;
    float* rowsum = wvs + H;                              // gcl only
    float* head = rowsum + (VEC ? 0 : R_MAX * H);         // gcl only
    int* row_start = reinterpret_cast<int*>(head + (VEC ? 0 : NW * H));
    int* head_row = row_start + R_MAX + 1;
    int* elist = head_row + NW;       // R * N entries at most

    const int N = p.N;
    const int R = p.R;
    const int bi = blockIdx.y;
    const int G = gridDim.x;
    auto grow = [&](int lr) { return (int)blockIdx.x + lr * G; };
    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int t = lane & 3;
    const int row_limit = p.n_rows < N ? p.n_rows : N;
    const int nrow = (row_limit - (int)blockIdx.x + G - 1) / G;   // <= R
    const WeightSet ws = blockIdx.z ? p.s[1] : p.s[0];
    float* contrib = reinterpret_cast<float*>(elist + R * N);

    // W2 whole, as the wrapper packed it, one bulk copy per slab of 64 k,
    // while the block loads its rows and builds its edge list
    PROF_T(p_start);
    if (tid == 0) {
        mbar_init(w2_full, H / 64);
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        const unsigned char* src =
            reinterpret_cast<const unsigned char*>(ws.w2);
#pragma unroll
        for (int s = 0; s < H / 64; ++s)
            bulk_load(w2s + s * SLAB, src + s * SLAB, SLAB, w2_full);
    }

    for (int i = tid; i < nrow * H; i += THREADS)
        as[i] = ws.a[((size_t)bi * N + grow(i / H)) * H + i % H];
    for (int i = tid; i < H; i += THREADS) {
        we0[i] = ws.we[i];
        we1[i] = ws.we[H + i];
        b2s[i] = ws.b2[i];
        wvs[i] = bf16_round(ws.wvec[i]);
    }
    if (!VEC)
        for (int i = tid; i < R_MAX * H; i += THREADS) rowsum[i] = 0.f;

    const int n_edges = compact_edges(p.adj + (size_t)bi * N * N, N, nrow,
                                      grow, row_start, elist);

    const float batt = (!VEC && p.flag_a) ? p.batt[0] : 0.f;
    PROF_T(p_compact);
    PROF_ADD(0, p_start, p_compact);
    PROF_ADD(7, 0, 1);
    mbar_wait(w2_full, 0);            // W2 is here
    PROF_T(p_w2);
    PROF_ADD(1, p_compact, p_w2);
    // B of k-step c: slab c / 4, 32 bytes further per k-step inside it
    const uint64_t desc0 = wgmma_desc_b128(smem_addr(w2s));
    auto desc = [&](int c) {
        return desc0 + (uint64_t)((((c >> 2) * SLAB) + (c & 3) * 32) >> 4);
    };

    float acc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;

    for (int pass = 0; pass * NW * TM < n_edges; ++pass) {
        const int tile0 = (pass * NW + warp) * TM;
        const int tile_n = n_edges - tile0 < TM ? n_edges - tile0 : TM;
        const bool active = tile_n > 0;                   // warp-uniform
        // warpgroup-uniform: one of its four tiles has edges
        const bool wg_active = (pass * NW + (warp & ~3)) * TM < n_edges;

        PROF_T(p_a);
        if (wg_active) {
            // the product needs the edges' rows, columns and distances
            const EdgePair e = load_pair(p, elist, n_edges, tile0, bi, grow);
            const float* b_lo = ws.b + ((size_t)bi * N + e.col_lo) * H + 4 * t;
            const float* b_hi = ws.b + ((size_t)bi * N + e.col_hi) * H + 4 * t;
            const float* a_lo = as + e.lr_lo * H + 4 * t;
            const float* a_hi = as + e.lr_hi * H + 4 * t;
            float4 bl = ldg_in_place(b_lo);
            float4 bh = ldg_in_place(b_hi);
            // z of k-step c (k = 16c + 4t..16c + 4t + 3 of edges g, g + 8)
            // into A slots 2t, 2t+1 (k 4t, 4t+1) and 2t+8, 2t+9 (k 4t+2,
            // 4t+3); zeros for a tile past the list
            auto z_step = [&](int c, float4 bl_c, float4 bh_c,
                              uint32_t (&frag)[4]) {
                if (!active) {
                    frag[0] = frag[1] = frag[2] = frag[3] = 0u;
                    return;
                }
                const float4 al = *reinterpret_cast<const float4*>(a_lo + 16 * c);
                const float4 ah = *reinterpret_cast<const float4*>(a_hi + 16 * c);
                const float4 w0 = *reinterpret_cast<const float4*>(we0 + 16 * c + 4 * t);
                const float4 w1 = *reinterpret_cast<const float4*>(we1 + 16 * c + 4 * t);
                auto zlo = [&](float av, float bv, float w0v, float w1v) {
                    return silu_bf16(pre_exact(av, bv, e.dc_lo, w0v, e.di_lo, w1v));
                };
                auto zhi = [&](float av, float bv, float w0v, float w1v) {
                    return silu_bf16(pre_exact(av, bv, e.dc_hi, w0v, e.di_hi, w1v));
                };
                frag[0] = pack_bf16x2(zlo(al.x, bl_c.x, w0.x, w1.x),
                                      zlo(al.y, bl_c.y, w0.y, w1.y));
                frag[1] = pack_bf16x2(zhi(ah.x, bh_c.x, w0.x, w1.x),
                                      zhi(ah.y, bh_c.y, w0.y, w1.y));
                frag[2] = pack_bf16x2(zlo(al.z, bl_c.z, w0.z, w1.z),
                                      zlo(al.w, bl_c.w, w0.w, w1.w));
                frag[3] = pack_bf16x2(zhi(ah.z, bh_c.z, w0.z, w1.z),
                                      zhi(ah.w, bh_c.w, w0.w, w1.w));
            };
            // two sets of A registers: z of step c is computed while the
            // product of step c - 1 runs, once that of step c - 2 (the
            // set's last reader) is done
            // (unrolled whole: a loop would copy the accumulators at its
            // back edge while a product runs, and the compiler would then
            // wait for each product as soon as it is issued)
            uint32_t af[2][4];
            wgmma_fence_acc(acc);
#pragma unroll
            for (int c = 0; c < NK; ++c) {
                float4 bl_n = bl, bh_n = bh;
                if (c + 1 < NK) {     // b_j of the next step, ahead
                    bl_n = ldg_in_place(b_lo + 16 * (c + 1));
                    bh_n = ldg_in_place(b_hi + 16 * (c + 1));
                }
                if (c >= 2) wgmma_wait<1>();
                z_step(c, bl, bh, af[c & 1]);
                wgmma_fence();
                wgmma_bf16<H>(acc, af[c & 1], desc(c), c > 0);
                wgmma_commit();
                bl = bl_n;
                bh = bh_n;
            }
            wgmma_wait<0>();
            wgmma_fence_acc(acc);
        }
        PROF_T(p_b);
        PROF_ADD(3, p_a, p_b);
        PROF_ADD(6, 0, 1);

        // ---- epilogue of a pass: acc holds z @ W2 of 16 edges x H ----
        // the edges loaded again rather than held through the product,
        // where acc takes most registers
        const EdgePair e = load_pair(p, elist, n_edges, tile0, bi, grow);
        float dot_lo = 0.f, dot_hi = 0.f;
        if (active) {
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
                // the bias and weight of four blocks at a time: the
                // compiler hoisted all of them, H/2 registers beside acc,
                // and spilled; a warp barrier keeps the loads in place
                if (nt % 4 == 0) __syncwarp();
                const int c0 = nt * 8 + 2 * t;
                const float2 bias = *reinterpret_cast<const float2*>(b2s + c0);
                const float2 wv = *reinterpret_cast<const float2*>(wvs + c0);
                acc[nt][0] = silu_bf16(acc[nt][0] + bias.x);
                acc[nt][1] = silu_bf16(acc[nt][1] + bias.y);
                acc[nt][2] = silu_bf16(acc[nt][2] + bias.x);
                acc[nt][3] = silu_bf16(acc[nt][3] + bias.y);
                // the dot's operands in bf16 (wvs is rounded), exact
                // products, fp32 sums
                dot_lo = fmaf(bf16_round(acc[nt][0]), wv.x,
                              fmaf(bf16_round(acc[nt][1]), wv.y, dot_lo));
                dot_hi = fmaf(bf16_round(acc[nt][2]), wv.x,
                              fmaf(bf16_round(acc[nt][3]), wv.y, dot_hi));
            }
            if (VEC || p.flag_a) {
                dot_lo += __shfl_xor_sync(FULL, dot_lo, 1);
                dot_hi += __shfl_xor_sync(FULL, dot_hi, 1);
                dot_lo += __shfl_xor_sync(FULL, dot_lo, 2);
                dot_hi += __shfl_xor_sync(FULL, dot_hi, 2);
            }
        }

        if (!VEC) {
            if (active) {
                const float f_lo = (p.flag_a ? sigmoid_f(dot_lo + batt) : 1.f);
                const float f_hi = (p.flag_a ? sigmoid_f(dot_hi + batt) : 1.f);
                tile_row_sums(acc, e, f_lo, f_hi, elist, tile0, tile_n,
                              rowsum, head, head_row);
            } else if (lane == 0) {
                head_row[warp] = -1;
            }
            __syncthreads();
            fold_heads<H>(rowsum, head, head_row);
            __syncthreads();          // the heads are free for the next pass
        } else if (active && t == 0) {
            edge_contribs(p, ws, e, dot_lo, dot_hi, bi, grow, contrib);
        }
    }
    PROF_T(p_e);
    PROF_ADD(4, p_compact, p_e);
    __syncthreads();
    // the output pointer read here, where it is used: read with the other
    // weights, it was held through the passes
    write_rows<H, VEC>(p, blockIdx.z ? p.s[1].out : p.s[0].out, bi, nrow,
                       grow, rowsum, row_start, contrib);
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

int sm_count() {
    static int n = 0;
    if (n == 0) {
        int dev = 0;
        if (cudaGetDevice(&dev) != cudaSuccess
            || cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev)
                   != cudaSuccess || n <= 0)
            n = 132;
    }
    return n;
}

// rows per block: one block per SM or fewer, fewer rows where the list of
// R * N candidate edges would not fit shared memory
template <int H, bool VEC, bool BF>
int pick_rows(int B, int rows, int N, int n_sets) {
    const long total = (long)B * rows * n_sets;
    const long target = sm_count();
    long R = (total + target - 1) / target;
    if (R > R_MAX) R = R_MAX;
    if (R > rows) R = rows;
    if (R < 1) R = 1;
    while (R > 1 && smem_bytes<H, VEC, BF>((int)R * N) > (size_t)SMEM_LIMIT)
        --R;
    return (int)R;
}

template <int H, bool VEC, bool BF>
int launch_t(EdgeArgs& args, int B, int n_sets, cudaStream_t stream) {
    void (*kernel)(const EdgeArgs) = BF ? edge_chain_wgmma<H, VEC>
                                        : edge_chain_mma<H, VEC>;
    static bool configured = false;
    if (!configured) {
        cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
        if (e != cudaSuccess) return (int)e;
        configured = true;
    }
    const int rows = args.n_rows < args.N ? args.n_rows : args.N;
    args.R = pick_rows<H, VEC, BF>(B, rows, args.N, n_sets);
    const size_t smem = smem_bytes<H, VEC, BF>(args.R * args.N);
    if (smem > (size_t)SMEM_LIMIT || args.N > 0xffff)
        return (int)cudaErrorInvalidValue;
    dim3 grid((rows + args.R - 1) / args.R, B, n_sets);
    kernel<<<grid, THREADS, smem, stream>>>(args);
    return (int)cudaGetLastError();
}

template <bool VEC, bool BF = false>
int launch(EdgeArgs& args, int B, int H, int n_sets, cudaStream_t stream) {
    if (B <= 0 || args.N <= 0 || args.n_rows <= 0) return 0;
    switch (H) {
        case 128: return launch_t<128, VEC, BF>(args, B, n_sets, stream);
        case 192: return launch_t<192, VEC, BF>(args, B, n_sets, stream);
        case 256: return launch_t<256, VEC, BF>(args, B, n_sets, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}

EdgeArgs gcl_args(const float* a, const float* b, const float* d2c,
                  const float* d2i, const float* adj, const float* we,
                  const float* w2, const float* b2, const float* watt,
                  const float* batt, float* out, int N, int attention,
                  float norm_factor) {
    EdgeArgs p{};
    p.s[0] = WeightSet{a, b, we, w2, b2, watt, out, 0};
    p.d2c = d2c; p.d2i = d2i; p.adj = adj; p.batt = batt;
    p.N = N; p.n_rows = N; p.flag_a = attention;
    p.norm_factor = norm_factor;
    return p;
}

// the vector kernel's shared arguments; the caller fills the weight sets
EdgeArgs vec_args(const float* d2c, const float* d2i, const float* adj,
                  const float* x, const float* center, int N, int n_rows,
                  int tanh_, float coords_range, float norm_constant,
                  float norm_factor) {
    EdgeArgs p{};
    p.d2c = d2c; p.d2i = d2i; p.adj = adj; p.x = x; p.center = center;
    p.N = N; p.n_rows = n_rows; p.flag_a = tanh_;
    p.coords_range = coords_range; p.norm_constant = norm_constant;
    p.norm_factor = norm_factor;
    return p;
}

}  // namespace

extern "C" {

// Rows per block that a launch of these sizes gets (vec: the vector
// kernel; n_sets 2 for the pair); its grid is
// (ceil(n_rows / rows per block), B, n_sets).  0 for an unsupported H.
int egnn_rows_per_block(int B, int N, int H, int n_rows, int n_sets,
                        int vec) {
    const int rows = n_rows < N ? n_rows : N;
    switch (vec ? -H : H) {
        case 128: return pick_rows<128, false, false>(B, rows, N, n_sets);
        case 192: return pick_rows<192, false, false>(B, rows, N, n_sets);
        case 256: return pick_rows<256, false, false>(B, rows, N, n_sets);
        case -128: return pick_rows<128, true, false>(B, rows, N, n_sets);
        case -192: return pick_rows<192, true, false>(B, rows, N, n_sets);
        case -256: return pick_rows<256, true, false>(B, rows, N, n_sets);
        default: return 0;
    }
}

// The same for the bf16 variants.
int egnn_rows_per_block_bf16(int B, int N, int H, int n_rows, int n_sets,
                             int vec) {
    const int rows = n_rows < N ? n_rows : N;
    switch (vec ? -H : H) {
        case 128: return pick_rows<128, false, true>(B, rows, N, n_sets);
        case 192: return pick_rows<192, false, true>(B, rows, N, n_sets);
        case 256: return pick_rows<256, false, true>(B, rows, N, n_sets);
        case -128: return pick_rows<128, true, true>(B, rows, N, n_sets);
        case -192: return pick_rows<192, true, true>(B, rows, N, n_sets);
        case -256: return pick_rows<256, true, true>(B, rows, N, n_sets);
        default: return 0;
    }
}

// Each entry below returns the CUDA error code of its launch (0 on
// success).  None of them allocates, synchronises or writes rows >= n_rows.
// An entry *_bf16 launches the bf16 kernel: the same arguments, W2 packed
// in bf16 for wgmma ([H/64, H, 64], see edge_chain_wgmma).

int egnn_gcl_messages(const float* a, const float* b, const float* d2c,
                      const float* d2i, const float* adj, const float* we,
                      const float* w2, const float* b2, const float* watt,
                      const float* batt, float* out, int B, int N, int H,
                      int attention, float norm_factor, void* stream) {
    EdgeArgs p = gcl_args(a, b, d2c, d2i, adj, we, w2, b2, watt, batt, out,
                          N, attention, norm_factor);
    return launch<false>(p, B, H, 1, (cudaStream_t)stream);
}

int egnn_gcl_messages_bf16(const float* a, const float* b, const float* d2c,
                           const float* d2i, const float* adj,
                           const float* we, const float* w2, const float* b2,
                           const float* watt, const float* batt, float* out,
                           int B, int N, int H, int attention,
                           float norm_factor, void* stream) {
    EdgeArgs p = gcl_args(a, b, d2c, d2i, adj, we, w2, b2, watt, batt, out,
                          N, attention, norm_factor);
    return launch<false, true>(p, B, H, 1, (cudaStream_t)stream);
}

int egnn_edge_vector_reduce(const float* a, const float* b, const float* d2c,
                            const float* d2i, const float* adj,
                            const float* x, const float* center,
                            const float* we, const float* w2, const float* b2,
                            const float* wout, float* out, int B, int N,
                            int H, int n_rows, int tanh_, float coords_range,
                            float norm_constant, int cross, float norm_factor,
                            void* stream) {
    EdgeArgs p = vec_args(d2c, d2i, adj, x, center, N, n_rows, tanh_,
                          coords_range, norm_constant, norm_factor);
    p.s[0] = WeightSet{a, b, we, w2, b2, wout, out, cross};
    return launch<true>(p, B, H, 1, (cudaStream_t)stream);
}

int egnn_edge_vector_reduce_bf16(
        const float* a, const float* b, const float* d2c, const float* d2i,
        const float* adj, const float* x, const float* center,
        const float* we, const float* w2, const float* b2, const float* wout,
        float* out, int B, int N, int H, int n_rows, int tanh_,
        float coords_range, float norm_constant, int cross, float norm_factor,
        void* stream) {
    EdgeArgs p = vec_args(d2c, d2i, adj, x, center, N, n_rows, tanh_,
                          coords_range, norm_constant, norm_factor);
    p.s[0] = WeightSet{a, b, we, w2, b2, wout, out, cross};
    return launch<true, true>(p, B, H, 1, (cudaStream_t)stream);
}

// Set 0 weights the difference direction, set 1 the cross direction; out is
// [2, B, N, 3], one plane per set.
int egnn_edge_vector_reduce_pair(
        const float* a0, const float* b0, const float* we0, const float* w20,
        const float* b20, const float* wout0,
        const float* a1, const float* b1, const float* we1, const float* w21,
        const float* b21, const float* wout1,
        const float* d2c, const float* d2i, const float* adj, const float* x,
        const float* center, float* out, int B, int N, int H, int n_rows,
        int tanh_, float coords_range, float norm_constant, float norm_factor,
        void* stream) {
    EdgeArgs p = vec_args(d2c, d2i, adj, x, center, N, n_rows, tanh_,
                          coords_range, norm_constant, norm_factor);
    p.s[0] = WeightSet{a0, b0, we0, w20, b20, wout0, out, 0};
    p.s[1] = WeightSet{a1, b1, we1, w21, b21, wout1,
                       out + (size_t)B * N * 3, 1};
    return launch<true>(p, B, H, 2, (cudaStream_t)stream);
}

int egnn_edge_vector_reduce_pair_bf16(
        const float* a0, const float* b0, const float* we0, const float* w20,
        const float* b20, const float* wout0,
        const float* a1, const float* b1, const float* we1, const float* w21,
        const float* b21, const float* wout1,
        const float* d2c, const float* d2i, const float* adj, const float* x,
        const float* center, float* out, int B, int N, int H, int n_rows,
        int tanh_, float coords_range, float norm_constant, float norm_factor,
        void* stream) {
    EdgeArgs p = vec_args(d2c, d2i, adj, x, center, N, n_rows, tanh_,
                          coords_range, norm_constant, norm_factor);
    p.s[0] = WeightSet{a0, b0, we0, w20, b20, wout0, out, 0};
    p.s[1] = WeightSet{a1, b1, we1, w21, b21, wout1,
                       out + (size_t)B * N * 3, 1};
    return launch<true, true>(p, B, H, 2, (cudaStream_t)stream);
}

}  // extern "C"
