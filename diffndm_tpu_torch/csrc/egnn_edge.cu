// EGNN edge-chain kernels for NVIDIA Hopper (sm_90a): fp32 in and out, the
// product by W2 on the tensor cores as a three-term TF32 split.
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
//
// What bounds them on this card: operations.  Per edge with a nonzero
// adjacency the chain costs about 2*H^2 FLOPs for the product by W2
// (73.7 kFLOP at H=192) against a few bytes of edge input and O(N*H) node
// input, far above the ridge point even of the TF32 tensor cores
// (495 TFLOP/s over 3.35 TB/s = 148 FLOP/byte).  At the sampler's shapes
// the bound is a few microseconds, below the cost of a launch, so what
// matters is that the card is filled and that no work is done for edges
// the cutoff graph does not have.
//
// The design:
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
//     list entries as the M = 16 rows of its tile; only the last tile of a
//     block is ragged, so the work is that of the real edges.
//   * The product z @ W2 runs as mma.sync.aligned.m16n8k8 TF32 with fp32
//     accumulators.  v3b is an fp32 model, so both operands are split into
//     a TF32 "big" part and a TF32 remainder and three products are
//     accumulated (big*small, small*big, big*big): fp32-level accuracy.
//     mma.sync was taken over wgmma because TF32 wgmma wants both operands
//     K-major (W2 arrives N-major) and 64-row tiles, while the tiles here
//     are small and the tensor-core work of a launch is microseconds;
//     mma.sync needs no descriptors, swizzle or transposed weight copy.
//   * z never touches shared memory: it is elementwise in (edge, k), so
//     each thread computes exactly the A-fragment elements it owns from
//     a_i (shared memory), b_j (global, read-only path, fetched one chunk
//     ahead), we and the two distances, 16 k at a time from float4 loads,
//     and splits them in registers.  The k order inside a group of 16 is
//     permuted the same way for A and for the rows of W2, which keeps
//     those loads 16 bytes wide.
//   * A warp holds its whole 16 x H accumulator tile (H/2 registers), so
//     bias, silu, the dot with watt / wout, the gate, the direction math
//     and the multiplication by adj_ij all happen on registers.  Rows are
//     summed per distinct row of the tile with a halving exchange of warp
//     shuffles (each lane ends with H/32 sums); a row that continues from
//     the previous tile goes through a per-warp buffer that is folded in
//     warp order, every other row has one writer.
//   * W2 arrives already split and laid out for shared memory
//     ([H/16, 16, H+4, 2]: chunks of 16 rows of (big, remainder) pairs,
//     padded rows), which the wrapper computes once per weight tensor:
//     splitting in the inner loop cost two cvt per element per warp.  One
//     8-byte load feeds a B fragment of both parts, free of bank conflicts.
//   * The chunks stream through a 4-stage ring, each asked for by one
//     thread as one bulk copy (cp.async.bulk) that reports to an mbarrier:
//     chunk c+3 lands while chunk c multiplies, with one __syncthreads per
//     chunk to free a stage.  All warps of a block share each chunk, so W2
//     crosses L2 -> shared memory once per pass of 128 edges:
//     8*(H+4)*H / 128 bytes per edge, 2352 B at H=192.  The ring keeps
//     running across passes, so an epilogue overlaps the next copies.
//   * One block of 8 warps per SM: the accumulators put a thread at
//     ~190-255 registers.  More warps (12 at H=192) were slower on the
//     card: two warps per scheduler already keep mma.sync busy.
// Where the time of a pass goes at H=192 (cycle counters, build with
// -DEGNN_PROFILE): about 70 % in the mma loop, 25 % in the epilogue, the
// rest in waiting for chunks and asking for them.
// Left for later work: the last pass of a block often has tiles for a few
// warps only (split such a tile's columns over the idle warps); the list
// is built from two reads of adj; single-pass TF32 or bf16 once a
// chemistry metric can judge it; d2 and adjacency computed inside the
// kernel; the sorted-band column window for large pockets.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

// -DEGNN_PROFILE: thread 0 of every block adds the cycles it spends in
// each phase to g_prof (0 set-up and compaction, 1 waiting for a chunk,
// 2 asking for the next, 3 the mma loop, 4 the whole chunk loop, 6 passes,
// 7 blocks); egnn_read_profile copies the sums out and clears them.
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
constexpr int KC = 16;               // W2 rows per ring stage
constexpr int STAGES = 4;
constexpr int NG = 4;                // column tiles per group of mma
constexpr int R_MAX = 16;            // most rows a block owns
constexpr int SMEM_LIMIT = 232448;   // bytes a block may use on sm_90
constexpr unsigned FULL = 0xffffffffu;

struct WeightSet {
    const float* a;       // [B, N, H]
    const float* b;       // [B, N, H]
    const float* we;      // [2, H]
    const float* w2;      // [H/16, 16, H+4, 2]: split and laid out for the ring
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

__device__ __forceinline__ float sigmoid_f(float v) {
    return 1.0f / (1.0f + expf(-v));
}

__device__ __forceinline__ uint32_t to_tf32(float v) {
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
    return r;
}

// v = big + small + O(2^-22 |v|), both parts exact TF32 values
__device__ __forceinline__ void split_tf32(float v, uint32_t& big,
                                           uint32_t& small) {
    big = to_tf32(v);
    small = to_tf32(v - __uint_as_float(big));
}

// D += A (16x8, row) * B (8x8, col); lane = 4 * g + t:
//   a0 (g, t) a1 (g+8, t) a2 (g, t+4) a3 (g+8, t+4); b0 (t, g) b1 (t+4, g);
//   d0 (g, 2t) d1 (g, 2t+1) d2 (g+8, 2t) d3 (g+8, 2t+1)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
    return (uint32_t)__cvta_generic_to_shared(ptr);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                 :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

// one bulk copy of `bytes` from global to shared memory; the barrier's
// phase completes when all of them have arrived
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];"
        :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
        : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    asm volatile(
        "{\n"
        ".reg .pred P1;\n"
        "LAB_WAIT:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
        "@P1 bra DONE;\n"
        "bra LAB_WAIT;\n"
        "DONE:\n"
        "}"
        :: "r"(smem_addr(bar)), "r"(parity) : "memory");
}

// floats of shared memory besides the edge list (4 bytes per list entry,
// 16 with the per-edge vector contributions)
template <int H, bool VEC>
constexpr int fixed_floats() {
    return 2 * STAGES                 // the ring's barriers (8 bytes each)
           + STAGES * KC * (H + 4) * 2  // W2 ring (row stride H + 4 pairs)
           + R_MAX * H                // a rows
           + 4 * H                    // we0, we1, b2, wvec
           + (VEC ? 0 : (R_MAX + NW) * H)   // row sums, per-warp heads
           + R_MAX + 1 + NW + 3;      // row starts, head rows (ints), pad
}

template <int H, bool VEC>
constexpr size_t smem_bytes(int list_len) {
    return (size_t)fixed_floats<H, VEC>() * 4
           + (size_t)list_len * (VEC ? 16 : 4);
}

// VEC = false: gcl_messages; VEC = true: edge_vector_reduce
template <int H, bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
edge_chain_mma(const EdgeArgs p) {
    constexpr int LD = H + 4;         // pairs; = 4 mod 16: B loads hit all banks
    constexpr int NT = H / 8;         // mma N tiles of a warp
    constexpr int NC = H / KC;        // ring chunks per pass over W2
    extern __shared__ __align__(16) float smem[];
    uint64_t* full = reinterpret_cast<uint64_t*>(smem);
    float* ring = smem + 2 * STAGES;
    float* as = ring + STAGES * KC * LD * 2;
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
    constexpr uint32_t CHUNK_BYTES = KC * LD * 2 * 4;
    auto request_chunk = [&](int q) {
        if (tid == 0)
            bulk_load(ring + (q % STAGES) * KC * LD * 2,
                      ws.w2 + (size_t)(q % NC) * KC * LD * 2, CHUNK_BYTES,
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
            const float2* wst = reinterpret_cast<const float2*>(
                ring + (q % STAGES) * KC * LD * 2);
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
            float zl[4], zh[4];
            zl[0] = silu_fast(fmaf(di_lo, w1.x, fmaf(dc_lo, w0.x, al.x + bl.x)));
            zl[1] = silu_fast(fmaf(di_lo, w1.y, fmaf(dc_lo, w0.y, al.y + bl.y)));
            zl[2] = silu_fast(fmaf(di_lo, w1.z, fmaf(dc_lo, w0.z, al.z + bl.z)));
            zl[3] = silu_fast(fmaf(di_lo, w1.w, fmaf(dc_lo, w0.w, al.w + bl.w)));
            zh[0] = silu_fast(fmaf(di_hi, w1.x, fmaf(dc_hi, w0.x, ah.x + bh.x)));
            zh[1] = silu_fast(fmaf(di_hi, w1.y, fmaf(dc_hi, w0.y, ah.y + bh.y)));
            zh[2] = silu_fast(fmaf(di_hi, w1.z, fmaf(dc_hi, w0.z, ah.z + bh.z)));
            zh[3] = silu_fast(fmaf(di_hi, w1.w, fmaf(dc_hi, w0.w, ah.w + bh.w)));
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                // k-step of 8: slots t and t + 4 hold k = 4t + 2*half, +1
                uint32_t ab[4], asml[4];
                split_tf32(zl[2 * half], ab[0], asml[0]);
                split_tf32(zh[2 * half], ab[1], asml[1]);
                split_tf32(zl[2 * half + 1], ab[2], asml[2]);
                split_tf32(zh[2 * half + 1], ab[3], asml[3]);
                const float2* wk = wst + (half * 8 + t) * LD + g;
                // NG column tiles at a time, one product term after
                // the other, so that one mma does not wait on the
                // accumulator of the mma just before it
#pragma unroll
                for (int n0 = 0; n0 < NT; n0 += NG) {
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
                        mma_tf32(acc[n0 + j], ab, bs0[j], bs1[j]);
#pragma unroll
                    for (int j = 0; j < NG; ++j)
                        mma_tf32(acc[n0 + j], asml, bb0[j], bb1[j]);
#pragma unroll
                    for (int j = 0; j < NG; ++j)
                        mma_tf32(acc[n0 + j], ab, bb0[j], bb1[j]);
                }
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

// rows per block: about two blocks per SM, fewer rows where the list of
// R * N candidate edges would not fit shared memory
template <int H, bool VEC>
int pick_rows(int B, int rows, int N, int n_sets) {
    const long total = (long)B * rows * n_sets;
    const long target = sm_count();
    long R = (total + target - 1) / target;
    if (R > R_MAX) R = R_MAX;
    if (R > rows) R = rows;
    if (R < 1) R = 1;
    while (R > 1 && smem_bytes<H, VEC>((int)R * N) > (size_t)SMEM_LIMIT) --R;
    return (int)R;
}

template <int H, bool VEC>
int launch_t(EdgeArgs& args, int B, int n_sets, cudaStream_t stream) {
    static bool configured = false;
    if (!configured) {
        cudaError_t e = cudaFuncSetAttribute(
            edge_chain_mma<H, VEC>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
        if (e != cudaSuccess) return (int)e;
        configured = true;
    }
    const int rows = args.n_rows < args.N ? args.n_rows : args.N;
    args.R = pick_rows<H, VEC>(B, rows, args.N, n_sets);
    const size_t smem = smem_bytes<H, VEC>(args.R * args.N);
    if (smem > (size_t)SMEM_LIMIT || args.N > 0xffff)
        return (int)cudaErrorInvalidValue;
    dim3 grid((rows + args.R - 1) / args.R, B, n_sets);
    edge_chain_mma<H, VEC><<<grid, THREADS, smem, stream>>>(args);
    return (int)cudaGetLastError();
}

template <bool VEC>
int launch(EdgeArgs& args, int B, int H, int n_sets, cudaStream_t stream) {
    if (B <= 0 || args.N <= 0 || args.n_rows <= 0) return 0;
    switch (H) {
        case 128: return launch_t<128, VEC>(args, B, n_sets, stream);
        case 192: return launch_t<192, VEC>(args, B, n_sets, stream);
        case 256: return launch_t<256, VEC>(args, B, n_sets, stream);
        default: return (int)cudaErrorInvalidValue;
    }
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
        case 128: return pick_rows<128, false>(B, rows, N, n_sets);
        case 192: return pick_rows<192, false>(B, rows, N, n_sets);
        case 256: return pick_rows<256, false>(B, rows, N, n_sets);
        case -128: return pick_rows<128, true>(B, rows, N, n_sets);
        case -192: return pick_rows<192, true>(B, rows, N, n_sets);
        case -256: return pick_rows<256, true>(B, rows, N, n_sets);
        default: return 0;
    }
}

// Each entry below returns the CUDA error code of its launch (0 on
// success).  None of them allocates, synchronises or writes rows >= n_rows.

int egnn_gcl_messages(const float* a, const float* b, const float* d2c,
                      const float* d2i, const float* adj, const float* we,
                      const float* w2, const float* b2, const float* watt,
                      const float* batt, float* out, int B, int N, int H,
                      int attention, float norm_factor, void* stream) {
    EdgeArgs p{};
    p.s[0] = WeightSet{a, b, we, w2, b2, watt, out, 0};
    p.d2c = d2c; p.d2i = d2i; p.adj = adj; p.batt = batt;
    p.N = N; p.n_rows = N; p.flag_a = attention;
    p.norm_factor = norm_factor;
    return launch<false>(p, B, H, 1, (cudaStream_t)stream);
}

int egnn_edge_vector_reduce(const float* a, const float* b, const float* d2c,
                            const float* d2i, const float* adj,
                            const float* x, const float* center,
                            const float* we, const float* w2, const float* b2,
                            const float* wout, float* out, int B, int N,
                            int H, int n_rows, int tanh_, float coords_range,
                            float norm_constant, int cross, float norm_factor,
                            void* stream) {
    EdgeArgs p{};
    p.s[0] = WeightSet{a, b, we, w2, b2, wout, out, cross};
    p.d2c = d2c; p.d2i = d2i; p.adj = adj; p.x = x; p.center = center;
    p.N = N; p.n_rows = n_rows; p.flag_a = tanh_;
    p.coords_range = coords_range; p.norm_constant = norm_constant;
    p.norm_factor = norm_factor;
    return launch<true>(p, B, H, 1, (cudaStream_t)stream);
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
    EdgeArgs p{};
    p.s[0] = WeightSet{a0, b0, we0, w20, b20, wout0, out, 0};
    p.s[1] = WeightSet{a1, b1, we1, w21, b21, wout1,
                       out + (size_t)B * N * 3, 1};
    p.d2c = d2c; p.d2i = d2i; p.adj = adj; p.x = x; p.center = center;
    p.N = N; p.n_rows = n_rows; p.flag_a = tanh_;
    p.coords_range = coords_range; p.norm_constant = norm_constant;
    p.norm_factor = norm_factor;
    return launch<true>(p, B, H, 2, (cudaStream_t)stream);
}

}  // extern "C"
