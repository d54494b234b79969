// Backward of the EGNN edge-chain kernels for NVIDIA Hopper (sm_90a): fp32
// (edge_chain_bwd_mma, TF32 mma.sync) and bf16 (edge_chain_bwd_wgmma,
// wgmma).
//
// The JAX package's Pallas kernels (diffndm_tpu/ops/pallas_egnn.py:
// gcl_messages, edge_vector_reduce) have no VJP; its trainer takes the
// gradient by XLA autodiff of the dense path (diffndm_tpu/models/egnn.py).
// This kernel computes that gradient for the port's forward kernels
// (csrc/egnn_edge.cu), recomputing the chain from the forward's inputs so
// that nothing of [B, N, N, H] size is kept between forward and backward.
//
// Per edge (i, j) with adj_ij != 0, with g_i the output gradient of row i:
//   u1 = a_i + b_j + d2c*we0 + d2i*we1,  s = silu(u1),  u = s @ W2 + b2,
//   m = silu(u);
//   gcl:  gate = sigmoid(m . watt + batt) (1 without attention),
//         g = g_i * adj / nf,  dm = g*gate + (g.m)*gate*(1-gate)*watt
//   vec:  phi = tanh(m . wout)*range (or m . wout), v the direction,
//         dphi = adj/nf * (g_i . v), dm = dphi*range*(1-tanh^2)*wout, and
//         the direction's own gradient w.r.t. x_i, x_j and the centre
//   du = dm * silu'(u),  ds = du @ W2^T,  dz = ds * silu'(u1)
//   da_i += dz, db_j += dz, dd2c_ij = dz.we0, dd2i_ij = dz.we1,
//   dW2 += s^T du, db2 += du, dwe += dz*(d2c, d2i), dwatt / dwout, dbatt.
//
// What bounds it: operations.  Three products of an edge by an H x H
// matrix (the recompute s @ W2, du @ W2^T and s^T du): 6*H^2 FLOPs per edge,
// against a few bytes of edge input.
//
// bf16: the VJP of the bf16 forward (the Pallas kernels'
// mxu_dtype = bfloat16, edge_chain_wgmma of egnn_edge.cu) under the cast
// rule of jax.vjp and torch autograd, a cotangent rounded to bf16 where the
// forward rounded an operand (' a rounded value):
//   s' = bf16(silu(u1)), u = s' @ W2' + b2 (W2' = bf16(W2), rounded and
//   packed by the wrapper), the gate or phi dot bf16(m) . wvec' (wvec' =
//   bf16(watt / wout), rounded as the block stages it);
//   dm = alpha * g_i + bf16(coef * wvec') (vec: alpha = 0),
//   du = dm * silu'(u),  ds' = bf16(du @ W2'^T),  dz = ds' * silu'(u1),
//   dW2 = sum s'^T du and dwvec = sum coef * bf16(m), each summed in fp32
//   over the call and rounded to bf16 once, by egnn_bwd_reduce.
// du is not rounded (autograd and JAX's dot_general transpose do not), so
// du enters ds' and dW2 as three bf16 parts (below).
//
// Two kernels, edge_chain_bwd_mma<H, VEC> (fp32) and
// edge_chain_bwd_wgmma<H, VEC> (bf16), each with two epilogues: VEC false
// is the backward of gcl_messages (the attention gate), VEC true that of
// edge_vector_reduce (one weight set, or the difference + cross pair
// through blockIdx.z).  Common to both:
//   * Two launches per backward.  The edge kernel: a block owns R rows of
//     one batch element (every G-th row, as the forward deals them) and
//     one weight set.  It gathers the (row, column) pairs of its rows with
//     adj != 0 into a list in shared memory, sorted by column and then
//     row, and walks it in passes.  da per owned row in shared memory; db
//     per run of equal columns (the runs of a pass have distinct columns)
//     into the block's partial record.
//   * No atomics.  Every sum that crosses blocks (dW2, db, the small
//     weight vectors, dbatt, dx, dcenter, the pair's two dd2c planes) goes
//     to the block's own partial record and egnn_bwd_reduce adds the
//     records in a fixed order: repeat launches give the same bits.
// edge_chain_bwd_mma (fp32):
//   * The three products on the tensor cores, as the forward's
//     mma.sync.m16n8k8 TF32 tiles in a three-term split (big*small +
//     small*big + big*big, fp32 accumulators: fp32-level accuracy).  A
//     pass covers PE = 16 * NWT edges of the list: tile w (entries
//     16w..16w+15 of the pass) is warp w's, at H=256 warps w and w + 4's.
//   (3) u = s @ W2: each thread computes the A fragments of s it owns in
//       registers from a_i (shared), b_j (global), we and the distances,
//       as the forward does; W2 arrives split and packed by the wrapper
//       (pack_w2) and streams in 16-row chunks through a ring of VSTAGES
//       bulk copies (cp.async.bulk + mbarrier).  The warp holds its 16 x H
//       accumulator tile, so the epilogue runs on registers: u = acc + b2,
//       m = silu(u) (sigmoid(u) waits in du's slots of shared memory, so
//       it is computed once), the row dots (quad sums; at H=256 added
//       across the tile's two warps through per-warp slots), then
//       du = dm * silu'(u) to shared memory (the C fragment layout is not
//       the A layout) and the tile's column sums of c * m through a
//       halving shuffle exchange into a per-tile row (dwatt, dwout).
//       gcl: the dots m . watt and gout_i . m in one pass (adj / nf
//       factored out of g . m), gate, datt = adj/nf (gout_i . m) gate
//       (1 - gate), dm = adj/nf gate gout_i + datt watt, c = datt; dbatt
//       in a register.  vec: m . wout, tanh, the direction and its x /
//       centre gradients, dm = dphi' wout, c = dphi'.
//   (5) dW2 = s^T du over the pass, once per pass: the 8 warps as WK x WN
//       slabs of dW2 (rows k, columns n), NH halves of a slab one after the
//       other where the accumulators would not fit.  A = s^T is
//       recomputed in registers (a thread's mma rows g, g+8 are k = 2g,
//       2g+1 of an m tile, so its loads are 8 bytes wide), B = du from
//       shared memory, both split on load.  The first pass writes the
//       block's dW2 record, later passes add to it.
//   (6) ds = du @ W2^T: the forward's main loop with A = du read from
//       shared memory (float4, split on load) and W2^T, split and packed
//       by the wrapper (pack_w2 of W2^T), streaming through the same ring
//       after W2's last chunk.  dz = ds * silu'(u1) on registers with u1
//       recomputed per fragment element; dd2c / dd2i are quad-shuffle dots
//       with we0 / we1.  dz then replaces du for the row sums (da), the
//       column runs (db) and dwe, one column per thread (vec: and dx).
// Shared memory (bytes) and the rows a block can own (R <= 16):
//            gcl                             vec
//   H=128: fixed 131,104 + R (1,536 + 4 N)   135,712 + R (1,056 + 4 N)
//   H=192: fixed 191,520 + R (2,304 + 4 N)   196,128 + R (1,568 + 4 N)
//   H=256: fixed 178,464 + R (3,072 + 4 N)   180,768 + R (2,080 + 4 N)
// (ring 3 x 16 x (H+4) split pairs; du PE x (H+8); we, b2, watt / wout;
// per-tile column sums, per-warp row dots; per-edge scalars (vec: and dx
// terms); a and da rows; gcl: output gradient rows, vec: gout and dx rows
// of 4; the list.)  At [16, 96, 192] a gcl block owns 12 rows, at the
// flagship [20, 344, 256] 12 (vec 14).
// At H=256 a pass of 8 tiles does not fit (the du tile alone would be
// 135 KB beside a 100 KB ring), so a pass has 4 tiles and two warps take
// half the n tiles of each in (3) and (6), adding their row dots through
// shared memory; all 8 share (5).
// Registers (ptxas -v, build/egnn_edge_bwd-*.log; chip_smoke.py prints
// them per instantiation).  Where the time of a 128-edge pass of the
// vector epilogue goes at H=192 (cycle counters, chip_smoke.py --only
// phases, NVIDIA H100): the two chunk loops ~35 k cycles each, about what
// mma.sync TF32 gives 8 warps; (5) ~46 k; the two epilogues ~15 k each;
// the row and column sums ~13 k.
// Left for later: wgmma (mma.sync caps the products near a third of the
// TF32 rate after the split); a ragged last pass spread over the idle
// warps (a block with a few edges over 128 pays a second pass; splitting
// the n tiles at run time, as H=256 does at compile time, made the
// predicated chunk loops 40 % slower); the epilogues overlapped with
// another warp group's products; dW2 in registers across a block's
// passes; fewer partial bytes for small graphs.
//
// edge_chain_bwd_wgmma (bf16), shaped by the special functions and by the
// products' operands:
//   * A pass is 64 edges of the list, one wgmma M tile, and both
//     warpgroups work on all of them, splitting the width: warp w of a
//     warpgroup owns edges 16w..16w+15 (thread (g, t) rows g, g + 8).
//   * The s' chain: each warpgroup computes u1 (the plain version's order,
//     pre_exact), sigma(u1) and s' = bf16(u1 sigma(u1)) for its own half of
//     the k-steps (own_kstep), writes s' to shared memory in the A layout
//     (K-major, 128-byte swizzle, k permuted in each 16 as pack_w2_bf16
//     permutes W2's rows) and keeps silu'(u1) = sigma (1 + u1 (1 - sigma))
//     in registers for (6): H/4 floats a thread.
//   * (3) u = s' @ W2': m64n(H/2)k16, A (s') and B (W2') from shared
//     memory, warpgroup w the columns w H/2..; its epilogue takes sigma(u)
//     once, m, m' = bf16(m) (m' waits in shared memory) and the row dots
//     over its half, the halves meeting in shared memory (warpgroup 0's
//     first); then du = dm silu'(u), split into three bf16 parts du = hi +
//     lo + lo2 (each the rounding of what the earlier leave: du to 2^-24,
//     so that the products lie no further from float64 than the fp32
//     kernel's TF32 split; two parts lie 18x further,
//     tests/test_torch_bf16_bwd_wgmma.py), to shared memory [64][H] each,
//     swizzled as s' but in natural column order; the column sums of du
//     (db2) and coef m' (dwvec) by a halving shuffle exchange into one
//     register per lane and exchange, carried over the passes.
//   * (6) ds = du @ W2'^T: A = du's parts (K-major), B = W2' read
//     transposed through the MN-major descriptor from the same copy (row n
//     of a slab holds 64 k, 64 of N' per K' row), three parts per k-step;
//     warpgroup w the k of its own k-steps, so that the accumulator's
//     columns are the k of the silu'(u1) its threads kept (the slot
//     permutation lands column 2t + e of n tile j on k 4t + 2 (j % 2) + e
//     of k-step j / 2).  At H = 192 the halves are 96 k, a slab and half
//     of one: the half slab is an n32 tile starting 64 bytes into its
//     128-byte rows for warpgroup 1.  ds' = bf16(acc), dz = ds' silu'(u1)
//     on registers, the dots with we0, we1 over both halves; dz to shared
//     memory over s' and du for the sums (7).
//   * (5) dW2 = s'^T du: m64n64k16 tiles of 64 k x 64 n dealt to the
//     warpgroups in turn, A = s' read MN-major (accumulator row m of slab
//     b is k = 64 b + 16 (m / 16) + slot_k(m % 16)), B = du's parts
//     MN-major; a tile's 4 x 3 products summed from zero per pass and
//     added to the block's record with one rounded add, as in the fp32
//     kernel (the tensor cores' fp32 sums truncate).  At H = 128 the
//     block's dW2 (64 KB) stays in shared memory over its passes and goes
//     to the record once; above, it does not fit, and the record's read-
//     modify-write per 64-edge pass is what (5) spends its time on (L2
//     bandwidth; device memory at the flagship, whose records exceed the
//     L2).  (5) runs before (6), so that (6)'s accumulators hold no
//     register through it.
//   * Per edge, thread e < 64 takes the gate (gcl) or tanh and the
//     direction with its gradients (vec) once, after the row dots.
//   * W2' is the bf16 forward's own tensor (pack_w2_bf16_cached), H/64
//     bulk copies to one mbarrier while the block builds its list, held
//     for the block's life at H = 128 and 192.  At H = 256 it is 128 KB
//     and s' with du's parts another 128 KB, so W2' streams through a ring
//     of two 32 KB slabs, four copies a stage per pass: (3) reads slabs 0,
//     1, then 2, 3; (6) warpgroup w slab w (copied under (3)'s epilogue and
//     (5)), then w + 2 (asked for by the warpgroup's own thread and waited
//     for).
//   * Special functions per (edge, k) and pass: one sigmoid of u1 and one
//     of u, an ex2 and a reciprocal each: 2 + 2, where the earlier bf16
//     kernel on TF32 mma.sync took 4 + 4 (sigmoid(u1) for s' in (3), again for s'
//     in (5), again for silu'(u1) in (6); sigmoid(u)).
//   * The warp index and the list's length come through a shuffle, which
//     the compiler knows to be warp-uniform: a wgmma on a path it cannot
//     prove uniform is serialised ("Potential Performance Loss").
// Shared memory (bytes): 1024 alignment + W2' (2 H^2; the ring 2 x 128 H)
// + s' and du's three parts (4 x 128 H) + 16 (barriers) + 4 x (4 H
// weights + 4 x 64 row dots + 3 x 64 edge scalars + (vec) 9 x 64 dx terms
// + 4 x 64 indices; at H = 128 the dW2 of 4 H^2) = 169,744 / 178,960 /
// 204,560 for gcl_messages at H = 128 / 192 / 256 and 172,048 / 181,264 /
// 206,864 for the vector kernel,
// plus per owned row 4 x (2 H + H (gcl) or 8 (vec)) and 4 N for its
// candidate pairs (bwd_rows_per_block in ops/egnn_kernels.py mirrors the
// choice): at [16, 88, 192] a gcl block owns 11 rows, at the flagship
// [20, 344, 256] 6 (the pair 7).
// On an NVIDIA H100 80GB HBM3 (700 W; scripts/backward_build_ab.py) it
// takes 0.55-0.79x the fp32 backward's time on [bf16train]'s calls, and
// the earlier bf16 kernel on TF32 mma.sync took 1.10-1.71x its time.  Per 64-edge pass at
// [16, 88, 192] (cycle counters): the s' chain ~4 k, (3) ~1.3 k, its
// epilogue ~10 k, (6) ~2.4 k, (5) ~18 k (the record), the sums ~10 k.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "egnn_mma.cuh"
#include "egnn_wgmma.cuh"

// -DEGNN_PROFILE: thread 0 of every block adds the cycles it spends in
// spans to g_prof (see PROFILE_BWD_FIELDS in ops/egnn_kernels.py): the
// whole block, its passes, (fp32) the chunk loops of products (3) and (6)
// or (bf16) product (3), product (5), the counts of passes and blocks,
// (bf16) the s' chain, product (6), the epilogue of (3) and that of (6);
// egnn_bwd_read_profile copies the sums out and clears them.
#ifdef EGNN_PROFILE
__device__ unsigned long long g_prof[10];
#define PROF_T(v) const long long v = clock64()
#define PROF_ADD(i, a, b)                                               \
    if (threadIdx.x == 0) atomicAdd(&g_prof[i], (unsigned long long)((b) - (a)))
extern "C" int egnn_bwd_read_profile(unsigned long long* dst) {
    const unsigned long long zero[10] = {0};
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
constexpr int R_MAX = 16;            // most rows a block owns
constexpr int SMEM_LIMIT = 232448;   // bytes a block may use on sm_90
constexpr unsigned FULL = 0xffffffffu;

struct Set {
    const float* a;       // [B, N, H]
    const float* b;       // [B, N, H]
    const float* we;      // [2, H]
    const float* w2;      // pack_w2(W2)
    const float* w2t;     // pack_w2(W2^T)
    const float* b2;      // [H]
    const float* wvec;    // [H]: watt or wout
    float* da;            // [B, N, H]: rows < n_rows written
    float* dd2c;          // [B, N, N] plane of this set, or null
    float* dd2i;          // [B, N, N] plane of this set, or null
    int cross;
};

struct Args {
    Set s[2];
    const float* gout;    // gcl [B, N, H]; vec [B, N, 3]
    const float* d2c;
    const float* d2i;
    const float* adj;
    const float* x;       // vec [B, N, 3]
    const float* center;  // vec [B, 1, 3]
    const float* batt;    // gcl [1]
    float* part;          // [n_sets, B, G] records of P floats
    int B, N, n_rows, R, G, P;
    int flag_a;           // gcl: attention; vec: tanh
    float coords_range, norm_constant, norm_factor;
};

// offsets (floats) in one block's partial record
struct Layout {
    int w2, b, vec, x, c, size;
};

__host__ __device__ inline Layout layout(int H, int N) {
    Layout l;
    l.w2 = 0;
    l.b = H * H;                  // db of every column
    l.vec = l.b + N * H;          // db2, dwe0, dwe1, dwvec [H each], dbatt
    l.x = l.vec + 4 * H + 4;      // dx of every node [N, 3]
    l.c = l.x + 3 * N;            // dcenter [3]
    l.size = (l.c + 4 + 3) & ~3;
    return l;
}

__device__ __forceinline__ float sigm(float v) { return 1.f / (1.f + expf(-v)); }

__device__ __forceinline__ float silu_fast(float v) {
    return __fdividef(v, 1.0f + __expf(-v));
}

__device__ __forceinline__ float sigm_fast(float v) {
    return __fdividef(1.0f, 1.0f + __expf(-v));
}

__device__ __forceinline__ float dsilu_fast(float v) {
    const float s = sigm_fast(v);
    return s * (1.f + v * (1.f - s));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
    return v;
}

// sum over the four lanes of a quad (the lanes that share an mma row)
__device__ __forceinline__ float quad_sum(float v) {
    v += __shfl_xor_sync(FULL, v, 1);
    return v + __shfl_xor_sync(FULL, v, 2);
}

// the direction of edge (row, col) and the gradient of w * v_hat . G with
// respect to x_row (gp), x_col (gq); the centre's is -(gp + gq) (cross)
__device__ __forceinline__ void direction(const float* xr, const float* xc,
                                          const float* ctr, bool cross,
                                          float nc, const float G[3], float w,
                                          float vh[3], float gp[3],
                                          float gq[3]) {
    if (cross) {
        const float p0 = xr[0] - ctr[0], p1 = xr[1] - ctr[1], p2 = xr[2] - ctr[2];
        const float q0 = xc[0] - ctr[0], q1 = xc[1] - ctr[1], q2 = xc[2] - ctr[2];
        const float v0 = p1 * q2 - p2 * q1;
        const float v1 = p2 * q0 - p0 * q2;
        const float v2 = p0 * q1 - p1 * q0;
        const float n2 = v0 * v0 + v1 * v1 + v2 * v2;
        const float nrm = n2 > 0.f ? sqrtf(n2) : 0.f;
        const float den = nrm + nc;
        vh[0] = v0 / den; vh[1] = v1 / den; vh[2] = v2 / den;
        // d/dv of w * G . v / (|v| + nc); the |v| term vanishes at v = 0
        const float gv = G[0] * v0 + G[1] * v1 + G[2] * v2;
        const float k2 = n2 > 0.f ? w * gv / (den * den * nrm) : 0.f;
        const float d0 = w * G[0] / den - k2 * v0;
        const float d1 = w * G[1] / den - k2 * v1;
        const float d2 = w * G[2] / den - k2 * v2;
        // v = p x q: dp = q x dv, dq = dv x p
        gp[0] = q1 * d2 - q2 * d1; gp[1] = q2 * d0 - q0 * d2; gp[2] = q0 * d1 - q1 * d0;
        gq[0] = d1 * p2 - d2 * p1; gq[1] = d2 * p0 - d0 * p2; gq[2] = d0 * p1 - d1 * p0;
    } else {
        const float e0 = xr[0] - xc[0], e1 = xr[1] - xc[1], e2 = xr[2] - xc[2];
        const float r = sqrtf(e0 * e0 + e1 * e1 + e2 * e2 + 1e-8f);
        const float den = r + nc;
        vh[0] = e0 / den; vh[1] = e1 / den; vh[2] = e2 / den;
        const float ge = G[0] * e0 + G[1] * e1 + G[2] * e2;
        const float k2 = w * ge / (den * den * r);
        gp[0] = w * G[0] / den - k2 * e0;
        gp[1] = w * G[1] / den - k2 * e1;
        gp[2] = w * G[2] / den - k2 * e2;
        gq[0] = -gp[0]; gq[1] = -gp[1]; gq[2] = -gp[2];
    }
}

// the block's (row, column) pairs with adj != 0, sorted by column and then
// row, as (local row << 16) | column; returns their count.  cnt is scratch
// of N + 1 + THREADS ints.
__device__ int build_list(const float* adj_b, int N, int nrow, int G,
                          int* cnt, int* elist) {
    const int tid = threadIdx.x;
    int* tsum = cnt + N + 1;
    auto grow = [&](int lr) { return (int)blockIdx.x + lr * G; };
    for (int j = tid; j < N; j += THREADS) {
        int c = 0;
        for (int lr = 0; lr < nrow; ++lr)
            c += adj_b[(size_t)grow(lr) * N + j] != 0.f;
        cnt[j] = c;
    }
    __syncthreads();
    const int chunk = (N + THREADS - 1) / THREADS;
    const int j0 = tid * chunk < N ? tid * chunk : N;
    const int j1 = j0 + chunk < N ? j0 + chunk : N;
    // exclusive prefix sum of the threads' counts: within each warp by
    // shuffles, then over the warps' totals
    const int lane = tid & 31, warp = tid >> 5;
    int mine = 0;
    for (int j = j0; j < j1; ++j) mine += cnt[j];
    int incl = mine;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(FULL, incl, o);
        if (lane >= o) incl += v;
    }
    if (lane == 31) tsum[warp] = incl;
    __syncthreads();
    if (tid == 0) {
        int run = 0;
        for (int w = 0; w < NW; ++w) {
            const int v = tsum[w];
            tsum[w] = run;
            run += v;
        }
        cnt[N] = run;
    }
    __syncthreads();
    const int start = tsum[warp] + incl - mine;
    __syncthreads();                  // tsum is read before it is reused
    tsum[tid] = start;
    __syncthreads();
    {
        int run = tsum[tid];
        for (int j = j0; j < j1; ++j) {
            const int v = cnt[j];
            cnt[j] = run;
            run += v;
        }
    }
    __syncthreads();
    const int n_edges = cnt[N];
    for (int j = tid; j < N; j += THREADS) {
        int pos = cnt[j];
        for (int lr = 0; lr < nrow; ++lr)
            if (adj_b[(size_t)grow(lr) * N + j] != 0.f)
                elist[pos++] = (lr << 16) | j;
    }
    __syncthreads();
    return n_edges;
}

// ---------------------------------------------------------------------------
// edge_chain_bwd_mma: the three products on the tensor cores
// ---------------------------------------------------------------------------

constexpr int KC = 16;               // rows of a packed W2 / W2^T chunk
constexpr int VSTAGES = 3;           // ring stages

template <int H>
struct MCfg {
    static constexpr int NWT = H <= 192 ? 8 : 4;   // edge tiles per pass
    static constexpr int PE = 16 * NWT;            // edges per pass
    static constexpr int LDR = H + 4;              // ring row stride (pairs)
    // du row stride, = 8 mod 32: the B loads of (5) hit every bank once
    static constexpr int LDU = H + 8;
    static constexpr int NT = H / 8;               // n tiles of a 16 x H tile
    // warps on each edge tile in (3) and (6), and the n tiles each takes
    static constexpr int SPLIT = NW / NWT;
    static constexpr int NTS = NT / SPLIT;
    static constexpr int NC = H / KC;              // chunks per product
    // (5): warps as WK (k) x WN (n) slabs of dW2, NH halves of a slab
    static constexpr int WK = 4, WN = 2;
    static constexpr int NH = H == 256 ? 2 : 1;
    static constexpr int MTW = H / 16 / WK;        // m tiles of a slab
    static constexpr int NTW = H / 8 / WN / NH;    // n tiles of a half
};

template <int H, bool VEC>
constexpr int mma_fixed_floats() {
    using C = MCfg<H>;
    return 8                                   // ring barriers, padded
           + VSTAGES * KC * C::LDR * 2         // W2 / W2^T ring
           + C::PE * C::LDU                    // du, then dz, then run sums
           + 4 * H                             // we0, we1, b2, watt / wout
           + C::NWT * H                        // per-tile dwatt / dwout sums
           + NW * 32                           // per-warp row dots
           + C::PE * 3                         // adj, d2c, d2i
           + (VEC ? C::PE * 9 : 0)             // dx (6), dx runs (3)
           + C::PE * 4;                        // row, column, run column, pad
}

// floats per owned row: a and da rows; gcl: the output gradient row, vec:
// the gout and dx rows (4 each)
template <int H, bool VEC>
constexpr int mma_row_floats() {
    return 2 * H + (VEC ? 8 : H);
}

// + the list of R * N candidate pairs
template <int H, bool VEC>
size_t mma_smem_bytes(int R, int N) {
    return 4 * ((size_t)mma_fixed_floats<H, VEC>()
                + (size_t)R * mma_row_floats<H, VEC>() + (size_t)R * N);
}

// acc (16 edges x NT n tiles from column n8) += A (16 x 16 of this chunk)
// @ chunk (16 x H, split pairs as pack_w2 lays them out); zl / zh: the
// thread's A values of its two edges g, g + 8 at k = 4t..4t+3 of the
// chunk.  The forward's loop.
template <int H, int NT>
__device__ __forceinline__ void mma_chunk(float (&acc)[NT][4],
                                          const float* stage,
                                          const float (&zl)[4],
                                          const float (&zh)[4], int g,
                                          int t, int n8) {
    constexpr int LD = H + 4, NG = 4;
    const float2* wst = reinterpret_cast<const float2*>(stage) + n8;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
        const float av[4] = {zl[2 * half], zh[2 * half], zl[2 * half + 1],
                             zh[2 * half + 1]};
        uint32_t ab[4], asml[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) split_tf32(av[i], ab[i], asml[i]);
        const float2* wk = wst + (half * 8 + t) * LD + g;
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
            for (int j = 0; j < NG; ++j) mma_tf32(acc[n0 + j], ab, bs0[j], bs1[j]);
#pragma unroll
            for (int j = 0; j < NG; ++j) mma_tf32(acc[n0 + j], asml, bb0[j], bb1[j]);
#pragma unroll
            for (int j = 0; j < NG; ++j) mma_tf32(acc[n0 + j], ab, bb0[j], bb1[j]);
        }
    }
}

// the edge pre-activation u1, with fused multiply-adds
__device__ __forceinline__ float edge_pre(float a, float b, float dc,
                                          float w0, float di, float w1) {
    return fmaf(di, w1, fmaf(dc, w0, a + b));
}

// s = silu(u1) as the product takes it
__device__ __forceinline__ float edge_s(float a, float b, float dc, float w0,
                                        float di, float w1) {
    return silu_fast(edge_pre(a, b, dc, w0, di, w1));
}

template <int H, bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
edge_chain_bwd_mma(const Args p) {
    using C = MCfg<H>;
    constexpr int NWT = C::NWT, PE = C::PE, LDR = C::LDR, LDU = C::LDU;
    constexpr int NC = C::NC, SPLIT = C::SPLIT, NT = C::NTS;
    constexpr int WK = C::WK, WN = C::WN, NH = C::NH, MTW = C::MTW,
                  NTW = C::NTW;
    extern __shared__ __align__(16) float smem[];
    uint64_t* full = reinterpret_cast<uint64_t*>(smem);
    float* ring = smem + 8;
    float* sDU = ring + VSTAGES * KC * LDR * 2;
    float* we0 = sDU + PE * LDU;
    float* we1 = we0 + H;
    float* b2s = we1 + H;
    float* wvs = b2s + H;
    float* sWV = wvs + H;                      // [NWT][H]
    float* sRed = sWV + NWT * H;               // [NW][32]
    float* eAdj = sRed + NW * 32;
    float* eDc = eAdj + PE;
    float* eDi = eDc + PE;
    constexpr int XE = VEC ? PE : 0;           // edges with dx terms
    float* eEG = eDi + PE;                     // vec [PE][6]: gp, gq
    float* runX = eEG + 6 * XE;                // vec [PE][3]
    int* eLR = reinterpret_cast<int*>(runX + 3 * XE);
    int* eCol = eLR + PE;
    int* runCol = eCol + PE;
    float* sA = reinterpret_cast<float*>(runCol + 2 * PE);
    float* sDA = sA + p.R * H;
    float* sG = sDA + p.R * H;                 // gcl [R][H]; vec [R][4]
    float* sXR = sG + (VEC ? 4 : H) * p.R;     // vec [R][4]
    int* elist = reinterpret_cast<int*>(sXR + (VEC ? 4 : 0) * p.R);

    const int N = p.N, G = p.G;
    const int bi = blockIdx.y, z = blockIdx.z;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int row_limit = p.n_rows < N ? p.n_rows : N;
    const int nrow = (row_limit - (int)blockIdx.x + G - 1) / G;   // <= R
    auto grow = [&](int lr) { return (int)blockIdx.x + lr * G; };
    const Set ws = z ? p.s[1] : p.s[0];
    const Layout L = layout(H, N);
    float* part = p.part + ((size_t)(z * p.B + bi) * G + blockIdx.x) * p.P;
    const float inv_nf = 1.f / p.norm_factor;
    const float* b_b = ws.b + (size_t)bi * N * H;
    const float* ctr = VEC ? p.center + (size_t)bi * 3 : nullptr;
    PROF_T(p_start);

    // ring chunk q: chunk q mod 2 NC of the pass's sequence, W2's NC chunks
    // then W2^T's, into stage q mod VSTAGES; one thread asks for each
    constexpr uint32_t CHUNK_BYTES = KC * LDR * 2 * 4;
    auto request_chunk = [&](int q) {
        if (tid == 0) {
            const int c = q % (2 * NC);
            const float* src = (c < NC ? ws.w2 : ws.w2t)
                               + (size_t)(c % NC) * KC * LDR * 2;
            bulk_load(ring + (q % VSTAGES) * KC * LDR * 2, src, CHUNK_BYTES,
                      full + q % VSTAGES);
        }
    };
    if (tid == 0) {
#pragma unroll
        for (int s = 0; s < VSTAGES; ++s) mbar_init(full + s, 1);
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
#pragma unroll
        for (int s = 0; s < VSTAGES - 1; ++s) request_chunk(s);
    }

    for (int i = tid; i < nrow * H; i += THREADS) {
        const size_t o = ((size_t)bi * N + grow(i / H)) * H + i % H;
        sA[i] = ws.a[o];
        sDA[i] = 0.f;
        if constexpr (!VEC) sG[i] = p.gout[o];
    }
    if constexpr (VEC) {
        for (int i = tid; i < nrow * 4; i += THREADS) {
            const int c = i & 3;
            sG[i] = c < 3 ? p.gout[((size_t)bi * N + grow(i >> 2)) * 3 + c]
                          : 0.f;
            sXR[i] = 0.f;
        }
    }
    for (int i = tid; i < H; i += THREADS) {
        we0[i] = ws.we[i];
        we1[i] = ws.we[H + i];
        b2s[i] = ws.b2[i];
        wvs[i] = ws.wvec[i];
    }
    // the partial sums added to run by run start at zero
    for (int i = tid; i < N * H; i += THREADS) part[L.b + i] = 0.f;
    if constexpr (VEC)
        for (int i = tid; i < 3 * N; i += THREADS) part[L.x + i] = 0.f;

    const int n_edges = build_list(p.adj + (size_t)bi * N * N, N, nrow, G,
                                   reinterpret_cast<int*>(sDU), elist);
    const int n_pass = (n_edges + PE - 1) / PE;
    const int n_chunks = n_pass * 2 * NC;
    PROF_ADD(5, 0, 1);
    // chunk q is here, all are done with chunk q-1's stage: refill it
    auto next_chunk = [&](int q) {
        mbar_wait(full + q % VSTAGES, (q / VSTAGES) & 1);
        __syncthreads();
        if (q + VSTAGES - 1 < n_chunks) request_chunk(q + VSTAGES - 1);
    };

    // column tid (< H): the block's db2, dwe0, dwe1, dwatt / dwout
    float acc_b2 = 0.f, acc_we0 = 0.f, acc_we1 = 0.f, acc_wv = 0.f;
    // gcl: dbatt over the edges this thread's quad owns in (3)
    float acc_batt = 0.f;
    const float batt = !VEC && p.flag_a ? p.batt[0] : 0.f;
    // vec: threads xt..xt+2: component c of dx (and dcenter)
    const int xt = H + 3 <= THREADS ? H : 0;
    const int xc_ = tid - xt;
    const bool xthread = VEC && xc_ >= 0 && xc_ < 3;
    float dctr = 0.f;
    // (5): this warp's slab of dW2; its k rows 2g, 2g+1 of each m tile
    const int kb = (warp % WK) * (H / WK);
    const int nslab = (warp / WK) * (H / WN);

    int q = 0;
    for (int pass = 0; pass < n_pass; ++pass) {
        const int e0 = pass * PE;
        const int tn = n_edges - e0 < PE ? n_edges - e0 : PE;
        // the pass's edges; an entry past the list is (row 0, column 0)
        // with adj 0, so every gradient it gives is 0
        if (tid < PE) {
            const bool v = tid < tn;
            const int pk = v ? elist[e0 + tid] : 0;
            const int lr = pk >> 16, col = pk & 0xffff;
            const size_t o = ((size_t)bi * N + grow(lr)) * N + col;
            eLR[tid] = lr;
            eCol[tid] = col;
            eAdj[tid] = v ? p.adj[o] : 0.f;
            eDc[tid] = v ? p.d2c[o] : 0.f;
            eDi[tid] = v ? p.d2i[o] : 0.f;
        }
        __syncthreads();
        // this thread's two edges of the warp's tile: pass entries el_lo
        // = 16 tile + g and el_hi = el_lo + 8; its n tiles from column n8
        const int tile = warp % NWT, sub = warp / NWT;
        const int n8 = sub * NT * 8;
        const bool active = tile * 16 < tn;
        const int el_lo = tile * 16 + g;
        const int el_hi = el_lo + 8;
        PROF_T(p0);
        PROF_ADD(4, 0, 1);

        // ---- (3) u = s @ W2, and the epilogue up to du ----
        {
            // the thread's two edges, read again in (6): fewer registers
            // live across (5)
            const int lr_lo = eLR[el_lo], lr_hi = eLR[el_hi];
            const int col_lo = eCol[el_lo], col_hi = eCol[el_hi];
            const float dc_lo = eDc[el_lo], dc_hi = eDc[el_hi];
            const float di_lo = eDi[el_lo], di_hi = eDi[el_hi];
            const float* b_lo = b_b + (size_t)col_lo * H;
            const float* b_hi = b_b + (size_t)col_hi * H;
            float acc[NT][4];
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
                for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;
            float4 bl_next = __ldg(reinterpret_cast<const float4*>(b_lo + 4 * t));
            float4 bh_next = __ldg(reinterpret_cast<const float4*>(b_hi + 4 * t));
            for (int c = 0; c < NC; ++c, ++q) {
                next_chunk(q);
                if (!active) continue;
                const int kq = c * KC + 4 * t;
                const float4 al = *reinterpret_cast<const float4*>(
                    sA + lr_lo * H + kq);
                const float4 ah = *reinterpret_cast<const float4*>(
                    sA + lr_hi * H + kq);
                const float4 bl = bl_next, bh = bh_next;
                if (c + 1 < NC) {     // the next chunk's b_j, ahead of the mma
                    bl_next = __ldg(reinterpret_cast<const float4*>(
                        b_lo + kq + KC));
                    bh_next = __ldg(reinterpret_cast<const float4*>(
                        b_hi + kq + KC));
                }
                const float4 w0 = *reinterpret_cast<const float4*>(we0 + kq);
                const float4 w1 = *reinterpret_cast<const float4*>(we1 + kq);
                const float zl[4] = {
                    edge_s(al.x, bl.x, dc_lo, w0.x, di_lo, w1.x),
                    edge_s(al.y, bl.y, dc_lo, w0.y, di_lo, w1.y),
                    edge_s(al.z, bl.z, dc_lo, w0.z, di_lo, w1.z),
                    edge_s(al.w, bl.w, dc_lo, w0.w, di_lo, w1.w)};
                const float zh[4] = {
                    edge_s(ah.x, bh.x, dc_hi, w0.x, di_hi, w1.x),
                    edge_s(ah.y, bh.y, dc_hi, w0.y, di_hi, w1.y),
                    edge_s(ah.z, bh.z, dc_hi, w0.z, di_hi, w1.z),
                    edge_s(ah.w, bh.w, dc_hi, w0.w, di_hi, w1.w)};
                mma_chunk<H, NT>(
                    acc, ring + (q % VSTAGES) * KC * LDR * 2, zl, zh, g, t,
                    n8);
            }
            PROF_T(p1);
            PROF_ADD(2, p0, p1);

            // the owned rows' output gradients (gcl)
            const float* gr_lo = sG + lr_lo * H;
            const float* gr_hi = sG + lr_hi * H;
            // m . wvec per edge (wout or watt); gcl: and gout_i . m
            float dot_lo = 0.f, dot_hi = 0.f, gm_lo = 0.f, gm_hi = 0.f;
            if (active) {
                // u = acc + b2 (a quad holds a row; sigmoid(u) waits in
                // du's slots of shared memory)
#pragma unroll
                for (int nt = 0; nt < NT; ++nt) {
                    const int c0 = n8 + nt * 8 + 2 * t;
                    const float2 bias = *reinterpret_cast<const float2*>(b2s + c0);
                    const float2 wv = *reinterpret_cast<const float2*>(wvs + c0);
                    acc[nt][0] += bias.x;
                    acc[nt][1] += bias.y;
                    acc[nt][2] += bias.x;
                    acc[nt][3] += bias.y;
                    float sg[4], mq[4];
#pragma unroll
                    for (int i = 0; i < 4; ++i) {
                        sg[i] = sigm_fast(acc[nt][i]);
                        mq[i] = acc[nt][i] * sg[i];   // m as the dot takes it
                    }
                    dot_lo = fmaf(mq[0], wv.x, fmaf(mq[1], wv.y, dot_lo));
                    dot_hi = fmaf(mq[2], wv.x, fmaf(mq[3], wv.y, dot_hi));
                    if constexpr (!VEC) {
                        const float2 gl = *reinterpret_cast<const float2*>(gr_lo + c0);
                        const float2 gh = *reinterpret_cast<const float2*>(gr_hi + c0);
                        gm_lo = fmaf(acc[nt][0] * sg[0], gl.x,
                                     fmaf(acc[nt][1] * sg[1], gl.y, gm_lo));
                        gm_hi = fmaf(acc[nt][2] * sg[2], gh.x,
                                     fmaf(acc[nt][3] * sg[3], gh.y, gm_hi));
                    }
                    *reinterpret_cast<float2*>(sDU + el_lo * LDU + c0) =
                        make_float2(sg[0], sg[1]);
                    *reinterpret_cast<float2*>(sDU + el_hi * LDU + c0) =
                        make_float2(sg[2], sg[3]);
                }
                dot_lo = quad_sum(dot_lo);
                dot_hi = quad_sum(dot_hi);
                if constexpr (!VEC) {
                    gm_lo = quad_sum(gm_lo);
                    gm_hi = quad_sum(gm_hi);
                }
                if constexpr (SPLIT > 1) {    // the tile's warps add theirs
                    if (t == 0) {
                        sRed[warp * 32 + g] = dot_lo;
                        sRed[warp * 32 + 8 + g] = dot_hi;
                        if constexpr (!VEC) {
                            sRed[warp * 32 + 16 + g] = gm_lo;
                            sRed[warp * 32 + 24 + g] = gm_hi;
                        }
                    }
                }
            }
            if constexpr (SPLIT > 1) {
                __syncthreads();
                if (active) {
                    dot_lo = dot_hi = gm_lo = gm_hi = 0.f;
                    for (int j = 0; j < SPLIT; ++j) {
                        const float* r = sRed + (tile + j * NWT) * 32;
                        dot_lo += r[g];
                        dot_hi += r[8 + g];
                        if constexpr (!VEC) {
                            gm_lo += r[16 + g];
                            gm_hi += r[24 + g];
                        }
                    }
                }
            }
            if (active) {
                // per edge: dm = alpha * gout_i + coef * wvec, and coef
                // is the factor of m in the column sums (dwatt / dwout)
                float alpha[2] = {0.f, 0.f}, coef[2];
                if constexpr (!VEC) {
                    // the attention gate; without it gate = 1, dm = g
#pragma unroll
                    for (int side = 0; side < 2; ++side) {
                        const float av = eAdj[side ? el_hi : el_lo] * inv_nf;
                        if (p.flag_a) {
                            const float gate = sigm((side ? dot_hi : dot_lo) + batt);
                            coef[side] = av * (side ? gm_hi : gm_lo) * gate
                                         * (1.f - gate);
                            alpha[side] = av * gate;
                        } else {
                            coef[side] = 0.f;
                            alpha[side] = av;
                        }
                    }
                    if (t == 0 && sub == 0) acc_batt += coef[0] + coef[1];
                } else {
                    // dphi through tanh, and the direction's own gradients
#pragma unroll
                    for (int side = 0; side < 2; ++side) {
                        const int el = side ? el_hi : el_lo;
                        const int lr = side ? lr_hi : lr_lo;
                        const int col = side ? col_hi : col_lo;
                        const float dot = side ? dot_hi : dot_lo;
                        const float av = eAdj[el] * inv_nf;
                        const float* xr = p.x + ((size_t)bi * N + grow(lr)) * 3;
                        const float* xc = p.x + ((size_t)bi * N + col) * 3;
                        const float Gr[3] = {sG[lr * 4], sG[lr * 4 + 1], sG[lr * 4 + 2]};
                        const float th = p.flag_a ? tanhf(dot) : 0.f;
                        const float phi = p.flag_a ? th * p.coords_range : dot;
                        float vh[3], gp[3], gq[3];
                        direction(xr, xc, ctr, ws.cross, p.norm_constant, Gr,
                                  av * phi, vh, gp, gq);
                        const float dphi = av * (Gr[0] * vh[0] + Gr[1] * vh[1]
                                                 + Gr[2] * vh[2]);
                        coef[side] = p.flag_a
                                         ? dphi * p.coords_range * (1.f - th * th)
                                         : dphi;
                        if (t == 0 && sub == 0) {
                            eEG[el * 6 + 0] = gp[0];
                            eEG[el * 6 + 1] = gp[1];
                            eEG[el * 6 + 2] = gp[2];
                            eEG[el * 6 + 3] = gq[0];
                            eEG[el * 6 + 4] = gq[1];
                            eEG[el * 6 + 5] = gq[2];
                        }
                    }
                }
                // du = dm * silu'(u) to shared memory; the column sums'
                // terms coef * m over the tile's 16 edges, XT n tiles at a
                // time: over the 8 lanes that share t, halving what a lane
                // keeps at each step, so that it ends with 2 sums
                static_assert(NT % 8 == 0, "n tiles in chunks of XT");
                constexpr int XT = 8, V = 2 * XT;
                const bool up1 = lane & 16, up2 = lane & 8, up3 = lane & 4;
                const int base = (up1 ? V / 2 : 0) + (up2 ? V / 4 : 0)
                                 + (up3 ? V / 8 : 0);
#pragma unroll
                for (int n0 = 0; n0 < NT; n0 += XT) {
                    float v[V];
#pragma unroll
                    for (int j = 0; j < XT; ++j) {
                        const int nt = n0 + j;
                        const int c0 = n8 + nt * 8 + 2 * t;
                        const float2 wv = *reinterpret_cast<const float2*>(wvs + c0);
                        const float2 sl = *reinterpret_cast<const float2*>(
                            sDU + el_lo * LDU + c0);
                        const float2 sh = *reinterpret_cast<const float2*>(
                            sDU + el_hi * LDU + c0);
                        const float sgs[4] = {sl.x, sl.y, sh.x, sh.y};
                        float gv[4] = {0.f, 0.f, 0.f, 0.f};
                        if constexpr (!VEC) {
                            const float2 gl = *reinterpret_cast<const float2*>(gr_lo + c0);
                            const float2 gh = *reinterpret_cast<const float2*>(gr_hi + c0);
                            gv[0] = gl.x; gv[1] = gl.y; gv[2] = gh.x; gv[3] = gh.y;
                        }
                        float m[4], d[4];
#pragma unroll
                        for (int i = 0; i < 4; ++i) {
                            const float u = acc[nt][i];
                            const float sg = sgs[i];
                            const float w = i & 1 ? wv.y : wv.x;
                            // m and the gradient of m in the dot
                            m[i] = u * sg;
                            const float dw = coef[i >> 1] * w;
                            const float dm = VEC ? dw
                                                 : fmaf(alpha[i >> 1], gv[i], dw);
                            d[i] = dm * (sg * (1.f + u * (1.f - sg)));
                        }
                        v[2 * j] = fmaf(coef[0], m[0], coef[1] * m[2]);
                        v[2 * j + 1] = fmaf(coef[0], m[1], coef[1] * m[3]);
                        *reinterpret_cast<float2*>(sDU + el_lo * LDU + c0) =
                            make_float2(d[0], d[1]);
                        *reinterpret_cast<float2*>(sDU + el_hi * LDU + c0) =
                            make_float2(d[2], d[3]);
                    }
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
                    // values base, base + 1 of the chunk: n tile n0 +
                    // base / 2, columns 2t, 2t + 1
                    *reinterpret_cast<float2*>(
                        sWV + tile * H + n8 + (n0 + base / 2) * 8 + 2 * t) =
                        make_float2(v[0], v[1]);
                }
            } else {
                for (int n = lane; n < NT * 8; n += 32) sWV[tile * H + n8 + n] = 0.f;
            }
        }
        __syncthreads();
        // db2 and dwout of the pass, one column per thread
        if (tid < H) {
            float s = 0.f;
            for (int e = 0; e < tn; ++e) s += sDU[e * LDU + tid];
            acc_b2 += s;
            float w = 0.f;
#pragma unroll
            for (int wi = 0; wi < NWT; ++wi) w += sWV[wi * H + tid];
            acc_wv += w;
        }

        PROF_T(p3);
        // ---- (5) dW2 = s^T du over the pass's edges ----
        {
            const int n_ks = (tn + 7) >> 3;
#pragma unroll 1
            for (int h = 0; h < NH; ++h) {
                const int nb = nslab + h * NTW * 8;
                float d[MTW][NTW][4];
#pragma unroll
                for (int mt = 0; mt < MTW; ++mt)
#pragma unroll
                    for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
                        for (int i = 0; i < 4; ++i) d[mt][nt][i] = 0.f;
                // b_j of the k-step's two edges, one k-step ahead
                float2 ya[MTW], yb[MTW];
                auto load_b = [&](int ks) {
                    const float* ba = b_b + (size_t)eCol[ks * 8 + t] * H + kb
                                      + 2 * g;
                    const float* bb = b_b + (size_t)eCol[ks * 8 + t + 4] * H
                                      + kb + 2 * g;
#pragma unroll
                    for (int mt = 0; mt < MTW; ++mt) {
                        ya[mt] = __ldg(reinterpret_cast<const float2*>(ba + 16 * mt));
                        yb[mt] = __ldg(reinterpret_cast<const float2*>(bb + 16 * mt));
                    }
                };
                load_b(0);
#pragma unroll 1
                for (int ks = 0; ks < n_ks; ++ks) {
                    // mma columns t, t + 4 of the k-step: edges ea, eb
                    const int ea = ks * 8 + t, eb = ea + 4;
                    const float* aa = sA + eLR[ea] * H + kb + 2 * g;
                    const float* ab_ = sA + eLR[eb] * H + kb + 2 * g;
                    const float dca = eDc[ea], dia = eDi[ea];
                    const float dcb = eDc[eb], dib = eDi[eb];
                    uint32_t sb[MTW][4], ss[MTW][4];
#pragma unroll
                    for (int mt = 0; mt < MTW; ++mt) {
                        const int k = kb + 16 * mt + 2 * g;
                        const float2 xa = *reinterpret_cast<const float2*>(aa + 16 * mt);
                        const float2 xb = *reinterpret_cast<const float2*>(ab_ + 16 * mt);
                        const float2 w0 = *reinterpret_cast<const float2*>(we0 + k);
                        const float2 w1 = *reinterpret_cast<const float2*>(we1 + k);
                        // a0 (k, ea) a1 (k+1, ea) a2 (k, eb) a3 (k+1, eb)
                        const float sv[4] = {
                            edge_s(xa.x, ya[mt].x, dca, w0.x, dia, w1.x),
                            edge_s(xa.y, ya[mt].y, dca, w0.y, dia, w1.y),
                            edge_s(xb.x, yb[mt].x, dcb, w0.x, dib, w1.x),
                            edge_s(xb.y, yb[mt].y, dcb, w0.y, dib, w1.y)};
#pragma unroll
                        for (int i = 0; i < 4; ++i)
                            split_tf32(sv[i], sb[mt][i], ss[mt][i]);
                    }
                    if (ks + 1 < n_ks) load_b(ks + 1);
                    // NGB n tiles at a time, one product term after the
                    // other, so that an mma does not wait on the one before
                    constexpr int NGB = NTW % 4 == 0 ? 4 : 3;
                    static_assert(NTW % NGB == 0, "n tiles in groups");
#pragma unroll
                    for (int n0 = 0; n0 < NTW; n0 += NGB) {
                        uint32_t db0[NGB], ds0[NGB], db1[NGB], ds1[NGB];
#pragma unroll
                        for (int j = 0; j < NGB; ++j) {
                            const int n = nb + (n0 + j) * 8 + g;
                            split_tf32(sDU[ea * LDU + n], db0[j], ds0[j]);
                            split_tf32(sDU[eb * LDU + n], db1[j], ds1[j]);
                        }
#pragma unroll
                        for (int j = 0; j < NGB; ++j)
#pragma unroll
                            for (int mt = 0; mt < MTW; ++mt)
                                mma_tf32(d[mt][n0 + j], sb[mt], ds0[j], ds1[j]);
#pragma unroll
                        for (int j = 0; j < NGB; ++j)
#pragma unroll
                            for (int mt = 0; mt < MTW; ++mt)
                                mma_tf32(d[mt][n0 + j], ss[mt], db0[j], db1[j]);
#pragma unroll
                        for (int j = 0; j < NGB; ++j)
#pragma unroll
                            for (int mt = 0; mt < MTW; ++mt)
                                mma_tf32(d[mt][n0 + j], sb[mt], db0[j], db1[j]);
                    }
                }
                // the block's dW2 record: rows k, k+1 at columns n, n+1
#pragma unroll
                for (int mt = 0; mt < MTW; ++mt)
#pragma unroll
                    for (int nt = 0; nt < NTW; ++nt) {
                        const int k = kb + 16 * mt + 2 * g;
                        const int n = nb + nt * 8 + 2 * t;
                        float2* r0 = reinterpret_cast<float2*>(
                            part + L.w2 + (size_t)k * H + n);
                        float2* r1 = reinterpret_cast<float2*>(
                            part + L.w2 + (size_t)(k + 1) * H + n);
                        float2 o0 = make_float2(0.f, 0.f), o1 = o0;
                        if (pass > 0) {
                            o0 = *r0;
                            o1 = *r1;
                        }
                        *r0 = make_float2(o0.x + d[mt][nt][0], o0.y + d[mt][nt][1]);
                        *r1 = make_float2(o1.x + d[mt][nt][2], o1.y + d[mt][nt][3]);
                    }
            }
        }

        PROF_T(p4);
        PROF_ADD(3, p3, p4);
        // ---- (6) ds = du @ W2^T, dz = ds * silu'(u1) ----
        {
            const int lr_lo = eLR[el_lo], lr_hi = eLR[el_hi];
            const int col_lo = eCol[el_lo], col_hi = eCol[el_hi];
            const float dc_lo = eDc[el_lo], dc_hi = eDc[el_hi];
            const float di_lo = eDi[el_lo], di_hi = eDi[el_hi];
            const float* b_lo = b_b + (size_t)col_lo * H;
            const float* b_hi = b_b + (size_t)col_hi * H;
            float acc[NT][4];
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
                for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;
            for (int c = 0; c < NC; ++c, ++q) {
                next_chunk(q);
                if (!active) continue;
                const float4 dl = *reinterpret_cast<const float4*>(
                    sDU + el_lo * LDU + c * KC + 4 * t);
                const float4 dh = *reinterpret_cast<const float4*>(
                    sDU + el_hi * LDU + c * KC + 4 * t);
                const float zl[4] = {dl.x, dl.y, dl.z, dl.w};
                const float zh[4] = {dh.x, dh.y, dh.z, dh.w};
                mma_chunk<H, NT>(
                    acc, ring + (q % VSTAGES) * KC * LDR * 2, zl, zh, g, t,
                    n8);
            }
            PROF_T(p5);
            PROF_ADD(2, p4, p5);
            if (active) {
                float dd[4] = {0.f, 0.f, 0.f, 0.f};   // d2c lo, d2i lo, hi
                // b_j of 4 n tiles loaded ahead of their use
                constexpr int LB = 4;
                float2 bls[LB], bhs[LB];
#pragma unroll
                for (int j = 0; j < LB; ++j) {
                    bls[j] = __ldg(reinterpret_cast<const float2*>(b_lo + n8 + j * 8 + 2 * t));
                    bhs[j] = __ldg(reinterpret_cast<const float2*>(b_hi + n8 + j * 8 + 2 * t));
                }
#pragma unroll
                for (int nt = 0; nt < NT; ++nt) {
                    const int c0 = n8 + nt * 8 + 2 * t;
                    const float2 w0 = *reinterpret_cast<const float2*>(we0 + c0);
                    const float2 w1 = *reinterpret_cast<const float2*>(we1 + c0);
                    const float2 al = *reinterpret_cast<const float2*>(sA + lr_lo * H + c0);
                    const float2 ah = *reinterpret_cast<const float2*>(sA + lr_hi * H + c0);
                    const float2 bl = bls[nt % LB], bh = bhs[nt % LB];
                    if (nt + LB < NT) {
                        bls[nt % LB] = __ldg(reinterpret_cast<const float2*>(
                            b_lo + c0 + LB * 8));
                        bhs[nt % LB] = __ldg(reinterpret_cast<const float2*>(
                            b_hi + c0 + LB * 8));
                    }
                    acc[nt][0] *= dsilu_fast(edge_pre(al.x, bl.x, dc_lo, w0.x, di_lo, w1.x));
                    acc[nt][1] *= dsilu_fast(edge_pre(al.y, bl.y, dc_lo, w0.y, di_lo, w1.y));
                    acc[nt][2] *= dsilu_fast(edge_pre(ah.x, bh.x, dc_hi, w0.x, di_hi, w1.x));
                    acc[nt][3] *= dsilu_fast(edge_pre(ah.y, bh.y, dc_hi, w0.y, di_hi, w1.y));
                    dd[0] = fmaf(acc[nt][0], w0.x, fmaf(acc[nt][1], w0.y, dd[0]));
                    dd[1] = fmaf(acc[nt][0], w1.x, fmaf(acc[nt][1], w1.y, dd[1]));
                    dd[2] = fmaf(acc[nt][2], w0.x, fmaf(acc[nt][3], w0.y, dd[2]));
                    dd[3] = fmaf(acc[nt][2], w1.x, fmaf(acc[nt][3], w1.y, dd[3]));
                }
#pragma unroll
                for (int i = 0; i < 4; ++i) dd[i] = quad_sum(dd[i]);
                if constexpr (SPLIT > 1) {    // to the tile's first warp
                    if (t == 0)
#pragma unroll
                        for (int i = 0; i < 4; ++i)
                            sRed[warp * 32 + 4 * g + i] = dd[i];
                } else if (t == 0) {
#pragma unroll
                    for (int side = 0; side < 2; ++side) {
                        const int el = side ? el_hi : el_lo;
                        if (el >= tn) continue;
                        const size_t o = ((size_t)bi * N
                                          + grow(side ? lr_hi : lr_lo)) * N
                                         + (side ? col_hi : col_lo);
                        if (ws.dd2c) ws.dd2c[o] = dd[2 * side];
                        if (ws.dd2i) ws.dd2i[o] = dd[2 * side + 1];
                    }
                }
            }
            __syncthreads();          // every warp is done with du
            if constexpr (SPLIT > 1) {
                if (active && sub == 0 && t == 0) {   // in warp order
                    float dd[4] = {0.f, 0.f, 0.f, 0.f};
                    for (int j = 0; j < SPLIT; ++j)
#pragma unroll
                        for (int i = 0; i < 4; ++i)
                            dd[i] += sRed[(tile + j * NWT) * 32 + 4 * g + i];
#pragma unroll
                    for (int side = 0; side < 2; ++side) {
                        const int el = side ? el_hi : el_lo;
                        if (el >= tn) continue;
                        const size_t o = ((size_t)bi * N
                                          + grow(side ? lr_hi : lr_lo)) * N
                                         + (side ? col_hi : col_lo);
                        if (ws.dd2c) ws.dd2c[o] = dd[2 * side];
                        if (ws.dd2i) ws.dd2i[o] = dd[2 * side + 1];
                    }
                }
            }
            if (active) {
#pragma unroll
                for (int nt = 0; nt < NT; ++nt) {
                    const int c0 = n8 + nt * 8 + 2 * t;
                    *reinterpret_cast<float2*>(sDU + el_lo * LDU + c0) =
                        make_float2(acc[nt][0], acc[nt][1]);
                    *reinterpret_cast<float2*>(sDU + el_hi * LDU + c0) =
                        make_float2(acc[nt][2], acc[nt][3]);
                }
            }
        }
        __syncthreads();

        // ---- (7) row sums into da, dwe, column runs (db, dx) ----
        int n_runs = 0;
        if (tid < H) {
            // four edges at a time, their dz read before any run is written
            // back (a run goes to a row already read)
            float run = 0.f;
            for (int e0 = 0; e0 < tn; e0 += 4) {
                float v[4];
#pragma unroll
                for (int i = 0; i < 4; ++i)
                    v[i] = e0 + i < tn ? sDU[(e0 + i) * LDU + tid] : 0.f;
                const int4 lr4 = *reinterpret_cast<const int4*>(eLR + e0);
                const int4 col4 = *reinterpret_cast<const int4*>(eCol + e0);
                const float4 dc4 = *reinterpret_cast<const float4*>(eDc + e0);
                const float4 di4 = *reinterpret_cast<const float4*>(eDi + e0);
                const int lrs[4] = {lr4.x, lr4.y, lr4.z, lr4.w};
                const int cols[5] = {col4.x, col4.y, col4.z, col4.w,
                                     e0 + 4 < PE ? eCol[e0 + 4] : -1};
                const float dcs[4] = {dc4.x, dc4.y, dc4.z, dc4.w};
                const float dis[4] = {di4.x, di4.y, di4.z, di4.w};
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    if (e0 + i >= tn) break;
                    sDA[lrs[i] * H + tid] += v[i];
                    acc_we0 = fmaf(v[i], dcs[i], acc_we0);
                    acc_we1 = fmaf(v[i], dis[i], acc_we1);
                    run += v[i];
                    if (e0 + i == tn - 1 || cols[i + 1] != cols[i]) {
                        sDU[n_runs * LDU + tid] = run;
                        if (tid == 0) runCol[n_runs] = cols[i];
                        ++n_runs;
                        run = 0.f;
                    }
                }
            }
        }
        int n_xruns = 0;
        if (xthread) {                // the same, for component c of dx
            float run = 0.f;
            for (int e0 = 0; e0 < tn; e0 += 4) {
                float gp[4], gq[4];
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const bool ok = e0 + i < tn;
                    gp[i] = ok ? eEG[(e0 + i) * 6 + xc_] : 0.f;
                    gq[i] = ok ? eEG[(e0 + i) * 6 + 3 + xc_] : 0.f;
                }
                const int4 lr4 = *reinterpret_cast<const int4*>(eLR + e0);
                const int4 col4 = *reinterpret_cast<const int4*>(eCol + e0);
                const int lrs[4] = {lr4.x, lr4.y, lr4.z, lr4.w};
                const int cols[5] = {col4.x, col4.y, col4.z, col4.w,
                                     e0 + 4 < PE ? eCol[e0 + 4] : -1};
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    if (e0 + i >= tn) break;
                    sXR[lrs[i] * 4 + xc_] += gp[i];
                    if (ws.cross) dctr -= gp[i] + gq[i];
                    run += gq[i];
                    if (e0 + i == tn - 1 || cols[i + 1] != cols[i]) {
                        runX[n_xruns * 3 + xc_] = run;
                        ++n_xruns;
                        run = 0.f;
                    }
                }
            }
        }
        __syncthreads();
        // the runs of a pass have distinct columns: their read-modify-
        // writes of the partial record are independent, four at a time
        if (tid < H) {
            float* pb = part + L.b + tid;
            int r = 0;
            for (; r + 4 <= n_runs; r += 4) {
                float o[4];
#pragma unroll
                for (int i = 0; i < 4; ++i) o[i] = pb[(size_t)runCol[r + i] * H];
#pragma unroll
                for (int i = 0; i < 4; ++i)
                    pb[(size_t)runCol[r + i] * H] = o[i] + sDU[(r + i) * LDU + tid];
            }
            for (; r < n_runs; ++r)
                pb[(size_t)runCol[r] * H] += sDU[r * LDU + tid];
        }
        if (xthread)
            for (int r = 0; r < n_xruns; ++r)
                part[L.x + runCol[r] * 3 + xc_] += runX[r * 3 + xc_];
        PROF_T(p8);
        PROF_ADD(1, p0, p8);
    }

    if (n_chunks == 0)                // the first copies were asked for
        for (int s = 0; s < VSTAGES - 1; ++s) mbar_wait(full + s, 0);
    __syncthreads();

    // ---- write what the block owns, and the rest of its record ----
    if (n_pass == 0)
        for (int i = tid; i < H * H; i += THREADS) part[L.w2 + i] = 0.f;
    for (int i = tid; i < nrow * H; i += THREADS)
        ws.da[((size_t)bi * N + grow(i / H)) * H + i % H] = sDA[i];
    if (tid < H) {
        part[L.vec + tid] = acc_b2;
        part[L.vec + H + tid] = acc_we0;
        part[L.vec + 2 * H + tid] = acc_we1;
        part[L.vec + 3 * H + tid] = acc_wv;
    }
    if constexpr (VEC) {
        if (tid == 0) part[L.vec + 4 * H] = 0.f;
    } else {                          // dbatt: warps, then lanes 0 in order
        const float v = warp_sum(acc_batt);
        if (lane == 0) sRed[warp] = v;
        __syncthreads();
        if (tid == 0) {
            float sum = 0.f;
            for (int w = 0; w < NW; ++w) sum += sRed[w];
            part[L.vec + 4 * H] = sum;
        }
    }
    if (xthread) {
        for (int lr = 0; lr < nrow; ++lr)
            part[L.x + grow(lr) * 3 + xc_] += sXR[lr * 4 + xc_];
        part[L.c + xc_] = dctr;
    }
    PROF_T(p_done);
    PROF_ADD(0, p_start, p_done);
}

// ---------------------------------------------------------------------------
// edge_chain_bwd_wgmma: the bf16 backward on wgmma
// ---------------------------------------------------------------------------

constexpr int WPE = 64;              // edges per pass: one wgmma M tile
constexpr int DU_PARTS = 3;          // du = hi + lo + lo2, each exact in bf16

template <int H>
struct WCfg {
    static constexpr int NK = H / 16;              // k-steps of a product
    static constexpr int NKW = NK / 2;             // a warpgroup's own k-steps
    static constexpr int NSLAB = H / 64;           // 64-wide slabs
    static constexpr bool RING = H == 256;         // W2' streamed by slabs
    // H = 128: the block's dW2 in shared memory over its passes (64 KB;
    // above, its H^2 floats do not fit beside W2', s' and du)
    static constexpr bool DW2_SMEM = H == 128;
    // (5): the n width of a dW2 tile, and whether a tile's old values are
    // read while its products run (at H = 256 the registers are short)
    static constexpr int TN5 = 64;
    static constexpr bool AHEAD = H < 256;
    // tiles of (3)'s epilogue between warp barriers in its first sweep
    // (the spacing at which ptxas reports no spill at each H)
    static constexpr int SYNC1 = H == 192 ? 1 : 4;
    static constexpr int W2_SLABS = RING ? 2 : NSLAB;   // slabs held
    static constexpr uint32_t SLAB = 128 * H;      // bytes of a W2' slab
    static constexpr uint32_t ESLAB = 128 * WPE;   // of a pass operand's slab
    static constexpr int NT3 = H / 16;             // n8 tiles of u's half
    static constexpr int NT6 = 2 * NKW;            // n8 tiles of own ds'
    static constexpr int LDZ = H + 8;              // dz row stride (floats)
    static constexpr int XT = 4;                   // n tiles per column exchange
    static constexpr int NCH = NT3 / XT;           // exchanges per pass
    static_assert(NT3 % XT == 0, "n tiles in chunks of XT");
};

// k-step i (0..NKW-1) of warpgroup w's own ones: the k of its ds' in (6),
// two pieces of W2's slabs (product6): at H = 128 slab w; at H = 192 slab
// 2w, then half of slab 1 (its first half for w = 0); at H = 256 slabs w
// and w + 2 (the ring's stage w holds them in turn)
template <int H>
__device__ __forceinline__ int own_kstep(int w, int i) {
    if constexpr (H == 128) return 4 * w + i;
    else if constexpr (H == 192) return i < 4 ? 8 * w + i : 2 * w + i;
    else return (i / 4) * 8 + w * 4 + i % 4;
}

// the k of slot s (0..15) of a k-step in pack_w2_bf16's order, the order
// in which a thread packs its A values (k 4t, 4t+1 in slots 2t, 2t+1 and
// k 4t+2, 4t+3 in slots 2t+8, 2t+9)
__host__ __device__ constexpr int slot_k(int s) {
    return 4 * (s % 8 / 2) + 2 * (s / 8) + s % 2;
}

// x, y split into three bf16 parts each, x = x0 + x1 + x2 to 2^-24 of x
// (each residual exact in fp32), packed in pairs (x low): p[q] = (xq, yq)
__device__ __forceinline__ void split3(float x, float y, uint32_t (&p)[3]) {
#pragma unroll
    for (int q = 0; q < DU_PARTS; ++q) {
        p[q] = pack_bf16x2(x, y);
        x -= __uint_as_float(p[q] << 16);
        y -= __uint_as_float(p[q] & 0xffff0000u);
    }
}

// x, as a value taken anew at this point: a descriptor made from it is
// computed beside the wgmma that reads it.  Without it the compiler keeps
// the descriptors of every unrolled product, invariant over the passes, in
// registers for the whole loop (and spills).
__device__ __forceinline__ uint32_t fresh(uint32_t x) {
    asm volatile("mov.b32 %0, %0;" : "+r"(x));
    return x;
}

// bar.sync on a named barrier for the 128 threads of one warpgroup
__device__ __forceinline__ void wg_sync(int wg) {
    asm volatile("bar.sync %0, 128;" :: "r"(1 + wg) : "memory");
}

__device__ __forceinline__ void fence_async_smem() {
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// (6) for warpgroup wg: d[2i..2i+1] (its own k-step i) += du's parts (A,
// K-major, rows the pass's edges) @ W2'^T over every n, B read from W2'
// as it is packed (K-major for (3)) through the MN-major descriptor: row
// n of a slab holds 64 k, which is what the transpose wants.  A piece is
// the part of a slab the warpgroup owns (own_kstep): its address (slab,
// and the k offset inside it) and width, and its first tile of d; both
// warpgroups run the same pieces, so that no wgmma sits on a path the
// compiler cannot prove uniform.  PIECE: -1 both (W2' held whole), else
// that one alone (the ring: it is in stage wg).
template <int H, int PIECE>
__device__ __forceinline__ void product6(float (&d)[WCfg<H>::NT6][4],
                                         uint32_t du_addr, uint32_t w2_addr,
                                         int wg) {
    using C = WCfg<H>;
    auto run = [&](uint32_t b0, auto width_c, auto tile_c) {
        constexpr int W = decltype(width_c)::value;
        constexpr int TILE = decltype(tile_c)::value;
#pragma unroll
        for (int c = 0; c < C::NK; ++c)
#pragma unroll
            for (int q = 0; q < DU_PARTS; ++q) {
                const uint64_t da = wgmma_desc_b128(
                    fresh(du_addr) + q * C::NSLAB * C::ESLAB
                    + (c >> 2) * C::ESLAB + (c & 3) * 32);
                const uint64_t db = wgmma_desc_mn128(
                    fresh(b0) + c * 16 * 128, C::SLAB);
                wgmma_ss<W, TILE, 0, 1>(d, da, db, (c | q) != 0);
            }
    };
    using W64 = std::integral_constant<int, 64>;
    using T0 = std::integral_constant<int, 0>;
    using T8 = std::integral_constant<int, 8>;
    if constexpr (H == 128) {
        run(w2_addr + wg * C::SLAB, W64{}, T0{});
    } else if constexpr (H == 192) {
        // slab 2 wg, then k 64..95 (wg 0) or 96..127 (wg 1) of slab 1
        run(w2_addr + 2 * wg * C::SLAB, W64{}, T0{});
        run(w2_addr + C::SLAB + wg * 64, std::integral_constant<int, 32>{},
            T8{});
    } else {
        // slab wg, then slab wg + 2, each in stage wg when it runs
        if constexpr (PIECE != 1) run(w2_addr + wg * C::SLAB, W64{}, T0{});
        if constexpr (PIECE != 0) run(w2_addr + wg * C::SLAB, W64{}, T8{});
    }
}

template <int H, bool VEC>
constexpr int wg_fixed_bytes() {
    using C = WCfg<H>;
    constexpr int XE = VEC ? WPE : 0;
    return 1024                                      // W2' alignment slack
           + C::W2_SLABS * (int)C::SLAB              // W2', or the ring
           + (1 + DU_PARTS) * C::NSLAB * (int)C::ESLAB   // s', du's parts
           + 16                                      // barriers
           + 4 * ((C::DW2_SMEM ? H * H : 0)          // H = 128: dW2
                  + 4 * H                            // we0, we1, b2, wvec'
                  + 4 * WPE                          // warpgroups' row dots
                  + 3 * WPE                          // adj, d2c, d2i
                  + 9 * XE                           // vec: dx terms, runs
                  + 4 * WPE);                        // rows, columns, runs
}

// + per owned row (a and da rows; gcl: the output gradient row, vec: the
// gout and dx rows) + the list of R * N candidate pairs
template <int H, bool VEC>
size_t wg_smem_bytes(int R, int N) {
    return (size_t)wg_fixed_bytes<H, VEC>()
           + 4 * ((size_t)R * mma_row_floats<H, VEC>() + (size_t)R * N);
}

template <int H, bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
edge_chain_bwd_wgmma(const Args p) {
    using C = WCfg<H>;
    constexpr int NK = C::NK, NKW = C::NKW, NSLAB = C::NSLAB, NT3 = C::NT3,
                  NT6 = C::NT6, LDZ = C::LDZ, NCH = C::NCH;
    constexpr uint32_t SLAB = C::SLAB, ESLAB = C::ESLAB;
    constexpr int HALF = H / 2;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    // W2' (or the ring) on a 1024-byte boundary (the swizzle), then s' and
    // du's parts, each [NSLAB][WPE][64] bf16 swizzled as W2' is; dz of a
    // pass [WPE][LDZ] fp32 over them once (5) and (6) have read them
    unsigned char* w2s = smem_raw
        + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
    unsigned char* sS = w2s + C::W2_SLABS * SLAB;
    unsigned char* sDU = sS + NSLAB * ESLAB;
    float* sDZ = reinterpret_cast<float*>(sS);
    uint64_t* bars = reinterpret_cast<uint64_t*>(sDU + DU_PARTS * NSLAB * ESLAB);
    // H = 128: the block's dW2, row k's 8-column groups swizzled by k
    // (sw2_col), so that a warp's rows of a tile spread over the banks
    float* sW2 = reinterpret_cast<float*>(bars + 2);
    auto sw2_col = [](int k, int n) { return n ^ (((k >> 2) & 3) << 3); };
    float* we0 = sW2 + (C::DW2_SMEM ? H * H : 0);
    float* we1 = we0 + H;
    float* b2s = we1 + H;
    float* wvs = b2s + H;
    float* sRed = wvs + H;                     // [2 warpgroups][2][WPE]
    float* eAdj = sRed + 4 * WPE;
    float* eDc = eAdj + WPE;
    float* eDi = eDc + WPE;
    constexpr int XE = VEC ? WPE : 0;
    float* eEG = eDi + WPE;                    // vec [WPE][6]: gp, gq
    float* runX = eEG + 6 * XE;                // vec [WPE][3]
    int* eLR = reinterpret_cast<int*>(runX + 3 * XE);
    int* eCol = eLR + WPE;
    int* runCol = eCol + WPE;
    float* sA = reinterpret_cast<float*>(runCol + 2 * WPE);
    float* sDA = sA + p.R * H;
    float* sG = sDA + p.R * H;                 // gcl [R][H]; vec [R][4]
    float* sXR = sG + (VEC ? 4 : H) * p.R;     // vec [R][4]
    int* elist = reinterpret_cast<int*>(sXR + (VEC ? 4 : 0) * p.R);

    const int N = p.N, G = p.G;
    const int bi = blockIdx.y, z = blockIdx.z;
    const int tid = threadIdx.x, lane = tid & 31;
    // the warp and its warpgroup through a shuffle, which the compiler
    // knows to be the same in the whole warp (a wgmma on a path it cannot
    // prove uniform is serialised)
    const int warp = __shfl_sync(FULL, tid >> 5, 0);
    const int g = lane >> 2, t = lane & 3;
    const int wg = warp >> 2, wq = warp & 3;   // warpgroup, its warp
    const int row_limit = p.n_rows < N ? p.n_rows : N;
    const int nrow = (row_limit - (int)blockIdx.x + G - 1) / G;   // <= R
    auto grow = [&](int lr) { return (int)blockIdx.x + lr * G; };
    const Set ws = z ? p.s[1] : p.s[0];
    const Layout L = layout(H, N);
    float* part = p.part + ((size_t)(z * p.B + bi) * G + blockIdx.x) * p.P;
    const float* b_b = ws.b + (size_t)bi * N * H;
    const float* ctr = VEC ? p.center + (size_t)bi * 3 : nullptr;
    const unsigned char* w2src = reinterpret_cast<const unsigned char*>(ws.w2);
    PROF_T(p_start);

    // W2' whole, as pack_w2_bf16 lays it out, one bulk copy per slab while
    // the block builds its list (the ring: its first two slabs, below)
    if (tid == 0) {
        mbar_init(bars, C::RING ? 1 : NSLAB);
        mbar_init(bars + 1, 1);
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
        fence_async_smem();
        if constexpr (!C::RING)
#pragma unroll
            for (int s = 0; s < NSLAB; ++s)
                bulk_load(w2s + s * SLAB, w2src + s * SLAB, SLAB, bars);
    }
    // slab s into stage st of the ring (one thread asks)
    auto request = [&](int s, int st) {
        bulk_load(w2s + st * SLAB, w2src + s * SLAB, SLAB, bars + st);
    };

    for (int i = tid; i < nrow * H; i += THREADS) {
        const size_t o = ((size_t)bi * N + grow(i / H)) * H + i % H;
        sA[i] = ws.a[o];
        sDA[i] = 0.f;
        if constexpr (!VEC) sG[i] = p.gout[o];
    }
    if constexpr (VEC) {
        for (int i = tid; i < nrow * 4; i += THREADS) {
            const int c = i & 3;
            sG[i] = c < 3 ? p.gout[((size_t)bi * N + grow(i >> 2)) * 3 + c]
                          : 0.f;
            sXR[i] = 0.f;
        }
    }
    for (int i = tid; i < H; i += THREADS) {
        we0[i] = ws.we[i];
        we1[i] = ws.we[H + i];
        b2s[i] = ws.b2[i];
        wvs[i] = bf16_rn(ws.wvec[i]);
    }
    for (int i = tid; i < N * H; i += THREADS) part[L.b + i] = 0.f;
    if constexpr (VEC)
        for (int i = tid; i < 3 * N; i += THREADS) part[L.x + i] = 0.f;
    if constexpr (C::DW2_SMEM)
        for (int i = tid; i < H * H; i += THREADS) sW2[i] = 0.f;

    const int n_edges = __shfl_sync(
        FULL, build_list(p.adj + (size_t)bi * N * N, N, nrow, G,
                         reinterpret_cast<int*>(sDZ), elist), 0);
    if constexpr (C::RING) {
        if (tid == 0 && n_edges > 0) {
            request(0, 0);
            request(1, 1);
        }
    } else {
        mbar_wait(bars, 0);           // W2' is here
    }
    PROF_ADD(5, 0, 1);

    // column tid (< H): the block's dwe0, dwe1
    float acc_we0 = 0.f, acc_we1 = 0.f;
    // gcl: dbatt over the edges of this thread (threads < 64, an edge each)
    float acc_batt = 0.f;
    // vec: threads xt..xt+2: component c of dx (and dcenter)
    const int xt = H + 3 <= THREADS ? H : 0;
    const int xc_ = tid - xt;
    const bool xthread = VEC && xc_ >= 0 && xc_ < 3;
    float dctr = 0.f;
    // the thread's column sums of du (db2) and coef * m' (dwvec) over its
    // warp's edges of every pass, one column per exchange of XT n tiles
    float col_b[NCH], col_w[NCH];
#pragma unroll
    for (int i = 0; i < NCH; ++i) col_b[i] = col_w[i] = 0.f;
    const bool up1 = lane & 16, up2 = lane & 8, up3 = lane & 4;
    const int base = (up1 ? 4 : 0) + (up2 ? 2 : 0) + (up3 ? 1 : 0);
    // this thread's two edges of a pass (rows g, g + 8 of its warp's 16)
    const int el_lo = 16 * wq + g, el_hi = el_lo + 8;
    const uint32_t sS_a = smem_addr(sS), sDU_a = smem_addr(sDU),
                   w2_a = smem_addr(w2s);

    // the passes of WPE edges (counted by their first edge: no register
    // for the pass count, which spilled)
    for (int e0 = 0; e0 < n_edges; e0 += WPE) {
        const int tn = n_edges - e0 < WPE ? n_edges - e0 : WPE;
        // the pass's edges; an entry past the list is (row 0, column 0)
        // with adj 0, so every gradient it gives is 0
        if (tid < WPE) {
            const bool v = tid < tn;
            const int pk = v ? elist[e0 + tid] : 0;
            const int lr = pk >> 16, col = pk & 0xffff;
            const size_t o = ((size_t)bi * N + grow(lr)) * N + col;
            eLR[tid] = lr;
            eCol[tid] = col;
            eAdj[tid] = v ? p.adj[o] : 0.f;
            eDc[tid] = v ? p.d2c[o] : 0.f;
            eDi[tid] = v ? p.d2i[o] : 0.f;
        }
        __syncthreads();
        PROF_T(p0);
        PROF_ADD(4, 0, 1);
        const int lr_lo = eLR[el_lo], lr_hi = eLR[el_hi];

        // ---- the s' chain: each warpgroup its own k-steps of the pass's
        // 64 edges: u1 in the plain version's order, sigma(u1) once (one
        // ex2, one reciprocal), s' = bf16(u1 sigma) to shared memory in
        // the A layout of (3), silu'(u1) kept for (6) ----
        float dsl[NKW][8];            // k 4t..4t+3 of edge lo, then hi
        {
            const float dc_lo = eDc[el_lo], dc_hi = eDc[el_hi];
            const float di_lo = eDi[el_lo], di_hi = eDi[el_hi];
            const float* a_lo = sA + lr_lo * H + 4 * t;
            const float* a_hi = sA + lr_hi * H + 4 * t;
            const float* b_lo = b_b + (size_t)eCol[el_lo] * H + 4 * t;
            const float* b_hi = b_b + (size_t)eCol[el_hi] * H + 4 * t;
            float4 bl = __ldg(reinterpret_cast<const float4*>(
                b_lo + 16 * own_kstep<H>(wg, 0)));
            float4 bh = __ldg(reinterpret_cast<const float4*>(
                b_hi + 16 * own_kstep<H>(wg, 0)));
#pragma unroll
            for (int i = 0; i < NKW; ++i) {
                // a warp barrier per k-step keeps the loads of later steps
                // from being hoisted beside dsl (registers)
                __syncwarp();
                const int c = own_kstep<H>(wg, i);
                float4 bl_n = bl, bh_n = bh;
                if (i + 1 < NKW) {    // b_j of the next step, ahead
                    const int cn = own_kstep<H>(wg, i + 1);
                    bl_n = __ldg(reinterpret_cast<const float4*>(b_lo + 16 * cn));
                    bh_n = __ldg(reinterpret_cast<const float4*>(b_hi + 16 * cn));
                }
                const float4 al = *reinterpret_cast<const float4*>(a_lo + 16 * c);
                const float4 ah = *reinterpret_cast<const float4*>(a_hi + 16 * c);
                const float4 w0 = *reinterpret_cast<const float4*>(we0 + 16 * c + 4 * t);
                const float4 w1 = *reinterpret_cast<const float4*>(we1 + 16 * c + 4 * t);
                const float av[8] = {al.x, al.y, al.z, al.w, ah.x, ah.y, ah.z, ah.w};
                const float bv[8] = {bl.x, bl.y, bl.z, bl.w, bh.x, bh.y, bh.z, bh.w};
                const float w0v[4] = {w0.x, w0.y, w0.z, w0.w};
                const float w1v[4] = {w1.x, w1.y, w1.z, w1.w};
                float sv[8];
#pragma unroll
                for (int e = 0; e < 8; ++e) {
                    const float u1 = pre_exact(av[e], bv[e], e < 4 ? dc_lo : dc_hi,
                                               w0v[e & 3], e < 4 ? di_lo : di_hi,
                                               w1v[e & 3]);
                    const float sg = sigm_fast(u1);
                    sv[e] = u1 * sg;
                    dsl[i][e] = sg * (1.f + u1 * (1.f - sg));
                }
                // slots 2t, 2t+1 (group 2 (c % 4)) and 2t+8, 2t+9 (the
                // next group) of rows el_lo and el_hi, swizzled by row
                unsigned char* slab = sS + (c >> 2) * ESLAB + 4 * t;
                const int q0 = 2 * (c & 3);
                *reinterpret_cast<uint32_t*>(
                    slab + el_lo * 128 + ((q0 ^ g) << 4)) = pack_bf16x2(sv[0], sv[1]);
                *reinterpret_cast<uint32_t*>(
                    slab + el_lo * 128 + (((q0 + 1) ^ g) << 4)) = pack_bf16x2(sv[2], sv[3]);
                *reinterpret_cast<uint32_t*>(
                    slab + el_hi * 128 + ((q0 ^ g) << 4)) = pack_bf16x2(sv[4], sv[5]);
                *reinterpret_cast<uint32_t*>(
                    slab + el_hi * 128 + (((q0 + 1) ^ g) << 4)) = pack_bf16x2(sv[6], sv[7]);
                bl = bl_n;
                bh = bh_n;
            }
        }
        fence_async_smem();
        __syncthreads();
        PROF_T(p1);
        PROF_ADD(6, p0, p1);

        // ---- (3) u = s' @ W2': warpgroup wg the columns wg H/2.. of all
        // 64 edges, A (s') and B (W2') from shared memory, K-major ----
        float acc[NT3][4];
#pragma unroll
        for (int j = 0; j < NT3; ++j)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
        {
            const uint32_t wb = w2_a + wg * HALF * 128;
            if constexpr (C::RING) {
                mbar_wait(bars, 0);
                mbar_wait(bars + 1, 0);
            }
            wgmma_fence();
#pragma unroll
            for (int c = 0; c < NK; ++c) {
                if (C::RING && c == 8) {
                    // slabs 2, 3 into the stages once both warpgroups are
                    // done with slabs 0, 1
                    wgmma_commit();
                    wgmma_wait<0>();
                    wgmma_fence_acc(acc);
                    __syncthreads();
                    if (tid == 0) {
                        request(2, 0);
                        request(3, 1);
                    }
                    mbar_wait(bars, 1);
                    mbar_wait(bars + 1, 1);
                    wgmma_fence();
                }
                const int st = C::RING ? (c >> 2) & 1 : c >> 2;
                const uint64_t da = wgmma_desc_b128(
                    fresh(sS_a) + (c >> 2) * ESLAB + (c & 3) * 32);
                const uint64_t db = wgmma_desc_b128(
                    fresh(wb) + st * SLAB + (c & 3) * 32);
                wgmma_ss<HALF, 0, 0, 0>(acc, da, db, c > 0);
            }
            wgmma_commit();
            wgmma_wait<0>();
            wgmma_fence_acc(acc);
            if constexpr (C::RING) {
                // slabs 0, 1 back for (6), while the epilogue runs
                __syncthreads();
                if (tid == 0) {
                    request(0, 0);
                    request(1, 1);
                }
            }
        }
        PROF_T(p2);
        PROF_ADD(2, p1, p2);

        // ---- the epilogue of (3): u = acc + b2, m = silu(u) (sigma(u)
        // once), the row dots over both warpgroups' halves, then du =
        // dm * silu'(u) as three bf16 parts to shared memory, and the
        // column sums of du and coef * m' ----
        {
            const float* gr_lo = sG + lr_lo * H;
            const float* gr_hi = sG + lr_hi * H;
            float dot_lo = 0.f, dot_hi = 0.f, gm_lo = 0.f, gm_hi = 0.f;
            // m' waits in du's last part, where this thread writes that
            // part of the same elements later: (edge, column c0) of row
            // el at mslot(c0) + el * 128
            auto mslot = [&](int c0) {
                return sDU + (DU_PARTS - 1) * NSLAB * ESLAB + (c0 >> 6) * ESLAB
                       + ((((c0 & 63) >> 3) ^ g) << 4) + 4 * t;
            };
#pragma unroll
            for (int j = 0; j < NT3; ++j) {
                // warp barriers keep the loads of later tiles (bias,
                // weights, the gout rows) from being hoisted (registers)
                if (j % C::SYNC1 == 0) __syncwarp();
                const int c0 = wg * HALF + 8 * j + 2 * t;
                const float2 bias = *reinterpret_cast<const float2*>(b2s + c0);
                const float2 wv = *reinterpret_cast<const float2*>(wvs + c0);
                float m[4], mr[4];
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const float u = acc[j][i] + (i & 1 ? bias.y : bias.x);
                    const float sg = sigm_fast(u);
                    m[i] = u * sg;
                    mr[i] = bf16_rn(m[i]);
                    acc[j][i] = sg * (1.f + u * (1.f - sg));   // silu'(u)
                }
                *reinterpret_cast<uint32_t*>(mslot(c0) + el_lo * 128) =
                    pack_bf16x2(mr[0], mr[1]);
                *reinterpret_cast<uint32_t*>(mslot(c0) + el_hi * 128) =
                    pack_bf16x2(mr[2], mr[3]);
                dot_lo = fmaf(mr[0], wv.x, fmaf(mr[1], wv.y, dot_lo));
                dot_hi = fmaf(mr[2], wv.x, fmaf(mr[3], wv.y, dot_hi));
                if constexpr (!VEC) {
                    const float2 gl = *reinterpret_cast<const float2*>(gr_lo + c0);
                    const float2 gh = *reinterpret_cast<const float2*>(gr_hi + c0);
                    gm_lo = fmaf(m[0], gl.x, fmaf(m[1], gl.y, gm_lo));
                    gm_hi = fmaf(m[2], gh.x, fmaf(m[3], gh.y, gm_hi));
                }
            }
            dot_lo = quad_sum(dot_lo);
            dot_hi = quad_sum(dot_hi);
            if constexpr (!VEC) {
                gm_lo = quad_sum(gm_lo);
                gm_hi = quad_sum(gm_hi);
            }
            if (t == 0) {
                float* r = sRed + wg * 2 * WPE;
                r[el_lo] = dot_lo;
                r[el_hi] = dot_hi;
                if constexpr (!VEC) {
                    r[WPE + el_lo] = gm_lo;
                    r[WPE + el_hi] = gm_hi;
                }
            }
            __syncthreads();
            // per edge, by thread e < 64 (both halves, warpgroup 0's
            // first): dm = alpha * gout_i + bf16(coef * wvec'), and coef
            // is the factor of m' in the column sums (dwatt / dwout)
            if (tid < WPE) {
                const int el = tid;
                const float dot = sRed[el] + sRed[2 * WPE + el];
                // 1 / norm_factor and batt taken here, each pass: held in
                // registers over the passes they spilled
                float nf = p.norm_factor;
                asm volatile("" : "+f"(nf));
                const float av = eAdj[el] * (1.f / nf);
                float alpha_e = 0.f, coef_e;
                if constexpr (!VEC) {
                    if (p.flag_a) {
                        const float gm = sRed[WPE + el] + sRed[3 * WPE + el];
                        const float gate = sigm(dot + p.batt[0]);
                        coef_e = av * gm * gate * (1.f - gate);
                        alpha_e = av * gate;
                    } else {
                        coef_e = 0.f;
                        alpha_e = av;
                    }
                    acc_batt += coef_e;
                } else {
                    const int lr = eLR[el], col = eCol[el];
                    const float* xr = p.x + ((size_t)bi * N + grow(lr)) * 3;
                    const float* xc = p.x + ((size_t)bi * N + col) * 3;
                    const float Gr[3] = {sG[lr * 4], sG[lr * 4 + 1], sG[lr * 4 + 2]};
                    const float th = p.flag_a ? tanhf(dot) : 0.f;
                    const float phi = p.flag_a ? th * p.coords_range : dot;
                    float vh[3], gp[3], gq[3];
                    direction(xr, xc, ctr, ws.cross, p.norm_constant, Gr,
                              av * phi, vh, gp, gq);
                    const float dphi = av * (Gr[0] * vh[0] + Gr[1] * vh[1]
                                             + Gr[2] * vh[2]);
                    coef_e = p.flag_a ? dphi * p.coords_range * (1.f - th * th)
                                      : dphi;
#pragma unroll
                    for (int c = 0; c < 3; ++c) {
                        eEG[el * 6 + c] = gp[c];
                        eEG[el * 6 + 3 + c] = gq[c];
                    }
                }
                sRed[el] = alpha_e;
                sRed[WPE + el] = coef_e;
            }
            __syncthreads();
            const float alpha[2] = {sRed[el_lo], sRed[el_hi]};
            const float coef[2] = {sRed[WPE + el_lo], sRed[WPE + el_hi]};
            // du, XT n tiles at a time: its parts to shared memory; the
            // column sums' terms of the warp's 16 edges over the 8 lanes
            // that share t, halving what a lane keeps at each step
#pragma unroll
            for (int ch = 0; ch < NCH; ++ch) {
                // a warp barrier per chunk keeps its loads in place: the
                // compiler hoists every chunk's otherwise (and spills)
                __syncwarp();
                float vb[2 * C::XT], vw[2 * C::XT];
#pragma unroll
                for (int jj = 0; jj < C::XT; ++jj) {
                    const int j = ch * C::XT + jj;
                    const int c0 = wg * HALF + 8 * j + 2 * t;
                    const float2 wv = *reinterpret_cast<const float2*>(wvs + c0);
                    float gv[4] = {0.f, 0.f, 0.f, 0.f};
                    if constexpr (!VEC) {
                        const float2 gl = *reinterpret_cast<const float2*>(gr_lo + c0);
                        const float2 gh = *reinterpret_cast<const float2*>(gr_hi + c0);
                        gv[0] = gl.x; gv[1] = gl.y; gv[2] = gh.x; gv[3] = gh.y;
                    }
                    const uint32_t ml = *reinterpret_cast<const uint32_t*>(
                        mslot(c0) + el_lo * 128);
                    const uint32_t mh = *reinterpret_cast<const uint32_t*>(
                        mslot(c0) + el_hi * 128);
                    const float mr[4] = {
                        __uint_as_float(ml << 16),
                        __uint_as_float(ml & 0xffff0000u),
                        __uint_as_float(mh << 16),
                        __uint_as_float(mh & 0xffff0000u)};
                    float du[4];
#pragma unroll
                    for (int i = 0; i < 4; ++i) {
                        // the gradient of m' in the dot, rounded where the
                        // forward rounded m
                        const float dw = bf16_rn(coef[i >> 1] * (i & 1 ? wv.y : wv.x));
                        const float dm = VEC ? dw : fmaf(alpha[i >> 1], gv[i], dw);
                        du[i] = dm * acc[j][i];
                    }
                    vb[2 * jj] = du[0] + du[2];
                    vb[2 * jj + 1] = du[1] + du[3];
                    vw[2 * jj] = fmaf(coef[0], mr[0], coef[1] * mr[2]);
                    vw[2 * jj + 1] = fmaf(coef[0], mr[1], coef[1] * mr[3]);
                    // column c0 of rows el_lo, el_hi: slab c0 / 64, group
                    // (c0 % 64) / 8 swizzled by row, bytes 4t
                    uint32_t plo[3], phi_[3];
                    split3(du[0], du[1], plo);
                    split3(du[2], du[3], phi_);
                    unsigned char* d0 = sDU + (c0 >> 6) * ESLAB + 4 * t;
                    const int grp = ((c0 & 63) >> 3) ^ g;
#pragma unroll
                    for (int q = 0; q < DU_PARTS; ++q) {
                        unsigned char* dq = d0 + q * NSLAB * ESLAB + (grp << 4);
                        *reinterpret_cast<uint32_t*>(dq + el_lo * 128) = plo[q];
                        *reinterpret_cast<uint32_t*>(dq + el_hi * 128) = phi_[q];
                    }
                }
                constexpr int V = 2 * C::XT;
#pragma unroll
                for (int j = 0; j < V / 2; ++j) {
                    vb[j] = (up1 ? vb[j + V / 2] : vb[j])
                            + __shfl_xor_sync(FULL, up1 ? vb[j] : vb[j + V / 2], 16);
                    vw[j] = (up1 ? vw[j + V / 2] : vw[j])
                            + __shfl_xor_sync(FULL, up1 ? vw[j] : vw[j + V / 2], 16);
                }
#pragma unroll
                for (int j = 0; j < V / 4; ++j) {
                    vb[j] = (up2 ? vb[j + V / 4] : vb[j])
                            + __shfl_xor_sync(FULL, up2 ? vb[j] : vb[j + V / 4], 8);
                    vw[j] = (up2 ? vw[j + V / 4] : vw[j])
                            + __shfl_xor_sync(FULL, up2 ? vw[j] : vw[j + V / 4], 8);
                }
                vb[0] = (up3 ? vb[1] : vb[0])
                        + __shfl_xor_sync(FULL, up3 ? vb[0] : vb[1], 4);
                vw[0] = (up3 ? vw[1] : vw[0])
                        + __shfl_xor_sync(FULL, up3 ? vw[0] : vw[1], 4);
                // value `base` of the chunk: n tile ch XT + base / 2,
                // column 2t + base % 2
                col_b[ch] += vb[0];
                col_w[ch] += vw[0];
            }
        }
        fence_async_smem();
        __syncthreads();
        PROF_T(p3);
        PROF_ADD(8, p2, p3);

        // ---- (5) dW2 += s'^T du over the pass, then (6) ds = du @ W2'^T
        // for the warpgroup's own k, both from shared memory (in this
        // order acc6 holds no register through (5)); the ring: (6) on the
        // stage's first slab, then on its second (the refill between
        // them is waited for) ----
        auto product5 = [&]() {
            {
                // tiles of 64 k x TN5 n, dealt to the warpgroups in turn, over
                // the pass's four 16-edge steps (the rows of a ragged pass's
                // entries past the list have du = 0); the accumulator row of
                // position m of slab mb is k = 64 mb + 16 (m / 16) + slot_k(m %
                // 16)
                constexpr int TN5 = C::TN5, NJ = TN5 / 8, NTN = H / TN5;
                const int k_lo = 16 * wq + slot_k(g), k_hi = 16 * wq + slot_k(g + 8);
#pragma unroll 1
                for (int tile = wg; tile < NSLAB * NTN; tile += 2) {
                    const int mb = tile / NTN, n0 = TN5 * (tile % NTN);
                    float d5[NJ][4];
#pragma unroll
                    for (int j = 0; j < NJ; ++j)
#pragma unroll
                        for (int i = 0; i < 4; ++i) d5[j][i] = 0.f;
                    wgmma_fence();
#pragma unroll
                    for (int ks = 0; ks < WPE / 16; ++ks)
#pragma unroll
                        for (int q = 0; q < DU_PARTS; ++q) {
                            const uint64_t da = wgmma_desc_mn128(
                                fresh(sS_a) + mb * ESLAB + ks * 2048, ESLAB);
                            // n n0..n0 + TN5 - 1 of du's slab n0 / 64 (a
                            // 32-wide tile reads its rows from 64 bytes in
                            // for the slab's second half)
                            const uint64_t db = wgmma_desc_mn128(
                                fresh(sDU_a) + (q * NSLAB + n0 / 64) * ESLAB
                                + (n0 % 64) * 2 + ks * 2048, ESLAB);
                            wgmma_ss<TN5, 0, 1, 1>(d5, da, db, (ks | q) != 0);
                        }
                    wgmma_commit();
                    // rows k_lo, k_hi at columns n, n + 1 of the block's
                    // dW2: at H = 128 in shared memory (zeroed at the
                    // start); above, in its record, which the first pass
                    // writes and later ones add to.  The old values are
                    // read while the products run where the registers
                    // allow (AHEAD).  Each memory space in its own
                    // branch, the reads as written:
                    // a form with the address (one pointer for both
                    // spaces) and the condition through small lambdas made
                    // (5) twice as slow at H = 192.
                    float2 o_lo[NJ], o_hi[NJ];
                    const int kl = 64 * mb + k_lo, kh = 64 * mb + k_hi;
                    if constexpr (C::DW2_SMEM) {
                        float* r_lo = sW2 + kl * H;
                        float* r_hi = sW2 + kh * H;
#pragma unroll
                        for (int j = 0; j < NJ; ++j) {
                            const int n = n0 + 8 * j + 2 * t;
                            o_lo[j] = *reinterpret_cast<const float2*>(r_lo + sw2_col(kl, n));
                            o_hi[j] = *reinterpret_cast<const float2*>(r_hi + sw2_col(kh, n));
                        }
                        wgmma_wait<0>();
                        wgmma_fence_acc(d5);
#pragma unroll
                        for (int j = 0; j < NJ; ++j) {
                            const int n = n0 + 8 * j + 2 * t;
                            *reinterpret_cast<float2*>(r_lo + sw2_col(kl, n)) =
                                make_float2(o_lo[j].x + d5[j][0], o_lo[j].y + d5[j][1]);
                            *reinterpret_cast<float2*>(r_hi + sw2_col(kh, n)) =
                                make_float2(o_hi[j].x + d5[j][2], o_hi[j].y + d5[j][3]);
                        }
                    } else {
                        float* r_lo = part + L.w2 + (size_t)kl * H + n0 + 2 * t;
                        float* r_hi = part + L.w2 + (size_t)kh * H + n0 + 2 * t;
                        auto read = [&]() {
#pragma unroll
                            for (int j = 0; j < NJ; ++j)
                                o_lo[j] = e0 ? *reinterpret_cast<const float2*>(r_lo + 8 * j)
                                             : make_float2(0.f, 0.f);
#pragma unroll
                            for (int j = 0; j < NJ; ++j)
                                o_hi[j] = e0 ? *reinterpret_cast<const float2*>(r_hi + 8 * j)
                                             : make_float2(0.f, 0.f);
                        };
                        if constexpr (C::AHEAD) read();
                        wgmma_wait<0>();
                        wgmma_fence_acc(d5);
                        if constexpr (!C::AHEAD) read();
#pragma unroll
                        for (int j = 0; j < NJ; ++j) {
                            *reinterpret_cast<float2*>(r_lo + 8 * j) =
                                make_float2(o_lo[j].x + d5[j][0], o_lo[j].y + d5[j][1]);
                            *reinterpret_cast<float2*>(r_hi + 8 * j) =
                                make_float2(o_hi[j].x + d5[j][2], o_hi[j].y + d5[j][3]);
                        }
                    }
                }
            }
        };
        float acc6[NT6][4];
        if constexpr (C::RING) {
            product5();
            PROF_T(p5);
            PROF_ADD(3, p3, p5);
#pragma unroll
            for (int j = 0; j < NT6 / 2; ++j)
#pragma unroll
                for (int i = 0; i < 4; ++i) acc6[j][i] = 0.f;
            mbar_wait(bars + wg, 0);   // slab wg
            wgmma_fence();
            product6<H, 0>(acc6, sDU_a, w2_a, wg);
            wgmma_commit();
            wgmma_wait<0>();
            wgmma_fence_acc(acc6);
            // the warpgroup's stage takes its second slab (wg + 2)
            wg_sync(wg);
            if ((tid & 127) == 0) request(wg + 2, wg);
            mbar_wait(bars + wg, 1);
#pragma unroll
            for (int j = NT6 / 2; j < NT6; ++j)
#pragma unroll
                for (int i = 0; i < 4; ++i) acc6[j][i] = 0.f;
            wgmma_fence();
            product6<H, 1>(acc6, sDU_a, w2_a, wg);
            wgmma_commit();
            wgmma_wait<0>();
            wgmma_fence_acc(acc6);
            // the stage takes its first slab back for the next pass's (3)
            wg_sync(wg);
            if ((tid & 127) == 0 && e0 + WPE < n_edges) request(wg, wg);
            PROF_T(p5b);
            PROF_ADD(7, p5, p5b);
        } else {
            product5();
            PROF_T(p5);
            PROF_ADD(3, p3, p5);
#pragma unroll
            for (int j = 0; j < NT6; ++j)
#pragma unroll
                for (int i = 0; i < 4; ++i) acc6[j][i] = 0.f;
            wgmma_fence();
            product6<H, -1>(acc6, sDU_a, w2_a, wg);
            wgmma_commit();
            wgmma_wait<0>();
            wgmma_fence_acc(acc6);
            PROF_T(p5b);
            PROF_ADD(7, p5, p5b);
        }
        PROF_T(p6);

        // ---- ds' = bf16(ds), dz = ds' silu'(u1) on registers; the dots
        // of dz with we0, we1 (dd2c, dd2i) over both warpgroups ----
        {
            float dd[4] = {0.f, 0.f, 0.f, 0.f};   // d2c lo, d2i lo, hi
#pragma unroll
            for (int j = 0; j < NT6; ++j) {
                if (j % 4 == 0) __syncwarp();     // the same, per 4 tiles
                const int i = j / 2, h2 = 2 * (j & 1);
                const int k = 16 * own_kstep<H>(wg, i) + 4 * t + h2;
                const float2 w0 = *reinterpret_cast<const float2*>(we0 + k);
                const float2 w1 = *reinterpret_cast<const float2*>(we1 + k);
                acc6[j][0] = bf16_rn(acc6[j][0]) * dsl[i][h2];
                acc6[j][1] = bf16_rn(acc6[j][1]) * dsl[i][h2 + 1];
                acc6[j][2] = bf16_rn(acc6[j][2]) * dsl[i][4 + h2];
                acc6[j][3] = bf16_rn(acc6[j][3]) * dsl[i][5 + h2];
                dd[0] = fmaf(acc6[j][0], w0.x, fmaf(acc6[j][1], w0.y, dd[0]));
                dd[1] = fmaf(acc6[j][0], w1.x, fmaf(acc6[j][1], w1.y, dd[1]));
                dd[2] = fmaf(acc6[j][2], w0.x, fmaf(acc6[j][3], w0.y, dd[2]));
                dd[3] = fmaf(acc6[j][2], w1.x, fmaf(acc6[j][3], w1.y, dd[3]));
            }
#pragma unroll
            for (int i = 0; i < 4; ++i) dd[i] = quad_sum(dd[i]);
            if (t == 0) {
                float* r = sRed + wg * 2 * WPE;
                r[el_lo] = dd[0];
                r[WPE + el_lo] = dd[1];
                r[el_hi] = dd[2];
                r[WPE + el_hi] = dd[3];
            }
            __syncthreads();          // (5) and (6) are done with s', du
#pragma unroll
            for (int j = 0; j < NT6; ++j) {
                const int k = 16 * own_kstep<H>(wg, j / 2) + 4 * t + 2 * (j & 1);
                *reinterpret_cast<float2*>(sDZ + el_lo * LDZ + k) =
                    make_float2(acc6[j][0], acc6[j][1]);
                *reinterpret_cast<float2*>(sDZ + el_hi * LDZ + k) =
                    make_float2(acc6[j][2], acc6[j][3]);
            }
            if (wg == 0 && t == 0) {
#pragma unroll
                for (int side = 0; side < 2; ++side) {
                    const int el = side ? el_hi : el_lo;
                    if (el >= tn) continue;
                    const size_t o = ((size_t)bi * N + grow(side ? lr_hi : lr_lo)) * N
                                     + eCol[el];
                    if (ws.dd2c) ws.dd2c[o] = sRed[el] + sRed[2 * WPE + el];
                    if (ws.dd2i) ws.dd2i[o] = sRed[WPE + el] + sRed[3 * WPE + el];
                }
            }
        }
        __syncthreads();
        PROF_T(p7);
        PROF_ADD(9, p6, p7);

        // ---- (7) row sums into da, dwe, column runs (db, dx) ----
        int n_runs = 0;
        if (tid < H) {
            // four edges at a time, their dz read before any run is written
            // back (a run goes to a row already read)
            float run = 0.f;
            for (int q0 = 0; q0 < tn; q0 += 4) {
                float v[4];
#pragma unroll
                for (int i = 0; i < 4; ++i)
                    v[i] = q0 + i < tn ? sDZ[(q0 + i) * LDZ + tid] : 0.f;
                const int4 lr4 = *reinterpret_cast<const int4*>(eLR + q0);
                const int4 col4 = *reinterpret_cast<const int4*>(eCol + q0);
                const float4 dc4 = *reinterpret_cast<const float4*>(eDc + q0);
                const float4 di4 = *reinterpret_cast<const float4*>(eDi + q0);
                const int lrs[4] = {lr4.x, lr4.y, lr4.z, lr4.w};
                const int cols[5] = {col4.x, col4.y, col4.z, col4.w,
                                     q0 + 4 < WPE ? eCol[q0 + 4] : -1};
                const float dcs[4] = {dc4.x, dc4.y, dc4.z, dc4.w};
                const float dis[4] = {di4.x, di4.y, di4.z, di4.w};
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    if (q0 + i >= tn) break;
                    sDA[lrs[i] * H + tid] += v[i];
                    acc_we0 = fmaf(v[i], dcs[i], acc_we0);
                    acc_we1 = fmaf(v[i], dis[i], acc_we1);
                    run += v[i];
                    if (q0 + i == tn - 1 || cols[i + 1] != cols[i]) {
                        sDZ[n_runs * LDZ + tid] = run;
                        if (tid == 0) runCol[n_runs] = cols[i];
                        ++n_runs;
                        run = 0.f;
                    }
                }
            }
        }
        int n_xruns = 0;
        if (xthread) {                // the same, for component c of dx
            float run = 0.f;
            for (int q0 = 0; q0 < tn; q0 += 4) {
                float gp[4], gq[4];
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const bool ok = q0 + i < tn;
                    gp[i] = ok ? eEG[(q0 + i) * 6 + xc_] : 0.f;
                    gq[i] = ok ? eEG[(q0 + i) * 6 + 3 + xc_] : 0.f;
                }
                const int4 lr4 = *reinterpret_cast<const int4*>(eLR + q0);
                const int4 col4 = *reinterpret_cast<const int4*>(eCol + q0);
                const int lrs[4] = {lr4.x, lr4.y, lr4.z, lr4.w};
                const int cols[5] = {col4.x, col4.y, col4.z, col4.w,
                                     q0 + 4 < WPE ? eCol[q0 + 4] : -1};
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    if (q0 + i >= tn) break;
                    sXR[lrs[i] * 4 + xc_] += gp[i];
                    if (ws.cross) dctr -= gp[i] + gq[i];
                    run += gq[i];
                    if (q0 + i == tn - 1 || cols[i + 1] != cols[i]) {
                        runX[n_xruns * 3 + xc_] = run;
                        ++n_xruns;
                        run = 0.f;
                    }
                }
            }
        }
        __syncthreads();
        // the runs of a pass have distinct columns: their read-modify-
        // writes of the partial record are independent, four at a time
        if (tid < H) {
            // sixteen at a time: a round trip to L2 each
            float* pb = part + L.b + tid;
            for (int r0 = 0; r0 < n_runs; r0 += 16) {
                float o[16];
#pragma unroll
                for (int i = 0; i < 16; ++i)
                    if (r0 + i < n_runs) o[i] = pb[(size_t)runCol[r0 + i] * H];
#pragma unroll
                for (int i = 0; i < 16; ++i)
                    if (r0 + i < n_runs)
                        pb[(size_t)runCol[r0 + i] * H] =
                            o[i] + sDZ[(r0 + i) * LDZ + tid];
            }
        }
        if (xthread)
            for (int r = 0; r < n_xruns; ++r)
                part[L.x + runCol[r] * 3 + xc_] += runX[r * 3 + xc_];
        PROF_T(p8);
        PROF_ADD(1, p0, p8);
    }
    __syncthreads();

    // ---- write what the block owns, and the rest of its record ----
    if constexpr (C::DW2_SMEM) {
        for (int i = tid; i < H * H; i += THREADS)
            part[L.w2 + i] = sW2[(i / H) * H + sw2_col(i / H, i % H)];
    } else if (n_edges == 0) {
        for (int i = tid; i < H * H; i += THREADS) part[L.w2 + i] = 0.f;
    }
    for (int i = tid; i < nrow * H; i += THREADS)
        ws.da[((size_t)bi * N + grow(i / H)) * H + i % H] = sDA[i];
    // the warps' column sums (over sDZ, free now), then per column the
    // four warps of its warpgroup in order
    {
        float* sCol = sDZ;            // [2][NW][H/2]: db2, dwvec
#pragma unroll
        for (int ch = 0; ch < NCH; ++ch) {
            const int n = 8 * (ch * C::XT + base / 2) + 2 * t + (base & 1);
            sCol[warp * HALF + n] = col_b[ch];
            sCol[(NW + warp) * HALF + n] = col_w[ch];
        }
        __syncthreads();
        if (tid < H) {
            const int w0 = 4 * (tid / HALF), n = tid % HALF;
            float sb = 0.f, sw = 0.f;
#pragma unroll
            for (int v = 0; v < 4; ++v) {
                sb += sCol[(w0 + v) * HALF + n];
                sw += sCol[(NW + w0 + v) * HALF + n];
            }
            part[L.vec + tid] = sb;
            part[L.vec + H + tid] = acc_we0;
            part[L.vec + 2 * H + tid] = acc_we1;
            part[L.vec + 3 * H + tid] = sw;
        }
    }
    if constexpr (VEC) {
        if (tid == 0) part[L.vec + 4 * H] = 0.f;
    } else {                          // dbatt: warps, then lanes 0 in order
        const float v = warp_sum(acc_batt);
        if (lane == 0) sRed[warp] = v;
        __syncthreads();
        if (tid == 0) {
            float sum = 0.f;
            for (int w = 0; w < NW; ++w) sum += sRed[w];
            part[L.vec + 4 * H] = sum;
        }
    }
    if (xthread) {
        for (int lr = 0; lr < nrow; ++lr)
            part[L.x + grow(lr) * 3 + xc_] += sXR[lr * 4 + xc_];
        part[L.c + xc_] = dctr;
    }
    PROF_T(p_done);
    PROF_ADD(0, p_start, p_done);
}

// ---------------------------------------------------------------------------
// the fixed-order sums across blocks
// ---------------------------------------------------------------------------

struct RedSet {
    float* dw2;     // [H, H]
    float* db;      // [B, N, H]
    float* db2;     // [H]
    float* dwe;     // [2, H]
    float* dwvec;   // [H]
};

struct RedArgs {
    RedSet s[2];
    const float* part;
    float* dx;      // vec [B, N, 3]
    float* dctr;    // vec [B, 1, 3]
    float* dbatt;   // gcl [1], or null
    float* dd2c;    // pair: [2, B, N, N] planes, summed into the first
    float* dd2i;
    int B, N, H, G, P, n_sets, vec;
    int bf16;       // dw2 and dwvec rounded to bf16 (the bf16 backward)
};

// every sum across blocks, each element by one thread in a fixed order
__global__ void __launch_bounds__(THREADS)
edge_chain_bwd_reduce(const RedArgs p) {
    const int B = p.B, N = p.N, H = p.H, G = p.G, S = p.n_sets;
    const Layout L = layout(H, N);
    const long n_w2 = (long)H * H, n_b = (long)B * N * H, n_v = 4L * H;
    const long per_set = n_w2 + n_b + n_v;
    const long n_batt = (!p.vec && p.dbatt) ? 1 : 0;
    const long n_x = p.vec ? (long)B * N * 3 : 0, n_c = p.vec ? B * 3L : 0;
    const long n_pl = (long)B * N * N;
    const long n_d2c = (S == 2 && p.dd2c) ? n_pl : 0;
    const long n_d2i = (S == 2 && p.dd2i) ? n_pl : 0;
    const long total = S * per_set + n_batt + n_x + n_c + n_d2c + n_d2i;
    auto rec = [&](int z, int bi, int x) {
        return p.part + ((size_t)(z * B + bi) * G + x) * p.P;
    };
    for (long idx = blockIdx.x * (long)blockDim.x + threadIdx.x; idx < total;
         idx += (long)gridDim.x * blockDim.x) {
        long i = idx;
        if (i < S * per_set) {
            const int z = (int)(i / per_set);
            i -= z * per_set;
            const RedSet& o = p.s[z];
            if (i < n_w2) {
                // records (z, bi, x) lie in bi-major order: one loop whose
                // loads run ahead, the sum in the same order
                const float* r0 = rec(z, 0, 0) + L.w2 + i;
                float s = 0.f;
#pragma unroll 8
                for (int r = 0; r < B * G; ++r) s += r0[(size_t)r * p.P];
                o.dw2[i] = p.bf16 ? bf16_rn(s) : s;
            } else if (i < n_w2 + n_b) {
                i -= n_w2;
                const int bi = (int)(i / ((long)N * H));
                const long jk = i % ((long)N * H);
                float s = 0.f;
#pragma unroll 4
                for (int x = 0; x < G; ++x) s += rec(z, bi, x)[L.b + jk];
                o.db[i] = s;
            } else {
                i -= n_w2 + n_b;
                const float* r0 = rec(z, 0, 0) + L.vec + i;
                float s = 0.f;
#pragma unroll 8
                for (int r = 0; r < B * G; ++r) s += r0[(size_t)r * p.P];
                if (i < H) o.db2[i] = s;
                else if (i < 3 * H) o.dwe[i - H] = s;
                else o.dwvec[i - 3 * H] = p.bf16 ? bf16_rn(s) : s;
            }
            continue;
        }
        i -= S * per_set;
        if (i < n_batt) {
            float s = 0.f;
            for (int bi = 0; bi < B; ++bi)
                for (int x = 0; x < G; ++x) s += rec(0, bi, x)[L.vec + 4 * H];
            p.dbatt[0] = s;
            continue;
        }
        i -= n_batt;
        if (i < n_x) {
            const int bi = (int)(i / (3L * N));
            const long jc = i % (3L * N);
            float s = 0.f;
            for (int z = 0; z < S; ++z)
                for (int x = 0; x < G; ++x) s += rec(z, bi, x)[L.x + jc];
            p.dx[i] = s;
            continue;
        }
        i -= n_x;
        if (i < n_c) {
            const int bi = (int)(i / 3), c = (int)(i % 3);
            float s = 0.f;
            for (int z = 0; z < S; ++z)
                for (int x = 0; x < G; ++x) s += rec(z, bi, x)[L.c + c];
            p.dctr[i] = s;
            continue;
        }
        i -= n_c;
        if (i < n_d2c) {
            p.dd2c[i] += p.dd2c[n_pl + i];
            continue;
        }
        i -= n_d2c;
        p.dd2i[i] += p.dd2i[n_pl + i];
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

// rows per block: about one block per SM
long target_rows(int B, int rows, int n_sets) {
    const long total = (long)B * rows * n_sets;
    long R = (total + sm_count() - 1) / sm_count();
    if (R > R_MAX) R = R_MAX;
    if (R > rows) R = rows;
    return R < 1 ? 1 : R;
}

// the shared memory of a launch: edge_chain_bwd_wgmma's (BF16) or
// edge_chain_bwd_mma's
template <int H, bool VEC, bool BF16>
size_t smem_bytes(int R, int N) {
    return BF16 ? wg_smem_bytes<H, VEC>(R, N) : mma_smem_bytes<H, VEC>(R, N);
}

// fewer rows where shared memory would not hold them; 0 if not one
template <int H, bool VEC, bool BF16>
int pick_rows(int B, int rows, int N, int n_sets) {
    long R = target_rows(B, rows, n_sets);
    while (R > 1 && smem_bytes<H, VEC, BF16>((int)R, N) > (size_t)SMEM_LIMIT)
        --R;
    return smem_bytes<H, VEC, BF16>((int)R, N) <= (size_t)SMEM_LIMIT ? (int)R
                                                                     : 0;
}

template <int H>
int pick_rows(int B, int rows, int N, int n_sets, bool vec, bool bf16) {
    if (vec) return bf16 ? pick_rows<H, true, true>(B, rows, N, n_sets)
                         : pick_rows<H, true, false>(B, rows, N, n_sets);
    return bf16 ? pick_rows<H, false, true>(B, rows, N, n_sets)
                : pick_rows<H, false, false>(B, rows, N, n_sets);
}

template <int H, bool VEC, bool BF16>
int launch(const Args& args, int n_sets, cudaStream_t stream) {
    void (*kernel)(const Args) = BF16 ? edge_chain_bwd_wgmma<H, VEC>
                                      : edge_chain_bwd_mma<H, VEC>;
    static bool configured = false;
    if (!configured) {
        cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
        if (e != cudaSuccess) return (int)e;
        configured = true;
    }
    const size_t smem = smem_bytes<H, VEC, BF16>(args.R, args.N);
    if (smem > (size_t)SMEM_LIMIT) return (int)cudaErrorInvalidValue;
    dim3 grid(args.G, args.B, n_sets);
    kernel<<<grid, THREADS, smem, stream>>>(args);
    return (int)cudaGetLastError();
}

template <int H>
int launch(const Args& args, int n_sets, bool vec, bool bf16,
           cudaStream_t stream) {
    if (vec) return bf16 ? launch<H, true, true>(args, n_sets, stream)
                         : launch<H, true, false>(args, n_sets, stream);
    return bf16 ? launch<H, false, true>(args, n_sets, stream)
                : launch<H, false, false>(args, n_sets, stream);
}

}  // namespace

extern "C" {

// The launch layout of a backward at these sizes (vec: edge_vector_reduce,
// else gcl_messages with n_sets 1; bf16: the bf16 backward,
// edge_chain_bwd_wgmma): out[0] rows per block, out[1] blocks per batch
// element and set (G), out[2] floats per block's partial record (P).  The
// wrapper allocates n_sets * B * G * P floats.  Returns 0, or
// cudaErrorInvalidValue for sizes the kernels do not take.
int egnn_bwd_layout(int B, int N, int H, int n_rows, int n_sets, int vec,
                    int bf16, int* out) {
    const int rows = n_rows < N ? n_rows : N;
    if (B <= 0 || N <= 0 || N > 0xffff || rows <= 0
        || (H != 128 && H != 192 && H != 256)
        || (n_sets != 1 && (n_sets != 2 || !vec)))
        return (int)cudaErrorInvalidValue;
    const int R =
        H == 128   ? pick_rows<128>(B, rows, N, n_sets, vec, bf16)
        : H == 192 ? pick_rows<192>(B, rows, N, n_sets, vec, bf16)
                   : pick_rows<256>(B, rows, N, n_sets, vec, bf16);
    if (R <= 0) return (int)cudaErrorInvalidValue;
    out[0] = R;
    out[1] = (rows + R - 1) / R;
    out[2] = layout(H, N).size;
    return 0;
}

// set0 / set1: a, b, we, w2, w2t, b2, wvec, da, dd2c, dd2i (dd2c and dd2i
// may be null: not written; w2 and w2t are pack_w2 of W2 and of W2^T, in
// bf16 w2 is pack_w2_bf16 of W2 and w2t is not read); shared: gout, d2c, d2i, adj, x,
// center, batt, part; ints: B, N, H, n_rows, n_sets, vec, flag (attention
// or tanh), cross of set 0 (set 1 is the cross direction), bf16; floats:
// coords_range, norm_constant, norm_factor.
// Writes da rows < n_rows, the dd2c / dd2i entries with adj != 0 and every
// block's partial record.
int egnn_bwd_edges(void* const* set0, void* const* set1, void* const* shared,
                   const int* ia, const float* fa, void* stream) {
    int lay[3];
    int err = egnn_bwd_layout(ia[0], ia[1], ia[2], ia[3], ia[4], ia[5],
                              ia[8], lay);
    if (err) return err;
    Args p{};
    void* const* sets[2] = {set0, set1};
    for (int s = 0; s < ia[4]; ++s) {
        void* const* q = sets[s];
        p.s[s] = Set{(const float*)q[0], (const float*)q[1],
                     (const float*)q[2], (const float*)q[3],
                     (const float*)q[4], (const float*)q[5],
                     (const float*)q[6], (float*)q[7], (float*)q[8],
                     (float*)q[9], s == 0 ? ia[7] : 1};
    }
    p.gout = (const float*)shared[0];
    p.d2c = (const float*)shared[1];
    p.d2i = (const float*)shared[2];
    p.adj = (const float*)shared[3];
    p.x = (const float*)shared[4];
    p.center = (const float*)shared[5];
    p.batt = (const float*)shared[6];
    p.part = (float*)shared[7];
    p.B = ia[0]; p.N = ia[1]; p.n_rows = ia[3];
    p.R = lay[0]; p.G = lay[1]; p.P = lay[2];
    p.flag_a = ia[6];
    p.coords_range = fa[0]; p.norm_constant = fa[1]; p.norm_factor = fa[2];
    const int n_sets = ia[4];
    cudaStream_t st = (cudaStream_t)stream;
    const bool vec = ia[5], bf16 = ia[8];
    switch (ia[2]) {
        case 128: return launch<128>(p, n_sets, vec, bf16, st);
        case 192: return launch<192>(p, n_sets, vec, bf16, st);
        case 256: return launch<256>(p, n_sets, vec, bf16, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

// set0 / set1: dw2, db, db2, dwe, dwvec; shared: part, dx, dcenter, dbatt,
// dd2c planes, dd2i planes (null where not wanted; the planes are summed
// only for two sets); ints: B, N, H, n_rows, n_sets, vec, (unread: flag,
// cross), bf16 (dw2 and dwvec rounded to bf16).
int egnn_bwd_reduce(void* const* set0, void* const* set1, void* const* shared,
                    const int* ia, void* stream) {
    int lay[3];
    int err = egnn_bwd_layout(ia[0], ia[1], ia[2], ia[3], ia[4], ia[5],
                              ia[8], lay);
    if (err) return err;
    RedArgs p{};
    void* const* sets[2] = {set0, set1};
    for (int s = 0; s < ia[4]; ++s) {
        void* const* q = sets[s];
        p.s[s] = RedSet{(float*)q[0], (float*)q[1], (float*)q[2],
                        (float*)q[3], (float*)q[4]};
    }
    p.part = (const float*)shared[0];
    p.dx = (float*)shared[1];
    p.dctr = (float*)shared[2];
    p.dbatt = (float*)shared[3];
    p.dd2c = (float*)shared[4];
    p.dd2i = (float*)shared[5];
    p.B = ia[0]; p.N = ia[1]; p.H = ia[2]; p.G = lay[1]; p.P = lay[2];
    p.n_sets = ia[4]; p.vec = ia[5]; p.bf16 = ia[8];
    const int blocks = 4 * sm_count();
    edge_chain_bwd_reduce<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(p);
    return (int)cudaGetLastError();
}

}  // extern "C"
