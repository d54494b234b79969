// EGNN edge-chain kernels for NVIDIA Hopper (sm_90a), fp32.
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
//       only rows < n_rows are computed; the rest are written as zero.
//
// What bounds them on this card: operations.  Per edge the chain costs
// about 2*H^2 fp32 FLOPs for the product by W2 (73.7 kFLOP at H=192)
// against a few bytes of edge input (d2c, d2i, adj) and O(N*H) node
// input, so the kernels sit far above the fp32 ridge point of the card
// (67 TFLOP/s over 3.35 TB/s = 20 FLOP/byte) and the [B, N, N, H] edge
// tensor never needs to exist in device memory.
//
// What this simple design does about it:
//   * one block per (batch, tile of 4 rows); a loop over tiles of 16
//     columns inside the block takes the place of the sequential Pallas
//     column grid, so each output row is reduced in registers and written
//     once -- no atomics;
//   * each 64-edge tile of z lives in shared memory; W2 is streamed
//     through shared memory in 32-row chunks (W2 alone is 144 KB at
//     H=192 and 256 KB at H=256, over what a block may hold);
//   * 256 threads as 16 edge groups x 16 column lanes; each thread keeps
//     a 4-edge x (H/16)-column register tile of the product, so every
//     shared-memory load feeds several FMAs;
//   * the attention / phi dot products reduce over the 16 column lanes
//     with warp shuffles;
//   * a column tile whose 64 adjacency entries are all zero contributes
//     exactly zero and is skipped, so the work follows the cutoff graph.
// Left for later work: tensor cores (TF32/bf16 wgmma), TMA, fusing the
// coordinate and cross launches, computing d2 inside the kernel, and the
// sorted-band column window for large pockets.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int TR = 4;             // rows per block
constexpr int TC = 16;            // columns per tile
constexpr int TE = TR * TC;       // edges per tile
constexpr int KC = 32;            // W2 rows per shared-memory chunk
constexpr int THREADS = 256;      // 16 edge groups x 16 column lanes
constexpr int EPT = TE / 16;      // edges per thread (4, all in one row)

__device__ __forceinline__ float sigmoid_f(float v) {
    return 1.0f / (1.0f + expf(-v));
}

__device__ __forceinline__ float silu_f(float v) { return v * sigmoid_f(v); }

struct EdgeArgs {
    const float* a;       // [B, N, H]
    const float* b;       // [B, N, H]
    const float* d2c;     // [B, N, N]
    const float* d2i;     // [B, N, N]
    const float* adj;     // [B, N, N]
    const float* we;      // [2, H]
    const float* w2;      // [H, H]
    const float* b2;      // [H]
    const float* wvec;    // [H]: attention weight or phi weight
    const float* batt;    // [1] (gcl)
    const float* x;       // [B, N, 3] (vec)
    const float* center;  // [B, 1, 3] (vec)
    float* out;
    int N;
    int n_rows;           // rows computed (N for gcl)
    int flag_a;           // gcl: attention; vec: tanh
    int cross;            // vec only
    float coords_range;
    float norm_constant;
    float norm_factor;
};

template <int H>
constexpr size_t smem_floats() {
    return (size_t)TE * (H + 4)   // z tile (row stride H + 4)
           + (size_t)KC * H       // W2 chunk
           + (size_t)TR * H       // a rows
           + 4 * (size_t)H        // we0, we1, b2, wvec
           + 3 * (size_t)TE;      // adj, d2c, d2i of the tile
}

// VEC = false: gcl_messages; VEC = true: edge_vector_reduce
template <int CPT, bool VEC>
__global__ void __launch_bounds__(THREADS)
edge_chain_kernel(EdgeArgs p) {
    constexpr int H = 16 * CPT;
    constexpr int ZS = H + 4;
    extern __shared__ __align__(16) float smem[];
    float* zs = smem;
    float* ws = zs + TE * ZS;
    float* as = ws + KC * H;
    float* we0 = as + TR * H;
    float* we1 = we0 + H;
    float* b2s = we1 + H;
    float* wvs = b2s + H;
    float* adjs = wvs + H;
    float* d2cs = adjs + TE;
    float* d2is = d2cs + TE;

    const int N = p.N;
    const int bi = blockIdx.y;
    const int row0 = blockIdx.x * TR;
    const int tid = threadIdx.x;
    const int tx = tid & 15;          // column lane
    const int ty = tid >> 4;          // edge group
    const int row_limit = p.n_rows < N ? p.n_rows : N;

    if (row0 >= row_limit) {          // frozen rows: exact zeros
        if (VEC) {
            for (int i = tid; i < TR * 3; i += THREADS) {
                int row = row0 + i / 3;
                if (row < N) p.out[((size_t)bi * N + row) * 3 + i % 3] = 0.f;
            }
        }
        return;
    }

    for (int i = tid; i < TR * H; i += THREADS) {
        int row = row0 + i / H;
        as[i] = row < row_limit ? p.a[((size_t)bi * N + row) * H + i % H]
                                : 0.f;
    }
    for (int i = tid; i < H; i += THREADS) {
        we0[i] = p.we[i];
        we1[i] = p.we[H + i];
        b2s[i] = p.b2[i];
        wvs[i] = p.wvec[i];
    }
    const float batt = (!VEC && p.flag_a) ? p.batt[0] : 0.f;

    // this thread's edges: ty*EPT .. ty*EPT+3, all in tile row ty / 4
    const int my_lr = (ty * EPT) / TC;
    const int my_row = row0 + my_lr;
    float oacc[VEC ? 1 : CPT];
    float vacc[3] = {0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < (VEC ? 1 : CPT); ++j) oacc[j] = 0.f;
    float xr[3] = {0.f, 0.f, 0.f};
    float ctr[3] = {0.f, 0.f, 0.f};
    if (VEC && my_row < row_limit) {
        for (int c = 0; c < 3; ++c) {
            xr[c] = p.x[((size_t)bi * N + my_row) * 3 + c];
            ctr[c] = p.center[(size_t)bi * 3 + c];
        }
    }

    const int n_ct = (N + TC - 1) / TC;
    for (int ct = 0; ct < n_ct; ++ct) {
        const int col0 = ct * TC;
        __syncthreads();              // previous tile's readers are done
        int nonzero = 0;
        if (tid < TE) {
            int row = row0 + tid / TC;
            int col = col0 + tid % TC;
            float av = 0.f, dc = 0.f, di = 0.f;
            if (row < row_limit && col < N) {
                size_t e = ((size_t)bi * N + row) * N + col;
                av = p.adj[e];
                dc = p.d2c[e];
                di = p.d2i[e];
            }
            adjs[tid] = av;
            d2cs[tid] = dc;
            d2is[tid] = di;
            nonzero = av != 0.f;
        }
        if (!__syncthreads_or(nonzero)) continue;   // uniform per block

        // z tile: silu(a_i + b_j + d2c*we0 + d2i*we1); zero where adj = 0
        for (int i = tid; i < TE * H; i += THREADS) {
            int e = i / H;
            int k = i - e * H;
            float z = 0.f;
            if (adjs[e] != 0.f) {
                int col = col0 + e % TC;
                z = as[(e / TC) * H + k] + p.b[((size_t)bi * N + col) * H + k]
                    + d2cs[e] * we0[k] + d2is[e] * we1[k];
                z = silu_f(z);
            }
            zs[e * ZS + k] = z;
        }

        // acc = z @ W2 for this thread's 4 edges x CPT columns
        float acc[EPT][CPT];
#pragma unroll
        for (int r = 0; r < EPT; ++r)
#pragma unroll
            for (int j = 0; j < CPT; ++j) acc[r][j] = 0.f;

        for (int k0 = 0; k0 < H; k0 += KC) {
            __syncthreads();          // z written / previous chunk consumed
            const float4* src = reinterpret_cast<const float4*>(p.w2 + (size_t)k0 * H);
            float4* dst = reinterpret_cast<float4*>(ws);
            for (int i = tid; i < KC * H / 4; i += THREADS) dst[i] = src[i];
            __syncthreads();
#pragma unroll 4
            for (int kk = 0; kk < KC; ++kk) {
                float zr[EPT];
#pragma unroll
                for (int r = 0; r < EPT; ++r)
                    zr[r] = zs[(ty * EPT + r) * ZS + k0 + kk];
#pragma unroll
                for (int j = 0; j < CPT; ++j) {
                    float w = ws[kk * H + tx + 16 * j];
#pragma unroll
                    for (int r = 0; r < EPT; ++r)
                        acc[r][j] = fmaf(zr[r], w, acc[r][j]);
                }
            }
        }

        // epilogue: m = silu(acc + b2), then the per-edge dot with wvec
        float dot[EPT];
#pragma unroll
        for (int r = 0; r < EPT; ++r) {
            dot[r] = 0.f;
#pragma unroll
            for (int j = 0; j < CPT; ++j) {
                int c = tx + 16 * j;
                acc[r][j] = silu_f(acc[r][j] + b2s[c]);
                dot[r] = fmaf(acc[r][j], wvs[c], dot[r]);
            }
        }
        if (VEC || p.flag_a) {
#pragma unroll
            for (int r = 0; r < EPT; ++r)
#pragma unroll
                for (int off = 8; off > 0; off >>= 1)
                    dot[r] += __shfl_xor_sync(0xffffffffu, dot[r], off);
        }

        if (!VEC) {
#pragma unroll
            for (int r = 0; r < EPT; ++r) {
                float g = p.flag_a ? sigmoid_f(dot[r] + batt) : 1.f;
                float av = adjs[ty * EPT + r];
#pragma unroll
                for (int j = 0; j < CPT; ++j)
                    oacc[j] += (acc[r][j] * g) * av;
            }
        } else {
#pragma unroll
            for (int r = 0; r < EPT; ++r) {
                int e = ty * EPT + r;
                float av = adjs[e];
                if (av == 0.f) continue;
                float phi = p.flag_a ? tanhf(dot[r]) * p.coords_range : dot[r];
                float w = phi * av;
                int col = col0 + e % TC;
                const float* xc = p.x + ((size_t)bi * N + col) * 3;
                float v0, v1, v2, inv;
                if (p.cross) {
                    float a0 = xr[0] - ctr[0], a1 = xr[1] - ctr[1], a2 = xr[2] - ctr[2];
                    float c0 = xc[0] - ctr[0], c1 = xc[1] - ctr[1], c2 = xc[2] - ctr[2];
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
                vacc[0] += v0 * inv;
                vacc[1] += v1 * inv;
                vacc[2] += v2 * inv;
            }
        }
    }

    // reduce the 4 edge groups of each row through shared memory
    __syncthreads();
    float* red = zs;
    if (!VEC) {
#pragma unroll
        for (int j = 0; j < CPT; ++j) red[ty * H + tx + 16 * j] = oacc[j];
        __syncthreads();
        for (int i = tid; i < TR * H; i += THREADS) {
            int lr = i / H;
            int c = i - lr * H;
            int row = row0 + lr;
            if (row >= N) continue;
            const int g0 = lr * (TC / EPT);
            float s = 0.f;
#pragma unroll
            for (int g = 0; g < TC / EPT; ++g) s += red[(g0 + g) * H + c];
            p.out[((size_t)bi * N + row) * H + c] = s / p.norm_factor;
        }
    } else {
        if (tx == 0)
            for (int c = 0; c < 3; ++c) red[ty * 3 + c] = vacc[c];
        __syncthreads();
        if (tid < TR * 3) {
            int lr = tid / 3;
            int c = tid - lr * 3;
            int row = row0 + lr;
            if (row < N) {
                const int g0 = lr * (TC / EPT);
                float s = 0.f;
                for (int g = 0; g < TC / EPT; ++g) s += red[(g0 + g) * 3 + c];
                p.out[((size_t)bi * N + row) * 3 + c] =
                    row < row_limit ? s / p.norm_factor : 0.f;
            }
        }
    }
}

template <int CPT, bool VEC>
int launch_t(const EdgeArgs& args, int B, cudaStream_t stream) {
    constexpr int H = 16 * CPT;
    const size_t smem = smem_floats<H>() * sizeof(float);
    static bool configured = false;
    if (!configured) {
        cudaError_t e = cudaFuncSetAttribute(
            edge_chain_kernel<CPT, VEC>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
        configured = true;
    }
    dim3 grid((args.N + TR - 1) / TR, B);
    edge_chain_kernel<CPT, VEC><<<grid, THREADS, smem, stream>>>(args);
    return (int)cudaGetLastError();
}

template <bool VEC>
int launch(const EdgeArgs& args, int B, int H, cudaStream_t stream) {
    if (B <= 0 || args.N <= 0) return 0;
    switch (H) {
        case 128: return launch_t<8, VEC>(args, B, stream);
        case 192: return launch_t<12, VEC>(args, B, stream);
        case 256: return launch_t<16, VEC>(args, B, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

extern "C" {

// Returns the CUDA error code of the launch (0 on success).
int egnn_gcl_messages(const float* a, const float* b, const float* d2c,
                      const float* d2i, const float* adj, const float* we,
                      const float* w2, const float* b2, const float* watt,
                      const float* batt, float* out, int B, int N, int H,
                      int attention, float norm_factor, void* stream) {
    EdgeArgs p{};
    p.a = a; p.b = b; p.d2c = d2c; p.d2i = d2i; p.adj = adj; p.we = we;
    p.w2 = w2; p.b2 = b2; p.wvec = watt; p.batt = batt; p.out = out;
    p.N = N; p.n_rows = N; p.flag_a = attention;
    p.norm_factor = norm_factor;
    return launch<false>(p, B, H, (cudaStream_t)stream);
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
    p.a = a; p.b = b; p.d2c = d2c; p.d2i = d2i; p.adj = adj; p.we = we;
    p.w2 = w2; p.b2 = b2; p.wvec = wout; p.x = x; p.center = center;
    p.out = out; p.N = N; p.n_rows = n_rows; p.flag_a = tanh_;
    p.cross = cross; p.coords_range = coords_range;
    p.norm_constant = norm_constant; p.norm_factor = norm_factor;
    return launch<true>(p, B, H, (cudaStream_t)stream);
}

}  // extern "C"
