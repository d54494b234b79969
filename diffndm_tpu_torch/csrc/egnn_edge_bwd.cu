// Backward of the EGNN edge-chain kernels for NVIDIA Hopper (sm_90a), fp32.
//
// The JAX package's Pallas kernels (diffndm_tpu/ops/pallas_egnn.py:
// gcl_messages, edge_vector_reduce) have no VJP; its trainer takes the
// gradient by XLA autodiff of the dense path (diffndm_tpu/models/egnn.py).
// These kernels compute that gradient for the port's forward kernels
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
// The design (simple and exact first; the tensor cores are later work):
//   * Two launches per backward.  egnn_bwd_edges: a block owns R rows of
//     one batch element (every G-th row, as the forward deals them) and
//     one weight set (blockIdx.z for the pair).  It gathers the (row,
//     column) pairs of its rows with adj != 0 into a list in shared
//     memory, sorted by column and then row, and walks it in tiles of TE
//     edges.  Per tile: s into shared memory; u = s @ W2 on the CUDA cores
//     in fp32 (a warp owns TE/8 edges, a lane H/32 columns; W2 rows read
//     through L1); the epilogue on registers with warp sums for the dots;
//     du into shared memory; s^T du added to the block's own dW2 partial;
//     du @ W2^T (W2^T handed over by the wrapper, so the loads stay
//     coalesced); dz; then the row sums (da, shared memory) and the
//     column sums (db: one read-modify-write of the block's partial per
//     run of equal columns, the runs of a tile having distinct columns).
//   * No atomics.  Every sum that crosses blocks (dW2, db, the small
//     weight vectors, dx, dcenter, the pair's two dd2c planes) goes to the
//     block's own partial record and egnn_bwd_reduce adds the records in a
//     fixed order: repeat launches give the same bits.
//   * fp32 FMAs throughout (no TF32): the gradients keep fp32 accuracy.
// Left for later: the three products on the tensor cores (the forward's
// TF32x3 mma.sync tiles, or wgmma), W2 staged in shared memory, and fewer
// partial bytes for small graphs.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int NW = 8;                // warps per block
constexpr int THREADS = 32 * NW;
constexpr int R_MAX = 16;            // most rows a block owns
constexpr int LIST_MAX = 8192;       // most (row, column) pairs a block lists
constexpr int SMEM_LIMIT = 232448;   // bytes a block may use on sm_90
constexpr unsigned FULL = 0xffffffffu;

template <int H>
struct Cfg {
    static constexpr int TE = H <= 192 ? 64 : 32;   // edges per tile
    static constexpr int EPW = TE / NW;             // edges per warp
    static constexpr int NJ = H / 32;               // columns per lane
    static constexpr int KG = 8;                    // dW2 rows per group
};

struct Set {
    const float* a;       // [B, N, H]
    const float* b;       // [B, N, H]
    const float* we;      // [2, H]
    const float* w2;      // [H, H] (k, n)
    const float* w2t;     // [H, H] (n, k)
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

__device__ __forceinline__ float silu(float v) { return v * sigm(v); }

__device__ __forceinline__ float dsilu(float v) {
    const float s = sigm(v);
    return s * (1.f + v * (1.f - s));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
    return v;
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

template <int H, bool VEC>
constexpr int fixed_floats() {
    using C = Cfg<H>;
    return 2 * C::TE * H              // s (then dz), du (then run sums)
           + 2 * R_MAX * H            // a rows, da rows
           + R_MAX * (VEC ? 4 : H)    // output gradient rows
           + C::TE * 9                // adj, d2c, d2i, direction gradients
           + 2 * C::TE                // local row, column (ints)
           + C::TE;                   // column of each run (ints)
}

template <int H, bool VEC>
size_t smem_bytes(int R, int N) {
    return 4 * ((size_t)fixed_floats<H, VEC>() + (VEC ? 3 * (size_t)N : 0)
                + (size_t)R * N);
}

// VEC = false: gcl_messages; VEC = true: edge_vector_reduce (one or two
// weight sets, blockIdx.z)
template <int H, bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
edge_chain_bwd(const Args p) {
    using C = Cfg<H>;
    constexpr int TE = C::TE, EPW = C::EPW, NJ = C::NJ, KG = C::KG;
    constexpr int GW = VEC ? 4 : H;
    extern __shared__ __align__(16) float smem[];
    float* sS = smem;
    float* sDU = sS + TE * H;
    float* sA = sDU + TE * H;
    float* sDA = sA + R_MAX * H;
    float* sG = sDA + R_MAX * H;
    float* eAdj = sG + R_MAX * GW;
    float* eDc = eAdj + TE;
    float* eDi = eDc + TE;
    float* eEG = eDi + TE;                                 // TE x 6
    int* eLR = reinterpret_cast<int*>(eEG + TE * 6);
    int* eCol = eLR + TE;
    int* runCol = eCol + TE;
    float* sX = reinterpret_cast<float*>(runCol + TE);     // N x 3 (vec)
    int* elist = reinterpret_cast<int*>(sX + (VEC ? 3 * p.N : 0));

    const int N = p.N, G = p.G;
    const int bi = blockIdx.y, z = blockIdx.z;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int row_limit = p.n_rows < N ? p.n_rows : N;
    const int nrow = (row_limit - (int)blockIdx.x + G - 1) / G;   // <= R
    auto grow = [&](int lr) { return (int)blockIdx.x + lr * G; };
    const Set ws = z ? p.s[1] : p.s[0];
    const Layout L = layout(H, N);
    float* part = p.part + ((size_t)(z * p.B + bi) * G + blockIdx.x) * p.P;
    const float inv_nf = 1.f / p.norm_factor;

    // the partial sums this block adds to in place start at zero
    for (int i = tid; i < L.vec; i += THREADS) part[i] = 0.f;
    for (int i = tid; i < nrow * H; i += THREADS) {
        const size_t o = ((size_t)bi * N + grow(i / H)) * H + i % H;
        sA[i] = ws.a[o];
        sDA[i] = 0.f;
        if (!VEC) sG[i] = p.gout[o];
    }
    if (VEC) {
        for (int i = tid; i < nrow * 3; i += THREADS)
            sG[(i / 3) * 4 + i % 3] =
                p.gout[((size_t)bi * N + grow(i / 3)) * 3 + i % 3];
        for (int i = tid; i < 3 * N; i += THREADS) sX[i] = 0.f;
    }

    // ---- the block's edges, by column and then row ----
    const float* adj_b = p.adj + (size_t)bi * N * N;
    int* cnt = reinterpret_cast<int*>(sS);      // N + 1 counts, then sums
    int* tsum = cnt + N + 1;
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
    {
        int s = 0;
        for (int j = j0; j < j1; ++j) s += cnt[j];
        tsum[tid] = s;
    }
    __syncthreads();
    if (tid == 0) {
        int run = 0;
        for (int t = 0; t < THREADS; ++t) {
            const int v = tsum[t];
            tsum[t] = run;
            run += v;
        }
        cnt[N] = run;
    }
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

    // per-thread sums over the block's edges, columns n = lane + 32 j
    float acc_b2[NJ], acc_wv[NJ], acc_we0[NJ], acc_we1[NJ];
    float rb2[NJ], rwv[NJ], rwe0[NJ], rwe1[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
        const int n = lane + 32 * j;
        acc_b2[j] = acc_wv[j] = acc_we0[j] = acc_we1[j] = 0.f;
        rb2[j] = ws.b2[n];
        rwv[j] = ws.wvec[n];
        rwe0[j] = ws.we[n];
        rwe1[j] = ws.we[H + n];
    }
    float acc_batt = 0.f;
    float dctr = 0.f;                 // threads 0..2: dcenter (cross)
    const float batt = (!VEC && p.flag_a) ? p.batt[0] : 0.f;
    const float* ctr = VEC ? p.center + (size_t)bi * 3 : nullptr;
    const float* b_b = ws.b + (size_t)bi * N * H;

    for (int t0 = 0; t0 < n_edges; t0 += TE) {
        const int tn = n_edges - t0 < TE ? n_edges - t0 : TE;
        // (1) the tile's edges; an entry past the list is (row 0, column
        // 0) with adj 0, so every gradient it gives is 0
        if (tid < TE) {
            const bool v = tid < tn;
            const int pk = v ? elist[t0 + tid] : 0;
            const int lr = pk >> 16, col = pk & 0xffff;
            const size_t o = ((size_t)bi * N + grow(lr)) * N + col;
            eLR[tid] = lr;
            eCol[tid] = col;
            eAdj[tid] = v ? p.adj[o] : 0.f;
            eDc[tid] = v ? p.d2c[o] : 0.f;
            eDi[tid] = v ? p.d2i[o] : 0.f;
        }
        __syncthreads();
        // (2) s = silu(u1)
        for (int i = tid; i < TE * H; i += THREADS) {
            const int e = i / H, k = i % H;
            const float u1 = fmaf(eDi[e], __ldg(ws.we + H + k),
                                  fmaf(eDc[e], __ldg(ws.we + k),
                                       sA[eLR[e] * H + k]
                                       + __ldg(b_b + (size_t)eCol[e] * H + k)));
            sS[i] = silu(u1);
        }
        __syncthreads();
        // (3) u = s @ W2: warp's EPW edges x lane's NJ columns
        float acc[EPW][NJ];
#pragma unroll
        for (int e = 0; e < EPW; ++e)
#pragma unroll
            for (int j = 0; j < NJ; ++j) acc[e][j] = 0.f;
        {
            const float* sw = sS + warp * EPW * H;
#pragma unroll 2
            for (int k = 0; k < H; ++k) {
                float w[NJ];
#pragma unroll
                for (int j = 0; j < NJ; ++j)
                    w[j] = __ldg(ws.w2 + (size_t)k * H + lane + 32 * j);
#pragma unroll
                for (int e = 0; e < EPW; ++e) {
                    const float s = sw[e * H + k];
#pragma unroll
                    for (int j = 0; j < NJ; ++j)
                        acc[e][j] = fmaf(s, w[j], acc[e][j]);
                }
            }
        }
        // (4) epilogue: du = dm * silu'(u)
#pragma unroll
        for (int e = 0; e < EPW; ++e) {
            const int el = warp * EPW + e;
            const int lr = eLR[el];
            const float av = eAdj[el] * inv_nf;
            float u[NJ], m[NJ], dm[NJ];
            float dot = 0.f;
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
                u[j] = acc[e][j] + rb2[j];
                m[j] = silu(u[j]);
                dot = fmaf(m[j], rwv[j], dot);
            }
            if (VEC || p.flag_a) dot = warp_sum(dot);
            if (!VEC) {
                float g[NJ];
                float gm = 0.f;
#pragma unroll
                for (int j = 0; j < NJ; ++j) {
                    g[j] = sG[lr * H + lane + 32 * j] * av;
                    gm = fmaf(g[j], m[j], gm);
                }
                if (p.flag_a) {
                    gm = warp_sum(gm);
                    const float gate = sigm(dot + batt);
                    const float datt = gm * gate * (1.f - gate);
#pragma unroll
                    for (int j = 0; j < NJ; ++j) {
                        dm[j] = fmaf(g[j], gate, datt * rwv[j]);
                        acc_wv[j] = fmaf(datt, m[j], acc_wv[j]);
                    }
                    acc_batt += datt;
                } else {
#pragma unroll
                    for (int j = 0; j < NJ; ++j) dm[j] = g[j];
                }
            } else {
                const int col = eCol[el];
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
                const float dpr = p.flag_a
                                      ? dphi * p.coords_range * (1.f - th * th)
                                      : dphi;
#pragma unroll
                for (int j = 0; j < NJ; ++j) {
                    dm[j] = dpr * rwv[j];
                    acc_wv[j] = fmaf(dpr, m[j], acc_wv[j]);
                }
                if (lane == 0) {
                    eEG[el * 6 + 0] = gp[0];
                    eEG[el * 6 + 1] = gp[1];
                    eEG[el * 6 + 2] = gp[2];
                    eEG[el * 6 + 3] = gq[0];
                    eEG[el * 6 + 4] = gq[1];
                    eEG[el * 6 + 5] = gq[2];
                }
            }
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
                const float du = dm[j] * dsilu(u[j]);
                sDU[el * H + lane + 32 * j] = du;
                acc_b2[j] += du;
            }
        }
        __syncthreads();
        // (5) the block's dW2 partial += s^T du: a warp owns H/8 rows of
        // dW2, KG at a time, a lane NJ columns
        {
            constexpr int KW = H / NW;
#pragma unroll 1
            for (int g0 = 0; g0 < KW; g0 += KG) {
                const int k0 = warp * KW + g0;
                float a2[KG][NJ];
#pragma unroll
                for (int kk = 0; kk < KG; ++kk)
#pragma unroll
                    for (int j = 0; j < NJ; ++j) a2[kk][j] = 0.f;
                for (int e = 0; e < tn; ++e) {
                    const float4 s0 = *reinterpret_cast<const float4*>(
                        sS + e * H + k0);
                    const float4 s1 = *reinterpret_cast<const float4*>(
                        sS + e * H + k0 + 4);
                    const float sv[KG] = {s0.x, s0.y, s0.z, s0.w,
                                          s1.x, s1.y, s1.z, s1.w};
                    float dv[NJ];
#pragma unroll
                    for (int j = 0; j < NJ; ++j) dv[j] = sDU[e * H + lane + 32 * j];
#pragma unroll
                    for (int kk = 0; kk < KG; ++kk)
#pragma unroll
                        for (int j = 0; j < NJ; ++j)
                            a2[kk][j] = fmaf(sv[kk], dv[j], a2[kk][j]);
                }
                float* pw = part + L.w2 + (size_t)k0 * H + lane;
                float old[KG][NJ];
#pragma unroll
                for (int kk = 0; kk < KG; ++kk)
#pragma unroll
                    for (int j = 0; j < NJ; ++j) old[kk][j] = pw[kk * H + 32 * j];
#pragma unroll
                for (int kk = 0; kk < KG; ++kk)
#pragma unroll
                    for (int j = 0; j < NJ; ++j)
                        pw[kk * H + 32 * j] = old[kk][j] + a2[kk][j];
            }
        }
        // (6) ds = du @ W2^T, then dz = ds * silu'(u1): lane's NJ k
        {
            const float* sd = sDU + warp * EPW * H;
#pragma unroll
            for (int e = 0; e < EPW; ++e)
#pragma unroll
                for (int j = 0; j < NJ; ++j) acc[e][j] = 0.f;
#pragma unroll 2
            for (int n = 0; n < H; ++n) {
                float w[NJ];
#pragma unroll
                for (int j = 0; j < NJ; ++j)
                    w[j] = __ldg(ws.w2t + (size_t)n * H + lane + 32 * j);
#pragma unroll
                for (int e = 0; e < EPW; ++e) {
                    const float d = sd[e * H + n];
#pragma unroll
                    for (int j = 0; j < NJ; ++j)
                        acc[e][j] = fmaf(d, w[j], acc[e][j]);
                }
            }
        }
#pragma unroll
        for (int e = 0; e < EPW; ++e) {
            const int el = warp * EPW + e;
            const int lr = eLR[el], col = eCol[el];
            const float dc = eDc[el], di = eDi[el];
            float dd0 = 0.f, dd1 = 0.f;
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
                const int k = lane + 32 * j;
                const float u1 = fmaf(di, rwe1[j], fmaf(dc, rwe0[j],
                    sA[lr * H + k] + __ldg(b_b + (size_t)col * H + k)));
                const float dz = acc[e][j] * dsilu(u1);
                acc[e][j] = dz;
                acc_we0[j] = fmaf(dz, dc, acc_we0[j]);
                acc_we1[j] = fmaf(dz, di, acc_we1[j]);
                dd0 = fmaf(dz, rwe0[j], dd0);
                dd1 = fmaf(dz, rwe1[j], dd1);
            }
            if (ws.dd2c || ws.dd2i) {
                dd0 = warp_sum(dd0);
                dd1 = warp_sum(dd1);
                if (lane == 0 && el < tn) {
                    const size_t o = ((size_t)bi * N + grow(lr)) * N + col;
                    if (ws.dd2c) ws.dd2c[o] = dd0;
                    if (ws.dd2i) ws.dd2i[o] = dd1;
                }
            }
        }
        __syncthreads();              // every warp is done with s and du
#pragma unroll
        for (int e = 0; e < EPW; ++e)
#pragma unroll
            for (int j = 0; j < NJ; ++j)
                sS[(warp * EPW + e) * H + lane + 32 * j] = acc[e][j];
        __syncthreads();
        // (7) row sums into da, column runs into du's buffer
        int n_runs = 0;
        for (int k = tid; k < H; k += THREADS) {
            float run = 0.f;
            n_runs = 0;
            for (int e = 0; e < tn; ++e) {
                const float v = sS[e * H + k];
                sDA[eLR[e] * H + k] += v;
                run += v;
                if (e == tn - 1 || eCol[e + 1] != eCol[e]) {
                    sDU[n_runs * H + k] = run;
                    if (k == 0) runCol[n_runs] = eCol[e];
                    ++n_runs;
                    run = 0.f;
                }
            }
        }
        if (VEC && tid < 3) {
            for (int e = 0; e < tn; ++e) {
                const float gp = eEG[e * 6 + tid], gq = eEG[e * 6 + 3 + tid];
                sX[grow(eLR[e]) * 3 + tid] += gp;
                sX[eCol[e] * 3 + tid] += gq;
                if (ws.cross) dctr -= gp + gq;
            }
        }
        __syncthreads();
        // the runs of a tile have distinct columns: their read-modify-
        // writes of the db partial are independent, four at a time
        for (int k = tid; k < H; k += THREADS) {
            float* pb = part + L.b + k;
            int r = 0;
            for (; r + 4 <= n_runs; r += 4) {
                float o[4];
#pragma unroll
                for (int q = 0; q < 4; ++q) o[q] = pb[(size_t)runCol[r + q] * H];
#pragma unroll
                for (int q = 0; q < 4; ++q)
                    pb[(size_t)runCol[r + q] * H] = o[q] + sDU[(r + q) * H + k];
            }
            for (; r < n_runs; ++r)
                pb[(size_t)runCol[r] * H] += sDU[r * H + k];
        }
        __syncthreads();
    }

    // ---- write what the block owns, and its partial record ----
    for (int i = tid; i < nrow * H; i += THREADS)
        ws.da[((size_t)bi * N + grow(i / H)) * H + i % H] = sDA[i];
    float* red = sS;                  // [NW][4][H], then [NW]
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
        const int n = lane + 32 * j;
        red[(warp * 4 + 0) * H + n] = acc_b2[j];
        red[(warp * 4 + 1) * H + n] = acc_we0[j];
        red[(warp * 4 + 2) * H + n] = acc_we1[j];
        red[(warp * 4 + 3) * H + n] = acc_wv[j];
    }
    if (lane == 0) red[NW * 4 * H + warp] = acc_batt;
    __syncthreads();
    for (int i = tid; i < 4 * H; i += THREADS) {
        float s = 0.f;
        for (int w = 0; w < NW; ++w) s += red[(w * 4 + i / H) * H + i % H];
        part[L.vec + i] = s;
    }
    if (tid == 0) {
        float s = 0.f;
        for (int w = 0; w < NW; ++w) s += red[NW * 4 * H + w];
        part[L.vec + 4 * H] = s;
    }
    if (VEC) {
        for (int i = tid; i < 3 * N; i += THREADS) part[L.x + i] = sX[i];
        if (tid < 3) part[L.c + tid] = dctr;
    }
}

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
                float s = 0.f;
                for (int bi = 0; bi < B; ++bi)
                    for (int x = 0; x < G; ++x) s += rec(z, bi, x)[L.w2 + i];
                o.dw2[i] = s;
            } else if (i < n_w2 + n_b) {
                i -= n_w2;
                const int bi = (int)(i / ((long)N * H));
                const long jk = i % ((long)N * H);
                float s = 0.f;
                for (int x = 0; x < G; ++x) s += rec(z, bi, x)[L.b + jk];
                o.db[i] = s;
            } else {
                i -= n_w2 + n_b;
                float s = 0.f;
                for (int bi = 0; bi < B; ++bi)
                    for (int x = 0; x < G; ++x) s += rec(z, bi, x)[L.vec + i];
                if (i < H) o.db2[i] = s;
                else if (i < 3 * H) o.dwe[i - H] = s;
                else o.dwvec[i - 3 * H] = s;
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

// rows per block: about one block per SM, fewer rows where the block's
// list of R * N candidate pairs would exceed LIST_MAX
int pick_rows(int B, int rows, int N, int n_sets) {
    const long total = (long)B * rows * n_sets;
    long R = (total + sm_count() - 1) / sm_count();
    if (R > R_MAX) R = R_MAX;
    if (R > rows) R = rows;
    if (R > LIST_MAX / N) R = LIST_MAX / N;
    if (R < 1) R = 1;
    return (int)R;
}

template <int H, bool VEC>
int launch_t(Args& args, int n_sets, cudaStream_t stream) {
    static bool configured = false;
    if (!configured) {
        cudaError_t e = cudaFuncSetAttribute(
            edge_chain_bwd<H, VEC>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
        if (e != cudaSuccess) return (int)e;
        configured = true;
    }
    const size_t smem = smem_bytes<H, VEC>(args.R, args.N);
    if (smem > (size_t)SMEM_LIMIT) return (int)cudaErrorInvalidValue;
    dim3 grid(args.G, args.B, n_sets);
    edge_chain_bwd<H, VEC><<<grid, THREADS, smem, stream>>>(args);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The launch layout of a backward at these sizes: out[0] rows per block,
// out[1] blocks per batch element and set (G), out[2] floats per block's
// partial record (P).  The wrapper allocates n_sets * B * G * P floats.
// Returns 0, or cudaErrorInvalidValue for sizes the kernels do not take.
int egnn_bwd_layout(int B, int N, int H, int n_rows, int n_sets, int* out) {
    const int rows = n_rows < N ? n_rows : N;
    if (B <= 0 || N <= 0 || N > LIST_MAX || N > 0xffff || rows <= 0
        || (H != 128 && H != 192 && H != 256))
        return (int)cudaErrorInvalidValue;
    const int R = pick_rows(B, rows, N, n_sets);
    out[0] = R;
    out[1] = (rows + R - 1) / R;
    out[2] = layout(H, N).size;
    return 0;
}

// set0 / set1: a, b, we, w2, w2t, b2, wvec, da, dd2c, dd2i (dd2c and dd2i
// may be null: not written); shared: gout, d2c, d2i, adj, x, center, batt,
// part; ints: B, N, H, n_rows, n_sets, vec, flag (attention or tanh),
// cross of set 0 (set 1 is the cross direction); floats: coords_range,
// norm_constant, norm_factor.  Writes da rows < n_rows, the dd2c / dd2i
// entries with adj != 0 and every block's partial record.
int egnn_bwd_edges(void* const* set0, void* const* set1, void* const* shared,
                   const int* ia, const float* fa, void* stream) {
    int lay[3];
    int err = egnn_bwd_layout(ia[0], ia[1], ia[2], ia[3], ia[4], lay);
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
    switch (ia[5] ? -ia[2] : ia[2]) {
        case 128: return launch_t<128, false>(p, n_sets, st);
        case 192: return launch_t<192, false>(p, n_sets, st);
        case 256: return launch_t<256, false>(p, n_sets, st);
        case -128: return launch_t<128, true>(p, n_sets, st);
        case -192: return launch_t<192, true>(p, n_sets, st);
        case -256: return launch_t<256, true>(p, n_sets, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

// set0 / set1: dw2, db, db2, dwe, dwvec; shared: part, dx, dcenter, dbatt,
// dd2c planes, dd2i planes (null where not wanted; the planes are summed
// only for two sets); ints: B, N, H, n_rows, n_sets, vec.
int egnn_bwd_reduce(void* const* set0, void* const* set1, void* const* shared,
                    const int* ia, void* stream) {
    int lay[3];
    int err = egnn_bwd_layout(ia[0], ia[1], ia[2], ia[3], ia[4], lay);
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
    p.n_sets = ia[4]; p.vec = ia[5];
    const int blocks = 4 * sm_count();
    edge_chain_bwd_reduce<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(p);
    return (int)cudaGetLastError();
}

}  // extern "C"
