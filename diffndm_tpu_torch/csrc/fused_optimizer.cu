// The trainer's optimizer span as multi-tensor kernels for NVIDIA Hopper
// (sm_90a): the gradient norm and adaptive clip, the MultiSteps amsgrad
// update and the EMA of the weights (train/trainer.py).
//
// It replaces no TPU kernel: the JAX package's trainer runs optax under
// jit, where XLA fuses the update over the whole parameter tree.  Eager
// PyTorch walks the ~176 leaves one op at a time (~3,000 launches per
// micro-step, each a Python dispatch and a launch on the host for a few
// microseconds of the card's time), so these kernels take each phase over
// every leaf in one launch, or a few.
//
// What bounds them: bytes.  Each element is read and written a few times
// with a handful of flops (the update: 11 fp32 accesses, ~20 flops), far
// below the card's ~20 flops per byte.  A block takes one CHUNK of one
// leaf; the leaves' addresses and sizes travel in the launch's parameter
// space (LeafTable, passed by value as a __grid_constant__), as
// multi-tensor-apply does: a block finds its leaf by a binary search of
// the table's cumulative chunk counts, so a large leaf spreads over many
// blocks and no block idles on a small one.  A table holds CAP leaves; the
// wrapper cuts a longer list into several launches
// (ops/fused_optimizer.plan).
//
// Arithmetic: the plain path's (ops/fused_optimizer.*_plain, PyTorch's
// elementwise kernels on the card), op for op and in its order: fp32, one
// rounding per PyTorch op (__f*_rn, and the source is built with
// -fmad=false besides), IEEE sqrt and division.  PyTorch's CUDA division
// of a tensor by a host scalar multiplies by the scalar's fp32 reciprocal,
// so the wrapper passes 1/n, 1/c1, 1/c2 and 1/count as fp32 reciprocals.
// maximum / minimum / clamp_max propagate NaN as PyTorch's do.  Only the
// sums differ from the plain path's: the plain path sums each leaf's fp32
// squares in fp32 in PyTorch's reduction order, then the leaves' sums in
// fp32 in leaf order (Python's sum), and sums the norm buffer in fp32.
// Here each leaf's squares (rounded to fp32, as g * g is) and the buffer
// are summed in double in a fixed order and rounded once, the nearest
// fp32 to the exact sum, and the leaves' sums are added in fp32 in leaf
// order as the plain path adds them.  Repeat launches give the same bits.
//
// Kernels (one launch per table, THREADS threads a block):
//   sum_squares  partial[block] = sum of g^2 over the block's chunk, in
//                double.
//   clip         one block over a range of leaves (LeafEnds): each leaf's
//                partials in double, rounded, added to the running fp32
//                sum in leaf order; on the last range gnorm = sqrt(sum)
//                and, with the clip, the threshold 1.5 mean + 2 std of the
//                first count entries of the norm buffer, scale =
//                min(threshold / (gnorm + 1e-12), 1), buf[slot] =
//                min(gnorm, threshold); stats = (gnorm, threshold, scale,
//                the running sum).  No host sync.
//   scale        g *= stats[2], in place.
//   accumulate   acc += (g - acc) / n (a micro-step that does not update).
//   amsgrad      the same, then on the accumulated mean a:
//                mu = B1 mu + (1-B1) a, nu = B2 nu + ((1-B2) a) a,
//                nu_max = max(nu_max, nu / c2),
//                u = (mu / c1) / (sqrt(nu_max) + EPS) [+ wd p],
//                p += (-lr) u, acc = 0.
//   ema          e = p (decay 0), else e = d e + (1-d) p.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int CHUNK = 4096;          // elements of one leaf per block
constexpr int PARAM_BYTES = 4096;    // the launch parameter space we use
constexpr int CAP1 = 240;            // leaves per table: 1 pointer a leaf
constexpr int CAP2 = 160;            //                   2 pointers
constexpr int CAP6 = 64;             //                   6 pointers
constexpr int CAPF = 960;            // leaves per clip launch

template <int DEPTH, int CAP>
struct LeafTable {
    float* ptr[DEPTH][CAP];
    int numel[CAP];
    int chunk_end[CAP];      // cumulative chunks over the table's leaves
    int n;
};

static_assert(sizeof(LeafTable<1, CAP1>) + 64 <= PARAM_BYTES, "table 1");
static_assert(sizeof(LeafTable<2, CAP2>) + 64 <= PARAM_BYTES, "table 2");
static_assert(sizeof(LeafTable<6, CAP6>) + 64 <= PARAM_BYTES, "table 6");

// A range of leaves for the clip: leaf j's partials are
// [j ? chunk_end[j - 1] : chunk_begin, chunk_end[j]) of the norm pass's.
struct LeafEnds {
    int chunk_end[CAPF];
    int chunk_begin;
    int n;
};

static_assert(sizeof(LeafEnds) + 64 <= PARAM_BYTES, "leaf ends");

struct Span {
    int leaf, base, count;
};

// The chunk of blockIdx.x: its leaf (the first whose cumulative count
// passes the block), its first element and its length.
template <int DEPTH, int CAP>
__device__ __forceinline__ Span span_of(const LeafTable<DEPTH, CAP>& t) {
    const int c = blockIdx.x;
    int lo = 0, hi = t.n - 1;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (t.chunk_end[mid] > c) hi = mid; else lo = mid + 1;
    }
    const int first = lo ? t.chunk_end[lo - 1] : 0;
    const int base = (c - first) * CHUNK;
    const int rest = t.numel[lo] - base;
    return {lo, base, rest < CHUNK ? rest : CHUNK};
}

__device__ __forceinline__ float max_nan(float a, float b) {
    return a != a ? a : (b != b ? b : (a < b ? b : a));
}

__device__ __forceinline__ float min_nan(float a, float b) {
    return a != a ? a : (b != b ? b : (b < a ? b : a));
}

// The block's sum in a fixed order (warp shuffles, then warp 0 over the
// warps' sums), returned to every thread.
__device__ double block_sum(double v) {
    __shared__ double warp_sums[THREADS / 32];
    __shared__ double total;
    for (int o = 16; o > 0; o >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, o);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (lane == 0) warp_sums[warp] = v;
    __syncthreads();
    if (warp == 0) {
        v = lane < THREADS / 32 ? warp_sums[lane] : 0.0;
        for (int o = 16; o > 0; o >>= 1)
            v += __shfl_xor_sync(0xffffffffu, v, o);
        if (lane == 0) total = v;
    }
    __syncthreads();
    v = total;
    __syncthreads();        // the next call may overwrite the slots
    return v;
}

__global__ void __launch_bounds__(THREADS)
sum_squares_kernel(const __grid_constant__ LeafTable<1, CAP1> t,
                   double* partials) {
    const Span s = span_of(t);
    const float* g = t.ptr[0][s.leaf] + s.base;
    double acc = 0.0;
    for (int i = threadIdx.x; i < s.count; i += THREADS) {
        const float v = g[i];
        acc += (double)__fmul_rn(v, v);
    }
    acc = block_sum(acc);
    if (threadIdx.x == 0) partials[blockIdx.x] = acc;
}

// The trainer's norm and threshold, PyTorch's ops in their order:
// gnorm = sqrt(sum over leaves of (g * g).sum()),
// mean = where(valid, buf, 0).sum() / count,
// var = where(valid, (buf - mean) ** 2, 0).sum() / count,
// threshold = 1.5 * mean + 2.0 * sqrt(var).
// stats[3] carries the running sum of the leaves' sums between ranges.
__global__ void __launch_bounds__(THREADS)
clip_kernel(const __grid_constant__ LeafEnds e, const double* partials,
            int first, int last, float* buf, int buf_len, int count,
            float inv_count, int slot, int clip, float* stats) {
    __shared__ float leaf_sums[CAPF];
    __shared__ float total;
    for (int j = threadIdx.x; j < e.n; j += THREADS) {
        double acc = 0.0;
        for (int c = j ? e.chunk_end[j - 1] : e.chunk_begin;
             c < e.chunk_end[j]; ++c)
            acc += partials[c];
        leaf_sums[j] = (float)acc;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        float s = first ? 0.0f : stats[3];
        for (int j = 0; j < e.n; ++j) s = __fadd_rn(s, leaf_sums[j]);
        stats[3] = s;
        total = s;
    }
    __syncthreads();
    if (!last) return;
    const float gnorm = __fsqrt_rn(total);
    if (!clip) {
        if (threadIdx.x == 0) stats[0] = gnorm;
        return;
    }
    const bool valid = threadIdx.x < count && threadIdx.x < buf_len;
    const float b = valid ? buf[threadIdx.x] : 0.0f;
    const float mean = __fmul_rn((float)block_sum(b), inv_count);
    const float d = __fsub_rn(b, mean);
    const float var = __fmul_rn(
        (float)block_sum(valid ? __fmul_rn(d, d) : 0.0f), inv_count);
    const float threshold = __fadd_rn(__fmul_rn((float)1.5, mean),
                                      __fmul_rn((float)2.0, __fsqrt_rn(var)));
    // every thread has read buf (block_sum ends in a barrier)
    if (threadIdx.x == 0) {
        const float scale = min_nan(
            __fdiv_rn(threshold, __fadd_rn(gnorm, (float)1e-12)), 1.0f);
        buf[slot] = min_nan(gnorm, threshold);
        stats[0] = gnorm;
        stats[1] = threshold;
        stats[2] = scale;
    }
}

__global__ void __launch_bounds__(THREADS)
scale_kernel(const __grid_constant__ LeafTable<1, CAP1> t,
             const float* stats) {
    const Span s = span_of(t);
    float* g = t.ptr[0][s.leaf] + s.base;
    const float scale = stats[2];
    for (int i = threadIdx.x; i < s.count; i += THREADS)
        g[i] = __fmul_rn(g[i], scale);
}

// acc.add_((g - acc) / n)
__device__ __forceinline__ float running_mean(float acc, float g,
                                              float inv_n) {
    return __fadd_rn(acc, __fmul_rn(__fsub_rn(g, acc), inv_n));
}

__global__ void __launch_bounds__(THREADS)
accumulate_kernel(const __grid_constant__ LeafTable<2, CAP2> t,
                  float inv_n) {
    const Span s = span_of(t);
    const float* g = t.ptr[0][s.leaf] + s.base;
    float* acc = t.ptr[1][s.leaf] + s.base;
    for (int i = threadIdx.x; i < s.count; i += THREADS)
        acc[i] = running_mean(acc[i], g[i], inv_n);
}

struct Amsgrad {
    float inv_n, b1, omb1, b2, omb2, inv_c1, inv_c2, eps, wd, neg_lr;
    int decay;
};

__global__ void __launch_bounds__(THREADS)
amsgrad_kernel(const __grid_constant__ LeafTable<6, CAP6> t,
               const Amsgrad k) {
    const Span s = span_of(t);
    float* p = t.ptr[0][s.leaf] + s.base;
    const float* g = t.ptr[1][s.leaf] + s.base;
    float* acc = t.ptr[2][s.leaf] + s.base;
    float* mu = t.ptr[3][s.leaf] + s.base;
    float* nu = t.ptr[4][s.leaf] + s.base;
    float* nu_max = t.ptr[5][s.leaf] + s.base;
    for (int i = threadIdx.x; i < s.count; i += THREADS) {
        const float a = running_mean(acc[i], g[i], k.inv_n);
        const float m = __fadd_rn(__fmul_rn(mu[i], k.b1),
                                  __fmul_rn(k.omb1, a));
        const float v = __fadd_rn(__fmul_rn(nu[i], k.b2),
                                  __fmul_rn(__fmul_rn(k.omb2, a), a));
        const float vm = max_nan(nu_max[i], __fmul_rn(v, k.inv_c2));
        float u = __fdiv_rn(__fmul_rn(m, k.inv_c1),
                            __fadd_rn(__fsqrt_rn(vm), k.eps));
        const float w = p[i];
        if (k.decay) u = __fadd_rn(u, __fmul_rn(k.wd, w));
        p[i] = __fadd_rn(w, __fmul_rn(k.neg_lr, u));
        mu[i] = m;
        nu[i] = v;
        nu_max[i] = vm;
        acc[i] = 0.0f;
    }
}

__global__ void __launch_bounds__(THREADS)
ema_kernel(const __grid_constant__ LeafTable<2, CAP2> t, float d, float omd,
           int copy) {
    const Span s = span_of(t);
    const float* p = t.ptr[0][s.leaf] + s.base;
    float* e = t.ptr[1][s.leaf] + s.base;
    if (copy) {
        for (int i = threadIdx.x; i < s.count; i += THREADS) e[i] = p[i];
    } else {
        for (int i = threadIdx.x; i < s.count; i += THREADS)
            e[i] = __fadd_rn(__fmul_rn(e[i], d), __fmul_rn(omd, p[i]));
    }
}

// The table of leaves [0, n) of a launch: row d of the pointers at
// ptrs[d * stride], numel and chunk_end as the wrapper computed them.
// Returns the launch's blocks, or -1 when the table does not fit.
template <int DEPTH, int CAP>
int fill(LeafTable<DEPTH, CAP>& t, const uint64_t* ptrs, int stride,
         const int* numel, const int* chunk_end, int n) {
    if (n <= 0 || n > CAP) return -1;
    for (int d = 0; d < DEPTH; ++d)
        for (int i = 0; i < n; ++i)
            t.ptr[d][i] = reinterpret_cast<float*>(ptrs[d * stride + i]);
    for (int i = 0; i < n; ++i) {
        t.numel[i] = numel[i];
        t.chunk_end[i] = chunk_end[i];
    }
    t.n = n;
    return chunk_end[n - 1];
}

int launched() { return (int)cudaGetLastError(); }

}  // namespace

extern "C" {

// The compiled layout, for the wrapper to check against its own:
// out = {THREADS, CHUNK, PARAM_BYTES, CAP1, CAP2, CAP6, CAPF}.
void fo_layout(int* out) {
    const int v[7] = {THREADS, CHUNK, PARAM_BYTES, CAP1, CAP2, CAP6, CAPF};
    for (int i = 0; i < 7; ++i) out[i] = v[i];
}

int fo_sum_squares(const uint64_t* ptrs, int stride, const int* numel,
                   const int* chunk_end, int n, double* partials,
                   cudaStream_t stream) {
    LeafTable<1, CAP1> t;
    const int blocks = fill(t, ptrs, stride, numel, chunk_end, n);
    if (blocks < 0) return (int)cudaErrorInvalidValue;
    if (blocks) sum_squares_kernel<<<blocks, THREADS, 0, stream>>>(t, partials);
    return launched();
}

// Leaves [0, n) of a clip range: chunk_end as the wrapper computed them
// (indices into the norm pass's partials), the range's first chunk, and
// whether the range is the first and the last.
int fo_clip(const int* chunk_end, int chunk_begin, int n,
            const double* partials, int first, int last, float* buf,
            int buf_len, int count, float inv_count, int slot, int clip,
            float* stats, cudaStream_t stream) {
    if (n < 0 || n > CAPF || buf_len > THREADS || slot < 0
        || slot >= buf_len)
        return (int)cudaErrorInvalidValue;
    LeafEnds e;
    for (int i = 0; i < n; ++i) e.chunk_end[i] = chunk_end[i];
    e.chunk_begin = chunk_begin;
    e.n = n;
    clip_kernel<<<1, THREADS, 0, stream>>>(e, partials, first, last, buf,
                                           buf_len, count, inv_count, slot,
                                           clip, stats);
    return launched();
}

int fo_scale(const uint64_t* ptrs, int stride, const int* numel,
             const int* chunk_end, int n, const float* stats,
             cudaStream_t stream) {
    LeafTable<1, CAP1> t;
    const int blocks = fill(t, ptrs, stride, numel, chunk_end, n);
    if (blocks < 0) return (int)cudaErrorInvalidValue;
    if (blocks) scale_kernel<<<blocks, THREADS, 0, stream>>>(t, stats);
    return launched();
}

int fo_accumulate(const uint64_t* ptrs, int stride, const int* numel,
                  const int* chunk_end, int n, float inv_n,
                  cudaStream_t stream) {
    LeafTable<2, CAP2> t;
    const int blocks = fill(t, ptrs, stride, numel, chunk_end, n);
    if (blocks < 0) return (int)cudaErrorInvalidValue;
    if (blocks) accumulate_kernel<<<blocks, THREADS, 0, stream>>>(t, inv_n);
    return launched();
}

int fo_amsgrad(const uint64_t* ptrs, int stride, const int* numel,
               const int* chunk_end, int n, float inv_n, float b1,
               float omb1, float b2, float omb2, float inv_c1, float inv_c2,
               float eps, float wd, float neg_lr, int decay,
               cudaStream_t stream) {
    LeafTable<6, CAP6> t;
    const int blocks = fill(t, ptrs, stride, numel, chunk_end, n);
    if (blocks < 0) return (int)cudaErrorInvalidValue;
    const Amsgrad k{inv_n, b1, omb1, b2, omb2, inv_c1, inv_c2, eps, wd,
                    neg_lr, decay};
    if (blocks) amsgrad_kernel<<<blocks, THREADS, 0, stream>>>(t, k);
    return launched();
}

int fo_ema(const uint64_t* ptrs, int stride, const int* numel,
           const int* chunk_end, int n, float d, float omd, int copy,
           cudaStream_t stream) {
    LeafTable<2, CAP2> t;
    const int blocks = fill(t, ptrs, stride, numel, chunk_end, n);
    if (blocks < 0) return (int)cudaErrorInvalidValue;
    if (blocks) ema_kernel<<<blocks, THREADS, 0, stream>>>(t, d, omd, copy);
    return launched();
}

}  // extern "C"
