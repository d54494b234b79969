// Tensor-core and bulk-copy helpers shared by the EGNN edge-chain kernels
// (egnn_edge.cu) and their backward (egnn_edge_bwd.cu), for sm_90a: the
// TF32 split and mma.sync.m16n8k8, the bf16 packing of an operand pair and
// the bf16 rounding, the edge pre-activation in the plain version's order,
// and the mbarrier + cp.async.bulk copies.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

// lo and hi rounded to bf16 (nearest even) and packed, lo in the low half:
// the operand register of two consecutive k slots
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
    uint32_t r;
    asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
    return r;
}

// v rounded to bf16 (nearest even), as a float
__device__ __forceinline__ float bf16_rn(float v) {
    return __uint_as_float(pack_bf16x2(v, 0.f) << 16);
}

// ((a + b) + dc * w0) + di * w1, each operation rounded: the plain
// version's order, no fused multiply-add (the bf16 kernels round silu of
// it, and so meet the plain version's rounding of z)
__device__ __forceinline__ float pre_exact(float a, float b, float dc,
                                           float w0, float di, float w1) {
    return __fadd_rn(__fadd_rn(__fadd_rn(a, b), __fmul_rn(dc, w0)),
                     __fmul_rn(di, w1));
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

}  // namespace
